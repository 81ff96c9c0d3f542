"""Port vs JAX: cotangents of the fan statistics' per-particle columns.

The port's side is ``fan_stats`` given CPU tensors, i.e. ``torch.autograd``
through the plain fan (the plain version of the backward kernel); the JAX
side is ``jax.vjp`` of ``photon_tpu.ops.fan_pallas.fan_stats`` in interpret
mode, whose backward is the Pallas kernel ``_fan_bwd_kernel``.  Only the
column cotangents are compared: the JAX package returns zeros for the lens
rows ``x_lens`` / ``y_lens`` (a known fault), the port true gradients on the
CPU and an error on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photon_tpu.ops.fan_pallas import FanScalars as JaxFanScalars
from photon_tpu.ops.fan_pallas import fan_stats as jax_fan_stats
from photon_tpu_torch.ops.fan import fan_stats
from tests.test_torch_fan import _inputs

_NAMES = ("xs", "ys", "zs", "amp0", "dz_exit", "dpx", "dpy", "ddx", "ddy",
          "ddz")


def _cotangents(p, seed=7):
    """Cotangents of (A, AX, AY) as a centroid loss produces them: those of
    AX and AY of one size, that of A larger by a pixel coordinate."""
    rng = np.random.default_rng(seed)
    return [rng.normal(0, s, p).astype(np.float32) for s in (50.0, 1.0, 1.0)]


def _jax_vjp(sc, cols, deltas, x_lens, y_lens, lens_model, cts):
    jsc = JaxFanScalars(**sc._asdict())
    n_cols = len(cols)

    def f(*args):
        d6 = tuple(args[n_cols:]) if deltas is not None else None
        return jax_fan_stats(*args[:n_cols], d6, jnp.asarray(x_lens),
                             jnp.asarray(y_lens), sc=jsc,
                             lens_model=lens_model, mirror_x=True,
                             interpret=True)

    args = [jnp.asarray(a) for a in cols + (deltas or [])]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cts))]


def _torch_vjp(sc, cols, deltas, x_lens, y_lens, lens_model, cts):
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in cols + (deltas or [])]
    d6 = tuple(leaves[len(cols):]) if deltas is not None else None
    out = fan_stats(*leaves[:len(cols)], d6, torch.from_numpy(x_lens),
                    torch.from_numpy(y_lens), sc=sc, lens_model=lens_model,
                    mirror_x=True)
    grads = torch.autograd.grad(out, leaves,
                                grad_outputs=[torch.from_numpy(c)
                                              for c in cts])
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("lens_model,with_deltas", [
    ("general", True), ("general", False), ("apparent", True),
    ("thin-lens", True)])
def test_column_cotangents_match_jax(lens_model, with_deltas):
    """Tolerance: 5e-4 of each column's largest cotangent, ten times what is
    seen.  Both sides run the same f32 chain; the two autodiffs (XLA's fused
    transposes with rsqrt against PyTorch's per-operation ones with 1/sqrt)
    round it differently.  Seen: the thick lens, whose discriminant
    beta^2 - 4 gamma and its cotangent cancel from ~1e16 to ~1e9, at ~2e-5;
    the other two at ~3e-7, except the exit plane's column (a difference of
    two large terms in every model) at ~5e-5.  The JAX package itself asks
    only for a cosine of 0.9999 on the field gradient behind this kernel
    (tests/test_fan_pallas.py:67-78)."""
    sc, cols, deltas, x_lens, y_lens = _inputs(lens_model)
    deltas = deltas if with_deltas else None
    cts = _cotangents(len(cols[0]))
    ref = _jax_vjp(sc, cols, deltas, x_lens, y_lens, lens_model, cts)
    got = _torch_vjp(sc, cols, deltas, x_lens, y_lens, lens_model, cts)
    assert len(got) == len(ref) == (10 if with_deltas else 4)
    worst = {}
    for name, g, r in zip(_NAMES, got, ref):
        denom = np.abs(r).max()
        assert denom > 0 and np.isfinite(g).all(), name
        worst[name] = float(np.abs(g - r).max() / denom)
        cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r)))
        assert cos > 0.9999, (name, cos)
    print(f"{lens_model} deltas={with_deltas}: {worst}")
    assert max(worst.values()) < 5e-4, worst


def test_culled_particles_get_exactly_zero():
    """Particles whose every ray leaves the sensor: masks pass no gradient,
    and 0 * inf never reaches a cotangent."""
    sc, cols, deltas, x_lens, y_lens = _inputs("general")
    cts = _cotangents(len(cols[0]))
    got = _torch_vjp(sc, cols, deltas, x_lens, y_lens, "general", cts)
    leaves = [torch.from_numpy(a) for a in cols]
    A = fan_stats(*leaves, tuple(torch.from_numpy(d) for d in deltas),
                  torch.from_numpy(x_lens), torch.from_numpy(y_lens), sc=sc,
                  lens_model="general")[0].numpy()
    dead = A == 0
    assert dead.sum() >= 3
    for name, g in zip(_NAMES, got):
        assert np.isfinite(g).all(), name
        assert (g[dead] == 0).all(), name


def test_card_route_refuses_lens_rows_that_require_grad():
    """No kernel computes cotangents of x_lens / y_lens; tensors that are
    not on the CPU take the kernel route, which says so instead of returning
    zeros (meta tensors stand in for the card here)."""
    sc, cols, _, x_lens, y_lens = _inputs("thin-lens", p=12, r=8)
    ts = [torch.empty(12, device="meta") for _ in cols]
    xl = torch.empty(8, device="meta", requires_grad=True)
    yl = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="detach the lens rows"):
        fan_stats(*ts, None, xl, yl, sc=sc, lens_model="thin-lens")
    # on the CPU autograd through the plain version gives them true gradients
    leaves = [torch.from_numpy(a) for a in cols]
    xl = torch.from_numpy(x_lens).requires_grad_(True)
    out = fan_stats(*leaves, None, xl, torch.from_numpy(y_lens), sc=sc,
                    lens_model="thin-lens")
    out[0].sum().backward()
    assert xl.grad.abs().max() > 0
