"""Port vs JAX: render_image_fast on the scene of tests/test_fast.py."""
import numpy as np
import pytest
import torch

import jax

from photon_tpu.models.optics import camera_setup as jax_camera_setup
from photon_tpu.models.render_fast import render_image_fast as jax_render
from photon_tpu.models.scenes import bos_source as jax_bos_source
from photon_tpu.utils.rng import lens_samples as jax_lens_samples
from photon_tpu_torch.models.optics import camera_setup
from photon_tpu_torch.models.render_fast import render_image_fast
from tests.test_bos_pipeline import bos_case, gradient_volume_between
from tests.torch_port_helpers import (port_config, port_source, port_volume,
                                      rel_l1)


def _scene(lens_model, rays=32):
    """Both sides of one scene: the JAX objects and what crosses over."""
    cfg = bos_case(lens_model, n_dots=6, rays=rays)
    setup = jax_camera_setup(cfg)
    src, *_ = jax_bos_source(cfg, setup, np.random.default_rng(11))
    r1, r2 = (np.asarray(r) for r in
              jax_lens_samples(jax.random.key(5), rays))
    tcfg = port_config(cfg)
    return dict(jax=(cfg, setup, src, r1, r2),
                torch=(tcfg, camera_setup(tcfg), port_source(src), r1, r2))


@pytest.fixture(scope="module")
def general():
    sc = _scene("general")
    vol, _, _ = gradient_volume_between(sc["jax"][1])
    sc["jax_vol"], sc["torch_vol"] = vol, port_volume(vol)
    return sc


# budget of the JAX package's fast-vs-exact test (tests/test_fast.py): L1
# distance < 1e-3 of the image sum.  Both sides run the same f32 formulas;
# what separates them is the thick lens's cancellation and erf's last bits,
# seen at ~1e-5.
_L1 = 1e-3


@pytest.mark.parametrize("lens_model", ["apparent", "thin-lens", "general"])
def test_render_matches_jax_no_volume(lens_model):
    sc = _scene(lens_model)
    ref = np.asarray(jax_render(*sc["jax"]))
    got = render_image_fast(*sc["torch"], device="cpu").numpy()
    assert ref.sum() > 0 and got.shape == ref.shape
    assert got.dtype == np.float32 and np.isfinite(got).all()
    l1 = rel_l1(got, ref)
    print(f"{lens_model}: L1 {l1:.3g}")
    assert l1 < _L1, l1
    assert np.unravel_index(ref.argmax(), ref.shape) \
        == np.unravel_index(got.argmax(), got.shape)


def test_render_matches_jax_with_volume(general):
    ref0 = np.asarray(jax_render(*general["jax"]))
    ref = np.asarray(jax_render(*general["jax"], vol=general["jax_vol"]))
    got = render_image_fast(*general["torch"], vol=general["torch_vol"],
                            device="cpu").numpy()
    l1 = rel_l1(got, ref)
    print(f"general + volume: L1 {l1:.3g}")
    assert l1 < _L1, l1
    # the volume moves the dots: the comparison is not of two copies of im1
    assert rel_l1(ref, ref0) > 0.05


MENU = {
    "tricubic RK4": dict(interpolation_scheme=2),
    "tricubic Euler": dict(algorithm=1, interpolation_scheme=2),
    "RK4, substeps chosen from the data": dict(algorithm=3),
    "tricubic RK4, substeps chosen from the data": dict(
        algorithm=3, interpolation_scheme=2),
    "RK4 x 3 substeps": dict(algorithm=3, march_substeps=3),
    "Adams-Bashforth": dict(algorithm=4),
    "tricubic Adams-Bashforth": dict(algorithm=4, interpolation_scheme=2),
}


@pytest.mark.parametrize("case", sorted(MENU))
def test_render_matches_jax_across_the_march_menu(general, case):
    """Every (algorithm, scheme) of the dense march through the renderer:
    L1 within 1e-3 of the image sum, as the default march above."""
    kw = MENU[case]
    ref = np.asarray(jax_render(*general["jax"], vol=general["jax_vol"],
                                **kw))
    got = render_image_fast(*general["torch"], vol=general["torch_vol"],
                            device="cpu", **kw).numpy()
    l1 = rel_l1(got, ref)
    print(f"{case}: L1 {l1:.3g}")
    assert np.isfinite(got).all() and got.sum() > 0
    assert l1 < _L1, l1


def test_chosen_substeps_are_cached_by_scene_and_scheme(general, monkeypatch):
    from photon_tpu_torch.models import render_fast
    monkeypatch.setattr(render_fast, "_substep_cache", {})
    calls = []
    real = render_fast.choose_substeps

    def counting(*a, **kw):
        calls.append(kw["interpolation_scheme"])
        return real(*a, **kw)

    monkeypatch.setattr(render_fast, "choose_substeps", counting)
    kw = dict(vol=general["torch_vol"], algorithm=3, device="cpu")
    a = render_image_fast(*general["torch"], **kw)
    b = render_image_fast(*general["torch"], **kw)
    assert calls == [1] and torch.equal(a, b)
    assert list(render_fast._substep_cache.values()) == [2]
    render_image_fast(*general["torch"], interpolation_scheme=2, **kw)
    assert calls == [1, 2]
    # explicit substeps and the other integrators never probe
    render_image_fast(*general["torch"], **{**kw, "march_substeps": 2})
    render_image_fast(*general["torch"], **{**kw, "algorithm": 2})
    assert calls == [1, 2]


@pytest.mark.parametrize("kw", [dict(interpolation_scheme=3),
                                dict(algorithm=5), dict(algorithm=0)])
def test_unknown_march_option_raises_value_error(general, kw):
    with pytest.raises(ValueError, match="unknown"):
        render_image_fast(*general["torch"], vol=general["torch_vol"],
                          device="cpu", **kw)


def test_chunked_equals_unchunked(general):
    kw = dict(vol=general["torch_vol"], device="cpu")
    whole = render_image_fast(*general["torch"], **kw).numpy()
    parts = render_image_fast(*general["torch"], particles_per_chunk=7,
                              **kw).numpy()
    # same deposits, summed image by image instead of in one scatter: f32
    # rounding of the sum only
    np.testing.assert_allclose(parts, whole, rtol=0, atol=1e-6 * whole.max())


def test_two_cpu_renders_are_bit_equal(general):
    kw = dict(vol=general["torch_vol"], device="cpu", particles_per_chunk=16)
    a = render_image_fast(*general["torch"], **kw)
    b = render_image_fast(*general["torch"], **kw)
    assert torch.equal(a, b)


def test_inputs_as_tensors_and_single_ray(general):
    cfg, setup, src, r1, r2 = general["torch"]
    a = render_image_fast(cfg, setup, src, r1, r2, device="cpu")
    b = render_image_fast(cfg, setup, src, torch.tensor(r1),
                          torch.tensor(r2), device="cpu")
    assert torch.equal(a, b)
    # R == 1 zeroes the lens offsets: the lone ray is the chief ray
    one = render_image_fast(cfg, setup, src, r1[:1], r2[:1], device="cpu")
    assert one.sum() > 0


def _opts(name):
    """Options outside this slice, each as (config edits, keyword args)."""
    def edit(cfg):
        if name == "rotated camera":
            cfg.camera_design.x_camera_angle = 0.05
        elif name == "position noise":
            cfg.density_gradients.add_pos_noise = True
            cfg.density_gradients.pos_noise_std = 0.1
        elif name == "bilinear sensor":
            cfg.camera_design.implement_diffraction = False
    kw = {"per_ray_splat": dict(per_ray_splat=True),
          "chief_march=False": dict(chief_march=False),
          "Mie scattering": dict(scattering={"scattering_angle": [0.0]}),
          "mesh": dict(mesh=object()),
          "dense_march=False": dict(dense_march=False)}.get(name, {})
    return edit, kw


@pytest.mark.parametrize("option", [
    "rotated camera", "position noise", "bilinear sensor", "per_ray_splat",
    "chief_march=False", "Mie scattering", "mesh", "dense_march=False"])
def test_unsupported_option_raises(general, option):
    import copy
    cfg, _setup, src, r1, r2 = general["torch"]
    cfg = copy.deepcopy(cfg)
    edit, kw = _opts(option)
    edit(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        render_image_fast(cfg, camera_setup(cfg), src, r1, r2,
                          vol=general["torch_vol"], device="cpu", **kw)


def test_slab_over_dense_cap_raises(general):
    cfg, setup, src, r1, r2 = general["torch"]
    vol = general["torch_vol"]
    big = vol._replace(field=torch.zeros((3, 300, 300, 4)))
    with pytest.raises(NotImplementedError, match="Large volumes"):
        render_image_fast(cfg, setup, src, r1, r2, vol=big, device="cpu")
    # explicit substeps make algorithm 3 a supported march
    img = render_image_fast(cfg, setup, src, r1, r2, vol=vol, algorithm=3,
                            march_substeps=2, device="cpu")
    assert img.sum() > 0
