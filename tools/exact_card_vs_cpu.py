#!/usr/bin/env python3
"""The exact path on the card against the same work on the CPU, ray by ray.

    python3 tools/exact_card_vs_cpu.py [--every 4000]

On every ``--every``-th particle of chip_smoke's bench pair (the thick
`general` lens, RK4, the 64^3 ramp) this prints, card against CPU:

1. the rays the exact renderer hands its march, K11's coefficients against
   the CPU's plain prefilter, and the cubic B-spline weights
   (``ops/interp._bspline_weights``) on 2^20 fractions, today's and the
   earlier form that divided by the Python number 6.0;
2. the march's exit states ray by ray (trilinear RK4; cubic RK4 with the
   earlier weights and with today's), and for the first 2,000 rays the
   first recorded iteration at which card and CPU part;
3. stage by stage, for im1 (no march) and for im2 under both schemes: the
   rays after the march, after the lens, on the sensor plane, and the
   image; then the CPU's rays after the lens deposited on the card, and the
   CPU's marched rays taken through the lens on the card;
4. the thick lens's front surface operation by operation on the same
   (CPU) inputs, and which device's float32 ``sqrt`` of the discriminant is
   the correctly rounded one.

Needs a card: run it on the machine with the card.  Prints the card's name
and power limit first.
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from photon_tpu_torch import native  # noqa: E402
from photon_tpu_torch.models import render as exact  # noqa: E402
from photon_tpu_torch.ops import interp  # noqa: E402
from photon_tpu_torch.ops import lens as L  # noqa: E402
from photon_tpu_torch.ops.lens import RayBundle  # noqa: E402
from photon_tpu_torch.ops.march import make_march_fn, march_rays  # noqa: E402

CPU = torch.device("cpu")


def scalar_divisor_weights(t):
    """The cubic weights as ops/interp.py formed them before, each divided
    by the Python number 6.0 (on the card: times its rounded reciprocal)."""
    one = 1.0 - t
    return ((one * one * one) / 6.0,
            (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0,
            (-3.0 * t * t * t + 3.0 * t * t + 3.0 * t + 1.0) / 6.0,
            (t * t * t) / 6.0)


def equal_rows(a, b):
    a, b = a.cpu(), b.cpu()
    return ((a == b) | (torch.isnan(a) & torch.isnan(b))).all(-1)


def compare(x, y):
    """Rays of two bundles (any devices): how many equal, the largest
    differences of the finite ones."""
    same = equal_rows(x.pos, y.pos) & equal_rows(x.dir, y.dir)
    fin = torch.isfinite(y.pos.cpu()).all(-1)
    dp = (x.pos.cpu() - y.pos.cpu())[fin].abs().max() if fin.any() else 0.0
    dd = (x.dir.cpu() - y.dir.cpu())[fin].abs().max() if fin.any() else 0.0
    return (f"{int(same.sum())} of {len(same)} rays equal, max |dpos| "
            f"{float(dp):.3e} um, |ddir| {float(dd):.3e}")


class Grab(Exception):
    pass


def march_input(b, sub, dev):
    """The rays exact.render_image hands its march on `dev`."""
    got = []

    def grab(rays, field_override=None):
        got.append(rays)
        raise Grab

    try:
        with torch.no_grad():
            exact.render_image(b.cfg, b.setup, sub, b.r1, b.r2,
                               march_fn=grab, rays_per_chunk=10 ** 8,
                               device=dev)
    except Grab:
        pass
    return got[0]


def marches(vol, vol_cpu, rays, scheme, label, steps=400, n_rec=2000):
    rc = RayBundle(*(a.cpu() for a in rays))
    with torch.no_grad():
        oc, (pc, dc) = march_rays(vol, rays, algorithm=2,
                                  interpolation_scheme=scheme,
                                  record_steps=steps, record_rays=n_rec)
        oh, (ph, dh) = march_rays(vol_cpu, rc, algorithm=2,
                                  interpolation_scheme=scheme,
                                  record_steps=steps, record_rays=n_rec)
    print(f"  [{label}] exit states: {compare(oc, oh)}")
    pc, dc = pc.cpu(), dc.cpu()
    eq = equal_rows(pc, ph) & equal_rows(dc, dh)          # (rays, steps)
    live_c = (~torch.isnan(pc[..., 0])).sum(-1).numpy()
    live_h = (~torch.isnan(ph[..., 0])).sum(-1).numpy()
    first = np.array([int(r.nonzero()[0]) if (r := ~eq[k]).any() else -1
                      for k in range(eq.shape[0])])
    parted = first >= 0
    if parted.any():
        fr = first[parted]
        last = np.minimum(live_c, live_h)[parted]
        print(f"  [{label}] of the first {eq.shape[0]} rays {int(parted.sum())}"
              f" part, first at iteration {fr.min()}-{fr.max()} (median "
              f"{int(np.median(fr))}) of {int(last.min())}-{int(last.max())} "
              f"live; in the first 3 iterations: {int((fr <= 2).sum())}; "
              f"within 2 of the last live iteration: "
              f"{int((last - fr <= 2).sum())}; live iterations that differ: "
              f"{int((live_c[parted] != live_h[parted]).sum())}")


def stages(b, sub, params, dev, vol, scheme):
    chunk = exact._chunk_tensors(sub, slice(0, sub.num_particles), dev) + (
        torch.as_tensor(np.asarray(b.r1, np.float32), device=dev),
        torch.as_tensor(np.asarray(b.r2, np.float32), device=dev))
    mf = None if scheme == 0 else make_march_fn(
        vol, algorithm=2, interpolation_scheme=scheme)
    with torch.no_grad():
        marched = exact._generate_and_march(
            chunk, params, mf, b.setup.rotation_matrix,
            b.setup.inverse_rotation_matrix, {})
        lensed = exact.propagate_system(marched, b.setup.elements,
                                        params.lens_model)
        plane = exact.sensor_plane_rays(lensed, params)
        img = exact.sensor_splat(lensed, params, torch.zeros(
            (params.ny, params.nx), device=dev))
    return marched, lensed, plane, img


def lens_ops(b, sub, params, dev):
    """The front surface of the bench's lens, op by op, on the CPU's inputs."""
    chunk = exact._chunk_tensors(sub, slice(0, sub.num_particles), CPU) + (
        torch.as_tensor(np.asarray(b.r1, np.float32)),
        torch.as_tensor(np.asarray(b.r2, np.float32)))
    with torch.no_grad():
        rays = exact._generate_and_march(chunk, params, None,
                                         b.setup.rotation_matrix,
                                         b.setup.inverse_rotation_matrix, {})
    st = b.setup.elements
    e = int(np.argsort(-np.asarray(st.system_index), kind="stable")[0])
    center = torch.as_tensor(np.asarray(st.center[e], np.float32))
    plane = torch.as_tensor(np.asarray(st.plane_parameters[e], np.float32))
    vd, fr = float(st.vertex_distance[e]), float(st.front_surface_radius[e])

    def both(name, fn, *args):
        with torch.no_grad():
            h = fn(*args)
            c = fn(*(a.to(dev) for a in args)).cpu()
        same = (h == c) | (torch.isnan(h) & torch.isnan(c))
        print(f"  {name}: {int((~same).sum())} of {h.numel()} values differ")
        return h

    n_hat = both("n_hat", lambda p: p[:3] / torch.sqrt(L.dot3(p[:3], p[:3])),
                 plane)
    fc = both("front centre", lambda c_, n_: c_ + n_ * (vd / 2.0 - fr),
              center, n_hat)
    omc = both("origin - centre", lambda o, c_: o - c_, rays.pos, fc)
    alpha = both("alpha", lambda d: L.dot3(d, d), rays.dir)
    beta = both("beta", lambda d, m: 2.0 * L.dot3(d, m), rays.dir, omc)
    gamma = both("gamma", lambda m: L.dot3(m, m) - fr * fr, omc)
    disc = both("discriminant", lambda b_, a_, g_: b_ * b_ - 4.0 * a_ * g_,
                beta, alpha, gamma)
    disc = torch.where(disc < 0, 0.0, disc)
    both("its sqrt", torch.sqrt, disc)
    both("the sphere hit", lambda c_, d, o: L.ray_sphere_intersection(
        c_, fr, d, o, "front"), fc, rays.dir, rays.pos)
    right = torch.sqrt(disc.double()).float()
    print(f"  float32 sqrt of the discriminant against the correctly rounded "
          f"one: the CPU's differs at "
          f"{int((torch.sqrt(disc) != right).sum())}, the card's at "
          f"{int((torch.sqrt(disc.to(dev)).cpu() != right).sum())} of "
          f"{disc.numel()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--every", type=int, default=4000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    b = chip_smoke.bench_inputs(dev)
    vol = b.vol
    vol_cpu = vol._replace(field=vol.field.cpu())
    sub = chip_smoke.subset(b.source, slice(0, b.source.num_particles,
                                            args.every))
    params = exact.RenderParams.from_setup(b.cfg, b.setup, sub)

    print("1. inputs")
    rays = march_input(b, sub, dev)
    print(f"  the march's input rays: {compare(rays, march_input(b, sub, CPU))}")
    co = native.bspline_prefilter(vol.field).cpu()
    print(f"  K11's coefficients against the CPU's plain prefilter: "
          f"{int((co != native.bspline_prefilter_plain(vol_cpu.field)).sum())}"
          f" of {co.numel()} differ")
    t = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0))
    for label, fn in (("today's", interp._bspline_weights),
                      ("divided by the Python number 6.0",
                       scalar_divisor_weights)):
        w_card = torch.stack(fn(t.to(dev))).cpu()
        print(f"  cubic weights, {label}: card against CPU "
              f"{int((w_card != torch.stack(fn(t))).sum())} of "
              f"{w_card.numel()} differ")

    print("2. the exact march, RK4")
    marches(vol, vol_cpu, rays, 1, "trilinear")
    today = interp._bspline_weights
    interp._bspline_weights = scalar_divisor_weights
    try:
        marches(vol, vol_cpu, rays, 2, "cubic, weights divided by 6.0")
    finally:
        interp._bspline_weights = today
    marches(vol, vol_cpu, rays, 2, "cubic, today's weights")

    print("3. stage by stage")
    for scheme, label in ((0, "im1, no march"), (1, "im2, trilinear RK4"),
                          (2, "im2, cubic RK4")):
        card = stages(b, sub, params, dev, vol, scheme)
        host = stages(b, sub, params, CPU, vol_cpu, scheme)
        print(f"  [{label}]")
        for name, x, y in zip(("marched", "after the lens",
                               "on the sensor plane"), card, host):
            print(f"    {name}: {compare(x, y)}")
        print(f"    image: L1 {chip_smoke.rel_l1(card[3].cpu().numpy(), host[3].numpy()):.3e}"
              f" of the CPU's sum")
        with torch.no_grad():
            dep = exact.sensor_splat(RayBundle(*(a.to(dev) for a in host[1])),
                                     params, torch.zeros((params.ny, params.nx),
                                                         device=dev))
            lensed = exact.propagate_system(
                RayBundle(*(a.to(dev) for a in host[0])), b.setup.elements,
                params.lens_model)
        print(f"    the CPU's rays after the lens deposited on the card: L1 "
              f"{chip_smoke.rel_l1(dep.cpu().numpy(), host[3].numpy()):.3e}")
        print(f"    the CPU's marched rays through the lens on the card: "
              f"{compare(lensed, host[1])}")

    print("4. the lens's front surface, op by op on the CPU's inputs")
    lens_ops(b, sub, params, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
