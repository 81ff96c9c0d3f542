#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and nothing from the network.  It

1. prints the card (name and power limit as nvidia-smi gives them), the
   torch / CUDA versions, and builds the three kernels of
   photon_tpu_torch/csrc from source;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (and at the whole-image shapes), with the
   tolerance printed, and times both with CUDA events;
3. drives the main path once through the command line entry point
   (photon_tpu_torch.cli.main -> run_simulation -> run_bos -> save_result):
   the BOS image pair at 1024 x 1024, 1000 dots x ~100 source points,
   500 rays each, RK4 through a 64^3 density volume; checks the artifacts,
   the launch counters, the images against a render through the plain
   versions, and the run-to-run difference of the atomics-based splat;
4. prints one JSON line describing the kernels and, last, one JSON line
   {"ok": true, "device": {...}}.

Any failed phase raises: the exit code is then not 0 and no result line is
printed.  Without a CUDA device it exits with code 2 before anything else.
"""
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

H100_F32_FLOPS = 67e12        # published peak, f32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # published HBM3 rate, SXM part

# f32 operations (add, mul, div, sqrt, compare each counted as one) of the
# formulas in the kernels' sources, per unit of work
MARCH_OPS_PER_RHS = 100       # coordinates 15, weights 10, 8-voxel blend 68, rhs 7
MARCH_OPS_PER_RK4_COMBINE = 65
FAN_OPS_PER_PAIR = {"general": 200, "thin-lens": 90, "apparent": 70}
FAN_OPS_MARCH = 25
SPLAT_OPS_PER_PATCH_PIXEL = 10    # index arithmetic and the circle test
SPLAT_OPS_PER_DEPOSIT = 90        # four erff (~20 each) and the products


def bound_ms(nbytes, ops):
    """Least time the card could take: bytes over the memory rate against
    operations over the f32 rate; returns (ms, which)."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def require(cond, message) -> None:
    """A check that stays under ``python -O``."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {message}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from photon_tpu_torch import kernels
    from photon_tpu_torch.cli import main as cli_main
    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.models.render_fast import (_chief_geometry,
                                                     auto_patch, fan_scalars)
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.ops.fan import fan_stats, fan_stats_plain
    from photon_tpu_torch.ops.march_dense import (chief_deltas_dense,
                                                  march_chief_dense,
                                                  march_geometry)
    from photon_tpu_torch.ops.march_dense_fused import march_chief_fused
    from photon_tpu_torch.ops.splat import (splat_particles,
                                            splat_particles_plain)
    from photon_tpu_torch.pipeline import _lens_sample_pair, _ray_budget, run_bos
    from photon_tpu_torch.utils.nrrd_io import write_nrrd
    from photon_tpu_torch.utils.tiff_io import read_tiff16
    from photon_tpu_torch.volume import (build_density_volume,
                                         load_density_volume)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are held to full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False

    # ------------------------------------------------------------------
    # phase 1: the card, the versions, the build
    # ------------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    built = kernels.build()
    for name in kernels.SIGNATURES:
        kernels.load(name)
    print(f"built {len(built)} kernel libraries with "
          f"{os.path.basename(kernels.nvcc_path())} in "
          f"{kernels.build_seconds:.1f} s: "
          f"{', '.join(sorted(kernels.SIGNATURES))}")

    def sync():
        torch.cuda.synchronize(dev)

    def time_ms(fn, reps=7, warm=2, inner=1):
        """Median over `reps` of the CUDA-event time of `inner` calls."""
        for _ in range(warm):
            fn()
        sync()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            sync()
            ts.append(e0.elapsed_time(e1) / inner)
        return statistics.median(ts)

    # ------------------------------------------------------------------
    # the main path's scene (the JAX package's bench scene): 1024^2
    # sensor, 1000 dots x ~100 source points, 500 rays, 64^3 volume
    # ------------------------------------------------------------------
    sensor, n_dots, rays_per = 1024, 1000, 500
    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = sensor
    cfg.camera_design.y_pixel_number = sensor
    cfg.bos_pattern.grid_point_number = n_dots
    cfg.bos_pattern.particle_number_per_grid_point = 100
    cfg.bos_pattern.lightray_number_per_particle = rays_per
    cfg.density_gradients.simulate_density_gradients = True
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * sensor * cfg.camera_design.pixel_pitch / 2.0 / m
    cfg.bos_pattern.X_Min, cfg.bos_pattern.X_Max = -half, half
    cfg.bos_pattern.Y_Min, cfg.bos_pattern.Y_Max = -half, half
    setup = camera_setup(cfg)
    n = 64
    gx = np.linspace(-1.5e5, 1.5e5, n)
    gz = np.linspace(setup.object_distance - 5e5,
                     setup.object_distance - 1e2, n)
    rho = 1.225 + 5.0 * (gx[:, None, None] - gx.min()) \
        / (gx.max() - gx.min()) * np.ones((1, n, n))
    spacings = [gx[1] - gx[0], gx[1] - gx[0], gz[1] - gz[0]]
    origin = [gx[0], gx[0], gz[0]]

    source, dot_x, dot_y = bos_source(cfg, setup,
                                      np.random.default_rng(cfg.seed))
    r1, r2 = _lens_sample_pair(cfg, rays_per)
    vol = build_density_volume(rho, spacings, origin, device=dev)
    params = RenderParams.from_setup(cfg, setup, source)
    P, R = source.num_particles, rays_per
    chunk = max(1, _ray_budget(cfg) // R)       # particles per launch
    n_chunks = -(-P // chunk)
    print(f"scene: {P} particles x {R} rays = {P * R:.3g} rays per image, "
          f"{sensor}x{sensor} sensor, volume {tuple(vol.sizes)}, "
          f"{chunk} particles a chunk ({n_chunks} chunks)")

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    xs, ys, zs = f32(source.x), f32(source.y), f32(source.z)
    kernel_rows = []
    failures = []

    def hold(name, err, tol):
        ok = bool(err <= tol) and math.isfinite(err)
        print(f"    {name}: max error {err:.3e}  tolerance {tol:.1e}  "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    # ------------------------------------------------------------------
    # phase 2a: K1, the dense march
    # ------------------------------------------------------------------
    print("K1 march_dense (csrc/march_dense.cu) against its plain version")
    inv_rot = f32(setup.inverse_rotation_matrix)
    chief = _chief_geometry(xs, ys, zs, inv_rot, params.z_offset,
                            params.image_distance)
    geom = march_geometry(vol)
    scale = float(max(abs(float(v)) for v in
                      (geom.min_x, geom.min_y, geom.z_min, geom.z_max)))

    def march_err(got, ref):
        pos = max(float((g - r).abs().max()) for g, r in zip(got[:3], ref[:3]))
        dire = max(float((g - r).abs().max()) for g, r in zip(got[3:], ref[3:]))
        return pos, dire

    # tolerance: both sides are f32 with the same formulas; the kernel
    # contracts to FMA and blends the eight voxels in another order.  Errors
    # are normalised: positions by the largest coordinate of the volume,
    # directions as they are.  5e-6 is about 40 f32 roundings.
    K1_TOL = 5e-6
    got = march_chief_fused(vol, *chief, algorithm=2)
    sync()
    ref = march_chief_dense(vol, *chief, algorithm=2)
    pos_e, dir_e = march_err(got, ref)
    k1_err = max(pos_e / scale, dir_e)
    print(f"    RK4, {P} rays: position error {pos_e:.3e} um, "
          f"direction error {dir_e:.3e}")
    hold(f"K1 RK4 {P} rays (normalised)", k1_err, K1_TOL)
    bent = float((got[3] - chief[3]).abs().max())
    if not bent > 1e-5:
        failures.append("K1 does not bend the rays")
    sub = tuple(c[:4096].contiguous() for c in chief)
    for alg, ss, label in ((1, None, "Euler"), (3, 2, "RK4 x 2 substeps")):
        g = march_chief_fused(vol, *sub, algorithm=alg, substeps=ss)
        r = march_chief_dense(vol, *sub, algorithm=alg, substeps=ss)
        pe, de = march_err(g, r)
        hold(f"K1 {label} 4096 rays (normalised)", max(pe / scale, de), K1_TOL)
    # rays above, inside, below the volume and travelling upward
    odd = [c[:4096].clone() for c in chief]
    odd[2][1000:2000] = float(geom.z_min) + 0.3 * float(geom.z_max - geom.z_min)
    odd[2][2000:3000] = float(geom.z_min) - 1e4
    odd[5][3000:] = -odd[5][3000:]
    g = march_chief_fused(vol, *odd, algorithm=2)
    r = march_chief_dense(vol, *odd, algorithm=2)
    pe, de = march_err(g, r)
    hold("K1 RK4 entry cases (normalised)", max(pe / scale, de), K1_TOL)

    k1_ms = time_ms(lambda: march_chief_fused(vol, *chief, algorithm=2))
    k1_plain_ms = time_ms(lambda: march_chief_dense(vol, *chief, algorithm=2),
                          reps=5, warm=1)
    # work of this run's data: steps actually taken by rays that enter
    z_entry = torch.where(chief[2] >= float(geom.z_max),
                          torch.full_like(chief[2], float(geom.z_max)),
                          chief[2])
    inside = (z_entry >= float(geom.z_min)) & (chief[5] < 0)
    planes = f32(geom.z_planes(n))
    steps = int(((z_entry[:, None] > planes[None, :])
                 & inside[:, None]).sum())
    k1_ops = steps * (4 * MARCH_OPS_PER_RHS + MARCH_OPS_PER_RK4_COMBINE)
    k1_bytes = 12 * P * 4 + vol.field.numel() * 4
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)
    print(f"    time {k1_ms:.4f} ms  plain {k1_plain_ms:.2f} ms  bound "
          f"{k1_bound:.4f} ms ({k1_by}; {steps} ray-slab steps)  [{card}]")
    kernel_rows.append(dict(
        name="march_dense", route="cuda",
        source="photon_tpu_torch/csrc/march_dense.cu",
        replaces="photon_tpu/ops/march_dense_fused.py:174",
        shape=f"{P} rays, 64^3 field, RK4",
        max_abs_err=k1_err, tolerance=K1_TOL, ms=k1_ms, plain_ms=k1_plain_ms,
        bound_ms=k1_bound, bound_by=k1_by, library_ms=None))

    # ------------------------------------------------------------------
    # phase 2b: K2, the fan statistics
    # ------------------------------------------------------------------
    print("K2 fan_stats (csrc/fan_stats.cu) against its plain version")
    deltas6 = chief_deltas_dense(vol, *chief, algorithm=2)
    st = setup.elements
    lens_params = (float(setup.z_lens), float(st.pitch[0]),
                   float(st.vertex_distance[0]),
                   float(st.front_surface_radius[0]),
                   float(st.back_surface_radius[0]),
                   float(st.refractive_index[0]),
                   float(st.transmission_ratio[0]))
    sc = fan_scalars(params, lens_params)
    r1d, r2d = f32(r1), f32(r2)
    cone = params.ray_cone_pitch_ratio * params.lens_pitch
    x_lens = cone * r1d * torch.cos(2.0 * math.pi * r2d)
    y_lens = cone * r1d * torch.sin(2.0 * math.pi * r2d)
    amp0 = f32(source.radiance) * float(
        np.float32((8.0 / math.pi) / params.aperture_f_number ** 2))

    # tolerances: kernel and plain version evaluate the same f32 formulas
    # without FMA contraction and differ by the order of the sum over the
    # fan, so the sums agree to a few roundings (1e-5 of the largest value
    # is about 50 times what is seen) and the centroids AX/A, AY/A, which
    # place the spots, to 1e-3 px (some 15 roundings of a 1024 px
    # coordinate).  The thick lens forms beta^2 - 4 gamma from coordinates
    # of 1e5..1e8 um in f32: a build that rounds it differently moves the
    # centroids by hundredths of a pixel and fails the second check.
    K2_TOL = 1e-5
    K2_CENTROID_TOL = 1e-3

    def fan_err(got, ref):
        return max(float((g - r).abs().max() / r.abs().max())
                   for g, r in zip(got, ref))

    def fan_case(lens_model, d6, sl, label):
        cols = [a[sl].contiguous() for a in (xs, ys, zs, amp0)]
        dd = None if d6 is None else tuple(d[sl].contiguous() for d in d6)
        kw = dict(sc=sc, lens_model=lens_model, mirror_x=True)
        got = fan_stats(*cols, dd, x_lens, y_lens, **kw)
        sync()
        ref = fan_stats_plain(*cols, dd, x_lens, y_lens,
                              particles_per_chunk=10000, **kw)
        err = fan_err(got, ref)
        okp = ref[0] > 0
        cen = max(float((got[i][okp] / got[0][okp]
                         - ref[i][okp] / ref[0][okp]).abs().max())
                  for i in (1, 2))
        print(f"    {label}: {int(okp.sum())} of {okp.numel()} particles "
              f"on the sensor")
        hold(f"K2 {label} (relative)", err, K2_TOL)
        hold(f"K2 {label} (centroid, px)", cen, K2_CENTROID_TOL)
        return got, err

    whole = slice(0, P)
    first = slice(0, chunk)
    (A, AX, AY), k2_err_whole = fan_case(
        "general", deltas6, whole, f"general + deltas, {P} x {R}")
    _, k2_err = fan_case("general", deltas6, first,
                         f"general + deltas, {chunk} x {R}")
    fan_case("general", None, first, f"general, no deltas, {chunk} x {R}")
    fan_case("apparent", deltas6, first, f"apparent + deltas, {chunk} x {R}")
    fan_case("thin-lens", deltas6, first, f"thin-lens + deltas, {chunk} x {R}")
    # a particle far off the sensor keeps its zero and poisons nothing
    far = [a[first].clone() for a in (xs, ys, zs, amp0)]
    far[0][:7] = 5e5
    gfar = fan_stats(*far, None, x_lens, y_lens, sc=sc, lens_model="general")
    if not (float(gfar[0][:7].abs().max()) == 0.0
            and bool(torch.isfinite(torch.stack(gfar)).all())):
        failures.append("K2 off-sensor particles")

    def fan_time(sl, plain, **kw):
        cols = [a[sl].contiguous() for a in (xs, ys, zs, amp0)]
        dd = tuple(d[sl].contiguous() for d in deltas6)
        fn = fan_stats_plain if plain else fan_stats
        extra = dict(particles_per_chunk=10000) if plain else {}
        return time_ms(lambda: fn(*cols, dd, x_lens, y_lens, sc=sc,
                                  lens_model="general", **extra), **kw)

    k2_ms = fan_time(first, False, inner=20)
    k2_plain_ms = fan_time(first, True, reps=5, warm=1)
    k2_ms_whole = fan_time(whole, False)
    k2_plain_ms_whole = fan_time(whole, True, reps=5, warm=1)
    pair_ops = FAN_OPS_PER_PAIR["general"] + FAN_OPS_MARCH

    def fan_bound(p):
        return bound_ms(13 * p * 4 + 2 * R * 4, p * R * pair_ops)

    k2_bound, k2_by = fan_bound(chunk)
    k2_bound_whole, _ = fan_bound(P)
    print(f"    {chunk} x {R}: time {k2_ms:.4f} ms  plain {k2_plain_ms:.2f} ms"
          f"  bound {k2_bound:.4f} ms ({k2_by})  [{card}]")
    print(f"    {P} x {R}: time {k2_ms_whole:.4f} ms  plain "
          f"{k2_plain_ms_whole:.2f} ms  bound {k2_bound_whole:.4f} ms "
          f"({k2_by})  [{card}]")
    kernel_rows.append(dict(
        name="fan_stats", route="cuda",
        source="photon_tpu_torch/csrc/fan_stats.cu",
        replaces="photon_tpu/ops/fan_pallas.py:216",
        shape=f"{chunk} particles x {R} rays, thick lens, march deltas",
        max_abs_err=k2_err, tolerance=K2_TOL, ms=k2_ms, plain_ms=k2_plain_ms,
        bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
        whole_image=dict(shape=f"{P} x {R}", max_abs_err=k2_err_whole,
                         ms=k2_ms_whole, plain_ms=k2_plain_ms_whole,
                         bound_ms=k2_bound_whole)))

    # ------------------------------------------------------------------
    # phase 2c: K3, the splat
    # ------------------------------------------------------------------
    print("K3 splat (csrc/splat.cu) against its plain version")
    K = auto_patch(params)
    D = params.diffraction_diameter
    okp = A > 0
    Xbar = torch.where(okp, AX / A.clamp_min(1e-30), torch.full_like(A, -1e6))
    Ybar = torch.where(okp, AY / A.clamp_min(1e-30), torch.full_like(A, -1e6))
    Asc = torch.where(okp, A, torch.zeros_like(A)) * (math.pi / 32.0)
    col0 = (torch.round(Xbar).to(torch.int32) - K // 2).clamp(0, sensor - K)
    row0 = (torch.round(Ybar).to(torch.int32) - K // 2).clamp(0, sensor - K)
    # some particles without a surviving ray, as the sentinel leaves them
    Asc[:50] = 0.0
    Xbar[:50] = -1e6
    col0[:50] = 0
    skw = dict(K=K, ny=sensor, nx=sensor, diameter=D, render_fraction=0.75)

    # tolerance: 1e-5 of the image maximum.  Kernel and plain version use the
    # same erff; about a hundred spots of a dot overlap on a pixel and float
    # atomics add them in an order that changes from run to run.
    K3_TOL = 1e-5

    def splat_case(sl, label):
        args = [a[sl].contiguous() for a in (Xbar, Ybar, Asc, col0, row0)]
        got = splat_particles(*args, **skw)
        sync()
        ref = splat_particles_plain(*args, **skw)
        err = float((got - ref).abs().max() / ref.max())
        hold(f"K3 {label} (of the image maximum)", err, K3_TOL)
        return got, err

    img_whole, k3_err_whole = splat_case(whole, f"{P} spots, K={K}, {sensor}^2")
    _, k3_err = splat_case(first, f"{chunk} spots, K={K}, {sensor}^2")
    # a large patch on a small frame with spots on its edge
    e = dict(K=40, ny=96, nx=72, diameter=20.0, render_fraction=0.75)
    ex = f32([-0.4, 71.4, 3.0, 36.0, 70.0])
    ey = f32([-0.4, 95.4, 95.0, 0.2, 50.0])
    ea = f32([1.0, 2.0, 0.5, 1.5, 0.0])
    ec = (torch.round(ex).to(torch.int32) - 20).clamp(0, 72 - 40)
    er = (torch.round(ey).to(torch.int32) - 20).clamp(0, 96 - 40)
    ge = splat_particles(ex, ey, ea, ec, er, **e)
    re_ = splat_particles_plain(ex, ey, ea, ec, er, **e)
    hold("K3 K=40 on a 72x96 frame (of the image maximum)",
         float((ge - re_).abs().max() / re_.max()), K3_TOL)

    def splat_time(sl, plain, **kw):
        args = [a[sl].contiguous() for a in (Xbar, Ybar, Asc, col0, row0)]
        fn = splat_particles_plain if plain else splat_particles
        return time_ms(lambda: fn(*args, **skw), **kw)

    k3_ms = splat_time(first, False, inner=20)
    k3_plain_ms = splat_time(first, True, reps=5, warm=1)
    k3_ms_whole = splat_time(whole, False)
    k3_plain_ms_whole = splat_time(whole, True, reps=5, warm=1)

    def splat_bound(sl):
        live = int((Asc[sl] > 0).sum())
        ar = torch.arange(K, device=dev, dtype=torch.float32)
        fc = (col0[sl, None].float() + ar[None]) - Xbar[sl, None]
        fr = (row0[sl, None].float() + ar[None]) - Ybar[sl, None]
        inc = (fc[:, None, :] ** 2 + fr[:, :, None] ** 2) <= (0.75 * D) ** 2
        deposits = int((inc & (Asc[sl] > 0)[:, None, None]).sum())
        n_p = Asc[sl].numel()
        ops = live * K * K * SPLAT_OPS_PER_PATCH_PIXEL \
            + deposits * SPLAT_OPS_PER_DEPOSIT
        return bound_ms(20 * n_p + sensor * sensor * 4, ops) + (deposits,)

    k3_bound, k3_by, k3_dep = splat_bound(first)
    k3_bound_whole, k3_by_whole, k3_dep_whole = splat_bound(whole)
    print(f"    {chunk} spots: time {k3_ms:.4f} ms  plain {k3_plain_ms:.2f} ms"
          f"  bound {k3_bound:.4f} ms ({k3_by}; {k3_dep} deposits)  [{card}]")
    print(f"    {P} spots: time {k3_ms_whole:.4f} ms  plain "
          f"{k3_plain_ms_whole:.2f} ms  bound {k3_bound_whole:.4f} ms "
          f"({k3_by_whole}; {k3_dep_whole} deposits)  [{card}]")
    kernel_rows.append(dict(
        name="splat", route="cuda", source="photon_tpu_torch/csrc/splat.cu",
        replaces="photon_tpu/ops/splat_pallas.py:59",
        also_replaces="photon_tpu/ops/splat_pallas.py:186",
        shape=f"{chunk} spots, K={K}, {sensor}x{sensor} image",
        max_abs_err=k3_err, tolerance=K3_TOL, ms=k3_ms, plain_ms=k3_plain_ms,
        bound_ms=k3_bound, bound_by=k3_by, library_ms=None,
        whole_image=dict(shape=f"{P} spots", max_abs_err=k3_err_whole,
                         ms=k3_ms_whole, plain_ms=k3_plain_ms_whole,
                         bound_ms=k3_bound_whole)))
    if failures:
        raise SystemExit(f"chip_smoke: kernel comparisons failed: {failures}")

    # ------------------------------------------------------------------
    # phase 3: the main path, through the command line entry point
    # ------------------------------------------------------------------
    print("main path: photon_tpu_torch.cli.main at full size")
    with tempfile.TemporaryDirectory(prefix="photon_smoke_") as tmp:
        nrrd = os.path.join(tmp, "rho.nrrd")
        write_nrrd(nrrd, rho.astype(np.float32), spacings, origin)
        cfg.density_gradients.density_gradient_filename = nrrd
        case = os.path.join(tmp, "case.json")
        cfg.to_json(case)
        out = os.path.join(tmp, "out")

        wrappers = dict(march_dense=march_chief_fused, fan_stats=fan_stats,
                        splat=splat_particles)
        for w in wrappers.values():
            w.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([case, "--out", out, "--verbose"])
        counts = {k: int(w.launches) for k, w in wrappers.items()}
        log = buf.getvalue()
        print("    " + log.strip().replace("\n", "\n    "))
        if rc != 0:
            raise SystemExit(f"chip_smoke: the CLI returned {rc}")
        for row in kernel_rows:
            row["launches"] = counts[row["name"]]
        print(f"    launches on the main path: {counts}")
        expect = dict(march_dense=1, fan_stats=2 * n_chunks,
                      splat=2 * n_chunks)
        if counts != expect:
            raise SystemExit(f"chip_smoke: launch counts {counts}, "
                             f"expected {expect}")

        names = ("bos_pattern_image_1", "bos_pattern_image_2")
        raws, tifs = {}, {}
        for nm in names:
            tifs[nm] = read_tiff16(os.path.join(out, "tif", nm + ".tif"))
            raws[nm] = np.fromfile(os.path.join(out, "raw", nm + ".bin"),
                                   np.float32).reshape(sensor, sensor)
            require(tifs[nm].shape == (sensor, sensor) and tifs[nm].max() > 0,
                    f"{nm}.tif does not read back")
            require(np.isfinite(raws[nm]).all() and raws[nm].sum() > 0,
                    f"{nm}.bin is not a finite image with a positive sum")
        for side in ("parameters.json", "parameters.mat", "positions.json",
                     "positions.mat"):
            require(os.path.exists(os.path.join(out, side)),
                    f"{side} was not written")
        im1, im2 = raws[names[0]], raws[names[1]]
        total = float(im1.sum())
        moved = float(np.abs(im1 - im2).sum()) / total
        require(moved > 0.05, f"im1 and im2 differ by only {moved}")
        # the volume's gradient is along x: the dots move along x only, so
        # the image's profile along y (row sums) stays and the profile
        # along x (column sums) changes
        prof_y = float(np.abs(im1.sum(1) - im2.sum(1)).sum()) / total
        prof_x = float(np.abs(im1.sum(0) - im2.sum(0)).sum()) / total
        # per-dot centroid shift, dots well inside the frame
        pitch = cfg.camera_design.pixel_pitch
        pc = (sensor - 1) - ((-dot_x * m) + pitch * (sensor - 1) / 2) / pitch
        pr = ((-dot_y * m) + pitch * (sensor - 1) / 2) / pitch

        def centroid(im, c, r, rad=12):
            r0, c0 = int(round(r)), int(round(c))
            win = im[r0 - rad:r0 + rad + 1, c0 - rad:c0 + rad + 1]
            yy, xx = np.mgrid[-rad:rad + 1, -rad:rad + 1]
            return (win * xx).sum() / win.sum(), (win * yy).sum() / win.sum()

        shifts = np.array([np.subtract(centroid(im2, c, r), centroid(im1, c, r))
                           for c, r in zip(pc, pr)
                           if 40 < c < sensor - 40 and 40 < r < sensor - 40])
        med_x, med_y = np.median(shifts, axis=0)
        print(f"    im1 sum {total:.6g}, im2 sum {float(im2.sum()):.6g}, "
              f"|im1-im2|/sum {moved:.3f}; profile change along x "
              f"{prof_x:.3f}, along y {prof_y:.4f}; median dot shift "
              f"({med_x:+.3f}, {med_y:+.3f}) px over {len(shifts)} dots")
        require(prof_x > 0.2 and prof_y < 0.1 * prof_x
                and abs(med_x) > 0.5 and abs(med_y) < 0.05 * abs(med_x),
                "the dots do not move along x only")

        # im2 against a render of the same scene through the plain versions
        vol_file = load_density_volume(
            nrrd, gladstone_dale=cfg.density_gradients.gladstone_dale,
            device=dev)
        x1, y1, z1, dx1, dy1, dz1 = march_chief_dense(vol_file, *chief,
                                                      algorithm=2)
        t_exit = (z1 - chief[2]) / chief[5]
        d6_plain = (z1, x1 - (chief[0] + chief[3] * t_exit),
                    y1 - (chief[1] + chief[4] * t_exit),
                    dx1 - chief[3], dy1 - chief[4], dz1 - chief[5])
        amp2 = f32(source.radiance) * float(np.float32(
            (8.0 / math.pi) / params.aperture_f_number ** 2
            * lens_params[6]))                           # with transmission
        plain2 = torch.zeros((sensor, sensor), dtype=torch.float32,
                             device=dev)
        for s0 in range(0, P, chunk):
            sl = slice(s0, min(s0 + chunk, P))
            pA, pAX, pAY = fan_stats_plain(
                xs[sl], ys[sl], zs[sl], amp2[sl],
                tuple(d[sl] for d in d6_plain), x_lens, y_lens, sc=sc,
                lens_model="general", mirror_x=True)
            on = pA > 0
            pX = torch.where(on, pAX / pA.clamp_min(1e-30),
                             torch.full_like(pA, -1e6))
            pY = torch.where(on, pAY / pA.clamp_min(1e-30),
                             torch.full_like(pA, -1e6))
            plain2 += splat_particles_plain(
                pX, pY, torch.where(on, pA, torch.zeros_like(pA))
                * (math.pi / 32.0),
                (torch.round(pX).to(torch.int32) - K // 2).clamp(0, sensor - K),
                (torch.round(pY).to(torch.int32) - K // 2).clamp(0, sensor - K),
                **skw)
        plain2 = plain2.cpu().numpy()
        l1 = float(np.abs(im2 - plain2).sum() / plain2.sum())
        print(f"    im2 against the plain render: L1 {l1:.3e} of the sum "
              f"(tolerance 1.0e-03)")
        require(l1 < 1e-3, f"im2 is {l1} (L1) from the plain render")
        require(counts == {k: int(w.launches) for k, w in wrappers.items()},
                "the plain render launched a kernel")

        # run to run: float atomics in the splat
        again = run_bos(cfg, device=dev)
        sync()
        rr = max(float(np.abs(again.raw_images[nm] - raws[nm]).max()
                       / raws[nm].max()) for nm in names)
        print(f"    two runs differ by at most {rr:.3e} of the image maximum "
              f"(bound 1.0e-05)")
        require(rr <= 1e-5, f"two runs differ by {rr} of the maximum")

        # what the chunk loop costs: the same pair with one chunk an image
        # (the kernels hold no (P, R) array, so the ray budget bounds nothing)
        whole_img = run_bos(cfg, rays_per_chunk=P * R, device=dev)
        dw = max(float(np.abs(whole_img.raw_images[nm] - raws[nm]).max()
                       / raws[nm].max()) for nm in names)
        require(dw <= 1e-5, f"one chunk an image differs by {dw}")
        for nm, dt in whole_img.timer.phases.items():
            if nm.startswith("render:"):
                print(f"    one chunk an image, {nm}: {dt:.4f} s, "
                      f"{whole_img.timer.rays[nm] / dt / 1e6:.1f}M rays/s "
                      f"(differs from the chunked image by {dw:.1e} of the "
                      f"maximum)  [{card}]")

        # where the device's time goes on the main path: one more run under
        # torch.profiler (CUPTI); host times under the profiler are inflated,
        # so the busy share is device time over the second run's wall time
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_bos(cfg, device=dev)
            sync()
        dev_events = [ev for ev in prof.key_averages()
                      if "CUDA" in str(getattr(ev, "device_type", "")).upper()]
        dev_us = sum(ev.self_device_time_total for ev in dev_events)
        render_s = sum(dt for nm, dt in again.timer.phases.items()
                       if nm.startswith("render:"))
        if dev_us > 0:
            tags = dict(march_dense="march_dense_kernel",
                        fan_stats="fan_stats_kernel", splat="splat_kernel")
            for row in kernel_rows:
                evs = [ev for ev in dev_events if tags[row["name"]] in ev.key]
                n_ev = sum(ev.count for ev in evs)
                us = sum(ev.self_device_time_total for ev in evs)
                row["device_ms_on_main_path"] = us / max(n_ev, 1) / 1e3
                print(f"    traced {row['name']}: {n_ev} launches, "
                      f"{us / 1e3:.3f} ms on the device in all, "
                      f"{us / max(n_ev, 1):.1f} us a launch  [{card}]")
            ours = sum(ev.self_device_time_total for ev in dev_events
                       if any(t in ev.key for t in tags.values()))
            print(f"    traced run_bos: device busy {dev_us / 1e3:.2f} ms in "
                  f"all kernels and copies, {ours / 1e3:.2f} ms of it in the "
                  f"three kernels; the render phases of the untraced second "
                  f"run took {render_s * 1e3:.1f} ms, so the device was busy "
                  f"for about {dev_us / 1e6 / render_s:.1%} of "
                  f"them (an upper estimate: the two times come from "
                  f"different runs)  [{card}]")
        else:
            print("    traced run_bos: the profiler reported no device time; "
                  "device busy share not measured")

        for line in log.splitlines():
            mt = re.match(r"\s*(render:\S+): ([0-9.]+)s\s+([0-9.]+)M rays/s",
                          line)
            if mt:
                print(f"    {mt.group(1)}: {mt.group(2)} s, {mt.group(3)}M "
                      f"rays/s  [{card}]")
        for nm, dt in again.timer.phases.items():
            rays = again.timer.rays.get(nm)
            extra = f", {rays / dt / 1e6:.1f}M rays/s" if rays else ""
            print(f"    second run {nm}: {dt:.4f} s{extra}  [{card}]")

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
