#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and nothing from the network.  It

1. prints the card (name and power limit as nvidia-smi gives them), the
   torch / CUDA versions, and builds the kernel libraries of
   photon_tpu_torch/csrc from source;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it (and at the whole-image shapes), with the
   tolerance printed, and times both with CUDA events: the three forward
   kernels (march, fan statistics, splat), the march's stage-residual head,
   and the four backward kernels (march over the residual, march by
   re-marching, fan, splat transpose) against torch.autograd through the
   plain forward versions; the march kernels at both interpolation schemes,
   and the per-stage slab sampler with its backward;
3. drives the rendering path once through the command line entry point
   (photon_tpu_torch.cli.main -> run_simulation -> run_bos -> save_result):
   the BOS image pair at 1024 x 1024, 1000 dots x ~100 source points,
   500 rays each, RK4 through a 64^3 density volume; checks the artifacts,
   the launch counters, the images against a render through the plain
   versions, and the run-to-run difference of the atomics-based splat;
4. drives the inversion path: photon_tpu_torch.inverse.invert_bos takes five
   Adam steps on the density grid of the same scene against the rendered
   im2; checks the losses, the launch counters of every forward and
   backward kernel, and the first gradient against the same step through
   the plain versions at every tenth particle;
5. drives the rest of the dense march's menu through the same entry points
   at the same size: the pair with tricubic interpolation and algorithm 3
   (the prefilter, choose_substeps, the cubic march kernel) and the pair with
   Adams-Bashforth (the per-stage route over the sampler kernel); launch
   counts, im2 against a render through the plain versions;
6. takes one forward and backward of invert_bos's render loss through each
   new gradient route at full size (RK4 with substeps and Adams-Bashforth
   over the sampler kernels; tricubic RK4 over the cubic march kernels, by
   stage residual and by re-march) and holds each d_rho against the plain
   versions at every tenth particle;
7. holds the same march kernels on volumes whose slab exceeds 256 x 256
   voxels (phase 2j: the counterpart of the TPU's windowed march and its
   backward): random 320 x 224 x 6 and 140 x 116 x 8 volumes with rays that
   leave sideways, then the bench scene's 120,000 chief rays through a 512^3
   volume built on the device (2.15 GB), both heads, both backward kernels,
   rays in input and in shuffled order (a cone that stays near the L2) and
   as many rays spread over the whole slab (the reading beyond it), with
   the voxels each set touches, and the sampler pair on one 512 x 512 slab
   pair;
8. drives such volumes through the entry points (phase 7: the pair through
   the command line on a 288 x 288 x 64 NRRD; render_image_fast through the
   512^3 volume with RK4, tricubic RK4 and Adams-Bashforth) and
   differentiates through them (phase 8: one forward and backward of
   mean(img^2) with respect to the 512^3 field by stage residual and by
   re-march, with Adams-Bashforth and with tricubic interpolation; two steps
   of invert_bos on the 512^3 density grid), with launch counts per tier and
   peak device memory;
9. prints one JSON line describing the kernels and, last, one JSON line
   {"ok": true, "device": {...}}.

``--large-only`` runs the build and items 7 and 8 alone.

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
# backward kernels: one stage's sample recompute and VJP (coordinates 15,
# weights 10, blend 68, rhs 7, cotangents 20, scatter products 40, tap dots
# 56, coordinate cotangents 45) and the per-slab combine
MARCH_VJP_OPS_PER_STAGE = 260
MARCH_VJP_OPS_PER_COMBINE = 120
# the cubic scheme (4 x 4 x 2 taps): a sample is 2 x 4 B-spline weights (96),
# 32 weighted 4-channel taps (288) and the z blend (12), with the clamps 410;
# its VJP adds the weights' derivatives (80) and per tap-pair two dot
# products, two scatter products and the coordinate sums (33 x 16)
SAMPLE_OPS = {1: 78, 2: 410}
SAMPLE_VJP_OPS = {1: 150, 2: 700}      # beside the taps it gathers again
MARCH_OPS_PER_RHS_CUBIC = 15 + SAMPLE_OPS[2] + 7
MARCH_VJP_OPS_PER_STAGE_CUBIC = (MARCH_OPS_PER_RHS_CUBIC + 20
                                 + SAMPLE_VJP_OPS[2])
# fan backward sweep per pair, on top of the forward recompute
FAN_BWD_OPS_PER_PAIR = {"general": 420, "thin-lens": 150, "apparent": 110}
FAN_BWD_OPS_MARCH = 35
SPLAT_BWD_OPS_PER_DEPOSIT = 165   # four erff, four expf (~15 each), products


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


BENCH_SENSOR, BENCH_DOTS, BENCH_RAYS = 1024, 1000, 500


def bench_scene():
    """The scene both paths are driven at (the JAX package's bench scene):
    1024^2 sensor, 1000 dots x ~100 source points, 500 rays each, a 64^3
    volume with a density ramp along x.  Returns the config, the camera
    setup, rho (W, H, D) and the volume's spacings and origin."""
    import numpy as np

    from photon_tpu_torch.config import default_config
    from photon_tpu_torch.models.optics import camera_setup

    cfg = default_config("bos")
    cfg.camera_design.x_pixel_number = BENCH_SENSOR
    cfg.camera_design.y_pixel_number = BENCH_SENSOR
    cfg.bos_pattern.grid_point_number = BENCH_DOTS
    cfg.bos_pattern.particle_number_per_grid_point = 100
    cfg.bos_pattern.lightray_number_per_particle = BENCH_RAYS
    cfg.density_gradients.simulate_density_gradients = True
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)
    half = 0.8 * BENCH_SENSOR * cfg.camera_design.pixel_pitch / 2.0 / m
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
    return cfg, setup, rho, spacings, origin


def write_bench_case(directory, cfg, rho, spacings, origin):
    """Write the scene as a case for the command line (case.json beside
    rho.nrrd, which the config is pointed at); returns the two paths."""
    import numpy as np

    from photon_tpu_torch.utils.nrrd_io import write_nrrd

    nrrd = os.path.join(directory, "rho.nrrd")
    write_nrrd(nrrd, rho.astype(np.float32), spacings, origin)
    cfg.density_gradients.density_gradient_filename = nrrd
    case = os.path.join(directory, "case.json")
    cfg.to_json(case)
    return case, nrrd


def bench_volume_512(setup, dev, n=512):
    """The structured large volume of the JAX package's bench (bench.py,
    ``build_vol512``), built on the device from three 1-D factors so that no
    2 GB array crosses from the host: rho = 1.225 + 2 g(x) g(y) g(z) with
    Gaussian factors (sigma 0.35 of each extent), the gradient channels the
    analytic derivatives, ``data_min = K * 1.225``.  Returns the volume and
    ``(gx, gz, amplitude)``, from which rho is rebuilt on the device."""
    import numpy as np
    import torch

    from photon_tpu_torch.volume import Z_ORIGIN_SHIFT, DensityVolume

    x = np.linspace(-1.5e5, 1.5e5, n)
    z = np.linspace(setup.object_distance - 5e5, setup.object_distance - 1e2,
                    n)
    K, amp = 0.225e-3, 2.0
    sig_l = 0.35 * (x.max() - x.min())
    sig_z = 0.35 * (z.max() - z.min())
    zc = 0.5 * (z.min() + z.max())
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    gx = f32(np.exp(-(x / sig_l) ** 2 / 2.0))
    gz = f32(np.exp(-((z - zc) / sig_z) ** 2 / 2.0))
    dgx = f32(-(x / sig_l ** 2))
    dgz = f32(-((z - zc) / sig_z ** 2))
    # field[z, y, x, c]; c = (K drho/dx, K drho/dy, K drho/dz, K rho)
    g3 = gz[:, None, None] * gx[None, :, None] * gx[None, None, :]
    ka = float(np.float32(K * amp))
    field = torch.empty((n, n, n, 4), dtype=torch.float32, device=dev)
    field[..., 0] = ka * g3 * dgx[None, None, :]
    field[..., 1] = ka * g3 * dgx[None, :, None]
    field[..., 2] = ka * g3 * dgz[:, None, None]
    field[..., 3] = float(np.float32(K)) * (1.225 + amp * g3)
    spac = np.array([x[1] - x[0], x[1] - x[0], z[1] - z[0]])
    origin = np.array([x[0], x[0], z[0] - Z_ORIGIN_SHIFT])
    vol = DensityVolume(
        field=field, min_bound=origin.astype(np.float32),
        max_bound=(origin + (n - 1.0) * spac).astype(np.float32),
        grid_spacing=spac.astype(np.float32), data_min=float(K * 1.225),
        step_size=float(spac.min()), max_step_size=float(spac.max()))
    return vol, (gx, gz, amp)


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--large-only", action="store_true",
                    help="after the build, run the large-volume phases (2j, "
                    "7, 8) alone; the kernels line then lists their rows only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from photon_tpu_torch import kernels
    from photon_tpu_torch.cli import main as cli_main
    from photon_tpu_torch.models.render import RenderParams
    from photon_tpu_torch.models.render_fast import (_chief_geometry,
                                                     auto_patch, fan_scalars)
    import dataclasses

    from photon_tpu_torch.inverse import invert_bos, volume_from_rho
    from photon_tpu_torch.models import render_fast
    from photon_tpu_torch.models.render_fast import render_image_fast
    from photon_tpu_torch.models.scenes import bos_source
    from photon_tpu_torch.ops import march_dense_fused as mdf
    from photon_tpu_torch.ops.fan import (fan_constants, fan_stats,
                                          fan_stats_backward, fan_stats_plain)
    from photon_tpu_torch.ops.march_dense import (bspline_prefilter,
                                                  chief_deltas_dense,
                                                  march_chief_dense,
                                                  march_geometry)
    from photon_tpu_torch.ops.march_dense_fused import (
        march_backward_remarch, march_backward_stage, march_chief_fused,
        march_forward_residual)
    from photon_tpu_torch.ops.march_dense_sampler import (
        slab_sample_backward, slab_sample_forward, slab_sample_plain)
    from photon_tpu_torch.ops.splat import (splat_backward, splat_particles,
                                            splat_particles_plain)
    from photon_tpu_torch.pipeline import _lens_sample_pair, _ray_budget, run_bos
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
    sensor, n_dots, rays_per = BENCH_SENSOR, BENCH_DOTS, BENCH_RAYS
    cfg, setup, rho, spacings, origin = bench_scene()
    n = rho.shape[0]
    m = cfg.lens_design.focal_length / (
        cfg.lens_design.object_distance - cfg.lens_design.focal_length)

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
    # what every phase shares: the chief rays, the fan's scalars, the splat's
    # settings, tolerances and helpers (nothing here launches a kernel)
    # ------------------------------------------------------------------
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

    K = auto_patch(params)
    D = params.diffraction_diameter
    skw = dict(K=K, ny=sensor, nx=sensor, diameter=D, render_fraction=0.75)

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    # limits of the JAX package's own fused-vs-autodiff tests
    # (tests/test_dense_fused.py): 5e-4 of the largest field gradient, 1e-3
    # of the largest entry-state gradient.  Kernel and plain version differ
    # by FMA contraction, by the order of the sum over rays (atomics against
    # index_add) and, for K5, by the reconstruction of the stage states.
    # Where those maxima are no measure (march_bwd_case, `kinked`): 1 - cosine
    # at most 1e-4, that package's bound for its gradient beyond the slab cap
    # (tests/test_march_window.py).
    MARCH_FIELD_TOL, MARCH_STATE_TOL, MARCH_COSINE_TOL = 5e-4, 1e-3, 1e-4

    def nerr(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    def march_grads(fn, v, rays, cts, alg, scheme=1, ray_slice=None):
        """Gradients of the march with respect to the field and the rays;
        `ray_slice` rays at a time (the field's sums over the slices, the
        rays' concatenate), which bounds the graph of the plain cubic
        march."""
        n_r = rays[0].shape[0]
        d_fld, d_rr = None, []
        for s0 in range(0, n_r, ray_slice or n_r):
            sl = slice(s0, min(s0 + (ray_slice or n_r), n_r))
            fld = v.field.detach().clone().requires_grad_(True)
            rr = [r[sl].detach().clone().requires_grad_(True) for r in rays]
            outs = fn(v._replace(field=fld), *rr, algorithm=alg,
                      interpolation_scheme=scheme)
            g = torch.autograd.grad(outs, [fld] + rr,
                                    grad_outputs=[c[sl] for c in cts])
            d_fld = g[0] if d_fld is None else d_fld + g[0]
            d_rr.append(g[1:])
        return (d_fld,) + tuple(torch.cat(c) for c in zip(*d_rr))

    def with_budget(nbytes, fn):
        """fn() with the stage residual's budget, of both tiers, at nbytes."""
        saved = mdf.TRAJ_MAX_BYTES, mdf.TRAJ_MAX_BYTES_LARGE
        mdf.TRAJ_MAX_BYTES = mdf.TRAJ_MAX_BYTES_LARGE = nbytes
        try:
            return fn()
        finally:
            mdf.TRAJ_MAX_BYTES, mdf.TRAJ_MAX_BYTES_LARGE = saved

    def cosine(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()))

    def all_but_a_hundredth(diff):
        """The 99th percentile of |diff|."""
        flat = diff.abs().flatten()
        return float(flat.kthvalue(max(1, int(0.99 * flat.numel()))).values)

    def march_bwd_case(v, rays, alg, label, scheme=1, ray_slice=None,
                       kinked=False, seed=None):
        """K4 and K5 against autograd through the plain march.  `kinked`: the
        trilinear interpolant of a noise field has a gradient that jumps at
        every voxel face, so a ray whose stage lands within the two sides'
        rounding of a face gets another Jacobian on each side; a few rays in
        a thousand then differ by percents of the maximum while the median
        ray agrees to 1e-6.  Such a case is held by the cosine (1 - cosine
        at most 1e-4, the JAX package's bound for this volume) and by all
        but one entry in a hundred at the limits of the other cases; its
        largest difference is printed.  K4 against K5 is held at the maximum
        everywhere: the two meet the same kinks.  K5 runs with the defect
        corrections that the dispatch chooses from the field; where the
        dispatch refuses the re-march (its reconstruction does not converge
        on this field), the case holds that it raises.  `seed`: of the
        cotangents, where a case must not depend on what ran before it."""
        n_r = rays[0].shape[0]
        gen_c = gen
        if seed is not None:
            gen_c = torch.Generator(device=dev)
            gen_c.manual_seed(seed)
        cts = [torch.randn(n_r, generator=gen_c, device=dev) * sc_
               for sc_ in (1.0, 1.0, 1.0, 1e5, 1e5, 1e5)]
        g4 = march_grads(march_chief_fused, v, rays, cts, alg, scheme)
        gp = march_grads(march_chief_dense, v, rays, cts, alg, scheme,
                         ray_slice)
        fld = bspline_prefilter(v.field) if scheme == 2 else v.field
        gg = march_geometry(v)
        contraction = mdf.remarch_contraction(fld, gg)
        del fld

        def rows(gr):
            return torch.stack([a / b.abs().max().clamp_min(1e-30)
                                for a, b in zip(gr[1:], gp[1:])])

        def remarch():
            return with_budget(0, lambda: march_grads(
                march_chief_fused, v, rays, cts, alg, scheme))

        if contraction >= mdf.REMARCH_MAX_CONTRACTION:
            try:
                remarch()
                refused = False
            except ValueError:
                refused = True
            print(f"    K5 {label}: a defect correction changes the error by "
                  f"{contraction:.2f}: the dispatch "
                  f"{'refuses the re-march' if refused else 'DID NOT REFUSE'}")
            if not refused:
                failures.append(f"K5 {label}: not refused")
            cases = (("K4", g4),)
        else:
            print(f"    K5 {label}: a defect correction changes the error by "
                  f"{contraction:.3f}, "
                  f"{mdf.defect_iterations(gg, contraction)} corrections")
            cases = (("K4", g4), ("K5", remarch()))
        sync()

        errs = {}
        for nm, gk in cases:
            errs[nm] = (nerr(gk[0], gp[0]),
                        max(nerr(a, b) for a, b in zip(gk[1:], gp[1:])))
            if kinked:
                hold(f"{nm} {label}: d_field, 1 - cosine (largest difference "
                     f"{errs[nm][0]:.1e} of its maximum)",
                     1.0 - cosine(gk[0], gp[0]), MARCH_COSINE_TOL)
                hold(f"{nm} {label}: cotangents of the rays, 1 - cosine "
                     f"(largest difference {errs[nm][1]:.1e} of their "
                     f"maxima)", 1.0 - cosine(rows(gk), rows(gp)),
                     MARCH_COSINE_TOL)
                hold(f"{nm} {label}: d_field, 99 in 100 entries (of its "
                     f"maximum)", all_but_a_hundredth(
                         (gk[0] - gp[0]) / gp[0].abs().max()),
                     MARCH_FIELD_TOL)
                hold(f"{nm} {label}: cotangents of the rays, 99 in 100 "
                     f"entries (of their maxima)",
                     all_but_a_hundredth(rows(gk) - rows(gp)),
                     MARCH_STATE_TOL)
            else:
                hold(f"{nm} {label}: d_field (of its maximum)", errs[nm][0],
                     MARCH_FIELD_TOL)
                hold(f"{nm} {label}: cotangents of the rays (of their "
                     f"maxima)", errs[nm][1], MARCH_STATE_TOL)
            if not bool(torch.isfinite(torch.stack(
                    [g.abs().max() for g in gk])).all()):
                failures.append(f"{nm} {label}: not finite")
        if len(cases) == 2:
            hold(f"K4 against K5 {label}: d_field (of its maximum)",
                 nerr(g4[0], cases[1][1][0]), MARCH_FIELD_TOL)
        return errs

    amp2 = f32(source.radiance) * float(np.float32(
        (8.0 / math.pi) / params.aperture_f_number ** 2
        * lens_params[6]))                               # with transmission

    def plain_render(v, sel, algorithm=2, scheme=1, substeps=None):
        """The image of the particles `sel` through the plain versions
        only (differentiable with respect to v.field)."""
        ch = tuple(c[sel] for c in chief)
        x1, y1, z1, dx1, dy1, dz1 = march_chief_dense(
            v, *ch, algorithm=algorithm, interpolation_scheme=scheme,
            substeps=substeps)
        t_exit = (z1 - ch[2]) / ch[5]
        d6p = (z1, x1 - (ch[0] + ch[3] * t_exit),
               y1 - (ch[1] + ch[4] * t_exit),
               dx1 - ch[3], dy1 - ch[4], dz1 - ch[5])
        cols = [a[sel] for a in (xs, ys, zs, amp2)]
        img = torch.zeros((sensor, sensor), dtype=torch.float32, device=dev)
        n_sel = cols[0].shape[0]
        for s0 in range(0, n_sel, chunk):
            sl = slice(s0, min(s0 + chunk, n_sel))
            pA, pAX, pAY = fan_stats_plain(
                *(c[sl] for c in cols), tuple(d[sl] for d in d6p), x_lens,
                y_lens, sc=sc, lens_model="general", mirror_x=True)
            on = pA > 0
            pX = torch.where(on, pAX / pA.clamp_min(1e-30),
                             torch.full_like(pA, -1e6))
            pY = torch.where(on, pAY / pA.clamp_min(1e-30),
                             torch.full_like(pA, -1e6))
            img = img + splat_particles_plain(
                pX, pY, torch.where(on, pA, torch.zeros_like(pA))
                * (math.pi / 32.0),
                (torch.round(pX).to(torch.int32) - K // 2).clamp(0, sensor - K),
                (torch.round(pY).to(torch.int32) - K // 2).clamp(0, sensor - K),
                **skw)
        return img

    def large_tier():
        """Phases 2j, 7 and 8: volumes whose slab exceeds 256 x 256 voxels,
        through the same kernels.  Returns the rows it adds to the kernels
        line."""
        from torch.profiler import ProfilerActivity, profile
        rows = []
        gen_l = torch.Generator(device=dev)
        gen_l.manual_seed(12)
        everyone, tenth = slice(0, P), slice(0, P, 10)
        sub_src = dataclasses.replace(
            source, x=source.x[tenth], y=source.y[tenth], z=source.z[tenth],
            radiance=source.radiance[tenth],
            diameter_index=source.diameter_index[tenth])
        wrappers = dict(
            march=march_chief_fused, march_bwd_stage=march_backward_stage,
            march_bwd_remarch=march_backward_remarch,
            slab_sample=slab_sample_forward,
            slab_sample_bwd=slab_sample_backward, fan_stats=fan_stats,
            fan_stats_bwd=fan_stats_backward, splat=splat_particles,
            splat_bwd=splat_backward)
        tiered = ("march", "march_bwd_stage", "march_bwd_remarch",
                  "slab_sample", "slab_sample_bwd")

        def counted(fn):
            """fn's result, the launches of every wrapper during it, and of
            the march and sampler wrappers those on a slab over 256 x 256."""
            for k, w in wrappers.items():
                w.launches = 0
                if k in tiered:
                    w.launches_large = 0
            out_ = fn()
            sync()
            return (out_, {k: int(w.launches) for k, w in wrappers.items()},
                    {k: int(wrappers[k].launches_large) for k in tiered})

        def with_peak(fn):
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            out_ = fn()
            sync()
            return out_, torch.cuda.max_memory_allocated(dev) / 1e9

        def expect_counts(label, got_counts, want):
            for k, v in want.items():
                require(got_counts[k] == v, f"{label}: {k} launched "
                        f"{got_counts[k]} times, expected {v}")

        def device_time(prof_, tag=None):
            evs = [ev for ev in prof_.key_averages()
                   if "CUDA" in str(getattr(ev, "device_type", "")).upper()]
            if tag is not None:
                evs = [ev for ev in evs if tag in ev.key]
            return (sum(ev.self_device_time_total for ev in evs) / 1e3,
                    sum(ev.count for ev in evs))

        def in_band_steps(v, rays):
            """Ray-slab steps that this run's rays take through v."""
            gg = march_geometry(v)
            z_in = torch.where(rays[2] >= float(gg.z_max),
                               torch.full_like(rays[2], float(gg.z_max)),
                               rays[2])
            ins = (z_in >= float(gg.z_min)) & (rays[5] < 0)
            pl = f32(gg.z_planes(int(v.sizes[2])))
            return int(((z_in[:, None] > pl[None, :]) & ins[:, None]).sum())

        def touched_voxels(v, rays, slabs_at_once=16):
            """Distinct voxels of v.field under the 2 x 2 x 2 footprints of
            these rays' trilinear samples: at the top, the middle and the
            bottom of every slab a ray crosses (where RK4 samples), on both
            planes of the slab's pair.  Straight rays: this volume bends
            them by far less than a voxel.  It is what the march must read
            of the field."""
            gg = march_geometry(v)
            w, h, d = (int(n_) for n_ in v.sizes)
            x0, y0, z0, cx, cy, cz = rays
            z_max = float(gg.z_max)
            z_in = torch.where(z0 >= z_max, torch.full_like(z0, z_max), z0)
            inside = (z_in >= float(gg.z_min)) & (cz < 0)
            planes = f32(gg.z_planes(d))                    # top-down
            above = torch.cat([planes.new_tensor([z_max]), planes[:-1]])
            mask = torch.zeros((d, h * w), dtype=torch.bool, device=dev)
            for s0 in range(0, d - 1, slabs_at_once):
                zb = planes[s0:s0 + slabs_at_once, None]
                zt = torch.minimum(above[s0:s0 + slabs_at_once, None],
                                   z_in[None])
                band = inside[None] & (zt > zb)
                ks = (d - 2 - torch.arange(s0, s0 + zb.shape[0], device=dev)
                      )[:, None].expand_as(band)[band]
                for frac in (0.0, 0.5, 1.0):
                    t = (zt + frac * (zb - zt) - z0[None]) / cz[None]
                    ux = 0.5 + (x0[None] + cx[None] * t
                                - float(gg.min_x)) / float(gg.sx)
                    uy = 0.5 + (y0[None] + cy[None] * t
                                - float(gg.min_y)) / float(gg.sy)
                    ix = ux.clamp(0.0, w - 1.0).long().clamp_max(w - 2)
                    iy = uy.clamp(0.0, h - 1.0).long().clamp_max(h - 2)
                    o00 = (iy * w + ix)[band]
                    for plane in (ks, ks + 1):
                        for tap in (0, 1, w, w + 1):
                            mask[plane, o00 + tap] = True
            return int(mask.sum())

        # --------------------------------------------------------------
        # phase 2j (i): small volumes of the large tier, every kernel of the
        # march against its plain version
        # --------------------------------------------------------------
        print("phase 2j: the march kernels on slabs over 256 x 256 voxels "
              "(the counterpart of the TPU's windowed march and its backward) "
              "against the plain march and autograd through it")

        def random_volume(w, h, d, seed, half_x, noise=0.08):
            """`noise` kg/m^3 of density noise on a (w, h, d) grid of square
            voxels between z = 4e5 and 9e5 um."""
            rng = np.random.default_rng(seed)
            vox = 2.0 * half_x / (w - 1)
            v = build_density_volume(
                1.225 + noise * rng.random((w, h, d)),
                [vox, vox, 5.0e5 / (d - 1)], [-half_x, -half_x * h / w, 4.0e5],
                device=dev)
            return v, vox, rng

        def downward(rng, p, half_x, half_y):
            """Downward rays from above the volume: 64 start beyond its +x
            face, 256 near that face with a slope that takes them out of
            it sideways on the way down."""
            x0 = rng.uniform(-half_x, half_x, p)
            y0 = rng.uniform(-half_y, half_y, p)
            tx = rng.uniform(-0.02, 0.02, p)
            ty = rng.uniform(-0.01, 0.01, p)
            x0[:64] = rng.uniform(1.1, 1.3, 64) * half_x
            x0[64:320] = rng.uniform(0.8, 0.95, 256) * half_x
            tx[64:320] = 0.08
            inv = 1.0 / np.sqrt(tx * tx + ty * ty + 1.0)
            return [f32(a) for a in (x0, y0, np.full(p, 1.0e6), tx * inv,
                                     ty * inv, -inv)]

        # These grids are a hundred times coarser along z than across, and
        # 0.08 kg/m^3 of voxel noise (the JAX package's test volume) makes a
        # step's Jacobian d(exit) / d(entry) differ from the identity by
        # about h^2 |d^2 n / dx^2| ~ 0.6 (320 wide) and 0.1 (140 wide): the
        # reverse reconstruction of the re-march backward (K5, and the TPU
        # kernel it replaces) converges slowly or not at all there.  The
        # dispatch reads that from the field (remarch_contraction), gives K5
        # the corrections it needs and refuses it where none would do; every
        # case below holds whichever of the two the field calls for, on the
        # same grids with 0.08, 0.008 and 0.002 kg/m^3 of noise.  K4 is
        # held at its maxima but for the three trilinear RK4 cases in which
        # a few rays meet a kink of the interpolant (volumes, rays and
        # cotangents come from seeds, so the cases repeat).
        kinks_show = {(320, 0.08), (320, 0.008), (140, 0.008)}
        for w_, h_, d_, seed_, half_ in ((320, 224, 6, 11, 9e4),
                                         (140, 116, 8, 4, 6e4)):
            v_, vox_, rng_ = random_volume(w_, h_, d_, seed_, half_)
            v_mid = random_volume(w_, h_, d_, seed_, half_, noise=0.008)[0]
            v_calm = random_volume(w_, h_, d_, seed_, half_, noise=0.002)[0]
            rays_ = downward(rng_, 4096, 0.94 * half_, 0.45 * vox_ * h_)
            gg_ = march_geometry(v_)
            gnp_ = np.asarray(gg_, dtype=np.float32)
            sc_v = float(max(abs(float(t)) for t in
                             (gg_.min_x, gg_.min_y, gg_.z_min, gg_.z_max)))
            vname = f"{w_} x {h_} x {d_}"
            is_large = w_ * h_ > 256 * 256
            print(f"    {vname} ({'over' if is_large else 'under'} 256 x 256"
                  f"{'' if w_ % 32 == 0 and h_ % 8 == 0 else '; W, H no multiples of 32, 8'}"
                  f"), 4096 rays")
            rays6_ = torch.stack(rays_).contiguous()
            for scheme in (1, 2):
                fld_ = bspline_prefilter(v_.field) if scheme == 2 else v_.field
                for alg, ss, label in ((2, None, "RK4"), (1, None, "Euler"),
                                       (3, 2, "RK4 x 2 substeps")):
                    (g, _, lg) = counted(lambda: march_chief_fused(
                        v_, *rays_, algorithm=alg, substeps=ss,
                        interpolation_scheme=scheme))
                    r = march_chief_dense(v_, *rays_, algorithm=alg,
                                          substeps=ss,
                                          interpolation_scheme=scheme)
                    pe, de = march_err(g, r)
                    hold(f"K1 scheme {scheme} {label}, {vname} (normalised)",
                         max(pe / sc_v, de), K1_TOL)
                    require(lg["march"] == (1 if is_large else 0),
                            f"{vname}: launches_large {lg['march']}")
                    if ss is not None:
                        continue
                    out_t = march_forward_residual(fld_, rays6_, gnp_, alg,
                                                   True, scheme)[0]
                    out_p = mdf.march_forward_noresidual(fld_, rays_, gnp_,
                                                         alg, 1, scheme)
                    hold(f"K1 scheme {scheme} {label}, {vname}: values of the "
                         f"residual head that differ from the plain head",
                         float((out_t != out_p).sum()), 0.0)
                    for vv, noise in ((v_, 0.08), (v_mid, 0.008),
                                      (v_calm, 0.002)):
                        march_bwd_case(
                            vv, rays_, alg, f"scheme {scheme} {label}, {vname}, "
                            f"noise {noise}", scheme=scheme,
                            kinked=(scheme, alg) == (1, 2)
                            and (w_, noise) in kinks_show, seed=7)
            moved = float((g[3][:320] - rays_[3][:320]).abs().max())
            require(moved > 0, f"{vname}: the rays at the +x face are not bent")
            del v_, v_mid, v_calm, fld_, rays6_

        # --------------------------------------------------------------
        # phase 2j (ii): the 512^3 volume and the bench scene's chief rays
        # --------------------------------------------------------------
        n5 = 512
        (vol5, rho5_factors), vol5_gb = with_peak(
            lambda: bench_volume_512(setup, dev, n5))
        g5 = march_geometry(vol5)
        gnp5 = np.asarray(g5, dtype=np.float32)
        scale5 = float(max(abs(float(t)) for t in
                           (g5.min_x, g5.min_y, g5.z_min, g5.z_max)))
        field5_bytes = vol5.field.numel() * 4
        steps5 = in_band_steps(vol5, chief)
        contraction5 = mdf.remarch_contraction(vol5.field, g5)
        iters5 = mdf.defect_iterations(g5, contraction5)
        print(f"    {n5}^3 volume built on the device: field "
              f"{field5_bytes / 1e9:.2f} GB (peak {vol5_gb:.2f} GB while "
              f"building); {P} chief rays take {steps5} ray-slab steps "
              f"({steps5 / P:.1f} a ray); K5 with {iters5} defect "
              f"corrections (one changes the reconstruction error by "
              f"{contraction5:.2e})  [{card}]")
        got5 = march_chief_fused(vol5, *chief, algorithm=2)
        sync()
        t0 = time.perf_counter()
        ref5 = march_chief_dense(vol5, *chief, algorithm=2)
        sync()
        k1l_plain_ms = (time.perf_counter() - t0) * 1e3
        pe, de = march_err(got5, ref5)
        k1l_err = max(pe / scale5, de)
        print(f"    K1 RK4, {P} rays through {n5}^3: position error "
              f"{pe:.3e} um, direction error {de:.3e}; the rays turn by up "
              f"to {float((got5[3] - chief[3]).abs().max()):.3e}")
        hold(f"K1 RK4 {P} rays, {n5}^3 (normalised)", k1l_err, K1_TOL)
        require(float((got5[3] - chief[3]).abs().max()) > 1e-6,
                "the 512^3 volume does not bend the rays")
        del ref5

        rays6 = torch.stack(chief).contiguous()
        (out_t, texit5, traj5), traj_gb = with_peak(
            lambda: march_forward_residual(vol5.field, rays6, gnp5, 2, True))
        hold(f"K1 residual head, {P} rays, {n5}^3: values that differ from "
             f"the plain head", float((out_t != torch.stack(got5)).sum()),
             0.0)
        traj5_bytes = steps5 * 20 * 4
        print(f"    stage residual {traj5.numel() * 4 / 1e9:.2f} GB allocated, "
              f"{traj5_bytes / 1e9:.2f} GB written; peak device memory of the "
              f"residual head {traj_gb:.2f} GB  [{card}]")
        require(traj5.numel() * 4 <= mdf.traj_max_bytes(n5, n5)
                and traj5.numel() * 4 > mdf.TRAJ_MAX_BYTES,
                "the 512^3 residual does not sit between the two budgets")

        # K4 and K5 against autograd through the plain march, both sides on
        # every tenth ray (the plain march's graph is ~0.6 kB a ray and
        # stage: 6000 rays at a time)
        rays10 = [c[tenth].contiguous() for c in chief]
        n10 = rays10[0].shape[0]
        cts10 = [torch.randn(n10, generator=gen_l, device=dev) * s_
                 for s_ in (1.0, 1.0, 1.0, 1e5, 1e5, 1e5)]
        g4 = march_grads(march_chief_fused, vol5, rays10, cts10, 2)
        g5_ = with_budget(0, lambda: march_grads(march_chief_fused, vol5,
                                                 rays10, cts10, 2))
        sync()
        t0 = time.perf_counter()
        gp = march_grads(march_chief_dense, vol5, rays10, cts10, 2,
                         ray_slice=6000)
        sync()
        bwd_plain_ms = (time.perf_counter() - t0) * 1e3
        large_errs = {}
        for nm, gk in (("K4", g4), ("K5", g5_)):
            large_errs[nm] = (nerr(gk[0], gp[0]),
                              max(nerr(a, b) for a, b in zip(gk[1:], gp[1:])))
            hold(f"{nm} RK4, {n10} rays (every tenth), {n5}^3: d_field (of "
                 f"its maximum)", large_errs[nm][0], MARCH_FIELD_TOL)
            hold(f"{nm} RK4, {n10} rays, {n5}^3: cotangents of the rays (of "
                 f"their maxima)", large_errs[nm][1], MARCH_STATE_TOL)
        hold(f"K4 against K5, {n5}^3: d_field (of its maximum)",
             nerr(g4[0], g5_[0]), MARCH_FIELD_TOL)
        del g4, g5_, gp

        def kernel_step_ms(rays_l):
            """Forward and backward of the kernel route on these rays."""
            fld = vol5.field.detach().requires_grad_(True)
            outs = march_chief_fused(vol5._replace(field=fld), *rays_l)
            torch.autograd.grad(outs, fld, grad_outputs=cts10)
        k_same_ms = time_ms(lambda: kernel_step_ms(rays10), reps=3, warm=1)
        print(f"    forward + backward on every tenth ray: kernels (K1 "
              f"residual head, K4) {k_same_ms:.2f} ms, the plain march and "
              f"autograd through it {bwd_plain_ms:.0f} ms  [{card}]")

        del traj5, texit5, out_t

        # Times at 120,000 rays.  The bench scene's chief rays converge on
        # the lens axis: a cone that covers a few percent of each slab, so
        # what they read of the field, and the part of d_field they add to,
        # stays near the 50 MB L2 whatever the field's size ("input": in
        # the scene's order, where the particles of a dot are neighbours;
        # "shuffled": permuted).  The reading beyond L2 is "spread": as many
        # near-vertical rays over the whole 512 x 512 slab, which touch most
        # of the 2.15 GB, sorted by voxel column and unsorted.
        ct6 = torch.randn(6, P, generator=gen_l, device=dev)
        perm = torch.randperm(P, generator=gen_l, device=dev)

        def uniform(lo_, hi_):
            return lo_ + (hi_ - lo_) * torch.rand(P, generator=gen_l,
                                                  device=dev)

        tilt_x, tilt_y = uniform(-0.005, 0.005), uniform(-0.005, 0.005)
        inv_n = torch.rsqrt(tilt_x * tilt_x + tilt_y * tilt_y + 1.0)
        spread6 = torch.stack([
            float(g5.min_x) + float(g5.sx) * uniform(0.5, n5 - 2.5),
            float(g5.min_y) + float(g5.sy) * uniform(0.5, n5 - 2.5),
            torch.full((P,), float(g5.z_max) + 1.0e3, device=dev),
            tilt_x * inv_n, tilt_y * inv_n, -inv_n]).contiguous()
        column = ((spread6[1] - float(g5.min_y)) / float(g5.sy)).long() * n5 \
            + ((spread6[0] - float(g5.min_x)) / float(g5.sx)).long()
        spread_sorted6 = spread6[:, torch.argsort(column)].contiguous()
        sp10 = [c[tenth].contiguous() for c in spread6.unbind(0)]
        pe, de = march_err(march_chief_fused(vol5, *sp10, algorithm=2),
                           march_chief_dense(vol5, *sp10, algorithm=2))
        hold(f"K1 RK4, {sp10[0].shape[0]} rays spread over the {n5} x {n5} "
             f"slab (normalised)", max(pe / scale5, de), K1_TOL)

        def march_times(rays6_o):
            """Times and peak memory of the four march kernels on these
            rays, the voxels they touch and the steps they take."""
            rays_o = list(rays6_o.unbind(0))
            out_o, texit_o, traj_o = march_forward_residual(
                vol5.field, rays6_o, gnp5, 2, True)
            t = dict(steps=in_band_steps(vol5, rays_o),
                     touched=touched_voxels(vol5, rays_o))
            t["k1"], t["k1_gb"] = with_peak(lambda: time_ms(
                lambda: mdf.march_forward_noresidual(vol5.field, rays_o, gnp5,
                                                     2, 1), reps=5, warm=1))
            t["k1t"], t["k1t_gb"] = with_peak(lambda: time_ms(
                lambda: march_forward_residual(vol5.field, rays6_o, gnp5, 2,
                                               True), reps=3, warm=1))
            t["k4"], t["k4_gb"] = with_peak(lambda: time_ms(
                lambda: march_backward_stage(vol5.field, rays6_o, texit_o,
                                             traj_o, ct6, gnp5, 2),
                reps=3, warm=1))
            t["k5"], t["k5_gb"] = with_peak(lambda: time_ms(
                lambda: march_backward_remarch(vol5.field, rays6_o, texit_o,
                                               out_o, ct6, gnp5, 2, iters5),
                reps=3, warm=1))
            return t

        def march_bounds(t):
            """Bounds of the four kernels from what these rays need: their
            own columns and the residual of their steps, the voxels they
            touch read once, d_field written once."""
            touched_b = t["touched"] * 16
            res_b = t["steps"] * 20 * 4
            k1_ops = t["steps"] * (4 * MARCH_OPS_PER_RHS
                                   + MARCH_OPS_PER_RK4_COMBINE)
            k4_ops = t["steps"] * (4 * MARCH_VJP_OPS_PER_STAGE
                                   + MARCH_VJP_OPS_PER_COMBINE)
            k5_ops = k4_ops + t["steps"] * (
                (8 + 4 * iters5) * MARCH_OPS_PER_RHS
                + (2 + iters5) * MARCH_OPS_PER_RK4_COMBINE)
            return dict(
                k1=bound_ms(12 * P * 4 + touched_b, k1_ops),
                k1t=bound_ms(15 * P * 4 + touched_b + res_b, k1_ops),
                k4=bound_ms(res_b + 21 * P * 4 + touched_b + field5_bytes,
                            k4_ops),
                k5=bound_ms(27 * P * 4 + touched_b + field5_bytes, k5_ops))

        order_ms, order_bounds = {}, {}
        for order, rays6_o in (("input", rays6), ("shuffled",
                                                  rays6[:, perm].contiguous()),
                               ("spread, sorted by voxel column",
                                spread_sorted6), ("spread", spread6)):
            t = order_ms[order] = march_times(rays6_o)
            bd = order_bounds[order] = march_bounds(t)
            print(f"    {order} order, {P} rays, {n5}^3: {t['steps']} steps, "
                  f"{t['touched']} voxels touched "
                  f"({t['touched'] * 16 / 1e6:.1f} MB, "
                  f"{t['touched'] * 16 / field5_bytes:.4f} of the field); "
                  f"K1 {t['k1']:.3f} ms (bound {bd['k1'][0]:.3f} ms, "
                  f"{bd['k1'][1]}; peak {t['k1_gb']:.2f} GB), residual head "
                  f"{t['k1t']:.3f} ms ({bd['k1t'][0]:.3f} ms, {bd['k1t'][1]}; "
                  f"{t['k1t_gb']:.2f} GB), K4 {t['k4']:.3f} ms "
                  f"({bd['k4'][0]:.3f} ms, {bd['k4'][1]}; {t['k4_gb']:.2f} "
                  f"GB), K5 {t['k5']:.3f} ms ({bd['k5'][0]:.3f} ms, "
                  f"{bd['k5'][1]}; {t['k5_gb']:.2f} GB)  [{card}]")
        del rays6_o, spread6, spread_sorted6
        zero_ms = time_ms(lambda: torch.zeros_like(vol5.field), reps=3, warm=1)
        print(f"    zero-fill of a {field5_bytes / 1e9:.2f} GB cotangent "
              f"(inside K4's and K5's times): {zero_ms:.3f} ms  [{card}]")
        require(order_ms["input"]["steps"] == steps5,
                "the timed rays take other steps than the checked ones")
        require(order_ms["spread"]["touched"] * 16 > 0.5 * field5_bytes,
                "the spread rays do not touch half of the field")

        bd = order_bounds["input"]
        (k1l_bound, k1l_by), (k1tl_bound, k1tl_by) = bd["k1"], bd["k1t"]
        (k4l_bound, k4l_by), (k5l_bound, k5l_by) = bd["k4"], bd["k5"]
        print(f"    the plain march forward {k1l_plain_ms:.0f} ms  [{card}]")
        tin, tsh = order_ms["input"], order_ms["shuffled"]
        tss, tsp = (order_ms["spread, sorted by voxel column"],
                    order_ms["spread"])

        def beyond_l2(key):
            """The same kernel on the rays spread over the whole slab."""
            return dict(
                touched_bytes=tsp["touched"] * 16, steps=tsp["steps"],
                ms_sorted_by_voxel_column=tss[key], ms=tsp[key],
                bound_ms=order_bounds["spread"][key][0],
                bound_by=order_bounds["spread"][key][1])
        shape5 = f"{P} rays, {n5}^3 field, RK4, trilinear"
        same = dict(rays=n10, kernel_forward_backward_ms=k_same_ms,
                    plain_forward_backward_ms=bwd_plain_ms)
        rows.append(dict(
            name="march_window_fwd", route="cuda",
            source="photon_tpu_torch/csrc/march_dense.cu",
            replaces="photon_tpu/ops/march_window.py:546", shape=shape5,
            max_abs_err=k1l_err, tolerance=K1_TOL, ms=tin["k1"],
            ms_shuffled_rays=tsh["k1"], plain_ms=k1l_plain_ms,
            bound_ms=k1l_bound, bound_by=k1l_by, library_ms=None,
            peak_gb=tin["k1_gb"], touched_bytes=tin["touched"] * 16,
            spread_rays=beyond_l2("k1"),
            residual_head=dict(
                shape=shape5 + f", ({n5 - 1}, 20, {P}) residual",
                max_abs_err=0.0, tolerance=0.0, ms=tin["k1t"],
                ms_shuffled_rays=tsh["k1t"], bound_ms=k1tl_bound,
                bound_by=k1tl_by, peak_gb=tin["k1t_gb"],
                spread_rays=beyond_l2("k1t"))))
        for nm, line, key, e, bnd, by in (
                ("march_window_bwd_stage", 813, "k4", large_errs["K4"],
                 k4l_bound, k4l_by),
                ("march_window_bwd_remarch", 813, "k5", large_errs["K5"],
                 k5l_bound, k5l_by)):
            rows.append(dict(
                name=nm, route="cuda",
                source="photon_tpu_torch/csrc/march_bwd.cu",
                replaces=f"photon_tpu/ops/march_window.py:{line}",
                shape=shape5, max_abs_err=e[0], state_err=e[1],
                tolerance=MARCH_FIELD_TOL, ms=tin[key],
                ms_shuffled_rays=tsh[key], plain_ms=bwd_plain_ms,
                plain_ms_is="forward and backward of the plain march at "
                f"every tenth ray ({n10}); the kernels' forward and backward "
                f"on the same rays is in same_rays",
                same_rays=same, bound_ms=bnd, bound_by=by, library_ms=None,
                peak_gb=tin[key + "_gb"], touched_bytes=tin["touched"] * 16,
                spread_rays=beyond_l2(key)))

        # K8 / K9 on one 512 x 512 slab pair: the chief rays on a slab pair of
        # the bench volume, and noise slabs with coordinates beyond the clamps
        print(f"    K8 / K9 on a {n5} x {n5} slab pair against the plain "
              f"sampler and autograd through it")
        coeff5, prefilter5_gb = with_peak(lambda: bspline_prefilter(
            vol5.field))
        prefilter5_ms = time_ms(lambda: bspline_prefilter(vol5.field), reps=2,
                                warm=0)
        print(f"    prefilter of the {n5}^3 field (PyTorch): "
              f"{prefilter5_ms:.1f} ms, peak device memory "
              f"{prefilter5_gb:.2f} GB  [{card}]")
        ks5 = n5 // 2
        on_slab5 = (0.5 + (chief[0] - float(g5.min_x)) / float(g5.sx),
                    0.5 + (chief[1] - float(g5.min_y)) / float(g5.sy))

        def rows_err(a, b):
            return max(nerr(x_, y_) for x_, y_ in zip(a, b))

        # limits as phase 2i; on the smooth slab pair the coordinate
        # cotangents are sums of differences of neighbouring voxels that
        # agree to 1e-3, so FMA contraction shows at 1e-4 of the largest row:
        # 1e-3 there, each row at its own maximum to 5e-6 on the noise slabs
        K8L_TOL, K9L_SLAB_TOL, K9L_SMOOTH_TOL, K9L_ROW_TOL = (5e-6, 5e-5, 1e-3,
                                                               5e-6)
        noise5 = [torch.randn(n5, n5, 4, generator=gen_l, device=dev)
                  for _ in range(2)]
        big = {}
        for scheme in (1, 2):
            fld = coeff5 if scheme == 2 else vol5.field
            for label, lo_s, hi_s, uu in (
                    ("the chief rays on a slab pair of the 512^3 volume",
                     fld[ks5], fld[ks5 + 1], on_slab5 + (uniform(0.0, 1.0),)),
                    ("noise slabs, coordinates beyond both clamps", *noise5,
                     (uniform(-4.0, n5 + 3.0), uniform(-4.0, n5 + 3.0),
                      uniform(0.0, 1.0)))):
                uu = tuple(u.contiguous() for u in uu)
                got = slab_sample_forward(lo_s, hi_s, *uu, scheme)
                sync()
                ref = torch.stack(slab_sample_plain(lo_s, hi_s, *uu, scheme))
                e8 = rows_err(got, ref)
                hold(f"K8 scheme {scheme}, {P} rays, {label} (each channel "
                     f"of its maximum)", e8, K8L_TOL)
                ct4 = torch.randn(4, P, generator=gen_l, device=dev)
                d_lo, d_hi, d_u = slab_sample_backward(lo_s, hi_s, *uu, ct4,
                                                       scheme)
                sync()
                leaves = [t_.detach().clone().requires_grad_(True)
                          for t_ in (lo_s, hi_s) + uu]
                gp_ = torch.autograd.grad(
                    torch.stack(slab_sample_plain(*leaves, scheme)), leaves,
                    grad_outputs=ct4)
                e9s = max(nerr(d_lo, gp_[0]), nerr(d_hi, gp_[1]))
                smooth = label.startswith("the chief")
                if smooth:
                    e9u = float(max((a_ - b_).abs().max()
                                    for a_, b_ in zip(d_u, gp_[2:]))
                                / max(b_.abs().max() for b_ in gp_[2:]))
                else:
                    e9u = rows_err(d_u, gp_[2:])
                hold(f"K9 scheme {scheme}, {label}: d_lo, d_hi (of their "
                     f"maxima)", e9s, K9L_SLAB_TOL)
                hold(f"K9 scheme {scheme}, {label}: d_ux, d_uy, d_uz "
                     f"({'of the largest' if smooth else 'each of its maximum'})",
                     e9u, K9L_SMOOTH_TOL if smooth else K9L_ROW_TOL)
                if smooth:
                    big[scheme] = dict(uu=uu, ct=ct4, lo=lo_s.contiguous(),
                                       hi=hi_s.contiguous(), e8=e8,
                                       e9=max(e9s, e9u))
        del coeff5, noise5
        slab5_bytes = n5 * n5 * 16

        def slab_taps(ux, uy, width):
            """Distinct voxels of one slab under the width x width taps of
            these coordinates (clipped indices, as the kernels address)."""
            first = 0 if width == 2 else -1
            ix = ux.clamp(0.0, n5 - 1.0).long().clamp_max(n5 - 2)
            iy = uy.clamp(0.0, n5 - 1.0).long().clamp_max(n5 - 2)
            mask = torch.zeros(n5 * n5, dtype=torch.bool, device=dev)
            for jy in range(first, first + width):
                for jx in range(first, first + width):
                    mask[(iy + jy).clamp(0, n5 - 1) * n5
                         + (ix + jx).clamp(0, n5 - 1)] = True
            return int(mask.sum())
        for scheme in (1, 2):
            c = big[scheme]
            c["k8_ms"] = time_ms(lambda: slab_sample_forward(
                c["lo"], c["hi"], *c["uu"], scheme), inner=20)
            c["k9_ms"] = time_ms(lambda: slab_sample_backward(
                c["lo"], c["hi"], *c["uu"], c["ct"], scheme), inner=20)
            c["k8_plain_ms"] = time_ms(lambda: slab_sample_plain(
                c["lo"], c["hi"], *c["uu"], scheme), reps=5, warm=1)
            leaves = [t_.detach().clone().requires_grad_(True)
                      for t_ in (c["lo"], c["hi"]) + c["uu"]]
            out_p = torch.stack(slab_sample_plain(*leaves, scheme))
            c["k9_plain_ms"] = time_ms(lambda: torch.autograd.grad(
                out_p, leaves, grad_outputs=c["ct"], retain_graph=True),
                reps=5, warm=1)
            del out_p, leaves
            # the rays' taps read once (2 x 2 or 4 x 4 a slab); d_lo and
            # d_hi written once
            c["touched"] = 2 * slab_taps(c["uu"][0], c["uu"][1],
                                         2 if scheme == 1 else 4)
            c["k8_bound"], c["k8_by"] = bound_ms(
                7 * P * 4 + c["touched"] * 16, P * SAMPLE_OPS[scheme])
            c["k9_bound"], c["k9_by"] = bound_ms(
                10 * P * 4 + c["touched"] * 16 + 2 * slab5_bytes,
                P * (SAMPLE_OPS[scheme] + SAMPLE_VJP_OPS[scheme]))
        c1, c2 = big[1], big[2]
        gs_in = torch.stack([c1["lo"], c1["hi"]]).permute(3, 0, 1, 2)[None]
        gs_in = gs_in.contiguous().requires_grad_(True)
        gs_grid = torch.stack([2.0 * c1["uu"][0] / (n5 - 1.0) - 1.0,
                               2.0 * c1["uu"][1] / (n5 - 1.0) - 1.0,
                               2.0 * c1["uu"][2] - 1.0], -1)
        gs_grid = gs_grid.reshape(1, 1, 1, P, 3).requires_grad_(True)
        gs_kw = dict(mode="bilinear", padding_mode="border",
                     align_corners=True)
        with torch.no_grad():
            k8l_lib_ms = time_ms(lambda: torch.nn.functional.grid_sample(
                gs_in, gs_grid, **gs_kw), inner=20)
        gs_out = torch.nn.functional.grid_sample(gs_in, gs_grid, **gs_kw)
        k9l_lib_ms = time_ms(lambda: torch.autograd.grad(
            gs_out, [gs_in, gs_grid],
            grad_outputs=c1["ct"].reshape(gs_out.shape), retain_graph=True),
            inner=20)
        del gs_out, gs_in, gs_grid
        for scheme in (1, 2):
            c = big[scheme]
            print(f"    scheme {scheme}, {n5} x {n5} slab pair: "
                  f"{c['touched']} voxels touched of {2 * n5 * n5}; K8 time "
                  f"{c['k8_ms']:.4f} ms  plain {c['k8_plain_ms']:.3f} ms  "
                  f"bound {c['k8_bound']:.5f} ms ({c['k8_by']})  K9 time "
                  f"{c['k9_ms']:.4f} ms  autograd through the plain sampler "
                  f"{c['k9_plain_ms']:.3f} ms  bound {c['k9_bound']:.5f} ms "
                  f"({c['k9_by']})  [{card}]")
        print(f"    grid_sample {k8l_lib_ms:.4f} ms, its backward "
              f"{k9l_lib_ms:.4f} ms (trilinear only)  [{card}]")
        for nm, line, key, lib_ms in (
                ("slab_sample_large", 166, "k8", k8l_lib_ms),
                ("slab_sample_bwd_large", 181, "k9", k9l_lib_ms)):
            err_key = "e8" if key == "k8" else "e9"
            rows.append(dict(
                name=nm, route="cuda",
                source="photon_tpu_torch/csrc/slab_sample.cu",
                replaces=f"photon_tpu/ops/march_dense_pallas.py:{line}",
                shape=f"{P} rays, one {n5} x {n5} slab pair, trilinear",
                max_abs_err=c1[err_key],
                tolerance=K8L_TOL if key == "k8" else K9L_SMOOTH_TOL,
                ms=c1[key + "_ms"], plain_ms=c1[key + "_plain_ms"],
                bound_ms=c1[key + "_bound"], bound_by=c1[key + "_by"],
                library_ms=lib_ms,
                cubic=dict(shape=f"{P} rays, one {n5} x {n5} slab pair, "
                           f"tricubic", max_abs_err=c2[err_key],
                           ms=c2[key + "_ms"], plain_ms=c2[key + "_plain_ms"],
                           bound_ms=c2[key + "_bound"], library_ms=None)))
        del big, c1, c2
        if failures:
            raise SystemExit(f"chip_smoke: kernel comparisons on the large "
                             f"tier failed: {failures}")

        # --------------------------------------------------------------
        # phase 7: large volumes through the normal entry points
        # --------------------------------------------------------------
        print("phase 7: large volumes through the entry points: cli.main on "
              "a 288 x 288 x 64 NRRD, render_image_fast on the 512^3 volume")
        n_l, n_z = 288, 64
        xh = np.linspace(-1.5e5, 1.5e5, n_l)
        zh = np.linspace(setup.object_distance - 5e5,
                         setup.object_distance - 1e2, n_z)
        gxh = np.exp(-(xh / (0.35 * (xh.max() - xh.min()))) ** 2 / 2.0)
        gzh = np.exp(-((zh - 0.5 * (zh.min() + zh.max()))
                       / (0.35 * (zh.max() - zh.min()))) ** 2 / 2.0)
        rho288 = 1.225 + 2.0 * gxh[:, None, None] * gxh[None, :, None] \
            * gzh[None, None, :]
        spac288 = [xh[1] - xh[0], xh[1] - xh[0], zh[1] - zh[0]]
        orig288 = [xh[0], xh[0], zh[0]]
        for label, alg, scheme in (("RK4, trilinear", 2, 1),
                                   ("algorithm 3, substeps from the data", 3,
                                    1)):
            cfg_m = dataclasses.replace(
                cfg, density_gradients=dataclasses.replace(
                    cfg.density_gradients, ray_tracing_algorithm=alg,
                    interpolation_scheme=scheme))
            render_fast._substep_cache.clear()
            with tempfile.TemporaryDirectory(prefix="photon_smoke_") as tmp:
                case, nrrd = write_bench_case(tmp, cfg_m, rho288, spac288,
                                              orig288)
                out = os.path.join(tmp, "out")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc, counts_m, large_m = counted(
                        lambda: cli_main([case, "--out", out, "--verbose"]))
                require(rc == 0, f"the CLI returned {rc} ({label})")
                ims = [np.fromfile(os.path.join(
                    out, "raw", f"bos_pattern_image_{i}.bin"),
                    np.float32).reshape(sensor, sensor) for i in (1, 2)]
                vol_file = load_density_volume(
                    nrrd, gladstone_dale=cfg.density_gradients.gladstone_dale,
                    device=dev)
            chosen = list(render_fast._substep_cache.values())
            n_march = 1 if alg == 2 else 3
            print(f"    {n_l} x {n_l} x {n_z} pair, {label}: launches "
                  f"{counts_m}, of them on the large tier {large_m}"
                  + (f"; substeps chosen {chosen}" if alg == 3 else ""))
            expect_counts(label, counts_m, dict(
                march=n_march, march_bwd_stage=0, march_bwd_remarch=0,
                slab_sample=0, slab_sample_bwd=0, fan_stats=2 * n_chunks,
                splat=2 * n_chunks))
            expect_counts(label + " (large tier)", large_m,
                          dict(march=n_march))
            if alg == 3:
                require(len(chosen) == 1 and 2 <= chosen[0] <= 16,
                        f"choose_substeps gave {chosen}")
            with torch.no_grad():
                plain_m = plain_render(vol_file, everyone, alg, scheme,
                                       chosen[0] if alg == 3 else None
                                       ).cpu().numpy()
            l1_m = float(np.abs(ims[1] - plain_m).sum() / plain_m.sum())
            moved_m = float(np.abs(ims[1] - ims[0]).sum() / ims[0].sum())
            print(f"    {label}: im2 against the plain render L1 {l1_m:.3e} "
                  f"of the sum (tolerance 1.0e-03); |im1 - im2| / sum "
                  f"{moved_m:.3f}")
            require(np.isfinite(ims[1]).all() and l1_m < 1e-3,
                    f"{label}: im2 is {l1_m} (L1) from the plain render")
            require(moved_m > 0.01, f"{label}: the volume moves nothing")
            for line in buf.getvalue().splitlines():
                mt = re.match(r"\s*(render:\S+|volume): ([0-9.]+)s(?:\s+"
                              r"([0-9.]+)M rays/s)?", line)
                if mt:
                    rate = f", {mt.group(3)}M rays/s" if mt.group(3) else ""
                    print(f"    {label}: {mt.group(1)}: {mt.group(2)} s{rate}"
                          f"  [{card}]")
            del vol_file

        def render5(**kw):
            return render_image_fast(cfg, setup, source, r1, r2, vol=vol5,
                                     device=dev, **kw)

        def timed(fn, reps=3):
            ts = []
            for _ in range(reps):
                sync()
                ta = time.perf_counter()
                fn()
                sync()
                ts.append(time.perf_counter() - ta)
            return statistics.median(ts)

        menu5 = {}
        n_s5 = n5 - 1
        for label, kw, plain_kw, want, reps in (
                ("RK4, trilinear", {}, dict(algorithm=2),
                 dict(march=1, slab_sample=0), 3),
                ("RK4, tricubic", dict(interpolation_scheme=2),
                 dict(algorithm=2, scheme=2), dict(march=1, slab_sample=0), 2),
                ("Adams-Bashforth", dict(algorithm=4), dict(algorithm=4),
                 dict(march=0, slab_sample=4 * n_s5), 2)):
            ((img5, counts5, large5), peak5) = with_peak(
                lambda: counted(lambda: render5(**kw)))
            secs5 = timed(lambda: render5(**kw), reps)
            with torch.no_grad():
                plain5 = plain_render(vol5, everyone, **plain_kw)
            l1_5 = float((img5 - plain5).abs().sum() / plain5.sum())
            print(f"    render_image_fast through {n5}^3, {label}: launches "
                  f"{counts5}, large tier {large5}; {secs5:.4f} s, "
                  f"{P * R / secs5 / 1e6:.1f}M rays/s; peak device memory "
                  f"{peak5:.2f} GB; image against the plain render L1 "
                  f"{l1_5:.3e} of the sum (tolerance 1.0e-03)  [{card}]")
            expect_counts(label, counts5, dict(
                fan_stats=1, splat=1, march_bwd_stage=0, march_bwd_remarch=0,
                slab_sample_bwd=0, **want))
            expect_counts(label + " (large tier)", large5, want)
            require(bool(torch.isfinite(img5).all()) and l1_5 < 1e-3,
                    f"{label}: the 512^3 image is {l1_5} (L1) from the plain "
                    f"render")
            menu5[label] = dict(counts=large5, seconds=secs5, l1=l1_5)
            del plain5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            render5()
            sync()
        dev_ms, _ = device_time(prof)
        k1_dev_ms, k1_dev_n = device_time(prof, "march_dense_kernel")
        rk4_s = menu5["RK4, trilinear"]["seconds"]
        if dev_ms > 0:
            print(f"    traced render through {n5}^3: device busy "
                  f"{dev_ms:.2f} ms, {k1_dev_ms:.3f} ms of it in "
                  f"{k1_dev_n} launch of the march kernel; an untraced render "
                  f"takes {rk4_s * 1e3:.1f} ms, so the device was busy for "
                  f"about {dev_ms / 1e3 / rk4_s:.1%} of it  [{card}]")
            rows[0]["device_ms_on_main_path"] = k1_dev_ms
        else:
            print("    traced render: the profiler reported no device time; "
                  "not measured")
        on_render = f"render_image_fast through the {n5}^3 volume"
        rows[0]["launches"] = menu5["RK4, trilinear"]["counts"]["march"]
        rows[0]["launches_on"] = on_render + ", RK4, one chunk"
        rows[3]["launches"] = menu5["Adams-Bashforth"]["counts"]["slab_sample"]
        rows[3]["launches_on"] = on_render + ", Adams-Bashforth"

        # --------------------------------------------------------------
        # phase 8: gradients at 512^3
        # --------------------------------------------------------------
        print(f"phase 8: gradients at {n5}^3: mean(img^2) with respect to the "
              f"field, one chunk; invert_bos on the {n5}^3 density grid")

        def field_step(src=source, render=None, **kw):
            """(loss, d_field, forward s, backward s) of mean(img^2)."""
            fld = vol5.field.detach().requires_grad_(True)
            v = vol5._replace(field=fld)
            sync()
            ta = time.perf_counter()
            if render is None:
                img = render_image_fast(cfg, setup, src, r1, r2, vol=v,
                                        device=dev, **kw)
            else:
                img = render(v)
            loss = torch.mean(img * img)
            sync()
            tb = time.perf_counter()
            (g,) = torch.autograd.grad(loss, fld)
            sync()
            return float(loss.detach()), g, tb - ta, time.perf_counter() - tb

        def step_times(reps=3, **kw):
            fb = [field_step(**kw)[2:] for _ in range(reps)]
            return (statistics.median(t[0] for t in fb),
                    statistics.median(t[1] for t in fb))

        step_rows = {}
        for label, budget, want in (
                ("stage residual (the default)", None,
                 dict(march=1, march_bwd_stage=1, march_bwd_remarch=0)),
                ("residual budget 0 (re-march)", 0,
                 dict(march=1, march_bwd_stage=0, march_bwd_remarch=1))):
            run = (lambda f: f()) if budget is None else \
                (lambda f: with_budget(0, f))
            ((res_s, counts_s, large_s), peak_s) = with_peak(
                lambda: counted(lambda: run(field_step)))
            del res_s
            f_s, b_s = run(step_times)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(field_step)
            dev_ms, _ = device_time(prof)
            parts = {tag: device_time(prof, tag)[0] for tag in (
                "march_dense_kernel", "march_bwd_stage_kernel",
                "march_bwd_remarch_kernel", "fan_stats_kernel",
                "fan_stats_bwd_kernel", "splat_kernel", "splat_bwd_kernel")}
            busy = (f"{dev_ms / 1e3 / (f_s + b_s):.1%}" if dev_ms > 0
                    else "not measured")
            print(f"    one step, {label}: launches {counts_s}, large tier "
                  f"{large_s}; forward {f_s * 1e3:.2f} ms, backward "
                  f"{b_s * 1e3:.2f} ms (median of 3); peak device memory "
                  f"{peak_s:.2f} GB; device busy {busy} of the step "
                  f"({dev_ms:.2f} ms; by kernel "
                  f"{ {k: round(v, 3) for k, v in parts.items() if v} })  "
                  f"[{card}]")
            expect_counts(label, counts_s, dict(
                fan_stats=1, fan_stats_bwd=1, splat=1, splat_bwd=1,
                slab_sample=0, slab_sample_bwd=0, **want))
            expect_counts(label + " (large tier)", large_s, want)
            step_rows[budget] = dict(large=large_s, parts=parts)
        # d_field against the same step through the plain versions, every
        # tenth particle
        _, g_k, _, _ = field_step(src=sub_src)
        _, g_k5, _, _ = with_budget(0, lambda: field_step(src=sub_src))
        loss_p, g_p, _, _ = field_step(
            render=lambda v: plain_render(v, tenth))
        cos_k, cos_k5 = cosine(g_k, g_p), cosine(g_k5, g_p)
        rel_k = float((g_k - g_p).norm() / g_p.norm())
        rel_k5 = float((g_k5 - g_p).norm() / g_p.norm())
        print(f"    d_field at every tenth particle against the plain "
              f"versions: stage backward cosine {cos_k:.7f}, relative L2 "
              f"{rel_k:.3e}; re-march backward cosine {cos_k5:.7f}, relative "
              f"L2 {rel_k5:.3e}")
        require(cos_k >= 0.9999 and cos_k5 >= 0.9999
                and bool(torch.isfinite(g_k).all())
                and float(g_p.abs().max()) > 0,
                f"d_field at 512^3: cosine {cos_k} / {cos_k5}")
        del g_k5, g_p
        for i, key in ((1, "march_bwd_stage"), (2, "march_bwd_remarch")):
            budget = None if i == 1 else 0
            rows[i]["launches"] = step_rows[budget]["large"][key]
            rows[i]["launches_on"] = (
                f"one forward + backward of mean(img^2) with respect to the "
                f"{n5}^3 field, one chunk"
                + ("" if i == 1 else ", the stage residual over its budget"))
            tag = key + "_kernel"
            if step_rows[budget]["parts"].get(tag):
                rows[i]["device_ms_on_main_path"] = \
                    step_rows[budget]["parts"][tag]
        rows[0]["residual_head"]["launches"] = step_rows[None]["large"]["march"]
        rows[0]["residual_head"]["launches_on"] = rows[1]["launches_on"]
        if step_rows[None]["parts"].get("march_dense_kernel"):
            rows[0]["residual_head"]["device_ms_on_main_path"] = \
                step_rows[None]["parts"]["march_dense_kernel"]

        # the per-stage route at this size: Adams-Bashforth under autograd
        # (K8 and K9 on 512 x 512 slabs), held against the RK4 gradient here
        # and against the plain versions on the 288 x 288 x 64 volume
        ((res_a, counts_a, large_a), peak_a) = with_peak(
            lambda: counted(lambda: field_step(algorithm=4)))
        cos_a = cosine(res_a[1], g_k)
        _, g_a10, _, _ = field_step(src=sub_src, algorithm=4)
        cos_a10 = cosine(g_a10, g_k)
        print(f"    one step with Adams-Bashforth: launches {counts_a}, "
              f"large tier {large_a}; forward {res_a[2] * 1e3:.0f} ms, "
              f"backward {res_a[3] * 1e3:.0f} ms (one step); peak device "
              f"memory {peak_a:.2f} GB; d_field at every tenth particle "
              f"against the RK4 kernels' cosine {cos_a10:.7f}  [{card}]")
        expect_counts("Adams-Bashforth step", large_a, dict(
            march=0, slab_sample=4 * n_s5, slab_sample_bwd=4 * n_s5))
        require(cos_a10 >= 0.999 and bool(torch.isfinite(res_a[1]).all()),
                f"Adams-Bashforth d_field: cosine {cos_a10} against RK4's")
        rows[4]["launches"] = large_a["slab_sample_bwd"]
        rows[4]["launches_on"] = (
            f"one forward + backward of mean(img^2) with respect to the "
            f"{n5}^3 field with Adams-Bashforth")
        rows[3]["launches_gradient_step"] = large_a["slab_sample"]
        del res_a, g_a10, g_k, cos_a
        vol288 = build_density_volume(rho288, spac288, orig288, device=dev)

        def step288(render):
            fld = vol288.field.detach().clone().requires_grad_(True)
            img = render(vol288._replace(field=fld))
            (g,) = torch.autograd.grad(torch.mean(img * img), fld)
            return g

        g_a = step288(lambda v: render_image_fast(
            cfg, setup, sub_src, r1, r2, vol=v, algorithm=4, device=dev))
        g_ap = step288(lambda v: plain_render(v, tenth, algorithm=4))
        cos_288 = cosine(g_a, g_ap)
        print(f"    Adams-Bashforth d_field on the {n_l} x {n_l} x {n_z} "
              f"volume at every tenth particle against the plain versions: "
              f"cosine {cos_288:.7f}, relative L2 "
              f"{float((g_a - g_ap).norm() / g_ap.norm()):.3e}")
        require(cos_288 >= 0.9999, f"Adams-Bashforth d_field: cosine "
                f"{cos_288} against the plain versions")
        del vol288, g_a, g_ap

        # one tricubic step: the prefilter under autograd, K1 and K4 cubic
        ((res_c, counts_c, large_c), peak_c) = with_peak(
            lambda: counted(lambda: field_step(interpolation_scheme=2)))
        g_c5 = with_budget(0, lambda: field_step(interpolation_scheme=2))[1]
        cos_c = cosine(res_c[1], g_c5)
        print(f"    one tricubic step: launches {counts_c}, large tier "
              f"{large_c}; forward {res_c[2] * 1e3:.0f} ms, backward "
              f"{res_c[3] * 1e3:.0f} ms (one step, the prefilter and its "
              f"transpose included); peak device memory {peak_c:.2f} GB; "
              f"stage against re-march backward cosine {cos_c:.7f}  [{card}]")
        expect_counts("tricubic step", large_c, dict(
            march=1, march_bwd_stage=1, march_bwd_remarch=0))
        require(cos_c >= 0.9999 and bool(torch.isfinite(res_c[1]).all()),
                f"tricubic d_field: cosine {cos_c} between the two backwards")
        del res_c, g_c5

        # invert_bos: the unknown is the 512^3 density grid
        gx5, gz5, amp5 = rho5_factors
        rho_true5 = 1.225 + amp5 * gx5[:, None, None] * gx5[None, :, None] \
            * gz5[None, None, :]
        gd = cfg.density_gradients.gladstone_dale
        with torch.no_grad():
            observed5 = render_image_fast(
                cfg, setup, source, r1, r2,
                vol=volume_from_rho(rho_true5, vol5, gd), device=dev)
        rho_uni = cfg.density_gradients.rho_0
        rho0_5 = rho_uni + 0.8 * (rho_true5 - rho_uni)
        # Adam's first step moves every voxel that a ray touches by the
        # learning rate, and 511 slabs add up along a ray: with 1e-4 of
        # rho's range the loss falls, with 1e-3 it rose many times over
        lr5 = 1e-4 * float(rho_true5.max() - rho_true5.min())
        del rho_true5
        render_fast._substep_cache.clear()
        stamps = []

        def stamp(t, loss, rho):
            sync()
            stamps.append(time.perf_counter())

        sync()
        t0 = time.perf_counter()
        ((res5, counts_i, large_i), peak_i) = with_peak(
            lambda: counted(lambda: invert_bos(
                cfg, setup, source, r1, r2, observed5, vol5, rho0=rho0_5,
                steps=2, learning_rate=lr5, callback=stamp, device=dev)))
        t_end = time.perf_counter()
        print(f"    invert_bos, 2 steps on the {n5}^3 grid "
              f"({rho0_5.numel() * 4 / 1e9:.2f} GB of unknowns): losses "
              f"{', '.join(f'{v:.6g}' for v in res5.losses)}; steps "
              f"{stamps[0] - t0:.3f} s and {stamps[1] - stamps[0]:.3f} s; "
              f"the recovered volume's precompute on the host and its copy "
              f"{t_end - stamps[1]:.1f} s; launches {counts_i}, large tier "
              f"{large_i}; peak device memory {peak_i:.2f} GB  [{card}]")
        require(all(math.isfinite(v) for v in res5.losses),
                "a loss of the 512^3 inversion is not finite")
        require(res5.losses[1] < res5.losses[0],
                f"the 512^3 inversion's loss did not fall: {res5.losses}")
        require(res5.rho.shape == (n5, n5, n5) and np.isfinite(res5.rho).all()
                and tuple(res5.volume.field.shape) == (n5, n5, n5, 4),
                "the recovered 512^3 rho or its volume is malformed")
        expect_counts("invert_bos at 512^3", counts_i, dict(
            march=2, march_bwd_stage=2, march_bwd_remarch=0, fan_stats=2,
            fan_stats_bwd=2, splat=2, splat_bwd=2, slab_sample=0,
            slab_sample_bwd=0))
        expect_counts("invert_bos at 512^3 (large tier)", large_i,
                      dict(march=2, march_bwd_stage=2))
        rows[1]["launches_inversion"] = large_i["march_bwd_stage"]
        for row in rows:
            require(row.get("launches", 0) > 0,
                    f"{row['name']} was never launched on a large-volume path")
        return rows

    def finish(rows_) -> int:
        print(f"chip_smoke: all phases passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        print(card)
        print(json.dumps({"kernels": rows_}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    if args.large_only:
        return finish(large_tier())

    # ------------------------------------------------------------------
    # phase 2a: K1, the dense march
    # ------------------------------------------------------------------
    print("K1 march_dense (csrc/march_dense.cu) against its plain version")
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
    # ------------------------------------------------------------------
    # phase 2d: K1's stage-residual head (the forward of the gradient route)
    # ------------------------------------------------------------------
    print("K1 stage-residual head (csrc/march_dense.cu) against the plain head")
    gnp = np.asarray(geom, dtype=np.float32)
    field_bytes = vol.field.numel() * 4
    rays6 = torch.stack(chief).contiguous()
    out_t, texit, traj = march_forward_residual(vol.field, rays6, gnp, 2, True)
    out_n, texit_n, _ = march_forward_residual(vol.field, rays6, gnp, 2, False)
    plain_head = torch.stack(march_chief_fused(vol, *chief, algorithm=2))
    sync()
    k1t_err = float((out_t - plain_head).abs().max())
    # bit-equal: the two heads are instantiations of one kernel that differ
    # only in what they store
    hold(f"K1 residual head, {P} rays: values that differ from the plain "
         f"head", float((out_t != plain_head).sum()), 0.0)
    hold("K1 gradient-route head without the residual: values that differ",
         float((out_t != out_n).sum()
               + (texit[:, inside] != texit_n[:, inside]).sum()), 0.0)
    k1t_ms = time_ms(lambda: march_forward_residual(vol.field, rays6, gnp, 2,
                                                    True))
    traj_bytes = steps * 20 * 4
    k1t_bound, k1t_by = bound_ms(15 * P * 4 + field_bytes + traj_bytes, k1_ops)
    print(f"    time {k1t_ms:.4f} ms  (plain head {k1_ms:.4f} ms)  bound "
          f"{k1t_bound:.4f} ms ({k1t_by}; residual {traj_bytes / 1e6:.1f} MB "
          f"written, {traj.numel() * 4 / 1e6:.1f} MB allocated)  [{card}]")
    kernel_rows.append(dict(
        name="march_dense_residual", route="cuda",
        source="photon_tpu_torch/csrc/march_dense.cu",
        replaces="photon_tpu/ops/march_dense_fused.py:164",
        shape=f"{P} rays, 64^3 field, RK4, (63, 20, {P}) residual",
        max_abs_err=k1t_err, tolerance=0.0, ms=k1t_ms, plain_ms=k1_plain_ms,
        bound_ms=k1t_bound, bound_by=k1t_by, library_ms=None))

    # ------------------------------------------------------------------
    # phase 2e: K4 and K5, the march's backward kernels
    # ------------------------------------------------------------------
    print("K4 / K5 march backward (csrc/march_bwd.cu) against autograd "
          "through the plain march")
    # the random-density volume of the JAX package's fused-march tests
    rgen = np.random.default_rng(3)
    rx = np.linspace(-6e4, 6e4, 12)
    rz = np.linspace(4.0e5, 9.0e5, 12)
    vol_rand = build_density_volume(
        1.2 + 0.8 * rgen.random((12, 12, 12)),
        [rx[1] - rx[0], rx[1] - rx[0], rz[1] - rz[0]], [rx[0], rx[0], rz[0]],
        device=dev)
    rtx, rty = rgen.uniform(-0.08, 0.08, P), rgen.uniform(-0.08, 0.08, P)
    rinv = 1.0 / np.sqrt(rtx * rtx + rty * rty + 1.0)
    rand_rays = [f32(a) for a in (rgen.uniform(-4e4, 4e4, P),
                                  rgen.uniform(-4e4, 4e4, P),
                                  np.full(P, 1.0e6), rtx * rinv, rty * rinv,
                                  -rinv)]
    # some rays start inside the volume, below it, or travel upward
    rand_rays[2][:3000] = f32(rgen.uniform(4.5e5, 8.5e5, 3000))
    rand_rays[2][3000:4000] = 3.0e5
    rand_rays[5][4000:5000] = -rand_rays[5][4000:5000]
    iters_bench = mdf.defect_iterations(
        geom, mdf.remarch_contraction(vol.field, geom))
    print(f"    defect corrections of K5 on the bench volume: {iters_bench}")
    march_errs = {}
    for alg, alg_name in ((2, "RK4"), (1, "Euler")):
        march_errs[alg_name] = march_bwd_case(
            vol, chief, alg, f"{alg_name}, {P} rays, bench 64^3")
        march_bwd_case(vol_rand, rand_rays, alg,
                       f"{alg_name}, {P} rays, random 12^3")

    ct6 = torch.randn(6, P, generator=gen, device=dev)

    def run_k4():
        return march_backward_stage(vol.field, rays6, texit, traj, ct6, gnp,
                                    2)

    def run_k5():
        return march_backward_remarch(vol.field, rays6, texit, out_t, ct6,
                                      gnp, 2, iters_bench)

    d_a, d_b = run_k4()[0], run_k4()[0]
    sync()
    k4_rr = nerr(d_a, d_b)
    print(f"    two K4 launches differ in d_field by {k4_rr:.3e} of its "
          f"maximum (float atomics)")
    require(k4_rr <= 1e-4, f"two K4 launches differ by {k4_rr}")
    k4_ms = time_ms(run_k4, reps=5, warm=1)
    k5_ms = time_ms(run_k5, reps=5, warm=1)
    fld_p = vol.field.detach().clone().requires_grad_(True)
    outs_p = march_chief_dense(vol._replace(field=fld_p), *chief, algorithm=2)
    # (the exit z is a landing plane and carries no gradient)
    diff_p = [i for i, o in enumerate(outs_p) if o.requires_grad]
    march_plain_bwd_ms = time_ms(
        lambda: torch.autograd.grad([outs_p[i] for i in diff_p], fld_p,
                                    grad_outputs=[ct6[i] for i in diff_p],
                                    retain_graph=True), reps=3, warm=1)
    del outs_p, fld_p
    k4_ops = steps * (4 * MARCH_VJP_OPS_PER_STAGE + MARCH_VJP_OPS_PER_COMBINE)
    k4_bound, k4_by = bound_ms(traj_bytes + 21 * P * 4 + 2 * field_bytes,
                               k4_ops)
    k5_ops = k4_ops + steps * (
        (8 + 4 * iters_bench) * MARCH_OPS_PER_RHS
        + (2 + iters_bench) * MARCH_OPS_PER_RK4_COMBINE)
    k5_bound, k5_by = bound_ms(27 * P * 4 + 2 * field_bytes, k5_ops)
    print(f"    K4 time {k4_ms:.4f} ms  bound {k4_bound:.4f} ms ({k4_by})  "
          f"K5 time {k5_ms:.4f} ms  bound {k5_bound:.4f} ms ({k5_by})  "
          f"autograd through the plain march {march_plain_bwd_ms:.2f} ms  "
          f"[{card}]")
    for nm, line, ms_, bnd, by in (
            ("march_bwd_stage", 656, k4_ms, k4_bound, k4_by),
            ("march_bwd_remarch", 348, k5_ms, k5_bound, k5_by)):
        e = march_errs["RK4"]["K4" if nm == "march_bwd_stage" else "K5"]
        kernel_rows.append(dict(
            name=nm, route="cuda",
            source="photon_tpu_torch/csrc/march_bwd.cu",
            replaces=f"photon_tpu/ops/march_dense_fused.py:{line}",
            shape=f"{P} rays, 64^3 field, RK4",
            max_abs_err=e[0], state_err=e[1], tolerance=MARCH_FIELD_TOL,
            ms=ms_, plain_ms=march_plain_bwd_ms, bound_ms=bnd, bound_by=by,
            library_ms=None))
    del traj, texit, d_a, d_b

    # ------------------------------------------------------------------
    # phase 2f: K6, the fan's backward
    # ------------------------------------------------------------------
    print("K6 fan backward (csrc/fan_stats.cu) against autograd through the "
          "plain fan")
    # limit: four times the largest error seen on the card (2.5e-4), of each
    # column's largest cotangent.  Kernel and autograd run the same chain
    # without FMA contraction and differ by the order of the sum over the
    # 500 rays and of a few accumulations.  The error is the same for the
    # three lens models, so it is not the discriminant's cotangent
    # 2 beta d_beta - 4 d_gamma (formed the same way on both sides) that sets
    # it but the centroid loss: ct_A + ct_AX X + ct_AY Y nearly cancels for
    # every ray, since scaling a particle's amplitude moves no centroid.
    K6_TOL = 1e-3
    a_mean = float(A[A > 0].mean())

    def fan_grads(fn, cols, dd, lens_model, coef, **extra):
        cc = [c.detach().clone().requires_grad_(True) for c in cols]
        d6 = None if dd is None else tuple(
            d.detach().clone().requires_grad_(True) for d in dd)
        fa, fax, fay = fn(*cc, d6, x_lens, y_lens, sc=sc,
                          lens_model=lens_model, mirror_x=True, **extra)
        den = fa.clamp_min(1e-30)
        loss = (coef[0] * fa / a_mean + coef[1] * fax / den
                + coef[2] * fay / den).sum()
        return torch.autograd.grad(loss, cc + list(d6 or ()))

    def fan_bwd_case(lens_model, d6, sel, label, plain_slice=None):
        """One launch of the kernel route against autograd through the plain
        fan.  The loss is a sum over particles of terms of one particle each,
        so the plain side may be taken `plain_slice` particles at a time (its
        graph holds dozens of (particles, rays) arrays) and concatenated."""
        cols = [a[sel].contiguous() for a in (xs, ys, zs, amp0)]
        dd = None if d6 is None else tuple(d[sel].contiguous() for d in d6)
        n_p = cols[0].shape[0]
        coef = torch.randn(3, n_p, generator=gen, device=dev)
        before = int(fan_stats_backward.launches)
        gk = fan_grads(fan_stats, cols, dd, lens_model, coef)
        sync()
        require(int(fan_stats_backward.launches) == before + 1,
                f"K6 {label}: the kernel route took "
                f"{int(fan_stats_backward.launches) - before} launches, not 1")
        parts = []
        for s0 in range(0, n_p, plain_slice or n_p):
            sl = slice(s0, min(s0 + (plain_slice or n_p), n_p))
            parts.append(fan_grads(
                fan_stats_plain, [c[sl] for c in cols],
                None if dd is None else tuple(d[sl] for d in dd),
                lens_model, coef[:, sl]))
        gp = [torch.cat(g) for g in zip(*parts)]
        err = max(nerr(a, b) for a, b in zip(gk, gp))
        live = int(sum(int((b != 0).any()) for b in gp))
        hold(f"K6 {label}: {len(gp)} column cotangents, {live} not zero "
             f"(each of its maximum)", err, K6_TOL)
        if not all(bool(torch.isfinite(g).all()) for g in gk):
            failures.append(f"K6 {label}: not finite")
        return err

    k6_err = fan_bwd_case("general", deltas6, first,
                          f"general + deltas, {chunk} x {R}")
    fan_bwd_case("general", None, first, f"general, no deltas, {chunk} x {R}")
    for lm in ("apparent", "thin-lens"):
        fan_bwd_case(lm, deltas6, first, f"{lm} + deltas, {chunk} x {R}")
        fan_bwd_case(lm, None, first, f"{lm}, no deltas, {chunk} x {R}")
    # the shape the inversion path gives it: one launch over every particle
    k6_err_whole = fan_bwd_case(
        "general", deltas6, whole,
        f"general + deltas, {P} x {R} (the plain side 4000 particles at a "
        f"time)", plain_slice=4000)
    # off-sensor particles get exactly zero
    gfar_b = fan_grads(fan_stats, far, None, "general",
                       torch.ones(3, chunk, device=dev))
    if not all(float(g[:7].abs().max()) == 0.0 for g in gfar_b):
        failures.append("K6 off-sensor particles")

    consts = np.asarray(fan_constants(sc), dtype=np.float32)

    def fan_bwd_time(sel, **kw):
        cols = [a[sel].contiguous() for a in (xs, ys, zs, amp0)] \
            + [d[sel].contiguous() for d in deltas6]
        ct3 = torch.randn(3, cols[0].shape[0], generator=gen, device=dev)
        return time_ms(lambda: fan_stats_backward(
            cols, x_lens, y_lens, ct3, consts, "general", True), **kw)

    k6_ms = fan_bwd_time(first, inner=20)
    k6_ms_whole = fan_bwd_time(whole)
    cc_p = [a[first].detach().clone().requires_grad_(True)
            for a in (xs, ys, zs, amp0)]
    dd_p = tuple(d[first].detach().clone().requires_grad_(True)
                 for d in deltas6)
    outs_p = fan_stats_plain(*cc_p, dd_p, x_lens, y_lens, sc=sc,
                             lens_model="general", mirror_x=True)
    ct3_p = list(torch.randn(3, chunk, generator=gen, device=dev).unbind(0))
    k6_plain_ms = time_ms(
        lambda: torch.autograd.grad(outs_p, cc_p + list(dd_p),
                                    grad_outputs=ct3_p, retain_graph=True),
        reps=5, warm=1)
    del outs_p, cc_p, dd_p
    bwd_pair_ops = pair_ops + FAN_BWD_OPS_PER_PAIR["general"] \
        + FAN_BWD_OPS_MARCH

    def fan_bwd_bound(n_p):
        return bound_ms(23 * n_p * 4 + 2 * R * 4, n_p * R * bwd_pair_ops)

    k6_bound, k6_by = fan_bwd_bound(chunk)
    k6_bound_whole, _ = fan_bwd_bound(P)
    print(f"    {chunk} x {R}: time {k6_ms:.4f} ms  autograd through the "
          f"plain fan {k6_plain_ms:.2f} ms  bound {k6_bound:.4f} ms "
          f"({k6_by})  [{card}]")
    print(f"    {P} x {R}: time {k6_ms_whole:.4f} ms  bound "
          f"{k6_bound_whole:.4f} ms ({k6_by})  [{card}]")
    kernel_rows.append(dict(
        name="fan_stats_bwd", route="cuda",
        source="photon_tpu_torch/csrc/fan_stats.cu",
        replaces="photon_tpu/ops/fan_pallas.py:230",
        shape=f"{chunk} particles x {R} rays, thick lens, march deltas",
        max_abs_err=k6_err, tolerance=K6_TOL, ms=k6_ms, plain_ms=k6_plain_ms,
        bound_ms=k6_bound, bound_by=k6_by, library_ms=None,
        whole_image=dict(shape=f"{P} x {R}", max_abs_err=k6_err_whole,
                         ms=k6_ms_whole, bound_ms=k6_bound_whole)))

    # ------------------------------------------------------------------
    # phase 2g: K7, the splat's transpose
    # ------------------------------------------------------------------
    print("K7 splat transpose (csrc/splat.cu) against autograd through the "
          "plain splat")
    # limit: 30 times the largest error seen on the card (3.5e-7), of each
    # output's largest value; both sides use erff / expf of the same
    # arguments and differ by the order of the sum over the patch
    K7_TOL = 1e-5
    ct_img = torch.randn(sensor, sensor, generator=gen, device=dev)

    def splat_args(sel, K_):
        c0 = (torch.round(Xbar).to(torch.int32) - K_ // 2).clamp(0, sensor - K_)
        r0 = (torch.round(Ybar).to(torch.int32) - K_ // 2).clamp(0, sensor - K_)
        return [a[sel].contiguous() for a in (Xbar, Ybar, Asc, c0, r0)]

    def splat_grads(fn, args, K_):
        leaves = [a.detach().clone().requires_grad_(True) for a in args[:3]]
        img = fn(*leaves, args[3], args[4], **{**skw, "K": K_})
        return torch.autograd.grad(img, leaves, grad_outputs=ct_img)

    def splat_bwd_case(sel, K_, label):
        args = splat_args(sel, K_)
        gk = splat_grads(splat_particles, args, K_)
        sync()
        gp = splat_grads(splat_particles_plain, args, K_)
        err = max(nerr(a, b) for a, b in zip(gk, gp))
        hold(f"K7 {label}: d(Xs, Ys, A) (each of its maximum)", err, K7_TOL)
        return err

    k7_err = splat_bwd_case(first, K, f"{chunk} spots, K={K}")
    splat_bwd_case(first, 12, f"{chunk} spots, K=12")
    k7_err_whole = splat_bwd_case(whole, K, f"{P} spots, K={K}")

    def splat_bwd_time(sel, **kw):
        args = splat_args(sel, K)
        return time_ms(lambda: splat_backward(
            *args, ct_img, K=K, diameter=D, render_fraction=0.75), **kw)

    k7_ms = splat_bwd_time(first, inner=20)
    k7_ms_whole = splat_bwd_time(whole)
    args_p = splat_args(first, K)
    leaves_p = [a.detach().clone().requires_grad_(True) for a in args_p[:3]]
    img_p = splat_particles_plain(*leaves_p, args_p[3], args_p[4], **skw)
    k7_plain_ms = time_ms(
        lambda: torch.autograd.grad(img_p, leaves_p, grad_outputs=ct_img,
                                    retain_graph=True), reps=5, warm=1)
    del img_p, leaves_p

    def splat_bwd_bound(sl, deposits):
        n_p = Asc[sl].numel()
        ops = n_p * K * K * SPLAT_OPS_PER_PATCH_PIXEL \
            + deposits * SPLAT_BWD_OPS_PER_DEPOSIT
        return bound_ms(32 * n_p + min(sensor * sensor, n_p * K * K) * 4, ops)

    k7_bound, k7_by = splat_bwd_bound(first, k3_dep)
    k7_bound_whole, k7_by_whole = splat_bwd_bound(whole, k3_dep_whole)
    print(f"    {chunk} spots: time {k7_ms:.4f} ms  autograd through the "
          f"plain splat {k7_plain_ms:.2f} ms  bound {k7_bound:.4f} ms "
          f"({k7_by})  [{card}]")
    print(f"    {P} spots: time {k7_ms_whole:.4f} ms  bound "
          f"{k7_bound_whole:.4f} ms ({k7_by_whole})  [{card}]")
    kernel_rows.append(dict(
        name="splat_bwd", route="cuda",
        source="photon_tpu_torch/csrc/splat.cu",
        replaces="photon_tpu/ops/sensor_fast.py:181",
        shape=f"{chunk} spots, K={K}, {sensor}x{sensor} cotangent",
        max_abs_err=k7_err, tolerance=K7_TOL, ms=k7_ms, plain_ms=k7_plain_ms,
        bound_ms=k7_bound, bound_by=k7_by, library_ms=None,
        whole_image=dict(shape=f"{P} spots", max_abs_err=k7_err_whole,
                         ms=k7_ms_whole, bound_ms=k7_bound_whole)))

    # ------------------------------------------------------------------
    # phase 2h: K1, K4 and K5 under the cubic scheme
    # ------------------------------------------------------------------
    print("K1 / K4 / K5 with tricubic interpolation (scheme 2) against the "
          "plain march and autograd through it")

    def with_side_rays(rays, v):
        """The rays with 8000 of them moved sideways: beyond both cubic
        clamps (ux = -3, ux = W + 2) and across them, where taps fold onto
        the border voxels and the weights' derivatives are masked."""
        gg, wv = march_geometry(v), int(v.sizes[0])
        x_at = lambda ux: float(gg.min_x) + (ux - 0.5) * float(gg.sx)  # noqa: E731
        out_ = [r.clone() for r in rays]
        out_[0][:2000] = x_at(-3.0)
        out_[0][2000:4000] = x_at(wv + 2.0)
        out_[0][4000:6000] = torch.linspace(x_at(-2.5), x_at(1.0), 2000,
                                            device=dev)
        out_[0][6000:8000] = torch.linspace(x_at(wv - 2.0), x_at(wv + 1.5),
                                            2000, device=dev)
        return out_

    chief_c = with_side_rays(chief, vol)
    rand_c = with_side_rays(rand_rays, vol_rand)
    geom_r = march_geometry(vol_rand)
    scale_r = float(max(abs(float(v)) for v in
                        (geom_r.min_x, geom_r.min_y, geom_r.z_min,
                         geom_r.z_max)))
    k1c_err = {}
    for v, rays_, sc_v, vname in ((vol, chief_c, scale, "bench 64^3"),
                                  (vol_rand, rand_c, scale_r, "random 12^3")):
        for alg, ss, label in ((2, None, "RK4"), (1, None, "Euler"),
                               (3, 2, "RK4 x 2 substeps")):
            g = march_chief_fused(v, *rays_, algorithm=alg, substeps=ss,
                                  interpolation_scheme=2)
            sync()
            r = march_chief_dense(v, *rays_, algorithm=alg, substeps=ss,
                                  interpolation_scheme=2)
            pe, de = march_err(g, r)
            err = max(pe / sc_v, de)
            if v is vol:
                k1c_err[alg] = err
            hold(f"K1 tricubic {label}, {P} rays, {vname} (normalised)", err,
                 K1_TOL)
    coeff = bspline_prefilter(vol.field)
    rays6c = torch.stack(chief_c).contiguous()
    out_c, texit_c, traj_c = march_forward_residual(coeff, rays6c, gnp, 2,
                                                    True, 2)
    plain_c = mdf.march_forward_noresidual(coeff, chief_c, gnp, 2, 1, 2)
    whole_c = torch.stack(march_chief_fused(vol, *chief_c, algorithm=2,
                                            interpolation_scheme=2))
    sync()
    hold(f"K1 tricubic residual head, {P} rays: values that differ from the "
         f"plain head", float((out_c != plain_c).sum()), 0.0)
    hold("K1 tricubic through march_chief_fused (its own prefilter): values "
         "that differ", float((whole_c != plain_c).sum()), 0.0)
    del out_c, texit_c, traj_c, plain_c, whole_c, rays6c

    # the plain cubic march keeps some 150 bytes of graph a ray, stage and
    # tap pair, so autograd through it goes 30,000 rays at a time
    cubic_errs = {}
    for alg, alg_name in ((2, "RK4"), (1, "Euler")):
        cubic_errs[alg_name] = march_bwd_case(
            vol, chief_c, alg, f"tricubic {alg_name}, {P} rays, bench 64^3",
            scheme=2, ray_slice=30000)
        march_bwd_case(vol_rand, rand_c, alg,
                       f"tricubic {alg_name}, {P} rays, random 12^3", scheme=2)

    # times at the shape the main path gives: the chief rays as they are
    out_c, texit_c, traj_c = march_forward_residual(coeff, rays6, gnp, 2, True,
                                                    2)
    prefilter_ms = time_ms(lambda: bspline_prefilter(vol.field), reps=5,
                           warm=1)
    k1c_ms = time_ms(lambda: mdf.march_forward_noresidual(coeff, chief, gnp,
                                                          2, 1, 2))
    # the shapes of the pair with algorithm 3 and no substeps given: the
    # march at 2 substeps (what choose_substeps picks on this scene) and its
    # two probes on 1024 rays at 2 and 4 substeps
    k1c2_ms = time_ms(lambda: mdf.march_forward_noresidual(coeff, chief, gnp,
                                                           3, 2, 2))
    k1c2_plain_ms = time_ms(lambda: march_chief_dense(
        vol, *chief, algorithm=3, substeps=2, interpolation_scheme=2), reps=3,
        warm=1)
    probe_idx = torch.as_tensor(
        np.linspace(0, P - 1, 1024).astype(np.int64), device=dev)
    probe = [c[probe_idx].contiguous() for c in chief]
    probe_ms, probe_err = {}, 0.0
    for ss in (2, 4):
        g = mdf.march_forward_noresidual(coeff, probe, gnp, 3, ss, 2)
        sync()
        r = march_chief_dense(vol, *probe, algorithm=3, substeps=ss,
                              interpolation_scheme=2)
        pe, de = march_err(tuple(g), r)
        probe_err = max(probe_err, pe / scale, de)
        probe_ms[ss] = time_ms(lambda: mdf.march_forward_noresidual(
            coeff, probe, gnp, 3, ss, 2))
    hold("K1 tricubic, the 1024 probe rays of choose_substeps at 2 and 4 "
         "substeps (normalised)", probe_err, K1_TOL)
    k1c_call_ms = time_ms(lambda: march_chief_fused(
        vol, *chief, algorithm=2, interpolation_scheme=2), reps=5, warm=1)
    k1c_plain_ms = time_ms(lambda: march_chief_dense(
        vol, *chief, algorithm=2, interpolation_scheme=2), reps=3, warm=1)
    k1tc_ms = time_ms(lambda: march_forward_residual(coeff, rays6, gnp, 2,
                                                     True, 2))
    k4c_ms = time_ms(lambda: march_backward_stage(
        coeff, rays6, texit_c, traj_c, ct6, gnp, 2, 2), reps=5, warm=1)
    k5c_ms = time_ms(lambda: march_backward_remarch(
        coeff, rays6, texit_c, out_c, ct6, gnp, 2, iters_bench, 2), reps=5,
        warm=1)
    # autograd through the plain cubic march, the backward half only, summed
    # over slices of 30,000 rays
    cubic_plain_bwd_ms = 0.0
    for s0 in range(0, P, 30000):
        sl = slice(s0, min(s0 + 30000, P))
        fld_p = vol.field.detach().clone().requires_grad_(True)
        outs_p = march_chief_dense(vol._replace(field=fld_p),
                                   *(c[sl] for c in chief), algorithm=2,
                                   interpolation_scheme=2)
        diff_p = [i for i, o in enumerate(outs_p) if o.requires_grad]
        sync()
        t0 = time.perf_counter()
        torch.autograd.grad([outs_p[i] for i in diff_p], fld_p,
                            grad_outputs=[ct6[i, sl] for i in diff_p])
        sync()
        cubic_plain_bwd_ms += (time.perf_counter() - t0) * 1e3
        del outs_p, fld_p
    k1c_ops = steps * (4 * MARCH_OPS_PER_RHS_CUBIC + MARCH_OPS_PER_RK4_COMBINE)
    k1c_bound, k1c_by = bound_ms(k1_bytes, k1c_ops)
    k1c2_bound, k1c2_by = bound_ms(k1_bytes, 2 * k1c_ops)
    k1tc_bound, k1tc_by = bound_ms(15 * P * 4 + field_bytes + traj_bytes,
                                   k1c_ops)
    k4c_ops = steps * (4 * MARCH_VJP_OPS_PER_STAGE_CUBIC
                       + MARCH_VJP_OPS_PER_COMBINE)
    k4c_bound, k4c_by = bound_ms(traj_bytes + 21 * P * 4 + 2 * field_bytes,
                                 k4c_ops)
    k5c_ops = k4c_ops + steps * (
        (8 + 4 * iters_bench) * MARCH_OPS_PER_RHS_CUBIC
        + (2 + iters_bench) * MARCH_OPS_PER_RK4_COMBINE)
    k5c_bound, k5c_by = bound_ms(27 * P * 4 + 2 * field_bytes, k5c_ops)
    print(f"    prefilter of the 64^3 field (PyTorch, no kernel of this "
          f"package) {prefilter_ms:.3f} ms; march_chief_fused with it "
          f"{k1c_call_ms:.3f} ms  [{card}]")
    print(f"    K1 tricubic time {k1c_ms:.4f} ms  plain {k1c_plain_ms:.2f} ms "
          f"(with its prefilter)  bound {k1c_bound:.4f} ms ({k1c_by})  "
          f"residual head {k1tc_ms:.4f} ms  bound {k1tc_bound:.4f} ms "
          f"({k1tc_by})  [{card}]")
    print(f"    K1 tricubic with 2 substeps: time {k1c2_ms:.4f} ms  plain "
          f"{k1c2_plain_ms:.2f} ms  bound {k1c2_bound:.4f} ms ({k1c2_by}); on "
          f"the 1024 probe rays {probe_ms[2]:.4f} ms at 2 substeps, "
          f"{probe_ms[4]:.4f} ms at 4  [{card}]")
    print(f"    K4 tricubic time {k4c_ms:.4f} ms  bound {k4c_bound:.4f} ms "
          f"({k4c_by})  K5 tricubic time {k5c_ms:.4f} ms  bound "
          f"{k5c_bound:.4f} ms ({k5c_by})  autograd through the plain cubic "
          f"march {cubic_plain_bwd_ms:.2f} ms  (trilinear: K4 {k4_ms:.4f} ms, "
          f"K5 {k5_ms:.4f} ms)  [{card}]")
    cubic_shape = f"{P} rays, 64^3 coefficients, RK4, tricubic"
    kernel_rows.append(dict(
        name="march_dense_cubic", route="cuda",
        source="photon_tpu_torch/csrc/march_dense.cu",
        replaces="photon_tpu/ops/march_dense_fused.py:174",
        shape=cubic_shape + " with 2 substeps (the march of the pair that "
        "launches it)",
        max_abs_err=k1c_err[3], tolerance=K1_TOL, ms=k1c2_ms,
        plain_ms=k1c2_plain_ms, bound_ms=k1c2_bound, bound_by=k1c2_by,
        library_ms=None, prefilter_ms=prefilter_ms,
        one_substep=dict(shape=cubic_shape, max_abs_err=k1c_err[2],
                         ms=k1c_ms, plain_ms=k1c_plain_ms,
                         bound_ms=k1c_bound, ms_with_prefilter=k1c_call_ms),
        probes=dict(shape="1024 rays, 2 and 4 substeps",
                    max_abs_err=probe_err, ms=[probe_ms[2], probe_ms[4]])))
    kernel_rows.append(dict(
        name="march_dense_residual_cubic", route="cuda",
        source="photon_tpu_torch/csrc/march_dense.cu",
        replaces="photon_tpu/ops/march_dense_fused.py:164", shape=cubic_shape,
        max_abs_err=0.0, tolerance=0.0, ms=k1tc_ms, plain_ms=k1c_plain_ms,
        bound_ms=k1tc_bound, bound_by=k1tc_by, library_ms=None))
    for nm, line, ms_, bnd, by in (
            ("march_bwd_stage_cubic", 656, k4c_ms, k4c_bound, k4c_by),
            ("march_bwd_remarch_cubic", 348, k5c_ms, k5c_bound, k5c_by)):
        e = cubic_errs["RK4"]["K4" if "stage" in nm else "K5"]
        kernel_rows.append(dict(
            name=nm, route="cuda",
            source="photon_tpu_torch/csrc/march_bwd.cu",
            replaces=f"photon_tpu/ops/march_dense_fused.py:{line}",
            shape=cubic_shape, max_abs_err=e[0], state_err=e[1],
            tolerance=MARCH_FIELD_TOL, ms=ms_, plain_ms=cubic_plain_bwd_ms,
            bound_ms=bnd, bound_by=by, library_ms=None))
    del out_c, texit_c, traj_c

    # ------------------------------------------------------------------
    # phase 2i: K8 and K9, the per-stage slab sampler and its backward
    # ------------------------------------------------------------------
    print("K8 / K9 slab sampler (csrc/slab_sample.cu) against its plain "
          "version and autograd through it")
    # limits: the kernel and the plain version run the same f32 formulas and
    # differ by FMA contraction (values: 5e-6 of each channel's maximum) and,
    # for the slabs' cotangent, by the order in which some hundreds of rays
    # add into a voxel (atomics against index_add: 5e-5 of the maximum).  The
    # coordinate cotangents are sums of differences of neighbouring taps,
    # which cancel, so contraction shows at 1e-5 (seen: 9e-6): 5e-5 of the
    # largest of the three rows.  One scale for the three on the bench
    # field only: it varies along x alone, so d_uy and d_uz are zero in exact
    # arithmetic and hold nothing but rounding (held each at its own maximum
    # they read 1.08 and 0.82).  On the noise slabs all three rows are live
    # and each is held at its own maximum, to 5e-6 (seen: 2.4e-7).
    K8_TOL, K9_SLAB_TOL, K9_COORD_TOL, K9_COORD_ROW_TOL = 5e-6, 5e-5, 5e-5, 5e-6
    w_v, h_v = int(vol.sizes[0]), int(vol.sizes[1])
    ks_mid = n // 2
    on_slab = (0.5 + (chief[0] - float(geom.min_x)) / float(geom.sx),
               0.5 + (chief[1] - float(geom.min_y)) / float(geom.sy))

    def uniform(lo_, hi_):
        return lo_ + (hi_ - lo_) * torch.rand(P, generator=gen, device=dev)

    def rows_err(a, b):
        return max(nerr(x_, y_) for x_, y_ in zip(a, b))

    sampler = {}
    noise = [torch.randn(h_v, w_v, 4, generator=gen, device=dev)
             for _ in range(2)]
    for scheme in (1, 2):
        fld = coeff if scheme == 2 else vol.field
        cases = (("the chief rays on a slab pair of the bench volume",
                  fld[ks_mid], fld[ks_mid + 1],
                  on_slab + (uniform(0.0, 1.0),)),
                 ("random slabs, coordinates beyond both clamps", *noise,
                  (uniform(-4.0, w_v + 3.0), uniform(-4.0, h_v + 3.0),
                   uniform(0.0, 1.0))))
        for label, lo_s, hi_s, uu in cases:
            uu = tuple(u.contiguous() for u in uu)
            got = slab_sample_forward(lo_s, hi_s, *uu, scheme)
            sync()
            ref = torch.stack(slab_sample_plain(lo_s, hi_s, *uu, scheme))
            e8 = rows_err(got, ref)
            hold(f"K8 scheme {scheme}, {P} rays, {label} (each channel of its "
                 f"maximum)", e8, K8_TOL)
            ct4 = torch.randn(4, P, generator=gen, device=dev)
            d_lo, d_hi, d_u = slab_sample_backward(lo_s, hi_s, *uu, ct4,
                                                   scheme)
            sync()
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (lo_s, hi_s) + uu]
            gp = torch.autograd.grad(
                torch.stack(slab_sample_plain(*leaves, scheme)), leaves,
                grad_outputs=ct4)
            e9s = max(nerr(d_lo, gp[0]), nerr(d_hi, gp[1]))
            on_bench = label.startswith("the chief")
            if on_bench:
                e9u = float(max((a_ - b_).abs().max()
                                for a_, b_ in zip(d_u, gp[2:]))
                            / max(b_.abs().max() for b_ in gp[2:]))
            else:
                e9u = rows_err(d_u, gp[2:])
            hold(f"K9 scheme {scheme}, {label}: d_lo, d_hi (of their maxima)",
                 e9s, K9_SLAB_TOL)
            hold(f"K9 scheme {scheme}, {label}: d_ux, d_uy, d_uz "
                 f"({'of the largest' if on_bench else 'each of its maximum'})",
                 e9u, K9_COORD_TOL if on_bench else K9_COORD_ROW_TOL)
            if on_bench:
                sampler[scheme] = dict(uu=uu, ct=ct4, lo=lo_s, hi=hi_s,
                                       e8=e8, e9=max(e9s, e9u))
    slab_bytes = w_v * h_v * 16
    for scheme in (1, 2):
        c = sampler[scheme]
        c["k8_ms"] = time_ms(lambda: slab_sample_forward(
            c["lo"], c["hi"], *c["uu"], scheme), inner=20)
        c["k9_ms"] = time_ms(lambda: slab_sample_backward(
            c["lo"], c["hi"], *c["uu"], c["ct"], scheme), inner=20)
        c["k8_plain_ms"] = time_ms(lambda: slab_sample_plain(
            c["lo"], c["hi"], *c["uu"], scheme), reps=5, warm=1)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (c["lo"], c["hi"]) + c["uu"]]
        out_p = torch.stack(slab_sample_plain(*leaves, scheme))
        c["k9_plain_ms"] = time_ms(lambda: torch.autograd.grad(
            out_p, leaves, grad_outputs=c["ct"], retain_graph=True), reps=5,
            warm=1)
        del out_p, leaves
        c["k8_bound"], c["k8_by"] = bound_ms(
            7 * P * 4 + 2 * slab_bytes, P * SAMPLE_OPS[scheme])
        c["k9_bound"], c["k9_by"] = bound_ms(
            10 * P * 4 + 4 * slab_bytes,
            P * (SAMPLE_OPS[scheme] + SAMPLE_VJP_OPS[scheme]))
    # the one PyTorch call that computes the trilinear sample: grid_sample
    # over the two slabs as a depth-2 volume, border padding (the cubic one
    # has none: grid_sample's bicubic is another kernel, and 2-D only)
    c1 = sampler[1]
    gs_in = torch.stack([c1["lo"], c1["hi"]]).permute(3, 0, 1, 2)[None]
    gs_in = gs_in.contiguous().requires_grad_(True)
    gs_grid = torch.stack([2.0 * c1["uu"][0] / (w_v - 1.0) - 1.0,
                           2.0 * c1["uu"][1] / (h_v - 1.0) - 1.0,
                           2.0 * c1["uu"][2] - 1.0], -1)
    gs_grid = gs_grid.reshape(1, 1, 1, P, 3).requires_grad_(True)
    gs_kw = dict(mode="bilinear", padding_mode="border", align_corners=True)
    with torch.no_grad():
        gs_out = torch.nn.functional.grid_sample(gs_in, gs_grid, **gs_kw)
        k8_lib_err = rows_err(gs_out.reshape(4, P), slab_sample_forward(
            c1["lo"], c1["hi"], *c1["uu"], 1))
        k8_lib_ms = time_ms(lambda: torch.nn.functional.grid_sample(
            gs_in, gs_grid, **gs_kw), inner=20)
    gs_out = torch.nn.functional.grid_sample(gs_in, gs_grid, **gs_kw)
    k9_lib_ms = time_ms(lambda: torch.autograd.grad(
        gs_out, [gs_in, gs_grid], grad_outputs=c1["ct"].reshape(gs_out.shape),
        retain_graph=True), inner=20)
    del gs_out
    print(f"    grid_sample on the same inputs differs from K8 by "
          f"{k8_lib_err:.3e} of each channel's maximum")
    require(k8_lib_err <= 1e-4, "grid_sample does not compute K8's function")
    for scheme in (1, 2):
        c = sampler[scheme]
        print(f"    scheme {scheme}: K8 time {c['k8_ms']:.4f} ms  plain "
              f"{c['k8_plain_ms']:.3f} ms  bound {c['k8_bound']:.5f} ms "
              f"({c['k8_by']})  K9 time {c['k9_ms']:.4f} ms  autograd through "
              f"the plain sampler {c['k9_plain_ms']:.3f} ms  bound "
              f"{c['k9_bound']:.5f} ms ({c['k9_by']})  [{card}]")
    print(f"    grid_sample {k8_lib_ms:.4f} ms, its backward {k9_lib_ms:.4f} "
          f"ms (trilinear only)  [{card}]")
    c2 = sampler[2]
    for nm, line, key, lib_ms in (("slab_sample", 166, "k8", k8_lib_ms),
                                  ("slab_sample_bwd", 181, "k9", k9_lib_ms)):
        err_key = "e8" if key == "k8" else "e9"
        kernel_rows.append(dict(
            name=nm, route="cuda",
            source="photon_tpu_torch/csrc/slab_sample.cu",
            replaces=f"photon_tpu/ops/march_dense_pallas.py:{line}",
            shape=f"{P} rays, one 64 x 64 slab pair, trilinear",
            max_abs_err=c1[err_key],
            tolerance=K8_TOL if key == "k8" else K9_SLAB_TOL,
            ms=c1[key + "_ms"], plain_ms=c1[key + "_plain_ms"],
            bound_ms=c1[key + "_bound"], bound_by=c1[key + "_by"],
            library_ms=lib_ms,
            cubic=dict(shape=f"{P} rays, one 64 x 64 slab pair, tricubic",
                       max_abs_err=c2[err_key], ms=c2[key + "_ms"],
                       plain_ms=c2[key + "_plain_ms"],
                       bound_ms=c2[key + "_bound"], library_ms=None)))
    del sampler, c1, c2, coeff

    if failures:
        raise SystemExit(f"chip_smoke: kernel comparisons failed: {failures}")

    # ------------------------------------------------------------------
    # phase 3: the main path, through the command line entry point
    # ------------------------------------------------------------------
    print("rendering path: photon_tpu_torch.cli.main at full size")
    with tempfile.TemporaryDirectory(prefix="photon_smoke_") as tmp:
        case, nrrd = write_bench_case(tmp, cfg, rho, spacings, origin)
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
            if row["name"] in counts:
                row["launches"] = counts[row["name"]]
                row["launches_on"] = "cli.main, the BOS pair"
        print(f"    launches on the rendering path: {counts}")
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
        with torch.no_grad():
            plain2 = plain_render(vol_file, whole).cpu().numpy()
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
                if row["name"] not in tags:
                    continue
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

    # ------------------------------------------------------------------
    # phase 4: the inversion path, invert_bos at full size
    # ------------------------------------------------------------------
    print("inversion path: photon_tpu_torch.inverse.invert_bos at full size")
    gd = cfg.density_gradients.gladstone_dale
    rho_true = rho.astype(np.float32)
    rho_uniform = np.full_like(rho_true, cfg.density_gradients.rho_0)
    # a start whose spots overlap those of the observation
    rho0 = rho_uniform + 0.8 * (rho_true - rho_uniform)
    lr = 0.01 * float(rho_true.max() - rho_true.min())
    n_steps = 5
    inv_wrappers = dict(
        march_dense_residual=march_chief_fused,
        march_bwd_stage=march_backward_stage,
        march_bwd_remarch=march_backward_remarch,
        fan_stats=fan_stats, fan_stats_bwd=fan_stats_backward,
        splat=splat_particles, splat_bwd=splat_backward)

    def counted(fn):
        for w in inv_wrappers.values():
            w.launches = 0
        out_ = fn()
        sync()
        return out_, {k: int(w.launches) for k, w in inv_wrappers.items()}

    t0 = time.perf_counter()
    res, counts_inv = counted(lambda: invert_bos(
        cfg, setup, source, r1, r2, im2, vol, rho0=rho0, steps=n_steps,
        learning_rate=lr, algorithm=2, device=dev))
    inv_s = time.perf_counter() - t0
    print(f"    {n_steps} steps in {inv_s:.3f} s (the first builds nothing: "
          f"the kernels are loaded); losses "
          f"{', '.join(f'{v:.6g}' for v in res.losses)}  [{card}]")
    print(f"    launches in {n_steps} steps: {counts_inv}")
    require(all(math.isfinite(v) for v in res.losses), "a loss is not finite")
    require(res.losses[-1] < res.losses[0],
            f"the loss did not fall: {res.losses}")
    require(res.rho.shape == rho_true.shape and np.isfinite(res.rho).all()
            and tuple(res.volume.field.shape) == tuple(vol.field.shape),
            "the recovered rho or its volume is malformed")
    # per step: one march with the residual and one stage backward; the fan
    # and the splat forward and backward once a chunk (one chunk: nothing on
    # this path holds a (P, R) array)
    expect_inv = dict(march_dense_residual=n_steps, march_bwd_stage=n_steps,
                      march_bwd_remarch=0, fan_stats=n_steps,
                      fan_stats_bwd=n_steps, splat=n_steps, splat_bwd=n_steps)
    if counts_inv != expect_inv:
        raise SystemExit(f"chip_smoke: launch counts {counts_inv}, expected "
                         f"{expect_inv}")
    # the same first step with the residual over its budget: the re-march
    # backward
    res5, counts_k5 = counted(lambda: with_budget(0, lambda: invert_bos(
        cfg, setup, source, r1, r2, im2, vol, rho0=rho0, steps=1,
        learning_rate=lr, algorithm=2, device=dev)))
    print(f"    one step with the residual budget at 0: launches {counts_k5}, "
          f"loss {res5.losses[0]:.6g}")
    require(counts_k5["march_bwd_remarch"] == 1
            and counts_k5["march_bwd_stage"] == 0,
            f"the re-march backward was not taken: {counts_k5}")
    require(abs(res5.losses[0] - res.losses[0]) <= 1e-5 * res.losses[0],
            "the first loss depends on the residual budget")
    # which run a row's count comes from stands beside it: the five steps
    # above, or (the re-march backward, which they never take) the one step
    # with the residual over its budget
    five = f"invert_bos, {n_steps} steps"
    over = "invert_bos, 1 step with the stage residual over its budget"
    for row in kernel_rows:
        nm = row["name"]
        if nm not in counts_inv:
            continue
        if "launches" in row:                   # a kernel of both paths
            row["launches_inversion"] = counts_inv[nm]
        elif nm == "march_bwd_remarch":
            row["launches"], row["launches_on"] = counts_k5[nm], over
            row["launches_default_budget"] = counts_inv[nm]
        else:
            row["launches"], row["launches_on"] = counts_inv[nm], five
        require(row["launches"] > 0 and row.get("launches_inversion", 1) > 0,
                f"{nm} was never launched on the inversion path")

    # the first step's gradient against the same step through the plain
    # versions, at every tenth particle
    target = f32(im2)
    rho0_t = f32(rho0)
    tenth = slice(0, P, 10)
    sub = dataclasses.replace(
        source, x=source.x[tenth], y=source.y[tenth], z=source.z[tenth],
        radiance=source.radiance[tenth],
        diameter_index=source.diameter_index[tenth])

    def first_step(render):
        rho_t = rho0_t.detach().clone().requires_grad_(True)
        img = render(volume_from_rho(rho_t, vol, gd))
        loss = torch.mean((img - target) ** 2)
        (g,) = torch.autograd.grad(loss, rho_t)
        return float(loss.detach()), g

    def kernel_render(src, **kw):
        kw = {"algorithm": 2, **kw}
        return lambda v: render_image_fast(cfg, setup, src, r1, r2, vol=v,
                                           device=dev, **kw)

    loss_k, g_k = first_step(kernel_render(sub))
    _, g_k5 = with_budget(0, lambda: first_step(kernel_render(sub)))
    loss_p, g_p = first_step(lambda v: plain_render(v, tenth))

    cos_kp, cos_k5 = cosine(g_k, g_p), cosine(g_k5, g_p)
    rel_l2 = float((g_k - g_p).norm() / g_p.norm())
    print(f"    d_rho of the first step at every tenth particle "
          f"({sub.num_particles}): kernels against plain versions cosine "
          f"{cos_kp:.7f}, relative L2 {rel_l2:.3e}; re-march backward "
          f"against plain cosine {cos_k5:.7f}; loss {loss_k:.6g} against "
          f"{loss_p:.6g}")
    require(cos_kp >= 0.9999 and cos_k5 >= 0.9999,
            f"d_rho: cosine {cos_kp} / {cos_k5} against the plain versions")
    require(float(g_p.abs().max()) > 0 and bool(torch.isfinite(g_k).all()),
            "d_rho is zero or not finite")

    # seconds per step, forward and backward apart (host clock, device
    # synchronised)
    def timed_step(**kw):
        rho_t = rho0_t.detach().clone().requires_grad_(True)
        sync()
        ta = time.perf_counter()
        img = kernel_render(source, **kw)(volume_from_rho(rho_t, vol, gd))
        loss = torch.mean((img - target) ** 2)
        sync()
        tb = time.perf_counter()
        torch.autograd.grad(loss, rho_t)
        sync()
        return tb - ta, time.perf_counter() - tb

    timed_step()
    fb = [timed_step() for _ in range(5)]
    fwd_s = statistics.median(t[0] for t in fb)
    bwd_s = statistics.median(t[1] for t in fb)
    print(f"    one step: forward {fwd_s * 1e3:.3f} ms, backward "
          f"{bwd_s * 1e3:.3f} ms (median of 5)  [{card}]")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_step()
    dev_events = [ev for ev in prof.key_averages()
                  if "CUDA" in str(getattr(ev, "device_type", "")).upper()]
    dev_us = sum(ev.self_device_time_total for ev in dev_events)
    if dev_us > 0:
        tags = dict(march_dense_residual="march_dense_kernel",
                    march_bwd_stage="march_bwd_stage_kernel",
                    fan_stats="fan_stats_kernel",
                    fan_stats_bwd="fan_stats_bwd_kernel",
                    splat="splat_kernel", splat_bwd="splat_bwd_kernel")
        ours = 0.0
        for nm, tag in tags.items():
            evs = [ev for ev in dev_events if tag in ev.key]
            us = sum(ev.self_device_time_total for ev in evs)
            ours += us
            for row in kernel_rows:
                if row["name"] == nm:
                    row["device_ms_on_inversion_step"] = us / 1e3
            print(f"    traced step, {nm}: {sum(ev.count for ev in evs)} "
                  f"launches, {us / 1e3:.3f} ms on the device  [{card}]")
        print(f"    traced step: device busy {dev_us / 1e3:.2f} ms in all "
              f"kernels and copies, {ours / 1e3:.2f} ms of it in the six "
              f"kernels; an untraced step takes "
              f"{(fwd_s + bwd_s) * 1e3:.2f} ms, so the device was busy for "
              f"about {dev_us / 1e6 / (fwd_s + bwd_s):.1%} of it (the two "
              f"times come from different runs)  [{card}]")
    else:
        print("    traced step: the profiler reported no device time; device "
              "busy share not measured")

    # ------------------------------------------------------------------
    # phase 5: the rest of the march menu through the command line
    # ------------------------------------------------------------------
    print("the march menu: photon_tpu_torch.cli.main at full size with "
          "tricubic + algorithm 3, and with Adams-Bashforth")
    menu_wrappers = dict(
        march_dense=march_chief_fused, march_bwd_stage=march_backward_stage,
        march_bwd_remarch=march_backward_remarch,
        slab_sample=slab_sample_forward, slab_sample_bwd=slab_sample_backward,
        fan_stats=fan_stats, splat=splat_particles)

    def counted_menu(fn):
        for w in menu_wrappers.values():
            w.launches = 0
        out_ = fn()
        sync()
        return out_, {k: int(w.launches) for k, w in menu_wrappers.items()}

    n_slabs = n - 1
    pair_rest = dict(march_bwd_stage=0, march_bwd_remarch=0,
                     slab_sample_bwd=0, fan_stats=2 * n_chunks,
                     splat=2 * n_chunks)
    menu_counts = {}
    for label, alg, scheme in (("tricubic, algorithm 3, substeps from the "
                                "data", 3, 2), ("Adams-Bashforth", 4, 1)):
        cfg_m = dataclasses.replace(cfg, density_gradients=dataclasses.replace(
            cfg.density_gradients, ray_tracing_algorithm=alg,
            interpolation_scheme=scheme))
        render_fast._substep_cache.clear()
        with tempfile.TemporaryDirectory(prefix="photon_smoke_") as tmp:
            case, nrrd = write_bench_case(tmp, cfg_m, rho, spacings, origin)
            out = os.path.join(tmp, "out")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc, counts_m = counted_menu(
                    lambda: cli_main([case, "--out", out, "--verbose"]))
            if rc != 0:
                raise SystemExit(f"chip_smoke: the CLI returned {rc} ({label})")
            im2_m = np.fromfile(
                os.path.join(out, "raw", "bos_pattern_image_2.bin"),
                np.float32).reshape(sensor, sensor)
            vol_file = load_density_volume(
                nrrd, gladstone_dale=cfg.density_gradients.gladstone_dale,
                device=dev)
        chosen = list(render_fast._substep_cache.values())
        print(f"    {label}: launches {counts_m}; substeps chosen "
              f"{chosen if alg == 3 else 'none (one step a slab)'}")
        if alg == 3:
            require(len(chosen) == 1 and 2 <= chosen[0] <= 16,
                    f"choose_substeps gave {chosen}")
            # two probe marches of choose_substeps and the march itself, all
            # through the cubic march kernel; no per-stage sampling
            expect_m = dict(march_dense=3, slab_sample=0, **pair_rest)
            substeps_m = chosen[0]
        else:
            # a slab step samples four RK4 stages; the first is also the
            # Adams-Bashforth right-hand side at the step's entry
            expect_m = dict(march_dense=0, slab_sample=4 * n_slabs,
                            **pair_rest)
            substeps_m = None
        if counts_m != expect_m:
            raise SystemExit(f"chip_smoke: {label}: launch counts {counts_m}, "
                             f"expected {expect_m}")
        menu_counts[alg] = counts_m
        with torch.no_grad():
            plain_m = plain_render(vol_file, whole, alg, scheme,
                                   substeps_m).cpu().numpy()
        require(counts_m == {k: int(w.launches)
                             for k, w in menu_wrappers.items()},
                "the plain render launched a kernel")
        l1_m = float(np.abs(im2_m - plain_m).sum() / plain_m.sum())
        moved_m = float(np.abs(im2_m - im2).sum() / im2.sum())
        print(f"    {label}: im2 against the plain render L1 {l1_m:.3e} of "
              f"the sum (tolerance 1.0e-03); against the trilinear RK4 im2 "
              f"{moved_m:.3e}")
        require(np.isfinite(im2_m).all() and l1_m < 1e-3,
                f"{label}: im2 is {l1_m} (L1) from the plain render")
        for line in buf.getvalue().splitlines():
            mt = re.match(r"\s*(render:\S+|volume): ([0-9.]+)s(?:\s+([0-9.]+)M "
                          r"rays/s)?", line)
            if mt:
                rate = f", {mt.group(3)}M rays/s" if mt.group(3) else ""
                print(f"    {label}: {mt.group(1)}: {mt.group(2)} s{rate}  "
                      f"[{card}]")
    for row in kernel_rows:
        if row["name"] == "march_dense_cubic":
            row["launches"] = menu_counts[3]["march_dense"]
            row["launches_on"] = ("cli.main, the BOS pair with tricubic "
                                  "interpolation and algorithm 3: the march "
                                  "and the two probes of choose_substeps")
        elif row["name"] == "slab_sample":
            row["launches"] = menu_counts[4]["slab_sample"]
            row["launches_on"] = "cli.main, the BOS pair with Adams-Bashforth"

    # ------------------------------------------------------------------
    # phase 6: gradients through the new routes, one chunk at full size
    # ------------------------------------------------------------------
    print("gradients of the new routes: invert_bos's render loss at full "
          "size, one forward and backward each")

    def traced_busy(**kw):
        """Device time of one traced step, by kernel name."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_:
            timed_step(**kw)
        evs = [ev for ev in prof_.key_averages()
               if "CUDA" in str(getattr(ev, "device_type", "")).upper()]
        return sum(ev.self_device_time_total for ev in evs), evs

    def grad_route(label, expect, plain_kw, **kw):
        """One step of invert_bos for the launch counts, the same step's
        d_rho at every tenth particle against the plain versions, seconds
        per half-step and the device's busy share."""
        render_fast._substep_cache.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        step_fn = kw.pop("step_fn")
        res_r, counts_r = counted_menu(step_fn)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"    {label}: launches {counts_r}; loss {res_r:.6g}; peak "
              f"device memory {peak_gb:.2f} GB  [{card}]")
        for k, v in expect.items():
            require(counts_r[k] == v, f"{label}: {k} launched "
                    f"{counts_r[k]} times, expected {v}")
        _, g_kern = first_step(kernel_render(sub, **kw))
        _, g_plain = first_step(lambda v: plain_render(v, tenth, **plain_kw))
        cos = cosine(g_kern, g_plain)
        rel = float((g_kern - g_plain).norm() / g_plain.norm())
        timed_step(**kw)
        fb_ = [timed_step(**kw) for _ in range(3)]
        f_s = statistics.median(t[0] for t in fb_)
        b_s = statistics.median(t[1] for t in fb_)
        dev_us_, evs_ = traced_busy(**kw)
        busy = (f"{dev_us_ / 1e6 / (f_s + b_s):.1%}" if dev_us_ > 0
                else "not measured")
        print(f"    {label}: d_rho at every tenth particle against the plain "
              f"versions cosine {cos:.7f}, relative L2 {rel:.3e}; forward "
              f"{f_s * 1e3:.2f} ms, backward {b_s * 1e3:.2f} ms (median of "
              f"3); device busy {busy} of the step ({dev_us_ / 1e3:.2f} ms of "
              f"device time, traced run over untraced ones)  [{card}]")
        require(cos >= 0.9999 and bool(torch.isfinite(g_kern).all())
                and float(g_plain.abs().max()) > 0,
                f"{label}: d_rho cosine {cos} against the plain versions")
        return counts_r, evs_

    def one_invert_step(algorithm):
        return lambda: invert_bos(
            cfg, setup, source, r1, r2, im2, vol, rho0=rho0, steps=1,
            learning_rate=lr, algorithm=algorithm, device=dev).losses[0]

    def one_render_step(**kw):
        return lambda: first_step(kernel_render(source, **kw))[0]

    # RK4 with substeps under autograd: choose_substeps probes twice through
    # the fused kernel, then every stage of the march samples through K8 and
    # its backward through K9 (substeps x 4 stages a slab)
    sub2 = 2 * 4 * n_slabs
    counts_s, evs_s = grad_route(
        "algorithm 3 (substeps from the data)",
        dict(march_dense=2, slab_sample=sub2, slab_sample_bwd=sub2,
             march_bwd_stage=0, march_bwd_remarch=0),
        dict(algorithm=3, substeps=2), step_fn=one_invert_step(3),
        algorithm=3)
    require(list(render_fast._substep_cache.values()) == [2] * len(
        render_fast._substep_cache), "choose_substeps did not pick 2 here")
    counts_a, _ = grad_route(
        "algorithm 4 (Adams-Bashforth)",
        dict(march_dense=0, slab_sample=4 * n_slabs,
             slab_sample_bwd=4 * n_slabs, march_bwd_stage=0,
             march_bwd_remarch=0),
        dict(algorithm=4), step_fn=one_invert_step(4), algorithm=4)
    counts_c, evs_c = grad_route(
        "tricubic RK4, stage residual",
        dict(march_dense=1, march_bwd_stage=1, march_bwd_remarch=0,
             slab_sample=0, slab_sample_bwd=0),
        dict(algorithm=2, scheme=2),
        step_fn=one_render_step(interpolation_scheme=2),
        interpolation_scheme=2)
    counts_c5, _ = with_budget(0, lambda: grad_route(
        "tricubic RK4, re-march backward",
        dict(march_dense=1, march_bwd_stage=0, march_bwd_remarch=1,
             slab_sample=0, slab_sample_bwd=0),
        dict(algorithm=2, scheme=2),
        step_fn=one_render_step(interpolation_scheme=2),
        interpolation_scheme=2))
    for tag, evs_ in (("slab_sample_kernel", evs_s),
                      ("slab_sample_bwd_kernel", evs_s),
                      ("march_dense_kernel", evs_c),
                      ("march_bwd_stage_kernel", evs_c)):
        hit = [ev for ev in evs_ if tag in ev.key]
        if hit:
            n_ev = sum(ev.count for ev in hit)
            us = sum(ev.self_device_time_total for ev in hit)
            print(f"    traced step, {tag}: {n_ev} launches, {us / 1e3:.3f} "
                  f"ms on the device, {us / max(n_ev, 1):.1f} us a launch  "
                  f"[{card}]")
    step3 = "one step of invert_bos with algorithm 3 (substeps 2)"
    cubic_step = ("one forward and backward of the render loss with tricubic "
                  "interpolation")
    for row in kernel_rows:
        nm = row["name"]
        if nm == "slab_sample":
            row["launches_gradient_step"] = counts_s["slab_sample"]
        elif nm == "slab_sample_bwd":
            row["launches"], row["launches_on"] = (counts_s[nm], step3)
            row["launches_adams_bashforth_step"] = counts_a[nm]
        elif nm == "march_dense_residual_cubic":
            row["launches"], row["launches_on"] = (counts_c["march_dense"],
                                                   cubic_step)
        elif nm == "march_bwd_stage_cubic":
            row["launches"], row["launches_on"] = (counts_c["march_bwd_stage"],
                                                   cubic_step)
        elif nm == "march_bwd_remarch_cubic":
            row["launches"] = counts_c5["march_bwd_remarch"]
            row["launches_on"] = (cubic_step + ", the stage residual over its "
                                  "budget")
    for row in kernel_rows:
        require(row.get("launches", 0) > 0,
                f"{row['name']} was never launched on a main path")

    kernel_rows.extend(large_tier())
    return finish(kernel_rows)


if __name__ == "__main__":
    sys.exit(main())
