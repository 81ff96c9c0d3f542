#!/usr/bin/env python3
"""The JAX package's ray-dump validation flow on chip_smoke phase 12's case,
on the CPU, at a subsample: the limits the port is held to on the card.

    python3 oracle_flow.py [--every 40] [--algorithm 4]

Phase 12 (c) of ``chip_smoke.py`` dumps the rays of the bench scene under
the reference sample scene's camera (``y_camera_angle = 5 pi / 6``, the thin
lens) through a 64^3 ramp placed across its world-frame rays
(``chip_smoke.volume_across_rays``), averages each dot's rays
(``analysis.light_rays.process_lightray_data``) and compares the per-dot
displacement with ``analysis.fields.paraxial_displacement_oracle``, by
tests/test_sample_scene.py:158-166's measures: slope, correlation, and RMS
against the largest displacement.  That test's limits were set for the
reference's own sample volume; this ramp is steeper.  This script runs the
same flow through the JAX package (``render_rays`` with and without the
march, then the analysis and the oracle), on every ``--every``-th particle
of each dot, and prints each axis's readings and whether the sample
scene's limits hold.  It imports JAX and the JAX package; it is no part of
the port.
"""
import argparse
import math
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--every", type=int, default=40,
                    help="trace every n-th particle of each dot")
    ap.add_argument("--algorithm", type=int, default=4,
                    help="the march's ray_tracing_algorithm")
    args = ap.parse_args(argv)

    import numpy as np

    import jax
    jax.config.update("jax_platforms", "cpu")

    import chip_smoke
    from photon_tpu.analysis.fields import paraxial_displacement_oracle
    from photon_tpu.analysis.light_rays import process_lightray_data
    from photon_tpu.config import SimulationConfig
    from photon_tpu.models.optics import camera_setup
    from photon_tpu.models.render import render_rays
    from photon_tpu.models.scenes import bos_source
    from photon_tpu.ops.march import make_march_fn
    from photon_tpu.pipeline import _lens_sample_pair
    from photon_tpu.volume import load_density_volume

    t0 = time.perf_counter()
    tcfg, _, _, _, _ = chip_smoke.bench_scene()
    tcfg.camera_design.y_camera_angle = 5.0 * math.pi / 6.0
    tcfg.lens_design.lens_model = "thin-lens"
    tcfg.density_gradients.ray_tracing_algorithm = args.algorithm
    with tempfile.TemporaryDirectory() as tmp:
        from photon_tpu_torch.models.optics import camera_setup as t_setup
        rho, sp, origin = chip_smoke.volume_across_rays(
            t_setup(tcfg), float(tcfg.bos_pattern.X_Max), n=64)
        _, nrrd = chip_smoke.write_bench_case(tmp, tcfg, rho, sp, origin)
        path = os.path.join(tmp, "case.json")
        tcfg.to_json(path)
        cfg = SimulationConfig.from_json(path)
        vol = load_density_volume(nrrd,
                                  gladstone_dale=cfg.density_gradients
                                  .gladstone_dale)
    setup = camera_setup(cfg)
    src, dot_x, _ = bos_source(cfg, setup, np.random.default_rng(cfg.seed))
    n_dots = len(dot_x)
    per_dot = src.num_particles // n_dots
    keep = np.arange(src.num_particles).reshape(n_dots, per_dot)[
        :, ::args.every].ravel()
    sub = chip_smoke.subset(src, keep)
    R = int(src.lightray_number_per_particle)
    r1, r2 = _lens_sample_pair(cfg, R)
    march_fn = make_march_fn(vol, algorithm=args.algorithm)
    rays1 = render_rays(cfg, setup, sub, r1, r2)
    rays2 = render_rays(cfg, setup, sub, r1, r2, march_fn=march_fn)
    rays_per_dot = sub.num_particles // n_dots * R
    cd = cfg.camera_design
    disp = process_lightray_data(
        np.asarray(rays1.pos), np.asarray(rays2.pos), rays_per_dot,
        cd.pixel_pitch, cd.x_pixel_number, cd.y_pixel_number)["displacement"]
    pred, hit = paraxial_displacement_oracle(cfg, setup, vol, sub)
    pred = pred.reshape(n_dots, -1, 2).mean(1)
    hit = hit.reshape(n_dots, -1).all(1)
    ok = hit & np.isfinite(disp).all(1)
    print(f"the JAX package's flow, algorithm {args.algorithm}: "
          f"{sub.num_particles} particles ({sub.num_particles // n_dots} of "
          f"{per_dot} a dot, every {args.every}th) x {R} rays, {ok.sum()} of "
          f"{n_dots} dots finite and hit; CPU, "
          f"{time.perf_counter() - t0:.1f} s")
    for axis, (slope, corr, rms, rms_lim) in enumerate(
            chip_smoke.flow_readings(disp, pred, ok)):
        print(f"    axis {'xy'[axis]}: slope {slope:.5f} (|1 - slope| "
              f"{abs(1 - slope):.5f}, sample-scene limit 0.03), correlation "
              f"{corr:.6f} (limit 0.995), RMS {rms:.5f} px (limit "
              f"{rms_lim:.5f} px); largest oracle displacement "
              f"{float(np.abs(pred[ok, axis]).max()):.4f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
