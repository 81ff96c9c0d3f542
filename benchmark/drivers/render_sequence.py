"""Closed-loop renders of a sequence of density snapshots: a synthetic BOS
time series.

Set-up makes ``snapshots`` rho grids of the bench's Gaussian on the device,
each with its centre moved by up to ``centre_of_extent`` of the grid's
extent and its amplitude drawn from ``amplitude``, all from the seed, and
renders im1 (no volume) once.  A request takes the next snapshot, builds
its volume (``volume.build_density_volume``) and renders im2 in one chunk
(``models/render_fast.render_image_fast``), synchronised at its end.

The comparison: ``check_requests`` requests (the first, and others drawn
from the seed among the first ``check_among``): the volume's packed field
against the reference's stencil (an exact comparison) and the image
against the reference's render, as the relative L1 distance.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import common

SPANS = ("volume", "render")


class Driver:
    def __init__(self, doc, traffic, seed, dev, fault=None):
        from photon_tpu_torch.models.optics import camera_setup
        from photon_tpu_torch.models.render_fast import render_image_fast
        from photon_tpu_torch.volume import build_density_volume
        self.render = (render_image_fast if fault is None
                       else fault(render_image_fast))
        self.build = build_density_volume
        self.doc, self.traffic, self.seed, self.dev = doc, traffic, seed, dev
        self.inp = common.bos_inputs(doc, seed)
        self.cfg = common.program_config(doc, seed)
        self.setup = camera_setup(self.cfg)
        self.source = common.program_source(self.inp.ref_source)
        self.grid = common.bench_grid(doc, self.inp.ref_setup)
        self.gd = float(self.cfg.density_gradients.gladstone_dale)
        rng = np.random.default_rng(common.sub_seed(seed, 5))
        n = int(traffic["snapshots"])
        ext = np.array([np.ptp(self.grid.x), np.ptp(self.grid.y),
                        np.ptp(self.grid.z)])
        frac = np.asarray(traffic["centre_of_extent"], np.float64)
        self.centres = rng.uniform(-1.0, 1.0, (n, 3)) * frac * ext
        self.amps = rng.uniform(*traffic["amplitude"], n)
        self.snaps = [common.gaussian_rho(self.grid, doc, dev, tuple(c), a)
                      for c, a in zip(self.centres, self.amps)]
        self.im1 = self.render(self.cfg, self.setup, self.source,
                               self.inp.r1, self.inp.r2, vol=None,
                               device=dev)
        self.k = 0
        self.keep = {}
        self.wanted = set()
        for _ in range(int(traffic["warm_requests"])):
            self.request(None)
        self.k = 0
        among = int(traffic["check_among"])
        pick = np.random.default_rng(common.sub_seed(seed, 6)).choice(
            np.arange(1, among), int(traffic["check_requests"]) - 1,
            replace=False)
        self.wanted = {0} | set(pick.tolist())

    def request(self, deadline):
        k = self.k
        self.k += 1
        rho = self.snaps[k % len(self.snaps)]
        with torch.profiler.record_function("volume"):
            vol = self.build(rho, self.grid.spacings, self.grid.origin,
                             gladstone_dale=self.gd, device=self.dev)
        with torch.profiler.record_function("render"):
            img = self.render(self.cfg, self.setup, self.source,
                              self.inp.r1, self.inp.r2, vol=vol,
                              device=self.dev)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        if k in self.wanted:
            # the field once, the images of every request checked
            field = vol.field.clone() if not self.keep else None
            self.keep[k] = (k % len(self.snaps), field, img)
        return 1, None

    # -- the traced window ------------------------------------------------
    def shapes(self):
        from benchmark.counts import march_common as mc
        sc = self.reference_scene()
        g = self.reference_geometry(self.snaps[0])
        w, h, d = self.grid.sizes
        P = int(self.source.x.shape[0])
        return {"march_fwd": dict(rays=P, steps=mc.in_band_steps(g, sc.chief),
                                  touched=mc.touched_voxels(g, sc.chief),
                                  residual=False),
                "fan_fwd": dict(particles=P, rays=int(self.inp.r1.shape[0]),
                                march=True, lens=str(self.setup.lens_model)),
                "gradient": dict(voxels=w * h * d)}

    def phases(self):
        return {}

    # -- the comparison ---------------------------------------------------
    def outputs(self):
        return dict(keep=self.keep)

    def reference_scene(self):
        from benchmark.reference import render as R
        i = self.inp
        return R.scene(i.ref_cfg, i.ref_setup, i.ref_source, i.r1, i.r2,
                       self.dev)

    def reference_geometry(self, rho):
        from benchmark.reference import render as R
        return R.geometry(self.grid.sizes, self.grid.spacings,
                          self.grid.origin, float((self.gd * rho).min()))

    def reference(self, out, lowp=None):
        from benchmark.reference import render as R
        sc = self.reference_scene()
        keep = {}
        for k, (snap, field, _) in out["keep"].items():
            rho = self.snaps[snap]
            ref_field = R._round(R.gradient_field(self.gd * rho,
                                                  self.grid.spacings), lowp)
            img = R.render(sc, ref_field, self.reference_geometry(rho), lowp)
            keep[k] = (snap, ref_field if field is not None else None, img)
        return dict(keep=keep)

    @staticmethod
    def compare(prog, ref):
        image_gap, field_gap = 0.0, None
        for k, (_, rf, ri) in ref["keep"].items():
            got = prog["keep"].get(k)
            if got is None:
                return {"image_gap": float("inf"),
                        "volume_gap": float("inf")}
            _, pf, pi = got
            image_gap = max(image_gap, float(
                (pi.double() - ri.double()).abs().sum()
                / ri.double().abs().sum().clamp_min(1e-30)))
            if rf is not None and pf is not None:
                field_gap = float((pf - rf).abs().max()
                                  / rf.abs().max().clamp_min(1e-30))
        return {"image_gap": image_gap,
                "volume_gap": float("inf") if field_gap is None
                else field_gap}
