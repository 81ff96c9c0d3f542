"""Closed-loop cases of ``photon_tpu_torch.pipeline.run_piv``.

A request is one case: ``run_piv`` on the configuration with a seed of its
own (drawn from the run's seed and the case's index), its numpy generator
seeded alike: the Mie table, then each frame's particles, its render in the
pipeline's chunks and its post-processing.  No file is written.  A case
counts its frames as images.

The comparison: the raw frames of ``check_cases`` cases (the first, and
others drawn from the run's seed among those finished) against the
reference's Mie table, particles, render and post-processing of the same
case seed, as the relative L1 distance of the frames.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import common

SPANS = ("case",)


class Driver:
    def __init__(self, doc, traffic, seed, dev, fault=None):
        from photon_tpu_torch.pipeline import run_piv
        self.run_piv = run_piv if fault is None else fault(run_piv)
        self.doc, self.traffic, self.seed, self.dev = doc, traffic, seed, dev
        self.case = 0
        self.frames = {}           # case seed -> raw frames, for the check
        self.mie_s = 0.0
        self.keep = None
        for k in range(int(traffic["warm_cases"])):
            self._case(common.sub_seed(seed, 99, k))
        self.mie_s = 0.0
        # the cases to check: the first, and others among the first
        # ``check_among`` drawn from the seed
        rng = np.random.default_rng(common.sub_seed(seed, 3))
        among = int(traffic["check_among"])
        self.keep = {0} | set(rng.choice(np.arange(1, among),
                                         int(traffic["check_cases"]) - 1,
                                         replace=False).tolist())

    def case_seed(self, k: int) -> int:
        return common.sub_seed(self.seed, 4, k)

    def _case(self, case_seed):
        cfg = common.program_config(self.doc, case_seed)
        res = self.run_piv(cfg, rng=np.random.default_rng(case_seed),
                           device=self.dev)
        self.mie_s += res.timer.phases.get("mie", 0.0)
        return res

    def request(self, deadline):
        k = self.case
        self.case += 1
        with torch.profiler.record_function("case"):
            res = self._case(self.case_seed(k))
        if self.keep is not None and k in self.keep:
            self.frames[self.case_seed(k)] = [
                res.raw_images[n] for n in sorted(res.raw_images)]
        return len(res.raw_images), None

    # -- the traced window ------------------------------------------------
    def shapes(self):
        pf = self.doc["simulation"]["particle_field"]
        R = int(pf["lightray_number_per_particle"])
        budget = int(pf["lightray_process_number"])
        return {"fan_fwd": dict(particles=max(1, budget // R), rays=R,
                                march=False,
                                lens=self.doc["simulation"]["lens_design"]
                                ["lens_model"])}

    def phases(self):
        return {"mie": self.mie_s}

    def reset_phases(self):
        self.mie_s = 0.0

    # -- the comparison ---------------------------------------------------
    def outputs(self):
        return dict(frames=self.frames)

    def reference(self, out, lowp=None):
        from benchmark.reference import render as R
        from benchmark.reference.mie import create_mie_scattering_data
        from benchmark.reference.optics import camera_setup
        from benchmark.reference.postprocess import postprocess
        from benchmark.reference.scenes import piv_source
        frames = {}
        for case_seed in out["frames"]:
            cfg = common.reference_config(self.doc, case_seed)
            rng = np.random.default_rng(case_seed)
            pf = cfg.particle_field
            setup = camera_setup(cfg)
            scattering = create_mie_scattering_data(cfg, rng)
            idx = scattering["particle_diameter_index_distribution"]
            r1, r2 = common.lens_samples(case_seed,
                                         int(pf.lightray_number_per_particle))
            noise = torch.Generator(device=self.dev)
            noise.manual_seed(int(cfg.seed) + 7)
            raws = []
            for frame in pf.frame_vector:
                src = piv_source(cfg, setup, int(frame),
                                 diameter_index_distribution=idx, rng=rng)
                sc = R.scene(cfg, setup, src, r1, r2, self.dev,
                             scattering=scattering)
                img = R.image_of(sc, None, chunk=2000, lowp=lowp)
                raws.append(postprocess(cfg, img, generator=noise)[1])
            frames[case_seed] = raws
        return dict(frames=frames)

    @staticmethod
    def compare(prog, ref):
        gaps = []
        for case_seed, raws in ref["frames"].items():
            got = prog["frames"].get(case_seed)
            if got is None or len(got) != len(raws):
                return {"frame_gap": float("inf")}
            for a, b in zip(got, raws):
                gaps.append(float(np.abs(a.astype(np.float64) - b).sum()
                                  / max(np.abs(b.astype(np.float64)).sum(),
                                        1e-30)))
        if not gaps:
            return {"frame_gap": float("inf")}
        return {"frame_gap": max(gaps)}
