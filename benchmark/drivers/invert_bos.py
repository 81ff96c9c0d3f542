"""Closed-loop solves of ``photon_tpu_torch.inverse.invert_bos``.

Set-up renders the observation (im2 of the true field) through the
program, then warms one short solve.  A request is one solve of
``steps`` steps from ``start_fraction`` of the true rho, with Adam's rate
``learning_rate_of_range`` of rho's range, its result volume included.
Steps are counted through the solve's callback; the window closes at the
first step that ends after the deadline (the rest of that solve is
abandoned, unless no solve has finished yet: then it runs on, untimed, so
that its result volume can be checked).

The comparison: the first solve's first ``check_steps`` losses and the
norm of rho's change after them, against :func:`reference.inverse.
invert_steps` on the same inputs; and the first finished solve's result
volume against the reference's stencil on that solve's rho.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import common

SPANS = ("solve",)


class _Closed(Exception):
    pass


class Driver:
    def __init__(self, doc, traffic, seed, dev, fault=None):
        from photon_tpu_torch.inverse import invert_bos
        from photon_tpu_torch.models.optics import camera_setup
        from photon_tpu_torch.models.render_fast import render_image_fast
        from photon_tpu_torch.volume import build_density_volume

        self.doc, self.traffic, self.seed, self.dev = doc, traffic, seed, dev
        self.invert_bos = invert_bos if fault is None else fault(invert_bos)
        self.inp = common.bos_inputs(doc, seed)
        self.cfg = common.program_config(doc, seed)
        self.setup = camera_setup(self.cfg)
        self.source = common.program_source(self.inp.ref_source)
        self.grid = common.bench_grid(doc, self.inp.ref_setup)
        self.rho_true = common.gaussian_rho(self.grid, doc, dev)
        self.gd = float(self.cfg.density_gradients.gladstone_dale)
        self.template = build_density_volume(
            self.rho_true, self.grid.spacings, self.grid.origin,
            gladstone_dale=self.gd, device=dev)
        self.target = render_image_fast(
            self.cfg, self.setup, self.source, self.inp.r1, self.inp.r2,
            vol=self.template, device=dev)
        self.rho0 = (float(traffic["start_fraction"]) * self.rho_true)
        span = float(self.rho_true.max() - self.rho_true.min())
        self.lr = float(traffic["learning_rate_of_range"]) * span
        self.steps = int(traffic["steps"])
        self.check_steps = int(traffic["check_steps"])
        self.first = None          # the first solve's losses and change
        self.result = None         # the first finished solve's result
        self._solve(int(traffic["warm_steps"]), None)
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        self.first = None
        self.result = None

    def _solve(self, steps, deadline):
        losses, change = [], []
        state = {"units": 0, "closed_at": None}
        rho0 = self.rho0.clone()

        def callback(t, loss, rho):
            if t <= self.check_steps and self.first is None:
                losses.append(loss)
                if t == self.check_steps:
                    change.append(torch.linalg.vector_norm(
                        (rho.detach() - rho0.detach()).double()))
            if state["closed_at"] is not None:
                return
            state["units"] += 1
            if deadline is not None and time.perf_counter() >= deadline:
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
                state["closed_at"] = time.perf_counter()
                if self.result is not None:
                    raise _Closed()

        try:
            res = self.invert_bos(
                self.cfg, self.setup, self.source, self.inp.r1, self.inp.r2,
                self.target, self.template, rho0=rho0, steps=steps,
                learning_rate=self.lr, callback=callback, device=self.dev)
            if self.result is None:
                self.result = (res.rho, res.volume.field)
        except _Closed:
            pass
        if self.first is None and change:
            self.first = (list(losses), change[0])
        return state["units"], state["closed_at"]

    def request(self, deadline):
        with torch.profiler.record_function("solve"):
            return self._solve(self.steps, deadline)

    # -- the traced window ------------------------------------------------
    def shapes(self):
        from benchmark.counts import march_common as mc
        g = self.reference_geometry()
        chief = self.reference_scene().chief
        steps = mc.in_band_steps(g, chief)
        touched = mc.touched_voxels(g, chief)
        P = int(self.source.x.shape[0])
        R = int(self.inp.r1.shape[0])
        w, h, d = self.grid.sizes
        return {"march_fwd": dict(rays=P, steps=steps, touched=touched,
                                  residual=True),
                "march_bwd": dict(rays=P, steps=steps, touched=touched,
                                  field_voxels=w * h * d),
                "fan_fwd": dict(particles=P, rays=R, march=True,
                                lens=str(self.setup.lens_model)),
                "fan_bwd": dict(particles=P, rays=R, march=True,
                                lens=str(self.setup.lens_model))}

    def phases(self):
        return {}

    # -- the comparison ---------------------------------------------------
    def outputs(self):
        """The program's outputs; frees the rest of its state."""
        out = dict(first=self.first, result=self.result)
        self.template = self.target = None
        self.first = self.result = None
        return out

    def reference_scene(self):
        from benchmark.reference import render as R
        i = self.inp
        return R.scene(i.ref_cfg, i.ref_setup, i.ref_source, i.r1, i.r2,
                       self.dev)

    def reference_geometry(self):
        from benchmark.reference import render as R
        data_min = float((self.gd * self.rho_true).min())
        return R.geometry(self.grid.sizes, self.grid.spacings,
                          self.grid.origin, data_min)

    def reference(self, out, lowp=None):
        """The reference's outputs for the same inputs (``lowp``: the
        control's rounding); reads the program's result rho to judge its
        result volume."""
        from benchmark.reference import render as R
        from benchmark.reference.inverse import invert_steps
        sc = self.reference_scene()
        g = self.reference_geometry()
        field = R.gradient_field(self.gd * self.rho_true, self.grid.spacings)
        # the solve and its result volume take the grid's spacings as the
        # volume holds them, in float32
        sp = [float(np.float32(s)) for s in self.grid.spacings]
        target = R.render(sc, field, g, lowp)
        del field
        losses, rhos = invert_steps(sc, g, sp, self.gd, self.rho0, target,
                                    self.lr, self.check_steps, lowp)
        change = torch.linalg.vector_norm((rhos[-1] - self.rho0).double())
        del rhos, target
        volume = None
        if out["result"] is not None:
            rho_np = out["result"][0]
            rho = torch.from_numpy(np.ascontiguousarray(rho_np)).to(self.dev)
            volume = R._round(R.gradient_field(self.gd * rho, sp), lowp)
        return dict(first=(losses, change), result=(None, volume))

    @staticmethod
    def compare(prog, ref):
        """The numbers compared, by name."""
        out = {}
        if prog["first"] is None:
            out["loss_gap"] = float("inf")
            out["change_gap"] = float("inf")
        else:
            pl, pc = prog["first"]
            rl, rc = ref["first"]
            out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
            out["change_gap"] = abs(float(pc) - float(rc)) / float(rc)
        pv, rv = prog["result"], ref["result"]
        if pv is None or rv[1] is None:
            out["volume_gap"] = float("inf")
        else:
            a, b = pv[1], rv[1]
            out["volume_gap"] = float((a - b).abs().max()
                                      / b.abs().max().clamp_min(1e-30))
        return out
