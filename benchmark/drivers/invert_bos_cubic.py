"""Closed-loop solves of ``photon_tpu_torch.inverse.invert_bos`` under the
configuration's cubic B-spline scheme (``interpolation_scheme`` 2).

The driver of ``drivers/invert_bos.py``, extended:

* set-up renders the observation through the program under the
  configuration's scheme (after the base's set-up, which renders one under
  ``render_image_fast``'s default scheme and warms the solve on it), and
  checks that the solve marches under that scheme: on a field rough at the
  voxel scale, where the two schemes' images differ, the solve's first
  loss has to be the loss of the program's own render under the scheme.
  A program whose solve marches trilinear whatever the configuration says
  cannot run this configuration: set-up raises before the window, and the
  run ends with an error;
* the comparison runs the reference's first steps through the cubic march
  (:func:`reference.cubic.invert_steps_cubic`) and adds the gradient of
  the first step's loss with respect to rho (``grad_gap``, the relative
  norm of the difference): the program's through its differentiable
  ``volume_from_rho`` and ``render_image_fast``, taken after the window.
  Adam (eps 1e-12) follows only the gradient's signs and the ratios
  between its steps, so the losses and the change cannot see its scale.
  The result volume is still held to the reference's stencil, exactly.

Requests and the window are the base driver's.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.drivers import invert_bos as base

SPANS = base.SPANS

# the rough field of set-up's check: rho times 1 + ROUGH (u - 1/2), u
# uniform on [0, 1) a voxel; SCHEME_GAP: the largest relative gap between
# the solve's first loss and the render's under the configuration's scheme
ROUGH = 0.1
SCHEME_GAP = 1e-3


class Driver(base.Driver):
    def __init__(self, doc, traffic, seed, dev, fault=None):
        super().__init__(doc, traffic, seed, dev, fault)
        # the base's set-up renders the observation under
        # render_image_fast's default scheme (and warms the solve on it:
        # the same kernels and shapes); the solves invert the one of the
        # configuration's scheme
        self.scheme = int(self.cfg.density_gradients.interpolation_scheme)
        self.target = self._render(self.template)
        gap = self.scheme_gap()
        print(f"invert_bos_cubic: set-up's scheme gap {gap!r}",
              file=sys.stderr)
        if not gap <= SCHEME_GAP:
            raise RuntimeError(
                f"invert_bos's first loss is {gap:.3g} from the render's "
                f"under interpolation_scheme {self.scheme}: the solve does "
                "not march under the configuration's scheme")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _render(self, vol):
        from photon_tpu_torch.models.render_fast import render_image_fast
        return render_image_fast(
            self.cfg, self.setup, self.source, self.inp.r1, self.inp.r2,
            vol=vol, interpolation_scheme=self.scheme, device=self.dev)

    def scheme_gap(self) -> float:
        """The relative gap between the solve's first loss and the loss of
        the program's render under the configuration's scheme, both at a
        field rough at the voxel scale drawn from the seed."""
        from photon_tpu_torch.inverse import invert_bos, volume_from_rho
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(common.sub_seed(self.seed, 8))
        u = torch.rand(self.rho_true.shape, generator=gen, device=self.dev)
        rough = self.rho_true * (1.0 + ROUGH * (u - 0.5))
        del u
        with torch.no_grad():
            img = self._render(volume_from_rho(rough, self.template,
                                               self.gd))
            want = float(torch.mean((img - self.target) ** 2))
        del img
        got = invert_bos(
            self.cfg, self.setup, self.source, self.inp.r1, self.inp.r2,
            self.target, self.template, rho0=rough, steps=1,
            learning_rate=0.0, device=self.dev).losses[0]
        return abs(got - want) / want

    # -- the traced window ------------------------------------------------
    def shapes(self):
        from benchmark.counts.march_bwd_cubic import touched_coefficients
        out = super().shapes()
        w, h, d = self.grid.sizes
        field = dict(voxels=w * h * d, channels=4)
        out["prefilter"] = dict(field)
        out["prefilter_bwd"] = dict(field)
        out["march_bwd_cubic"] = dict(
            out["march_bwd"], touched=touched_coefficients(
                self.reference_geometry(), self.reference_scene().chief))
        return out

    # -- the comparison ---------------------------------------------------
    def first_gradient(self) -> torch.Tensor:
        """The gradient of the solve's loss (the mean square of the image
        against the observation) at rho0 with respect to rho: the program's
        ``volume_from_rho`` and its render under the configuration's
        scheme, differentiated as a solve's first step does."""
        from photon_tpu_torch.inverse import volume_from_rho
        rho = self.rho0.detach().clone().requires_grad_(True)
        img = self._render(volume_from_rho(rho, self.template, self.gd))
        loss = torch.mean((img - self.target) ** 2)
        (g,) = torch.autograd.grad(loss, rho)
        return g

    def outputs(self):
        grad = self.first_gradient()
        out = super().outputs()
        out["grad"] = grad
        return out

    def reference(self, out, lowp=None):
        """The reference's outputs for the same inputs under the cubic
        scheme (``lowp``: the control's rounding); reads the program's
        result rho to judge its result volume."""
        from benchmark.reference import cubic as C
        from benchmark.reference import render as R
        sc = self.reference_scene()
        g = self.reference_geometry()
        field = R.gradient_field(self.gd * self.rho_true, self.grid.spacings)
        # the solve and its result volume take the grid's spacings as the
        # volume holds them, in float32
        sp = [float(np.float32(s)) for s in self.grid.spacings]
        target = C.render(sc, field, g, lowp)
        del field
        losses, rhos, grad = C.invert_steps_cubic(
            sc, g, sp, self.gd, self.rho0, target, self.lr,
            self.check_steps, lowp)
        change = torch.linalg.vector_norm((rhos[-1] - self.rho0).double())
        del rhos, target
        volume = None
        if out["result"] is not None:
            rho_np = out["result"][0]
            rho = torch.from_numpy(np.ascontiguousarray(rho_np)).to(self.dev)
            volume = R._round(R.gradient_field(self.gd * rho, sp), lowp)
        return dict(first=(losses, change), result=(None, volume),
                    grad=grad)

    @staticmethod
    def compare(prog, ref):
        out = base.Driver.compare(prog, ref)
        a, b = prog["grad"], ref["grad"]
        b = b.double()
        out["grad_gap"] = float(
            torch.linalg.vector_norm(a.to(b.device).double() - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300))
        return out
