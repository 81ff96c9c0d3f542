"""The plain reference of ``invert_bos``'s first steps: the loss of each step
and rho after it, from the same inputs, in PyTorch alone.

The step is the port's (``photon_tpu_torch/inverse.py``): rho -> the packed
field (:func:`render.volume_from_rho`), the render, ``mean((img -
target)^2)``, its gradient with respect to rho, and Adam (0.9, 0.999,
1e-12).  The gradient runs backward by hand through the stages of
:mod:`render`: the splat and the fan by autograd a chunk of particles at a
time, the march slab by slab, the field's stencil by autograd.
"""
from __future__ import annotations

import torch

from benchmark.reference import render as R


def invert_steps(sc: R.Scene, g: R.Geometry, spacing, gladstone_dale: float,
                 rho0: torch.Tensor, target: torch.Tensor,
                 learning_rate: float, steps: int, lowp: R.Lowp = None):
    """Losses of the first ``steps`` steps, and rho after each."""
    rho = rho0.detach().clone()
    m = torch.zeros_like(rho)
    v = torch.zeros_like(rho)
    b1, b2, eps = 0.9, 0.999, 1e-12
    losses, rhos = [], []
    for t in range(1, steps + 1):
        with torch.enable_grad():
            rho_l = rho.detach().requires_grad_(True)
            field = R.volume_from_rho(rho_l, spacing, gladstone_dale)
        fr = R._round(field.detach(), lowp)
        deltas, tape = R.march_deltas(fr, g, sc.chief, keep=True)
        img = R.image_of(sc, deltas, lowp=lowp)
        diff = img - target
        loss = torch.mean(diff ** 2)
        d_img = (2.0 / diff.numel()) * diff
        d_deltas = R.deltas_backward(sc, deltas, d_img)
        del img, diff
        d_field = R.march_backward(fr, g, sc.chief, tape, d_deltas)
        del tape, fr
        (grad,) = torch.autograd.grad(field, rho_l, grad_outputs=d_field)
        del field, d_field
        with torch.no_grad():
            m = b1 * m + (1 - b1) * grad
            v = b2 * v + (1 - b2) * grad * grad
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            rho = rho - learning_rate * mhat / (torch.sqrt(vhat) + eps)
        losses.append(float(loss))
        rhos.append(rho)
    return losses, rhos
