"""Random-number utilities.

Two generators live here:

* :class:`GlibcRand` — a bit-exact emulation of glibc's ``rand()`` (TYPE_3
  additive-feedback generator).  The reference's CUDA host runtime draws its
  per-ray lens-aperture samples with ``srand(10); rand()/RAND_MAX``
  (ref: parallel_ray_tracing.cu:3228-3238) and shares that one vector across
  every source point.  Emulating it exactly lets golden tests reproduce the
  reference's lens-sample sequence without any C code.

* :func:`lens_samples` — the native path: draws from an explicit
  ``torch.Generator``.  The numbers differ from the JAX package's
  ``jax.random`` draws by design; parity tests inject the samples as numpy
  arrays or use ``reference_lens_samples``.
"""
from __future__ import annotations

import numpy as np
import torch

_RAND_MAX = 2147483647


class GlibcRand:
    """Bit-exact glibc ``rand()`` (TYPE_3: degree 31, separation 3)."""

    def __init__(self, seed: int = 1):
        seed = int(seed) or 1
        r = np.zeros(344, dtype=np.int64)
        r[0] = seed
        # 31 seeds from a Park-Miller LCG (computed in signed 64-bit, then
        # normalized into [0, 2^31-1))
        for i in range(1, 31):
            r[i] = (16807 * r[i - 1]) % _RAND_MAX
            if r[i] < 0:
                r[i] += _RAND_MAX
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) % (1 << 32)
        self._r = list(r[-31:].astype(np.uint64))  # rolling window, newest last
        # window order: self._r[-31] is r[i-31], self._r[-3] is r[i-3]

    def next_int(self) -> int:
        new = (int(self._r[-31]) + int(self._r[-3])) % (1 << 32)
        self._r.append(np.uint64(new))
        self._r.pop(0)
        return new >> 1

    def uniform(self, n: int) -> np.ndarray:
        """n draws of ``rand()/RAND_MAX`` as float64 in [0, 1]."""
        return np.array([self.next_int() for _ in range(n)],
                        dtype=np.float64) / _RAND_MAX

    def uniform_pairs(self, n: int):
        """Interleaved draws: (rand(), rand()) per iteration.

        Matches the reference's loop filling ``h_rand1``/``h_rand2``
        (ref: parallel_ray_tracing.cu:3233-3238).
        """
        flat = self.uniform(2 * n)
        return flat[0::2], flat[1::2]


def lens_samples(generator: torch.Generator, n: int, device=None):
    """Draw the (r, psi) uniform pairs for lens-aperture intersection points.

    One vector of ``n`` pairs is drawn and shared by every source point —
    the same semantics as the reference, where a single host-generated
    random vector indexed by ``local_ray_id`` serves all particles
    (ref: parallel_ray_tracing.cu:2004-2006, 3228-3243).  Drawn on the
    generator's device, returned as float32 on ``device``.
    """
    r1 = torch.rand(n, generator=generator, dtype=torch.float32,
                    device=generator.device)
    r2 = torch.rand(n, generator=generator, dtype=torch.float32,
                    device=generator.device)
    if device is not None:
        r1, r2 = r1.to(device), r2.to(device)
    return r1, r2


def reference_lens_samples(n: int, seed: int = 10):
    """The exact lens-sample vectors the reference CUDA host generates."""
    g = GlibcRand(seed)
    r1, r2 = g.uniform_pairs(n)
    return np.asarray(r1, dtype=np.float32), np.asarray(r2, dtype=np.float32)
