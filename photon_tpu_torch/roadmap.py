"""What this slice of the port leaves to later ones.

An option outside the slice raises ``NotImplementedError`` naming the
ROADMAP.md item ("Modules still to port") that brings it; nothing falls
through to a different path.
"""
from __future__ import annotations

CONFIGS = "PIV, Mie, calibration, rotation, noise, bilinear sensor"
EXACT_PATH = "The exact-semantics path"
MULTI_DEVICE = "Multi-device"


def later(what: str, item: str) -> NotImplementedError:
    """The error for an option that a later slice ports."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, modules still to port, "
        f"'{item}'")
