"""What the port has not reached yet, and where ROADMAP.md lists it.

Every option the reference offers but this package does not yet run
raises :func:`not_ported` -- never a quiet fallback -- naming the item of
ROADMAP.md's queue 1 that will bring it.
"""
from __future__ import annotations

__all__ = ["ROADMAP_ITEMS", "not_ported"]

ROADMAP_ITEMS = {
    "block_cg": "1.7 (Lanczos, block Lanczos, power iteration)",
    "transpose": "1.8 (rmatvec, .T and transpose='device')",
    "autograd": "1.9 (the autograd Function)",
    "reorder": "1.10 (RCM preprocessing and Matrix-Market I/O)",
    "dist_tune": "1.20 (the distributed tuner and link calibration)",
}


def not_ported(what: str, key: str) -> NotImplementedError:
    """The error an unported option raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md, open item "
        f"{ROADMAP_ITEMS[key]}")
