"""What the port has not reached yet, and where ROADMAP.md lists it.

Every option the reference offers but this package does not yet run
raises :func:`not_ported` -- never a quiet fallback -- naming the item of
ROADMAP.md's queue 1 that will bring it.  Every module of the reference
is ported now, so the table is empty.
"""
from __future__ import annotations

__all__ = ["ROADMAP_ITEMS", "not_ported"]

ROADMAP_ITEMS: dict = {}


def not_ported(what: str, key: str) -> NotImplementedError:
    """The error an unported option raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md, open item "
        f"{ROADMAP_ITEMS[key]}")
