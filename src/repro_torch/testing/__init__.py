"""Test-support utilities: the fault-injection harness.

``repro_torch.testing.faults`` holds the context managers that inject
the failure modes the solve pipeline and the serving scheduler must
turn into a typed status, a propagated error, or a mismatch detectable
out of band.
"""
from repro_torch.testing import faults

__all__ = ["faults"]
