"""What the drivers share: the card's clocks and memory, the kernels'
build, the sample of calls kept for the check."""
from __future__ import annotations

import time

__all__ = ["start", "sync", "allocated", "peak", "device_kind",
           "build_kernels", "Reservoir", "ring"]


def start(device) -> None:
    """Create the card's context now (set-up), so its cost shows apart."""
    if device.type == "cuda":
        import torch
        torch.zeros(1, device=device)
        sync(device)


def sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def allocated(device):
    """Bytes of live tensors on the card (None off the card)."""
    if device.type != "cuda":
        return None
    import torch
    sync(device)
    return int(torch.cuda.memory_allocated(device))


def peak(device):
    if device.type != "cuda":
        return None
    import torch
    return int(torch.cuda.max_memory_allocated(device))


def device_kind(device):
    if device.type != "cuda":
        return None
    import torch
    return torch.cuda.get_device_name(device)


def build_kernels(device) -> dict:
    """Build the port's kernels now (set-up), or find them in the
    checkout's build directory: ``{"compiled": {source: seconds}}``,
    empty when every library came from the cache."""
    if device.type != "cuda":
        return {"compiled": "none: the plain versions on the CPU"}
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    compiled = _build.build_all()
    return {"compiled": compiled, "dir": str(_build.build_dir()),
            "seconds": time.perf_counter() - t0}


class Reservoir:
    """A uniform sample of ``k`` of a stream's calls, drawn from the seed
    (reservoir sampling), so it spreads over the whole window whatever
    its length; ``items()`` adds the stream's last call."""

    def __init__(self, k: int, seed: int):
        import random
        self.k, self.rng = k, random.Random(seed)
        self.kept, self.last = [], None

    def offer(self, i: int, item) -> None:
        self.last = (i, item)
        if len(self.kept) < self.k:
            self.kept.append((i, item))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.kept[j] = (i, item)

    def items(self) -> list:
        out = sorted(self.kept, key=lambda t: t[0])
        if self.last is not None and (not out or out[-1][0] != self.last[0]):
            out.append(self.last)
        return out


def ring(n: int, count: int, seed: int, device):
    """``count`` float32 vectors of length n, normal, from the seed,
    made on ``device``."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return [torch.randn(n, generator=g, device=device, dtype=torch.float32)
            for _ in range(count)]
