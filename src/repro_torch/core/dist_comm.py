"""Point-to-point messages and sums across ranks: the port's counterpart
of the reference's ``jax.lax.ppermute`` inside ``shard_map`` and of the
all-reduce XLA inserts for a ``jnp.vdot`` of sharded vectors.

Each rank is one process (or thread) with one device, the paper's MPI
model.  The distributed layer (``core.dist_spmv``) and the solvers speak
one small protocol:

* ``rank`` and ``size``;
* ``exchange(sends, recvs)`` posts the messages of one step -- ``sends``
  and ``recvs`` are lists of ``(tensor, peer, tag)`` -- and returns a
  handle whose ``wait()`` returns once every receive buffer holds its
  message and every send buffer may be reused;
* ``all_reduce_sum(t)`` returns the sum of a small tensor over all
  ranks, the same bits on every rank.

Two implementations:

* :class:`GroupComm` runs on a ``torch.distributed`` process group:
  ``batch_isend_irecv`` for the messages, ``all_reduce`` for the sums.
  Gloo carries CPU tensors and NCCL CUDA tensors; any other pairing
  raises rather than staging tensors elsewhere.  NCCL matches messages
  between two ranks by order, not by tag, so every caller posts its
  messages in one fixed order on all ranks.
* :class:`ThreadComm` runs ``size`` ranks as threads of one process,
  each on its own CUDA stream when the tensors are on a card.  A message
  is handed across through a shared table (one FIFO per sender,
  receiver and tag), a sum through one slot per rank between two
  barriers, added in rank order.  It exists so that a P-rank partition
  runs on a machine with one card, where NCCL refuses two ranks on one
  device, and in the CPU tests.  All ranks share one card, so no
  multi-card speed is ever read from it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Sequence

import torch

from repro_torch.kernels._backend import resolve_device

__all__ = ["GroupComm", "ThreadComm", "run_ranks"]


# --------------------------------------------------------------------------
# torch.distributed process groups
# --------------------------------------------------------------------------
class _Works:
    """The handle of one :meth:`GroupComm.exchange`."""

    def __init__(self, works, keep):
        self.works = works
        self.keep = keep          # the buffers, alive until wait()

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        self.works, self.keep = [], []


class GroupComm:
    """The protocol on a ``torch.distributed`` process group (``None``:
    the default group), which the caller has initialised; every rank of
    the group constructs it.  Peers are ranks of that group.  On NCCL
    (after ``torch.cuda.set_device``) the constructor runs one
    ``all_reduce``: NCCL requires a group's first collective to include
    every rank, and a rank of an exchange may have no message to post."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("GroupComm needs an initialised process "
                               "group (torch.distributed.init_process_group)")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl":
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)

    def check(self, t: torch.Tensor) -> None:
        """Raise unless this group's backend carries ``t`` where it is."""
        want = {"gloo": "cpu", "nccl": "cuda"}.get(self.backend)
        if want is None:
            raise ValueError(f"GroupComm takes the gloo or nccl backend; "
                             f"the group runs {self.backend!r}")
        if t.device.type != want:
            raise ValueError(f"the {self.backend} backend carries {want} "
                             f"tensors; got one on {t.device}")

    def _peer(self, peer: int) -> int:
        import torch.distributed as dist
        return peer if self.group is None else dist.get_global_rank(
            self.group, peer)

    def exchange(self, sends, recvs) -> _Works:
        import torch.distributed as dist
        ops = []
        for t, peer, tag in sends:
            self.check(t)
            ops.append(dist.P2POp(dist.isend, t, self._peer(peer),
                                  self.group, tag))
        for t, peer, tag in recvs:
            self.check(t)
            ops.append(dist.P2POp(dist.irecv, t, self._peer(peer),
                                  self.group, tag))
        return _Works(dist.batch_isend_irecv(ops) if ops else [],
                      [op.tensor for op in ops])

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        self.check(t)
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out


# --------------------------------------------------------------------------
# Ranks as threads of one process
# --------------------------------------------------------------------------
class RankFailed(RuntimeError):
    """Raised in every rank thread still waiting when another rank of
    the same :class:`ThreadComm` failed."""


class _World:
    """What the ranks of one :class:`ThreadComm` share."""

    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.queues = collections.defaultdict(collections.deque)
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)
        self.failed = False
        # host plans the ranks share (core.operator.dist_operator)
        self.plans = {}
        self.plan_lock = threading.Lock()

    def abort(self) -> None:
        with self.cv:
            self.failed = True
            self.cv.notify_all()
        self.barrier.abort()


@dataclasses.dataclass
class _Message:
    tensor: torch.Tensor
    ready: object = None          # CUDA event: the sender's data is written
    taken: object = None          # CUDA event: the receiver has copied it
    done: bool = False


class _ThreadExchange:
    """The handle of one :meth:`ThreadComm.exchange`."""

    def __init__(self, comm: "ThreadComm", sent, recvs):
        self.comm, self.sent, self.recvs = comm, sent, recvs

    def wait(self) -> None:
        w = self.comm.world
        for t, peer, tag in self.recvs:
            with w.cv:
                q = w.queues[(peer, self.comm.rank, tag)]
                while not q and not w.failed:
                    w.cv.wait()
                if w.failed:
                    raise RankFailed("another rank failed")
                msg = q.popleft()
            if msg.ready is not None:
                cur = torch.cuda.current_stream(t.device)
                cur.wait_event(msg.ready)
                t.copy_(msg.tensor)
                msg.tensor.record_stream(cur)
                msg.taken = torch.cuda.Event()
                msg.taken.record(cur)
            else:
                t.copy_(msg.tensor)
            with w.cv:
                msg.done = True
                w.cv.notify_all()
        for msg in self.sent:
            with w.cv:
                while not msg.done and not w.failed:
                    w.cv.wait()
                if w.failed:
                    raise RankFailed("another rank failed")
            if msg.taken is not None:
                torch.cuda.current_stream(
                    msg.tensor.device).wait_event(msg.taken)
        self.recvs, self.sent = [], []


class ThreadComm:
    """One rank of ``size`` ranks run as threads of this process; make
    them with :meth:`create` and drive them with :func:`run_ranks`."""

    def __init__(self, world: _World, rank: int, stream):
        self.world = world
        self.rank = rank
        self.size = world.n
        self.stream = stream

    @classmethod
    def create(cls, n_ranks: int, device=None) -> list:
        """``n_ranks`` rank handles sharing one table.  The ranks run on
        the card unless ``device="cpu"`` is given, each on a CUDA stream
        of its own."""
        if n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1; got {n_ranks}")
        dev = resolve_device(device)
        world = _World(n_ranks)
        return [cls(world, r, torch.cuda.Stream(dev)
                    if dev.type == "cuda" else None)
                for r in range(n_ranks)]

    @staticmethod
    def _event(t: torch.Tensor):
        if t.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return ev

    def exchange(self, sends, recvs) -> _ThreadExchange:
        w = self.world
        sent = []
        with w.cv:
            for t, peer, tag in sends:
                msg = _Message(t, ready=self._event(t))
                w.queues[(self.rank, peer, tag)].append(msg)
                sent.append(msg)
            w.cv.notify_all()
        return _ThreadExchange(self, sent, list(recvs))

    def _barrier(self) -> None:
        try:
            self.world.barrier.wait()
        except threading.BrokenBarrierError:
            raise RankFailed("another rank failed") from None

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        w = self.world
        w.slots[self.rank] = (t, self._event(t))
        self._barrier()
        out = None
        for u, ev in w.slots:
            if ev is not None:
                cur = torch.cuda.current_stream(u.device)
                cur.wait_event(ev)
                u.record_stream(cur)
            out = u.clone() if out is None else out + u
        self._barrier()          # every rank has read the slots
        return out


def run_ranks(comms: Sequence[ThreadComm], fn: Callable) -> list:
    """Run ``fn(comm)`` for every rank in a thread of its own (inside
    the rank's CUDA stream when it has one, and with multithreaded
    backward off, so a gradient's backward pass runs on the rank's own
    thread) and return the results in rank order.  If a rank raises, the others are released from their
    waits and the first failure is raised here."""
    out = [None] * len(comms)
    errors = []

    def body(c):
        try:
            # a backward pass runs on this thread: the engine's one
            # worker per card would run the ranks' passes one after
            # another, and their exchanges wait on each other
            with torch.autograd.set_multithreading_enabled(False):
                if c.stream is not None:
                    with torch.cuda.stream(c.stream):
                        out[c.rank] = fn(c)
                    c.stream.synchronize()
                else:
                    out[c.rank] = fn(c)
        except BaseException as e:          # re-raised by the caller below
            errors.append(e)
            c.world.abort()

    threads = [threading.Thread(target=body, args=(c,), name=f"rank{c.rank}")
               for c in comms]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = [e for e in errors if not isinstance(e, RankFailed)] or errors
    if first:
        raise first[0]
    return out
