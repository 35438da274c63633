"""Distributed-memory spMVM / spMM (paper §3): a row-partitioned pJDS
with halo exchange, each rank one process with one device.

Port of ``repro/core/dist_spmv.py``.  The HOST half is a copy: the
partition of a global CSR onto a 2-D grid ``(gr, gc)`` of ``P = gr*gc``
ranks in row-major order (``i = p // gc``, ``j = p % gc``), where rank
``(i, j)`` stores ``A[I_i, J_j]`` and owns the ``n_loc`` rows of x and
y that a 1-D partition would give it.  ``grid=(P, 1)`` (the default) is
the paper's 1-D row partition.  Two exchanges follow:

* the **x halo** along each grid column (a ring of ``gr``): rank
  ``(i, j)`` needs x entries of ranks ``(i + d, j)``, ``|d| <= halo_w``;
* the **y reduction** along each grid row (a ring of ``gc``): rank
  ``(i, j)`` computes partial sums for the other segments of ``I_i`` and
  ships them to their owners, which add them to their y slice.

Each rank's operands are pJDS rows sorted inside windows of ``sigma``
rows of its own block, so no permutation crosses a link.  The local
operand addresses the rank's x slice; the remote one the "ext" buffer
of ``(2 * halo_w + 1) * n_loc`` entries, slot ``d + halo_w`` holding the
neighbour at distance ``d``; ``mode="pipeline"`` splits it per distance
into stage operands.  :class:`DistPJDS` is the host plan with the
reference's stacked layout (leading axis = rank, numpy arrays), held
bit-identical to it by the tests, except that the TPU's ``chunk_map`` /
``row_block`` are replaced by each rank's ``block_start``.

The DEVICE half runs one rank: :meth:`DistPJDS.shard` gives its
:class:`DistShard` (its operands as ``ops.PJDSDevice``, each with its
own diagonals rather than the padded shared extent, and its index sets
as int32 tensors), and :func:`dist_matvec` / :func:`dist_matmat` run
its body with a communicator of ``core.dist_comm``.  Where the
reference ``ppermute``s, this posts point-to-point messages.  The
spMVs are ``ops.pjds_matvec`` / ``ops.pjds_matmat``: K1 and K5 on a
card, their plain versions on the CPU.  The gathers, scatters and the
unpermute are PyTorch index operations, as the reference computes them
outside any kernel.

Messages carry exactly what the receiver needs: the plan pads each
index set to the largest rank's (``halo_lens``, with a sentinel the
reference drops), but sender and receiver both know the true count of
every link, so the shard trims the sets, sends no padding and skips a
link with nothing to carry -- nothing is ever scattered out of range.
``halo="full"`` ships whole x slices and whole partial segments, as
the reference's bulk baseline does.

Four modes (paper §3.1), now as message order:

* ``vector``: post the exchange, wait, then the local and remote spMVs;
* ``naive``: the local spMV, synchronise, then the exchange;
* ``overlap``: post the exchange, the local spMV while it flies, wait,
  then the remote spMV;
* ``pipeline``: post every stage's exchange; before stage ``s``'s spMV
  wait on stages ``s`` and ``s + 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from . import formats as F
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels._backend import host_tensor, resolve_device

Mode = Literal["vector", "naive", "overlap", "pipeline"]
Halo = Literal["gathered", "full"]
MODES = ("vector", "naive", "overlap", "pipeline")
HALOS = ("gathered", "full")

__all__ = ["DistPJDS", "DistShard", "partition_csr", "dist_matvec",
           "dist_matmat", "dist_matvec_local", "padded_global_size",
           "halo_distances", "grid_shapes", "MODES", "HALOS"]

# Message tags: the x halo of distance index k is tagged k, the
# reduction of distance index kk is tagged _RED_TAG + kk.
_RED_TAG = 1 << 12


def halo_distances(w: int) -> list[int]:
    """Signed ring distances of a width-w exchange, in slot order."""
    return [d for d in range(-w, w + 1) if d != 0]


def grid_shapes(n_dev: int) -> list[tuple[int, int]]:
    """All (gr, gc) factorizations of n_dev, 1-D row partition first."""
    return [(n_dev // gc, gc) for gc in range(1, n_dev + 1)
            if n_dev % gc == 0]


def _col_ring_pairs(n_dev: int, gc: int, d: int) -> list[tuple[int, int]]:
    """src->dst pairs shifting by +d within each grid COLUMN (the x-halo
    ring).  gc == 1 recovers the 1-D ring."""
    gr = n_dev // gc
    return [(q, ((q // gc + d) % gr) * gc + q % gc) for q in range(n_dev)]


def _row_ring_pairs(n_dev: int, gc: int, t: int) -> list[tuple[int, int]]:
    """src->dst pairs shifting by +t within each grid ROW (the
    partial-sum reduction ring)."""
    return [(q, (q // gc) * gc + (q % gc + t) % gc) for q in range(n_dev)]


@dataclasses.dataclass(frozen=True)
class DistPJDS:
    """The host plan: stacked per-rank local / remote / stage pJDS
    operands (leading axis = rank, padded with zeros to the longest
    rank's extent) and the halo and reduction index sets, as numpy
    arrays.  ``*_block_start`` is each rank's own (n_blocks + 1,)
    diagonal offsets, so ``*_block_start[p, -1]`` is where its padding
    starts."""

    loc_val: np.ndarray          # (P, loc_jds, b_r) float32
    loc_col: np.ndarray          # local slice coordinates
    loc_block_start: np.ndarray  # (P, n_blocks + 1) int32
    rem_val: np.ndarray          # (P, rem_jds, b_r)
    rem_col: np.ndarray          # columns in EXT (halo buffer) coordinates
    rem_block_start: np.ndarray
    inv_perm: np.ndarray         # (P, blk_rows) sorted position of each row
    send_idx: np.ndarray         # (P, 2*halo_w, max_h) local columns sent
    recv_idx: np.ndarray         # (P, 2*halo_w, max_h) ext slots received
                                 # (padding = ext_len sentinel)
    n_dev: int
    n_loc: int
    n_blocks: int                # row blocks of one rank (blk_rows // b_r)
    b_r: int
    chunk_l: int
    halo_w: int
    halo_lens: tuple             # per-distance gathered halo sizes
    n_rows: int                  # unpadded
    sigma: int                   # sort window
    loc_max_chunks: int = None   # the reference's per-block chunk ceilings
    rem_max_chunks: int = None
    rem_chunk_l: int = None      # remote tile height (None: chunk_l)
    seg_pos: np.ndarray = None   # (P, gc, n_loc) sorted positions of
                                 # segment (j+s)%gc; row 0 = own y slice
    red_send_pos: np.ndarray = None  # (P, n_red, max_r) sorted y positions
    red_recv_idx: np.ndarray = None  # (P, n_red, max_r) own rows (pad n_loc)
    stage_val: np.ndarray = None     # (P, S, stage_jds, b_r)
    stage_col: np.ndarray = None
    stage_block_start: np.ndarray = None  # (P, S, n_blocks + 1)
    grid: tuple = None           # (gr, gc); None = (P, 1)
    red_w: int = 0
    red_lens: tuple = ()
    stage_dists: tuple = ()
    stage_max_chunks: int = 1

    @property
    def rem_chunk_l_eff(self) -> int:
        return self.chunk_l if self.rem_chunk_l is None else self.rem_chunk_l

    @property
    def grid_eff(self) -> tuple:
        return (self.n_dev, 1) if self.grid is None else self.grid

    @property
    def blk_rows(self) -> int:
        """Matrix rows of one rank's block (gc * n_loc)."""
        return self.n_blocks * self.b_r

    @property
    def n_global_pad(self) -> int:
        return self.n_dev * self.n_loc

    @property
    def ext_len(self) -> int:
        return (2 * self.halo_w + 1) * self.n_loc

    def comm_bytes_per_device(self, value_bytes: int = 8, k: int = 1,
                              halo: Halo = "gathered") -> int:
        """Exchange traffic per rank per spMVM (send == recv volume), x
        halo plus partial-sum reduction, as the reference counts it:
        ``"gathered"`` the per-distance set sizes padded to the largest
        rank's, ``"full"`` whole slices and segments; ``k`` for a block
        of right-hand sides."""
        if halo == "full":
            n_red = sum(1 for h in self.red_lens if h)
            return (2 * self.halo_w + n_red) * self.n_loc * value_bytes * k
        if halo != "gathered":
            raise ValueError(halo)
        return (sum(self.halo_lens) + sum(self.red_lens)) * value_bytes * k

    def comm_msgs_per_device(self, halo: Halo = "gathered") -> int:
        """Point-to-point messages per rank per spMVM, the count the
        calibrated per-message cost multiplies (``perf_model.t_link``)."""
        if halo == "full":
            return 2 * self.halo_w + sum(1 for h in self.red_lens if h)
        if halo != "gathered":
            raise ValueError(halo)
        return (sum(1 for h in self.halo_lens if h) +
                sum(1 for h in self.red_lens if h))

    def shard(self, rank: int, device=None) -> "DistShard":
        """Rank ``rank``'s operands and index sets on ``device`` (CUDA
        unless named)."""
        if not 0 <= rank < self.n_dev:
            raise ValueError(f"rank {rank} outside 0..{self.n_dev - 1}")
        dev = resolve_device(device)
        p = rank
        gr, gc = self.grid_eff
        w, n_loc = self.halo_w, self.n_loc

        def operand(val, col, bs, chunk_l):
            n = int(bs[-1])
            blk = np.diff(bs)
            row_block = np.repeat(np.arange(self.n_blocks, dtype=np.int32),
                                  blk)
            return ops.pjds_container(
                val=host_tensor(val[:n], dev), col_idx=host_tensor(col[:n],
                                                                   dev),
                row_block=host_tensor(row_block, dev),
                block_start=host_tensor(bs, dev), n_blocks=self.n_blocks,
                b_r=self.b_r, chunk_l=chunk_l,
                max_col=int(col[:n].max(initial=0)))

        links = []
        for k, d in enumerate(halo_distances(w)):
            send_to = dict(_col_ring_pairs(self.n_dev, gc, -d))[p]
            recv_from = dict(_col_ring_pairs(self.n_dev, gc, d))[p]
            # the true counts: what this rank needs from recv_from, and
            # what send_to needs from this rank (its own recv set)
            n_recv = int((self.recv_idx[p, k] != self.ext_len).sum())
            n_send = int((self.recv_idx[send_to, k] != self.ext_len).sum())
            links.append(_Link(
                send_idx=host_tensor(self.send_idx[p, k, :n_send], dev),
                send_to=send_to,
                recv_idx=host_tensor(self.recv_idx[p, k, :n_recv]
                                     - (d + w) * n_loc, dev),
                recv_from=recv_from, tag=k))
        red = []
        for kk, t in enumerate(halo_distances(self.red_w)):
            send_to = dict(_row_ring_pairs(self.n_dev, gc, t))[p]
            recv_from = dict(_row_ring_pairs(self.n_dev, gc, -t))[p]
            n_recv = int((self.red_recv_idx[p, kk] != n_loc).sum())
            n_send = int((self.red_recv_idx[send_to, kk] != n_loc).sum())
            red.append(_Link(
                send_idx=host_tensor(self.red_send_pos[p, kk, :n_send], dev),
                send_to=send_to,
                recv_idx=host_tensor(self.red_recv_idx[p, kk, :n_recv], dev),
                recv_from=recv_from, tag=_RED_TAG + kk))
        return DistShard(
            rank=p, n_dev=self.n_dev, n_loc=n_loc, grid=(gr, gc), halo_w=w,
            halo_lens=self.halo_lens, red_w=self.red_w,
            red_lens=self.red_lens, stage_dists=self.stage_dists,
            loc=operand(self.loc_val[p], self.loc_col[p],
                        self.loc_block_start[p], self.chunk_l),
            rem=operand(self.rem_val[p], self.rem_col[p],
                        self.rem_block_start[p], self.rem_chunk_l_eff),
            stages=tuple(operand(self.stage_val[p, s], self.stage_col[p, s],
                                 self.stage_block_start[p, s],
                                 self.rem_chunk_l_eff)
                         for s in range(len(self.stage_dists))),
            seg_pos=host_tensor(self.seg_pos[p], dev),
            links=tuple(links), red=tuple(red), device=dev)


@dataclasses.dataclass(frozen=True)
class _Link:
    """One distance of one rank's exchange: the indices it gathers and
    sends to ``send_to``, and where what arrives from ``recv_from``
    goes.  x halo: ``send_idx`` local columns, ``recv_idx`` columns of
    the neighbour's slice; reduction: ``send_idx`` positions in sorted
    y, ``recv_idx`` rows of the own y slice.  Exact counts, no
    padding."""

    send_idx: torch.Tensor
    send_to: int
    recv_idx: torch.Tensor
    recv_from: int
    tag: int


@dataclasses.dataclass(frozen=True)
class DistShard:
    """One rank's part of a :class:`DistPJDS`, on its device: the local,
    remote and pipeline-stage operands (``ops.PJDSDevice``, each with its
    own diagonals), ``seg_pos`` (gc, n_loc) int32, and one :class:`_Link`
    per x-halo distance (``links``) and per reduction distance
    (``red``)."""

    rank: int
    n_dev: int
    n_loc: int
    grid: tuple
    halo_w: int
    halo_lens: tuple
    red_w: int
    red_lens: tuple
    stage_dists: tuple
    loc: ops.PJDSDevice
    rem: ops.PJDSDevice
    stages: tuple
    seg_pos: torch.Tensor
    links: tuple
    red: tuple
    device: torch.device

    def with_operands(self, fn) -> "DistShard":
        """A shard whose every operand is ``fn(operand)``; the index sets
        are shared."""
        return dataclasses.replace(self, loc=fn(self.loc), rem=fn(self.rem),
                                   stages=tuple(fn(s) for s in self.stages))


def padded_global_size(n_rows: int, n_dev: int, b_r: int = 128) -> int:
    per = b_r * n_dev
    return ((n_rows + per - 1) // per) * per


def _csr_row_slice(m: F.CSRMatrix, lo: int, hi: int,
                   n_loc: int) -> F.CSRMatrix:
    """Rows [lo, hi) of m as a standalone CSR of n_loc rows (zero-padded)."""
    hi = min(hi, m.n_rows)
    counts = np.zeros(n_loc, dtype=np.int64)
    if hi > lo:
        counts[: hi - lo] = np.diff(m.indptr[lo : hi + 1])
    indptr = np.zeros(n_loc + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    s, e = (m.indptr[lo], m.indptr[hi]) if hi > lo else (0, 0)
    return F.CSRMatrix(indptr, m.indices[s:e].copy(), m.data[s:e].copy(),
                       (n_loc, m.shape[1]))


def _split_loc_rem(local: F.CSRMatrix, p: int, n_loc: int, n_dev: int,
                   halo_w: int):
    """1-D helper: split a rank's row slice into local-column and
    remote-column CSRs, remapping columns to slice-local / halo-buffer
    coordinates."""
    own_lo, own_hi = p * n_loc, (p + 1) * n_loc
    rl = np.diff(local.indptr)
    rows = np.repeat(np.arange(local.n_rows), rl)
    cols = local.indices.astype(np.int64)
    vals = local.data
    is_loc = (cols >= own_lo) & (cols < own_hi)

    loc = F.csr_from_coo(rows[is_loc], cols[is_loc] - own_lo, vals[is_loc],
                         (n_loc, n_loc), sum_duplicates=False)
    rcols = cols[~is_loc]
    owner = rcols // n_loc
    d = (owner - p + n_dev) % n_dev          # ring distance
    d = np.where(d > n_dev // 2, d - n_dev, d)
    ext = (d + halo_w) * n_loc + (rcols % n_loc)
    rem = F.csr_from_coo(rows[~is_loc], ext, vals[~is_loc],
                         (n_loc, (2 * halo_w + 1) * n_loc),
                         sum_duplicates=False)
    return loc, rem


def _pad_lead(a: np.ndarray, longest: int, edge: bool) -> np.ndarray:
    """Pad axis 0 to ``longest``: values / columns with ZERO (padding
    contributes nothing), offset maps with their LAST entry (an empty
    map with zeros)."""
    if a.shape[0] == longest:
        return a
    if edge and a.shape[0] == 0:
        return np.zeros((longest,) + a.shape[1:], a.dtype)
    pad = [(0, longest - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, mode="edge" if edge else "constant")


def _check_chunks(p: F.PJDSMatrix, chunk_l: int) -> None:
    if np.any(p.block_len % chunk_l):
        raise ValueError(
            f"chunk_l={chunk_l} must divide every block length; rebuild the "
            f"pJDS matrix with diag_align a multiple of chunk_l")


def _max_chunks(pjs: list, chunk_l: int) -> int:
    """The reference's static per-block chunk ceiling across ranks,
    counting the chunks the shared-extent padding appends to each rank's
    last block."""
    longest = max(int(pj.total_jds) // chunk_l for pj in pjs)
    mx = 1
    for pj in pjs:
        per = (pj.block_len // chunk_l).astype(np.int64)
        if len(per):
            per[-1] += longest - int(pj.total_jds) // chunk_l
            mx = max(mx, int(per.max()))
    return mx


def partition_csr(
    m: F.CSRMatrix,
    n_dev: int,
    b_r: int = 128,
    diag_align: int = 8,
    chunk_l: int = 8,
    halo_w: int | None = None,
    sigma: int | None = None,
    index_dtype="auto",
    rem_chunk_l: int | None = None,
    grid: tuple | None = None,
    build_stages: bool = True,
) -> DistPJDS:
    """Partition a global CSR onto an ``n_dev``-rank grid as
    :class:`DistPJDS` (the reference's ``partition_csr``).

    ``grid=(gr, gc)`` selects the 2-D block layout (``gr * gc ==
    n_dev``); ``None`` is the 1-D row partition ``(n_dev, 1)``.
    ``halo_w`` is measured when not given (too small raises), clamped to
    the ring radius; a block-diagonal matrix measures 0 and exchanges
    nothing.  ``sigma`` bounds each rank's row-sort window (default
    8*b_r, clamped to the block).  ``index_dtype="auto"`` stores int16
    columns whenever a rank's slice or ext span fits.  ``rem_chunk_l``
    gives the remote operand its own tile height.  ``build_stages``
    also splits the remote operand per ring distance for
    ``mode="pipeline"`` (about a second copy of it).
    """
    if m.shape[0] != m.shape[1]:
        raise ValueError("distributed spMVM expects a square matrix")
    if grid is None:
        gr, gc = n_dev, 1
    else:
        gr, gc = (int(grid[0]), int(grid[1]))
        if gr < 1 or gc < 1 or gr * gc != n_dev:
            raise ValueError(f"grid {grid!r} incompatible with n_dev={n_dev}")
    n_pad = padded_global_size(m.n_rows, n_dev, b_r)
    n_loc = n_pad // n_dev
    blk_rows = gc * n_loc

    # COO view of each rank's block A[I_i, J_j], with the signed
    # grid-column ring distance of every entry's x owner.
    row_slices = [_csr_row_slice(m, i * blk_rows, (i + 1) * blk_rows,
                                 blk_rows) for i in range(gr)]
    dev_rows, dev_cols, dev_vals, dev_d = [], [], [], []
    needs = []
    for p in range(n_dev):
        i, j = divmod(p, gc)
        sl = row_slices[i]
        rl = np.diff(sl.indptr)
        rows = np.repeat(np.arange(blk_rows), rl)
        cols = sl.indices.astype(np.int64)
        vals = sl.data
        owner = cols // n_loc                 # rank owning x[col]
        keep = owner % gc == j                # this rank's column block
        rows, cols, vals, owner = (rows[keep], cols[keep], vals[keep],
                                   owner[keep])
        d = (owner // gc - i) % gr            # grid-column ring distance
        if gr > 1:
            d = np.where(d > gr // 2, d - gr, d)
        dev_rows.append(rows)
        dev_cols.append(cols)
        dev_vals.append(vals)
        dev_d.append(d)
        nd = {}
        for dd in np.unique(d):
            if dd == 0:
                continue
            nd[int(dd)] = np.unique(cols[d == dd] % n_loc)
        needs.append(nd)

    measured = max((max((abs(d) for d in nd), default=0) for nd in needs),
                   default=0)
    if halo_w is None:
        halo_w = measured
    else:
        halo_w = int(halo_w)
        if halo_w < measured:
            raise ValueError(
                f"halo_w={halo_w} too small: matrix couples devices at ring "
                f"distance {measured}")
    if halo_w > gr // 2 and gr > 1:
        halo_w = gr // 2
    if gr == 1:
        halo_w = 0

    dists = halo_distances(halo_w)
    halo_lens = tuple(
        max((len(nd.get(d, ())) for nd in needs), default=0) for d in dists)
    ext_len = (2 * halo_w + 1) * n_loc
    max_h = max(halo_lens, default=0)
    # send_idx[p, k]: the local columns p gathers for distance dists[k]
    # (p serves the grid-column neighbour at distance -d, so it is THAT
    # rank's need set); recv_idx[p, k]: where what arrives from distance
    # +d lands in p's ext buffer.  Gathers pad with 0, scatters with the
    # ext_len sentinel.
    send_idx = np.zeros((n_dev, len(dists), max_h), dtype=np.int32)
    recv_idx = np.full((n_dev, len(dists), max_h), ext_len, dtype=np.int32)
    for k, d in enumerate(dists):
        for p in range(n_dev):
            i, j = divmod(p, gc)
            served = ((i - d) % gr) * gc + j
            snd = needs[served].get(d)
            if snd is not None and len(snd):
                send_idx[p, k, : len(snd)] = snd
            rcv = needs[p].get(d)
            if rcv is not None and len(rcv):
                recv_idx[p, k, : len(rcv)] = (d + halo_w) * n_loc + rcv

    # Partial-sum reduction need sets: the rows of each FOREIGN segment
    # of its row block this rank touches, by signed grid-row distance t.
    red_needs = []
    for p in range(n_dev):
        i, j = divmod(p, gc)
        seg = dev_rows[p] // n_loc
        t = (seg - j) % gc
        if gc > 1:
            t = np.where(t > gc // 2, t - gc, t)
        nd = {}
        for tt in np.unique(t):
            if tt == 0:
                continue
            nd[int(tt)] = np.unique(dev_rows[p][t == tt] % n_loc)
        red_needs.append(nd)
    red_w = max((max((abs(t) for t in nd), default=0) for nd in red_needs),
                default=0)
    red_dists = halo_distances(red_w)
    red_lens = tuple(
        max((len(nd.get(t, ())) for nd in red_needs), default=0)
        for t in red_dists)
    max_r = max(red_lens, default=0)

    sig = min(int(sigma) if sigma is not None else 8 * b_r, blk_rows)
    sig = max(sig, 1)

    rcl = chunk_l if rem_chunk_l is None else int(rem_chunk_l)
    stage_dists = tuple(d for k, d in enumerate(dists)
                        if build_stages and halo_lens[k] > 0)
    locs, rems, invs, seg_pos = [], [], [], []
    stage_ops = []
    for p in range(n_dev):
        i, j = divmod(p, gc)
        rows, cols, vals, d = (dev_rows[p], dev_cols[p], dev_vals[p],
                               dev_d[p])
        is_loc = d == 0
        loc = F.csr_from_coo(rows[is_loc], cols[is_loc] % n_loc,
                             vals[is_loc], (blk_rows, n_loc),
                             sum_duplicates=False)
        ext = (d[~is_loc] + halo_w) * n_loc + (cols[~is_loc] % n_loc)
        rem = F.csr_from_coo(rows[~is_loc], ext, vals[~is_loc],
                             (blk_rows, ext_len), sum_duplicates=False)
        # One shared per-rank row sort (by TOTAL row length), windowed to
        # sigma rows, so all partial results add in one permuted order.
        total_rl = loc.row_lengths() + rem.row_lengths()
        perm = F.windowed_sort_perm(total_rl, sig)
        pj_loc = F._pjds_with_perm(loc, perm, b_r,
                                   max(diag_align, chunk_l), False,
                                   index_dtype)
        pj_rem = F._pjds_with_perm(rem, perm, b_r,
                                   max(diag_align, rcl), False,
                                   index_dtype)
        _check_chunks(pj_loc, chunk_l)
        _check_chunks(pj_rem, rcl)
        locs.append(pj_loc)
        rems.append(pj_rem)
        stages = []
        for ds in stage_dists:
            ss = ~is_loc & (d == ds)
            st = F.csr_from_coo(rows[ss], cols[ss] % n_loc, vals[ss],
                                (blk_rows, n_loc), sum_duplicates=False)
            pj_st = F._pjds_with_perm(st, perm, b_r,
                                      max(diag_align, rcl), False,
                                      index_dtype)
            _check_chunks(pj_st, rcl)
            stages.append(pj_st)
        stage_ops.append(stages)
        inv = np.empty(blk_rows, dtype=np.int32)
        inv[perm] = np.arange(blk_rows, dtype=np.int32)
        invs.append(inv)
        seg_pos.append(np.stack(
            [inv[((j + s) % gc) * n_loc : ((j + s) % gc + 1) * n_loc]
             for s in range(gc)]))

    # Reduction gather positions (into SORTED y) and scatter-add rows.
    red_send_pos = np.zeros((n_dev, len(red_dists), max_r), dtype=np.int32)
    red_recv_idx = np.full((n_dev, len(red_dists), max_r), n_loc,
                           dtype=np.int32)
    for kk, t in enumerate(red_dists):
        for p in range(n_dev):
            i, j = divmod(p, gc)
            snd = red_needs[p].get(t)
            if snd is not None and len(snd):
                jt = (j + t) % gc
                red_send_pos[p, kk, : len(snd)] = invs[p][jt * n_loc + snd]
            src = i * gc + (j - t) % gc
            rcv = red_needs[src].get(t)
            if rcv is not None and len(rcv):
                red_recv_idx[p, kk, : len(rcv)] = rcv

    def _stream(pj, attr):
        # values as the reference stores them: f32 (x64 off); columns as
        # built (int16 or int32)
        a = getattr(pj, attr)
        return a.astype(np.float32) if attr == "val" else a

    def _stack(pjs, attr):
        arrs = [_stream(pj, attr) for pj in pjs]
        longest = max(a.shape[0] for a in arrs)
        return np.stack([_pad_lead(a, longest, False) for a in arrs])

    def _stack_stages(attr):
        if not stage_dists:
            like = _stream(locs[0], attr)
            return np.zeros((n_dev, 0, 0) + like.shape[1:], like.dtype)
        arrs = [[_stream(st, attr) for st in stages] for stages in stage_ops]
        longest = max(a.shape[0] for row in arrs for a in row)
        return np.stack([np.stack([_pad_lead(a, longest, False)
                                   for a in row]) for row in arrs])

    def _starts(pjs):
        return np.stack([pj.block_start.astype(np.int32) for pj in pjs])

    n_blocks = blk_rows // b_r
    return DistPJDS(
        loc_val=_stack(locs, "val"),
        loc_col=_stack(locs, "col_idx"),
        loc_block_start=_starts(locs),
        rem_val=_stack(rems, "val"),
        rem_col=_stack(rems, "col_idx"),
        rem_block_start=_starts(rems),
        inv_perm=np.stack(invs),
        send_idx=send_idx,
        recv_idx=recv_idx,
        n_dev=n_dev,
        n_loc=n_loc,
        n_blocks=n_blocks,
        b_r=b_r,
        chunk_l=chunk_l,
        halo_w=halo_w,
        halo_lens=halo_lens,
        n_rows=m.n_rows,
        sigma=sig,
        loc_max_chunks=_max_chunks(locs, chunk_l),
        rem_max_chunks=_max_chunks(rems, rcl),
        rem_chunk_l=None if rcl == chunk_l else rcl,
        seg_pos=np.stack(seg_pos),
        red_send_pos=red_send_pos,
        red_recv_idx=red_recv_idx,
        stage_val=_stack_stages("val"),
        stage_col=_stack_stages("col_idx"),
        stage_block_start=(
            np.stack([_starts(stages) for stages in stage_ops])
            if stage_dists else np.zeros((n_dev, 0, n_blocks + 1), np.int32)),
        grid=None if gc == 1 else (gr, gc),
        red_w=red_w,
        red_lens=red_lens,
        stage_dists=stage_dists,
        stage_max_chunks=(_max_chunks([st for stages in stage_ops
                                       for st in stages], rcl)
                          if stage_dists else 1),
    )


# --------------------------------------------------------------------------
# One rank's body
# --------------------------------------------------------------------------
def _spmv(a: ops.PJDSDevice, v: torch.Tensor, backend: str) -> torch.Tensor:
    """K1 (K5 for a block of right-hand sides) on a card, the plain
    version on the CPU; y in the rank's sorted basis."""
    if v.dim() == 2:
        return ops.pjds_matmat(a, v, backend=backend)
    return ops.pjds_matvec(a, v, backend=backend)


def _sync(t: torch.Tensor) -> None:
    """Wait for every launch so far on ``t``'s stream: ``mode="naive"``
    models an MPI library without asynchronous progress."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def _post_halo(shard: DistShard, x: torch.Tensor, comm, halo: Halo,
               ks) -> tuple:
    """Post the x-halo messages of distance indices ``ks`` (one
    exchange); returns ``(handle, {k: receive buffer})``.  ``gathered``
    sends each neighbour the entries it references and skips a link
    with none; ``full`` sends the whole slice."""
    sends, recvs, bufs = [], [], {}
    for k in ks:
        ln = shard.links[k]
        if halo == "gathered":
            if ln.send_idx.numel():
                sends.append((x.index_select(0, ln.send_idx), ln.send_to,
                              ln.tag))
            if ln.recv_idx.numel():
                bufs[k] = x.new_empty((ln.recv_idx.numel(),) + x.shape[1:])
                recvs.append((bufs[k], ln.recv_from, ln.tag))
        else:
            sends.append((x.contiguous(), ln.send_to, ln.tag))
            bufs[k] = torch.empty_like(x)
            recvs.append((bufs[k], ln.recv_from, ln.tag))
    return comm.exchange(sends, recvs), bufs


def _ext_of(shard: DistShard, x: torch.Tensor, bufs: dict,
            halo: Halo) -> torch.Tensor:
    """The dense ext buffer, ``(2 * halo_w + 1) * n_loc`` entries, slot
    ``d + halo_w`` the neighbour at distance d (the own slot is x for
    ``full`` and zero for ``gathered``; remote columns never point
    there)."""
    w = shard.halo_w
    dists = halo_distances(w)
    if halo == "full":
        parts = [bufs[k] for k in range(w)] + [x] + \
                [bufs[k] for k in range(w, 2 * w)]
        return torch.cat(parts)
    ext = x.new_zeros((2 * w + 1, shard.n_loc) + x.shape[1:])
    for k, buf in bufs.items():
        ext[dists[k] + w].index_put_((shard.links[k].recv_idx,), buf)
    return ext.reshape((-1,) + x.shape[1:])


def _reduce_partials(shard: DistShard, y: torch.Tensor, comm,
                     halo: Halo) -> torch.Tensor:
    """The grid-row partial-sum reduction folded into the epilogue:
    gather the own y slice and the partial rows of each neighbour
    straight from the sorted y (no dense unpermute), ship them along the
    grid row, and add what arrives."""
    gc = shard.grid[1]
    red_dists = halo_distances(shard.red_w)
    sends, recvs = [], []
    if halo == "full":
        # Skip distances whose measured coupling is empty: on an even
        # ring +gc/2 and -gc/2 are one partner, and shipping the empty
        # mirror would count the shared segment twice.
        y_own = y.index_select(0, shard.seg_pos[0])
        for kk, t in enumerate(red_dists):
            if shard.red_lens[kk] == 0:
                continue
            ln = shard.red[kk]
            sends.append((y.index_select(0, shard.seg_pos[t % gc]),
                          ln.send_to, ln.tag))
            recvs.append((torch.empty_like(y_own), ln.recv_from, ln.tag))
        comm.exchange(sends, recvs).wait()
        for buf, _, _ in recvs:
            y_own = y_own + buf
        return y_own
    y_own, bufs = R.partial_reduce_epilogue(
        y, shard.seg_pos[0], [ln.send_idx for ln in shard.red])
    adds = []
    for kk, ln in enumerate(shard.red):
        if bufs[kk] is not None:
            sends.append((bufs[kk], ln.send_to, ln.tag))
        if ln.recv_idx.numel():
            buf = y.new_empty((ln.recv_idx.numel(),) + y.shape[1:])
            recvs.append((buf, ln.recv_from, ln.tag))
            adds.append((ln.recv_idx, buf))
    comm.exchange(sends, recvs).wait()
    for idx, buf in adds:
        # rows within one distance are distinct: one add per row
        y_own = y_own.index_add(0, idx, buf)
    return y_own


def dist_matvec_local(shard: DistShard, x: torch.Tensor, comm, *,
                      mode: Mode = "overlap", halo: Halo = "gathered",
                      backend: str = "auto") -> torch.Tensor:
    """One rank's body: ``x`` is its (n_loc,) or (n_loc, k) slice, the
    result its slice of y = A x."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    if halo not in HALOS:
        raise ValueError(f"halo must be one of {HALOS}; got {halo!r}")
    if x.shape[0] != shard.n_loc or x.dim() not in (1, 2):
        raise ValueError(f"x must be this rank's ({shard.n_loc},) or "
                         f"({shard.n_loc}, k) slice; got {tuple(x.shape)}")
    if x.device != shard.device:
        raise ValueError(f"x is on {x.device}; the shard on {shard.device}")
    ks = range(2 * shard.halo_w)
    no_halo = (sum(shard.halo_lens) == 0 if halo == "gathered"
               else shard.halo_w == 0)
    if no_halo:
        # Block-diagonal in x: nothing crosses a link, every mode is the
        # local spMV (the grid-row reduction may still communicate).
        y = _spmv(shard.loc, x, backend)
    elif mode == "vector":
        handle, bufs = _post_halo(shard, x, comm, halo, ks)
        handle.wait()
        ext = _ext_of(shard, x, bufs, halo)
        y = _spmv(shard.loc, x, backend) + _spmv(shard.rem, ext, backend)
    elif mode == "naive":
        y_loc = _spmv(shard.loc, x, backend)
        _sync(y_loc)
        handle, bufs = _post_halo(shard, x, comm, halo, ks)
        handle.wait()
        y = y_loc + _spmv(shard.rem, _ext_of(shard, x, bufs, halo), backend)
    elif mode == "overlap":
        handle, bufs = _post_halo(shard, x, comm, halo, ks)
        y_loc = _spmv(shard.loc, x, backend)
        handle.wait()
        y = y_loc + _spmv(shard.rem, _ext_of(shard, x, bufs, halo), backend)
    else:
        y = _pipeline_body(shard, x, comm, halo, backend)

    if shard.grid[1] == 1:
        # 1-D: the rank owns its whole row block; undo the sort
        y = y.index_select(0, shard.seg_pos[0])
    else:
        y = _reduce_partials(shard, y, comm, halo)
    return y.to(x.dtype)


def _pipeline_body(shard: DistShard, x: torch.Tensor, comm, halo: Halo,
                   backend: str) -> torch.Tensor:
    """Every stage's exchange is posted up front; before stage s's
    spMV the rank waits on stages s and s + 1, the reference's
    one-buffer-ahead schedule (paper's explicit overlap)."""
    if not shard.stage_dists:
        raise ValueError(
            "mode='pipeline' needs per-distance stage operands; "
            "repartition with build_stages=True")
    w, n_loc = shard.halo_w, shard.n_loc
    dists = halo_distances(w)
    posted = [_post_halo(shard, x, comm, halo, [dists.index(d)])
              for d in shard.stage_dists]
    y = _spmv(shard.loc, x, backend)
    for s, d in enumerate(shard.stage_dists):
        k = dists.index(d)
        posted[s][0].wait()
        if s + 1 < len(posted):
            posted[s + 1][0].wait()
        buf = posted[s][1].get(k)
        if halo == "gathered":
            ext_s = x.new_zeros((n_loc,) + x.shape[1:])
            if buf is not None:
                ext_s.index_put_((shard.links[k].recv_idx,), buf)
        else:
            ext_s = buf
        y = y + _spmv(shard.stages[s], ext_s, backend)
    return y


def dist_matvec(shard: DistShard, x: torch.Tensor, comm, *,
                mode: Mode = "overlap", halo: Halo = "gathered",
                backend: str = "auto") -> torch.Tensor:
    """y = A x on one rank: ``x`` is the rank's (n_loc,) slice of the
    padded global vector, and so is the result."""
    if x.dim() != 1:
        raise ValueError(f"dist_matvec expects x of shape (n_loc,); got "
                         f"{tuple(x.shape)}")
    return dist_matvec_local(shard, x, comm, mode=mode, halo=halo,
                             backend=backend)


def dist_matmat(shard: DistShard, x: torch.Tensor, comm, *,
                mode: Mode = "overlap", halo: Halo = "gathered",
                backend: str = "auto") -> torch.Tensor:
    """Y = A X on one rank for a block of right-hand sides: ``x`` is
    the rank's (n_loc, k) slice; the spMVs run K5 on a card, and every
    message carries k columns per entry."""
    if x.dim() != 2:
        raise ValueError(f"dist_matmat expects x of shape (n, k); got "
                         f"{tuple(x.shape)}")
    return dist_matvec_local(shard, x, comm, mode=mode, halo=halo,
                             backend=backend)
