"""The DP fill: kernel K1's wrapper and its plain PyTorch version.

Replaces ``smithwaterman_tpu/ops/pallas_dp.py`` ``fill_tiled`` (kernel
body ``_kernel``) with the dense score precompute of ``ops/batch.py``.

One call fills every chunk of a flush (:func:`fill_many`).  Its outputs:

* ``tb``: one flat uint8 pool holding each pair's pointer bytes together,
  row-major: a chunk is a ``(B, NP, RS)`` array, ``RS`` = MP rounded up to
  a multiple of 4 (:func:`row_stride`), so K1's lanes store four columns
  a word (:meth:`Filled.tb_view` shows it as ``(NP, MP, B)``); the byte of
  DP cell ``(i, j)``, ``1 <= i <= n``, ``1 <= j <= m``, holds the
  predecessor state of M in bits 0-1, of X in bits 2-3 and of Y in bits
  4-5 (``CELL_STOP`` = 3 at LOCAL zeros).  Only each pair's ``[:n, :m]``
  bytes are defined.
* ``stats`` (B, 8) f32, the Pallas contract (``pallas_dp.py:105``):
  LOCAL ``[best, best_i, best_j, 0, ...]`` with the first maximum in
  i-major, j-minor order (best_i, best_j zero for score-only fills);
  GLOBAL/GLOCAL ``[0, 0, 0, finalM, finalX, finalY, 0, 0]``.
* ``desc`` (B, 8) int64 per-pair descriptors (``csrc/sw_cell.cuh`` Desc),
  which the walk (``device_walk``) reads too, and ``order`` (B,) int32,
  the pairs in the order the walks start them: the longest n + m first
  (:func:`walk_order`).
* ``run`` (with ``runs=True``, for the token walk): a second uint8 pool in
  ``tb``'s layout holding each cell's match-run byte (``pallas_dp.py``
  ``fill_tiled(emit_runs=True)``): e in bits 0-3, the exit state in bits
  4-5, ``(15, STOP)`` reserved for LOCAL zero cells.  Defined, as ``tb``,
  for each pair's ``[:n, :m]``.

On CUDA tensors :func:`fill_many` launches K1 (``csrc/fill.cu``, a warp a
pair, or a block of warps a pair when the pairs are few) once for each
stripe depth its chunks take (:func:`stripe_rows`: from their rows, the
pairs of the fill and the pools written; :func:`launch_plan`), or
K10 (the same kernel writing run bytes too) with ``runs=True``; on CPU
tensors it runs :func:`fill_ref`, the plain version built on the exact
oracle ``ops/scan_dp.py``, and :func:`run_bytes_ref`.  There is no other
route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CELL_MATCH, CELL_STOP, LOCAL
from ..utils import metrics
from . import batch, scan_dp

STATS_W = 8
# per-pair descriptor columns (int64), the csrc/sw_cell.cuh Desc enum
D_OFF1, D_OFF2, D_N, D_M, D_TB, D_CS, D_RS, D_CARRY = range(8)
DESC_W = 8

# a run byte: (e, exit state); row 0 and column 0 read (15, M)
RUN_EDGE = 15
# K1's rows a lane (csrc/fill.cu template instantiations), deepest first
STRIPE_R = (8, 4, 2, 1)
WARP = 32
# A K1 warp keeps one 128-byte line a row of its stripe, in each byte pool
# it writes, half written until its lanes have passed the line's 128
# columns; lines a launch holds past the L2 cache are written back and
# fetched again half filled.  The lines in flight a launch is given:
L2_LINE = 128
L2_INFLIGHT = 32 << 20
# warps an SM keeps resident at 128 registers a thread (K1 takes 69 to 166
# by R and outputs); launch_plan shares a card's out among a fill's pairs
WARPS_AN_SM = 16


def row_stride(MP: int) -> int:
    """Bytes between a pair's pointer rows: MP rounded up to a multiple
    of 4 (K1 stores four columns a word)."""
    return -(-MP // 4) * 4


def carry_floats(rs: int) -> int:
    """K1's carry scratch of a pair with row stride ``rs``, in floats: two
    seed rows, each M, X, Y and its run bytes (``csrc/sw_band.cuh``)."""
    return 2 * (3 * rs + rs // 4)


def stripe_rows(NP: int, pairs: int = 1, pools: int = 1) -> int:
    """K1's rows a lane R for a chunk of NP rows in a launch of ``pairs``
    pairs that writes ``pools`` byte pools (0 score-only, 1 pointer bytes,
    2 with run bytes): the deepest stripe of 32 R rows that the chunk fills
    and whose lines in flight, over the launch's pairs, fit L2_INFLIGHT
    (R = 1 when none does).  A deep stripe runs a pair in fewer steps,
    each repeating fewer 31-step ramps, which is what a few pairs need; a
    shallow one idles fewer lanes and, for many pairs, keeps the pools'
    partly written lines in L2."""
    return next((R for R in STRIPE_R if WARP * R <= NP and
                 pairs * WARP * R * L2_LINE * pools <= L2_INFLIGHT), 1)


def pool_view(pool: torch.Tensor, lo: int, shape) -> torch.Tensor:
    """A chunk of shape (B, NP, MP) at offset ``lo`` of a pool in K1's
    layout, as an (NP, MP, B) view."""
    B, NP, MP = shape
    rs = row_stride(MP)
    return pool[lo:lo + B * NP * rs].view(B, NP, rs)[:, :, :MP] \
        .permute(1, 2, 0)


@dataclass
class Filled:
    """The result of one pooled fill (see the module docstring)."""

    tb: Optional[torch.Tensor]     # flat uint8 pool, None when score-only
    stats: torch.Tensor            # (B, 8) f32
    desc: torch.Tensor             # (B, 8) int64, on the fill's device
    shapes: List[Tuple[int, int, int]]  # per chunk (B, NP, MP)
    tb_base: List[int]             # per chunk offset into the pool
    run: Optional[torch.Tensor] = None  # run-byte pool in tb's layout
    order: Optional[torch.Tensor] = None  # (B,) int32, walk_order's

    def tb_view(self, c: int, pool: Optional[torch.Tensor] = None):
        """Chunk ``c``'s pointers (or its bytes of ``pool``, a pool in the
        same layout such as ``run``) as a (NP, MP, B) view."""
        return pool_view(self.tb if pool is None else pool,
                         self.tb_base[c], self.shapes[c])


def layout(chunks: Sequence[batch.Chunk]):
    """Per-pair descriptors for the pairs of ``chunks``, in order.

    Returns ``(desc (B, 8) int64 numpy, tb_base, tb_bytes, carry_floats)``.
    Pair k of a chunk of shape (B, NP, MP), ``rs = row_stride(MP)``: codes
    at ``c1_base + k*NP`` / ``c2_base + k*MP`` of the flat code buffers;
    cell (i, j) pointer at ``tb_base + k*NP*rs + (i-1)*rs + (j-1)``
    (``D_CS`` = 1, ``D_RS`` = rs); K1's carry scratch (:func:`carry_floats`)
    at ``carry_base + k*carry_floats(rs)`` floats."""
    rows = []
    tb_base = []
    c1 = c2 = tb = carry = 0
    for ch in chunks:
        B, NP, MP = ch.shape
        rs = row_stride(MP)
        cf = carry_floats(rs)
        k = np.arange(B, dtype=np.int64)
        d = np.empty((B, DESC_W), np.int64)
        d[:, D_OFF1] = c1 + k * NP
        d[:, D_OFF2] = c2 + k * MP
        d[:, D_N] = ch.n
        d[:, D_M] = ch.m
        d[:, D_TB] = tb + k * NP * rs
        d[:, D_CS] = 1
        d[:, D_RS] = rs
        d[:, D_CARRY] = carry + k * cf
        rows.append(d)
        tb_base.append(tb)
        c1 += B * NP
        c2 += B * MP
        tb += B * NP * rs
        carry += B * cf
    desc = (np.concatenate(rows) if rows
            else np.zeros((0, DESC_W), np.int64))
    return desc, tb_base, tb, carry


def walk_order(desc: np.ndarray) -> np.ndarray:
    """The descriptor rows of ``desc`` in the order K2 and K11 start their
    walks: the longest n + m first (a pair's longest walk), so that the
    longest chains start in the launch's first blocks; int32."""
    return np.argsort(-(desc[:, D_N] + desc[:, D_M]),
                      kind="stable").astype(np.int32)


def launch_plan(chunks: Sequence[batch.Chunk], pools: int = 1,
                sms: int = 0):
    """K1's launches over ``chunks`` writing ``pools`` byte pools (see
    :func:`stripe_rows`) on a card of ``sms`` SMs: ``[(R, NW, order)]``,
    one for each R that :func:`stripe_rows` gives a chunk.  ``order`` is
    the int32 rows of ``layout(chunks)``'s descriptors it fills, the
    costliest pairs first (stripes times columns plus the ramp) so that the
    last blocks to start are short.  ``NW`` is the warps a pair: one while
    the fill's pairs fill the card's resident warps, else up to a warp a
    stripe (with ``sms`` 0, one)."""
    groups = {}
    lo = 0
    pairs = sum(ch.shape[0] for ch in chunks)
    spare = max(1, WARPS_AN_SM * sms // max(pairs, 1))
    for ch in chunks:
        B, NP, _ = ch.shape
        R = stripe_rows(NP, pairs, pools)
        stripes = -(-ch.n.astype(np.int64) // (WARP * R))
        cost = stripes * (ch.m.astype(np.int64) + WARP - 1)
        g = groups.setdefault(R, ([], [], []))
        g[0].append(np.arange(lo, lo + B, dtype=np.int32))
        g[1].append(cost)
        g[2].append(stripes)
        lo += B
    plan = []
    for R in STRIPE_R:
        if R in groups:
            rows, cost, stripes = (np.concatenate(a) for a in groups[R])
            NW = int(min(spare, stripes.max(), 32))
            plan.append((R, NW, rows[np.argsort(-cost, kind="stable")]))
    return plan


def computed_cells(chunks: Sequence[batch.Chunk], pools: int = 1) -> int:
    """The cells K1 computes over ``chunks`` writing ``pools`` byte pools:
    each pair's rows rounded up to its stripes of 32 R rows
    (:func:`stripe_rows`) times its columns."""
    pairs = sum(ch.shape[0] for ch in chunks)
    total = 0
    for ch in chunks:
        rows = WARP * stripe_rows(ch.shape[1], pairs, pools)
        total += int(np.dot(-(-ch.n.astype(np.int64) // rows) * rows, ch.m))
    return total


def fill_ref(table: torch.Tensor, codes1: torch.Tensor, codes2: torch.Tensor,
             n: torch.Tensor, m: torch.Tensor, *, mode: int, og: float,
             eg: float, score_only: bool = False):
    """Plain PyTorch fill of one chunk on the tensors' device: the dense
    score gather plus ``scan_dp.fill``.  Returns ``(tb (NP, MP, B) uint8
    or None, stats (B, 8) f32)`` in K1's contract."""
    S = batch.scores(table, codes1, codes2)
    r = scan_dp.fill(S, n, m, og, eg, mode, with_traceback=not score_only)
    B = codes1.shape[0]
    stats = torch.zeros((B, STATS_W), dtype=torch.float32, device=S.device)
    if mode == LOCAL:
        stats[:, 0] = r.best
        if not score_only:
            stats[:, 1] = r.best_i.to(torch.float32)
            stats[:, 2] = r.best_j.to(torch.float32)
    else:
        stats[:, 3:6] = r.final
    tb = None if score_only else r.tb[:, 1:, 1:].permute(1, 2, 0).contiguous()
    return tb, stats


def run_bytes_ref(tb: torch.Tensor) -> torch.Tensor:
    """The match-run bytes of one chunk's pointers ``tb`` (NP, MP, B),
    in plain PyTorch: a loop over rows, vectorised over columns and pairs,
    reading the row above shifted one column, as ``pallas_dp.py:525-546``
    and ``csrc/sw_cell.cuh`` ``run_byte`` do."""
    NP, MP, B = tb.shape
    pm = (tb & 3).to(torch.int32)
    out = torch.empty_like(tb)
    edge = torch.full((1, B), RUN_EDGE, dtype=torch.int32, device=tb.device)
    above = edge.expand(MP, B)          # row 0
    for i in range(NP):
        rd = torch.cat([edge, above[:-1]], 0)   # column 0 reads the edge
        ed, xd = rd & 15, (rd >> 4) & 3
        p = pm[i]
        is_m = p == CELL_MATCH
        diag_stop = (ed == 15) & (xd == CELL_STOP)
        ecap = torch.where(xd == CELL_STOP, 14, 15)
        cont = is_m & ~diag_stop & (ed < ecap)
        e = torch.where(cont, ed + 1, 0)
        x = torch.where(cont, xd, torch.where(
            is_m, torch.where(diag_stop, CELL_STOP, CELL_MATCH), p))
        stop = p == CELL_STOP
        e = torch.where(stop, 15, e)
        x = torch.where(stop, CELL_STOP, x)
        above = e | (x << 4)
        out[i] = above.to(torch.uint8)
    return out


def _validate(chunks: Sequence[batch.Chunk], K: int) -> None:
    ctype = batch.code_dtype(K)
    for ch in chunks:
        B, NP, MP = ch.shape
        for name, a, dt in (("codes1", ch.codes1, ctype),
                            ("codes2", ch.codes2, ctype),
                            ("n", ch.n, np.int32), ("m", ch.m, np.int32)):
            if a.dtype != dt:
                raise ValueError(f"{name} has dtype {a.dtype}, expected {dt}")
        if ch.codes2.shape[0] != B or ch.n.shape != (B,) or \
                ch.m.shape != (B,):
            raise ValueError("chunk arrays disagree on the pair count")
        if B and (ch.n.min() < 1 or ch.m.min() < 1 or ch.n.max() > NP
                  or ch.m.max() > MP):
            raise ValueError(
                f"lengths must lie in 1..{NP} and 1..{MP} for a "
                f"{NP}x{MP} chunk")
        # K1 looks scores up in the table, where a larger code would read
        # past it
        if B and (max(ch.codes1.max(), ch.codes2.max()) >= K
                  or min(ch.codes1.min(), ch.codes2.min()) < 0):
            raise ValueError(f"codes must lie below the table's {K} symbols")


def _alloc(chunks, table: torch.Tensor, score_only: bool, runs: bool):
    if runs and score_only:
        raise ValueError("run bytes come with a traceback fill")
    dev = table.device
    _validate(chunks, table.shape[0])
    desc_np, tb_base, tb_bytes, carry_floats = layout(chunks)

    def pool(on):
        return (torch.empty(max(tb_bytes, 1), dtype=torch.uint8, device=dev)
                if on else None)

    B = desc_np.shape[0]
    stats = torch.empty((B, STATS_W), dtype=torch.float32, device=dev)
    # the descriptors and the walk order in one upload
    both = np.empty(B * DESC_W + (B + 1) // 2, np.int64)
    both[:B * DESC_W] = desc_np.ravel()
    both[B * DESC_W:].view(np.int32)[:B] = walk_order(desc_np)
    both = batch.to_device(both, dev)
    out = Filled(pool(not score_only), stats,
                 both[:B * DESC_W].view(B, DESC_W),
                 [ch.shape for ch in chunks], tb_base, pool(runs),
                 both[B * DESC_W:].view(torch.int32)[:B])
    return out, carry_floats


def fill_many_ref(table: torch.Tensor, chunks: Sequence[batch.Chunk], *,
                  mode: int, og: float, eg: float, score_only: bool = False,
                  runs: bool = False) -> Filled:
    """The plain version of :func:`fill_many`: :func:`fill_ref` (and with
    ``runs`` :func:`run_bytes_ref`) per chunk, on ``table``'s device, into
    the same pool layout."""
    dev = table.device
    table = table.to(torch.float32)
    out, _ = _alloc(chunks, table, score_only, runs)
    lo = 0
    for c, ch in enumerate(chunks):
        B = ch.shape[0]
        tbc, st = fill_ref(
            table, *(torch.from_numpy(a).to(dev) for a in ch), mode=mode,
            og=og, eg=eg, score_only=score_only)
        out.stats[lo:lo + B] = st
        if tbc is not None:
            out.tb_view(c).copy_(tbc)
        if runs:
            out.tb_view(c, out.run).copy_(run_bytes_ref(tbc))
        lo += B
    return out


def fill_many(table: torch.Tensor, chunks: Sequence[batch.Chunk], *,
              mode: int, og: float, eg: float, score_only: bool = False,
              runs: bool = False) -> Filled:
    """Fill every chunk of a flush on ``table``'s device; with ``runs``
    the match-run bytes too (``Filled.run``).

    CUDA: one launch of K1 (K10 with ``runs``) for each stripe depth
    (:func:`device_plan`, :func:`launch`; codes uploaded as two flat
    buffers, the per-pair descriptors as one (B, 8) array).  CPU: the plain
    version, :func:`fill_many_ref`.  Any other device raises."""
    dev = table.device
    if dev.type == "cpu":
        return fill_many_ref(table, chunks, mode=mode, og=og, eg=eg,
                             score_only=score_only, runs=runs)
    if dev.type != "cuda":
        raise ValueError(f"no fill for device {dev}")
    out, carry_floats = _alloc(chunks, table, score_only, runs)
    if out.desc.shape[0] == 0:
        return out
    codes1 = batch.to_device(np.concatenate(
        [ch.codes1.ravel() for ch in chunks]), dev)
    codes2 = batch.to_device(np.concatenate(
        [ch.codes2.ravel() for ch in chunks]), dev)
    carry = torch.empty(carry_floats, dtype=torch.float32, device=dev)
    pools = 0 if score_only else 2 if runs else 1
    plan = device_plan(chunks, pools, dev)
    launch(plan, table.to(torch.float32).contiguous(), codes1, codes2,
           out.desc, out.tb, carry, out.stats, mode=mode,
           traceback=not score_only, og=og, eg=eg, run=out.run)
    K = "K10" if runs else "K1"
    metrics.count("launch." + K, len(plan))
    metrics.count("cells.computed." + K, computed_cells(chunks, pools))
    return out


def device_plan(chunks: Sequence[batch.Chunk], pools: int,
                device: torch.device):
    """:func:`launch_plan` for the card ``device``, each launch's descriptor
    rows uploaded there (one copy): ``[(R, NW, order int32 tensor)]``."""
    plan = launch_plan(chunks, pools, torch.cuda.get_device_properties(
        device).multi_processor_count)
    order = batch.to_device(np.concatenate([o for *_, o in plan]), device)
    out, lo = [], 0
    for R, NW, rows in plan:
        out.append((R, NW, order[lo:lo + len(rows)]))
        lo += len(rows)
    return out


def launch(plan, table, codes1, codes2, desc, tb, carry, stats, *,
           mode: int, traceback: bool, og: float, eg: float,
           run=None) -> None:
    """Launch K1 (K10 with a ``run`` pool) on the current stream once for
    each ``(R, NW, order)`` of ``plan`` (:func:`device_plan`), given the
    pairs' buffers in :func:`layout`'s layout on the card."""
    from . import kernels

    for R, NW, order in plan:
        kernels.fill(table, codes1, codes2, desc, order, tb, carry, stats,
                     mode=mode, traceback=traceback, og=og, eg=eg, rows=R,
                     warps=NW, run=run)
