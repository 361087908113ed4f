"""The long-sequence route: checkpointed fill, band refill, segment walk.

The counterpart of ``smithwaterman_tpu/ops/longseq.py``
(``align_long_packed``).  A pair whose pointer matrix would not fit the
device (``ops/batch.plan_flushes``) is aligned in two passes that keep
only O(n/C * m) floats and O(C * m) pointer bytes:

1. :func:`fill_checkpointed` (kernel K3): a score-only fill that keeps the
   (M, X, Y) row after every C-th row (checkpoint k holds the row after
   global row (k+1)*C) and the stats row, with the LOCAL argmax;
2. per group of G bands, top group first, :func:`fill_bands` (kernel K4)
   refills bands sk0 .. sk0+G-1 (band sk: rows sk*C+1 .. sk*C+C) of every
   pair with rows there, each seeded from checkpoint sk-1 (row 0's closed
   form for sk == 0), in one launch; then :func:`walk_segments` (kernel
   K5) steps each pair's walk through the group's bands, top band first,
   in one launch.  The walk state (i, j, state, done) and the move count
   stay on the device between groups.  G (:func:`group_bands`) is as many bands
   as fit :data:`REFILL_BYTES` a pair and the pointer budget
   (``batch.tb_budget``) beside the chunk's checkpoints.

The refill replays the same cell rules from the same carries, so the
pointer bytes, and with them the path, are those of the single-pass fill.
The output is ``walk_bundle_pooled``'s packed contract (``ops/device_walk``)
except that a non-LOCAL walk follows the boundary down to (0, 0), as the
JAX route's does; ``ops/reconstruct.reconstruct_packed`` takes both.

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version (``*_ref``) on CPU tensors; any other device raises.
``C`` is the card's own choice (:data:`DEFAULT_CKPT_ROWS`: K3 fills a band
with one warp of C / 32 rows a lane, K4 with C / 32 warps of one row a
lane); the results do not depend on it, only the checkpoint arrays do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import (CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP,
                      GLOBAL, LOCAL)
from ..utils import metrics
from . import batch
from .device_walk import _walk_starts
from .fill_dp import STATS_W
from .scan_dp import fill as scan_fill

# rows per band and per checkpoint
DEFAULT_CKPT_ROWS = 256
# device bytes a pair's refilled bands may take together at most: K4
# refills as many bands of every pair in one launch (a block a band) as fit
# this and the pointer budget
REFILL_BYTES = 320 << 20

Ckpts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def n_ckpts(NP: int, C: int) -> int:
    """Bands (and checkpoint rows) of an NP-row bucket."""
    return -(-NP // C)


def band_bytes(C: int, MP: int) -> int:
    """Pointer bytes of one pair's band (``csrc/sw_band.cuh``)."""
    return (C + MP) * C


def ckpt_bytes(NP: int, MP: int, C: int = DEFAULT_CKPT_ROWS) -> int:
    """Device bytes of one pair's checkpoints (three f32 rows a band)."""
    return 12 * n_ckpts(NP, C) * MP


def pair_bytes(NP: int, MP: int, C: int = DEFAULT_CKPT_ROWS) -> int:
    """The least device bytes the route holds per pair: checkpoints and one
    refilled band (``batch.plan_flushes`` sizes a chunk's pairs by it)."""
    return ckpt_bytes(NP, MP, C) + band_bytes(C, MP)


def group_bands(B: int, NP: int, MP: int, budget: int,
                C: int = DEFAULT_CKPT_ROWS) -> int:
    """Bands one K4 launch refills per pair of a B-pair chunk: as many as
    fit :data:`REFILL_BYTES` a pair and, beside the checkpoints, ``budget``
    device bytes for the chunk; at least one, at most the bucket's.  The
    route then stays inside ``budget`` whenever B * :func:`pair_bytes`
    does."""
    bb = band_bytes(C, MP)
    room = (budget // max(B, 1) - ckpt_bytes(NP, MP, C)) // bb
    return max(1, min(n_ckpts(NP, C), REFILL_BYTES // bb, room))


def band_buffer_bytes(B: int, NP: int, MP: int,
                      C: int = DEFAULT_CKPT_ROWS) -> int:
    """Device bytes of the refilled bands :func:`align_long_packed` holds
    for a B-pair chunk: :func:`group_bands` bands of every pair."""
    return group_bands(B, NP, MP, batch.tb_budget(), C) * B * band_bytes(C, MP)


def band_cells(n: np.ndarray, m: np.ndarray, C: int, lo: int = 0,
               hi: Optional[int] = None) -> int:
    """The cells K3 (bands ``lo`` ..) or K4 (bands ``lo`` .. ``hi - 1``)
    computes for pairs of lengths ``n``, ``m``: C rows of each band the
    pair has rows in, times its columns."""
    bands = -(-n.astype(np.int64) // C)
    rows = np.clip(bands if hi is None else np.minimum(bands, hi), lo,
                   None) - lo
    return int(np.dot(rows * C, m))


def band_view(band: torch.Tensor, C: int, MP: int) -> torch.Tensor:
    """The skewed band buffer (B, (C + MP) * C) as (B, C, MP): element
    [b, r, c] is the pointer byte of cell (sk*C + r + 1, c + 1)."""
    B = band.shape[0]
    return band.as_strided((B, C, MP), (band.stride(0), C + 1, C),
                           band.storage_offset())


def row0_carries(B: int, mp: int, mode: int, og: float, eg: float
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form boundary-row carries (j = 1..mp), matching the fill's
    un-seeded start (rs:100-108)."""
    so, se = (og, eg) if mode == GLOBAL else (0.0, 0.0)
    sent = 10.0 * og + 10.0 * eg
    jf1 = np.arange(1, mp + 1, dtype=np.float32)
    lsc = jf1 * se + (so - se)
    m0 = np.broadcast_to(lsc + sent, (B, mp)).astype(np.float32)
    x0 = np.broadcast_to(lsc, (B, mp)).astype(np.float32)
    y0 = np.broadcast_to(lsc + sent, (B, mp)).astype(np.float32)
    return m0.copy(), x0.copy(), y0.copy()


# walk_band's status: path complete, walked off the top of the band, or off
# the left edge of the column window
WALK_DONE = 0
WALK_UP = 1
WALK_LEFT = 2


def walk_band(tb_band: np.ndarray, i_top: int, j_off: int, i: int, j: int,
              s: int, local: bool):
    """Walk within one band window on the host: ``tb_band[r, c]`` (C,
    width) uint8 holds DP cell (i_top + r + 1, j_off + c + 1), ``i_top``
    the global row above the band.  Returns (idx1_chunk, idx2_chunk, i, j,
    s, status), the chunks in walk (reverse-path) order with global 0-based
    indices (-1 a gap), status :data:`WALK_DONE`, :data:`WALK_UP` or
    :data:`WALK_LEFT` (the JAX ``walk_band`` contract).  The shared C++
    walker ``sw_walk_band`` (``ops/traceback.native_walk_band``)."""
    from .traceback import native_walk_band

    return native_walk_band(tb_band, i_top, j_off, i, j, s, local)


def _device(table: torch.Tensor) -> str:
    dev = table.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no long-sequence route for device {table.device}")
    return dev


# ---------------------------------------------------------------- K3
def fill_checkpointed_ref(table, codes1, codes2, n, m, *, mode: int,
                          og: float, eg: float, C: int
                          ) -> Tuple[torch.Tensor, Ckpts]:
    """Plain version of :func:`fill_checkpointed`: ``scan_dp.fill`` one
    band of C rows at a time, each seeded with the last one's carries."""
    dev = table.device
    B, NP = codes1.shape
    MP = codes2.shape[1]
    nck = n_ckpts(NP, C)
    ck = tuple(torch.zeros((B, nck, MP), dtype=torch.float32, device=dev)
               for _ in range(3))
    n64 = n.to(torch.int64)
    best = torch.full((B,), -3.0e38, dtype=torch.float32, device=dev)
    best_i = torch.zeros((B,), dtype=torch.int64, device=dev)
    best_j = torch.zeros((B,), dtype=torch.int64, device=dev)
    final = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    seed = None
    for kb in range(nck):
        lo = kb * C
        S = batch.scores(table, codes1[:, lo:lo + C], codes2)
        r = scan_fill(S, n, m, og, eg, mode, with_traceback=False, i0=lo,
                      seed=seed)
        seed = r.carry
        if lo + C <= NP:
            for a, v in zip(ck, seed):
                a[:, kb] = v
        # bands run in row order, so a strict `>` keeps the first maximum
        up = r.best > best
        best = torch.where(up, r.best, best)
        best_i = torch.where(up, r.best_i.to(torch.int64), best_i)
        best_j = torch.where(up, r.best_j.to(torch.int64), best_j)
        here = ((n64 > lo) & (n64 <= lo + C))[:, None]
        final = torch.where(here, r.final, final)
    stats = torch.zeros((B, STATS_W), dtype=torch.float32, device=dev)
    if mode == LOCAL:
        stats[:, 0] = best
        stats[:, 1] = best_i.to(torch.float32)
        stats[:, 2] = best_j.to(torch.float32)
    else:
        stats[:, 3:6] = final
    return stats, ck


def fill_checkpointed(table, codes1, codes2, n, m, *, mode: int, og: float,
                      eg: float, C: int) -> Tuple[torch.Tensor, Ckpts]:
    """Score-only fill of B pairs that keeps every C-th row.

    ``codes1`` (B, NP) / ``codes2`` (B, MP) uint8 (int16 for tables past
    255 symbols) and ``n``, ``m`` (B,) int32 on ``table``'s device.
    Returns ``stats`` (B, 8) f32 (LOCAL
    ``[best, best_i, best_j, 0...]``, else ``[0, 0, 0, finalM, finalX,
    finalY, 0, 0]``) and the checkpoints ``(ckm, ckx, cky)``, each
    (B, ceil(NP/C), MP) f32: row k is the (M, X, Y) row after global row
    (k+1)*C, defined at columns < m for (k+1)*C <= n.  CUDA: one launch
    of K3, with a zeroed scratch for its tickets, the bands' published
    checkpoint tiles and their LOCAL bests.  CPU:
    :func:`fill_checkpointed_ref`."""
    if _device(table) == "cpu":
        return fill_checkpointed_ref(table, codes1, codes2, n, m, mode=mode,
                                     og=og, eg=eg, C=C)
    from . import kernels

    dev = table.device
    B, NP = codes1.shape
    MP = codes2.shape[1]
    nck = n_ckpts(NP, C)
    ck = tuple(torch.empty((B, nck, MP), dtype=torch.float32, device=dev)
               for _ in range(3))
    stats = torch.empty((B, STATS_W), dtype=torch.float32, device=dev)
    scratch = torch.zeros(kernels.ckpt_scratch_words(B, nck),
                          dtype=torch.int32, device=dev)
    kernels.ckpt_fill(table, codes1, codes2, n, m, *ck, stats, scratch,
                      mode=mode, C=C, og=og, eg=eg)
    metrics.count("launch.K3")
    return stats, ck


# ---------------------------------------------------------------- K4
def fill_band_ref(table, codes1, codes2, n, m, ck: Ckpts, band, *, sk: int,
                  mode: int, og: float, eg: float, C: int) -> None:
    """Plain version of :func:`fill_band`: ``scan_dp.fill`` over the band's
    rows from its seed (:func:`row0_carries` for band 0)."""
    B, NP = codes1.shape
    MP = codes2.shape[1]
    lo = sk * C
    S = batch.scores(table, codes1[:, lo:lo + C], codes2)
    if sk == 0:
        seed = tuple(torch.from_numpy(a).to(table.device)
                     for a in row0_carries(B, MP, mode, og, eg))
    else:
        seed = tuple(a[:, sk - 1] for a in ck)
    r = scan_fill(S, n, m, og, eg, mode, with_traceback=True, i0=lo,
                  seed=seed)
    rows = S.shape[1]
    band_view(band, C, MP)[:, :rows].copy_(r.tb[:, 1:, 1:])


def fill_bands_ref(table, codes1, codes2, n, m, ck: Ckpts, bands, *,
                   sk0: int, mode: int, og: float, eg: float, C: int) -> None:
    """Plain version of :func:`fill_bands`: :func:`fill_band_ref` for each
    band of the group."""
    for g in range(bands.shape[0]):
        fill_band_ref(table, codes1, codes2, n, m, ck, bands[g], sk=sk0 + g,
                      mode=mode, og=og, eg=eg, C=C)


def fill_bands(table, codes1, codes2, n, m, ck: Ckpts, bands, *, sk0: int,
               mode: int, og: float, eg: float, C: int) -> None:
    """Refill bands sk0 .. sk0 + G - 1 of every pair into ``bands``
    (G, B, (C + MP) * C) uint8, band sk0 + g at ``bands[g]``
    (:func:`band_view` reads each): the pointer bytes of the single-pass
    fill inside each pair's [:n, :m].  CUDA: one launch of K4, a block a
    band.  CPU: :func:`fill_bands_ref`."""
    if _device(table) == "cpu":
        fill_bands_ref(table, codes1, codes2, n, m, ck, bands, sk0=sk0,
                       mode=mode, og=og, eg=eg, C=C)
        return
    from . import kernels

    kernels.band_fill(table, codes1, codes2, n, m, *ck, bands, mode=mode,
                      C=C, sk0=sk0, og=og, eg=eg)
    metrics.count("launch.K4")


def fill_band(table, codes1, codes2, n, m, ck: Ckpts, band, *, sk: int,
              mode: int, og: float, eg: float, C: int) -> None:
    """Refill band ``sk`` (rows sk*C+1 .. sk*C+C) of every pair into
    ``band`` (B, (C + MP) * C) uint8: :func:`fill_bands` with one band."""
    fill_bands(table, codes1, codes2, n, m, ck, band[None], sk0=sk, mode=mode,
               og=og, eg=eg, C=C)


# ---------------------------------------------------------------- K5
def walk_start(stats: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
               mode: int) -> torch.Tensor:
    """The walk state (B, 4) int32 ``{i, j, state, done}`` at the path's
    end cell (``device_walk._walk_starts``)."""
    i, j, s, done = _walk_starts(stats, n, m, mode)
    return torch.stack([i, j, s, done.to(torch.int64)],
                       dim=1).to(torch.int32).contiguous()


def walk_segment_ref(band, walk, cnt, moves, *, sk: int, C: int, MP: int,
                     L: int, local: bool) -> None:
    """Plain version of :func:`walk_segment`: the JAX loop body
    (``longseq.py:359-388``) as tensor operations, one iteration per
    lockstep step, until no pair is active or L + 8 steps (whether any pair
    is active is read every 32 steps: a step of inactive pairs changes
    nothing)."""
    dev = band.device
    B = walk.shape[0]
    base = sk * C
    bidx = torch.arange(B, device=dev)
    flat = band.view(-1)
    stride = band.stride(0)
    i, j, s = (walk[:, q].to(torch.int64) for q in range(3))
    done = walk[:, 3] != 0
    c = cnt.to(torch.int64)
    L4 = moves.shape[0]

    def active(i, j, done):
        return ~done & ((i > base) | (i == 0) | (j == 0))

    act = active(i, j, done)
    for it in range(L + 8):
        if it % 32 == 0 and not bool(act.any()):
            break
        s = torch.where((j == 0) & (i > 0), CELL_GAPINY,
                        torch.where((i == 0) & (j > 0), CELL_GAPINX, s))
        interior = (i >= 1) & (j >= 1)
        r = (i - 1 - base).clamp(0, C - 1)
        col = (j - 1).clamp(0, MP - 1)
        ptr = flat[bidx * stride + (r + col) * C + r].to(torch.int64)
        prev_in = (ptr >> (2 * s)) & 3
        bstate = torch.where((i == 0) & (j == 0), CELL_MATCH,
                             torch.where(i == 0, CELL_GAPINX, CELL_GAPINY))
        if local:
            bstate = torch.where(s == bstate, CELL_STOP, bstate)
        prev = torch.where(interior, prev_in, bstate)
        stop = (prev == CELL_STOP) if local else torch.zeros_like(done)
        emit = act & ~stop
        # one byte per pair, OR-ed with zero where the pair emits nothing
        row = (c >> 2).clamp(max=L4 - 1)
        bits = torch.where(emit & ((c >> 2) < L4), s << (2 * (c & 3)), 0)
        moves[row, bidx] |= bits.to(torch.uint8)
        ni = torch.where(emit & (s != CELL_GAPINX), i - 1, i)
        nj = torch.where(emit & (s != CELL_GAPINY), j - 1, j)
        s = torch.where(emit, prev, s)
        done = done | (act & stop) | (emit & (ni == 0) & (nj == 0))
        c = c + emit.to(torch.int64)
        i, j = ni, nj
        act = active(i, j, done)
    walk.copy_(torch.stack([i, j, s, done.to(torch.int64)], dim=1))
    cnt.copy_(c)


def walk_segments_ref(bands, walk, cnt, moves, *, sk0: int, C: int, MP: int,
                      L: int, local: bool) -> None:
    """Plain version of :func:`walk_segments`: :func:`walk_segment_ref`
    for each band of the group, top band first."""
    for g in range(bands.shape[0] - 1, -1, -1):
        walk_segment_ref(bands[g], walk, cnt, moves, sk=sk0 + g, C=C, MP=MP,
                         L=L, local=local)


def walk_segments(bands, walk, cnt, moves, *, sk0: int, C: int, MP: int,
                  L: int, local: bool) -> None:
    """Step every pair's walk through bands sk0 + G - 1 .. sk0 of the group
    ``bands`` (G, B, (C + MP) * C) uint8 from :func:`fill_bands` (band
    sk0 + g at [g]), top band first, in place: ``walk`` (B, 4) and ``cnt``
    (B,) int32, ``moves`` (ceil(L/4), B) uint8 packed as
    ``ops/device_walk``'s (zeroed before the first group).  CUDA: one
    launch of K5, C a multiple of 32.  CPU: :func:`walk_segments_ref`."""
    if bands.device.type == "cpu":
        walk_segments_ref(bands, walk, cnt, moves, sk0=sk0, C=C, MP=MP, L=L,
                          local=local)
        return
    if bands.device.type != "cuda":
        raise ValueError(f"no segment walk for device {bands.device}")
    from . import kernels

    kernels.seg_walk(bands, walk, cnt, moves, local=local, C=C, sk0=sk0,
                     MP=MP, L=L)
    metrics.count("launch.K5")


def walk_segment(band, walk, cnt, moves, *, sk: int, C: int, MP: int, L: int,
                 local: bool) -> None:
    """Step every pair's walk through band ``sk`` (``band`` (B, (C + MP) *
    C) from :func:`fill_band`): :func:`walk_segments` with one band."""
    walk_segments(band[None], walk, cnt, moves, sk0=sk, C=C, MP=MP, L=L,
                  local=local)


# ---------------------------------------------------------------- route
def align_long_packed(table: torch.Tensor, chunk: batch.Chunk, *, mode: int,
                      og: float, eg: float, ckpt_rows: Optional[int] = None):
    """Checkpointed fill and on-device segment walks for one bucket chunk.

    ``chunk``: padded codes (B, NP) / (B, MP) and true lengths, host numpy
    (``ops/batch.Chunk``).  Runs on ``table``'s device and returns device
    tensors ``(stats (B, 8) f32, cnt (B,) int32, moves (ceil(L/4), B)
    uint8)`` with ``L = NP + MP + 2``: the JAX ``align_long_packed``
    contract, for ``ops/reconstruct.reconstruct_packed``.  One K3 launch,
    then one K4 launch per group of :func:`group_bands` bands (at the
    pointer budget ``batch.tb_budget``), each followed by one K5 launch
    that walks the group's bands.  On a card each launch counts the cells
    it computes (``cells.computed.K3`` / ``.K4``)."""
    dev = table.device
    card = _device(table) == "cuda"
    C = ckpt_rows or DEFAULT_CKPT_ROWS
    table = table.to(torch.float32).contiguous()
    B, NP, MP = chunk.shape
    L = NP + MP + 2
    args = dict(mode=mode, og=og, eg=eg, C=C)
    with metrics.span("ckpt"):
        codes1, codes2, n, m = (
            batch.to_device(np.ascontiguousarray(a), dev) for a in chunk)
        stats, ck = fill_checkpointed(table, codes1, codes2, n, m, **args)
        if card:
            metrics.count("cells.computed.K3",
                          band_cells(chunk.n, chunk.m, C))
    walk = walk_start(stats, n, m, mode)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    moves = torch.zeros((-(-L // 4), B), dtype=torch.uint8, device=dev)
    G = group_bands(B, NP, MP, batch.tb_budget(), C)
    bands = torch.empty((G, B, band_bytes(C, MP)), dtype=torch.uint8,
                        device=dev)
    for top in range(n_ckpts(NP, C) - 1, -1, -G):
        sk0 = max(0, top - G + 1)
        group = bands[:top - sk0 + 1]
        with metrics.span("group", bands=top - sk0 + 1,
                          rows=min((top + 1) * C, NP) - sk0 * C):
            fill_bands(table, codes1, codes2, n, m, ck, group, sk0=sk0,
                       **args)
            if card:
                metrics.count("cells.computed.K4", band_cells(
                    chunk.n, chunk.m, C, sk0, top + 1))
            walk_segments(group, walk, cnt, moves, sk0=sk0, C=C, MP=MP, L=L,
                          local=mode == LOCAL)
    return stats, cnt, moves
