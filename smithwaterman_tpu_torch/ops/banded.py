"""Banded alignment: the DP restricted to a diagonal band of width W.

The counterpart of ``smithwaterman_tpu/ops/banded.py``, with the same
geometry, flags and results: the speed knob for long, similar sequences,
O(W) work per row.  Lane w of band row i is DP cell (i, off(i) + w + 1),
with monotone per-row offsets (:func:`band_offsets`); cells outside the
band are -inf, so a result equals the full DP when the optimal path (and
the gap runs feeding it) fits the band.  The walk flags a path pressed
against the band edge (``edge_touched``), :func:`align_banded_verified`
widens the band until two widths agree, and :class:`BandExceeded` is
raised only for a read outside the band (a corrupt fill).

A batch of up to :data:`TBP` pairs (one static W for all) runs as three
launches on the card:

1. :func:`banded_scores` (kernel K6, ``csrc/banded_scores.cu``): the band's
   substitution scores from the codes, (B, NP, W) f32, zero past seq2;
2. :func:`fill_banded` (kernel K7, ``csrc/banded_fill.cu``): the band's
   pointer bytes (B, NP, W) and the stats row per pair;
3. :func:`walk_banded_device` (kernel K8, ``csrc/banded_walk.cu``): every
   pair's walk on the device; only the (B, L) index arrays, the counts and
   the flags come back to the host.

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch version (``*_ref``) on CPU tensors; any other device raises.
:func:`walk_banded` is the host walk over one pair's band (the shared C++
walker first, then the Python loop), kept as an oracle independent of K8.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP, LOCAL
from ..config import GLOBAL, GLOCAL
from ..utils import metrics
from .batch import code_dtype
from .fill_dp import STATS_W

NEG = -1.0e30
BIGI = 2**30
TBP = 8  # pairs per batch: the JAX kernel's sublanes, kept as the API's cap

# the shape of K6's last launch (kernels.banded_scores: rows a tile,
# blocks, 16-byte stores), K7's (kernels.banded_fill: rows a lane,
# stripes, blocks) and K8's (rows a window, 0 for reads straight from the
# band), read by chip_smoke.py
SHAPES: dict = {}


class BandExceeded(RuntimeError):
    """The optimal path touched the band edge; rerun wider or unbanded."""


def band_offsets(n: int, m: int, W: int) -> np.ndarray:
    """Monotone per-row band offsets with steps in {0, 1}:
    off(i) ≈ i * (m - W) / n, clamped; requires W >= m - n."""
    if W >= m:
        return np.zeros(n + 1, np.int32)
    if W < m - n:
        raise ValueError(f"band {W} cannot reach column {m} with {n} rows")
    i = np.arange(n + 1, dtype=np.int64)
    off = (i * (m - W)) // max(n, 1)
    return np.clip(off, 0, m - W).astype(np.int32)


def row_offsets(n: torch.Tensor, m: torch.Tensor, W: int,
                rows: int) -> torch.Tensor:
    """(B, rows + 1) int64 offsets off(min(i, n)), i = 0 .. rows: the
    kernels' formula clip(min(i, n) * num // den, 0, num), num =
    max(m - W, 0), den = max(n, 1), which equals :func:`band_offsets` at
    min(W, m) for i <= n."""
    n64 = n.to(torch.int64)[:, None]
    num = (m.to(torch.int64)[:, None] - W).clamp(min=0)
    i = torch.arange(rows + 1, device=n.device)[None, :]
    off = torch.minimum(i, n64) * num // n64.clamp(min=1)
    return torch.minimum(off.clamp(min=0), num)


def _device(t: torch.Tensor) -> str:
    dev = t.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no banded path for device {t.device}")
    return dev


# ---------------------------------------------------------------- K6
def banded_scores_ref(table, codes1, codes2, n, m, *, W: int) -> torch.Tensor:
    """Plain version of :func:`banded_scores`: a gather at JAX's offsets,
    zero at columns past m (``_banded_scores``, ``banded.py:503-522``)."""
    B, NP = codes1.shape
    off = row_offsets(n, m, W, NP)[:, 1:]
    cols = off[:, :, None] + torch.arange(W, device=table.device)
    mm = m.to(torch.int64)[:, None, None]
    colc = torch.minimum(cols, (mm - 1).clamp(min=0))
    codes_w = torch.gather(codes2.to(torch.int64), 1,
                           colc.reshape(B, -1)).view(B, NP, W)
    S = table[codes1.to(torch.int64)[:, :, None], codes_w]
    return torch.where(cols >= mm, 0.0, S)


def banded_scores(table, codes1, codes2, n, m, *, W: int) -> torch.Tensor:
    """Band scores S (B, NP, W) f32 of B pairs: S[b, i-1, w] =
    table[codes1[b, i-1], codes2[b, off_b(i) + w]] where that column is
    below m_b, else 0.  ``codes1`` (B, NP) / ``codes2`` (B, MP) uint8 (int16
    past 255 symbols) and ``n``, ``m`` (B,) int32 on ``table``'s device.
    CUDA: one launch of K6, its shape in ``SHAPES["K6"]``.  CPU:
    :func:`banded_scores_ref`."""
    if _device(table) == "cpu":
        return banded_scores_ref(table, codes1, codes2, n, m, W=W)
    from . import kernels

    B, NP = codes1.shape
    S = torch.empty((B, NP, W), dtype=torch.float32, device=table.device)
    SHAPES["K6"] = kernels.banded_scores(table, codes1, codes2, n, m, S, W=W)
    metrics.count("launch.K6")
    return S


# ---------------------------------------------------------------- K7
def fill_banded_ref(S, n, m, *, mode: int, og: float, eg: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fill_banded`: JAX's row loop (``_kernel``,
    ``banded.py:117-280``) over (B, W) lanes, every pair in step, every
    row to NP.  The row constants are rounded as the JAX kernel rounds
    them (float32, the penalty sums in double first); the X prefix is
    ``cummax``, which equals JAX's doubling scan bit for bit because max is
    exact in any order."""
    B, NP, W = S.shape
    dev = S.device
    f32, i64 = torch.float32, torch.int64
    f = np.float32
    so, se = (og, eg) if mode == GLOBAL else (0.0, 0.0)
    dso = f(so - se)
    sent = f(10.0 * og + 10.0 * eg)
    nn = n.to(i64)[:, None]
    mm = m.to(i64)[:, None]
    offs = row_offsets(n, m, W, NP)
    lane = torch.arange(W, device=dev)[None, :]
    neg = torch.full((B, 1), NEG, dtype=f32, device=dev)
    # the X penalties as float32 tensors, so that every sum with them rounds
    # in float32 as the JAX kernel's does
    og_t = torch.full((B, 1), og, dtype=f32, device=dev)
    eg_t = torch.full((B, 1), eg, dtype=f32, device=dev)

    def sh_r(v, fill):
        return torch.cat([fill.expand(B, 1), v[:, :-1]], dim=1)

    def sh_l(v, fill):
        return torch.cat([v[:, 1:], fill.expand(B, 1)], dim=1)

    def col0(at, value):
        return torch.where(at, value, neg)

    lsc0 = (lane + 1).to(f32) * float(f(se)) + float(dso)
    cm = (lsc0 + float(sent)).expand(B, W).clone()
    cx = lsc0.expand(B, W).clone()
    cy = cm.clone()
    runbest = torch.full((B, W), NEG, dtype=f32, device=dev)
    runbest_i = torch.full((B, W), BIGI, dtype=i64, device=dev)
    stats = torch.zeros((B, STATS_W), dtype=f32, device=dev)
    tb = torch.empty((B, NP, W), dtype=torch.uint8, device=dev)
    for i in range(1, NP + 1):
        off = offs[:, i:i + 1]
        dlt1 = (off - offs[:, i - 1:i]) == 1
        jg = off + lane + 1
        # cells (i-1, 0) and (i, 0), as numpy float32 scalars
        lsc_im1 = f(i - 1) * f(se) + dso
        lsc_i = f(i) * f(se) + dso
        at_j0 = off == 0
        if i == 1:
            fills = (0.0, -1.0, -1.0)
        else:
            fills = (lsc_im1 + sent, lsc_im1 + sent, lsc_im1)
        fill_m, fill_x, fill_y = (col0(at_j0, float(v)) for v in fills)
        d1m = torch.where(dlt1, cm, sh_r(cm, fill_m))
        d1x = torch.where(dlt1, cx, sh_r(cx, fill_x))
        d1y = torch.where(dlt1, cy, sh_r(cy, fill_y))
        upm = torch.where(dlt1, sh_l(cm, neg), cm)
        upx = torch.where(dlt1, sh_l(cx, neg), cx)
        upy = torch.where(dlt1, sh_l(cy, neg), cy)

        val_m = torch.maximum(torch.maximum(d1m, d1x), d1y) + S[:, i - 1]
        prev_m = torch.where(d1m >= d1x, torch.where(d1m >= d1y, 0, 2),
                             torch.where(d1x >= d1y, 1, 2))
        if mode == GLOCAL:
            last_col = jg == mm
            qo = torch.where(last_col, so, og)
            qe = torch.where(last_col, se, eg)
        else:
            qo, qe = og, eg
        if mode == LOCAL:
            c1 = upm + og >= upy + eg
            c2 = upm > upx
            c3 = upy + eg > upx + og
            val_y = torch.where(c1, torch.where(c2, upm + og, upx + og),
                                torch.where(c3, upy + eg, upx + og))
        else:
            c1 = upm + qo > upy + qe
            c2 = upm >= upx
            c3 = upy + qe >= upx + qo
            val_y = torch.maximum(torch.maximum(upm + qo, upy + qe),
                                  upx + qo)
        prev_y = torch.where(c1, torch.where(c2, 0, 1),
                             torch.where(c3, 2, 1))
        if mode == LOCAL:
            val_m = val_m.clamp(min=0.0)
            val_y = val_y.clamp(min=0.0)

        if mode == GLOCAL:  # the last row's gaps are free
            po = torch.where(nn == i, so, og).to(f32)
            pe = torch.where(nn == i, se, eg).to(f32)
        else:
            po, pe = og_t, eg_t
        x0b = float(lsc_i + sent)
        g0 = col0(at_j0, float(lsc_i) + po)
        gline = torch.maximum(val_m, val_y) + po
        t_pe = (jg.to(f32) - 1.0) * pe
        h = sh_r(gline, g0) - t_pe
        h = torch.where(jg == 1, torch.maximum(h, x0b + pe), h)
        c = torch.cummax(h, dim=1).values.clamp(min=NEG)
        val_x = c + t_pe
        if mode == LOCAL:
            val_x = val_x.clamp(min=0.0)

        Mm1 = sh_r(val_m, col0(at_j0, x0b))
        Xm1 = sh_r(val_x, col0(at_j0, x0b))
        Ym1 = sh_r(val_y, col0(at_j0, float(lsc_i)))
        if mode == LOCAL:
            e1 = Mm1 + og >= Xm1 + eg
            e2 = Mm1 > Ym1
            e3 = Xm1 + eg > Ym1 + og
        else:
            e1 = Mm1 + po > Xm1 + pe
            e2 = Mm1 >= Ym1
            e3 = Xm1 + pe >= Ym1 + po
        prev_x = torch.where(e1, torch.where(e2, 0, 2),
                             torch.where(e3, 1, 2))
        if mode == LOCAL:
            prev_m = torch.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = torch.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = torch.where(val_y == 0.0, CELL_STOP, prev_y)
        tb[:, i - 1] = (prev_m | (prev_x << 2) | (prev_y << 4)).to(torch.uint8)

        if mode == LOCAL:
            masked = torch.where((jg <= mm) & (nn >= i), val_m, NEG)
            upd = masked > runbest
            runbest = torch.where(upd, masked, runbest)
            runbest_i = torch.where(upd, i, runbest_i)
        else:
            take = (nn == i) & (jg == mm)
            fin = torch.stack([torch.where(take, v, 0.0).sum(dim=1)
                               for v in (val_m, val_x, val_y)], dim=1)
            stats[:, 3:6] = torch.where(take.any(dim=1, keepdim=True), fin,
                                        stats[:, 3:6])
        cm, cx, cy = val_m, val_x, val_y

    if mode == LOCAL:
        gmax = runbest.max(dim=1, keepdim=True).values
        cand = runbest == gmax
        min_i = torch.where(cand, runbest_i, BIGI).min(dim=1,
                                                       keepdim=True).values
        cw = torch.where(cand & (runbest_i == min_i), lane, BIGI)
        stats[:, 0] = gmax[:, 0]
        stats[:, 1] = min_i[:, 0].to(f32)
        stats[:, 2] = cw.min(dim=1).values.to(f32)
    return tb, stats


def fill_banded(S, n, m, *, mode: int, og: float, eg: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The banded fill of B pairs from their band scores S (B, NP, W) f32
    (:func:`banded_scores`), ``n``, ``m`` (B,) int32 on S's device, W a
    multiple of 4.  Returns ``tb`` (B, NP, W) uint8, the pointer byte of
    lane w of row i at ``tb[b, i-1, w]`` (defined for i <= n), and
    ``stats`` (B, 8) f32: LOCAL ``[best, best_i, best_lane, 0, ...]``,
    otherwise ``[0, 0, 0, finalM, finalX, finalY, 0, 0]``.  CUDA: one
    launch of K7 (stripes of 64 rows, which leaves the rows past n
    unwritten), with a scratch whose tickets and counts are
    zeroed on the launch's stream; the launch's shape goes to
    ``SHAPES["K7"]``.  CPU: :func:`fill_banded_ref`."""
    if _device(S) == "cpu":
        return fill_banded_ref(S, n, m, mode=mode, og=og, eg=eg)
    from . import kernels

    B, NP, W = S.shape
    scratch = torch.empty(kernels.banded_scratch_words(B, NP, W),
                          dtype=torch.int32, device=S.device)
    scratch[:kernels.banded_scratch_zeroed(B, NP)].zero_()
    tb = torch.empty((B, NP, W), dtype=torch.uint8, device=S.device)
    stats = torch.empty((B, STATS_W), dtype=torch.float32, device=S.device)
    SHAPES["K7"] = kernels.banded_fill(S, n, m, scratch, tb, stats,
                                       mode=mode, og=og, eg=eg)
    metrics.count("launch.K7")
    return tb, stats


# ---------------------------------------------------------------- K8
Walked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def walk_banded_ref(tb, off, start, m, *, local: bool, L: int) -> Walked:
    """Plain version of :func:`walk_banded_device`: JAX's lockstep loop
    (``_walk_banded_device``, ``banded.py:435-500``) as tensor operations,
    one iteration per step, while a pair is active and at most L + 4
    steps (whether any pair is active is read every 32 steps: a step of
    inactive pairs changes nothing).  A walk never leaves 0 <= i <= n,
    0 <= j <= m, which the index arithmetic below relies on."""
    B, NP, W = tb.shape
    dev = tb.device
    i64 = torch.int64
    flat = tb.reshape(-1)
    bidx = torch.arange(B, device=dev)
    base = bidx * (NP * W)
    i, j, s = (start[:, q].to(i64) for q in range(3))
    active = start[:, 3] != 0
    offl = off.to(i64)
    mm = m.to(i64)
    cnt = torch.zeros(B, dtype=i64, device=dev)
    flags = torch.zeros(B, dtype=i64, device=dev)
    idx = torch.full((B, 2, L), -2, dtype=torch.int32, device=dev)
    for it in range(L + 4):
        if it % 32 == 0 and not bool(active.any()):
            break
        i0, j0 = i == 0, j == 0
        s = torch.where(j0 & ~i0, CELL_GAPINY,
                        torch.where(i0 & ~j0, CELL_GAPINX, s))
        in_mat = ~(i0 | j0)
        w = j - 1 - offl[bidx, i]
        exceeded = active & in_mat & ((w < 0) | (w >= W))
        edge = in_mat & (((w == 0) & (j > 1)) | ((w == W - 1) & (j < mm)))
        byte = flat[base + (i - 1).clamp(min=0) * W + w.clamp(0, W - 1)]
        bnd = torch.where(i0 & j0, CELL_MATCH,
                          torch.where(i0, CELL_GAPINX, CELL_GAPINY))
        if local:
            bnd = torch.where(bnd == s, CELL_STOP, bnd)
        prev = torch.where(in_mat, (byte.to(i64) >> (2 * s)) & 3, bnd)
        ok = active & ~exceeded
        do = ok & (prev != CELL_STOP) if local else ok
        flags = flags | (ok & edge) | (exceeded.to(i64) << 1)
        gx, gy = s == CELL_GAPINX, s == CELL_GAPINY
        e = torch.stack([torch.where(gx, -1, i - 1),
                         torch.where(gy, -1, j - 1)], dim=1).to(torch.int32)
        wr = cnt.clamp(max=L - 1)
        idx[bidx, :, wr] = torch.where(do[:, None], e, idx[bidx, :, wr])
        i = i - (do & ~gx).to(i64)
        j = j - (do & ~gy).to(i64)
        cnt = cnt + do
        active = do & ~((i == 0) & (j == 0))
        s = torch.where(active, prev, s)
    flags = flags | (active.to(i64) << 1)
    return (idx[:, 0].contiguous(), idx[:, 1].contiguous(),
            cnt.to(torch.int32), flags.to(torch.int32))


def walk_banded_device(tb, off, start, m, *, local: bool, L: int) -> Walked:
    """Walk every pair of a banded batch on the device.  ``tb`` (B, NP, W)
    uint8 from :func:`fill_banded`, ``off`` (B, NP + 1) int32 offsets,
    ``start`` (B, 4) int32 ``{i, j, state, active}``, ``m`` (B,) int32.
    Returns ``idx1, idx2`` (B, L) int32 in walk (reverse path) order, -1
    for a gap and -2 where nothing was written, ``cnt`` (B,) int32 and
    ``flags`` (B,) int32: bit 0 ``edge_touched``, bit 1 band exceeded (the
    caller raises :class:`BandExceeded`).  CUDA: one launch of K8.  CPU:
    :func:`walk_banded_ref`."""
    if _device(tb) == "cpu":
        return walk_banded_ref(tb, off, start, m, local=local, L=L)
    from . import kernels

    B = tb.shape[0]
    dev = tb.device
    idx1, idx2 = (torch.empty((B, L), dtype=torch.int32, device=dev)
                  for _ in range(2))
    cnt, flags = (torch.empty((B,), dtype=torch.int32, device=dev)
                  for _ in range(2))
    kernels.banded_walk(tb, off, start, m, idx1, idx2, cnt, flags,
                        local=local, L=L)
    metrics.count("launch.K8")
    SHAPES["K8"] = {"rows": kernels.banded_walk_rows(tb.shape[2])}
    return idx1, idx2, cnt, flags


def random_band(rng: np.random.Generator, W: int, local: bool):
    """Synthetic inputs for checks of the band walk (the tests and
    ``chip_smoke.py``): eight pairs (m - n at most 8) with random pointer
    bytes (mostly diagonal moves, every state's pointer drawn on its own)
    in a band of W bytes a row, their offsets and walk starts: from (n, m)
    and, when ``local``, from inside the band in every other pair.  Lanes
    past the widest pair's m, which no walk reads, hold zeros.  Returns
    ``(tb, off, start, m, L)`` numpy."""
    ns = [300, 257, 90, 1, 40, 310, 64, 200]
    ms = [305, 250, 95, 3, 46, 300, 64, 205]
    B, NP = len(ns), -(-max(ns) // 8) * 8
    offs = np.zeros((B, NP + 1), np.int32)
    start = np.zeros((B, 4), np.int32)
    for b, (n, m) in enumerate(zip(ns, ms)):
        off = band_offsets(n, m, min(W, m))
        offs[b, :n + 1] = off
        offs[b, n + 1:] = off[-1]
        if local and b % 2:
            i = n // 2 + 1
            start[b] = (i, off[i] + min(W, m) // 2 + 1, 0, 1)
        else:
            start[b] = (n, m, b % 3, 1)
    tb = np.zeros((B, NP, W), np.uint8)
    w = min(W, max(ms))
    for f in range(3):
        tb[:, :, :w] |= (rng.choice(4, size=(B, NP, w),
                                    p=[0.7, 0.12, 0.12, 0.06])
                         << (2 * f)).astype(np.uint8)
    L = -(-(max(ns) + max(ms) + 2) // 1024) * 1024
    return tb, offs, start, np.asarray(ms, np.int32), L


def walk_banded(tb: np.ndarray, off: np.ndarray, si: int, sj: int,
                state: int, local: bool, W: int, m: int
                ) -> Tuple[List[int], List[int], bool]:
    """Host pointer walk over one pair's (NP, W) band ``tb``.  Raises
    BandExceeded if the path reads outside the band (corrupt fill); also
    returns ``edge_touched``, True when the path visited a band-edge lane
    at a cell where out-of-band alternatives exist, i.e. the band may have
    constrained the result.  The shared C++ walker runs first; the Python
    loop below reports what it gives up on."""
    from . import traceback as traceback_ops

    native = traceback_ops.native_walk_banded(tb, off, si, sj, state, local,
                                              W, m)
    if native == ("exceeded",):
        raise BandExceeded(f"path left band starting at ({si},{sj})")
    if native is not None:
        return native

    r1: List[int] = []
    r2: List[int] = []
    edge_touched = False
    i, j, s = int(si), int(sj), int(state)
    while True:
        s = traceback_ops.normalize_boundary_state(i, j, s)
        if i >= 1 and j >= 1:
            w = j - 1 - int(off[i])
            if w < 0 or w >= W:
                raise BandExceeded(f"path left band at ({i},{j})")
            if (w == 0 and j > 1) or (w == W - 1 and j < m):
                edge_touched = True
            prev = (int(tb[i - 1, w]) >> (2 * s)) & 3
        else:
            prev = traceback_ops._boundary_prev(i, j, s, local)
        if local and prev == CELL_STOP:
            break
        if s == CELL_MATCH:
            r1.append(i - 1)
            r2.append(j - 1)
            i -= 1
            j -= 1
        elif s == CELL_GAPINX:
            r1.append(-1)
            r2.append(j - 1)
            j -= 1
        elif s == CELL_GAPINY:
            r1.append(i - 1)
            r2.append(-1)
            i -= 1
        else:
            raise RuntimeError(f"invalid state {s} at ({i},{j})")
        if i == 0 and j == 0:
            break
        s = prev
    r1.reverse()
    r2.reverse()
    return r1, r2, edge_touched


# ---------------------------------------------------------------- batch
@dataclass
class Packed:
    """A batch laid out for the kernels (:func:`pack`)."""

    codes1: np.ndarray  # (B, NP) uint8 (int16 past 255 symbols), NP = max
    #                     n rounded up to 8
    codes2: np.ndarray  # (B, max m), codes1's dtype
    n: np.ndarray       # (B,) int32
    m: np.ndarray       # (B,) int32
    offs: np.ndarray    # (B, NP + 1) int32 band offsets, past n the last one
    W: int              # the batch's band width


def pack(pairs, band: int, K: int) -> Packed:
    """Lay out up to TBP pairs ``(codes1, codes2)`` (codes below ``K``)
    for one banded run, with JAX's geometry (``banded.py:675-708``): one W
    for the batch, ``band`` rounded up to a multiple of 128 and to at least
    max(m - n) + 128, capped at max(m) rounded up; NP = max(n) rounded up
    to 8."""
    count = len(pairs)
    if not 1 <= count <= TBP:
        raise ValueError(f"a banded batch holds 1 to {TBP} pairs, got {count}")
    ns = [len(c1) for c1, _ in pairs]
    ms = [len(c2) for _, c2 in pairs]
    if min(ns) < 1 or min(ms) < 1:
        raise ValueError("banded alignment needs non-empty sequences")
    W = -(-max(band, max(m - n for n, m in zip(ns, ms)) + 128) // 128) * 128
    if W >= max(ms):
        W = -(-max(ms) // 128) * 128
    NP = -(-max(ns) // 8) * 8
    ctype = code_dtype(K)
    pk = Packed(np.zeros((count, NP), ctype),
                np.zeros((count, max(ms)), ctype),
                np.asarray(ns, np.int32), np.asarray(ms, np.int32),
                np.zeros((count, NP + 1), np.int32), W)
    for k, (codes1, codes2) in enumerate(pairs):
        n, m = ns[k], ms[k]
        if n * max(m - W, 0) >= 2**31:
            raise ValueError("banded offsets exceed int32 range; reduce sizes")
        for c in (codes1, codes2):
            c = np.asarray(c)
            if c.min() < 0 or c.max() >= K:
                raise ValueError(f"codes must lie below the table's {K} "
                                 "symbols")
        pk.codes1[k, :n] = codes1
        pk.codes2[k, :m] = codes2
        off = band_offsets(n, m, min(W, m))
        # rows beyond n keep the last offset (they never affect results)
        pk.offs[k, :n + 1] = off
        pk.offs[k, n + 1:] = off[-1]
        assert (np.diff(pk.offs[k]) <= 1).all(), "band slope must be <= 1"
    return pk


def walk_starts(stats: np.ndarray, pk: Packed, mode: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Each pair's walk start (B, 4) int32 ``{i, j, state, active}`` and
    score (B,) float64 from the fill's stats rows (``banded.py:749-770``):
    LOCAL at the best cell in M, inactive when best <= 0; otherwise at
    (n, m) in the first maximum of the final (M, X, Y)."""
    count = len(pk.n)
    start = np.zeros((count, 4), np.int32)
    score = np.zeros(count, np.float64)
    for k in range(count):
        if mode == LOCAL:
            score[k] = float(stats[k, 0])
            if score[k] <= 0.0:
                continue
            si = int(stats[k, 1])
            start[k] = (si, int(pk.offs[k, si]) + int(stats[k, 2]) + 1,
                        CELL_MATCH, 1)
        else:
            s0 = int(np.argmax(stats[k, 3:6]))
            score[k] = float(stats[k, 3 + s0])
            start[k] = (pk.n[k], pk.m[k], s0, 1)
    return start, score


def path_len(pk: Packed) -> int:
    """The walk's capacity L: max n + max m + 2, rounded up to 1024 so
    few shapes recur across batches."""
    return -(-(int(pk.n.max()) + int(pk.m.max()) + 2) // 1024) * 1024


def align_banded_batch(
    pairs,
    table,
    *,
    mode: int,
    og: float,
    eg: float,
    band: int,
    device=None,
    timings: Optional[dict] = None,
):
    """Banded alignment of up to TBP pairs ``(codes1, codes2)`` in one
    launch of each kernel, with one W for the batch: ``band`` rounded up to
    a multiple of 128 and to at least max(m - n) + 128, capped at max(m)
    rounded up.  Runs on ``device`` (default: the card, see
    ``aligner.resolve_device``).  Returns a list of (idx1, idx2, score,
    edge_touched) per pair; raises :class:`BandExceeded` when a walk left
    the band.

    ``edge_touched`` True means the in-band-optimal path pressed against
    the band edge, so the result may differ from the full DP: widen the
    band or fall back to the exact fill.

    ``timings``: pass a dict to record per-stage wall seconds (the card is
    synchronised between stages, so the run itself is slower; diagnosis
    only, see :func:`phase_probe`)."""
    from ..aligner import resolve_device

    dev = resolve_device(device)

    def _tick(key):
        if timings is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.time()
        timings[key] = round(timings.get(key, 0.0) + now - _tick.t0, 4)
        _tick.t0 = now

    _tick.t0 = time.time()
    tab = torch.as_tensor(np.asarray(table, np.float32)).to(dev).contiguous()
    pk = pack(pairs, band, tab.shape[0])
    count, W = len(pk.n), pk.W
    _tick("host_prep_s")

    t1, t2, tn, tm = (torch.from_numpy(a).to(dev)
                      for a in (pk.codes1, pk.codes2, pk.n, pk.m))
    S = banded_scores(tab, t1, t2, tn, tm, W=W)
    _tick("scores_s")
    tb, stats = fill_banded(S, tn, tm, mode=mode, og=og, eg=eg)
    del S
    _tick("fill_s")
    stats_np = stats.cpu().numpy()
    _tick("stats_fetch_s")

    # start cell and state per pair (host-side: tiny), then one device
    # walk for the whole batch: the pointer band never leaves the device
    start, score = walk_starts(stats_np, pk, mode)
    L = path_len(pk)
    i1, i2, cnt, flags = walk_banded_device(
        tb, torch.from_numpy(pk.offs).to(dev), torch.from_numpy(start).to(dev),
        tm, local=mode == LOCAL, L=L)
    _tick("walk_s")
    i1, i2, cnt, flags = (a.cpu().numpy() for a in (i1, i2, cnt, flags))
    _tick("idx_fetch_s")

    results = []
    for k in range(count):
        if not start[k, 3]:
            results.append(([], [], 0.0, False))
            continue
        if flags[k] & 2:
            raise BandExceeded(
                f"path left band starting at ({start[k, 0]},{start[k, 1]})")
        c = int(cnt[k])
        results.append((i1[k, :c][::-1].tolist(), i2[k, :c][::-1].tolist(),
                        float(score[k]), bool(flags[k] & 1)))
    _tick("host_build_s")
    return results


def phase_probe(codes1, codes2, table, *, mode: int, og: float, eg: float,
                band: int, device=None) -> dict:
    """Warm per-stage wall split of one banded single-pair alignment: a
    first call builds and warms, then a second call on content-fresh codes
    is timed with the card synchronised at each stage boundary, so the
    stages are attributed but the probed total exceeds the warm wall."""
    codes1 = np.asarray(codes1, np.int32)
    codes2 = np.asarray(codes2, np.int32)
    align_banded(codes1, codes2, table, mode=mode, og=og, eg=eg, band=band,
                 device=device)
    K = np.asarray(table).shape[0]
    c1 = codes1.copy()
    c1[:8] = (c1[:8] + 1) % K
    t: dict = {}
    t0 = time.time()
    align_banded_batch([(c1, codes2)], table, mode=mode, og=og, eg=eg,
                       band=band, device=device, timings=t)
    t["probed_total_s"] = round(time.time() - t0, 3)
    return t


def align_banded(codes1, codes2, table, *, mode: int, og: float, eg: float,
                 band: int, device=None):
    """Banded alignment of ONE pair (a batch of one, see
    :func:`align_banded_batch`).  Returns (idx1, idx2, score,
    edge_touched)."""
    return align_banded_batch(
        [(np.asarray(codes1, np.int32), np.asarray(codes2, np.int32))],
        table, mode=mode, og=og, eg=eg, band=band, device=device,
    )[0]


def align_banded_verified(codes1, codes2, table, *, mode: int, og: float,
                          eg: float, band: int,
                          max_band: Optional[int] = None, device=None):
    """Double-band verification: run at W and 2W and accept when the scores
    agree (a band-constrained optimum almost surely improves when the band
    doubles); otherwise keep widening until agreement or the band covers
    the matrix (then the result is the exact full DP).  Returns (idx1,
    idx2, score, band_used).

    Acceptance is on score agreement alone: ``band_offsets`` anchors the
    band's slack linearly, so a full-span near-diagonal path necessarily
    grazes lane 0 near the top corner and lane W-1 near the bottom one,
    and ``edge_touched`` cannot be required to clear."""
    m = len(codes2)
    cap = max_band or m
    W = band
    kw = dict(mode=mode, og=og, eg=eg, device=device)
    prev = align_banded(codes1, codes2, table, band=W, **kw)
    while W < cap and W < m:
        W2 = min(2 * W, max(cap, W + 1))
        cur = align_banded(codes1, codes2, table, band=W2, **kw)
        if cur[2] == prev[2]:
            return cur[0], cur[1], cur[2], W2
        prev = cur
        W = W2
    return prev[0], prev[1], prev[2], W
