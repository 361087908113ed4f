"""The anti-diagonal (wavefront) LOCAL score-only fill: kernel K9's wrapper
and its plain PyTorch version.

Replaces ``smithwaterman_tpu/ops/diag_dp.py`` ``fill_diag_scores`` (the
skewed scores ``skew_scores`` and the Pallas kernel ``_diag_kernel``
through ``fill_diag_skewed``).  Each pair's columns are cut into strips of
``LANES`` columns; along a strip, step ``d`` holds in lane ``l`` the cell
``(d - l, c0 + l)``, so no cell of a step depends on another of the same
step, and the step rule (``csrc/sw_diag.cuh``, ``diag_dp.py:185-197``)
folds every gap open through ``W = max(M, X, Y)``.  The fold is
value-exact only under ``og <= eg <= 0``; the result is each pair's LOCAL
best score, the stats row ``[best, 0, ...]`` of a score-only fill without
the argmax.

On CUDA tensors :func:`fill_diag` launches K9 (``csrc/diag_fill.cu``, one
warp per pair, ``R`` columns a lane: a strip of ``LANES * R`` columns,
:func:`lane_cols` picks R) once over every chunk of a flush; on CPU
tensors it runs :func:`fill_diag_ref`.  Any other device raises.
``BatchAligner`` (``diag_scores=True``) sends a score-only flush here when
:func:`eligible` accepts it, and to K1 otherwise.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import LOCAL
from ..utils import metrics
from . import batch, fill_dp

LANES = 32  # lanes of a strip: one warp (csrc/sw_diag.cuh LANES)
LANE_COLS = (2, 4, 8)  # the R K9 is built for

# the last K9 launch's columns a lane (read by chip_smoke.py)
SHAPE = {"R": 0}


def lane_cols(MP: int) -> int:
    """K9's columns a lane R for a flush whose widest chunk has MP
    columns: the widest strip of ``LANES * R`` columns that the chunk
    fills, at least 2.  A wider strip takes a pair in fewer steps and
    pays each step's shuffles and feed once for R cells; past the pair's
    width its lanes only carry dead columns.  Each R wins where it is
    picked (``scripts/ab_diag.py``, PERF.md: 2 at 64 columns, 4 at 128, 8
    from 256); R = 1 beat R = 2 nowhere by more than the run-to-run
    spread, not even at 32 columns."""
    return max((R for R in LANE_COLS if LANES * R <= MP), default=2)


def computed_cells(chunks: Sequence[batch.Chunk], R: int) -> int:
    """The cells K9 computes over ``chunks`` at ``R`` columns a lane: each
    pair's rows times its columns rounded up to strips of ``LANES * R``."""
    w = LANES * R
    return sum(int(np.dot(ch.n.astype(np.int64),
                          -(-ch.m.astype(np.int64) // w) * w))
               for ch in chunks)


def eligible(*, mode: int, og: float, eg: float, score_only: bool,
             n: np.ndarray, m: np.ndarray) -> bool:
    """True when the wavefront fill may replace K1 for these pairs: a
    score-only LOCAL fill, every length at least 1 and ``og <= eg <= 0``
    (the semantic conditions of the JAX package's ``diag_dp.eligible``).
    Its 128-column alignment and tile conditions are the TPU's lane tiling:
    K9 masks any length itself, so the port drops them."""
    return (score_only and mode == LOCAL and og <= eg <= 0.0
            and bool(np.all(n >= 1)) and bool(np.all(m >= 1)))


def _check_penalties(og: float, eg: float) -> None:
    if not og <= eg <= 0.0:
        raise ValueError(
            f"the wavefront fill needs og <= eg <= 0, got og={og}, eg={eg}")


def fill_diag_ref(table: torch.Tensor, codes1: torch.Tensor,
                  codes2: torch.Tensor, n: torch.Tensor, m: torch.Tensor, *,
                  og: float, eg: float, lanes: int = LANES) -> torch.Tensor:
    """Plain PyTorch wavefront fill of one chunk (codes (B, NP), (B, MP),
    lengths (B,)) on the tensors' device: strip by strip, step by step,
    vectorised over pairs and the strip's ``lanes`` columns (K9's 32 by
    default; a wider strip takes fewer steps, and every value is the same,
    since the step rule does not depend on the width).  Returns stats
    (B, 8) f32."""
    _check_penalties(og, eg)
    dev = codes1.device
    B, NP = codes1.shape
    MP = codes2.shape[1]
    W = lanes
    steps = NP + W - 1
    table = table.to(torch.float32)
    c1 = codes1.to(torch.int64)
    c2 = codes2.to(torch.int64)
    lane = torch.arange(W, device=dev)
    # step d, lane l: row d - l; rows past NP clamp onto dead cells
    r = torch.arange(steps, device=dev)[:, None] - lane        # (steps, W)
    row_live = (r >= 0)[:, None, :] & \
        (r[:, None, :] < n.to(torch.int64)[None, :, None])     # (steps, B, W)
    z = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    bestl = torch.zeros((B, W), dtype=torch.float32, device=dev)
    # row r's (W, fx) of the previous strip's last column; 0 for the first
    edge_w = torch.zeros((NP, B, 1), dtype=torch.float32, device=dev)
    edge_x = torch.zeros_like(edge_w)
    for c0 in range(0, MP, W):
        cols = c0 + lane
        live = row_live & (cols < m.to(torch.int64)[:, None])[None]
        # every step's scores at once: (steps, B, W)
        code1 = c1[:, r.clamp(0, NP - 1)].permute(1, 0, 2)
        code2 = c2[:, cols.clamp(max=MP - 1)][None].expand_as(code1)
        S = table[code1, code2]
        w1 = torch.zeros((B, W), dtype=torch.float32, device=dev)
        x1, y1, wd = w1.clone(), w1.clone(), w1.clone()
        hist_w = torch.zeros((steps, B), dtype=torch.float32, device=dev)
        hist_x = torch.zeros_like(hist_w)
        for d in range(steps):
            t0 = torch.clamp_min(w1 + og, 0.0)
            xp = torch.maximum(t0, x1 + eg)
            first = d < NP
            x = torch.cat([edge_x[d] if first else z, xp[:, :-1]], 1)
            wl = torch.cat([edge_w[d] if first else z, w1[:, :-1]], 1)
            y = torch.maximum(t0, y1 + eg)
            mm = torch.clamp_min(wd + S[d], 0.0)
            w = torch.maximum(torch.maximum(mm, x), y)
            if d < W - 1:
                # rows r < 0: the LOCAL boundary
                top = (r[d] < 0)[None, :]
                w, x, y, mm = (torch.where(top, 0.0, v)
                               for v in (w, x, y, mm))
            bestl = torch.maximum(bestl, mm.masked_fill(~live[d], 0.0))
            hist_w[d] = w[:, -1]
            hist_x[d] = x[:, -1]
            w1, x1, y1, wd = w, x, y, wl
        # the last lane's rows 0..NP-1 sit at steps W-1 .. W+NP-2
        ew, ex = hist_w[W - 1:], hist_x[W - 1:]
        edge_w = ew[:, :, None]
        edge_x = torch.maximum(torch.clamp_min(ew + og, 0.0),
                               ex + eg)[:, :, None]
    stats = torch.zeros((B, fill_dp.STATS_W), dtype=torch.float32,
                        device=dev)
    stats[:, 0] = bestl.amax(1)
    return stats


def layout(chunks: Sequence[batch.Chunk]):
    """K9's per-pair descriptors: the fill's (``fill_dp.layout``: codes
    offsets, n, m), with ``D_CARRY`` the offset in floats of the pair's
    edge scratch (2 * NP floats).  Returns ``(desc, scratch_floats)``."""
    desc, *_ = fill_dp.layout(chunks)
    per = np.concatenate([np.full(ch.shape[0], 2 * ch.shape[1], np.int64)
                          for ch in chunks]) if chunks else \
        np.zeros(0, np.int64)
    desc[:, fill_dp.D_CARRY] = np.cumsum(per) - per
    return desc, int(per.sum())


def fill_diag(table: torch.Tensor, chunks: Sequence[batch.Chunk], *,
              og: float, eg: float) -> torch.Tensor:
    """The LOCAL best score of every pair of ``chunks`` on ``table``'s
    device: stats (B, 8) f32, ``[best, 0, ...]``, pairs in chunk order.

    CUDA: one launch of K9 over all pairs, :func:`lane_cols` columns a
    lane.  CPU: :func:`fill_diag_ref` per chunk.  Any other device raises;
    so does ``og <= eg <= 0`` failing."""
    _check_penalties(og, eg)
    dev = table.device
    fill_dp._validate(chunks, table.shape[0])
    if dev.type == "cpu":
        parts = [fill_diag_ref(table, *(torch.from_numpy(a) for a in ch),
                               og=og, eg=eg) for ch in chunks]
        return (torch.cat(parts) if parts
                else torch.zeros((0, fill_dp.STATS_W)))
    if dev.type != "cuda":
        raise ValueError(f"no wavefront fill for device {dev}")
    from . import kernels

    desc_np, scratch_floats = layout(chunks)
    B = desc_np.shape[0]
    stats = torch.empty((B, fill_dp.STATS_W), dtype=torch.float32,
                        device=dev)
    if B == 0:
        return stats
    codes1 = batch.to_device(np.concatenate(
        [ch.codes1.ravel() for ch in chunks]), dev)
    codes2 = batch.to_device(np.concatenate(
        [ch.codes2.ravel() for ch in chunks]), dev)
    scratch = torch.empty(max(scratch_floats, 1), dtype=torch.float32,
                          device=dev)
    R = lane_cols(max(ch.shape[2] for ch in chunks))
    kernels.diag_fill(table.to(torch.float32).contiguous(), codes1, codes2,
                      batch.to_device(desc_np, dev), scratch, stats,
                      og=og, eg=eg, R=R)
    metrics.count("launch.K9")
    metrics.count("cells.computed.K9", computed_cells(chunks, R))
    SHAPE["R"] = R
    return stats
