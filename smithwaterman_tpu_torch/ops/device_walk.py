"""The traceback walk on the device: kernel K2's wrapper and its plain
PyTorch version.

Replaces ``smithwaterman_tpu/ops/device_walk.py`` ``walk_bundle_pooled``,
a ``lax.while_loop`` that walks every pair of many bucket-chunks in
lockstep.  The pointer bytes never leave the device; what comes back is
two bits per step:

* ``cnt`` (B,) int32, the number of moves of each pair;
* ``moves`` (ceil(L/4), B) uint8: move ``t`` of pair ``k`` is
  ``(moves[t >> 2, k] >> ((t & 3) * 2)) & 3``, valid for ``t < cnt[k]``,
  in walk order (``t = 0`` is the path's END cell); every other bit is 0.

That is ``walk_bundle_pooled``'s exact contract, which
``csrc/reconstruct.cpp`` consumes unchanged.  Non-LOCAL walks stop at the
first boundary cell; the rebuild synthesizes the terminal-gap tail.

On CUDA tensors :func:`walk_packed` launches K2 (``csrc/walk.cu``) once
per flush: a warp a pair, walking it from tiles of its pointer bytes that
the lanes copy into shared memory ahead of the walk (``csrc/sw_walk.cuh``
Tiles, :data:`TILES` rows x columns), the pairs started in the fill's
``order`` (the longest n + m first); on CPU tensors it runs
:func:`walk_packed_ref`, a lockstep loop of tensor operations that
mirrors ``device_walk.py:281-311``.

The token walk (:func:`walk_tokens`) replaces ``walk_bundle_pooled_tokens``
(``device_walk.py:322``): over the fill's pointer pool and its match-run
bytes (``fill_dp.fill_many(runs=True)``) a pair in state M jumps up to 16
diagonal cells a step, and each step emits one token byte, state in bits
0-1 and the extra steps ``e`` in bits 2-5:

* ``cnt`` (B,) int32, the number of tokens of each pair;
* ``toks`` (L, B) uint8: token ``t`` of pair ``k`` at ``toks[t, k]`` for
  ``t < cnt[k]``, in walk order; every other byte is 0.

On CUDA tensors it launches K11 (``csrc/token_walk.cu``, K2's design over
both pools) once per flush; on CPU tensors it runs :func:`walk_tokens_ref`, mirroring
``device_walk.py:392-432``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP, LOCAL
from ..utils import metrics
from .fill_dp import D_CS, D_M, D_N, D_RS, D_TB

# K2's and K11's tiles (csrc/sw_walk.cuh Tiles), by the pools a walk reads:
# two slots a pair of T rows x C columns of its block, of each pool.
# Measured on an H100 (PERF.md: T x C from 16 x 48 to 64 x 128), K2
# is fastest at 32 x 64, within a few per cent of 24 x 64 and 64 x 64; K11,
# with its two pools, at 16 x 48, which halves its shared memory a pair.
TILES = {1: (32, 64), 2: (16, 48)}


def max_path_len(np_pad: int, mp_pad: int) -> int:
    """Walk-buffer row count for a bucket: the longest possible path."""
    return np_pad + mp_pad + 2


def _walk_starts(stats: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                mode: int):
    """Per-pair start cell, start state and already-done mask
    (``device_walk._walk_starts``): LOCAL starts at the argmax in M and a
    pair with best <= 0 is done at once; otherwise the walk starts at
    (n, m) in the first maximum of the final (M, X, Y)."""
    B = stats.shape[0]
    dev = stats.device
    if mode == LOCAL:
        done0 = stats[:, 0] <= 0.0
        i0 = torch.where(done0, 0, stats[:, 1].to(torch.int64))
        j0 = torch.where(done0, 0, stats[:, 2].to(torch.int64))
        s0 = torch.full((B,), CELL_MATCH, dtype=torch.int64, device=dev)
    else:
        i0 = n.to(torch.int64)
        j0 = m.to(torch.int64)
        s0 = torch.argmax(stats[:, 3:6], dim=1)   # first max
        done0 = torch.zeros((B,), dtype=torch.bool, device=dev)
    return i0, j0, s0, done0


def walk_packed_ref(tb: torch.Tensor, desc: torch.Tensor,
                    stats: torch.Tensor, *, mode: int, L: int):
    """Plain lockstep walk of every pair on the tensors' device: one
    iteration of tensor operations per step, as the JAX loop body."""
    dev = tb.device
    B = desc.shape[0]
    local = mode == LOCAL
    base, cs, rs = desc[:, D_TB], desc[:, D_CS], desc[:, D_RS]
    i, j, s, done = _walk_starts(stats, desc[:, D_N], desc[:, D_M], mode)
    Lp = -(-L // 4) * 4
    out = torch.zeros((Lp, B), dtype=torch.int64, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    step = 0
    while step < L and not bool(done.all()):
        # normalize_boundary_state (ops/traceback.py)
        s = torch.where((j == 0) & (i > 0), CELL_GAPINY,
                        torch.where((i == 0) & (j > 0), CELL_GAPINX, s))
        interior = (i >= 1) & (j >= 1)
        off = base + (i - 1).clamp_min(0) * rs + (j - 1).clamp_min(0) * cs
        ptr = tb[off].to(torch.int64)
        prev_in = (ptr >> (2 * s)) & 3
        # _boundary_prev closed form
        bstate = torch.where((i == 0) & (j == 0), CELL_MATCH,
                             torch.where(i == 0, CELL_GAPINX, CELL_GAPINY))
        if local:
            bstate = torch.where(s == bstate, CELL_STOP, bstate)
        prev = torch.where(interior, prev_in, bstate)
        stop = (prev == CELL_STOP) if local else torch.zeros_like(done)
        emit = ~done & ~stop
        ni = torch.where(emit & (s != CELL_GAPINX), i - 1, i)
        nj = torch.where(emit & (s != CELL_GAPINY), j - 1, j)
        out[step] = torch.where(emit, s, 0)
        cnt += emit.to(torch.int32)
        # boundary short-circuit: the terminal-gap tail is synthesized by
        # the rebuild
        done = done | stop | (ni == 0) | (nj == 0)
        s = torch.where(emit, prev, s)
        i, j = ni, nj
        step += 1
    r = out.view(Lp // 4, 4, B)
    moves = r[:, 0] | (r[:, 1] << 2) | (r[:, 2] << 4) | (r[:, 3] << 6)
    return cnt, moves.to(torch.uint8)


def walk_packed(tb: torch.Tensor, desc: torch.Tensor, stats: torch.Tensor,
                *, mode: int, L: int, order: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Walk every pair of a fill (``fill_dp.Filled``'s tb pool, desc,
    stats and ``order``, the pairs in the order the kernel starts them).
    CUDA: one launch of K2 at :data:`TILES`' tiles.  CPU:
    :func:`walk_packed_ref`, which walks every pair at once (no order).
    Any other device raises."""
    dev = tb.device
    if dev.type == "cpu":
        return walk_packed_ref(tb, desc, stats, mode=mode, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no walk for device {dev}")
    from . import kernels

    B = desc.shape[0]
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    moves = torch.zeros((-(-L // 4), B), dtype=torch.uint8, device=dev)
    if B == 0:
        return cnt, moves
    T, C = TILES[1]
    kernels.walk(tb, desc, stats, cnt, moves, local=mode == LOCAL, L=L,
                 order=order, T=T, C=C)
    metrics.count("launch.K2")
    return cnt, moves


def walk_tokens_ref(tb: torch.Tensor, run: torch.Tensor, desc: torch.Tensor,
                    stats: torch.Tensor, *, mode: int, L: int):
    """Plain lockstep token walk of every pair on the tensors' device: one
    iteration of tensor operations per step, as the JAX loop body."""
    dev = tb.device
    B = desc.shape[0]
    local = mode == LOCAL
    base, cs, rs = desc[:, D_TB], desc[:, D_CS], desc[:, D_RS]
    i, j, s, done = _walk_starts(stats, desc[:, D_N], desc[:, D_M], mode)
    out = torch.zeros((L, B), dtype=torch.uint8, device=dev)
    cnt = torch.zeros((B,), dtype=torch.int32, device=dev)
    step = 0
    while step < L and not bool(done.all()):
        s = torch.where((j == 0) & (i > 0), CELL_GAPINY,
                        torch.where((i == 0) & (j > 0), CELL_GAPINX, s))
        interior = (i >= 1) & (j >= 1)
        off = base + (i - 1).clamp_min(0) * rs + (j - 1).clamp_min(0) * cs
        ptr = tb[off].to(torch.int64)
        rb = run[off].to(torch.int64)
        prev_in = (ptr >> (2 * s)) & 3
        bstate = torch.where((i == 0) & (j == 0), CELL_MATCH,
                             torch.where(i == 0, CELL_GAPINX, CELL_GAPINY))
        if local:
            bstate = torch.where(s == bstate, CELL_STOP, bstate)
        prev = torch.where(interior, prev_in, bstate)
        is_m = (s == CELL_MATCH) & interior
        e = torch.where(is_m, rb & 15, 0)
        xs = (rb >> 4) & 3
        if local:
            # the reserved (15, STOP) marker: landing there in state M ends
            # the path without emission
            marker = ((rb & 15) == 15) & (xs == CELL_STOP)
            stop = torch.where(is_m, marker, prev == CELL_STOP)
        else:
            stop = torch.zeros_like(done)
        emit = ~done & ~stop
        e = torch.where(stop, 0, e)
        adv = 1 + e
        ni = torch.where(emit & (s != CELL_GAPINX), i - adv, i)
        nj = torch.where(emit & (s != CELL_GAPINY), j - adv, j)
        ns = torch.where(emit, torch.where(is_m, xs, prev), s)
        out[step] = torch.where(emit, s | (e << 2), 0).to(torch.uint8)
        cnt += emit.to(torch.int32)
        done = done | stop | (ni == 0) | (nj == 0)
        if local:
            done = done | (ns == CELL_STOP)
        i, j, s = ni, nj, ns
        step += 1
    return cnt, out


def walk_tokens(tb: torch.Tensor, run: torch.Tensor, desc: torch.Tensor,
                stats: torch.Tensor, *, mode: int, L: int,
                order: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-walk every pair of a fill with run bytes (``fill_dp.Filled``'s
    tb and run pools, desc, stats and ``order``).  CUDA: one launch of K11
    at :data:`TILES`' tiles for two pools.  CPU: :func:`walk_tokens_ref`.
    Any other device raises."""
    dev = tb.device
    if dev.type == "cpu":
        return walk_tokens_ref(tb, run, desc, stats, mode=mode, L=L)
    if dev.type != "cuda":
        raise ValueError(f"no token walk for device {dev}")
    from . import kernels

    B = desc.shape[0]
    cnt = torch.empty((B,), dtype=torch.int32, device=dev)
    toks = torch.zeros((L, B), dtype=torch.uint8, device=dev)
    if B == 0:
        return cnt, toks
    T, C = TILES[2]
    kernels.walk_tokens(tb, run, desc, stats, cnt, toks, local=mode == LOCAL,
                        L=L, order=order, T=T, C=C)
    metrics.count("launch.K11")
    return cnt, toks


def unpack_moves(mv_col: np.ndarray, c: int) -> np.ndarray:
    """(L4,) packed byte column -> (c,) uint8 states, walk order."""
    b = mv_col[: (c + 3) // 4]
    s = np.empty(b.shape[0] * 4, np.uint8)
    s[0::4] = b & 3
    s[1::4] = (b >> 2) & 3
    s[2::4] = (b >> 4) & 3
    s[3::4] = (b >> 6) & 3
    return s[:c]


def tokens_to_states(tok_col: np.ndarray, c: int) -> np.ndarray:
    """(L,) token byte column -> expanded per-step uint8 states, walk
    order (the numpy counterpart of csrc sw_reconstruct_tokens's
    expansion)."""
    t = np.asarray(tok_col[:c], np.int64)
    return np.repeat((t & 3).astype(np.uint8), 1 + (t >> 2))


def moves_to_path(moves: np.ndarray, cnt: np.ndarray, i0: int, j0: int,
                  k: int):
    """Replay pair ``k``'s packed move column into left-to-right aligned
    index lists (the numpy counterpart of csrc/reconstruct.cpp)."""
    c = int(cnt[k])
    if c == 0:
        return [], []
    return _states_to_path(
        np.asarray(unpack_moves(moves[:, k], c), np.int64), i0, j0)


def tokens_to_path(toks: np.ndarray, cnt: np.ndarray, i0: int, j0: int,
                   k: int):
    """Like :func:`moves_to_path` for token streams (one byte a token,
    state bits 0-1, extra MATCH steps bits 2-5)."""
    c = int(cnt[k])
    if c == 0:
        return [], []
    return _states_to_path(
        np.asarray(tokens_to_states(toks[:, k], c), np.int64), i0, j0)


def _states_to_path(s: np.ndarray, i0: int, j0: int):
    """Walk-order per-step states -> left-to-right aligned index lists."""
    di = (s != CELL_GAPINX).astype(np.int64)
    dj = (s != CELL_GAPINY).astype(np.int64)
    ib = i0 - np.concatenate([[0], np.cumsum(di[:-1])])
    jb = j0 - np.concatenate([[0], np.cumsum(dj[:-1])])
    r1 = np.where(s == CELL_GAPINX, -1, ib - 1)
    r2 = np.where(s == CELL_GAPINY, -1, jb - 1)
    return r1[::-1].tolist(), r2[::-1].tolist()
