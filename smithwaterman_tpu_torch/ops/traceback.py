"""Host-side traceback from packed predecessor pointers.

The counterpart of ``smithwaterman_tpu/ops/traceback.py``: the single-pair
``Aligner`` walks the full pointer matrix of ``scan_dp.fill`` (boundary row
and column included) on the host, through the shared C++ walker
``csrc/traceback.cpp``; the tests also use it as an oracle independent of
the device walk, :func:`native_walk_banded` walks one pair's band of
pointers (``ops/banded.walk_banded``) and :func:`native_walk_band` one
pair's window of a striped band (``ops/longseq.walk_band``).  Pointer bytes: prev-state of M in
bits 0-1, of X in bits 2-3, of Y in bits 4-5 (3 = LOCAL "score is zero,
stop here").

Loop semantics parity: sequence_alignment.rs:349-386.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..config import CELL_GAPINX, CELL_GAPINY, CELL_MATCH, CELL_STOP
from . import native


def _boundary_prev(i: int, j: int, s: int, local: bool) -> int:
    """Closed-form predecessor pointers on the DP boundary (row 0 / col 0):
    the origin points to M, row 0 left (X), column 0 up (Y); LOCAL marks
    the state matching the boundary STOP (its score is 0)."""
    if i == 0 and j == 0:
        return CELL_STOP if (local and s == CELL_MATCH) else CELL_MATCH
    if i == 0:
        return CELL_STOP if (local and s == CELL_GAPINX) else CELL_GAPINX
    return CELL_STOP if (local and s == CELL_GAPINY) else CELL_GAPINY


def normalize_boundary_state(i: int, j: int, s: int) -> int:
    """Defined behavior where the reference has none: with og == eg == 0
    the boundary sentinel is 0, so the `>=` extend tie rules can route the
    walk into state X at column 0 (or Y at row 0), where the reference
    crashes (sequence_alignment.rs:368-370).  Any state on a boundary
    continues along that boundary's gap chain, which at the only
    reachable penalty point (og = eg = 0) scores identically."""
    if j == 0 and i > 0 and s != CELL_GAPINY:
        return CELL_GAPINY
    if i == 0 and j > 0 and s != CELL_GAPINX:
        return CELL_GAPINX
    return s


def walk_py(tb: np.ndarray, si: int, sj: int, state: int,
            local: bool) -> Tuple[List[int], List[int]]:
    """The exact Python walk over a full (boundary-inclusive) matrix."""
    r1: List[int] = []
    r2: List[int] = []
    i, j, s = int(si), int(sj), int(state)
    while True:
        s = normalize_boundary_state(i, j, s)
        prev = (int(tb[i, j]) >> (2 * s)) & 3
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
            raise RuntimeError(f"invalid traceback state {s} at ({i},{j})")
        if i == 0 and j == 0:
            break
        s = prev
    r1.reverse()
    r2.reverse()
    return r1, r2


def walk(tb: np.ndarray, si: int, sj: int, state: int,
         local: bool) -> Tuple[List[int], List[int]]:
    """Walk packed pointers of a full (npad+1, mpad+1) matrix from
    (si, sj, state) with the native walker; returns aligned index lists
    (-1 = gap), left to right."""
    lib = native.host_lib()
    cap = int(si + sj + 2)
    o1 = np.empty(cap, dtype=np.int64)
    o2 = np.empty(cap, dtype=np.int64)
    tbc = np.ascontiguousarray(tb, dtype=np.uint8)
    count = lib.sw_traceback(
        tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), tbc.shape[1],
        si, sj, state, 1 if local else 0,
        o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if count < 0:
        raise RuntimeError(f"corrupt pointer matrix (walk status {count})")
    return o1[:count][::-1].tolist(), o2[:count][::-1].tolist()


def native_walk_banded(tb: np.ndarray, off: np.ndarray, si: int, sj: int,
                       state: int, local: bool, W: int, m: int):
    """Walk one pair's (NP, W) band of pointer bytes from (si, sj, state)
    with the shared C++ walker ``sw_walk_banded``; ``off`` holds the
    (NP + 1) band offsets.  Returns (idx1, idx2, edge_touched) with
    ``ops/banded.walk_banded``'s contract, ``("exceeded",)`` when the path
    leaves the band, or None when the walker gives up (out of capacity or
    a corrupt pointer) and the Python walk should report it."""
    tbc = np.ascontiguousarray(tb, dtype=np.uint8)
    offc = np.ascontiguousarray(off, dtype=np.int32)
    if (tbc.ndim != 2 or tbc.shape[1] != W or not 0 <= si <= tbc.shape[0]
            or offc.shape != (tbc.shape[0] + 1,)):
        raise ValueError(f"band {tbc.shape} and offsets {offc.shape} do not "
                         f"fit W={W} and start row {si}")
    lib = native.host_lib()
    cap = int(si + sj + 2)
    o1 = np.empty(cap, dtype=np.int64)
    o2 = np.empty(cap, dtype=np.int64)
    edge = np.zeros(1, dtype=np.int64)
    count = lib.sw_walk_banded(
        tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), W,
        offc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        si, sj, state, 1 if local else 0, m,
        o1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        o2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        edge.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if count == -2:
        return ("exceeded",)
    if count < 0:
        return None
    return o1[:count][::-1].tolist(), o2[:count][::-1].tolist(), bool(edge[0])


def native_walk_band(tb_band: np.ndarray, i_top: int, j_off: int, i: int,
                     j: int, s: int, local: bool):
    """Walk one pair's (C, width) window of band pointer bytes from
    (i, j, s) with the shared C++ walker ``sw_walk_band``; ``tb_band[r, c]``
    holds DP cell (i_top + r + 1, j_off + c + 1).  Returns (idx1_chunk,
    idx2_chunk, i, j, s, status) with ``ops/longseq.walk_band``'s contract:
    chunks in walk (reverse-path) order, status ``WALK_DONE`` /
    ``WALK_UP`` / ``WALK_LEFT``.  Raises ``RuntimeError`` when the walker
    fails (out of capacity or a corrupt pointer); there is no Python walk
    to fall back to."""
    tbc = np.ascontiguousarray(tb_band, dtype=np.uint8)
    if tbc.ndim != 2:
        raise ValueError(f"band window must be 2-D, got {tbc.shape}")
    lib = native.host_lib()
    cap = int(i + j + 2)
    o1 = np.empty(cap, dtype=np.int64)
    o2 = np.empty(cap, dtype=np.int64)
    ijs = np.array([i, j, s], dtype=np.int64)
    status = np.zeros(1, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_int64)
    count = lib.sw_walk_band(
        tbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), tbc.shape[1],
        int(i_top), int(j_off), ijs.ctypes.data_as(p64), 1 if local else 0,
        o1.ctypes.data_as(p64), o2.ctypes.data_as(p64), cap,
        status.ctypes.data_as(p64),
    )
    if count < 0:
        raise RuntimeError(f"band walk failed (status {count}) from "
                           f"({i}, {j}, {s})")
    return (o1[:count].tolist(), o2[:count].tolist(), int(ijs[0]),
            int(ijs[1]), int(ijs[2]), int(status[0]))
