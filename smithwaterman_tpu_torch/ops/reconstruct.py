"""Bulk host reconstruction from packed device-walk move streams.

The counterpart of ``smithwaterman_tpu/ops/reconstruct.py``: the device
walk ships one 2-bit-packed move array per flush, and the shared native
rebuild ``csrc/reconstruct.cpp`` (``sw_reconstruct_moves``) replays every
pair's stream straight into its alignment strings; the token walk ships
one byte a token, which ``sw_reconstruct_tokens`` expands the same way
(``tokens=True``).  String and span
semantics are ``aligner.reconstruct_alignment``'s (parity:
sequence_alignment.rs:469-551); :func:`reconstruct_packed_py` is the exact
Python path the tests hold the native one against.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Sequence

import numpy as np

from ..config import LOCAL
from . import device_walk, native

_RETAIN_WARNING = "The glocal or global mode will retain all letters.\n"


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def reconstruct_packed(
    seq1s: Sequence[str],
    seq2s: Sequence[str],
    moves: np.ndarray,
    cnt: np.ndarray,
    i0: np.ndarray,
    j0: np.ndarray,
    scores: np.ndarray,
    mode: int,
    retain_all: bool,
    col0: int = 0,
    tokens: bool = False,
) -> List:
    """Replay packed move streams into AlignResults, natively.

    ``moves`` is the (n_rows, B) packed byte array whose columns ``col0 ..
    col0+count`` belong to these pairs (count = len(seq1s)); cnt, i0, j0
    and scores are per pair (>= count entries).  ``tokens=True`` reads
    ``moves`` as a token stream (``device_walk.walk_tokens``: one byte a
    token, ``cnt`` counting tokens).  Raises on a stream the rebuild
    rejects (a corrupt walk)."""
    from ..aligner import AlignResult

    count = len(seq1s)
    if mode != LOCAL and not retain_all:
        # parity: reconstruct_alignment warns once per pair (rs:497-499)
        sys.stderr.write(_RETAIN_WARNING * count)
        retain_all = True
    if count == 0:
        return []
    lib = native.host_lib()
    moves = np.ascontiguousarray(moves, np.uint8)
    n_rows, B = moves.shape
    if col0 + count > B:
        raise ValueError(f"columns {col0}..{col0 + count} past {B}")
    cnt32 = np.ascontiguousarray(cnt[:count], np.int32)
    i032 = np.ascontiguousarray(i0[:count], np.int32)
    j032 = np.ascontiguousarray(j0[:count], np.int32)
    try:
        b1 = [s.encode("latin-1") for s in seq1s]
        b2 = [s.encode("latin-1") for s in seq2s]
    except UnicodeEncodeError:
        # letters past Latin-1 (a table's symbols may be any characters):
        # the native rebuild copies bytes, so take the exact Python path
        return reconstruct_packed_py(seq1s, seq2s, moves, cnt, i0, j0,
                                     scores, mode, retain_all, col0, tokens)
    off1 = np.zeros(count + 1, np.int64)
    off2 = np.zeros(count + 1, np.int64)
    np.cumsum([len(s) for s in b1], out=off1[1:])
    np.cumsum([len(s) for s in b2], out=off2[1:])
    seq1 = np.frombuffer(b"".join(b1) or b"\0", np.uint8)
    seq2 = np.frombuffer(b"".join(b2) or b"\0", np.uint8)
    lens = off1[1:] - off1[:-1] + off2[1:] - off2[:-1]
    outoff = np.zeros(count + 1, np.int64)
    np.cumsum(lens, out=outoff[1:])
    out1 = np.empty(max(int(outoff[-1]), 1), np.uint8)
    out2 = np.empty_like(out1)
    outlen = np.zeros(count, np.int64)
    spans = np.zeros((count, 4), np.int64)
    i64, i32, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint8
    mv_ptr = ctypes.cast(moves.ctypes.data + col0, ctypes.POINTER(u8))
    rebuild = (lib.sw_reconstruct_tokens if tokens
               else lib.sw_reconstruct_moves)
    rc = rebuild(
        mv_ptr, B, n_rows,
        _ptr(cnt32, i32), _ptr(i032, i32), _ptr(j032, i32),
        _ptr(seq1, u8), _ptr(off1, i64), _ptr(seq2, u8), _ptr(off2, i64),
        count, 1 if mode == LOCAL else 0, 1 if retain_all else 0,
        _ptr(out1, u8), _ptr(out2, u8), _ptr(outoff, i64),
        _ptr(outlen, i64), _ptr(spans, i64),
    )
    if rc != 0:
        raise RuntimeError(f"corrupt {'token' if tokens else 'move'} "
                           f"stream at pair {-rc - 1}")
    o1b = out1.tobytes()
    o2b = out2.tobytes()
    res = []
    for k in range(count):
        lo = int(outoff[k])
        hi = lo + int(outlen[k])
        sp = spans[k]
        res.append(AlignResult(
            o1b[lo:hi].decode("latin-1"), o2b[lo:hi].decode("latin-1"),
            float(scores[k]), int(sp[0]), int(sp[1]), int(sp[2]),
            int(sp[3]),
        ))
    return res


def reconstruct_packed_py(seq1s, seq2s, moves, cnt, i0, j0, scores,
                          mode: int, retain_all: bool, col0: int = 0,
                          tokens: bool = False):
    """The exact Python path of :func:`reconstruct_packed` (no warning)."""
    from ..aligner import reconstruct_alignment

    if mode != LOCAL:
        retain_all = True
    to_path = (device_walk.tokens_to_path if tokens
               else device_walk.moves_to_path)
    res = []
    for k in range(len(seq1s)):
        idx1, idx2 = to_path(
            moves[:, col0:], cnt, int(i0[k]), int(j0[k]), k)
        if mode != LOCAL:
            # a non-local stream stops at its first boundary cell: put
            # back the terminal-gap tail the walk skipped
            ie = int(i0[k]) - sum(1 for x in idx1 if x >= 0)
            je = int(j0[k]) - sum(1 for x in idx2 if x >= 0)
            if ie > 0:
                idx1 = list(range(ie)) + list(idx1)
                idx2 = [-1] * ie + list(idx2)
            elif je > 0:
                idx1 = [-1] * je + list(idx1)
                idx2 = list(range(je)) + list(idx2)
        res.append(reconstruct_alignment(
            seq1s[k], seq2s[k], idx1, idx2, float(scores[k]), retain_all,
            mode))
    return res
