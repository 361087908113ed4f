"""Batch layout on the host: score gathers and pointer-budget chunking.

The counterpart of ``smithwaterman_tpu/ops/batch.py``.  In the JAX package
a bucket's dense substitution scores were built on the device
(``scores_tiled``) and streamed into the Pallas fill; the GPU fill kernel
instead looks each score up in a shared-memory copy of the table, so the
dense scores exist only in the plain reference path (:func:`scores`).

What stays is the memory plan: a traceback fill keeps one pointer byte per
padded cell of each pair on the device until its walk has run, so pairs
are cut into chunks whose pointer bytes fit a budget (``SWTPU_TB_HBM_BYTES``,
default 4 GiB, the JAX package's setting) and chunks are filled and walked
together while their sum fits it (:func:`plan_flushes`).  A pair whose
pointers alone exceed the budget takes the long-sequence route
(``ops/longseq.py``) instead.
"""

from __future__ import annotations

import os
from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import metrics

DEFAULT_TB_BUDGET = 4 << 30


def tb_budget() -> int:
    """Pointer bytes one flush may hold on the device."""
    return int(os.environ.get("SWTPU_TB_HBM_BYTES", str(DEFAULT_TB_BUDGET)))


def code_dtype(K: int) -> np.dtype:
    """The codes of a K-symbol table: uint8, or int16 past 255 symbols (the
    JAX package widens to int32 past 127; every kernel here takes both)."""
    return np.dtype(np.uint8 if K <= 255 else np.int16)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``: one copy to a card,
    counted (``copy.h2d``, ``copy.h2d_bytes``), none on the CPU."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        metrics.count("copy.h2d")
        metrics.count("copy.h2d_bytes", a.nbytes)
    return t.to(device)


def is_integer_table(table: np.ndarray) -> bool:
    return bool(
        np.all(table == np.round(table))
        and np.all(np.abs(table) <= 127)
    )


def scores(table: torch.Tensor, codes1: torch.Tensor,
           codes2: torch.Tensor) -> torch.Tensor:
    """Dense substitution scores ``table[c1][..., c2]``: (B, NP, MP) f32
    from codes (B, NP) and (B, MP).  An exact gather for integer and
    non-integer tables alike.  Padded positions score whatever their
    (zero) codes give; every consumer masks cells past (n, m)."""
    prof = table[codes1.long()]                          # (B, NP, K)
    B, NP, _ = prof.shape
    idx = codes2.long()[:, None, :].expand(B, NP, codes2.shape[1])
    return torch.gather(prof, 2, idx)


class Chunk(NamedTuple):
    """Pairs of one bucket filled together: padded codes (B, NP) and
    (B, MP) (:func:`code_dtype`: uint8, int16 past 255 symbols) and true
    lengths (B,) int32, host numpy arrays."""

    codes1: np.ndarray
    codes2: np.ndarray
    n: np.ndarray
    m: np.ndarray

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.codes1.shape[0], self.codes1.shape[1],
                self.codes2.shape[1])


class Flush(NamedTuple):
    """Chunks filled and walked together; ``long``: one chunk that takes the
    long-sequence route (``ops/longseq.align_long_packed``)."""

    chunks: List[Chunk]
    long: bool = False


def plan_flushes(chunks: Iterable[Chunk], budget: int, score_only: bool,
                 long_cells: Optional[int] = None,
                 runs: bool = False) -> List[Flush]:
    """Split bucket chunks so each piece's pointer array fits ``budget``,
    then group pieces into flushes whose pointers fit it together (input
    order kept).  Score-only fills keep no pointers: one flush.  With
    ``runs`` (the token walk's match-run bytes, one more byte a cell) a
    cell counts two bytes, as the JAX package doubles ``tb_bytes``.

    A chunk whose single pair's pointers exceed the budget, or whose NP*MP
    is at least ``long_cells`` (the JAX package's ``longseq_cells``), takes
    the long-sequence route: pieces of as many pairs as fit the budget at
    ``longseq.pair_bytes(NP, MP)`` device bytes each (checkpoints and one
    band; the route refills as many bands at once as the rest of the
    budget holds, ``longseq.group_bands``), one flush apiece.  The
    JAX package counts a whole tile group of pairs against the budget, the
    port one pair; both routes are exact, so the results do not depend on
    which one runs."""
    from . import longseq  # it builds on this module's Chunk

    chunks = list(chunks)
    if score_only:
        return [Flush(chunks)] if chunks else []
    flushes: List[Flush] = []
    cur: List[Chunk] = []
    cur_bytes = 0
    for ch in chunks:
        B, NP, MP = ch.shape
        per_pair = NP * MP * (2 if runs else 1)
        if per_pair > budget or (long_cells is not None
                                 and NP * MP >= long_cells):
            if cur:
                flushes.append(Flush(cur))
                cur, cur_bytes = [], 0
            step = max(1, budget // longseq.pair_bytes(NP, MP))
            flushes += [Flush([Chunk(*(a[lo:lo + step] for a in ch))], True)
                        for lo in range(0, B, step)]
            continue
        step = budget // per_pair
        for lo in range(0, B, step):
            piece = Chunk(*(a[lo:lo + step] for a in ch))
            nbytes = piece.shape[0] * per_pair
            if cur and cur_bytes + nbytes > budget:
                flushes.append(Flush(cur))
                cur, cur_bytes = [], 0
            cur.append(piece)
            cur_bytes += nbytes
    if cur:
        flushes.append(Flush(cur))
    return flushes
