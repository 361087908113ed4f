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
    """Chunks filled and walked together; ``why`` is None on the ordinary
    route, else why the flush takes the long-sequence route
    (``ops/longseq.align_long_packed``, one chunk): ``"budget"`` (a pair's
    pointers pass the budget), ``"long_cells"`` (the caller's
    ``longseq_cells``) or ``"occupancy"`` (K1 would leave most of the card
    idle, :func:`occupancy_long`)."""

    chunks: List[Chunk]
    why: Optional[str] = None

    @property
    def long(self) -> bool:
        return self.why is not None


# The occupancy rule (:func:`occupancy_long`): K1 fills a pair in one block,
# on one SM, while the long route runs a warp (K3) and a block (K4) a
# 256-row band of every pair.  An ordinary traceback flush of at most
# 1 / OCCUPANCY_SHARE of the card's SMs in pairs runs its buckets of at
# least LONG_MIN_ROWS padded rows on the long route.  Set from one H100's
# table of both routes (scripts/ab_route.py, PERF.md section 6): the long
# route won every such shape from 4096 rows up, 1.1-13x; at 2048 rows K1
# won LOCAL flushes of 16 to 128 pairs.
OCCUPANCY_SHARE = 2
LONG_MIN_ROWS = 4096


def card_sms(device) -> int:
    """The SM count of the card ``device`` as the occupancy rule reads it;
    0 off a card.  K1's launch plan reads the card apart
    (``fill_dp.device_plan``), so a test or a timing that sets this to 0
    turns the rule off and leaves K1 as it runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).multi_processor_count


def occupancy_long(pairs: int, NP: int, sms: int) -> bool:
    """Whether a bucket of NP padded rows in an ordinary traceback flush of
    ``pairs`` pairs takes the long route on a card of ``sms`` SMs (0: never):
    K1 would run the flush on at most 1 / :data:`OCCUPANCY_SHARE` of the
    card, and the bucket's rows give the long route's kernels
    :data:`LONG_MIN_ROWS` // 256 bands or more a pair to spread."""
    return 0 < pairs * OCCUPANCY_SHARE <= sms and NP >= LONG_MIN_ROWS


# a piece of a chunk: (chunk index, first pair, end pair)
_Piece = Tuple[int, int, int]


def plan_flushes(chunks: Iterable[Chunk], budget: int, score_only: bool,
                 long_cells: Optional[int] = None,
                 runs: bool = False, sms: int = 0) -> List[Flush]:
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
    budget holds, ``longseq.group_bands``), one flush apiece.  With
    ``sms``, the SM count of the card an ordinary traceback flush would
    run on, the pieces of a grouped flush that :func:`occupancy_long`
    picks take that route too: adjacent pieces of one chunk joined, then
    cut the same way.  The JAX package counts a whole tile group of pairs
    against the budget, the port one pair; both routes are exact, so the
    results do not depend on which one runs."""
    chunks = list(chunks)
    if score_only:
        return [Flush(chunks)] if chunks else []
    groups: List[Tuple[Optional[str], List[_Piece]]] = []
    cur: List[_Piece] = []
    cur_bytes = 0
    for ci, ch in enumerate(chunks):
        B, NP, MP = ch.shape
        per_pair = NP * MP * (2 if runs else 1)
        why = ("budget" if per_pair > budget else "long_cells"
               if long_cells is not None and NP * MP >= long_cells else None)
        if why:
            if cur:
                groups.append((None, cur))
                cur, cur_bytes = [], 0
            groups.append((why, [(ci, 0, B)]))
            continue
        step = budget // per_pair
        for lo in range(0, B, step):
            hi = min(B, lo + step)
            nbytes = (hi - lo) * per_pair
            if cur and cur_bytes + nbytes > budget:
                groups.append((None, cur))
                cur, cur_bytes = [], 0
            cur.append((ci, lo, hi))
            cur_bytes += nbytes
    if cur:
        groups.append((None, cur))
    if sms:
        groups = _occupancy(groups, chunks, sms)
    return [flush for why, pieces in groups
            for flush in _flushes(why, pieces, chunks, budget)]


def _occupancy(groups, chunks: List[Chunk], sms: int):
    """``groups`` with the pieces of each ordinary group that
    :func:`occupancy_long` picks moved to long groups, in order, adjacent
    pieces of one chunk joined."""
    out: List[Tuple[Optional[str], List[_Piece]]] = []
    for why, pieces in groups:
        if why is not None:
            out.append((why, pieces))
            continue
        pairs = sum(hi - lo for _, lo, hi in pieces)
        ordinary: List[_Piece] = []
        for ci, lo, hi in pieces:
            if not occupancy_long(pairs, chunks[ci].shape[1], sms):
                ordinary.append((ci, lo, hi))
                continue
            if ordinary:
                out.append((None, ordinary))
                ordinary = []
            if out and out[-1][0] == "occupancy" and \
                    out[-1][1][0][0] == ci and out[-1][1][0][2] == lo:
                lo = out.pop()[1][0][1]
            out.append(("occupancy", [(ci, lo, hi)]))
        if ordinary:
            out.append((None, ordinary))
    return out


def _flushes(why: Optional[str], pieces: List[_Piece], chunks: List[Chunk],
             budget: int) -> List[Flush]:
    """The flushes of one group: its pieces together, or one long flush a
    ``longseq.pair_bytes`` cut of its one piece."""
    def part(ci, lo, hi):
        return Chunk(*(a[lo:hi] for a in chunks[ci]))

    if why is None:
        return [Flush([part(*p) for p in pieces])]
    from . import longseq  # it builds on this module's Chunk

    (ci, lo, hi), = pieces
    _, NP, MP = chunks[ci].shape
    step = max(1, budget // longseq.pair_bytes(NP, MP))
    return [Flush([part(ci, a, min(hi, a + step))], why)
            for a in range(lo, hi, step)]
