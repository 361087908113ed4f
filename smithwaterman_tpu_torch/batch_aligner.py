"""BatchAligner: bucketed many-pair alignment on a CUDA card.

The counterpart of ``smithwaterman_tpu/batch_aligner.py`` and the main path
every user surface goes through (CLI, clustering, the single-pair
``Aligner`` on a card).  Its stages:

1. codes: ``SubstitutionMatrix.seq_to_index`` per sequence; pairs with an
   empty side get the closed-form ``degenerate_result``;
2. buckets: pairs grouped by ``(bucket_len(n), bucket_len(m))``, buckets in
   sorted order, each bucket's codes padded into (B, NP) and (B, MP);
3. flushes: buckets cut into chunks whose pointer bytes fit the budget
   (``ops/batch.plan_flushes``); a bucket whose single pair's pointers
   exceed it (or, with ``longseq_cells``, whose padded cells reach that
   count) takes the long-sequence route instead, and so does a bucket of
   long pairs in an ordinary flush too small in pairs to occupy the card
   (``ops/batch.occupancy_long``, counted in ``route.long.occupancy``);
4. per flush, the fill (kernel K1, ``ops/fill_dp.fill_many``) and the walk
   (kernel K2, ``ops/device_walk.walk_packed``), one launch each over all
   of the flush's pairs, leaving only the stats, move counts and packed
   moves to copy back; on the long route, the checkpointed fill (K3) and
   per band the refill (K4) and segment walk (K5),
   ``ops/longseq.align_long_packed``, with the same outputs;
5. the string rebuild on the host from the 2-bit move streams
   (``ops/reconstruct.reconstruct_packed``, ``csrc/reconstruct.cpp``).

Two opt-in routes, off by default as in the JAX package, change no result:

* ``diag_scores=True`` (or ``SWTPU_DIAG_SCORES=1``): a score-only
  flush that ``ops/diag_dp.eligible`` accepts (LOCAL, og <= eg <= 0) takes
  the wavefront fill (kernel K9, ``ops/diag_dp.fill_diag``) instead of K1;
  ``align_pairs`` never does;
* ``SWTPU_TOKEN_WALK=1``: alignments take the fill with match-run bytes
  (kernel K10) and the token walk (kernel K11,
  ``ops/device_walk.walk_tokens``), which jumps up to 16 diagonal cells a
  step and ships one byte a token; the rebuild expands the tokens
  (``reconstruct_packed(tokens=True)``).  The long route is unchanged.

With ``device_axis`` (a ``parallel.DataParallel``, JAX's
``batch_aligner.py:167``, ``:388-399``, ``:491-539``) every flush that
is not long is sharded over the mesh's devices: alignments through
``DataParallel.fill_walk_packed`` (K1 then K2 on each shard's pairs),
score-only flushes through ``DataParallel.fill_many(score_only=True)``
(K1), or with ``diag_scores`` through ``DataParallel.fill_diag`` (K9).
The token walk is not taken there, as in JAX, whose sharded branch is
the fill and the packed walk only.  A long flush runs unsharded on the
engine's device (by default ``mesh.devices[0]``) through
``longseq.align_long_packed``: JAX with ``device_axis`` never takes the
long route (``:457-462``) and walks on the host past its per-shard cap
(``:491-497``); the port has no host walk, and both routes are exact, so
the results are the same.

Results come back in input order and are bit-identical to the single-pair
``Aligner``, with or without ``device_axis``.  ``device="cpu"`` runs the
same stages with the kernels' plain PyTorch versions: the tests' reference
path.  Without a device (or a mesh) the engine runs on the card, and
raises where there is none.

Each call is one ``utils.metrics.call`` with a span around every stage
(the layer map of ``PERF.md`` section 3): ``bucket`` (``encode``,
``table``, ``pack``, ``plan``), then a ``flush`` a flush (attributes:
route, why a long flush is long, pairs, padded cells, pointer bytes)
holding ``dispatch`` (``fill``, ``walk``, or ``long`` with ``ckpt`` and
a ``group`` a band group), ``gather`` (``wait`` for the card's stream,
``copy`` of the results) and ``reconstruct``.
:attr:`BatchAligner.phase` is the last call's seconds by span name.  The
call is traced (its spans and counts logged, ``utils.metrics.calls()``)
while a ``torch.profiler`` records or a
:class:`~.utils.metrics.StatsCollector` is attached.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .aligner import (
    AlignResult,
    _as_seqdata,
    _perl_compat_seq,
    degenerate_result,
    resolve_device,
)
from .config import LOCAL, AlignConfig, bucket_len
from .matrices import ScoringMatrix, SubstitutionMatrix
from .ops import batch as batch_ops
from .ops import device_walk, diag_dp, fill_dp, longseq
from .ops import reconstruct as recon
from .utils import metrics

# the phases BatchAligner.phase always holds
PHASES = ("bucket", "dispatch", "gather", "reconstruct")


@dataclass
class _Bucket:
    np_pad: int
    mp_pad: int
    indices: List[int] = field(default_factory=list)  # caller positions
    codes1: List[np.ndarray] = field(default_factory=list)
    codes2: List[np.ndarray] = field(default_factory=list)

    def chunk(self, dtype: np.dtype) -> batch_ops.Chunk:
        """The bucket's padded codes (of ``dtype``) and lengths."""
        count = len(self.indices)
        n = np.fromiter((len(c) for c in self.codes1), np.int32, count)
        m = np.fromiter((len(c) for c in self.codes2), np.int32, count)
        return batch_ops.Chunk(_pack(self.codes1, n, self.np_pad, dtype),
                               _pack(self.codes2, m, self.mp_pad, dtype), n, m)


def _pack(codes: List[np.ndarray], lens: np.ndarray, width: int,
          dtype: np.dtype):
    """Rows of ragged codes into a zero-padded (count, width) array of
    ``dtype`` with one fancy-index scatter."""
    count = len(codes)
    out = np.zeros((count, width), dtype)
    total = int(lens.sum())
    if total:
        starts = np.zeros(count, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        rows = np.repeat(np.arange(count), lens)
        cols = np.arange(total) - np.repeat(starts, lens)
        out[rows, cols] = np.concatenate(codes)
    return out


class BatchAligner:
    def __init__(
        self,
        scoring_matrix: Optional[ScoringMatrix] = None,
        gap_open: float = 10.0,
        gap_extend: float = 0.5,
        mode: int = LOCAL,
        config: Optional[AlignConfig] = None,
        device: Optional[str] = None,
        perl_compat: bool = False,
        longseq_cells: Optional[int] = None,
        diag_scores: Optional[bool] = None,
        device_axis=None,
    ):
        if config is None:
            config = AlignConfig(mode=mode, gap_open=gap_open,
                                 gap_extend=gap_extend)
        self.config = config
        self.scoring_matrix = scoring_matrix or SubstitutionMatrix.blosum62()
        # parallel.DataParallel or None: shard each flush's pairs over its
        # mesh, whose first device is the engine's by default (a mesh of
        # CPU devices asks for the CPU); a device outside the mesh raises
        self.device_axis = device_axis
        if device_axis is None:
            self.device = resolve_device(device)
        elif device is None:
            self.device = device_axis.mesh.devices[0]
        else:
            self.device = torch.device(device)
            if self.device.type == "cuda" and self.device.index is None \
                    and torch.cuda.is_available():
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            if self.device not in device_axis.mesh.devices:
                raise ValueError(
                    f"device {self.device} is not in the mesh "
                    f"{list(device_axis.mesh.devices)}")
        # buckets with at least this many padded cells take the
        # long-sequence route (ops/longseq.py) for alignments; None: only
        # buckets whose single pair's pointers exceed SWTPU_TB_HBM_BYTES
        self.longseq_cells = longseq_cells
        # the wavefront fill (K9) for eligible score-only LOCAL chunks;
        # None reads SWTPU_DIAG_SCORES (default off, as in the JAX package)
        if diag_scores is None:
            diag_scores = os.environ.get("SWTPU_DIAG_SCORES", "0") == "1"
        self.diag_scores = diag_scores
        # token walks (K10 fill with run bytes, K11 walk) for alignments;
        # SWTPU_TOKEN_WALK=1 turns them on (default off, as in the JAX
        # package), never under device_axis
        self.token_walk = (os.environ.get("SWTPU_TOKEN_WALK", "0") == "1"
                           and device_axis is None)
        # replicate the Perl engine's input rewrite (aligner.perl_sanitize)
        self.perl_compat = perl_compat
        # opt-in observability: assign a utils.metrics.StatsCollector,
        # which also traces every call
        self.stats = None
        # the last call's seconds by span name: always PHASES (bucket,
        # dispatch, gather, reconstruct), call and the spans it opened
        self.phase: Dict[str, float] = {}

    @property
    def mode(self) -> int:
        return self.config.mode

    # ------------------------------------------------------------------
    def align_pairs(
        self, pairs: Sequence[Tuple], retain_all: bool = True
    ) -> List[AlignResult]:
        return self._run(pairs, retain_all=retain_all, score_only=False)

    def score_pairs(self, pairs: Sequence[Tuple]) -> np.ndarray:
        res = self._run(pairs, retain_all=True, score_only=True)
        return np.asarray([r.score for r in res], dtype=np.float32)

    # ------------------------------------------------------------------
    def _table_on_device(self) -> torch.Tensor:
        table = np.asarray(self.scoring_matrix.table, np.float32)
        return batch_ops.to_device(table.copy(), self.device)

    def _run(self, pairs: Sequence[Tuple], retain_all: bool,
             score_only: bool) -> List[AlignResult]:
        sm = self.scoring_matrix
        if not hasattr(sm, "table"):
            raise ValueError(
                "BatchAligner needs a letter-indexed scoring matrix; "
                "position-specific matrices are per-pair — use Aligner"
            )
        with metrics.call(trace=self.stats is not None,
                          pairs=len(pairs)) as call:
            call.totals.update(dict.fromkeys(PHASES, 0))
            results = self._stages(call, pairs, retain_all, score_only)
        self.phase = {k: ns * 1e-9 for k, ns in call.totals.items()}
        if self.stats is not None:
            self.stats.add_call(call)
        return results

    def _stages(self, call, pairs, retain_all, score_only):
        sm = self.scoring_matrix
        og, eg = self.config.og, self.config.eg
        results: List[Optional[AlignResult]] = [None] * len(pairs)
        seqs: List[Tuple] = []
        buckets: Dict[Tuple[int, int], _Bucket] = {}
        with metrics.span("bucket"):
            with metrics.span("encode"):
                for idx, (a, b) in enumerate(pairs):
                    s1, s2 = _as_seqdata(a), _as_seqdata(b)
                    if self.perl_compat:
                        s1, s2 = _perl_compat_seq(s1), _perl_compat_seq(s2)
                    seqs.append((s1, s2))
                    c1 = sm.seq_to_index(s1.seq)
                    c2 = sm.seq_to_index(s2.seq)
                    if len(c1) == 0 or len(c2) == 0:
                        results[idx] = degenerate_result(
                            s1.seq, s2.seq, self.mode, og, eg, retain_all,
                            score_only)
                        continue
                    key = (bucket_len(len(c1), self.config.buckets),
                           bucket_len(len(c2), self.config.buckets))
                    bk = buckets.get(key)
                    if bk is None:
                        bk = buckets[key] = _Bucket(*key)
                    bk.indices.append(idx)
                    bk.codes1.append(c1)
                    bk.codes2.append(c2)
                order = sorted(buckets.values(),
                               key=lambda b: (b.np_pad, b.mp_pad))
            with metrics.span("table"):
                table = self._table_on_device() if order else None
            with metrics.span("pack"):
                ctype = batch_ops.code_dtype(np.shape(sm.table)[0])
                chunks = [bk.chunk(ctype) for bk in order]
            with metrics.span("plan"):
                # the card's SMs for the occupancy rule, on the ordinary
                # route alone (not the token walk, not sharded)
                ordinary = not (score_only or self.token_walk
                                or self.device_axis is not None)
                flushes = batch_ops.plan_flushes(
                    chunks, batch_ops.tb_budget(), score_only,
                    long_cells=self.longseq_cells,
                    runs=self.token_walk and not score_only,
                    sms=batch_ops.card_sms(self.device) if ordinary else 0)
            # caller positions of each pair, in flush order
            positions = [i for bk in order for i in bk.indices]
        call.attrs["flushes"] = len(flushes)

        lo = 0
        for fl in flushes:
            B = sum(ch.shape[0] for ch in fl.chunks)
            pos = positions[lo:lo + B]
            self._flush(fl, pos, table, seqs, results, retain_all,
                        score_only)
            lo += B
        if self.stats is not None:
            self._record(order)
        return results  # type: ignore[return-value]

    def _route(self, flush, score_only: bool) -> str:
        if flush.long:
            return "long"
        if score_only:
            return "scores"
        if self.device_axis is not None:
            return "sharded"
        return "tokens" if self.token_walk else "ordinary"

    def _flush(self, flush, pos, table, seqs, results, retain_all,
               score_only) -> None:
        """Fill and walk one flush on the device, then rebuild on the host."""
        chunks = flush.chunks
        route = self._route(flush, score_only)
        padded = sum(B * NP * MP for B, NP, MP in (ch.shape for ch in chunks))
        if score_only:
            ptr = 0
        elif flush.long:
            ptr = longseq.band_buffer_bytes(*chunks[0].shape)
        else:
            ptr = sum(B * NP * fill_dp.row_stride(MP) for B, NP, MP in
                      (ch.shape for ch in chunks))
            ptr *= 2 if route == "tokens" else 1
        metrics.count("cells.true", sum(int(np.dot(ch.n.astype(np.int64),
                                                   ch.m)) for ch in chunks))
        if flush.why == "occupancy":
            metrics.count("route.long.occupancy", len(pos))
        with metrics.span("flush", route=route, why=flush.why,
                          pairs=len(pos), padded_cells=padded,
                          pointer_bytes=ptr):
            stats_d, cnt_d, mv_d = self._dispatch(route, chunks, table)
            with metrics.span("gather"):
                # the sharded route's outputs are on the host already
                on_card = stats_d.device.type == "cuda"
                if on_card:
                    with metrics.span("wait"):
                        torch.cuda.current_stream(
                            stats_d.device).synchronize()
                outs = (stats_d,) if score_only else (stats_d, cnt_d, mv_d)
                nbytes = sum(t.numel() * t.element_size() for t in outs)
                with metrics.span("copy", bytes=nbytes if on_card else 0):
                    outs = [t.cpu().numpy() for t in outs]
                if on_card:
                    metrics.count("copy.d2h", len(outs))
                    metrics.count("copy.d2h_bytes", nbytes)
            with metrics.span("reconstruct"):
                self._rebuild(outs, chunks, pos, seqs, results, retain_all,
                              route == "tokens")

    def _dispatch(self, route: str, chunks, table):
        """Enqueue a flush's fill and walk: (stats, move counts, moves) on
        the device; None for the last two of a score-only flush."""
        og, eg = self.config.og, self.config.eg
        cnt_d = mv_d = None
        with metrics.span("dispatch"):
            if route == "long":
                (chunk,) = chunks
                with metrics.span("long"):
                    stats_d, cnt_d, mv_d = longseq.align_long_packed(
                        table, chunk, mode=self.mode, og=og, eg=eg)
            elif route == "scores":
                with metrics.span("fill"):
                    stats_d = self._fill_scores(table, chunks)
            elif route == "sharded":
                L = max(device_walk.max_path_len(NP, MP)
                        for _, NP, MP in (ch.shape for ch in chunks))
                with metrics.span("fill"):
                    stats_d, cnt_d, mv_d = self.device_axis.fill_walk_packed(
                        table, chunks, mode=self.mode, og=og, eg=eg, L=L)
            else:
                tokens = route == "tokens"
                with metrics.span("fill"):
                    filled = fill_dp.fill_many(table, chunks, mode=self.mode,
                                               og=og, eg=eg, runs=tokens)
                stats_d = filled.stats
                L = max(device_walk.max_path_len(NP, MP)
                        for _, NP, MP in filled.shapes)
                with metrics.span("walk"):
                    if tokens:
                        cnt_d, mv_d = device_walk.walk_tokens(
                            filled.tb, filled.run, filled.desc, filled.stats,
                            mode=self.mode, L=L, order=filled.order)
                    else:
                        cnt_d, mv_d = device_walk.walk_packed(
                            filled.tb, filled.desc, filled.stats,
                            mode=self.mode, L=L, order=filled.order)
        return stats_d, cnt_d, mv_d

    def _rebuild(self, outs, chunks, pos, seqs, results, retain_all,
                 tokens: bool) -> None:
        """Scores and, for alignments, strings of a flush's pairs from its
        copied-back stats, move counts and moves."""
        st = outs[0]
        if self.mode == LOCAL:
            scores = np.maximum(st[:, 0], 0.0)
        else:
            scores = st[:, 3:6].max(axis=1)
        if len(outs) == 1:
            for k, idx in enumerate(pos):
                results[idx] = AlignResult("", "", float(scores[k]))
            return
        _, cnt, mv = outs
        metrics.count("walk.steps", int(cnt.sum(dtype=np.int64)))
        if self.mode == LOCAL:
            hit = st[:, 0] > 0.0
            i0 = np.where(hit, st[:, 1], 0).astype(np.int32)
            j0 = np.where(hit, st[:, 2], 0).astype(np.int32)
        else:
            i0 = np.concatenate([ch.n for ch in chunks])
            j0 = np.concatenate([ch.m for ch in chunks])
        res = recon.reconstruct_packed(
            [seqs[i][0].seq for i in pos], [seqs[i][1].seq for i in pos],
            mv, cnt, i0, j0, scores, self.mode, retain_all, tokens=tokens,
        )
        for k, idx in enumerate(pos):
            results[idx] = res[k]

    def _fill_scores(self, table, chunks) -> torch.Tensor:
        """Stats of a score-only flush: through the wavefront fill (K9)
        with ``diag_scores`` when ``diag_dp.eligible`` accepts the flush,
        else through K1.  The port's eligibility is the flush's mode and
        penalties and lengths of at least 1, which every bucketed pair has,
        so one flush never holds both kinds (the JAX package decides per
        bucket, on its TPU tiling too).  With ``device_axis`` either fill
        is sharded over its mesh."""
        og, eg = self.config.og, self.config.eg
        dp = self.device_axis
        if self.diag_scores and diag_dp.eligible(
                mode=self.mode, og=og, eg=eg, score_only=True,
                n=np.concatenate([ch.n for ch in chunks]),
                m=np.concatenate([ch.m for ch in chunks])):
            if dp is not None:
                return dp.fill_diag(table, chunks, og=og, eg=eg)
            return diag_dp.fill_diag(table, chunks, og=og, eg=eg)
        if dp is not None:
            return dp.fill_many(table, chunks, mode=self.mode, og=og, eg=eg,
                                score_only=True)[1]
        return fill_dp.fill_many(table, chunks, mode=self.mode, og=og,
                                 eg=eg, score_only=True).stats

    def _record(self, order: List[_Bucket]) -> None:
        for bk in order:
            count = len(bk.indices)
            n = np.fromiter((len(c) for c in bk.codes1), np.int64, count)
            m = np.fromiter((len(c) for c in bk.codes2), np.int64, count)
            bs = self.stats.bucket(bk.np_pad, bk.mp_pad)
            bs.pairs += count
            bs.padded_pairs += count
            bs.true_cells += int(np.sum(n * m))
            bs.padded_cells += count * bk.np_pad * bk.mp_pad
