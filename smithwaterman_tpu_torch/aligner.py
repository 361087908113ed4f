"""Pairwise aligner: the user-facing engine.

API parity with the reference Rust engine
(rust/sequence_alignment/src/sequence_alignment.rs:15-551)
and with ``smithwaterman_tpu.aligner``: ``align(s1, s2, retain_all)``,
``align_partial(..., partial_region, score_only)``, three modes, any
ScoringMatrix.

Structure: on a CUDA device, whole pairs with a letter table go through
:class:`BatchAligner` (the GPU fill and walk kernels); otherwise (the CPU,
a position-specific matrix, a partial region) the pair is filled by the
exact torch oracle (``ops/scan_dp.py``) on the aligner's device and walked
on the host, as the JAX package runs its scan path for those.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import (
    GLOBAL,
    LOCAL,
    AlignConfig,
    CELL_MATCH,
    bucket_len,
)
from .io.fasta import SeqData
from .matrices import ScoringMatrix, SubstitutionMatrix
from .ops import scan_dp, traceback


def default_device() -> str:
    """The device an engine runs on when the caller names none: the card.
    The CPU runs only when asked for (``device="cpu"``)."""
    return "cuda"


def resolve_device(device) -> torch.device:
    """The engine's device: ``device`` as given, else :func:`default_device`,
    which raises ``RuntimeError`` when no card is visible rather than run
    on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device=\"cpu\" to run on "
                "the CPU")
        device = default_device()
    return torch.device(device)


@dataclass
class AlignResult:
    aligned1: str
    aligned2: str
    score: float
    # 0-based inclusive span of aligned residues in each input (local mode;
    # -1 when nothing aligned).
    start1: int = -1
    end1: int = -1
    start2: int = -1
    end2: int = -1


def _as_seqdata(s) -> SeqData:
    if isinstance(s, SeqData):
        return s
    return SeqData(name="", desc="", seq=str(s))


_PERL_STRIP = re.compile(r"[^A-Za-z]")
_PERL_TO_X = re.compile(r"[BJOUXZ]")


def perl_sanitize(seq: str) -> str:
    """The Perl engine's input rewrite (smithwaterman.pl:82-99):
    uppercase, strip non-letters, then map ambiguity codes ``[BJOUXZ]``
    to ``X`` (the rewrite's ``a-z`` class is dead after ``uc``).  Opt-in
    via ``Aligner(perl_compat=True)`` / CLI ``-perl_compat`` — the Perl
    engine is the ONLY reference engine with this behavior (the others
    score B/Z via the BLOSUM62 rows), so the default stays the
    majority/EMBOSS behavior.  Scope is the INPUT rewrite: the Perl
    engine's other solo quirks (terminal-pad order, its zero-score
    walk) are not replicated.

    The strip runs BEFORE the uppercase map: Perl's byte-semantics ``uc``
    never turns a non-letter into a letter, but Python's ``str.upper``
    can (e.g. ``"ß".upper() == "SS"`` would survive the ``[A-Za-z]``
    strip as two letters the Perl engine deletes), so stripping first —
    leaving pure ASCII for ``upper`` — keeps the rewrite byte-faithful
    off ASCII too."""
    return _PERL_TO_X.sub("X", _PERL_STRIP.sub("", seq).upper())


def _perl_compat_seq(s: SeqData) -> SeqData:
    return SeqData(name=s.name, desc=s.desc, seq=perl_sanitize(s.seq))


def reconstruct_alignment(
    seq1: str,
    seq2: str,
    idx1: Sequence[int],
    idx2: Sequence[int],
    score: float,
    retain_all: bool,
    mode: int,
) -> AlignResult:
    """String reconstruction + full-length terminal padding
    (parity: sequence_alignment.rs:469-551)."""
    a1: List[str] = []
    a2: List[str] = []
    start1 = start2 = -1
    end1 = end2 = -1
    for ii in idx1:
        if ii > -1:
            if start1 < 0:
                start1 = ii
            a1.append(seq1[ii])
            end1 = ii
        else:
            a1.append("-")
    for ii in idx2:
        if ii > -1:
            if start2 < 0:
                start2 = ii
            a2.append(seq2[ii])
            end2 = ii
        else:
            a2.append("-")

    if mode == LOCAL and not retain_all:
        return AlignResult(
            "".join(a1), "".join(a2), score, start1, end1, start2, end2
        )
    if mode != LOCAL and not retain_all:
        import sys

        sys.stderr.write("The glocal or global mode will retain all letters.\n")

    if start1 < 0 or start2 < 0:
        # nothing aligned: seq1 over gaps, then gaps over seq2 (rs:512-524)
        r1 = list(seq1) + ["-"] * len(seq2)
        r2 = ["-"] * len(seq1) + list(seq2)
        return AlignResult("".join(r1), "".join(r2), score, -1, -1, -1, -1)

    r1 = []
    r2 = []
    for ii in range(start1):
        r1.append(seq1[ii])
        r2.append("-")
    for ii in range(start2):
        r1.append("-")
        r2.append(seq2[ii])
    r1 += a1
    r2 += a2
    for ii in range(end1 + 1, len(seq1)):
        r1.append(seq1[ii])
        r2.append("-")
    for ii in range(end2 + 1, len(seq2)):
        r1.append("-")
        r2.append(seq2[ii])
    return AlignResult("".join(r1), "".join(r2), score, start1, end1, start2, end2)


def degenerate_result(
    seq1: str,
    seq2: str,
    mode: int,
    og: float,
    eg: float,
    retain_all: bool,
    score_only: bool,
) -> AlignResult:
    """Empty-sequence handling (boundary-only DP, computed in closed form)."""
    n, m = len(seq1), len(seq2)
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = 0.0, 0.0
    if mode == LOCAL:
        score = 0.0
    else:
        k = max(n, m)
        score = 0.0 if k == 0 else k * se + (so - se)
    if score_only:
        return AlignResult("", "", score)
    if mode == LOCAL and not retain_all:
        return AlignResult("", "", score)
    return AlignResult(seq1 + "-" * m, "-" * n + seq2, score, -1, -1, -1, -1)


class Aligner:
    """Three-mode affine-gap pairwise aligner.

    >>> a = Aligner(mode=LOCAL)
    >>> r = a.align("HEAGAWGHEE", "PAWHEAE")
    """

    def __init__(
        self,
        scoring_matrix: Optional[ScoringMatrix] = None,
        gap_open: float = 10.0,
        gap_extend: float = 0.5,
        mode: int = LOCAL,
        config: Optional[AlignConfig] = None,
        perl_compat: bool = False,
        device: Optional[str] = None,
    ):
        if config is None:
            config = AlignConfig(mode=mode, gap_open=gap_open, gap_extend=gap_extend)
        self.config = config
        self.scoring_matrix = scoring_matrix or SubstitutionMatrix.blosum62()
        # replicate the Perl engine's input rewrite (perl_sanitize)
        self.perl_compat = perl_compat
        self.device = resolve_device(device)
        self._batch = None  # lazy GPU-kernel delegate (see align_partial)

    # ------------------------------------------------------------------
    @property
    def mode(self) -> int:
        return self.config.mode

    def prepare(self, s1, s2) -> None:
        """Parity hook for PositionSpecificMatrix (rs:51-54)."""
        self.scoring_matrix.prepare(_as_seqdata(s1), _as_seqdata(s2))

    # ------------------------------------------------------------------
    def align(self, s1, s2, retain_all: bool = True) -> AlignResult:
        return self.align_partial(s1, s2, retain_all, None, False)

    def align_fasta(self, text1: str, text2: str, retain_all: bool = True) -> AlignResult:
        """Align the first records of two raw FASTA texts (parity with the
        Java engine's ``align(String, String)`` overload,
        SmithWaterman.java:41-66)."""
        from .io.fasta import parse_fasta

        r1 = parse_fasta(text1.splitlines())
        r2 = parse_fasta(text2.splitlines())
        s1 = r1[0] if r1 else SeqData("", "", text1.strip())
        s2 = r2[0] if r2 else SeqData("", "", text2.strip())
        return self.align(s1, s2, retain_all)

    def align_banded(self, s1, s2, band: int = 512, retain_all: bool = True,
                     verified: bool = True) -> AlignResult:
        """Diagonal-banded alignment (O(band) work per row) for long,
        similar sequences, on the aligner's device (the kernels K6-K8 on a
        card).  With ``verified`` (default) the band widens until two
        widths agree, the standard banded-DP guard; without it the result
        is the in-band optimum (a heuristic).  See ``ops/banded.py``."""
        from .ops import banded as banded_ops

        s1 = _as_seqdata(s1)
        s2 = _as_seqdata(s2)
        if self.perl_compat:
            s1 = _perl_compat_seq(s1)
            s2 = _perl_compat_seq(s2)
        codes1 = self.scoring_matrix.seq_to_index(s1.seq)
        codes2 = self.scoring_matrix.seq_to_index(s2.seq)
        if len(codes1) == 0 or len(codes2) == 0:
            return self._degenerate(s1, s2, len(codes1), len(codes2),
                                    retain_all, False)
        fn = (banded_ops.align_banded_verified if verified
              else banded_ops.align_banded)
        idx1, idx2, score, _ = fn(
            codes1, codes2, np.asarray(self.scoring_matrix.table, np.float32),
            mode=self.mode, og=self.config.og, eg=self.config.eg, band=band,
            device=self.device,
        )
        return reconstruct_alignment(s1.seq, s2.seq, idx1, idx2, score,
                                     retain_all, self.mode)

    def align_files(self, path1: str, path2: str, retain_all: bool = True):
        """All-vs-all over two FASTA files (parity with the Python engine's
        ``alignFile``, smithwaterman.py:79-87); yields
        (record1, record2, AlignResult)."""
        from .io.fasta import load_fasta

        for s1 in load_fasta(path1):
            for s2 in load_fasta(path2):
                yield s1, s2, self.align(s1, s2, retain_all)

    def score(self, s1, s2) -> float:
        return self.align_partial(s1, s2, True, None, True).score

    def align_partial(
        self,
        s1,
        s2,
        retain_all: bool = True,
        partial_region: Optional[Tuple[int, int]] = None,
        score_only: bool = False,
    ) -> AlignResult:
        s1 = _as_seqdata(s1)
        s2 = _as_seqdata(s2)
        if self.perl_compat:
            s1 = _perl_compat_seq(s1)
            s2 = _perl_compat_seq(s2)

        # On a card the flagship API uses the flagship kernels: route
        # through the batch pipeline (one pair) whenever the matrix is a
        # letter table (PSMs are per-pair: oracle path) and no partial
        # region narrows the sequences.  The kernels are bit-exact vs the
        # oracle, so results are unchanged.
        if (
            partial_region is None
            and hasattr(self.scoring_matrix, "table")
            and self.device.type == "cuda"
        ):
            if self._batch is None:
                from .batch_aligner import BatchAligner

                self._batch = BatchAligner(
                    scoring_matrix=self.scoring_matrix, config=self.config,
                    device=self.device,
                )
            if score_only:
                score = float(self._batch.score_pairs([(s1, s2)])[0])
                return AlignResult("", "", score)
            return self._batch.align_pairs([(s1, s2)], retain_all)[0]

        p1 = partial_region[0] if partial_region else None
        p2 = partial_region[1] if partial_region else None
        codes1 = self.scoring_matrix.seq_to_index(s1.seq, p1)
        codes2 = self.scoring_matrix.seq_to_index(s2.seq, p2)
        n, m = len(codes1), len(codes2)

        if n == 0 or m == 0:
            return self._degenerate(s1, s2, n, m, retain_all, score_only)

        npad, mpad = bucket_len(n, self.config.buckets), bucket_len(
            m, self.config.buckets
        )
        S = np.zeros((npad, mpad), dtype=np.float32)
        S[:n, :m] = self.scoring_matrix.dense_scores(codes1, codes2)

        res = scan_dp.fill(
            torch.from_numpy(S)[None].to(self.device),
            torch.tensor([n]),
            torch.tensor([m]),
            self.config.og,
            self.config.eg,
            mode=self.mode,
            with_traceback=not score_only,
        )
        best = float(res.best[0])

        if self.mode == LOCAL:
            maxscore = best
            if maxscore < 0.0:
                maxscore = 0.0
        else:
            maxscore = float(res.final[0, res.final_state[0]])

        if score_only:
            return AlignResult("", "", maxscore)

        tb = res.tb[0].cpu().numpy()
        if self.mode == LOCAL:
            if best <= 0.0:
                idx1: List[int] = []
                idx2: List[int] = []
            else:
                idx1, idx2 = traceback.walk(
                    tb, int(res.best_i[0]), int(res.best_j[0]), CELL_MATCH,
                    True
                )
        else:
            idx1, idx2 = traceback.walk(
                tb, n, m, int(res.final_state[0]), False
            )

        seq1 = s1.seq if p1 is None else s1.seq[:p1]
        seq2 = s2.seq if p2 is None else s2.seq[:p2]
        return reconstruct_alignment(
            seq1, seq2, idx1, idx2, maxscore, retain_all, self.mode
        )

    # ------------------------------------------------------------------
    def _degenerate(
        self, s1: SeqData, s2: SeqData, n: int, m: int, retain_all: bool, score_only: bool
    ) -> AlignResult:
        return degenerate_result(
            s1.seq[:n] if n < len(s1.seq) else s1.seq,
            s2.seq[:m] if m < len(s2.seq) else s2.seq,
            self.mode,
            self.config.og,
            self.config.eg,
            retain_all,
            score_only,
        )
