"""Scoring matrices for pairwise sequence alignment (a copy of
``smithwaterman_tpu.matrices``; numpy only).

Re-design of the reference scoring layer
(cf. rust/sequence_alignment/src/sequence_alignment.rs:574-795).

Components (reference parity):
  * ``SubstitutionMatrix`` — letter-indexed score table.
      - ``blosum62()``            (ref: sequence_alignment.rs:697-733)
      - ``match_mismatch()``      (ref: sequence_alignment.rs:681-695)
      - ``from_lines()`` parser   (ref: sequence_alignment.rs:735-794)
  * ``PositionSpecificMatrix`` — position-indexed (profile) scores
      (ref: sequence_alignment.rs:583-623).

Design difference from the reference: the compute path consumes either
(a) integer code arrays + a dense ``(K, K)`` float32 table (the GPU fill
kernel looks scores up from a shared-memory copy of the table), or (b) a
dense ``(la, lb)`` score matrix for the position-specific case.  The
classes here produce those dense arrays; no per-cell host callbacks exist.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "ScoringMatrix",
    "SubstitutionMatrix",
    "PositionSpecificMatrix",
    "BLOSUM62_LETTERS",
    "blosum62_table",
]

# NCBI BLOSUM62, half-bit units (public data:
# https://www.ncbi.nlm.nih.gov/Class/FieldGuide/BLOSUM62.txt), the same table
# every reference implementation embeds (e.g. sequence_alignment.rs:706-730).
BLOSUM62_LETTERS = "ARNDCQEGHILKMFPSTWYVBZX*"

_BLOSUM62_ROWS = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""


def blosum62_table() -> np.ndarray:
    """24x24 float32 BLOSUM62 table ordered by ``BLOSUM62_LETTERS``."""
    rows = [r.split() for r in _BLOSUM62_ROWS.strip().splitlines()]
    return np.asarray(rows, dtype=np.float32)


class MatrixFormatError(ValueError):
    """Raised on malformed scoring-matrix input (reference panics instead;
    cf. sequence_alignment.rs:752,761,784)."""


@dataclass
class ScoringMatrix:
    """Base interface mirroring the reference ``ScoringMatrix`` trait
    (sequence_alignment.rs:574-580), re-shaped for array-based compute."""

    def seq_to_index(self, seq: Sequence[str], partial: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def get_score(self, a: int, b: int) -> float:
        raise NotImplementedError

    def set_score(self, a: int, b: int, s: float) -> None:
        raise NotImplementedError

    def prepare(self, s1, s2) -> None:  # noqa: D401 - parity hook
        """Pre-alignment hook (only PositionSpecificMatrix needs it)."""

    def dense_scores(self, codes1: np.ndarray, codes2: np.ndarray) -> np.ndarray:
        """Dense (len1, len2) float32 substitution-score matrix."""
        raise NotImplementedError


@dataclass
class SubstitutionMatrix(ScoringMatrix):
    """Letter-indexed substitution matrix.

    ``table`` is a dense (K, K) float32 array; ``letters`` maps index -> symbol.
    Unknown symbols map to the index of ``X`` when present
    (ref: sequence_alignment.rs:669-679).
    """

    letters: List[str] = field(default_factory=list)
    table: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    letter_to_index: Dict[str, int] = field(default_factory=dict)

    # -- constructors -----------------------------------------------------

    @classmethod
    def blosum62(cls) -> "SubstitutionMatrix":
        letters = list(BLOSUM62_LETTERS)
        return cls(
            letters=letters,
            table=blosum62_table(),
            letter_to_index={c: i for i, c in enumerate(letters)},
        )

    @classmethod
    def match_mismatch(cls, match: float, mismatch: float) -> "SubstitutionMatrix":
        """A-Z identity matrix (ref: sequence_alignment.rs:681-695)."""
        letters = [chr(ord("A") + i) for i in range(26)]
        table = np.full((26, 26), mismatch, dtype=np.float32)
        np.fill_diagonal(table, match)
        return cls(
            letters=letters,
            table=table,
            letter_to_index={c: i for i, c in enumerate(letters)},
        )

    @classmethod
    def from_lines(cls, lines: Sequence[str]) -> "SubstitutionMatrix":
        """Parse a scoring-matrix file body (ref: sequence_alignment.rs:735-794).

        Behavior parity: ``#``-prefixed lines skipped; first non-comment line
        is the column-symbol header; duplicate header symbols and unknown row
        labels raise; unparseable values become 0.0 with a warning; a missing
        (row, col) pair raises.
        """
        header: List[str] = []
        scores: Dict[tuple, float] = {}
        lincount = -1
        for line in lines:
            bs = line.strip()
            if not bs:
                continue
            ptt = bs.split()
            if ptt[0][0] == "#":
                continue
            lincount += 1
            if lincount == 0:
                for sym in ptt:
                    if sym in header:
                        raise MatrixFormatError(f"{sym} was already found.")
                    header.append(sym)
            else:
                row = ptt[0]
                if row not in header:
                    raise MatrixFormatError(f"{row} was not found in the row name.")
                for ll in range(1, len(ptt)):
                    try:
                        val = float(ptt[ll])
                    except ValueError:
                        sys.stderr.write(
                            f"{ptt[ll]} can not be parsed! zero was assigned\n"
                        )
                        val = 0.0
                    scores[(row, header[ll - 1])] = val
        k = len(header)
        table = np.zeros((k, k), dtype=np.float32)
        for i, ri in enumerate(header):
            for j, cj in enumerate(header):
                if (ri, cj) not in scores:
                    raise MatrixFormatError(f"score about {ri} {cj} is not defined.")
                table[i, j] = scores[(ri, cj)]
        return cls(
            letters=header,
            table=table,
            letter_to_index={c: i for i, c in enumerate(header)},
        )

    @classmethod
    def from_file(cls, path: str) -> "SubstitutionMatrix":
        with open(path, "r") as f:
            return cls.from_lines(f.read().splitlines())

    # -- interface ---------------------------------------------------------

    @property
    def n_symbols(self) -> int:
        return len(self.letters)

    def index_of(self, letter: str) -> int:
        """Symbol index; unknown symbols fall back to ``X``
        (ref: sequence_alignment.rs:669-679)."""
        idx = self.letter_to_index.get(letter)
        if idx is not None:
            return idx
        x = self.letter_to_index.get("X")
        if x is None:
            raise KeyError(
                f"unknown letter {letter}. please set X to allow scoring for "
                "undefined letter pair."
            )
        return x

    def _byte_lut(self):
        """256-entry byte -> symbol-index table for vectorized encoding
        (False when letters fall outside latin-1).  Unknown bytes map to
        X (index_of's fallback) or -1 when the matrix has no X."""
        lut = self.__dict__.get("_lut")
        if lut is not None:
            return lut
        if any(len(c) != 1 or ord(c) > 255 for c in self.letter_to_index):
            self.__dict__["_lut"] = False
            return False
        x = self.letter_to_index.get("X", -1)
        lut = np.full(256, x, np.int32)
        for c, i in self.letter_to_index.items():
            lut[ord(c)] = i
        self.__dict__["_lut"] = lut
        return lut

    def seq_to_index(self, seq: Sequence[str], partial: Optional[int] = None) -> np.ndarray:
        if partial is not None:
            seq = seq[:partial]
        if isinstance(seq, str):
            # vectorized path: per-character index_of cost ~100 us/pair
            # of pure Python and dominated large-batch bucketing
            lut = self._byte_lut()
            if lut is not False:
                try:
                    b = np.frombuffer(seq.encode("latin-1"), np.uint8)
                except UnicodeEncodeError:
                    b = None
                if b is not None:
                    codes = lut[b]
                    if codes.min(initial=0) >= 0:
                        return codes
                    bad = seq[int(np.argmax(codes < 0))]
                    raise KeyError(
                        f"unknown letter {bad}. please set X to allow "
                        "scoring for undefined letter pair."
                    )
        return np.asarray([self.index_of(c) for c in seq], dtype=np.int32)

    def get_score(self, a: int, b: int) -> float:
        return float(self.table[a, b])

    def get_score_str(self, a: str, b: str) -> float:
        for s in (a, b):
            if s not in self.letter_to_index:
                raise KeyError(f"{s} was not found in scoring matrix!")
        return float(self.table[self.letter_to_index[a], self.letter_to_index[b]])

    def set_score(self, a: int, b: int, s: float) -> None:
        self.table[a, b] = s

    def dense_scores(self, codes1: np.ndarray, codes2: np.ndarray) -> np.ndarray:
        return self.table[np.ix_(codes1, codes2)].astype(np.float32)


@dataclass
class PositionSpecificMatrix(ScoringMatrix):
    """Position-indexed score matrix: score(i, j) of *positions*, not letters
    (ref: sequence_alignment.rs:583-623).  Enables profile alignment."""

    scores: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    a_length: int = 0
    b_length: int = 0

    def prepare(self, s1, s2) -> None:
        """Size the table for a pair (ref: sequence_alignment.rs:606-612)."""
        la = len(s1.seq) if hasattr(s1, "seq") else len(s1)
        lb = len(s2.seq) if hasattr(s2, "seq") else len(s2)
        self.a_length, self.b_length = la, lb
        if self.scores.shape != (la, lb):
            self.scores = np.zeros((la, lb), dtype=np.float32)

    def seq_to_index(self, seq: Sequence[str], partial: Optional[int] = None) -> np.ndarray:
        n = partial if partial is not None else len(seq)
        return np.arange(n, dtype=np.int32)

    def get_score(self, a: int, b: int) -> float:
        return float(self.scores[a, b])

    def set_score(self, a: int, b: int, s: float) -> None:
        self.scores[a, b] = s

    def dense_scores(self, codes1: np.ndarray, codes2: np.ndarray) -> np.ndarray:
        return self.scores[np.ix_(codes1, codes2)].astype(np.float32)
