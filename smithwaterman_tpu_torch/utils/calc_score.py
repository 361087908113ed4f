"""Recompute an alignment score from two gapped strings.

Parity with the reference's standalone checker ``test/calc_score.pl:86-101``:
walk columns left to right; a residue-residue column adds the substitution
score; a gap column is charged ``gap_open`` if the previous column was a
residue-residue column, else ``gap_extend`` — and leading gap columns (before
the first residue-residue column) are free.  (Note: like the reference
utility, trailing gap columns *are* charged; feed trimmed alignments when
scoring local mode.)
"""

from __future__ import annotations

import sys
from typing import Optional

from ..matrices import ScoringMatrix, SubstitutionMatrix


def recalc_score(
    a1: str,
    a2: str,
    matrix: Optional[ScoringMatrix] = None,
    gap_open: float = 10.0,
    gap_extend: float = 0.5,
) -> float:
    if matrix is None:
        matrix = SubstitutionMatrix.blosum62()
    if len(a1) != len(a2):
        raise ValueError("aligned strings must have equal length")
    score = 0.0
    seen_match_col = False
    for ii in range(len(a1)):
        x, y = a1[ii], a2[ii]
        if x != "-" and y != "-":
            seen_match_col = True
            score += matrix.get_score(matrix.index_of(x), matrix.index_of(y))
        elif seen_match_col:
            if ii > 0 and (a1[ii - 1] == "-" or a2[ii - 1] == "-"):
                score -= gap_extend
            else:
                score -= gap_open
    return score


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        sys.stderr.write(
            "usage: python -m smithwaterman_tpu_torch.utils.calc_score "
            "<aligned1> <aligned2> [gap_open gap_extend]\n"
        )
        sys.exit(2)
    go = float(args[2]) if len(args) > 2 else 10.0
    ge = float(args[3]) if len(args) > 3 else 0.5
    score = recalc_score(args[0], args[1], gap_open=go, gap_extend=ge)
    print(int(score) if score == int(score) else score)


if __name__ == "__main__":
    main()
