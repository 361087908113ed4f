"""The port against the reference's EMBOSS golden fixtures
(tests/test_golden_suite.py over ``smithwaterman_tpu_torch``): the port's
``BatchAligner(device="cpu")`` on the suite's pairs, judged by the port's
own oracle (``utils/oracle.py``: trimTerminal for local, J/U/Z/B/O/X
tolerance).  Skips where the fixtures are absent.

Tolerance: exact equality of strings (bar the tolerated letters), scores
within 1e-4 of EMBOSS's printed ones.
"""

import os

import pytest

from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
from smithwaterman_tpu_torch import load_fasta
from smithwaterman_tpu_torch.utils import oracle

MODES = {"local": LOCAL, "glocal": GLOCAL, "global": GLOBAL}

if not os.path.isdir(oracle.REFERENCE_TEST_DIR):
    pytest.skip("reference fixtures unavailable", allow_module_level=True)

SUITE = oracle.default_suite()
# spread across the suite: different lengths, both parities
SUBSET = [SUITE[i] for i in range(0, len(SUITE), 9)]


@pytest.mark.parametrize("mode_name", ["local", "glocal", "global"])
def test_golden_subset(mode_name):
    pairs = [(load_fasta(c.fasta1)[0], load_fasta(c.fasta2)[0])
             for c in SUBSET]
    got = BatchAligner(mode=MODES[mode_name], device="cpu").align_pairs(
        pairs)
    for case, r in zip(SUBSET, got):
        g = oracle.parse_emboss_dat(case.golden[mode_name])
        a1, a2 = r.aligned1, r.aligned2
        if mode_name == "local":
            a1, a2 = oracle.trim_terminal(a1, a2)
        if (a1, a2) != (g.seq1, g.seq2):
            assert oracle.is_tolerated(a1, a2), (
                f"{case.tag} {mode_name}:\nours  ={a1[:100]}\n"
                f"golden={g.seq1[:100]}")
        if g.score is not None:
            assert abs(r.score - g.score) < 1e-4
