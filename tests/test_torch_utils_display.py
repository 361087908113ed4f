"""The port's copies of the display and EMBOSS-oracle utilities
(smithwaterman_tpu_torch/utils/display.py, oracle.py) against the JAX
package's, on seeded random inputs: ``match_line``, ``format_alignment``,
``trim_terminal``, ``is_tolerated``, ``parse_emboss_dat`` and
``discover_suite``.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from smithwaterman_tpu.utils import display as jdisplay
from smithwaterman_tpu.utils import oracle as joracle
from smithwaterman_tpu_torch.utils import display, oracle

ALPHABET = np.array(list("ACDEFGHIKLMNPQRSTVWYBJOUXZ-"))


def _rows(rng):
    """Two alignment rows of one length, with gapped ends on either row."""
    lead, k, tail = (int(x) for x in rng.integers(0, [4, 140, 4]))

    def letters(count):
        return "".join(rng.choice(ALPHABET[:-1], count))

    a = "-" * lead + "".join(rng.choice(ALPHABET, k)) + letters(tail)
    b = letters(lead) + "".join(rng.choice(ALPHABET, k)) + "-" * tail
    return a, b


@pytest.mark.parametrize("seed", range(4))
def test_display_and_oracle_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a1, a2 = _rows(rng)
        width = int(rng.integers(1, 80))
        assert display.match_line(a1, a2) == jdisplay.match_line(a1, a2)
        assert display.format_alignment(a1, a2, width) == \
            jdisplay.format_alignment(a1, a2, width)
        assert oracle.trim_terminal(a1, a2) == joracle.trim_terminal(a1, a2)
        assert oracle.is_tolerated(a1, a2) == joracle.is_tolerated(a1, a2)


def test_parse_emboss_dat_matches_jax(tmp_path):
    rng = np.random.default_rng(7)
    lines = ["########################################",
             "# Program: water", "#", "# Score: 57.5", "#====="]
    for k in range(4):
        s1 = "".join(rng.choice(ALPHABET, 50))
        s2 = "".join(rng.choice(ALPHABET, 50))
        lines += [f"s1 {1 + 50 * k:>10} {s1} {50 * (k + 1)}",
                  "                " + display.match_line(s1, s2),
                  f"s2 {1 + 50 * k:>10} {s2} {50 * (k + 1)}", ""]
    path = tmp_path / "res1.dat"
    path.write_text("\n".join(lines) + "\n")
    got = oracle.parse_emboss_dat(str(path))
    want = joracle.parse_emboss_dat(str(path))
    assert (got.seq1, got.seq2, got.score) == (want.seq1, want.seq2,
                                                want.score)
    assert got.score == 57.5 and len(got.seq1) == 200


def test_discover_suite_matches_jax(tmp_path):
    inputs = tmp_path / "inputs"
    inputs.mkdir()
    (tmp_path / "emboss_results").mkdir()
    for k in (10, 2, 1):
        for side in (1, 2):
            (inputs / f"seq{k}.{side}.fas").write_text(">s\nACGT\n")
    (inputs / "README").write_text("")
    got = oracle.discover_suite(str(tmp_path))
    want = joracle.discover_suite(str(tmp_path))
    assert [c.tag for c in got] == ["seq1", "seq2", "seq10"]
    assert [(c.tag, c.fasta1, c.fasta2, c.golden) for c in got] == \
        [(c.tag, c.fasta1, c.fasta2, c.golden) for c in want]
    assert oracle.REFERENCE_TEST_DIR == joracle.REFERENCE_TEST_DIR
