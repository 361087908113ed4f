"""The rooflines' work counts on hand-worked shapes."""

import pytest

from swbench import roofline


def test_fill_work_by_hand():
    # LOCAL, one 2 x 3 pair and one 4 x 5 pair, a 24-letter table, 2 calls
    ops, nbytes = roofline.fill_work("local", [(2, 3), (4, 5)], 24, 2)
    assert ops == 26 * (6 + 20)
    assert nbytes == 0.75 * 26 + (5 + 9) + 12 * 2 + 4 * 24 * 24 * 2
    ops, _ = roofline.fill_work("glocal", [(2, 3)], 4, 1)
    assert ops == 19 * 6


def test_least_names_its_bound():
    t, by = roofline.least(67e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = roofline.least(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
    # a 70 kbp GLOCAL pair: operations bound it, ~1.4 ms
    t, by = roofline.least(*roofline.fill_work("glocal", [(70000, 70000)],
                                               4, 1))
    assert by == "operations" and t == pytest.approx(19 * 4.9e9 / 67e12)


def test_walk_work_and_path_steps():
    assert roofline.walk_work(10) == (40, 5.0)
    # "xxACG-T" over "--AC-GT" with seq1 = xxACGT (6), seq2 = ACGT (4):
    # the core ACG-T / AC-GT spans seq1 2..5 and seq2 0..3
    a1, a2 = "xxACG-T", "--AC-GT"
    assert roofline.path_steps(a1, 6, 4, 2, 5, 0, 3) == 5
    # LOCAL with unaligned heads and tails: AxxB / ----B over seq2 yyB
    assert roofline.path_steps("A--B", 2, 3, 1, 1, 2, 2) == 1
    assert roofline.path_steps("AC---", 2, 3, -1, -1, -1, -1) == 0
