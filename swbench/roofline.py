"""The yardstick of the per-layer rooflines: the work, not the kernels.

A fill or a walk is counted by what the alignment needs, whatever kernel
does it and however often it re-reads or re-fills, so that a change that
moves pairs to another route or kernel keeps the same yardstick.  The
least time of a piece of work is the larger of its operations at the
card's peak rate and its bytes at the card's peak bandwidth; a roofline
share is that least time over the device time the stage's kernels took.

Peaks: one NVIDIA H100 SXM by NVIDIA's data sheet, float32 outside the
tensor cores (67 TFLOP/s) and HBM3 (3.35 TB/s), at the full 700 W; the run
prints the card's power limit beside them.

Fill, a cell (i, j) of Gotoh's three-state recurrence with pointers:

* values: M = max(M, X, Y) of the diagonal + s(i, j): 2 maxima, 1 add;
  Y = max(max(M, X) + open, Y + extend) from above: 2 maxima, 2 adds;
  X the same from the left: 2 maxima, 2 adds.  11 operations.
* pointers: each state's predecessor is the first of three candidates,
  2 compares a state: 6; the three 2-bit codes packed: 2.  8 operations.
* LOCAL adds the clamp of each state at 0 (3), each state's test for the
  zero that stops a walk (3) and the compare with the running best (1).

So 19 operations a cell in GLOBAL and GLOCAL, 26 in LOCAL, over the true
cells, the sum of n * m (no padding, no refill).  Bytes: the three 2-bit
pointers of a cell written once (0.75 bytes a cell), each pair's codes
read once (n + m bytes) and its end state written once (score and end
cell, 12 bytes), and the table read once a call (K * K * 4 bytes).

Walk, a step of a finished alignment's path: the step's 2-bit pointer read
and its 2-bit move written (0.5 bytes), and 4 operations (extract the
code, choose the move, update i and j).  The steps of a pair are the
columns of its alignment between its first and last aligned residues
(``path_steps``); the entry the window drives counts them from its
results (``Entry.steps``), and an entry whose results hold no path (scores
alone) counts none.
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

CELL_OPS = {"global": 19, "glocal": 19, "local": 26}
CELL_BYTES = 0.75
PAIR_BYTES = 12
STEP_OPS = 4
STEP_BYTES = 0.5


def least(ops: float, nbytes: float) -> Tuple[float, str]:
    """(seconds, "operations" or "bytes"): the least time of the work at
    the peaks, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fill_work(mode: str, lens: Sequence[Tuple[int, int]], symbols: int,
              calls: int) -> Tuple[float, float]:
    """(operations, bytes) of filling pairs of lengths ``lens`` (n, m),
    with a table of ``symbols`` letters read once in each of ``calls``."""
    cells = sum(n * m for n, m in lens)
    codes = sum(n + m for n, m in lens)
    nbytes = (CELL_BYTES * cells + codes + PAIR_BYTES * len(lens)
              + 4 * symbols * symbols * calls)
    return CELL_OPS[mode] * cells, nbytes


def walk_work(steps: int) -> Tuple[float, float]:
    """(operations, bytes) of walking ``steps`` path steps."""
    return STEP_OPS * steps, STEP_BYTES * steps


def path_steps(aligned1: str, len1: int, len2: int, s1: int, e1: int,
               s2: int, e2: int) -> int:
    """Columns of an alignment printed with every letter retained between
    its first and last aligned residues (0 when nothing aligned)."""
    if s1 < 0 or s2 < 0:
        return 0
    return len(aligned1) - s1 - s2 - (len1 - e1 - 1) - (len2 - e2 - 1)
