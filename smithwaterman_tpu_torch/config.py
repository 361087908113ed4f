"""Alignment configuration (a copy of ``smithwaterman_tpu.config``).

The reference hardcodes gap penalties in its CLIs (go=10, ge=0.5;
rust/sequence_alignment/src/main.rs:34) while its engines accept any values;
we expose them in one dataclass together with the bucket ladder.  The module
is framework-free and kept identical in behaviour to the JAX package's
(tests/test_torch_host.py asserts it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

# Alignment modes (semantics parity: sequence_alignment.rs:11-13)
GLOBAL = 0  # EMBOSS `needle -endweight Y`
GLOCAL = 1  # EMBOSS `needle` (end gaps free)
LOCAL = 2   # EMBOSS `water`

MODE_NAMES = {GLOBAL: "global", GLOCAL: "glocal", LOCAL: "local"}
MODE_MESSAGES = {
    GLOBAL: "Global alignment",
    GLOCAL: "Glocal alignment",
    LOCAL: "Local alignment",
}

# Traceback state codes (parity: sequence_alignment.rs:7-9)
CELL_MATCH = 0
CELL_GAPINX = 1  # gap in seq1 (consumes seq2 / j axis)
CELL_GAPINY = 2  # gap in seq2 (consumes seq1 / i axis)
# Local-mode "score is zero here, stop traceback" marker (2-bit packed).
CELL_STOP = 3

# Default padded-length ladder for shape bucketing (median reference test
# length is ~438, max 3685).  128-multiples through 2048, where most real
# protein lengths live, then coarser.  On the GPU a bucket fixes the
# pointer-array layout of its pairs and keeps the lengths inside one warp
# close, so the one-thread-per-pair fill wastes few lockstep iterations.
# Workloads with a known length distribution can do better still: see
# :func:`ladder_for_lengths`.
DEFAULT_BUCKETS: Tuple[int, ...] = (
    64, 128, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536, 1792, 2048,
    2560, 3072, 3584, 4096, 5120, 6144, 7168, 8192,
)


@dataclass(frozen=True)
class AlignConfig:
    mode: int = LOCAL
    gap_open: float = 10.0   # stored positive, negated internally
    gap_extend: float = 0.5
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        # The engines' vectorized recurrences (max-plus cummax for the X
        # state, boundary closed forms) are bit-exact vs the reference's
        # sequential recurrence only when every partial sum is exactly
        # representable in f32 — guaranteed for quarter-integer penalties
        # (all reference CLIs use go=10, ge=0.5).  Arbitrary floats (e.g.
        # 0.1) can diverge in the last ulp and flip equality-sensitive
        # tie-breaks, changing alignment strings.
        import warnings

        for name, v in (("gap_open", self.gap_open), ("gap_extend", self.gap_extend)):
            if (abs(v) * 4.0) != round(abs(v) * 4.0):
                warnings.warn(
                    f"{name}={v} is not a multiple of 0.25: scores may differ "
                    "from a sequential implementation in the last ulp and "
                    "tie-breaks (hence alignment strings) may diverge",
                    stacklevel=2,
                )

    @property
    def og(self) -> float:
        return -abs(self.gap_open)

    @property
    def eg(self) -> float:
        return -abs(self.gap_extend)

    @property
    def mode_name(self) -> str:
        return MODE_NAMES[self.mode]


def bucket_len(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (last bucket is a hard cap -> rounded up to a
    multiple of 256 beyond the ladder)."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 256) * 256


def ladder_for_lengths(
    lengths, max_rungs: int = 12, quantum: int = 128
) -> Tuple[int, ...]:
    """Pick a bucket ladder matched to an observed length distribution.

    Rungs are placed at equal-mass quantiles of the distribution, rounded
    up to ``quantum``, so padding concentrates where sequences actually
    are: each rung absorbs ~1/max_rungs of the sequences with at most one
    quantum of per-dimension padding inside dense regions.  Use for
    production sweeps with known inputs (``AlignConfig(buckets=
    ladder_for_lengths([len(s.seq) for s in seqs]))``).
    """
    import numpy as np

    ls = np.asarray(sorted(int(x) for x in lengths if int(x) > 0))
    if ls.size == 0:
        return DEFAULT_BUCKETS
    rungs = set()
    for q in np.linspace(0.0, 1.0, max(2, max_rungs)):
        v = int(np.quantile(ls, q, method="higher"))
        rungs.add(max(quantum, -(-v // quantum) * quantum))
    if ls[0] <= 64:
        rungs.add(64)  # sub-64 pairs shouldn't pad to a full lane tile
    return tuple(sorted(rungs))
