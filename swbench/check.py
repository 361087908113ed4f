"""The comparison that decides ``correct``.

What the window's calls returned is held against the plain reference
(``references/<name>.py``), which works every sampled pair out again from
its sequences.  The entry (``entries/<name>.py``) turns each of the
program's results into the reference's form (``Entry.record``), and the
reference says which fields each layer of the program decides
(``layers(config, result)``): for alignments, ``fill`` (the score, and in
LOCAL the end cell), ``walk`` (where the path starts, and outside LOCAL
where it ends) and ``rebuild`` (both aligned strings).  A reference of
scores alone gives ``fill`` alone, and only that is compared.

The sample is drawn from the seed before the window: ``check_per_batch``
pairs of every batch, the batch's largest (by n * m) always among them.
Every call's results at the sampled positions are compared with the
reference; a call that returns another number of results than it was
sent pairs, or an empty one, counts the difference as ``missing``.  The
alignments are exact, so every limit is 0.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from . import traffic

LIMITS = {"missing": 0, "fill_mismatch": 0, "walk_mismatch": 0,
          "rebuild_mismatch": 0}

Layers = Callable[[tuple], Dict[str, tuple]]


def sample(batches: Sequence[Sequence[Tuple[str, str]]], per_batch: int,
           seed: int) -> Dict[int, List[int]]:
    """Batch -> the pair positions the reference checks."""
    out = {}
    for b, pairs in enumerate(batches):
        rng = traffic.rng_for(seed, 2, b)
        big = int(np.argmax([len(x) * len(y) for x, y in pairs]))
        rest = [k for k in range(len(pairs)) if k != big]
        take = min(per_batch, len(pairs)) - 1
        pick = rng.choice(rest, size=take, replace=False).tolist() \
            if take > 0 else []
        out[b] = sorted([big] + pick)
    return out


def mismatched(layers: Layers, got: tuple, want: tuple) -> List[str]:
    """The layers at which one result (in the reference's form) differs
    from the reference's; a layer the result lacks differs."""
    mine = layers(got)
    return [name for name, value in layers(want).items()
            if mine.get(name) != value]


def compare(layers: Layers, calls: Sequence, sizes: Sequence[int],
            picks: Dict[int, List[int]],
            reference: Dict[Tuple[int, int], tuple]) -> Dict[str, int]:
    """Counts of each kind of fault over the window's calls
    (``harness.Call``: batch, results returned and empty, the records
    kept at ``picks``), with ``sizes`` the pairs of each batch and
    ``layers`` the reference's split of a result into layers, plus
    ``checked``: the results held against the reference."""
    counts = dict.fromkeys(LIMITS, 0)
    counts["checked"] = 0
    for c in calls:
        if c.returned is None:
            continue  # a call that raised: its pairs count as failed
        want = sizes[c.batch]
        counts["missing"] += abs(c.returned - want) + c.empty
        for k, r in zip(picks[c.batch], c.kept):
            counts["checked"] += 1
            if r is None:
                continue
            for layer in mismatched(layers, r, reference[(c.batch, k)]):
                counts[f"{layer}_mismatch"] += 1
    return counts


def correct(counts: Dict[str, int]) -> bool:
    return counts["checked"] > 0 and all(
        counts[k] <= limit for k, limit in LIMITS.items())
