"""Alignment display formatting.

A copy of ``smithwaterman_tpu/utils/display.py`` (:11-26): pure host code,
kept here so the port imports nothing of the JAX package.

The reference's browser UI prints a three-line alignment view with a
middle match line (``:`` marks identical residue pairs,
SmithWaterman.html:364-371); this reproduces that format for terminals.
"""

from __future__ import annotations


def match_line(a1: str, a2: str) -> str:
    """':' where both rows carry the same residue, ' ' elsewhere."""
    return "".join(
        ":" if (x == y and x != "-") else " " for x, y in zip(a1, a2)
    )


def format_alignment(a1: str, a2: str, width: int = 60) -> str:
    """Wrapped three-line blocks: seq1 / match line / seq2."""
    mid = match_line(a1, a2)
    blocks = []
    for k in range(0, len(a1), width):
        blocks.append(
            "\n".join([a1[k : k + width], mid[k : k + width], a2[k : k + width]])
        )
    return "\n\n".join(blocks)
