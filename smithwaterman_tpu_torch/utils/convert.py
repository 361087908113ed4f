"""Carry state across from the JAX package.

The system has no weights: its state is the scoring table, the gap
penalties, the mode and the bucket ladder.  :func:`from_jax_state` builds
the port's objects from that state given as numpy arrays and plain values
(what ``smithwaterman_tpu``'s ``SubstitutionMatrix`` and ``AlignConfig``
hold), so both packages compute the same thing from one source.
:func:`from_jax_striped` carries the JAX striped fill's outputs across, so a
band re-fill of the port can start from the JAX package's own checkpoints.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..matrices import SubstitutionMatrix


def from_jax_state(
    table: np.ndarray,
    alphabet: Sequence[str],
    gap_open: float,
    gap_extend: float,
    mode: int,
    buckets: Sequence[int],
) -> Tuple[SubstitutionMatrix, AlignConfig]:
    """``(SubstitutionMatrix, AlignConfig)`` of the port from the JAX
    package's state: a (K, K) table, its K symbols in index order (a string
    or a list), the positive penalties, the mode and the bucket ladder."""
    letters = list(alphabet)
    table = np.array(table, dtype=np.float32)
    if table.shape != (len(letters), len(letters)):
        raise ValueError(
            f"table {table.shape} does not match {len(letters)} symbols")
    sm = SubstitutionMatrix(
        letters=letters,
        table=table,
        letter_to_index={c: i for i, c in enumerate(letters)},
    )
    cfg = AlignConfig(mode=int(mode), gap_open=float(gap_open),
                      gap_extend=float(gap_extend),
                      buckets=tuple(int(b) for b in buckets))
    return sm, cfg


def from_jax_striped(stats, ckpts: Optional[Sequence] = None,
                     device="cpu"):
    """Port tensors from ``smithwaterman_tpu.parallel.seq_tiled``'s outputs:
    ``stats`` ((B,) / (B, 3) of ``striped_fill``, (B, 8) of
    ``striped_fill_ckpt``) as f32, and the checkpoints ``(ckm, ckx, cky)``,
    each (B, NCK, MP) sharded on columns over the JAX mesh: ``np.asarray``
    gathers a sharded array's shards in column order, so each comes back
    whole.  Any array type with ``__array__`` is taken; JAX is not
    imported.  Returns ``stats``, or ``(stats, (ckm, ckx, cky))``."""
    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    if ckpts is None:
        return tensor(stats)
    return tensor(stats), tuple(tensor(a) for a in ckpts)
