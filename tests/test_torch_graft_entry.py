"""The port's graft entry (``__graft_entry_torch__.py``) on the CPU:
``entry()``'s one score-only fill against the JAX package's scan fill of
the same inputs, and ``dryrun_multichip`` over a mesh of eight CPU shards
(the sharded fill, then one pair striped: ``striped_fill`` and
``striped_align``, whose bests must agree).

Tolerance: exact equality of the stats.
"""

import numpy as np
import pytest
import torch

from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu_torch.config import LOCAL

import __graft_entry_torch__ as graft


def test_entry_matches_jax_scan():
    fn, (table, chunks) = graft.entry(device="cpu")
    assert table.device.type == "cpu"
    stats = fn(table, chunks).numpy()
    (ch,) = chunks
    assert ch.shape == (8, 128, 128)
    S = JaxSM.blosum62().table[ch.codes1[:, :, None].astype(np.int64),
                               ch.codes2[:, None, :].astype(np.int64)]
    ref = jbatch.fill_scan(S.astype(np.float32), ch.n, ch.m, mode=LOCAL,
                           og=graft.OG, eg=graft.EG, score_only=True)
    want = np.zeros((8, 8), np.float32)
    want[:, 0] = np.asarray(ref.best)
    np.testing.assert_array_equal(stats, want)


def test_entry_and_dryrun_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(4)


@pytest.mark.parametrize("shards", [8, 3])
def test_dryrun_multichip_on_cpu_shards(shards, capsys):
    graft.dryrun_multichip(shards, devices=["cpu"] * shards)
    assert f"dryrun_multichip({shards}): ok" in capsys.readouterr().err
