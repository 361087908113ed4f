"""The control at a size a test run holds: the reference in bfloat16, put
in the program's place, fails the run's comparison on every cell's mix;
in float32 it passes it."""

import pytest
import torch

from swbench import control

from conftest import load_cell


@pytest.mark.parametrize("workload", ["water_protein_long", "needle_dna_70k",
                                      "needle_genome_30k"])
def test_control_fails_the_comparison(workload):
    _, cell, config, spec = load_cell(workload)
    shared = spec["a"].get("shared", False)
    spec = dict(spec, pairs_per_call=4, batches=2, check_per_batch=4,
                a=dict(spec["a"], length=[600, 600] if shared
                       else [300, 600]))
    spec["b"] = {"mutate": dict(spec["b"]["mutate"], indel_every=150)}
    low = control.control(cell, config, spec, 2**31 + 3, torch.bfloat16,
                          "cpu")
    assert low["checked"] == 8 and not low["correct"]
    assert any(c["value"] > c["limit"] for c in low["checks"].values())
    same = control.control(cell, config, spec, 2**31 + 3, torch.float32,
                           "cpu")
    assert same["correct"]
    assert all(c["value"] == 0 for c in same["checks"].values())
