"""The harness's own tests (run on the CPU: ``python -m pytest
swbench/tests -q``).  They import the benchmark as the package
``swbench`` from the checkout's root."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


# cells whose files this folder holds but BENCHMARK.json does not run
# yet (PERF.md, Open questions): their paths are tested all the same
HELD = {
    "water_protein_long": {"name": "water_protein_long",
                           "config": "emboss_water_protein",
                           "traffic": "protein_long_homologs", "chips": 1},
}


def load_cell(workload):
    """(benchmark, cell, configuration, traffic mix), as
    ``harness.load_cell`` gives them, of a cell of BENCHMARK.json or of
    :data:`HELD`."""
    import json

    from swbench import harness, traffic

    if workload not in HELD:
        return harness.load_cell(ROOT, workload)
    cell = HELD[workload]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "swbench", "configs",
                           cell["config"] + ".json")) as f:
        config = json.load(f)
    return bench, cell, config, traffic.load(cell["traffic"])
