"""Tests that need an NVIDIA card (marked ``gpu``; each decides in the
``card`` fixture and skips without one).  On a card:

    python3 -m pytest swbench/tests/test_swbench_card.py -q
"""

import numpy as np
import pytest

from swbench import devtrace
from swbench.references import gotoh

from conftest import ROOT

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


def pairs(seed, count, lo, hi, letters="ARNDCQEGHILKMFPSTWYV"):
    rng = np.random.default_rng(seed)
    alpha = np.array(list(letters))
    out = []
    for _ in range(count):
        a = "".join(rng.choice(alpha, int(rng.integers(lo, hi))))
        cut = int(rng.integers(0, len(a) // 3))
        b = a[cut:] + "".join(rng.choice(alpha, int(rng.integers(1, 40))))
        out.append((a, b))
    return out


def test_every_program_kernel_has_a_stage_by_its_printed_name(card,
                                                              monkeypatch):
    """Each of the program's CUDA kernels (K1-K13) runs once under the
    profiler; the function name the profiler prints is in a stage file."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import smithwaterman_tpu_torch as swt
    from smithwaterman_tpu_torch.parallel import data_parallel, seq_tiled

    ps = pairs(1, 16, 100, 300)
    S = torch.randint(-4, 6, (1, 128, 1024), dtype=torch.float32,
                      device=card)
    n = np.array([128], np.int32)
    m = np.array([1024], np.int32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        swt.BatchAligner(device=card).align_pairs(ps)            # K1, K2
        swt.BatchAligner(device=card, mode=swt.GLOBAL,
                         longseq_cells=1).align_pairs(ps[:4])    # K3-K5
        swt.Aligner(device=card).align_banded(*ps[0], band=64)   # K6-K8
        swt.BatchAligner(device=card, diag_scores=True).score_pairs(ps)
        monkeypatch.setenv("SWTPU_TOKEN_WALK", "1")
        swt.BatchAligner(device=card).align_pairs(ps)            # K10, K11
        monkeypatch.delenv("SWTPU_TOKEN_WALK")
        for d in (1, 4):                                         # K13, K12
            seq_tiled.striped_fill(
                S, n, m, mode=swt.LOCAL, og=-10.0, eg=-0.5, block_rows=64,
                mesh=data_parallel.make_mesh(devices=[card] * d))
        torch.cuda.synchronize()
    seen = {devtrace.kernel_base(e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA}
    known = set(devtrace.program_kernels(
        os.path.join(ROOT, "smithwaterman_tpu_torch", "csrc")))
    stages = devtrace.load_stages()
    print("kernels seen:", sorted(seen & known))
    assert known <= seen
    assert known <= set(stages)


@pytest.mark.parametrize("mode", ["local", "glocal", "global"])
def test_reference_in_graphs_matches_the_cpu(card, mode):
    """On a card the reference replays captured CUDA graphs of rows; on
    the CPU it runs every row by itself: the results are the same."""
    import json
    import os

    with open(os.path.join(ROOT, "swbench", "configs",
                           "emboss_water_protein.json")) as f:
        cfg = dict(json.load(f), mode=mode)
    ps = pairs(2, 12, 2 * gotoh.GRAPH_ROWS + 10, 700)
    assert gotoh.align(ps, cfg, card) == gotoh.align(ps, cfg, "cpu")
