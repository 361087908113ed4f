"""No run loads JAX or the JAX package, compared by whole top-level
names (the program's name begins with the JAX package's); a run without
enough cards, or without the program beside the benchmark, exits
non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "smithwaterman_tpu"}

PROBE = r"""
import glob, os, sys
sys.path.insert(0, {root!r})
from swbench import check, control, devtrace, harness, roofline, traffic
for folder in ("entries", "metrics", "references"):
    for path in glob.glob(os.path.join({root!r}, "swbench", folder, "*.py")):
        harness.load_module(folder, os.path.basename(path)[:-3])
sys.path.insert(0, os.path.join({root!r}, "swbench"))
import run
import smithwaterman_tpu_torch
from swbench.entries import batch_aligner
config = {{"entry_matrix": "mat_5_-4", "gap_open": 10.0, "gap_extend": 0.5,
           "mode": "glocal"}}
batch_aligner.Entry(config, "cpu")([("ACGTACGT", "ACGGT")])
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_the_benchmark_and_the_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                         capture_output=True, text=True, env=clean_env(),
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert "smithwaterman_tpu_torch" in names and "swbench" in names
    assert not names & FORBIDDEN


def test_forbidden_names_are_whole_names():
    sys.path.insert(0, os.path.join(ROOT, "swbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        sys.modules["smithwaterman_tpu_torch_extra"] = sys
        for name in list(sys.modules):
            if name.split(".")[0] in FORBIDDEN:
                del sys.modules[name]
        assert run.forbidden_loaded() == []
        sys.modules["jax.numpy"] = sys
        sys.modules["smithwaterman_tpu.ops"] = sys
        assert run.forbidden_loaded() == ["jax", "smithwaterman_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def run_cmd(cwd):
    return subprocess.run(
        [sys.executable, "swbench/run.py", "--workload", "needle_genome_30k",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, env=clean_env(),
        timeout=600)


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # this test is about a machine without a card
    out = run_cmd(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "swbench"), tmp_path / "swbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""
