"""A whole run, on the CPU, at a size a test run holds, with the timed
path broken underneath: each fault the cells can have must make
``correct`` false.  The harness's look for a card is skipped (the
program runs its kernels' plain versions); the cells run on one card, so
there is no exchange between cards to leave out.

Faults: an answer altered where it is produced (a score in the fill's
stats, a letter in the rebuild); half of each batch left out; a call that
returns the state of the call before (stale results).
"""

import pytest

from swbench import harness

from conftest import load_cell

SEED = 2**31 + 77


def tiny(workload):
    bench, cell, config, spec = load_cell(workload)
    spec = dict(spec, pairs_per_call=6, batches=2, check_per_batch=6)
    shared = spec["a"].get("shared", False)
    spec["a"] = dict(spec["a"], length=[150, 150] if shared else [40, 90])
    spec["b"] = {"mutate": dict(spec["b"]["mutate"], indel_every=30,
                                indel_max=4)}
    return bench, cell, config, spec


def run(workload, trace=False):
    bench, cell, config, spec = tiny(workload)
    return harness.run(bench, cell, config, spec, SEED, 0.3, trace, "cpu")


@pytest.mark.parametrize("workload", ["water_protein_long",
                                      "needle_genome_30k"])
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] and r["failed"] == 0
    assert r["pairs_checked"] >= 6
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    # no peak memory on the CPU: its reader finds nothing to read
    assert set(r["metrics"]) == {"gcups", "setup_s"}


def test_traced_run_reads_per_layer_metrics():
    r = run("needle_genome_30k", trace=True)
    assert r["correct"]
    assert {"bucket_ms", "rebuild_ms"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def score_plus_one(monkeypatch):
    from smithwaterman_tpu_torch.ops import fill_dp

    real = fill_dp.fill_many

    def fill_many(*args, **kwargs):
        out = real(*args, **kwargs)
        out.stats[0, 0] += 1.0      # LOCAL's best
        out.stats[0, 3:6] += 1.0    # GLOBAL / GLOCAL's final states
        return out
    monkeypatch.setattr(fill_dp, "fill_many", fill_many)


def letter_changed(monkeypatch):
    from smithwaterman_tpu_torch.ops import reconstruct

    real = reconstruct.reconstruct_packed

    def reconstruct_packed(*args, **kwargs):
        res = real(*args, **kwargs)
        r = res[-1]
        k = next(i for i, c in enumerate(r.aligned1) if c != "-")
        r.aligned1 = (r.aligned1[:k] + ("A" if r.aligned1[k] != "A" else "C")
                      + r.aligned1[k + 1:])
        return res
    monkeypatch.setattr(reconstruct, "reconstruct_packed",
                        reconstruct_packed)


def half_left_out(monkeypatch):
    from smithwaterman_tpu_torch import BatchAligner

    real = BatchAligner.align_pairs

    def align_pairs(self, pairs, retain_all=True):
        half = len(pairs) // 2
        return real(self, pairs[:half], retain_all)
    monkeypatch.setattr(BatchAligner, "align_pairs", align_pairs)


def stale(monkeypatch):
    from smithwaterman_tpu_torch import BatchAligner

    real = BatchAligner.align_pairs
    last = {}

    def align_pairs(self, pairs, retain_all=True):
        out = last.get("res") or real(self, pairs, retain_all)
        last["res"] = real(self, pairs, retain_all)
        return out
    monkeypatch.setattr(BatchAligner, "align_pairs", align_pairs)


@pytest.mark.parametrize("workload", ["water_protein_long",
                                      "needle_genome_30k"])
@pytest.mark.parametrize("fault,count", [
    (score_plus_one, "fill_mismatch"),
    (letter_changed, "rebuild_mismatch"),
    (half_left_out, "missing"),
    (stale, "fill_mismatch"),
])
def test_fault_is_not_correct(monkeypatch, workload, fault, count):
    fault(monkeypatch)
    r = run(workload)
    assert not r["correct"]
    assert r["checks"][count]["value"] > r["checks"][count]["limit"]
