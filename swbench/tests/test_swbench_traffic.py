"""The traffic generator: deterministic for a seed, changed by it, and
each mix gives the lengths and cell counts its cell states."""

import numpy as np
import pytest

from swbench import traffic

SEED = 2**31 + 12345
MIXES = ["protein_long_homologs", "dna_70k_pairs", "viral_genome_variants"]


@pytest.mark.parametrize("name", MIXES)
def test_pool_is_the_seeds(name):
    spec = traffic.load(name)
    assert traffic.pool(spec, SEED) == traffic.pool(spec, SEED)
    other = traffic.pool(spec, SEED + 1)
    assert other != traffic.pool(spec, SEED)
    # the same work for every seed: cells within 0.5 % (indels only)
    for x, y in zip(other, traffic.pool(spec, SEED)):
        assert abs(traffic.cells(x) / traffic.cells(y) - 1) < 5e-3


def test_protein_long_homologs():
    spec = traffic.load("protein_long_homologs")
    pool = traffic.pool(spec, SEED)
    assert len(pool) == 4 and all(len(b) == 256 for b in pool)
    for batch in pool:
        la = sorted(len(a) for a, _ in batch)
        assert la == sorted(traffic.lengths(1500, 4000, 256).tolist())
        assert la[0] >= 1500 and la[-1] <= 4000
        for a, b in batch:
            assert abs(len(b) - len(a)) <= 10
            assert set(a) | set(b) <= set("ARNDCQEGHILKMFPSTWYV")
        assert abs(traffic.cells(batch) / 2.07e9 - 1) < 0.01
    # 30 % substitutions drawn over 20 letters change ~28.5 % of letters
    a, b = pool[0][0]
    same = sum(x == y for x, y in zip(a[:90], b[:90]))
    assert 40 <= same <= 85
    assert len({a for batch in pool for a, _ in batch}) == 1024


def test_protein_composition_is_swiss_prots():
    spec = traffic.load("protein_long_homologs")
    pool = traffic.pool(spec, SEED)
    text = "".join(a for batch in pool[:2] for a, _ in batch)
    share = spec["composition"]
    total = sum(share.values())
    for letter in "LAWC":
        got = text.count(letter) / len(text)
        assert abs(got / (share[letter] / total) - 1) < 0.05, letter


def test_a_mix_may_name_its_generator(tmp_path, monkeypatch):
    """A mix whose file names a ``generator`` is made by that module of
    the traffic folder; the others by the default generator."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "fixed_pairs.py").write_text(
        "def pool(spec, seed):\n"
        "    return [[(spec['a'], spec['b'] * (seed % 3 + 1))]]\n")
    monkeypatch.setattr(traffic, "HERE", str(tmp_path))
    spec = {"generator": "fixed_pairs", "a": "ACGT", "b": "AC"}
    assert traffic.pool(spec, 4) == [[("ACGT", "ACAC")]]
    dna = {"alphabet": "ACGT", "pairs_per_call": 2, "batches": 1,
           "a": {"length": [10, 20]}, "b": {"length": [5, 5]}}
    assert traffic.pool(dna, 4) == traffic.homologs(dna, 4)


def test_dna_70k_pairs():
    pool = traffic.pool(traffic.load("dna_70k_pairs"), SEED)
    assert len(pool) == 2 and all(len(b) == 4 for b in pool)
    for batch in pool:
        for a, b in batch:
            assert len(a) == 70000 and abs(len(b) - 70000) <= 20
            assert set(a) | set(b) <= set("ACGT")
        assert abs(traffic.cells(batch) / 1.96e10 - 1) < 0.001


def test_viral_genome_variants():
    pool = traffic.pool(traffic.load("viral_genome_variants"), SEED)
    assert len(pool) == 2 and all(len(b) == 4 for b in pool)
    refs = {a for batch in pool for a, _ in batch}
    assert len(refs) == 1 and len(next(iter(refs))) == 29903
    variants = [b for batch in pool for _, b in batch]
    assert len(set(variants)) == 8
    # every variant stays in the reference's bucket (29,952 = 117 * 256)
    assert all(29903 - 30 <= len(b) <= 29952 for b in variants)
    for batch in pool:
        assert abs(traffic.cells(batch) / 3.58e9 - 1) < 0.002


def test_mutate_by_hand():
    rng = np.random.default_rng(0)
    codes = np.arange(10) % 4
    same = traffic.mutate(codes, rng, 4, sub_rate=0.0, indel_every=100,
                          indel_max=5)
    assert same.tolist() == codes.tolist()
    out = traffic.mutate(np.zeros(30, np.int64), np.random.default_rng(1),
                         4, sub_rate=0.0, indel_every=10, indel_max=1)
    # one insertion and one deletion of one letter, in turn
    assert len(out) == 30
    assert traffic.lengths(1, 3, 3).tolist() == [1, 2, 3]
    assert traffic.letters(np.array([2, 0, 1]), "ACGT") == "GAC"
