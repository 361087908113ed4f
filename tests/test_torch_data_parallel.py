"""Pair sharding in the port against the JAX package's and the unsharded
port, on the CPU.

``BatchAligner(device_axis=DataParallel(make_mesh(devices=["cpu"] * 8)))``
shards each flush's pairs over eight CPU shards, each running the kernels'
plain versions.  It is held against the JAX package's
``BatchAligner(backend="pallas_interpret", device_axis=DataParallel(
make_mesh(8)))`` on the eight CPU devices ``tests/conftest.py`` forces
(LOCAL, short pairs: interpret mode is slow), against JAX's
``backend="scan"`` path and against the port's unsharded path in every
mode, and ``DataParallel``'s methods against the unsharded plain versions
and JAX's ``DataParallel.fill_pallas``.

Tolerance: exact equality of strings, scores, spans, stats, pointer bytes,
move counts and moves.
"""

import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu.parallel import DataParallel as JaxDataParallel
from smithwaterman_tpu.parallel import make_mesh as jax_mesh
from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
from smithwaterman_tpu_torch.ops import batch, device_walk, diag_dp, fill_dp
from smithwaterman_tpu_torch.parallel import DataParallel, make_mesh

MODES = [LOCAL, GLOCAL, GLOBAL]
LETTERS = np.array(list("ARNDCQEGHILKMFPSTWYV"))
OG, EG = -10.0, -0.5


def _dp(shards=8):
    return DataParallel(make_mesh(devices=["cpu"] * shards))


def _short_pairs():
    """tests/test_batch_aligner.py's mixed short pairs, degenerate and
    ambiguous ones included."""
    return [("HEAGAWGHEE", "PAWHEAE"), ("AAAAASSSSSS", "NNNNNSSSSSS"),
            ("", "ACDEF"), ("W", "W"), ("KKKK", "LLLL"),
            ("ACDJU", "ACDXX"), ("MKVS", "MKVS")]


def _pairs(seed, count=21, lmax=60):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        a = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        b = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        if k % 3 == 0 and len(a) > 20:  # a shared motif
            cut = int(rng.integers(0, len(a) - 15))
            b = b[:10] + a[cut:cut + 15] + b[10:]
        out.append((a, b))
    return out + [("", "ACDEF"), ("W", "")]


def _key(r):
    return (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
            r.end2)


def _keys(rs):
    return [_key(r) for r in rs]


class _Spy(DataParallel):
    """Counts the sharded calls a BatchAligner makes."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.calls = {"fill_many": 0, "fill_walk_packed": 0, "fill_diag": 0}

    def fill_many(self, *a, **k):
        self.calls["fill_many"] += 1
        return super().fill_many(*a, **k)

    def fill_walk_packed(self, *a, **k):
        self.calls["fill_walk_packed"] += 1
        return super().fill_walk_packed(*a, **k)

    def fill_diag(self, *a, **k):
        self.calls["fill_diag"] += 1
        return super().fill_diag(*a, **k)


# ------------------------------------------------ BatchAligner(device_axis=)
def test_sharded_local_matches_jax_sharded_pallas():
    """28 short pairs on 8 shards: the port's sharded path, JAX's sharded
    Pallas path (interpret mode) and the port's unsharded path agree."""
    import jax

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    pairs = _short_pairs() * 4
    ours = BatchAligner(mode=LOCAL, device_axis=_dp()).align_pairs(pairs)
    theirs = jswt.BatchAligner(
        mode=LOCAL, backend="pallas_interpret",
        device_axis=JaxDataParallel(jax_mesh(8))).align_pairs(pairs)
    unsharded = BatchAligner(mode=LOCAL, device="cpu").align_pairs(pairs)
    assert _keys(ours) == _keys(theirs) == _keys(unsharded)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_jax_scan_and_unsharded(mode):
    """23 pairs (not a multiple of 8, two of them empty on one side):
    alignments and scores."""
    pairs = _pairs(300 + mode)
    spy = _Spy(make_mesh(devices=["cpu"] * 8))
    eng = BatchAligner(mode=mode, device_axis=spy)
    ours = eng.align_pairs(pairs)
    theirs = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    unsharded = BatchAligner(mode=mode, device="cpu").align_pairs(pairs)
    assert _keys(ours) == _keys(theirs) == _keys(unsharded)
    scores = eng.score_pairs(pairs)
    np.testing.assert_array_equal(
        scores, jswt.BatchAligner(mode=mode, backend="scan").score_pairs(
            pairs))
    np.testing.assert_array_equal(scores, [r.score for r in ours])
    assert spy.calls["fill_walk_packed"] >= 1 and spy.calls["fill_many"] >= 1
    assert spy.calls["fill_diag"] == 0


def test_sharded_diag_scores():
    """The wavefront route under device_axis: every score equal to JAX's
    scan path and the unsharded port, through DataParallel.fill_diag."""
    pairs = _pairs(31)
    spy = _Spy(make_mesh(devices=["cpu"] * 8))
    got = BatchAligner(mode=LOCAL, device_axis=spy,
                       diag_scores=True).score_pairs(pairs)
    assert spy.calls == {"fill_many": 0, "fill_walk_packed": 0,
                         "fill_diag": 1}
    np.testing.assert_array_equal(
        got, jswt.BatchAligner(mode=LOCAL, backend="scan").score_pairs(pairs))
    np.testing.assert_array_equal(
        got, BatchAligner(mode=LOCAL, device="cpu",
                          diag_scores=True).score_pairs(pairs))


@pytest.mark.parametrize("mode", MODES)
def test_three_pairs_on_eight_shards(mode):
    pairs = [("HEAGAWGHEE", "PAWHEAE"), ("MKVSA", "MKVS"), ("", "W")]
    eng = BatchAligner(mode=mode, device_axis=_dp())
    want = jswt.BatchAligner(mode=mode, backend="scan")
    assert _keys(eng.align_pairs(pairs)) == _keys(want.align_pairs(pairs))
    np.testing.assert_array_equal(eng.score_pairs(pairs),
                                  want.score_pairs(pairs))


def test_only_empty_pairs():
    pairs = [("", ""), ("", "ACD"), ("W", "")]
    for mode in MODES:
        got = BatchAligner(mode=mode, device_axis=_dp()).align_pairs(pairs)
        want = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
        assert _keys(got) == _keys(want)


def test_several_buckets_and_flushes(monkeypatch):
    """A pointer budget of three 128 x 128 pairs cuts the sharded batch into
    several flushes over several buckets; input order and results hold."""
    pairs = _pairs(41, count=24, lmax=150)
    base = BatchAligner(mode=GLOBAL, device="cpu").align_pairs(pairs)
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(3 * 128 * 128))
    spy = _Spy(make_mesh(devices=["cpu"] * 8))
    got = BatchAligner(mode=GLOBAL, device_axis=spy).align_pairs(pairs)
    assert spy.calls["fill_walk_packed"] > 3
    assert _keys(got) == _keys(base)


@pytest.mark.parametrize("mode", MODES)
def test_long_flush_under_device_axis(mode):
    """longseq_cells=1 sends every bucket down the long route, which runs
    unsharded on the engine's device: no sharded call, same results."""
    pairs = _pairs(51 + mode, count=9, lmax=70)
    spy = _Spy(make_mesh(devices=["cpu"] * 8))
    got = BatchAligner(mode=mode, device_axis=spy,
                       longseq_cells=1).align_pairs(pairs)
    assert spy.calls["fill_walk_packed"] == 0
    want = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    assert _keys(got) == _keys(want)


def test_token_walk_not_taken_under_device_axis(monkeypatch):
    monkeypatch.setenv("SWTPU_TOKEN_WALK", "1")
    pairs = _pairs(61, count=12)
    spy = _Spy(make_mesh(devices=["cpu"] * 8))
    eng = BatchAligner(mode=LOCAL, device_axis=spy)
    assert not eng.token_walk
    got = eng.align_pairs(pairs)
    assert spy.calls["fill_walk_packed"] == 1
    assert _keys(got) == _keys(
        BatchAligner(mode=LOCAL, device="cpu").align_pairs(pairs))


def test_engine_device_comes_from_the_mesh(monkeypatch):
    dp = _dp(4)
    assert BatchAligner(device_axis=dp).device == torch.device("cpu")
    assert BatchAligner(device="cpu", device_axis=dp).device.type == "cpu"
    with pytest.raises(ValueError, match="not in the mesh"):
        BatchAligner(device="meta", device_axis=dp)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="not in the mesh"):
            BatchAligner(device="cuda", device_axis=dp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataParallel()
    assert DataParallel(n_devices=None, mesh=dp.mesh).n_devices == 4


# ------------------------------------------------------- DataParallel itself
def _chunk(seed, B, NP, MP):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, NP + 1, size=B).astype(np.int32)
    m = rng.integers(1, MP + 1, size=B).astype(np.int32)
    n[0], m[0] = 1, MP
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    w = min(10, NP - 5, MP - 3)
    c2[1, 3:3 + w] = c1[1, 5:5 + w]
    return batch.Chunk(c1, c2, n, m)


CHUNKS = [_chunk(71, 11, 24, 40), _chunk(72, 5, 16, 64), _chunk(73, 2, 8, 8)]
TABLE = torch.from_numpy(
    np.asarray(SubstitutionMatrix.blosum62().table, np.float32))


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_shards_cover_every_pair_once(shards):
    dp = _dp(shards)
    parts = dp.shards(CHUNKS)
    rows = np.concatenate([sh.rows for sh in parts])
    assert sorted(rows.tolist()) == list(range(18))
    for sh in parts:
        assert sh.rows.shape[0] == sum(ch.shape[0] for ch in sh.chunks)
        assert all(ch.shape[0] > 0 for ch in sh.chunks)
    # piece d of a chunk holds floor or ceil of B / shards pairs
    for c, ch in enumerate(CHUNKS):
        sizes = [p.shape[0] for sh in parts for p in sh.chunks
                 if p.shape[1:] == ch.shape[1:]]
        assert sum(sizes) == ch.shape[0]
        assert max(sizes) - min(sizes) <= 1
    assert len(parts) == min(shards, 11)


def _flush_index(chunks):
    """Flush position -> (chunk, index in the chunk)."""
    return [(c, k) for c, ch in enumerate(chunks) for k in range(ch.shape[0])]


@pytest.mark.parametrize("mode", MODES)
def test_fill_many_matches_unsharded(mode):
    fills, stats = _dp().fill_many(TABLE, CHUNKS, mode=mode, og=OG, eg=EG)
    ref = fill_dp.fill_many_ref(TABLE, CHUNKS, mode=mode, og=OG, eg=EG)
    assert torch.equal(stats, ref.stats)
    where = _flush_index(CHUNKS)
    seen = 0
    for sh, f in fills:
        lo = 0
        for c, piece in enumerate(sh.chunks):
            view = f.tb_view(c)
            for k in range(piece.shape[0]):
                gc, gk = where[int(sh.rows[lo + k])]
                nb, mb = int(piece.n[k]), int(piece.m[k])
                assert torch.equal(view[:nb, :mb, k],
                                   ref.tb_view(gc)[:nb, :mb, gk])
                seen += 1
            lo += piece.shape[0]
    assert seen == 18
    none, so = _dp().fill_many(TABLE, CHUNKS, mode=mode, og=OG, eg=EG,
                               score_only=True)
    assert none is None
    assert torch.equal(so, fill_dp.fill_many_ref(
        TABLE, CHUNKS, mode=mode, og=OG, eg=EG, score_only=True).stats)


@pytest.mark.parametrize("mode", MODES)
def test_fill_walk_packed_matches_unsharded(mode):
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in
            (ch.shape for ch in CHUNKS))
    stats, cnt, mv = _dp().fill_walk_packed(TABLE, CHUNKS, mode=mode, og=OG,
                                            eg=EG, L=L)
    ref = fill_dp.fill_many_ref(TABLE, CHUNKS, mode=mode, og=OG, eg=EG)
    rcnt, rmv = device_walk.walk_packed_ref(ref.tb, ref.desc, ref.stats,
                                            mode=mode, L=L)
    assert torch.equal(stats, ref.stats)
    assert torch.equal(cnt, rcnt)
    assert mv.shape == rmv.shape == (-(-L // 4), 18)
    assert torch.equal(mv, rmv)
    assert int(cnt.max()) > 0


def test_fill_diag_matches_unsharded():
    got = _dp(3).fill_diag(TABLE, CHUNKS, og=OG, eg=EG)
    assert torch.equal(got, diag_dp.fill_diag(TABLE, CHUNKS, og=OG, eg=EG))


def test_fill_many_matches_jax_fill_pallas():
    """64 pairs of 8 x 128 as one tile a device of JAX's
    ``DataParallel.fill_pallas`` (interpret mode) and as one chunk of the
    port's ``fill_many`` on 8 shards: equal stats, and the pointer bytes of
    every pair."""
    sm = jswt.SubstitutionMatrix.blosum62()
    ch = _chunk(81, 64, 8, 128)
    S = jbatch.scores_tiled(sm.table, ch.codes1.astype(np.int32),
                            ch.codes2.astype(np.int32), as_int8=True, tile=8)
    tb_t, jstats = JaxDataParallel(jax_mesh(8)).fill_pallas(
        S, ch.n, ch.m, mode=LOCAL, og=OG, eg=EG, interpret=True)
    fills, stats = _dp().fill_many(TABLE, [ch], mode=LOCAL, og=OG, eg=EG)
    np.testing.assert_array_equal(stats.numpy(), jstats)
    for sh, f in fills:
        view = f.tb_view(0).numpy()
        for k, p in enumerate(sh.rows):
            nb, mb = int(ch.n[p]), int(ch.m[p])
            np.testing.assert_array_equal(
                view[:nb, :mb, k], jbatch.tb_pair_view(tb_t, int(p))[:nb, :mb])
