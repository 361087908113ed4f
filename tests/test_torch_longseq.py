"""The port's long-sequence route against the JAX package's, exactly.

Three implementations of the port are held against the JAX package on the
same seeded numpy inputs:

* the plain versions in ``smithwaterman_tpu_torch/ops/longseq.py``
  (``fill_checkpointed_ref``, ``fill_band_ref``, ``walk_segments_ref`` and
  the route ``align_long_packed`` on the CPU) against the Pallas kernels in
  interpret mode (``pallas_dp.fill_checkpointed``, ``pallas_dp.fill_band``)
  and the JAX route ``longseq.align_long_packed``;
* the host twin of kernels K3, K4 and K5 (``csrc/cell_twin.cpp``, which
  runs the kernels' own headers ``sw_band.cuh`` and ``sw_walk.cuh``, every
  thread of a block in turn at each wavefront step) against the same
  references, on tie-heavy inputs too;
* ``BatchAligner`` routing (``longseq_cells``, a small pointer budget)
  against the JAX ``BatchAligner(backend="scan")``.

Tolerance: exact equality of stats, of checkpoint values in each pair's
true region (rows (k+1)*C <= n, columns < m), of band pointer bytes in
[:n, :m], of move counts and of every packed move byte; strings, scores
and spans exactly.
"""

import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu.ops import longseq as jlong
from smithwaterman_tpu.ops import pallas_dp
from smithwaterman_tpu.utils import calc_score as jcalc
from smithwaterman_tpu_torch import BatchAligner
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
from smithwaterman_tpu_torch.ops import batch, longseq, native
from smithwaterman_tpu_torch.utils import calc_score

MODES = [LOCAL, GLOCAL, GLOBAL]
OG, EG = -10.0, -0.5
CKPT = 32  # 4 bands of the 128-row shapes
# the shapes of tests/test_longseq.py
N = np.array([128, 100, 65, 32, 96, 1, 33, 127], np.int32)
M = np.array([128, 40, 128, 128, 9, 100, 13, 127], np.int32)


def _chunk(seed, NP=128, MP=128, n=N, m=M, K=24):
    rng = np.random.default_rng(seed)
    B = len(n)
    c1 = rng.integers(0, K, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, K, size=(B, MP)).astype(np.uint8)
    w = min(55, NP - 20)
    c2[0, 5:5 + w] = c1[0, 20:20 + w]  # a long local alignment
    return batch.Chunk(c1, c2, n.copy(), m.copy())


def _tied_chunk(seed):
    """Two-letter sequences with a motif repeated down seq1: LOCAL maxima
    tie across rows, bands and threads."""
    rng = np.random.default_rng(seed)
    B, NP, MP = 8, 128, 96
    c1 = rng.choice([0, 2], size=(B, NP)).astype(np.uint8)
    c2 = rng.choice([0, 2], size=(B, MP)).astype(np.uint8)
    motif = rng.choice([0, 2], size=12).astype(np.uint8)
    for b in range(B):
        for r in range(3, NP - 12, 29):
            c1[b, r:r + 12] = motif
        c2[b, 40:52] = motif
    n = np.array([128, 127, 97, 64, 33, 31, 90, 1], np.int32)
    m = np.array([96, 52, 96, 53, 96, 60, 1, 96], np.int32)
    return batch.Chunk(c1, c2, n, m)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_S(table, ch):
    return jbatch.scores_tiled(table, ch.codes1.astype(np.int32),
                               ch.codes2.astype(np.int32), as_int8=True,
                               tile=8)


def _nm(ch):
    B = ch.shape[0]
    return (np.asarray(ch.n).reshape(B // 8, 8, 1),
            np.asarray(ch.m).reshape(B // 8, 8, 1))


def _untile(a):
    """(G, K, TBP, W) -> (G*TBP, K, W)."""
    a = np.asarray(a)
    G, K, T, W = a.shape
    return a.transpose(0, 2, 1, 3).reshape(G * T, K, W)


def _assert_ckpts_equal(ours, ref, ch, C, what):
    for b in range(ch.shape[0]):
        nb, mb = int(ch.n[b]), int(ch.m[b])
        k = nb // C  # checkpoints (k+1)*C <= n
        for a, r, name in zip(ours, ref, "MXY"):
            np.testing.assert_array_equal(
                a[b, :k, :mb], r[b, :k, :mb],
                err_msg=f"{what}: pair {b} checkpoint {name}")


# ------------------------------------------------------------ plain vs JAX
@pytest.mark.parametrize("mode", MODES)
def test_fill_checkpointed_ref_matches_pallas(mode):
    sm = JaxSM.blosum62()
    ch = _chunk(1)
    nt, mt = _nm(ch)
    stats, ck = pallas_dp.fill_checkpointed(
        _jax_S(sm.table, ch), nt, mt, mode=mode, og=OG, eg=EG,
        ckpt_rows=CKPT, interpret=True)
    st, ours = longseq.fill_checkpointed_ref(
        _t(sm.table), _t(ch.codes1), _t(ch.codes2), _t(ch.n), _t(ch.m),
        mode=mode, og=OG, eg=EG, C=CKPT)
    np.testing.assert_array_equal(st.numpy(), np.asarray(stats).reshape(-1, 8))
    _assert_ckpts_equal([a.numpy() for a in ours], [_untile(a) for a in ck],
                        ch, CKPT, "plain")


@pytest.mark.parametrize("mode", [LOCAL, GLOCAL])
def test_fill_band_ref_matches_pallas(mode):
    """Band 2 refilled from checkpoint 1: every pointer byte in [:n, :m]."""
    sm = JaxSM.blosum62()
    ch = _chunk(2)
    S = _jax_S(sm.table, ch)
    nt, mt = _nm(ch)
    _, ck = pallas_dp.fill_checkpointed(S, nt, mt, mode=mode, og=OG, eg=EG,
                                        ckpt_rows=CKPT, interpret=True)
    sk = 2
    seeds = [np.asarray(a)[:, sk - 1] for a in ck]
    tb, _ = pallas_dp.fill_band(
        S[:, sk * CKPT:(sk + 1) * CKPT], nt, mt,
        np.array([[sk * CKPT]], np.int32), *seeds, mode=mode, og=OG, eg=EG,
        interpret=True)
    ref = _untile(tb)  # (B, C, MP)
    _, ours_ck = longseq.fill_checkpointed_ref(
        _t(sm.table), _t(ch.codes1), _t(ch.codes2), _t(ch.n), _t(ch.m),
        mode=mode, og=OG, eg=EG, C=CKPT)
    B, NP, MP = ch.shape
    band = torch.zeros((B, longseq.band_bytes(CKPT, MP)), dtype=torch.uint8)
    longseq.fill_band_ref(_t(sm.table), _t(ch.codes1), _t(ch.codes2),
                          _t(ch.n), _t(ch.m), ours_ck, band, sk=sk,
                          mode=mode, og=OG, eg=EG, C=CKPT)
    ours = longseq.band_view(band, CKPT, MP).numpy()
    tw = _twin_band(sm.table, ch, mode, OG, EG, CKPT, sk,
                    [a.numpy() for a in ours_ck])
    for b in range(B):
        rows = min(max(int(ch.n[b]) - sk * CKPT, 0), CKPT)
        mb = int(ch.m[b])
        np.testing.assert_array_equal(ours[b, :rows, :mb],
                                      ref[b, :rows, :mb], err_msg=f"{b}")
        np.testing.assert_array_equal(tw[b, :rows, :mb],
                                      ref[b, :rows, :mb], err_msg=f"{b}")


def _jax_route(table, ch, mode, og, eg, C):
    stats, cnt, mv = jlong.align_long_packed(
        _jax_S(table, ch), ch.n, ch.m, mode=mode, og=og, eg=eg, ckpt_rows=C,
        interpret=True)
    return np.asarray(stats), np.asarray(cnt), np.asarray(mv)


# (mode, og, eg, shape case, C): the three modes, the degenerate og = eg = 0,
# and a GLOBAL case with gap runs far longer than a band
ROUTE_CASES = [
    (LOCAL, OG, EG, "square", CKPT),
    (GLOCAL, OG, EG, "square", CKPT),
    (GLOBAL, OG, EG, "square", CKPT),
    (GLOBAL, 0.0, 0.0, "square", CKPT),
    (GLOBAL, OG, EG, "wide", 8),
]


def _route_chunk(case):
    if case == "square":
        return _chunk(3)
    n = np.full(8, 32, np.int32)
    m = np.array([512, 300, 512, 200, 512, 150, 512, 512], np.int32)
    return _chunk(4, NP=32, MP=512, n=n, m=m, K=20)


@pytest.mark.parametrize("mode,og,eg,case,C", ROUTE_CASES)
def test_align_long_packed_matches_jax(mode, og, eg, case, C):
    """The port's route on the CPU (plain versions) and through the host
    twin of K3/K4/K5: stats, counts and every move byte."""
    table = JaxSM.blosum62().table
    ch = _route_chunk(case)
    ref = _jax_route(table, ch, mode, og, eg, C)
    st, cnt, mv = longseq.align_long_packed(_t(table), ch, mode=mode, og=og,
                                            eg=eg, ckpt_rows=C)
    for got, want, name in zip((st.numpy(), cnt.numpy(), mv.numpy()), ref,
                               ("stats", "cnt", "moves")):
        np.testing.assert_array_equal(got, want, err_msg=f"plain {name}")
    for got, want, name in zip(_twin_route(table, ch, mode, og, eg, C), ref,
                               ("stats", "cnt", "moves")):
        np.testing.assert_array_equal(got, want, err_msg=f"twin {name}")


# ------------------------------------------------------------ host twin
def _twin_ckpt(table, ch, mode, og, eg, C):
    lib = native.twin_lib()
    B, NP, MP = ch.shape
    nck = longseq.n_ckpts(NP, C)
    ck = [np.zeros((B, nck, MP), np.float32) for _ in range(3)]
    stats = np.ones((B, 8), np.float32)
    scratch = np.zeros(1 + B + 4 * B * nck, np.int32)
    tab = np.ascontiguousarray(table, np.float32)
    rc = lib.sw_twin_ckpt_fill(
        mode, tab.ctypes.data, tab.shape[0], ch.codes1.itemsize,
        ch.codes1.ctypes.data, ch.codes2.ctypes.data, ch.n.ctypes.data,
        ch.m.ctypes.data, B, NP, MP, C, ck[0].ctypes.data, ck[1].ctypes.data,
        ck[2].ctypes.data, stats.ctypes.data, scratch.ctypes.data, og, eg)
    assert rc == 0
    return stats, ck


def _twin_bands(table, ch, mode, og, eg, C, sk0, G, ck, bands=None):
    """K4's twin over bands sk0 .. sk0 + G - 1: (G, B, C, MP) band views."""
    lib = native.twin_lib()
    B, NP, MP = ch.shape
    tab = np.ascontiguousarray(table, np.float32)
    if bands is None:
        bands = np.zeros((G, B, longseq.band_bytes(C, MP)), np.uint8)
    rc = lib.sw_twin_band_fill(
        mode, tab.ctypes.data, tab.shape[0], ch.codes1.itemsize,
        ch.codes1.ctypes.data, ch.codes2.ctypes.data, ch.n.ctypes.data,
        ch.m.ctypes.data, B, NP, MP, C, sk0, G, ck[0].ctypes.data,
        ck[1].ctypes.data, ck[2].ctypes.data, bands.ctypes.data, og, eg)
    assert rc == 0
    return np.stack([longseq.band_view(torch.from_numpy(b), C, MP).numpy()
                     for b in bands[:G]])


def _twin_band(table, ch, mode, og, eg, C, sk, ck, band=None):
    return _twin_bands(table, ch, mode, og, eg, C, sk, 1, ck,
                       None if band is None else band[None])[0]


def _twin_route(table, ch, mode, og, eg, C, G=1, D=0):
    """K3, then per group of G bands one K4 launch and one K5 launch, as
    align_long_packed launches them, all through the twin (K5's windows of
    D diagonals, 0 for the card's)."""
    lib = native.twin_lib()
    B, NP, MP = ch.shape
    L = NP + MP + 2
    stats, ck = _twin_ckpt(table, ch, mode, og, eg, C)
    walk = longseq.walk_start(_t(stats), _t(ch.n), _t(ch.m), mode).numpy()
    walk = np.ascontiguousarray(walk)
    cnt = np.zeros(B, np.int32)
    moves = np.zeros((-(-L // 4), B), np.uint8)
    bands = np.zeros((G, B, longseq.band_bytes(C, MP)), np.uint8)
    for top in range(longseq.n_ckpts(NP, C) - 1, -1, -G):
        sk0 = max(0, top - G + 1)
        _twin_bands(table, ch, mode, og, eg, C, sk0, top - sk0 + 1, ck,
                    bands)
        rc = lib.sw_twin_seg_walk(1 if mode == LOCAL else 0,
                                  bands.ctypes.data, top - sk0 + 1, B, MP, C,
                                  sk0, L, walk.ctypes.data, cnt.ctypes.data,
                                  moves.ctypes.data, D)
        assert rc == 0
    return stats, cnt, moves


def _jax_fill_stats(table, ch, mode, og, eg):
    S = table[ch.codes1[:, :, None].astype(np.int64),
              ch.codes2[:, None, :].astype(np.int64)].astype(np.float32)
    ref = jbatch.fill_scan(S, ch.n, ch.m, mode=mode, og=og, eg=eg)
    st = np.zeros((ch.shape[0], 8), np.float32)
    if mode == LOCAL:
        st[:, 0] = np.asarray(ref.best)
        st[:, 1] = np.asarray(ref.best_i)
        st[:, 2] = np.asarray(ref.best_j)
    else:
        st[:, 3:6] = np.asarray(ref.final)
    return st


@pytest.mark.parametrize("C", [32, 64, 256])
@pytest.mark.parametrize("mode", MODES)
def test_twin_ckpt_fill_ties(mode, C):
    """K3's wavefront and argmax merge on tie-heavy inputs, including a
    band taller than every pair (C = 256): stats equal the JAX oracle's,
    checkpoints the plain version's."""
    sm = JaxSM.match_mismatch(5.0, -4.0)
    ch = _tied_chunk(5 + mode)
    stats, ck = _twin_ckpt(sm.table, ch, mode, OG, EG, C)
    np.testing.assert_array_equal(
        stats, _jax_fill_stats(sm.table, ch, mode, OG, EG))
    st, ours = longseq.fill_checkpointed_ref(
        _t(sm.table), _t(ch.codes1), _t(ch.codes2), _t(ch.n), _t(ch.m),
        mode=mode, og=OG, eg=EG, C=C)
    np.testing.assert_array_equal(st.numpy(), stats)
    _assert_ckpts_equal(ck, [a.numpy() for a in ours], ch, C, "twin")


@pytest.mark.parametrize("og,eg", [(OG, EG), (0.0, 0.0), (-1.0, 0.0)])
@pytest.mark.parametrize("mode", MODES)
def test_twin_route_matches_plain(mode, og, eg):
    """The whole route through the twin against the plain route, ties
    everywhere, under the penalty edge cases: at C = 32 one band a K4
    launch and three (the last group short), at C = 64 and 256 (R = 2 and
    8 rows a lane) every band in one launch."""
    sm = JaxSM.match_mismatch(5.0, -4.0)
    ch = _tied_chunk(11)
    st, cnt, mv = longseq.align_long_packed(_t(sm.table), ch, mode=mode,
                                            og=og, eg=eg, ckpt_rows=CKPT)
    for C, G in ((CKPT, 1), (CKPT, 3), (64, 2), (256, 1)):
        tst, tcnt, tmv = _twin_route(sm.table, ch, mode, og, eg, C, G)
        np.testing.assert_array_equal(tst, st.numpy(), err_msg=f"C={C}")
        np.testing.assert_array_equal(tcnt, cnt.numpy(), err_msg=f"C={C}")
        np.testing.assert_array_equal(tmv, mv.numpy(), err_msg=f"C={C}")


def _ragged_chunk(seed, NP=300, MP=90):
    """Tie-heavy pairs whose lengths end inside, at and just past band
    edges at C = 32, 64 and 256, one pair of one row: a group of bands
    holds empty bands for most pairs."""
    rng = np.random.default_rng(seed)
    B = 8
    c1 = rng.choice([0, 2], size=(B, NP)).astype(np.uint8)
    c2 = rng.choice([0, 2], size=(B, MP)).astype(np.uint8)
    motif = rng.choice([0, 2], size=10).astype(np.uint8)
    for b in range(B):
        for r in range(7, NP - 10, 37):
            c1[b, r:r + 10] = motif
        c2[b, 30:40] = motif
    n = np.array([300, 257, 256, 255, 1, 64, 299, 100], np.int32)
    m = np.array([90, 33, 90, 1, 90, 64, 77, 89], np.int32)
    return batch.Chunk(c1, c2, n, m)


@pytest.mark.parametrize("C", [32, 64, 256])
@pytest.mark.parametrize("mode", MODES)
def test_twin_band_groups_match_plain(mode, C):
    """K3's twin on ragged pairs (stats equal to the JAX oracle's,
    checkpoints to the plain version's) and K4's twin refilling groups of
    bands, every band of the bucket in one launch and a group from band 1
    on: every band's bytes in each pair's [:n, :m] equal the plain
    refill's, empty bands of a group included."""
    sm = JaxSM.match_mismatch(5.0, -4.0)
    ch = _ragged_chunk(13 + mode)
    B, NP, MP = ch.shape
    stats, ck = _twin_ckpt(sm.table, ch, mode, OG, EG, C)
    np.testing.assert_array_equal(
        stats, _jax_fill_stats(sm.table, ch, mode, OG, EG))
    st, ours = longseq.fill_checkpointed_ref(
        _t(sm.table), _t(ch.codes1), _t(ch.codes2), _t(ch.n), _t(ch.m),
        mode=mode, og=OG, eg=EG, C=C)
    np.testing.assert_array_equal(st.numpy(), stats)
    _assert_ckpts_equal(ck, [a.numpy() for a in ours], ch, C, "twin")
    nck = longseq.n_ckpts(NP, C)
    ref = torch.zeros((nck, B, longseq.band_bytes(C, MP)), dtype=torch.uint8)
    longseq.fill_bands(_t(sm.table), _t(ch.codes1), _t(ch.codes2), _t(ch.n),
                       _t(ch.m), ours, ref, sk0=0, mode=mode, og=OG, eg=EG,
                       C=C)
    ref = [longseq.band_view(r, C, MP).numpy() for r in ref]
    for sk0 in sorted({0, min(1, nck - 1)}):
        got = _twin_bands(sm.table, ch, mode, OG, EG, C, sk0, nck - sk0, ck)
        for g in range(nck - sk0):
            sk = sk0 + g
            for b in range(B):
                rows = min(max(int(ch.n[b]) - sk * C, 0), C)
                mb = int(ch.m[b])
                np.testing.assert_array_equal(
                    got[g, b, :rows, :mb], ref[sk][b, :rows, :mb],
                    err_msg=f"band {sk} pair {b} (group from {sk0})")


def test_twin_seg_walk_state_matches_plain():
    """K5's step rule band by band (groups of one band): the walk state
    after every band, not only the final stream, equals the plain walk's."""
    table = JaxSM.blosum62().table
    ch = _chunk(6)
    mode = GLOCAL
    B, NP, MP = ch.shape
    L = NP + MP + 2
    stats, ck = _twin_ckpt(table, ch, mode, OG, EG, CKPT)
    walk = longseq.walk_start(_t(stats), _t(ch.n), _t(ch.m), mode)
    tw = walk.numpy().copy()
    cnt, tcnt = torch.zeros(B, dtype=torch.int32), np.zeros(B, np.int32)
    moves = torch.zeros((-(-L // 4), B), dtype=torch.uint8)
    tmoves = np.zeros((-(-L // 4), B), np.uint8)
    band = np.zeros((B, longseq.band_bytes(CKPT, MP)), np.uint8)
    lib = native.twin_lib()
    for sk in range(longseq.n_ckpts(NP, CKPT) - 1, -1, -1):
        _twin_band(table, ch, mode, OG, EG, CKPT, sk, ck, band)
        longseq.walk_segment_ref(torch.from_numpy(band), walk, cnt, moves,
                                 sk=sk, C=CKPT, MP=MP, L=L, local=False)
        assert lib.sw_twin_seg_walk(0, band.ctypes.data, 1, B, MP, CKPT, sk,
                                    L, tw.ctypes.data, tcnt.ctypes.data,
                                    tmoves.ctypes.data, 0) == 0
        np.testing.assert_array_equal(tw, walk.numpy(), err_msg=f"band {sk}")
        np.testing.assert_array_equal(tcnt, cnt.numpy())
        np.testing.assert_array_equal(tmoves, moves.numpy())
    assert bool((walk[:, 3] == 1).all())  # every walk reached (0, 0)


def _gap_chunk(seed):
    """Pairs whose seq2 is five to eight times seq1: non-LOCAL walks run
    hundreds of steps along gaps, one anti-diagonal a step, and some end on
    the DP boundary inside a band."""
    rng = np.random.default_rng(seed)
    B, NP, MP = 8, 64, 512
    c1 = rng.choice([0, 2], size=(B, NP)).astype(np.uint8)
    c2 = rng.choice([0, 2], size=(B, MP)).astype(np.uint8)
    c2[0, 200:250] = c1[0, 5:55]  # a local alignment far along seq2
    n = np.array([64, 64, 33, 1, 63, 40, 64, 17], np.int32)
    m = np.array([512, 500, 511, 300, 320, 512, 401, 512], np.int32)
    return batch.Chunk(c1, c2, n, m)


@pytest.mark.parametrize("C", [32, 64, 256])
@pytest.mark.parametrize("mode", MODES)
def test_twin_seg_walk_groups_match_plain(mode, C):
    """K5's group launches through the twin, every window copy checked (a
    read outside a loaded window returns 3): groups of one band, three
    bands and every band of the bucket, at the card's window and at
    windows of 2 and 5 diagonals, on ragged tie-heavy pairs (LOCAL walks
    start mid-band, pairs end at band edges) and on pairs with long gap
    runs.  The state after each group equals the plain walk's after the
    same band, and the plain route's final stream equals JAX's."""
    sm = JaxSM.match_mismatch(5.0, -4.0)
    lib = native.twin_lib()
    local = mode == LOCAL
    for ch in (_ragged_chunk(17 + mode), _gap_chunk(19 + mode)):
        B, NP, MP = ch.shape
        L = NP + MP + 2
        nck = longseq.n_ckpts(NP, C)
        stats, ck = _twin_ckpt(sm.table, ch, mode, OG, EG, C)
        bands = np.zeros((nck, B, longseq.band_bytes(C, MP)), np.uint8)
        _twin_bands(sm.table, ch, mode, OG, EG, C, 0, nck, ck, bands)
        start = longseq.walk_start(_t(stats), _t(ch.n), _t(ch.m), mode)
        walk, cnt = start.clone(), torch.zeros(B, dtype=torch.int32)
        moves = torch.zeros((-(-L // 4), B), dtype=torch.uint8)
        after = {}
        for sk in range(nck - 1, -1, -1):
            longseq.walk_segment_ref(torch.from_numpy(bands[sk]), walk, cnt,
                                     moves, sk=sk, C=C, MP=MP, L=L,
                                     local=local)
            after[sk] = (walk.numpy().copy(), cnt.numpy().copy(),
                         moves.numpy().copy())
        if MP > 100 and C == 32:  # the gap pairs: the plain stream is JAX's
            ref = _jax_route(sm.table, ch, mode, OG, EG, C)
            np.testing.assert_array_equal(after[0][1], ref[1])
            np.testing.assert_array_equal(after[0][2], ref[2])
        for G in sorted({1, 3, nck}):
            for D in (0, 2, 5):
                tw = start.numpy().copy()
                tcnt = np.zeros(B, np.int32)
                tmv = np.zeros((-(-L // 4), B), np.uint8)
                for top in range(nck - 1, -1, -G):
                    sk0 = max(0, top - G + 1)
                    group = np.ascontiguousarray(bands[sk0:top + 1])
                    rc = lib.sw_twin_seg_walk(
                        1 if local else 0, group.ctypes.data, top - sk0 + 1,
                        B, MP, C, sk0, L, tw.ctypes.data, tcnt.ctypes.data,
                        tmv.ctypes.data, D)
                    what = f"G={G} D={D} bands {sk0}..{top}"
                    assert rc == 0, what
                    for got, want in zip((tw, tcnt, tmv), after[sk0]):
                        np.testing.assert_array_equal(got, want,
                                                      err_msg=what)


# ------------------------------------------------------------ routing
LETTERS = np.array(list("ARNDCQEGHILKMFPSTWYV"))


def _pairs(seed, count=10, lmax=300):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        a = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        b = "".join(rng.choice(LETTERS, int(rng.integers(1, lmax))))
        if k % 2 == 0 and len(a) > 60:
            cut = int(rng.integers(0, len(a) - 50))
            b = b[:20] + a[cut:cut + 50] + b[20:]
        out.append((a, b))
    return out + [("W", "W"), ("", "ACD")]


def _key(r):
    return (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
            r.end2)


@pytest.fixture
def spy(monkeypatch):
    calls = []
    real = longseq.align_long_packed

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(longseq, "align_long_packed", counted)
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_longseq_cells_routes_every_bucket(mode, spy):
    pairs = _pairs(7)
    ours = BatchAligner(mode=mode, device="cpu",
                        longseq_cells=1).align_pairs(pairs)
    theirs = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(pairs)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]
    assert sum(s[0] for s in spy) == len(pairs) - 1  # all but the empty one
    # score_pairs stays on the ordinary fill
    del spy[:]
    sc = BatchAligner(mode=mode, device="cpu",
                      longseq_cells=1).score_pairs(pairs)
    assert not spy
    assert sc.tolist() == [r.score for r in theirs]


def test_small_budget_routes_long_pairs(monkeypatch, spy):
    """A pointer budget below one 256x256 pair: those buckets take the long
    route, the rest the ordinary one, results unchanged and in order."""
    monkeypatch.setenv("SWTPU_TB_HBM_BYTES", str(256 * 256 - 1))
    pairs = _pairs(8)
    ours = BatchAligner(mode=GLOBAL, device="cpu").align_pairs(pairs)
    theirs = jswt.BatchAligner(mode=GLOBAL, backend="scan").align_pairs(pairs)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]
    assert spy and all(NP * MP > 256 * 256 - 1 for _, NP, MP in spy)


def test_plan_flushes_long_pieces_keep_order():
    def ch(B, NP, MP):
        return batch.Chunk(np.zeros((B, NP), np.uint8),
                           np.zeros((B, MP), np.uint8),
                           np.full(B, NP, np.int32), np.full(B, MP, np.int32))

    chunks = [ch(3, 64, 64), ch(5, 512, 512), ch(2, 64, 128)]
    # one 512x512 pair's checkpoints and band take more than half the budget
    assert 2 * longseq.pair_bytes(512, 512) > 512 * 512 - 1
    fl = batch.plan_flushes(chunks, 512 * 512 - 1, False)
    assert [(f.long, [c.shape for c in f.chunks]) for f in fl] == [
        (False, [(3, 64, 64)]),
        (True, [(1, 512, 512)]), (True, [(1, 512, 512)]),
        (True, [(1, 512, 512)]), (True, [(1, 512, 512)]),
        (True, [(1, 512, 512)]),
        (False, [(2, 64, 128)]),
    ]


@pytest.mark.parametrize("budget", [200 << 20, 512 << 20, 1 << 30, 4 << 30,
                                    512 * 512 - 1])
def test_long_pieces_stay_inside_budget(budget):
    """Each long piece plan_flushes cuts, with the bands group_bands lets
    one K4 launch refill, holds at most the budget whenever its pairs'
    checkpoints and one band each fit it; the group is capped by
    REFILL_BYTES a pair and by the bucket's bands."""
    for B, NP, MP in [(17, 70144, 70144), (4, 70144, 70144), (5, 512, 512),
                      (6, 600, 280)]:
        ch = batch.Chunk(np.zeros((B, NP), np.uint8),
                         np.zeros((B, MP), np.uint8),
                         np.full(B, NP, np.int32), np.full(B, MP, np.int32))
        bb = longseq.band_bytes(longseq.DEFAULT_CKPT_ROWS, MP)
        for fl in batch.plan_flushes([ch], budget, False, long_cells=1):
            Bp = fl.chunks[0].shape[0]
            G = longseq.group_bands(Bp, NP, MP, budget)
            assert 1 <= G <= min(longseq.n_ckpts(NP, 256),
                                 longseq.REFILL_BYTES // bb)
            if Bp * longseq.pair_bytes(NP, MP) <= budget:
                assert Bp * (longseq.ckpt_bytes(NP, MP) + G * bb) <= budget
    # four 70 kb pairs at the default budget: the cap sets the group
    assert longseq.group_bands(4, 70144, 70144, 4 << 30) == \
        longseq.REFILL_BYTES // longseq.band_bytes(256, 70144)


def _zeros(B, NP, MP, first=0):
    """A chunk of B pairs whose n numbers them from ``first``."""
    return batch.Chunk(np.zeros((B, NP), np.uint8),
                       np.zeros((B, MP), np.uint8),
                       np.arange(first, first + B, dtype=np.int32),
                       np.full(B, MP, np.int32))


def _plan_before(chunks, budget, long_cells=None, runs=False):
    """The planner before the occupancy rule: (long, shapes) a flush."""
    out, cur, cur_bytes = [], [], 0
    for ch in chunks:
        B, NP, MP = ch.shape
        per_pair = NP * MP * (2 if runs else 1)
        if per_pair > budget or (long_cells is not None
                                 and NP * MP >= long_cells):
            if cur:
                out.append((False, cur))
                cur, cur_bytes = [], 0
            step = max(1, budget // longseq.pair_bytes(NP, MP))
            out += [(True, [(min(step, B - lo), NP, MP)])
                    for lo in range(0, B, step)]
            continue
        step = budget // per_pair
        for lo in range(0, B, step):
            shape = (min(step, B - lo), NP, MP)
            if cur and cur_bytes + shape[0] * per_pair > budget:
                out.append((False, cur))
                cur, cur_bytes = [], 0
            cur.append(shape)
            cur_bytes += shape[0] * per_pair
    if cur:
        out.append((False, cur))
    return out


def _plan(flushes):
    return [(f.long, [c.shape for c in f.chunks]) for f in flushes]


def _order(chunks, flushes):
    """Every pair once, in input order (each chunk's n numbers its pairs)."""
    got = np.concatenate([c.n for f in flushes for c in f.chunks])
    want = np.concatenate([c.n for c in chunks])
    return np.array_equal(got, want)


PLAN_CASES = {
    "genome": [(4, 29952, 29952)],
    "dna_70k": [(4, 70144, 70144)],
    "protein_256": [(40, 1536, 1792), (60, 2048, 2048), (56, 2560, 3072),
                    (50, 3584, 3584), (50, 4096, 4096)],
    "mixed": [(3, 64, 64), (5, 512, 512), (2, 8192, 8192), (7, 16128, 16128),
              (30, 29952, 30208), (1, 70144, 70144), (2, 64, 128)],
    "many_30k": [(128, 29952, 29952)],
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
@pytest.mark.parametrize("budget", [4 << 30, 1 << 30, 512 * 512 - 1])
@pytest.mark.parametrize("long_cells", [None, 1 << 26])
def test_plan_without_sms_is_unchanged(case, budget, long_cells):
    """With no SM count (off a card, score-only, the token walk, sharding)
    every chunk plans as before the occupancy rule, in order."""
    first = np.cumsum([0] + [B for B, _, _ in PLAN_CASES[case]])
    chunks = [_zeros(B, NP, MP, f) for (B, NP, MP), f in
              zip(PLAN_CASES[case], first)]
    for runs in (False, True):
        fl = batch.plan_flushes(chunks, budget, False, long_cells=long_cells,
                                runs=runs)
        assert _plan(fl) == _plan_before(chunks, budget, long_cells, runs)
        assert _order(chunks, fl)
        assert all(f.why in (None, "budget", "long_cells") for f in fl)


def test_occupancy_moves_a_genome_flush():
    """The genome cell's chunk, 4 pairs of 29,903 nt in a 29,952 bucket,
    plans as one long flush of 4 on a 132-SM card, and as one K1 flush
    without the SM count."""
    ch = _zeros(4, 29952, 29952)
    fl = batch.plan_flushes([ch], 4 << 30, False, sms=132)
    assert [(f.why, [c.shape for c in f.chunks]) for f in fl] == [
        ("occupancy", [(4, 29952, 29952)])]
    assert _plan(batch.plan_flushes([ch], 4 << 30, False)) == [
        (False, [(4, 29952, 29952)])]
    # score-only fills keep no pointers: never moved
    assert _plan(batch.plan_flushes([ch], 4 << 30, True, sms=132)) == [
        (False, [(4, 29952, 29952)])]


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_occupancy_keeps_full_flushes(sms):
    """256 protein-sized pairs in one flush fill the card: it stays on K1.
    So do short buckets in a flush of few pairs."""
    first = np.cumsum([0] + [B for B, _, _ in PLAN_CASES["protein_256"]])
    chunks = [_zeros(B, NP, MP, f) for (B, NP, MP), f in
              zip(PLAN_CASES["protein_256"], first)]
    fl = batch.plan_flushes(chunks, 4 << 30, False, sms=sms)
    assert _plan(fl) == _plan_before(chunks, 4 << 30)
    assert not any(f.long for f in fl)
    short = [_zeros(2, 2048, 2048), _zeros(1, 3584, 4096, 2)]
    assert _plan(batch.plan_flushes(short, 4 << 30, False, sms=sms)) == [
        (False, [(2, 2048, 2048), (1, 3584, 4096)])]


def test_occupancy_joins_a_chunk_and_keeps_order():
    """Budget-cut K1 flushes of one chunk join into long pieces cut by
    longseq.pair_bytes; over-budget chunks are cut as before; short buckets
    of a moved flush stay on K1, in their place."""
    budget = 4 << 30
    shapes = [(3, 64, 64), (2, 8192, 8192), (128, 29952, 29952),
              (3, 70144, 70144), (2, 64, 128)]
    first = np.cumsum([0] + [B for B, _, _ in shapes])
    chunks = [_zeros(B, NP, MP, f) for (B, NP, MP), f in zip(shapes, first)]
    fl = batch.plan_flushes(chunks, budget, False, sms=132)
    assert _order(chunks, fl)
    step30 = budget // longseq.pair_bytes(29952, 29952)
    step70 = budget // longseq.pair_bytes(70144, 70144)
    assert step30 < 128 and step70 >= 3
    # 3 + 2 + the first 4 of the 30k chunk fill the first K1 flush: 9 pairs
    assert [(f.why, [c.shape for c in f.chunks]) for f in fl] == [
        (None, [(3, 64, 64)]),
        ("occupancy", [(2, 8192, 8192)]),
        ("occupancy", [(step30, 29952, 29952)]),
        ("occupancy", [(128 - step30, 29952, 29952)]),
        ("budget", [(3, 70144, 70144)]),
        (None, [(2, 64, 128)]),
    ]
    # the same chunks with a pointer budget two pairs of 30k hold
    fl = batch.plan_flushes(chunks, 2 * 29952 * 29952, False, sms=132)
    assert _order(chunks, fl)
    assert all(f.why == "occupancy" for f in fl
               if f.chunks[0].shape[1] in (8192, 29952))


def _dna_pairs(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        a = rng.integers(0, 4, size=int(rng.integers(lo, hi)))
        b = a.copy()
        sub = rng.random(len(a)) < 0.05
        b[sub] = rng.integers(0, 4, size=int(sub.sum()))
        b = np.concatenate([b[:40], b[47:], rng.integers(0, 4, 5)])
        out.append(("".join("ACGT"[c] for c in a),
                    "".join("ACGT"[c] for c in b)))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_occupancy_routes_small_flushes_long(mode, monkeypatch, spy):
    """BatchAligner with the planner's SM count set (132) and the rule's
    row floor lowered to these pairs' buckets: the few pairs take the long
    route, the counter counts them, and every result equals the JAX
    package's; a score-only call stays on K1."""
    from smithwaterman_tpu_torch.utils import metrics

    monkeypatch.setattr(batch, "card_sms", lambda device: 132)
    monkeypatch.setattr(batch, "LONG_MIN_ROWS", 256)
    pairs = _dna_pairs(11 + mode, 5, 200, 300) + [("ACGT", "ACGA")]
    sm, jsm = (S.match_mismatch(5.0, -4.0) for S in (SubstitutionMatrix,
                                                     JaxSM))
    moved = metrics.counter("route.long.occupancy")
    ours = BatchAligner(scoring_matrix=sm, mode=mode, device="cpu",
                        gap_open=10.0, gap_extend=0.5).align_pairs(pairs)
    theirs = jswt.BatchAligner(scoring_matrix=jsm, mode=mode,
                               gap_open=10.0, gap_extend=0.5,
                               backend="scan").align_pairs(pairs)
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]
    assert metrics.counter("route.long.occupancy") - moved == 5
    assert sum(s[0] for s in spy) == 5 and all(s[1] >= 256 for s in spy)
    del spy[:]
    BatchAligner(scoring_matrix=sm, mode=mode, device="cpu").score_pairs(
        pairs)
    assert not spy


# ------------------------------------------------------------ calc_score
def test_recalc_score_matches_jax():
    pairs = [("HEAG-AWGHE-E", "--PAWHE-AE--"), ("ACDEF", "ACDEF"),
             ("A--CD", "AWWCD"), ("--AC", "GGAC")]
    for a, b in pairs:
        assert calc_score.recalc_score(a, b) == jcalc.recalc_score(a, b)
    dna = SubstitutionMatrix.match_mismatch(5.0, -4.0)
    jdna = JaxSM.match_mismatch(5.0, -4.0)
    assert calc_score.recalc_score("ACG-T", "ACGGT", dna, 10.0, 0.5) == \
        jcalc.recalc_score("ACG-T", "ACGGT", jdna, 10.0, 0.5)
    with pytest.raises(ValueError):
        calc_score.recalc_score("AC", "A")
