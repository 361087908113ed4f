"""The port's fill against the JAX package's, exactly.

Three implementations of the port are held against the JAX oracle
``smithwaterman_tpu.ops.batch.fill_scan`` (vmapped ``scan_dp.fill``) on the
same seeded numpy inputs: the torch oracle ``ops/scan_dp.fill``, the plain
fill ``ops/fill_dp.fill_many_ref`` (kernel K1's plain version), and the
host twin of K1 (``csrc/cell_twin.cpp``, which runs the kernel's own lane
functions ``csrc/sw_band.cuh`` and cell rules ``csrc/sw_cell.cuh`` for
every lane of the warp, at each stripe depth R).  One small case also
goes against the Pallas kernel in interpret mode.

Tolerance: exact equality of every pointer byte in each pair's [:n, :m]
and of every stats value.  Scores are quarter-integers, and "close" is a
fault for an EMBOSS-exact system.
"""

import numpy as np
import pytest
import torch

from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu.ops import pallas_dp
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.ops import batch, fill_dp, native, scan_dp

MODES = [LOCAL, GLOCAL, GLOBAL]
# the penalties of tests/test_pallas_kernel.py: the reference CLI's, the
# degenerate og = eg = 0, a zero extend, and opens that lose to extends
PENALTIES = [(-10.0, -0.5), (0.0, 0.0), (-1.0, 0.0), (-25.0, -0.5)]


def _batch(seed, B=6, NP=24, MP=40, K=24):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, NP + 1, size=B).astype(np.int32)
    m = rng.integers(1, MP + 1, size=B).astype(np.int32)
    n[0], m[0] = 1, MP        # a one-row pair
    n[1], m[1] = NP, 1        # a one-column pair
    c1 = rng.integers(0, K, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, K, size=(B, MP)).astype(np.uint8)
    # a shared motif so LOCAL alignments are long enough to tie
    w = min(10, NP - 5, MP - 3)
    c2[2, 3:3 + w] = c1[2, 5:5 + w]
    return batch.Chunk(c1, c2, n, m)


def _jax_ref(table, ch, mode, og, eg, score_only=False):
    S = table[ch.codes1[:, :, None].astype(np.int64),
              ch.codes2[:, None, :].astype(np.int64)].astype(np.float32)
    return jbatch.fill_scan(S, ch.n, ch.m, mode=mode, og=og, eg=eg,
                            score_only=score_only)


def _jax_stats(ref, mode, score_only):
    B = ref.best.shape[0]
    st = np.zeros((B, 8), np.float32)
    if mode == LOCAL:
        st[:, 0] = np.asarray(ref.best)
        if not score_only:
            st[:, 1] = np.asarray(ref.best_i)
            st[:, 2] = np.asarray(ref.best_j)
    else:
        st[:, 3:6] = np.asarray(ref.final)
    return st


def _assert_tb_equal(ours_nmb, ref_tb, ch, what):
    """ours: (NP, MP, B) pointer bytes; ref: JAX (B, NP+1, MP+1)."""
    ref_tb = np.asarray(ref_tb)
    for b in range(ch.shape[0]):
        nb, mb = int(ch.n[b]), int(ch.m[b])
        np.testing.assert_array_equal(
            ours_nmb[:nb, :mb, b], ref_tb[b, 1:nb + 1, 1:mb + 1],
            err_msg=f"{what}: pair {b} pointers")


def _stripe_chunk(R, seed=0, K=24):
    """Pairs that end on either side of K1's lane and stripe boundaries at
    R rows a lane (stripes of 32 R rows): n in {1, 31, 32, 33, 32R - 1,
    32R + 1, 64R + 1} by m in {1, 5, 31, 33}; one pair whose maximum ties
    in every row from 5 on (a run of W against WWWWW), one whose motif
    lies in seq1 four times, on different lanes and stripes, and one of
    200 columns (warps that take a second stripe wait more than LAG)."""
    C = 32 * R
    ns = sorted({1, 31, 32, 33, C - 1, C + 1, 2 * C + 1})
    lens = [(n, m) for n in ns for m in (1, 5, 31, 33)] + [(2 * C + 1, 200)]
    NP, MP = max(ns), 200
    B = len(lens) + 2
    rng = np.random.default_rng(seed + R)
    c1 = rng.integers(0, K, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, K, size=(B, MP)).astype(np.uint8)
    n = np.array([a for a, _ in lens] + [NP, NP], np.int32)
    m = np.array([b for _, b in lens] + [5, 8], np.int32)
    c1[-2] = 17                 # W
    c2[-2, :5] = 17
    motif = rng.integers(0, 20, size=8).astype(np.uint8)
    c2[-1, :8] = motif
    for at in (3, C // 2 + 1, C + 5, NP - 9):
        c1[-1, at:at + 8] = motif
    return batch.Chunk(c1, c2, n, m)


def _twin(table, chunks, mode, og, eg, score_only, R=None, NW=1):
    """Run K1's host twin over chunks in the kernel's layout, NW warps a
    pair: at R rows a lane, or (R None) each chunk at the R its launch
    takes."""
    lib = native.twin_lib()
    desc, tb_base, tb_bytes, carry_floats = fill_dp.layout(chunks)
    B = desc.shape[0]
    c1 = np.concatenate([ch.codes1.ravel() for ch in chunks])
    c2 = np.concatenate([ch.codes2.ravel() for ch in chunks])
    tb = np.zeros(max(tb_bytes, 1), np.uint8)
    carry = np.zeros(carry_floats, np.float32)
    stats = np.zeros((B, 8), np.float32)
    tab = np.ascontiguousarray(table, np.float32)
    plan = ([(R, NW, np.arange(B, dtype=np.int32))] if R is not None
            else fill_dp.launch_plan(chunks))
    for r, nw, rows in plan:
        d = np.ascontiguousarray(desc[rows])
        st = np.zeros((len(rows), 8), np.float32)
        rc = lib.sw_twin_fill(
            mode, 0 if score_only else 1, r, nw, tab.ctypes.data,
            tab.shape[0],
            c1.itemsize, c1.ctypes.data, c2.ctypes.data, d.ctypes.data,
            len(rows), tb.ctypes.data, None, carry.ctypes.data,
            st.ctypes.data, og, eg)
        assert rc == 0
        stats[rows] = st
    pool = torch.from_numpy(tb)
    views = [fill_dp.pool_view(pool, base, ch.shape).numpy()
             for ch, base in zip(chunks, tb_base)]
    return views, stats


@pytest.mark.parametrize("og,eg", PENALTIES)
@pytest.mark.parametrize("mode", MODES)
def test_scan_dp_matches_jax(mode, og, eg):
    """The torch oracle: every FillResult field, boundary pointers too."""
    table = JaxSM.blosum62().table
    ch = _batch(7)
    ref = _jax_ref(table, ch, mode, og, eg)
    S = batch.scores(torch.from_numpy(table), torch.from_numpy(ch.codes1),
                     torch.from_numpy(ch.codes2))
    ours = scan_dp.fill(S, torch.from_numpy(ch.n), torch.from_numpy(ch.m),
                        og, eg, mode)
    for b in range(ch.shape[0]):
        nb, mb = int(ch.n[b]), int(ch.m[b])
        np.testing.assert_array_equal(
            ours.tb[b, :nb + 1, :mb + 1].numpy(),
            np.asarray(ref.tb)[b, :nb + 1, :mb + 1], err_msg=f"pair {b}")
    np.testing.assert_array_equal(ours.best.numpy(), np.asarray(ref.best))
    np.testing.assert_array_equal(ours.best_i.numpy(), np.asarray(ref.best_i))
    np.testing.assert_array_equal(ours.best_j.numpy(), np.asarray(ref.best_j))
    np.testing.assert_array_equal(ours.final.numpy(), np.asarray(ref.final))
    np.testing.assert_array_equal(ours.final_state.numpy(),
                                  np.asarray(ref.final_state))


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fill_ref_matches_jax(mode, score_only):
    """K1's plain version through the pooled API, two chunks in one call,
    under every penalty set."""
    table = JaxSM.blosum62().table
    chunks = [_batch(11), _batch(12, B=3, NP=8, MP=16)]
    for og, eg in PENALTIES:
        filled = fill_dp.fill_many(torch.from_numpy(table), chunks,
                                   mode=mode, og=og, eg=eg,
                                   score_only=score_only)
        lo = 0
        for c, ch in enumerate(chunks):
            ref = _jax_ref(table, ch, mode, og, eg, score_only)
            B = ch.shape[0]
            np.testing.assert_array_equal(
                filled.stats[lo:lo + B].numpy(),
                _jax_stats(ref, mode, score_only),
                err_msg=f"stats og={og} eg={eg}")
            if not score_only:
                _assert_tb_equal(filled.tb_view(c).numpy(), ref.tb, ch,
                                 f"og={og} eg={eg}")
            lo += B


@pytest.mark.parametrize("R", fill_dp.STRIPE_R)
@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cell_twin_matches_jax(mode, score_only, R):
    """The kernel's own lane functions (through the g++ twin: every lane of
    the warp at every step), in the kernel's layout, at R rows a lane and
    1, 2 or 3 warps a pair (the seed rows between warps checked against
    the card's barriers), under every penalty set and for a non-integer
    table; pairs across the lane and stripe boundaries, with tied
    maxima."""
    blosum = JaxSM.blosum62().table
    chunks = [_batch(21), _batch(22, B=5, NP=40, MP=8), _stripe_chunk(R)]
    for table in (blosum, blosum * np.float32(0.5)):
        for og, eg in PENALTIES:
            refs = [_jax_ref(table, ch, mode, og, eg, score_only)
                    for ch in chunks]
            for NW in (1, 2, 3):
                views, stats = _twin(table, chunks, mode, og, eg,
                                     score_only, R, NW)
                lo = 0
                for c, (ch, ref) in enumerate(zip(chunks, refs)):
                    B = ch.shape[0]
                    np.testing.assert_array_equal(
                        stats[lo:lo + B], _jax_stats(ref, mode, score_only),
                        err_msg=f"stats og={og} eg={eg} NW={NW}")
                    if not score_only:
                        _assert_tb_equal(views[c], ref.tb, ch,
                                         f"twin og={og} eg={eg} NW={NW}")
                    lo += B


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_fill_ref_dna(mode):
    """A match/mismatch table (26 symbols) with long exact repeats, where
    ties between equal-score paths are everywhere."""
    sm = JaxSM.match_mismatch(5.0, -4.0)
    rng = np.random.default_rng(5)
    B, NP, MP = 4, 32, 32
    c1 = rng.choice([0, 2, 6, 19], size=(B, NP)).astype(np.uint8)
    c2 = rng.choice([0, 2, 6, 19], size=(B, MP)).astype(np.uint8)
    ch = batch.Chunk(c1, c2, np.array([32, 17, 5, 29], np.int32),
                     np.array([30, 32, 9, 3], np.int32))
    views, stats = _twin(sm.table, [ch], mode, -10.0, -0.5, False)
    filled = fill_dp.fill_many(torch.from_numpy(sm.table), [ch], mode=mode,
                               og=-10.0, eg=-0.5)
    np.testing.assert_array_equal(stats, filled.stats.numpy())
    for b in range(B):
        nb, mb = int(ch.n[b]), int(ch.m[b])
        np.testing.assert_array_equal(
            views[0][:nb, :mb, b], filled.tb_view(0).numpy()[:nb, :mb, b])


@pytest.mark.parametrize("mode", MODES)
def test_fill_ref_matches_pallas_interpret(mode):
    """One small case against the Pallas kernel itself (interpret mode)."""
    sm = JaxSM.blosum62()
    ch = _batch(31, B=8, NP=8, MP=128)
    S_tiled = np.asarray(jbatch.scores_tiled(
        sm.table, ch.codes1.astype(np.int32), ch.codes2.astype(np.int32),
        as_int8=True, tile=8))
    tb_t, stats = jbatch.fill_pallas(S_tiled, ch.n, ch.m, mode=mode,
                                     og=-10.0, eg=-0.5, interpret=True)
    filled = fill_dp.fill_many(torch.from_numpy(sm.table), [ch], mode=mode,
                               og=-10.0, eg=-0.5)
    np.testing.assert_array_equal(filled.stats.numpy(),
                                  stats.reshape(-1, pallas_dp.STATS_W))
    ours = filled.tb_view(0).numpy()
    for b in range(8):
        nb, mb = int(ch.n[b]), int(ch.m[b])
        np.testing.assert_array_equal(
            ours[:nb, :mb, b], jbatch.tb_pair_view(tb_t, b)[:nb, :mb])


def test_fill_many_rejects_bad_lengths():
    ch = _batch(3)
    bad = batch.Chunk(ch.codes1, ch.codes2, ch.n.copy(), ch.m)
    bad.n[0] = 0
    with pytest.raises(ValueError):
        fill_dp.fill_many(torch.zeros((24, 24)), [bad], mode=LOCAL,
                          og=-10.0, eg=-0.5)
    with pytest.raises(ValueError):
        fill_dp.fill_many(torch.zeros((24, 24), device="meta"), [ch],
                          mode=LOCAL, og=-10.0, eg=-0.5)


def test_fill_many_rejects_codes_past_the_table():
    ch = _batch(3)
    bad = batch.Chunk(ch.codes1.copy(), ch.codes2, ch.n, ch.m)
    bad.codes1[1, 0] = 24
    with pytest.raises(ValueError, match="below the table"):
        fill_dp.fill_many(torch.zeros((24, 24)), [bad], mode=LOCAL,
                          og=-10.0, eg=-0.5)
