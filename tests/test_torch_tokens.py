"""The port's match-run bytes, token walk and token rebuild against the
JAX package's, exactly.

K10's run bytes (the plain ``fill_dp.run_bytes_ref`` through
``fill_many(runs=True)``, and the g++ twin running ``csrc/sw_cell.cuh``'s
``run_byte`` inside the fill) are held against the Pallas kernel
``pallas_dp.fill_tiled(emit_runs=True)`` in interpret mode and a scalar
reference; K11's plain version ``device_walk.walk_tokens_ref`` and its twin
(``csrc/sw_walk.cuh`` ``walk_tokens_pair`` through the checked tiles of
both pools, at the launcher's tile shape and at small forced tiles that
jumps of up to 16 cells cross) against
``walk_bundle_pooled_tokens``, also cut at L; the native token rebuild against its Python
path and the JAX rebuild; ``BatchAligner(device="cpu")`` with
``SWTPU_TOKEN_WALK=1`` against the move-stream path and the JAX scan
backend.

Tolerance: exact equality of every run byte, token count and token byte,
and of strings, scores and spans.
"""

import functools

import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu.ops import device_walk as jwalk
from smithwaterman_tpu.ops import pallas_dp
from smithwaterman_tpu.ops import reconstruct as jrecon
from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
from smithwaterman_tpu_torch.ops import (batch, device_walk, fill_dp, native,
                                         reconstruct)

MODES = [LOCAL, GLOCAL, GLOBAL]
PENALTIES = [(-10.0, -0.5), (0.0, 0.0), (-1.0, 0.0)]
LETTERS = "ARNDCQEGHILKMFPSTWYV"


def _scalar_runs(tb):
    """Scalar reference of the run-byte recurrence over one pair's (NP, MP)
    pointer bytes (tests/test_token_walk.py's, written out again)."""
    NP, MP = tb.shape
    e = np.zeros((NP, MP), np.int32)
    x = np.zeros_like(e)
    for i in range(NP):
        for j in range(MP):
            ed = e[i - 1, j - 1] if (i > 0 and j > 0) else 15
            xd = x[i - 1, j - 1] if (i > 0 and j > 0) else 0
            p = int(tb[i, j]) & 3
            if p == 3:
                e[i, j], x[i, j] = 15, 3
            elif p != 0:
                e[i, j], x[i, j] = 0, p
            elif ed == 15 and xd == 3:
                e[i, j], x[i, j] = 0, 3
            elif ed < (14 if xd == 3 else 15):
                e[i, j], x[i, j] = ed + 1, xd
            else:
                e[i, j], x[i, j] = 0, 0
    return (e | (x << 4)).astype(np.uint8)


def _run_chunk(seed, B, NP, MP):
    """Random pairs, half of them holding identical runs longer than 16:
    the cap and the reserved-marker collision occur."""
    rng = np.random.default_rng(seed)
    n = rng.integers(NP // 2, NP + 1, size=B).astype(np.int32)
    m = rng.integers(MP // 2, MP + 1, size=B).astype(np.int32)
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    for k in range(B // 2):
        rep = np.concatenate([[17, 17, 17]] + [c1[k, :n[k]]] * 4)
        c2[k, :m[k]] = rep[:m[k]]
    n[-1], m[-1] = 1, MP
    return batch.Chunk(c1, c2, n, m)


def _twin_runs(table, chunks, mode, og, eg, R, NW=1):
    """K10's host twin (K1's with a run pool) at R rows a lane, NW warps a
    pair."""
    desc, tb_base, tb_bytes, carry_floats = fill_dp.layout(chunks)
    B = desc.shape[0]
    c1 = np.concatenate([ch.codes1.ravel() for ch in chunks])
    c2 = np.concatenate([ch.codes2.ravel() for ch in chunks])
    tb = np.zeros(max(tb_bytes, 1), np.uint8)
    run = np.zeros_like(tb)
    carry = np.zeros(carry_floats, np.float32)
    stats = np.zeros((B, 8), np.float32)
    tab = np.ascontiguousarray(table, np.float32)
    rc = native.twin_lib().sw_twin_fill(
        mode, 1, R, NW, tab.ctypes.data, tab.shape[0], c1.itemsize,
        c1.ctypes.data, c2.ctypes.data, desc.ctypes.data, B, tb.ctypes.data,
        run.ctypes.data, carry.ctypes.data, stats.ctypes.data, og, eg)
    assert rc == 0
    return fill_dp.Filled(torch.from_numpy(tb), torch.from_numpy(stats),
                          torch.from_numpy(desc), [ch.shape for ch in chunks],
                          tb_base, torch.from_numpy(run))


def _stripe_chunk(R, seed=0):
    """Pairs that end on either side of K10's lane and stripe boundaries at
    R rows a lane (n in {1, 31, 32, 33, 32R - 1, 32R + 1, 64R + 1}, m in
    {1, 5, 31, 33}), half of them holding runs longer than 16 that cross
    the boundaries, and one of a W run against WWWWW (tied maxima in every
    row from 5 on)."""
    C = 32 * R
    ns = sorted({1, 31, 32, 33, C - 1, C + 1, 2 * C + 1})
    lens = [(n, m) for n in ns for m in (1, 5, 31, 33)]
    NP, MP = max(ns), 40
    B = len(lens) + 1
    rng = np.random.default_rng(seed + R)
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    n = np.array([a for a, _ in lens] + [NP], np.int32)
    m = np.array([b for _, b in lens] + [5], np.int32)
    for k in range(0, len(lens), 2):
        at = max(0, int(n[k]) - 24)
        w = min(MP, NP - at)
        c2[k, :w] = c1[k, at:at + w]
    c1[-1] = 17                 # W
    c2[-1, :5] = 17
    return batch.Chunk(c1, c2, n, m)


@functools.lru_cache(maxsize=None)
def _pallas_runs(mode):
    """_run_chunk(3 + mode, 8, 64, 128) and the Pallas kernel's run bytes
    and stats of it (interpret mode)."""
    sm = JaxSM.blosum62()
    ch = _run_chunk(3 + mode, 8, 64, 128)
    S = jbatch.scores_tiled(sm.table, ch.codes1.astype(np.int32),
                            ch.codes2.astype(np.int32), as_int8=True, tile=8)
    _, run_j, st_j = pallas_dp.fill_tiled(
        S, ch.n.reshape(1, 8, 1), ch.m.reshape(1, 8, 1), mode=mode,
        og=-10.0, eg=-0.5, interpret=True, emit_runs=True)
    return ch, np.asarray(run_j), np.asarray(st_j).reshape(-1, 8)


@pytest.mark.parametrize("R", fill_dp.STRIPE_R)
@pytest.mark.parametrize("mode", MODES)
def test_run_bytes_match_pallas(mode, R):
    """B = 8, NP = 64, MP = 128: the plain and twin (at R rows a lane) run
    bytes against the Pallas kernel's and the scalar reference on every
    pair's [:n, :m]; the pointer bytes and stats stay those of the fill
    without runs.  Then pairs across the twin's lane and stripe boundaries,
    at 1 and 3 warps a pair: pointer bytes and stats equal to the JAX
    fill's, run bytes to the scalar reference's on them."""
    sm = JaxSM.blosum62()
    ch, run_j, st_j = _pallas_runs(mode)
    tab = torch.from_numpy(sm.table.astype(np.float32))
    plain = fill_dp.fill_many(tab, [ch], mode=mode, og=-10.0, eg=-0.5,
                              runs=True)
    moves_only = fill_dp.fill_many(tab, [ch], mode=mode, og=-10.0, eg=-0.5)
    twin = _twin_runs(sm.table, [ch], mode, -10.0, -0.5, R)
    assert torch.equal(plain.stats, moves_only.stats)
    np.testing.assert_array_equal(twin.stats.numpy(), plain.stats.numpy())
    np.testing.assert_array_equal(plain.stats.numpy(), st_j)
    saw_long = False
    for k in range(8):
        nb, mb = int(ch.n[k]), int(ch.m[k])
        want = run_j[0, :nb, k, :mb]
        tb = plain.tb_view(0).numpy()[:nb, :mb, k]
        np.testing.assert_array_equal(
            tb, moves_only.tb_view(0).numpy()[:nb, :mb, k])
        np.testing.assert_array_equal(twin.tb_view(0).numpy()[:nb, :mb, k],
                                      tb)
        for f in (plain, twin):
            np.testing.assert_array_equal(
                f.tb_view(0, f.run).numpy()[:nb, :mb, k], want, err_msg=k)
        np.testing.assert_array_equal(_scalar_runs(tb), want)
        saw_long |= bool(((want & 15) == 15).any() and
                         ((want & 15) == 14).any())
    assert saw_long  # the cap and the collision case were exercised
    sc = _stripe_chunk(R)
    S = sm.table[sc.codes1[:, :, None].astype(np.int64),
                 sc.codes2[:, None, :].astype(np.int64)].astype(np.float32)
    ref = jbatch.fill_scan(S, sc.n, sc.m, mode=mode, og=-10.0, eg=-0.5)
    jtb = np.asarray(ref.tb)
    wants = [jtb[k, 1:int(sc.n[k]) + 1, 1:int(sc.m[k]) + 1]
             for k in range(sc.shape[0])]
    runs = [_scalar_runs(w) for w in wants]
    for NW in (1, 3):
        twin = _twin_runs(sm.table, [sc], mode, -10.0, -0.5, R, NW)
        st = twin.stats.numpy()
        if mode == LOCAL:
            np.testing.assert_array_equal(st[:, 0], np.asarray(ref.best))
            np.testing.assert_array_equal(st[:, 1], np.asarray(ref.best_i))
            np.testing.assert_array_equal(st[:, 2], np.asarray(ref.best_j))
        else:
            np.testing.assert_array_equal(st[:, 3:6], np.asarray(ref.final))
        for k, (want, rw) in enumerate(zip(wants, runs)):
            nb, mb = want.shape
            np.testing.assert_array_equal(
                twin.tb_view(0).numpy()[:nb, :mb, k], want,
                err_msg=f"NW={NW} pair {k}")
            np.testing.assert_array_equal(
                twin.tb_view(0, twin.run).numpy()[:nb, :mb, k], rw,
                err_msg=f"NW={NW} pair {k} runs")


def _walk_chunks():
    return [_run_chunk(1, 7, 40, 48), _run_chunk(2, 5, 24, 64)]


def _filled_runs(mode, og, eg):
    chunks = _walk_chunks()
    table = torch.from_numpy(JaxSM.blosum62().table.astype(np.float32))
    return chunks, fill_dp.fill_many(table, chunks, mode=mode, og=og, eg=eg,
                                     runs=True)


def _jax_tokens(chunks, filled, mode, L):
    tbs = tuple(filled.tb_view(c).numpy().transpose(0, 2, 1)[None]
                for c in range(len(chunks)))
    runs = tuple(filled.tb_view(c, filled.run).numpy().transpose(0, 2, 1)
                 [None] for c in range(len(chunks)))
    st = filled.stats.numpy()
    statss, lo = [], 0
    for ch in chunks:
        statss.append(st[lo:lo + ch.shape[0]][None])
        lo += ch.shape[0]
    cnt, toks = jwalk.walk_bundle_pooled_tokens(
        tbs, runs, tuple(statss), tuple(ch.n for ch in chunks),
        tuple(ch.m for ch in chunks), mode=mode, L=L)
    return np.asarray(cnt), np.asarray(toks)


def _L(chunks):
    return max(device_walk.max_path_len(ch.shape[1], ch.shape[2])
               for ch in chunks)


def _twin_tokens(filled, mode, L, shape):
    """K11 through the twin at ``shape`` (T, C), in the fill's order."""
    B = filled.desc.shape[0]
    cnt = np.zeros(B, np.int32)
    toks = np.zeros((L, B), np.uint8)
    rc = native.twin_lib().sw_twin_walk_tokens(
        1 if mode == LOCAL else 0, filled.tb.numpy().ctypes.data,
        filled.run.numpy().ctypes.data, filled.desc.numpy().ctypes.data,
        filled.stats.numpy().ctypes.data, filled.order.numpy().ctypes.data,
        B, L, *shape, cnt.ctypes.data, toks.ctypes.data)
    assert rc == 0, f"twin token walk at {shape}: rc {rc}"
    return cnt, toks


# (T, C): the launcher's tiles for two pools, and forced small tiles that
# jumps of up to 16 cells cross (1 x 1: a tile a cell)
TILES = [device_walk.TILES[2], (4, 8), (3, 5), (12, 20), (1, 1)]


@pytest.mark.parametrize("shape", TILES)
@pytest.mark.parametrize("og,eg", PENALTIES)
@pytest.mark.parametrize("mode", MODES)
def test_token_walk_plain_and_twin_match_jax(mode, og, eg, shape):
    """The plain token walk and the twin at every tile shape against the
    JAX walk, the twin also cut at half the longest walk's tokens; jumps
    of 9 cells or more (over two 4-row tiles) occur."""
    chunks, filled = _filled_runs(mode, og, eg)
    L = _L(chunks)
    cnt, toks = device_walk.walk_tokens(filled.tb, filled.run, filled.desc,
                                        filled.stats, mode=mode, L=L,
                                        order=filled.order)
    jcnt, jtoks = _jax_tokens(chunks, filled, mode, L)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(toks.numpy(), jtoks)
    tcnt, ttoks = _twin_tokens(filled, mode, L, shape)
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert ((jtoks >> 2) >= 8).any()
    cut = max(1, int(jcnt.max()) // 2)
    tcnt, ttoks = _twin_tokens(filled, mode, cut, shape)
    jcnt, jtoks = _jax_tokens(chunks, filled, mode, cut)
    assert jcnt.max() == cut
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_array_equal(ttoks, jtoks)
    # tokens are fewer than moves: the runs were jumped
    mcnt, _ = device_walk.walk_packed(filled.tb, filled.desc, filled.stats,
                                      mode=mode, L=L, order=filled.order)
    assert int(cnt.sum()) < int(mcnt.sum())


def _rebuild_inputs(mode):
    chunks, filled = _filled_runs(mode, -10.0, -0.5)
    cnt, toks = device_walk.walk_tokens(filled.tb, filled.run, filled.desc,
                                        filled.stats, mode=mode,
                                        L=_L(chunks), order=filled.order)
    st = filled.stats.numpy()
    if mode == LOCAL:
        hit = st[:, 0] > 0
        i0 = np.where(hit, st[:, 1], 0).astype(np.int32)
        j0 = np.where(hit, st[:, 2], 0).astype(np.int32)
        scores = np.maximum(st[:, 0], 0)
    else:
        i0 = np.concatenate([ch.n for ch in chunks])
        j0 = np.concatenate([ch.m for ch in chunks])
        scores = st[:, 3:6].max(axis=1)
    seq1s, seq2s = [], []
    for ch in chunks:
        for b in range(ch.shape[0]):
            seq1s.append("".join(LETTERS[c] for c in ch.codes1[b, :ch.n[b]]))
            seq2s.append("".join(LETTERS[c] for c in ch.codes2[b, :ch.m[b]]))
    return seq1s, seq2s, toks.numpy(), cnt.numpy(), i0, j0, scores


def _key(r):
    return (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
            r.end2)


@pytest.mark.parametrize("retain_all", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_token_rebuild_native_matches_python_and_jax(mode, retain_all):
    args = _rebuild_inputs(mode)
    ours = reconstruct.reconstruct_packed(*args, mode, retain_all,
                                          tokens=True)
    py = reconstruct.reconstruct_packed_py(*args, mode, retain_all,
                                           tokens=True)
    theirs = jrecon.reconstruct_packed(*args, mode, retain_all, tokens=True)
    assert [_key(r) for r in ours] == [_key(r) for r in py]
    assert [_key(r) for r in ours] == [_key(r) for r in theirs]


def test_token_rebuild_rejects_corrupt_stream():
    seq1s, seq2s, toks, cnt, i0, j0, scores = _rebuild_inputs(GLOBAL)
    bad = toks.copy()
    bad[0, 0] = 3          # state 3 is no move
    with pytest.raises(RuntimeError, match="token stream"):
        reconstruct.reconstruct_packed(seq1s, seq2s, bad, cnt, i0, j0,
                                       scores, GLOBAL, True, tokens=True)


def test_tokens_to_states_and_path_match_jax():
    toks = np.array([[0 | (3 << 2)], [2], [1]], np.uint8)
    assert device_walk.tokens_to_states(toks[:, 0], 3).tolist() == \
        [0, 0, 0, 0, 2, 1]
    seq1s, seq2s, toks, cnt, i0, j0, scores = _rebuild_inputs(GLOCAL)
    for k in range(len(seq1s)):
        assert device_walk.tokens_to_path(toks, cnt, int(i0[k]), int(j0[k]),
                                          k) == \
            jwalk.tokens_to_path(toks, cnt, int(i0[k]), int(j0[k]), k)


def test_plan_flushes_counts_run_bytes():
    ch = _run_chunk(5, 8, 64, 64)
    per = 64 * 64
    one = batch.plan_flushes([ch], 4 * per, score_only=False)
    two = batch.plan_flushes([ch], 4 * per, score_only=False, runs=True)
    assert [f.chunks[0].shape[0] for f in one] == [4, 4]
    assert [f.chunks[0].shape[0] for f in two] == [2, 2, 2, 2]
    assert not any(f.long for f in one + two)
    # a pair whose pointers fit but whose pointers and runs do not goes
    # down the long route
    assert all(f.long for f in batch.plan_flushes([ch], per, False,
                                                  runs=True))


def _pairs(seed, count=10):
    rng = np.random.default_rng(seed)
    letters = np.array(list(LETTERS))
    out = []
    for _ in range(count):
        a = "".join(rng.choice(letters, int(rng.integers(3, 110))))
        if rng.random() < 0.5:
            b = ("WW" + a * 2)[: int(rng.integers(3, 110))]
        else:
            b = "".join(rng.choice(letters, int(rng.integers(3, 110))))
        out.append((a, b))
    return out + [("AAAA", "WWWW"), ("A", "A"), (LETTERS * 3, LETTERS * 3),
                  ("", "ACD")]


@pytest.mark.parametrize("retain_all", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_batch_aligner_token_walk(mode, retain_all, monkeypatch):
    pairs = _pairs(29 + 2 * mode + retain_all)
    moves = BatchAligner(mode=mode, device="cpu").align_pairs(pairs,
                                                              retain_all)
    calls = []
    real = device_walk.walk_tokens

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(device_walk, "walk_tokens", counted)
    monkeypatch.setenv("SWTPU_TOKEN_WALK", "1")
    toks = BatchAligner(mode=mode, device="cpu").align_pairs(pairs,
                                                             retain_all)
    assert calls
    theirs = jswt.BatchAligner(mode=mode, backend="scan").align_pairs(
        pairs, retain_all)
    assert [_key(r) for r in toks] == [_key(r) for r in moves]
    assert [_key(r) for r in toks] == [_key(r) for r in theirs]
