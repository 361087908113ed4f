"""The port's traceback walk and string rebuild against the JAX package's.

K2's plain version (``ops/device_walk.walk_packed_ref``) and K2's host
twin (``csrc/cell_twin.cpp`` running ``csrc/sw_walk.cuh``'s walk through
its shared-memory tiles, every byte read checked against the tile copies
that have landed) are held against
``smithwaterman_tpu.ops.device_walk.walk_bundle_pooled`` on the same pointer
bytes, the twin at the launcher's tile shape and at small forced tiles, on
pairs with gaps longer than a tile, one-row and one-column pairs, a LOCAL
pair with no positive cell, and walks cut at L;
the native rebuild against its exact Python path and the JAX package's
rebuild.

Tolerance: exact equality of move counts, every packed move byte, and the
rebuilt strings, scores and spans.
"""

import numpy as np
import pytest
import torch

from smithwaterman_tpu.ops import device_walk as jwalk
from smithwaterman_tpu.ops import reconstruct as jrecon
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
from smithwaterman_tpu_torch.ops import (batch, device_walk, fill_dp, native,
                                         reconstruct)

MODES = [LOCAL, GLOCAL, GLOBAL]
PENALTIES = [(-10.0, -0.5), (0.0, 0.0), (-1.0, 0.0)]
LETTERS = "ARNDCQEGHILKMFPSTWYV"


def _chunk(seed, B, NP, MP):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, NP + 1, size=B).astype(np.int32)
    m = rng.integers(1, MP + 1, size=B).astype(np.int32)
    n[0], m[0] = 1, MP
    n[1], m[1] = NP, 1
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    c2[2, 2:10] = c1[2, 4:12]   # a shared motif: a real local alignment
    return batch.Chunk(c1, c2, n, m)


def _gap_chunk(seed=3):
    """Pairs whose walks leave tiles sideways and stop at once: a gap of 80
    in each sequence (longer than a tile is wide or tall) between two
    copies of a 30-residue motif, W against C (no positive cell: a LOCAL
    walk of no step), W against W, a pair identical along its 150
    residues and a random one."""
    rng = np.random.default_rng(seed)
    NP = MP = 150
    c1 = rng.integers(0, 20, size=(6, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(6, MP)).astype(np.uint8)
    n = np.array([60, 140, 1, 1, 150, 97], np.int32)
    m = np.array([140, 60, 1, 1, 150, 120], np.int32)
    c2[0, :30], c2[0, 110:140] = c1[0, :30], c1[0, 30:60]
    c1[1, :30], c1[1, 110:140] = c2[1, :30], c2[1, 30:60]
    w, c = LETTERS.index("W"), LETTERS.index("C")
    c1[2, 0], c2[2, 0], c1[3, 0], c2[3, 0] = w, c, w, w
    c2[4] = c1[4]
    return batch.Chunk(c1, c2, n, m)


def _filled(mode, og, eg):
    chunks = [_chunk(1, 7, 16, 24), _chunk(2, 5, 24, 12), _gap_chunk()]
    table = torch.from_numpy(SubstitutionMatrix.blosum62().table)
    return chunks, fill_dp.fill_many(table, chunks, mode=mode, og=og, eg=eg)


def _jax_walk(chunks, filled, mode, L):
    tbs = tuple(filled.tb_view(c).numpy().transpose(0, 2, 1)[None]
                for c in range(len(chunks)))
    st = filled.stats.numpy()
    statss, lo = [], 0
    for ch in chunks:
        statss.append(st[lo:lo + ch.shape[0]][None])
        lo += ch.shape[0]
    cnt, mv = jwalk.walk_bundle_pooled(
        tbs, tuple(statss), tuple(ch.n for ch in chunks),
        tuple(ch.m for ch in chunks), mode=mode, L=L)
    return np.asarray(cnt), np.asarray(mv)


def _L(chunks):
    return max(device_walk.max_path_len(ch.shape[1], ch.shape[2])
               for ch in chunks)


@pytest.mark.parametrize("og,eg", PENALTIES)
@pytest.mark.parametrize("mode", MODES)
def test_walk_packed_ref_matches_jax(mode, og, eg):
    chunks, filled = _filled(mode, og, eg)
    L = _L(chunks)
    cnt, mv = device_walk.walk_packed(filled.tb, filled.desc, filled.stats,
                                      mode=mode, L=L, order=filled.order)
    jcnt, jmv = _jax_walk(chunks, filled, mode, L)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    np.testing.assert_array_equal(mv.numpy(), jmv)


# (T, C): tile rows x columns.  The launcher's, and forced small tiles,
# which walks leave through the top and the left many times (odd sizes:
# tile rows off the source's 16-byte pieces; 12 x 20: four-step blocks
# between frequent events; 1 x 1: a tile a cell)
TILES = [device_walk.TILES[1], (4, 8), (3, 5), (12, 20), (1, 1)]


def twin_walk(filled, mode, L, shape, tokens=False, order=None):
    """K2 (K11 with ``tokens``) through the twin at ``shape`` (T, C),
    the pairs started in ``order`` (the fill's by default): (cnt, out)."""
    B = filled.desc.shape[0]
    T, C = shape
    order = filled.order.numpy() if order is None else order
    cnt = np.zeros(B, np.int32)
    out = np.zeros((L, B) if tokens else (-(-L // 4), B), np.uint8)
    pools = [filled.tb.numpy()] + ([filled.run.numpy()] if tokens else [])
    lib = native.twin_lib()
    fn = lib.sw_twin_walk_tokens if tokens else lib.sw_twin_walk
    rc = fn(1 if mode == LOCAL else 0, *(p.ctypes.data for p in pools),
            filled.desc.numpy().ctypes.data, filled.stats.numpy().ctypes.data,
            order.ctypes.data, B, L, T, C, cnt.ctypes.data,
            out.ctypes.data)
    assert rc == 0, f"twin walk at {shape}: rc {rc}"
    return cnt, out


@pytest.mark.parametrize("shape", TILES)
@pytest.mark.parametrize("og,eg", PENALTIES)
@pytest.mark.parametrize("mode", MODES)
def test_walk_twin_matches_jax(mode, og, eg, shape):
    """K2's own walk header through the g++ twin's checked tiles, at every
    tile shape, in the fill's order and in reverse; then cut at L = 7."""
    chunks, filled = _filled(mode, og, eg)
    L = _L(chunks)
    jcnt, jmv = _jax_walk(chunks, filled, mode, L)
    for order in (None, filled.order.numpy()[::-1].copy()):
        cnt, mv = twin_walk(filled, mode, L, shape, order=order)
        np.testing.assert_array_equal(cnt, jcnt)
        np.testing.assert_array_equal(mv, jmv)
    assert (jcnt > 80).any() and (jcnt == 0).any() == (mode == LOCAL)
    cnt, mv = twin_walk(filled, mode, 7, shape)
    jcnt, jmv = _jax_walk(chunks, filled, mode, 7)
    assert jcnt.max() == 7
    np.testing.assert_array_equal(cnt, jcnt)
    np.testing.assert_array_equal(mv, jmv)


def test_walk_twins_refuse_what_the_launchers_refuse():
    """No order, tiles of no row or column, tiles past a block's shared
    memory and (K11) a run pool off the pointer pool's address mod 16
    return rc 1."""
    chunks, filled = _filled(GLOBAL, -10.0, -0.5)
    L = _L(chunks)
    B = filled.desc.shape[0]
    head = (filled.desc.numpy().ctypes.data,
            filled.stats.numpy().ctypes.data)
    tail = head + (filled.order.numpy().ctypes.data, B, L)
    cnt = np.zeros(B, np.int32)
    out = np.zeros((L, B), np.uint8)
    tb = np.zeros(filled.tb.numel() + 16, np.uint8)
    tb[:-16] = filled.tb.numpy()
    lib = native.twin_lib()
    for T, C in ((4, 0), (400, 400), (0, 8)):
        assert lib.sw_twin_walk(0, tb.ctypes.data, *tail, T, C,
                                cnt.ctypes.data, out.ctypes.data) == 1
    assert lib.sw_twin_walk(0, tb.ctypes.data, *head, None, B, L, 4, 8,
                            cnt.ctypes.data, out.ctypes.data) == 1
    assert lib.sw_twin_walk(0, tb.ctypes.data, *tail, 4, 8,
                            cnt.ctypes.data, out.ctypes.data) == 0
    assert lib.sw_twin_walk_tokens(0, tb.ctypes.data, tb.ctypes.data + 1,
                                   *tail, 4, 8, cnt.ctypes.data,
                                   out.ctypes.data) == 1


def _rebuild_inputs(mode):
    chunks, filled = _filled(mode, -10.0, -0.5)
    L = _L(chunks)
    cnt, mv = device_walk.walk_packed(filled.tb, filled.desc, filled.stats,
                                      mode=mode, L=L, order=filled.order)
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
    return seq1s, seq2s, mv.numpy(), cnt.numpy(), i0, j0, scores


@pytest.mark.parametrize("retain_all", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_reconstruct_native_matches_python_and_jax(mode, retain_all):
    args = _rebuild_inputs(mode)
    ours = reconstruct.reconstruct_packed(*args, mode, retain_all)
    py = reconstruct.reconstruct_packed_py(*args, mode, retain_all)
    theirs = jrecon.reconstruct_packed(*args, mode, retain_all)
    as_t = [(r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
             r.end2) for r in ours]
    assert as_t == [(r.aligned1, r.aligned2, r.score, r.start1, r.end1,
                     r.start2, r.end2) for r in py]
    assert as_t == [(r.aligned1, r.aligned2, r.score, r.start1, r.end1,
                     r.start2, r.end2) for r in theirs]


def test_reconstruct_column_offset():
    """A pair's columns may start inside a wider move array (col0)."""
    seq1s, seq2s, mv, cnt, i0, j0, scores = _rebuild_inputs(GLOCAL)
    full = reconstruct.reconstruct_packed(seq1s, seq2s, mv, cnt, i0, j0,
                                          scores, GLOCAL, True)
    tail = reconstruct.reconstruct_packed(seq1s[3:], seq2s[3:], mv, cnt[3:],
                                          i0[3:], j0[3:], scores[3:],
                                          GLOCAL, True, col0=3)
    assert [r.aligned1 for r in tail] == [r.aligned1 for r in full[3:]]


def test_reconstruct_rejects_corrupt_stream():
    seq1s, seq2s, mv, cnt, i0, j0, scores = _rebuild_inputs(GLOBAL)
    bad = cnt.copy()
    bad[0] = 4 * mv.shape[0] + 1
    with pytest.raises(RuntimeError):
        reconstruct.reconstruct_packed(seq1s, seq2s, mv, bad, i0, j0,
                                       scores, GLOBAL, True)


def test_moves_to_path_matches_jax():
    seq1s, seq2s, mv, cnt, i0, j0, scores = _rebuild_inputs(GLOBAL)
    for k in range(len(seq1s)):
        assert device_walk.moves_to_path(mv, cnt, int(i0[k]), int(j0[k]),
                                         k) == \
            jwalk.moves_to_path(mv, cnt, int(i0[k]), int(j0[k]), k)
        np.testing.assert_array_equal(
            device_walk.unpack_moves(mv[:, k], int(cnt[k])),
            jwalk.unpack_moves(mv[:, k], int(cnt[k])))


def test_walk_packed_rejects_other_devices():
    with pytest.raises(ValueError):
        device_walk.walk_packed(torch.zeros(4, dtype=torch.uint8,
                                            device="meta"),
                                torch.zeros((1, 8), dtype=torch.int64),
                                torch.zeros((1, 8)), mode=LOCAL, L=4,
                                order=torch.zeros(1, dtype=torch.int32))
