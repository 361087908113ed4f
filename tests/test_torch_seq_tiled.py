"""The port's striped (sequence-tiled) fill against the JAX package's, exactly.

``smithwaterman_tpu_torch/parallel/seq_tiled.py`` runs on a mesh of CPU
devices (``make_mesh(devices=["cpu"] * D)``) with the plain versions of
K12 and K13 (``block_ref``, ``grid_fill_ref``) and is held against
``smithwaterman_tpu/parallel/seq_tiled.py`` on the 8 virtual CPU devices of
``tests/conftest.py``, on the inputs of ``tests/test_seq_tiled.py``:

* ``striped_fill``, ``striped_fill_ckpt``, ``striped_band_tb`` (seeded
  from JAX's own checkpoints) and ``striped_align`` at D = 8 and D = 1,
  against JAX's ``rows="jax"`` path; the D = 1 grid inputs (int8 and
  ``fold_S``) and their refusal off the grid path;
* a non-integer table and penalties (og = -10.3, eg = -0.7) at D = 4.
  XLA's CPU compiler contracts a multiply and the add after it into one
  fused multiply-add inside a fusion, which the JAX code does not say and
  the card (``nvcc --fmad=false``) does not do; there the JAX functions
  are compiled with the HLO ``fusion`` pass off, so each operation rounds
  once, as written;
* ``walk_band`` against JAX's;
* the g++ twin of K12 and K13 (``csrc/cell_twin.cpp``, the kernels' own
  ``csrc/sw_striped.cuh``) in place of the plain versions, across shard
  edges, against the plain versions;
* two tiny cases of JAX's ``rows="pallas", interpret=True``: the block
  kernel (B7) at D = 8 and the grid kernel (B9) at D = 1.

Tolerance: exact equality of every score, stat, checkpoint value, pointer
byte and index.
"""

import functools

import numpy as np
import pytest
import torch

from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import longseq as jlongseq
from smithwaterman_tpu.parallel import make_mesh as jax_mesh
from smithwaterman_tpu.parallel import seq_tiled as jst
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.ops import kernels, longseq, native
from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled
from smithwaterman_tpu_torch.utils.convert import from_jax_striped

MODES = [LOCAL, GLOCAL, GLOBAL]
B, NP, MP = 3, 256, 256
OG, EG = -10.0, -0.5
SM = JaxSM.blosum62()
# the JAX compile option under which each operation rounds once (see above)
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


def _scores(c1, c2, scale=1.0):
    return (np.stack([SM.dense_scores(a, b) for a, b in zip(c1, c2)])
            * np.float32(scale)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _data():
    """tests/test_seq_tiled.py's _data(): 3 pairs of 256 x 256 codes."""
    rng = np.random.default_rng(17)
    codes1 = rng.integers(0, 24, size=(B, NP)).astype(np.int32)
    codes2 = rng.integers(0, 24, size=(B, MP)).astype(np.int32)
    n = np.array([256, 200, 129], dtype=np.int32)
    m = np.array([256, 131, 256], dtype=np.int32)
    return _scores(codes1, codes2), n, m


def _meshes(D):
    return jax_mesh(D), make_mesh(devices=["cpu"] * D)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@functools.lru_cache(maxsize=None)
def _jax_ckpt(mode, D):
    S, n, m = _data()
    stats, ck = jst.striped_fill_ckpt(S, n, m, mode=mode, og=OG, eg=EG,
                                      block_rows=32, ckpt_rows=64,
                                      mesh=jax_mesh(D))
    return np.asarray(stats), tuple(np.asarray(a) for a in ck)


# ------------------------------------------------------------ the mesh
def test_make_mesh():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert make_mesh(2, devices=["cpu"] * 8).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_wrappers_refuse_other_devices():
    S = torch.zeros((1, 8, 8), device="meta")
    n = torch.ones(1, dtype=torch.int32, device="meta")
    pen = seq_tiled.make_pen(LOCAL, OG, EG)
    with pytest.raises(ValueError, match="no striped fill"):
        seq_tiled.grid_fill(S, n, n, mode=LOCAL, pen=pen)
    with pytest.raises(ValueError, match="no striped fill"):
        seq_tiled.block_fill(S, n, n, *([None] * 7), ds=[0], t=0, i0=0, K=8,
                             W=8, s_lo=0, mode=LOCAL, pen=pen)


def test_mesh_over_two_devices_matches_one():
    """A mesh that alternates two devices ("cpu" and "cpu:0" are two
    keys of the mesh): each shard's outbox is copied to the other device
    every step and the outputs are gathered, equal to a one-device mesh's."""
    S, n, m = _data()
    one = make_mesh(devices=["cpu"] * 4)
    two = make_mesh(devices=["cpu", "cpu:0"] * 2)
    for mode in MODES:
        kw = dict(mode=mode, og=OG, eg=EG, block_rows=32, ckpt_rows=64)
        st1, ck1 = seq_tiled.striped_fill_ckpt(S, n, m, mesh=one, **kw)
        st2, ck2 = seq_tiled.striped_fill_ckpt(S, n, m, mesh=two, **kw)
        assert torch.equal(st1, st2)
        assert all(torch.equal(a, b) for a, b in zip(ck1, ck2))
        kw = dict(mode=mode, og=OG, eg=EG, block_rows=16)
        tb1, tb2 = (seq_tiled.striped_band_tb(S[:, 64:128], n, m, 64,
                                              *(a[:, 0] for a in ck1),
                                              mesh=mesh, **kw)
                    for mesh in (one, two))
        assert torch.equal(tb1, tb2)


# ------------------------------------------------------------ fills
@pytest.mark.parametrize("block_rows", [32, 256])
@pytest.mark.parametrize("mode", MODES)
def test_striped_fill_matches_jax(mode, block_rows):
    S, n, m = _data()
    jm, pm = _meshes(8)
    kw = dict(mode=mode, og=OG, eg=EG, block_rows=block_rows)
    want = np.asarray(jst.striped_fill(S, n, m, mesh=jm, **kw))
    got = seq_tiled.striped_fill(S, n, m, mesh=pm, **kw)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("D", [8, 1])
@pytest.mark.parametrize("mode", MODES)
def test_striped_fill_ckpt_matches_jax(mode, D):
    S, n, m = _data()
    stats, ck = seq_tiled.striped_fill_ckpt(
        S, n, m, mode=mode, og=OG, eg=EG, block_rows=32, ckpt_rows=64,
        mesh=make_mesh(devices=["cpu"] * D))
    wstats, wck = _jax_ckpt(mode, D)
    np.testing.assert_array_equal(_np(stats), wstats)
    for got, want in zip(ck, wck):
        assert tuple(got.shape) == want.shape == (B, NP // 64, MP)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("D", [8, 1])
@pytest.mark.parametrize("mode", MODES)
def test_striped_band_tb_matches_jax(mode, D):
    """A band re-fill seeded from JAX's own checkpoints (carried across by
    utils/convert.from_jax_striped): every pointer byte."""
    S, n, m = _data()
    jm, pm = _meshes(D)
    wstats, wck = _jax_ckpt(mode, D)
    _, ck = from_jax_striped(wstats, wck)
    sk, C = 2, 64
    seeds = [a[:, sk - 1] for a in wck]
    kw = dict(mode=mode, og=OG, eg=EG, block_rows=16)
    want = np.asarray(jst.striped_band_tb(
        S[:, sk * C:(sk + 1) * C], n, m, np.int32(sk * C), *seeds, mesh=jm,
        **kw))
    got = seq_tiled.striped_band_tb(
        S[:, sk * C:(sk + 1) * C], n, m, sk * C, *(a[:, sk - 1] for a in ck),
        mesh=pm, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(_np(got), want)


# ------------------------------------------------------------ alignment
def _align_both(S, n, m, D, **kw):
    jm, pm = _meshes(D)
    want = jst.striped_align(S, n, m, mesh=jm, **kw)
    got = seq_tiled.striped_align(S, n, m, mesh=pm, **kw)
    return got, want


def _assert_align_equal(got, want):
    (idx, stats), (widx, wstats) = got, want
    np.testing.assert_array_equal(stats, wstats)
    assert len(idx) == len(widx)
    for b, (g, w) in enumerate(zip(idx, widx)):
        assert g == w, f"pair {b}"


@pytest.mark.parametrize("mode", MODES)
def test_striped_align_matches_jax(mode):
    """tests/test_seq_tiled.py's alignment inputs at D = 8."""
    rng = np.random.default_rng(18)
    c1 = rng.integers(0, 23, size=(B, NP))
    c2 = rng.integers(0, 23, size=(B, MP))
    n = np.array([256, 180, 111], dtype=np.int32)
    m = np.array([256, 121, 250], dtype=np.int32)
    got, want = _align_both(_scores(c1, c2), n, m, 8, mode=mode, og=OG,
                            eg=EG, block_rows=16, ckpt_rows=64)
    _assert_align_equal(got, want)
    assert all(len(i1) for i1, _ in got[0])


def test_striped_align_walk_left_rerounds(monkeypatch):
    """A gap run longer than the column window (window=128): WALK_LEFT
    re-rounds re-fill the same segment."""
    rng = np.random.default_rng(19)
    npp, mpp = 32, 512
    c1 = rng.integers(0, 20, size=(B, npp))
    c2 = rng.integers(0, 20, size=(B, mpp))
    n = np.full(B, npp, np.int32)
    m = np.array([512, 300, 512], np.int32)
    calls = []
    real = seq_tiled._seg_windows

    def counted(*a, **k):
        calls.append(a[5])
        return real(*a, **k)

    monkeypatch.setattr(seq_tiled, "_seg_windows", counted)
    got, want = _align_both(_scores(c1, c2), n, m, 8, mode=GLOBAL, og=OG,
                            eg=EG, block_rows=8, ckpt_rows=8, window=128)
    _assert_align_equal(got, want)
    assert len(calls) > len(set(calls)), "no segment was re-filled"


def test_striped_align_degenerate_penalties_one_device():
    """og = eg = 0 through the striped fill and band re-fills at D = 1."""
    rng = np.random.default_rng(20)
    c1 = rng.integers(0, 24, size=(B, NP))
    c2 = rng.integers(0, 24, size=(B, MP))
    n = np.array([256, 100, 31], dtype=np.int32)
    m = np.array([256, 41, 250], dtype=np.int32)
    got, want = _align_both(_scores(c1, c2), n, m, 1, mode=GLOBAL, og=0.0,
                            eg=0.0, block_rows=16, ckpt_rows=64)
    _assert_align_equal(got, want)


# ------------------------------------------------------------ D = 1 inputs
def _grid_input():
    """tests/test_seq_tiled.py's grid input: one 48 x 1024 pair, m = 997."""
    rng = np.random.default_rng(21)
    c1 = rng.integers(0, 20, size=(1, 48))
    c2 = rng.integers(0, 20, size=(1, 1024))
    return _scores(c1, c2), np.array([48], np.int32), np.array([997],
                                                               np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_grid_fill_int8_and_folded_inputs(mode):
    """The D = 1 grid path takes int8 S (widened in the kernel) and
    fold_S's layout; both equal JAX's f32 rows path.  In GLOCAL JAX's grid
    kernel itself (B9) runs too, in interpret mode, on the int8 input."""
    S, n, m = _grid_input()
    jm, pm = _meshes(1)
    kw = dict(mode=mode, og=OG, eg=EG, block_rows=8)
    want = np.asarray(jst.striped_fill(S, n, m, mesh=jm, **kw))
    S8 = S.astype(np.int8)
    got_i8 = seq_tiled.striped_fill(S8, n, m, mesh=pm, **kw)
    got_f = seq_tiled.striped_fill(seq_tiled.fold_S(torch.from_numpy(S8)), n,
                                   m, mesh=pm, folded=True, **kw)
    np.testing.assert_array_equal(_np(got_i8), want)
    np.testing.assert_array_equal(_np(got_f), want)
    if mode == GLOCAL:
        b9 = np.asarray(jst.striped_fill(S8, n, m, mesh=jm, rows="pallas",
                                         interpret=True, **kw))
        np.testing.assert_array_equal(_np(got_i8), b9)


def test_grid_only_inputs_refused_off_the_grid_path():
    S = np.zeros((1, 48, 1024), np.int8)
    n, m = np.array([48], np.int32), np.array([1024], np.int32)
    kw = dict(mode=LOCAL, og=OG, eg=EG)
    with pytest.raises(ValueError, match="grid kernel"):
        seq_tiled.striped_fill(seq_tiled.fold_S(torch.from_numpy(S)), n, m,
                               block_rows=4, mesh=make_mesh(devices=["cpu"]),
                               folded=True, **kw)
    with pytest.raises(ValueError, match="grid kernel"):
        seq_tiled.striped_fill(S, n, m, block_rows=8,
                               mesh=make_mesh(devices=["cpu"] * 2), **kw)
    with pytest.raises(ValueError, match="f32 or int8"):
        seq_tiled.striped_fill(S.astype(np.float16), n, m, block_rows=8,
                               mesh=make_mesh(devices=["cpu"]), **kw)


def test_block_kernel_in_interpret_mode_matches():
    """JAX's block kernel (B7) itself, rows="pallas" in interpret mode, at
    D = 8 on 64 rows, against the port."""
    S, n, m = _data()
    S, n = np.ascontiguousarray(S[:, :64]), np.minimum(n, 64)
    jm, pm = _meshes(8)
    kw = dict(mode=LOCAL, og=OG, eg=EG, block_rows=32)
    want = np.asarray(jst.striped_fill(S, n, m, mesh=jm, rows="pallas",
                                       interpret=True, **kw))
    np.testing.assert_array_equal(
        _np(seq_tiled.striped_fill(S, n, m, mesh=pm, **kw)), want)


# ------------------------------------------------------------ non-integer
def _no_fusion(fn, *args, **static):
    return fn.lower(*args, **static).compile(compiler_options=NO_FUSION)(
        *args)


@pytest.mark.parametrize("mode", MODES)
def test_non_integer_scores_and_penalties_at_four_shards(mode):
    """S = BLOSUM62 * 0.37, og = -10.3, eg = -0.7 at D = 4: every partial
    sum rounds, so only the JAX code's order of operations agrees."""
    rng = np.random.default_rng(22)
    c1 = rng.integers(0, 24, size=(B, 128))
    c2 = rng.integers(0, 24, size=(B, 128))
    S = _scores(c1, c2, 0.37)
    n = np.array([128, 100, 65], np.int32)
    m = np.array([128, 67, 128], np.int32)
    jm, pm = _meshes(4)
    kw = dict(mode=mode, og=-10.3, eg=-0.7, block_rows=16)
    want = np.asarray(_no_fusion(jst.striped_fill, S, n, m, mesh=jm, **kw))
    np.testing.assert_array_equal(
        _np(seq_tiled.striped_fill(S, n, m, mesh=pm, **kw)), want)
    wst, wck = _no_fusion(jst.striped_fill_ckpt, S, n, m, mesh=jm,
                          ckpt_rows=32, **kw)
    st, ck = seq_tiled.striped_fill_ckpt(S, n, m, mesh=pm, ckpt_rows=32,
                                         **kw)
    np.testing.assert_array_equal(_np(st), np.asarray(wst))
    for a, w in zip(ck, wck):
        np.testing.assert_array_equal(_np(a), np.asarray(w))
    seeds = [np.array(a)[:, 1] for a in wck]
    wtb = _no_fusion(jst.striped_band_tb, S[:, 64:96], n, m, np.int32(64),
                     *seeds, mesh=jm, **kw)
    tb = seq_tiled.striped_band_tb(S[:, 64:96], n, m, 64,
                                   *(torch.from_numpy(a) for a in seeds),
                                   mesh=pm, **kw)
    np.testing.assert_array_equal(_np(tb), np.asarray(wtb))


# ------------------------------------------------------------ walk_band
def test_walk_band_matches_jax():
    """The native band-window walk against JAX's walk_band on windows of
    real band re-fills, from starts that end in each status."""
    S, n, m = _data()
    pm = make_mesh(devices=["cpu"] * 8)
    statuses = set()
    for mode in (LOCAL, GLOBAL):
        stats, ck = seq_tiled.striped_fill_ckpt(
            S, n, m, mode=mode, og=OG, eg=EG, block_rows=32, ckpt_rows=64,
            mesh=pm)
        row0 = tuple(torch.from_numpy(a) for a in
                     longseq.row0_carries(B, MP, mode, OG, EG))
        for sk in (0, 2):
            seeds = row0 if sk == 0 else tuple(a[:, sk - 1] for a in ck)
            tb = seq_tiled.striped_band_tb(
                S[:, sk * 64:(sk + 1) * 64], n, m, sk * 64, *seeds,
                mode=mode, og=OG, eg=EG, block_rows=16, mesh=pm).numpy()
            for b in range(B):
                i = min(int(n[b]), sk * 64 + 64)
                for j, s, j0, W in ((int(m[b]), 0, 0, MP), (100, 1, 60, 64),
                                    (200, 2, 80, 160), (40, 0, 0, 64)):
                    win = np.ascontiguousarray(tb[b, :, j0:j0 + W])
                    got = longseq.walk_band(win, sk * 64, j0, i, j, s,
                                            mode == LOCAL)
                    want = jlongseq.walk_band(win, sk * 64, j0, i, j, s,
                                              mode == LOCAL)
                    assert got == tuple(want), (mode, sk, b, j, s)
                    statuses.add(got[-1])
    assert statuses == {longseq.WALK_DONE, longseq.WALK_UP,
                        longseq.WALK_LEFT}


# ------------------------------------------------------------ the twin
# the H100's SMs: the twin takes the tiling the launcher would take there
TWIN_SMS = 132
BLOCK_STATE = ("rows", "box", "above", "best", "best_i", "acc", "tb")


def _twin_block(S, n, m, rows, box, above, best, best_i, acc, tb, *, ds, t,
                i0, K, W, s_lo, mode, pen, plan=None, blocks=0):
    """seq_tiled.block_ref's contract, run by the g++ twin of K12 with the
    tiling ``plan`` (L, E) (the launcher's when None) and ``blocks`` tiles
    in flight (0: all)."""
    ds_arr = np.asarray(ds, np.int32)
    B_, MP_ = best.shape
    L, E = plan or kernels.striped_plan(W, K, len(ds) * B_, TWIN_SMS)
    rc = native.twin_lib().sw_twin_striped_block(
        mode, 0 if tb is None else 1, ds_arr.ctypes.data, len(ds), t, i0,
        K, W, above.shape[0], B_, MP_, S.data_ptr(), S.stride(0),
        S.stride(1), s_lo, n.data_ptr(), m.data_ptr(), rows.data_ptr(),
        box.data_ptr(), above.data_ptr(), best.data_ptr(), best_i.data_ptr(),
        acc.data_ptr(), None if tb is None else tb.data_ptr(),
        0 if tb is None else tb.shape[1], *pen, L, E, blocks)
    assert rc == 0, rc


def _twin_grid(S, n, m, best, best_i, acc, ck, *, C, mode, pen, plan=None,
               blocks=0):
    """seq_tiled.grid_fill_ref's contract, run by the g++ twin of K13 (the
    tiling as _twin_block's)."""
    B_, NP_, MP_ = S.shape
    L, E = plan or kernels.striped_plan(MP_, NP_, B_, TWIN_SMS)
    cks = (None,) * 3 if ck is None else tuple(a.data_ptr() for a in ck)
    rc = native.twin_lib().sw_twin_striped_grid(
        mode, 1 if S.dtype == torch.int8 else 0, S.data_ptr(), B_, NP_, MP_,
        n.data_ptr(), m.data_ptr(), 0 if ck is None else C,
        best.data_ptr(), best_i.data_ptr(), acc.data_ptr(), *cks, *pen, L, E,
        blocks)
    assert rc == 0, rc


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_plain_across_shard_edges(mode, monkeypatch):
    """K12's and K13's twin in place of the plain versions, at the
    launcher's tiling: the checkpointed fill and a band re-fill at D = 2
    (W = 4500: rows of nine column tiles, the last one partial) and D = 4
    (W = 33), and the grid fill of f32 and int8 scores, every output equal
    to the plain versions'."""
    rng = np.random.default_rng(23 + mode)
    for D, mp in ((2, 9000), (4, 132)):
        c1 = rng.integers(0, 24, size=(2, 64))
        c2 = rng.integers(0, 24, size=(2, mp))
        c2[0, 5:60] = c1[0, 2:57]
        S = _scores(c1, c2, 0.5)
        n = np.array([64, 37], np.int32)
        m = np.array([mp, mp // 2 + 3], np.int32)
        mesh = make_mesh(devices=["cpu"] * D)
        kw = dict(mode=mode, og=-10.3, eg=-0.7, block_rows=8, mesh=mesh)

        def run():
            st, ck = seq_tiled.striped_fill_ckpt(S, n, m, ckpt_rows=16, **kw)
            tb = seq_tiled.striped_band_tb(S[:, 16:48], n, m, 16,
                                           *(a[:, 0] for a in ck), **kw)
            return st, ck, tb

        want = run()
        with monkeypatch.context() as mp_:
            mp_.setattr(seq_tiled, "block_ref", _twin_block)
            got = run()
        assert torch.equal(got[0], want[0])
        for a, w in zip(got[1], want[1]):
            assert torch.equal(a, w)
        assert torch.equal(got[2], want[2])
    S, n, m = _grid_input()
    S = np.concatenate([S] * 5, axis=2)  # 5120 columns: several tiles a row
    m[0] = 4999
    pen = seq_tiled.make_pen(mode, -10.3, -0.7)
    for S_ in (torch.from_numpy(S * np.float32(0.37)),
               torch.from_numpy(S.astype(np.int8))):
        args = (S_, torch.from_numpy(n), torch.from_numpy(m))
        want = seq_tiled.grid_fill(*args, mode=mode, pen=pen, C=16)
        with monkeypatch.context() as mp_:
            mp_.setattr(seq_tiled, "grid_fill_ref", _twin_grid)
            got = seq_tiled.grid_fill(*args, mode=mode, pen=pen, C=16)
        for a, w in zip(got[:3], want[:3]):
            assert torch.equal(a, w)
        for a, w in zip(got[3], want[3]):
            assert torch.equal(a, w)


def _lockstep(monkeypatch, plan, blocks):
    """Every K12 / K13 call of seq_tiled on the CPU runs the plain version
    on copies of its inputs and the twin (tiling ``plan``, ``blocks`` tiles
    in flight) on the inputs, and asserts every output equal.  Returns the
    count of calls a kernel."""
    calls = {"K12": 0, "K13": 0}
    real_block, real_grid = seq_tiled.block_ref, seq_tiled.grid_fill_ref

    def block(*state, **kw):
        ref = [None if a is None else a.clone() for a in state]
        real_block(*ref, **kw)
        _twin_block(*state, **kw, plan=plan, blocks=blocks)
        for name, a, r in zip(BLOCK_STATE, state[3:], ref[3:]):
            assert a is None or torch.equal(a, r), (name, kw)
        calls["K12"] += 1

    def grid(S, n, m, best, best_i, acc, ck, **kw):
        outs = [best, best_i, acc] + list(ck or ())
        ref = [torch.empty_like(a) for a in outs]
        real_grid(S, n, m, *ref[:3], ref[3:] or None, **kw)
        _twin_grid(S, n, m, best, best_i, acc, ck, **kw, plan=plan,
                   blocks=blocks)
        for a, r in zip(outs, ref):
            assert torch.equal(a, r), kw
        calls["K13"] += 1

    monkeypatch.setattr(seq_tiled, "block_ref", block)
    monkeypatch.setattr(seq_tiled, "grid_fill_ref", grid)
    return calls


@pytest.mark.parametrize("plan, blocks", [
    (None, 0),     # the launcher's tiling, every tile in flight
    ((8, 1), 0),   # tiles of 256 lanes, an edge published every row
    ((8, 3), 2),   # every 3 rows, two tiles in flight (tickets reused)
    ((8, 2), 1),   # one tile at a time, in ticket order
])
@pytest.mark.parametrize("mode", MODES)
def test_twin_tiles_match_plain_launch_by_launch(mode, plan, blocks,
                                                 monkeypatch):
    """K12's and K13's twin beside the plain versions, every launch, every
    output (row state, outbox and above edges, per-lane bests and rows,
    accumulators, pointer bytes, checkpoints), across tile edges: W = 300
    (not a multiple of the tile) at D = 1, 2 and 4 shards, W = 33 (under
    one tile) at D = 4, lengths down to 1, og = -10.3 and eg = -0.7, and
    int8 scores at D = 1."""
    calls = _lockstep(monkeypatch, plan, blocks)
    rng = np.random.default_rng(31 + mode)
    for D, W in ((1, 300), (2, 300), (4, 300), (4, 33)):
        mp = D * W
        c1 = rng.integers(0, 24, size=(3, 48))
        c2 = rng.integers(0, 24, size=(3, mp))
        c2[0, 7:47] = c1[0, 3:43]
        S = _scores(c1, c2, 0.37)
        n = np.array([48, 1, 29], np.int32)
        m = np.array([mp, mp // 3 + 1, 1], np.int32)
        kw = dict(mode=mode, og=-10.3, eg=-0.7, block_rows=8,
                  mesh=make_mesh(devices=["cpu"] * D))
        _, ck = seq_tiled.striped_fill_ckpt(S, n, m, ckpt_rows=16, **kw)
        seq_tiled.striped_band_tb(S[:, 16:32], n, m, 16,
                                  *(a[:, 0] for a in ck), **kw)
    S8 = torch.from_numpy(S[:1].astype(np.int8))
    seq_tiled.striped_fill(S8, n[:1], m[:1], mode=mode, og=-10.3, eg=-0.7,
                           block_rows=8, mesh=make_mesh(devices=["cpu"]))
    assert calls["K12"] > 0 and calls["K13"] == 2


def test_striped_plan():
    """The launcher's tiling at phase 14's shapes on an H100 (132 SMs):
    K13 over 65,536 lanes takes 128 tiles of 512 lanes and publishes every
    4 rows; K12's steps of 64 rows at D = 4 (32 tiles a shard) and the band
    re-fill (128) publish every row; a narrow fill of many rows takes the
    narrower tiles."""
    assert kernels.striped_plan(65536, 2048, 1, TWIN_SMS) == (16, 4)
    assert kernels.striped_plan(16384, 64, 4, TWIN_SMS) == (16, 1)
    assert kernels.striped_plan(65536, 64, 1, TWIN_SMS) == (16, 1)
    assert kernels.striped_plan(2048, 512, 1, TWIN_SMS) == (8, 8)
    assert kernels.striped_plan(32768, 2048, 1, TWIN_SMS) == (8, 4)
    assert kernels.striped_plan(4096, 512, 8, TWIN_SMS) == (8, 4)
    assert kernels.striped_plan(33, 8, 4, TWIN_SMS) == (8, 2)
