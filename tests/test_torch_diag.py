"""The port's wavefront score fill against the JAX package's, exactly.

K9's plain version (``ops/diag_dp.fill_diag_ref``) and K9's host twin
(``csrc/cell_twin.cpp`` running ``csrc/sw_diag.cuh`` lane by lane, at
every R columns a lane the launcher can pick) are held against
``smithwaterman_tpu.ops.diag_dp.fill_diag_scores`` (the Pallas wavefront
kernel in interpret mode) and the JAX scan oracle's LOCAL best;
``BatchAligner(device="cpu", diag_scores=True)`` against the JAX
``BatchAligner(backend="scan")``.

Tolerance: exact equality of every f32 best score.
"""

import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu.ops import diag_dp as jdiag
from smithwaterman_tpu_torch import LOCAL, GLOCAL, BatchAligner
from smithwaterman_tpu_torch.ops import batch, diag_dp, native

LETTERS = np.array(list("ARNDCQEGHILKMFPSTWYV"))


def _chunk(seed, B, NP, MP):
    rng = np.random.default_rng(seed)
    n = rng.integers(1, NP + 1, size=B).astype(np.int32)
    m = rng.integers(1, MP + 1, size=B).astype(np.int32)
    n[0], m[1] = 1, 1                    # a one-row and a one-column pair
    n[2], m[2] = NP, MP                  # a full pair
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    w = min(NP, MP) // 2                 # a long shared stretch
    c2[3, 5:5 + w] = c1[3, 1:1 + w]
    n[3], m[3] = NP, MP
    if B > 4 and MP > diag_dp.LANES:
        # a stretch from row 0 across the first strip boundary: lane 0 of
        # the second strip reads the edge at its first step
        k = min(w, MP - diag_dp.LANES + 1)
        c1[4, :k] = 18                   # W against W: BLOSUM62's 11
        c2[4, diag_dp.LANES - 1:diag_dp.LANES - 1 + k] = 18
        n[4], m[4] = NP, MP
    return batch.Chunk(c1, c2, n, m)


def _table():
    return JaxSM.blosum62().table.astype(np.float32)


def _ref(ch, og, eg, table=None, lanes=diag_dp.LANES):
    table = _table() if table is None else table
    return diag_dp.fill_diag_ref(
        torch.from_numpy(table), *(torch.from_numpy(a) for a in ch),
        og=og, eg=eg, lanes=lanes).numpy()


def _twin(ch, og, eg, table=None):
    """The K9 twin at every R of ``diag_dp.LANE_COLS``, which must agree;
    returns their stats."""
    table = np.ascontiguousarray(_table() if table is None else table)
    desc, floats = diag_dp.layout([ch])
    B = ch.shape[0]
    out = None
    for R in diag_dp.LANE_COLS:
        scratch = np.full(max(floats, 1), np.nan, np.float32)
        stats = np.ones((B, 8), np.float32)
        rc = native.twin_lib().sw_twin_diag_fill(
            R, table.ctypes.data, table.shape[0], ch.codes1.itemsize,
            ch.codes1.ctypes.data, ch.codes2.ctypes.data, desc.ctypes.data,
            B, scratch.ctypes.data, stats.ctypes.data, og, eg)
        assert rc == 0, f"R={R}: rc {rc}"
        if out is None:
            out = stats
        np.testing.assert_array_equal(stats, out, err_msg=f"R={R}")
    return out


def _jax_scan_best(ch, og, eg, table=None):
    table = _table() if table is None else table
    S = table[ch.codes1[:, :, None].astype(np.int64),
              ch.codes2[:, None, :].astype(np.int64)]
    r = jbatch.fill_scan(S, ch.n, ch.m, mode=LOCAL, og=og, eg=eg,
                         score_only=True)
    return np.asarray(r.best)


@pytest.mark.parametrize("og,eg", [(-10.0, -0.5), (0.0, 0.0)])
def test_plain_and_twin_match_pallas_wavefront(og, eg):
    """B = 16, NP = 128, MP = 256 against the Pallas kernel itself."""
    ch = _chunk(7, 16, 128, 256)
    S = jbatch.scores_tiled(_table(), ch.codes1.astype(np.int32),
                            ch.codes2.astype(np.int32), as_int8=True,
                            tile=8, n=ch.n, m=ch.m)
    want = np.asarray(jdiag.fill_diag_scores(S, og=og, eg=eg,
                                             interpret=True))
    want = want.reshape(-1, 8)
    ours = _ref(ch, og, eg)
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(_twin(ch, og, eg), want)


@pytest.mark.parametrize("og,eg", [(-12.5, -0.25), (-5.0, -2.0), (-1.0, 0.0)])
def test_plain_and_twin_match_scan_best(og, eg):
    """Two chunks, one rectangular each way, against the scan oracle."""
    for ch in (_chunk(11 + int(-og), 9, 40, 75), _chunk(12, 6, 70, 33)):
        want = _jax_scan_best(ch, og, eg)
        ours = _ref(ch, og, eg)
        np.testing.assert_array_equal(ours[:, 0], want)
        assert not ours[:, 1:].any()
        # any strip width gives the same values: 128 as on the TPU, and
        # one strip over every column
        for lanes in (128, ch.shape[2]):
            np.testing.assert_array_equal(_ref(ch, og, eg, lanes=lanes), ours)
        np.testing.assert_array_equal(_twin(ch, og, eg)[:, 0], want)


def test_rectangular_and_length_one():
    """NP not a multiple of the strip width, NP > MP, n = 1, m = 1, m equal
    to a strip boundary, a non-integer table."""
    ch = _chunk(21, 8, 97, 32)
    ch.m[4], ch.m[5] = 31, 32
    ch.n[6], ch.m[6] = 1, 1
    half = _table() * np.float32(0.5)
    for table in (_table(), half):
        want = _jax_scan_best(ch, -10.0, -0.5, table)
        np.testing.assert_array_equal(_ref(ch, -10.0, -0.5, table)[:, 0],
                                      want)
        np.testing.assert_array_equal(_twin(ch, -10.0, -0.5, table)[:, 0],
                                      want)


def _ragged_around_strips(dtype):
    """Pairs whose widths sit around every strip width 32 R (m = 1, 32 R -
    1, 32 R, 32 R + 1) and heights from 1 up; pair 0's seq1 is all code
    0 (A, A/A = 4) against a seq2 of W (A/W = -3) one column past a strip,
    so the dead columns of its last strip, whose codes are 0, would hold
    far higher M than any cell of the pair; pair 1 a stretch across the
    strip boundaries of every R."""
    widths = [1, 33, 31, 32, 63, 64, 65, 127, 128, 129, 255, 256, 257]
    heights = [70, 1, 2, 31, 33, 64, 70, 5, 40, 69, 1, 17, 70]
    B, NP, MP = len(widths), max(heights), max(widths)
    rng = np.random.default_rng(77)
    c1 = rng.integers(0, 20, size=(B, NP)).astype(dtype)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(dtype)
    c1[0] = 0
    c2[0] = 17
    c2[1, :200] = 18
    c1[1, 10:70] = 18
    return batch.Chunk(c1, c2, np.asarray(heights, np.int32),
                       np.asarray(widths, np.int32))


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
@pytest.mark.parametrize("og,eg", [(-10.0, -0.5), (0.0, 0.0)])
def test_twin_every_R_ragged_strips(og, eg, dtype):
    """Widths around 32, 64, 128 and 256 (for every R, a last strip of
    one live column, of all but one, of every one, or a lane's R cells
    cut anywhere), heights from 1, dead columns that would win the best,
    uint8 and int16 codes: the twin at every R, the plain wavefront and
    the scan oracle, exactly."""
    ch = _ragged_around_strips(dtype)
    want = _jax_scan_best(ch, og, eg)
    assert want[0] < 32 * 4  # the dead columns' diagonal would beat it
    np.testing.assert_array_equal(_ref(ch, og, eg)[:, 0], want)
    np.testing.assert_array_equal(_twin(ch, og, eg)[:, 0], want)


def test_lane_cols():
    """The launcher's R: the widest strip the flush's widest chunk fills."""
    assert [diag_dp.lane_cols(MP) for MP in (1, 31, 32, 63, 64, 128, 255,
                                             256, 700)] == \
        [2, 2, 2, 2, 2, 4, 4, 8, 8]


def test_open_cheaper_than_extend_raises():
    ch = _chunk(3, 4, 16, 16)
    with pytest.raises(ValueError, match="og <= eg <= 0"):
        diag_dp.fill_diag(torch.from_numpy(_table()), [ch], og=0.0, eg=-1.0)
    with pytest.raises(ValueError, match="og <= eg <= 0"):
        _ref(ch, -1.0, 0.5)
    with pytest.raises(ValueError):
        diag_dp.fill_diag(torch.zeros((24, 24), device="meta"), [ch],
                          og=-10.0, eg=-0.5)


def test_eligible():
    n, m = np.array([3, 1]), np.array([1, 9])
    kw = dict(og=-10.0, eg=-0.5, n=n, m=m)
    assert diag_dp.eligible(mode=LOCAL, score_only=True, **kw)
    assert not diag_dp.eligible(mode=LOCAL, score_only=False, **kw)
    assert not diag_dp.eligible(mode=GLOCAL, score_only=True, **kw)
    assert not diag_dp.eligible(mode=LOCAL, score_only=True, og=0.0,
                                eg=-1.0, n=n, m=m)
    assert not diag_dp.eligible(mode=LOCAL, score_only=True, og=-10.0,
                                eg=-0.5, n=np.array([0, 2]), m=m)


def _seqs(count, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(LETTERS, int(rng.integers(lo, hi + 1))))
            for _ in range(count)]


def test_batch_aligner_diag_route(monkeypatch):
    """score_pairs with the wavefront route equals the JAX scan backend
    over mixed buckets and goes through fill_diag; align_pairs never
    takes it (cf. tests/test_diag_kernel.py test_batch_aligner_diag_route)."""
    a = _seqs(6, 20, 60, 1)
    b = _seqs(6, 100, 250, 2)
    pairs = list(zip(a + b, b + a)) + [("", "ACD"), ("W", "W")]
    calls = []
    real = diag_dp.fill_diag

    def counted(*args, **kw):
        calls.append(len(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(diag_dp, "fill_diag", counted)
    ours = BatchAligner(device="cpu", diag_scores=True)
    got = ours.score_pairs(pairs)
    assert calls and sum(calls) > 1
    want = jswt.BatchAligner(backend="scan").score_pairs(pairs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, BatchAligner(device="cpu").score_pairs(pairs))
    calls.clear()
    r1 = ours.align_pairs(pairs[:4])
    assert not calls
    r2 = jswt.BatchAligner(backend="scan").align_pairs(pairs[:4])
    for x, y in zip(r1, r2):
        assert (x.aligned1, x.aligned2, x.score) == (y.aligned1, y.aligned2,
                                                     y.score)
    # the environment switch, and a configuration the route refuses
    monkeypatch.setenv("SWTPU_DIAG_SCORES", "1")
    assert BatchAligner(device="cpu").diag_scores
    open_cheap = BatchAligner(device="cpu", diag_scores=True, gap_open=0.5,
                              gap_extend=1.0)
    got = open_cheap.score_pairs(pairs[:5])
    assert not calls
    np.testing.assert_array_equal(
        got, jswt.BatchAligner(backend="scan", gap_open=0.5,
                               gap_extend=1.0).score_pairs(pairs[:5]))
