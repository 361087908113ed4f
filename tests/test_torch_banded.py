"""The port's banded alignment against the JAX package's, exactly.

Three implementations of the port are held against
``smithwaterman_tpu/ops/banded.py`` on the same seeded numpy inputs, the
JAX Pallas kernels in ``interpret=True`` as ``tests/test_banded.py`` runs
them:

* the plain versions in ``smithwaterman_tpu_torch/ops/banded.py``
  (``banded_scores_ref``, ``fill_banded_ref``, ``walk_banded_ref``) against
  ``_banded_scores`` / ``_banded_scores_pallas``, ``fill_banded`` and
  ``_walk_banded_device``;
* the host twin of kernels K7 and K8 (``csrc/cell_twin.cpp``, which runs
  the kernels' own header ``sw_banded.cuh``: K7's stripes of 64 rows,
  every lane of a stripe in turn at each step, the stripes in ticket order
  as their feed tiles are published) against the same, and the twin of
  K6's tiling (``sw_scores.cuh``: tiles of T rows, their offsets, sub-tiles
  cut to fit seq2's code window, quads of 4 columns, every window read
  checked) against ``banded_scores_ref`` and ``_banded_scores``;
* the entry points on the CPU (``align_banded_batch``,
  ``align_banded_verified``, ``Aligner(device="cpu").align_banded``) and
  the host walk ``walk_banded`` against JAX's.

Tolerance: exact equality of every score value, of every pointer byte in
each pair's true band rows (i <= n), of stats, walk indices, counts and
flags; strings and scores exactly.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import banded as jb
from smithwaterman_tpu_torch import Aligner
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.ops import banded, batch, native, traceback

MODES = [LOCAL, GLOCAL, GLOBAL]
OG, EG = -10.0, -0.5
TABLE = np.asarray(JaxSM.blosum62().table, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pairs(seed, ns, ms, K=20, similar=True):
    """Pairs of the given lengths; ``similar`` makes each seq2 a shifted,
    mutated copy of seq1 (the workload banded mode is for)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, m in zip(ns, ms):
        base = rng.integers(0, K, size=n + m + 10).astype(np.int32)
        c1 = base[:n].copy()
        c2 = (base[3:3 + m].copy() if similar
              else rng.integers(0, K, size=m).astype(np.int32))
        mut = rng.integers(0, m, size=max(1, m // 10))
        c2[mut] = rng.integers(0, K, size=len(mut))
        out.append((c1, c2))
    return out


def _tied_pairs(seed):
    """Two-letter pairs with a motif repeated down seq1: LOCAL maxima tie
    across rows and lanes."""
    rng = np.random.default_rng(seed)
    out = []
    for n, m in ((150, 120), (131, 140), (97, 100), (64, 61), (33, 90),
                 (120, 40), (8, 10), (1, 1)):
        c1 = rng.choice([0, 2], size=n).astype(np.int32)
        c2 = rng.choice([0, 2], size=m).astype(np.int32)
        motif = rng.choice([0, 2], size=6)
        for r in range(2, n - 6, 23):
            c1[r:r + 6] = motif
        if m > 20:
            c2[10:16] = motif
        out.append((c1, c2))
    return out


# (name, pairs, band, table, og, eg): ragged lengths and both signs of
# m - n, a band as wide as every seq2 (offsets all 0), og = eg = 0, a
# non-integer table, and tied maxima
RAGGED = ([150, 1, 200, 37, 120, 90, 64, 180],
          [170, 60, 150, 1, 140, 180, 64, 200])
CASES = {
    "ragged": (lambda: _pairs(1, *RAGGED), 128, TABLE, OG, EG),
    "wide": (lambda: _pairs(2, [90, 120, 60, 30, 100, 110, 5, 80],
                            [100, 128, 70, 44, 90, 128, 9, 60]),
             256, TABLE, OG, EG),
    "og=eg=0": (lambda: _pairs(3, *RAGGED, similar=False), 128, TABLE,
                0.0, 0.0),
    "table*0.5": (lambda: _pairs(4, *RAGGED), 128, TABLE * np.float32(0.5),
                  OG, EG),
    "ties": (lambda: _tied_pairs(5), 128,
             np.asarray(JaxSM.match_mismatch(5.0, -4.0).table, np.float32),
             OG, EG),
}


def _packed(case):
    make, band, table, og, eg = CASES[case]
    return banded.pack(make(), band, table.shape[0]), table, og, eg


def _S(pk, table):
    return banded.banded_scores_ref(_t(table), _t(pk.codes1), _t(pk.codes2),
                                    _t(pk.n), _t(pk.m), W=pk.W)


def _jax_fill(S, pk, mode, og, eg):
    tb, stats = jb.fill_banded(
        jnp.asarray(S.numpy().transpose(1, 0, 2)),
        jnp.asarray(pk.n[:, None]), jnp.asarray(pk.m[:, None]),
        mode=mode, og=og, eg=eg, interpret=True)
    return np.asarray(tb).transpose(1, 0, 2), np.asarray(stats)


def _twin_fill(S, pk, mode, og, eg, blocks=0):
    """The K7 twin, ``blocks`` stripes in flight (0: all)."""
    S = np.ascontiguousarray(S.numpy())
    B, NP, W = S.shape
    tb = np.zeros((B, NP, W), np.uint8)
    stats = np.full((B, 8), 7.0, np.float32)
    rc = native.twin_lib().sw_twin_banded_fill(
        mode, S.ctypes.data, pk.n.ctypes.data, pk.m.ctypes.data, B, NP, W,
        tb.ctypes.data, stats.ctypes.data, og, eg, blocks)
    assert rc == 0, f"twin blocks={blocks}: rc {rc}"
    return tb, stats


def _assert_tb_equal(got, want, pk, what):
    for b in range(len(pk.n)):
        n = int(pk.n[b])
        np.testing.assert_array_equal(got[b, :n], want[b, :n],
                                      err_msg=f"{what}: pair {b}")


# ------------------------------------------------------------ geometry
def test_band_offsets_match_jax():
    for n, m, W in ((100, 120, 64), (100, 80, 64), (7, 300, 296),
                    (1, 1, 128), (50, 50, 50), (3000, 3100, 512)):
        np.testing.assert_array_equal(banded.band_offsets(n, m, W),
                                      jb.band_offsets(n, m, W))
    for f in (banded.band_offsets, jb.band_offsets):
        with pytest.raises(ValueError):
            f(10, 200, 64)
    pk = banded.pack(_pairs(6, *RAGGED), 128, 24)
    off = banded.row_offsets(_t(pk.n), _t(pk.m), pk.W, pk.codes1.shape[1])
    np.testing.assert_array_equal(off.numpy(), pk.offs)
    with pytest.raises(ValueError, match="int32"):
        banded.pack([(np.zeros(50000, np.int32), np.zeros(100000, np.int32))],
                    128, 24)


@pytest.mark.parametrize("band", [128, 256])
def test_banded_scores_ref_matches_jax(band):
    pk = banded.pack(_pairs(7, *RAGGED), band, TABLE.shape[0])
    S = _S(pk, TABLE).numpy()
    NP = pk.codes1.shape[1]
    Mpad = -(-int(pk.m.max()) // 128) * 128 + 128
    c2 = np.zeros((8, Mpad), np.int32)
    c2[:, :pk.codes2.shape[1]] = pk.codes2
    nm = np.stack([pk.n, pk.m], axis=1).astype(np.int32)
    fast = np.asarray(jb._banded_scores_pallas(
        jnp.asarray(pk.codes1.astype(np.int32)), jnp.asarray(c2),
        jnp.asarray(TABLE), jnp.asarray(nm), W=pk.W, interpret=True))
    ref = np.asarray(jb._banded_scores(
        jnp.asarray(pk.codes1.astype(np.int32)),
        jnp.asarray(pk.codes2.astype(np.int32)), jnp.asarray(TABLE),
        jnp.asarray(pk.offs[:, 1:NP + 1]), jnp.asarray(pk.m), W=pk.W))
    np.testing.assert_array_equal(S, fast.transpose(1, 0, 2))
    np.testing.assert_array_equal(S, ref)


# (ns, ms, W, K): m ~ n (ragged, NP not a multiple of any tile), m >> n
# (the offset rises ~49 and ~48 columns a row: sub-tiles), m <= W
# (offsets all 0), n = 1, W % 4 != 0 (4-byte stores), a 65-symbol table
# (uint8 codes, read from device memory) and a 300-symbol one (int16)
SCORES_CASES = {
    "m~n": (RAGGED[0], RAGGED[1], 128, 20),
    "m>>n": ([100, 60], [5000, 3000], 128, 20),
    "m<=W": ([50, 100, 7], [100, 128, 3], 256, 20),
    "n=1": ([1, 1, 2], [300, 128, 500], 128, 20),
    "W%4": ([77, 40], [90, 170], 130, 20),
    "K=65": (RAGGED[0], RAGGED[1], 128, 65),
    "K=300": (RAGGED[0], RAGGED[1], 256, 300),
}
# (T, window bytes, columns a window): the card's window (0, 0) at 64-row
# tiles, and 7-row tiles through a window of 128 bytes in chunks of 32
# columns (every row a sub-tile of its own in "m>>n")
SCORES_PLANS = {"card": (64, 0, 0), "small": (7, 128, 32)}


def _scores_inputs(case):
    ns, ms, W, K = SCORES_CASES[case]
    rng = np.random.default_rng(sorted(SCORES_CASES).index(case))
    B, NP, MP = len(ns), max(ns) + 3, max(ms) + 5
    ct = batch.code_dtype(K)
    c1 = np.zeros((B, NP), ct)
    c2 = np.zeros((B, MP), ct)
    for b, (n, m) in enumerate(zip(ns, ms)):
        c1[b, :n] = rng.integers(0, K, size=n)
        c2[b, :m] = rng.integers(0, K, size=m)
    table = rng.standard_normal((K, K)).astype(np.float32)
    return (table, c1, c2, np.asarray(ns, np.int32), np.asarray(ms, np.int32),
            W)


@pytest.mark.parametrize("plan", list(SCORES_PLANS))
@pytest.mark.parametrize("case", list(SCORES_CASES))
def test_twin_banded_scores_match_jax(case, plan):
    """K6's tiling in the twin (16-byte stores where W % 4 == 0) against
    the plain scores and JAX's XLA-gather ``_banded_scores`` at the
    kernels' offsets: every value, bit for bit; every code read came from
    the current window's staged pieces (rc 3 otherwise)."""
    table, c1, c2, n, m, W = _scores_inputs(case)
    B, NP = c1.shape
    T, win, chunk = SCORES_PLANS[plan]
    S = np.full((B, NP, W), np.nan, np.float32)
    rc = native.twin_lib().sw_twin_banded_scores(
        table.ctypes.data, table.shape[0], c1.itemsize, c1.ctypes.data,
        c2.ctypes.data, n.ctypes.data, m.ctypes.data, B, NP, c2.shape[1], W,
        S.ctypes.data, T, int(W % 4 == 0), win, chunk)
    assert rc == 0, f"twin rc {rc}"
    ref = banded.banded_scores_ref(_t(table), _t(c1), _t(c2), _t(n), _t(m),
                                   W=W).numpy()
    off = banded.row_offsets(_t(n), _t(m), W, NP)[:, 1:].numpy()
    want = np.asarray(jb._banded_scores(
        jnp.asarray(c1.astype(np.int32)), jnp.asarray(c2.astype(np.int32)),
        jnp.asarray(table), jnp.asarray(off.astype(np.int32)),
        jnp.asarray(m), W=W))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(S, want)
    if case == "m>>n":  # the offset rises more than 40 columns a row
        for b, x in enumerate(n.tolist()):
            assert (np.diff(off[b, :x]) > 40).all()


# ------------------------------------------------------------ fill
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_fill_banded_matches_jax(mode, case):
    """The plain fill and the K7 twin against the Pallas kernel: stats and
    every pointer byte of each pair's rows i <= n."""
    pk, table, og, eg = _packed(case)
    S = _S(pk, table)
    jtb, jst = _jax_fill(S, pk, mode, og, eg)
    tb, st = banded.fill_banded_ref(S, _t(pk.n), _t(pk.m), mode=mode, og=og,
                                    eg=eg)
    np.testing.assert_array_equal(st.numpy(), jst)
    np.testing.assert_array_equal(tb.numpy(), jtb)
    ttb, tst = _twin_fill(S, pk, mode, og, eg)
    np.testing.assert_array_equal(tst, jst)
    _assert_tb_equal(ttb, jtb, pk, f"twin {case}")


# (name, pairs, band, og, eg) for the K7 stripes of 64 rows: one pair and
# eight at W = 512, n ragged around the stripes' edges (multiples of 64)
# and below one stripe, down to 1, eight at W = 128, og = eg = 0, and tied
# maxima (the match/mismatch table)
STRIPE_CASES = {
    "one W=512": (lambda: _pairs(30, [700], [760]), 512, OG, EG),
    "eight W=512": (lambda: _pairs(
        31, [704, 1, 255, 31, 641, 63, 639, 65],
        [720, 40, 300, 1, 560, 150, 700, 30]), 512, OG, EG),
    "eight W=128": (lambda: _pairs(
        32, [320, 64, 129, 7, 191, 256, 257, 127],
        [310, 70, 120, 9, 200, 240, 300, 130]), 128, OG, EG),
    "og=eg=0": (lambda: _pairs(33, [600, 5, 200, 300], [650, 3, 260, 280],
                               similar=False), 512, 0.0, 0.0),
    "ties": (lambda: _tied_pairs(34), 128, OG, EG),
}


@pytest.mark.parametrize("case", list(STRIPE_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_twin_stripes_match_plain(mode, case):
    """The K7 twin's stripes, every stripe in flight, one and three at a
    time (a stripe reads a feed tile only once it is published; a hang
    returns 2, an unfenced publication 3), against the plain fill: stats
    and every pointer byte of rows i <= n."""
    make, band, og, eg = STRIPE_CASES[case]
    table = (np.asarray(JaxSM.match_mismatch(5.0, -4.0).table, np.float32)
             if case == "ties" else TABLE)
    pk = banded.pack(make(), band, table.shape[0])
    S = _S(pk, table)
    tb, st = banded.fill_banded_ref(S, _t(pk.n), _t(pk.m), mode=mode, og=og,
                                    eg=eg)
    for blocks in (0, 1, 3):
        ttb, tst = _twin_fill(S, pk, mode, og, eg, blocks)
        what = f"{case} blocks={blocks}"
        np.testing.assert_array_equal(tst, st.numpy(), err_msg=what)
        _assert_tb_equal(ttb, tb.numpy(), pk, what)


# ------------------------------------------------------------ walk
def _jax_walk(tb, pk, start, mode, L):
    i1, i2, cnt, flags = jb._walk_banded_device(
        jnp.asarray(tb.transpose(1, 0, 2)), jnp.asarray(pk.offs),
        jnp.asarray(start[:, 0]), jnp.asarray(start[:, 1]),
        jnp.asarray(start[:, 2]), jnp.asarray(pk.m),
        jnp.asarray(start[:, 3] != 0), W=pk.W, local=mode == LOCAL, L=L)
    return tuple(np.asarray(a) for a in (i1, i2, cnt, flags))


def _walk_windows(W):
    """K8's rows a window in the twin: the card's (0), two and three (a
    switch every row or two), and -1, reads straight from the band."""
    return [0, 2, 3, -1]


def _twin_walk(tb, pk, start, mode, L, D):
    B, NP, W = tb.shape
    tb = np.ascontiguousarray(tb)
    start = np.ascontiguousarray(start, np.int32)
    i1 = np.zeros((B, L), np.int32)
    i2 = np.zeros((B, L), np.int32)
    cnt = np.zeros(B, np.int32)
    flags = np.zeros(B, np.int32)
    rc = native.twin_lib().sw_twin_banded_walk(
        1 if mode == LOCAL else 0, tb.ctypes.data, pk.offs.ctypes.data,
        start.ctypes.data, pk.m.ctypes.data, B, NP, W, L, D, i1.ctypes.data,
        i2.ctypes.data, cnt.ctypes.data, flags.ctypes.data)
    assert rc == 0, f"D={D}: rc {rc}"
    return i1, i2, cnt, flags


def _walks_agree(tb, pk, start, mode, L):
    """JAX's walk, the plain walk and the K8 twin at every window of
    _walk_windows on the same band; returns JAX's."""
    want = _jax_walk(tb, pk, start, mode, L)
    ref = banded.walk_banded_ref(_t(tb), _t(pk.offs), _t(start), _t(pk.m),
                                 local=mode == LOCAL, L=L)
    runs = [("plain", [a.numpy() for a in ref])]
    runs += [(f"twin D={D}", _twin_walk(tb, pk, start, mode, L, D))
             for D in _walk_windows(tb.shape[2])]
    for name, got in runs:
        for a, w, what in zip(got, want, ("idx1", "idx2", "cnt", "flags")):
            np.testing.assert_array_equal(a, w, err_msg=f"{name} {what}")
    return want


@pytest.mark.parametrize("case", ["ragged", "og=eg=0", "ties"])
@pytest.mark.parametrize("mode", MODES)
def test_walk_banded_matches_jax(mode, case):
    """Every pair's walk from the JAX fill's own band and stats."""
    pk, table, og, eg = _packed(case)
    jtb, jst = _jax_fill(_S(pk, table), pk, mode, og, eg)
    start, _ = banded.walk_starts(jst, pk, mode)
    i1, i2, cnt, flags = _walks_agree(jtb, pk, start, mode,
                                      banded.path_len(pk))
    assert (cnt[start[:, 3] != 0] > 0).all()


def test_walk_banded_flags():
    """Edge touches (a detour wider than the band), a band corrupted so the
    walk leaves it, and a capacity too short for the path: bits 0 and 1 as
    JAX sets them."""
    a = np.random.default_rng(9).integers(0, 20, size=600).astype(np.int32)
    junk = ((a[:200] + 7) % 20).astype(np.int32)
    pairs = [(a, np.concatenate([junk, a[:400]]))]
    pairs += _pairs(10, [500] * 7, [560] * 7)  # the JAX fill takes 8 pairs
    pk = banded.pack(pairs, 128, TABLE.shape[0])
    jtb, jst = _jax_fill(_S(pk, TABLE), pk, GLOCAL, OG, EG)
    start, _ = banded.walk_starts(jst, pk, GLOCAL)
    flags = _walks_agree(jtb, pk, start, GLOCAL, banded.path_len(pk))[3]
    assert flags[0] == 1
    # every pointer says "gap in seq1": the walks run left out of the band
    bad = np.full_like(jtb, 0x15)
    flags = _walks_agree(bad, pk, start, GLOCAL, banded.path_len(pk))[3]
    assert (flags & 2).all()
    flags = _walks_agree(jtb, pk, start, GLOCAL, 64)[3]
    assert (flags & 2).all()


@pytest.mark.parametrize("W", [130, 8])
@pytest.mark.parametrize("mode", MODES)
def test_walk_odd_widths_small_windows(mode, W):
    """Bands of W = 130 and 8 bytes a row (rows not 16-, or for 130 not
    even 4-byte aligned: the window copies' end pieces), random pointer
    bytes, walks from (n, m) and, in LOCAL, from inside the band: JAX's
    walk, the plain walk and the twin at every window, exactly; some walks
    leave the band (flag bit 1), some touch its edge (bit 0)."""
    tb, offs, start, ms, L = banded.random_band(
        np.random.default_rng(30 + W + mode), W, mode == LOCAL)
    pk = types.SimpleNamespace(offs=offs, m=ms, W=W)
    flags = _walks_agree(tb, pk, start, mode, L)[3]
    assert (flags & 2).any() and (flags & 1).any()


def test_walk_rows_fit_the_ring():
    """K8's rows a window (``sw_banded_walk_rows``, which the twin's D = 0
    takes as the launcher does) fit its ring: the twin refuses a ring past
    shared memory as the launcher would, takes the rows picked for any
    band, refuses one more row a window where the pick is two rows, and
    past ~29,000 columns the pick is to read the band straight."""
    B, NP, L = 1, 8, 64
    off = np.zeros((B, NP + 1), np.int32)
    start = np.array([[NP, NP, 0, 1]], np.int32)
    m = np.array([NP], np.int32)
    out = [np.zeros((B, L), np.int32) for _ in range(2)] + \
        [np.zeros(B, np.int32) for _ in range(2)]
    lib = native.twin_lib()
    picks = {}
    for W in (8, 130, 512, 2048, 24576, 27008, 28800, 29952):
        tb = np.zeros((B, NP, W), np.uint8)
        D = picks[W] = lib.sw_twin_banded_walk_rows(W)
        assert D == 0 or D >= 2, (W, D)
        fits = [0, D, -1] if D else [0, -1]
        refused = [D + 1] if D == 2 else [] if D else [2]
        for d, rc in [(d, 0) for d in fits] + [(d, 1) for d in refused]:
            assert lib.sw_twin_banded_walk(
                0, tb.ctypes.data, off.ctypes.data, start.ctypes.data,
                m.ctypes.data, B, NP, W, L, d,
                *(a.ctypes.data for a in out)) == rc, (W, d)
    assert picks[8] == (48 << 10) // 12 and picks[512] == (48 << 10) // 516
    assert picks[29952] == 0 and picks[28800] == 2


@pytest.mark.parametrize("mode", MODES)
def test_host_walk_matches_jax(mode, monkeypatch):
    """``walk_banded``, native and Python, against JAX's on one pair."""
    pk, table, og, eg = _packed("ragged")
    jtb, jst = _jax_fill(_S(pk, table), pk, mode, og, eg)
    start, _ = banded.walk_starts(jst, pk, mode)
    for k in (0, 2, 5):
        args = (jtb[k], pk.offs[k], int(start[k, 0]), int(start[k, 1]),
                int(start[k, 2]), mode == LOCAL, pk.W, int(pk.m[k]))
        want = jb.walk_banded(*args)
        assert banded.walk_banded(*args) == want
        with monkeypatch.context() as mp:
            mp.setattr(traceback, "native_walk_banded", lambda *a: None)
            assert banded.walk_banded(*args) == want
    # a band past column 0 whose pointers all say "gap in seq1"
    pk = banded.pack(_pairs(12, [300], [320]), 128, TABLE.shape[0])
    assert pk.offs[0, -1] > 0
    bad = np.full((pk.codes1.shape[1], pk.W), 0x15, np.uint8)
    args = (bad, pk.offs[0], 300, 320, 0, False, pk.W, 320)
    for f in (banded.walk_banded, jb.walk_banded):
        with pytest.raises((banded.BandExceeded, jb.BandExceeded)):
            f(*args)


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("mode", MODES)
def test_align_banded_batch_matches_jax(mode):
    pairs = _pairs(11, *RAGGED)
    want = jb.align_banded_batch(pairs, TABLE, mode=mode, og=OG, eg=EG,
                                 band=128, interpret=True)
    got = banded.align_banded_batch(pairs, TABLE, mode=mode, og=OG, eg=EG,
                                    band=128, device="cpu")
    assert got == want


def test_align_banded_batch_raises_band_exceeded(monkeypatch):
    real = banded.fill_banded

    def corrupt(*a, **k):
        tb, stats = real(*a, **k)
        return torch.full_like(tb, 0x15), stats

    monkeypatch.setattr(banded, "fill_banded", corrupt)
    pairs = _pairs(12, [200], [260])
    with pytest.raises(banded.BandExceeded):
        banded.align_banded_batch(pairs, TABLE, mode=GLOBAL, og=OG, eg=EG,
                                  band=128, device="cpu")


def test_align_banded_verified_matches_jax():
    """A detour wider than the band: the narrow band's score is worse, and
    verification widens to the full DP's result, as JAX's does."""
    a = np.random.default_rng(13).integers(0, 20, size=220).astype(np.int32)
    junk = ((a[:70] + 7) % 20).astype(np.int32)
    c1, c2 = a, np.concatenate([junk, a[:150]]).astype(np.int32)
    kw = dict(mode=GLOCAL, og=OG, eg=EG, band=128)
    got = banded.align_banded_verified(c1, c2, TABLE, device="cpu", **kw)
    want = jb.align_banded_verified(c1, c2, TABLE, interpret=True, **kw)
    assert got == want and got[3] > 128
    narrow = banded.align_banded(c1, c2, TABLE, device="cpu", **kw)
    assert narrow == jb.align_banded(c1, c2, TABLE, interpret=True, **kw)
    assert narrow[2] < got[2]
    kw = dict(mode=LOCAL, og=OG, eg=EG, band=128, max_band=256)
    b = a.copy()
    b[::17] = (b[::17] + 5) % 20
    got = banded.align_banded_verified(a, b, TABLE, device="cpu", **kw)
    assert got == jb.align_banded_verified(a, b, TABLE, interpret=True, **kw)
    assert got[3] == 256


@pytest.mark.parametrize("verified", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_aligner_align_banded_matches_jax(mode, verified):
    rng = np.random.default_rng(20 + mode)
    letters = "ACDEFGHIKLMNPQRSTVWYBZX"
    s1 = "".join(letters[i] for i in rng.integers(0, 23, 180))
    l2 = list(s1[15:])
    l2[50] = "W"
    del l2[120:124]
    s2 = "".join(l2) + "KKLL"
    cases = [(s1, s2), (s2, s1), ("", s2)]
    if not verified:
        cases += [("W", "W"), ("bj*o", "BJO")]
    for a, b in cases:
        got = Aligner(mode=mode, device="cpu", perl_compat=True).align_banded(
            a, b, band=128, verified=verified)
        want = jswt.Aligner(mode=mode, perl_compat=True).align_banded(
            a, b, band=128, verified=verified)
        assert vars(got) == vars(want), (a[:10], b[:10])
