"""Tables past 64 and past 255 symbols through the port, against the JAX
package, exactly.

The JAX package aligns with any ``SubstitutionMatrix.from_lines`` table: it
widens its codes past 127 symbols and encodes letters one by one where they
are not single Latin-1 characters.  The port's kernels read a table of up
to 64 symbols from shared memory and a larger one from device memory, and
take int16 codes past 255 symbols.  Here, on a 65-symbol and a 300-symbol
table (the latter's letters partly past Latin-1, its ASCII letters at
indices 235 and up):

* ``BatchAligner(device="cpu")`` (the kernels' plain versions, the ordinary
  and the long route) against ``BatchAligner(backend="scan")``;
* the host twins of K1, K3 / K4 (the long route's fills) and K9 against
  the JAX oracle ``ops/batch.fill_scan`` and the plain versions;
* the CLI with ``-matrix FILE`` against the JAX CLI, byte for byte;
* banded alignment on the CPU against the JAX package's.

Tolerance: exact equality of stats, pointer bytes, strings, scores and
spans.
"""

import numpy as np
import pytest
import torch

import smithwaterman_tpu as jswt
from smithwaterman_tpu import cli as jcli
from smithwaterman_tpu.matrices import SubstitutionMatrix as JaxSM
from smithwaterman_tpu.ops import batch as jbatch
from smithwaterman_tpu_torch import Aligner, BatchAligner, cli
from smithwaterman_tpu_torch.config import GLOBAL, GLOCAL, LOCAL
from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
from smithwaterman_tpu_torch.ops import batch, diag_dp, fill_dp, longseq, native

MODES = [LOCAL, GLOCAL, GLOBAL]
OG, EG = -10.0, -0.5
ASCII = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
         "@$%")  # 65 single-byte letters, none a FASTA or gap character


def letters(K):
    """K single-character symbols: the 65 ASCII ones, and for K = 300 235
    letters past Latin-1 before them."""
    if K <= len(ASCII):
        return list(ASCII[:K])
    return [chr(0x100 + i) for i in range(K - len(ASCII))] + list(ASCII)


def matrix_lines(K, seed=0):
    """A from_lines body: integer scores in -4..4, the diagonal 5..9."""
    rng = np.random.default_rng(seed + K)
    sym = letters(K)
    tab = rng.integers(-4, 5, size=(K, K))
    np.fill_diagonal(tab, rng.integers(5, 10, size=K))
    rows = ["# a wide test table", "  ".join(sym)]
    rows += [s + " " + " ".join(str(v) for v in tab[i])
             for i, s in enumerate(sym)]
    return rows


def pairs_over(K, seed, count=8, lmax=120, alphabet=None):
    rng = np.random.default_rng(seed)
    sym = np.array(alphabet or letters(K))
    out = []
    for k in range(count):
        a = "".join(rng.choice(sym, int(rng.integers(1, lmax))))
        b = "".join(rng.choice(sym, int(rng.integers(1, lmax))))
        if k % 2 == 0 and len(a) > 40:
            b = b[:10] + a[5:35] + b[10:]  # a long local alignment
        out.append((a, b))
    return out


def _key(r):
    return (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
            r.end2)


@pytest.fixture(scope="module", params=[65, 300])
def tables(request):
    K = request.param
    lines = matrix_lines(K)
    return K, SubstitutionMatrix.from_lines(lines), JaxSM.from_lines(lines)


@pytest.mark.parametrize("mode", MODES)
def test_batch_aligner_matches_jax(tables, mode):
    """The ordinary route (plain K1 / K2), the long route (plain K3 / K4 /
    K5) and score_pairs, every field of every result."""
    K, sm, jsm = tables
    pairs = pairs_over(K, 10 + mode) + [("", letters(K)[0])]
    theirs = jswt.BatchAligner(scoring_matrix=jsm, mode=mode,
                               backend="scan").align_pairs(pairs)
    want = [_key(r) for r in theirs]
    ours = BatchAligner(scoring_matrix=sm, mode=mode,
                        device="cpu").align_pairs(pairs)
    assert [_key(r) for r in ours] == want
    long = BatchAligner(scoring_matrix=sm, mode=mode, device="cpu",
                        longseq_cells=1).align_pairs(pairs)
    assert [_key(r) for r in long] == want
    sc = BatchAligner(scoring_matrix=sm, mode=mode,
                      device="cpu").score_pairs(pairs)
    assert sc.tolist() == [r.score for r in theirs]


def _chunk(K, seed, B=6, NP=96, MP=80):
    rng = np.random.default_rng(seed)
    ct = batch.code_dtype(K)
    c1 = rng.integers(0, K, size=(B, NP)).astype(ct)
    c2 = rng.integers(0, K, size=(B, MP)).astype(ct)
    c2[0, 10:50] = c1[0, 30:70]
    n = np.array([NP, 1, 70, NP - 1, 33, 64], np.int32)[:B]
    m = np.array([MP, MP, 1, 41, MP - 3, 64], np.int32)[:B]
    return batch.Chunk(c1, c2, n, m)


def _jax_stats(table, ch, mode, score_only=False):
    S = table[ch.codes1[:, :, None].astype(np.int64),
              ch.codes2[:, None, :].astype(np.int64)].astype(np.float32)
    ref = jbatch.fill_scan(S, ch.n, ch.m, mode=mode, og=OG, eg=EG,
                           score_only=score_only)
    st = np.zeros((ch.shape[0], 8), np.float32)
    if mode == LOCAL:
        st[:, 0] = np.asarray(ref.best)
        if not score_only:
            st[:, 1] = np.asarray(ref.best_i)
            st[:, 2] = np.asarray(ref.best_j)
    else:
        st[:, 3:6] = np.asarray(ref.final)
    return st, np.asarray(ref.tb)


@pytest.mark.parametrize("mode", MODES)
def test_twins_match_jax(tables, mode):
    """K1's twin (pointer bytes and stats, at every R), the long route's
    twins K3 / K4 (stats, checkpoints, every band's bytes, at C = 32 and
    64, all bands in one K4 launch) and, in LOCAL, K9's twin, on the wide
    table's codes."""
    K, sm, _ = tables
    table = np.ascontiguousarray(sm.table, np.float32)
    ch = _chunk(K, 20 + mode)
    assert ch.codes1.dtype == batch.code_dtype(K)
    want, tb = _jax_stats(table, ch, mode)
    lib = native.twin_lib()
    B, NP, MP = ch.shape
    # K1 at every stripe depth (n = 33, 64, 70, 95, 96 cross its lane and
    # stripe boundaries at R = 1 and 2), one to three warps a pair
    desc, _, tb_bytes, carry_floats = fill_dp.layout([ch])
    for R, NW in zip(fill_dp.STRIPE_R, (1, 2, 3, 1)):
        tbt = np.zeros(tb_bytes, np.uint8)
        stats = np.zeros((B, 8), np.float32)
        carry = np.zeros(carry_floats, np.float32)
        assert lib.sw_twin_fill(
            mode, 1, R, NW, table.ctypes.data, K, ch.codes1.itemsize,
            ch.codes1.ctypes.data, ch.codes2.ctypes.data, desc.ctypes.data,
            B, tbt.ctypes.data, None, carry.ctypes.data, stats.ctypes.data,
            OG, EG) == 0
        np.testing.assert_array_equal(stats, want)
        got = fill_dp.pool_view(torch.from_numpy(tbt), 0, ch.shape).numpy()
        for b in range(B):
            nb, mb = int(ch.n[b]), int(ch.m[b])
            np.testing.assert_array_equal(
                got[:nb, :mb, b], tb[b, 1:nb + 1, 1:mb + 1],
                err_msg=f"R={R} NW={NW} pair {b}")
    # K3 and K4
    for C in (32, 64):
        nck = longseq.n_ckpts(NP, C)
        ck = [np.zeros((B, nck, MP), np.float32) for _ in range(3)]
        st3 = np.ones((B, 8), np.float32)
        scratch = np.zeros(1 + B + 4 * B * nck, np.int32)
        assert lib.sw_twin_ckpt_fill(
            mode, table.ctypes.data, K, ch.codes1.itemsize,
            ch.codes1.ctypes.data, ch.codes2.ctypes.data, ch.n.ctypes.data,
            ch.m.ctypes.data, B, NP, MP, C, *(a.ctypes.data for a in ck),
            st3.ctypes.data, scratch.ctypes.data, OG, EG) == 0
        np.testing.assert_array_equal(st3, want)
        bands = np.zeros((nck, B, longseq.band_bytes(C, MP)), np.uint8)
        assert lib.sw_twin_band_fill(
            mode, table.ctypes.data, K, ch.codes1.itemsize,
            ch.codes1.ctypes.data, ch.codes2.ctypes.data, ch.n.ctypes.data,
            ch.m.ctypes.data, B, NP, MP, C, 0, nck,
            *(a.ctypes.data for a in ck), bands.ctypes.data, OG, EG) == 0
        for sk in range(nck):
            got = longseq.band_view(torch.from_numpy(bands[sk]), C,
                                    MP).numpy()
            for b in range(B):
                rows = min(max(int(ch.n[b]) - sk * C, 0), C)
                mb = int(ch.m[b])
                np.testing.assert_array_equal(
                    got[b, :rows, :mb],
                    tb[b, sk * C + 1:sk * C + rows + 1, 1:mb + 1],
                    err_msg=f"C={C} band {sk} pair {b}")
    if mode != LOCAL:
        return
    # K9 (score-only LOCAL: the best alone)
    desc9, floats = diag_dp.layout([ch])
    plain = diag_dp.fill_diag(torch.from_numpy(table), [ch], og=OG, eg=EG)
    for R in diag_dp.LANE_COLS:
        st9 = np.ones((B, 8), np.float32)
        scr = np.zeros(max(floats, 1), np.float32)
        assert lib.sw_twin_diag_fill(
            R, table.ctypes.data, K, ch.codes1.itemsize,
            ch.codes1.ctypes.data, ch.codes2.ctypes.data, desc9.ctypes.data,
            B, scr.ctypes.data, st9.ctypes.data, OG, EG) == 0
        np.testing.assert_array_equal(st9[:, 0], want[:, 0])
        np.testing.assert_array_equal(plain.numpy(), st9)


@pytest.mark.parametrize("flag", ["-local", "-glocal", "-global"])
def test_cli_matrix_file_matches_jax(tables, tmp_path, capsys, flag):
    """``-matrix FILE`` with the wide table: FASTA residues are read as
    Latin-1, so the sequences use the table's ASCII letters (indices 235
    and up in the 300-symbol table, past uint8's range for most)."""
    K, _, _ = tables
    path = tmp_path / "wide.mat"
    path.write_text("\n".join(matrix_lines(K)) + "\n")
    ps = pairs_over(K, 30, count=3, lmax=60, alphabet=list(ASCII))
    f1, f2 = tmp_path / "a.fas", tmp_path / "b.fas"
    f1.write_text("".join(f">q{k}\n{a}\n" for k, (a, _) in enumerate(ps)))
    f2.write_text("".join(f">t{k}\n{b}\n" for k, (_, b) in enumerate(ps)))
    argv = [flag, "-matrix", str(path), str(f1), str(f2)]
    cli.main(argv, device="cpu")
    ours = capsys.readouterr().out
    jcli.main(argv)
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert ours.count("#score:") == 9


def test_banded_matches_jax(tables):
    """Banded alignment (plain K6 / K7 / K8 on the CPU) on the wide
    table's codes, against the JAX package's banded alignment."""
    K, sm, jsm = tables
    rng = np.random.default_rng(40 + K)
    sym = np.array(letters(K))
    a = "".join(rng.choice(sym, 300))
    b = a[:120] + "".join(rng.choice(sym, 5)) + a[130:]
    for mode in MODES:
        ours = Aligner(scoring_matrix=sm, mode=mode,
                       device="cpu").align_banded(a, b, band=128)
        theirs = jswt.Aligner(scoring_matrix=jsm, mode=mode).align_banded(
            a, b, band=128)
        assert _key(ours) == _key(theirs), mode
