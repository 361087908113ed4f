"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA card (marker ``gpu``) and skip without one;
whether a card is present is decided inside the fixture, never at import.
On the card: ``python -m pytest tests/test_torch_gpu.py -q``.  Tolerance:
exact equality of pointer bytes, stats, move counts, moves and strings.
"""

import numpy as np
import pytest
import torch

from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
from smithwaterman_tpu_torch.ops import (batch, device_walk, diag_dp,
                                         fill_dp, longseq)
from smithwaterman_tpu_torch.utils import metrics

pytestmark = pytest.mark.gpu
MODES = [LOCAL, GLOCAL, GLOBAL]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches(*kernels):
    """The registry's launch counts of ``kernels`` (``launch.K1`` ...)."""
    return tuple(metrics.counter("launch." + k) for k in kernels)


def _chunks(seed):
    """Ragged chunks at every R K1 takes (fill_dp.stripe_rows: 4, 2, 8, 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for B, NP, MP in ((37, 128, 256), (5, 64, 64), (6, 300, 100),
                      (9, 40, 48)):
        c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
        c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
        n = rng.integers(1, NP + 1, size=B).astype(np.int32)
        m = rng.integers(1, MP + 1, size=B).astype(np.int32)
        n[0], m[0] = 1, MP
        k = min(40, NP - 10)
        c2[1, :k] = c1[1, 10:10 + k]
        out.append(batch.Chunk(c1, c2, n, m))
    return out


def _batch(seed, which):
    """The ragged chunks, one pair of 1000 x 900, or 16 pairs of 300 to
    1100 residues a side: few pairs, few warps."""
    if which == "ragged":
        return _chunks(seed)
    rng = np.random.default_rng(seed)
    B, NP, MP = (1, 1024, 1024) if which == "one" else (16, 1152, 1152)
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    if B == 1:
        n, m = np.array([1000], np.int32), np.array([900], np.int32)
    else:
        n = rng.integers(300, 1101, size=B).astype(np.int32)
        m = rng.integers(300, 1101, size=B).astype(np.int32)
    for b in range(B):
        c2[b, 100:400] = c1[b, 200:500]
    return [batch.Chunk(c1, c2, n, m)]


@pytest.mark.parametrize("which", ["ragged", "one", "sixteen"])
@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fill_kernel_matches_plain(cuda, mode, score_only, which):
    chunks = _batch(mode, which)
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    for og, eg in ((-10.0, -0.5), (0.0, 0.0)):
        got = fill_dp.fill_many(tab, chunks, mode=mode, og=og, eg=eg,
                                score_only=score_only)
        ref = fill_dp.fill_many_ref(tab, chunks, mode=mode, og=og, eg=eg,
                                    score_only=score_only)
        torch.cuda.synchronize()
        assert torch.equal(got.stats, ref.stats)
        if score_only:
            continue
        for c, ch in enumerate(chunks):
            for b in range(ch.shape[0]):
                n, m = int(ch.n[b]), int(ch.m[b])
                assert torch.equal(got.tb_view(c)[:n, :m, b],
                                   ref.tb_view(c)[:n, :m, b])


@pytest.mark.parametrize("mode", MODES)
def test_fill_kernel_takes_any_depth_and_warps(cuda, mode):
    """K1 and K10 with every pair at each R and with 1, 2, 3, 8 and 32
    warps a pair (a warp's stripes back to back, or overlapping, cycling
    when the stripes outnumber the warps), on pairs of 1 to 23 stripes,
    against the plain fill."""
    rng = np.random.default_rng(40 + mode)
    B, NP, MP = 6, 736, 320
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    n = np.array([736, 1, 257, 600, 33, 511], np.int32)
    m = np.array([320, 17, 300, 1, 250, 319], np.int32)
    c2[:, 50:250] = c1[:, 300:500]
    chunks = [batch.Chunk(c1, c2, n, m)]
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    args = dict(mode=mode, og=-10.0, eg=-0.5)
    ref = fill_dp.fill_many_ref(tab, chunks, runs=True, **args)
    codes1 = torch.from_numpy(c1.ravel()).to(cuda)
    codes2 = torch.from_numpy(c2.ravel()).to(cuda)
    order = torch.arange(B, dtype=torch.int32, device=cuda)
    carry = torch.empty(fill_dp.layout(chunks)[3], dtype=torch.float32,
                        device=cuda)
    for R in fill_dp.STRIPE_R:
        for NW in (1, 2, 3, 8, 32):
            for runs in (False, True):
                got = fill_dp.fill_many(tab, chunks, runs=runs, **args)
                for out in (got.stats, got.tb, got.run):
                    if out is not None:
                        out.zero_()
                fill_dp.launch([(R, NW, order)], tab, codes1, codes2,
                               got.desc, got.tb, carry, got.stats,
                               traceback=True, run=got.run, **args)
                assert torch.equal(got.stats, ref.stats), (R, NW, runs)
                for b in range(B):
                    nb, mb = int(n[b]), int(m[b])
                    assert torch.equal(got.tb_view(0)[:nb, :mb, b],
                                       ref.tb_view(0)[:nb, :mb, b])
                    if runs:
                        assert torch.equal(
                            got.tb_view(0, got.run)[:nb, :mb, b],
                            ref.tb_view(0, ref.run)[:nb, :mb, b])


# (T, C) forced on K2 and K11 beside the launcher's own: small tiles that
# walks leave many times (odd sizes: rows off 16-byte pieces), a tile a
# cell, and wide short tiles
FORCED_WALKS = [(4, 8), (3, 5), (1, 1), (8, 200)]


def _walk_shapes(monkeypatch, pools):
    """The launcher's tiles for ``pools`` pools, then each of
    FORCED_WALKS set in device_walk.TILES; yields the tiles."""
    own = device_walk.TILES[pools]
    yield own
    for shape in FORCED_WALKS:
        monkeypatch.setitem(device_walk.TILES, pools, shape)
        yield shape
    monkeypatch.setitem(device_walk.TILES, pools, own)


@pytest.mark.parametrize("mode", MODES)
def test_walk_kernel_matches_plain(cuda, mode, monkeypatch):
    """K2 at the launcher's tiles and at every forced one, in the fill's
    order and in descriptor order, against the plain walk."""
    chunks = _chunks(10 + mode)
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    got = fill_dp.fill_many(tab, chunks, mode=mode, og=-10.0, eg=-0.5)
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in got.shapes)
    rcnt, rmv = device_walk.walk_packed_ref(got.tb, got.desc, got.stats,
                                            mode=mode, L=L)
    desc_order = torch.arange(len(rcnt), dtype=torch.int32, device=cuda)
    for shape in _walk_shapes(monkeypatch, 1):
        for order in (got.order, desc_order):
            cnt, mv = device_walk.walk_packed(got.tb, got.desc, got.stats,
                                              mode=mode, L=L, order=order)
            assert torch.equal(cnt, rcnt) and torch.equal(mv, rmv), shape


@pytest.mark.parametrize("mode", MODES)
def test_batch_cuda_matches_cpu(cuda, mode):
    rng = np.random.default_rng(mode)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    pairs = [("".join(rng.choice(letters, int(rng.integers(1, 300)))),
              "".join(rng.choice(letters, int(rng.integers(1, 300)))))
             for _ in range(40)] + [("", "ACD")]
    before = _launches("K1", "K2")
    got = BatchAligner(mode=mode, device="cuda").align_pairs(pairs)
    after = _launches("K1", "K2")
    assert after[0] > before[0] and after[1] > before[1]
    want = BatchAligner(mode=mode, device="cpu").align_pairs(pairs)
    assert [(r.aligned1, r.aligned2, r.score, r.start1, r.end2)
            for r in got] == [(r.aligned1, r.aligned2, r.score, r.start1,
                               r.end2) for r in want]


def test_fill_launches_lie_in_the_programs_fill_span(cuda):
    """In a profiled call, the host side of every K1 launch (the runtime
    call whose correlation id the kernel carries) lies inside the
    program's ``fill`` span of its flush, on the profiler's own clock,
    and the registry counts each launch once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(7)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    pairs = [("".join(rng.choice(letters, int(rng.integers(20, 900)))),
              "".join(rng.choice(letters, int(rng.integers(20, 900)))))
             for _ in range(48)]
    eng = BatchAligner(mode=GLOCAL, device="cuda")
    eng.align_pairs(pairs)  # builds the kernels outside the profile
    metrics.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.align_pairs(pairs)
        torch.cuda.synchronize()
    (call,) = metrics.calls()
    fills = [(s.start, s.end) for s in call.spans if s.name == "fill"]
    events = list(prof.profiler.kineto_results.events())
    k1 = {e.correlation_id() for e in events
          if e.device_type() == DeviceType.CUDA
          and "fill_kernel" in e.name()}
    hosts = [e for e in events if e.device_type() == DeviceType.CPU
             and e.name() in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC")
             and e.correlation_id() in k1]
    assert len(k1) == len(hosts) == call.counts["launch.K1"] > 0
    assert len(fills) == call.attrs["flushes"]
    for e in hosts:
        assert any(lo <= e.start_ns() and
                   e.start_ns() + e.duration_ns() <= hi
                   for lo, hi in fills), e.start_ns()


GUARD = 4096   # canary bytes on each side of a fenced output
CANARY = 0xA5


def _fenced(nbytes, dtype, dev, inner=CANARY):
    """``nbytes`` of ``dtype`` inside an arena with GUARD canary bytes on
    each side; returns (arena, view)."""
    arena = torch.full((nbytes + 2 * GUARD,), CANARY, dtype=torch.uint8,
                       device=dev)
    arena[GUARD:GUARD + nbytes] = inner
    return arena, arena[GUARD:GUARD + nbytes].view(dtype)


@pytest.mark.parametrize("score_only", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_kernels_write_only_their_outputs(cuda, mode, score_only):
    """K1 and K2 (traceback), K10 and K11 (traceback) and K9 (score-only
    LOCAL) launched on outputs fenced by canary bytes, K1 and K10 at every
    R (one launch each), K2 and K11 at small tiles (their scratch is
    shared memory only): every canary stays intact and the
    outputs equal the wrappers' (the walks' plain versions') on the same
    inputs."""
    from smithwaterman_tpu_torch.ops import kernels

    chunks = _chunks(20 + mode)
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    args = dict(mode=mode, og=-10.0, eg=-0.5)
    want = fill_dp.fill_many(tab, chunks, score_only=score_only, **args)
    _, _, tb_bytes, carry_floats = fill_dp.layout(chunks)
    B = want.desc.shape[0]
    codes1, codes2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(cuda)
        for f in ("codes1", "codes2"))
    arenas = {}
    tb = None
    if not score_only:
        arenas["tb"], tb = _fenced(tb_bytes, torch.uint8, cuda)
    arenas["carry"], carry = _fenced(4 * carry_floats, torch.float32, cuda)
    arenas["stats"], stats = _fenced(4 * 8 * B, torch.float32, cuda)
    stats = stats.view(B, 8)
    fill_dp.launch(fill_dp.device_plan(chunks, 0 if score_only else 1, cuda),
                   tab, codes1, codes2, want.desc, tb, carry, stats,
                   traceback=not score_only, **args)
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in want.shapes)
    walks = {}
    if not score_only:
        L4 = -(-L // 4)
        # K2 and K11 at small tiles, into fenced outputs
        for T, C in FORCED_WALKS:
            arenas[f"cnt {T, C}"], cnt = _fenced(4 * B, torch.int32, cuda)
            arenas[f"moves {T, C}"], moves = _fenced(L4 * B, torch.uint8,
                                                     cuda, inner=0)
            moves = moves.view(L4, B)
            kernels.walk(tb, want.desc, stats, cnt, moves,
                         local=mode == LOCAL, L=L, order=want.order, T=T,
                         C=C)
            walks[T, C] = (cnt, moves)
        # K10 into fenced pointer and run pools, K11 into fenced outputs
        arenas["tb10"], tb10 = _fenced(tb_bytes, torch.uint8, cuda)
        arenas["run"], run = _fenced(tb_bytes, torch.uint8, cuda)
        arenas["carry10"], carry10 = _fenced(4 * carry_floats, torch.float32,
                                             cuda)
        arenas["stats10"], stats10 = _fenced(4 * 8 * B, torch.float32, cuda)
        stats10 = stats10.view(B, 8)
        fill_dp.launch(fill_dp.device_plan(chunks, 2, cuda), tab, codes1,
                       codes2, want.desc, tb10, carry10, stats10,
                       traceback=True, run=run, **args)
        for T, C in FORCED_WALKS:
            arenas[f"tcnt {T, C}"], tcnt = _fenced(4 * B, torch.int32, cuda)
            arenas[f"toks {T, C}"], toks = _fenced(L * B, torch.uint8, cuda,
                                                   inner=0)
            toks = toks.view(L, B)
            kernels.walk_tokens(tb10, run, want.desc, stats10, tcnt, toks,
                                local=mode == LOCAL, L=L, order=want.order,
                                T=T, C=C)
            walks["tokens", T, C] = (tcnt, toks)
    elif mode == LOCAL:
        # K9 into a fenced scratch and stats, at every R
        desc9, floats = diag_dp.layout(chunks)
        desc9 = torch.from_numpy(desc9).to(cuda)
        stats9 = {}
        for R in diag_dp.LANE_COLS:
            arenas[f"scratch9 R={R}"], scratch9 = _fenced(
                4 * floats, torch.float32, cuda)
            arenas[f"stats9 R={R}"], st9 = _fenced(4 * 8 * B, torch.float32,
                                                   cuda)
            stats9[R] = st9.view(B, 8)
            kernels.diag_fill(tab, codes1, codes2, desc9, scratch9,
                              stats9[R], og=-10.0, eg=-0.5, R=R)
    torch.cuda.synchronize()
    for name, arena in arenas.items():
        assert bool((arena[:GUARD] == CANARY).all()), name
        assert bool((arena[-GUARD:] == CANARY).all()), name
    assert torch.equal(stats, want.stats)
    if score_only:
        if mode == LOCAL:
            want9 = diag_dp.fill_diag(tab, chunks, og=-10.0, eg=-0.5)
            for R, st9 in stats9.items():
                assert torch.equal(st9, want9), R
        return
    got = fill_dp.Filled(tb, stats, want.desc, want.shapes, want.tb_base)
    wruns = fill_dp.fill_many(tab, chunks, runs=True, **args)
    got10 = fill_dp.Filled(tb10, stats10, want.desc, want.shapes,
                           want.tb_base, run)
    assert torch.equal(stats10, want.stats)
    for c, ch in enumerate(chunks):
        for b in range(ch.shape[0]):
            n, m = int(ch.n[b]), int(ch.m[b])
            for f in (got, got10):
                assert torch.equal(f.tb_view(c)[:n, :m, b],
                                   want.tb_view(c)[:n, :m, b])
            assert torch.equal(got10.tb_view(c, run)[:n, :m, b],
                               wruns.tb_view(c, wruns.run)[:n, :m, b])
    wcnt, wmv = device_walk.walk_packed_ref(want.tb, want.desc, want.stats,
                                            mode=mode, L=L)
    wtcnt, wtoks = device_walk.walk_tokens_ref(wruns.tb, wruns.run,
                                               wruns.desc, wruns.stats,
                                               mode=mode, L=L)
    for key, (c, out) in walks.items():
        w = (wtcnt, wtoks) if key[0] == "tokens" else (wcnt, wmv)
        assert torch.equal(c, w[0]) and torch.equal(out, w[1]), key


def _run_chunks(seed):
    """_chunks with identical runs longer than 16 in half the pairs."""
    out = _chunks(seed)
    for ch in out:
        for b in range(0, ch.shape[0], 2):
            k = min(ch.shape[1], ch.shape[2]) - 3
            ch.codes2[b, 3:3 + k] = ch.codes1[b, :k]
    return out


@pytest.mark.parametrize("which", ["ragged", "one", "sixteen"])
@pytest.mark.parametrize("mode", MODES)
def test_run_fill_and_token_walk_match_plain(cuda, mode, which,
                                            monkeypatch):
    """K10 (pointer bytes, run bytes, stats) against its plain version and
    K1, at every R, and K11 on K10's own pools against its plain version,
    at the launcher's tiles and every forced one."""
    chunks = (_run_chunks(30 + mode) if which == "ragged"
              else _batch(30 + mode, which))
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    for og, eg in ((-10.0, -0.5), (0.0, 0.0)):
        args = dict(mode=mode, og=og, eg=eg)
        before = metrics.counter("launch.K10")
        got = fill_dp.fill_many(tab, chunks, runs=True, **args)
        assert metrics.counter("launch.K10") == before + len(
            fill_dp.launch_plan(chunks, pools=2))
        ref = fill_dp.fill_many_ref(tab, chunks, runs=True, **args)
        k1 = fill_dp.fill_many(tab, chunks, **args)
        assert torch.equal(got.stats, ref.stats)
        assert torch.equal(got.stats, k1.stats)
        for c, ch in enumerate(chunks):
            for b in range(ch.shape[0]):
                n, m = int(ch.n[b]), int(ch.m[b])
                assert torch.equal(got.tb_view(c)[:n, :m, b],
                                   k1.tb_view(c)[:n, :m, b])
                assert torch.equal(got.tb_view(c, got.run)[:n, :m, b],
                                   ref.tb_view(c, ref.run)[:n, :m, b])
        L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in got.shapes)
        rcnt, rtoks = device_walk.walk_tokens_ref(got.tb, got.run, got.desc,
                                                  got.stats, mode=mode, L=L)
        for shape in _walk_shapes(monkeypatch, 2):
            cnt, toks = device_walk.walk_tokens(got.tb, got.run, got.desc,
                                                got.stats, mode=mode, L=L,
                                                order=got.order)
            assert torch.equal(cnt, rcnt) and torch.equal(toks, rtoks), shape
        assert int(((toks >> 2) > 0).sum()) > 0  # runs were jumped


def _strip_chunk(dtype):
    """Widths around every strip of 32 R columns (1, 32 R - 1, 32 R, 32 R +
    1), heights from 1; pair 0 all A against W one column past a strip, so
    its last strip's dead columns (code 0) would win the best."""
    widths = [1, 33, 31, 32, 63, 64, 65, 127, 128, 129, 255, 256, 257]
    heights = [70, 1, 2, 31, 33, 64, 70, 5, 40, 69, 1, 17, 70]
    rng = np.random.default_rng(41)
    c1 = rng.integers(0, 20, size=(len(widths), max(heights))).astype(dtype)
    c2 = rng.integers(0, 20, size=(len(widths), max(widths))).astype(dtype)
    c1[0], c2[0] = 0, 17
    return batch.Chunk(c1, c2, np.asarray(heights, np.int32),
                       np.asarray(widths, np.int32))


@pytest.mark.parametrize("R", [None, 2, 4, 8])
@pytest.mark.parametrize("og,eg", [(-10.0, -0.5), (0.0, 0.0), (-5.0, -2.0)])
def test_diag_kernel_matches_plain(cuda, og, eg, R, monkeypatch):
    """K9 against its plain version and K1's score-only best, at the
    launcher's R (None) and at every R, on ragged chunks and on widths
    around every strip (uint8 and int16 codes)."""
    chunks = _chunks(40)
    ch = chunks[0]
    ch.n[1], ch.m[2] = 1, 1
    ch.m[3] = 32
    # a stretch from row 0 across the first strip boundary (column 31)
    ch.codes1[4, :60] = 18
    ch.codes2[4, 31:91] = 18
    ch.n[4], ch.m[4] = 128, 256
    if R is not None:
        monkeypatch.setattr(diag_dp, "lane_cols", lambda MP: R)
    blosum = SubstitutionMatrix.blosum62().table
    # int16 codes come with tables past 255 symbols: BLOSUM62 in the corner
    # of a 300-symbol one
    wide = np.zeros((300, 300), np.float32)
    wide[:blosum.shape[0], :blosum.shape[1]] = blosum
    for table, chs in ((blosum, chunks + [_strip_chunk(np.uint8)]),
                       (wide, [_strip_chunk(np.int16)])):
        tab = torch.from_numpy(table).to(cuda)
        before = metrics.counter("launch.K9")
        got = diag_dp.fill_diag(tab, chs, og=og, eg=eg)
        assert metrics.counter("launch.K9") == before + 1
        if R is not None:
            assert diag_dp.SHAPE["R"] == R
        ref = torch.cat([diag_dp.fill_diag_ref(
            tab, *(torch.from_numpy(a).to(cuda) for a in c), og=og, eg=eg)
            for c in chs])
        k1 = fill_dp.fill_many(tab, chs, mode=LOCAL, og=og, eg=eg,
                               score_only=True)
        assert torch.equal(got, ref)
        assert torch.equal(got, k1.stats)


@pytest.mark.parametrize("mode", MODES)
def test_opt_in_routes_cuda_match_cpu(cuda, mode, monkeypatch):
    """The token walk (K10, K11) and, in LOCAL, the wavefront route (K9)
    through BatchAligner on the card equal the CPU path."""
    rng = np.random.default_rng(60 + mode)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    pairs = []
    for _ in range(40):
        a = "".join(rng.choice(letters, int(rng.integers(1, 300))))
        b = "".join(rng.choice(letters, int(rng.integers(1, 300))))
        pairs.append((a, b[:20] + a[10:200] + b[20:] if len(a) > 50 else b))
    pairs.append(("", "ACD"))
    want = BatchAligner(mode=mode, device="cpu").align_pairs(pairs)
    monkeypatch.setenv("SWTPU_TOKEN_WALK", "1")
    before = _launches("K10", "K11", "K1", "K2")
    got = BatchAligner(mode=mode, device="cuda").align_pairs(pairs)
    after = _launches("K10", "K11", "K1", "K2")
    assert after[0] > before[0]
    assert after[1] > before[1]
    assert after[2:] == before[2:]
    assert [vars(r) for r in got] == [vars(r) for r in want]
    if mode != LOCAL:
        return
    before = metrics.counter("launch.K9")
    scores = BatchAligner(device="cuda", diag_scores=True).score_pairs(pairs)
    assert metrics.counter("launch.K9") > before
    np.testing.assert_array_equal(
        scores, BatchAligner(device="cpu").score_pairs(pairs))


def test_fill_rejects_codes_past_the_table(cuda):
    chunks = _chunks(4)
    chunks[0].codes2[2, 0] = 24
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    with pytest.raises(ValueError, match="below the table"):
        fill_dp.fill_many(tab, chunks, mode=LOCAL, og=-10.0, eg=-0.5)


def test_fill_kernel_rejects_wide_table(cuda):
    """A 65-symbol table, once refused, is read from device memory: K1
    equals its plain version on it."""
    chunks = _chunks(3)
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(
        rng.integers(-4, 6, size=(65, 65)).astype(np.float32)).to(cuda)
    for ch in chunks:
        ch.codes1[:, ::3] = 64
    got = fill_dp.fill_many(wide, chunks, mode=LOCAL, og=-10.0, eg=-0.5)
    ref = fill_dp.fill_many_ref(wide, chunks, mode=LOCAL, og=-10.0, eg=-0.5)
    torch.cuda.synchronize()
    assert torch.equal(got.stats, ref.stats)
    _assert_tb_equal(got, ref, chunks)


def _assert_tb_equal(got, ref, chunks, runs=False):
    """Two fills' pointer bytes (run bytes with ``runs``) inside every
    pair's [:n, :m]."""
    for c, ch in enumerate(chunks):
        a = got.tb_view(c, got.run if runs else None)
        r = ref.tb_view(c, ref.run if runs else None)
        for b in range(ch.shape[0]):
            n, m = int(ch.n[b]), int(ch.m[b])
            assert torch.equal(a[:n, :m, b], r[:n, :m, b]), (c, b)


def _wide(K, seed):
    """A K-symbol integer table and ragged pairs whose codes span it, in
    the port's code dtype (int16 past 255 symbols)."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(-4, 5, size=(K, K)).astype(np.float32)
    np.fill_diagonal(tab, 7.0)
    ct = batch.code_dtype(K)
    chunks = []
    for B, NP, MP in ((9, 300, 280), (3, 64, 96)):
        c1 = rng.integers(0, K, size=(B, NP)).astype(ct)
        c2 = rng.integers(0, K, size=(B, MP)).astype(ct)
        n = rng.integers(1, NP + 1, size=B).astype(np.int32)
        m = rng.integers(1, MP + 1, size=B).astype(np.int32)
        n[0], m[0] = NP, MP
        c2[0, 20:60] = c1[0, 10:50]
        c1[1, :3] = K - 1
        chunks.append(batch.Chunk(c1, c2, n, m))
    return tab, chunks


def _k6_shapes(W, B, K, dev, seed):
    """B ragged pairs for K6 alone, codes below K: every other seq2 up to
    3000 times its seq1 plus W (the offset rises up to ~3000 columns a
    row: the window cuts a tile into sub-tiles), the rest m <= W (offsets
    all 0); of eight, seq1 of one residue first."""
    rng = np.random.default_rng(seed)
    n = rng.integers(1, 300, size=B)
    if B > 1:
        n[0] = 1
    m = np.where(np.arange(B) % 2 == 0,
                 n * rng.integers(5, 3000, size=B) + W,
                 rng.integers(1, W + 1, size=B))
    NP, MP = int(n.max()) + 5, int(m.max()) + 3
    ct = batch.code_dtype(K)
    c1 = rng.integers(0, K, size=(B, NP)).astype(ct)
    c2 = rng.integers(0, K, size=(B, MP)).astype(ct)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (c1, c2, n.astype(np.int32), m.astype(np.int32)))


def _check_k6(tab, c1, c2, n, m, W, monkeypatch):
    """K6 equal to its plain version at the launcher's plan, at forced ones
    (tiles of 1, 7 and 64 rows on 1 to 3 blocks), with 4-byte stores (S
    one float off 16-byte alignment) and at W + 2 (W % 4 != 0)."""
    from smithwaterman_tpu_torch.ops import banded, kernels

    ref = banded.banded_scores_ref(tab, c1, c2, n, m, W=W)
    assert torch.equal(banded.banded_scores(tab, c1, c2, n, m, W=W), ref)
    assert banded.SHAPES["K6"]["vec"] == (W % 4 == 0)
    for T, blocks in ((1, 3), (7, 1), (64, 2)):
        with monkeypatch.context() as mp:
            mp.setattr(kernels, "scores_plan",
                       lambda *a, T=T, blocks=blocks: (T, blocks))
            S = banded.banded_scores(tab, c1, c2, n, m, W=W)
        assert torch.equal(S, ref), (T, blocks)
    B, NP = c1.shape
    flat = torch.empty(B * NP * W + 1, dtype=torch.float32, device=tab.device)
    S = flat[1:].view(B, NP, W)
    assert not kernels.banded_scores(tab, c1, c2, n, m, S, W=W)["vec"]
    assert torch.equal(S, ref)
    assert torch.equal(banded.banded_scores(tab, c1, c2, n, m, W=W + 2),
                       banded.banded_scores_ref(tab, c1, c2, n, m, W=W + 2))


@pytest.mark.parametrize("K", [65, 300])
def test_kernels_take_wide_tables(cuda, K, monkeypatch):
    """K1 (traceback and score-only) and K10, K3, K4 (every band in one
    launch), K6 and K9 with a K-symbol table read from device memory, int16
    codes past 255 symbols: each equal to its plain version; K6 also at
    skewed and m <= W pairs, one and eight of them, W 128 and 2048."""
    from smithwaterman_tpu_torch.ops import banded

    table, chunks = _wide(K, K)
    tab = torch.from_numpy(table).to(cuda)
    for mode in MODES:
        for score_only in (False, True):
            got = fill_dp.fill_many(tab, chunks, mode=mode, og=-10.0, eg=-0.5,
                                    score_only=score_only)
            ref = fill_dp.fill_many_ref(tab, chunks, mode=mode, og=-10.0,
                                        eg=-0.5, score_only=score_only)
            assert torch.equal(got.stats, ref.stats), (mode, score_only)
            if not score_only:
                _assert_tb_equal(got, ref, chunks)
        got = fill_dp.fill_many(tab, chunks, mode=mode, og=-10.0, eg=-0.5,
                                runs=True)
        ref = fill_dp.fill_many_ref(tab, chunks, mode=mode, og=-10.0,
                                    eg=-0.5, runs=True)
        assert torch.equal(got.stats, ref.stats), mode
        _assert_tb_equal(got, ref, chunks)
        _assert_tb_equal(got, ref, chunks, runs=True)
    ch = chunks[0]
    c1, c2, n, m = _on(ch, cuda)
    B, NP, MP = ch.shape
    for mode in MODES:
        args = dict(mode=mode, og=-10.0, eg=-0.5, C=64)
        st, ck = longseq.fill_checkpointed(tab, c1, c2, n, m, **args)
        rst, rck = longseq.fill_checkpointed_ref(tab, c1, c2, n, m, **args)
        assert torch.equal(st, rst), mode
        for b in range(B):
            k, mb = int(ch.n[b]) // 64, int(ch.m[b])
            for a, r in zip(ck, rck):
                assert torch.equal(a[b, :k, :mb], r[b, :k, :mb]), (mode, b)
        nck = longseq.n_ckpts(NP, 64)
        bands = torch.zeros((nck, B, longseq.band_bytes(64, MP)),
                            dtype=torch.uint8, device=cuda)
        rbands = bands.clone()
        longseq.fill_bands(tab, c1, c2, n, m, ck, bands, sk0=0, **args)
        longseq.fill_bands_ref(tab, c1, c2, n, m, ck, rbands, sk0=0, **args)
        _assert_bands_equal(bands, rbands, ch, 64, 0)
    got = diag_dp.fill_diag(tab, chunks, og=-10.0, eg=-0.5)
    ref = torch.cat([diag_dp.fill_diag_ref(
        tab, *(torch.from_numpy(a).to(cuda) for a in c), og=-10.0, eg=-0.5)
        for c in chunks])
    assert torch.equal(got, ref)
    pairs = [(ch.codes1[b, :ch.n[b]], ch.codes2[b, :ch.m[b]])
             for b in range(8)]
    pk = banded.pack(pairs, 128, K)
    assert pk.codes1.dtype == batch.code_dtype(K)
    t1, t2, tn, tm = (torch.from_numpy(a).to(cuda)
                      for a in (pk.codes1, pk.codes2, pk.n, pk.m))
    S = banded.banded_scores(tab, t1, t2, tn, tm, W=pk.W)
    assert torch.equal(S, banded.banded_scores_ref(tab, t1, t2, tn, tm,
                                                   W=pk.W))
    for W in (128, 2048):
        for B in (1, 8):
            _check_k6(tab, *_k6_shapes(W, B, K, cuda, K + W + B), W,
                      monkeypatch)


@pytest.mark.parametrize("mode", MODES)
def test_aligner_cuda_matches_cpu(cuda, mode):
    """Whole pairs go through the kernels, partial regions through the
    oracle on the card; both must equal the CPU path."""
    from smithwaterman_tpu_torch import Aligner

    s1, s2 = "HEAGAWGHEEKLMNPQRSTVW", "PAWHEAEKLMQQRSW"
    gpu = Aligner(mode=mode, device="cuda")
    cpu = Aligner(mode=mode, device="cpu")
    for args in ((s1, s2, True, None), (s1, s2, True, (9, 7))):
        g, c = gpu.align_partial(*args), cpu.align_partial(*args)
        assert (g.aligned1, g.aligned2, g.score) == (c.aligned1, c.aligned2,
                                                     c.score)
    assert gpu.score(s1, s2) == cpu.score(s1, s2)


def _long_chunk(seed, B=8, NP=300, MP=280):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    n = rng.integers(1, NP + 1, size=B).astype(np.int32)
    m = rng.integers(1, MP + 1, size=B).astype(np.int32)
    n[:3], m[:3] = (1, NP, NP), (MP, 1, MP)
    c2[2, 10:200] = c1[2, 40:230]
    c1[3, 64:128] = c1[3, 0:64]  # a repeated motif: tied maxima
    c2[3, 0:64] = c1[3, 0:64]
    return batch.Chunk(c1, c2, n, m)


def _on(ch, dev):
    return tuple(torch.from_numpy(a).to(dev) for a in ch)


def _assert_bands_equal(bands, rbands, ch, C, sk0):
    """Every band of a (G, B, band_bytes) group in each pair's [:n, :m]."""
    MP = ch.shape[2]
    for g in range(bands.shape[0]):
        got, ref = (longseq.band_view(x[g], C, MP) for x in (bands, rbands))
        for b in range(ch.shape[0]):
            rows = min(max(int(ch.n[b]) - (sk0 + g) * C, 0), C)
            assert torch.equal(got[b, :rows, :int(ch.m[b])],
                               ref[b, :rows, :int(ch.m[b])]), (sk0 + g, b)


@pytest.mark.parametrize("C", [32, 64, 128, 256])
@pytest.mark.parametrize("mode", MODES)
def test_longseq_kernels_match_plain(cuda, mode, C):
    """K3, K4 and K5 against their plain versions on the card: the route's
    groups of one band, of three and of every band, each refilled in one K4
    launch and walked in one K5 launch from the same walk state as the
    plain walk's; then every band but the first in one K4 launch (some
    pairs have no rows in most of them)."""
    ch = _long_chunk(40 + mode, NP=600, MP=280)
    ch.n[3:6] = (256, 257, 511)
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    c1, c2, n, m = _on(ch, cuda)
    B, NP, MP = ch.shape
    args = dict(mode=mode, og=-10.0, eg=-0.5, C=C)
    st, ck = longseq.fill_checkpointed(tab, c1, c2, n, m, **args)
    rst, rck = longseq.fill_checkpointed_ref(tab, c1, c2, n, m, **args)
    torch.cuda.synchronize()
    assert torch.equal(st, rst)
    for b in range(B):
        k, mb = int(ch.n[b]) // C, int(ch.m[b])
        for a, r in zip(ck, rck):
            assert torch.equal(a[b, :k, :mb], r[b, :k, :mb])
    L = NP + MP + 2
    nck = longseq.n_ckpts(NP, C)
    bb = longseq.band_bytes(C, MP)
    for G in sorted({1, 3, nck}):
        walk = longseq.walk_start(st, n, m, mode)
        rwalk = walk.clone()
        cnt = torch.zeros(B, dtype=torch.int32, device=cuda)
        rcnt = cnt.clone()
        moves = torch.zeros((-(-L // 4), B), dtype=torch.uint8, device=cuda)
        rmoves = moves.clone()
        bands = torch.zeros((G, B, bb), dtype=torch.uint8, device=cuda)
        rbands = bands.clone()
        for top in range(nck - 1, -1, -G):
            sk0 = max(0, top - G + 1)
            g = top - sk0 + 1
            longseq.fill_bands(tab, c1, c2, n, m, ck, bands[:g], sk0=sk0,
                               **args)
            longseq.fill_bands_ref(tab, c1, c2, n, m, ck, rbands[:g],
                                   sk0=sk0, **args)
            torch.cuda.synchronize()
            _assert_bands_equal(bands[:g], rbands[:g], ch, C, sk0)
            kw = dict(sk0=sk0, C=C, MP=MP, L=L, local=mode == LOCAL)
            before = metrics.counter("launch.K5")
            longseq.walk_segments(bands[:g], walk, cnt, moves, **kw)
            assert metrics.counter("launch.K5") == before + 1
            longseq.walk_segments_ref(bands[:g], rwalk, rcnt, rmoves, **kw)
            torch.cuda.synchronize()
            assert torch.equal(walk, rwalk) and torch.equal(cnt, rcnt), (
                G, sk0)
            assert torch.equal(moves, rmoves), (G, sk0)
        assert bool((walk[:, 3] == 1).all()) or mode == LOCAL
    if nck > 1:
        bands = torch.zeros((nck - 1, B, bb), dtype=torch.uint8, device=cuda)
        rbands = bands.clone()
        before = metrics.counter("launch.K4")
        longseq.fill_bands(tab, c1, c2, n, m, ck, bands, sk0=1, **args)
        assert metrics.counter("launch.K4") == before + 1
        longseq.fill_bands_ref(tab, c1, c2, n, m, ck, rbands, sk0=1, **args)
        torch.cuda.synchronize()
        _assert_bands_equal(bands, rbands, ch, C, 1)


@pytest.mark.parametrize("mode", MODES)
def test_long_route_matches_ordinary(cuda, mode, monkeypatch):
    """Every bucket through K3 -> K4 -> K5 against K1 -> K2 (the occupancy
    rule off: the planner sees no SMs): every field of every result."""
    rng = np.random.default_rng(50 + mode)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    pairs = []
    for k in range(12):
        a = "".join(rng.choice(letters, int(rng.integers(1, 700))))
        b = "".join(rng.choice(letters, int(rng.integers(1, 700))))
        if k % 3 == 0 and len(a) > 120:
            b = b[:30] + a[20:120] + b[30:]
        pairs.append((a, b))
    before = _launches("K3", "K4", "K5")
    got = BatchAligner(mode=mode, device="cuda",
                       longseq_cells=1).align_pairs(pairs)
    assert all(a > b for a, b in zip(_launches("K3", "K4", "K5"), before))
    monkeypatch.setattr(batch, "card_sms", lambda device: 0)
    before = _launches("K1", "K3")
    want = BatchAligner(mode=mode, device="cuda").align_pairs(pairs)
    k1, k3 = (a - b for a, b in zip(_launches("K1", "K3"), before))
    assert k1 > 0 and k3 == 0
    for g, w in zip(got, want):
        assert (g.aligned1, g.aligned2, g.score, g.start1, g.end1, g.start2,
                g.end2) == (w.aligned1, w.aligned2, w.score, w.start1,
                            w.end1, w.start2, w.end2)


@pytest.mark.parametrize("mode", [GLOCAL, LOCAL])
def test_occupancy_rule_matches_ordinary(cuda, mode, monkeypatch):
    """Two related DNA pairs of ~12 kbp, a flush the occupancy rule sends
    down the long route (K3, K4, K5), against the ordinary route (K1, K2)
    with the planner's SM count at 0: strings, scores and spans equal, and
    ``route.long.occupancy`` counts both pairs."""
    rng = np.random.default_rng(70 + mode)
    pairs = []
    for L in (12000, 11800):
        a = rng.integers(0, 4, size=L)
        b = a.copy()
        sub = rng.random(L) < 0.02
        b[sub] = rng.integers(0, 4, size=int(sub.sum()))
        b = np.concatenate([b[:3000], b[3040:], rng.integers(0, 4, 25)])
        pairs.append(("".join("ACGT"[c] for c in a),
                      "".join("ACGT"[c] for c in b)))
    dna = SubstitutionMatrix.match_mismatch(5.0, -4.0)
    NP = max(len(a) for a, _ in pairs)
    assert batch.occupancy_long(2, -(-NP // 256) * 256,
                                batch.card_sms(cuda))

    def run():
        return BatchAligner(scoring_matrix=dna, gap_open=10.0,
                            gap_extend=0.5, mode=mode,
                            device="cuda").align_pairs(pairs)

    before = _launches("K1", "K3", "K4", "K5")
    moved = metrics.counter("route.long.occupancy")
    got = run()
    k1, k3, k4, k5 = (a - b for a, b in
                      zip(_launches("K1", "K3", "K4", "K5"), before))
    assert k1 == 0 and k3 == 1 and k4 >= 1 and k5 == k4
    assert metrics.counter("route.long.occupancy") - moved == 2
    monkeypatch.setattr(batch, "card_sms", lambda device: 0)
    before = _launches("K1", "K3")
    want = run()
    k1, k3 = (a - b for a, b in zip(_launches("K1", "K3"), before))
    assert k1 == 1 and k3 == 0
    assert [(r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
             r.end2) for r in got] == [
        (r.aligned1, r.aligned2, r.score, r.start1, r.end1, r.start2,
         r.end2) for r in want]
    assert all(len(r.aligned1) > 11000 for r in got)


@pytest.mark.parametrize("mode", MODES)
def test_longseq_kernels_write_only_their_outputs(cuda, mode):
    """K3 (with its scratch: tickets, published tiles, band bests), K4 (a
    group of two bands) and K5 (walking that group) launched on outputs
    fenced by canary bytes:
    every canary stays intact and the outputs equal the wrappers' on the
    same inputs."""
    from smithwaterman_tpu_torch.ops import kernels

    C = 32
    ch = _long_chunk(60 + mode)
    tab = torch.from_numpy(SubstitutionMatrix.blosum62().table).to(cuda)
    c1, c2, n, m = _on(ch, cuda)
    B, NP, MP = ch.shape
    nck = longseq.n_ckpts(NP, C)
    args = dict(mode=mode, og=-10.0, eg=-0.5, C=C)
    wst, wck = longseq.fill_checkpointed(tab, c1, c2, n, m, **args)
    arenas = {}
    ck = []
    for name in ("ckm", "ckx", "cky"):
        arenas[name], t = _fenced(4 * B * nck * MP, torch.float32, cuda)
        ck.append(t.view(B, nck, MP))
    arenas["stats"], stats = _fenced(4 * 8 * B, torch.float32, cuda)
    stats = stats.view(B, 8)
    words = kernels.ckpt_scratch_words(B, nck)
    arenas["scratch"], scratch = _fenced(4 * words, torch.int32, cuda,
                                         inner=0)
    kernels.ckpt_fill(tab, c1, c2, n, m, *ck, stats, scratch, **args)
    sk = nck - 2
    bb = longseq.band_bytes(C, MP)
    arenas["band"], bands = _fenced(2 * B * bb, torch.uint8, cuda)
    bands = bands.view(2, B, bb)
    kernels.band_fill(tab, c1, c2, n, m, *ck, bands, sk0=sk - 1, **args)
    L = NP + MP + 2
    walk0 = longseq.walk_start(wst, n, m, mode)
    walk0[:, 0] = torch.minimum(walk0[:, 0], n.new_tensor((sk + 1) * C))
    arenas["walk"], walk = _fenced(4 * 4 * B, torch.int32, cuda)
    walk = walk.view(B, 4)
    walk.copy_(walk0)
    arenas["cnt"], cnt = _fenced(4 * B, torch.int32, cuda, inner=0)
    arenas["moves"], moves = _fenced(-(-L // 4) * B, torch.uint8, cuda,
                                     inner=0)
    moves = moves.view(-1, B)
    kernels.seg_walk(bands, walk, cnt, moves, local=mode == LOCAL, C=C,
                     sk0=sk - 1, MP=MP, L=L)
    torch.cuda.synchronize()
    for name, arena in arenas.items():
        assert bool((arena[:GUARD] == CANARY).all()), name
        assert bool((arena[-GUARD:] == CANARY).all()), name
    assert torch.equal(stats, wst)
    for b in range(B):
        k, mb = int(ch.n[b]) // C, int(ch.m[b])
        for a, r in zip(ck, wck):
            assert torch.equal(a[b, :k, :mb], r[b, :k, :mb])
    # the scratch afterwards: every ticket taken, every full band's tiles
    # published, in LOCAL every band of a pair counted done
    sc = scratch.cpu().numpy()
    nb = -(-ch.n // C)
    assert sc[0] >= nck * B
    prog = sc[1 + B:1 + B + B * nck].reshape(B, nck)
    for b in range(B):
        full = int(ch.n[b]) // C
        assert (prog[b, :full] == -(-int(ch.m[b]) // 32)).all(), b
        assert (prog[b, full:] == 0).all(), b
    if mode == LOCAL:
        assert (sc[1:1 + B] == nb).all()
    wbands = torch.zeros_like(bands)
    longseq.fill_bands(tab, c1, c2, n, m, wck, wbands, sk0=sk - 1, **args)
    _assert_bands_equal(bands, wbands, ch, C, sk - 1)
    rwalk = walk0.clone()
    rcnt = torch.zeros(B, dtype=torch.int32, device=cuda)
    rmoves = torch.zeros_like(moves)
    longseq.walk_segments_ref(wbands, rwalk, rcnt, rmoves, sk0=sk - 1, C=C,
                              MP=MP, L=L, local=mode == LOCAL)
    assert torch.equal(walk, rwalk) and torch.equal(cnt, rcnt)
    assert torch.equal(moves, rmoves)


def _banded_pairs(seed):
    """Ragged similar pairs (lengths down to 1, around multiples of 64,
    both signs of m - n) and one pair with a repeated motif: tied LOCAL
    maxima."""
    rng = np.random.default_rng(seed)
    out = []
    for n, m in ((639, 640), (1, 50), (705, 560), (37, 1), (321, 400),
                 (512, 512), (65, 180)):
        base = rng.integers(0, 20, size=n + m + 10)
        c2 = base[3:3 + m].copy()
        c2[rng.integers(0, m, size=max(1, m // 10))] = 5
        out.append((base[:n].copy(), c2))
    c1 = rng.integers(0, 20, size=400)
    for r in range(0, 360, 60):
        c1[r:r + 40] = c1[:40]
    out.append((c1, c1[:40].copy()))
    return out


def _banded_on(pk, dev):
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (pk.codes1, pk.codes2, pk.n, pk.m))


@pytest.mark.parametrize("which", ["eight", "one"])
@pytest.mark.parametrize("band", [128, 512, 2048])
@pytest.mark.parametrize("mode", MODES)
def test_banded_kernels_match_plain(cuda, mode, band, which, monkeypatch):
    """K6, K7 and K8 against their plain versions on the card: every score,
    every pointer byte of rows i <= n, stats, indices, counts and flags;
    eight ragged pairs (n around K7's stripes of 64 rows and below one) or
    one of 3000 x 3100 (W up to 2048), K7 on more blocks than pairs; K6
    also alone at as many skewed and m <= W pairs at the same W."""
    from smithwaterman_tpu_torch.ops import banded

    table = SubstitutionMatrix.blosum62().table
    tab = torch.from_numpy(table).to(cuda)
    pairs = _banded_pairs(70 + mode)
    if which == "one":
        c1 = np.random.default_rng(75 + mode).integers(0, 20, size=3000)
        c2 = np.concatenate([c1[:1400], c1[1300:]])
        c2[::23] = 4
        pairs = [(c1, c2)]
    pk = banded.pack(pairs, band, table.shape[0])
    c1, c2, n, m = _banded_on(pk, cuda)
    S = banded.banded_scores(tab, c1, c2, n, m, W=pk.W)
    assert torch.equal(S, banded.banded_scores_ref(tab, c1, c2, n, m,
                                                   W=pk.W))
    _check_k6(tab, *_k6_shapes(pk.W, len(pairs), 20, cuda, band + mode),
              pk.W, monkeypatch)
    args = dict(mode=mode, og=-10.0, eg=-0.5)
    rtb, rst = banded.fill_banded_ref(S, n, m, **args)
    tb, st = banded.fill_banded(S, n, m, **args)
    shape = banded.SHAPES["K7"]
    assert shape["blocks"] > len(pairs), shape
    assert torch.equal(st, rst)
    for b in range(len(pk.n)):
        assert torch.equal(tb[b, :int(pk.n[b])], rtb[b, :int(pk.n[b])]), b
    start, _ = banded.walk_starts(st.cpu().numpy(), pk, mode)
    off, start = (torch.from_numpy(a).to(cuda) for a in (pk.offs, start))
    L = banded.path_len(pk)
    got = banded.walk_banded_device(tb, off, start, m, local=mode == LOCAL,
                                    L=L)
    want = banded.walk_banded_ref(tb, off, start, m, local=mode == LOCAL, L=L)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_banded_cuda_matches_cpu(cuda, mode):
    """align_banded_batch and Aligner.align_banded on the card equal the
    CPU path, and every banded kernel launched."""
    from smithwaterman_tpu_torch import Aligner
    from smithwaterman_tpu_torch.ops import banded

    table = SubstitutionMatrix.blosum62().table
    pairs = _banded_pairs(80 + mode)
    before = _launches("K6", "K7", "K8")
    got = banded.align_banded_batch(pairs, table, mode=mode, og=-10.0,
                                    eg=-0.5, band=128, device="cuda")
    assert all(a > b for a, b in zip(_launches("K6", "K7", "K8"), before))
    assert got == banded.align_banded_batch(pairs, table, mode=mode, og=-10.0,
                                            eg=-0.5, band=128, device="cpu")
    s1 = "".join("ACDEFGHIKLMNPQRSTVWY"[c] for c in pairs[0][0])
    s2 = "".join("ACDEFGHIKLMNPQRSTVWY"[c] for c in pairs[0][1])
    g = Aligner(mode=mode, device="cuda").align_banded(s1, s2, band=128)
    c = Aligner(mode=mode, device="cpu").align_banded(s1, s2, band=128)
    assert vars(g) == vars(c)


@pytest.mark.parametrize("mode", MODES)
def test_banded_kernels_write_only_their_outputs(cuda, mode):
    """K6, K7 (with its scratch: tickets, published tiles, stripe bests
    and bottom rows) and K8 launched on outputs fenced by canary bytes:
    every canary stays intact and the outputs equal the wrappers' on the
    same inputs."""
    from smithwaterman_tpu_torch.ops import banded, kernels

    table = SubstitutionMatrix.blosum62().table
    tab = torch.from_numpy(table).to(cuda)
    pk = banded.pack(_banded_pairs(90 + mode), 256, table.shape[0])
    c1, c2, n, m = _banded_on(pk, cuda)
    B, NP = pk.codes1.shape
    W = pk.W
    args = dict(mode=mode, og=-10.0, eg=-0.5)
    wS = banded.banded_scores(tab, c1, c2, n, m, W=W)
    wtb, wst = banded.fill_banded(wS, n, m, **args)
    arenas = {}
    arenas["S"], S = _fenced(4 * B * NP * W, torch.float32, cuda)
    S = S.view(B, NP, W)
    kernels.banded_scores(tab, c1, c2, n, m, S, W=W)
    words = kernels.banded_scratch_words(B, NP, W)
    arenas["scratch"], scratch = _fenced(4 * words, torch.int32, cuda)
    scratch[:kernels.banded_scratch_zeroed(B, NP)].zero_()
    arenas["tb"], tb = _fenced(B * NP * W, torch.uint8, cuda)
    arenas["stats"], stats = _fenced(4 * 8 * B, torch.float32, cuda)
    tb, stats = tb.view(B, NP, W), stats.view(B, 8)
    kernels.banded_fill(S, n, m, scratch, tb, stats, **args)
    start, _ = banded.walk_starts(wst.cpu().numpy(), pk, mode)
    off, start = (torch.from_numpy(a).to(cuda) for a in (pk.offs, start))
    L = banded.path_len(pk)
    out = []
    for name, nbytes in (("idx1", 4 * B * L), ("idx2", 4 * B * L),
                         ("cnt", 4 * B), ("flags", 4 * B)):
        arenas[name], t = _fenced(nbytes, torch.int32, cuda)
        out.append(t.view(B, L) if name.startswith("idx") else t)
    kernels.banded_walk(tb, off, start, m, *out, local=mode == LOCAL, L=L)
    torch.cuda.synchronize()
    for name, arena in arenas.items():
        assert bool((arena[:GUARD] == CANARY).all()), name
        assert bool((arena[-GUARD:] == CANARY).all()), name
    assert torch.equal(S, wS) and torch.equal(stats, wst)
    for b in range(B):
        assert torch.equal(tb[b, :int(pk.n[b])], wtb[b, :int(pk.n[b])])
    want = banded.walk_banded_device(wtb, off, start, m, local=mode == LOCAL,
                                     L=L)
    for g, w in zip(out, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("W", [8, 130, 512, 27008, 29952])
@pytest.mark.parametrize("mode", MODES)
def test_banded_walk_any_width(cuda, mode, W):
    """K8 at bands of 8 and 130 bytes a row (row starts off 16- and
    4-byte alignment: the window copies' end pieces), 512, 27,008 (the
    ring's largest slots of two rows) and 29,952 (no ring fits: reads
    straight from the band), random pointer bytes, on canary-fenced
    outputs: every canary intact, indices, counts and flags equal to the
    plain walk's."""
    from smithwaterman_tpu_torch.ops import banded, kernels

    D = kernels.banded_walk_rows(W)
    assert (D >= 2) if W <= 27008 else D == 0
    tb, off, start, m, L = banded.random_band(
        np.random.default_rng(100 + W + mode), W, mode == LOCAL)
    B = tb.shape[0]
    tb, off, start, m = (torch.from_numpy(a).to(cuda)
                         for a in (tb, off, start, m))
    want = banded.walk_banded_ref(tb, off, start, m, local=mode == LOCAL,
                                  L=L)
    arenas, out = {}, []
    for name, nbytes in (("idx1", 4 * B * L), ("idx2", 4 * B * L),
                         ("cnt", 4 * B), ("flags", 4 * B)):
        arenas[name], t = _fenced(nbytes, torch.int32, cuda)
        out.append(t.view(B, L) if name.startswith("idx") else t)
    kernels.banded_walk(tb, off, start, m, *out, local=mode == LOCAL, L=L)
    torch.cuda.synchronize()
    for name, arena in arenas.items():
        assert bool((arena[:GUARD] == CANARY).all()), name
        assert bool((arena[-GUARD:] == CANARY).all()), name
    for g, w in zip(out, want):
        assert torch.equal(g, w)
    assert int(out[2].max()) > 0


def _striped_case(seed, NP=128, MP=512):
    """Three ragged pairs (lengths down to 1, one shared stretch) as dense
    BLOSUM62 scores (B, NP, MP) f32 with their lengths."""
    rng = np.random.default_rng(seed)
    table = SubstitutionMatrix.blosum62().table
    c1 = rng.integers(0, 20, size=(3, NP))
    c2 = rng.integers(0, 20, size=(3, MP))
    k = min(100, NP - 10, MP - 40)
    c2[0, 40:40 + k] = c1[0, 10:10 + k]
    S = np.stack([table[a[:, None], b[None, :]] for a, b in zip(c1, c2)])
    n = np.array([NP, 1, NP - 29], np.int32)
    m = np.array([MP - 7, MP, 1], np.int32)
    return S.astype(np.float32), n, m


class _Lockstep:
    """Every K12 / K13 launch of parallel/seq_tiled beside its plain version
    on copies of the same inputs; ``err`` is the largest |difference| of
    any output (state, edges, pointer bytes, checkpoints)."""

    def __init__(self):
        from smithwaterman_tpu_torch.parallel import seq_tiled

        self.st = seq_tiled
        self.err = 0.0
        self.launches = 0

    def _diff(self, a, b):
        if a is None:
            return 0.0
        d = (a.double() - b.double()).abs()
        return float(d.max()) if d.numel() else 0.0

    def __enter__(self):
        st, real_block, real_grid = self.st, self.st.block_fill, \
            self.st.grid_fill
        self.real = (real_block, real_grid)

        def block(*state, ds, **kw):
            ref = [None if a is None else a.clone() for a in state]
            st.block_ref(*ref, ds=ds, **kw)
            real_block(*state, ds=ds, **kw)
            self.launches += 1
            self.err = max([self.err] + [self._diff(a, r) for a, r in
                                         zip(state[3:], ref[3:])])

        def grid(S, n, m, *, mode, pen, C=None):
            out = real_grid(S, n, m, mode=mode, pen=pen, C=C)
            ref = [torch.empty_like(a) for a in out[:3]]
            rck = None if out[3] is None else tuple(
                torch.empty_like(a) for a in out[3])
            st.grid_fill_ref(S, n, m, *ref, rck, C=C, mode=mode, pen=pen)
            self.launches += 1
            self.err = max([self.err] + [self._diff(a, r) for a, r in
                                         zip(out[:3], ref)]
                           + [self._diff(a, r) for a, r in
                              zip(out[3] or (), rck or ())])
            return out

        st.block_fill, st.grid_fill = block, grid
        return self

    def __exit__(self, *exc):
        self.st.block_fill, self.st.grid_fill = self.real


@pytest.mark.parametrize("plan", [None, (8, 1), (8, 3), (16, 2)])
@pytest.mark.parametrize("mode", MODES)
def test_striped_kernels_match_plain(cuda, mode, plan, monkeypatch):
    """K12 (D = 1, 2, 4 shards on one card: the checkpointed fill at D > 1
    and a seeded band re-fill with pointer bytes at every D) and K13 (the
    D = 1 checkpointed fill, f32, int8 and folded S) against their plain
    versions, launch by launch, at the launcher's tiling and at forced
    ones (L lanes a thread, E rows a publication): shards of 512 lanes,
    of 300 (not a multiple of the tile) and of 33 (under one tile); and a
    fill of 320 pairs with more tiles than the card holds blocks, so that
    the blocks take tickets again."""
    from smithwaterman_tpu_torch.ops import kernels
    from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled

    if plan:
        monkeypatch.setattr(kernels, "striped_plan", lambda *a: plan)
    before = _launches("K12", "K13")
    with _Lockstep() as ls:
        for D, MP in ((1, 512), (2, 1024), (4, 2048), (1, 300), (2, 600),
                      (4, 1200), (4, 132)):
            S, n, m = _striped_case(90 + mode + MP, MP=MP)
            St = torch.from_numpy(S).to(cuda)
            mesh = make_mesh(devices=[cuda] * D)
            for K, og, eg in ((8, -10.0, -0.5), (64, -10.3, -0.7),
                              (16, 0.0, 0.0)):
                kw = dict(mode=mode, og=og, eg=eg, block_rows=K, mesh=mesh)
                st, ck = seq_tiled.striped_fill_ckpt(St, n, m, ckpt_rows=64,
                                                     **kw)
                seq_tiled.striped_band_tb(St[:, 64:], n, m, 64,
                                          *(a[:, 0] for a in ck), **kw)
        mesh = make_mesh(devices=[cuda])
        S, n, m = _striped_case(90 + mode)
        S8 = torch.from_numpy(S[:1].astype(np.int8)).to(cuda)
        for x, folded in ((S8, False), (seq_tiled.fold_S(S8), True)):
            seq_tiled.striped_fill(x, n[:1], m[:1], mode=mode, og=-10.0,
                                   eg=-0.5, block_rows=8, mesh=mesh,
                                   folded=folded)
        if plan == (8, 1):
            rng = np.random.default_rng(mode)
            Sb = torch.from_numpy(rng.integers(
                -4, 12, size=(320, 32, 4096)).astype(np.float32)).to(cuda)
            nb = rng.integers(1, 33, size=320).astype(np.int32)
            mb = rng.integers(1, 4097, size=320).astype(np.int32)
            for D in (1, 2):
                seq_tiled.striped_fill_ckpt(
                    Sb, nb, mb, mode=mode, og=-10.0, eg=-0.5, block_rows=16,
                    ckpt_rows=16, mesh=make_mesh(devices=[cuda] * D))
                k = "K13" if D == 1 else "K12"
                shape = seq_tiled.SHAPES[k]
                assert shape["blocks"] < shape["tiles"], (k, shape)
    torch.cuda.synchronize()
    assert ls.err == 0.0 and ls.launches > 0
    assert all(a > b for a, b in zip(_launches("K12", "K13"), before))


@pytest.mark.parametrize("mode", MODES)
def test_striped_cuda_matches_cpu(cuda, mode):
    """striped_fill, striped_fill_ckpt and striped_align on a card (one and
    four shards) and on a mesh that alternates the card and the CPU (edges
    copied between devices every step, outputs gathered) equal the CPU
    mesh's plain versions."""
    from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled

    S, n, m = _striped_case(95 + mode, NP=96, MP=256)
    kw = dict(mode=mode, og=-10.0, eg=-0.5, block_rows=16)
    for devs in ([cuda], [cuda] * 4, [cuda, "cpu"] * 2):
        gm = make_mesh(devices=devs)
        cm = make_mesh(devices=["cpu"] * len(devs))
        assert torch.equal(seq_tiled.striped_fill(S, n, m, mesh=gm, **kw).cpu(),
                           seq_tiled.striped_fill(S, n, m, mesh=cm, **kw))
        gst, gck = seq_tiled.striped_fill_ckpt(S, n, m, ckpt_rows=32,
                                               mesh=gm, **kw)
        cst, cck = seq_tiled.striped_fill_ckpt(S, n, m, ckpt_rows=32,
                                               mesh=cm, **kw)
        assert torch.equal(gst.cpu(), cst)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(gck, cck))
        gi, gs = seq_tiled.striped_align(S, n, m, mesh=gm, ckpt_rows=32, **kw)
        ci, cs = seq_tiled.striped_align(S, n, m, mesh=cm, ckpt_rows=32, **kw)
        assert gi == ci and np.array_equal(gs, cs)


@pytest.mark.parametrize("mode", MODES)
def test_striped_kernels_write_only_their_outputs(cuda, mode, monkeypatch):
    """K12 (one step of shards 1 and 2 of four, with pointer bytes) and K13
    (with checkpoints), each in tiles of 256 lanes, launched on outputs and
    scratch fenced by canary bytes: every canary stays intact and the
    outputs equal the plain versions'."""
    from smithwaterman_tpu_torch.ops import kernels
    from smithwaterman_tpu_torch.parallel import seq_tiled

    S, n, m = _striped_case(99 + mode, NP=64, MP=2048)
    B, NP, MP = S.shape
    D, K, W = 4, 16, 512
    # tiles of 256 lanes: two a shard, eight a K13 row
    monkeypatch.setattr(kernels, "striped_plan", lambda *a: (8, 3))
    St = torch.from_numpy(S).to(cuda)
    nt, mt = (torch.from_numpy(a).to(cuda) for a in (n, m))
    pen = seq_tiled.make_pen(mode, -10.0, -0.5)
    rng = np.random.default_rng(mode)

    def filled(shape, dtype, fill_fn):
        nbytes = int(np.prod(shape)) * torch.tensor([], dtype=dtype)\
            .element_size()
        arena, t = _fenced(nbytes, dtype, cuda)
        t = t.view(shape)
        t.copy_(fill_fn(shape).to(dtype))
        return arena, t

    rnd = lambda shape: torch.from_numpy(
        rng.uniform(-30, 30, size=shape).astype(np.float32)).round()
    arenas, state = {}, {}
    for name, shape, dtype, fn in (
            ("rows", (2, 3, B, MP), torch.float32, rnd),
            ("box", (2, D, B, K, 4), torch.float32, rnd),
            ("above", (D, B, 4), torch.float32, rnd),
            ("best", (B, MP), torch.float32, rnd),
            ("best_i", (B, MP), torch.int32,
             lambda s: torch.full(s, 1 << 30)),
            ("acc", (D, B, 4), torch.float32, lambda s: torch.zeros(s)),
            ("tb", (B, NP, MP), torch.uint8, lambda s: torch.zeros(s))):
        arenas[name], state[name] = filled(shape, dtype, fn)
    ref = {k: v.clone() for k, v in state.items()}
    args = dict(ds=[1, 2], t=2, i0=0, K=K, W=W, s_lo=0, mode=mode, pen=pen)
    order = ("rows", "box", "above", "best", "best_i", "acc", "tb")
    words = kernels.striped_scratch_words(2 * B * 2, K)
    arenas["k12 scratch"], scratch = _fenced(4 * words, torch.int32, cuda)
    kernels.striped_block(St, nt, mt, *(state[k] for k in order), **args,
                          scratch=scratch)
    seq_tiled.block_ref(St, nt, mt, *(ref[k] for k in order), **args)
    outs = {}
    for name, shape, dtype in (("scratch", (kernels.striped_scratch_words(
                                    B * 8, NP),), torch.int32),
                               ("best", (B, MP), torch.float32),
                               ("best_i", (B, MP), torch.int32),
                               ("acc", (B, 4), torch.float32),
                               ("ckm", (B, NP // 16, MP), torch.float32),
                               ("ckx", (B, NP // 16, MP), torch.float32),
                               ("cky", (B, NP // 16, MP), torch.float32)):
        nbytes = int(np.prod(shape)) * torch.tensor([], dtype=dtype)\
            .element_size()
        arenas["k13 " + name], t = _fenced(nbytes, dtype, cuda)
        outs[name] = t.view(shape)
    kernels.striped_grid(St, nt, mt, outs["best"], outs["best_i"],
                         outs["acc"], (outs["ckm"], outs["ckx"], outs["cky"]),
                         C=16, mode=mode, pen=pen, scratch=outs["scratch"])
    torch.cuda.synchronize()
    for name, arena in arenas.items():
        assert bool((arena[:GUARD] == CANARY).all()), name
        assert bool((arena[-GUARD:] == CANARY).all()), name
    for k in order:
        assert torch.equal(state[k], ref[k]), k
    want = [torch.empty_like(outs[k]) for k in ("best", "best_i", "acc")]
    wck = tuple(torch.empty_like(outs[k]) for k in ("ckm", "ckx", "cky"))
    seq_tiled.grid_fill_ref(St, nt, mt, *want, wck, C=16, mode=mode, pen=pen)
    for a, w in zip((outs["best"], outs["best_i"], outs["acc"]), want):
        assert torch.equal(a, w)
    for a, w in zip((outs["ckm"], outs["ckx"], outs["cky"]), wck):
        assert torch.equal(a, w)
