#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.  Imports nothing of
JAX and nothing of the JAX package.  Phases, one or more stdout lines each:

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. the builds: the two hand-written CUDA kernels (``nvcc``) and the shared
   host library (``g++``), from the checkout's sources, with build seconds;
3. K1 (the fill kernel) against its plain PyTorch version on the card:
   all three modes, traceback and score-only, ragged lengths down to 1,
   one 3685 x 3685 pair, a non-integer table and og = ge = 0.  Every
   pair's pointer bytes and stats must be equal;
4. K2 (the walk kernel) against its plain version on K1's own pointers:
   move counts and packed moves must be equal;
5. the main path at a size users run: 3200 protein pairs, lengths uniform
   in 150..700, BLOSUM62, go = 10, ge = 0.5, through
   ``BatchAligner(device="cuda")`` in all three modes plus one
   ``score_pairs``; a random 64-pair subset per mode must equal the CPU
   path exactly and every kernel must have launched.  Then, per mode,
   each kernel runs at the main path's shapes (the same pairs, bucketed
   alike, every chunk in one launch) beside its plain version on the same
   inputs: every pair's pointer bytes and stats, every move count and
   move byte must be equal, and both are timed.

The last two stdout lines are the kernels' JSON record and the result
line; its ``max_abs_err`` is that main-path comparison's.  Any failure
raises and exits non-zero without a result line; so does a machine
without CUDA.
"""

import json
import subprocess
import sys
import time

import numpy as np

SEED = 42
PAIRS = 3200
LMIN, LMAX = 150, 700
LETTERS = "ARNDCQEGHILKMFPSTWYV"
CHECKED = 64
LONGEST = 3685  # the reference suite's longest sequence


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(line: str) -> None:
    print(line, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main_path_pairs():
    """The main path's input: PAIRS protein pairs, each side's length
    uniform in LMIN..LMAX, from ``numpy.random.default_rng(SEED)``."""
    from smithwaterman_tpu_torch.io.fasta import SeqData

    rng = np.random.default_rng(SEED)
    letters = np.array(list(LETTERS))

    def seq(name):
        k = int(rng.integers(LMIN, LMAX + 1))
        return SeqData(name, "", "".join(rng.choice(letters, k)))

    return [(seq(f"a{i}"), seq(f"b{i}")) for i in range(PAIRS)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.batch_aligner import _Bucket
    from smithwaterman_tpu_torch.config import bucket_len
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import (batch, device_walk, fill_dp,
                                             kernels, native)

    dev = torch.device("cuda:0")
    modes = [(LOCAL, "local"), (GLOCAL, "glocal"), (GLOBAL, "global")]

    # ---- phase 1: the card
    card = card_line()
    say(card)
    say(f"phase 1 card: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- phase 2: builds from the checkout's sources
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.lib()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.host_lib()
    t_gxx = time.perf_counter() - t0
    say(f"phase 2 build: nvcc {t_nvcc:.2f} s, g++ host library {t_gxx:.2f} s")
    # the kernels link the CUDA runtime as a shared library, so the process
    # should map one libcudart, PyTorch's
    with open("/proc/self/maps") as f:
        runtimes = sorted({ln.split()[-1] for ln in f if "libcudart" in ln})
    say(f"  CUDA runtime mapped: {runtimes}")
    with open(so + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                say("  ptxas: " + line.strip())

    blosum = SubstitutionMatrix.blosum62().table
    rng = np.random.default_rng(SEED)

    def chunk(B, NP, MP, lo=1):
        n = rng.integers(lo, NP + 1, size=B).astype(np.int32)
        m = rng.integers(lo, MP + 1, size=B).astype(np.int32)
        c1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
        c2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
        return batch.Chunk(c1, c2, n, m)

    ragged = [chunk(96, 384, 384), chunk(7, 64, 512)]
    # one-row and one-column pairs in both chunks
    ragged[0].n[:3], ragged[0].m[:3] = (1, 300, 1), (1, 1, 37)
    ragged[1].n[:2], ragged[1].m[:2] = (1, 64), (512, 1)
    # a shared motif: long local alignments and many tied paths
    ragged[0].codes2[3, 10:200] = ragged[0].codes1[3, 30:220]
    ragged[0].n[3], ragged[0].m[3] = 380, 384
    big = batch.Chunk(
        rng.integers(0, 20, size=(1, 4096)).astype(np.uint8),
        rng.integers(0, 20, size=(1, 4096)).astype(np.uint8),
        np.array([LONGEST], np.int32), np.array([LONGEST], np.int32))
    big.codes2[0, :2000] = big.codes1[0, 100:2100]
    cases = [
        ("ragged", ragged, blosum, -10.0, -0.5),
        (f"{LONGEST}x{LONGEST}", [big], blosum, -10.0, -0.5),
        ("blosum62*0.5", ragged, blosum * np.float32(0.5), -10.0, -0.5),
        ("go=ge=0", ragged, blosum, 0.0, 0.0),
    ]

    def pair_masks(chunks):
        out = []
        for ch in chunks:
            B, NP, MP = ch.shape
            n = torch.from_numpy(ch.n).to(dev)
            m = torch.from_numpy(ch.m).to(dev)
            i = torch.arange(NP, device=dev)[:, None, None]
            j = torch.arange(MP, device=dev)[None, :, None]
            out.append((i < n[None, None, :]) & (j < m[None, None, :]))
        return out

    def fill_err(got, ref, masks):
        """Largest |difference| between two fills' stats and pointer bytes
        inside every pair's [:n, :m], and the count of differing bytes."""
        err = float((got.stats - ref.stats).abs().max())
        bad = 0
        if got.tb is not None:
            for c, mask in enumerate(masks):
                d = (got.tb_view(c).int() - ref.tb_view(c).int()).abs() * mask
                bad += int((d != 0).sum())
                err = max(err, float(d.max()))
        return err, bad

    def walk_err(out, ref):
        """Largest |difference| between two walks' counts and move bytes."""
        (cnt, mv), (rcnt, rmv) = out, ref
        return max(float((cnt - rcnt).abs().max()),
                   float((mv.int() - rmv.int()).abs().max()))

    # ---- phase 3: K1 against its plain version
    walk_inputs = []
    for name, chunks, table, og, eg in cases:
        tab = torch.from_numpy(np.ascontiguousarray(table)).to(dev)
        masks = pair_masks(chunks)
        for mode, mname in modes:
            for score_only in (False, True):
                got = fill_dp.fill_many(tab, chunks, mode=mode, og=og, eg=eg,
                                        score_only=score_only)
                torch.cuda.synchronize()
                ref = fill_dp.fill_many_ref(tab, chunks, mode=mode, og=og,
                                            eg=eg, score_only=score_only)
                torch.cuda.synchronize()
                err, bad = fill_err(got, ref, masks)
                if not score_only:
                    walk_inputs.append((name, mode, mname, got))
                if err != 0.0 or bad or not torch.equal(got.stats, ref.stats):
                    fail(f"K1 {name} {mname} score_only={score_only}: "
                         f"max stats/tb error {err}, {bad} pointer bytes "
                         "differ")
        say(f"phase 3 K1 {name}: 3 modes x (traceback, score-only) equal to "
            "the plain fill")

    # ---- phase 4: K2 against its plain version on K1's own pointers
    for name, mode, mname, got in walk_inputs:
        L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in got.shapes)
        cnt, mv = device_walk.walk_packed(got.tb, got.desc, got.stats,
                                          mode=mode, L=L)
        torch.cuda.synchronize()
        ref = device_walk.walk_packed_ref(got.tb, got.desc, got.stats,
                                          mode=mode, L=L)
        if walk_err((cnt, mv), ref) != 0.0:
            fail(f"K2 {name} {mname}: walk differs from the plain walk")
        if int(cnt.max()) == 0:
            fail(f"K2 {name} {mname}: no moves at all")
    say(f"phase 4 K2: {len(walk_inputs)} walks equal to the plain walk "
        "(counts and every move byte)")

    # ---- phase 5: the main path at a size users run
    pairs = main_path_pairs()
    cells = sum(len(a.seq) * len(b.seq) for a, b in pairs)
    sub = np.random.default_rng(SEED + 1).choice(PAIRS, CHECKED,
                                                 replace=False)
    fill_dp.LAUNCHES = 0
    device_walk.LAUNCHES = 0
    walls = {}
    results = {}
    for mode, mname in modes:
        eng = BatchAligner(mode=mode, device="cuda")
        eng.align_pairs(pairs)              # cold: first use of the shapes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.align_pairs(pairs)
        walls[mname] = time.perf_counter() - t0
        results[mname] = (res, dict(eng.phase))
    eng = BatchAligner(mode=LOCAL, device="cuda")
    t0 = time.perf_counter()
    scores = eng.score_pairs(pairs)
    walls["local score_pairs"] = time.perf_counter() - t0
    launches = {"K1": fill_dp.LAUNCHES, "K2": device_walk.LAUNCHES}
    if launches["K1"] == 0 or launches["K2"] == 0:
        fail(f"a kernel of the main path never launched: {launches}")

    for mode, mname in modes:
        res, phase = results[mname]
        if len(res) != PAIRS or not all(np.isfinite(r.score) for r in res):
            fail(f"{mname}: {len(res)} results, or a non-finite score")
        ref = BatchAligner(mode=mode, device="cpu").align_pairs(
            [pairs[k] for k in sub])
        for k, r in zip(sub, ref):
            g = res[k]
            if (g.aligned1, g.aligned2, g.score, g.start1, g.end1, g.start2,
                    g.end2) != (r.aligned1, r.aligned2, r.score, r.start1,
                                r.end1, r.start2, r.end2):
                fail(f"{mname} pair {k}: differs from the CPU path")
        wall = walls[mname]
        say(f"phase 5 {mname}: {PAIRS} pairs warm {wall:.4f} s, "
            f"{PAIRS / wall:.1f} pairs/s, {cells / wall / 1e9:.4f} GCUPS "
            f"(true cells) on {card}; {CHECKED} checked pairs equal to the "
            f"CPU path; phases " + json.dumps(
                {k: round(v, 4) for k, v in phase.items()}))
    local_scores = np.array([r.score for r in results["local"][0]],
                            np.float32)
    if not np.array_equal(scores, local_scores):
        fail("score_pairs disagrees with align_pairs")
    say(f"phase 5 score_pairs local: {walls['local score_pairs']:.4f} s, "
        f"equal to align_pairs' scores; launches {json.dumps(launches)}")

    # ---- each kernel against its plain version at the main path's shapes:
    # the pairs above, bucketed as BatchAligner buckets them, every chunk in
    # one launch; every output must be equal, and each kernel is timed
    sm = SubstitutionMatrix.blosum62()
    buckets = {}
    for a, b in pairs:
        key = (bucket_len(len(a.seq)), bucket_len(len(b.seq)))
        bk = buckets.setdefault(key, _Bucket(*key))
        bk.indices.append(len(bk.indices))
        bk.codes1.append(sm.seq_to_index(a.seq))
        bk.codes2.append(sm.seq_to_index(b.seq))
    chunks = [buckets[k].chunk() for k in sorted(buckets)]
    tab = torch.from_numpy(blosum).to(dev)
    masks = pair_masks(chunks)
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in
            (ch.shape for ch in chunks))

    def timed(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    main_err = {"K1": 0.0, "K2": 0.0}
    times = {}
    fill_dp.fill_many_ref(tab, chunks[:1], mode=LOCAL, og=-10.0, eg=-0.5)
    for mode, mname in modes:
        args = dict(mode=mode, og=-10.0, eg=-0.5)
        fill_dp.fill_many(tab, chunks, **args)
        k1_ms, got = timed(lambda: fill_dp.fill_many(tab, chunks, **args), 3)
        k1_plain_ms, ref = timed(
            lambda: fill_dp.fill_many_ref(tab, chunks, **args), 1)
        err, bad = fill_err(got, ref, masks)
        if err != 0.0 or bad or not torch.equal(got.stats, ref.stats):
            fail(f"K1 at the main path's shapes, {mname}: max stats/tb "
                 f"error {err}, {bad} pointer bytes differ")
        del ref
        def walk():
            return device_walk.walk_packed(got.tb, got.desc, got.stats,
                                           mode=mode, L=L)

        walk()
        k2_ms, out = timed(walk, 5)
        k2_plain_ms, rout = timed(lambda: device_walk.walk_packed_ref(
            got.tb, got.desc, got.stats, mode=mode, L=L), 1)
        werr = walk_err(out, rout)
        if werr != 0.0:
            fail(f"K2 at the main path's shapes, {mname}: walk differs "
                 f"from the plain walk (max error {werr})")
        main_err["K1"] = max(main_err["K1"], err)
        main_err["K2"] = max(main_err["K2"], werr)
        times[mname] = (k1_ms, k1_plain_ms, k2_ms, k2_plain_ms)
        say(f"phase 5 kernels {mname} at the main path's shapes ({PAIRS} "
            f"pairs, {len(chunks)} chunks, L={L}) on {card}: every pointer "
            f"byte, stat, count and move equal to the plain versions; K1 "
            f"{k1_ms:.3f} ms vs plain {k1_plain_ms:.3f} ms; K2 {k2_ms:.3f} "
            f"ms vs plain {k2_plain_ms:.3f} ms")
        del got, out, rout
    k1_ms, k1_plain_ms, k2_ms, k2_plain_ms = times["local"]

    kernels_line = {"kernels": [
        {"name": "K1 fill", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/fill.cu",
         "replaces": "smithwaterman_tpu/ops/pallas_dp.py:197",
         "launches": launches["K1"], "max_abs_err": main_err["K1"],
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 walk", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/walk.cu",
         "replaces": "smithwaterman_tpu/ops/device_walk.py:220",
         "launches": launches["K2"], "max_abs_err": main_err["K2"],
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}
    say(json.dumps(kernels_line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
