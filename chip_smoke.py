#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``.  Imports nothing of
JAX and nothing of the JAX package.  Phases, one or more stdout lines each:

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. the builds: the hand-written CUDA kernels (``nvcc``, one process per
   source, started together) and the shared host library (``g++``), from
   the checkout's sources, with build seconds;
3. K1 (the fill kernel, a warp a pair) against its plain PyTorch version
   on the card: all three modes, traceback and score-only, ragged lengths
   down to 1, one 3685 x 3685 pair, a non-integer table and og = ge = 0.
   Every pair's pointer bytes and stats must be equal; K1's time on the
   3685 x 3685 pair alone (a block of a warp a stripe) is printed;
4. K2 (the walk kernel) against its plain version on K1's own pointers:
   move counts and packed moves must be equal; the longest walk's steps
   are printed;
5. the main path at a size users run: 3200 protein pairs, lengths uniform
   in 150..700, BLOSUM62, go = 10, ge = 0.5, through
   ``BatchAligner(device=dev)`` in all three modes plus one
   ``score_pairs``; a random 64-pair subset per mode must equal the CPU
   path exactly and every kernel must have launched; each mode's warm
   wall is printed beside the one measured with K1 a thread a pair, and
   the rows a lane R and warps a pair each K1 launch takes.  Then, per mode,
   each kernel runs at the main path's shapes (the same pairs, bucketed
   alike, every chunk in one launch) beside its plain version on the same
   inputs (K1's in GLOCAL and GLOBAL on every third chunk): every pair's
   pointer bytes and stats, every move count and move byte must be equal,
   and both are timed (K1 and K10 by their launches alone, inputs
   uploaded once; K2 by its launch alone and by a ``walk_packed`` call,
   with the longest walk's steps and their chain at SMEM_STEP_CYCLES a
   step);
6. the long-sequence kernels K3 (checkpointed fill), K4 (band refill) and
   K5 (segment walk) against their plain versions: 8 ragged pairs up to
   1024 x 1024 (lengths down to 1, one pair with tied maxima), all three
   modes, the default band height C and C = 64, K4 band by band and every
   band in one launch.  Stats, checkpoints, every band pointer byte, walk
   state, move count and move byte must be equal.  Then tables of 65 and
   300 symbols (read from device memory; int16 codes past 255): K1, K3,
   K4, K6 and K9 against their plain versions, and 12 pairs over the
   table's letters (past Latin-1 for 300) through ``BatchAligner`` on the
   card, ordinary and long route, equal to the CPU path in three modes;
7. the long route against the ordinary one: 16 protein pairs of 1500..4000
   residues a side through ``BatchAligner(device=dev,
   longseq_cells=1)`` and ``BatchAligner(device=dev)``, every field of
   every result equal, in all three modes;
8. the long route at a real size: 4 DNA pairs of 70,000 bp a side (each
   partner a mutated copy: 5 % substitutions, an indel of 1..20 every
   2000 positions), EDNAFULL's match/mismatch values (5 / -4) on ACGT,
   go = 10, ge = 0.5, default pointer budget, in all three modes.  Only
   K3, K4 and K5 may launch; each alignment re-scored from its strings
   must equal its score, GLOBAL and GLOCAL alignments must consume every
   residue and LOCAL ones reach 90 % identity; K5 launches once a group
   of bands (48 over the three modes).  Then K3 (LOCAL, its plain version
   beside it), K4 (one group of bands in one launch, one band alone, every
   band in the route's groups) and K5 (every group launch of a GLOBAL
   mode, each against the plain walk of the same bands from the same
   state) run at these shapes, equal and timed, with the SM clock read
   during K3;
9. the banded kernels K6 (scores), K7 (fill) and K8 (walk) against their
   plain versions: 8 ragged protein pairs up to 2048 a side (lengths down
   to 1, m - n from -300 to +300, one pair with tied maxima), bands of 128
   (the pairs with m <= n), 512 and 2048 (offsets all 0) in all three
   modes, GLOBAL with og = eg = 0 and LOCAL with a non-integer table.
   Every score, every pointer byte of each pair's rows i <= n, the stats,
   walk indices, counts and flags must be equal; K8 on random pointer
   bands of 8, 130 and 29,952 bytes a row (row starts off 16- and 4-byte
   alignment for its window copies, and a band read straight from device
   memory) must equal the plain walk in all three modes; a corrupted band
   must set flag bit 1 in both walks and make ``align_banded_batch`` raise
   ``BandExceeded``;
10. banded alignment at a real size: (a) 8 protein pairs of 12,000
   residues (mutated copies as in phase 8, over the 20 amino acids, from
   ``default_rng(42)``), BLOSUM62, go = 10, ge = 0.5, through
   ``align_banded_batch(band=512)`` in all three modes: one launch each of
   K6, K7 and K8 and none of K1-K5; every score must equal the full DP's
   (the long route), every alignment re-score to its score, GLOBAL and
   GLOCAL consume every residue; then K6, K7 and K8 at these shapes beside
   their plain versions, equal and timed, K6 also beside one PyTorch
   indexing expression; (b) a 32,768-residue pair and its mutated copy in
   LOCAL through the verified ``Aligner.align_banded(band=1024)``: the band
   used must be at most 2048, the score the full DP's, the trimmed
   strings must re-score to it at 85 % identity or more; cold and warm
   walls, peak device memory and ``phase_probe``'s stages are printed, and
   K6 and K7 at the verified band's launch are held against their plain
   versions (K6 timed beside its plain version, its byte bound and the
   indexing expression, as at 10a).  At 10a and 10b K6's tile plan (rows
   a tile, blocks, 16-byte stores) and K7's launch shape (rows a lane,
   stripes, blocks) are printed, and the phase fails if a pair's stripes
   ran on one block;
11. the opt-in routes' kernels against their plain versions: K9 (the
   wavefront score fill) on ragged pairs down to length 1 with NP not a
   multiple of the strip width, at (go, ge) = (10, 0.5), (0, 0) and (5, 2)
   and with a non-integer table, also against K1's score-only best, at the
   launcher's R and at every R columns a lane; K10
   (the fill with match-run bytes) on phase 3's inputs in all three modes,
   its pointer bytes and stats equal to K1's and its run bytes to the plain
   ones; K11 (the token walk) on K10's own pools.  All exact;
12. the opt-in routes at the main path's full width, each driven with the
   launch counts set to 0 just before it: (a) phase 5's 3200 pairs with
   ``SWTPU_TOKEN_WALK=1`` in all three modes, every result equal to phase
   5's, only K10 and K11 launching (not K1 or K2); warm wall, peak device
   memory, tokens against moves a pair, and K10 / K11 beside K1 / K2 and
   their plain versions at that flush (K11 by its launch alone and by a
   ``walk_tokens`` call, with its longest walk's chain); (b)
   ``BatchAligner(diag_scores=True).score_pairs`` on the same pairs in
   LOCAL, every score equal to phase 5's, only K9 launching; its warm wall
   beside phase 5's, and K9 beside K1's score-only fill (both by their
   launches alone) and its plain version (on every third chunk); (c)
   ``sweep.score_matrix``, a self-sweep
   of 400 such proteins (79,800 pairs, ``chunk_pairs`` 8192) through the
   wavefront route into a temporary file, cut to half its lines and
   resumed, equal to the matrix of the K1 route;
13. the striped kernels K12 (block fill) and K13 (single-device grid fill)
   against their plain versions, launch by launch: 3 ragged pairs of up to
   512 x 2048 (lengths down to 1), D = 1, 2, 4 shards on one card, three
   modes, block_rows 8 and 64, C = 64, each a checkpointed fill and a
   seeded band re-fill with pointer bytes; a non-integer table with
   og = -10.3, eg = -0.7; og = eg = 0; int8 and folded S at D = 1.  Stats,
   checkpoints, row state, outbox edges and pointer bytes all exact;
14. the striped path at a real size: one 2048 x 65,536 protein pair (the
   reference 65,536 random residues from ``default_rng(42)``, the query a
   mutated copy of its residues 30,000-32,047), BLOSUM62, go = 10,
   ge = 0.5, block_rows 64.  (a) ``striped_fill`` in three modes at D = 1
   (K13) and D = 4 on the one card (K12), and ``striped_fill_ckpt`` LOCAL
   at D = 4, each equal to K3's stats row on the same pair; (b)
   ``striped_align`` at D = 1 in three modes, its strings and score equal
   to ``BatchAligner(longseq_cells=1)``'s; only K12 and K13 launch in
   (a) and (b).  Then K12 and K13 beside their plain versions and their
   bounds at these shapes;
15. pair sharding, the web surface and the graft entry, each driven with
   the launch counts set to 0 just before each call: (a) phase 5's 3200
   pairs through ``BatchAligner(device="cuda",
   device_axis=DataParallel(make_mesh(devices=["cuda:0"] * 4)))`` in all
   three modes and a LOCAL ``score_pairs``: every result (strings, score,
   spans) of all 3200 pairs equal to phase 5's, only K1 and K2 launching
   (K1 alone for scores), K1 at least once and K2 once a shard a flush;
   (b) the same ``score_pairs`` with ``diag_scores=True``: only K9, every
   score equal to phase 5's; each warm wall (median of 3 calls) beside
   phase 5's; (d) the web surface (``web.Server`` on 127.0.0.1, port 0,
   on the card): ``GET /`` and one ``POST /align`` of two of phase 5's
   records against two, equal to ``web.align_request(..., device="cpu")``,
   K1 and K2 launched; (e) ``__graft_entry_torch__``: ``entry()``'s stats
   equal to the plain fill's, and ``dryrun_multichip(4)`` on the card
   repeated four times.  The multi-process rendezvous
   (``parallel/multihost``) is host-level gloo and is not driven here:
   NCCL needs a card a rank, and this runs on one card.

The last two stdout lines are the kernels' JSON record and the result
line; each kernel's ``max_abs_err`` is its comparison at its main path's
shapes (phase 5 for K1 and K2, phase 8 for K3-K5, phase 10a for K6-K8,
phase 12 for K9-K11, phase 14 for K12-K13),
its ``launches`` the
count from that path's run (K1, K2 and K9 also ``launches_sharded``, the
count from phase 15's warm calls), and ``bound_ms`` the least time the card could
take for the same work on this run's inputs (the larger of its f32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s).  Any failure raises
and exits non-zero without a result line; so does a machine without CUDA.
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
DNA_PAIRS, DNA_LEN = 4, 70000
# phase 10: (a) 8 protein pairs of 12,000 at band 512, (b) one of 32,768
BANDED_PAIRS, BANDED_LEN, BANDED_BAND = 8, 12000, 512
GIANT_LEN, GIANT_BAND = 32768, 1024
# f32 operations of one band cell of K7: sw::cell's 22-27 plus the
# normalisation of X's prefix (2) and the prefix's maximum (1)
BANDED_CELL_OPS = 30
# an H100 SXM's published peaks (f32 outside the tensor cores, HBM3)
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# f32 operations (adds, compares, maxima) one cell of sw_cell.cuh's cell()
# executes, common subexpressions counted once: M 5 (2 compares for its
# pointer, 2 maxima, 1 add), Y 8 (3 adds, 3 compares, 2 maxima; LOCAL 6:
# its value is selected, not maximised), X 9 (4 for the value, 2 adds and
# 3 compares for the pointer).  LOCAL adds 3 clamps at 0, 3 tests for a
# zero state and the running-best compare.
CELL_FLOPS = {0: 22, 1: 22, 2: 27}  # GLOBAL, GLOCAL, LOCAL
# integer operations of one walk step (state normalisation, address,
# shift, compares, moves), counted at the f32 rate for want of a
# published integer one
STEP_OPS = 12
# f32 operations of one cell of sw_diag.cuh's step(): 4 adds (W1 + og,
# Y1 + eg, X1 + eg in xpre, Wd + s), 7 maxima (T0, xpre, Y, M, two for W,
# the running best)
DIAG_CELL_FLOPS = 11
# cycles of one dependent shared-memory read on an H100 (the latency
# microbenchmarks of Hopper report, not measured here): K5's step chain
SMEM_STEP_CYCLES = 30
# integer operations of sw_cell.cuh's run_byte() a cell (field extraction
# 2, compares 5, the increment, the pack 2), counted at the f32 rate
RUN_OPS = 10
# integer operations of one token-walk step (walk_tokens_pair): a walk
# step's 12 plus the run byte's fields, the marker test and the jump
TOKEN_STEP_OPS = 18
SWEEP_SEQS, SWEEP_CHUNK = 400, 8192
# phase 15: shards of the pair-sharded path, all on the one card
SHARDS = 4
# phase 5's warm wall a mode with K1 one thread a pair (medians of 7 calls,
# scripts/measure_torch.py on one H100 80GB HBM3 at 700 W, PERF.md section 5)
THREAD_A_PAIR_WALL = {"local": 0.2455, "glocal": 0.2375, "global": 0.2523}
# phase 14: one 2048 x 65,536 protein pair, the query a mutated copy of the
# reference's residues 30,000-32,047 (the JAX package's single-chip striped
# shape, scripts/bench_suite.py:241)
STRIPED_NP, STRIPED_MP, STRIPED_AT = 2048, 65536, 30000
# f32 operations of one score-only striped cell (sw_striped.cuh): M 3 (2
# maxima, 1 add), Y 5 (3 adds, 2 maxima; LOCAL 2 adds, 2 maxima, 1 clamp),
# G 2, h 4 (the column's (jg-1)*pe: 1 subtract, 1 multiply; 1 subtract, the
# thread's running maximum), X 5 (2 maxima, 1 subtract, 1 multiply, 1 add);
# LOCAL adds the clamps of M and X and the running-best compare
STRIPED_CELL_OPS = {0: 19, 1: 19, 2: 22}  # GLOBAL, GLOCAL, LOCAL
# and with pointer bytes: M's 3 compares, Y's 3, X's 4 adds and 3 compares
# (LOCAL 3 more zero tests), the pack 3
STRIPED_TB_OPS = 16


def launch_counts(*kernels):
    """The port's launch counters (``launch.K1`` ...) of ``kernels``."""
    from smithwaterman_tpu_torch.utils import metrics

    return {k: metrics.counter("launch." + k) for k in kernels}


def reset_launches():
    """Zero the port's counters (and empty its log of traced calls)."""
    from smithwaterman_tpu_torch.utils import metrics

    metrics.reset()


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


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], stdout=subprocess.PIPE, text=True, check=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0])


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


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations' and the bytes'
    time at the card's peak rates."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def mutate(s1, rng, k, sub_rate=0.05, indel_every=2000, indel_max=20):
    """A mutated copy of the codes ``s1`` over ``k`` letters: 5 %
    substitutions, an indel of 1..20 every 2000 positions."""
    n = len(s1)
    out = []
    i = 0
    next_indel = indel_every
    while i < n:
        if i >= next_indel:
            next_indel += indel_every
            d = int(rng.integers(1, indel_max + 1))
            if rng.integers(0, 2):  # insertion into s2
                out.extend(rng.integers(0, k, size=d).tolist())
            else:  # deletion from s2
                i += d
                continue
        c = int(s1[i])
        if rng.random() < sub_rate:
            c = int(rng.integers(0, k))
        out.append(c)
        i += 1
    return out


def mutated_pair(n, rng, alphabet, sub_rate=0.05, indel_every=2000,
                 indel_max=20):
    """A random sequence of n letters of ``alphabet`` and a mutated copy of
    it (5 % substitutions, an indel of 1..20 every 2000 positions), as
    ``scripts/giant_pair_check.py`` ``make_pair`` builds protein pairs."""
    k = len(alphabet)
    s1 = rng.integers(0, k, size=n)
    out = mutate(s1, rng, k, sub_rate, indel_every, indel_max)
    return ("".join(alphabet[c] for c in s1),
            "".join(alphabet[c] for c in out))


def one_chunk(pairs, sm):
    """``pairs`` bucketed as ``BatchAligner`` buckets them, as one chunk
    (they must share a bucket)."""
    from smithwaterman_tpu_torch.batch_aligner import _Bucket
    from smithwaterman_tpu_torch.config import bucket_len

    bks = {}
    for a, b in pairs:
        key = (bucket_len(len(a)), bucket_len(len(b)))
        bk = bks.setdefault(key, _Bucket(*key))
        bk.indices.append(len(bk.indices))
        bk.codes1.append(sm.seq_to_index(a))
        bk.codes2.append(sm.seq_to_index(b))
    if len(bks) != 1:
        fail(f"{len(pairs)} pairs fell into {len(bks)} buckets")
    return next(iter(bks.values())).chunk(
        np.uint8 if len(sm.letters) <= 255 else np.int16)


def rescore(a1: str, a2: str, sm, og: float, eg: float, mode: int,
            local: int, glocal: int) -> float:
    """The score of an alignment under the mode's affine gap model: a gap
    run costs og + (len - 1) * eg (og, eg the negative penalties), a run
    of the other gap kind right after it opens anew; GLOCAL's terminal gap
    runs are free.  LOCAL strings are trimmed to their aligned core."""
    cols = [(x, y) for x, y in zip(a1, a2)]
    if mode == local:
        while cols and "-" in cols[0]:
            cols.pop(0)
        while cols and "-" in cols[-1]:
            cols.pop()
    pair = [k for k, (x, y) in enumerate(cols) if x != "-" and y != "-"]
    first, last = (pair[0], pair[-1]) if pair else (len(cols), -1)
    score, prev = 0.0, None
    for k, (x, y) in enumerate(cols):
        if x != "-" and y != "-":
            score += sm.get_score(sm.index_of(x), sm.index_of(y))
            prev = None
            continue
        kind = "x" if x == "-" else "y"
        if not (mode == glocal and (k < first or k > last)):
            score += eg if prev == kind else og
        prev = kind
    return score


def event_ms(fn):
    """CUDA-event time of one call of ``fn`` (ms) and its result."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def cpu_ms(fn, *tensors):
    """Host-clock time (ms) and result of ``fn`` on CPU copies of
    ``tensors``: the plain versions of K5 and K7 run on the CPU, where
    their thousands of small operations a row or a step cost less than as
    launches on the card (the same function on the same inputs)."""
    import torch

    args = [t.cpu() for t in tensors]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    return (time.perf_counter() - t0) * 1e3, out


def matches(moves, cnt):
    """Match moves (state 0) among each pair's first cnt packed moves
    (``ops/device_walk``'s packing: move t at bits 2 (t & 3) of byte
    t >> 2), summed over the pairs."""
    import torch

    states = torch.stack([(moves.long() >> (2 * q)) & 3 for q in range(4)],
                         dim=1).reshape(-1, moves.shape[1])
    t = torch.arange(states.shape[0], device=moves.device)[:, None]
    return int(((states == 0) & (t < cnt.long()[None, :])).sum())


def timed(fn, reps):
    """Mean CUDA-event time of ``reps`` back-to-back calls (ms) and the last
    result."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def queued_ms(fn, reps):
    """Mean CUDA-event time (ms) of ``reps`` calls of ``fn`` queued behind
    a device sleep, and the last result: the host enqueues every call
    before the first starts, so the device's time alone is measured, not
    the host's per call (for kernels of tens of microseconds)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def k6_library(tab, c1, c2, n, m, W):
    """K6's library yardstick: the time (ms, mean of 3) and result of one
    indexing expression over the codes, with the band's columns and mask
    (geometry, no codes) computed beforehand."""
    import torch

    from smithwaterman_tpu_torch.ops import banded

    B, NP = c1.shape
    cols = (banded.row_offsets(n, m, W, NP)[:, 1:, None]
            + torch.arange(W, device=tab.device))
    valid = cols < m.to(torch.int64)[:, None, None]
    colc = torch.minimum(cols, (m.to(torch.int64) - 1)[:, None, None])
    del cols
    bidx = torch.arange(B, device=tab.device)[:, None, None]
    l1, l2 = c1.to(torch.int64), c2.to(torch.int64)
    return timed(lambda: torch.where(
        valid, tab[l1[:, :, None], l2[bidx, colc]], 0.0), 3)


def relaunch(tab, chunks, got, **args):
    """A function that refills ``got`` (a ``fill_dp.fill_many`` result on
    the card, with run bytes or not) by ``fill_dp.launch``, the launches of
    K1 (K10) that ``fill_many`` makes, its plan and inputs uploaded once:
    the kernels' time without the host's uploads.  These launches are not
    counted."""
    import torch

    from smithwaterman_tpu_torch.ops import fill_dp

    dev = tab.device
    codes1, codes2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(dev)
        for f in ("codes1", "codes2"))
    carry = torch.empty(fill_dp.layout(chunks)[3], dtype=torch.float32,
                        device=dev)
    pools = 0 if got.tb is None else 1 if got.run is None else 2
    plan = fill_dp.device_plan(chunks, pools, dev)

    def run():
        fill_dp.launch(plan, tab, codes1, codes2, got.desc, got.tb, carry,
                       got.stats, traceback=got.tb is not None, run=got.run,
                       **args)
        return got

    return run


def walk_launch(got, mode, L, tokens=False):
    """A function that launches K2 (K11 with ``tokens``) through
    ``kernels.walk`` (``kernels.walk_tokens``) over the fill ``got`` at
    ``device_walk.TILES``' tiles, its pairs in the fill's order, into
    outputs allocated once: the kernel's launch alone.  These launches are
    not counted; run() returns (cnt, moves or toks)."""
    import torch

    from smithwaterman_tpu_torch import LOCAL
    from smithwaterman_tpu_torch.ops import device_walk, kernels

    B = got.desc.shape[0]
    dev = got.desc.device
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    out = torch.zeros((L, B) if tokens else (-(-L // 4), B),
                      dtype=torch.uint8, device=dev)
    T, C = device_walk.TILES[2 if tokens else 1]
    kw = dict(local=mode == LOCAL, L=L, order=got.order, T=T, C=C)

    def run():
        if tokens:
            kernels.walk_tokens(got.tb, got.run, got.desc, got.stats, cnt,
                                out, **kw)
        else:
            kernels.walk(got.tb, got.desc, got.stats, cnt, out, **kw)
        return cnt, out

    return run


def walk_by_launch(got, mode, L, ref, walk_err, what, tokens=False):
    """K2 (K11) over the fill ``got`` timed by its launch alone (mean of 10
    after one) and held against the plain walk's ``ref``: ms."""
    run = walk_launch(got, mode, L, tokens)
    run()
    ms, out = timed(run, 10)
    err = walk_err(out, ref)
    if err != 0.0:
        fail(f"{what} by its launch: differs from the plain walk "
             f"(max error {err})")
    return ms


def k9_relaunch(tab, chunks, R, og, eg):
    """A function that launches K9 (``kernels.diag_fill``, R columns a
    lane) on ``chunks``, the launch ``diag_dp.fill_diag`` makes, its
    descriptors and codes uploaded once: the kernel's time without the
    host's layout and uploads.  Returns (run, stats); these launches are
    not counted."""
    import torch

    from smithwaterman_tpu_torch.ops import diag_dp, kernels

    dev = tab.device
    desc, floats = diag_dp.layout(chunks)
    desc = torch.from_numpy(desc).to(dev)
    codes1, codes2 = (torch.from_numpy(np.concatenate(
        [getattr(ch, f).ravel() for ch in chunks])).to(dev)
        for f in ("codes1", "codes2"))
    scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    stats = torch.empty((desc.shape[0], 8), dtype=torch.float32, device=dev)

    def run():
        kernels.diag_fill(tab, codes1, codes2, desc, scratch, stats, og=og,
                          eg=eg, R=R)
        return stats

    return run


PHASE9_LENGTHS = ((2048, 1748), (1, 5), (1500, 1800), (700, 640),
                  (1234, 1234), (2000, 2048), (300, 600), (1600, 1600))


def phase9_pairs(rng):
    """Phase 9's 8 protein code pairs: similar pairs (each seq2 a shifted
    copy of seq1 with 8 % substitutions) of PHASE9_LENGTHS, m - n from
    -300 to +300, lengths down to 1; the last one a 60-residue motif
    repeated down seq1 and once in seq2: tied LOCAL maxima."""
    pairs = []
    for n, m in PHASE9_LENGTHS:
        base = rng.integers(0, 20, size=n + m + 10)
        c2 = base[7:7 + m].copy()
        hit = rng.random(m) < 0.08
        c2[hit] = rng.integers(0, 20, size=int(hit.sum()))
        pairs.append((base[:n].copy(), c2))
    c1, c2 = pairs[-1]
    for r in range(100, len(c1) - 60, 150):
        c1[r:r + 60] = c1[:60]
    q = len(c2) // 4
    c2[q:q + 60] = c1[:60]
    return pairs


def phase9(dev, card, modes):
    """K6, K7 and K8 against their plain versions on the card; returns the
    summed kernel / plain milliseconds per kernel."""
    import torch

    from smithwaterman_tpu_torch import GLOBAL, LOCAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import banded

    blosum = np.asarray(SubstitutionMatrix.blosum62().table, np.float32)
    pairs = phase9_pairs(np.random.default_rng(SEED + 9))
    narrow = [p for p, (n, m) in zip(pairs, PHASE9_LENGTHS) if m <= n]
    cases = [(mode, mname, band, sub, blosum, -10.0, -0.5)
             for mode, mname in modes
             for band, sub in ((128, narrow), (512, pairs), (2048, pairs))]
    cases += [(GLOBAL, "global og=eg=0", 512, pairs, blosum, 0.0, 0.0),
              (LOCAL, "local blosum62*0.5", 512, pairs,
               blosum * np.float32(0.5), -10.0, -0.5)]
    sums = {"K6": [0.0, 0.0], "K7": [0.0, 0.0], "K8": [0.0, 0.0]}
    widths = set()
    for mode, mname, band, sub, table, og, eg in cases:
        pk = banded.pack(sub, band, table.shape[0])
        widths.add(pk.W)
        tab = torch.from_numpy(table).to(dev)
        c1, c2, n, m = (torch.from_numpy(a).to(dev)
                        for a in (pk.codes1, pk.codes2, pk.n, pk.m))
        what = f"{mname} W={pk.W}"
        ms, S = event_ms(lambda: banded.banded_scores(tab, c1, c2, n, m,
                                                      W=pk.W))
        pms, rS = event_ms(lambda: banded.banded_scores_ref(
            tab, c1, c2, n, m, W=pk.W))
        sums["K6"][0] += ms
        sums["K6"][1] += pms
        if not torch.equal(S, rS):
            fail(f"K6 {what}: differs from the plain scores")
        kw = dict(mode=mode, og=og, eg=eg)
        ms, (tb, st) = event_ms(lambda: banded.fill_banded(S, n, m, **kw))
        pms, (rtb, rst) = cpu_ms(
            lambda *a: banded.fill_banded_ref(*a, **kw), S, n, m)
        sums["K7"][0] += ms
        sums["K7"][1] += pms
        if k7_diff(tb.cpu(), st.cpu(), rtb, rst, pk.n) != 0.0:
            fail(f"K7 {what}: stats or pointer bytes differ from the plain "
                 "fill")
        start, _ = banded.walk_starts(st.cpu().numpy(), pk, mode)
        off, start = (torch.from_numpy(a).to(dev) for a in (pk.offs, start))
        L = banded.path_len(pk)
        wk = dict(local=mode == LOCAL, L=L)
        ms, got = event_ms(lambda: banded.walk_banded_device(tb, off, start,
                                                             m, **wk))
        pms, want = event_ms(lambda: banded.walk_banded_ref(tb, off, start,
                                                            m, **wk))
        sums["K8"][0] += ms
        sums["K8"][1] += pms
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"K8 {what}: walk differs from the plain walk")
        if int(got[2].max()) == 0:
            fail(f"K8 {what}: no steps at all")
    # a corrupted band: every pointer says "gap in seq1", so each walk whose
    # band starts past column 0 at row n runs left out of it
    pk = banded.pack(narrow, 128, blosum.shape[0])
    tab = torch.from_numpy(blosum).to(dev)
    c1, c2, n, m = (torch.from_numpy(a).to(dev)
                    for a in (pk.codes1, pk.codes2, pk.n, pk.m))
    tb, st = banded.fill_banded(banded.banded_scores(tab, c1, c2, n, m,
                                                     W=pk.W), n, m,
                                mode=GLOBAL, og=-10.0, eg=-0.5)
    bad = torch.full_like(tb, 0x15)
    start = torch.from_numpy(banded.walk_starts(st.cpu().numpy(), pk,
                                                GLOBAL)[0]).to(dev)
    off = torch.from_numpy(pk.offs).to(dev)
    wk = dict(local=False, L=banded.path_len(pk))
    flags = banded.walk_banded_device(bad, off, start, m, **wk)[3]
    rflags = banded.walk_banded_ref(bad, off, start, m, **wk)[3]
    past0 = torch.from_numpy(pk.offs[np.arange(len(pk.n)), pk.n] > 0)
    if not (bool(past0.any()) and bool((flags.cpu()[past0] & 2).all())
            and torch.equal(flags, rflags)):
        fail(f"corrupted band: flags {flags.tolist()} / plain "
             f"{rflags.tolist()}, expected bit 1 where {past0.tolist()}")
    # K8 on random pointer bands of any width: rows off 16- and 4-byte
    # alignment (8, 130: the window copies' end pieces) and past the
    # window ring's shared memory (29,952: direct reads)
    odd = []
    for W in (8, 130, 29952):
        for mode, mname in modes:
            tb, off, start, m, L = banded.random_band(
                np.random.default_rng(SEED + W + mode), W, mode == LOCAL)
            tb, off, start, m = (torch.from_numpy(a).to(dev)
                                 for a in (tb, off, start, m))
            wk = dict(local=mode == LOCAL, L=L)
            got = banded.walk_banded_device(tb, off, start, m, **wk)
            want = banded.walk_banded_ref(tb, off, start, m, **wk)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"K8 {mname} random band W={W}: walk differs from the "
                     "plain walk")
            odd.append(int(got[2].sum()))
    real_fill = banded.fill_banded

    def corrupted(*a, **k):
        tb, st = real_fill(*a, **k)
        return torch.full_like(tb, 0x15), st

    banded.fill_banded = corrupted
    try:
        banded.align_banded_batch(narrow, blosum, mode=GLOBAL, og=-10.0,
                                  eg=-0.5, band=128, device=dev)
        fail("align_banded_batch on a corrupted band did not raise")
    except banded.BandExceeded:
        pass
    finally:
        banded.fill_banded = real_fill
    say(f"phase 9 K6/K7/K8: {len(cases)} cases (3 modes x W in "
        f"{sorted(widths)}, GLOBAL og=eg=0, LOCAL blosum62*0.5), "
        f"{len(pairs)} pairs of up to 2048 a side: every score, every "
        "pointer byte of rows i <= n, stats, indices, counts and flags equal "
        "to the plain versions; K8 on random bands of W 8, 130 and 29,952 "
        f"in each mode ({sum(odd)} steps) equal to the plain walk; a "
        "corrupted band sets flag bit 1 in both "
        "walks and align_banded_batch raises BandExceeded; summed ms kernel "
        "/ plain (K7's on the CPU): " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                                for k, v in sums.items()) + f"; on {card}")
    return sums


def k7_diff(tb, st, rtb, rst, n):
    """Largest |difference| of two banded fills' stats and pointer bytes in
    each pair's rows i <= n."""
    err = float((st - rst).abs().max())
    for b, x in enumerate(n.tolist()):
        err = max(err, float((tb[b, :x].int() - rtb[b, :x].int())
                             .abs().max()))
    return err


def trimmed_core(a1: str, a2: str):
    """A LOCAL alignment's columns without its terminal gap columns."""
    core = list(zip(a1, a2))
    while core and "-" in core[0]:
        core.pop(0)
    while core and "-" in core[-1]:
        core.pop()
    return core


def phase10(dev, card, modes):
    """Banded alignment at a real size: (a) 8 protein pairs of 12,000
    residues through ``align_banded_batch`` in every mode, against the full
    DP of the long route, then K6/K7/K8 beside their plain versions at
    these shapes; (b) one 32,768-residue pair through the verified
    ``Aligner.align_banded``.  Returns the kernels' records."""
    import torch

    from smithwaterman_tpu_torch import GLOBAL, GLOCAL, LOCAL, Aligner
    from smithwaterman_tpu_torch import BatchAligner
    from smithwaterman_tpu_torch.aligner import reconstruct_alignment
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import (banded, device_walk, fill_dp,
                                             longseq)
    from smithwaterman_tpu_torch.utils.calc_score import recalc_score

    reset = reset_launches

    def counts():
        return launch_counts("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")

    sm = SubstitutionMatrix.blosum62()
    table = np.asarray(sm.table, np.float32)
    og, eg = -10.0, -0.5
    rng = np.random.default_rng(SEED)
    pairs = [mutated_pair(BANDED_LEN, rng, LETTERS)
             for _ in range(BANDED_PAIRS)]
    codes = [(sm.seq_to_index(a), sm.seq_to_index(b)) for a, b in pairs]
    launches = {"K6": 0, "K7": 0, "K8": 0}
    for mode, mname in modes:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = banded.align_banded_batch(codes, table, mode=mode, og=og, eg=eg,
                                        band=BANDED_BAND, device=dev)
        wall = time.perf_counter() - t0
        c = counts()
        if any(c[k] != 1 for k in launches) or any(
                c[k] for k in ("K1", "K2", "K3", "K4", "K5")):
            fail(f"phase 10 {mname}: launches {c}")
        for k in launches:
            launches[k] += c[k]
        t0 = time.perf_counter()
        full = BatchAligner(mode=mode, device=dev,
                            longseq_cells=1).align_pairs(pairs)
        t_full = time.perf_counter() - t0
        same = 0
        for k, ((a, b), (i1, i2, score, _), f) in enumerate(
                zip(pairs, res, full)):
            if score != f.score:
                fail(f"phase 10 {mname} pair {k}: banded score {score}, "
                     f"full DP {f.score}")
            r = reconstruct_alignment(a, b, i1, i2, score, True, mode)
            same += (r.aligned1, r.aligned2) == (f.aligned1, f.aligned2)
            if rescore(r.aligned1, r.aligned2, sm, og, eg, mode, LOCAL,
                       GLOCAL) != score:
                fail(f"phase 10 {mname} pair {k}: does not re-score to "
                     f"{score}")
            if mode != LOCAL and (r.aligned1.replace("-", ""),
                                  r.aligned2.replace("-", "")) != (a, b):
                fail(f"phase 10 {mname} pair {k}: residues lost")
        edges = sum(e for *_, e in res)
        say(f"phase 10a {mname}: {BANDED_PAIRS} protein pairs of "
            f"{BANDED_LEN} (m {[len(b) for _, b in pairs]}), band "
            f"{BANDED_BAND}: align_banded_batch wall {wall:.4f} s, "
            f"launches {json.dumps(c)}; every score equals the full DP's "
            f"(long route, {t_full:.3f} s), {same} of {BANDED_PAIRS} "
            f"alignment strings equal its strings, every alignment "
            f"re-scores to its score; {edges} edge-touched; on {card}")

    # where a LOCAL batch's time goes: one more call, the card synchronised
    # between its stages
    stages = {}
    banded.align_banded_batch(codes, table, mode=LOCAL, og=og, eg=eg,
                              band=BANDED_BAND, device=dev, timings=stages)
    say("phase 10a local stages (align_banded_batch timings): "
        + json.dumps(stages))

    # K6, K7 and K8 at these shapes beside their plain versions (LOCAL)
    pk = banded.pack(codes, BANDED_BAND, table.shape[0])
    tab = torch.from_numpy(table).to(dev)
    c1, c2, n, m = (torch.from_numpy(a).to(dev)
                    for a in (pk.codes1, pk.codes2, pk.n, pk.m))
    B, NP = pk.codes1.shape
    W = pk.W
    banded.banded_scores(tab, c1, c2, n, m, W=W)
    k6_ms, S = queued_ms(lambda: banded.banded_scores(tab, c1, c2, n, m,
                                                      W=W), 20)
    k6_shape = dict(banded.SHAPES["K6"])
    k6_plain_ms, rS = event_ms(lambda: banded.banded_scores_ref(
        tab, c1, c2, n, m, W=W))
    k6_err = float((S - rS).abs().max())
    del rS
    lib_ms, lS = k6_library(tab, c1, c2, n, m, W)
    if not torch.equal(lS, S):
        fail("K6's library yardstick computes another function")
    del lS
    kw = dict(mode=LOCAL, og=og, eg=eg)
    banded.fill_banded(S, n, m, **kw)
    k7_ms, (tb, st) = timed(lambda: banded.fill_banded(S, n, m, **kw), 3)
    k7_shape = dict(banded.SHAPES["K7"])
    k7_plain_ms, (rtb, rst) = cpu_ms(
        lambda *a: banded.fill_banded_ref(*a, **kw), S, n, m)
    k7_err = k7_diff(tb.cpu(), st.cpu(), rtb, rst, pk.n)
    del rtb
    if k7_shape["blocks"] <= B:
        fail(f"phase 10a: a pair's stripes on one block: K7 {k7_shape}")
    start, _ = banded.walk_starts(st.cpu().numpy(), pk, LOCAL)
    off, start = (torch.from_numpy(a).to(dev) for a in (pk.offs, start))
    L = banded.path_len(pk)
    wk = dict(local=True, L=L)
    k8_ms, got = timed(lambda: banded.walk_banded_device(tb, off, start, m,
                                                         **wk), 3)
    k8_rows = banded.SHAPES["K8"]["rows"]
    k8_plain_ms, want = event_ms(lambda: banded.walk_banded_ref(
        tb, off, start, m, **wk))
    k8_err = max(float((g.long() - w.long()).abs().max())
                 for g, w in zip(got, want))
    if max(k6_err, k7_err, k8_err) != 0.0:
        fail(f"phase 10 kernels against plain: max errors K6 {k6_err}, K7 "
             f"{k7_err}, K8 {k8_err}")
    steps = int(got[2].sum())
    cells = int(pk.n.sum()) * W
    code_bytes = int(pk.n.sum() + pk.m.sum())
    k6_bound = bound(0, code_bytes + 4 * B * NP * W)
    k7_bound = bound(BANDED_CELL_OPS * cells, 5 * cells + 32 * B)
    k8_bound = bound(STEP_OPS * steps, 8 * B * L + 5 * steps + 28 * B)
    say(f"phase 10a kernels at these shapes ({B} pairs, NP={NP}, W={W}, "
        f"LOCAL) on {card}: K6 {k6_ms:.4f} ms by its queued launches "
        f"({k6_shape['rows']} rows a tile, {k6_shape['blocks']} blocks, "
        f"16-byte stores {k6_shape['vec']}) vs plain {k6_plain_ms:.3f} ms "
        f"vs one indexing expression {lib_ms:.4f} ms, bound "
        f"{k6_bound[0]:.4f} ms; K7 {k7_ms:.3f} ms ({cells} band cells, "
        f"{k7_ms * 1e6 / NP:.1f} ns a band row; R {k7_shape['rows']}, "
        f"{k7_shape['stripes']} stripes, {k7_shape['blocks']} blocks) vs "
        f"plain (CPU) {k7_plain_ms:.3f} ms, bound {k7_bound[0]:.4f} ms; K8 "
        f"{k8_ms:.4f} ms ({steps} steps, {k8_ms * 1e6 / steps * B:.1f} ns a "
        f"step of a pair's walk; {k8_rows} rows a window) vs "
        f"plain {k8_plain_ms:.3f} ms, bound {k8_bound[0]:.6f} ms; all equal "
        "to the plain versions")
    del S, tb, got, want

    # (b) the giant pair, LOCAL, through the verified Aligner
    s1, s2 = mutated_pair(GIANT_LEN, np.random.default_rng(SEED), LETTERS)
    al = Aligner(mode=LOCAL, device=dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = al.align_banded(s1, s2, band=GIANT_BAND)
    cold = time.perf_counter() - t0
    gcounts = counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r2 = al.align_banded(s1, s2, band=GIANT_BAND)
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    a, b = sm.seq_to_index(s1), sm.seq_to_index(s2)
    *_, vscore, band_used = banded.align_banded_verified(
        a, b, table, mode=LOCAL, og=og, eg=eg, band=GIANT_BAND, device=dev)
    if (r2.aligned1, r2.aligned2, r2.score) != (r.aligned1, r.aligned2,
                                                r.score) or vscore != r.score:
        fail("phase 10b: repeated banded alignments differ")
    if band_used > 2 * GIANT_BAND:
        fail(f"phase 10b: verified only at band {band_used}")
    t0 = time.perf_counter()
    full = BatchAligner(mode=LOCAL, device=dev,
                        longseq_cells=1).align_pairs([(s1, s2)])[0]
    t_full = time.perf_counter() - t0
    if full.score != r.score:
        fail(f"phase 10b: banded score {r.score}, full DP {full.score}")
    core = trimmed_core(r.aligned1, r.aligned2)
    rc = recalc_score("".join(x for x, _ in core),
                      "".join(y for _, y in core), sm, -og, -eg)
    ident = sum(x == y for x, y in core) / max(len(core), 1)
    if rc != r.score or ident < 0.85:
        fail(f"phase 10b: recalc_score {rc} vs {r.score}, identity "
             f"{ident:.4f}")
    probes = {w: banded.phase_probe(a, b, table, mode=LOCAL, og=og, eg=eg,
                                    band=w, device=dev)
              for w in sorted({GIANT_BAND, band_used})}
    # K7 at the verified band's launch against its plain version
    gp = banded.pack([(a, b)], band_used, table.shape[0])
    g1, g2, gn, gm = (torch.from_numpy(x).to(dev)
                      for x in (gp.codes1, gp.codes2, gp.n, gp.m))
    gS = banded.banded_scores(tab, g1, g2, gn, gm, W=gp.W)
    # K6 at the verified band's launch beside its plain version, its byte
    # bound and the indexing expression
    gk6_ms, gS = queued_ms(lambda: banded.banded_scores(tab, g1, g2, gn, gm,
                                                        W=gp.W), 20)
    gk6_shape = dict(banded.SHAPES["K6"])
    gk6_plain_ms, grS = event_ms(lambda: banded.banded_scores_ref(
        tab, g1, g2, gn, gm, W=gp.W))
    gk6_err = float((gS - grS).abs().max())
    del grS
    glib_ms, glS = k6_library(tab, g1, g2, gn, gm, gp.W)
    if not torch.equal(glS, gS):
        fail("phase 10b: K6's library yardstick computes another function")
    del glS
    if gk6_err != 0.0:
        fail(f"phase 10b: K6 at W={gp.W} differs from the plain scores by "
             f"{gk6_err}")
    gk6_bound = bound(0, int(gp.n.sum() + gp.m.sum())
                      + 4 * gp.codes1.size * gp.W)
    banded.fill_banded(gS, gn, gm, **kw)
    gk7_ms, (gtb, gst) = timed(lambda: banded.fill_banded(gS, gn, gm, **kw),
                               3)
    g_shape = dict(banded.SHAPES["K7"])
    gk7_plain_ms, (grtb, grst) = cpu_ms(
        lambda *a: banded.fill_banded_ref(*a, **kw), gS, gn, gm)
    gk7_err = k7_diff(gtb.cpu(), gst.cpu(), grtb, grst, gp.n)
    del gS, gtb, grtb
    if gk7_err != 0.0:
        fail(f"phase 10b: K7 at W={gp.W} differs from the plain fill by "
             f"{gk7_err}")
    if g_shape["blocks"] <= 1:
        fail(f"phase 10b: the pair's stripes on one block: K7 {g_shape}")
    say(f"phase 10b: {len(s1)} x {len(s2)} protein pair, LOCAL, verified "
        f"Aligner.align_banded(band={GIANT_BAND}): score {r.score} equal to "
        f"the full DP's (long route, {t_full:.3f} s; strings "
        f"{'equal' if (r.aligned1, r.aligned2) == (full.aligned1, full.aligned2) else 'differ'}"
        f"), band_used {band_used}, recalc_score of the trimmed strings "
        f"{rc}, identity {ident:.4f}; cold wall {cold:.4f} s (launches "
        f"{json.dumps(gcounts)}), warm wall {warm:.4f} s, peak device memory "
        f"{peak / 1e9:.3f} GB; phase_probe " + json.dumps(
            {str(w): p for w, p in probes.items()}) + f"; K6 at W={gp.W} "
        f"{gk6_ms:.4f} ms by its queued launches ({gk6_shape['rows']} rows "
        f"a tile, {gk6_shape['blocks']} blocks) vs plain {gk6_plain_ms:.3f} "
        f"ms vs one indexing expression {glib_ms:.4f} ms, bound "
        f"{gk6_bound[0]:.4f} ms, equal; K7 at W={gp.W} "
        f"{gk7_ms:.3f} ms ({gk7_ms * 1e6 / gp.codes1.shape[1]:.1f} ns a band "
        f"row; R {g_shape['rows']}, {g_shape['stripes']} stripes, "
        f"{g_shape['blocks']} blocks) vs plain (CPU) {gk7_plain_ms:.3f} ms, "
        f"equal; on {card}")

    out = []
    for name, src, repl, k, err, ms, pms, bd, lib in (
            ("K6 banded scores", "banded_scores.cu",
             "smithwaterman_tpu/ops/banded.py:585", "K6", k6_err, k6_ms,
             k6_plain_ms, k6_bound, lib_ms),
            ("K7 banded fill", "banded_fill.cu",
             "smithwaterman_tpu/ops/banded.py:286", "K7", k7_err, k7_ms,
             k7_plain_ms, k7_bound, None),
            ("K8 banded walk", "banded_walk.cu",
             "smithwaterman_tpu/ops/banded.py:413", "K8", k8_err, k8_ms,
             k8_plain_ms, k8_bound, None)):
        out.append({
            "name": name, "route": "cuda",
            "source": f"smithwaterman_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches[k], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bd[0], "bound_by": bd[1],
            "library_ms": lib})
    return out

def phase11(dev, card, modes, cases, ragged, pair_masks, fill_err, walk_err):
    """K9, K10 and K11 against their plain versions on the card."""
    import torch

    from smithwaterman_tpu_torch import LOCAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import batch, device_walk, diag_dp
    from smithwaterman_tpu_torch.ops import fill_dp

    blosum = np.asarray(SubstitutionMatrix.blosum62().table, np.float32)
    rng = np.random.default_rng(SEED + 11)
    B, NP, MP = 40, 300, 210   # NP and MP not multiples of the strip width
    odd = batch.Chunk(rng.integers(0, 20, size=(B, NP)).astype(np.uint8),
                      rng.integers(0, 20, size=(B, MP)).astype(np.uint8),
                      rng.integers(1, NP + 1, size=B).astype(np.int32),
                      rng.integers(1, MP + 1, size=B).astype(np.int32))
    odd.n[:4], odd.m[:4] = (1, NP, 1, 77), (MP, 1, 1, 32)
    odd.codes2[4, 20:180] = odd.codes1[4, 50:210]
    odd.n[4], odd.m[4] = NP, MP
    # a stretch from row 0 across the first strip boundary (column 31)
    odd.codes1[5, :60] = 18
    odd.codes2[5, 31:91] = 18
    odd.n[5], odd.m[5] = NP, MP
    sums = {"K9": [0.0, 0.0], "K10": [0.0, 0.0], "K11": [0.0, 0.0]}
    n9 = longest = 0
    for table, tname in ((blosum, "blosum62"),
                         (blosum * np.float32(0.5), "blosum62*0.5")):
        tab = torch.from_numpy(table).to(dev)
        for og, eg in ((-10.0, -0.5), (0.0, 0.0), (-5.0, -2.0)):
            chunks = ragged + [odd]
            ms, got = event_ms(lambda: diag_dp.fill_diag(tab, chunks, og=og,
                                                         eg=eg))
            pms, ref = event_ms(lambda: torch.cat([diag_dp.fill_diag_ref(
                tab, *(torch.from_numpy(a).to(dev) for a in ch), og=og,
                eg=eg) for ch in chunks]))
            sums["K9"][0] += ms
            sums["K9"][1] += pms
            k1 = fill_dp.fill_many(tab, chunks, mode=LOCAL, og=og, eg=eg,
                                   score_only=True)
            if not (torch.equal(got, ref) and torch.equal(got, k1.stats)):
                fail(f"K9 {tname} og={og} eg={eg}: best scores differ from "
                     "the plain wavefront or K1's score-only fill")
            # every R columns a lane, forced for one launch each
            real = diag_dp.lane_cols
            try:
                for R in diag_dp.LANE_COLS:
                    diag_dp.lane_cols = lambda MP, R=R: R
                    if not torch.equal(diag_dp.fill_diag(tab, chunks, og=og,
                                                         eg=eg), ref):
                        fail(f"K9 R={R} {tname} og={og} eg={eg}: best "
                             "scores differ from the plain wavefront")
            finally:
                diag_dp.lane_cols = real
            n9 += 1
    for name, chunks, table, og, eg in cases:
        tab = torch.from_numpy(np.ascontiguousarray(table)).to(dev)
        masks = pair_masks(chunks)
        for mode, mname in modes:
            args = dict(mode=mode, og=og, eg=eg)
            k1 = fill_dp.fill_many(tab, chunks, **args)
            ms, got = event_ms(lambda: fill_dp.fill_many(tab, chunks,
                                                         runs=True, **args))
            err, bad = fill_err(got, k1, masks)
            runs = fill_dp.Filled(got.run, got.stats, got.desc, got.shapes,
                                  got.tb_base)
            plain = fill_dp.Filled(torch.empty_like(got.run), got.stats,
                                   got.desc, got.shapes, got.tb_base)
            pms, _ = event_ms(lambda: [
                plain.tb_view(c).copy_(fill_dp.run_bytes_ref(got.tb_view(c)))
                for c in range(len(chunks))])
            sums["K10"][0] += ms
            sums["K10"][1] += pms
            if err != 0.0 or bad or not torch.equal(got.stats, k1.stats):
                fail(f"K10 {name} {mname}: pointer bytes or stats differ "
                     f"from K1's ({bad} bytes, max error {err})")
            rerr, rbad = fill_err(runs, plain, masks)
            if rerr != 0.0 or rbad:
                fail(f"K10 {name} {mname}: {rbad} run bytes differ from the "
                     "plain ones")
            L = max(device_walk.max_path_len(NP_, MP_)
                    for _, NP_, MP_ in got.shapes)
            ms, out = event_ms(lambda: device_walk.walk_tokens(
                got.tb, got.run, got.desc, got.stats, mode=mode, L=L,
                order=got.order))
            pms, rout = event_ms(lambda: device_walk.walk_tokens_ref(
                got.tb, got.run, got.desc, got.stats, mode=mode, L=L))
            sums["K11"][0] += ms
            sums["K11"][1] += pms
            if walk_err(out, rout) != 0.0 or int(out[0].max()) == 0:
                fail(f"K11 {name} {mname}: tokens differ from the plain "
                     "token walk, or none at all")
            longest = max(longest, int(out[0].max()))
        del masks
    say(f"phase 11 K9: {n9} cases (2 tables x (go, ge) in (10, 0.5), (0, 0), "
        f"(5, 2); phase 3's ragged chunks and {B} pairs of up to {NP} x {MP}, "
        "lengths down to 1), at the launcher's R and at R in "
        f"{list(diag_dp.LANE_COLS)} columns a lane, equal to the plain "
        "wavefront and to K1's "
        f"score-only best; K10 and K11: {len(cases)} cases x 3 modes, "
        "pointer bytes and stats equal to K1's, run bytes to the plain ones, "
        "tokens to the plain token walk (K11's tiles (T, C) "
        f"{device_walk.TILES[2]}; longest walk {longest} tokens); "
        "summed ms kernel / plain: "
        + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in sums.items())
        + f"; on {card}")


def phase12(dev, card, modes, pairs, chunks, results, scores, walls,
            walk_steps, times, pair_masks, fill_err, walk_err):
    """The opt-in routes at the main path's full width; returns the K9,
    K10 and K11 records."""
    import os
    import tempfile

    import torch

    from smithwaterman_tpu_torch import LOCAL, BatchAligner
    from smithwaterman_tpu_torch import sweep as swp
    from smithwaterman_tpu_torch.io.fasta import SeqData
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import (batch, device_walk, diag_dp,
                                             fill_dp, longseq)

    reset = reset_launches

    def counts():
        return launch_counts("K1", "K2", "K9", "K10", "K11", "K3", "K4",
                             "K5")

    def same(a, b):
        return (a.aligned1, a.aligned2, a.score, a.start1, a.end1, a.start2,
                a.end2) == (b.aligned1, b.aligned2, b.score, b.start1,
                            b.end1, b.start2, b.end2)

    og, eg = -10.0, -0.5
    tab = torch.from_numpy(np.asarray(SubstitutionMatrix.blosum62().table,
                                      np.float32)).to(dev)
    true_cells = sum(len(a.seq) * len(b.seq) for a, b in pairs)
    code_bytes = sum(len(a.seq) + len(b.seq) for a, b in pairs)
    nflush = len(batch.plan_flushes(chunks, batch.tb_budget(), False,
                                    runs=True))

    # (a) the token walk through BatchAligner, all three modes
    launches = {"K9": 0, "K10": 0, "K11": 0}
    os.environ["SWTPU_TOKEN_WALK"] = "1"
    try:
        for mode, mname in modes:
            eng = BatchAligner(mode=mode, device="cuda")
            eng.align_pairs(pairs)            # cold
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()   # earlier phases' tensors
            reset()
            t0 = time.perf_counter()
            res = eng.align_pairs(pairs)
            wall = time.perf_counter() - t0
            c = counts()
            peak = torch.cuda.max_memory_allocated() - held
            if c["K10"] == 0 or c["K11"] == 0 or any(
                    c[k] for k in ("K1", "K2", "K3", "K4", "K5", "K9")):
                fail(f"phase 12a {mname}: launches {c}")
            launches["K10"] += c["K10"]
            launches["K11"] += c["K11"]
            moves = results[mname][0]
            diff = [k for k, (g, w) in enumerate(zip(res, moves))
                    if not same(g, w)]
            if diff:
                fail(f"phase 12a {mname}: {len(diff)} results differ from "
                     f"phase 5's move-stream results (first pair {diff[0]})")
            say(f"phase 12a {mname}: {PAIRS} pairs with SWTPU_TOKEN_WALK=1, "
                f"warm wall {wall:.4f} s (move streams, phase 5: "
                f"{walls[mname]:.4f} s), {nflush} flush(es), peak device "
                f"memory {peak / 1e9:.3f} GB above the {held / 1e9:.3f} GB "
                f"held before the call, launches {json.dumps(c)}; all "
                f"{PAIRS} results equal to phase 5's; phases "
                + json.dumps({k: round(v, 4) for k, v in eng.phase.items()})
                + f"; on {card}")
    finally:
        del os.environ["SWTPU_TOKEN_WALK"]

    # K10 and K11 at the main path's shapes, beside K1 / K2 and their plain
    # versions: every pair's pointer bytes and stats equal to K1's, run
    # bytes to the plain ones, tokens to the plain token walk
    masks = pair_masks(chunks)
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in
            (ch.shape for ch in chunks))
    errs = {"K10": 0.0, "K11": 0.0}
    tt = {}
    for mode, mname in modes:
        args = dict(mode=mode, og=og, eg=eg)
        k1 = fill_dp.fill_many(tab, chunks, **args)
        got = fill_dp.fill_many(tab, chunks, runs=True, **args)
        run = relaunch(tab, chunks, got, **args)
        run()
        k10_ms, got = timed(run, 3)
        del run
        err, bad = fill_err(got, k1, masks)
        if err != 0.0 or bad or not torch.equal(got.stats, k1.stats):
            fail(f"K10 at the main path's shapes, {mname}: pointer bytes or "
                 "stats differ from K1's")
        del k1
        # the plain run bytes on every chunk in LOCAL, on every third in
        # GLOCAL and GLOBAL (host-bound: ~7 s a mode on all 25)
        step = 1 if mode == LOCAL else 3
        plain = torch.zeros_like(got.run)
        pview = fill_dp.Filled(plain, got.stats, got.desc, got.shapes,
                               got.tb_base)
        k10_plain_ms, _ = event_ms(lambda: [
            pview.tb_view(c).copy_(fill_dp.run_bytes_ref(got.tb_view(c)))
            for c in range(0, len(chunks), step)])
        rerr, rbad = fill_err(
            fill_dp.Filled(got.run, got.stats, got.desc, got.shapes,
                           got.tb_base), pview,
            [mk if c % step == 0 else torch.zeros_like(mk)
             for c, mk in enumerate(masks)])
        del plain, pview
        def walk():
            return device_walk.walk_tokens(got.tb, got.run, got.desc,
                                           got.stats, mode=mode, L=L,
                                           order=got.order)

        walk()
        k11_call_ms, out = timed(walk, 5)
        k11_plain_ms, rout = event_ms(lambda: device_walk.walk_tokens_ref(
            got.tb, got.run, got.desc, got.stats, mode=mode, L=L))
        werr = walk_err(out, rout)
        if rerr != 0.0 or rbad or werr != 0.0:
            fail(f"K10/K11 at the main path's shapes, {mname}: {rbad} run "
                 f"bytes differ, token walk max error {werr}")
        k11_ms = walk_by_launch(got, mode, L, rout, walk_err,
                                f"K11 at phase 12a, {mname}", tokens=True)
        clock11 = sm_clock_mhz()
        errs["K10"] = max(errs["K10"], err, rerr)
        errs["K11"] = max(errs["K11"], werr)
        ntok = int(out[0].sum())
        longest = int(out[0].max())
        tt[mname] = (k10_ms, k10_plain_ms, k11_ms, k11_plain_ms, ntok,
                     k11_call_ms, longest,
                     longest * SMEM_STEP_CYCLES / (clock11 * 1e3))
        k1_ms, _, k2_ms, _ = times[mname]
        say(f"phase 12a kernels {mname} at the main path's shapes: K10 "
            f"{k10_ms:.3f} ms (K1 {k1_ms:.3f} ms) vs plain run bytes "
            f"{k10_plain_ms:.3f} ms on {len(chunks[::step])} chunks; K11 by "
            f"its launch {k11_ms:.4f} ms at (T, C) = {device_walk.TILES[2]} "
            f"(a walk_tokens call {k11_call_ms:.4f} ms; K2 {k2_ms:.4f} ms) vs plain {k11_plain_ms:.3f} ms; tokens {ntok} "
            f"({ntok / PAIRS:.1f} a pair, the longest walk {longest}, its "
            f"chain at {SMEM_STEP_CYCLES} cycles a step {tt[mname][7]:.4f} "
            f"ms at {clock11:.0f} MHz) against moves {walk_steps[mname]} "
            f"({walk_steps[mname] / PAIRS:.1f} a pair); all equal")
        del got, out, rout
    del masks

    # (b) the wavefront route through score_pairs, LOCAL
    eng = BatchAligner(mode=LOCAL, device="cuda", diag_scores=True)
    eng.score_pairs(pairs)                      # cold
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    dscores = eng.score_pairs(pairs)
    wall = time.perf_counter() - t0
    c = counts()
    if c["K9"] == 0 or any(c[k] for k in ("K1", "K2", "K10", "K11")):
        fail(f"phase 12b: launches {c}")
    launches["K9"] += c["K9"]
    if not np.array_equal(dscores, scores):
        fail("phase 12b: wavefront scores differ from the K1 route's")
    say(f"phase 12b score_pairs local, diag_scores=True: {PAIRS} pairs warm "
        f"{wall:.4f} s (K1 route, phase 5: {walls['local score_pairs']:.4f} "
        f"s), launches {json.dumps(c)}; every score equal to phase 5's; "
        f"phases " + json.dumps({k: round(v, 4) for k, v in
                                  eng.phase.items()}))
    # K9 and K1's score-only fill by their launches alone (inputs uploaded
    # once), and the wavefront call with its host layout and uploads
    diag_dp.fill_diag(tab, chunks, og=og, eg=eg)
    k9_call_ms, got = timed(lambda: diag_dp.fill_diag(tab, chunks, og=og,
                                                      eg=eg), 5)
    k9_R = diag_dp.SHAPE["R"]
    run9 = k9_relaunch(tab, chunks, k9_R, og, eg)
    run9()
    k9_ms, again = timed(run9, 10)
    k1 = fill_dp.fill_many(tab, chunks, mode=LOCAL, og=og, eg=eg,
                           score_only=True)
    run1 = relaunch(tab, chunks, k1, mode=LOCAL, og=og, eg=eg)
    run1()
    k1so_ms, k1 = timed(run1, 10)
    k9_err = max(float((got - k1.stats).abs().max()),
                 float((again - got).abs().max()))
    # the plain wavefront in strips of 128 columns (its values do not
    # depend on the width; phase 11 runs K9's 32) on every third chunk
    sub = chunks[::3]
    k9_plain_ms, ref = event_ms(lambda: torch.cat([diag_dp.fill_diag_ref(
        tab, *(torch.from_numpy(a).to(dev) for a in ch), og=og, eg=eg,
        lanes=128) for ch in sub]))
    lo, rows = 0, []
    for k, ch in enumerate(chunks):
        if k % 3 == 0:
            rows.append(got[lo:lo + ch.shape[0]])
        lo += ch.shape[0]
    k9_err = max(k9_err, float((torch.cat(rows) - ref).abs().max()))
    if k9_err != 0.0:
        fail(f"K9 at the main path's shapes: max error {k9_err}")
    sub_ms, _ = timed(lambda: diag_dp.fill_diag(tab, sub, og=og, eg=eg), 5)
    say(f"phase 12b kernels at the main path's shapes ({PAIRS} pairs, "
        f"{len(chunks)} chunks), by their launches alone: K9 {k9_ms:.4f} ms "
        f"(R {k9_R} columns a lane; {k9_call_ms:.4f} ms a fill_diag call "
        f"with its host layout and uploads) vs K1 score-only "
        f"{k1so_ms:.4f} ms, equal best on every pair; plain wavefront (128 "
        f"columns a strip) on {len(sub)} of {len(chunks)} chunks "
        f"{k9_plain_ms:.3f} ms (K9 on "
        f"them {sub_ms:.4f} ms), equal; on {card}")

    # (c) a resumable self-sweep through the wavefront route
    rng = np.random.default_rng(SEED + 12)
    letters = np.array(list(LETTERS))
    seqs = [SeqData(f"p{k}", "", "".join(rng.choice(
        letters, int(rng.integers(LMIN, LMAX + 1)))))
        for k in range(SWEEP_SEQS)]
    cfg = swp.SweepConfig(chunk_pairs=SWEEP_CHUNK)
    npairs = SWEEP_SEQS * (SWEEP_SEQS - 1) // 2
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sweep.jsonl")
        wave = BatchAligner(mode=LOCAL, device="cuda", diag_scores=True)
        reset()
        t0 = time.perf_counter()
        mat = swp.score_matrix(seqs, None, wave, out, cfg)
        t_wave = time.perf_counter() - t0
        c = counts()
        if c["K9"] == 0 or c["K1"]:
            fail(f"phase 12c: launches {c}")
        launches["K9"] += c["K9"]
        with open(out) as f:
            lines = f.read().splitlines()
        with open(out, "w") as f:
            f.write("\n".join(lines[:len(lines) // 2]) + "\n")
        t0 = time.perf_counter()
        redone = swp.sweep(seqs, None, wave, out, cfg)
        t_resume = time.perf_counter() - t0
        if redone != len(lines) - len(lines) // 2:
            fail(f"phase 12c: resume ran {redone} chunks")
        resumed = swp.score_matrix(seqs, None, wave, out, cfg)
        t0 = time.perf_counter()
        k1mat = swp.score_matrix(seqs, None,
                                 BatchAligner(mode=LOCAL, device="cuda"),
                                 os.path.join(tmp, "k1.jsonl"), cfg)
        t_k1 = time.perf_counter() - t0
    if not (np.array_equal(mat, k1mat) and np.array_equal(resumed, k1mat)):
        fail("phase 12c: the sweep's matrix differs from the K1 route's")
    say(f"phase 12c sweep.score_matrix: {SWEEP_SEQS} proteins of "
        f"{LMIN}..{LMAX}, {npairs} pairs in {len(lines)} chunks of "
        f"{SWEEP_CHUNK}: wavefront route {t_wave:.3f} s (launches "
        f"{json.dumps(c)}), cut to {len(lines) // 2} lines and resumed "
        f"({redone} chunks, {t_resume:.3f} s), K1 route {t_k1:.3f} s; both "
        "matrices equal")

    k10_ms, k10_plain_ms, k11_ms, k11_plain_ms, ntok = tt["local"][:5]
    k9_bound = bound(DIAG_CELL_FLOPS * true_cells,
                     code_bytes + 32 * PAIRS)
    k10_bound = bound((CELL_FLOPS[LOCAL] + RUN_OPS) * true_cells,
                      2 * true_cells + code_bytes + 32 * PAIRS)
    k11_bound = bound(TOKEN_STEP_OPS * ntok, 3 * ntok + 36 * PAIRS)
    out = []
    for name, src, repl, k, err, ms, pms, bd in (
            ("K9 wavefront score fill", "diag_fill.cu",
             "smithwaterman_tpu/ops/diag_dp.py:291", "K9", k9_err, k9_ms,
             k9_plain_ms, k9_bound),
            ("K10 fill with run bytes", "fill.cu",
             "smithwaterman_tpu/ops/pallas_dp.py:820", "K10", errs["K10"],
             k10_ms, k10_plain_ms, k10_bound),
            ("K11 token walk", "token_walk.cu",
             "smithwaterman_tpu/ops/device_walk.py:322", "K11", errs["K11"],
             k11_ms, k11_plain_ms, k11_bound)):
        out.append({
            "name": name, "route": "cuda",
            "source": f"smithwaterman_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches[k], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bd[0], "bound_by": bd[1],
            "library_ms": None})
    # K9's and K11's "ms" is the launch alone, as K1's and K2's; a
    # fill_diag (LOCAL walk_tokens) call, with its host work and the
    # zeroed outputs, is "call_ms"
    out[0]["call_ms"] = k9_call_ms
    out[2].update(
        call_ms=tt["local"][5],
        ms_by_mode={mn: tt[mn][2] for _, mn in modes},
        longest_steps={mn: tt[mn][6] for _, mn in modes})
    return out


class StripedLockstep:
    """While active, every K12 / K13 launch of ``parallel/seq_tiled`` runs
    beside its plain version on copies of the same inputs.  ``err`` is the
    largest |difference| of any output (row state, outbox edges, above
    edges, per-lane bests and rows, accumulators, pointer bytes,
    checkpoints); ``ms`` / ``plain_ms`` sum each kernel's and its plain
    version's CUDA-event times."""

    def __init__(self):
        from smithwaterman_tpu_torch.parallel import seq_tiled

        self.st = seq_tiled
        self.err = 0.0
        self.ms = {"K12": 0.0, "K13": 0.0}
        self.plain_ms = {"K12": 0.0, "K13": 0.0}
        self.calls = {"K12": 0, "K13": 0}
        self.shapes = {"K12": [], "K13": []}  # each launch's tiling, grid

    @staticmethod
    def diff(a, b):
        if a is None or not a.numel():
            return 0.0
        return float((a.double() - b.double()).abs().max())

    def __enter__(self):
        import torch

        st = self.st
        self.real = real_block, real_grid = st.block_fill, st.grid_fill

        def block(*state, ds, **kw):
            ref = [None if a is None else a.clone() for a in state]
            pms, _ = event_ms(lambda: st.block_ref(*ref, ds=ds, **kw))
            ms, _ = event_ms(lambda: real_block(*state, ds=ds, **kw))
            self.shapes["K12"].append(dict(st.SHAPES["K12"],
                                           shards=len(ds)))
            self.ms["K12"] += ms
            self.plain_ms["K12"] += pms
            self.calls["K12"] += 1
            self.err = max([self.err] + [self.diff(a, r) for a, r in
                                         zip(state[3:], ref[3:])])

        def grid(S, n, m, *, mode, pen, C=None):
            ms, out = event_ms(lambda: real_grid(S, n, m, mode=mode, pen=pen,
                                                 C=C))
            self.shapes["K13"].append(dict(st.SHAPES["K13"]))
            ref = [torch.empty_like(a) for a in out[:3]]
            rck = None if out[3] is None else [torch.empty_like(a)
                                               for a in out[3]]
            pms, _ = event_ms(lambda: st.grid_fill_ref(
                S, n, m, *ref, rck, C=C, mode=mode, pen=pen))
            self.ms["K13"] += ms
            self.plain_ms["K13"] += pms
            self.calls["K13"] += 1
            self.err = max([self.err] + [self.diff(a, r) for a, r in
                                         zip(out[:3], ref)]
                           + [self.diff(a, r) for a, r in
                              zip(out[3] or (), rck or ())])
            return out

        st.block_fill, st.grid_fill = block, grid
        return self

    def __exit__(self, *exc):
        self.st.block_fill, self.st.grid_fill = self.real


def split(seq_tiled, run) -> dict:
    """Seconds of one ``run()`` of seq_tiled.striped_align by stage, from
    wrappers around its checkpointed fill, its band re-fills and its
    windows (each window's gather and copy is _seg_windows less its
    re-fill), the card synchronised around each; the walks are the rest.
    It wraps functions that every version of the striped path has, so
    scripts/ab_striped.py splits a parent tree's wall with it too."""
    import torch

    real = {k: getattr(seq_tiled, k) for k in
            ("striped_fill_ckpt", "striped_band_tb", "_seg_windows")}
    secs = {k: 0.0 for k in real}
    calls = {"refills": 0}

    def wrap(k):
        def f(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real[k](*a, **kw)
            torch.cuda.synchronize()
            secs[k] += time.perf_counter() - t0
            calls["refills"] += k == "striped_band_tb"
            return r
        return f

    for k in real:
        setattr(seq_tiled, k, wrap(k))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    finally:
        for k, f in real.items():
            setattr(seq_tiled, k, f)
    return {"wall_s": wall, "fill_s": secs["striped_fill_ckpt"],
            "refill_s": secs["striped_band_tb"],
            "copy_s": secs["_seg_windows"] - secs["striped_band_tb"],
            "walk_s": wall - secs["striped_fill_ckpt"] - secs["_seg_windows"],
            "refills": calls["refills"]}


def phase13(dev, card, modes):
    """K12 and K13 against their plain versions on the card, launch by
    launch: ragged pairs, D = 1, 2, 4 shards on one card, three modes,
    block_rows 8 and 64, C = 64, a seeded band with pointer bytes, a
    non-integer table and penalties, og = eg = 0, int8 and folded S; then
    the column tiles' edges: shards of 300 lanes (not a multiple of a tile)
    and of 33 (under one tile) at forced tilings (L lanes a thread, E rows
    a publication) beside the launcher's."""
    import torch

    from smithwaterman_tpu_torch import GLOBAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import kernels
    from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled

    blosum = np.asarray(SubstitutionMatrix.blosum62().table, np.float32)
    rng = np.random.default_rng(SEED + 13)
    NP, MP = 512, 2048
    c1 = rng.integers(0, 20, size=(3, NP))
    c2 = rng.integers(0, 20, size=(3, MP))
    c2[0, 700:1100] = c1[0, 50:450]          # a long shared stretch
    n = np.array([NP, 1, 377], np.int32)     # lengths down to 1
    m = np.array([1733, MP, 1], np.int32)
    tab = torch.from_numpy(blosum).to(dev)
    S = tab[torch.from_numpy(c1).to(dev)[:, :, None],
            torch.from_numpy(c2).to(dev)[:, None, :]].contiguous()
    Sx = (S * 0.37).contiguous()             # a non-integer table
    cases = [(mode, mname, D, K, S, -10.0, -0.5) for mode, mname in modes
             for D in (1, 2, 4) for K in (8, 64)]
    cases += [(mode, mname + " blosum62*0.37 og=-10.3 eg=-0.7", 4, 64, Sx,
               -10.3, -0.7) for mode, mname in modes]
    cases.append((GLOBAL, "global og=eg=0", 2, 8, S, 0.0, 0.0))
    S8 = S[:1].to(torch.int8)
    with StripedLockstep() as ls:
        for mode, what, D, K, Sc, og, eg in cases:
            kw = dict(mode=mode, og=og, eg=eg, block_rows=K,
                      mesh=make_mesh(devices=[dev] * D))
            _, ck = seq_tiled.striped_fill_ckpt(Sc, n, m, ckpt_rows=64, **kw)
            seq_tiled.striped_band_tb(Sc[:, 64:128], n, m, 64,
                                      *(a[:, 0] for a in ck), **kw)
            if ls.err != 0.0:
                fail(f"K12/K13 {what} D={D} block_rows={K}: max error "
                     f"{ls.err} against the plain versions")
        one = make_mesh(devices=[dev])
        for mode, mname in modes:
            kw = dict(mode=mode, og=-10.0, eg=-0.5, block_rows=8, mesh=one)
            want = seq_tiled.striped_fill(S[:1], n[:1], m[:1], **kw)
            for x, folded in ((S8, False), (seq_tiled.fold_S(S8), True)):
                got = seq_tiled.striped_fill(x, n[:1], m[:1], folded=folded,
                                             **kw)
                if not torch.equal(got, want) or ls.err != 0.0:
                    fail(f"K13 {mname} int8 folded={folded}: differs")
        # the tiles' edges, at forced tilings and the launcher's
        real_plan, tiled = kernels.striped_plan, 0
        Sx1 = Sx[:, :128]
        n1 = np.minimum(n, 128).astype(np.int32)
        try:
            for plan in ((8, 1), (8, 3), (16, 2), None):
                kernels.striped_plan = (real_plan if plan is None
                                        else lambda *a, p=plan: p)
                for mode, mname in modes:
                    for D, W in ((1, 300), (2, 300), (4, 300), (4, 33)):
                        Sw = Sx1[:, :, :D * W].contiguous()
                        mw = np.minimum(m, D * W).astype(np.int32)
                        kw = dict(mode=mode, og=-10.3, eg=-0.7, block_rows=16,
                                  mesh=make_mesh(devices=[dev] * D))
                        _, ck = seq_tiled.striped_fill_ckpt(
                            Sw, n1, mw, ckpt_rows=64, **kw)
                        seq_tiled.striped_band_tb(Sw[:, 64:], n1, mw, 64,
                                                  *(a[:, 0] for a in ck),
                                                  **kw)
                        tiled += 1
                        if ls.err != 0.0:
                            fail(f"K12/K13 tiles {plan} {mname} D={D} W={W}: "
                                 f"max error {ls.err}")
        finally:
            kernels.striped_plan = real_plan
    say(f"phase 13 K12/K13: {len(cases)} cases (3 modes x D in (1, 2, 4) "
        "shards on one card x block_rows in (8, 64), a non-integer table "
        "with og=-10.3 eg=-0.7 at D=4, GLOBAL og=eg=0), 3 pairs of up to "
        f"{NP} x {MP} (lengths down to 1), each a checkpointed fill (C=64) "
        "and a seeded band re-fill with pointer bytes; int8 and folded S at "
        f"D=1 in 3 modes; {tiled} tile-edge cases (tilings (L, E) (8, 1), "
        "(8, 3), (16, 2) and the launcher's x 3 modes x shards of 300 lanes "
        "at D in (1, 2, 4) and of 33 at D=4, 128 rows, og=-10.3 eg=-0.7): "
        f"{ls.calls['K12']} K12 and {ls.calls['K13']} K13 "
        "launches each equal to its plain version in every output (stats, "
        "checkpoints, row state, outbox edges, pointer bytes); summed ms "
        f"kernel / plain: K12 {ls.ms['K12']:.3f} / {ls.plain_ms['K12']:.3f}, "
        f"K13 {ls.ms['K13']:.3f} / {ls.plain_ms['K13']:.3f}; on {card}")


def phase14(dev, card, modes):
    """The striped path at a real size: one 2048 x 65,536 protein pair.
    Returns the K12 and K13 records."""
    import torch

    from smithwaterman_tpu_torch import GLOBAL, LOCAL, BatchAligner
    from smithwaterman_tpu_torch.aligner import reconstruct_alignment
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import (banded, device_walk, diag_dp,
                                             fill_dp, longseq)
    from smithwaterman_tpu_torch.parallel import make_mesh, seq_tiled

    reset = reset_launches

    def counts():
        return launch_counts("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                             "K9", "K10", "K11", "K12", "K13")

    og, eg, K, C = -10.0, -0.5, 64, longseq.DEFAULT_CKPT_ROWS
    sm = SubstitutionMatrix.blosum62()
    rng = np.random.default_rng(SEED)
    ref_codes = rng.integers(0, 20, size=STRIPED_MP)
    ref = "".join(LETTERS[c] for c in ref_codes)
    qry = "".join(LETTERS[c] for c in mutate(
        ref_codes[STRIPED_AT:STRIPED_AT + STRIPED_NP], rng, 20))
    qry = qry[:STRIPED_NP]
    n, m = len(qry), STRIPED_MP
    q_idx = np.zeros(STRIPED_NP, np.uint8)
    q_idx[:n] = sm.seq_to_index(qry)
    r_idx = np.asarray(sm.seq_to_index(ref), np.uint8)
    tab = torch.from_numpy(np.asarray(sm.table, np.float32)).to(dev)
    qt = torch.from_numpy(q_idx).to(dev)[None]
    rt = torch.from_numpy(r_idx).to(dev)[None]
    S = tab[qt[0].long()[:, None], rt[0].long()[None, :]][None].contiguous()
    nv, mv = np.array([n], np.int32), np.array([m], np.int32)
    mesh1 = make_mesh(devices=[dev])
    mesh4 = make_mesh(devices=[dev] * 4)
    kw = dict(og=og, eg=eg, block_rows=K)

    # (a) + (b): the striped calls alone, with every launch count at 0
    seq_tiled.striped_align(S, nv, mv, mode=LOCAL, mesh=mesh1, **kw)  # warm
    torch.cuda.synchronize()
    reset()
    fills, aligns, walls, peaks = {}, {}, {}, {}
    for mode, mname in modes:
        fills[mname] = (seq_tiled.striped_fill(S, nv, mv, mode=mode,
                                               mesh=mesh1, **kw),
                        seq_tiled.striped_fill(S, nv, mv, mode=mode,
                                               mesh=mesh4, **kw))
    st4, _ = seq_tiled.striped_fill_ckpt(S, nv, mv, mode=LOCAL, ckpt_rows=C,
                                         mesh=mesh4, **kw)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()   # S and earlier phases' tensors
    for mode, mname in modes:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aligns[mname] = seq_tiled.striped_align(S, nv, mv, mode=mode,
                                                mesh=mesh1, **kw)
        walls[mname] = time.perf_counter() - t0
        peaks[mname] = torch.cuda.max_memory_allocated() - held
    c = counts()
    launches = {"K12": c["K12"], "K13": c["K13"]}
    if not (c["K12"] and c["K13"]) or any(
            v for k, v in c.items() if k not in launches):
        fail(f"phase 14: launches {c}")

    # the references: K3's stats row and the long route's alignment
    nt, mt = (torch.tensor([x], dtype=torch.int32, device=dev)
              for x in (n, m))
    for mode, mname in modes:
        st3, _ = longseq.fill_checkpointed(tab, qt, rt, nt, mt, mode=mode,
                                           og=og, eg=eg, C=C)
        st3 = st3[0].cpu().numpy()
        f1, f4 = (x.cpu().numpy()[0] for x in fills[mname])
        idx, stats = aligns[mname]
        if mode == LOCAL:
            ok = (f1 == f4 == st3[0]
                  and np.array_equal(st4[0, :3].cpu().numpy(), st3[:3])
                  and np.array_equal(stats[0, :3], st3[:3]))
            score = float(stats[0, 0]) if stats[0, 0] > 0 else 0.0
        else:
            ok = (np.array_equal(f1, st3[3:6]) and np.array_equal(f4, st3[3:6])
                  and np.array_equal(stats[0, 3:6], st3[3:6]))
            score = float(np.max(stats[0, 3:6]))
        if not ok:
            fail(f"phase 14 {mname}: striped stats {f1} (D=1) / {f4} (D=4) "
                 f"/ align {stats[0]} differ from K3's {st3}")
        got = reconstruct_alignment(qry, ref, idx[0][0], idx[0][1], score,
                                    True, mode)
        t0 = time.perf_counter()
        want = BatchAligner(mode=mode, device=dev,
                            longseq_cells=1).align_pairs([(qry, ref)])[0]
        t_long = time.perf_counter() - t0
        if (got.aligned1, got.aligned2, got.score) != (
                want.aligned1, want.aligned2, want.score):
            fail(f"phase 14 {mname}: striped_align's alignment differs from "
                 "the long route's")
        say(f"phase 14 {mname}: {n} x {m} protein pair, striped_fill equal "
            f"to K3's stats at D=1 (K13) and D=4 on one card (K12)"
            + (", striped_fill_ckpt's (i, j) too" if mode == LOCAL else "")
            + f"; striped_align (D=1) warm wall {walls[mname]:.4f} s, peak "
            f"device memory {peaks[mname] / 1e9:.3f} GB above the "
            f"{held / 1e9:.3f} GB held before (S is "
            f"{S.numel() * 4 / 1e9:.3f} GB), score {got.score}, "
            f"strings ({len(got.aligned1)} columns) equal to the long "
            f"route's ({t_long:.3f} s); on {card}")
    say(f"phase 14 launches of the striped calls (3 modes x striped_fill at "
        f"D=1 and D=4, striped_fill_ckpt LOCAL at D=4, striped_align at "
        f"D=1): {json.dumps(c)}")

    # striped_align's wall split by stage (the card synchronised between
    # stages, so a little slower than the walls above)
    for mode, mname in modes:
        sp = split(seq_tiled, lambda: seq_tiled.striped_align(
            S, nv, mv, mode=mode, mesh=mesh1, **kw))
        say(f"phase 14 {mname} striped_align split (s): " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in sp.items()) + f"; on {card}")

    # K12 and K13 at these shapes beside their plain versions (LOCAL)
    pen = seq_tiled.make_pen(LOCAL, og, eg)
    seq_tiled.grid_fill(S, nt, mt, mode=LOCAL, pen=pen)
    k13_shape = dict(seq_tiled.SHAPES["K13"])
    k13_ms, out = timed(lambda: seq_tiled.grid_fill(S, nt, mt, mode=LOCAL,
                                                     pen=pen), 3)
    ref13 = [torch.empty_like(a) for a in out[:3]]
    k13_plain_ms, _ = event_ms(lambda: seq_tiled.grid_fill_ref(
        S, nt, mt, *ref13, None, C=None, mode=LOCAL, pen=pen))
    k13_err = max(StripedLockstep.diff(a, r) for a, r in zip(out[:3], ref13))
    del out, ref13
    with StripedLockstep() as ls:
        seq_tiled.striped_fill(S, nv, mv, mode=LOCAL, mesh=mesh4, **kw)
    k12 = (ls.ms["K12"], ls.plain_ms["K12"], ls.calls["K12"], ls.err)
    _, ck = seq_tiled.striped_fill_ckpt(S, nv, mv, mode=GLOBAL,
                                        ckpt_rows=C, mesh=mesh1, **kw)
    sk = STRIPED_NP // C - 1
    with StripedLockstep() as lb:
        seq_tiled.striped_band_tb(S[:, sk * C:], nv, mv, sk * C,
                                  *(a[:, sk - 1] for a in ck),
                                  mode=GLOBAL, mesh=mesh1, **kw)
    if max(k13_err, k12[3], lb.err) != 0.0:
        fail(f"phase 14 kernels against plain: K13 {k13_err}, K12 {k12[3]} "
             f"(D=4 fill), {lb.err} (band)")
    k12_shape = max(ls.shapes["K12"], key=lambda d: d["tiles"])
    kb_shape = lb.shapes["K12"][0]
    if not (k13_shape["blocks"] > 1 and k12_shape["blocks"] >
            k12_shape["shards"] and kb_shape["blocks"] > 1):
        fail(f"phase 14: a (shard, pair) on one block: K13 {k13_shape}, "
             f"K12 {k12_shape}, band {kb_shape}")
    say(f"phase 14 launch shapes (tiles of 'lanes' lanes, one warp a block, "
        f"an edge published every E rows): K13 at B=1 {k13_shape}; K12 at "
        f"D=4, its widest step {k12_shape}; K12 band re-fill at B=1, D=1 "
        f"{kb_shape}")
    cells = STRIPED_NP * STRIPED_MP
    s_bytes = 4 * cells
    k13_bound = bound(STRIPED_CELL_OPS[LOCAL] * cells,
                      s_bytes + 8 * STRIPED_MP + 16)
    # K12 at D=4: the scores, each shard's edge row out and in, the state
    k12_bound = bound(STRIPED_CELL_OPS[LOCAL] * cells,
                      s_bytes + 2 * 16 * 4 * STRIPED_NP + 8 * STRIPED_MP)
    # the band re-fill: its scores, seeds and pointer bytes
    kb_bound = bound((STRIPED_CELL_OPS[GLOBAL] + STRIPED_TB_OPS) * C
                     * STRIPED_MP, 5 * C * STRIPED_MP + 12 * STRIPED_MP)
    say(f"phase 14 kernels at these shapes ({n} x {m}, LOCAL) on {card}: "
        f"K13 {k13_ms:.3f} ms ({k13_ms * 1e6 / STRIPED_NP:.1f} ns a row) vs "
        f"plain {k13_plain_ms:.3f} ms, bound {k13_bound[0]:.4f} ms; K12 at "
        f"D=4 on one card {k12[0]:.3f} ms over {k12[2]} launches vs plain "
        f"{k12[1]:.3f} ms, bound {k12_bound[0]:.4f} ms; K12 at B=1, D=1, "
        f"one band re-fill of {C} rows with pointer bytes (GLOBAL) "
        f"{lb.ms['K12']:.3f} ms over {lb.calls['K12']} launches vs plain "
        f"{lb.plain_ms['K12']:.3f} ms, bound {kb_bound[0]:.4f} ms; all equal "
        "to the plain versions")
    return [
        {"name": "K12 striped block fill (B7; B8 at B = 1)", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/striped_fill.cu",
         "replaces": "smithwaterman_tpu/parallel/seq_tiled.py:821",
         "launches": launches["K12"], "max_abs_err": max(k12[3], lb.err),
         "ms": k12[0], "plain_ms": k12[1], "bound_ms": k12_bound[0],
         "bound_by": k12_bound[1], "library_ms": None},
        {"name": "K13 striped grid fill (B9)", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/striped_fill.cu",
         "replaces": "smithwaterman_tpu/parallel/seq_tiled.py:765",
         "launches": launches["K13"], "max_abs_err": k13_err,
         "ms": k13_ms, "plain_ms": k13_plain_ms, "bound_ms": k13_bound[0],
         "bound_by": k13_bound[1], "library_ms": None},
    ]


def wide_letters(K):
    """K single-character symbols, those past 65 beyond Latin-1."""
    ascii_ = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
              "0123456789@$%")
    if K <= len(ascii_):
        return list(ascii_[:K])
    return [chr(0x100 + i) for i in range(K - len(ascii_))] + list(ascii_)


def phase6_wide(dev, modes):
    """Tables past 64 and 255 symbols (read from device memory; int16
    codes past 255): K1, K3, K4, K6 and K9 against their plain versions,
    and ``BatchAligner`` on the card (both routes) against the CPU path."""
    import torch

    from smithwaterman_tpu_torch import LOCAL, BatchAligner
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import banded, batch, diag_dp, fill_dp
    from smithwaterman_tpu_torch.ops import longseq

    rng = np.random.default_rng(SEED + 60)
    summary = []
    for K in (65, 300):
        tabn = rng.integers(-4, 5, size=(K, K)).astype(np.float32)
        np.fill_diagonal(tabn, 7.0)
        tab = torch.from_numpy(tabn).to(dev)
        ct = batch.code_dtype(K)
        B, NP, MP = 8, 600, 520
        c1 = rng.integers(0, K, size=(B, NP)).astype(ct)
        c2 = rng.integers(0, K, size=(B, MP)).astype(ct)
        n = rng.integers(1, NP + 1, size=B).astype(np.int32)
        m = rng.integers(1, MP + 1, size=B).astype(np.int32)
        n[:3], m[:3] = (NP, 1, 256), (MP, MP, 1)
        c2[0, 40:400] = c1[0, 100:460]
        ch = batch.Chunk(c1, c2, n, m)
        t1, t2, tn, tm = (torch.from_numpy(a).to(dev) for a in ch)
        err = 0.0
        for mode, _ in modes:
            got = fill_dp.fill_many(tab, [ch], mode=mode, og=-10.0, eg=-0.5)
            ref = fill_dp.fill_many_ref(tab, [ch], mode=mode, og=-10.0,
                                        eg=-0.5)
            err = max(err, float((got.stats - ref.stats).abs().max()))
            for b in range(B):  # pointer bytes inside each pair's [:n, :m]
                d = (got.tb_view(0)[:n[b], :m[b], b].int()
                     - ref.tb_view(0)[:n[b], :m[b], b].int())
                err = max(err, float(d.abs().max()))
            for C in (256, 64):
                args = dict(mode=mode, og=-10.0, eg=-0.5, C=C)
                st, ck = longseq.fill_checkpointed(tab, t1, t2, tn, tm, **args)
                rst, rck = longseq.fill_checkpointed_ref(tab, t1, t2, tn, tm,
                                                         **args)
                err = max(err, float((st - rst).abs().max()))
                for b in range(B):
                    k = int(n[b]) // C
                    for a, r in zip(ck, rck):
                        if k:
                            err = max(err, float((a[b, :k, :m[b]]
                                                  - r[b, :k, :m[b]])
                                                 .abs().max()))
                nck = longseq.n_ckpts(NP, C)
                bands = torch.zeros((nck, B, longseq.band_bytes(C, MP)),
                                    dtype=torch.uint8, device=dev)
                rbands = bands.clone()
                longseq.fill_bands(tab, t1, t2, tn, tm, ck, bands, sk0=0,
                                   **args)
                longseq.fill_bands_ref(tab, t1, t2, tn, tm, ck, rbands, sk0=0,
                                       **args)
                for sk in range(nck):
                    g, r = (longseq.band_view(x[sk], C, MP)
                            for x in (bands, rbands))
                    for b in range(B):
                        rows = min(max(int(n[b]) - sk * C, 0), C)
                        d = (g[b, :rows, :int(m[b])].int()
                             - r[b, :rows, :int(m[b])].int())
                        if rows:
                            err = max(err, float(d.abs().max()))
        got = diag_dp.fill_diag(tab, [ch], og=-10.0, eg=-0.5)
        ref = diag_dp.fill_diag_ref(tab, t1, t2, tn, tm, og=-10.0, eg=-0.5)
        err = max(err, float((got - ref).abs().max()))
        pk = banded.pack([(c1[b, :n[b]], c2[b, :m[b]]) for b in range(B)],
                         128, K)
        u1, u2, un, um = (torch.from_numpy(a).to(dev)
                          for a in (pk.codes1, pk.codes2, pk.n, pk.m))
        S = banded.banded_scores(tab, u1, u2, un, um, W=pk.W)
        err = max(err, float((S - banded.banded_scores_ref(
            tab, u1, u2, un, um, W=pk.W)).abs().max()))
        if err != 0.0:
            fail(f"phase 6 wide table of {K} symbols: kernels differ from "
                 f"their plain versions by {err}")
        # BatchAligner on the card, ordinary and long route, against the
        # CPU path, on a from_lines table of these scores
        sym = wide_letters(K)
        lines = ["  ".join(sym)] + [
            s_ + " " + " ".join(str(int(v)) for v in tabn[i])
            for i, s_ in enumerate(sym)]
        sm = SubstitutionMatrix.from_lines(lines)
        letters = np.array(sym)
        pairs = []
        for k in range(12):
            a = "".join(rng.choice(letters, int(rng.integers(1, 900))))
            b = "".join(rng.choice(letters, int(rng.integers(1, 900))))
            if k % 2 == 0 and len(a) > 300:
                b = b[:50] + a[100:300] + b[50:]
            pairs.append((a, b))
        for mode, mname in modes:
            want = [(r.aligned1, r.aligned2, r.score, r.start1, r.end1,
                     r.start2, r.end2) for r in BatchAligner(
                scoring_matrix=sm, mode=mode, device="cpu").align_pairs(pairs)]
            for cells in (None, 1):
                got = BatchAligner(scoring_matrix=sm, mode=mode, device="cuda",
                                   longseq_cells=cells).align_pairs(pairs)
                if [(r.aligned1, r.aligned2, r.score, r.start1, r.end1,
                     r.start2, r.end2) for r in got] != want:
                    fail(f"phase 6 wide table of {K} symbols, {mname}: "
                         f"BatchAligner on the card (longseq_cells={cells}) "
                         "differs from the CPU path")
        summary.append(f"{K} symbols ({np.dtype(ct).name} codes)")
    say("phase 6 wide tables: " + ", ".join(summary) + ": K1 (3 modes), "
        "K3 and K4 (3 modes x C in (256, 64), every band in one K4 launch), "
        "K9 and K6 equal to their plain versions; 12 pairs through "
        "BatchAligner on the card (ordinary and long route) equal to the "
        "CPU path in 3 modes")


def phase15(dev, card, modes, pairs, chunks, results, scores, walls):
    """The sharded path at the main path's full width, the web surface and
    the graft entry on the card; returns the launches of K1, K2 and K9 on
    the sharded path."""
    import statistics
    import threading
    import urllib.request

    import torch

    import __graft_entry_torch__ as graft
    from smithwaterman_tpu_torch import LOCAL, BatchAligner, web
    from smithwaterman_tpu_torch.ops import (banded, batch, device_walk,
                                             diag_dp, fill_dp, longseq)
    from smithwaterman_tpu_torch.parallel import (DataParallel, make_mesh,
                                                  seq_tiled)

    reset = reset_launches

    def counts():
        return launch_counts("K1", "K2", "K9", "K10", "K11", "K3", "K4",
                             "K5", "K6", "K7", "K8", "K12", "K13")

    def only(c, allowed, what):
        if any(v for k, v in c.items() if k not in allowed):
            fail(f"phase 15 {what}: a kernel off the path launched: {c}")

    def same(a, b):
        return (a.aligned1, a.aligned2, a.score, a.start1, a.end1, a.start2,
                a.end2) == (b.aligned1, b.aligned2, b.score, b.start1,
                            b.end1, b.start2, b.end2)

    def warm(call, check):
        """Three warm calls, each with the counts set to 0 just before it
        and checked just after; (median wall, summed counts)."""
        total, ts = {}, []
        for _ in range(3):
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            out = call()
            ts.append(time.perf_counter() - t0)
            c = counts()
            check(out, c)
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        return statistics.median(ts), total

    t_phase = time.perf_counter()
    shards = SHARDS
    dp = DataParallel(make_mesh(devices=[dev] * shards))
    nflush = len(batch.plan_flushes(chunks, batch.tb_budget(), False))
    launched = {"K1": 0, "K2": 0, "K9": 0}

    # (a) alignments and scores, sharded over four shards of the card
    for mode, mname in modes:
        eng = BatchAligner(mode=mode, device="cuda", device_axis=dp)
        eng.align_pairs(pairs)                  # cold
        want = results[mname][0]

        def check(res, c, mname=mname, want=want):
            only(c, ("K1", "K2"), mname)
            if c["K1"] < shards * nflush or c["K2"] != shards * nflush:
                fail(f"phase 15a {mname}: launches {c} on {shards} shards "
                     f"and {nflush} flush(es)")
            diff = [k for k, (g, w) in enumerate(zip(res, want))
                    if not same(g, w)]
            if len(res) != PAIRS or diff:
                fail(f"phase 15a {mname}: {len(diff)} of {len(res)} results "
                     f"differ from phase 5's (first pair "
                     f"{diff[0] if diff else None})")

        wall, c = warm(lambda: eng.align_pairs(pairs), check)
        launched["K1"] += c["K1"]
        launched["K2"] += c["K2"]
        say(f"phase 15a {mname}: {PAIRS} pairs on {shards} shards of the "
            f"card, warm wall {wall:.4f} s (median of 3; unsharded, phase "
            f"5: {walls[mname]:.4f} s), launches over the 3 calls "
            f"{json.dumps(c)}; all {PAIRS} results equal to phase 5's; "
            "phases " + json.dumps({k: round(v, 4)
                                    for k, v in eng.phase.items()})
            + f"; on {card}")
    for diag in (False, True):
        eng = BatchAligner(mode=LOCAL, device="cuda", device_axis=dp,
                           diag_scores=diag)
        eng.score_pairs(pairs)                  # cold
        kernel = "K9" if diag else "K1"

        def check(got, c, kernel=kernel):
            only(c, (kernel,), f"score_pairs with {kernel}")
            if c[kernel] < shards:
                fail(f"phase 15 score_pairs: launches {c} on {shards} "
                     "shards")
            if not np.array_equal(got, scores):
                fail(f"phase 15 score_pairs through {kernel}: scores differ "
                     "from phase 5's")

        wall, c = warm(lambda: eng.score_pairs(pairs), check)
        launched[kernel] += c[kernel]
        say(f"phase 15{'b' if diag else 'a'} score_pairs local"
            f"{', diag_scores=True' if diag else ''}: {PAIRS} pairs on "
            f"{shards} shards, warm wall {wall:.4f} s (median of 3; "
            f"unsharded through K1, phase 5: "
            f"{walls['local score_pairs']:.4f} s), launches over the 3 "
            f"calls {json.dumps(c)}; every score equal to phase 5's")

    # (d) the web surface on the card against the same request on the CPU
    req = {"seq1": "".join(f">a{k}\n{pairs[k][0].seq}\n" for k in (0, 1)),
           "seq2": "".join(f">b{k}\n{pairs[k][1].seq}\n" for k in (0, 1)),
           "gap_open": 10, "gap_extend": 0.5, "matrix": "protein"}
    srv = web.Server(("127.0.0.1", 0), device="cuda")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        page = urllib.request.urlopen(url + "/", timeout=60).read()
        if b"smithwaterman_tpu_torch" not in page or \
                b"Gap Open Penalty" not in page:
            fail("phase 15d: GET / did not serve the port's page")
        reset()
        got = json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/align", data=json.dumps(req).encode(), method="POST"),
            timeout=300).read())
        c = counts()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    want = json.loads(json.dumps(web.align_request(req, device="cpu")))
    if "error" in got or got != want or len(got["results"]) != 4:
        fail(f"phase 15d: POST /align on the card differs from the CPU: "
             f"{str(got)[:300]}")
    if c["K1"] == 0 or c["K2"] == 0:
        fail(f"phase 15d: the web surface did not run K1 and K2: {c}")
    say(f"phase 15d web: GET / and POST /align (2 x 2 records of phase 5) "
        f"on the card, every result equal to the CPU's; scores "
        f"{[r['score'] for r in got['results']]}; launches {json.dumps(c)}")

    # (e) the graft entry: one K1 fill, and the dry run over four shards
    fn, args = graft.entry()
    reset()
    st = fn(*args)
    torch.cuda.synchronize()
    c = counts()
    ref = fill_dp.fill_many_ref(args[0], args[1], mode=LOCAL, og=graft.OG,
                                eg=graft.EG, score_only=True).stats
    if c["K1"] == 0 or not torch.equal(st, ref):
        fail(f"phase 15e: entry()'s stats differ from the plain fill, or "
             f"K1 never launched: {c}")
    reset()
    graft.dryrun_multichip(shards)
    c = counts()
    if c["K1"] < shards or c["K12"] == 0:
        fail(f"phase 15e: dryrun_multichip({shards}) launches {c}")
    say(f"phase 15e graft entry: entry() stats {tuple(st.shape)} equal to "
        f"the plain fill; dryrun_multichip({shards}) on the card repeated "
        f"{shards} times passed, launches {json.dumps(c)}; phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


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
                                             kernels, longseq, native)
    from smithwaterman_tpu_torch.utils.calc_score import recalc_score

    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
        if len(chunks) == 1 and chunks[0].shape[0] == 1:
            # one pair: a block of warps, its stripes overlapping
            args = dict(mode=LOCAL, og=og, eg=eg)
            got = fill_dp.fill_many(tab, chunks, **args)
            run = relaunch(tab, chunks, got, **args)
            run()
            big_ms, _ = timed(run, 3)
            R, NW, _ = fill_dp.launch_plan(chunks, 1, sms)[0]
            say(f"phase 3 K1 {name}, LOCAL with pointers: {big_ms:.3f} ms, "
                f"R = {R} rows a lane, {NW} warps; on {card}")
            del got, run

    # ---- phase 4: K2 against its plain version on K1's own pointers
    longest = 0
    for name, mode, mname, got in walk_inputs:
        L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in got.shapes)
        cnt, mv = device_walk.walk_packed(got.tb, got.desc, got.stats,
                                          mode=mode, L=L, order=got.order)
        torch.cuda.synchronize()
        ref = device_walk.walk_packed_ref(got.tb, got.desc, got.stats,
                                          mode=mode, L=L)
        if walk_err((cnt, mv), ref) != 0.0:
            fail(f"K2 {name} {mname}: walk differs from the plain walk")
        if int(cnt.max()) == 0:
            fail(f"K2 {name} {mname}: no moves at all")
        longest = max(longest, int(cnt.max()))
    say(f"phase 4 K2: {len(walk_inputs)} walks equal to the plain walk "
        f"(counts and every move byte) at tiles (T, C) "
        f"{device_walk.TILES[1]}; longest walk {longest} steps")
    say(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 5: the main path at a size users run
    pairs = main_path_pairs()
    cells = sum(len(a.seq) * len(b.seq) for a, b in pairs)
    sub = np.random.default_rng(SEED + 1).choice(PAIRS, CHECKED,
                                                 replace=False)
    reset_launches()
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
    launches = launch_counts("K1", "K2")
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
        say(f"phase 5 {mname}: {PAIRS} pairs warm {wall:.4f} s (K1 a "
            f"thread a pair: {THREAD_A_PAIR_WALL[mname]:.4f} s), "
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
    chunks = [buckets[k].chunk(np.uint8) for k in sorted(buckets)]
    tab = torch.from_numpy(blosum).to(dev)
    masks = pair_masks(chunks)
    L = max(device_walk.max_path_len(NP, MP) for _, NP, MP in
            (ch.shape for ch in chunks))

    say("phase 5 K1 stripes (R rows a lane, NW warps a pair: pairs) at "
        "this flush: " + "; ".join(f"{what} " + ", ".join(
            f"R = {R}, NW = {NW}: {len(rows)}" for R, NW, rows in
            fill_dp.launch_plan(chunks, pools, sms))
            for what, pools in (("score-only", 0), ("pointers", 1),
                                ("with run bytes (K10)", 2))))

    main_err = {"K1": 0.0, "K2": 0.0}
    times = {}
    walk_steps, walk_longest, k2_modes, clock = {}, {}, {}, {}
    fill_dp.fill_many_ref(tab, chunks[:1], mode=LOCAL, og=-10.0, eg=-0.5)
    for mode, mname in modes:
        args = dict(mode=mode, og=-10.0, eg=-0.5)
        got = fill_dp.fill_many(tab, chunks, **args)
        run = relaunch(tab, chunks, got, **args)
        run()
        k1_ms, got = timed(run, 3)
        del run
        # LOCAL, the mode recorded below, against the plain fill on every
        # chunk; GLOCAL and GLOBAL at a cut depth, on every third chunk (the
        # plain fill is host-bound: ~18 s a mode on all 25)
        step = 1 if mode == LOCAL else 3
        cgot = got if step == 1 else fill_dp.fill_many(tab, chunks[::step],
                                                       **args)
        k1_plain_ms, ref = timed(
            lambda: fill_dp.fill_many_ref(tab, chunks[::step], **args), 1)
        err, bad = fill_err(cgot, ref, masks[::step])
        if err != 0.0 or bad or not torch.equal(cgot.stats, ref.stats):
            fail(f"K1 at the main path's shapes, {mname}: max stats/tb "
                 f"error {err}, {bad} pointer bytes differ")
        del ref, cgot
        def walk():
            return device_walk.walk_packed(got.tb, got.desc, got.stats,
                                           mode=mode, L=L, order=got.order)

        walk()
        k2_call_ms, out = timed(walk, 5)
        k2_plain_ms, rout = timed(lambda: device_walk.walk_packed_ref(
            got.tb, got.desc, got.stats, mode=mode, L=L), 1)
        werr = walk_err(out, rout)
        if werr != 0.0:
            fail(f"K2 at the main path's shapes, {mname}: walk differs "
                 f"from the plain walk (max error {werr})")
        k2_ms = walk_by_launch(got, mode, L, rout, walk_err,
                               f"K2 at phase 5, {mname}")
        clock[mname] = sm_clock_mhz()
        main_err["K1"] = max(main_err["K1"], err)
        main_err["K2"] = max(main_err["K2"], werr)
        walk_steps[mname] = int(out[0].sum())
        walk_longest[mname] = int(out[0].max())
        times[mname] = (k1_ms, k1_plain_ms, k2_ms, k2_plain_ms)
        k2_modes[mname] = (k2_ms, k2_call_ms)
        say(f"phase 5 kernels {mname} at the main path's shapes ({PAIRS} "
            f"pairs, {len(chunks)} chunks, L={L}; K1 against the plain fill "
            f"on {len(chunks[::step])} chunks) on {card}: every pointer "
            f"byte, stat, count and move equal to the plain versions; K1 "
            f"{k1_ms:.3f} ms vs plain {k1_plain_ms:.3f} ms; K2 by its launch "
            f"{k2_ms:.4f} ms at (T, C) = {device_walk.TILES[1]} (a "
            f"walk_packed call {k2_call_ms:.4f} ms) vs plain "
            f"{k2_plain_ms:.3f} ms; {walk_steps[mname]} steps, the longest "
            f"walk {walk_longest[mname]}; SM clock {clock[mname]:.0f} MHz")
        del got, out, rout
    k1_ms, k1_plain_ms, k2_ms, k2_plain_ms = times["local"]
    # bounds of the LOCAL flush timed above: K1 reads the codes and writes
    # one pointer byte per true cell and a stats row per pair; K2 reads one
    # pointer byte per step and writes the packed moves, counts and reads
    # the stats
    lens = [(len(a.seq), len(b.seq)) for a, b in pairs]
    code_bytes = sum(x + y for x, y in lens)
    k1_bound = bound(CELL_FLOPS[LOCAL] * cells,
                     cells + code_bytes + 32 * PAIRS)
    steps = walk_steps["local"]
    k2_bound = bound(STEP_OPS * steps, steps + steps / 4 + 36 * PAIRS)
    # beside the bound, not the bound: the longest walk's chain of steps at
    # one dependent shared-memory read a step, at the SM clock read after
    # the mode's launches
    k2_chain = {mn: walk_longest[mn] * SMEM_STEP_CYCLES / (clock[mn] * 1e3)
                for _, mn in modes}
    say("phase 5 K2 longest walks' chains at " f"{SMEM_STEP_CYCLES} cycles "
        "a step: " + ", ".join(f"{mn} {walk_longest[mn]} steps, "
                               f"{k2_chain[mn]:.4f} ms" for _, mn in modes))
    records = [
        {"name": "K1 fill", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/fill.cu",
         "replaces": "smithwaterman_tpu/ops/pallas_dp.py:197",
         "launches": launches["K1"], "max_abs_err": main_err["K1"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "K2 walk", "route": "cuda",
         "source": "smithwaterman_tpu_torch/csrc/walk.cu",
         "replaces": "smithwaterman_tpu/ops/device_walk.py:220",
         "launches": launches["K2"], "max_abs_err": main_err["K2"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "call_ms": k2_modes["local"][1],
         "ms_by_mode": {mn: k2_modes[mn][0] for _, mn in modes},
         "longest_steps": walk_longest},
    ]
    del masks
    say(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 6: K3, K4, K5 against their plain versions
    def ckpt_err(got, ref, n, m, C):
        """Largest |difference| of stats and of checkpoint values inside
        every pair's true region (rows (k+1)*C <= n, columns < m)."""
        (st, ck), (rst, rck) = got, ref
        err = float((st - rst).abs().max())
        for b in range(len(n)):
            k, mb = int(n[b]) // C, int(m[b])
            for a, r in zip(ck, rck):
                if k:
                    err = max(err, float((a[b, :k, :mb] - r[b, :k, :mb])
                                         .abs().max()))
        return err

    def band_err(band, rband, n, m, C, MP, sk):
        """Largest |difference| of two bands' pointer bytes in [:n, :m]."""
        got, ref = (longseq.band_view(x, C, MP) for x in (band, rband))
        err = 0.0
        for b in range(len(n)):
            rows = min(max(int(n[b]) - sk * C, 0), C)
            if rows:
                d = got[b, :rows, :int(m[b])].int() - \
                    ref[b, :rows, :int(m[b])].int()
                err = max(err, float(d.abs().max()))
        return err

    def state_err(a, b):
        return max(float((x.long() - y.long()).abs().max())
                   for x, y in zip(a, b))

    rng6 = np.random.default_rng(SEED + 6)
    B6, NP6 = 8, 1024
    c1 = rng6.integers(0, 20, size=(B6, NP6)).astype(np.uint8)
    c2 = rng6.integers(0, 20, size=(B6, NP6)).astype(np.uint8)
    n6 = rng6.integers(1, NP6 + 1, size=B6).astype(np.int32)
    m6 = rng6.integers(1, NP6 + 1, size=B6).astype(np.int32)
    n6[:3], m6[:3] = (1, NP6, NP6), (NP6, 1, NP6)
    motif = c1[3, :100].copy()  # repeated down seq1: tied LOCAL maxima
    for r in range(150, 900, 190):
        c1[3, r:r + 100] = motif
    c2[3, 300:400] = motif
    n6[3], m6[3] = 1000, 700
    c2[4, 100:700] = c1[4, 300:900]  # a long shared stretch
    ch6 = batch.Chunk(c1, c2, n6, m6)
    t1, t2, tn, tm = (torch.from_numpy(a).to(dev) for a in ch6)
    tab = torch.from_numpy(blosum).to(dev)
    p6 = {"K3": [0.0, 0.0], "K4": [0.0, 0.0], "K5": [0.0, 0.0]}
    for mode, mname in modes:
        for C in (longseq.DEFAULT_CKPT_ROWS, 64):
            args = dict(mode=mode, og=-10.0, eg=-0.5, C=C)
            ms, got = event_ms(lambda: longseq.fill_checkpointed(
                tab, t1, t2, tn, tm, **args))
            pms, ref = event_ms(lambda: longseq.fill_checkpointed_ref(
                tab, t1, t2, tn, tm, **args))
            p6["K3"][0] += ms
            p6["K3"][1] += pms
            if ckpt_err(got, ref, n6, m6, C) != 0.0:
                fail(f"K3 {mname} C={C}: differs from the plain fill")
            st, ck = got
            L = 2 * NP6 + 2
            walk = longseq.walk_start(st, tn, tm, mode)
            rwalk = walk.clone()
            cnt = torch.zeros(B6, dtype=torch.int32, device=dev)
            rcnt = cnt.clone()
            mv = torch.zeros((-(-L // 4), B6), dtype=torch.uint8, device=dev)
            rmv = mv.clone()
            band = torch.zeros((B6, longseq.band_bytes(C, NP6)),
                               dtype=torch.uint8, device=dev)
            rband = band.clone()
            nck6 = longseq.n_ckpts(NP6, C)
            rbands = torch.zeros((nck6,) + tuple(band.shape),
                                 dtype=torch.uint8, device=dev)
            for sk in range(nck6 - 1, -1, -1):
                ms, _ = event_ms(lambda: longseq.fill_band(
                    tab, t1, t2, tn, tm, ck, band, sk=sk, **args))
                pms, _ = event_ms(lambda: longseq.fill_band_ref(
                    tab, t1, t2, tn, tm, ck, rband, sk=sk, **args))
                p6["K4"][0] += ms
                p6["K4"][1] += pms
                if band_err(band, rband, n6, m6, C, NP6, sk) != 0.0:
                    fail(f"K4 {mname} C={C} band {sk}: differs from the "
                         "plain refill")
                rbands[sk] = rband
                kw = dict(sk=sk, C=C, MP=NP6, L=L, local=mode == LOCAL)
                ms, _ = event_ms(lambda: longseq.walk_segment(
                    band, walk, cnt, mv, **kw))
                pms, _ = event_ms(lambda: longseq.walk_segment_ref(
                    band, rwalk, rcnt, rmv, **kw))
                p6["K5"][0] += ms
                p6["K5"][1] += pms
                if state_err((walk, cnt, mv), (rwalk, rcnt, rmv)) != 0.0:
                    fail(f"K5 {mname} C={C} band {sk}: differs from the "
                         "plain walk")
            if not bool((walk[:, 3] == 1).all()) or int(cnt.max()) == 0:
                fail(f"long route {mname} C={C}: a walk did not finish")
            # every band in one K4 launch (most pairs have no rows in the
            # lower bands) against the plain refills above
            bands = torch.zeros_like(rbands)
            longseq.fill_bands(tab, t1, t2, tn, tm, ck, bands, sk0=0, **args)
            for sk in range(nck6):
                if band_err(bands[sk], rbands[sk], n6, m6, C, NP6, sk):
                    fail(f"K4 {mname} C={C}: band {sk} of a {nck6}-band "
                         "launch differs from the plain refill")
    say("phase 6 K3/K4/K5: 3 modes x C in "
        f"({longseq.DEFAULT_CKPT_ROWS}, 64), {B6} pairs up to "
        f"{NP6}x{NP6}: stats, checkpoints, band bytes (band by band and "
        "every band in one K4 launch), walk states, counts and moves equal "
        "to the plain versions; summed ms kernel / plain: "
        + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in p6.items()))
    del got, ref, band, rband, bands, rbands
    phase6_wide(dev, modes)
    say(f"phase 6 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 7: the long route against the ordinary route
    rng7 = np.random.default_rng(SEED + 7)
    letters = np.array(list(LETTERS))

    def prot(k):
        return "".join(rng7.choice(letters, k))

    pairs7 = []
    for k in range(16):
        a = prot(int(rng7.integers(1500, 4001)))
        b = prot(int(rng7.integers(1500, 4001)))
        if k % 2 == 0:  # a shared stretch: a long local alignment
            b = b[:300] + a[500:1400] + b[1200:]
        pairs7.append((a, b))
    for mode, mname in modes:
        reset_launches()
        t0 = time.perf_counter()
        got = BatchAligner(mode=mode, device="cuda",
                           longseq_cells=1).align_pairs(pairs7)
        t_long = time.perf_counter() - t0
        long_counts = launch_counts("K3", "K4", "K5")
        if min(long_counts.values()) == 0:
            fail(f"phase 7 {mname}: the long route did not run "
                 f"{long_counts}")
        t0 = time.perf_counter()
        want = BatchAligner(mode=mode, device="cuda").align_pairs(pairs7)
        t_ord = time.perf_counter() - t0
        for k, (g, w) in enumerate(zip(got, want)):
            if (g.aligned1, g.aligned2, g.score, g.start1, g.end1, g.start2,
                    g.end2) != (w.aligned1, w.aligned2, w.score, w.start1,
                                w.end1, w.start2, w.end2):
                fail(f"phase 7 {mname} pair {k}: long route differs")
        say(f"phase 7 {mname}: 16 pairs of 1500..4000 a side, long route "
            f"{t_long:.3f} s (launches {json.dumps(long_counts)}) vs "
            f"ordinary {t_ord:.3f} s: every field equal")

    say(f"phase 7 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 8: the long route at a real size
    rng8 = np.random.default_rng(SEED)
    pairs8 = [mutated_pair(DNA_LEN, rng8, "ACGT")
              for _ in range(DNA_PAIRS)]
    dna = SubstitutionMatrix.match_mismatch(5.0, -4.0)
    cells8 = sum(len(a) * len(b) for a, b in pairs8)
    full_tb = sum(bucket_len(len(a)) * bucket_len(len(b)) for a, b in pairs8)
    lengths = [(len(a), len(b)) for a, b in pairs8]
    run8 = {}
    for mode, mname in modes:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        eng = BatchAligner(scoring_matrix=dna, gap_open=10.0, gap_extend=0.5,
                           mode=mode, device="cuda")
        t0 = time.perf_counter()
        res = eng.align_pairs(pairs8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts("K1", "K2", "K3", "K4", "K5")
        peak = torch.cuda.max_memory_allocated()
        if counts["K1"] or counts["K2"] or not all(
                counts[k] for k in ("K3", "K4", "K5")):
            fail(f"phase 8 {mname}: launches {counts}")
        run8[mname] = counts
        og, eg = eng.config.og, eng.config.eg
        for k, (r, (a, b)) in enumerate(zip(res, pairs8)):
            if not np.isfinite(r.score):
                fail(f"phase 8 {mname} pair {k}: score {r.score}")
            s = rescore(r.aligned1, r.aligned2, dna, og, eg, mode, LOCAL,
                        GLOCAL)
            if s != r.score:
                fail(f"phase 8 {mname} pair {k}: re-scored {s}, reported "
                     f"{r.score}")
            if mode != LOCAL:
                if (r.aligned1.replace("-", ""), r.aligned2.replace("-", "")
                        ) != (a, b):
                    fail(f"phase 8 {mname} pair {k}: residues lost")
                continue
            core = [(x, y) for x, y in zip(r.aligned1, r.aligned2)]
            while core and "-" in core[0]:
                core.pop(0)
            while core and "-" in core[-1]:
                core.pop()
            t1s = "".join(x for x, _ in core)
            t2s = "".join(y for _, y in core)
            rc = recalc_score(t1s, t2s, dna, -og, -eg)
            ident = sum(x == y for x, y in core) / max(len(core), 1)
            if rc != r.score or ident < 0.9:
                fail(f"phase 8 local pair {k}: recalc_score {rc} vs "
                     f"{r.score}, identity {ident:.4f}")
        say(f"phase 8 {mname}: {DNA_PAIRS} DNA pairs {lengths}, long route "
            f"wall {wall:.3f} s, {cells8 / wall / 1e9:.4f} Gcells/s over "
            f"{cells8} true cells, peak device memory {peak / 1e9:.3f} GB "
            f"(one pair's full pointer matrix would need "
            f"{full_tb / DNA_PAIRS / 1e9:.3f} GB, all {DNA_PAIRS} "
            f"{full_tb / 1e9:.3f} GB); "
            f"launches {json.dumps(counts)}; every alignment re-scores to "
            f"its score; on {card}")

    # K3 beside its plain version at phase 8's shapes, in LOCAL (the argmax
    # over every band; the plain fill runs ~60 launches a row, about a
    # minute); K4 and K5 at phase 8's own shapes in GLOBAL: one group of
    # bands as the route refills them (the first group the walks cross,
    # every walk starts at (n, m)), one band alone, and every band of the
    # bucket in the route's groups
    sm8 = dna
    ch8 = one_chunk(pairs8, sm8)
    B8, NP8, MP8 = ch8.shape
    u1, u2, un, um = (torch.from_numpy(a).to(dev) for a in ch8)
    tab8 = torch.from_numpy(np.asarray(sm8.table, np.float32)).to(dev)
    C = longseq.DEFAULT_CKPT_ROWS
    args = dict(mode=LOCAL, og=-10.0, eg=-0.5, C=C)
    longseq.fill_checkpointed(tab8, u1, u2, un, um, **args)
    k3_ms, got = timed(lambda: longseq.fill_checkpointed(
        tab8, u1, u2, un, um, **args), 3)
    k3_plain_ms, ref = event_ms(lambda: longseq.fill_checkpointed_ref(
        tab8, u1, u2, un, um, **args))
    k3_err = ckpt_err(got, ref, ch8.n, ch8.m, C)
    if k3_err != 0.0:
        fail(f"K3 at phase 8's shapes: max error {k3_err}")
    del got, ref
    lengths8 = list(zip(ch8.n.tolist(), ch8.m.tolist()))
    ck_rows = sum((x // C) * y for x, y in lengths8)
    k3_bound = bound(CELL_FLOPS[LOCAL] * sum(x * y for x, y in lengths8),
                     sum(x + y for x, y in lengths8) + 12 * ck_rows
                     + 32 * B8)
    args = dict(mode=GLOBAL, og=-10.0, eg=-0.5, C=C)
    # the SM clock, read while ten K3 launches run back to back
    for _ in range(10):
        st, ck = longseq.fill_checkpointed(tab8, u1, u2, un, um, **args)
    clock_mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    L8 = NP8 + MP8 + 2
    nck8 = longseq.n_ckpts(NP8, C)
    G8 = longseq.group_bands(B8, NP8, MP8, batch.tb_budget(), C)
    bands = torch.empty((G8, B8, longseq.band_bytes(C, MP8)),
                        dtype=torch.uint8, device=dev)
    # every group of the mode as the route takes it, top down: K4 refills
    # it, K5 walks it in one launch, and the plain walk the same bands from
    # the same state; K4 is held against its plain refill on the first
    # group of full bands
    walk = longseq.walk_start(st, un, um, GLOBAL)
    cnt = torch.zeros(B8, dtype=torch.int32, device=dev)
    mv = torch.zeros((-(-L8 // 4), B8), dtype=torch.uint8, device=dev)
    rwalk, rcnt, rmv = walk.cpu(), cnt.cpu(), mv.cpu()
    k4_ms = k4_plain_ms = None
    k4_err = k5_err = 0.0
    k5_ms = k5_plain_ms = 0.0
    k5_groups, k5_bands = [], 0
    for top in range(nck8 - 1, -1, -G8):
        sk0 = max(0, top - G8 + 1)
        g = top - sk0 + 1
        group = bands[:g]
        ms, _ = event_ms(lambda: longseq.fill_bands(
            tab8, u1, u2, un, um, ck, group, sk0=sk0, **args))
        if k4_ms is None and g == G8 and (top + 1) * C <= int(ch8.n.min()):
            k4_ms, k4_sk0, k4_top = ms, sk0, top
            rbands = torch.zeros_like(bands)
            k4_plain_ms, _ = event_ms(lambda: longseq.fill_bands_ref(
                tab8, u1, u2, un, um, ck, rbands, sk0=sk0, **args))
            k4_err = max(band_err(bands[q], rbands[q], ch8.n, ch8.m, C, MP8,
                                  sk0 + q) for q in range(G8))
            del rbands
        kw = dict(sk0=sk0, C=C, MP=MP8, L=L8, local=False)
        ms, _ = event_ms(lambda: longseq.walk_segments(group, walk, cnt, mv,
                                                       **kw))
        pms, _ = cpu_ms(lambda gc: longseq.walk_segments_ref(
            gc, rwalk, rcnt, rmv, **kw), group)
        k5_ms += ms
        k5_plain_ms += pms
        k5_groups.append(ms)
        k5_bands += g
        k5_err = max(k5_err, state_err((walk.cpu(), cnt.cpu(), mv.cpu()),
                                       (rwalk, rcnt, rmv)))
    if k4_ms is None:
        fail("phase 8: no group of full bands")
    if k4_err != 0.0:
        fail(f"K4 at phase 8's shapes, bands {k4_sk0}..{k4_top}: max error "
             f"{k4_err}")
    if k5_err != 0.0:
        fail(f"K5 at phase 8's shapes: a group walk differs from the plain "
             f"walk by {k5_err}")
    if not bool((walk[:, 3] == 1).all()):
        fail("phase 8: a GLOBAL walk did not reach (0, 0)")
    sk0, top = k4_sk0, k4_top
    band_cells = sum(min(C, max(int(x) - (sk0 + g) * C, 0)) * int(y)
                     for g in range(G8) for x, y in zip(ch8.n, ch8.m))
    k4_bound = bound(CELL_FLOPS[GLOBAL] * band_cells,
                     band_cells + G8 * (12 * int(ch8.m.sum())
                                        + B8 * C + int(ch8.m.sum())))
    longseq.fill_bands(tab8, u1, u2, un, um, ck, bands, sk0=sk0, **args)
    one = torch.empty_like(bands[0])
    k4_one_ms, _ = event_ms(lambda: longseq.fill_band(
        tab8, u1, u2, un, um, ck, one, sk=top, **args))
    if band_err(one, bands[G8 - 1], ch8.n, ch8.m, C, MP8, top) != 0.0:
        fail(f"K4 at phase 8's shapes: band {top} alone differs from its "
             "group's")
    del one

    def all_bands():
        for hi in range(nck8 - 1, -1, -G8):
            lo = max(0, hi - G8 + 1)
            longseq.fill_bands(tab8, u1, u2, un, um, ck, bands[:hi - lo + 1],
                               sk0=lo, **args)

    k4_all_ms, _ = event_ms(all_bands)
    # K5's bound: what the walks must read and write, a pointer byte a
    # step, the moves and the states; beside it, as context, the bytes of
    # the windows the kernel stages (C bytes a diagonal; a step crosses one
    # diagonal, a match two) and the chain of the longest walk's steps at
    # one dependent shared-memory read a step
    steps = int(cnt.sum())
    crossed = steps + matches(mv, cnt)
    k5_bound = bound(STEP_OPS * steps, steps + steps / 4 + 20 * B8)
    k5_window_mb = C * crossed / 1e6
    k5_chain_ms = int(cnt.max()) * SMEM_STEP_CYCLES / (clock_mhz * 1e3)
    del bands
    # K3: SM-cycles a band-step (one warp's step over its band's C rows),
    # the card's SMs over every band's steps (sw_band.cuh band_steps:
    # m + 31 a band); K4 alone: a block of C / 32 one-row warps a band,
    # cycles a block step (block_steps: m + 31 a warp, LAG = 96 steps
    # between its warps)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k3_band_steps = sum(-(-x // C) * (y + 31) for x, y in lengths8)
    k3_cyc = k3_ms * 1e3 * clock_mhz * sms / k3_band_steps
    k4_steps = max(int(y) + 31 + (C // 32 - 1) * 96 for y in ch8.m)
    k4_cyc = k4_one_ms * 1e3 * clock_mhz / k4_steps
    say(f"phase 8 kernels at the long route's shapes ({B8} pairs, "
        f"{NP8}x{MP8}, C={C}, {nck8} bands a pair, {G8} a K4 launch) on "
        f"{card}: K3 (LOCAL) {k3_ms:.3f} ms vs plain {k3_plain_ms:.3f} ms, "
        f"bound {k3_bound[0]:.4f} ms; K4 (GLOBAL, bands {sk0}..{top} in one "
        f"launch) {k4_ms:.3f} ms vs plain {k4_plain_ms:.3f} ms, bound "
        f"{k4_bound[0]:.6f} ms; K4 one band {k4_one_ms:.3f} ms; K4 over all "
        f"{nck8} bands in {-(-nck8 // G8)} launches {k4_all_ms:.3f} ms; K5 "
        f"(GLOBAL, every group of the mode: {len(k5_groups)} launches over "
        f"{k5_bands} bands, {steps} steps) {k5_ms:.3f} ms, "
        f"{k5_ms / len(k5_groups):.4f} ms a group, "
        f"{k5_ms * 1e3 / k5_bands:.2f} us a band, vs plain (CPU) "
        f"{k5_plain_ms:.3f} ms, bound {k5_bound[0]:.6f} ms (windows: "
        f"{crossed} diagonals crossed, {k5_window_mb:.3f} MB; the longest "
        f"walk's {int(cnt.max())} steps at {SMEM_STEP_CYCLES} cycles a "
        f"shared-memory read: {k5_chain_ms:.4f} ms); "
        "all equal to the plain versions; SM clock during K3 "
        f"{clock_mhz:.0f} MHz: K3 "
        f"{k3_band_steps} band-steps on {sms} SMs, {k3_cyc:.1f} SM-cycles a "
        f"band-step; K4 one band {k4_steps} block steps, {k4_cyc:.1f} "
        "cycles a block step")
    launches8 = {k: sum(run8[mn][k] for _, mn in modes)
                 for k in ("K3", "K4", "K5")}
    for name, src, repl, k, err, ms, pms, bd in (
            ("K3 checkpointed fill", "longseq_fill.cu",
             "smithwaterman_tpu/ops/pallas_dp.py:890", "K3", k3_err, k3_ms,
             k3_plain_ms, k3_bound),
            ("K4 band refill", "longseq_fill.cu",
             "smithwaterman_tpu/ops/pallas_dp.py:958", "K4", k4_err, k4_ms,
             k4_plain_ms, k4_bound),
            ("K5 segment walk", "seg_walk.cu",
             "smithwaterman_tpu/ops/longseq.py:277", "K5", k5_err,
             k5_ms / len(k5_groups), k5_plain_ms / len(k5_groups),
             (k5_bound[0] / len(k5_groups), k5_bound[1]))):
        records.append({
            "name": name, "route": "cuda",
            "source": f"smithwaterman_tpu_torch/csrc/{src}",
            "replaces": repl, "launches": launches8[k], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bd[0],
            "bound_by": bd[1], "library_ms": None})
    say(f"phase 8 done at {time.perf_counter() - t_start:.1f} s")

    # ---- phase 9: K6, K7, K8 against their plain versions
    phase9(dev, card, modes)
    say(f"phase 9 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 10: banded alignment at a real size
    records += phase10(dev, card, modes)
    say(f"phase 10 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 11: K9, K10, K11 against their plain versions
    phase11(dev, card, modes, cases, ragged, pair_masks, fill_err, walk_err)
    say(f"phase 11 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 12: the opt-in routes at the main path's full width
    records += phase12(dev, card, modes, pairs, chunks, results, scores,
                       walls, walk_steps, times, pair_masks, fill_err,
                       walk_err)
    say(f"phase 12 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 13: K12, K13 against their plain versions
    phase13(dev, card, modes)
    say(f"phase 13 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 14: the striped path at a real size
    records += phase14(dev, card, modes)
    say(f"phase 14 done at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 15: pair sharding, the web surface, the graft entry
    sharded = phase15(dev, card, modes, pairs, chunks, results, scores,
                      walls)
    for rec in records:
        kernel = rec["name"].split()[0]
        if kernel in sharded:
            rec["launches_sharded"] = sharded[kernel]
    say(f"phase 15 done at {time.perf_counter() - t_start:.1f} s")
    say(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}"
        f" s on {card}")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
