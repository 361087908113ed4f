"""Build, load and launch the hand-written CUDA kernels.

``csrc/fill.cu`` (K1, and K10 with run bytes), ``csrc/walk.cu`` (K2),
``csrc/longseq_fill.cu`` (K3, K4), ``csrc/seg_walk.cu`` (K5),
``csrc/banded_scores.cu`` (K6), ``csrc/banded_fill.cu`` (K7),
``csrc/banded_walk.cu`` (K8), ``csrc/diag_fill.cu`` (K9),
``csrc/token_walk.cu`` (K11) and ``csrc/striped_fill.cu`` (K12, K13) are
compiled on first use with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and linked into one shared library with a plain C
interface under the package's ``_build/`` directory, loaded with ctypes.
No PyTorch header is compiled, so the build takes seconds.

Every launch goes through one wrapper here (:func:`fill`, :func:`walk`,
:func:`ckpt_fill`, :func:`band_fill`, :func:`seg_walk`,
:func:`banded_scores`, :func:`banded_fill`, :func:`banded_walk`,
:func:`diag_fill`, :func:`walk_tokens`, :func:`striped_block`,
:func:`striped_grid`), which
checks the tensors the kernel takes, passes each pointer and the current
stream as ``c_void_p``, and raises when the C entry point reports a CUDA
error.  The callers (``ops/fill_dp.py``, ``ops/device_walk.py``,
``ops/longseq.py``, ``ops/banded.py``, ``ops/diag_dp.py``,
``parallel/seq_tiled.py``) count launches.  This module
imports nothing CUDA-specific until a kernel is built.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Optional

import torch

from . import native

KERNEL_SOURCES = tuple(
    os.path.join(native.CSRC, f)
    for f in ("fill.cu", "walk.cu", "longseq_fill.cu", "seg_walk.cu",
              "banded_scores.cu", "banded_fill.cu", "banded_walk.cu",
              "diag_fill.cu", "token_walk.cu", "striped_fill.cu")
)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + (
    "-std=c++17", "-O3",
    # exact f32: a fused multiply-add or a reordered sum can flip a tie
    # and with it an alignment string
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, into the build log
    "-Xptxas", "-v",
)
LINK_FLAGS = ARCH + (
    "-shared",
    # link the CUDA runtime as a shared library: the loader then hands the
    # kernels the libcudart PyTorch already loaded, so both share one
    # runtime (the static default would put a second one in the process)
    "-cudart", "shared",
)
# codes the kernels take (csrc/sw_cell.cuh SMEM_K: tables of up to 64
# symbols are copied into shared memory, larger ones read from device
# memory): uint8, or int16 for tables past 255 symbols, up to int16's range
CODE_DTYPES = (torch.uint8, torch.int16)
MAX_K = 32767

_LIB: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Build the kernel library if needed; return its path (the nvcc
    report, with ptxas's per-kernel registers and spills, is in
    ``<path>.log``)."""
    nvcc = nvcc_path()
    # where the toolkit's libcudart is, should PyTorch not have loaded one
    rpath = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")
    return native.build_shared(
        "swkernels", (nvcc,) + COMPILE_FLAGS,
        (nvcc,) + LINK_FLAGS + ("-Xlinker", f"-rpath,{rpath}"),
        KERNEL_SOURCES, native.headers(),
    )


def lib() -> ctypes.CDLL:
    """The kernel library, built if needed, with every argtype set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = ctypes.CDLL(build())
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    so.sw_fill_launch.restype = i32
    so.sw_fill_launch.argtypes = [
        i32, i32, i32, i32, vp, i32, i32, vp, vp, vp, vp, i64, vp, vp, vp,
        vp, f32, f32, vp,
    ]
    so.sw_walk_launch.restype = i32
    so.sw_walk_launch.argtypes = [
        i32, vp, vp, vp, vp, i64, i64, i32, i32, vp, vp, vp,
    ]
    so.sw_ckpt_fill_launch.restype = i32
    so.sw_ckpt_fill_launch.argtypes = native.LONG_FILL_ARGS + [
        vp, vp, vp, vp, vp, f32, f32, vp,
    ]
    so.sw_band_fill_launch.restype = i32
    so.sw_band_fill_launch.argtypes = native.LONG_FILL_ARGS + [
        i32, i32, vp, vp, vp, vp, f32, f32, vp,
    ]
    so.sw_seg_walk_launch.restype = i32
    so.sw_seg_walk_launch.argtypes = [
        i32, vp, i32, i64, i64, i32, i32, i64, vp, vp, vp, vp,
    ]
    so.sw_banded_scores_launch.restype = i32
    so.sw_banded_scores_launch.argtypes = [
        vp, i32, i32, vp, vp, vp, vp, i64, i64, i64, i32, vp, i32, i32, vp,
        vp,
    ]
    so.sw_banded_fill_launch.restype = i32
    so.sw_banded_fill_launch.argtypes = [
        i32, vp, vp, vp, i64, i64, i32, vp, vp, vp, f32, f32, vp, vp,
    ]
    so.sw_banded_walk_launch.restype = i32
    so.sw_banded_walk_launch.argtypes = [
        i32, vp, vp, vp, vp, i64, i64, i32, i64, vp, vp, vp, vp, vp,
    ]
    so.sw_banded_walk_rows.restype = i32
    so.sw_banded_walk_rows.argtypes = [i32]
    so.sw_diag_fill_launch.restype = i32
    so.sw_diag_fill_launch.argtypes = [
        i32, vp, i32, i32, vp, vp, vp, i64, vp, vp, f32, f32, vp,
    ]
    so.sw_walk_tokens_launch.restype = i32
    so.sw_walk_tokens_launch.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp, vp, vp,
    ]
    so.sw_striped_block_launch.restype = i32
    so.sw_striped_block_launch.argtypes = native.STRIPED_BLOCK_ARGS + [
        vp, vp, vp,  # scratch, grid, stream
    ]
    so.sw_striped_grid_launch.restype = i32
    so.sw_striped_grid_launch.argtypes = native.STRIPED_GRID_ARGS + [
        vp, vp, vp,
    ]
    _LIB = so
    return so


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device,
           shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def fill(table, codes1, codes2, desc, order, tb, carry, stats, *,
         mode: int, traceback: bool, og: float, eg: float, rows: int,
         warps: int = 1, run=None) -> None:
    """Launch K1 (csrc/fill.cu) on the current stream over the pairs whose
    descriptor rows ``order`` (int32) lists, ``rows`` (1, 2, 4 or 8) rows a
    lane and ``warps`` warps a pair (capped by the kernel's registers), or
    K10 when given a ``run`` pool (tb's size; needs ``traceback``); see
    fill_dp.launch."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {dev}")
    K = _check_table(table, "K1")
    B = desc.shape[0]
    _check(table, "table", torch.float32, dev)
    _check_codes(codes1, codes2, dev)
    _check(desc, "desc", torch.int64, dev, (B, 8))
    _check(order, "order", torch.int32, dev)
    _check(carry, "carry", torch.float32, dev)
    _check(stats, "stats", torch.float32, dev, (B, 8))
    if order.dim() != 1 or not 1 <= order.shape[0] <= B:
        raise ValueError(f"order must list 1 to {B} descriptor rows, got "
                         f"shape {tuple(order.shape)}")
    if rows not in (1, 2, 4, 8):
        raise ValueError(f"K1 runs 1, 2, 4 or 8 rows a lane, got {rows}")
    if not 1 <= warps <= 32:
        raise ValueError(f"K1 runs 1 to 32 warps a pair, got {warps}")
    if traceback:
        _check(tb, "tb", torch.uint8, dev)
    if run is not None:
        if not traceback:
            raise ValueError("K10's run bytes need a traceback fill")
        _check(run, "run", torch.uint8, dev, tuple(tb.shape))
    # a launch goes to the current device: make it the tensors' card
    with torch.cuda.device(dev):
        rc = lib().sw_fill_launch(
            int(mode), 1 if traceback else 0, int(rows), int(warps),
            table.data_ptr(), K,
            codes1.element_size(), codes1.data_ptr(), codes2.data_ptr(),
            desc.data_ptr(), order.data_ptr(), order.shape[0],
            tb.data_ptr() if traceback else None,
            None if run is None else run.data_ptr(), carry.data_ptr(),
            stats.data_ptr(), float(og), float(eg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K1 (fill)" if run is None else "K10 (fill with runs)")


def _check_walk(what, tb, desc, stats, cnt, order, T, C):
    """The walks' common inputs (K2, K11); returns B."""
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    B = desc.shape[0]
    _check(tb, "tb", torch.uint8, dev)
    _check(desc, "desc", torch.int64, dev, (B, 8))
    _check(stats, "stats", torch.float32, dev, (B, 8))
    _check(cnt, "cnt", torch.int32, dev, (B,))
    _check(order, "order", torch.int32, dev, (B,))
    if T < 1 or C < 1:
        raise ValueError(f"{what} takes tiles of T, C >= 1, got T={T}, C={C}")
    return B


def walk(tb, desc, stats, cnt, moves, *, local: bool, L: int, order,
         T: int, C: int) -> None:
    """Launch K2 (csrc/walk.cu) on the current stream, a warp a pair,
    tiles of T rows x C columns, the pairs started in ``order`` ((B,)
    int32, a permutation of the descriptor rows); see
    device_walk.walk_packed."""
    B = _check_walk("K2", tb, desc, stats, cnt, order, T, C)
    dev = tb.device
    _check(moves, "moves", torch.uint8, dev, (-(-L // 4), B))
    with torch.cuda.device(dev):
        rc = lib().sw_walk_launch(
            1 if local else 0, tb.data_ptr(), desc.data_ptr(),
            stats.data_ptr(), order.data_ptr(), B, int(L), int(T), int(C),
            cnt.data_ptr(), moves.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K2 (walk)")


def _check_table(table: torch.Tensor, what: str) -> int:
    K = table.shape[0]
    if table.dim() != 2 or table.shape[1] != K or not 1 <= K <= MAX_K:
        raise ValueError(
            f"{what} takes a square table of 1 to {MAX_K} symbols, got "
            f"{tuple(table.shape)}")
    return K


def _check_codes(codes1, codes2, device, shape1=None, shape2=None) -> None:
    """Both code tensors uint8, or both int16 (tables past 255 symbols)."""
    if codes1.dtype not in CODE_DTYPES:
        raise ValueError(f"codes have dtype {codes1.dtype}, expected uint8 "
                         "or int16")
    _check(codes1, "codes1", codes1.dtype, device, shape1)
    _check(codes2, "codes2", codes1.dtype, device, shape2)


def _check_pairs(table, codes1, codes2, n, m, C: int, what: str):
    """The long-sequence kernels' common inputs; returns (K, B, NP, MP)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    K = _check_table(table, what)
    if C not in (32, 64, 128, 256):
        raise NotImplementedError(
            f"{what} fills a band of C rows with warps of 32 lanes (K3 one "
            f"warp of C / 32 rows a lane, K4 C / 32 warps of one row a "
            f"lane): C must be 32, 64, 128 or 256, got {C}")
    B, NP = codes1.shape
    MP = codes2.shape[1]
    _check(table, "table", torch.float32, dev)
    _check_codes(codes1, codes2, dev, (B, NP), (B, MP))
    _check(n, "n", torch.int32, dev, (B,))
    _check(m, "m", torch.int32, dev, (B,))
    return K, B, NP, MP


def ckpt_fill(table, codes1, codes2, n, m, ckm, ckx, cky, stats, scratch,
              *, mode: int, C: int, og: float, eg: float) -> None:
    """Launch K3 (csrc/longseq_fill.cu) on the current stream; see
    ops/longseq.fill_checkpointed.  ``scratch``: int32 of
    ``ckpt_scratch_words(B, ceil(NP / C))`` words, zeroed."""
    K, B, NP, MP = _check_pairs(table, codes1, codes2, n, m, C, "K3")
    dev = table.device
    nck = -(-NP // C)
    for name, t in (("ckm", ckm), ("ckx", ckx), ("cky", cky)):
        _check(t, name, torch.float32, dev, (B, nck, MP))
    _check(stats, "stats", torch.float32, dev, (B, 8))
    _check(scratch, "scratch", torch.int32, dev,
           (ckpt_scratch_words(B, nck),))
    with torch.cuda.device(dev):
        rc = lib().sw_ckpt_fill_launch(
            int(mode), table.data_ptr(), K, codes1.element_size(),
            codes1.data_ptr(), codes2.data_ptr(), n.data_ptr(), m.data_ptr(),
            B, NP, MP, int(C), ckm.data_ptr(), ckx.data_ptr(), cky.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), float(og), float(eg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K3 (checkpointed fill)")


def ckpt_scratch_words(B: int, nck: int) -> int:
    """K3's scratch words (the layout of csrc/sw_band.cuh ckpt_scratch):
    the ticket, each pair's finished bands, each band's published tiles and
    LOCAL best."""
    return 1 + B + 4 * B * nck


def band_fill(table, codes1, codes2, n, m, ckm, ckx, cky, band, *,
              mode: int, C: int, sk0: int, og: float, eg: float) -> None:
    """Launch K4 (csrc/longseq_fill.cu) on the current stream: bands
    sk0 .. sk0 + G - 1 into ``band`` (G, B, (C + MP) * C); see
    ops/longseq.fill_bands."""
    K, B, NP, MP = _check_pairs(table, codes1, codes2, n, m, C, "K4")
    dev = table.device
    nck = -(-NP // C)
    for name, t in (("ckm", ckm), ("ckx", ckx), ("cky", cky)):
        _check(t, name, torch.float32, dev, (B, nck, MP))
    G = band.shape[0]
    _check(band, "band", torch.uint8, dev, (G, B, (C + MP) * C))
    if not (G >= 1 and 0 <= sk0 and sk0 + G <= nck):
        raise ValueError(f"bands {sk0}..{sk0 + G - 1} outside 0..{nck - 1}")
    with torch.cuda.device(dev):
        rc = lib().sw_band_fill_launch(
            int(mode), table.data_ptr(), K, codes1.element_size(),
            codes1.data_ptr(), codes2.data_ptr(), n.data_ptr(), m.data_ptr(),
            B, NP, MP, int(C), int(sk0), int(G), ckm.data_ptr(),
            ckx.data_ptr(), cky.data_ptr(), band.data_ptr(), float(og),
            float(eg), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K4 (band refill)")


def seg_walk(bands, walk, cnt, moves, *, local: bool, C: int, sk0: int,
             MP: int, L: int) -> None:
    """Launch K5 (csrc/seg_walk.cu) on the current stream over the group
    ``bands`` (G, B, (C + MP) * C), band sk0 + g at [g]; see
    ops/longseq.walk_segments."""
    dev = bands.device
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got {dev}")
    G, B = bands.shape[0], walk.shape[0]
    _check(bands, "bands", torch.uint8, dev, (G, B, (C + MP) * C))
    _check(walk, "walk", torch.int32, dev, (B, 4))
    _check(cnt, "cnt", torch.int32, dev, (B,))
    _check(moves, "moves", torch.uint8, dev, (-(-L // 4), B))
    with torch.cuda.device(dev):
        rc = lib().sw_seg_walk_launch(
            1 if local else 0, bands.data_ptr(), G, B, int(MP), int(C),
            int(sk0), int(L), walk.data_ptr(), cnt.data_ptr(),
            moves.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K5 (segment walk)")


def _check_lengths(B: int, dev, what: str, **lengths) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, got {dev}")
    for name, t in lengths.items():
        _check(t, name, torch.int32, dev, (B,))


# K6's tiles (csrc/sw_scores.cuh): rows a tile it may take, the columns of
# S a tile aims at (128 KB of scores), and blocks of 256 threads an SM in
# its persistent grid
SCORES_TILES = (64, 32, 16, 8)
SCORES_TILE_COLS = 32768
SCORES_BLOCKS_PER_SM = 8


def scores_plan(B: int, NP: int, W: int, sms: int):
    """K6's launch over B pairs of NP rows of W columns on a card of
    ``sms`` SMs: ``(T, blocks)``.  T, the rows a tile, is the largest of
    :data:`SCORES_TILES` whose tile holds at most
    :data:`SCORES_TILE_COLS` columns of S, else the smallest; blocks, the
    persistent grid, :data:`SCORES_BLOCKS_PER_SM` an SM, at most the
    tiles.  On an H100 (``scripts/ab_banded.py --plans``, PERF.md) this
    is within 1 % of the best of T in 8-64 at 4 or 8 blocks an SM at phase
    10a (W = 512: T = 64), 10b (W = 2048: T = 16) and phase 9 at W = 2048
    (T = 16), and 2.5 % at W = 128 (T = 64 against 32), where picking T
    for 4 tiles a block (T = 8) was 43 % slower."""
    T = SCORES_TILES[-1]
    for t in SCORES_TILES:
        if t * W <= SCORES_TILE_COLS:
            T = t
            break
    return T, min(SCORES_BLOCKS_PER_SM * sms, B * -(-NP // T))


def banded_scores(table, codes1, codes2, n, m, S, *, W: int) -> dict:
    """Launch K6 (csrc/banded_scores.cu) on the current stream, tiles and
    grid from :func:`scores_plan`.  Returns the launch's shape (``rows`` a
    tile, ``blocks``, ``vec``: 16-byte stores, taken when W % 4 == 0 and
    S is 16-byte aligned, which the launcher checks); see
    ops/banded.banded_scores."""
    dev = table.device
    B, NP = codes1.shape
    MP = codes2.shape[1]
    _check_lengths(B, dev, "K6", n=n, m=m)
    K = _check_table(table, "K6")
    _check(table, "table", torch.float32, dev)
    _check_codes(codes1, codes2, dev, (B, NP), (B, MP))
    _check(S, "S", torch.float32, dev, (B, NP, W))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    T, blocks = scores_plan(B, NP, W, sms)
    vec = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib().sw_banded_scores_launch(
            table.data_ptr(), K, codes1.element_size(), codes1.data_ptr(),
            codes2.data_ptr(),
            n.data_ptr(), m.data_ptr(), B, NP, MP, int(W), S.data_ptr(),
            T, blocks, ctypes.byref(vec),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K6 (banded scores)")
    return {"rows": T, "blocks": blocks, "vec": bool(vec.value)}


# K7's rows a lane, R (csrc/sw_banded.cuh ROWS): a stripe of a pair is
# 32 R rows, one warp
BANDED_R = 2


def banded_stripes(NP: int) -> int:
    """K7's stripes of a pair of NP rows, 32 R rows each."""
    return -(-NP // (32 * BANDED_R))


def banded_scratch_words(B: int, NP: int, W: int) -> int:
    """K7's scratch words (the layout of csrc/sw_banded.cuh
    stripe_scratch): the ticket, each pair's finished stripes, each
    stripe's published tiles (these first :func:`banded_scratch_zeroed`
    words are zeroed before a launch), each stripe's LOCAL best and bottom
    row ((M, X, Y) rows of W + 32 R floats)."""
    NS = banded_stripes(NP)
    return banded_scratch_zeroed(B, NP) + 3 * B * NS * (1 + W + 32 * BANDED_R)


def banded_scratch_zeroed(B: int, NP: int) -> int:
    return 1 + B + B * banded_stripes(NP)


def banded_fill(S, n, m, scratch, tb, stats, *, mode: int, og: float,
                eg: float) -> dict:
    """Launch K7 (csrc/banded_fill.cu) on the current stream; ``scratch``
    int32 of :func:`banded_scratch_words` words, its first
    :func:`banded_scratch_zeroed` zero.  Returns the launch's shape
    (``rows`` a lane, ``stripes``: the tickets, B times a pair of NP
    rows', ``blocks``); see ops/banded.fill_banded."""
    dev = S.device
    B, NP, W = S.shape
    _check_lengths(B, dev, "K7", n=n, m=m)
    if W % 4:
        raise ValueError(f"K7 takes W a multiple of 4, got W={W}")
    _check(S, "S", torch.float32, dev)
    _check(scratch, "scratch", torch.int32, dev,
           (banded_scratch_words(B, NP, W),))
    _check(tb, "tb", torch.uint8, dev, (B, NP, W))
    _check(stats, "stats", torch.float32, dev, (B, 8))
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib().sw_banded_fill_launch(
            int(mode), S.data_ptr(), n.data_ptr(), m.data_ptr(), B, NP,
            int(W), scratch.data_ptr(), tb.data_ptr(),
            stats.data_ptr(), float(og), float(eg), ctypes.byref(grid),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K7 (banded fill)")
    return {"rows": BANDED_R, "stripes": B * banded_stripes(NP),
            "blocks": grid.value}


def banded_walk(tb, off, start, m, idx1, idx2, cnt, flags, *, local: bool,
                L: int) -> None:
    """Launch K8 (csrc/banded_walk.cu) on the current stream, its rows
    read through a ring of :func:`banded_walk_rows` rows a window; see
    ops/banded.walk_banded_device."""
    dev = tb.device
    B, NP, W = tb.shape
    _check_lengths(B, dev, "K8", m=m, cnt=cnt, flags=flags)
    _check(tb, "tb", torch.uint8, dev)
    _check(off, "off", torch.int32, dev, (B, NP + 1))
    _check(start, "start", torch.int32, dev, (B, 4))
    for name, t in (("idx1", idx1), ("idx2", idx2)):
        _check(t, name, torch.int32, dev, (B, L))
    with torch.cuda.device(dev):
        rc = lib().sw_banded_walk_launch(
            1 if local else 0, tb.data_ptr(), off.data_ptr(),
            start.data_ptr(), m.data_ptr(), B, NP, int(W), int(L),
            idx1.data_ptr(), idx2.data_ptr(), cnt.data_ptr(),
            flags.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K8 (banded walk)")


def banded_walk_rows(W: int) -> int:
    """K8's rows a window for a band of W bytes a row, 0 where it reads
    the rows straight from device memory (csrc/sw_banded.cuh walk_rows)."""
    return int(lib().sw_banded_walk_rows(int(W)))


def diag_fill(table, codes1, codes2, desc, scratch, stats, *, og: float,
              eg: float, R: int) -> None:
    """Launch K9 (csrc/diag_fill.cu) on the current stream, ``R`` columns
    a lane (2, 4 or 8); see ops/diag_dp.fill_diag."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {dev}")
    if not og <= eg <= 0.0:
        raise ValueError(f"K9 needs og <= eg <= 0, got og={og}, eg={eg}")
    if R not in (2, 4, 8):
        raise ValueError(f"K9 takes R in 2, 4, 8, got {R}")
    K = _check_table(table, "K9")
    B = desc.shape[0]
    _check(table, "table", torch.float32, dev)
    _check_codes(codes1, codes2, dev)
    _check(desc, "desc", torch.int64, dev, (B, 8))
    _check(scratch, "scratch", torch.float32, dev)
    _check(stats, "stats", torch.float32, dev, (B, 8))
    with torch.cuda.device(dev):
        rc = lib().sw_diag_fill_launch(
            int(R), table.data_ptr(), K, codes1.element_size(),
            codes1.data_ptr(), codes2.data_ptr(), desc.data_ptr(), B,
            scratch.data_ptr(), stats.data_ptr(), float(og), float(eg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K9 (wavefront score fill)")


def walk_tokens(tb, run, desc, stats, cnt, toks, *, local: bool, L: int,
                order, T: int, C: int) -> None:
    """Launch K11 (csrc/token_walk.cu) on the current stream, as
    :func:`walk` (``run`` at ``tb``'s address mod 16); see
    device_walk.walk_tokens."""
    B = _check_walk("K11", tb, desc, stats, cnt, order, T, C)
    dev = tb.device
    _check(run, "run", torch.uint8, dev, tuple(tb.shape))
    if (tb.data_ptr() - run.data_ptr()) % 16:
        raise ValueError("K11 takes tb and run at the same address mod 16")
    _check(toks, "toks", torch.uint8, dev, (L, B))
    with torch.cuda.device(dev):
        rc = lib().sw_walk_tokens_launch(
            1 if local else 0, tb.data_ptr(), run.data_ptr(), desc.data_ptr(),
            stats.data_ptr(), order.data_ptr(), B, int(L), int(T), int(C),
            cnt.data_ptr(), toks.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K11 (token walk)")


# shards one K12 launch takes (csrc/sw_striped.cuh MAX_SHARDS)
MAX_SHARDS = 64
# K12 / K13 cut a shard's W lanes into column tiles of one warp, L lanes a
# thread (csrc/striped_fill.cu): the narrower tiles give the shorter row a
# tile, the wider the shorter chain of tiles.  Tiles of 4 lanes a thread
# beat those of 8 nowhere beyond the spread between runs on an H100
# (PERF.md), so the kernels take 8 and 16 only.
STRIPED_LANES = (8, 16)
# A tile waits for its left neighbour's edges about E rows plus one
# handover (a fence, a flag and a load through L2: a few rows' time), so a
# chain of T tiles takes about T * (E + 4) row steps to fill: T at most a
# launch's rows / FILL_ROWS keeps the fill about as long as the rows.
STRIPED_FILL_ROWS = 8
# the most rows a publication carries (csrc/sw_striped.cuh HELD: the edge
# slots a reading tile loads at once)
STRIPED_MAX_E = 8


def striped_plan(W: int, rows: int, chains: int, sms: int):
    """K12 / K13's tiling of a launch of ``rows`` rows over ``chains``
    shards of ``W`` lanes (shards times pairs) on a card of ``sms`` SMs:
    ``(L, E)``.  L, the lanes a thread, is the smallest of
    :data:`STRIPED_LANES` whose tiles take at most one SM each and whose
    chain fills within the rows (:data:`STRIPED_FILL_ROWS`), else the
    widest.  E, the rows a tile publishes at once, is the largest power of
    two up to :data:`STRIPED_MAX_E` with E * E <= rows / T: a
    publication's fence and release cost the writing tile about a row's
    time, so E balances the fill (T * E rows) against the fences (rows /
    E).  On an H100 (PERF.md, ``scripts/ab_striped.py --plans``) this pick
    is within 1 % of the best of (L, E) in {4, 8, 16} x {1, 2, 4, 8} for K13
    at phase 14's 2048 x 65,536 (L = 16) and its band re-fill, and within
    the spread between runs for K12's steps of 64 rows at D = 4; where it
    takes L = 8, L = 16 is 10-19 % slower: K13 0.598 against 0.714 ms at
    512 x 2048, 3.097 against 3.440 at 2048 x 32,768 and 0.743 against
    0.821 at 8 pairs of 512 x 4096 (K12 at D = 4 on 512 x 2048 ties)."""
    lanes = STRIPED_LANES[-1]
    for L in STRIPED_LANES:
        T = -(-W // (32 * L))
        if chains * T <= sms and T * STRIPED_FILL_ROWS <= rows:
            lanes = L
            break
    T = -(-W // (32 * lanes))
    E = 1
    while 2 * E <= STRIPED_MAX_E and 4 * E * E * T <= rows:
        E *= 2
    return lanes, E


def striped_scratch_words(tiles: int, rows: int) -> int:
    """K12 / K13's scratch words for ``tiles`` tiles of ``rows`` rows."""
    return ((1 + tiles + 3) & ~3) + tiles * (rows + 1) * 4


def striped_scratch(tiles: int, rows: int, dev, scratch=None):
    """K12 / K13's scratch for ``tiles`` tiles of ``rows`` rows (the layout
    of csrc/sw_striped.cuh set_scratch: the ticket, each tile's count of
    published edge slots, each tile's rows + 1 slots of four floats), with
    the ticket and counts zeroed on the current stream: ``scratch`` when
    given (int32, at least that long), else a new tensor."""
    zeroed = (1 + tiles + 3) & ~3
    words = striped_scratch_words(tiles, rows)
    if scratch is None:
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _check(scratch, "scratch", torch.int32, dev)
    if scratch.numel() < words:
        raise ValueError(f"scratch has {scratch.numel()} words, the launch "
                         f"needs {words}")
    scratch[:zeroed].zero_()
    return scratch


def _striped_tiling(W: int, rows: int, chains: int, dev, scratch):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    L, E = striped_plan(W, rows, chains, sms)
    tiles = chains * -(-W // (32 * L))
    return L, E, tiles, striped_scratch(tiles, rows, dev, scratch)


def striped_block(S, n, m, rows, box, above, best, best_i, acc, tb, *,
                  ds, t: int, i0: int, K: int, W: int, s_lo: int, mode: int,
                  pen, scratch=None) -> dict:
    """Launch K12 (csrc/striped_fill.cu) on the current stream: step ``t``
    of the wavefront for the shards ``ds``; see parallel/seq_tiled.
    ``S`` (B, rows, cols) f32 with unit column stride holds row i0 + 1 of
    the fill at column ``s_lo``; ``tb`` is None or (B, tb_rows, MP)
    uint8; the tiling is :func:`striped_plan`'s; ``scratch`` is
    :func:`striped_scratch`'s tensor (made here when None).  Returns the
    launch's shape: its tiles of ``lanes`` lanes, ``E`` and ``blocks``."""
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {dev}")
    D = above.shape[0]
    B = n.shape[0]
    MP = D * W
    if not 0 < len(ds) <= MAX_SHARDS:
        raise ValueError(f"K12 takes 1..{MAX_SHARDS} shards, got {len(ds)}")
    if S.dtype != torch.float32 or S.dim() != 3 or S.stride(2) != 1:
        raise ValueError(f"S must be (B, rows, cols) f32 with unit column "
                         f"stride, got {S.dtype} {tuple(S.stride())}")
    if S.shape[0] != B or not s_lo <= min(ds) * W or \
            (max(ds) + 1) * W - s_lo > S.shape[2]:
        raise ValueError(f"S {tuple(S.shape)} at column {s_lo} does not hold "
                         f"shards {ds} of width {W}")
    _check_lengths(B, dev, "K12", n=n, m=m)
    _check(rows, "rows", torch.float32, dev, (2, 3, B, MP))
    _check(box, "box", torch.float32, dev, (2, D, B, K, 4))
    _check(above, "above", torch.float32, dev, (D, B, 4))
    _check(best, "best", torch.float32, dev, (B, MP))
    _check(best_i, "best_i", torch.int32, dev, (B, MP))
    _check(acc, "acc", torch.float32, dev, (D, B, 4))
    rows_needed = (t - min(ds) + 1) * K  # S's (and tb's) rows from i0 + 1
    if S.shape[1] < rows_needed:
        raise ValueError(f"S has {S.shape[1]} rows, step {t} needs "
                         f"{rows_needed}")
    if tb is not None:
        _check(tb, "tb", torch.uint8, dev)
        if tb.dim() != 3 or tuple(tb.shape)[::2] != (B, MP) or \
                tb.shape[1] < rows_needed:
            raise ValueError(f"tb has shape {tuple(tb.shape)}, expected "
                             f"({B}, >= {rows_needed}, {MP})")
    L, E, tiles, scratch = _striped_tiling(W, K, len(ds) * B, dev, scratch)
    dsa = (ctypes.c_int32 * len(ds))(*ds)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib().sw_striped_block_launch(
            int(mode), 0 if tb is None else 1, dsa, len(ds), int(t), int(i0),
            int(K), int(W), D, B, MP, S.data_ptr(), S.stride(0), S.stride(1),
            int(s_lo), n.data_ptr(), m.data_ptr(), rows.data_ptr(),
            box.data_ptr(), above.data_ptr(), best.data_ptr(),
            best_i.data_ptr(), acc.data_ptr(),
            None if tb is None else tb.data_ptr(),
            0 if tb is None else tb.shape[1], *pen, L, E, scratch.data_ptr(),
            ctypes.byref(grid), torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K12 (striped block fill)")
    return {"tiles": tiles, "lanes": 32 * L, "E": E, "blocks": grid.value}


def striped_grid(S, n, m, best, best_i, acc, ck, *, C: int, mode: int, pen,
                 scratch=None) -> dict:
    """Launch K13 (csrc/striped_fill.cu) on the current stream: the whole
    single-device fill of ``S`` (B, NP, MP) f32 or int8; ``ck`` is None or
    the (ckm, ckx, cky) checkpoints (B, NP // C, MP) f32; the tiling,
    ``scratch`` and the return as :func:`striped_block`'s; see
    parallel/seq_tiled."""
    dev = S.device
    if dev.type != "cuda":
        raise ValueError(f"K13 runs on CUDA tensors, got {dev}")
    if S.dtype not in (torch.float32, torch.int8) or S.dim() != 3:
        raise ValueError(f"K13 reads (B, NP, MP) f32 or int8 scores, got "
                         f"{S.dtype} {tuple(S.shape)}")
    B, NP, MP = S.shape
    _check(S, "S", S.dtype, dev)
    _check_lengths(B, dev, "K13", n=n, m=m)
    _check(best, "best", torch.float32, dev, (B, MP))
    _check(best_i, "best_i", torch.int32, dev, (B, MP))
    _check(acc, "acc", torch.float32, dev, (B, 4))
    if ck is not None:
        if not (C > 0 and NP % C == 0):
            raise ValueError(f"checkpoint rows C={C} must divide NP={NP}")
        for name, a in zip(("ckm", "ckx", "cky"), ck):
            _check(a, name, torch.float32, dev, (B, NP // C, MP))
    cks = (None,) * 3 if ck is None else tuple(a.data_ptr() for a in ck)
    L, E, tiles, scratch = _striped_tiling(MP, NP, B, dev, scratch)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib().sw_striped_grid_launch(
            int(mode), 1 if S.dtype == torch.int8 else 0, S.data_ptr(), B, NP,
            MP, n.data_ptr(), m.data_ptr(), 0 if ck is None else int(C),
            best.data_ptr(), best_i.data_ptr(), acc.data_ptr(), *cks, *pen,
            L, E, scratch.data_ptr(), ctypes.byref(grid),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K13 (striped grid fill)")
    return {"tiles": tiles, "lanes": 32 * L, "E": E, "blocks": grid.value}
