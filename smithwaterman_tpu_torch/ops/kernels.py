"""Build, load and launch the hand-written CUDA kernels.

``csrc/fill.cu`` (K1) and ``csrc/walk.cu`` (K2) are compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain
C interface under the package's ``_build/`` directory, and loaded with
ctypes.  No PyTorch header is compiled, so the build takes seconds.

Every launch goes through :func:`fill` or :func:`walk`, which check the
tensors the kernel takes, pass each pointer and the current stream as
``c_void_p``, and raise when the C entry point reports a CUDA error.  The
callers (``ops/fill_dp.py``, ``ops/device_walk.py``) count launches.
This module imports nothing CUDA-specific until a kernel is built.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Optional

import torch

from . import native

KERNEL_SOURCES = tuple(
    os.path.join(native.CSRC, f) for f in ("fill.cu", "walk.cu")
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exact f32: a fused multiply-add or a reordered sum can flip a tie
    # and with it an alignment string
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    # link the CUDA runtime as a shared library: the loader then hands the
    # kernels the libcudart PyTorch already loaded, so both share one
    # runtime (the static default would put a second one in the process)
    "-cudart", "shared",
    # registers, shared memory and spills per kernel, into the build log
    "-Xptxas", "-v",
)
MAX_K = 64  # the table lives in shared memory: K*K f32 (csrc/fill.cu)

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
        "swkernels", (nvcc,) + NVCC_FLAGS + ("-Xlinker", f"-rpath,{rpath}"),
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
        i32, i32, vp, i32, vp, vp, vp, i64, vp, vp, vp, f32, f32, vp,
    ]
    so.sw_walk_launch.restype = i32
    so.sw_walk_launch.argtypes = [i32, vp, vp, vp, i64, i64, vp, vp, vp]
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


def fill(table, codes1, codes2, desc, tb, carry, stats, *, mode: int,
         traceback: bool, og: float, eg: float) -> None:
    """Launch K1 (csrc/fill.cu) on the current stream; see fill_dp."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {dev}")
    K = table.shape[0]
    if table.dim() != 2 or table.shape[1] != K or not 1 <= K <= MAX_K:
        raise NotImplementedError(
            f"K1 takes a square table of at most {MAX_K} symbols, got "
            f"{tuple(table.shape)}")
    B = desc.shape[0]
    _check(table, "table", torch.float32, dev)
    _check(codes1, "codes1", torch.uint8, dev)
    _check(codes2, "codes2", torch.uint8, dev)
    _check(desc, "desc", torch.int64, dev, (B, 8))
    _check(carry, "carry", torch.float32, dev)
    _check(stats, "stats", torch.float32, dev, (B, 8))
    if traceback:
        _check(tb, "tb", torch.uint8, dev)
    # a launch goes to the current device: make it the tensors' card
    with torch.cuda.device(dev):
        rc = lib().sw_fill_launch(
            int(mode), 1 if traceback else 0, table.data_ptr(), K,
            codes1.data_ptr(), codes2.data_ptr(), desc.data_ptr(), B,
            tb.data_ptr() if traceback else None, carry.data_ptr(),
            stats.data_ptr(), float(og), float(eg),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K1 (fill)")


def walk(tb, desc, stats, cnt, moves, *, local: bool, L: int) -> None:
    """Launch K2 (csrc/walk.cu) on the current stream; see device_walk."""
    dev = tb.device
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, got {dev}")
    B = desc.shape[0]
    _check(tb, "tb", torch.uint8, dev)
    _check(desc, "desc", torch.int64, dev, (B, 8))
    _check(stats, "stats", torch.float32, dev, (B, 8))
    _check(cnt, "cnt", torch.int32, dev, (B,))
    _check(moves, "moves", torch.uint8, dev, (-(-L // 4), B))
    with torch.cuda.device(dev):
        rc = lib().sw_walk_launch(
            1 if local else 0, tb.data_ptr(), desc.data_ptr(),
            stats.data_ptr(), B, int(L), cnt.data_ptr(), moves.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(rc, "K2 (walk)")
