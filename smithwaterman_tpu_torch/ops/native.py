"""Build and load the native host libraries with ctypes.

Two libraries, each compiled with g++ on first use into the package's
``_build/`` directory (listed in ``.gitignore``):

* the host library: the repo-root ``csrc/traceback.cpp``, ``csrc/fasta.cpp``
  and ``csrc/reconstruct.cpp``, shared with the JAX package (which builds
  its own copy through ``csrc/Makefile``; this module does not use it);
* the cell twin: ``csrc/cell_twin.cpp`` of this package, which runs the
  GPU kernels' own headers (``sw_cell.cuh``, ``sw_walk.cuh``,
  ``sw_band.cuh``, ``sw_banded.cuh``, ``sw_diag.cuh``, ``sw_striped.cuh``)
  on the host so the tier-1 tests check the code the card runs.

Every library (these two and the CUDA kernels of ``ops/kernels.py``) is
built by :func:`build_shared`: one compiler process per source, all
started together, then one link.  A library's file name carries a hash of
its compiler commands and sources, so an edited source is rebuilt and
concurrent processes (test workers) never load a half-written file: each
writes a private temporary and renames it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
CSRC = os.path.join(PKG_DIR, "csrc")
SHARED_CSRC = os.path.join(REPO_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

HOST_SOURCES = tuple(
    os.path.join(SHARED_CSRC, f)
    for f in ("traceback.cpp", "fasta.cpp", "reconstruct.cpp")
)
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17")
# the twin must round every f32 operation as the card does (nvcc
# --fmad=false): no contraction into fused multiply-adds
TWIN_FLAGS = GXX_FLAGS + ("-ffp-contract=off",)
GXX_LINK = ("g++", "-shared")

_LIBS: dict = {}

_vp, _i32, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
# the long route's fills (csrc/longseq_fill.cu): mode, table, K,
# code_bytes, codes1, codes2, n, m, B, NP, MP, C, then each fill's own
LONG_FILL_ARGS = [
    _i32, _vp, _i32, _i32, _vp, _vp, _vp, _vp, _i64, _i64, _i64, _i32,
]
# the striped fills' C signatures (csrc/striped_fill.cu), shared by the
# kernels' launchers and the twin's entry points; the launchers add the
# scratch, the grid's address and the stream, the twin the blocks in
# flight.  ds is a host array of int32 shard indices.
STRIPED_BLOCK_ARGS = [
    _i32, _i32, _vp, _i32, _i32, _i32, _i32, _i32, _i32,  # .. K, W, D
    _i64, _i64, _vp, _i64, _i64, _i64, _vp, _vp,        # B .. n, m
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,             # rows .. tb_rows
] + [_f32] * 6 + [_i32, _i32]                            # pens, L, E
STRIPED_GRID_ARGS = [
    _i32, _i32, _vp, _i64, _i64, _i64, _vp, _vp, _i32,   # .. n, m, C
    _vp, _vp, _vp, _vp, _vp, _vp,                        # best .. cky
] + [_f32] * 6 + [_i32, _i32]                            # pens, L, E


def build_shared(name: str, compile_cmd: Sequence[str],
                 link_cmd: Sequence[str], sources: Sequence[str],
                 deps: Sequence[str] = ()) -> str:
    """Build ``_build/lib<name>-<hash>.so`` from ``sources`` (plus header
    ``deps``, hashed but not passed) and return its path: each source is
    compiled to an object by its own ``compile_cmd -c`` process, all
    started together, then ``link_cmd`` links the objects.  The compilers'
    output is kept beside the library in ``<path>.log``.  Raises
    ``RuntimeError`` with that output on failure."""
    h = hashlib.sha256(" ".join(compile_cmd).encode() + b"\0" +
                       " ".join(link_cmd).encode())
    for path in list(sources) + list(deps):
        with open(path, "rb") as f:
            h.update(path.encode() + b"\0" + f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{k}.o" for k in range(len(sources))]
    procs = [
        subprocess.Popen(list(compile_cmd) + ["-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for src, obj in zip(sources, objs)
    ]
    report = [proc.communicate()[0] for proc in procs]
    if any(proc.returncode for proc in procs):
        raise RuntimeError(f"building {name} failed:\n" + "".join(report))
    proc = subprocess.run(
        list(link_cmd) + ["-o", tmp] + objs,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    report.append(proc.stdout)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n" + "".join(report))
    with open(out + ".log", "w") as f:  # the compiler's report, kept
        f.write("".join(report))
    os.replace(tmp, out)
    return out


def headers() -> List[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    )


def host_lib() -> ctypes.CDLL:
    """The shared host library with every entry point the port calls
    bound (argtypes set explicitly: ctypes would pass Python ints as
    32-bit values and cut pointers)."""
    lib = _LIBS.get("host")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(build_shared("swhost", ("g++",) + GXX_FLAGS, GXX_LINK,
                                   HOST_SOURCES))
    i64 = ctypes.c_int64
    pi64 = ctypes.POINTER(i64)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    for fn in (lib.sw_traceback, lib.sw_traceback_tiled):
        fn.restype = i64
        fn.argtypes = [pu8, i64, i64, i64, i64, i64, pi64, pi64, i64]
    lib.sw_walk_banded.restype = i64
    lib.sw_walk_banded.argtypes = [
        pu8, i64, pi32, i64, i64, i64, i64, i64, pi64, pi64, i64, pi64,
    ]
    lib.sw_walk_band.restype = i64
    lib.sw_walk_band.argtypes = [
        pu8, i64, i64, i64, pi64, i64, pi64, pi64, i64, pi64,
    ]
    # the token rebuild takes the move rebuild's arguments, with one
    # token byte an entry and cnt counting tokens
    for fn in (lib.sw_reconstruct_moves, lib.sw_reconstruct_tokens):
        fn.restype = i64
        fn.argtypes = [
            pu8, i64, i64,          # moves or tokens, row_stride, n_rows
            pi32, pi32, pi32,       # cnt, i0, j0
            pu8, pi64, pu8, pi64,   # seq1, off1, seq2, off2
            i64, i64, i64,          # count, local, retain
            pu8, pu8, pi64,         # out1, out2, outoff
            pi64, pi64,             # outlen, spans
        ]
    p = ctypes.POINTER
    lib.sw_fasta_parse.restype = ctypes.c_void_p
    lib.sw_fasta_parse.argtypes = [ctypes.c_char_p, i64, p(i64)]
    lib.sw_fasta_record.restype = None
    lib.sw_fasta_record.argtypes = [
        ctypes.c_void_p, i64,
        p(ctypes.c_char_p), p(i64),
        p(ctypes.c_char_p), p(i64),
        p(ctypes.c_char_p), p(i64),
    ]
    lib.sw_fasta_n_warnings.restype = i64
    lib.sw_fasta_n_warnings.argtypes = [ctypes.c_void_p]
    lib.sw_fasta_warning_pos.restype = i64
    lib.sw_fasta_warning_pos.argtypes = [ctypes.c_void_p, i64]
    lib.sw_fasta_free.restype = None
    lib.sw_fasta_free.argtypes = [ctypes.c_void_p]
    _LIBS["host"] = lib
    return lib


def twin_lib() -> ctypes.CDLL:
    """The host twin of the GPU kernels (csrc/cell_twin.cpp)."""
    lib = _LIBS.get("twin")
    if lib is not None:
        return lib
    src = os.path.join(CSRC, "cell_twin.cpp")
    lib = ctypes.CDLL(build_shared("swtwin", ("g++",) + TWIN_FLAGS, GXX_LINK,
                                   [src], headers()))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.sw_twin_fill.restype = i32
    lib.sw_twin_fill.argtypes = [
        i32, i32, i32, i32, vp, i32, i32, vp, vp, vp, i64, vp, vp, vp, vp,
        f32, f32,
    ]
    lib.sw_twin_walk.restype = i32
    lib.sw_twin_walk.argtypes = [
        i32, vp, vp, vp, vp, i64, i64, i32, i32, vp, vp,
    ]
    lib.sw_twin_ckpt_fill.restype = i32
    lib.sw_twin_ckpt_fill.argtypes = LONG_FILL_ARGS + [
        vp, vp, vp, vp, vp, f32, f32,  # ckm, ckx, cky, stats, scratch
    ]
    lib.sw_twin_band_fill.restype = i32
    lib.sw_twin_band_fill.argtypes = LONG_FILL_ARGS + [
        i32, i32, vp, vp, vp, vp, f32, f32,  # sk0, G, ckm, ckx, cky, band
    ]
    lib.sw_twin_seg_walk.restype = i32
    lib.sw_twin_seg_walk.argtypes = [
        i32, vp, i32, i64, i64, i32, i32, i64, vp, vp, vp, i32,
    ]
    lib.sw_twin_banded_fill.restype = i32
    lib.sw_twin_banded_fill.argtypes = [
        i32, vp, vp, vp, i64, i64, i32, vp, vp, f32, f32, i32,
    ]
    lib.sw_twin_banded_walk.restype = i32
    lib.sw_twin_banded_walk.argtypes = [
        i32, vp, vp, vp, vp, i64, i64, i32, i64, i32, vp, vp, vp, vp,
    ]
    lib.sw_twin_banded_walk_rows.restype = i32
    lib.sw_twin_banded_walk_rows.argtypes = [i32]
    lib.sw_twin_banded_scores.restype = i32
    lib.sw_twin_banded_scores.argtypes = [
        vp, i32, i32, vp, vp, vp, vp, i64, i64, i64, i32, vp, i32, i32, i32,
        i32,
    ]
    lib.sw_twin_diag_fill.restype = i32
    lib.sw_twin_diag_fill.argtypes = [
        i32, vp, i32, i32, vp, vp, vp, i64, vp, vp, f32, f32,
    ]
    lib.sw_twin_walk_tokens.restype = i32
    lib.sw_twin_walk_tokens.argtypes = [
        i32, vp, vp, vp, vp, vp, i64, i64, i32, i32, vp, vp,
    ]
    lib.sw_twin_striped_block.restype = i32
    lib.sw_twin_striped_block.argtypes = STRIPED_BLOCK_ARGS + [i32]
    lib.sw_twin_striped_grid.restype = i32
    lib.sw_twin_striped_grid.argtypes = STRIPED_GRID_ARGS + [i32]
    _LIBS["twin"] = lib
    return lib
