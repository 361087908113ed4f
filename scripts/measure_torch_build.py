#!/usr/bin/env python3
"""Time a fresh build of the port's CUDA kernel library, two ways.

Run from the repository root on a machine with ``nvcc`` (no card needed):

    python3 scripts/measure_torch_build.py [--reps 2]

* ``parallel``: ``ops/kernels.build`` as the port runs it
  (``ops/native.build_shared``: one ``nvcc -c`` per source, all started
  together, then one link);
* ``serial``: the same compile and link commands, one after another.

Each build starts from an empty temporary directory under the package's
``_build/``, so nothing is cached; the order is serial, parallel, parallel, serial, repeated
``--reps`` times.  Prints one JSON line with every build's seconds and
the host's CPU count.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from smithwaterman_tpu_torch.ops import kernels, native  # noqa: E402


def serial(tmp: str) -> None:
    nvcc = kernels.nvcc_path()
    rpath = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")
    objs = []
    for k, src in enumerate(kernels.KERNEL_SOURCES):
        objs.append(os.path.join(tmp, f"{k}.o"))
        subprocess.run([nvcc, *kernels.COMPILE_FLAGS, "-c", "-o", objs[-1],
                        src], check=True, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    subprocess.run([nvcc, *kernels.LINK_FLAGS, "-Xlinker", f"-rpath,{rpath}",
                    "-o", os.path.join(tmp, "lib.so"), *objs], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def parallel(tmp: str) -> None:
    saved = native.BUILD_DIR
    native.BUILD_DIR = tmp
    try:
        kernels.build()
    finally:
        native.BUILD_DIR = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    out = {"sources": len(kernels.KERNEL_SOURCES), "cpus": os.cpu_count(),
           "serial": [], "parallel": []}
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    for _ in range(args.reps):
        for how in ("serial", "parallel", "parallel", "serial"):
            with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
                t0 = time.perf_counter()
                (serial if how == "serial" else parallel)(tmp)
                out[how].append(time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
