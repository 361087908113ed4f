#!/usr/bin/env python3
"""The benchmark of smithwaterman_tpu_torch on one NVIDIA card.

    python3 swbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Prints the run's findings on standard
error and, as the last line of standard output, one JSON object: whether
the window's alignments were correct, the pairs attempted and failed,
the cell's end-to-end metrics (``--trace 0``) or per-layer metrics
(``--trace 1``, with the device's busy time and a breakdown), the device,
and last the numbers compared with their limits.  Exits non-zero, and
prints no result, without enough CUDA cards, or when JAX or the JAX
package is loaded once the run is over.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# modules that may never be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "smithwaterman_tpu")
# the program's routing switches: each cell takes the route users get
ROUTING = ("SWTPU_TB_HBM_BYTES", "SWTPU_TOKEN_WALK", "SWTPU_DIAG_SCORES")


def forbidden_loaded():
    return sorted({name.split(".")[0] for name in sys.modules} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key in ROUTING:
        os.environ.pop(key, None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from swbench import harness

    bench, cell, config, spec = harness.load_cell(root, args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"swbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s), {have} visible", file=sys.stderr)
        return 2
    result = harness.run(bench, cell, config, spec, args.seed, args.seconds,
                         bool(args.trace), "cuda", CLOCK0)
    found = forbidden_loaded()
    if found:
        print(f"swbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
