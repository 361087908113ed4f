"""Worker process for the two-process gloo test of the port
(tests/test_torch_multihost.py).  Not collected by pytest (no test_
prefix).  Imports torch and the port, never jax.

argv: <coordinator_port> <process_id> <out_dir>.  Process 0 passes the
address, count and id to ``initialize``; process 1 reads them from
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
"""

import os
import sys

PORT, PID, OUT_DIR = sys.argv[1], int(sys.argv[2]), sys.argv[3]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

from smithwaterman_tpu_torch import LOCAL, BatchAligner, SeqData  # noqa: E402
from smithwaterman_tpu_torch.parallel import multihost  # noqa: E402
from smithwaterman_tpu_torch.sweep import SweepConfig, sweep  # noqa: E402

SEQS = ["HEAGAWGHEE", "PAWHEAE", "HEAGAWGHEF", "WWWPPP", "AWHEA", "GGGGG"]


def main():
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    if PID == 0:
        # explicit arguments; RANK=1 in this process's environment must not
        # replace process_id=0
        multihost.initialize(f"localhost:{PORT}", num_processes=2,
                             process_id=0)
    else:
        # the variables torchrun sets
        multihost.initialize()
    try:
        assert multihost.process_count() == 2, multihost.process_count()
        assert multihost.process_index() == PID, multihost.process_index()

        # a collective across the two processes
        ranks = [None, None]
        dist.all_gather_object(ranks, PID)
        assert sorted(ranks) == [0, 1], ranks

        # host-sharded sweep: each process computes its chunk shard
        seqs = [SeqData(f"s{i}", "", s) for i, s in enumerate(SEQS)]
        cfg = SweepConfig(chunk_pairs=2,
                          process_index=multihost.process_index(),
                          process_count=multihost.process_count())
        out = os.path.join(OUT_DIR, f"shard{PID}.jsonl")
        n = sweep(seqs, None, BatchAligner(mode=LOCAL, device="cpu"), out,
                  cfg)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"WORKER {PID} OK chunks={n}", flush=True)


if __name__ == "__main__":
    main()
