"""Several processes in the port: a real two-process ``torch.distributed``
rendezvous (gloo) on localhost through ``parallel.multihost.initialize``
(one process from its arguments, the other from the variables torchrun
sets), one collective, and the process-sharded sweep, whose two shards together
must equal the JAX package's single-process sweep of the same sequences,
row for row (tests/test_multihost.py's case over the port).

The workers (tests/torch_multihost_worker.py) import torch and the port,
never jax.  Tolerance: exact equality of every result row.
"""

import os
import socket
import subprocess
import sys

import torch.distributed as dist

from smithwaterman_tpu import BatchAligner as JaxBatchAligner
from smithwaterman_tpu import LOCAL, SeqData
from smithwaterman_tpu import sweep as jsweep
from smithwaterman_tpu_torch.parallel import initialize_multihost, multihost
from smithwaterman_tpu_torch.sweep import load_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
SEQS = ["HEAGAWGHEE", "PAWHEAE", "HEAGAWGHEF", "WWWPPP", "AWHEA", "GGGGG"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sweep(tmp_path):
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    envs = [dict(base, RANK="1"),  # a decoy: process 0 passes process_id=0
            dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 WORLD_SIZE="2", RANK="1")]
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, str(port), str(pid), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=envs[pid]) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=50)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER {pid} OK" in out, out

    # the two shards together cover every pair once and equal the JAX
    # package's single-process sweep, row for row
    rows = []
    for pid in range(2):
        rows.extend(load_sweep(str(tmp_path / f"shard{pid}.jsonl")))
    assert len(rows) == len(SEQS) * (len(SEQS) - 1) // 2
    assert len({(r[0], r[1]) for r in rows}) == len(rows)
    seqs = [SeqData(f"s{i}", "", s) for i, s in enumerate(SEQS)]
    ref = str(tmp_path / "jax.jsonl")
    jsweep.sweep(seqs, None, JaxBatchAligner(mode=LOCAL, backend="scan"), ref,
                 jsweep.SweepConfig(chunk_pairs=2))
    assert sorted(rows) == sorted(jsweep.load_sweep(ref))


def test_initialize_is_a_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    initialize_multihost()
    assert not dist.is_initialized()
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
