"""Several processes: rendezvous and the work division between them.

The counterpart of ``smithwaterman_tpu/parallel/multihost.py`` (:18-47),
over ``torch.distributed``.  Pairs are sharded over a process's own cards
by ``DataParallel`` (one process drives its mesh); across processes,
``initialize()`` joins the process group, after which host-level work
(the sweep's chunks, ``sweep.SweepConfig.process_index`` /
``process_count``) is divided by :func:`process_index` and
:func:`process_count`.

The default backend is ``gloo``: the rendezvous only divides host-level
work and carries no tensors between cards, and NCCL needs a card of its
own for every rank, which a machine with one card cannot give.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Join the process group at ``tcp://<coordinator_address>``
    (``host:port``), from the arguments or the variables ``torchrun``
    sets (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    No-op when running single-process (no address given or set)."""
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            return
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:  # 0 is a valid id: do not use `or`
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def process_index() -> int:
    """This process's rank; 0 before :func:`initialize`."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 before :func:`initialize`."""
    return dist.get_world_size() if dist.is_initialized() else 1
