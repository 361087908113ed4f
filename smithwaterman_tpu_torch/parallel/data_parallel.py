"""The device mesh of the port.

The counterpart of ``make_mesh`` in ``smithwaterman_tpu/parallel/
data_parallel.py`` (:25-31).  JAX's ``shard_map`` is single-controller, and
so is the port: one process drives a 1-D mesh of ``torch.device``s.  Shard
d of a striped fill owns columns ``[d*W, (d+1)*W)`` and runs on
``devices[d]``; a device may repeat (``[cuda:0] * 4`` is four shards on one
card).  Pair sharding over cards and several processes (JAX's
``DataParallel``, ``multihost``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard d runs on ``devices[d]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh holds cpu or cuda devices, got {dev}")
    return dev


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices``, by default every
    visible card.  Raises ``RuntimeError`` when no card is visible and no
    devices are named: the CPU runs only when named, as in
    ``make_mesh(devices=["cpu"] * 8)``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; name the mesh's devices, e.g. "
                "make_mesh(devices=['cpu'] * 8)")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs)
