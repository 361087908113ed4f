"""The device mesh of the port, and pair sharding over it.

The counterpart of ``smithwaterman_tpu/parallel/data_parallel.py``.  JAX's
``shard_map`` is single-controller, and so is the port: one process drives
a 1-D mesh of ``torch.device``s.  A device may repeat (``[cuda:0] * 4`` is
four shards on one card).  Two kinds of work go over a mesh:

* one giant pair's columns, striped (``parallel/seq_tiled.py``): shard d
  owns columns ``[d*W, (d+1)*W)`` and runs on ``devices[d]``;
* many pairs, sharded (:class:`DataParallel`, JAX's ``DataParallel``,
  ``data_parallel.py:135-249``): each shard fills (K1) and walks (K2), or
  fills score-only (K1 or the wavefront K9), its own pairs on its own
  device, and only stats, move counts and packed moves come back.

Several processes (``torch.distributed``, ``parallel/multihost.py``)
divide host-level work, such as a sweep's chunks, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import batch, device_walk, diag_dp, fill_dp
from ..utils import metrics


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


class Shard(NamedTuple):
    """One shard's share of a flush: piece d of every chunk (pieces with
    no pairs left out), and the flush positions of its pairs in the order
    the pieces hold them."""

    device: torch.device
    chunks: List[batch.Chunk]
    rows: np.ndarray  # (pairs,) int64


class DataParallel:
    """Shards a flush's pairs over a mesh (JAX's ``DataParallel``).

    Every chunk of a flush is cut into ``n_devices`` contiguous pieces of
    as equal a pair count as possible; shard d takes piece d of every
    chunk and runs the unsharded route's kernels on it on ``devices[d]``
    (CPU devices run their plain versions, as the unsharded path does).
    Outputs are stitched back into flush order.  A shard may get no pairs
    (3 pairs on 8 shards).  Unlike JAX (``data_parallel.py:160-163``),
    nothing is padded to a multiple of the mesh and no tile count is
    required: the port's chunks are pairs, not TPU tiles.

    Every shard's work is launched before any result is copied back, each
    under its own card, so distinct cards overlap; shards that repeat a
    card run one after another on it.  A flush's pointer bytes
    (``ops/batch.plan_flushes``' budget) are split over the shards, so a
    card that appears several times in the mesh never holds more than the
    unsharded flush would."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 n_devices: Optional[int] = None):
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.n_devices = self.mesh.size

    def shards(self, chunks: Sequence[batch.Chunk]) -> List[Shard]:
        """The flush ``chunks`` cut over the mesh; shards with no pairs
        are left out."""
        D = self.n_devices
        pieces: List[List[batch.Chunk]] = [[] for _ in range(D)]
        rows: List[List[np.ndarray]] = [[] for _ in range(D)]
        lo = 0
        for ch in chunks:
            B = ch.shape[0]
            cuts = [B * d // D for d in range(D + 1)]
            for d in range(D):
                a, b = cuts[d], cuts[d + 1]
                if b > a:
                    pieces[d].append(batch.Chunk(*(x[a:b] for x in ch)))
                    rows[d].append(np.arange(lo + a, lo + b))
            lo += B
        return [Shard(self.mesh.devices[d], pieces[d], np.concatenate(rows[d]))
                for d in range(D) if pieces[d]]

    def _run(self, table: torch.Tensor, chunks, work):
        """``work(table on the shard's device, shard)`` for every shard,
        each under its card; returns ``[(shard, output)]``."""
        tables = {}
        out = []
        for sh in self.shards(chunks):
            tab = tables.get(sh.device)
            if tab is None:
                tab = tables[sh.device] = table.to(sh.device)
            with (torch.cuda.device(sh.device) if sh.device.type == "cuda"
                  else contextlib.nullcontext()):
                out.append((sh, work(tab, sh)))
        return out

    @staticmethod
    def _stitch(B: int, parts, shape, dtype, axis: int = 0) -> torch.Tensor:
        """Host tensor of ``B`` pairs along ``axis`` from ``[(rows,
        tensor)]``, each shard's pairs written at their flush positions."""
        full = list(shape)
        full.insert(axis, B)
        out = torch.zeros(full, dtype=dtype)
        for rows, t in parts:
            if t.device.type == "cuda":
                metrics.count("copy.d2h")
                metrics.count("copy.d2h_bytes", t.numel() * t.element_size())
            idx = torch.from_numpy(rows)
            out.index_copy_(axis, idx, t.cpu())
        return out

    def fill_many(self, table: torch.Tensor, chunks: Sequence[batch.Chunk],
                  *, mode: int, og: float, eg: float,
                  score_only: bool = False):
        """``fill_dp.fill_many`` of a flush, sharded; the counterpart of
        JAX's ``fill_pallas`` (``data_parallel.py:142-171``).

        Returns ``(fills, stats)``: ``stats`` (B, 8) f32 on the host in
        flush order; ``fills`` None when ``score_only``, else ``[(shard,
        fill_dp.Filled)]``, each fill left on its shard's device
        (``Filled.tb_view(c)`` is piece c of ``shard.chunks``)."""
        B = sum(ch.shape[0] for ch in chunks)
        done = self._run(table, chunks, lambda tab, sh: fill_dp.fill_many(
            tab, sh.chunks, mode=mode, og=og, eg=eg, score_only=score_only))
        stats = self._stitch(B, [(sh.rows, f.stats) for sh, f in done],
                             (fill_dp.STATS_W,), torch.float32)
        return (None if score_only else done), stats

    def fill_walk_packed(self, table: torch.Tensor,
                         chunks: Sequence[batch.Chunk], *, mode: int,
                         og: float, eg: float, L: int):
        """Fill (K1) and walk (K2) a flush, sharded: each shard's pointer
        bytes stay on its device; the counterpart of JAX's
        ``fill_walk_bundle_packed`` (``data_parallel.py:202-228``).

        Returns host tensors in flush order, ``device_walk.walk_packed``'s
        contract for the whole flush: stats (B, 8) f32, counts (B,) int32
        and moves (ceil(L/4), B) uint8."""
        def work(tab, sh):
            f = fill_dp.fill_many(tab, sh.chunks, mode=mode, og=og, eg=eg)
            cnt, mv = device_walk.walk_packed(f.tb, f.desc, f.stats,
                                              mode=mode, L=L, order=f.order)
            return f.stats, cnt, mv

        B = sum(ch.shape[0] for ch in chunks)
        done = self._run(table, chunks, work)
        stats = self._stitch(B, [(sh.rows, o[0]) for sh, o in done],
                             (fill_dp.STATS_W,), torch.float32)
        cnt = self._stitch(B, [(sh.rows, o[1]) for sh, o in done], (),
                           torch.int32)
        moves = self._stitch(B, [(sh.rows, o[2]) for sh, o in done],
                             (-(-L // 4),), torch.uint8, axis=1)
        return stats, cnt, moves

    def fill_diag(self, table: torch.Tensor, chunks: Sequence[batch.Chunk],
                  *, og: float, eg: float) -> torch.Tensor:
        """The wavefront LOCAL score-only fill (K9) of a flush, sharded:
        stats (B, 8) f32 on the host in flush order, ``diag_dp.fill_diag``'s
        contract; the counterpart of JAX's ``fill_diag``
        (``data_parallel.py:230-249``).  Callers check
        ``diag_dp.eligible`` first."""
        B = sum(ch.shape[0] for ch in chunks)
        done = self._run(table, chunks, lambda tab, sh: diag_dp.fill_diag(
            tab, sh.chunks, og=og, eg=eg))
        return self._stitch(B, [(sh.rows, st) for sh, st in done],
                            (fill_dp.STATS_W,), torch.float32)
