"""Entry points of the PyTorch + CUDA port: one fill on a card, and a dry run
over a mesh of shards.

The counterpart of ``__graft_entry__.py`` (:20-127) for
``smithwaterman_tpu_torch``.  Imports torch, never jax.  Both functions run
on the card unless given CPU devices; without a card and without them they
raise.

    python3 __graft_entry_torch__.py        # entry(): one K1 fill
    python3 __graft_entry_torch__.py 4      # dryrun_multichip(4)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

OG, EG = -10.0, -0.5


def _codes(rng, B: int, NP: int, MP: int):
    """B random BLOSUM62 pairs of NP x MP residues, every length full."""
    from smithwaterman_tpu_torch.ops import batch

    codes1 = rng.integers(0, 20, size=(B, NP)).astype(np.uint8)
    codes2 = rng.integers(0, 20, size=(B, MP)).astype(np.uint8)
    return batch.Chunk(codes1, codes2, np.full(B, NP, np.int32),
                       np.full(B, MP, np.int32))


def entry(device=None):
    """``(fn, args)``: one score-only fill (kernel K1 on a card) of 8
    BLOSUM62 pairs of 128 x 128 from ``default_rng(0)``, LOCAL, og = -10,
    eg = -0.5; ``fn(*args)`` returns the stats (8, 8) f32.  The inputs sit
    on ``device``, the card when None."""
    from smithwaterman_tpu_torch.aligner import resolve_device
    from smithwaterman_tpu_torch.config import LOCAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.ops import fill_dp

    dev = resolve_device(device)
    table = torch.from_numpy(
        np.asarray(SubstitutionMatrix.blosum62().table, np.float32)).to(dev)
    chunk = _codes(np.random.default_rng(0), 8, 128, 128)

    def fn(table, chunks):
        return fill_dp.fill_many(table, chunks, mode=LOCAL, og=OG, eg=EG,
                                 score_only=True).stats

    return fn, (table, [chunk])


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The batched fill sharded over an ``n_devices`` mesh, then one pair's
    columns striped over the same mesh (``striped_fill``, ``striped_align``),
    on tiny shapes; the striped alignment's best must equal the striped
    fill's.  ``devices``: the mesh's devices, by default the visible cards,
    repeated until there are ``n_devices`` shards (four shards on one card
    for ``n_devices=4``)."""
    from smithwaterman_tpu_torch.config import LOCAL
    from smithwaterman_tpu_torch.matrices import SubstitutionMatrix
    from smithwaterman_tpu_torch.parallel import DataParallel, make_mesh
    from smithwaterman_tpu_torch.parallel.seq_tiled import (striped_align,
                                                            striped_fill)

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; name the mesh's devices, e.g. "
                "dryrun_multichip(8, devices=['cpu'] * 8)")
        count = torch.cuda.device_count()
        devices = [f"cuda:{k % count}" for k in range(n_devices)]
    mesh = make_mesh(n_devices, devices)
    tile = 8
    B, NP, MP = n_devices * tile, 16, 128  # tiny: a pair-tile a shard
    chunk = _codes(np.random.default_rng(0), B, NP, MP)
    sm = np.asarray(SubstitutionMatrix.blosum62().table, np.float32)
    table = torch.from_numpy(sm).to(mesh.devices[0])

    fills, stats = DataParallel(mesh).fill_many(table, [chunk], mode=LOCAL,
                                                og=OG, eg=EG)
    assert stats.shape == (B, 8), stats.shape
    assert sum(f.desc.shape[0] for _, f in fills) == B
    gbest = float(stats[:, 0].max())

    # sequence-tiled path: ONE pair's columns striped over the same mesh
    MP1 = (MP // n_devices) * n_devices
    S1 = sm[chunk.codes1[:1, :, None], chunk.codes2[:1, None, :MP1]]
    n1 = np.full((1,), NP, np.int32)
    m1 = np.full((1,), MP1, np.int32)
    striped = striped_fill(S1, n1, m1, mode=LOCAL, og=OG, eg=EG,
                           block_rows=8, mesh=mesh)
    # striped traceback: checkpointed striped fill, banded striped
    # re-fills, host walk
    idx_lists, st_stats = striped_align(S1, n1, m1, mode=LOCAL, og=OG,
                                        eg=EG, mesh=mesh, block_rows=8,
                                        ckpt_rows=8)
    if float(st_stats[0, 0]) != float(striped[0]):
        raise AssertionError(
            f"striped_align's best {float(st_stats[0, 0])} differs from "
            f"striped_fill's {float(striped[0])}")
    path_len = len(idx_lists[0][0])
    print(f"dryrun_multichip({n_devices}): ok on "
          f"{[str(d) for d in mesh.devices]}, global best={gbest:.1f}, "
          f"striped best={float(striped[0]):.1f}, striped path={path_len} "
          "cols", file=sys.stderr)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
    else:
        fn, args = entry()
        out = fn(*args)
        if out.is_cuda:
            torch.cuda.synchronize()
        print("entry ok", tuple(out.shape), file=sys.stderr)
