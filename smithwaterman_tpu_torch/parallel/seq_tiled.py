"""Sequence-tiled DP: one giant alignment striped across a mesh of devices.

The counterpart of ``smithwaterman_tpu/parallel/seq_tiled.py``.  The column
axis of one DP matrix is split into D shards of W = MP / D columns
(``parallel/data_parallel.make_mesh``), and the shards run row blocks in a
software-pipelined wavefront: at step t, shard d runs its block r = t - d
of K rows as soon as shard d-1 has finished the same rows.  The only
traffic between shards is each block's right edge: [M, X, Y, C] per row
and pair, C the running maximum of X's max-plus prefix, which composes
exactly across shards, so the striped fill is bit-identical to the
single-device one.

Two hand-written CUDA kernels (``csrc/striped_fill.cu``, the row rule in
``csrc/sw_striped.cuh``) do the work on the card:

* K12 (:func:`block_fill`, plain version :func:`block_ref`) runs one step
  for every active shard of a device in one launch: JAX's block kernel
  (B7) and its B = 1 folded form (B8);
* K13 (:func:`grid_fill`, plain version :func:`grid_fill_ref`) runs the
  whole single-device fill in one launch: JAX's grid kernel (B9).

``striped_fill`` and ``striped_fill_ckpt`` on a one-device mesh take K13;
everything else (several shards, a seeded band re-fill with pointer bytes)
takes K12.  Each wrapper launches its kernel on CUDA tensors and runs its
plain version on CPU tensors; any other device raises.  ``striped_align``
walks the path on the host with ``ops/longseq.walk_band`` from per-segment
band re-fills, as the JAX function does.  JAX's ``rows=`` and
``interpret=`` arguments are TPU matters and are gone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CELL_MATCH, CELL_STOP, GLOBAL, GLOCAL, LOCAL
from ..ops import longseq
from ..utils import metrics
from .data_parallel import Mesh

NEG = -3.0e38
BIGI = 2 ** 30

# each kernel's last launch's shape (ops/kernels.striped_block's return:
# tiles, lanes, E, blocks), read by chip_smoke.py and scripts/ab_striped.py
SHAPES: Dict[str, dict] = {}

Ckpts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class Pen(NamedTuple):
    """The penalty constants as the JAX code forms them: og, eg, the start
    penalties so / se, sent = 10*og + 10*eg and sose = so - se, each in
    double, rounded to f32 once (``csrc/sw_striped.cuh`` Pen)."""

    og: float
    eg: float
    so: float
    se: float
    sent: float
    sose: float


def make_pen(mode: int, og: float, eg: float) -> Pen:
    so, se = (og, eg) if mode == GLOBAL else (0.0, 0.0)
    return Pen(*(float(np.float32(v)) for v in
                 (og, eg, so, se, 10.0 * og + 10.0 * eg, so - se)))


# ------------------------------------------------------------ row rule
def _shift(v, fill):
    return torch.cat([fill, v[:, :-1]], dim=1)


def _lsc(i, p: Pen):
    return i.to(torch.float32) * p.se + p.sose


def _column0(i, p: Pen):
    """(P, 3) [M, X, Y] of cells (i, 0), i (P, 1): the origin (0, -1, -1)
    at i == 0, else the gap chain down column 0."""
    li = _lsc(i, p)
    at0 = i == 0
    return torch.cat([torch.where(at0, 0.0, li + p.sent),
                      torch.where(at0, -1.0, li + p.sent),
                      torch.where(at0, -1.0, li)], dim=1)


def _left_edge(i, p: Pen):
    """(P, 4) shard 0's left edge [M, X, Y, C] at (i, 0), i >= 1."""
    li = _lsc(i, p)
    return torch.cat([li + p.sent, li + p.sent, li,
                      torch.full_like(li, NEG)], dim=1)


def _row0(jgf, p: Pen):
    """Row 0's (M, X, Y) at global columns jgf (f32)."""
    l0 = _lsc(jgf, p)
    return l0 + p.sent, l0, l0 + p.sent


def _row_cells(mode, p: Pen, i, jg, jgf, srow, cm, cx, cy, eb, ab, nvec,
               mvec, emit_tb: bool):
    """One striped DP row over P rows of W lanes, JAX's ``_row_cells``
    (``seq_tiled.py:52-182``) op for op: ``i`` (P, 1) global row, ``jg`` /
    ``jgf`` (P, W) global columns (int / f32), ``srow`` (P, W) scores,
    ``cm, cx, cy`` the row above, ``eb`` (P, 4) left edge [M, X, Y, C] at
    (i, col0), ``ab`` (P, 3) [M, X, Y] at (i-1, col0), ``nvec`` / ``mvec``
    (P, 1).  Returns (M, X, Y, C, pointer bytes or None)."""
    mx = torch.maximum
    ebm, ebx, eby, ebc = eb[:, 0:1], eb[:, 1:2], eb[:, 2:3], eb[:, 3:4]
    abm, abx, aby = ab[:, 0:1], ab[:, 1:2], ab[:, 2:3]
    og, eg = p.og, p.eg
    if emit_tb:
        Mp1, Xp1, Yp1 = _shift(cm, abm), _shift(cx, abx), _shift(cy, aby)
        vm = mx(mx(Mp1, Xp1), Yp1) + srow
        prev_m = torch.where(Mp1 >= Xp1, torch.where(Mp1 >= Yp1, 0, 2),
                             torch.where(Xp1 >= Yp1, 1, 2))
    else:
        vm = _shift(mx(mx(cm, cx), cy), mx(mx(abm, abx), aby)) + srow
    if mode == GLOCAL:
        last_col = jg == mvec
        qo = torch.where(last_col, p.so, og)
        qe = torch.where(last_col, p.se, eg)
    else:
        qo, qe = og, eg
    if mode == LOCAL:
        if emit_tb:  # `>=` favors M-open, inner `>` favors X on ties
            c1 = cm + og >= cy + eg
            c2 = cm > cx
            c3 = cy + eg > cx + og
        vy = mx(mx(cm, cx) + og, cy + eg)
        vm = torch.clamp_min(vm, 0.0)
        vy = torch.clamp_min(vy, 0.0)
    else:
        if emit_tb:  # strict `>` for M-open vs Y-extend
            c1 = cm + qo > cy + qe
            c2 = cm >= cx
            c3 = cy + qe >= cx + qo
        vy = mx(mx(cm + qo, cy + qe), cx + qo)
    if mode == GLOCAL:
        lr = i == nvec
        po = torch.where(lr, p.so, og)
        pe = torch.where(lr, p.se, eg)
    else:
        po, pe = og, eg
    # X by the max-plus prefix in global columns: h = G(j-1) - (j-1)*pe
    g_edge = mx(ebm, eby) + po
    gline = mx(vm, vy) + po
    jpe = (jgf - 1.0) * pe
    h = _shift(gline, g_edge) - jpe
    c = mx(torch.cummax(h, dim=1).values, ebc)
    vx = c + jpe
    if mode == LOCAL:
        vx = torch.clamp_min(vx, 0.0)
    if not emit_tb:
        return vm, vx, vy, c, None
    prev_y = torch.where(c1, torch.where(c2, 0, 1), torch.where(c3, 2, 1))
    Mm1, Xm1, Ym1 = _shift(vm, ebm), _shift(vx, ebx), _shift(vy, eby)
    if mode == LOCAL:
        d1 = Mm1 + og >= Xm1 + eg
        d2 = Mm1 > Ym1
        d3 = Xm1 + eg > Ym1 + og
    else:
        d1 = Mm1 + po > Xm1 + pe
        d2 = Mm1 >= Ym1
        d3 = Xm1 + pe >= Ym1 + po
    prev_x = torch.where(d1, torch.where(d2, 0, 2), torch.where(d3, 1, 2))
    if mode == LOCAL:
        prev_m = torch.where(vm == 0.0, CELL_STOP, prev_m)
        prev_x = torch.where(vx == 0.0, CELL_STOP, prev_x)
        prev_y = torch.where(vy == 0.0, CELL_STOP, prev_y)
    tb = (prev_m | (prev_x << 2) | (prev_y << 4)).to(torch.uint8)
    return vm, vx, vy, c, tb


# ------------------------------------------------------------ K12
def block_ref(S, n, m, rows, box, above, best, best_i, acc, tb, *, ds, t,
              i0, K, W, s_lo, mode, pen: Pen) -> None:
    """Plain version of K12 (``ops/kernels.striped_block``, the same
    arguments): the shards ``ds`` run their block r = t - d, vectorized as
    len(ds) * B rows of W lanes, row by row with :func:`_row_cells`.
    Updates the state in place as the kernel does."""
    dev = S.device
    B, A = n.shape[0], len(ds)
    P = A * B
    starts = [i0 + (t - d) * K for d in ds]
    cols = [slice(d * W, d * W + W) for d in ds]
    cur = torch.stack([rows[s & 1][:, :, c] for s, c in zip(starts, cols)],
                      1).reshape(3, P, W)
    cm, cx, cy = cur[0], cur[1], cur[2]
    Sb = torch.stack([S[:, s - i0:s - i0 + K, d * W - s_lo:d * W - s_lo + W]
                      for d, s in zip(ds, starts)]).reshape(P, K, W)
    jg = torch.stack([torch.arange(d * W + 1, d * W + W + 1, device=dev)
                      for d in ds]).repeat_interleave(B, 0)
    jgf = jg.to(torch.float32)
    nv = n.to(torch.int64).repeat(A)[:, None]
    mv = m.to(torch.int64).repeat(A)[:, None]
    dev0 = torch.tensor([d == 0 for d in ds],
                        device=dev).repeat_interleave(B)[:, None]
    start = torch.tensor(starts, device=dev).repeat_interleave(B)[:, None]
    zero_box = torch.zeros((B, K, 4), dtype=torch.float32, device=dev)
    inbox = torch.stack([box[(t - 1) & 1, d - 1] if d else zero_box
                         for d in ds]).reshape(P, K, 4)
    ab = torch.where(dev0, _column0(start, pen),
                     above[ds, :, :3].reshape(P, 3))
    rb = torch.stack([best[:, c] for c in cols]).reshape(P, W)
    rbi = torch.stack([best_i[:, c] for c in cols]).reshape(P, W)
    ac = acc[ds].reshape(P, 4)
    outbox = torch.empty((P, K, 4), dtype=torch.float32, device=dev)
    tbs = None if tb is None else torch.empty((P, K, W), dtype=torch.uint8,
                                              device=dev)
    prev = (cm, cx, cy)
    for q in range(K):
        i = start + q + 1
        eb = torch.where(dev0, _left_edge(i, pen), inbox[:, q])
        vm, vx, vy, c, tbr = _row_cells(mode, pen, i, jg, jgf, Sb[:, q], cm,
                                        cx, cy, eb, ab, nv, mv, tb is not None)
        outbox[:, q] = torch.stack([vm[:, -1], vx[:, -1], vy[:, -1],
                                    c[:, -1]], dim=1)
        if tbs is not None:
            tbs[:, q] = tbr
        if mode == LOCAL:
            masked = torch.where((jg <= mv) & (i <= nv), vm, NEG)
            upd = masked > rb  # strict `>`: the first (smallest) i wins
            rb = torch.where(upd, masked, rb)
            rbi = torch.where(upd, i.to(torch.int32), rbi)
        else:
            take = (i == nv) & (jg == mv)
            ac = torch.cat([ac[:, :3] + torch.stack(
                [torch.where(take, v, 0.0).sum(dim=1) for v in (vm, vx, vy)],
                dim=1), ac[:, 3:]], dim=1)
        ab = torch.where(dev0, _column0(i, pen), inbox[:, q, :3])
        prev, (cm, cx, cy) = (cm, cx, cy), (vm, vx, vy)
    for a, (d, s, c) in enumerate(zip(ds, starts, cols)):
        sl = slice(a * B, a * B + B)
        e = s + K
        rows[(e - 1) & 1][:, :, c] = torch.stack([v[sl] for v in prev])
        rows[e & 1][:, :, c] = torch.stack([v[sl] for v in (cm, cx, cy)])
        box[t & 1, d] = outbox[sl]
        best[:, c] = rb[sl]
        best_i[:, c] = rbi[sl]
        acc[d] = ac[sl]
        if d:
            above[d, :, :3] = inbox[sl, K - 1, :3]
        if tbs is not None:
            tb[:, s - i0:e - i0, c] = tbs[sl]


def block_fill(S, n, m, rows, box, above, best, best_i, acc, tb, *, ds, t,
               i0, K, W, s_lo, mode, pen: Pen) -> None:
    """Step ``t`` of the wavefront for the shards ``ds`` (all on S's
    device): K12 on CUDA tensors, one launch per up to
    ``kernels.MAX_SHARDS`` shards; :func:`block_ref` on CPU tensors."""
    args = dict(t=t, i0=i0, K=K, W=W, s_lo=s_lo, mode=mode, pen=pen)
    state = (S, n, m, rows, box, above, best, best_i, acc, tb)
    if S.device.type == "cpu":
        block_ref(*state, ds=ds, **args)
        return
    if S.device.type != "cuda":
        raise ValueError(f"no striped fill for device {S.device}")
    from ..ops import kernels

    for k in range(0, len(ds), kernels.MAX_SHARDS):
        SHAPES["K12"] = kernels.striped_block(
            *state, ds=ds[k:k + kernels.MAX_SHARDS], **args)
        metrics.count("launch.K12")


# ------------------------------------------------------------ K13
def grid_fill_ref(S, n, m, best, best_i, acc, ck, *, C, mode,
                  pen: Pen) -> None:
    """Plain version of K13 (``ops/kernels.striped_grid``, the same
    arguments): the single-device fill of S (B, NP, MP) f32 or int8 row by
    row with :func:`_row_cells`, into ``best`` / ``best_i`` (B, MP),
    ``acc`` (B, 4) and, when given, the checkpoints ``ck``."""
    dev = S.device
    B, NP, MP = S.shape
    jg = torch.arange(1, MP + 1, device=dev).expand(B, MP)
    jgf = jg.to(torch.float32)
    nv = n.to(torch.int64)[:, None]
    mv = m.to(torch.int64)[:, None]
    cm, cx, cy = _row0(jgf, pen)
    rb = torch.full((B, MP), NEG, dtype=torch.float32, device=dev)
    rbi = torch.full((B, MP), BIGI, dtype=torch.int32, device=dev)
    ac = torch.zeros((B, 4), dtype=torch.float32, device=dev)
    for i in range(1, NP + 1):
        it = torch.full((B, 1), i, dtype=torch.int64, device=dev)
        vm, vx, vy, _, _ = _row_cells(
            mode, pen, it, jg, jgf, S[:, i - 1].to(torch.float32), cm, cx,
            cy, _left_edge(it, pen), _column0(it - 1, pen), nv, mv, False)
        if mode == LOCAL:
            masked = torch.where((jg <= mv) & (it <= nv), vm, NEG)
            upd = masked > rb
            rb = torch.where(upd, masked, rb)
            rbi = torch.where(upd, i, rbi)
        else:
            take = (it == nv) & (jg == mv)
            ac[:, :3] += torch.stack(
                [torch.where(take, v, 0.0).sum(dim=1) for v in (vm, vx, vy)],
                dim=1)
        if ck is not None and i % C == 0:
            for a, v in zip(ck, (vm, vx, vy)):
                a[:, i // C - 1] = v
        cm, cx, cy = vm, vx, vy
    best.copy_(rb)
    best_i.copy_(rbi)
    acc.copy_(ac)


def grid_fill(S, n, m, *, mode: int, pen: Pen, C: Optional[int] = None):
    """The single-device fill of S (B, NP, MP) f32 or int8 (contiguous):
    K13 on a CUDA tensor, :func:`grid_fill_ref` on a CPU one.  Returns
    ``(best, best_i, acc, ck)``: the LOCAL per-lane best (B, MP) f32 and
    its row (int32), the non-LOCAL (M, X, Y) of cell (n, m) in acc (B, 4),
    and with ``C`` the checkpoints (ckm, ckx, cky) (B, NP // C, MP)."""
    dev = S.device
    B, NP, MP = S.shape
    best = torch.empty((B, MP), dtype=torch.float32, device=dev)
    best_i = torch.empty((B, MP), dtype=torch.int32, device=dev)
    acc = torch.empty((B, 4), dtype=torch.float32, device=dev)
    ck = None if not C else tuple(
        torch.empty((B, NP // C, MP), dtype=torch.float32, device=dev)
        for _ in range(3))
    if dev.type == "cpu":
        grid_fill_ref(S, n, m, best, best_i, acc, ck, C=C, mode=mode,
                      pen=pen)
    elif dev.type == "cuda":
        from ..ops import kernels

        SHAPES["K13"] = kernels.striped_grid(S, n, m, best, best_i, acc, ck,
                                             C=C or 0, mode=mode, pen=pen)
        metrics.count("launch.K13")
    else:
        raise ValueError(f"no striped fill for device {dev}")
    return best, best_i, acc, ck


# ------------------------------------------------------------ wavefront
@dataclass
class _Part:
    """One device's share of a striped fill: its shards, their scores and
    the state K12 keeps between launches (``csrc/striped_fill.cu``)."""

    ds: List[int]
    S: torch.Tensor        # columns [lo, lo + S.shape[2]) of the fill's rows
    lo: int
    n: torch.Tensor
    m: torch.Tensor
    rows: torch.Tensor     # (2, 3, B, MP): row i's (M, X, Y) in [i & 1]
    box: torch.Tensor      # (2, D, B, K, 4): step t's outboxes in [t & 1]
    above: torch.Tensor    # (D, B, 4)
    best: torch.Tensor     # (B, MP)
    best_i: torch.Tensor   # (B, MP) int32
    acc: torch.Tensor      # (D, B, 4)
    tb: Optional[torch.Tensor]
    ck: Optional[torch.Tensor]  # (3, B, NCK, MP)


def _wavefront(S, n, m, *, mode: int, pen: Pen, K: int, mesh: Mesh,
               C: Optional[int] = None, emit_tb: bool = False, seed=None):
    """The striped fill of S (B, rows, MP) f32 over ``mesh`` (JAX's
    ``local_fill``, ``seq_tiled.py:973-1335``): steps t = 0 .. NB+D-2, shard
    d runs block r = t - d when 0 <= r < NB, one K12 launch per device a
    step; shard d-1's outbox becomes shard d's inbox (a copy when they lie
    on two devices).  ``seed`` = (i0, icm, icx, icy) re-fills rows i0+1 ..
    from carries (B, MP) at row i0; else rows start at row 0's closed form.
    Returns (best, best_i, fin (B, 3), ck, tb) on the mesh's first device:
    the per-lane LOCAL best (B, MP) and its row, the summed (M, X, Y) of
    cell (n, m), the checkpoints (when C) and the pointer bytes (B, rows,
    MP) uint8 (when emit_tb)."""
    B, NP, MP = S.shape
    D = mesh.size
    W = MP // D
    NB = NP // K
    NCK = NP // C if C else 0
    i0 = seed[0] if seed else 0
    out_dev = mesh.devices[0]
    if seed:
        init = torch.stack([a.to(torch.float32) for a in seed[1:]])
    else:
        jgf = torch.arange(1, MP + 1, dtype=torch.float32)
        init = torch.stack(_row0(jgf, pen))[:, None, :].expand(3, B, MP)
    groups: Dict[torch.device, List[int]] = {}
    for d, dv in enumerate(mesh.devices):
        groups.setdefault(dv, []).append(d)
    parts: Dict[torch.device, _Part] = {}
    for dv, ds in groups.items():
        lo, hi = ds[0] * W, (ds[-1] + 1) * W
        rows = torch.zeros((2, 3, B, MP), dtype=torch.float32, device=dv)
        rows[i0 & 1] = init.to(dv)
        above = torch.zeros((D, B, 4), dtype=torch.float32, device=dv)
        for d in ds[1:] if ds[0] == 0 else ds:
            # shard d's above edge at (i0, col0): its left neighbour's last
            # lane of the carries (shard 0 uses the closed form)
            above[d, :, :3] = init[:, :, d * W - 1].T.to(dv)
        parts[dv] = _Part(
            ds=ds, S=S[:, :, lo:hi].to(dv), lo=lo,
            n=n.to(dv, torch.int32), m=m.to(dv, torch.int32), rows=rows,
            box=torch.zeros((2, D, B, K, 4), dtype=torch.float32, device=dv),
            above=above,
            best=torch.full((B, MP), NEG, dtype=torch.float32, device=dv),
            best_i=torch.full((B, MP), BIGI, dtype=torch.int32, device=dv),
            acc=torch.zeros((D, B, 4), dtype=torch.float32, device=dv),
            tb=(torch.zeros((B, NP, MP), dtype=torch.uint8, device=dv)
                if emit_tb else None),
            ck=(torch.zeros((3, B, NCK, MP), dtype=torch.float32, device=dv)
                if C else None))
    where = {d: parts[dv] for d, dv in enumerate(mesh.devices)}
    for t in range(NB + D - 1):
        for part in parts.values():
            ds = [d for d in part.ds if 0 <= t - d < NB]
            if ds:
                block_fill(part.S, part.n, part.m, part.rows, part.box,
                           part.above, part.best, part.best_i, part.acc,
                           part.tb, ds=ds, t=t, i0=i0, K=K, W=W, s_lo=part.lo,
                           mode=mode, pen=pen)
        for d in range(max(0, t - NB + 1), min(D, t + 1)):
            part, end = where[d], i0 + (t - d + 1) * K
            if C and end % C == 0:
                # checkpoint k holds the carries after global row (k+1)*C
                c = slice(d * W, d * W + W)
                part.ck[:, :, end // C - 1, c] = part.rows[end & 1][:, :, c]
            if d + 1 < D and where[d + 1] is not part:
                where[d + 1].box[t & 1, d].copy_(part.box[t & 1, d])
    return _gather(parts, out_dev, W)


def _gather(parts: Dict[torch.device, _Part], out_dev, W: int):
    """The parts' outputs on ``out_dev``: each device's shard columns of
    best, best_i, ck and tb; fin summed over shards (one shard holds the
    cell (n, m), the others add 0)."""
    home = parts[out_dev]
    fin = sum(p.acc.to(out_dev).sum(dim=0) for p in parts.values())[:, :3]
    outs = [home.best, home.best_i, home.ck, home.tb]
    for p in parts.values():
        if p is home:
            continue
        for a, src in zip(outs, (p.best, p.best_i, p.ck, p.tb)):
            if a is None:
                continue
            for d in p.ds:
                c = slice(d * W, d * W + W)
                a[..., c] = src[..., c].to(out_dev)
    best, best_i, ck, tb = outs
    return best, best_i, fin, ck, tb


def _merge_local(best: torch.Tensor, best_i: torch.Tensor):
    """The exact global argmax over every lane of every shard: max score,
    then min row, then min column (the first-encounter rule,
    ``seq_tiled.py:1295-1317``).  Returns (gmax, min_i, min_j)."""
    MP = best.shape[1]
    jg = torch.arange(1, MP + 1, dtype=torch.int32, device=best.device)
    gmax = best.max(dim=1).values
    cand = best == gmax[:, None]
    min_i = torch.where(cand, best_i, BIGI).min(dim=1).values
    min_j = torch.where(cand & (best_i == min_i[:, None]), jg,
                        BIGI).min(dim=1).values
    return gmax, min_i, min_j


# ------------------------------------------------------------ public API
def fold_S(S):
    """(1, NP, MP) -> (NP, 8, MP // 8), the JAX grid kernel's folded layout
    (sublane s carries global columns [s*MP/8, (s+1)*MP/8)).  A view: on
    the card the fold is only a reshape, and ``striped_fill(...,
    folded=True)`` reads it back as (1, NP, MP)."""
    B, NP, MP = S.shape
    assert B == 1 and MP % 8 == 0, (B, MP)
    return S.reshape(NP, 8, MP // 8)


def _scores(S) -> torch.Tensor:
    return S if isinstance(S, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(S))


def _lengths(v, dev) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.asarray(v).reshape(-1))
    return t.to(dev, torch.int32).contiguous()


def _check_grid_only(D: int, B: int, K: int, W: int, C: Optional[int],
                     dtype) -> None:
    """JAX's acceptance rule for folded or int8 S (``seq_tiled.py:898-914``):
    only the single-device grid kernel reads them.  Mosaic's lane-width
    gates (W % 1024, W >= 1024) and its VMEM halving of K are TPU matters
    and are left out."""
    if dtype not in (torch.float32, torch.int8):
        raise ValueError(f"S must be f32 or int8, got {dtype}")
    if not (D == 1 and B == 1 and K % 8 == 0):
        raise ValueError(
            "folded or non-f32 S requires the D==1 grid kernel: need B==1, "
            f"block_rows%8==0 (got D={D}, B={B}, K={K}, W={W}, C={C})")


def striped_fill(S, n, m, *, mode: int, og: float, eg: float,
                 block_rows: int, mesh: Mesh, folded: bool = False):
    """Score a batch of pairs with the column axis striped over ``mesh``.

    ``S``: (B, NP, MP) dense substitution scores (torch or numpy; MP must
    divide by the mesh size), f32, or int8 on a one-device mesh; with
    ``folded=True`` (one device, one pair) the (NP, 8, MP // 8) layout of
    :func:`fold_S`.  ``n``, ``m``: (B,) true lengths; ``block_rows``: the
    wavefront's rows per step.  Returns, on the mesh's first device, LOCAL:
    (B,) best scores; GLOBAL / GLOCAL: (B, 3) final (M, X, Y) at (n, m)."""
    S = _scores(S)
    D = mesh.size
    K = block_rows
    if folded:
        NP, eight, Wf = S.shape
        assert D == 1 and eight == 8, (tuple(S.shape), D)
        S = S.reshape(1, NP, 8 * Wf)
    B, NP, MP = S.shape
    assert (MP // D) * D == MP, (MP, D)
    assert (NP // K) * K == NP, (NP, K)
    if folded or S.dtype != torch.float32:
        _check_grid_only(D, B, K, MP // D, None, S.dtype)
    dev = mesh.devices[0]
    n, m = _lengths(n, dev), _lengths(m, dev)
    pen = make_pen(mode, og, eg)
    if D == 1:
        best, _, acc, _ = grid_fill(S.to(dev).contiguous(), n, m, mode=mode,
                                    pen=pen)
        fin = acc[:, :3]
    else:
        best, _, fin, _, _ = _wavefront(S, n, m, mode=mode, pen=pen, K=K,
                                        mesh=mesh)
    return best.max(dim=1).values if mode == LOCAL else fin


def _stats(mode: int, best, best_i, fin) -> torch.Tensor:
    """The (B, 8) stats row: LOCAL [best, best_i, best_j, 0...], else
    [0, 0, 0, finalM, finalX, finalY, 0, 0]."""
    B = fin.shape[0]
    stats = torch.zeros((B, 8), dtype=torch.float32, device=fin.device)
    if mode == LOCAL:
        gmax, min_i, min_j = _merge_local(best, best_i)
        stats[:, 0] = gmax
        stats[:, 1] = min_i.to(torch.float32)
        stats[:, 2] = min_j.to(torch.float32)
    else:
        stats[:, 3:6] = fin
    return stats


def striped_fill_ckpt(S, n, m, *, mode: int, og: float, eg: float,
                      block_rows: int, ckpt_rows: int, mesh: Mesh):
    """Striped score fill with exact argmax stats and carry checkpoints.

    Returns ``(stats, (ckm, ckx, cky))`` on the mesh's first device: stats
    (B, 8) as ``ops/fill_dp``'s ([best, best_i, best_j, fM, fX, fY, 0, 0]);
    checkpoints (B, NP // ckpt_rows, MP) f32, row k the carries after
    global row (k+1) * ckpt_rows."""
    S = _scores(S)
    B, NP, MP = S.shape
    D = mesh.size
    K = block_rows
    assert (MP // D) * D == MP, (MP, D)
    assert (NP // K) * K == NP, (NP, K)
    assert ckpt_rows % K == 0 and NP % ckpt_rows == 0, (ckpt_rows, K, NP)
    if S.dtype != torch.float32:
        raise ValueError(f"striped_fill_ckpt takes f32 S, got {S.dtype}")
    dev = mesh.devices[0]
    n, m = _lengths(n, dev), _lengths(m, dev)
    pen = make_pen(mode, og, eg)
    if D == 1:
        best, best_i, acc, ck = grid_fill(S.to(dev).contiguous(), n, m,
                                          mode=mode, pen=pen, C=ckpt_rows)
        fin = acc[:, :3]
    else:
        best, best_i, fin, ck4, _ = _wavefront(
            S, n, m, mode=mode, pen=pen, K=K, mesh=mesh, C=ckpt_rows)
        ck = (ck4[0], ck4[1], ck4[2])
    return _stats(mode, best, best_i, fin), ck


def striped_band_tb(S_band, n, m, i0, icm, icx, icy, *, mode: int, og: float,
                    eg: float, block_rows: int, mesh: Mesh) -> torch.Tensor:
    """Re-fill a C-row band from checkpointed carries with pointer bytes
    across all shards (K12 at every mesh size).

    ``S_band`` (B, C, MP) f32 scores of global rows i0+1 .. i0+C; ``icm``,
    ``icx``, ``icy`` (B, MP) the carries at row ``i0``.  Returns tb
    (B, C, MP) uint8 on the mesh's first device: tb[b, r, c] holds the
    packed pointers of cell (i0 + r + 1, c + 1)."""
    S_band = _scores(S_band)
    B, C, MP = S_band.shape
    D = mesh.size
    K = block_rows
    assert (MP // D) * D == MP, (MP, D)
    assert (C // K) * K == C, (C, K)
    if S_band.dtype != torch.float32:
        raise ValueError(f"striped_band_tb takes f32 S, got {S_band.dtype}")
    dev = mesh.devices[0]
    n, m = _lengths(n, dev), _lengths(m, dev)
    seed = (int(i0),) + tuple(_scores(a) for a in (icm, icx, icy))
    *_, tb = _wavefront(S_band, n, m, mode=mode, pen=make_pen(mode, og, eg),
                        K=K, mesh=mesh, emit_tb=True, seed=seed)
    return tb


def _seg_windows(S, n, m, ck: Ckpts, row0: Ckpts, sk: int, bs: Sequence[int],
                 j0s: Sequence[int], *, mode: int, og: float, eg: float,
                 block_rows: int, mesh: Mesh, W: int, C: int) -> np.ndarray:
    """One traceback segment (JAX's ``_striped_seg_windows``,
    ``seq_tiled.py:1481-1509``): slice the segment's S band, select its
    seeds (checkpoint sk - 1, or row 0's carries), re-fill it with pointer
    bytes and gather each (pair, first column) window's (C, W) bytes to the
    host."""
    seeds = row0 if sk == 0 else tuple(a[:, sk - 1] for a in ck)
    tb = striped_band_tb(S[:, sk * C:(sk + 1) * C], n, m, sk * C, *seeds,
                         mode=mode, og=og, eg=eg, block_rows=block_rows,
                         mesh=mesh)
    return torch.stack([tb[b, :, j0:j0 + W] for b, j0 in zip(bs, j0s)]
                       ).cpu().numpy()


def striped_align(S, n, m, *, mode: int, og: float, eg: float, mesh: Mesh,
                  block_rows: int = 8, ckpt_rows: Optional[int] = None,
                  window: Optional[int] = None):
    """Full alignment of column-striped pairs over ``mesh``: one
    checkpointed striped fill, then per segment (top one first) striped
    band re-fills whose (C, window) column windows are walked on the host
    by ``ops/longseq.walk_band``; a walk that leaves its window on the left
    re-fills the same segment for the next window, as JAX's
    ``striped_align`` (``seq_tiled.py:1512-1610``) does.  Paths are
    bit-identical to the single-device fill.

    Returns ``(idx_lists, stats_np)``: idx_lists[b] = (idx1, idx2) aligned
    0-based index lists (-1 = gap); stats_np (B, 8)."""
    S = _scores(S)
    B, NP, MP = S.shape
    C = ckpt_rows or max(block_rows, min(256, NP))
    while NP % C or C % block_rows:
        C -= block_rows
    W = window or min(MP, -(-(2 * C + 128) // 128) * 128)
    W = min(W, MP)
    n_np = np.asarray(n.cpu() if isinstance(n, torch.Tensor) else n)
    m_np = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m)
    args = dict(mode=mode, og=og, eg=eg, block_rows=block_rows, mesh=mesh)
    stats, ck = striped_fill_ckpt(S, n_np, m_np, ckpt_rows=C, **args)
    stats_np = stats.cpu().numpy().copy()
    if mode != LOCAL:
        # start coords are closed-form for global/glocal
        stats_np[:, 1] = n_np.astype(np.float32)
        stats_np[:, 2] = m_np.astype(np.float32)

    cur: List[Optional[Tuple[int, int, int]]] = [None] * B
    chunks1: List[List[int]] = [[] for _ in range(B)]
    chunks2: List[List[int]] = [[] for _ in range(B)]
    for b in range(B):
        if mode == LOCAL:
            if stats_np[b, 0] > 0.0:
                cur[b] = (int(stats_np[b, 1]), int(stats_np[b, 2]),
                          CELL_MATCH)
        else:
            cur[b] = (int(n_np[b]), int(m_np[b]),
                      int(np.argmax(stats_np[b, 3:6])))

    local = mode == LOCAL
    dev = mesh.devices[0]
    row0 = tuple(torch.from_numpy(a).to(dev)
                 for a in longseq.row0_carries(B, MP, mode, og, eg))
    for sk in range(NP // C - 1, -1, -1):
        pend = [(b, *cur[b]) for b in range(B)
                if cur[b] is not None and sk * C < cur[b][0] <= (sk + 1) * C]
        while pend:
            j0s = [max(0, min(j - W, MP - W)) for _, _, j, _ in pend]
            wins = _seg_windows(S, n_np, m_np, ck, row0, sk,
                                [b for b, *_ in pend], j0s, W=W, C=C, **args)
            nxt = []
            for k, (b, i, j, s) in enumerate(pend):
                c1, c2, i, j, s, status = longseq.walk_band(
                    wins[k], sk * C, j0s[k], i, j, s, local)
                chunks1[b].extend(c1)
                chunks2[b].extend(c2)
                if status == longseq.WALK_LEFT:
                    nxt.append((b, i, j, s))
                else:
                    cur[b] = None if status == longseq.WALK_DONE else (i, j, s)
            pend = nxt

    idx_lists = []
    for b in range(B):
        if cur[b] is not None:  # pragma: no cover - walk must terminate
            raise RuntimeError(f"incomplete traceback for pair {b}: {cur[b]}")
        idx_lists.append((chunks1[b][::-1], chunks2[b][::-1]))
    return idx_lists, stats_np
