"""Exact DP fill oracle in PyTorch, batched over pairs.

The counterpart of ``smithwaterman_tpu/ops/scan_dp.py`` (a ``lax.scan``
over rows, vmapped over pairs): a Python loop over rows, vectorized over
pairs and columns, with the same cell rules and the same comparison
cascades, verbatim.  The only j-sequential dependence in a row, the X
recurrence ``X[j] = max(G[j-1], X[j-1] + pe)`` with ``G = max(M, Y) + po``,
is the max-plus prefix ``X[j] = cummax(G[k] - k*pe)[j-1] + (j-1)*pe``
(``torch.cummax``); all scores are quarter-integers well inside f32's exact
range, so the prefix reproduces the sequential recurrence bit-exactly and
the predecessor pointers are recovered elementwise afterwards.

This is the port's reference for its kernels (``fill_dp.fill_ref`` is
built on it) and the single-pair ``Aligner``'s fill.  Semantics parity
with the reference engine: sequence_alignment.rs:55-387 (see the JAX
module's docstring for the rule-by-rule citations).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CELL_STOP, GLOBAL, LOCAL

NEG = -3.0e38


class FillResult(NamedTuple):
    tb: torch.Tensor           # (B, npad+1, mpad+1) uint8 packed pointers
    best: torch.Tensor         # (B,) local: best M score
    best_i: torch.Tensor       # (B,) local: argmax row (first max, i-major)
    best_j: torch.Tensor       # (B,) local: argmax col within that row
    final: torch.Tensor        # (B, 3) global/glocal: (M, X, Y) at (n, m)
    final_state: torch.Tensor  # (B,) global/glocal: argmax state (first)
    # (M, X, Y) of the last row filled at columns 1..mpad, each (B, mpad)
    carry: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def _shift_right(v: torch.Tensor) -> torch.Tensor:
    """out[:, j] = v[:, j-1]; out[:, 0] = v[:, 0] (junk, overwritten)."""
    return torch.cat([v[:, :1], v[:, :-1]], dim=1)


def fill(S: torch.Tensor, n: torch.Tensor, m: torch.Tensor, og: float,
         eg: float, mode: int, with_traceback: bool = True, *, i0: int = 0,
         seed: Optional[Tuple[torch.Tensor, torch.Tensor,
                              torch.Tensor]] = None) -> FillResult:
    """Fill the DP over padded dense score matrices.

    Args:
      S: (B, npad, mpad) float32, S[b, r, j-1] = score of pairing
         seq1[i0 + r] with seq2[j-1]; the padded region is arbitrary.
      n, m: (B,) true lengths, 1 <= n, 1 <= m <= mpad.
      og, eg: negative gap open/extend penalties (rounded to f32).
      mode: GLOBAL / GLOCAL / LOCAL.
      i0, seed: a band refill (the long-sequence route, ops/longseq.py):
         S holds global rows i0+1 .. i0+npad, and seed the (M, X, Y) of
         row i0 at columns 1..mpad (each (B, mpad)); without a seed, row
         i0 == 0 is the closed-form boundary row.  Every rule that depends
         on the row (column 0, GLOCAL's free last row, the LOCAL argmax)
         uses the global i.
    Returns a :class:`FillResult` whose tb covers the boundary row and
    column (``(B, 1, 1)`` zeros when ``with_traceback`` is False; with a
    seed, tb's row 0 is zeros).  LOCAL best / best_i / best_j are the first
    maximum over the filled rows i <= n (best = NEG when none is).
    """
    dev = S.device
    f32 = torch.float32
    B, npad, mpad = S.shape
    n = n.to(device=dev, dtype=torch.int64)
    m = m.to(device=dev, dtype=torch.int64)
    # every scalar is an f32 tensor, so each partial sum rounds as in the
    # JAX oracle (f32 throughout)
    og = torch.tensor(og, dtype=f32, device=dev)
    eg = torch.tensor(eg, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    if mode == GLOBAL:
        so, se = og, eg
    else:
        so, se = zero, zero
    sent = 10.0 * og + 10.0 * eg

    jvec = torch.arange(mpad + 1, device=dev)[None, :]       # (1, mpad+1)
    jf = jvec.to(f32)
    j0 = jvec == 0
    u8 = torch.uint8

    if seed is None:
        if i0 != 0:
            raise ValueError("a fill starting below row 0 needs a seed")
        # ---- boundary row i == 0 and the origin (rs:88-108)
        lsc = jf * se + (so - se)
        Mp = torch.where(j0, zero, lsc + sent).expand(B, -1)
        minus1 = torch.tensor(-1.0, device=dev)
        Xp = torch.where(j0, minus1, lsc).expand(B, -1)
        Yp = torch.where(j0, minus1, lsc + sent).expand(B, -1)
        # prev: the origin points to M, the rest of row 0 to X
        prev0 = (~j0).to(torch.int64).expand(B, -1)
        pm0 = px0 = py0 = prev0
        if mode == LOCAL:
            pm0 = torch.where(Mp == 0.0, CELL_STOP, prev0)
            px0 = torch.where(Xp == 0.0, CELL_STOP, prev0)
            py0 = torch.where(Yp == 0.0, CELL_STOP, prev0)
        row0 = (pm0 | (px0 << 2) | (py0 << 4)).to(u8)
    else:
        # ---- row i0 from the seed; its column 0 is the origin (i0 == 0)
        # or the closed-form (i0, 0) of the chain down column 0
        if i0 == 0:
            c0 = [torch.tensor(v, dtype=f32, device=dev)
                  for v in (0.0, -1.0, -1.0)]
        else:
            lsc0 = torch.tensor(float(i0), dtype=f32, device=dev) * se + \
                (so - se)
            c0 = [lsc0 + sent, lsc0 + sent, lsc0]
        Mp, Xp, Yp = (torch.cat([c.expand(B, 1), v.to(f32)], dim=1)
                      for c, v in zip(c0, seed))
        row0 = torch.zeros((B, mpad + 1), dtype=u8, device=dev)
    tb_rows = [row0] if with_traceback else None

    # Y's last-column switch (glocal; rs:169-170)
    if mode == LOCAL:
        qo = og.expand(B, mpad + 1)
        qe = eg.expand(B, mpad + 1)
    else:
        lastc = jvec == m[:, None]
        qo = torch.where(lastc, so, og)
        qe = torch.where(lastc, se, eg)

    Spad = torch.cat([torch.zeros((B, npad, 1), dtype=f32, device=dev),
                      S.to(f32)], dim=2)
    jmask = (jvec >= 1) & (jvec <= m[:, None])
    rowmax = []
    rowarg = []
    final = torch.zeros((B, 3), dtype=f32, device=dev)

    # each row's index as an f32 on the device, made once: a tensor made
    # from a Python number a row would be a host-to-device copy a row,
    # which waits for the device
    fis = torch.arange(i0 + 1, i0 + npad + 1, dtype=f32, device=dev)
    for i in range(i0 + 1, i0 + npad + 1):
        srow = Spad[:, i - i0 - 1, :]
        fi = fis[i - i0 - 1]

        # ---- M: from (i-1, j-1); tie order M >= X >= Y (rs:139-158)
        Mp1, Xp1, Yp1 = _shift_right(Mp), _shift_right(Xp), _shift_right(Yp)
        m_ge_x = Mp1 >= Xp1
        m_ge_y = Mp1 >= Yp1
        x_ge_y = Xp1 >= Yp1
        prev_m = torch.where(m_ge_x, torch.where(m_ge_y, 0, 2),
                             torch.where(x_ge_y, 1, 2))
        val_m = torch.maximum(torch.maximum(Mp1, Xp1), Yp1) + srow

        # ---- Y: gap in seq2, from (i-1, j)
        if mode == LOCAL:
            # rs:233-252: `>=` favors M-open, inner `>` favors X on ties
            c1 = Mp + og >= Yp + eg
            c2 = Mp > Xp
            c3 = Yp + eg > Xp + og
            val_y = torch.where(c1, torch.where(c2, Mp + og, Xp + og),
                                torch.where(c3, Yp + eg, Xp + og))
        else:
            # rs:192-211: strict `>` for M-open vs Y-extend
            c1 = Mp + qo > Yp + qe
            c2 = Mp >= Xp
            c3 = Yp + qe >= Xp + qo
            val_y = torch.maximum(torch.maximum(Mp + qo, Yp + qe), Xp + qo)
        prev_y = torch.where(c1, torch.where(c2, 0, 1),
                             torch.where(c3, 2, 1))

        if mode == LOCAL:
            val_m = torch.clamp_min(val_m, 0.0)
            val_y = torch.clamp_min(val_y, 0.0)

        # ---- boundary column j == 0 (rs:109-117)
        lsc_i = fi * se + (so - se)
        val_m = torch.where(j0, lsc_i + sent, val_m)
        val_y = torch.where(j0, lsc_i, val_y)
        prev_m = torch.where(j0, 2, prev_m)
        prev_y = torch.where(j0, 2, prev_y)

        # ---- X: gap in seq1, from (i, j-1), as a max-plus prefix
        if mode == LOCAL:
            po, pe = og.expand(B, 1), eg.expand(B, 1)
        else:
            # glocal: free gaps along the last row of seq1 (rs:166-167)
            last_row = (n == i)[:, None]
            po = torch.where(last_row, so, og)
            pe = torch.where(last_row, se, eg)
        x0b = lsc_i + sent  # boundary X at (i, 0)
        G = torch.maximum(val_m, val_y) + po
        H = G - jf * pe
        H = torch.cat([torch.maximum(G[:, :1], x0b + pe), H[:, 1:]], dim=1)
        C = torch.cummax(H, dim=1).values
        val_x = _shift_right(C) + (jf - 1.0) * pe
        if mode == LOCAL:
            val_x = torch.clamp_min(val_x, 0.0)
        val_x = torch.where(j0, x0b, val_x)

        # ---- X predecessor pointers, recovered elementwise
        Mm1, Xm1, Ym1 = (_shift_right(val_m), _shift_right(val_x),
                         _shift_right(val_y))
        if mode == LOCAL:
            d1 = Mm1 + og >= Xm1 + eg
            d2 = Mm1 > Ym1
            d3 = Xm1 + eg > Ym1 + og
        else:
            d1 = Mm1 + po > Xm1 + pe
            d2 = Mm1 >= Ym1
            d3 = Xm1 + pe >= Ym1 + po
        prev_x = torch.where(d1, torch.where(d2, 0, 2),
                             torch.where(d3, 1, 2))
        prev_x = torch.where(j0, 2, prev_x)

        if mode == LOCAL:
            prev_m = torch.where(val_m == 0.0, CELL_STOP, prev_m)
            prev_x = torch.where(val_x == 0.0, CELL_STOP, prev_x)
            prev_y = torch.where(val_y == 0.0, CELL_STOP, prev_y)

        # ---- per-row outputs
        masked = torch.where(jmask, val_m, NEG)
        arg = torch.argmax(masked, dim=1)   # first maximum
        rowarg.append(arg)
        rowmax.append(masked.gather(1, arg[:, None])[:, 0])
        at_n = (n == i)[:, None]
        lastcol = torch.stack(
            [v.gather(1, m[:, None])[:, 0] for v in (val_m, val_x, val_y)],
            dim=1)
        final = torch.where(at_n, lastcol, final)
        if with_traceback:
            tb_rows.append((prev_m | (prev_x << 2) | (prev_y << 4)).to(u8))
        Mp, Xp, Yp = val_m, val_x, val_y

    if with_traceback:
        tb = torch.stack(tb_rows, dim=1)
    else:
        tb = torch.zeros((B, 1, 1), dtype=u8, device=dev)

    # local argmax: first row (i-major), then first column, strict `>`
    # (rs:282-295: only the M state competes)
    rm = torch.stack(rowmax, dim=1)                     # (B, npad)
    ra = torch.stack(rowarg, dim=1)
    ivec = torch.arange(i0 + 1, i0 + npad + 1, device=dev)[None, :]
    rm = torch.where(ivec <= n[:, None], rm, NEG)
    bi = torch.argmax(rm, dim=1)
    best = rm.gather(1, bi[:, None])[:, 0]
    best_j = ra.gather(1, bi[:, None])[:, 0].to(torch.int32)
    final_state = torch.argmax(final, dim=1).to(torch.int32)
    return FillResult(tb, best, (bi + 1 + i0).to(torch.int32), best_j,
                      final, final_state,
                      (Mp[:, 1:], Xp[:, 1:], Yp[:, 1:]))
