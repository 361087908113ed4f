"""Plain reference: Gotoh's affine-gap DP with EMBOSS's tie rules.

A straightforward PyTorch implementation of the three alignment modes that
EMBOSS ``water`` (LOCAL) and ``needle`` (GLOBAL with ``-endweight``,
GLOCAL by default) compute, written for the benchmark and independent of
the program under test: it imports nothing of it.  It reads only the
sequences and the configuration (its own copy of the substitution table),
and works out every alignment again.

The DP runs one row at a time on a device, vectorised over pairs and
columns; the one sequential dependence inside a row, the horizontal gap
``X[j] = max(G[j-1], X[j-1] + pe)`` with ``G = max(M, Y) + po``, is the
max-plus prefix ``X[j] = cummax(G[k] - k*pe)[j-1] + (j-1)*pe``.  Scores
are multiples of a quarter, exact in float32, so the prefix gives the
sequential recurrence's values exactly; ``dtype`` lets a test or the
control compute in a lower precision, where it does not.

Tie rules (the reference engine's, which reproduce EMBOSS's strings):

* M from the diagonal: M >= X >= Y, the first maximum;
* Y (gap in seq2, from the cell above): GLOBAL / GLOCAL prefer Y, then
  M, then X on ties; LOCAL prefers X, then M, then Y;
* X (gap in seq1, from the cell to the left): GLOBAL / GLOCAL prefer X,
  then M, then Y; LOCAL prefers Y, then M, then X;
* LOCAL clamps M, X and Y at 0 and marks a zero-valued state "stop"; its
  end cell is the first maximum of M, rows first;
* GLOBAL / GLOCAL end at (n, m) in the first best of M, X, Y; GLOCAL's
  gaps along row 0, column 0, the last row and the last column are free.

Each pair's traceback pointers (2 bits a state, M in bits 0-1, X in 2-3,
Y in 4-5) stay on the device; the walk reads them in tiles copied to the
host as it reaches them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

GLOBAL, GLOCAL, LOCAL = "global", "glocal", "local"
MATCH, GAP_X, GAP_Y, STOP = 0, 1, 2, 3
NEG = -3.0e38
# side of the square tiles of pointer bytes the walk copies to the host
TILE = 1024
# rows a captured CUDA graph fills (even: the two row buffers come back)
GRAPH_ROWS = 64

Result = Tuple[str, str, float, int, int, int, int]


def _pack(codes: Sequence[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(codes), max(width, 1)), np.int64)
    for k, c in enumerate(codes):
        out[k, :len(c)] = c
    return out


def encode(seq: str, letters: str) -> np.ndarray:
    index = {c: k for k, c in enumerate(letters)}
    return np.asarray([index[c] for c in seq], np.int64)


class _Fill:
    """Pointers and end cells of a batch of pairs, filled on ``device``.

    One row is :meth:`_row`: ~35 device operations (~48 in LOCAL) over
    every pair and column at once.  On a CUDA device the rows run as
    replays of a CUDA graph of :data:`GRAPH_ROWS` captured rows, since
    launching each operation from Python takes longer than running it;
    a row that is the last of some pair outside LOCAL runs by itself."""

    def __init__(self, a: Sequence[np.ndarray], b: Sequence[np.ndarray],
                 table: np.ndarray, mode: str, go: float, ge: float,
                 dtype: torch.dtype, device):
        dev = self.dev = torch.device(device)
        self.mode, self.dtype = mode, dtype
        B = len(a)
        n = np.asarray([len(x) for x in a], np.int64)
        m = np.asarray([len(x) for x in b], np.int64)
        N, W = int(n.max()), int(m.max())
        self.n, self.m, self.N, self.W = n, m, N, W
        og, eg = -abs(float(go)), -abs(float(ge))
        self.og, self.eg = og, eg
        local = self.local = mode == LOCAL
        so, se = (og, eg) if mode == GLOBAL else (0.0, 0.0)
        self.so, self.se = so, se
        sent = 10.0 * og + 10.0 * eg

        def lsc(i):
            return i * se + (so - se)

        # each state's predecessor codes, shifted to its bits
        u8 = torch.uint8
        self.codes = [[torch.tensor(v << (2 * k), dtype=u8, device=dev)
                       for v in range(4)] for k in range(3)]

        tab = torch.tensor(np.asarray(table, np.float32), device=dev)
        bc = torch.from_numpy(_pack(b, W)).to(dev)
        K = tab.shape[0]
        # prof[c * B + r] = the scores of letter c against pair r's seq2
        self.prof = tab.to(dtype)[:, bc].reshape(K * B, W)
        rows = np.zeros((N + 1, B), np.int64)
        rows[1:] = _pack(a, N).T * B + np.arange(B)
        self.arow = torch.from_numpy(rows).to(dev)
        self.jcol = torch.arange(W + 1, device=dev).to(dtype)
        self.jpe = self.jcol * eg                      # j * pe, j = 0..W
        self.ndev = torch.from_numpy(n).to(dev)[:, None]
        mt = torch.from_numpy(m).to(dev)[:, None]
        self.rows = torch.arange(N + 1, device=dev)

        # row 0 and column 0 in closed form (the boundary chains)
        row0 = []
        for j in range(W + 1):
            vals = ((0.0, -1.0, -1.0) if j == 0 else
                    (lsc(j) + sent, lsc(j), lsc(j) + sent))
            prev = MATCH if j == 0 else GAP_X
            ptr = [STOP if local and v == 0.0 else prev for v in vals]
            row0.append(ptr[0] | ptr[1] << 2 | ptr[2] << 4)
        col0, edge = [], []
        for i in range(N + 1):
            vals = (lsc(i) + sent, lsc(i) + sent, lsc(i))
            ptr = [STOP if local and v == 0.0 else GAP_Y for v in vals]
            col0.append(ptr[0] | ptr[1] << 2 | ptr[2] << 4)
            # column 0's (M, X, Y) and X's own candidate at column 0
            edge.append(vals + (vals[1] + eg,))
        # pointers row-major, a row of every pair together: (N+1, B, W+1)
        self.tb = torch.empty((N + 1, B, W + 1), dtype=u8, device=dev)
        self.tb[0] = torch.tensor(row0, dtype=u8, device=dev)
        self.tb[:, :, 0] = torch.tensor(col0, dtype=u8, device=dev)[:, None]
        self.edge = torch.tensor(edge, dtype=dtype, device=dev)
        # two rows of (M, X, Y), filled in turn
        self.V = torch.empty((2, 3, B, W + 1), dtype=dtype, device=dev)
        self.V[0, 0] = torch.tensor(
            [0.0] + [lsc(j) + sent for j in range(1, W + 1)], dtype=dtype,
            device=dev)
        self.V[0, 1] = torch.tensor(
            [-1.0] + [lsc(j) for j in range(1, W + 1)], dtype=dtype,
            device=dev)
        self.V[0, 2] = torch.tensor(
            [-1.0] + [lsc(j) + sent for j in range(1, W + 1)], dtype=dtype,
            device=dev)

        # the vertical gap's penalties a column (GLOCAL: free in column m)
        if mode == GLOCAL:
            last_col = torch.arange(1, W + 1, device=dev)[None, :] == mt
            self.qo = torch.where(last_col, so, og).to(dtype)
            self.qe = torch.where(last_col, se, eg).to(dtype)
        else:
            self.qo, self.qe = og, eg
        self.jmask = None
        if local:
            if (m != W).any():
                self.jmask = torch.arange(1, W + 1, device=dev)[None, :] <= mt
            self.rowmax = torch.full((N + 1, B), NEG, dtype=dtype,
                                     device=dev)
            self.rowarg = torch.zeros((N + 1, B), dtype=torch.int64,
                                      device=dev)
        self.final = np.zeros((B, 3))
        self.ends: Dict[int, List[int]] = {}
        if not local:
            for r, nb in enumerate(n.tolist()):
                self.ends.setdefault(nb, []).append(r)

        self._fill_rows()
        if local:
            rm = torch.where(self.rows[1:, None] <= self.ndev[:, 0][None, :],
                             self.rowmax[1:], NEG)
            bi = torch.argmax(rm, dim=0)               # first maximum row
            self.best = rm.gather(0, bi[None])[0].float().cpu().numpy()
            self.best_i = (bi + 1).cpu().numpy()
            self.best_j = (self.rowarg[1:].gather(0, bi[None])[0] + 1
                           ).cpu().numpy()
        else:
            self.state = np.argmax(self.final, axis=1)  # first maximum

    def _fill_rows(self) -> None:
        """Rows 1..N, a row from V[src] into V[1 - src]."""
        N, src, i = self.N, 0, 1
        graph = None
        if self.dev.type == "cuda" and N > 2 * GRAPH_ROWS:
            # warm the row's operations up on a side stream, then capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._row(src, self.rows[i], i)
                    src, i = 1 - src, i + 1
            torch.cuda.current_stream().wait_stream(side)
            base = torch.zeros((), dtype=torch.int64, device=self.dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for r in range(GRAPH_ROWS):  # even: src comes back to 0
                    self._row(r % 2, base + r, None)
        while i <= N:
            if (graph is not None and src == 0 and i + GRAPH_ROWS - 1 <= N
                    and not any(e in self.ends for e in
                                range(i, i + GRAPH_ROWS))):
                base.fill_(i)
                graph.replay()
                i += GRAPH_ROWS
                continue
            self._row(src, self.rows[i], i)
            src, i = 1 - src, i + 1
        if graph is not None:
            torch.cuda.synchronize()
            del graph

    def _row(self, src: int, it: torch.Tensor, i) -> None:
        """Row ``it`` (a device scalar; ``i`` the same on the host, or
        None inside a captured graph) from V[src] into V[1 - src]."""
        local, V = self.local, self.V
        (c0, c1, c2, c3), (x0, x1, x2, x3), (y0, y1, y2, y3) = self.codes
        pM, pX, pY = V[src]
        cM, cX, cY = V[1 - src]
        edge = self.edge.index_select(0, it.view(1))   # (1, 4)
        V[1 - src, :, :, 0].copy_(edge[0, :3, None])
        s = self.prof.index_select(
            0, self.arow.index_select(0, it.view(1)).view(-1))
        Md, Xd, Yd = pM[:, :-1], pX[:, :-1], pY[:, :-1]
        Mu, Xu, Yu = pM[:, 1:], pX[:, 1:], pY[:, 1:]
        # M from the diagonal: M, then X, then Y on ties
        mxy = torch.maximum(Xd, Yd)
        torch.add(torch.maximum(Md, mxy), s, out=cM[:, 1:])
        pm = torch.where(Md >= mxy, c0, torch.where(Xd >= Yd, c1, c2))
        # Y from the cell above
        if local:  # X, then M, then Y on ties
            ym, yy, yx = Mu + self.og, Yu + self.eg, Xu + self.og
            mmy = torch.maximum(ym, yy)
            torch.maximum(mmy, yx, out=cY[:, 1:])
            py = torch.where(yx >= mmy, y1, torch.where(ym >= yy, y0, y2))
            cM[:, 1:].clamp_min_(0.0)
            cY[:, 1:].clamp_min_(0.0)
        else:  # Y, then M, then X on ties
            mx = torch.maximum(Mu, Xu) + self.qo
            yy = Yu + self.qe
            torch.maximum(mx, yy, out=cY[:, 1:])
            py = torch.where(yy >= mx, y2, torch.where(Mu >= Xu, y0, y1))
        # X from the cell to the left, as a max-plus prefix
        end = i is not None and i in self.ends
        if end and self.mode == GLOCAL:  # free gaps along a last row
            last = self.ndev == it
            po = torch.where(last, self.so, self.og).to(self.dtype)
            pe = torch.where(last, self.se, self.eg).to(self.dtype)
            jp = self.jcol * pe
            x0pe = edge[:, 1:2] + pe
        else:
            po, pe, jp, x0pe = self.og, self.eg, self.jpe, edge[:, 3:4]
        G = torch.maximum(cM, cY) + po
        H = G - jp
        torch.maximum(H[:, :1], x0pe, out=H[:, :1])
        C = torch.cummax(H, dim=1).values
        torch.add(C[:, :-1], jp[..., :-1], out=cX[:, 1:])
        Mm, Xm, Ym = cM[:, :-1], cX[:, :-1], cY[:, :-1]
        if local:  # Y, then M, then X on ties
            cX[:, 1:].clamp_min_(0.0)
            xm, xx, xy = Mm + self.og, Xm + self.eg, Ym + self.og
            mmx = torch.maximum(xm, xx)
            px = torch.where(xy >= mmx, x2, torch.where(xm >= xx, x0, x1))
            pm = torch.where(cM[:, 1:] == 0, c3, pm)
            px = torch.where(cX[:, 1:] == 0, x3, px)
            py = torch.where(cY[:, 1:] == 0, y3, py)
        else:  # X, then M, then Y on ties; G[:, :-1] is max(M, Y) + po
            px = torch.where(Xm + pe >= G[:, :-1], x1,
                             torch.where(Mm >= Ym, x0, x2))
        self.tb[:, :, 1:].index_copy_(0, it.view(1), (pm + px + py)[None])
        if local:
            v = cM[:, 1:] if self.jmask is None else \
                torch.where(self.jmask, cM[:, 1:], NEG)
            vals, args = torch.max(v, dim=1)
            self.rowmax.index_copy_(0, it.view(1), vals[None])
            self.rowarg.index_copy_(0, it.view(1), args[None])
        elif end:
            for r in self.ends[i]:
                mb = int(self.m[r])
                self.final[r] = [float(cM[r, mb]), float(cX[r, mb]),
                                 float(cY[r, mb])]

    def start(self, r: int):
        """(score, i, j, state) the walk of pair ``r`` starts from, or
        (score, None, None, None) for a LOCAL pair with nothing aligned."""
        if self.mode == LOCAL:
            best = float(self.best[r])
            if best <= 0.0:
                return max(best, 0.0), None, None, None
            return best, int(self.best_i[r]), int(self.best_j[r]), MATCH
        s = int(self.state[r])
        return (float(self.final[r, s]), int(self.n[r]), int(self.m[r]), s)

    def walk(self, r: int, i: int, j: int, s: int):
        """The aligned index lists (-1 a gap) of pair ``r`` from (i, j, s),
        left to right."""
        local = self.mode == LOCAL
        tiles: Dict[Tuple[int, int], np.ndarray] = {}
        tb = self.tb[:, r]
        r1: List[int] = []
        r2: List[int] = []
        while True:
            # a state that walks onto the boundary follows its gap chain
            if j == 0 and i > 0:
                s = GAP_Y
            elif i == 0 and j > 0:
                s = GAP_X
            key = (i // TILE, j // TILE)
            t = tiles.get(key)
            if t is None:
                t = tiles[key] = tb[key[0] * TILE:(key[0] + 1) * TILE,
                                    key[1] * TILE:(key[1] + 1) * TILE
                                    ].cpu().numpy()
            prev = (int(t[i % TILE, j % TILE]) >> (2 * s)) & 3
            if local and prev == STOP:
                break
            if s == MATCH:
                r1.append(i - 1)
                r2.append(j - 1)
                i -= 1
                j -= 1
            elif s == GAP_X:
                r1.append(-1)
                r2.append(j - 1)
                j -= 1
            else:
                r1.append(i - 1)
                r2.append(-1)
                i -= 1
            if i == 0 and j == 0:
                break
            s = prev
        r1.reverse()
        r2.reverse()
        return r1, r2


def rebuild(seq1: str, seq2: str, idx1: Sequence[int], idx2: Sequence[int],
            score: float) -> Result:
    """The alignment strings with every letter retained: the aligned core
    between seq1's and seq2's unaligned heads (each over gaps, seq1's
    first) and tails; with nothing aligned, seq1 over gaps then gaps over
    seq2.  Spans are 0-based and inclusive, -1 when nothing aligned."""
    core1 = "".join(seq1[k] if k >= 0 else "-" for k in idx1)
    core2 = "".join(seq2[k] if k >= 0 else "-" for k in idx2)
    on1 = [k for k in idx1 if k >= 0]
    on2 = [k for k in idx2 if k >= 0]
    if not on1 or not on2:
        return (seq1 + "-" * len(seq2), "-" * len(seq1) + seq2, score,
                -1, -1, -1, -1)
    s1, e1, s2, e2 = on1[0], on1[-1], on2[0], on2[-1]
    a1 = (seq1[:s1] + "-" * s2 + core1 + seq1[e1 + 1:]
          + "-" * (len(seq2) - e2 - 1))
    a2 = ("-" * s1 + seq2[:s2] + core2 + "-" * (len(seq1) - e1 - 1)
          + seq2[e2 + 1:])
    return (a1, a2, score, s1, e1, s2, e2)


def align(pairs: Sequence[Tuple[str, str]], config: dict, device="cpu",
          dtype: torch.dtype = torch.float32,
          budget: int = 48 << 30) -> List[Result]:
    """Every pair's (aligned1, aligned2, score, start1, end1, start2,
    end2), all letters retained, as EMBOSS prints them for ``config``'s
    mode, table and gap penalties.  Pairs are filled in groups whose
    pointer bytes fit ``budget``; each group's pointers are freed before
    the next is filled."""
    mat = config["matrix"]
    letters, table = mat["letters"], np.asarray(mat["rows"], np.float32)
    go, ge, mode = config["gap_open"], config["gap_extend"], config["mode"]
    out: List[Result] = [None] * len(pairs)  # type: ignore[list-item]
    order = sorted(range(len(pairs)),
                   key=lambda k: (len(pairs[k][0]), len(pairs[k][1])))
    groups, cur, size = [], [], 0
    for k in order:
        a, b = pairs[k]
        nbytes = (len(a) + 1) * (len(b) + 1)
        if cur and size + nbytes > budget:
            groups.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += nbytes
    if cur:
        groups.append(cur)
    for grp in groups:
        for k in grp:
            a, b = pairs[k]
            if not a or not b:
                raise ValueError("the reference takes non-empty sequences")
        fill = _Fill([encode(pairs[k][0], letters) for k in grp],
                     [encode(pairs[k][1], letters) for k in grp],
                     table, mode, go, ge, dtype, device)
        for r, k in enumerate(grp):
            score, i, j, s = fill.start(r)
            idx1, idx2 = ([], []) if i is None else fill.walk(r, i, j, s)
            out[k] = rebuild(pairs[k][0], pairs[k][1], idx1, idx2, score)
        del fill
    return out


def layers(config: dict, r: Result) -> Dict[str, tuple]:
    """The fields of one result that each layer of the program decides,
    as the comparison holds them (``check.compare``): the fill gives the
    score, and in LOCAL the end cell; the walk where the path starts, and
    outside LOCAL where it ends; the rebuild both aligned strings."""
    a1, a2, score, s1, e1, s2, e2 = r
    if config["mode"] == LOCAL:
        return {"fill": (score, e1, e2), "walk": (s1, s2),
                "rebuild": (a1, a2)}
    return {"fill": (score,), "walk": (s1, s2, e1, e2), "rebuild": (a1, a2)}
