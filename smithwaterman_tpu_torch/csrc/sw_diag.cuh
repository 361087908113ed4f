// Per-lane step of the anti-diagonal (wavefront) LOCAL score fill, written
// once.
//
// nvcc compiles it into kernel K9 (diag_fill.cu), g++ into the host twin
// (cell_twin.cpp), which runs the step for every lane of a warp in turn and
// which the tier-1 tests hold against the JAX package's wavefront kernel
// (smithwaterman_tpu/ops/diag_dp.py fill_diag_scores).
//
// The pair's columns are cut into strips of LANES columns; lane l of a
// strip starting at column c0 holds, at step d, the cell (r, c) = (d - l,
// c0 + l) in 0-based interior coordinates (DP cell (r + 1, c + 1)).  The
// step rule is diag_dp.py:185-197:
//   T0 = max(W1 + og, 0);  Y = max(T0, Y1 + eg);
//   X  = shift(max(T0, X1 + eg));  M = max(shift(W2) + s, 0);
//   W  = max(M, X, Y);  best = max(best, M),
// where W1, X1, Y1 are the lane's values one step earlier (the cell above)
// and "shift" takes lane l - 1's value: its xpre is X of the cell to the
// left, and its W one step earlier is W of the diagonal cell.  Lane 0 takes
// both from the previous strip's last column (the edge, kept per row in a
// scratch of the pair) or, in the first strip, from the LOCAL boundary, 0.
// Folding every gap open through W = max(M, X, Y) is value-exact only
// under og <= eg <= 0: an open from X or Y then never beats the extend.
// The adds are the JAX kernel's, one each, and every max is exact in any
// order, so with no FMA contraction (nvcc --fmad=false, g++
// -ffp-contract=off) the values are the JAX kernel's bit for bit.
//
// Rows r < 0 (the top of the skew) are the LOCAL boundary and hold 0.
// Cells past the pair's end (r >= n or c >= m) feed only cells below or to
// the right of them, so they never reach a cell of the pair and are left
// out of the best: the JAX kernel's poisoned scores give the same values.
#pragma once

#include "sw_cell.cuh"

namespace sw {
namespace diag {

constexpr int LANES = 32;  // a strip's width: one warp

// One lane's registers.
struct Lane {
  float w1;    // W of the cell above, (r - 1, c)
  float x1;    // X of the cell above
  float y1;    // Y of the cell above
  float wd;    // W of the diagonal cell (r - 1, c - 1), for this step
  float best;  // this lane's running maximum of M over the pair's cells
};

SW_HD Lane lane_begin() { return {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}; }

// X of the cell right of (w, x)'s cell: what a lane hands its right
// neighbour before each step (from the values of its cell of the step
// before, which lies left of the neighbour's cell of this step), and the
// edge value a strip keeps for the next strip's lane 0 (diag_dp.py:230,
// fx = max(max(W + og, 0), X + eg)).
SW_HD float xpre(float w, float x, float og, float eg) {
  return mx(mx(w + og, 0.0f), x + eg);
}

// One step of one lane.  xin is X of the lane's cell (lane l - 1's xpre
// from before the step, or lane 0's edge fill), wl the W that becomes the
// diagonal of the lane's next cell (lane l - 1's w1 from before the step,
// or lane 0's edge W of row r).  top: r < 0; live: the cell lies in the
// pair.  Returns the cell's M.
SW_HD void step(Lane* L, float s, float xin, float wl, bool top, bool live,
                float og, float eg) {
  const float t0 = mx(L->w1 + og, 0.0f);
  float y = mx(t0, L->y1 + eg);
  float mm = mx(L->wd + s, 0.0f);
  float x = xin;
  float w = mx(mx(mm, x), y);
  if (top) w = x = y = mm = 0.0f;
  if (live) L->best = mx(L->best, mm);
  L->w1 = w;
  L->x1 = x;
  L->y1 = y;
  L->wd = wl;
}

// Steps of the strip starting at column c0 of an n x m pair: until the
// strip's last live lane has passed row n - 1.
SW_HD int strip_steps(int n, int m, int c0) {
  const int lanes = m - c0 < LANES ? m - c0 : LANES;
  return n + lanes - 1;
}

// The edge scratch of a pair: row r's (W, fx) of the previous strip's
// last column at edge[2r], edge[2r + 1].  Lane 0 of the strip at c0 reads
// row d at step d; the first strip and rows d >= n read 0.  A strip's last
// lane writes row r at step r + LANES - 1, after the row was read, so one
// buffer serves every strip.
SW_HD void lane0_fill(const float* edge, int n, int c0, int d, float* xin,
                      float* wl) {
  const bool have = c0 > 0 && d < n;
  *wl = have ? edge[2 * (int64_t)d] : 0.0f;
  *xin = have ? edge[2 * (int64_t)d + 1] : 0.0f;
}

// The last lane's write of its cell's row r to the edge, when a strip
// follows (c0 + LANES < m) and r lies in the pair.
SW_HD bool keeps_edge(int n, int m, int c0, int r) {
  return c0 + LANES < m && r >= 0 && r < n;
}

}  // namespace diag
}  // namespace sw
