// Per-lane step of the anti-diagonal (wavefront) LOCAL score fill, written
// once.
//
// nvcc compiles it into kernel K9 (diag_fill.cu), g++ into the host twin
// (cell_twin.cpp), which runs the step for every lane of a warp in turn and
// which the tier-1 tests hold against the JAX package's wavefront kernel
// (smithwaterman_tpu/ops/diag_dp.py fill_diag_scores).
//
// The pair's columns are cut into strips of LANES * R columns (R columns a
// lane, a template constant); lane l of a strip starting at column c0
// holds, at step d, the R cells (r, c0 + l R + k), k = 0 .. R-1, of row
// r = d - l, in 0-based interior coordinates (DP cell (r + 1, c + 1)).  The
// step rule is diag_dp.py:185-197, cell by cell:
//   T0 = max(W1 + og, 0);  Y = max(T0, Y1 + eg);
//   X  = max(T0', X' + eg) of the cell to the left;  M = max(W2 + s, 0);
//   W  = max(M, X, Y);  best = max(best, M),
// where W1, Y1 are the cell above's (the lane's values one step earlier),
// W2 the diagonal cell's W and T0', X' the left cell's.  A lane sweeps its
// R cells left to right: cell k > 0 takes X from cell k-1 of the same step
// and its diagonal from cell k-1's W of the step before; cell 0 takes both
// from lane l - 1 (a shuffle of its last column: X from before the step, W
// one step earlier, as `wd`).  Lane 0 takes them from the previous strip's
// last column (the edge, kept per row in a scratch of the pair) or, in
// the first strip, from the LOCAL boundary, 0.
// Folding every gap open through W = max(M, X, Y) is value-exact only
// under og <= eg <= 0: an open from X or Y then never beats the extend.
// The adds are the JAX kernel's, one each, and every max is exact in any
// order, so with no FMA contraction (nvcc --fmad=false, g++
// -ffp-contract=off) the values are the JAX kernel's bit for bit.
//
// Rows r < 0 (the top of the skew) are the LOCAL boundary and hold 0.
// Cells past the pair's end (r >= n or c >= m, the dead columns of a last
// strip narrower than LANES * R among them) feed only cells below or to
// the right of them, so they never reach a cell of the pair and are left
// out of the best: the JAX kernel's poisoned scores give the same values.
#pragma once

#include "sw_cell.cuh"

namespace sw {
namespace diag {

constexpr int LANES = 32;  // lanes of a strip: one warp

// One lane's registers: R cells of one row.
template <int R>
struct Lane {
  float w1[R];  // W of each cell above, (r - 1, c)
  float y1[R];  // Y of each cell above
  float xr;     // X of the cell right of the last one: the right lane's
                // (or the edge's) fx, max(max(W + og, 0), X + eg)
  float wd;     // W of cell 0's diagonal (r - 1, c - 1), for this step
  float best;   // this lane's running maximum of M over the pair's cells
};

template <int R>
SW_HD Lane<R> lane_begin() {
  Lane<R> L;
  for (int k = 0; k < R; ++k) L.w1[k] = L.y1[k] = 0.0f;
  L.xr = L.wd = L.best = 0.0f;
  return L;
}

// The maximum of two of the fill's values: one FMNMX on the card.  The
// values are never NaN and never -0 (every zero is the boundary's +0, a
// max with +0, or a sum of which one term is +0), where fmaxf and sw::mx
// give the same bits.
SW_HD float fmx(float a, float b) {
#if defined(__CUDA_ARCH__)
  return fmaxf(a, b);
#else
  return mx(a, b);
#endif
}

// X of the cell right of (w, x)'s cell (diag_dp.py:230, fx = max(max(W +
// og, 0), X + eg)): what a cell hands the next cell of its row.
SW_HD float xpre(float w, float x, float og, float eg) {
  return fmx(fmx(w + og, 0.0f), x + eg);
}

// One step of one lane.  s: the R cells' scores; xin: X of cell 0 (lane
// l - 1's xr from before the step, or lane 0's edge fx); wl: the W that
// becomes cell 0's diagonal at the next step (lane l - 1's last w1 from
// before the step, or lane 0's edge W of row r).  top: r < 0; live: how
// many of the R cells lie in the pair (0 for a row outside it).  BODY:
// the caller knows the row lies in the pair and every cell is live (top
// false, live R), so neither is tested.
template <int R, bool BODY = false>
SW_HD void step(Lane<R>* L, const float* s, float xin, float wl, bool top,
                int live, float og, float eg) {
  float x = xin, diag = L->wd, best = L->best;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float up = L->w1[k];
    const float t0 = fmx(up + og, 0.0f);
    float y = fmx(t0, L->y1[k] + eg);
    float mm = fmx(diag + s[k], 0.0f);
    float w = fmx(fmx(mm, x), y);
    if (!BODY && top) w = x = y = mm = 0.0f;
    if (BODY || k < live) best = fmx(best, mm);
    diag = up;
    L->w1[k] = w;
    L->y1[k] = y;
    x = xpre(w, x, og, eg);
  }
  L->xr = x;
  L->wd = wl;
  L->best = best;
}

// A compile-time flag handed to a generic step (the BODY variant).
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The steps of a strip whose every lane steps in the body (BODY): rows r
// = d - lane in the pair for every lane (LANES - 1 <= d < n) and every
// column live (the strip full: c0 + LANES R <= m).  Empty otherwise.
// A strip's steps 0 .. steps-1 are run as [0, d0) general, [d0, d1) BODY,
// [d1, steps) general.
template <int R>
SW_HD void body_steps(int n, int m, int c0, int steps, int* d0, int* d1) {
  const bool full = c0 + LANES * R <= m;
  *d0 = LANES - 1 < steps ? LANES - 1 : steps;
  *d1 = full && n > *d0 ? n : *d0;
}

// Columns a strip of R columns a lane spans.
template <int R>
SW_HD int strip_cols() {
  return LANES * R;
}

// The cells of a lane's R that lie in the pair: lane l of the strip at c0
// of a pair m columns wide (0 to R).
template <int R>
SW_HD int live_cols(int m, int c0, int lane) {
  const int v = m - c0 - lane * R;
  return v < 0 ? 0 : (v > R ? R : v);
}

// Steps of the strip starting at column c0 of an n x m pair: until the
// strip's last lane with a live cell has passed row n - 1.
template <int R>
SW_HD int strip_steps(int n, int m, int c0) {
  const int need = (m - c0 + R - 1) / R;
  return n + (need < LANES ? need : LANES) - 1;
}

// Lane 0's feed, staged LANES rows at a time in shared memory: at step d
// with d % LANES == 0 lane l stages row d + l (stage_row), and lane 0
// reads row d at step d from the stage.  Row r's feed is the previous
// strip's last column at row r: edge[2r] its W, edge[2r + 1] its fx; the
// first strip and rows past n take the boundary, 0.
SW_HD bool stages(int d) { return d % LANES == 0; }
SW_HD int stage_row(int d, int lane) { return d + lane; }

struct Feed {
  int code;  // the row's seq1 code
  float w;   // edge W
  float x;   // edge fx
};

template <typename CODE>
SW_HD Feed feed_row(const CODE* c1, const float* edge, int n, int c0,
                    int row) {
  Feed f;
  const bool in = row < n;
  const bool have = c0 > 0 && in;
  f.code = in ? (int)c1[row] : 0;
  f.w = have ? edge[2 * (int64_t)row] : 0.0f;
  f.x = have ? edge[2 * (int64_t)row + 1] : 0.0f;
  return f;
}

// The row whose edge the strip's last lane writes at step d, after its
// step: its own row d - (LANES - 1), LANES - 1 steps after lane 0 read
// the same row's feed (at most LANES - 1 steps after it was staged), so
// one buffer serves every strip.  keeps_edge: a strip follows (c0 + LANES
// R < m) and the row lies in the pair.
SW_HD int edge_row(int d) { return d - (LANES - 1); }

template <int R>
SW_HD bool keeps_edge(int n, int m, int c0, int r) {
  return c0 + strip_cols<R>() < m && r >= 0 && r < n;
}

}  // namespace diag
}  // namespace sw
