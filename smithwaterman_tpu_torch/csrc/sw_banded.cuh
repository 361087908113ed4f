// The banded fill (kernel K7, banded_fill.cu), the banded scores' offsets
// (kernel K6, banded_scores.cu) and the banded walk (kernel K8,
// banded_walk.cu), written once.
//
// nvcc compiles it into the kernels; g++ compiles it into the host twin
// (cell_twin.cpp), which runs the fill's per-thread phases for thread
// 0 .. THREADS-1 in turn between the points where the card's block waits.
// No thread reads in a phase what another writes in it, so the twin's
// order is one the card may take too.
//
// Semantics are smithwaterman_tpu/ops/banded.py's, bit for bit: the fill
// is _kernel (:61-280), the walk _walk_banded_device (:435-500).  Lane w of
// band row i is DP cell (i, jg) with jg = off(i) + w + 1, where
// off(i) = clip(min(i, n) * num / den, 0, num), num = max(m - W, 0) and
// den = max(n, 1): band_offsets' integer formula, in 64 bits.  The band is
// not sw_cell.cuh's sequential recurrence on a narrower grid:
//   * outside the band a value is BNEG = -1e30 (not sw_cell.cuh's -3e38);
//   * the diag of lane w is lane w + dlt - 1 of the row above and its up
//     lane w + dlt (dlt = off(i) - off(i-1), 0 or 1); lane 0's diag when
//     dlt == 0 is cell (i-1, 0) if off(i) == 0, else BNEG, and lane W-1's
//     up when dlt == 1 is BNEG;
//   * X is a max-plus prefix in normalised coordinates: with G(w) =
//     max(M, Y)(w) + po and G(-1) cell (i, 0)'s Y + po (BNEG unless
//     off(i) == 0), h(w) = G(w-1) - (jg-1)*pe (and max(h, X(i, 0) + pe) at
//     jg == 1), X(w) = max(BNEG, h(0..w)) + (jg-1)*pe.  Max is exact in any
//     order, so the prefix is taken in any grouping: each thread over its
//     own lanes, then across threads;
//   * X's pointer compares lane w-1's final (M, X, Y) of the same row.
// The LOCAL best is per lane: each lane keeps its first strict-`>` maximum
// of M over rows i <= n at columns jg <= m; the lanes are merged at the end
// by value, then smaller row, then smaller lane.  Build with no FMA
// contraction (nvcc --fmad=false, g++ -ffp-contract=off), as sw_cell.cuh.
#pragma once

#include "sw_band.cuh"

namespace sw {
namespace banded {

constexpr float BNEG = -1.0e30f;
constexpr int BIGI = 1 << 30;
// K7's threads per pair: every band width is a multiple of 128, and each
// thread owns W / THREADS contiguous lanes
constexpr int THREADS = 128;
// K7's scratch per pair, rows of W floats: the (M, X, Y) rows of two band
// rows (by row parity), then the LOCAL per-lane best and its row (int32)
constexpr int SCRATCH_ROWS = 8;

// One pair's band geometry.
struct Geom {
  int n, m, W;
  int64_t num, den;
};

SW_HD Geom geom(int n, int m, int W) {
  Geom g;
  g.n = n;
  g.m = m;
  g.W = W;
  g.num = m > W ? (int64_t)(m - W) : 0;
  g.den = n > 1 ? n : 1;
  return g;
}

// off(min(i, n)), i >= 0.
SW_HD int offset(const Geom& g, int64_t i) {
  const int64_t ii = i < g.n ? i : g.n;
  int64_t o = ii * g.num / g.den;
  if (o < 0) o = 0;
  if (o > g.num) o = g.num;
  return (int)o;
}

// What every thread needs of band row i.
struct Row {
  int i, off, dlt;
  float po, pe;    // the row's X penalties (GLOCAL's free last row)
  Cell diag0;      // lane 0's diag when dlt == 0: cell (i-1, 0), or BNEG
  Cell left0;      // lane 0's left: cell (i, 0), or BNEG
  float g0;        // G(-1)
  float x0pe;      // X(i, 0) + pe, the jg == 1 term
  const float* s;  // the row's band scores, W of them
};

template <int MODE>
SW_HD Row row_begin(const Geom& g, const Pen& p, int i, const float* s) {
  Row r;
  r.i = i;
  r.off = offset(g, i);
  r.dlt = r.off - offset(g, i - 1);
  const bool last = MODE == GLOCAL && i == g.n;
  r.po = last ? p.so : p.og;
  r.pe = last ? p.se : p.eg;
  const bool j0 = r.off == 0;
  const Cell neg = {BNEG, BNEG, BNEG};
  r.diag0 = j0 ? col0_cell(i - 1, p.so, p.se, p.sent) : neg;
  r.left0 = j0 ? col0_cell(i, p.so, p.se, p.sent) : neg;
  const float lsc = (float)i * p.se + (p.so - p.se);
  r.g0 = j0 ? lsc + r.po : BNEG;
  r.x0pe = (lsc + p.sent) + r.pe;
  r.s = s;
  return r;
}

// One band row's (M, X, Y), W floats each.
struct Buf {
  float* m;
  float* x;
  float* y;
};

SW_HD Buf buf(float* scratch, int W, int parity) {
  float* b = scratch + (int64_t)parity * 3 * W;
  return {b, b + W, b + 2 * W};
}

SW_HD Cell at(const Buf& b, int w) { return {b.m[w], b.x[w], b.y[w]}; }

// Thread t's lanes: row 0's closed form into `row0`, and the LOCAL bests
// reset.
SW_HD void init_lanes(int t, const Geom& g, const Pen& p, const Buf& row0,
                      float* best, int32_t* best_i) {
  const int R = g.W / THREADS;
  for (int w = t * R; w < t * R + R; ++w) {
    const Cell c = row0_cell(w + 1, p.so, p.se, p.sent);
    row0.m[w] = c.m;
    row0.x[w] = c.x;
    row0.y[w] = c.y;
    best[w] = BNEG;
    best_i[w] = BIGI;
  }
}

// M and Y of lane w of row r, from the row above (`up`); returns their
// pointer bits (M in bits 0-1, Y in bits 4-5).
template <int MODE>
SW_HD uint32_t lane_my(const Geom& g, const Pen& p, const Row& r,
                       const Buf& up, int w, float* vm, float* vy) {
  const int a = w + r.dlt - 1, b = w + r.dlt;
  const Cell d = a < 0 ? r.diag0 : at(up, a);
  const Cell u = b >= g.W ? Cell{BNEG, BNEG, BNEG} : at(up, b);
  uint32_t pm = (d.m >= d.x) ? ((d.m >= d.y) ? MATCH : GAPINY)
                             : ((d.x >= d.y) ? GAPINX : GAPINY);
  float m = mx(mx(d.m, d.x), d.y) + r.s[w];
  float y;
  uint32_t py;
  if (MODE == LOCAL) {
    const bool c1 = u.m + p.og >= u.y + p.eg;
    const bool c2 = u.m > u.x;
    const bool c3 = u.y + p.eg > u.x + p.og;
    y = c1 ? (c2 ? u.m + p.og : u.x + p.og)
           : (c3 ? u.y + p.eg : u.x + p.og);
    py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
  } else {
    const bool last_col = MODE == GLOCAL && r.off + w + 1 == g.m;
    const float qo = last_col ? p.so : p.og;
    const float qe = last_col ? p.se : p.eg;
    const bool c1 = u.m + qo > u.y + qe;
    const bool c2 = u.m >= u.x;
    const bool c3 = u.y + qe >= u.x + qo;
    y = mx(mx(u.m + qo, u.y + qe), u.x + qo);
    py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
  }
  if (MODE == LOCAL) {
    m = mx(m, 0.0f);
    y = mx(y, 0.0f);
    if (m == 0.0f) pm = STOP;
    if (y == 0.0f) py = STOP;
  }
  *vm = m;
  *vy = y;
  return pm | (py << 4);
}

// Lane w0-1's final M and Y, for the first lane's X pointer.
struct Left {
  float m, y;
};

// Phase A of row r for thread t, before the block's prefix: its lanes' M,
// Y and pointer bits of M and Y (into `cur` and the row's `tb`), and X's
// prefix maximum over its own lanes (into cur.x).  Returns that maximum,
// the thread's share of the block prefix.  Reads only `up` and the
// scores; lane w0-1's M and Y are recomputed here, not read.
template <int MODE>
SW_HD float phase_a(int t, const Geom& g, const Pen& p, const Row& r,
                    const Buf& up, const Buf& cur, uint8_t* tb, Left* left) {
  const int R = g.W / THREADS, w0 = t * R;
  float gl;  // G of the lane to the left
  if (w0 == 0) {
    gl = r.g0;
    left->m = r.left0.m;
    left->y = r.left0.y;
  } else {
    float vm, vy;
    lane_my<MODE>(g, p, r, up, w0 - 1, &vm, &vy);
    gl = mx(vm, vy) + r.po;
    left->m = vm;
    left->y = vy;
  }
  float run = BNEG;
  for (int w = w0; w < w0 + R; ++w) {
    float vm, vy;
    tb[w] = (uint8_t)lane_my<MODE>(g, p, r, up, w, &vm, &vy);
    cur.m[w] = vm;
    cur.y[w] = vy;
    const int jg = r.off + w + 1;
    float h = gl - ((float)jg - 1.0f) * r.pe;
    if (jg == 1) h = mx(h, r.x0pe);
    run = mx(run, h);
    cur.x[w] = run;
    gl = mx(vm, vy) + r.po;
  }
  return run;
}

// Phase C of row r for thread t, after the block's prefix: `excl` is the
// prefix maximum over the lanes left of the thread's (BNEG for thread 0).
// Finishes X, its pointer bits and the tb byte, then the LOCAL per-lane
// best or, at cell (n, m), the final (M, X, Y) into fin[0..2].  Reads only
// the thread's own lanes of `cur` and `tb`.
template <int MODE>
SW_HD void phase_c(int t, const Geom& g, const Pen& p, const Row& r,
                   float excl, const Left& left, const Buf& cur, uint8_t* tb,
                   float* best, int32_t* best_i, float* fin) {
  const int R = g.W / THREADS, w0 = t * R;
  Cell l;  // lane w-1's final (M, X, Y)
  if (w0 == 0) {
    l = r.left0;
  } else {
    float x = excl + ((float)(r.off + w0) - 1.0f) * r.pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    l = Cell{left.m, x, left.y};
  }
  for (int w = w0; w < w0 + R; ++w) {
    const int jg = r.off + w + 1;
    float x = mx(excl, cur.x[w]) + ((float)jg - 1.0f) * r.pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    bool e1, e2, e3;
    if (MODE == LOCAL) {
      e1 = l.m + p.og >= l.x + p.eg;
      e2 = l.m > l.y;
      e3 = l.x + p.eg > l.y + p.og;
    } else {
      e1 = l.m + r.po > l.x + r.pe;
      e2 = l.m >= l.y;
      e3 = l.x + r.pe >= l.y + r.po;
    }
    uint32_t px = e1 ? (e2 ? MATCH : GAPINY) : (e3 ? GAPINX : GAPINY);
    if (MODE == LOCAL && x == 0.0f) px = STOP;
    tb[w] = (uint8_t)(tb[w] | (px << 2));
    cur.x[w] = x;
    const Cell v = {cur.m[w], x, cur.y[w]};
    if (MODE == LOCAL) {
      const float masked = (jg <= g.m && r.i <= g.n) ? v.m : BNEG;
      if (masked > best[w]) {
        best[w] = masked;
        best_i[w] = r.i;
      }
    } else if (r.i == g.n && jg == g.m) {
      fin[0] = v.m;
      fin[1] = v.x;
      fin[2] = v.y;
    }
    l = v;
  }
}

// A lane's LOCAL best: value, row, lane.
struct LaneBest {
  float v;
  int i, w;
};

#if defined(__CUDACC__)
// The maximum of v over the threads before this one in a block of WARPS
// warps (`neg` for thread 0): warp shuffles, then the warp totals through
// `warp_max` (WARPS floats of shared memory) and one barrier; `total`, when
// given, receives the maximum over the whole block.  Max is exact in any
// grouping.  K7 and the striped kernels K12 / K13 scan with it.
template <int WARPS>
__device__ __forceinline__ float block_excl_max(float v, float* warp_max,
                                                float neg,
                                                float* total = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = mx(v, o);
  }
  float e = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) e = neg;
  if (lane == 31) warp_max[warp] = v;
  __syncthreads();
  for (int q = 0; q < warp; ++q) e = mx(e, warp_max[q]);
  if (total) {
    float all = neg;
    for (int q = 0; q < WARPS; ++q) all = mx(all, warp_max[q]);
    *total = all;
  }
  return e;
}
#endif

// The first of two by the JAX kernel's _finish: the larger value, then the
// smaller row, then the smaller lane.
SW_HD LaneBest lane_better(LaneBest a, LaneBest b) {
  if (a.v != b.v) return a.v > b.v ? a : b;
  if (a.i != b.i) return a.i < b.i ? a : b;
  return a.w <= b.w ? a : b;
}

// Thread t's best over its own lanes.
SW_HD LaneBest thread_best(int t, const Geom& g, const float* best,
                           const int32_t* best_i) {
  const int R = g.W / THREADS;
  LaneBest b = {best[t * R], best_i[t * R], t * R};
  for (int w = t * R + 1; w < t * R + R; ++w)
    b = lane_better(b, LaneBest{best[w], best_i[w], w});
  return b;
}

// The LOCAL stats row [best, best_i, best_lane] from every thread's best
// (slots 3..7 stay 0).
SW_HD void finish_local(const LaneBest* bests, int T, float* stats) {
  LaneBest b = bests[0];
  for (int t = 1; t < T; ++t) b = lane_better(b, bests[t]);
  stats[0] = b.v;
  stats[1] = (float)b.i;
  stats[2] = (float)b.w;
}

// One pair's walk (kernel K8), _walk_banded_device's loop body step for
// step, run while the pair is active, at most L + 4 steps:
//   tb:    the pair's (NP, W) pointer bytes; off: its (NP + 1) offsets;
//   start: {i, j, state, active} at the path's end cell;
//   idx1/idx2: L entries each, already -2; step k writes entry
//          min(k, L - 1): i-1 / j-1, or -1 for a gap;
//   *cnt:  the steps taken; *flags: bit 0 when an active step that did not
//          leave the band stood on an edge lane with cells beyond it, bit 1
//          when a read left the band or the walk was still active after
//          L + 4 steps.
SW_HD void walk_pair(bool local, const uint8_t* tb, const int32_t* off,
                     int NP, int W, int m, const int32_t* start, int64_t L,
                     int32_t* idx1, int32_t* idx2, int32_t* cnt,
                     int32_t* flags) {
  int i = start[0], j = start[1], s = start[2];
  bool active = start[3] != 0;
  int32_t c = 0, f = 0;
  for (int64_t it = 0; active && it < L + 4; ++it) {
    if (j == 0 && i > 0) s = GAPINY;
    if (i == 0 && j > 0) s = GAPINX;
    const int w = j - 1 - off[i < 0 ? 0 : (i > NP ? NP : i)];
    const bool in_mat = i >= 1 && j >= 1;
    const bool exceeded = in_mat && (w < 0 || w >= W);
    const bool edge =
        in_mat && ((w == 0 && j > 1) || (w == W - 1 && j < m));
    int prev;
    if (in_mat) {
      const int r = i - 1 > NP - 1 ? NP - 1 : i - 1;
      const int q = w < 0 ? 0 : (w > W - 1 ? W - 1 : w);
      prev = (tb[(int64_t)r * W + q] >> (2 * s)) & 3;
    } else {
      prev = (i == 0 && j == 0) ? MATCH : (i == 0 && j >= 1 ? GAPINX : GAPINY);
      if (local && prev == s) prev = STOP;
    }
    const bool stop = local && prev == STOP;
    const bool step = !stop && !exceeded;
    if (!exceeded && edge) f |= 1;
    if (exceeded) f |= 2;
    if (step) {
      const int64_t k = c < L - 1 ? c : L - 1;
      idx1[k] = s == GAPINX ? -1 : i - 1;
      idx2[k] = s == GAPINY ? -1 : j - 1;
      if (s != GAPINX) --i;
      if (s != GAPINY) --j;
      ++c;
    }
    const bool hit00 = i == 0 && j == 0;
    if (step && !hit00) s = prev;
    active = step && !hit00;
  }
  if (active) f |= 2;
  *cnt = c;
  *flags = f;
}

}  // namespace banded
}  // namespace sw
