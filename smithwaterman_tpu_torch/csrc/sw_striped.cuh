// The striped fill's row rule (kernels K12 and K13, striped_fill.cu), written
// once.
//
// nvcc compiles it into the kernels; g++ compiles it into the host twin
// (cell_twin.cpp), which runs phase A for thread 0 .. THREADS-1 in turn, the
// block's prefix in thread order, then phase C for every thread, where the
// card's threads wait for each other between the phases.  No thread reads in
// a phase what another writes in it, so the twin's order is one the card may
// take too.
//
// Semantics are smithwaterman_tpu/parallel/seq_tiled.py's _row_cells
// (:52-182), bit for bit.  A shard owns W columns from col0 (global column
// jg = col0 + w + 1 at lane w); row i of it needs the row above (its own
// lanes), the left edge [M, X, Y, C] at (i, col0) and the above edge
// [M, X, Y] at (i-1, col0).  C is the running maximum of the prefix of h
// over the columns left of the shard.  Shard 0's edges are the closed forms
// of column 0 (C = NEG); another shard's come from its left neighbour.
//   * M from the diag (lane w-1 of the row above, the above edge at lane 0),
//     ties M >= X >= Y; Y from the up cell, LOCAL `>=` / `>` against
//     non-LOCAL `>` / `>=`, GLOCAL's free last column for Y (qo, qe) and
//     last row for X (po, pe).
//   * X is a max-plus prefix in global-column coordinates, not the
//     sequential recurrence: with G(w) = max(M, Y)(w) + po, G(-1) the left
//     edge's, h(w) = G(w-1) - (jg-1)*pe, X(w) = max(C, h(0..w)) + (jg-1)*pe.
//     Max is exact in any grouping, so the prefix is taken in any: each
//     thread over its own lanes, then across the threads of a tile, then
//     across the row's tiles; the adds keep the JAX code's order.
//   * X's pointer compares lane w-1's final (M, X, Y) of the same row (the
//     left edge at lane 0).  LOCAL clamps at 0 and marks zero states STOP.
// The LOCAL best is per lane: each lane keeps its first strict-`>` maximum
// of M over rows i <= n at columns jg <= m (merged by the caller by value,
// then row, then column); otherwise the cell (n, m) adds its (M, X, Y) to
// the shard's accumulator.  The constants come from the caller as the JAX
// code forms them (Pen).  Build with no FMA contraction (nvcc --fmad=false,
// g++ -ffp-contract=off).
#pragma once

#include "sw_banded.cuh"

namespace sw {
namespace striped {

// threads of a K12 / K13 block.  A row is walked in column tiles of TILE
// lanes; in tile j thread t owns the LANES adjacent lanes from
// j*TILE + t*LANES, so a warp's loads and stores cover 32 * LANES
// consecutive floats
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 4;
constexpr int TILE = THREADS * LANES;
// shards one K12 launch takes (the launch's list rides in its parameters)
constexpr int MAX_SHARDS = 64;
constexpr int BIGI = 1 << 30;

// og, eg, the start penalties so / se (og / eg in GLOBAL, else 0), the
// boundary sentinel sent = 10*og + 10*eg and sose = so - se, each formed in
// double and rounded to f32 once, as the JAX code's Python constants are.
struct Pen {
  float og, eg, so, se, sent, sose;
};

SW_HD float lsc(int i, const Pen& p) { return (float)i * p.se + p.sose; }

// (i, 0): the origin (0, -1, -1) for i == 0, else the chain down column 0.
SW_HD Cell column0(int i, const Pen& p) {
  if (i == 0) return {0.0f, -1.0f, -1.0f};
  const float l = lsc(i, p);
  return {l + p.sent, l + p.sent, l};
}

// (0, j), j >= 1: the chain along row 0.
SW_HD Cell row0(int j, const Pen& p) {
  const float l = lsc(j, p);
  return {l + p.sent, l, l + p.sent};
}

// What every thread needs of row i of a shard.
struct Row {
  int i, col0, n, m;
  float po, pe;  // the row's X penalties (GLOCAL's free last row)
  Cell ab;       // above edge (i-1, col0)
  Cell eb;       // left edge (i, col0)
  float ebc;     // prefix maximum of h left of the shard
};

// `in` is the row's [M, X, Y, C] inbox entry, or null on shard 0.
template <int MODE>
SW_HD Row row_begin(const Pen& p, int i, int col0, int n, int m, Cell ab,
                    const float* in) {
  Row r;
  r.i = i;
  r.col0 = col0;
  r.n = n;
  r.m = m;
  const bool last = MODE == GLOCAL && i == n;
  r.po = last ? p.so : p.og;
  r.pe = last ? p.se : p.eg;
  r.ab = ab;
  if (in) {
    r.eb = Cell{in[0], in[1], in[2]};
    r.ebc = in[3];
  } else {
    r.eb = column0(i, p);
    r.ebc = NEG;
  }
  return r;
}

// One row's (M, X, Y) of a shard's lanes.
struct Buf {
  float* m;
  float* x;
  float* y;
};

SW_HD Cell at(const Buf& b, int w) { return {b.m[w], b.x[w], b.y[w]}; }

// Row buffers: (2, 3, B, MP) f32, global row i in [i & 1]; the shard's
// lane 0 of pair b.
SW_HD Buf row_buf(float* rows, int64_t B, int64_t MP, int64_t b, int col0,
                  int i) {
  float* base = rows + (int64_t)(i & 1) * 3 * B * MP + b * MP + col0;
  return {base, base + B * MP, base + 2 * B * MP};
}

// Tiles of a W-lane row.
SW_HD int tiles(int W) { return (W + TILE - 1) / TILE; }

// Thread t's lanes [*w0, *w1) of tile j of a W-lane shard (empty when
// *w0 >= W).
SW_HD void lanes(int t, int j, int W, int* w0, int* w1) {
  *w0 = j * TILE + t * LANES;
  *w1 = *w0 + LANES < W ? *w0 + LANES : W;
}

// M and Y of the lane at global column jg from its diag d and up u cells;
// returns their pointer bits (M in bits 0-1, Y in bits 4-5) when TB.
template <int MODE, bool TB>
SW_HD uint32_t lane_my(const Pen& p, const Row& r, const Cell& d,
                       const Cell& u, float s, int jg, float* vm, float* vy) {
  float m = mx(mx(d.m, d.x), d.y) + s;
  float y;
  bool c1, c2, c3;
  if (MODE == LOCAL) {
    y = mx(mx(u.m, u.x) + p.og, u.y + p.eg);
    c1 = u.m + p.og >= u.y + p.eg;
    c2 = u.m > u.x;
    c3 = u.y + p.eg > u.x + p.og;
    m = mx(m, 0.0f);
    y = mx(y, 0.0f);
  } else {
    const bool last_col = MODE == GLOCAL && jg == r.m;
    const float qo = last_col ? p.so : p.og;
    const float qe = last_col ? p.se : p.eg;
    y = mx(mx(u.m + qo, u.y + qe), u.x + qo);
    c1 = u.m + qo > u.y + qe;
    c2 = u.m >= u.x;
    c3 = u.y + qe >= u.x + qo;
  }
  *vm = m;
  *vy = y;
  if (!TB) return 0;
  uint32_t pm = (d.m >= d.x) ? ((d.m >= d.y) ? MATCH : GAPINY)
                             : ((d.x >= d.y) ? GAPINX : GAPINY);
  uint32_t py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
  if (MODE == LOCAL) {
    if (m == 0.0f) pm = STOP;
    if (y == 0.0f) py = STOP;
  }
  return pm | (py << 4);
}

// Lane w0-1's final M and Y, for the thread's first X pointer.
struct Left {
  float m, y;
};

// Phase A of tile j of row r for thread t, before the block's prefix: its
// lanes' M,
// Y (into `cur`) and their pointer bits (into `tb` when TB), and h's prefix
// maximum over its own lanes (into cur.x).  Returns that maximum, the
// thread's share of the block prefix (NEG for a thread without lanes).
// Reads only `up`, the edges and the scores; lane w0-1's M and Y are
// recomputed here, not read.
template <int MODE, bool TB, typename ST>
SW_HD float phase_a(int t, int j, int W, const Pen& p, const Row& r,
                    const ST* s, const Buf& up, const Buf& cur, uint8_t* tb,
                    Left* left) {
  int w0, w1;
  lanes(t, j, W, &w0, &w1);
  if (w0 >= W) return NEG;
  float gl;  // G of the lane to the left
  if (w0 == 0) {
    gl = mx(r.eb.m, r.eb.y) + r.po;
  } else {
    const int w = w0 - 1;
    const Cell d = w == 0 ? r.ab : at(up, w - 1);
    lane_my<MODE, false>(p, r, d, at(up, w), (float)s[w], r.col0 + w + 1,
                         &left->m, &left->y);
    gl = mx(left->m, left->y) + r.po;
  }
  float run = NEG;
  for (int w = w0; w < w1; ++w) {
    const int jg = r.col0 + w + 1;
    const Cell d = w == 0 ? r.ab : at(up, w - 1);
    float vm, vy;
    const uint32_t bits =
        lane_my<MODE, TB>(p, r, d, at(up, w), (float)s[w], jg, &vm, &vy);
    if (TB) tb[w] = (uint8_t)bits;
    cur.m[w] = vm;
    cur.y[w] = vy;
    run = mx(run, gl - ((float)jg - 1.0f) * r.pe);
    cur.x[w] = run;
    gl = mx(vm, vy) + r.po;
  }
  return run;
}

// Phase C of tile j of row r for thread t, after the block's prefix:
// `excl` is the maximum of h over the row's lanes left of the thread's
// (NEG for lane 0).
// Finishes X and, when TB, its pointer bits and the byte; then the LOCAL
// per-lane best (`best`, `best_i`: the shard's lane 0 of the pair) or, at
// cell (n, m), acc[0..2] += (M, X, Y); the last lane's [M, X, Y, C] goes
// to edge_out when given.  Reads only the thread's own lanes of `cur` and
// `tb`.
template <int MODE, bool TB>
SW_HD void phase_c(int t, int j, int W, const Pen& p, const Row& r,
                   float excl, const Left& left, const Buf& cur, uint8_t* tb,
                   float* best, int32_t* best_i, float* acc,
                   float* edge_out) {
  int w0, w1;
  lanes(t, j, W, &w0, &w1);
  if (w0 >= W) return;
  Cell l;  // lane w-1's final (M, X, Y)
  if (w0 == 0) {
    l = r.eb;
  } else {
    float x = mx(excl, r.ebc) + ((float)(r.col0 + w0) - 1.0f) * r.pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    l = Cell{left.m, x, left.y};
  }
  for (int w = w0; w < w1; ++w) {
    const int jg = r.col0 + w + 1;
    const float c = mx(mx(excl, cur.x[w]), r.ebc);
    float x = c + ((float)jg - 1.0f) * r.pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    if (TB) {
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
    }
    cur.x[w] = x;
    const Cell v = {cur.m[w], x, cur.y[w]};
    if (MODE == LOCAL) {
      const float masked = (jg <= r.m && r.i <= r.n) ? v.m : NEG;
      if (masked > best[w]) {
        best[w] = masked;
        best_i[w] = r.i;
      }
    } else if (r.i == r.n && jg == r.m) {
      acc[0] = acc[0] + v.m;
      acc[1] = acc[1] + v.x;
      acc[2] = acc[2] + v.y;
    }
    if (edge_out && w == W - 1) {
      edge_out[0] = v.m;
      edge_out[1] = x;
      edge_out[2] = v.y;
      edge_out[3] = c;
    }
    l = v;
  }
}

// K12's arguments (sw_striped_block_launch): one wavefront step t of the
// shards that run block r = t - d of their rows.
struct BlockArgs {
  int t, i0, K, W, D;
  int64_t B, MP;
  const float* S;  // row i0 + 1 of the fill, at column s_lo
  int64_t s_b, s_r, s_lo;
  const int32_t* n;
  const int32_t* m;
  float* rows;     // (2, 3, B, MP)
  float* box;      // (2, D, B, K, 4): step t's outboxes in [t & 1]
  float* above;    // (D, B, 4)
  float* best;     // (B, MP)
  int32_t* best_i; // (B, MP)
  float* acc;      // (D, B, 4)
  uint8_t* tb;     // (B, tb_rows, MP) or null
  int64_t tb_rows;
  Pen p;
};

// Shard d's block of pair b at step a.t: where its inputs and outputs lie.
struct Block {
  int i_start, col0;
  const float* in;  // inbox (K, 4), null on shard 0
  float* out;       // outbox (K, 4)
  float* above;     // [M, X, Y] at (i_start, col0) of shards d > 0
  float* acc;
};

SW_HD Block block_at(const BlockArgs& a, int d, int64_t b) {
  Block k;
  k.i_start = a.i0 + (a.t - d) * a.K;
  k.col0 = d * a.W;
  const int64_t box = a.B * a.K * 4;
  k.in = d == 0 ? nullptr
                : a.box + ((int64_t)((a.t - 1) & 1) * a.D + d - 1) * box +
                      b * a.K * 4;
  k.out = a.box + ((int64_t)(a.t & 1) * a.D + d) * box + b * a.K * 4;
  k.above = a.above + ((int64_t)d * a.B + b) * 4;
  k.acc = a.acc + ((int64_t)d * a.B + b) * 4;
  return k;
}

// The row's scores and pointer bytes of the shard (lane 0).
SW_HD const float* block_scores(const BlockArgs& a, const Block& k,
                                int64_t b, int i) {
  return a.S + b * a.s_b + (int64_t)(i - a.i0 - 1) * a.s_r + k.col0 -
         a.s_lo;
}

SW_HD uint8_t* block_tb(const BlockArgs& a, const Block& k, int64_t b,
                        int i) {
  if (!a.tb) return nullptr;
  return a.tb + (b * a.tb_rows + (i - a.i0 - 1)) * a.MP + k.col0;
}

}  // namespace striped
}  // namespace sw
