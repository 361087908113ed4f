// The striped fill's row rule and column tiles (kernels K12 and K13,
// striped_fill.cu), written once.
//
// nvcc compiles it into the kernels; g++ compiles it into the host twin
// (cell_twin.cpp).  A tile is one warp; the card runs its 32 threads
// together and trades values by shuffles, the twin runs each per-thread
// function below for thread 0 .. 31 in turn, handing each thread its left
// neighbour's values from before the call, as the shuffles do, and the
// warp's max scan in thread order.  The twin advances the tiles of a launch
// a row at a time in ticket order, a tile only once its left neighbour has
// published the edge it needs, and checks every publication against the
// fence rule (put_edge, publish): an order the card may take.
//
// Semantics are smithwaterman_tpu/parallel/seq_tiled.py's _row_cells
// (:52-182), bit for bit.  A shard owns W columns from col0 (global column
// jg = col0 + w + 1 at lane w); row i of it needs the row above (its own
// lanes), the left edge [M, X, Y, C] at (i, col0) and the above edge
// [M, X, Y] at (i-1, col0).  C is the running maximum of the prefix of h
// over the columns left of the shard.  Shard 0's edges are the closed forms
// of column 0 (C = NEG); another shard's come from its left neighbour.  A
// column tile is a shard of its own in the same sense: its edges come from
// the tile to its left, through global memory inside the launch.
//   * M from the diag (lane w-1 of the row above, the above edge at lane 0),
//     ties M >= X >= Y; Y from the up cell, LOCAL `>=` / `>` against
//     non-LOCAL `>` / `>=`, GLOCAL's free last column for Y (qo, qe) and
//     last row for X (po, pe).
//   * X is a max-plus prefix in global-column coordinates, not the
//     sequential recurrence: with G(w) = max(M, Y)(w) + po, G(-1) the left
//     edge's, h(w) = G(w-1) - (jg-1)*pe, X(w) = max(C, h(0..w)) + (jg-1)*pe.
//     Max is exact in any grouping, so the prefix is taken in any: each
//     thread over its own lanes, then across the warp, then the left edge's
//     C with the tile's lane 0 h (which needs the left edge, so it waits
//     until phase C); the adds keep the JAX code's order.
//   * X's pointer compares lane w-1's final (M, X, Y) of the same row (the
//     left edge at lane 0).  LOCAL clamps at 0 and marks zero states STOP.
// The LOCAL best is per lane: each lane keeps its first strict-`>` maximum
// of M over rows i <= n at columns jg <= m (merged by the caller by value,
// then row, then column); otherwise the cell (n, m) adds its (M, X, Y) to
// the shard's accumulator.  The constants come from the caller as the JAX
// code forms them (Pen).  Build with no FMA contraction (nvcc --fmad=false,
// g++ -ffp-contract=off).
#pragma once

#include <type_traits>

#include "sw_banded.cuh"

namespace sw {
namespace striped {

// shards one K12 launch takes (the launch's list rides in its parameters)
constexpr int MAX_SHARDS = 64;
constexpr int BIGI = 1 << 30;
// edge slots a reading tile holds at once: a float a thread, four a slot
constexpr int HELD = WARP / 4;

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

// What every lane needs of row i.
struct Row {
  int i, n, m;
  float po, pe;  // the row's X penalties (GLOCAL's free last row)
};

template <int MODE>
SW_HD Row row_at(const Pen& p, int i, int n, int m) {
  const bool last = MODE == GLOCAL && i == n;
  return {i, n, m, last ? p.so : p.og, last ? p.se : p.eg};
}

// An edge [M, X, Y, C]: a lane's final cell and the prefix maximum of h
// through it.
struct Edge {
  Cell v;
  float c;
};

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

// One thread's L adjacent lanes of a tile, kept in registers for every row
// of the launch.
template <int L>
struct Thread {
  float pm[L], px[L], py[L];  // the row above; after phase C this row
  float cm[L], cy[L], hp[L];  // this row's M, Y and h's running maximum
  uint32_t bits[L];           // this row's pointer bytes (TB)
  float best[L];              // LOCAL: each lane's best M and its row
  int32_t bi[L];
};

// The diag of the thread's first lane: the tile's above edge for thread 0,
// else lane w0-1 of the row above (thread t-1's last lane before the row).
SW_HD Cell first_diag(int t, const Cell& ab, const Cell& nb) {
  return t == 0 ? ab : nb;
}

// Phase A: M, Y and their pointer bits of the thread's lanes (first global
// column jg0), from the row above and the first lane's diag dg.
template <int MODE, bool TB, int L>
SW_HD void thread_a(const Pen& p, const Row& r, int jg0, const float* s,
                    const Cell& dg, Thread<L>* th) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const Cell d =
        k == 0 ? dg : Cell{th->pm[k - 1], th->px[k - 1], th->py[k - 1]};
    const Cell u = {th->pm[k], th->px[k], th->py[k]};
    th->bits[k] = lane_my<MODE, TB>(p, r, d, u, s[k], jg0 + k, &th->cm[k],
                                    &th->cy[k]);
  }
}

// h's running maximum over the thread's lanes, into hp; returns it.  (lm,
// ly) are lane w0-1's M and Y of this row (thread t-1's last lane); the
// tile's lane 0 (has_left false) leaves its h to phase C, which has the
// left edge.
template <int L>
SW_HD float thread_h(const Row& r, int jg0, bool has_left, float lm,
                     float ly, Thread<L>* th) {
  float gl = mx(lm, ly) + r.po;
  float run = NEG;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const float h = gl - ((float)(jg0 + k) - 1.0f) * r.pe;
    if (k > 0 || has_left) run = mx(run, h);
    th->hp[k] = run;
    gl = mx(th->cm[k], th->cy[k]) + r.po;
  }
  return run;
}

// The prefix maximum of h through the tile's lane 0: the left edge's C and
// lane 0's h (global column jgt), which only the left edge gives.
SW_HD float left_c(const Row& r, int jgt, const Edge& e) {
  const float h0 = (mx(e.v.m, e.v.y) + r.po) - ((float)jgt - 1.0f) * r.pe;
  return mx(e.c, h0);
}

// Phase C, once the row's left edge e is in: `excl` is h's maximum over the
// tile's lanes left of the thread's (NEG for thread 0), lc = left_c(e).
// Finishes X and, when TB, its pointer bits; then the LOCAL per-lane best
// or, at cell (n, m), acc[0..2] += (M, X, Y) (acc: the shard's
// accumulator); the row becomes the row above.  The thread's first nv lanes
// lie in the tile; lane klast (if any) is the tile's last, whose edge goes
// to *out.
template <int MODE, bool TB, int L>
SW_HD void thread_c(const Pen& p, const Row& r, int jg0, int t, float excl,
                    float lc, const Edge& e, float lm, float ly, int nv,
                    int klast, Thread<L>* th, float* acc, Edge* out) {
  Cell l;  // lane w-1's final (M, X, Y)
  if (t == 0) {
    l = e.v;
  } else {
    float x = mx(excl, lc) + ((float)(jg0 - 1) - 1.0f) * r.pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    l = Cell{lm, x, ly};
  }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int jg = jg0 + k;
    const float c = mx(mx(excl, th->hp[k]), lc);
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
      th->bits[k] |= px << 2;
    }
    const Cell v = {th->cm[k], x, th->cy[k]};
    if (MODE == LOCAL) {
      const float masked = (jg <= r.m && r.i <= r.n) ? v.m : NEG;
      if (masked > th->best[k]) {
        th->best[k] = masked;
        th->bi[k] = r.i;
      }
    } else if (k < nv && r.i == r.n && jg == r.m) {
      acc[0] = acc[0] + v.m;
      acc[1] = acc[1] + v.x;
      acc[2] = acc[2] + v.y;
    }
    if (k == klast) *out = Edge{v, c};
    th->pm[k] = v.m;
    th->px[k] = x;
    th->py[k] = v.y;
    l = v;
  }
}

// ------------------------------------------------------------ memory
// The scores of the thread's lanes (nv of them in the tile; 0 past).
template <int L, typename ST>
SW_HD void get_s(const ST* p, int nv, float* s) {
#if defined(__CUDA_ARCH__)
  if (nv == L) {
    if constexpr (std::is_same<ST, float>::value) {
      if (!((uintptr_t)p & 15)) {
#pragma unroll
        for (int k = 0; k < L; k += 4) {
          const float4 v = *reinterpret_cast<const float4*>(p + k);
          s[k] = v.x;
          s[k + 1] = v.y;
          s[k + 2] = v.z;
          s[k + 3] = v.w;
        }
        return;
      }
    } else if (!((uintptr_t)p & 3)) {
#pragma unroll
      for (int k = 0; k < L; k += 4) {
        const char4 v = *reinterpret_cast<const char4*>(p + k);
        s[k] = (float)v.x;
        s[k + 1] = (float)v.y;
        s[k + 2] = (float)v.z;
        s[k + 3] = (float)v.w;
      }
      return;
    }
  }
#endif
#pragma unroll
  for (int k = 0; k < L; ++k) s[k] = k < nv ? (float)p[k] : 0.0f;
}

// Asks L2 for the thread's scores at p ahead of their row (the card only:
// a row's loads otherwise wait on device memory in phase A).
template <typename ST>
SW_HD void prefetch_s(const ST* p, int nv) {
#if defined(__CUDA_ARCH__)
  if (nv > 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Stores the thread's first nv lanes of v at p.
template <int L>
SW_HD void put_f32(float* p, const float* v, int nv) {
#if defined(__CUDA_ARCH__)
  if (nv == L && !((uintptr_t)p & 15)) {
#pragma unroll
    for (int k = 0; k < L; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    return;
  }
#endif
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k < nv) p[k] = v[k];
}

// Stores the low bytes of the thread's first nv lanes of v at p.
template <int L>
SW_HD void put_u8(uint8_t* p, const uint32_t* v, int nv) {
#if defined(__CUDA_ARCH__)
  if (nv == L && !((uintptr_t)p & 3)) {
#pragma unroll
    for (int k = 0; k < L; k += 4)
      *reinterpret_cast<uint32_t*>(p + k) =
          v[k] | (v[k + 1] << 8) | (v[k + 2] << 16) | (v[k + 3] << 24);
    return;
  }
#endif
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (k < nv) p[k] = (uint8_t)v[k];
}

// ------------------------------------------------------------ handover
// One tile's edges for its right neighbour: slot 0 is its last lane's cell
// in the row above its first, slot q+1 the edge of its row q; ctr counts
// the slots published.  `twin` is the host twin's record of the slots
// stored and fenced and whether a publication broke the rule ([stored,
// fenced, broken]); null on the card.
struct Chain {
  float* slots;
  int32_t* ctr;
  int32_t* twin;
};

// Stores slot s (in order, by the thread that holds the tile's last lane).
SW_HD void put_edge(const Chain& ch, int s, const Edge& e) {
  float* q = ch.slots + 4 * s;
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float4*>(q) = make_float4(e.v.m, e.v.x, e.v.y, e.c);
#else
  q[0] = e.v.m;
  q[1] = e.v.x;
  q[2] = e.v.y;
  q[3] = e.c;
  if (ch.twin) {
    if (s != ch.twin[0]) ch.twin[2] = 1;
    ch.twin[0] = s + 1;
  }
#endif
}

// Makes the slots stored so far visible to every SM before what follows.
SW_HD void fence_edges(const Chain& ch) {
#if defined(__CUDA_ARCH__)
  __threadfence();
#else
  if (ch.twin) ch.twin[1] = ch.twin[0];
#endif
}

// Sets the count of published slots to v (release semantics); the twin
// flags a count past the slots fenced.
SW_HD void release_count(const Chain& ch, int v) {
#if !defined(__CUDA_ARCH__)
  if (ch.twin && v > ch.twin[1]) ch.twin[2] = 1;
#endif
  st_release(ch.ctr, v);
}

// Publishes slots 0 .. v-1 (same thread): their stores, a fence, then the
// count with release semantics, as K3 publishes its checkpoint tiles.
SW_HD void publish(const Chain& ch, int v) {
  fence_edges(ch);
  release_count(ch, v);
}

// Whether a tile of R rows publishes after its row q: every E rows and
// after its last.
SW_HD bool publishes(int q, int R, int E) {
  return (q + 1) % E == 0 || q == R - 1;
}

// ------------------------------------------------------------ a launch
// One launch of K12 (step t of the wavefront for the shards ds, rows
// i0 + (t-d)*K + 1 .. + K of shard d) or K13 (GRID: one shard, d = 0,
// t = 0, K = NP, W = MP, S (B, NP, MP) f32 or int8, no rows, box or above).
struct Launch {
  int ds[MAX_SHARDS];
  int nds, t, i0, K, W, D;
  int64_t B, MP;
  const void* S;  // row i0 + 1 of the fill at column s_lo
  int64_t s_b, s_r, s_lo;
  const int32_t* n;
  const int32_t* m;
  float* rows;      // K12: (2, 3, B, MP), row i's (M, X, Y) in [i & 1]
  float* box;       // K12: (2, D, B, K, 4), step t's outboxes in [t & 1]
  float* above;     // K12: (D, B, 4)
  float* best;      // (B, MP)
  int32_t* best_i;  // (B, MP)
  float* acc;       // K12: (D, B, 4); K13: (B, 4)
  uint8_t* tb;      // K12: (B, tb_rows, MP) or null
  int64_t tb_rows;
  int C;            // K13: checkpoint rows (0: none)
  float* ckm;       // K13: (B, NP / C, MP)
  float* ckx;
  float* cky;
  Pen p;
  // the tiling: L lanes a thread, TW = 32 L lanes a tile, T tiles a shard,
  // publication every E rows, tiles = nds * B * T tickets
  int L, TW, T, E;
  int64_t tiles;
  int32_t* ticket;  // scratch: the ticket counter, each tile's count of
  int32_t* ctr;     // published slots, each tile's K + 1 edge slots
  float* edges;
};

// The scratch of a launch of `tiles` tiles: int32 words, the first
// scratch_zeroed(tiles) zeroed before the launch.
SW_HD int64_t scratch_zeroed(int64_t tiles) { return (1 + tiles + 3) & ~3; }
SW_HD int64_t scratch_words(int64_t tiles, int K) {
  return scratch_zeroed(tiles) + tiles * (K + 1) * 4;
}

SW_HD void set_scratch(Launch* a, int32_t* s) {
  a->ticket = s;
  a->ctr = s + 1;
  a->edges = reinterpret_cast<float*>(s + scratch_zeroed(a->tiles));
}

// Tile j of shard ds[q] of pair b for ticket tk (pair-major, then the
// launch's shards in order, then tiles left to right): what it reads and
// writes.
struct Job {
  int64_t b;
  int d, j;
  int i_start;      // the row above the tile's first
  int col0;         // the pair's column index of the tile's lane 0
  int Wt;           // the tile's lanes
  int n, m;
  const float* in;  // K12 tile 0 of shard d > 0: the inbox (K, 4)
  float* above;     // K12 shard d > 0: [M, X, Y] at (i_start, shard col0)
  float* out;       // K12 last tile: the outbox (K, 4)
  Chain left;       // tile j-1's edges (slots null on tile 0)
  Chain right;      // this tile's edges (slots null on the last tile)
};

SW_HD Job job_at(const Launch& a, int64_t tk) {
  Job J{};
  const int64_t per = (int64_t)a.nds * a.T;
  J.b = tk / per;
  const int q = (int)(tk % per / a.T);
  J.j = (int)(tk % a.T);
  J.d = a.ds[q];
  J.i_start = a.i0 + (a.t - J.d) * a.K;
  J.col0 = J.d * a.W + J.j * a.TW;
  J.Wt = a.W - J.j * a.TW < a.TW ? a.W - J.j * a.TW : a.TW;
  J.n = a.n[J.b];
  J.m = a.m[J.b];
  const int64_t box = a.B * a.K * 4;
  if (a.box && J.d > 0 && J.j == 0)
    J.in = a.box + ((int64_t)((a.t - 1) & 1) * a.D + J.d - 1) * box +
           J.b * a.K * 4;
  if (a.above && J.d > 0 && J.j == 0) J.above = a.above + ((int64_t)J.d * a.B + J.b) * 4;
  if (a.box && J.j == a.T - 1)
    J.out = a.box + ((int64_t)(a.t & 1) * a.D + J.d) * box + J.b * a.K * 4;
  const int64_t stride = (int64_t)(a.K + 1) * 4;
  if (J.j > 0) J.left = Chain{a.edges + (tk - 1) * stride, a.ctr + tk - 1,
                              nullptr};
  if (J.j < a.T - 1)
    J.right = Chain{a.edges + tk * stride, a.ctr + tk, nullptr};
  return J;
}

// The left edge of a tile 0 at row i (q-th of the launch): column 0's closed
// form on shard 0, else the inbox.
SW_HD Edge box_edge(const Pen& p, const Job& J, int q, int i) {
  if (!J.in) return Edge{column0(i, p), NEG};
  const float* e = J.in + 4 * q;
  return Edge{Cell{e[0], e[1], e[2]}, e[3]};
}

// The above edge of a tile 0 at its first row.
SW_HD Cell box_above(const Pen& p, const Job& J) {
  if (!J.in) return column0(J.i_start, p);
  return Cell{J.above[0], J.above[1], J.above[2]};
}

// Thread t's lanes in the tile and which of them (if any) is its last.
SW_HD int lanes_in(const Job& J, int t, int L) {
  const int v = J.Wt - t * L;
  return v < 0 ? 0 : v < L ? v : L;
}

SW_HD int last_lane(const Job& J, int t, int L) {
  const int k = J.Wt - 1 - t * L;
  return k >= 0 && k < L ? k : -1;
}

// Thread t's lanes before the tile's first row: the row above (K12: from
// rows; K13: row 0's closed form) and the LOCAL bests (K12: from best /
// best_i; K13: none yet); K13's accumulator is zeroed by the thread that
// adds to it.
template <int L, bool GRID>
SW_HD void thread_begin(const Launch& a, const Job& J, int t,
                        Thread<L>* th) {
  const int nv = lanes_in(J, t, L);
  const int64_t o = J.b * a.MP + J.col0 + t * L;
  const int64_t plane = a.B * a.MP;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    Cell c{0.0f, 0.0f, 0.0f};
    th->best[k] = NEG;
    th->bi[k] = BIGI;
    if (GRID) {
      c = row0(J.col0 + t * L + k + 1, a.p);
    } else if (k < nv) {
      const float* r = a.rows + (int64_t)(J.i_start & 1) * 3 * plane + o + k;
      c = Cell{r[0], r[plane], r[2 * plane]};
      th->best[k] = a.best[o + k];
      th->bi[k] = a.best_i[o + k];
    }
    th->pm[k] = c.m;
    th->px[k] = c.x;
    th->py[k] = c.y;
  }
  if (GRID) {
    const int c = J.m < 1 ? 1 : J.m > a.MP ? (int)a.MP : J.m;
    const int k = c - 1 - J.col0 - t * L;
    if (k >= 0 && k < nv)
      for (int q = 0; q < 4; ++q) a.acc[J.b * 4 + q] = 0.0f;
  }
}

// Lane k's cell of the row above (k a run-time index).
template <int L>
SW_HD Cell lane_cell(const Thread<L>& th, int k) {
  Cell c{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < L; ++q)
    if (q == k) c = Cell{th.pm[q], th.px[q], th.py[q]};
  return c;
}

// The accumulator the tile's cell (n, m) adds to: the shard's (K12) or
// the pair's (K13).
SW_HD float* acc_of(const Launch& a, const Job& J, bool grid) {
  return a.acc + (grid ? J.b : (int64_t)J.d * a.B + J.b) * 4;
}

// The scores (element type ST) and pointer bytes of the tile's row i.
template <typename ST>
SW_HD const ST* row_scores(const Launch& a, const Job& J, int i) {
  return static_cast<const ST*>(a.S) + J.b * a.s_b +
         (int64_t)(i - a.i0 - 1) * a.s_r + J.col0 - a.s_lo;
}

SW_HD uint8_t* row_tb(const Launch& a, const Job& J, int i) {
  return a.tb + (J.b * a.tb_rows + (i - a.i0 - 1)) * a.MP + J.col0;
}

// The thread's stores after phase C of row i (its q-th): pointer bytes
// (TB), K13's checkpoint every C rows, and K12's row e-1 before its last
// row e (rows keeps the launch's last two rows by parity).
template <bool TB, int L, bool GRID>
SW_HD void thread_row_out(const Launch& a, const Job& J, int t, int q, int i,
                          const Thread<L>& th) {
  const int nv = lanes_in(J, t, L);
  if (TB) put_u8<L>(row_tb(a, J, i) + t * L, th.bits, nv);
  if (GRID && a.C && i % a.C == 0) {
    const int64_t o =
        (J.b * (a.K / a.C) + i / a.C - 1) * a.MP + J.col0 + t * L;
    put_f32<L>(a.ckm + o, th.pm, nv);
    put_f32<L>(a.ckx + o, th.px, nv);
    put_f32<L>(a.cky + o, th.py, nv);
  }
  if (!GRID && q == a.K - 2) {
    float* r = a.rows + (int64_t)(i & 1) * 3 * a.B * a.MP + J.b * a.MP +
               J.col0 + t * L;
    put_f32<L>(r, th.pm, nv);
    put_f32<L>(r + a.B * a.MP, th.px, nv);
    put_f32<L>(r + 2 * a.B * a.MP, th.py, nv);
  }
}

// The thread's stores after the tile's last row e: K12's row e into rows,
// the LOCAL bests (K13: every mode's, NEG / BIGI outside LOCAL).
template <int MODE, int L, bool GRID>
SW_HD void thread_end(const Launch& a, const Job& J, int t,
                      const Thread<L>& th) {
  const int nv = lanes_in(J, t, L);
  const int64_t o = J.b * a.MP + J.col0 + t * L;
  const int e = J.i_start + a.K;
  if (!GRID) {
    float* r = a.rows + (int64_t)(e & 1) * 3 * a.B * a.MP + o;
    put_f32<L>(r, th.pm, nv);
    put_f32<L>(r + a.B * a.MP, th.px, nv);
    put_f32<L>(r + 2 * a.B * a.MP, th.py, nv);
  }
  if (MODE == LOCAL || GRID) {
    put_f32<L>(a.best + o, th.best, nv);
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (k < nv) a.best_i[o + k] = th.bi[k];
  }
}

// The tiling of a launch: L lanes a thread (8 or 16), publication
// every E rows (1 .. HELD); false for a tiling the kernels do not take.
inline bool set_tiling(Launch* a, int L, int E) {
  if ((L != 8 && L != 16) || E < 1 || E > HELD) return false;
  a->L = L;
  a->TW = WARP * L;
  a->T = (a->W + a->TW - 1) / a->TW;
  a->E = E;
  a->tiles = (int64_t)a->nds * a->B * a->T;
  return a->tiles < (int64_t)1 << 30;
}

// K12's launch (sw_striped_block_launch's arguments, striped_fill.cu);
// false for arguments the kernel does not take.
inline bool block_launch(Launch* a, int emit_tb, const int32_t* ds, int nds,
                         int t, int i0, int K, int W, int D, int64_t B,
                         int64_t MP, const float* S, int64_t s_b, int64_t s_r,
                         int64_t s_lo, const int32_t* n, const int32_t* m,
                         float* rows, float* box, float* above, float* best,
                         int32_t* best_i, float* acc, uint8_t* tb,
                         int64_t tb_rows, const Pen& p, int L, int E) {
  if (nds <= 0 || nds > MAX_SHARDS || K <= 0 || W <= 0 || D <= 0 || B <= 0 ||
      (int64_t)W * D != MP || (emit_tb && !tb))
    return false;
  *a = Launch{};
  for (int q = 0; q < nds; ++q) {
    if (ds[q] < 0 || ds[q] >= D || t - ds[q] < 0) return false;
    a->ds[q] = ds[q];
  }
  a->nds = nds;
  a->t = t;
  a->i0 = i0;
  a->K = K;
  a->W = W;
  a->D = D;
  a->B = B;
  a->MP = MP;
  a->S = S;
  a->s_b = s_b;
  a->s_r = s_r;
  a->s_lo = s_lo;
  a->n = n;
  a->m = m;
  a->rows = rows;
  a->box = box;
  a->above = above;
  a->best = best;
  a->best_i = best_i;
  a->acc = acc;
  a->tb = emit_tb ? tb : nullptr;
  a->tb_rows = tb_rows;
  a->p = p;
  return set_tiling(a, L, E);
}

// K13's launch (sw_striped_grid_launch's arguments): one shard of MP
// columns, K = NP rows from row 0.
inline bool grid_launch(Launch* a, const void* S, int64_t B, int64_t NP,
                        int64_t MP, const int32_t* n, const int32_t* m, int C,
                        float* best, int32_t* best_i, float* acc, float* ckm,
                        float* ckx, float* cky, const Pen& p, int L, int E) {
  if (B <= 0 || NP <= 0 || NP >= (1 << 30) || MP <= 0 || MP >= (1 << 30) ||
      C < 0 || (C && (NP % C || !ckm || !ckx || !cky)))
    return false;
  *a = Launch{};
  a->nds = 1;
  a->K = (int)NP;
  a->W = (int)MP;
  a->D = 1;
  a->B = B;
  a->MP = MP;
  a->S = S;
  a->s_b = NP * MP;
  a->s_r = MP;
  a->n = n;
  a->m = m;
  a->best = best;
  a->best_i = best_i;
  a->acc = acc;
  a->C = C;
  a->ckm = ckm;
  a->ckx = ckx;
  a->cky = cky;
  a->p = p;
  return set_tiling(a, L, E);
}

}  // namespace striped
}  // namespace sw
