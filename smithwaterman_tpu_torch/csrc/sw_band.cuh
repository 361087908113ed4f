// The band wavefront of kernels K3 and K4 (longseq_fill.cu), written once.
//
// nvcc compiles it into the kernels, where each of a block's C threads
// runs the per-thread functions below with one barrier after every step;
// g++ compiles it into the host twin (cell_twin.cpp), which runs the same
// functions for thread 0 .. C-1 in turn at every step.  Within a step no
// thread reads what another writes in that step (double buffers by step
// parity, column tiles written one tile ahead), so the order the twin
// takes is one the card may take too.
//
// A band is C consecutive DP rows base+1 .. base+C of one pair.  Thread t
// owns global row i = base + t + 1 and at step k computes column
// c + 1 = k - t + 1 (c 0-based).  Its inputs are those of the sequential
// fill (sw_cell.cuh fill_pair), so values and pointer bytes are the
// sequential ones, bit for bit:
//   * left (i, c): the thread's own previous cell;
//   * up (i-1, c+1): what thread t-1 computed at step k-1 (shared buffer),
//     or for thread 0 the row above the band: row 0's closed form, or a
//     checkpoint row (the seed);
//   * diag (i-1, c): the thread's previous `up`.
// The seed row and seq2's codes are staged through shared memory in tiles
// of C columns: each thread fetches one element of tile T+1 into
// registers at the first step of tile T and stores it half a tile later,
// so the load latency hides behind C/2 steps.
#pragma once

#include <climits>

#include "sw_cell.cuh"

namespace sw {

// A LOCAL maximum candidate: value and DP cell.
struct Best {
  float v;
  int i, j;
};

SW_HD Best no_best() { return {NEG, INT_MAX, INT_MAX}; }

// The earlier of two candidates in the sequential fill's order: the larger
// value, then the smaller i, then the smaller j.  The sequential strict `>`
// keeps the first maximum in i-major, j-minor order; each thread keeps the
// first maximum of its own rows, and merging those with this rule gives the
// same cell.
SW_HD Best better(Best a, Best b) {
  if (a.v != b.v) return a.v > b.v ? a : b;
  if (a.i != b.i) return a.i < b.i ? a : b;
  return a.j <= b.j ? a : b;
}

// Band pointer bytes, skewed so the C stores of one step are contiguous:
// cell (base + r + 1, c + 1), 0 <= r < C, 0 <= c < MP, at byte (r + c) * C + r
// of the pair's band_bytes(C, MP) bytes (row stride C + 1, column stride C).
SW_HD int64_t band_bytes(int C, int64_t MP) { return (int64_t)(C + MP) * C; }

struct Pen {
  float og, eg;  // interior gap penalties (negative)
  float so, se;  // start penalties: og/eg in GLOBAL, else 0
  float sent;    // boundary sentinel
};

template <int MODE>
SW_HD Pen make_pen(float og, float eg) {
  Pen p;
  p.og = og;
  p.eg = eg;
  p.so = MODE == GLOBAL ? og : 0.0f;
  p.se = MODE == GLOBAL ? eg : 0.0f;
  p.sent = 10.0f * og + 10.0f * eg;
  return p;
}

// One pair's band: inputs and outputs.
struct BandIO {
  const float* tab;  // (K, K) substitution table
  int K;
  const uint8_t* c1;  // the pair's codes (n and m of them)
  const uint8_t* c2;
  int n, m;
  int base;  // global row above the band
  // (M, X, Y) of row `base` at 0-based column c: seed_*[c]; null for row 0
  const float* seed_m;
  const float* seed_x;
  const float* seed_y;
  uint8_t* tb;     // the band's pointer bytes (skewed), or null
  float* out_m;    // the band's bottom row base + C (a checkpoint), or null
  float* out_x;
  float* out_y;
  float* fin;      // non-LOCAL: (M, X, Y) of cell (n, m), or null
};

// The band's shared memory: C threads.
struct BandSmem {
  Cell* up;        // [2C]: cell of thread t at step k in up[(k & 1) * C + t]
  Cell* seed;      // [2C]: seed row, column c in seed[c & (2C - 1)]
  uint8_t* code;   // [4C]: seq2 codes, column c in code[c & (4C - 1)]
};

// Per-thread state.
struct Lane {
  int i;              // global row, 0 when the thread has none in the band
  const float* trow;  // the row's substitution scores
  Cell left, diag;
  float po, pe;       // the row's X penalties (GLOCAL's free last row)
  Cell pseed;         // the tile element in flight
  uint8_t pcode;
};

// Rows of the band that lie in the pair, and the steps they take.
SW_HD int band_rows(int C, const BandIO& io) {
  const int r = io.n - io.base;
  return r < C ? r : C;
}

SW_HD int band_steps(int C, const BandIO& io) {
  return io.m + band_rows(C, io) - 1;
}

// Element t of column tile T (0-based columns T*C .. T*C + C - 1) into
// the lane's registers.
SW_HD void tile_fetch(int t, int C, int T, const BandIO& io, const Pen& p,
                      Lane* L) {
  const int c = T * C + t;
  if (c >= io.m) return;
  L->pcode = io.c2[c];
  L->pseed = io.seed_m ? Cell{io.seed_m[c], io.seed_x[c], io.seed_y[c]}
                       : row0_cell(c + 1, p.so, p.se, p.sent);
}

SW_HD void tile_put(int t, int C, int T, const Lane& L, const BandSmem& sm) {
  const int c = T * C + t;
  sm.seed[c & (2 * C - 1)] = L.pseed;
  sm.code[c & (4 * C - 1)] = L.pcode;
}

// Thread t's state at the start of the band, with tile 0 fetched (the
// caller stores it with tile_put and then waits for every thread).
template <int MODE>
SW_HD Lane lane_begin(int t, int C, const BandIO& io, const Pen& p) {
  Lane L;
  const int i = io.base + t + 1;
  L.i = i <= io.n ? i : 0;
  L.trow = io.tab + (L.i ? (int64_t)io.c1[i - 1] * io.K : 0);
  L.left = col0_cell(i, p.so, p.se, p.sent);
  L.diag = col0_cell(i - 1, p.so, p.se, p.sent);
  const bool last_row = MODE != LOCAL && i == io.n;
  L.po = last_row ? p.so : p.og;
  L.pe = last_row ? p.se : p.eg;
  L.pseed = Cell{0.0f, 0.0f, 0.0f};
  L.pcode = 0;
  tile_fetch(t, C, 0, io, p, &L);
  return L;
}

// Step k of thread t: the tile staging, then cell (L.i, k - t + 1) when it
// lies in the pair.  LOCAL: `best` (may be null) keeps the thread's first
// maximum under a strict `>`.
template <int MODE>
SW_HD void band_step(int t, int C, int k, const BandIO& io, const Pen& p,
                     Lane* L, const BandSmem& sm, Best* best) {
  const int T = k / C, r = k - T * C;
  if (r == 0) tile_fetch(t, C, T + 1, io, p, L);
  if (r == C / 2) tile_put(t, C, T + 1, *L, sm);
  const int c = k - t;
  if (!L->i || c < 0 || c >= io.m) return;
  const Cell u = t == 0 ? sm.seed[c & (2 * C - 1)]
                        : sm.up[((k - 1) & 1) * C + t - 1];
  const float s = L->trow[sm.code[c & (4 * C - 1)]];
  const bool last_col = MODE != LOCAL && c + 1 == io.m;
  const float qo = last_col ? p.so : p.og;
  const float qe = last_col ? p.se : p.eg;
  Cell v;
  const uint32_t ptr =
      cell<MODE>(s, L->diag, u, L->left, p.og, p.eg, L->po, L->pe, qo, qe, &v);
  if (io.tb) io.tb[(int64_t)k * C + t] = (uint8_t)ptr;
  if (io.out_m && t == C - 1) {
    io.out_m[c] = v.m;
    io.out_x[c] = v.x;
    io.out_y[c] = v.y;
  }
  if (MODE == LOCAL && best && v.m > best->v) *best = Best{v.m, L->i, c + 1};
  if (MODE != LOCAL && io.fin && L->i == io.n && c + 1 == io.m) {
    io.fin[0] = v.m;
    io.fin[1] = v.x;
    io.fin[2] = v.y;
  }
  L->diag = u;
  L->left = v;
  sm.up[(k & 1) * C + t] = v;
}

// The stats row of a checkpointed fill from every thread's candidate
// (LOCAL) or the captured final cell (already in stats[3..5]).
SW_HD void finish_stats(bool local, const Best* bests, int C, float* stats) {
  if (!local) return;
  Best b = no_best();
  for (int t = 0; t < C; ++t) b = better(b, bests[t]);
  stats[0] = b.v;
  stats[1] = (float)b.i;
  stats[2] = (float)b.j;
}

}  // namespace sw
