// The band fill of kernels K3 and K4 (longseq_fill.cu), written once.
//
// A band is C consecutive DP rows base+1 .. base+C of one pair.  A warp
// owns rows_w of them from row r0 of the band, its lane l the R
// consecutive rows base + r0 + l*R + 1 .. base + r0 + l*R + R, and at its
// step k the lane computes column c = k - l (0-based) for them, top to
// bottom.  K3 fills a band with one warp, R = C / 32; K4 with a block of
// C / 32 warps of one row a lane.  (A band of fewer than 32 rows, which
// only the host twin runs, is one warp of C lanes with one row each.)
// Every cell gets the sequential fill's inputs (sw_cell.cuh fill_pair),
// so values and pointer bytes are the sequential ones, bit for bit:
//   * left (i, c): the row's own cell at the lane's previous step;
//   * up (i-1, c+1): the lane's row above at this step, or for its first
//     row lane l-1's bottom cell from step k-1 (a shuffle on the card),
//     and for lane 0 the row above the warp's rows (the seed): row 0's
//     closed form or a checkpoint row above a band, and in K4 the bottom
//     row of warp w-1 above warp w, which warp w-1's bottom lane stores
//     into a ring in shared memory.  Warp w runs LAG steps behind warp w-1
//     and the block waits at a barrier every 32 steps, so each ring tile is
//     stored before a barrier that precedes its read, and read before a
//     barrier that precedes its overwrite;
//   * diag (i-1, c): the left cell of the row above, or for the first row
//     the `up` it took at the previous step.
// Within a lane only Y chains from row to row; M comes from the diagonal
// and X from the left, so the R cells of a step overlap.  Nothing goes
// through shared memory per cell: seq2's codes and the seed row arrive a
// 32-column tile at a time, element l in lane l's registers, fetched half
// a tile ahead, and lane 0 takes element k mod 32 of the current tile by a
// shuffle; each lane passes its code down to the next lane one step later.
//
// Outputs:
//   * K3: the band's bottom row (a checkpoint).  The bottom lane's cell of
//     each step is broadcast and kept by lane (c mod 32); when a 32-column
//     tile is complete the warp stores it with coalesced stores and
//     publishes the tile count, which the band below waits for;
//   * K4: pointer bytes, skewed: cell (base + r + 1, c + 1) at byte
//     (r + c) * C + r of the pair's band (row stride C + 1, column stride
//     C), as ops/longseq.band_view and K5 read them.  At step k lane l's
//     cell lies on diagonal r0 + k, the same for every lane of the warp,
//     so the warp's 32 bytes of a step are contiguous;
//   * LOCAL: each lane keeps its first maximum under `better` (value, then
//     smaller i, then smaller j): a lane visits its cells column by column,
//     so the sequential strict `>` is not enough;
//   * non-LOCAL: the lane holding row n writes (M, X, Y) of cell (n, m).
//
// nvcc compiles it into the kernels, where lane l of a warp runs the
// per-lane functions below with the warp's shuffles in between; g++
// compiles it into the host twin (cell_twin.cpp), which runs the same
// functions for lane 0 .. 31 in turn at every step, handing each lane its
// neighbour's values from before the step, as the shuffles do, and checks
// the rings against the card's barriers.
#pragma once

#include <climits>
#include <cstring>

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
// keeps the first maximum in i-major, j-minor order; this is a total
// order, so any grouping and any merge order of the candidates give that
// same cell.
SW_HD Best better(Best a, Best b) {
  if (a.v != b.v) return a.v > b.v ? a : b;
  if (a.i != b.i) return a.i < b.i ? a : b;
  return a.j <= b.j ? a : b;
}

// A band's best in a scratch slot of three int32 words (value bits, i, j).
SW_HD void put_best(int32_t* slot, Best b) {
#if defined(__CUDA_ARCH__)
  slot[0] = __float_as_int(b.v);
#else
  std::memcpy(slot, &b.v, sizeof(float));
#endif
  slot[1] = b.i;
  slot[2] = b.j;
}

SW_HD Best get_best(const int32_t* slot) {
  Best b;
#if defined(__CUDA_ARCH__)
  b.v = __int_as_float(__ldcg(slot));
  b.i = __ldcg(slot + 1);
  b.j = __ldcg(slot + 2);
#else
  std::memcpy(&b.v, slot, sizeof(float));
  b.i = slot[1];
  b.j = slot[2];
#endif
  return b;
}

// Band pointer bytes, skewed so a diagonal's C bytes are contiguous: cell
// (base + r + 1, c + 1), 0 <= r < C, 0 <= c < MP, at byte (r + c) * C + r
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

constexpr int WARP = 32;
// steps warp w runs behind warp w-1 of a K4 band, and the columns of a
// ring: the bottom lane stores column c of tile T at the producer's step
// c + 31, the tile's last column at 32T + 62, and the consumer fetches the
// tile at its step 32T - 16 (half a tile ahead), so with this lag a
// barrier lies between each tile's last store and its fetch, and with four
// tiles a ring one between its fetch and the first store over it
constexpr int LAG = 3 * WARP;
constexpr int RING = 4 * WARP;

// A band of C rows (a multiple of 32) a warp's worth of rows at a time:
// the rows a K3 lane owns, and the one-row warps of a K4 block.
SW_HD int band_r(int C) { return C / WARP; }

// Checkpoint scratch of a K3 launch over B pairs of NCK bands, int32
// words, zeroed before the launch (ops/kernels.ckpt_scratch_words): the
// ticket counter, each pair's count of finished bands, each band's
// published checkpoint tiles, each band's LOCAL best (three words).
struct CkptScratch {
  int32_t* ticket;
  int32_t* done;  // [B]
  int32_t* prog;  // [B * NCK]
  int32_t* best;  // [B * NCK * 3]
};

SW_HD CkptScratch ckpt_scratch(int32_t* s, int64_t B, int64_t NCK) {
  CkptScratch c;
  c.ticket = s;
  c.done = s + 1;
  c.prog = c.done + B;
  c.best = c.prog + B * NCK;
  return c;
}

// Loads that must see another SM's stores: through L2 on the card (L1 is
// not coherent across SMs), after an acquire.
SW_HD float ld_l2(const float* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

SW_HD int ld_acquire(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
#else
  return *p;
#endif
}

SW_HD void st_release(int32_t* p, int v) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
#else
  *p = v;
#endif
}

// One warp's part of a pair's band: inputs and outputs.  CODE is uint8_t,
// or int16_t for tables past 255 symbols.
template <typename CODE>
struct BandIO {
  const float* tab;  // (K, K) substitution table
  int K;
  const CODE* c1;  // the pair's codes (n and m of them)
  const CODE* c2;
  int n, m;
  int C;       // rows of the band (the pointer bytes' layout)
  int base;    // global row above the band
  int r0;      // the warp's first row in the band
  int rows_w;  // the warp's rows
  // the seed, (M, X, Y) of the row above the warp's at 0-based column c:
  // ring_in[c mod RING + {0, RING, 2 RING}] (the warp above's ring), else
  // seed_*[c] (a checkpoint in device memory, read through L2), else row
  // 0's closed form
  const float* ring_in;
  const float* seed_m;
  const float* seed_x;
  const float* seed_y;
  // the band above's published checkpoint tiles (K3), or null: seed tile
  // T may be read once *wait > T
  const int32_t* wait;
  uint8_t* tb;      // K4: the band's pointer bytes (skewed), or null
  float* ring_out;  // K4: the warp's bottom row for the warp below, or null
  // K3: the band's bottom row base + C (a checkpoint), or null, and where
  // its stored tiles are counted
  float* out_m;
  float* out_x;
  float* out_y;
  int32_t* publish;
  float* fin;  // non-LOCAL: (M, X, Y) of cell (n, m), or null
};

// Element l of a 32-column tile: seq2's code and the seed row's cell.
struct TileReg {
  Cell seed;
  int code;
};

// Whether seed tile T may be read (row 0's closed form and rings always
// may: the block's barriers order those).
template <typename CODE>
SW_HD bool seed_ready(int T, const BandIO<CODE>& io) {
  return !io.wait || T * WARP >= io.m || ld_acquire(io.wait) > T;
}

template <typename CODE>
SW_HD TileReg tile_fetch(int l, int T, const BandIO<CODE>& io, const Pen& p) {
  TileReg t{{0.0f, 0.0f, 0.0f}, 0};
  const int c = T * WARP + l;
  if (c >= io.m) return t;
  t.code = io.c2[c];
  if (io.ring_in) {
    const float* r = io.ring_in + (c & (RING - 1));
    t.seed = Cell{r[0], r[RING], r[2 * RING]};
  } else if (io.seed_m) {
    t.seed = Cell{ld_l2(io.seed_m + c), ld_l2(io.seed_x + c),
                  ld_l2(io.seed_y + c)};
  } else {
    t.seed = row0_cell(c + 1, p.so, p.se, p.sent);
  }
  return t;
}

// Per-lane state.
template <int R>
struct Lane {
  int i0;       // global row of the lane's first row
  int rows;     // of its R rows, those inside the pair (0 .. R)
  int toff[R];  // each row's offset into the table (0 past the pair)
  Cell left[R];
  Cell up;    // the cell above the first row at the previous column
  int code;   // seq2's code at the lane's current column
  Best best;  // LOCAL: the lane's first maximum
  Cell keep;  // K3: the bottom row's cell at column T*32 + l
};

// Lanes of the warp that own rows.
template <int R, typename CODE>
SW_HD int warp_lanes(const BandIO<CODE>& io) {
  return io.rows_w / R;
}

// Steps a warp takes: every lane's m columns.
template <int R, typename CODE>
SW_HD int band_steps(const BandIO<CODE>& io) {
  return io.m + warp_lanes<R>(io) - 1;
}

// Block steps of a K4 band of NW warps (warp w's step k at block step
// k + w * LAG); the block waits at a barrier after every block step K with
// K mod 32 == 31.
template <typename CODE>
SW_HD int block_steps(int NW, const BandIO<CODE>& io) {
  return (NW - 1) * LAG + band_steps<1>(io);
}

template <int MODE, int R, typename CODE>
SW_HD Lane<R> lane_begin(int l, const BandIO<CODE>& io, const Pen& p) {
  Lane<R> L;
  L.i0 = io.base + io.r0 + l * R + 1;
  const int end = io.base + io.r0 + io.rows_w;
  const int last = io.n < end ? io.n : end;
  const int rows = last - L.i0 + 1;
  L.rows = rows < 0 ? 0 : (rows > R ? R : rows);
  for (int r = 0; r < R; ++r) {
    L.toff[r] = r < L.rows ? (int)io.c1[L.i0 + r - 1] * io.K : 0;
    L.left[r] = col0_cell(L.i0 + r, p.so, p.se, p.sent);
  }
  L.up = col0_cell(L.i0 - 1, p.so, p.se, p.sent);
  L.code = 0;
  L.best = no_best();
  L.keep = Cell{0.0f, 0.0f, 0.0f};
  return L;
}

// Step k of lane l: its R cells at column c = k - l, when that lies in the
// pair.  `u` is the cell above the first row at that column and L->code
// seq2's code there.  TB (K4, one row a lane): the cell's pointer byte, at
// byte (r0 + l + c) * C + r0 + l = (r0 + k) * C + r0 + l.
template <int MODE, int R, bool TB, typename CODE>
SW_HD void lane_step(int l, int k, Lane<R>* L, Cell u, const BandIO<CODE>& io,
                     const Pen& p) {
  static_assert(!TB || R == 1, "K4 runs one row a lane");
  const int c = k - l;
  if (L->rows == 0 || c < 0 || c >= io.m) return;
  Cell d = L->up;
  L->up = u;
  const bool last_col = MODE != LOCAL && c + 1 == io.m;
  const float qo = last_col ? p.so : p.og;
  const float qe = last_col ? p.se : p.eg;
  // every row's score first: the loads then overlap the Y chain below
  // (the stores in the loop could alias the table, so they would not be
  // moved ahead of them)
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = io.tab[L->toff[r] + L->code];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = L->i0 + r;
    const bool last_row = MODE != LOCAL && i == io.n;
    const float po = last_row ? p.so : p.og;
    const float pe = last_row ? p.se : p.eg;
    Cell v;
    const uint32_t ptr =
        cell<MODE>(s[r], d, u, L->left[r], p.og, p.eg, po, pe, qo, qe, &v);
    if (TB) io.tb[(int64_t)(io.r0 + k) * io.C + io.r0 + l] = (uint8_t)ptr;
    if (MODE == LOCAL && r < L->rows)
      L->best = better(L->best, Best{v.m, i, c + 1});
    if (MODE != LOCAL && io.fin && i == io.n && c + 1 == io.m) {
      io.fin[0] = v.m;
      io.fin[1] = v.x;
      io.fin[2] = v.y;
    }
    d = L->left[r];
    L->left[r] = v;
    u = v;
  }
}

// K4, after lane_step at step k: the warp's bottom lane stores its cell of
// column k - l into the ring of the warp below.
template <int R, typename CODE>
SW_HD void ring_put(int l, int k, const Lane<R>& L, const BandIO<CODE>& io) {
  const int c = k - l;
  if (!io.ring_out || l != warp_lanes<R>(io) - 1 || c < 0 || c >= io.m)
    return;
  float* r = io.ring_out + (c & (RING - 1));
  r[0] = L.left[R - 1].m;
  r[RING] = L.left[R - 1].x;
  r[2 * RING] = L.left[R - 1].y;
}

// K3, after lane_step at step k, with `bottom` the bottom lane's last
// cell: lane (cb mod 32) keeps column cb = k - (lanes - 1) of the band's
// bottom row.  Returns the index of the tile this step completes, or -1.
template <int R, typename CODE>
SW_HD int ck_collect(int l, int k, Lane<R>* L, Cell bottom,
                     const BandIO<CODE>& io) {
  const int cb = k - (warp_lanes<R>(io) - 1);
  if (cb < 0 || cb >= io.m) return -1;
  if ((cb & (WARP - 1)) == l) L->keep = bottom;
  return ((cb & (WARP - 1)) == WARP - 1 || cb == io.m - 1) ? cb / WARP : -1;
}

// Lane l's column of checkpoint tile T (the caller then publishes T + 1).
template <int R, typename CODE>
SW_HD void ck_store(int l, int T, const Lane<R>& L, const BandIO<CODE>& io) {
  const int c = T * WARP + l;
  if (c >= io.m) return;
  io.out_m[c] = L.keep.m;
  io.out_x[c] = L.keep.x;
  io.out_y[c] = L.keep.y;
}

// The LOCAL stats row from a pair's band bests (any order: `better` is a
// total order); the other slots stay as they are (zero).
SW_HD void local_stats(Best b, float* stats) {
  stats[0] = b.v;
  stats[1] = (float)b.i;
  stats[2] = (float)b.j;
}

}  // namespace sw
