// The band fill of kernels K1 and K10 (fill.cu) and K3 and K4
// (longseq_fill.cu), written once.
//
// A band is C consecutive DP rows base+1 .. base+C of one pair.  A warp
// owns rows_w of them from row r0 of the band, its lane l the R
// consecutive rows base + r0 + l*R + 1 .. base + r0 + l*R + R, and at its
// step k the lane computes column c = k - l (0-based) for them, top to
// bottom.  K3 fills a band with one warp, R = C / 32; K4 with a block of
// C / 32 warps of one row a lane.  K1 fills a pair's stripes of C = 32 R
// rows top to bottom, each a band seeded by the bottom row of the stripe
// above (stripe_io), with one warp or, for few pairs, a block of warps
// whose stripes overlap (stripe_gap).  (A band of fewer than
// 32 rows, which only the host twin runs, is one warp of C lanes with one
// row each.)
// Every cell gets the sequential recurrence's inputs (sw_cell.cuh),
// so values and pointer bytes are the sequential ones, bit for bit:
//   * left (i, c): the row's own cell at the lane's previous step;
//   * up (i-1, c+1): the lane's row above at this step, or for its first
//     row lane l-1's bottom cell from step k-1 (a shuffle on the card),
//     and for lane 0 the row above the warp's rows (the seed): row 0's
//     closed form, a checkpoint row above a band, in K1 the stripe above's
//     bottom row, and in K4 the bottom
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
//   * K1: pointer bytes row-major, a pair's together (cell (i, j) at byte
//     (i-1) * rs + j-1 of the pair's block, rs a multiple of 4).  A lane
//     packs four consecutive columns of each of its rows into a register
//     and stores the word when its fourth column (or column m) is done;
//     K10 the run bytes (sw_cell.cuh run_byte) likewise into a second
//     pool.  A cell's diagonal run byte comes as its values do: from the
//     row above's register within a lane, from lane l-1 (its bottom row's
//     byte, passed a step later with the cell above, kept a step more) for
//     a lane's first row, and from the seed row for lane 0.  The stripe's
//     bottom lane stores its row, the next stripe's seed, into the pair's
//     carry scratch (stripe_put);
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
  // one expression, no branches: it runs for every cell of a LOCAL fill
  const bool take_b =
      b.v > a.v || (b.v == a.v && (b.i < a.i || (b.i == a.i && b.j < a.j)));
  return take_b ? b : a;
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

SW_HD uint32_t ld_l2(const uint8_t* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// Four bytes at p, 4-aligned (K1's packed pointer and run bytes).
SW_HD void st_word(uint8_t* p, uint32_t v) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint32_t*>(p) = v;
#else
  std::memcpy(p, &v, sizeof v);
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
  // K1: the pair's pointer bytes in tb, cell (i, j) at (i-1) * rs + j-1
  // (rs a multiple of 4), and with runs (K10) its run bytes at the same
  // offsets of `run`, else null
  int64_t rs;
  uint8_t* run;
  // K10: the seed row's run bytes, or null (row 0's RUN_EDGE)
  const uint8_t* seed_run;
  // K1: where the band's bottom lane puts the bottom row, the stripe
  // below's seed (stripe_put), or null
  float* next_m;
  float* next_x;
  float* next_y;
  uint8_t* next_run;
};

// Element l of a 32-column tile: seq2's code and the seed row's cell (and
// its run byte, read only by K10).
struct TileReg {
  Cell seed;
  int code;
  uint32_t run;
};

// Whether seed tile T may be read (row 0's closed form and rings always
// may: the block's barriers order those).
template <typename CODE>
SW_HD bool seed_ready(int T, const BandIO<CODE>& io) {
  return !io.wait || T * WARP >= io.m || ld_acquire(io.wait) > T;
}

template <typename CODE>
SW_HD TileReg tile_fetch(int l, int T, const BandIO<CODE>& io, const Pen& p) {
  TileReg t{{0.0f, 0.0f, 0.0f}, 0, RUN_EDGE};
  const int c = T * WARP + l;
  if (c >= io.m) return t;
  t.code = io.c2[c];
  if (io.seed_run) t.run = ld_l2(io.seed_run + c);
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
  // K1: each row's pointer bytes of its current 4-column word; K10 its run
  // bytes likewise, each row's run byte at the previous column, and the
  // run byte above the first row at the previous column
  uint32_t pk[R];
  uint32_t rk[R];
  uint32_t rleft[R];
  uint32_t rup;
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
    L.pk[r] = L.rk[r] = 0;
    L.rleft[r] = RUN_EDGE;  // column 0
  }
  L.up = col0_cell(L.i0 - 1, p.so, p.se, p.sent);
  L.rup = RUN_EDGE;
  L.code = 0;
  L.best = no_best();
  L.keep = Cell{0.0f, 0.0f, 0.0f};
  return L;
}

// Where lane_step puts each cell's pointer byte.
enum TbStore {
  TB_NONE = 0,  // nowhere (score-only fills, K3)
  TB_SKEW = 1,  // K4: the band's skewed bytes, one row a lane
  TB_ROWS = 2,  // K1: row-major, four columns of a row a word
};

// Step k of lane l: its R cells at column c = k - l, when that lies in the
// pair.  `u` is the cell above the first row at that column and L->code
// seq2's code there.  TB_SKEW (K4, one row a lane): the cell's pointer
// byte, at byte (r0 + l + c) * C + r0 + l = (r0 + k) * C + r0 + l.
// TB_ROWS (K1): each row's byte goes into its word L->pk[r], stored at
// tb + (i-1) * rs + (c & ~3) when c is the word's last column or m - 1
// (the bytes past m in that word are undefined, as every byte outside the
// pair's n x m); with RUNS (K10) the run bytes likewise, `ru` being the
// run byte above the first row at column c.
template <int MODE, int R, int TBS, bool RUNS = false, typename CODE>
SW_HD void lane_step(int l, int k, Lane<R>* L, Cell u, const BandIO<CODE>& io,
                     const Pen& p, uint32_t ru = RUN_EDGE) {
  static_assert(TBS != TB_SKEW || R == 1, "K4 runs one row a lane");
  static_assert(!RUNS || TBS == TB_ROWS, "run bytes come with K1's bytes");
  const int c = k - l;
  if (L->rows == 0 || c < 0 || c >= io.m) return;
  Cell d = L->up;
  L->up = u;
  uint32_t rd = L->rup;  // the diagonal's run byte, row by row
  L->rup = ru;
  const int sh = 8 * (c & 3);
  const bool flush = (c & 3) == 3 || c + 1 == io.m;
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
    if (TBS == TB_SKEW)
      io.tb[(int64_t)(io.r0 + k) * io.C + io.r0 + l] = (uint8_t)ptr;
    if (TBS == TB_ROWS) {
      L->pk[r] = (sh ? L->pk[r] : 0u) | ptr << sh;
      if (RUNS) {
        const uint32_t rb = run_byte(ptr & 3u, rd);
        rd = L->rleft[r];
        L->rleft[r] = rb;
        L->rk[r] = (sh ? L->rk[r] : 0u) | rb << sh;
      }
    }
    // rows past the pair offer NEG, which a cell of the pair (>= 0) beats
    if (MODE == LOCAL)
      L->best = better(L->best, Best{r < L->rows ? v.m : NEG, i, c + 1});
    d = L->left[r];
    L->left[r] = v;
    u = v;
  }
  // the stores after the rows, so that the rows' arithmetic interleaves
  if (TBS == TB_ROWS && flush) {
    const int64_t at = (int64_t)(L->i0 - 1) * io.rs + (c & ~3);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= L->rows) break;
      st_word(io.tb + at + r * io.rs, L->pk[r]);
      if (RUNS) st_word(io.run + at + r * io.rs, L->rk[r]);
    }
  }
  if (MODE != LOCAL && io.fin && c + 1 == io.m) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (L->i0 + r != io.n) continue;
      io.fin[0] = L->left[r].m;
      io.fin[1] = L->left[r].x;
      io.fin[2] = L->left[r].y;
    }
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

// K1, after lane_step at step k: the band's bottom lane puts its cell of
// column k - l (and with RUNS its run byte) into the stripe below's seed.
// Only a full stripe has a stripe below, so the bottom lane owns R rows.
template <int R, bool RUNS, typename CODE>
SW_HD void stripe_put(int l, int k, const Lane<R>& L, const BandIO<CODE>& io) {
  const int c = k - l;
  if (!io.next_m || l != warp_lanes<R>(io) - 1 || c < 0 || c >= io.m) return;
  io.next_m[c] = L.left[R - 1].m;
  io.next_x[c] = L.left[R - 1].x;
  io.next_y[c] = L.left[R - 1].y;
  if (RUNS) io.next_run[c] = (uint8_t)L.rleft[R - 1];
}

// K1's carry scratch of a pair whose pointer rows are rs bytes apart, in
// floats: two seed rows (stripe s leaves its bottom row in row s mod 2),
// each the row's M, X and Y at [0, rs), [rs, 2 rs), [2 rs, 3 rs) and its
// run bytes in the next rs / 4 floats.
SW_HD int64_t seed_floats(int64_t rs) { return 3 * rs + rs / 4; }
SW_HD int64_t carry_floats(int64_t rs) { return 2 * seed_floats(rs); }

// K1's stripes of a pair of n rows, R rows a lane.
SW_HD int stripes(int n, int R) { return (n + WARP * R - 1) / (WARP * R); }

// K1's block steps between the starts of a pair's consecutive stripes,
// stripe s on warp s mod NW of the pair's block, `full` the steps of a
// full stripe.  One warp runs its stripes back to back.  Several start
// their stripes LAG steps apart or, when they cycle (stripes > NW), far
// enough apart that a warp has finished a stripe before its next one
// starts; a multiple of 32 steps, so that the block's barrier after every
// block step K with K mod 32 == 31 lies between a seed tile's last store
// and its fetch (as in K4), and between that fetch and the store two
// stripes later over the same carry row.
SW_HD int stripe_gap(int NW, int S, int full) {
  if (NW == 1) return full;
  const int cycle = S > NW ? (full + NW - 1) / NW : 0;
  const int g = cycle > LAG ? cycle : LAG;
  return (g + WARP - 1) / WARP * WARP;
}

// K1's inputs of pair d (a descriptor row, sw_cell.cuh Desc): tb and run
// are the pools (or null), stats the pair's stats row.
template <int MODE, typename CODE>
SW_HD BandIO<CODE> fill_io(const float* tab, int K, const CODE* codes1,
                           const CODE* codes2, const int64_t* d, uint8_t* tb,
                           uint8_t* run, float* stats) {
  BandIO<CODE> io{};
  io.tab = tab;
  io.K = K;
  io.c1 = codes1 + d[D_OFF1];
  io.c2 = codes2 + d[D_OFF2];
  io.n = (int)d[D_N];
  io.m = (int)d[D_M];
  io.rs = d[D_RS];
  io.tb = tb ? tb + d[D_TB] : nullptr;
  io.run = run ? run + d[D_TB] : nullptr;
  io.fin = MODE != LOCAL ? stats + 3 : nullptr;
  return io;
}

// K1's band for stripe s of C = 32 R rows of the pair `io` (fill_io): its
// rows s*C + 1 .. min(s*C + C, n), the last stripe's rounded up to R a
// lane (fewer lanes, fewer steps), seeded by row 0's closed form (s == 0)
// or the stripe above's bottom row in the pair's carry scratch `carry`,
// where it leaves its own bottom row when a stripe follows: in seed row 0
// when one warp runs the stripes one after another, else (`two`) in seed
// row s mod 2, the stripe above's being row (s - 1) mod 2.
template <int R, typename CODE>
SW_HD BandIO<CODE> stripe_io(BandIO<CODE> io, int s, float* carry,
                             bool two) {
  io.C = WARP * R;
  io.base = s * io.C;
  io.r0 = 0;
  const int rows = io.n - io.base;
  io.rows_w = rows >= io.C ? io.C : (rows + R - 1) / R * R;
  if (s > 0) {
    float* in = carry + (two ? (s - 1) & 1 : 0) * seed_floats(io.rs);
    io.seed_m = in;
    io.seed_x = in + io.rs;
    io.seed_y = in + 2 * io.rs;
    if (io.run) io.seed_run = reinterpret_cast<uint8_t*>(in + 3 * io.rs);
  }
  if (rows > io.C) {
    float* out = carry + (two ? s & 1 : 0) * seed_floats(io.rs);
    io.next_m = out;
    io.next_x = out + io.rs;
    io.next_y = out + 2 * io.rs;
    io.next_run = reinterpret_cast<uint8_t*>(out + 3 * io.rs);
  }
  return io;
}

#if defined(__CUDACC__)
// A warp's exchanges (all 32 lanes take part).
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ Cell shfl_cell(Cell v, int src) {
  return {__shfl_sync(FULL, v.m, src), __shfl_sync(FULL, v.x, src),
          __shfl_sync(FULL, v.y, src)};
}

__device__ __forceinline__ Cell shfl_up_cell(Cell v) {
  return {__shfl_up_sync(FULL, v.m, 1), __shfl_up_sync(FULL, v.x, 1),
          __shfl_up_sync(FULL, v.y, 1)};
}

__device__ __forceinline__ Best shfl_xor_best(Best b, int o) {
  return {__shfl_xor_sync(FULL, b.v, o), __shfl_xor_sync(FULL, b.i, o),
          __shfl_xor_sync(FULL, b.j, o)};
}

// Every lane's best merged, in every lane.
__device__ __forceinline__ Best warp_best(Best b) {
  for (int o = WARP / 2; o > 0; o /= 2) b = better(b, shfl_xor_best(b, o));
  return b;
}
#endif

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
