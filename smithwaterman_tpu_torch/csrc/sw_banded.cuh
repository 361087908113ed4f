// The banded fill (kernel K7, banded_fill.cu), the banded scores' offsets
// (kernel K6, banded_scores.cu) and the banded walk (kernel K8,
// banded_walk.cu), written once.
//
// nvcc compiles it into the kernels; g++ compiles it into the host twin
// (cell_twin.cpp), which runs the fill's per-lane step for lane 0 .. 31 of
// a stripe in turn, each handed lane l-1's value from before the step (the
// card's shuffle), and the stripes in ticket order, each reading a feed
// tile only once it is published.
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
//     order, so the prefix is taken in any grouping: K7 keeps each row's
//     running maximum as it sweeps the row's lanes left to right;
//   * X's pointer compares lane w-1's final (M, X, Y) of the same row.
// In absolute columns these are the plain rules with every cell outside
// the band BNEG (and column 0, or row 0, its closed form), which is how K7
// sweeps them (lane_step).  The LOCAL best is the first maximum of M over
// rows i <= n at columns jg <= m in the JAX kernel's order: value, then
// smaller row, then smaller lane (lane_better, a total order, so stripes
// and lanes merge in any order).  Build with no FMA contraction (nvcc
// --fmad=false, g++ -ffp-contract=off), as sw_cell.cuh.
#pragma once

#include "sw_band.cuh"
#include "sw_walk.cuh"

namespace sw {
namespace banded {

constexpr float BNEG = -1.0e30f;
constexpr int BIGI = 1 << 30;
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

// ------------------------------------------------------------ K7
// A stripe is 32 R rows of a pair (R = ROWS), filled by one warp: lane l
// owns the R rows first + l*R .. first + l*R + R - 1 and at step k visits absolute
// column jg = j0 + k - l of each of them (j0 = off(first)), top to bottom;
// a row computes the column when it lies in its band (jg - off(i) - 1 in
// 0 .. W-1).  The cell above a lane's first row at that column comes from
// lane l-1 a step later (a shuffle on the card), the one above lane 0's
// from the stripe above's bottom row (the feed), and the diagonal is what
// the cell above was at the step before.  The lane below is handed each
// row's value at the column: the computed cell, the row's value left of
// its band (its column-off(i) cell) or BNEG right of it.
// columns of a published tile of a bottom row (at most a warp's lanes):
// the stripe below may start a tile and a half of columns, plus the 31
// steps its bottom lane trails lane 0, after the stripe above; eight beat
// 16 and 32 at phase 10's shapes by 2 % and 13 % (scripts/ab_banded.py)
constexpr int TILE = 8;
// rows a lane: a step costs about 0.3 us more a row a lane, and a stripe
// hands over to the next 32 R rows later, after a fixed lag; at phase 10's
// shapes two beat 1, 4 and 8 (PERF.md, K7's sweep of R)
constexpr int ROWS = 2;
constexpr int STRIPE_ROWS = WARP * ROWS;

SW_HD int n_stripes(int64_t NP) {
  return (int)((NP + STRIPE_ROWS - 1) / STRIPE_ROWS);
}
// Columns of a stripe's bottom row kept for the stripe below: the stripe's
// columns j0 .. off(last) + W, at most W + 32 R of them.
SW_HD int64_t slot_cols(int W) { return (int64_t)W + STRIPE_ROWS; }

// A K7 launch's scratch over B pairs of NS stripes, int32 words, the
// ticket, done and prog words zeroed before the launch
// (ops/kernels.banded_scratch_words): the ticket counter, each pair's
// count of finished stripes, each stripe's count of published tiles of its
// bottom row, each stripe's LOCAL best (three words), each stripe's bottom
// row ((M, X, Y) rows of slot_cols floats).
struct StripeScratch {
  int32_t* ticket;
  int32_t* done;  // [B]
  int32_t* prog;  // [B * NS]
  int32_t* best;  // [B * NS * 3]
  float* rows;    // [B * NS * 3 * slot_cols]
};

SW_HD int64_t scratch_zeroed(int64_t B, int NS) { return 1 + B + B * NS; }
SW_HD int64_t scratch_words(int64_t B, int NS, int W) {
  return scratch_zeroed(B, NS) + 3 * B * NS + 3 * B * NS * slot_cols(W);
}

SW_HD StripeScratch stripe_scratch(int32_t* s, int64_t B, int NS) {
  StripeScratch c;
  c.ticket = s;
  c.done = s + 1;
  c.prog = c.done + B;
  c.best = c.prog + B * NS;
  c.rows = reinterpret_cast<float*>(c.best + 3 * B * NS);
  return c;
}

// One stripe of a pair: its rows first .. first + rows - 1 (those <= n),
// its lanes with rows, the column j0 of lane 0's first step, the index cl
// of its last column (off(last) + W - j0: lane l's steps cover its rows'
// bands), its steps, and whether a stripe follows (its bottom row feeds
// it).
struct Stripe {
  int first, rows, lanes, j0, cl, steps;
  bool next;
};

SW_HD Stripe stripe_at(const Geom& g, int s) {
  Stripe t;
  constexpr int R = ROWS, SR = STRIPE_ROWS;
  t.first = s * SR + 1;
  const int left = g.n - s * SR;
  t.rows = left < SR ? left : SR;
  t.lanes = (t.rows + R - 1) / R;
  t.j0 = offset(g, t.first);
  t.cl = offset(g, t.first + t.rows - 1) + g.W - t.j0;
  t.steps = t.cl + t.lanes;
  t.next = left > SR;
  return t;
}

// A LOCAL candidate: value, row, lane.
struct LaneBest {
  float v;
  int i, w;
};

SW_HD LaneBest no_lane_best() { return {BNEG, BIGI, BIGI}; }

// The first of two by the JAX kernel's _finish: the larger value, then the
// smaller row, then the smaller lane.  A total order: any grouping of the
// cells and any merge order give the same one.
SW_HD LaneBest lane_better(LaneBest a, LaneBest b) {
  // one expression, no branches: it runs for every cell of a LOCAL fill
  const bool take_b =
      b.v > a.v || (b.v == a.v && (b.i < a.i || (b.i == a.i && b.w < a.w)));
  return take_b ? b : a;
}

SW_HD void put_lane_best(int32_t* slot, LaneBest b) {
  put_best(slot, Best{b.v, b.i, b.w});
}

SW_HD LaneBest get_lane_best(const int32_t* slot) {
  const Best b = get_best(slot);
  return {b.v, b.i, b.j};
}

// The LOCAL stats row [best, best_i, best_lane] (slots 3..7 stay 0).
SW_HD void local_stats(LaneBest b, float* stats) {
  stats[0] = b.v;
  stats[1] = (float)b.i;
  stats[2] = (float)b.w;
}

// Where a stripe's lane 0 finds the row above the stripe: the stripe
// above's bottom row (columns j0' .. j0' + cl' at slot[0 .. cl'], c0 =
// j0 - j0', tiles of it published in *ctr), or for stripe 0 row 0 (column
// 0 the origin, 1 .. W row 0's closed form, j0' = 0).  Columns past cl'
// are BNEG: right of the row's band.
struct Feed {
  const float* slot;  // null: row 0
  const int32_t* ctr;
  int64_t sw;         // the slot's row stride (slot_cols)
  int c0, cl;
  // the twin's record of the producer's tile stores ([stored, fenced,
  // broken]), null on the card
  int32_t* twin;
};

// Everything a stripe's warp reads and writes.
struct StripeIO {
  Geom g;
  Stripe st;
  Feed feed;
  const float* S;  // the pair's band scores (NP, W)
  uint8_t* tb;     // the pair's pointer bytes (NP, W)
  float* fin;      // non-LOCAL: (M, X, Y) of cell (n, m)
  // the stripe's bottom row for the stripe below, its published tiles and
  // the twin's record of them, when a stripe follows
  float* out;
  int32_t* publish;
  int32_t* twin;
};

// Whether feed tile T (columns T*TILE .. T*TILE + TILE - 1 of the
// producer's) may be read: row 0 always, past the producer's last column always.
SW_HD bool feed_ready(const Feed& f, int T) {
  return !f.slot || T * TILE > f.cl || ld_acquire(f.ctr) > T;
}

// Lane l's element of feed tile T, once feed_ready.
SW_HD Cell feed_tile(int l, int T, const Feed& f, const Pen& p, int W) {
  const Cell neg = {BNEG, BNEG, BNEG};
  const int c = T * TILE + l;
  if (!f.slot) {
    if (c == 0) return col0_cell(0, p.so, p.se, p.sent);
    return c <= W ? row0_cell(c, p.so, p.se, p.sent) : neg;
  }
  if (c > f.cl) return neg;
  return {ld_l2(f.slot + c), ld_l2(f.slot + f.sw + c),
          ld_l2(f.slot + 2 * f.sw + c)};
}

// Row i's band score at lane w, 0 outside the band or past n: a load
// through L2, made two steps before the score is used, so that the
// row's chain does not wait for it.
SW_HD float band_score(const StripeIO& io, int i, bool row, int w) {
  return row && w >= 0 && w < io.g.W
             ? ld_l2(io.S + (int64_t)(i - 1) * io.g.W + w)
             : 0.0f;
}

// Asks L2 for the line at p ahead of its use (the card only).
SW_HD void prefetch_l2(const float* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// Per-lane state of a K7 stripe.
struct BLane {
  static constexpr int R = ROWS;
  int i0;         // global row of the lane's first row
  int rows;       // of its R rows, those <= n
  int off[R];     // each row's offset
  Cell left[R];   // each row's last value: its cell left of the column
  float gl[R];    // G of that cell (the row's X chain: max(M, Y) + po)
  float run[R];   // X's running maximum in normalised coordinates
  uint32_t pk[R]; // each row's pointer bytes of its current 4-lane word
  float s1[R];    // each row's band score at the next step's column
  float s2[R];    // and at the one after
  float po[R];    // each row's X penalties (GLOCAL's free last row)
  float pe[R];
  float x0pe[R];  // X(i, 0) + pe, the jg == 1 term
  Cell up;        // the cell above the first row at the previous column
  Cell out;       // the bottom row's value at this step's column
  Cell keep;      // the bottom row's value at column T*TILE + l (publishing)
  LaneBest best;  // LOCAL: the lane's first maximum (lane_better)
};

template <int MODE>
SW_HD BLane lane_begin(int l, const StripeIO& io, const Pen& p) {
  constexpr int R = ROWS;
  BLane L;
  const Cell neg = {BNEG, BNEG, BNEG};
  L.i0 = io.st.first + l * R;
  const int rows = io.st.first + io.st.rows - L.i0;
  L.rows = rows < 0 ? 0 : (rows > R ? R : rows);
  for (int r = 0; r < R; ++r) {
    const int i = L.i0 + r;
    L.off[r] = offset(io.g, i);
    const bool j0 = L.off[r] == 0;
    const bool last = MODE == GLOCAL && i == io.g.n;
    const float lsc = (float)i * p.se + (p.so - p.se);
    L.po[r] = last ? p.so : p.og;
    L.pe[r] = last ? p.se : p.eg;
    L.x0pe[r] = (lsc + p.sent) + L.pe[r];
    L.left[r] = j0 ? col0_cell(i, p.so, p.se, p.sent) : neg;
    L.gl[r] = j0 ? lsc + L.po[r] : BNEG;
    L.run[r] = BNEG;
    L.pk[r] = 0;
    const int w = io.st.j0 - l - L.off[r] - 1;  // the row's lane at step 0
    L.s1[r] = band_score(io, L.i0 + r, r < L.rows, w);
    L.s2[r] = band_score(io, L.i0 + r, r < L.rows, w + 1);
  }
  L.up = neg;
  L.out = neg;
  L.keep = neg;
  L.best = no_lane_best();
  return L;
}

// Step k of lane l: each of its rows at column jg = j0 + k - l, `u` the
// cell above its first row there.  The cell is JAX's, bit for bit: M and Y
// from the diagonal and the cell above (_kernel :137-176), X from the
// row's running maximum of h = G(w-1) - (jg-1)*pe (:186-275), its pointer
// from the row's cell to the left.  Every row's cell is computed whether or
// not the column lies in its band, and kept only where it does: no branch
// per row, so the rows' independent arithmetic interleaves (only Y chains
// from row to row).  Pointer bytes go four lanes to a word, stored after
// the rows when the word's last lane is done (W is a multiple of 4).
template <int MODE>
SW_HD void lane_step(int l, int k, BLane* L, Cell u, const StripeIO& io,
                     const Pen& p) {
  constexpr int R = ROWS;
  const Cell neg = {BNEG, BNEG, BNEG};
  const int jg = io.st.j0 + k - l;
  const int W = io.g.W;
  Cell d = L->up;
  L->up = u;
  // every row's score, loaded two steps ago; the load for two steps ahead,
  // and every 32 lanes the line 64 lanes ahead into L2
  float sc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int w2 = jg + 2 - L->off[r] - 1;
    sc[r] = L->s1[r];
    L->s1[r] = L->s2[r];
    L->s2[r] = band_score(io, L->i0 + r, r < L->rows, w2);
    if (r < L->rows && (w2 & 31) == 0 && w2 >= 0 && w2 + 64 < W)
      prefetch_l2(io.S + (int64_t)(L->i0 + r - 1) * W + w2 + 64);
  }
  const float jf = (float)jg - 1.0f;
  const bool last_col = MODE == GLOCAL && jg == io.g.m;
  const float qo = last_col ? p.so : p.og;
  const float qe = last_col ? p.se : p.eg;
  bool keep[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = L->i0 + r;
    const int w = jg - L->off[r] - 1;
    const bool inb = r < L->rows && w >= 0 && w < W;
    keep[r] = inb;
    const Cell lc = L->left[r];
    const float po = L->po[r], pe = L->pe[r];
    // M and Y (lane_my)
    uint32_t pm = (d.m >= d.x) ? ((d.m >= d.y) ? MATCH : GAPINY)
                               : ((d.x >= d.y) ? GAPINX : GAPINY);
    float m = mx(mx(d.m, d.x), d.y) + sc[r];
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
      const bool c1 = u.m + qo > u.y + qe;
      const bool c2 = u.m >= u.x;
      const bool c3 = u.y + qe >= u.x + qo;
      y = mx(mx(u.m + qo, u.y + qe), u.x + qo);
      py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
    }
    if (MODE == LOCAL) {
      m = mx(m, 0.0f);
      y = mx(y, 0.0f);
      pm = m == 0.0f ? (uint32_t)STOP : pm;
      py = y == 0.0f ? (uint32_t)STOP : py;
    }
    // X: the running maximum of h, then its pointer from the left cell
    float h = L->gl[r] - jf * pe;
    h = jg == 1 ? mx(h, L->x0pe[r]) : h;
    const float run = mx(L->run[r], h);
    float x = run + jf * pe;
    if (MODE == LOCAL) x = mx(x, 0.0f);
    bool e1, e2, e3;
    if (MODE == LOCAL) {
      e1 = lc.m + p.og >= lc.x + p.eg;
      e2 = lc.m > lc.y;
      e3 = lc.x + p.eg > lc.y + p.og;
    } else {
      e1 = lc.m + po > lc.x + pe;
      e2 = lc.m >= lc.y;
      e3 = lc.x + pe >= lc.y + po;
    }
    uint32_t px = e1 ? (e2 ? MATCH : GAPINY) : (e3 ? GAPINX : GAPINY);
    if (MODE == LOCAL) px = x == 0.0f ? (uint32_t)STOP : px;
    const uint32_t ptr = pm | (px << 2) | (py << 4);
    const int sh = 8 * (w & 3);
    const uint32_t pk = (sh ? L->pk[r] : 0u) | ptr << sh;
    const Cell v = {m, x, y};
    L->pk[r] = inb ? pk : L->pk[r];
    L->run[r] = inb ? run : L->run[r];
    L->gl[r] = inb ? mx(m, y) + po : L->gl[r];
    L->left[r] = inb ? v : lc;
    if (MODE == LOCAL) {
      const bool take = inb && jg <= io.g.m;
      L->best = take ? lane_better(L->best, LaneBest{m, i, w}) : L->best;
    }
    // what the row below takes: this row's cell left of jg, and at jg its
    // cell, its column-off(i) value left of the band, or BNEG right of it
    d = lc;
    u = inb ? v : (w < 0 ? lc : neg);
  }
  L->out = u;
  // the stores after the rows, so that the rows' arithmetic interleaves
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = L->i0 + r;
    const int w = jg - L->off[r] - 1;
    if (keep[r] && (w & 3) == 3)
      st_word(io.tb + (int64_t)(i - 1) * W + (w & ~3), L->pk[r]);
    if (MODE != LOCAL && keep[r] && io.fin && i == io.g.n &&
        jg == io.g.m) {
      io.fin[0] = L->left[r].m;
      io.fin[1] = L->left[r].x;
      io.fin[2] = L->left[r].y;
    }
  }
}

// After lane_step at step k, with `bottom` the stripe's bottom lane's out:
// lane (c mod 32) keeps column c = k - (lanes - 1) of the bottom row.
// Returns the index of the tile this step completes, or -1.
SW_HD int bottom_collect(int l, int k, BLane* L, Cell bottom,
                         const StripeIO& io) {
  const int c = k - (io.st.lanes - 1);
  if (c < 0 || c > io.st.cl) return -1;
  if ((c & (TILE - 1)) == l) L->keep = bottom;
  return ((c & (TILE - 1)) == TILE - 1 || c == io.st.cl) ? c / TILE : -1;
}

// Lane l's column of bottom-row tile T; the twin records the tile stored
// once its last lane has stored.
SW_HD void bottom_store(int l, int T, const BLane& L, const StripeIO& io,
                        int64_t sw) {
  const int c = T * TILE + l;
  if (l < TILE && c <= io.st.cl) {
    io.out[c] = L.keep.m;
    io.out[sw + c] = L.keep.x;
    io.out[2 * sw + c] = L.keep.y;
  }
#if !defined(__CUDA_ARCH__)
  if (io.twin && l == TILE - 1) {
    if (T != io.twin[0]) io.twin[2] = 1;
    io.twin[0] = T + 1;
  }
#endif
}

// Makes the tiles stored so far visible to every SM before what follows;
// the twin records them fenced.
SW_HD void fence_tiles(const StripeIO& io) {
#if defined(__CUDA_ARCH__)
  __threadfence();
#else
  if (io.twin) io.twin[1] = io.twin[0];
#endif
}

// Sets the count of published tiles to v (release semantics); the twin
// flags a count past the tiles fenced.
SW_HD void release_tiles(const StripeIO& io, int v) {
#if !defined(__CUDA_ARCH__)
  if (io.twin && v > io.twin[1]) io.twin[2] = 1;
#endif
  st_release(io.publish, v);
}

// Publishes bottom-row tiles 0 .. v-1 once the warp has stored them (one
// lane, after the warp's barrier): a fence, then the count, as K3
// publishes its checkpoint tiles.
SW_HD void publish_tiles(const StripeIO& io, int v) {
  fence_tiles(io);
  release_tiles(io, v);
}

// The stripe at ticket t of a launch over B pairs (stripe-major: a stripe
// waits only on the one above it, whose ticket came B earlier), or false
// when the pair has no rows there.  `twin` is the twin's record, three
// words a stripe, or null.
SW_HD bool stripe_io(StripeIO* io, int64_t t, int64_t B, int64_t NP, int W,
                     int NS, const float* S, const int32_t* n,
                     const int32_t* m, uint8_t* tb, float* stats,
                     const StripeScratch& sc, int mode, int32_t* twin) {
  const int s = (int)(t / B);
  const int64_t b = t % B;
  io->g = geom(n[b], m[b], W);
  if (s >= n_stripes(io->g.n)) return false;
  io->st = stripe_at(io->g, s);
  const int64_t sw = slot_cols(W);
  const int64_t k = b * NS + s;
  io->S = S + b * NP * W;
  io->tb = tb + b * NP * W;
  io->fin = mode != LOCAL ? stats + b * STATS_W + 3 : nullptr;
  io->feed = Feed{nullptr, nullptr, sw, io->st.j0, W, nullptr};
  if (s > 0) {
    const Stripe above = stripe_at(io->g, s - 1);
    io->feed = Feed{sc.rows + (k - 1) * 3 * sw, sc.prog + k - 1, sw,
                    io->st.j0 - above.j0, above.cl,
                    twin ? twin + 3 * (k - 1) : nullptr};
  }
  io->out = io->st.next ? sc.rows + k * 3 * sw : nullptr;
  io->publish = io->st.next ? sc.prog + k : nullptr;
  io->twin = io->st.next && twin ? twin + 3 * k : nullptr;
  return true;
}

// A pair's band rows read straight from device memory: K8's reads when
// the window ring does not fit a block's shared memory (bands of tens of
// thousands of columns), and the rows' interface Windows gives the walk:
// byte k of row u, row u's offset word.
struct DirectRows {
  const uint8_t* tb;   // row u at tb + u * W
  const int32_t* off;  // row u's offset at off[u]
  int64_t W;
  SW_HD void to(int) {}
  SW_HD uint32_t byte(int u, int k) { return tb[u * W + k]; }
  SW_HD int32_t word(int u) { return off[u]; }
  SW_HD void close() {}
};

// K8's windows over a pair's band rows (sw_walk.cuh Windows): unit u is
// row u's W bytes, with off(u + 1) as its side word.  A walk lowers i by
// at most one a step, so it reads rows in non-increasing order.  The ring
// takes WINDOWS slots of D rows, within a block's shared memory
// (WALK_SMEM: Hopper's 227 KB).  A window switch costs the warp a copy's
// issue and a wait, so the windows are as large as four fit: WALK_WINDOW
// bytes of rows and their offset words (PERF.md: 16, 32 and 48 KB
// measured), at least two rows.
constexpr int64_t WALK_SMEM = BLOCK_SMEM;
constexpr int WALK_WINDOW = 48 << 10;

// K8's rows a window for a band of W bytes a row, or 0 when a ring of two
// rows does not fit WALK_SMEM (bands past about 29,000 columns): the walk
// then reads the rows straight from device memory (DirectRows).
SW_HD int walk_rows(int W) {
  const int d = WALK_WINDOW / (W + 4);
  const int D = d < 2 ? 2 : d;
  return WINDOWS * window_slot_bytes(D, W, true) <= WALK_SMEM ? D : 0;
}

template <class Copy>
SW_HD Windows<Copy> row_windows(const uint8_t* tb, int W, int NP,
                                const int32_t* off, int D, uint8_t* smem,
                                Copy copy) {
  return windows(tb, W, NP, off + 1, D, smem, copy);
}

// One pair's walk (kernel K8), _walk_banded_device's loop body step for
// step, run while the pair is active, at most L + 4 steps:
//   rows:  the pair's (NP, W) pointer bytes and its offsets: unit u is
//          band row u (DP row u + 1), rows.byte(u, w) its byte at lane w
//          and rows.word(u) = off(u + 1), after rows.to(u), read through
//          Windows (sw_walk.cuh) or DirectRows; a walk reads its rows in
//          non-increasing order;
//   start: {i, j, state, active} at the path's end cell;
//   idx1/idx2: L entries each, already -2; step k writes entry
//          min(k, L - 1): i-1 / j-1, or -1 for a gap (every lane of a warp
//          steps the same walk and stores the same values: no lane test);
//   *cnt:  the steps taken; *flags: bit 0 when an active step that did not
//          leave the band stood on an edge lane with cells beyond it, bit 1
//          when a read left the band or the walk was still active after
//          L + 4 steps.
// Row i - 1 and off(i) are read with i clamped to NP, as JAX clamps them;
// a step off the matrix (i == 0 or j == 0) reads nothing.  A step's move
// depends only on its state s, known before its pointer byte: so inside
// the matrix the next cell's offset and byte are read before the current
// byte is decoded, and the two reads of one step wait on the step before
// the last, not on the last.
template <class Rows>
SW_HD bool walk_read(Rows& rows, int NP, int W, int i, int j, int* w,
                     uint32_t* byte) {
  if (i < 1 || j < 1) return false;
  const int u = (i > NP ? NP : i) - 1;
  rows.to(u);
  *w = j - 1 - rows.word(u);
  const int q = *w < 0 ? 0 : (*w > W - 1 ? W - 1 : *w);
  *byte = rows.byte(u, q);
  return true;
}

template <class Rows>
SW_HD void walk_pair(bool local, Rows& rows, int NP, int W, int m,
                     const int32_t* start, int64_t L, int32_t* idx1,
                     int32_t* idx2, int32_t* cnt, int32_t* flags) {
  int i = start[0], j = start[1], s = start[2];
  bool active = start[3] != 0;
  int32_t c = 0, f = 0;
  const int last = (int)(L - 1), steps = (int)(L + 4);
  int32_t *o1 = idx1, *o2 = idx2;  // entry min(c, L - 1)
  int w = 0;
  uint32_t byte = 0;
  bool in_mat = active && walk_read(rows, NP, W, i, j, &w, &byte);
  // four steps a loop body on the card: the next step's reads overlap this
  // one's tail (measured, PERF.md)
#pragma unroll 4
  for (int it = 0; active && it < steps; ++it) {
    if (in_mat) {
      // inside the matrix: no boundary state; the next cell's reads first
      const int ni = i - (s != GAPINX), nj = j - (s != GAPINY);
      int nw = 0;
      uint32_t nbyte = 0;
      const bool nin = walk_read(rows, NP, W, ni, nj, &nw, &nbyte);
      if (w < 0 || w >= W) {  // the read left the band
        f |= 2;
        active = false;
        break;
      }
      if ((w == 0 && j > 1) || (w == W - 1 && j < m)) f |= 1;
      const int prev = (byte >> (2 * s)) & 3;
      if (local && prev == STOP) {
        active = false;
        break;
      }
      *o1 = s == GAPINX ? -1 : i - 1;
      *o2 = s == GAPINY ? -1 : j - 1;
      o1 += c < last;
      o2 += c < last;
      ++c;
      i = ni;
      j = nj;
      s = prev;
      w = nw;
      byte = nbyte;
      in_mat = nin;
      active = i != 0 || j != 0;
      continue;
    }
    // on the boundary (i == 0 or j == 0): the boundary state and pointer
    if (j == 0 && i > 0) s = GAPINY;
    if (i == 0 && j > 0) s = GAPINX;
    int prev = i == 0 && j == 0 ? MATCH : (i == 0 && j >= 1 ? GAPINX : GAPINY);
    if (local && prev == s) prev = STOP;
    if (local && prev == STOP) {
      active = false;
      break;
    }
    *o1 = s == GAPINX ? -1 : i - 1;
    *o2 = s == GAPINY ? -1 : j - 1;
    o1 += c < last;
    o2 += c < last;
    ++c;
    if (s != GAPINX) --i;
    if (s != GAPINY) --j;
    const bool hit00 = i == 0 && j == 0;
    if (!hit00) s = prev;
    active = !hit00;
    in_mat = active && walk_read(rows, NP, W, i, j, &w, &byte);
  }
  if (active) f |= 2;
  *cnt = c;
  *flags = f;
}

}  // namespace banded
}  // namespace sw
