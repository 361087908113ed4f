// Host twin of the GPU kernels K1 and K10 (fill.cu), K2 (walk.cu), K3 and
// K4 (longseq_fill.cu), K5 (seg_walk.cu), K6 (banded_scores.cu), K7
// (banded_fill.cu), K8 (banded_walk.cu), K9 (diag_fill.cu), K11
// (token_walk.cu), and K12 and K13 (striped_fill.cu).
//
// It includes the kernels' own headers and runs them over a batch in the
// kernels' loop order, one pair after another, with the same per-pair
// descriptors and memory layout.  For K1, K10, K3 and K4 it runs the warp
// band's per-lane functions (sw_band.cuh) for lane 0 .. 31 in turn at each
// step, handing each lane its neighbour's values from before the step, as
// the card's shuffles do; K1's stripes of a pair run one after another.
// K3's bands begin in ticket order (band-major over
// the pairs) and advance a step each in turn, every band reading its seed
// tiles as soon as they are published (the LOCAL merge in the pair's last
// band); K4's bands of a group run one after another.  Both are orders the
// card may take.  For K5 and K8 it walks each pair (K5: its group of
// bands) through the window ring (sw_walk.cuh Windows) with its copies
// landing only when the card's warp waits for them, and checks every byte
// read against the landed copies; for K2 and K11 likewise through a
// warp's two tile slots (sw_walk.cuh Tiles), every lane's pieces of a
// tile cut as the card's, at the T and C given.  For K7 it runs each
// stripe's lanes in turn at each step (sw_banded.cuh) and the launch's
// stripes in ticket order with a given number in flight, each advanced
// once the feed tiles it reads are published, every publication checked
// against the fence rule.  For K6 it runs each tile's block a thread at a
// time between the barriers (sw_scores.cuh), every code read from the
// staged window checked against the window's landed pieces.  For K12 and
// K13 it runs each column tile as
// its warp would, a row at a time, every thread in turn, and the launch's
// tiles in ticket order with a given number in flight, each advanced once
// its left neighbour has published the edges it needs, every publication
// checked against the fence rule (sw_striped.cuh).
// For K9 it runs every lane of a warp in turn at each step, R columns a
// lane, handing each lane its left neighbour's values from before the
// step, as the card's shuffles do, and lane 0 its row from the stage the
// warp loads 32 rows at a time, each staged edge row checked against the
// strips' writes (sw_diag.cuh).  The tier-1 tests hold its
// outputs against the JAX package (ops/scan_dp.py, ops/pallas_dp.py,
// ops/device_walk.py, ops/longseq.py, ops/banded.py, ops/diag_dp.py,
// parallel/seq_tiled.py),
// which is the only check of the card's cell code that runs without a
// card.
// Build: g++ -O2 -fPIC -std=c++17 -ffp-contract=off -c, then g++ -shared.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <utility>
#include <vector>

#include "sw_band.cuh"
#include "sw_banded.cuh"
#include "sw_cell.cuh"
#include "sw_diag.cuh"
#include "sw_scores.cuh"
#include "sw_striped.cuh"
#include "sw_walk.cuh"

namespace {

// Calls f(codes) with the codes of code_bytes width (1: uint8, 2: int16)
// typed; returns 1 for another width.
template <typename F>
int with_codes(int code_bytes, const void* codes1, const void* codes2,
               F&& f) {
  if (code_bytes == 1) {
    f((const uint8_t*)codes1, (const uint8_t*)codes2);
    return 0;
  }
  if (code_bytes == 2) {
    f((const int16_t*)codes1, (const int16_t*)codes2);
    return 0;
  }
  return 1;
}

// One pair's wavefront fill as a warp would run it (diag_fill.cu), R
// columns a lane: every lane in turn at each step, each handed its left
// neighbour's values from before the step, as the shuffles hand them, and
// lane 0 its row from the stage the warp loads 32 rows at a time.  Every
// staged edge row is checked: the previous strip's last lane has written
// it and this strip's has not yet (*broken otherwise).
template <typename CODE, int R>
float diag_pair(const float* table, int K, const CODE* c1, const CODE* c2,
                int n, int m, float* edge, float og, float eg,
                bool* broken) {
  namespace dg = sw::diag;
  constexpr int W = dg::LANES;
  std::vector<int> wrote(n, -1);  // the strip that last wrote each edge row
  float best = 0.0f;
  for (int c0 = 0, strip = 0; c0 < m; c0 += dg::strip_cols<R>(), ++strip) {
    dg::Lane<R> lanes[W];
    int code1[W], live[W], cc[W][R];
    for (int l = 0; l < W; ++l) {
      lanes[l] = dg::lane_begin<R>();
      code1[l] = 0;
      live[l] = dg::live_cols<R>(m, c0, l);
      for (int k = 0; k < R; ++k)
        cc[l][k] = k < live[l] ? c2[c0 + l * R + k] : 0;
    }
    dg::Feed stage[W] = {};
    const int steps = dg::strip_steps<R>(n, m, c0);
    int d0, d1;
    dg::body_steps<R>(n, m, c0, steps, &d0, &d1);
    for (int d = 0; d < steps; ++d) {
      if (dg::stages(d)) {
        for (int l = 0; l < W; ++l) {
          const int row = dg::stage_row(d, l);
          if (c0 > 0 && row < n && wrote[row] != strip - 1) *broken = true;
          stage[l] = dg::feed_row(c1, edge, n, c0, row);
        }
      }
      // every lane's values from before the step: the shuffles' sources
      float xr[W], w1[W];
      int cd[W];
      for (int l = 0; l < W; ++l) {
        xr[l] = lanes[l].xr;
        w1[l] = lanes[l].w1[R - 1];
        cd[l] = code1[l];
      }
      const dg::Feed& f = stage[d % W];
      const bool body = d >= d0 && d < d1;
      for (int l = 0; l < W; ++l) {
        code1[l] = l ? cd[l - 1] : f.code;
        float s[R];
        for (int k = 0; k < R; ++k) s[k] = table[code1[l] * K + cc[l][k]];
        const int r = d - l;
        const float xin = l ? xr[l - 1] : f.x, wl = l ? w1[l - 1] : f.w;
        const int lv = r >= 0 && r < n ? live[l] : 0;
        if (body)
          dg::step<R, true>(&lanes[l], s, xin, wl, r < 0, lv, og, eg);
        else
          dg::step<R>(&lanes[l], s, xin, wl, r < 0, lv, og, eg);
        const int er = dg::edge_row(d);
        if (l == W - 1 && dg::keeps_edge<R>(n, m, c0, er)) {
          edge[2 * (int64_t)er] = lanes[l].w1[R - 1];
          edge[2 * (int64_t)er + 1] = lanes[l].xr;
          wrote[er] = strip;
        }
      }
    }
    for (int l = 0; l < W; ++l) best = sw::mx(best, lanes[l].best);
  }
  return best;
}

// One warp of a band as the card runs it (longseq_fill.cu run_band, fill.cu
// fill_stripe), a step at a time: every lane in turn at each step, each
// handed its neighbour's values from before the step, as the shuffles hand
// them.  TBS is lane_step's pointer store (sw::TbStore), RUNS K10's run
// bytes.
template <int MODE, int R, int TBS, bool RUNS, typename CODE>
struct TwinWarp {
  static constexpr bool SKEW = TBS == sw::TB_SKEW;
  static constexpr int W = sw::WARP;
  sw::BandIO<CODE> io;
  sw::Pen p;
  std::vector<sw::Lane<R>> L;
  std::vector<sw::TileReg> cur, nxt;
  int k = 0, steps = 0;
  int fetched = -1;  // the seed tile this step fetched, or -1

  void begin() {
    for (int l = 0; l < W; ++l) L.push_back(sw::lane_begin<MODE, R>(l, io, p));
    cur.assign(W, sw::TileReg{});
    nxt = cur;
    steps = sw::band_steps<R>(io);
  }

  // Step k.  Returns false, changing nothing, where the card would wait for
  // a seed tile not yet published.
  bool advance() {
    const int q = k % W;
    fetched = -1;
    if (k == 0 || q == W / 2) {
      const int T = k == 0 ? 0 : k / W + 1;
      if (!sw::seed_ready(T, io)) return false;
      for (int l = 0; l < W; ++l)
        (k == 0 ? cur : nxt)[l] = sw::tile_fetch(l, T, io, p);
      fetched = T;
    }
    sw::Cell bottom[W];
    int code[W];
    uint32_t run[W];
    for (int l = 0; l < W; ++l) {  // the shuffles' sources
      bottom[l] = L[l].left[R - 1];
      code[l] = L[l].code;
      run[l] = L[l].rleft[R - 1];
    }
    for (int l = 0; l < W; ++l) {
      L[l].code = l ? code[l - 1] : cur[q].code;
      sw::lane_step<MODE, R, TBS, RUNS>(l, k, &L[l],
                                        l ? bottom[l - 1] : cur[q].seed, io,
                                        p, l ? run[l - 1] : cur[q].run);
      if (SKEW) sw::ring_put<R>(l, k, L[l], io);
      sw::stripe_put<R, RUNS>(l, k, L[l], io);
    }
    if (!SKEW && io.out_m) {
      const sw::Cell b = L[sw::warp_lanes<R>(io) - 1].left[R - 1];
      int T = -1;
      for (int l = 0; l < W; ++l) T = sw::ck_collect<R>(l, k, &L[l], b, io);
      if (T >= 0) {
        for (int l = 0; l < W; ++l) sw::ck_store<R>(l, T, L[l], io);
        sw::st_release(io.publish, T + 1);
      }
    }
    if (q == W - 1) cur = nxt;
    ++k;
    return true;
  }

  sw::Best best() const {
    sw::Best b = sw::no_best();
    for (const auto& lane : L) b = sw::better(b, lane.best);
    return b;
  }
};

// K1's seed rows as the card's barriers order them: for each of a pair's
// two carry rows and each 32-column tile of it, the stripe whose bottom row
// it holds, how many of its columns that stripe has stored, and the block
// steps of its last store and of its fetch by the stripe below.  With
// several warps a pair, a tile must be complete, and stored before a
// barrier that precedes its fetch; a stripe's first store into a tile must
// follow a barrier that follows the fetch of what it overwrites.  The
// block's barriers follow every block step K with K mod 32 == 31.
struct SeedTiles {
  std::vector<int> gen, cnt, put_at, got_at;
  int tiles = 0;
  bool broken = false;

  explicit SeedTiles(int m) : tiles((m + sw::WARP - 1) / sw::WARP) {
    gen.assign(2 * tiles, -1);
    cnt = put_at = got_at = gen;
  }
  static bool apart(int a, int b) { return a / sw::WARP < b / sw::WARP; }

  // stripe s fetched tile T of its seed row at block step K
  void fetch(int s, int T, int K, int m) {
    const int q = ((s - 1) & 1) * tiles + T;
    const int cols = m - T * sw::WARP < sw::WARP ? m - T * sw::WARP : sw::WARP;
    if (gen[q] != s - 1 || cnt[q] != cols || !apart(put_at[q], K))
      broken = true;
    got_at[q] = K;
  }
  // stripe s stored column c of its bottom row at block step K
  void store(int s, int c, int K) {
    const int q = (s & 1) * tiles + c / sw::WARP;
    if (gen[q] != s) {
      if (gen[q] >= 0 && (got_at[q] < 0 || !apart(got_at[q], K)))
        broken = true;
      gen[q] = s;
      cnt[q] = 0;
      got_at[q] = -1;
    }
    ++cnt[q];
    put_at[q] = K;
  }
};

// K1 / K10 (fill.cu fill_kernel): each pair a block of NW warps of R rows a
// lane, stripe s on warp s mod NW starting at block step s * stripe_gap,
// the stripes active at a block step advanced one step each in stripe
// order (an order the card may take where the barriers order the seed
// rows, which SeedTiles checks with NW > 1; one warp runs its stripes back
// to back), the lanes' LOCAL bests merged.  Returns 3 if a seed row access
// is not ordered by the card's barriers or a warp's next stripe would
// start before its last one ended.
template <int MODE, int R, bool TB, bool RUNS, typename CODE>
int fill_all(const float* table, int K, const CODE* codes1,
             const CODE* codes2, const int64_t* desc, int64_t B, uint8_t* tb,
             uint8_t* run, float* carry, float* stats, float og, float eg,
             int NW) {
  using Warp = TwinWarp<MODE, R, TB ? sw::TB_ROWS : sw::TB_NONE, RUNS, CODE>;
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  for (int64_t b = 0; b < B; ++b) {
    const int64_t* d = desc + b * sw::DESC_W;
    float* st = stats + b * sw::STATS_W;
    for (int q = 0; q < sw::STATS_W; ++q) st[q] = 0.0f;
    const sw::BandIO<CODE> io = sw::fill_io<MODE>(
        table, K, codes1, codes2, d, TB ? tb : nullptr, RUNS ? run : nullptr,
        st);
    float* cy = carry + d[sw::D_CARRY];
    const int S = sw::stripes(io.n, R);
    const int gap = sw::stripe_gap(NW, S, io.m + sw::WARP - 1);
    std::vector<Warp> ws(S);
    SeedTiles seeds(io.m);
    sw::Best best = sw::no_best();
    for (int left = S, K = 0; left; ++K) {
      for (int s = 0; s < S; ++s) {
        Warp& w = ws[s];
        const int k = K - s * gap;
        if (k < 0 || (k > 0 && w.k >= w.steps)) continue;
        if (k == 0) {
          if (s >= NW && ws[s - NW].k < ws[s - NW].steps) return 3;
          w.io = sw::stripe_io<R>(io, s, cy, NW > 1);
          w.p = p;
          w.begin();
        }
        w.advance();  // no wait: the barriers order the seed rows
        const int cb = w.k - 1 - (sw::warp_lanes<R>(w.io) - 1);
        if (NW > 1 && s > 0 && w.fetched >= 0 &&
            w.fetched * sw::WARP < io.m)
          seeds.fetch(s, w.fetched, K, io.m);
        if (NW > 1 && w.io.next_m && cb >= 0 && cb < io.m)
          seeds.store(s, cb, K);
        if (w.k == w.steps) {
          best = sw::better(best, w.best());
          --left;
        }
      }
      if (seeds.broken) return 3;
    }
    if (MODE != sw::LOCAL) continue;
    st[0] = best.v;
    if (TB) {
      st[1] = (float)best.i;
      st[2] = (float)best.j;
    }
  }
  return 0;
}

// A band's block of NW warps, a block step at a time: warp w's step
// K - w * LAG for w = 0 .. NW-1 (K3: NW = 1).  The rings between the warps
// are checked against the card's barriers, which follow every block step K
// with K mod 32 == 31: a tile's last column must be stored before a
// barrier that precedes its fetch, and the tile fetched before a barrier
// that precedes the first store over it, four tiles later.
template <int MODE, int R, bool TB, typename CODE>
struct TwinBlock {
  static constexpr int SLOTS = sw::RING / sw::WARP;  // tiles a ring
  using Warp = TwinWarp<MODE, R, TB ? sw::TB_SKEW : sw::TB_NONE, false,
                        CODE>;
  std::vector<Warp> warps;
  std::vector<float> rings;
  // per ring slot: the tile in it, the block step of its last store and of
  // its fetch (-1: not fetched yet)
  std::vector<int> tile, put_at, got_at;
  int K = 0, total = 0;
  bool broken = false;  // a ring access the barriers would not order

  // The band's warps, R rows a lane: warp 0 reads and the last warp writes
  // as `io` says, rings in between.
  void begin(const sw::BandIO<CODE>& io, const sw::Pen& p, int NW) {
    rings.assign((size_t)(NW - 1) * 3 * sw::RING, 0.0f);
    tile.assign((NW - 1) * SLOTS, -1);
    put_at = got_at = tile;
    for (int w = 0; w < NW; ++w) {
      Warp t;
      t.p = p;
      t.io = io;
      t.io.r0 = w * sw::WARP * R;
      t.io.rows_w = io.C >= sw::WARP ? sw::WARP * R : io.C;
      if (w > 0) {
        t.io.ring_in = rings.data() + (w - 1) * 3 * sw::RING;
        t.io.seed_m = t.io.seed_x = t.io.seed_y = nullptr;
        t.io.wait = nullptr;
      }
      if (w < NW - 1) t.io.ring_out = rings.data() + w * 3 * sw::RING;
      t.begin();
      warps.push_back(std::move(t));
    }
    total = TB ? sw::block_steps(NW, warps[0].io) : warps[0].steps;
  }

  bool done() const { return K >= total; }

  // Block step K.  Returns false, changing nothing, where warp 0 would wait
  // for a seed tile of the band above.
  bool advance() {
    const int NW = (int)warps.size();
    const int barriers = K / sw::WARP;  // barriers passed before this step
    for (int w = 0; w < NW; ++w) {
      auto& t = warps[w];
      const int k = K - w * sw::LAG;
      if (k < 0 || k >= t.steps) continue;
      if (!t.advance()) {
        if (w == 0) return false;
        broken = true;  // a ring tile is always "published"
        continue;
      }
      if (w > 0 && t.fetched >= 0 && t.fetched * sw::WARP < t.io.m) {
        const int slot = (w - 1) * SLOTS + t.fetched % SLOTS;
        if (tile[slot] != t.fetched || put_at[slot] / sw::WARP >= barriers)
          broken = true;
        got_at[slot] = K;
      }
      // the bottom lane's column of this step (ring_put)
      const int cb = k - (sw::warp_lanes<R>(t.io) - 1);
      if (w < NW - 1 && cb >= 0 && cb < t.io.m) {
        const int T = cb / sw::WARP;
        const int slot = w * SLOTS + T % SLOTS;
        if (cb % sw::WARP == 0 && tile[slot] >= 0 &&
            (got_at[slot] < 0 || got_at[slot] / sw::WARP >= barriers))
          broken = true;  // overwrites a tile not yet fetched
        tile[slot] = T;
        put_at[slot] = K;
        if (cb % sw::WARP == 0) got_at[slot] = -1;
      }
    }
    ++K;
    return true;
  }

  sw::Best best() const {
    sw::Best b = sw::no_best();
    for (const auto& t : warps) b = sw::better(b, t.best());
    return b;
  }
};

template <typename CODE>
sw::BandIO<CODE> pair_io(const float* table, int K, const CODE* codes1,
                         const CODE* codes2, const int32_t* n,
                         const int32_t* m, int64_t b, int64_t NP, int64_t MP,
                         int C, int kb, const float* ckm, const float* ckx,
                         const float* cky) {
  sw::BandIO<CODE> io{};
  io.tab = table;
  io.K = K;
  io.c1 = codes1 + b * NP;
  io.c2 = codes2 + b * MP;
  io.n = n[b];
  io.m = m[b];
  io.C = C;
  io.base = kb * C;
  const int64_t NCK = (NP + C - 1) / C;
  const int64_t prev = (b * NCK + kb - 1) * MP;
  io.seed_m = kb ? ckm + prev : nullptr;
  io.seed_x = kb ? ckx + prev : nullptr;
  io.seed_y = kb ? cky + prev : nullptr;
  return io;
}

// K3 (longseq_fill.cu ckpt_kernel): a block for every ticket, begun in
// ticket order, and every begun band advanced one block step in turn, so
// each band reads its seed tiles as early as their publication allows (a
// schedule the card may take; a band that would read an unpublished tile
// waits its turn).  The LOCAL merge runs in the pair's last band to finish.
// Returns 2 if no band can advance (the card would hang), 3 if a ring
// access is not ordered by the card's barriers.
template <int MODE, int R, typename CODE>
int ckpt_all(const float* table, int K, const CODE* codes1,
             const CODE* codes2, const int32_t* n, const int32_t* m,
             int64_t B, int64_t NP, int64_t MP, int C, float* ckm, float* ckx,
             float* cky, float* stats, int32_t* scratch, float og, float eg) {
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int64_t NCK = (NP + C - 1) / C;
  const sw::CkptScratch s = sw::ckpt_scratch(scratch, B, NCK);
  for (int64_t q = 0; q < B * sw::STATS_W; ++q) stats[q] = 0.0f;
  std::vector<TwinBlock<MODE, R, false, CODE>> blocks;
  std::vector<std::pair<int64_t, int>> at;  // (pair, band) of each block
  for (int64_t t = (*s.ticket)++; t < NCK * B; t = (*s.ticket)++) {
    const int kb = (int)(t / B);
    const int64_t b = t % B;
    if (kb * C >= n[b]) continue;
    sw::BandIO<CODE> io = pair_io(table, K, codes1, codes2, n, m, b, NP, MP,
                                  C, kb, ckm, ckx, cky);
    io.wait = kb ? s.prog + b * NCK + kb - 1 : nullptr;
    if (io.base + C <= io.n) {
      const int64_t row = (b * NCK + kb) * MP;
      io.out_m = ckm + row;
      io.out_x = ckx + row;
      io.out_y = cky + row;
      io.publish = s.prog + b * NCK + kb;
    }
    if (MODE != sw::LOCAL && io.n <= io.base + C)
      io.fin = stats + b * sw::STATS_W + 3;
    blocks.emplace_back();
    blocks.back().begin(io, p, 1);
    at.push_back({b, kb});
  }
  for (size_t left = blocks.size(); left;) {
    bool moved = false;
    for (size_t q = 0; q < blocks.size(); ++q) {
      auto& blk = blocks[q];
      if (blk.done() || !blk.advance()) continue;
      moved = true;
      if (blk.broken) return 3;
      if (!blk.done()) continue;
      --left;
      if (MODE != sw::LOCAL) continue;
      const int64_t b = at[q].first;
      sw::put_best(s.best + 3 * (b * NCK + at[q].second), blk.best());
      const int nb = (n[b] + C - 1) / C;
      if (s.done[b]++ != nb - 1) continue;
      sw::Best all = sw::no_best();
      for (int kb = 0; kb < nb; ++kb)
        all = sw::better(all, sw::get_best(s.best + 3 * (b * NCK + kb)));
      sw::local_stats(all, stats + b * sw::STATS_W);
    }
    if (!moved) return 2;
  }
  return 0;
}

// Whether the twin takes a band of C rows: a power of two up to 256 (below
// 32, which the card refuses, one warp of C lanes with a row each).
bool twin_c(int C) { return C > 0 && C <= 256 && !(C & (C - 1)); }
int twin_r(int C) { return C < sw::WARP ? 1 : sw::band_r(C); }

// K4 (longseq_fill.cu band_kernel): bands sk0 .. sk0+G-1 of every pair,
// band-major, each block of one-row warps to its end (they do not wait on
// each other).  Returns 3 if a ring access is not ordered by the card's
// barriers.
template <int MODE, typename CODE>
int band_all(const float* table, int K, const CODE* codes1,
             const CODE* codes2, const int32_t* n, const int32_t* m,
             int64_t B, int64_t NP, int64_t MP, int C, int sk0, int G,
             const float* ckm, const float* ckx, const float* cky,
             uint8_t* band, float og, float eg) {
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  for (int64_t w = 0; w < G * B; ++w) {
    const int sk = sk0 + (int)(w / B);
    const int64_t b = w % B;
    if (sk * C >= n[b]) continue;
    sw::BandIO<CODE> io = pair_io(table, K, codes1, codes2, n, m, b, NP, MP,
                                  C, sk, ckm, ckx, cky);
    io.tb = band + w * sw::band_bytes(C, MP);
    TwinBlock<MODE, 1, true, CODE> blk;
    blk.begin(io, p, twin_r(C));
    while (!blk.done())
      if (!blk.advance() || blk.broken) return 3;
  }
  return 0;
}

// Calls f.run<MODE, R>() for the mode and R = r (1, 2, 4 or 8); returns 1
// for another mode or r.
template <typename F>
int dispatch(int mode, int r, const F& f) {
#define SW_R(MODE)                      \
  switch (r) {                          \
    case 1:                             \
      return f.template run<MODE, 1>(); \
    case 2:                             \
      return f.template run<MODE, 2>(); \
    case 4:                             \
      return f.template run<MODE, 4>(); \
    case 8:                             \
      return f.template run<MODE, 8>(); \
    default:                            \
      return 1;                         \
  }
  if (mode == sw::LOCAL) SW_R(sw::LOCAL)
  if (mode == sw::GLOCAL) SW_R(sw::GLOCAL)
  if (mode == sw::GLOBAL) SW_R(sw::GLOBAL)
#undef SW_R
  return 1;
}

template <typename CODE>
struct FillRun {
  const float* table;
  int K;
  const CODE *codes1, *codes2;
  const int64_t* desc;
  int64_t B;
  int traceback;
  uint8_t *tb, *runs;
  float *carry, *stats;
  float og, eg;
  int NW;
  template <int MODE, int R>
  int run() const {
    if (runs)
      return fill_all<MODE, R, true, true>(table, K, codes1, codes2, desc, B,
                                           tb, runs, carry, stats, og, eg,
                                           NW);
    if (traceback)
      return fill_all<MODE, R, true, false>(table, K, codes1, codes2, desc,
                                            B, tb, nullptr, carry, stats, og,
                                            eg, NW);
    return fill_all<MODE, R, false, false>(table, K, codes1, codes2, desc, B,
                                           nullptr, nullptr, carry, stats, og,
                                           eg, NW);
  }
};

template <typename CODE>
struct CkptRun {
  const float* table;
  int K;
  const CODE *codes1, *codes2;
  const int32_t *n, *m;
  int64_t B, NP, MP;
  int C;
  float *ckm, *ckx, *cky, *stats;
  int32_t* scratch;
  float og, eg;
  template <int MODE, int R>
  int run() const {
    return ckpt_all<MODE, R, CODE>(table, K, codes1, codes2, n, m, B, NP, MP,
                                   C, ckm, ckx, cky, stats, scratch, og, eg);
  }
};

template <typename CODE>
struct BandRun {
  const float* table;
  int K;
  const CODE *codes1, *codes2;
  const int32_t *n, *m;
  int64_t B, NP, MP;
  int C, sk0, G;
  const float *ckm, *ckx, *cky;
  uint8_t* band;
  float og, eg;
  template <int MODE, int R>
  int run() const {  // K4 runs one row a lane
    return band_all<MODE, CODE>(table, K, codes1, codes2, n, m, B, NP, MP, C,
                                sk0, G, ckm, ckx, cky, band, og, eg);
  }
};

namespace bd = sw::banded;

// One K7 stripe as its warp runs it (banded_fill.cu run_stripe), a step at
// a time: every lane in turn, each handed lane l-1's value from before the
// step (the card's shuffle), lane 0 the feed tile's element; the bottom
// row's tiles stored and published as the card's warp does.
template <int MODE>
struct TwinStripe {
  bd::StripeIO io{};
  std::vector<bd::BLane> L;
  sw::Cell cur[sw::WARP]{}, nxt[sw::WARP]{};
  int k = 0;
  int64_t t = 0;

  void begin(const bd::StripeIO& s, int64_t tk, const sw::Pen& p) {
    io = s;
    t = tk;
    for (int l = 0; l < sw::WARP; ++l)
      L.push_back(bd::lane_begin<MODE>(l, io, p));
  }

  bool done() const { return k >= io.st.steps; }

  // The feed tiles this step reads first, as the card's warp waits for
  // them (-1: none).
  void needs(int* a, int* b) const {
    const int c = io.feed.c0 + k, q = c & (bd::TILE - 1);
    *a = k == 0 ? c / bd::TILE : -1;
    *b = (q == bd::TILE / 2 || (k == 0 && q > bd::TILE / 2))
             ? c / bd::TILE + 1
             : -1;
  }

  bool ready() const {
    int a, b;
    needs(&a, &b);
    return (a < 0 || bd::feed_ready(io.feed, a)) &&
           (b < 0 || bd::feed_ready(io.feed, b));
  }

  void step(const sw::Pen& p) {
    const int c = io.feed.c0 + k, q = c & (bd::TILE - 1);
    int a, b;
    needs(&a, &b);
    for (int l = 0; l < sw::WARP; ++l) {
      if (a >= 0) cur[l] = bd::feed_tile(l, a, io.feed, p, io.g.W);
      if (b >= 0) nxt[l] = bd::feed_tile(l, b, io.feed, p, io.g.W);
    }
    sw::Cell outs[sw::WARP];
    for (int l = 0; l < sw::WARP; ++l) outs[l] = L[l].out;
    for (int l = 0; l < sw::WARP; ++l)
      bd::lane_step<MODE>(l, k, &L[l], l ? outs[l - 1] : cur[q], io, p);
    if (io.out) {
      const sw::Cell bottom = L[io.st.lanes - 1].out;
      int T = -1;
      for (int l = 0; l < sw::WARP; ++l)
        T = bd::bottom_collect(l, k, &L[l], bottom, io);
      if (T >= 0) {
        for (int l = 0; l < sw::WARP; ++l)
          bd::bottom_store(l, T, L[l], io, io.feed.sw);
        bd::publish_tiles(io, T + 1);
      }
    }
    if (q == bd::TILE - 1)
      for (int l = 0; l < sw::WARP; ++l) cur[l] = nxt[l];
    ++k;
  }

  bd::LaneBest best() const {
    bd::LaneBest b = bd::no_lane_best();
    for (const auto& lane : L) b = bd::lane_better(b, lane.best);
    return b;
  }
};

// K7 (banded_fill.cu stripe_kernel): `blocks` stripes in flight (0: every
// stripe), taken by ticket as blocks free up, and each stripe in flight
// advanced a step in turn, in ticket order, once the feed tiles it reads
// at that step are published.  The LOCAL merge runs in the pair's last
// stripe to finish.  Returns 0, 2 if no stripe can advance (the card would
// hang), 3 if a publication broke the fence rule.
template <int MODE>
int banded_all(const float* S, const int32_t* n, const int32_t* m, int64_t B,
               int64_t NP, int W, uint8_t* tb, float* stats, float og,
               float eg, int blocks) {
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int NS = bd::n_stripes(NP);
  std::vector<int32_t> scratch(bd::scratch_words(B, NS, W), 0);
  const bd::StripeScratch sc = bd::stripe_scratch(scratch.data(), B, NS);
  std::vector<int32_t> twin(3 * B * NS, 0);
  for (int64_t q = 0; q < B * sw::STATS_W; ++q) stats[q] = 0.0f;
  std::vector<TwinStripe<MODE>> run;
  const int64_t tickets = (int64_t)NS * B;
  const int64_t cap = blocks > 0 ? blocks : tickets;
  for (;;) {
    while ((int64_t)run.size() < cap && *sc.ticket < tickets) {
      const int64_t t = (*sc.ticket)++;
      bd::StripeIO io;
      if (!bd::stripe_io(&io, t, B, NP, W, NS, S, n, m, tb, stats, sc, MODE,
                         twin.data()))
        continue;
      run.emplace_back();
      run.back().begin(io, t, p);
    }
    if (run.empty()) break;
    bool moved = false;
    for (auto& st : run) {
      if (!st.ready()) continue;
      st.step(p);
      moved = true;
      if (!st.done() || MODE != sw::LOCAL) continue;
      const int s = (int)(st.t / B);
      const int64_t b = st.t % B;
      bd::put_lane_best(sc.best + 3 * (b * NS + s), st.best());
      const int ns = bd::n_stripes(n[b]);
      if (sc.done[b]++ != ns - 1) continue;
      bd::LaneBest all = bd::no_lane_best();
      for (int q = 0; q < ns; ++q)
        all = bd::lane_better(all,
                              bd::get_lane_best(sc.best + 3 * (b * NS + q)));
      bd::local_stats(all, stats + b * sw::STATS_W);
    }
    if (!moved) return 2;
    run.erase(std::remove_if(run.begin(), run.end(),
                             [](const auto& st) { return st.done(); }),
              run.end());
  }
  for (int64_t k = 0; k < B * NS; ++k)
    if (twin[3 * k + 2]) return 3;
  return 0;
}

// The window copies of K5 and K8 as the card's warp makes them
// (sw_walk.cuh WarpCopy), in the order Windows asks: a window's copies,
// cut into sw::pieces, stay pending until a wait covers their commit
// group, and only then do their bytes land in the slot and count as
// loaded; a window's first copy unloads what its slot held.  A read of a
// byte that is not loaded, or a word or 16-byte piece misaligned at
// either end, marks the walk broken.
struct TwinWindows {
  struct Piece {
    uint8_t* dst;
    const uint8_t* src;
    int64_t bytes;
  };
  int64_t sb;  // bytes a slot
  std::vector<uint8_t> mem, loaded;
  uint8_t* buf;  // mem, 16-byte aligned
  std::vector<std::vector<Piece>> groups;  // committed, not landed
  std::vector<Piece> group;                // being started
  bool fresh = true;                       // the next load starts a window
  bool broken = false;

  explicit TwinWindows(int64_t slot_bytes)
      : sb(slot_bytes),
        mem(sw::WINDOWS * slot_bytes + 16, 0),
        loaded(sw::WINDOWS * slot_bytes, 0) {
    buf = mem.data() + ((16 - ((uintptr_t)mem.data() & 15)) & 15);
  }

  void land(size_t count) {
    for (size_t g = 0; g < count; ++g)
      for (const Piece& c : groups[g]) {
        std::memcpy(c.dst, c.src, (size_t)c.bytes);
        std::fill_n(loaded.begin() + (c.dst - buf), c.bytes, 1);
      }
    groups.erase(groups.begin(), groups.begin() + count);
  }
};

struct TwinCopy {
  TwinWindows* t;

  void piece(uint8_t* dst, const uint8_t* src, int64_t bytes, int align) {
    if (bytes <= 0) return;
    if ((uintptr_t)dst % align || (uintptr_t)src % align) t->broken = true;
    t->group.push_back({dst, src, bytes});
  }
  void load(int k, uint8_t* dst, const uint8_t* src, int64_t bytes) {
    if (t->fresh) std::fill_n(t->loaded.begin() + k * t->sb, t->sb, 0);
    t->fresh = false;
    if (((uintptr_t)dst & 15) != ((uintptr_t)src & 15)) t->broken = true;
    if (dst < t->buf + k * t->sb || dst + bytes > t->buf + (k + 1) * t->sb)
      t->broken = true;
    if (t->broken) return;
    const sw::Pieces p = sw::pieces((uint64_t)src, bytes);
    piece(dst, src, p.w0, 1);
    for (int64_t o = p.w0; o < p.q0; o += 4) piece(dst + o, src + o, 4, 4);
    for (int64_t o = p.q0; o < p.q1; o += 16) piece(dst + o, src + o, 16, 16);
    for (int64_t o = p.q1; o < p.w1; o += 4) piece(dst + o, src + o, 4, 4);
    piece(dst + p.w1, src + p.w1, bytes - p.w1, 1);
  }
  void commit() {
    t->groups.push_back(std::move(t->group));
    t->group.clear();
    t->fresh = true;
  }
  void wait_all() { t->land(t->groups.size()); }
  void wait_ahead() {
    const size_t keep = sw::WINDOWS - 1;
    if (t->groups.size() > keep) t->land(t->groups.size() - keep);
  }
  void ok(int k, int64_t at) {
    if (at < 0 || at >= t->sb || !t->loaded[k * t->sb + at])
      t->broken = true;
  }
};

// The tiles of K2 and K11 as a warp of the card copies them (sw_walk.cuh
// Tiles and LaneCopy): every lane's rows of a tile, each piece checked for
// alignment and for landing inside the slot begun and at its source's
// address mod 16, stays pending until the warp waits, and
// only then do its bytes land and count as loaded; a slot's first copy
// unloads what it held.  A read of a byte that is not loaded, a copy into
// a slot with copies pending, or a misplaced piece marks the walk broken.
struct TwinTiles {
  struct Piece {
    uint8_t* dst;
    const uint8_t* src;
    int n;
  };
  int64_t bytes;  // the warp's slots
  std::vector<uint8_t> mem, loaded;
  uint8_t* buf;  // mem, 16-byte aligned
  uint8_t *lo = nullptr, *hi = nullptr;  // the slot being copied into
  std::vector<Piece> pending;
  bool broken = false;

  explicit TwinTiles(int64_t b) : bytes(b), mem(b + 16, 0), loaded(b, 0) {
    buf = mem.data() + ((16 - ((uintptr_t)mem.data() & 15)) & 15);
  }
  void reset() {
    pending.clear();
    std::fill(loaded.begin(), loaded.end(), 0);
  }
};

struct TwinTileCopy {
  TwinTiles* t;
  int first, last;  // every lane of the warp

  void begin(uint8_t* slot, int64_t n) {
    for (const auto& c : t->pending)
      if (c.dst < slot + n && c.dst + c.n > slot) t->broken = true;
    std::fill_n(t->loaded.begin() + (slot - t->buf), n, 0);
    t->lo = slot;
    t->hi = slot + n;
  }
  void put(uint8_t* dst, const uint8_t* src, int n, int align) {
    if ((uintptr_t)dst % align || (uintptr_t)src % align ||
        dst < t->lo || dst + n > t->hi)
      t->broken = true;
    t->pending.push_back({dst, src, n});
  }
  // as LaneCopy::piece cuts it
  void piece(uint8_t* dst, const uint8_t* src, int n) {
    if (n < 1 || n > 16 || ((uintptr_t)dst & 15) != ((uintptr_t)src & 15)) {
      t->broken = true;
      return;
    }
    if (n == 16) return put(dst, src, 16, 16);
    const sw::Pieces p = sw::pieces((uint64_t)src, n);
    for (int o = 0; o < (int)p.w0; ++o) put(dst + o, src + o, 1, 1);
    for (int o = (int)p.w0; o < (int)p.w1; o += 4) put(dst + o, src + o, 4, 4);
    for (int o = (int)p.w1; o < n; ++o) put(dst + o, src + o, 1, 1);
  }
  void commit() {}
  void wait_all() {
    for (const auto& c : t->pending) {
      std::memcpy(c.dst, c.src, (size_t)c.n);
      std::fill_n(t->loaded.begin() + (c.dst - t->buf), c.n, 1);
    }
    t->pending.clear();
  }
  void sync() {}
  uint32_t read(int off) {
    if (off < 0 || off >= t->bytes || !t->loaded[off]) {
      t->broken = true;
      return 0;
    }
    return t->buf[off];
  }
};

// K2 (P = 1) and K11 (P = 2) over B pairs as the card's launch takes them:
// block t of the launch walks pair order[t], a warp
// with tiles of T rows x C columns; the warps one after another.  Returns 0, 1 for arguments the launch refuses, or 3
// if a walk read a byte no finished copy had brought.
template <int P>
int tile_walks(int local, const uint8_t* const* pools, const int64_t* desc,
               const float* stats, const int32_t* order, int64_t B,
               int64_t L, int32_t* cnt, uint8_t* out, int T, int C) {
  const int64_t slots = sw::TILE_SLOTS * P * sw::tile_slot_bytes(T, C);
  if (!order || B <= 0 || L <= 0 || T < 1 || C < 1 || slots > sw::BLOCK_SMEM)
    return 1;
  if (P == 2 && (((uintptr_t)pools[0] - (uintptr_t)pools[1]) & 15)) return 1;
  TwinTiles tw(slots);
  for (int64_t t = 0; t < B; ++t) {
    const int64_t b = order[t];
    const int64_t* d = desc + b * sw::DESC_W;
    const uint8_t* src[P];
    for (int q = 0; q < P; ++q) src[q] = pools[q] + d[sw::D_TB];
    tw.reset();
    auto cells = sw::tiles<P>(src, d[sw::D_RS], T, C, tw.buf,
                              TwinTileCopy{&tw, 0, 32});
    const float* st = stats + b * sw::STATS_W;
    if constexpr (P == 1)
      cnt[b] = sw::walk_pair(local != 0, cells, (int)d[sw::D_N],
                             (int)d[sw::D_M], st, L, out + b, B);
    else
      cnt[b] = sw::walk_tokens_pair(local != 0, cells, (int)d[sw::D_N],
                                    (int)d[sw::D_M], st, L, out + b, B);
    if (tw.broken || !tw.pending.empty()) return 3;
  }
  return 0;
}

namespace st = sw::striped;

// One K12 / K13 tile as its warp runs it (striped_fill.cu run_tile), a row
// at a time: each per-thread function for thread 0 .. 31 in turn, each
// thread handed its left neighbour's values from before the call (the
// card's shuffles), the max scan in thread order.  The left neighbour's
// edges are read only once published, and `twin` records this tile's
// publications ([stored, fenced, broken] a tile).
template <int MODE, bool TB, int L, typename ST, bool GRID>
struct TwinTile {
  const st::Launch* a = nullptr;
  st::Job J{};
  std::vector<st::Thread<L>> th;
  sw::Cell ab{};
  int q = 0;

  void begin(const st::Launch& la, int64_t tk, int32_t* twin) {
    a = &la;
    J = st::job_at(la, tk);
    if (J.left.slots) J.left.twin = twin + 3 * (tk - 1);
    if (J.right.slots) J.right.twin = twin + 3 * tk;
    th.resize(sw::WARP);
    for (int t = 0; t < sw::WARP; ++t) {
      st::thread_begin<L, GRID>(la, J, t, &th[t]);
      const int kl = st::last_lane(J, t, L);
      if (J.right.slots && kl >= 0)
        st::put_edge(J.right, 0, st::Edge{st::lane_cell(th[t], kl), sw::NEG});
    }
  }

  bool done() const { return q >= a->K; }

  // Whether row q's edges are published (slot 0 with the first row's).
  bool ready() const { return !J.left.slots || *J.left.ctr >= q + 2; }

  st::Edge slot(int s) const {
    const float* v = J.left.slots + 4 * s;
    return st::Edge{{v[0], v[1], v[2]}, v[3]};
  }

  void row() {
    constexpr int NT = sw::WARP;
    const int i = J.i_start + q + 1;
    const st::Row r = st::row_at<MODE>(a->p, i, J.n, J.m);
    if (q == 0) ab = J.left.slots ? slot(0).v : st::box_above(a->p, J);
    sw::Cell nb[NT];
    for (int t = 0; t < NT; ++t)
      nb[t] = sw::Cell{th[t].pm[L - 1], th[t].px[L - 1], th[t].py[L - 1]};
    for (int t = 0; t < NT; ++t) {
      float s[L];
      st::get_s<L>(st::row_scores<ST>(*a, J, i) + t * L,
                   st::lanes_in(J, t, L), s);
      st::thread_a<MODE, TB, L>(a->p, r, J.col0 + t * L + 1, s,
                                st::first_diag(t, ab, nb[t ? t - 1 : 0]),
                                &th[t]);
    }
    float lm[NT], ly[NT], excl[NT];
    for (int t = 0; t < NT; ++t) {
      lm[t] = th[t ? t - 1 : 0].cm[L - 1];
      ly[t] = th[t ? t - 1 : 0].cy[L - 1];
    }
    float run = sw::NEG;
    for (int t = 0; t < NT; ++t) {
      const float own =
          st::thread_h<L>(r, J.col0 + t * L + 1, t > 0, lm[t], ly[t], &th[t]);
      excl[t] = run;
      run = sw::mx(run, own);
    }
    const st::Edge e = J.left.slots ? slot(q + 1) : st::box_edge(a->p, J, q, i);
    const float lc = st::left_c(r, J.col0 + 1, e);
    float* acc = st::acc_of(*a, J, GRID);
    for (int t = 0; t < NT; ++t) {
      const int kl = st::last_lane(J, t, L);
      st::Edge eo{};
      st::thread_c<MODE, TB, L>(a->p, r, J.col0 + t * L + 1, t, excl[t], lc,
                                e, lm[t], ly[t], st::lanes_in(J, t, L), kl,
                                &th[t], acc, &eo);
      if (kl >= 0 && J.right.slots) {
        st::put_edge(J.right, q + 1, eo);
        if (st::publishes(q, a->K, a->E)) st::publish(J.right, q + 2);
      } else if (kl >= 0 && J.out) {
        float* o = J.out + 4 * q;
        o[0] = eo.v.m;
        o[1] = eo.v.x;
        o[2] = eo.v.y;
        o[3] = eo.c;
      }
      st::thread_row_out<TB, L, GRID>(*a, J, t, q, i, th[t]);
    }
    ab = e.v;
    if (++q < a->K) return;
    for (int t = 0; t < NT; ++t) st::thread_end<MODE, L, GRID>(*a, J, t, th[t]);
    if (J.in) {
      J.above[0] = ab.m;
      J.above[1] = ab.x;
      J.above[2] = ab.y;
    }
  }
};

// A K12 / K13 launch (striped_fill.cu tile_kernel): `blocks` tiles in
// flight (0: every tile), taken by ticket as blocks free up, and each tile
// in flight advanced a row in turn, in ticket order, once its left
// neighbour's edges are published.  Returns 0, 2 if no tile can advance
// (the card would hang), 3 if a publication broke the fence rule.
template <int MODE, bool TB, int L, typename ST, bool GRID>
int twin_tiles(st::Launch& a, int blocks) {
  std::vector<int32_t> scratch(st::scratch_words(a.tiles, a.K), 0);
  st::set_scratch(&a, scratch.data());
  std::vector<int32_t> twin(3 * a.tiles, 0);
  std::vector<TwinTile<MODE, TB, L, ST, GRID>> run;
  const int64_t cap = blocks > 0 ? blocks : a.tiles;
  for (;;) {
    while ((int64_t)run.size() < cap && *a.ticket < a.tiles) {
      run.emplace_back();
      run.back().begin(a, (*a.ticket)++, twin.data());
    }
    if (run.empty()) break;
    bool moved = false;
    for (auto& tile : run) {
      if (!tile.ready()) continue;
      tile.row();
      moved = true;
    }
    if (!moved) return 2;
    run.erase(std::remove_if(run.begin(), run.end(),
                             [](const auto& tile) { return tile.done(); }),
              run.end());
  }
  for (int64_t k = 0; k < a.tiles; ++k)
    if (twin[3 * k + 2]) return 3;
  return 0;
}

template <bool TB, typename ST, bool GRID>
int twin_launch(int mode, st::Launch& a, int blocks) {
  auto lanes = [&](auto mode_c) {
    constexpr int M = decltype(mode_c)::value;
    if (a.L == 8) return twin_tiles<M, TB, 8, ST, GRID>(a, blocks);
    return twin_tiles<M, TB, 16, ST, GRID>(a, blocks);
  };
  switch (mode) {
    case sw::LOCAL:
      return lanes(std::integral_constant<int, sw::LOCAL>{});
    case sw::GLOCAL:
      return lanes(std::integral_constant<int, sw::GLOCAL>{});
    case sw::GLOBAL:
      return lanes(std::integral_constant<int, sw::GLOBAL>{});
    default:
      return 1;
  }
}


// K6's block as the twin runs it (sw_scores.cuh): every thread in turn
// between the block's barriers, every global read checked to lie in the
// codes' buffers, every window read checked to be a byte the current
// window's pieces brought (a window's landed bytes are dropped when the
// next window's staging begins), every store checked to lie in S and, for
// the 16-byte ones, to be 16-byte aligned.
struct ScoresExec {
  template <class F>
  void each(F&& f) {
    for (int tid = 0; tid < sw::scores::THREADS; ++tid) f(tid);
  }
};

struct ScoresMem {
  const uint8_t *c1, *c1_end, *c2, *c2_end;
  const uint8_t* win;
  int win_bytes;
  const float *S, *S_end;
  std::vector<uint8_t> landed;
  bool reading = false, broken = false;

  bool in(const void* p, int bytes, const uint8_t* lo, const uint8_t* hi) {
    const uint8_t* q = static_cast<const uint8_t*>(p);
    return q >= lo && q + bytes <= hi;
  }
  template <typename CODE>
  void land(CODE* dst) {
    if (reading) std::fill(landed.begin(), landed.end(), 0);
    reading = false;
    const int64_t at = reinterpret_cast<const uint8_t*>(dst) - win;
    if (at < 0 || at % 16 || at + 16 > win_bytes) {
      broken = true;
      return;
    }
    std::fill_n(landed.begin() + at, 16, 1);
  }
  template <typename CODE>
  void load16(CODE* dst, const CODE* src) {
    if (!in(src, 16, c2, c2_end) || (uintptr_t)src % 16) broken = true;
    land(dst);
    if (!broken) std::memcpy(dst, src, 16);
  }
  template <typename CODE>
  CODE load(const CODE* p) {
    if (in(p, sizeof(CODE), c1, c1_end) || in(p, sizeof(CODE), c2, c2_end))
      return *p;
    broken = true;
    return 0;
  }
  template <typename CODE>
  void put16(CODE* dst, const CODE* piece) {
    land(dst);
    if (!broken) std::memcpy(dst, piece, 16);
  }
  template <typename CODE>
  CODE code(const CODE* w, int j) {
    reading = true;
    const int64_t at = (int64_t)j * (int64_t)sizeof(CODE);
    if (at < 0 || at + (int64_t)sizeof(CODE) > win_bytes) {
      broken = true;
      return 0;
    }
    for (int k = 0; k < (int)sizeof(CODE); ++k)
      if (!landed[at + k]) broken = true;
    return broken ? 0 : w[j];
  }
  void store4(float* out, const float* v) {
    if (out < S || out + 4 > S_end || (out - S) % 4) {
      broken = true;
      return;
    }
    std::memcpy(out, v, 16);
  }
  void store1(float* out, float v) {
    if (out < S || out >= S_end) {
      broken = true;
      return;
    }
    *out = v;
  }
};

template <bool VEC, typename CODE>
int scores_all(const sw::scores::Args& a) {
  const int64_t cb = sizeof(CODE);
  std::vector<uint8_t> wmem(a.win_bytes + 16, 0);
  // the window 16-byte aligned, as the card's shared memory
  CODE* win = reinterpret_cast<CODE*>(
      wmem.data() + ((16 - ((uintptr_t)wmem.data() & 15)) & 15));
  std::vector<int> offs(a.T), rbase(a.T);
  ScoresMem mem;
  mem.c1 = static_cast<const uint8_t*>(a.codes1);
  mem.c1_end = mem.c1 + a.B * a.NP * cb;
  mem.c2 = static_cast<const uint8_t*>(a.codes2);
  mem.c2_end = mem.c2 + a.B * a.MP * cb;
  mem.win = reinterpret_cast<const uint8_t*>(win);
  mem.win_bytes = a.win_bytes;
  mem.S = a.S;
  mem.S_end = a.S + a.B * a.NP * a.W;
  mem.landed.assign(a.win_bytes, 0);
  ScoresExec ex;
  for (int64_t t = 0; t < a.B * a.tiles && !mem.broken; ++t)
    sw::scores::run_tile<VEC, CODE>(ex, mem, a, a.table, t, win,
                                    offs.data(), rbase.data());
  return mem.broken ? 3 : 0;
}

}  // namespace

extern "C" {

// Same arguments and layout as sw_fill_launch (fill.cu), host pointers,
// pairs 0 .. B-1 in order, NW warps a pair, no stream.  Returns 0, 1 for
// an unknown mode, R or code width, or 3 if a seed row access between a
// pair's warps is not ordered by the card's barriers.
int sw_twin_fill(int mode, int traceback, int R, int NW, const float* table,
                 int K, int code_bytes, const void* codes1,
                 const void* codes2, const int64_t* desc, int64_t B,
                 uint8_t* tb, uint8_t* run, float* carry, float* stats,
                 float og, float eg) {
  if ((run && !traceback) || NW < 1) return 1;
  int rc = 1;
  if (with_codes(code_bytes, codes1, codes2, [&](auto c1, auto c2) {
        using CODE = std::remove_const_t<std::remove_pointer_t<decltype(c1)>>;
        rc = dispatch(mode, R,
                      FillRun<CODE>{table, K, c1, c2, desc, B, traceback, tb,
                                    run, carry, stats, og, eg, NW});
      }))
    return 1;
  return rc;
}

// Same arguments and layout as sw_diag_fill_launch (diag_fill.cu), host
// pointers.  Returns 0, 1 for an unknown R or code width, or 3 if a lane 0
// read an edge row its strip's last lane had written, or one the previous
// strip had not.
int sw_twin_diag_fill(int R, const float* table, int K, int code_bytes,
                      const void* codes1, const void* codes2,
                      const int64_t* desc, int64_t B, float* scratch,
                      float* stats, float og, float eg) {
  bool broken = false;
  auto run = [&](auto c1, auto c2, auto r) {
    constexpr int RR = decltype(r)::value;
    for (int64_t b = 0; b < B; ++b) {
      const int64_t* d = desc + b * sw::DESC_W;
      float* st = stats + b * sw::STATS_W;
      for (int q = 0; q < sw::STATS_W; ++q) st[q] = 0.0f;
      st[0] = diag_pair<std::remove_const_t<std::remove_pointer_t<
                            decltype(c1)>>, RR>(
          table, K, c1 + d[sw::D_OFF1], c2 + d[sw::D_OFF2], (int)d[sw::D_N],
          (int)d[sw::D_M], scratch + d[sw::D_CARRY], og, eg, &broken);
    }
  };
  int bad = 0;
  if (with_codes(code_bytes, codes1, codes2, [&](auto c1, auto c2) {
        switch (R) {
          case 2: run(c1, c2, std::integral_constant<int, 2>{}); break;
          case 4: run(c1, c2, std::integral_constant<int, 4>{}); break;
          case 8: run(c1, c2, std::integral_constant<int, 8>{}); break;
          default: bad = 1;
        }
      }))
    return 1;
  return bad ? 1 : (broken ? 3 : 0);
}

// Same arguments and layout as sw_walk_tokens_launch (token_walk.cu), host
// pointers, no stream.  Returns tile_walks' codes.
int sw_twin_walk_tokens(int local, const uint8_t* tb, const uint8_t* run,
                        const int64_t* desc, const float* stats,
                        const int32_t* order, int64_t B, int64_t L, int T,
                        int C, int32_t* cnt, uint8_t* toks) {
  const uint8_t* pools[2] = {tb, run};
  return tile_walks<2>(local, pools, desc, stats, order, B, L, cnt, toks, T,
                       C);
}

// Same arguments and layout as sw_walk_launch (walk.cu), host pointers, no
// stream.  Returns tile_walks' codes.
int sw_twin_walk(int local, const uint8_t* tb, const int64_t* desc,
                 const float* stats, const int32_t* order, int64_t B,
                 int64_t L, int T, int C, int32_t* cnt, uint8_t* moves) {
  const uint8_t* pools[1] = {tb};
  return tile_walks<1>(local, pools, desc, stats, order, B, L, cnt, moves, T,
                       C);
}

// Same arguments and layout as sw_ckpt_fill_launch (longseq_fill.cu), host
// pointers, C a power of two up to 256 (below 32, one warp of C lanes with
// rows).  Returns 0, 1 for an unknown mode, C or code width, 2 if no band
// could advance (the card would hang) or 3 if a ring access between a
// band's warps is not ordered by the card's barriers.
int sw_twin_ckpt_fill(int mode, const float* table, int K, int code_bytes,
                      const void* codes1, const void* codes2,
                      const int32_t* n, const int32_t* m, int64_t B,
                      int64_t NP, int64_t MP, int C, float* ckm, float* ckx,
                      float* cky, float* stats, int32_t* scratch, float og,
                      float eg) {
  if (!twin_c(C)) return 1;
  int rc = 1;
  if (with_codes(code_bytes, codes1, codes2, [&](auto c1, auto c2) {
        using CODE = std::remove_const_t<std::remove_pointer_t<decltype(c1)>>;
        rc = dispatch(mode, twin_r(C),
                      CkptRun<CODE>{table, K, c1, c2, n, m, B, NP, MP, C, ckm,
                                    ckx, cky, stats, scratch, og, eg});
      }))
    return 1;
  return rc;
}

// Same arguments and layout as sw_band_fill_launch (longseq_fill.cu), host
// pointers, C as for sw_twin_ckpt_fill.  Same return convention.
int sw_twin_band_fill(int mode, const float* table, int K, int code_bytes,
                      const void* codes1, const void* codes2,
                      const int32_t* n, const int32_t* m, int64_t B,
                      int64_t NP, int64_t MP, int C, int sk0, int G,
                      const float* ckm, const float* ckx, const float* cky,
                      uint8_t* band, float og, float eg) {
  if (!twin_c(C)) return 1;
  const int64_t NCK = (NP + C - 1) / C;
  if (sk0 < 0 || G < 1 || sk0 + G > NCK) return 1;
  int rc = 1;
  if (with_codes(code_bytes, codes1, codes2, [&](auto c1, auto c2) {
        using CODE = std::remove_const_t<std::remove_pointer_t<decltype(c1)>>;
        rc = dispatch(mode, 1,
                      BandRun<CODE>{table, K, c1, c2, n, m, B, NP, MP, C, sk0,
                                    G, ckm, ckx, cky, band, og, eg});
      }))
    return 1;
  return rc;
}

// Same arguments and layout as sw_seg_walk_launch (seg_walk.cu), host
// pointers, each pair's windows D diagonals (0: the card's,
// sw::window_units).  Returns 0, 1 for arguments the kernel does not
// take, or 3 if the walk read a byte no finished window copy had brought.
int sw_twin_seg_walk(int local, const uint8_t* bands, int G, int64_t B,
                     int64_t MP, int C, int sk0, int64_t L, int32_t* walk,
                     int32_t* cnt, uint8_t* moves, int D) {
  if (B <= 0 || L <= 0 || C <= 0 || sk0 < 0 || G < 1 || D == 1 || D < 0)
    return 1;
  if (D == 0) D = sw::window_units(C);
  const int64_t L4 = (L + 3) / 4;
  const int64_t bb = sw::band_bytes(C, MP);
  TwinWindows tw(sw::window_slot_bytes(D, C, false));
  for (int64_t b = 0; b < B; ++b) {
    sw::SegState st = sw::seg_load(walk + b * 4, cnt + b, moves + b, B);
    for (int g = G - 1; g >= 0; --g) {
      auto win = sw::seg_windows(bands + (g * B + b) * bb, C, MP, D, tw.buf,
                                 TwinCopy{&tw});
      sw::walk_segment(local != 0, win, (sk0 + g) * C, L, &st, moves + b, B,
                       L4);
      win.close();
      if (tw.broken) return 3;
    }
    sw::seg_store(st, walk + b * 4, cnt + b, moves + b, B, L4);
  }
  return 0;
}

// Same arguments and layout as sw_banded_fill_launch (banded_fill.cu), host
// pointers, no stream, the scratch the twin's own; `blocks` stripes in
// flight (0: all).  Returns 0, 1 for arguments the kernel does not take, 2
// if the launch would hang, 3 if a tile publication is not fenced.
int sw_twin_banded_fill(int mode, const float* S, const int32_t* n,
                        const int32_t* m, int64_t B, int64_t NP, int W,
                        uint8_t* tb, float* stats, float og, float eg,
                        int blocks) {
  if (B <= 0 || NP <= 0 || W <= 0 || W % 4) return 1;
  switch (mode) {
    case sw::LOCAL:
      return banded_all<sw::LOCAL>(S, n, m, B, NP, W, tb, stats, og, eg,
                                   blocks);
    case sw::GLOCAL:
      return banded_all<sw::GLOCAL>(S, n, m, B, NP, W, tb, stats, og, eg,
                                    blocks);
    case sw::GLOBAL:
      return banded_all<sw::GLOBAL>(S, n, m, B, NP, W, tb, stats, og, eg,
                                    blocks);
    default:
      return 1;
  }
}

// Same arguments and layout as sw_banded_walk_launch (banded_walk.cu),
// host pointers, no stream, each pair's rows read through windows of D
// rows (0: the card's, sw::banded::walk_rows) or straight (D = -1).
// Returns 0, 1 for arguments the kernel does not take or a ring past its
// shared memory, or 3 if the walk read a byte or an offset no finished
// window copy had brought.
int sw_twin_banded_walk(int local, const uint8_t* tb, const int32_t* off,
                        const int32_t* start, const int32_t* m, int64_t B,
                        int64_t NP, int W, int64_t L, int D, int32_t* idx1,
                        int32_t* idx2, int32_t* cnt, int32_t* flags) {
  if (B <= 0 || NP <= 0 || W <= 0 || L <= 0 || D == 1 || D < -1) return 1;
  if (D == 0) D = sw::banded::walk_rows(W);
  if (D > 0 && sw::WINDOWS * sw::window_slot_bytes(D, W, true) >
                   sw::banded::WALK_SMEM)
    return 1;
  TwinWindows tw(D > 0 ? sw::window_slot_bytes(D, W, true) : 0);
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t q = 0; q < L; ++q) idx1[b * L + q] = idx2[b * L + q] = -2;
    const uint8_t* rows = tb + b * NP * W;
    const int32_t* o = off + b * (NP + 1);
    auto walk = [&](auto& r) {
      sw::banded::walk_pair(local != 0, r, (int)NP, W, m[b], start + 4 * b,
                            L, idx1 + b * L, idx2 + b * L, cnt + b,
                            flags + b);
      r.close();
    };
    if (D > 0) {
      auto win = sw::banded::row_windows(rows, W, (int)NP, o, D, tw.buf,
                                         TwinCopy{&tw});
      walk(win);
      if (tw.broken) return 3;
    } else {
      sw::banded::DirectRows direct{rows, o + 1, W};
      walk(direct);
    }
  }
  return 0;
}

// sw_banded_walk_rows (banded_walk.cu): K8's rows a window for a band of W
// bytes a row, 0 for straight reads.
int sw_twin_banded_walk_rows(int W) {
  return W > 0 ? sw::banded::walk_rows(W) : 0;
}

// Same arguments and layout as sw_striped_block_launch (striped_fill.cu),
// host pointers, no stream, the scratch the twin's own; `blocks` tiles in
// flight (0: all).  Returns 0, 1 for arguments the kernel does not take, 2
// if the launch would hang, 3 if an edge publication is not fenced.
int sw_twin_striped_block(int mode, int emit_tb, const int32_t* ds, int nds,
                          int t, int i0, int K, int W, int D, int64_t B,
                          int64_t MP, const float* S, int64_t s_b,
                          int64_t s_r, int64_t s_lo, const int32_t* n,
                          const int32_t* m, float* rows, float* box,
                          float* above, float* best, int32_t* best_i,
                          float* acc, uint8_t* tb, int64_t tb_rows, float og,
                          float eg, float so, float se, float sent,
                          float sose, int L, int E, int blocks) {
  st::Launch a;
  if (!st::block_launch(&a, emit_tb, ds, nds, t, i0, K, W, D, B, MP, S, s_b,
                        s_r, s_lo, n, m, rows, box, above, best, best_i, acc,
                        tb, tb_rows, st::Pen{og, eg, so, se, sent, sose}, L,
                        E))
    return 1;
  return emit_tb ? twin_launch<true, float, false>(mode, a, blocks)
                 : twin_launch<false, float, false>(mode, a, blocks);
}

// Same arguments and layout as sw_striped_grid_launch (striped_fill.cu),
// host pointers, no stream, the scratch the twin's own; `blocks` and the
// return as sw_twin_striped_block's.
int sw_twin_striped_grid(int mode, int s_int8, const void* S, int64_t B,
                         int64_t NP, int64_t MP, const int32_t* n,
                         const int32_t* m, int C, float* best,
                         int32_t* best_i, float* acc, float* ckm, float* ckx,
                         float* cky, float og, float eg, float so, float se,
                         float sent, float sose, int L, int E, int blocks) {
  st::Launch a;
  if (!st::grid_launch(&a, S, B, NP, MP, n, m, C, best, best_i, acc, ckm, ckx,
                       cky, st::Pen{og, eg, so, se, sent, sose}, L, E))
    return 1;
  return s_int8 ? twin_launch<false, int8_t, true>(mode, a, blocks)
                : twin_launch<false, float, true>(mode, a, blocks);
}


// Same arguments and layout as sw_banded_scores_launch (banded_scores.cu),
// host pointers, no stream, the tiles in order (they are independent), 16-
// or 4-byte stores as `vec` says (1 needs W % 4 == 0), and a window of
// win_bytes bytes taking chunks of `chunk` columns (0, 0: the card's
// WIN_BYTES and CHUNK_COLS).  Returns 0, 1 for arguments the kernel does
// not take, 3 for a read outside the codes or of a window byte no piece of
// the current window brought, or a store outside S or misaligned.
int sw_twin_banded_scores(const float* table, int K, int code_bytes,
                          const void* codes1, const void* codes2,
                          const int32_t* n, const int32_t* m, int64_t B,
                          int64_t NP, int64_t MP, int W, float* S, int T,
                          int vec, int win_bytes, int chunk) {
  if (win_bytes == 0 && chunk == 0) {
    win_bytes = sw::scores::WIN_BYTES;
    chunk = sw::scores::CHUNK_COLS;
  }
  if (B <= 0 || NP <= 0 || MP <= 0 || W <= 0 || K <= 0 ||
      (code_bytes != 1 && code_bytes != 2) || T < 1 ||
      T > sw::scores::MAX_TILE || (vec && W % 4) ||
      !sw::scores::window_fits(win_bytes, chunk, code_bytes))
    return 1;
  const sw::scores::Args a{table, K, codes1, codes2, n, m, B, NP, MP, W, S,
                           T, win_bytes, chunk, sw::scores::tiles_of(NP, T)};
  if (code_bytes == 1)
    return vec ? scores_all<true, uint8_t>(a) : scores_all<false, uint8_t>(a);
  return vec ? scores_all<true, int16_t>(a) : scores_all<false, int16_t>(a);
}

}  // extern "C"
