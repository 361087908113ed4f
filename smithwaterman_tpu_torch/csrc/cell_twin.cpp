// Host twin of the GPU kernels K1 (fill.cu), K2 (walk.cu), K3 and K4
// (longseq_fill.cu) and K5 (seg_walk.cu).
//
// It includes the kernels' own headers and runs them over a batch in the
// kernels' loop order, one pair after another, with the same per-pair
// descriptors and memory layout.  For K3 and K4 it runs the band
// wavefront's per-thread functions (sw_band.cuh) for every thread of a
// block at each step, where the card runs them in parallel with a barrier
// after each step.  The tier-1 tests hold its outputs against the JAX
// package (ops/scan_dp.py, ops/device_walk.py, ops/longseq.py), which is
// the only check of the card's cell code that runs without a card.
// Build: g++ -O2 -fPIC -std=c++17 -ffp-contract=off -c, then g++ -shared.
#include <cstdint>
#include <vector>

#include "sw_band.cuh"
#include "sw_cell.cuh"
#include "sw_walk.cuh"

namespace {

template <int MODE, bool TB>
void fill_all(const float* table, int K, const uint8_t* codes1,
              const uint8_t* codes2, const int64_t* desc, int64_t B,
              uint8_t* tb, float* carry, float* stats, float og, float eg) {
  for (int64_t b = 0; b < B; ++b) {
    const int64_t* d = desc + b * sw::DESC_W;
    sw::fill_pair<MODE, TB>(table, K, codes1 + d[sw::D_OFF1],
                            codes2 + d[sw::D_OFF2], (int)d[sw::D_N],
                            (int)d[sw::D_M], TB ? tb + d[sw::D_TB] : nullptr,
                            d[sw::D_RS], d[sw::D_CS], carry + d[sw::D_CARRY],
                            3 * d[sw::D_CS], og, eg, stats + b * sw::STATS_W);
  }
}

template <int MODE>
void fill_mode(int traceback, const float* table, int K,
               const uint8_t* codes1, const uint8_t* codes2,
               const int64_t* desc, int64_t B, uint8_t* tb, float* carry,
               float* stats, float og, float eg) {
  if (traceback)
    fill_all<MODE, true>(table, K, codes1, codes2, desc, B, tb, carry, stats,
                         og, eg);
  else
    fill_all<MODE, false>(table, K, codes1, codes2, desc, B, tb, carry,
                          stats, og, eg);
}

// One band of one pair as a block of C threads would run it.
template <int MODE>
void run_band(int C, const sw::BandIO& io, const sw::Pen& p, sw::Best* best) {
  std::vector<sw::Cell> up(2 * C), seed(2 * C);
  std::vector<uint8_t> code(4 * C);
  const sw::BandSmem sm{up.data(), seed.data(), code.data()};
  std::vector<sw::Lane> lanes;
  for (int t = 0; t < C; ++t) {
    lanes.push_back(sw::lane_begin<MODE>(t, C, io, p));
    sw::tile_put(t, C, 0, lanes[t], sm);
  }
  const int steps = sw::band_steps(C, io);
  for (int k = 0; k < steps; ++k)
    for (int t = 0; t < C; ++t)
      sw::band_step<MODE>(t, C, k, io, p, &lanes[t], sm,
                          best ? best + t : nullptr);
}

sw::BandIO pair_io(const float* table, int K, const uint8_t* codes1,
                   const uint8_t* codes2, const int32_t* n, const int32_t* m,
                   int64_t b, int64_t NP, int64_t MP) {
  sw::BandIO io{};
  io.tab = table;
  io.K = K;
  io.c1 = codes1 + b * NP;
  io.c2 = codes2 + b * MP;
  io.n = n[b];
  io.m = m[b];
  return io;
}

template <int MODE>
void ckpt_all(const float* table, int K, const uint8_t* codes1,
              const uint8_t* codes2, const int32_t* n, const int32_t* m,
              int64_t B, int64_t NP, int64_t MP, int C, float* ckm,
              float* ckx, float* cky, float* stats, float og, float eg) {
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int64_t NCK = (NP + C - 1) / C;
  for (int64_t b = 0; b < B; ++b) {
    float* st = stats + b * sw::STATS_W;
    for (int q = 0; q < sw::STATS_W; ++q) st[q] = 0.0f;
    sw::BandIO io = pair_io(table, K, codes1, codes2, n, m, b, NP, MP);
    io.fin = MODE == sw::LOCAL ? nullptr : st + 3;
    std::vector<sw::Best> best(C, sw::no_best());
    for (int kb = 0; kb * C < io.n; ++kb) {
      io.base = kb * C;
      const int64_t prev = (b * NCK + kb - 1) * MP, row = (b * NCK + kb) * MP;
      io.seed_m = kb ? ckm + prev : nullptr;
      io.seed_x = kb ? ckx + prev : nullptr;
      io.seed_y = kb ? cky + prev : nullptr;
      io.out_m = ckm + row;
      io.out_x = ckx + row;
      io.out_y = cky + row;
      run_band<MODE>(C, io, p, best.data());
    }
    sw::finish_stats(MODE == sw::LOCAL, best.data(), C, st);
  }
}

template <int MODE>
void band_all(const float* table, int K, const uint8_t* codes1,
              const uint8_t* codes2, const int32_t* n, const int32_t* m,
              int64_t B, int64_t NP, int64_t MP, int C, int sk,
              const float* ckm, const float* ckx, const float* cky,
              uint8_t* band, float og, float eg) {
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int64_t NCK = (NP + C - 1) / C;
  const int base = sk * C;
  for (int64_t b = 0; b < B; ++b) {
    if (base >= n[b]) continue;
    sw::BandIO io = pair_io(table, K, codes1, codes2, n, m, b, NP, MP);
    io.base = base;
    const int64_t prev = (b * NCK + sk - 1) * MP;
    io.seed_m = sk ? ckm + prev : nullptr;
    io.seed_x = sk ? ckx + prev : nullptr;
    io.seed_y = sk ? cky + prev : nullptr;
    io.tb = band + b * sw::band_bytes(C, MP);
    run_band<MODE>(C, io, p, nullptr);
  }
}

}  // namespace

extern "C" {

// Same arguments and layout as sw_fill_launch (fill.cu), host pointers,
// no stream.  Returns 0, or 1 for an unknown mode.
int sw_twin_fill(int mode, int traceback, const float* table, int K,
                 const uint8_t* codes1, const uint8_t* codes2,
                 const int64_t* desc, int64_t B, uint8_t* tb, float* carry,
                 float* stats, float og, float eg) {
  switch (mode) {
    case sw::LOCAL:
      fill_mode<sw::LOCAL>(traceback, table, K, codes1, codes2, desc, B, tb,
                           carry, stats, og, eg);
      return 0;
    case sw::GLOCAL:
      fill_mode<sw::GLOCAL>(traceback, table, K, codes1, codes2, desc, B, tb,
                            carry, stats, og, eg);
      return 0;
    case sw::GLOBAL:
      fill_mode<sw::GLOBAL>(traceback, table, K, codes1, codes2, desc, B, tb,
                            carry, stats, og, eg);
      return 0;
    default:
      return 1;
  }
}

// Same arguments and layout as sw_walk_launch (walk.cu), host pointers.
int sw_twin_walk(int local, const uint8_t* tb, const int64_t* desc,
                 const float* stats, int64_t B, int64_t L, int32_t* cnt,
                 uint8_t* moves) {
  for (int64_t b = 0; b < B; ++b) {
    const int64_t* d = desc + b * sw::DESC_W;
    cnt[b] = sw::walk_pair(local != 0, tb + d[sw::D_TB], d[sw::D_RS],
                           d[sw::D_CS], (int)d[sw::D_N], (int)d[sw::D_M],
                           stats + b * sw::STATS_W, L, moves + b, B);
  }
  return 0;
}

// Same arguments and layout as sw_ckpt_fill_launch (longseq_fill.cu), host
// pointers.  Returns 0, or 1 for an unknown mode.
int sw_twin_ckpt_fill(int mode, const float* table, int K,
                      const uint8_t* codes1, const uint8_t* codes2,
                      const int32_t* n, const int32_t* m, int64_t B,
                      int64_t NP, int64_t MP, int C, float* ckm, float* ckx,
                      float* cky, float* stats, float og, float eg) {
  switch (mode) {
    case sw::LOCAL:
      ckpt_all<sw::LOCAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, ckm,
                          ckx, cky, stats, og, eg);
      return 0;
    case sw::GLOCAL:
      ckpt_all<sw::GLOCAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, ckm,
                           ckx, cky, stats, og, eg);
      return 0;
    case sw::GLOBAL:
      ckpt_all<sw::GLOBAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, ckm,
                           ckx, cky, stats, og, eg);
      return 0;
    default:
      return 1;
  }
}

// Same arguments and layout as sw_band_fill_launch (longseq_fill.cu).
int sw_twin_band_fill(int mode, const float* table, int K,
                      const uint8_t* codes1, const uint8_t* codes2,
                      const int32_t* n, const int32_t* m, int64_t B,
                      int64_t NP, int64_t MP, int C, int sk,
                      const float* ckm, const float* ckx, const float* cky,
                      uint8_t* band, float og, float eg) {
  switch (mode) {
    case sw::LOCAL:
      band_all<sw::LOCAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, sk,
                          ckm, ckx, cky, band, og, eg);
      return 0;
    case sw::GLOCAL:
      band_all<sw::GLOCAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, sk,
                           ckm, ckx, cky, band, og, eg);
      return 0;
    case sw::GLOBAL:
      band_all<sw::GLOBAL>(table, K, codes1, codes2, n, m, B, NP, MP, C, sk,
                           ckm, ckx, cky, band, og, eg);
      return 0;
    default:
      return 1;
  }
}

// Same arguments and layout as sw_seg_walk_launch (seg_walk.cu).
int sw_twin_seg_walk(int local, const uint8_t* band, int64_t B, int64_t MP,
                     int C, int sk, int64_t L, int32_t* walk, int32_t* cnt,
                     uint8_t* moves) {
  for (int64_t b = 0; b < B; ++b)
    sw::walk_segment(local != 0, band + b * sw::band_bytes(C, MP), C + 1, C,
                     sk * C, L, walk + b * 4, cnt + b, moves + b, B,
                     (L + 3) / 4);
  return 0;
}

}  // extern "C"
