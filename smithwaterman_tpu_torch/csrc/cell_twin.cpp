// Host twin of the GPU kernels K1 (fill.cu) and K2 (walk.cu).
//
// It includes the kernels' own headers and runs them over a batch in the
// kernels' loop order, one pair after another, with the same per-pair
// descriptors and memory layout.  The tier-1 tests hold its outputs
// against the JAX package (ops/scan_dp.py, ops/device_walk.py), which is
// the only check of the card's cell code that runs without a card.
// Build: g++ -O2 -fPIC -std=c++17 -shared -ffp-contract=off.
#include <cstdint>

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

}  // extern "C"
