// K9: the anti-diagonal (wavefront) LOCAL score-only fill, one warp per
// pair, R columns a lane.
//
// Replaces: smithwaterman_tpu/ops/diag_dp.py _diag_kernel (:130) as called
// by fill_diag_skewed (:291) through fill_diag_scores (:258), together with
// the skewed score tensor skew_scores (:105) that fed it.
//
// What bounds it on an H100: the dependency chain of a strip's steps.
// Within a strip a step needs the step before (one lane to the left), so a
// pair of n x m cells takes ceil(m / (32 R)) strips of n + 31 dependent
// steps.  Bytes are negligible: the codes once, a stats row, and an edge
// scratch of 8 bytes a row per strip (L1/L2).
//
// What the design does about it: the 32 lanes of a warp work on one pair,
// R consecutive columns a lane (sw_diag.cuh), so a strip is 32 R columns
// wide and a pair takes R times fewer steps.  A step's fixed cost is paid
// once for the lane's R cells: one __shfl_up_sync each of the left lane's
// last-column fx, its last-column W and the row code, and lane 0's feed
// from shared memory (the previous strip's last column, W and fx, and the
// row's code, staged 32 rows at a time with one coalesced load by the
// warp).  The lane's R column codes sit in registers for the strip, so its
// R scores are independent shared-memory reads of the row's table line
// (device memory past sw::SMEM_K symbols: the STAB template parameter;
// codes uint8, or int16 past 255 symbols: CODE).  Inside the lane X runs
// in registers from cell to cell, every maximum one FMNMX.  A strip's
// steps where every lane's row lies in the pair and every column is live
// (the body) test neither the top boundary nor the live columns.  The
// strip's last lane stores its last column's W and fx a row a step into
// the pair's edge scratch; the next strip's lane 0 reads the row back,
// after a __syncwarp.  The score-only
// LOCAL fill keeps no pointer and no argmax, only a maximum, which is the
// same in any order: the best is a warp maximum at the end.  A flush of a
// few thousand pairs fills the card with warps (3200 pairs: 3200 warps).
// The TPU kernel's edge rings and their slot groups are Mosaic layout and
// are not carried over.
#include <cuda_runtime.h>

#include "sw_diag.cuh"

namespace {

namespace dg = sw::diag;

constexpr int kWarps = 4;  // pairs a block
constexpr unsigned kFull = 0xffffffffu;

// A warp's stage of lane 0's feed: LANES rows of code, edge W and fx.
struct Stage {
  int code[dg::LANES];
  float w[dg::LANES];
  float x[dg::LANES];
};

template <typename CODE, int R, bool STAB>
__global__ void __launch_bounds__(kWarps * dg::LANES)
    diag_kernel(const float* __restrict__ table, int K,
                const CODE* __restrict__ codes1,
                const CODE* __restrict__ codes2,
                const int64_t* __restrict__ desc, int64_t B, float* scratch,
                float* stats, float og, float eg) {
  // STAB: the (K, K) table copied into shared memory (block_table; K is
  // within sw::SMEM_K there), then the warps' stages; else the stages
  // alone and the table read from device memory.  The reads name smem
  // itself: through block_table's returned pointer, which may point to
  // either memory, the kernel took 1.27-1.28 ms on an H100 at phase 12b's
  // flush against 1.13-1.14 (PERF.md)
  extern __shared__ __align__(16) float smem[];
  if (STAB) sw::block_table(table, K, smem);
  const float* tab = STAB ? smem : table;
  Stage* stage = reinterpret_cast<Stage*>(smem + (STAB ? K * K : 0)) +
                 threadIdx.x / dg::LANES;
  const int lane = threadIdx.x % dg::LANES;
  const int64_t b = (int64_t)blockIdx.x * kWarps + threadIdx.x / dg::LANES;
  if (b >= B) return;  // the whole warp: b is the warp's
  const int64_t* dd = desc + b * sw::DESC_W;
  const CODE* c1 = codes1 + dd[sw::D_OFF1];
  const CODE* c2 = codes2 + dd[sw::D_OFF2];
  const int n = (int)dd[sw::D_N], m = (int)dd[sw::D_M];
  float* edge = scratch + dd[sw::D_CARRY];
  float best = 0.0f;
  for (int c0 = 0; c0 < m; c0 += dg::strip_cols<R>()) {
    const int live = dg::live_cols<R>(m, c0, lane);
    int cc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) cc[k] = k < live ? c2[c0 + lane * R + k] : 0;
    dg::Lane<R> L = dg::lane_begin<R>();
    int code1 = 0;
    // one step d of the strip; body: the BODY variant (sw_diag.cuh)
    auto one = [&](int d, auto body) {
      constexpr bool BODY = decltype(body)::value;
      if (dg::stages(d)) {
        const dg::Feed f =
            dg::feed_row(c1, edge, n, c0, dg::stage_row(d, lane));
        __syncwarp();  // lane 0 has read the stage's last rows
        stage->code[lane] = f.code;
        stage->w[lane] = f.w;
        stage->x[lane] = f.x;
        __syncwarp();
      }
      const int q = d % dg::LANES;
      const float xs = __shfl_up_sync(kFull, L.xr, 1);
      const float ws = __shfl_up_sync(kFull, L.w1[R - 1], 1);
      const int cs = __shfl_up_sync(kFull, code1, 1);
      const int fc = stage->code[q];  // one address: a broadcast
      const float fw = stage->w[q], fx = stage->x[q];
      code1 = lane ? cs : fc;
      const int row = code1 * K;
      float s[R];
#pragma unroll
      for (int k = 0; k < R; ++k)
        s[k] = STAB ? tab[row + cc[k]] : __ldg(tab + row + cc[k]);
      const int r = d - lane;
      dg::step<R, BODY>(&L, s, lane ? xs : fx, lane ? ws : fw, r < 0,
                        r >= 0 && r < n ? live : 0, og, eg);
      const int er = dg::edge_row(d);  // r on the last lane
      if (lane == dg::LANES - 1 && dg::keeps_edge<R>(n, m, c0, er)) {
        edge[2 * (int64_t)er] = L.w1[R - 1];
        edge[2 * (int64_t)er + 1] = L.xr;
      }
    };
    const int steps = dg::strip_steps<R>(n, m, c0);
    int d0, d1;
    dg::body_steps<R>(n, m, c0, steps, &d0, &d1);
    for (int d = 0; d < d0; ++d) one(d, dg::Flag<false>{});
    for (int d = d0; d < d1; ++d) one(d, dg::Flag<true>{});
    for (int d = d1; d < steps; ++d) one(d, dg::Flag<false>{});
    best = sw::mx(best, L.best);
    __syncwarp();  // the edge rows written above, before the next strip reads
  }
  for (int o = dg::LANES / 2; o > 0; o /= 2)
    best = sw::mx(best, __shfl_xor_sync(kFull, best, o));
  if (lane < sw::STATS_W) stats[b * sw::STATS_W + lane] = lane ? 0.0f : best;
}

// int16 codes come with tables past 255 symbols (ops/batch.code_dtype),
// never copied into shared memory: their kernels are built without it
template <typename CODE, int R>
void launch(const float* table, int K, const void* codes1,
            const void* codes2, const int64_t* desc, int64_t B,
            float* scratch, float* stats, float og, float eg,
            cudaStream_t st) {
  constexpr bool U8 = sizeof(CODE) == 1;
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  const bool stab = U8 && K <= sw::SMEM_K;
  const size_t smem = (stab ? sw::table_smem(K) : 0) + kWarps * sizeof(Stage);
  if (stab)
    diag_kernel<CODE, R, U8><<<grid, kWarps * dg::LANES, smem, st>>>(
        table, K, (const CODE*)codes1, (const CODE*)codes2, desc, B, scratch,
        stats, og, eg);
  else
    diag_kernel<CODE, R, false><<<grid, kWarps * dg::LANES, smem, st>>>(
        table, K, (const CODE*)codes1, (const CODE*)codes2, desc, B, scratch,
        stats, og, eg);
}

template <typename CODE>
int launch_r(int R, const float* table, int K, const void* codes1,
             const void* codes2, const int64_t* desc, int64_t B,
             float* scratch, float* stats, float og, float eg,
             cudaStream_t st) {
  switch (R) {
    case 2:
      launch<CODE, 2>(table, K, codes1, codes2, desc, B, scratch, stats, og,
                      eg, st);
      return 0;
    case 4:
      launch<CODE, 4>(table, K, codes1, codes2, desc, B, scratch, stats, og,
                      eg, st);
      return 0;
    case 8:
      launch<CODE, 8>(table, K, codes1, codes2, desc, B, scratch, stats, og,
                      eg, st);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

extern "C" {

// Launches K9 on `stream` over B pairs described by desc (B, 8) int64 (the
// fill's layout: codes offsets, n, m; D_CARRY the offset in floats of the
// pair's edge scratch, 2 * n floats), R columns a lane (2, 4 or 8).
// table: (K, K) f32; codes: flat buffers of code_bytes-wide codes (1:
// uint8, 2: int16), each below K; stats: (B, 8) f32, written [best, 0,
// ...].  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take (og <= eg
// <= 0 is the caller's to check).
int sw_diag_fill_launch(int R, const float* table, int K, int code_bytes,
                        const void* codes1, const void* codes2,
                        const int64_t* desc, int64_t B, float* scratch,
                        float* stats, float og, float eg, void* stream) {
  if (B <= 0 || K <= 0 || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int bad =
      code_bytes == 1
          ? launch_r<uint8_t>(R, table, K, codes1, codes2, desc, B, scratch,
                              stats, og, eg, st)
          : launch_r<int16_t>(R, table, K, codes1, codes2, desc, B, scratch,
                              stats, og, eg, st);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
