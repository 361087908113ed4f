// K9: the anti-diagonal (wavefront) LOCAL score-only fill, one warp per
// pair.
//
// Replaces: smithwaterman_tpu/ops/diag_dp.py _diag_kernel (:130) as called
// by fill_diag_skewed (:291) through fill_diag_scores (:258), together with
// the skewed score tensor skew_scores (:105) that fed it.
//
// What bounds it on an H100: the dependency chain of a strip's steps.
// Within a strip a step needs the step before (one lane to the left), so a
// pair of n x m cells takes ceil(m / 32) strips of n + 31 dependent steps,
// each a few f32 adds and maxima (sw_diag.cuh), three warp shuffles and a
// shared-memory score lookup.  Bytes are negligible: the codes once, a
// stats row, and an edge scratch of 8 bytes a row per strip (L1/L2).
//
// What the design does about it: the 32 lanes of a warp work on 32 cells
// of one pair at each step, so a flush of a few thousand pairs fills the
// card with warps (3200 pairs: 3200 warps).  The score-only LOCAL fill
// keeps no pointer and no argmax, only a maximum, which is the same in any
// order.  The one-lane shift of the JAX kernel is
// __shfl_up_sync; lane 0 takes the previous strip's last column from a
// per-pair scratch (row r's W and fx at 8 bytes), written by lane 31 and
// read back by lane 0 in the next strip.  The codes of seq1 and the edge
// are loaded 32 rows at a time, one per lane, and handed to lane 0 by
// shuffles; the score comes from a shared-memory copy of the (K, K) table
// (device memory past sw::SMEM_K symbols; codes uint8, or int16 past 255
// symbols: the CODE template parameter), so no skewed score tensor is
// built.  The best is a warp maximum at the
// end.  The TPU kernel's edge rings and their slot groups are Mosaic
// layout and are not carried over.
#include <cuda_runtime.h>

#include "sw_diag.cuh"

namespace {

namespace dg = sw::diag;

constexpr int kWarps = 4;  // pairs a block
constexpr unsigned kFull = 0xffffffffu;

template <typename CODE>
__global__ void __launch_bounds__(kWarps * dg::LANES)
    diag_kernel(const float* __restrict__ table, int K,
                const CODE* __restrict__ codes1,
                const CODE* __restrict__ codes2,
                const int64_t* __restrict__ desc, int64_t B, float* scratch,
                float* stats, float og, float eg) {
  extern __shared__ float smem[];
  const float* tab = sw::block_table(table, K, smem);
  const int lane = threadIdx.x % dg::LANES;
  const int64_t b = (int64_t)blockIdx.x * kWarps + threadIdx.x / dg::LANES;
  if (b >= B) return;  // the whole warp: b is the warp's
  const int64_t* dd = desc + b * sw::DESC_W;
  const CODE* c1 = codes1 + dd[sw::D_OFF1];
  const CODE* c2 = codes2 + dd[sw::D_OFF2];
  const int n = (int)dd[sw::D_N], m = (int)dd[sw::D_M];
  float* edge = scratch + dd[sw::D_CARRY];
  float best = 0.0f;
  for (int c0 = 0; c0 < m; c0 += dg::LANES) {
    const int c = c0 + lane;
    const bool col_live = c < m;
    const float* tcol = tab + (col_live ? c2[c] : 0);
    dg::Lane L = dg::lane_begin();
    int code1 = 0;
    // this lane's share of the next 32 rows for lane 0: code, edge W, fx
    int bc = 0;
    float bw = 0.0f, bx = 0.0f;
    const int steps = dg::strip_steps(n, m, c0);
    for (int d = 0; d < steps; ++d) {
      const int q = d % dg::LANES;
      if (q == 0) {
        const int row = d + lane;
        bc = row < n ? c1[row] : 0;
        dg::lane0_fill(edge, n, c0, row, &bx, &bw);
      }
      const float xp = dg::xpre(L.w1, L.x1, og, eg);
      float xin = __shfl_up_sync(kFull, xp, 1);
      float wl = __shfl_up_sync(kFull, L.w1, 1);
      int cd = __shfl_up_sync(kFull, code1, 1);
      const int c_q = __shfl_sync(kFull, bc, q);
      const float w_q = __shfl_sync(kFull, bw, q);
      const float x_q = __shfl_sync(kFull, bx, q);
      if (lane == 0) {
        xin = x_q;
        wl = w_q;
        cd = c_q;
      }
      code1 = cd;
      const int r = d - lane;
      dg::step(&L, tcol[code1 * K], xin, wl, r < 0, r >= 0 && r < n && col_live,
               og, eg);
      if (lane == dg::LANES - 1 && dg::keeps_edge(n, m, c0, r)) {
        edge[2 * (int64_t)r] = L.w1;
        edge[2 * (int64_t)r + 1] = dg::xpre(L.w1, L.x1, og, eg);
      }
    }
    best = sw::mx(best, L.best);
    __syncwarp();  // the edge rows written above, before the next strip reads
  }
  for (int o = dg::LANES / 2; o > 0; o /= 2)
    best = sw::mx(best, __shfl_xor_sync(kFull, best, o));
  if (lane < sw::STATS_W) stats[b * sw::STATS_W + lane] = lane ? 0.0f : best;
}

}  // namespace

extern "C" {

// Launches K9 on `stream` over B pairs described by desc (B, 8) int64 (the
// fill's layout: codes offsets, n, m; D_CARRY the offset in floats of the
// pair's edge scratch, 2 * n floats).  table: (K, K) f32; codes: flat
// buffers of code_bytes-wide codes (1: uint8, 2: int16), each below K;
// stats: (B, 8) f32, written [best, 0, ...].  Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take (og <= eg <= 0 is the caller's to check).
int sw_diag_fill_launch(const float* table, int K, int code_bytes,
                        const void* codes1, const void* codes2,
                        const int64_t* desc, int64_t B, float* scratch,
                        float* stats, float og, float eg, void* stream) {
  if (B <= 0 || K <= 0 || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  const size_t smem = sw::table_smem(K);
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    diag_kernel<uint8_t><<<grid, kWarps * dg::LANES, smem, st>>>(
        table, K, (const uint8_t*)codes1, (const uint8_t*)codes2, desc, B,
        scratch, stats, og, eg);
  else
    diag_kernel<int16_t><<<grid, kWarps * dg::LANES, smem, st>>>(
        table, K, (const int16_t*)codes1, (const int16_t*)codes2, desc, B,
        scratch, stats, og, eg);
  return (int)cudaGetLastError();
}

}  // extern "C"
