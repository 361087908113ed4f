// K7: the banded three-state fill of up to eight pairs.
//
// Replaces: smithwaterman_tpu/ops/banded.py fill_banded (:286, pallas_call
// :310; body _kernel :61-280).  Inputs are K6's scores S (B, NP, W); the
// outputs are the band's pointer bytes tb (B, NP, W), in each pair's true
// rows i <= n, and the stats row per pair: LOCAL [best, best_i, best_lane,
// 0...], the host turning the lane into the column off(best_i) + lane + 1;
// otherwise [0, 0, 0, finalM, finalX, finalY, 0, 0] of cell (n, m).
//
// What bounds it on an H100: the chain of rows.  Row i needs row i-1 and,
// through X, every lane to its left in the same row, so a pair's rows run in
// order; the work per row is W cells of ~30 f32 operations and 5 bytes of
// scores and pointers.  With at most eight pairs a launch, eight SMs work.
//
// What the design does about it: one block of THREADS = 128 threads per
// pair, each thread owning W / 128 contiguous lanes (W is a multiple of 128),
// with the rules of sw_banded.cuh.  Per row: phase A computes M and Y of the
// thread's lanes from the row above and X's prefix over its own lanes; a
// block-wide exclusive max scan (warp shuffles, then the four warp totals
// through shared memory, one barrier) joins the threads' prefixes; phase C
// finishes X, the X pointer (lane w0-1's M and Y were recomputed in phase A,
// its X is the exclusive prefix, so no second exchange is needed), the tb
// byte and the LOCAL per-lane best; a barrier ends the row.  The two band
// rows' (M, X, Y) live in a per-pair global scratch (B, 8, W) f32, L2
// resident, with the per-lane best.  Rows past n are not computed.  Holding
// the rows in shared memory and reading the scores from the codes would save
// device traffic (ROADMAP Queue D).
#include <cuda_runtime.h>

#include "sw_banded.cuh"

namespace {

namespace bd = sw::banded;

constexpr int kWarps = bd::THREADS / 32;

template <int MODE>
__global__ void __launch_bounds__(bd::THREADS)
    banded_fill_kernel(const float* __restrict__ S,
                       const int32_t* __restrict__ n_,
                       const int32_t* __restrict__ m_, int64_t NP, int W,
                       float* scratch, uint8_t* tb, float* stats, float og,
                       float eg) {
  __shared__ float warp_max[kWarps];
  __shared__ bd::LaneBest bests[bd::THREADS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const bd::Geom g = bd::geom(n_[b], m_[b], W);
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  float* scr = scratch + b * bd::SCRATCH_ROWS * W;
  float* best = scr + 6 * (int64_t)W;
  int32_t* best_i = reinterpret_cast<int32_t*>(scr + 7 * (int64_t)W);
  uint8_t* tbp = tb + b * NP * W;
  float* st = stats + b * sw::STATS_W;
  if (t == 0)
    for (int q = 0; q < sw::STATS_W; ++q) st[q] = 0.0f;
  bd::init_lanes(t, g, p, bd::buf(scr, W, 0), best, best_i);
  __syncthreads();
  for (int i = 1; i <= g.n; ++i) {
    const bd::Row r =
        bd::row_begin<MODE>(g, p, i, S + (b * NP + i - 1) * (int64_t)W);
    const bd::Buf up = bd::buf(scr, W, (i - 1) & 1);
    const bd::Buf cur = bd::buf(scr, W, i & 1);
    uint8_t* row_tb = tbp + (int64_t)(i - 1) * W;
    bd::Left left;
    const float own = bd::phase_a<MODE>(t, g, p, r, up, cur, row_tb, &left);
    const float excl = bd::block_excl_max<kWarps>(own, warp_max, bd::BNEG);
    bd::phase_c<MODE>(t, g, p, r, excl, left, cur, row_tb, best, best_i,
                      st + 3);
    __syncthreads();
  }
  if (MODE == sw::LOCAL) {
    bests[t] = bd::thread_best(t, g, best, best_i);
    __syncthreads();
    if (t == 0) bd::finish_local(bests, bd::THREADS, st);
  }
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: S (B, NP, W) f32 from K6, true lengths n, m (B,)
// int32 (1 <= n <= NP), scratch (B, 8, W) f32; writes tb (B, NP, W) uint8
// (rows i <= n of each pair) and stats (B, 8) f32.  W must be a multiple of
// 128.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_banded_fill_launch(int mode, const float* S, const int32_t* n,
                          const int32_t* m, int64_t B, int64_t NP, int W,
                          float* scratch, uint8_t* tb, float* stats, float og,
                          float eg, void* stream) {
  if (B <= 0 || NP <= 0 || W <= 0 || W % bd::THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define SW_BANDED(MODE)                                             \
  banded_fill_kernel<MODE><<<(unsigned)B, bd::THREADS, 0, st>>>(    \
      S, n, m, NP, W, scratch, tb, stats, og, eg)
  if (mode == sw::LOCAL)
    SW_BANDED(sw::LOCAL);
  else if (mode == sw::GLOCAL)
    SW_BANDED(sw::GLOCAL);
  else if (mode == sw::GLOBAL)
    SW_BANDED(sw::GLOBAL);
  else
    return (int)cudaErrorInvalidValue;
#undef SW_BANDED
  return (int)cudaGetLastError();
}

}  // extern "C"
