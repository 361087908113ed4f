// K7: the banded three-state fill of up to eight pairs.
//
// Replaces: smithwaterman_tpu/ops/banded.py fill_banded (:286, pallas_call
// :310; body _kernel :61-280).  Inputs are K6's scores S (B, NP, W); the
// outputs are the band's pointer bytes tb (B, NP, W), in each pair's true
// rows i <= n, and the stats row per pair: LOCAL [best, best_i, best_lane,
// 0...], the host turning the lane into the column off(best_i) + lane + 1;
// otherwise [0, 0, 0, finalM, finalX, finalY, 0, 0] of cell (n, m).
//
// What bounds it on an H100: the chain through a pair.  Row i needs row i-1
// and, through X, every cell to its left in the same row, so the cells of
// a pair form one wavefront; a launch has at most eight pairs, and a block
// a pair would leave all but eight SMs idle.
//
// What the design does about it: a pair's rows are cut into stripes of
// 32 R rows (R = sw::banded::ROWS, two), each filled by one warp whose lane
// l owns R rows and sweeps absolute columns in a wavefront, lane l a step behind
// lane l-1: the cell above a lane's first row comes by a shuffle, every
// cell's inputs are in registers (the row's cell to the left, its running
// maximum of X's h, the diagonal kept from the step before), and a warp
// needs no barrier.  The stripes of a pair run at once on many SMs: a
// stripe's bottom row goes to the stripe below through global memory, a
// tile of bd::TILE columns at a time, published as K3 publishes its
// checkpoint tiles (the stores, a fence, then the tile count with release
// semantics; the reader takes the count with acquire semantics and loads
// the tile through L2, half a tile ahead).  The band scores come through
// L2 two steps before their use.  Persistent one-warp blocks take stripes
// by an atomic ticket, stripe-major over the pairs, so a stripe only waits
// on the stripe above, whose ticket was taken earlier by a block already
// running: nothing deadlocks, whatever order the blocks are scheduled in.
// Each stripe puts its LOCAL best (lane_better, the JAX kernel's order) in
// a scratch slot and counts itself done; the pair's last stripe merges
// them.  Rows past n are not computed.
#include <cuda_runtime.h>

#include "sw_banded.cuh"

namespace {

namespace bd = sw::banded;
constexpr unsigned kFull = sw::FULL;

__device__ __forceinline__ bd::LaneBest shfl_xor_lane_best(bd::LaneBest b,
                                                          int o) {
  return {__shfl_xor_sync(kFull, b.v, o), __shfl_xor_sync(kFull, b.i, o),
          __shfl_xor_sync(kFull, b.w, o)};
}

// Every lane's best merged, in every lane.
__device__ __forceinline__ bd::LaneBest warp_lane_best(bd::LaneBest b) {
  for (int o = sw::WARP / 2; o > 0; o /= 2)
    b = bd::lane_better(b, shfl_xor_lane_best(b, o));
  return b;
}

__device__ __forceinline__ void await_feed(const bd::Feed& f, int T) {
  while (!bd::feed_ready(f, T)) __nanosleep(64);
}

// One stripe, as lane l of its warp; returns the lane's LOCAL best.
template <int MODE>
__device__ bd::LaneBest run_stripe(int l, const bd::StripeIO& io,
                                   const sw::Pen& p) {
  bd::BLane L = bd::lane_begin<MODE>(l, io, p);
  sw::Cell cur{}, nxt{};
  const int64_t sw_cols = io.feed.sw;
  for (int k = 0; k < io.st.steps; ++k) {
    const int c = io.feed.c0 + k;
    const int q = c & (bd::TILE - 1);
    if (k == 0) {
      await_feed(io.feed, c / bd::TILE);
      cur = bd::feed_tile(l, c / bd::TILE, io.feed, p, io.g.W);
    }
    if (q == bd::TILE / 2 || (k == 0 && q > bd::TILE / 2)) {
      // the next tile, half a tile ahead
      const int T = c / bd::TILE + 1;
      await_feed(io.feed, T);
      nxt = bd::feed_tile(l, T, io.feed, p, io.g.W);
    }
    sw::Cell u = sw::shfl_up_cell(L.out);
    const sw::Cell s0 = sw::shfl_cell(cur, q);
    if (l == 0) u = s0;
    bd::lane_step<MODE>(l, k, &L, u, io, p);
    if (io.out) {
      const sw::Cell bottom = sw::shfl_cell(L.out, io.st.lanes - 1);
      const int T = bd::bottom_collect(l, k, &L, bottom, io);
      if (T >= 0) {
        bd::bottom_store(l, T, L, io, sw_cols);
        __syncwarp();
        if (l == 0) bd::publish_tiles(io, T + 1);
      }
    }
    if (q == bd::TILE - 1) cur = nxt;
  }
  return L.best;
}

template <int MODE>
__global__ void __launch_bounds__(sw::WARP)
    stripe_kernel(const float* __restrict__ S, const int32_t* __restrict__ n,
                  const int32_t* __restrict__ m, int64_t B, int64_t NP,
                  int W, int NS, int32_t* scratch, uint8_t* tb, float* stats,
                  float og, float eg) {
  const int l = threadIdx.x;
  const bd::StripeScratch sc = bd::stripe_scratch(scratch, B, NS);
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int64_t tickets = (int64_t)NS * B;
  for (;;) {
    int t = 0;
    if (l == 0) t = atomicAdd(sc.ticket, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= tickets) return;
    bd::StripeIO io;
    if (!bd::stripe_io(&io, t, B, NP, W, NS, S, n, m, tb, stats, sc, MODE,
                       nullptr))
      continue;  // the pair has no rows in this stripe
    const bd::LaneBest mine = run_stripe<MODE>(l, io, p);
    if (MODE != sw::LOCAL) continue;
    const int s = (int)(t / B);
    const int64_t b = t % B;
    const bd::LaneBest best = warp_lane_best(mine);
    int before = 0;
    if (l == 0) {
      bd::put_lane_best(sc.best + 3 * (b * NS + s), best);
      __threadfence();
      before = atomicAdd(sc.done + b, 1);
    }
    before = __shfl_sync(kFull, before, 0);
    const int ns = bd::n_stripes(io.g.n);
    if (before != ns - 1) continue;
    __threadfence();  // the pair's last stripe: merge every stripe's best
    bd::LaneBest all = bd::no_lane_best();
    for (int q = l; q < ns; q += sw::WARP)
      all = bd::lane_better(all,
                            bd::get_lane_best(sc.best + 3 * (b * NS + q)));
    all = warp_lane_best(all);
    if (l == 0) bd::local_stats(all, stats + b * sw::STATS_W);
  }
}

template <int MODE>
int launch(const float* S, const int32_t* n, const int32_t* m, int64_t B,
           int64_t NP, int W, int32_t* scratch, uint8_t* tb, float* stats,
           float og, float eg, int* grid, cudaStream_t st) {
  auto kern = stripe_kernel<MODE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, sw::WARP, 0);
  const int NS = bd::n_stripes(NP);
  const int64_t need = (int64_t)NS * B;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int g = (int)(need < resident ? need : resident);
  if (grid) *grid = g;
  cudaMemsetAsync(stats, 0, (size_t)B * sw::STATS_W * sizeof(float), st);
  kern<<<g, sw::WARP, 0, st>>>(S, n, m, B, NP, W, NS, scratch, tb, stats, og,
                               eg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: S (B, NP, W) f32 from K6, true lengths n, m (B,)
// int32 (1 <= n <= NP), scratch sw::banded::scratch_words(B, NS, W) int32
// words, NS = n_stripes(NP), the first scratch_zeroed(B, NS) of them zero;
// writes tb (B, NP, W) uint8 (rows i <= n of each pair) and stats (B, 8)
// f32.  W must be a multiple of 4.  The grid goes to *grid when given.  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_banded_fill_launch(int mode, const float* S, const int32_t* n,
                          const int32_t* m, int64_t B, int64_t NP, int W,
                          int32_t* scratch, uint8_t* tb, float* stats,
                          float og, float eg, int* grid, void* stream) {
  if (B <= 0 || NP <= 0 || W <= 0 || W % 4 || !scratch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == sw::LOCAL)
    return launch<sw::LOCAL>(S, n, m, B, NP, W, scratch, tb, stats, og, eg,
                             grid, st);
  if (mode == sw::GLOCAL)
    return launch<sw::GLOCAL>(S, n, m, B, NP, W, scratch, tb, stats, og, eg,
                              grid, st);
  if (mode == sw::GLOBAL)
    return launch<sw::GLOBAL>(S, n, m, B, NP, W, scratch, tb, stats, og, eg,
                              grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
