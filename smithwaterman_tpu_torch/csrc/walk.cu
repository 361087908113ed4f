// K2: the pooled traceback walk, a warp a pair, its pointer
// bytes read from shared-memory tiles copied ahead of the walk.
//
// Replaces: smithwaterman_tpu/ops/device_walk.py walk_bundle_pooled
// (:220), a lax.while_loop in the JAX package (not Pallas).  In PyTorch a
// loop on the host would pay one launch per step, and a walk takes up to
// NP + MP + 2 steps.
//
// What bounds it on an H100: a chain of dependent reads.  Each step's
// pointer address depends on the state the step before read, so a pair's
// walk is a chain of up to n + m dependent byte reads, with a few integer
// operations between them.  The flush's pool (~5.8e8 bytes at the main
// path's shapes) is far past L2, so a read straight from it is a
// device-memory round trip a step (what one thread a pair paid).
//
// What the design does about it: a walk lowers its row and column and
// never raises them, so the warp copies the part of the pair's block it
// heads for into shared memory before it gets there (sw_walk.cuh Tiles:
// two slots of a tile of T rows x C columns, the next tile above or to the
// left copied by cp.async once the walk passes the current one's middle),
// and a step reads shared memory.  A pair is a warp (a block of one
// warp, so the flush's pairs spread over every SM): the lanes split a
// tile's rows among them and then all step the same walk on the shared
// bytes (a broadcast read, no lane test).  What is left is the chain of one walk's steps, so a step is kept
// short: where the walk is four rows and columns inside the part of the
// tile that needs no event, it takes four steps a block with no bounds
// test and one packed store, the next cell's byte read before the current
// one is decoded (the next cell depends only on the state).  Pairs start
// in the caller's order (the fill's longest n + m first), so the longest
// chains start first.
#include <cuda_runtime.h>

#include "sw_walk.cuh"

namespace {

__global__ void __launch_bounds__(32)
    walk_kernel(int local, const uint8_t* __restrict__ tb,
                const int64_t* __restrict__ desc,
                const float* __restrict__ stats,
                const int32_t* __restrict__ order, int64_t L, int T,
                int C, int32_t* cnt, uint8_t* moves) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t B = gridDim.x, b = order[blockIdx.x];
  const int64_t* d = desc + b * sw::DESC_W;
  const int lane = (int)threadIdx.x;
  const uint8_t* src[1] = {tb + d[sw::D_TB]};
  auto cells = sw::tiles<1>(
      src, d[sw::D_RS], T, C, smem,
      sw::LaneCopy{lane, lane + 1, (unsigned)__cvta_generic_to_shared(smem)});
  cnt[b] = sw::walk_pair(local != 0, cells, (int)d[sw::D_N], (int)d[sw::D_M],
                         stats + b * sw::STATS_W, L, moves + b, B);
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over B pairs: tb is the fill's pointer pool,
// desc (B, 8) int64 (D_CS = 1) and stats (B, 8) f32 the fill's; order
// (B,) int32 the pairs in the order they start (fill_dp.walk_order),
// tiles of T rows x C columns.  Writes cnt (B,) int32
// and moves (ceil(L/4), B) uint8 (the caller zeroes moves).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_walk_launch(int local, const uint8_t* tb, const int64_t* desc,
                   const float* stats, const int32_t* order, int64_t B,
                   int64_t L, int T, int C, int32_t* cnt, uint8_t* moves,
                   void* stream) {
  const int64_t smem = sw::TILE_SLOTS * sw::tile_slot_bytes(T, C);
  if (!order || B <= 0 || B >= (1LL << 31) || L <= 0 || L >= (1LL << 31) ||
      T < 1 || C < 1 || smem > sw::BLOCK_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(walk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  walk_kernel<<<(unsigned)B, 32, (size_t)smem, (cudaStream_t)stream>>>(
      local, tb, desc, stats, order, L, T, C, cnt, moves);
  return (int)cudaGetLastError();
}

}  // extern "C"
