// K11: the pooled token walk, a warp a pair, its pointer and
// run bytes read from shared-memory tiles copied ahead of the walk.
//
// Replaces: smithwaterman_tpu/ops/device_walk.py walk_bundle_pooled_tokens
// (:322), a lax.while_loop in the JAX package (not Pallas).
//
// What bounds it on an H100: a chain of dependent reads, as in K2
// (walk.cu): each step's address depends on the state read at the step
// before.  The match-run bytes of K10 (fill.cu with RUNS) let a step in
// state M jump up to 16 diagonal cells, so a pair's chain is one step per
// token instead of one per move; the two reads of a step (pointer byte and
// run byte) sit at the same offset of two pools.
//
// What the design does about it: K2's (sw_walk.cuh Tiles, with P = 2
// pools): the warp copies the tiles of both pools the walk heads for into
// shared memory ahead of it, at the same offsets, and a step reads both
// bytes there, a token at a time (a token's cell depends on the run byte
// read before it, so K2's four-step blocks do not apply; the tiles are
// 16 x 48, half K2's, as two pools halve the pairs an SM holds).  A jump
// that leaves the tile (or passes the copied neighbour) copies the tile at
// its cell and waits.  A token is one byte (state bits 0-1, extra steps
// bits 2-5), stored by every lane of the warp as it is emitted at
// toks[t * B + pair]; the host rebuild (csrc/reconstruct.cpp
// sw_reconstruct_tokens) expands them.
#include <cuda_runtime.h>

#include "sw_walk.cuh"

namespace {

__global__ void __launch_bounds__(32)
    token_walk_kernel(int local, const uint8_t* __restrict__ tb,
                      const uint8_t* __restrict__ run,
                      const int64_t* __restrict__ desc,
                      const float* __restrict__ stats,
                      const int32_t* __restrict__ order, int64_t L, int T,
                      int C, int32_t* cnt, uint8_t* toks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t B = gridDim.x, b = order[blockIdx.x];
  const int64_t* d = desc + b * sw::DESC_W;
  const int lane = (int)threadIdx.x;
  const uint8_t* src[2] = {tb + d[sw::D_TB], run + d[sw::D_TB]};
  auto cells = sw::tiles<2>(
      src, d[sw::D_RS], T, C, smem,
      sw::LaneCopy{lane, lane + 1, (unsigned)__cvta_generic_to_shared(smem)});
  cnt[b] = sw::walk_tokens_pair(local != 0, cells, (int)d[sw::D_N],
                                (int)d[sw::D_M], stats + b * sw::STATS_W, L,
                                toks + b, B);
}

}  // namespace

extern "C" {

// Launches K11 on `stream` over B pairs: tb and run are the fill's pointer
// and run pools (K10, at the same address mod 16), desc (B, 8) int64
// (D_CS = 1) and stats (B, 8) f32 the fill's; order, T and C as
// sw_walk_launch's.  Writes cnt (B,) int32 and the tokens t < cnt of toks
// (L, B) uint8 (the caller zeroes toks).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take.
int sw_walk_tokens_launch(int local, const uint8_t* tb, const uint8_t* run,
                          const int64_t* desc, const float* stats,
                          const int32_t* order, int64_t B, int64_t L, int T,
                          int C, int32_t* cnt, uint8_t* toks, void* stream) {
  const int64_t smem = sw::TILE_SLOTS * 2 * sw::tile_slot_bytes(T, C);
  if (!order || B <= 0 || B >= (1LL << 31) || L <= 0 || L >= (1LL << 31) ||
      T < 1 || C < 1 || smem > sw::BLOCK_SMEM ||
      (((uintptr_t)tb - (uintptr_t)run) & 15))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(token_walk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  token_walk_kernel<<<(unsigned)B, 32, (size_t)smem, (cudaStream_t)stream>>>(
      local, tb, run, desc, stats, order, L, T, C, cnt, toks);
  return (int)cudaGetLastError();
}

}  // extern "C"
