// K11: the pooled token walk, one thread per pair.
//
// Replaces: smithwaterman_tpu/ops/device_walk.py walk_bundle_pooled_tokens
// (:322), a lax.while_loop in the JAX package (not Pallas).
//
// What bounds it on an H100: dependent gathers, as in K2 (walk.cu): each
// step's address depends on the state read at the step before.  The
// match-run bytes of K10 (fill.cu with RUNS) let a step in state M jump up
// to 16 diagonal cells, so a pair's chain is one step per token instead of
// one per move; the two loads of a step (pointer byte and run byte) sit at
// the same offset of two pools and issue together.
//
// What the design does about it: every pair walks in its own thread over
// the fill's per-pair descriptors, all pairs of a flush in one launch, so
// the chains of thousands of pairs overlap each other's latency.  A token
// is one byte (state bits 0-1, extra steps bits 2-5), stored as it is
// emitted at toks[t * B + pair] (pairs innermost, so a warp's stores of one
// step coalesce); the host rebuild (csrc/reconstruct.cpp
// sw_reconstruct_tokens) expands them.
#include <cuda_runtime.h>

#include "sw_walk.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    token_walk_kernel(int local, const uint8_t* __restrict__ tb,
                      const uint8_t* __restrict__ run,
                      const int64_t* __restrict__ desc,
                      const float* __restrict__ stats, int64_t B, int64_t L,
                      int32_t* cnt, uint8_t* toks) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* d = desc + b * sw::DESC_W;
  cnt[b] = sw::walk_tokens_pair(
      local != 0, tb + d[sw::D_TB], run + d[sw::D_TB], d[sw::D_RS],
      d[sw::D_CS], (int)d[sw::D_N], (int)d[sw::D_M], stats + b * sw::STATS_W,
      L, toks + b, B);
}

}  // namespace

extern "C" {

// Launches K11 on `stream` over B pairs: tb and run are the fill's pointer
// and run pools (K10), desc (B, 8) int64 and stats (B, 8) f32 the fill's;
// writes cnt (B,) int32 and the tokens t < cnt of toks (L, B) uint8 (the
// caller zeroes toks).  Returns cudaGetLastError() after the launch.
int sw_walk_tokens_launch(int local, const uint8_t* tb, const uint8_t* run,
                          const int64_t* desc, const float* stats, int64_t B,
                          int64_t L, int32_t* cnt, uint8_t* toks,
                          void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  token_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      local, tb, run, desc, stats, B, L, cnt, toks);
  return (int)cudaGetLastError();
}

}  // extern "C"
