// K2: the pooled traceback walk, one thread per pair.
//
// Replaces: smithwaterman_tpu/ops/device_walk.py walk_bundle_pooled
// (:220), a lax.while_loop in the JAX package (not Pallas).  In PyTorch a
// loop on the host would pay one launch per step, and a walk takes up to
// NP + MP + 2 steps.
//
// What bounds it on an H100: dependent gathers.  Each step's pointer
// address depends on the state read at the previous step, so a pair's
// walk is a chain of up to n + m dependent loads from the tb pool (L2
// hits at best), with almost no arithmetic between them.
//
// What the design does about it: every pair walks in its own thread, all
// pairs of a flush in one launch through the fill's per-pair descriptors
// (64-bit offsets, no gather-size limit), so the chains of thousands of
// pairs overlap each other's latency; each thread packs four 2-bit moves
// per register byte and stores one byte per four steps.  Unlike the
// lockstep JAX loop, a pair that finishes early costs nothing more.
#include <cuda_runtime.h>

#include "sw_walk.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    walk_kernel(int local, const uint8_t* __restrict__ tb,
                const int64_t* __restrict__ desc,
                const float* __restrict__ stats, int64_t B, int64_t L,
                int32_t* cnt, uint8_t* moves) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* d = desc + b * sw::DESC_W;
  cnt[b] = sw::walk_pair(local != 0, tb + d[sw::D_TB], d[sw::D_RS],
                         d[sw::D_CS], (int)d[sw::D_N], (int)d[sw::D_M],
                         stats + b * sw::STATS_W, L, moves + b, B);
}

}  // namespace

extern "C" {

// Launches K2 on `stream` over B pairs: tb is the fill's pointer pool,
// desc (B, 8) int64 and stats (B, 8) f32 the fill's; writes cnt (B,)
// int32 and moves (ceil(L/4), B) uint8 (the caller zeroes moves).
// Returns cudaGetLastError() after the launch (0 = launched).
int sw_walk_launch(int local, const uint8_t* tb, const int64_t* desc,
                   const float* stats, int64_t B, int64_t L, int32_t* cnt,
                   uint8_t* moves, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      local, tb, desc, stats, B, L, cnt, moves);
  return (int)cudaGetLastError();
}

}  // extern "C"
