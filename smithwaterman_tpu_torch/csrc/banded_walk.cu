// K8: the banded traceback walk of up to eight pairs, one thread per pair.
//
// Replaces: smithwaterman_tpu/ops/banded.py _walk_banded_device (:413-500),
// a lax.while_loop that steps every pair of the batch in lockstep (not
// Pallas).  Only the (B, L) index arrays, the counts and the flags leave the
// device; the band of pointer bytes never does.
//
// What bounds it on an H100: dependent loads, as in K2.  Each step's pointer
// address depends on the state the previous step read, so a pair's walk is a
// chain of up to n + m dependent one-byte loads from K7's band, with a few
// integer operations between them.
//
// What the design does about it: one block of 32 threads per pair.  The
// threads first set the pair's idx1 and idx2 rows to -2 (coalesced), then
// thread 0 walks with sw_banded.cuh's walk_pair, the JAX loop body step for
// step; a pair that stops early costs nothing more, and the pairs' chains
// overlap each other's latency on separate SMs.
#include <cuda_runtime.h>

#include "sw_banded.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    banded_walk_kernel(int local, const uint8_t* __restrict__ tb,
                       const int32_t* __restrict__ off,
                       const int32_t* __restrict__ start,
                       const int32_t* __restrict__ m, int64_t NP, int W,
                       int64_t L, int32_t* idx1, int32_t* idx2, int32_t* cnt,
                       int32_t* flags) {
  const int64_t b = blockIdx.x;
  int32_t* i1 = idx1 + b * L;
  int32_t* i2 = idx2 + b * L;
  for (int64_t q = threadIdx.x; q < L; q += blockDim.x) {
    i1[q] = -2;
    i2[q] = -2;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  sw::banded::walk_pair(local != 0, tb + b * NP * W, off + b * (NP + 1),
                        (int)NP, W, m[b], start + 4 * b, L, i1, i2, cnt + b,
                        flags + b);
}

}  // namespace

extern "C" {

// Launches K8 on `stream` over B pairs: tb (B, NP, W) uint8 from K7, off
// (B, NP + 1) int32 band offsets, start (B, 4) int32 {i, j, state, active},
// m (B,) int32; writes idx1, idx2 (B, L) int32 (-2 where the walk wrote
// nothing), cnt and flags (B,) int32.  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int sw_banded_walk_launch(int local, const uint8_t* tb, const int32_t* off,
                          const int32_t* start, const int32_t* m, int64_t B,
                          int64_t NP, int W, int64_t L, int32_t* idx1,
                          int32_t* idx2, int32_t* cnt, int32_t* flags,
                          void* stream) {
  if (B <= 0 || NP <= 0 || W <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  banded_walk_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
      local, tb, off, start, m, NP, W, L, idx1, idx2, cnt, flags);
  return (int)cudaGetLastError();
}

}  // extern "C"
