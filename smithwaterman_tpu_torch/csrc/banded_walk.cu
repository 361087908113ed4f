// K8: the banded traceback walk of up to eight pairs, one warp per pair,
// reading its band rows from a ring of shared-memory windows.
//
// Replaces: smithwaterman_tpu/ops/banded.py _walk_banded_device (:413-500),
// a lax.while_loop that steps every pair of the batch in lockstep (not
// Pallas).  Only the (B, L) index arrays, the counts and the flags leave the
// device; the band of pointer bytes never does.
//
// What bounds it on an H100: dependent loads, as in K2.  Each step reads
// its row's offset off(i) and then the pointer byte at lane j - 1 - off(i)
// of band row i - 1, whose address depends on the state the previous step
// read, so a pair's walk is a chain of up to n + m dependent reads from
// K7's band; a step moves to a new row of W bytes, so reads straight from
// the band miss L1 and wait on device memory each step.
//
// What the design does about it: a walk lowers i by 0 or 1 a step, so it
// reads the band's rows in non-increasing order and the warp can fetch
// them before the walk needs them.  Each pair is a warp with a ring of
// sw::WINDOWS windows of D band rows and their offset words (48 KB each,
// at least two rows: sw_banded.cuh walk_rows) in shared memory (sw_walk.cuh
// Windows, the ring K5 reads its diagonals through): the warp's 32 lanes
// copy a window with cp.async (16-byte pieces, 4-byte ones and plain
// bytes at the ends, so any W and any row start), the windows below are
// in flight while the walk reads the current one, and every lane steps
// the same walk on the shared bytes (a broadcast read, no divergence), so
// a step waits on shared memory, not on device memory.  A step's move
// depends only on its state, so the next cell's offset and byte are read
// before the current byte is decoded (sw_banded.cuh walk_pair).  Every
// lane stores the same indices, count and flags (one transaction, and no
// lane test in the step), after the warp has set the pair's idx1 and idx2
// rows to -2 (coalesced).  Past bands of about
// 29,000 columns the ring's slots of two rows do not fit a block's shared
// memory, and the walk reads the rows straight from device memory
// (sw_banded.cuh DirectRows).  The step rule is sw_banded.cuh walk_pair,
// which the host twin runs through the same windows.
#include <cuda_runtime.h>

#include "sw_banded.cuh"

namespace {

template <bool RING>
__global__ void __launch_bounds__(32)
    banded_walk_kernel(int local, const uint8_t* __restrict__ tb,
                       const int32_t* __restrict__ off,
                       const int32_t* __restrict__ start,
                       const int32_t* __restrict__ m, int64_t NP, int W,
                       int64_t L, int D, int32_t* idx1, int32_t* idx2,
                       int32_t* cnt, int32_t* flags) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  int32_t* i1 = idx1 + b * L;
  int32_t* i2 = idx2 + b * L;
  for (int64_t q = lane; q < L; q += 32) {
    i1[q] = -2;
    i2[q] = -2;
  }
  __syncwarp();  // the -2s before lane 0's entries
  const uint8_t* rows = tb + b * NP * W;
  const int32_t* o = off + b * (NP + 1);
  if (RING) {
    auto win = sw::banded::row_windows(rows, W, (int)NP, o, D, smem,
                                       sw::WarpCopy{lane});
    sw::banded::walk_pair(local != 0, win, (int)NP, W, m[b], start + 4 * b,
                          L, i1, i2, cnt + b, flags + b);
    win.close();
  } else {
    sw::banded::DirectRows direct{rows, o + 1, W};
    sw::banded::walk_pair(local != 0, direct, (int)NP, W, m[b],
                          start + 4 * b, L, i1, i2, cnt + b, flags + b);
  }
}

}  // namespace

extern "C" {

// Launches K8 on `stream` over B pairs: tb (B, NP, W) uint8 from K7, off
// (B, NP + 1) int32 band offsets, start (B, 4) int32 {i, j, state, active},
// m (B,) int32; writes idx1, idx2 (B, L) int32 (-2 where the walk wrote
// nothing), cnt and flags (B,) int32.  The rows are read through a ring of
// sw_banded_walk_rows(W) rows a window, or straight from device memory
// where that is 0.  Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not
// take.
int sw_banded_walk_launch(int local, const uint8_t* tb, const int32_t* off,
                          const int32_t* start, const int32_t* m, int64_t B,
                          int64_t NP, int W, int64_t L, int32_t* idx1,
                          int32_t* idx2, int32_t* cnt, int32_t* flags,
                          void* stream) {
  if (B <= 0 || NP <= 0 || W <= 0 || L <= 0 || NP >= (1LL << 31) ||
      L + 4 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int D = sw::banded::walk_rows(W);
  if (D > 0) {
    const int64_t smem = sw::WINDOWS * sw::window_slot_bytes(D, W, true);
    cudaFuncSetAttribute(banded_walk_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    banded_walk_kernel<true><<<(unsigned)B, 32, (size_t)smem, st>>>(
        local, tb, off, start, m, NP, W, L, D, idx1, idx2, cnt, flags);
  } else {
    banded_walk_kernel<false><<<(unsigned)B, 32, 0, st>>>(
        local, tb, off, start, m, NP, W, L, 0, idx1, idx2, cnt, flags);
  }
  return (int)cudaGetLastError();
}

// K8's rows a window for a band of W bytes a row (0: straight reads).
int sw_banded_walk_rows(int W) {
  return W > 0 ? sw::banded::walk_rows(W) : 0;
}

}  // extern "C"
