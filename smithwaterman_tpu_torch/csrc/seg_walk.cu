// K5: the long-sequence traceback walk through a group of refilled bands,
// one warp per pair.
//
// Replaces: smithwaterman_tpu/ops/longseq.py _packed_walk_segments (:277),
// a lax.while_loop over bands around a lockstep while_loop of steps (not
// Pallas).  The route (ops/longseq.py) launches K4 once per group of G
// bands and then K5 once for the same group: K5 walks bands top .. sk0 of
// every pair, top first; the walk state lives in device tensors between
// launches and in registers between the bands of a launch.
//
// What bounds it on an H100: a chain of dependent byte reads.  Each step's
// pointer address depends on the state the previous step read, so a pair's
// walk through a band is a chain of up to ~2C reads.  K4 has just written
// the group (G bands x B pairs x (C + MP) * C bytes, ~1.3 GB at the long
// route's shapes), far past L2, so a read straight from the band is an
// HBM round trip.
//
// What the design does about it: the bytes of cell (i, j) lie on the
// band's anti-diagonal r + j - 1 (r = i - 1 - base), C contiguous bytes,
// and every step lowers the diagonal, so a walk reads a band's diagonals
// in decreasing order and the warp can fetch them before the walk needs
// them.  Each pair is a warp with a ring of sw::WINDOWS windows of D
// diagonals (sw::window_units: 16 KB each) in shared memory: the
// warp's 32 lanes copy a window with 16-byte cp.async copies, the windows
// below are in flight while the walk reads the current one, and every lane
// steps the same walk on the shared bytes (a broadcast read, no
// divergence); lane 0 stores the moves.  A band is opened by its first read, so a pair the
// band does not concern, or whose walk there only follows the DP boundary,
// costs one check and copies nothing.  The step rule is sw_walk.cuh
// walk_segment and the windows sw_walk.cuh Windows (the ring K8 reads its
// band rows through too), which the host twin runs as well.
#include <cuda_runtime.h>

#include "sw_band.cuh"
#include "sw_walk.cuh"

namespace {

__global__ void __launch_bounds__(sw::WARP)
    seg_walk_kernel(int local, const uint8_t* __restrict__ bands, int G,
                    int64_t B, int64_t MP, int C, int sk0, int64_t L, int D,
                    int32_t* walk, int32_t* cnt, uint8_t* moves) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t L4 = (L + 3) / 4;
  const int64_t bb = sw::band_bytes(C, MP);
  sw::SegState st = sw::seg_load(walk + b * 4, cnt + b, moves + b, B);
  for (int g = G - 1; g >= 0; --g) {
    auto win = sw::seg_windows(bands + (g * B + b) * bb, C, MP, D, smem,
                               sw::WarpCopy{lane});
    sw::walk_segment(local != 0, win, (sk0 + g) * C, L, &st, moves + b, B,
                     L4, lane == 0);
    win.close();
  }
  if (lane == 0) sw::seg_store(st, walk + b * 4, cnt + b, moves + b, B, L4);
}

}  // namespace

extern "C" {

// Launches K5 on `stream` for bands sk0 .. sk0 + G - 1 of B pairs, walked
// top band first: bands (G, B, (C + MP) * C) uint8 from K4, band sk0 + g at
// [g]; walk (B, 4) int32 {i, j, s, done} and cnt (B,) int32 read and
// written back, moves (ceil(L/4), B) uint8 (zeroed before the first
// launch).  C is a multiple of 32.  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int sw_seg_walk_launch(int local, const uint8_t* bands, int G, int64_t B,
                       int64_t MP, int C, int sk0, int64_t L, int32_t* walk,
                       int32_t* cnt, uint8_t* moves, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || C % sw::WARP || sk0 < 0 || G < 1)
    return (int)cudaErrorInvalidValue;
  const int D = sw::window_units(C);
  const size_t smem = sw::WINDOWS * sw::window_slot_bytes(D, C, false);
  cudaFuncSetAttribute(seg_walk_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  seg_walk_kernel<<<(unsigned)B, sw::WARP, smem, (cudaStream_t)stream>>>(
      local, bands, G, B, MP, C, sk0, L, D, walk, cnt, moves);
  return (int)cudaGetLastError();
}

}  // extern "C"
