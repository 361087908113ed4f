// K5: one band's share of the long-sequence traceback walk, one thread per
// pair.
//
// Replaces: smithwaterman_tpu/ops/longseq.py _packed_walk_segments (:277),
// a lax.while_loop over bands around a lockstep while_loop of steps (not
// Pallas).  The route (ops/longseq.py) launches K4 and then K5 once per
// band, top band last; the walk state lives in device tensors between
// launches.
//
// What bounds it on an H100: dependent gathers, as in K2.  Each step's
// pointer address depends on the state the previous step read, so a pair's
// walk through one band is a chain of up to ~2C dependent one-byte loads
// from the band buffer (L2 hits at best), with almost no arithmetic.
//
// What the design does about it: every pair walks in its own thread and a
// finished or waiting pair costs one check; the thread keeps four 2-bit
// moves in a register and stores one byte per four steps, reading back the
// byte the previous band left part-filled.  The step rule is
// sw_walk.cuh walk_segment, which the host twin runs too.
#include <cuda_runtime.h>

#include "sw_band.cuh"
#include "sw_walk.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    seg_walk_kernel(int local, const uint8_t* __restrict__ band, int64_t B,
                    int64_t MP, int C, int sk, int64_t L, int32_t* walk,
                    int32_t* cnt, uint8_t* moves) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  sw::walk_segment(local != 0, band + b * sw::band_bytes(C, MP), C + 1, C,
                   sk * C, L, walk + b * 4, cnt + b, moves + b, B,
                   (L + 3) / 4);
}

}  // namespace

extern "C" {

// Launches K5 on `stream` for band sk over B pairs: band (B, (C + MP) * C)
// uint8 from K4, walk (B, 4) int32 {i, j, s, done} and cnt (B,) int32 read
// and written back, moves (ceil(L/4), B) uint8 (zeroed before the first
// band).  Returns cudaGetLastError() after the launch (0 = launched).
int sw_seg_walk_launch(int local, const uint8_t* band, int64_t B, int64_t MP,
                       int C, int sk, int64_t L, int32_t* walk, int32_t* cnt,
                       uint8_t* moves, void* stream) {
  if (B <= 0 || L <= 0 || C <= 0 || sk < 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  seg_walk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      local, band, B, MP, C, sk, L, walk, cnt, moves);
  return (int)cudaGetLastError();
}

}  // extern "C"
