// K1: the batched three-state affine DP fill, one thread per pair.
//
// Replaces: smithwaterman_tpu/ops/pallas_dp.py _kernel (:197) as called by
// fill_tiled (:705), traceback and score-only variants, together with the
// dense score precompute ops/batch.py scores_tiled (:39) that fed it.
//
// What bounds it on an H100: the per-cell dependency latency.  Within a
// pair, cell (i, j) needs (i, j-1) (the X state), so a pair is a serial
// chain of n*m cells of a few dependent f32 compares and adds each; the
// pointer byte written per cell (1 B) and the row carry (12 B read and
// written per cell, L1/L2 resident) are far below the card's bandwidth.
//
// What the design does about it: pairs are the parallel axis.  Each
// thread runs one pair's sequential recurrence (sw_cell.cuh, the same
// code the host twin checks), so there is no prefix scan and no
// cross-thread reduction: the LOCAL argmax is the sequential strict-`>`
// first maximum by construction.  Blocks are one warp, so a batch's warps
// spread over all SMs; pairs of one length bucket sit in neighbouring
// lanes, so a warp's lanes step through similar row lengths, and the
// pointer bytes and carries keep pairs innermost so a warp's stores to
// one cell coalesce.  The substitution score comes from a shared-memory
// copy of the (K, K) table (device memory past sw::SMEM_K symbols), so the
// dense score tensor is never built; codes are uint8, or int16 for tables
// past 255 symbols (the CODE template parameter).
// One launch covers every bucket-chunk of a flush through per-pair
// descriptors (sw_cell.cuh Desc).  Latency is hidden only across the
// pairs in flight: a batch of a few thousand pairs leaves most of each SM
// idle, and intra-pair parallelism is later work.  (A hand-written
// one-column-ahead prefetch in fill_pair faulted with an illegal address
// in the optimized non-LOCAL score-only build, not under -G; the plain
// loop the compiler unrolls itself is right in every specialization.)
//
// K10: the same kernel with RUNS, replacing pallas_dp.py _kernel's
// emit_runs branch (:505-547) as called by fill_tiled(emit_runs=True)
// (:820).  Besides the pointer byte it writes each cell's match-run byte
// (sw_cell.cuh run_byte) into a second pool in the pointer pool's layout,
// which the token walk (token_walk.cu, K11) reads.  The diagonal's run byte
// is the byte this thread stored one row earlier, read back from the pool
// (an L1/L2 hit: one more byte load a cell); bound as K1 is, by the serial
// chain of a pair, now with two byte stores a cell.  K1 without runs is
// the RUNS = false specialization, unchanged.
#include <cuda_runtime.h>

#include "sw_cell.cuh"

namespace {

constexpr int kThreads = 32;

template <int MODE, bool TB, bool RUNS, typename CODE>
__global__ void __launch_bounds__(kThreads)
    fill_kernel(const float* __restrict__ table, int K,
                const CODE* __restrict__ codes1,
                const CODE* __restrict__ codes2,
                const int64_t* __restrict__ desc, int64_t B, uint8_t* tb,
                uint8_t* run, float* carry, float* stats, float og,
                float eg) {
  extern __shared__ float smem[];
  const float* tab = sw::block_table(table, K, smem);
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t* d = desc + b * sw::DESC_W;
  sw::fill_pair<MODE, TB, RUNS, CODE>(
      tab, K, codes1 + d[sw::D_OFF1], codes2 + d[sw::D_OFF2],
      (int)d[sw::D_N], (int)d[sw::D_M], TB ? tb + d[sw::D_TB] : nullptr,
      d[sw::D_RS], d[sw::D_CS], carry + d[sw::D_CARRY], 3 * d[sw::D_CS], og,
      eg, stats + b * sw::STATS_W, RUNS ? run + d[sw::D_TB] : nullptr);
}

template <int MODE, bool TB, bool RUNS, typename CODE>
void launch(const float* table, int K, const void* codes1,
            const void* codes2, const int64_t* desc, int64_t B, uint8_t* tb,
            uint8_t* run, float* carry, float* stats, float og, float eg,
            cudaStream_t stream) {
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  const size_t smem = sw::table_smem(K);
  fill_kernel<MODE, TB, RUNS, CODE><<<grid, kThreads, smem, stream>>>(
      table, K, (const CODE*)codes1, (const CODE*)codes2, desc, B, tb, run,
      carry, stats, og, eg);
}

template <int MODE, typename CODE>
void launch_mode(int traceback, const float* table, int K,
                 const void* codes1, const void* codes2, const int64_t* desc,
                 int64_t B, uint8_t* tb, uint8_t* run, float* carry,
                 float* stats, float og, float eg, cudaStream_t st) {
  if (run)
    launch<MODE, true, true, CODE>(table, K, codes1, codes2, desc, B, tb,
                                   run, carry, stats, og, eg, st);
  else if (traceback)
    launch<MODE, true, false, CODE>(table, K, codes1, codes2, desc, B, tb,
                                    nullptr, carry, stats, og, eg, st);
  else
    launch<MODE, false, false, CODE>(table, K, codes1, codes2, desc, B,
                                     nullptr, nullptr, carry, stats, og, eg,
                                     st);
}

template <typename CODE>
int launch_code(int mode, int traceback, const float* table, int K,
                const void* codes1, const void* codes2, const int64_t* desc,
                int64_t B, uint8_t* tb, uint8_t* run, float* carry,
                float* stats, float og, float eg, cudaStream_t st) {
  if (mode == sw::LOCAL)
    launch_mode<sw::LOCAL, CODE>(traceback, table, K, codes1, codes2, desc,
                                 B, tb, run, carry, stats, og, eg, st);
  else if (mode == sw::GLOCAL)
    launch_mode<sw::GLOCAL, CODE>(traceback, table, K, codes1, codes2, desc,
                                  B, tb, run, carry, stats, og, eg, st);
  else if (mode == sw::GLOBAL)
    launch_mode<sw::GLOBAL, CODE>(traceback, table, K, codes1, codes2, desc,
                                  B, tb, run, carry, stats, og, eg, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over B pairs described by desc (B, 8) int64.
// table: (K, K) f32; codes: flat buffers of code_bytes-wide codes (1:
// uint8, 2: int16), each below K; tb: uint8 pool (ignored when
// traceback == 0); run: NULL, or a second uint8 pool in tb's layout that
// receives each cell's match-run byte (K10, which needs traceback); carry:
// f32 scratch; stats: (B, 8) f32.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_fill_launch(int mode, int traceback, const float* table, int K,
                   int code_bytes, const void* codes1, const void* codes2,
                   const int64_t* desc, int64_t B, uint8_t* tb, uint8_t* run,
                   float* carry, float* stats, float og, float eg,
                   void* stream) {
  if (B <= 0 || K <= 0 || (run && !traceback) ||
      (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return code_bytes == 1
             ? launch_code<uint8_t>(mode, traceback, table, K, codes1, codes2,
                                    desc, B, tb, run, carry, stats, og, eg, st)
             : launch_code<int16_t>(mode, traceback, table, K, codes1, codes2,
                                    desc, B, tb, run, carry, stats, og, eg,
                                    st);
}

}  // extern "C"
