// K6: the banded substitution scores of up to eight pairs.
//
// Replaces: smithwaterman_tpu/ops/banded.py _banded_scores_pallas (:585,
// pallas_call :610; body _scores_kernel :525).  It writes
// S[b, i-1, w] = table[c1[b, i-1], c2[b, off_b(i) + w]] where that column is
// below m_b, else 0, for every row i = 1 .. NP: each pair's (NP, W) slice
// equals the JAX kernel's (NP, TBP, W) output at the pair's sublane.
//
// What bounds it on an H100: bytes.  It reads n + m one-byte codes a pair
// and writes 4 * NP * W bytes; there is no arithmetic beyond the offset and
// one table lookup per value.
//
// What the design does about it: a grid over (row block, pair); the block's
// threads stride over the W lanes of a row, so the stores of a warp are 128
// contiguous bytes, and the (K, K) table sits in shared memory (device
// memory past sw::SMEM_K symbols; codes uint8, or int16 past 255 symbols,
// as in K1).  The band offset is sw_banded.cuh's integer formula, the one K7
// and the host use.  The scores cost 4 bytes a band cell in device memory;
// fusing the lookup into K7's row loop would save them (ROADMAP Queue D).
#include <cuda_runtime.h>

#include "sw_banded.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // band rows per block

template <typename CODE>
__global__ void __launch_bounds__(kThreads)
    banded_scores_kernel(const float* __restrict__ table, int K,
                         const CODE* __restrict__ codes1,
                         const CODE* __restrict__ codes2,
                         const int32_t* __restrict__ n_,
                         const int32_t* __restrict__ m_, int64_t NP,
                         int64_t MP, int W, float* __restrict__ S) {
  extern __shared__ float smem[];
  const float* tab = sw::block_table(table, K, smem);
  const int64_t b = blockIdx.y;
  const sw::banded::Geom g = sw::banded::geom(n_[b], m_[b], W);
  const CODE* c2 = codes2 + b * MP;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t r1 = r0 + kRows < NP ? r0 + kRows : NP;
  for (int64_t r = r0; r < r1; ++r) {
    const int off = sw::banded::offset(g, r + 1);
    const float* trow = tab + codes1[b * NP + r] * K;
    float* out = S + (b * NP + r) * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const int col = off + w;
      out[w] = col < g.m ? trow[c2[col]] : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Launches K6 on `stream`: B pairs, codes (B, NP) / (B, MP) of
// code_bytes-wide codes (1: uint8, 2: int16) with every code below K, true
// lengths n, m (B,) int32 (m <= MP), table (K, K) f32; writes S (B, NP, W)
// f32.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_banded_scores_launch(const float* table, int K, int code_bytes,
                            const void* codes1, const void* codes2,
                            const int32_t* n, const int32_t* m, int64_t B,
                            int64_t NP, int64_t MP, int W, float* S,
                            void* stream) {
  if (B <= 0 || B > 65535 || NP <= 0 || MP <= 0 || W <= 0 || K <= 0 ||
      (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((NP + kRows - 1) / kRows), (unsigned)B);
  const size_t smem = sw::table_smem(K);
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    banded_scores_kernel<uint8_t><<<grid, kThreads, smem, st>>>(
        table, K, (const uint8_t*)codes1, (const uint8_t*)codes2, n, m, NP,
        MP, W, S);
  else
    banded_scores_kernel<int16_t><<<grid, kThreads, smem, st>>>(
        table, K, (const int16_t*)codes1, (const int16_t*)codes2, n, m, NP,
        MP, W, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
