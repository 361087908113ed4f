// K6: the banded substitution scores of up to eight pairs.
//
// Replaces: smithwaterman_tpu/ops/banded.py _banded_scores_pallas (:585,
// pallas_call :610; body _scores_kernel :525).  It writes
// S[b, i-1, w] = table[c1[b, i-1], c2[b, off_b(i) + w]] where that column is
// below m_b, else 0, for every row i = 1 .. NP: each pair's (NP, W) slice
// equals the JAX kernel's (NP, TBP, W) output at the pair's sublane.
//
// What bounds it on an H100: bytes.  It reads n + m codes a pair and writes
// 4 * NP * W bytes; there is no arithmetic beyond the offset and one table
// lookup per value.
//
// What the design does about it (the tiling is sw_scores.cuh's, which the
// host twin runs too): a persistent grid of `blocks` blocks of 256 threads
// takes tiles of T rows of one pair in turn (T and blocks from
// ops/kernels.scores_plan).  The (K, K) table is copied into shared memory
// once a block (device memory past sw::SMEM_K symbols; codes uint8, or
// int16 past 255 symbols, as in K1).  A tile's row offsets (sw_banded.cuh's
// integer formula, the one K7 and the host use) and table rows are computed
// once, one thread a row, into shared memory; seq2's codes of the rows'
// band are staged into a shared-memory window of WIN_BYTES in 16-byte
// pieces; every thread then builds quads of 4 columns from shared memory
// and writes each as one 16-byte streaming store, several in flight a
// thread (a store does not wait; 61 registers at uint8 codes keep 4 blocks
// an SM resident, so the grid of 8 an SM runs in two rounds).  The
// scores cost 4 bytes a band cell in device memory; fusing the lookup into
// K7's row loop would save them (ROADMAP performance item 0).
#include <cuda_runtime.h>

#include "sw_scores.cuh"

namespace {

namespace sc = sw::scores;

// The block's threads, each its own tid, then the block's barrier.
struct BlockExec {
  template <class F>
  __device__ void each(F&& f) {
    f((int)threadIdx.x);
    __syncthreads();
  }
};

struct CardMem {
  template <typename CODE>
  __device__ void load16(CODE* dst, const CODE* src) {
    *reinterpret_cast<uint4*>(dst) =
        __ldg(reinterpret_cast<const uint4*>(src));
  }
  template <typename CODE>
  __device__ CODE load(const CODE* p) {
    return __ldg(p);
  }
  template <typename CODE>
  __device__ void put16(CODE* dst, const CODE* piece) {
    for (int e = 0; e < 16 / (int)sizeof(CODE); ++e) dst[e] = piece[e];
  }
  template <typename CODE>
  __device__ CODE code(const CODE* win, int j) {
    return win[j];
  }
  // streaming stores (evict first): S passes L2 on its way to device
  // memory either way, and they beat plain stores by ~3 % at phases 9 and
  // 10 (scripts/ab_banded.py, PERF.md)
  __device__ void store4(float* out, const float* v) {
    __stcs(reinterpret_cast<float4*>(out),
           make_float4(v[0], v[1], v[2], v[3]));
  }
  __device__ void store1(float* out, float v) { *out = v; }
};

template <bool VEC, typename CODE>
__global__ void __launch_bounds__(sc::THREADS)
    banded_scores_kernel(sc::Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  CODE* win = reinterpret_cast<CODE*>(smem);
  int* offs = reinterpret_cast<int*>(smem + sc::WIN_BYTES);
  int* rbase = offs + sc::MAX_TILE;
  float* tsm = reinterpret_cast<float*>(rbase + sc::MAX_TILE);
  const float* tab = sw::block_table(a.table, a.K, tsm);
  BlockExec ex;
  CardMem mem;
  for (int64_t t = blockIdx.x; t < a.B * a.tiles; t += gridDim.x)
    sc::run_tile<VEC, CODE>(ex, mem, a, tab, t, win, offs, rbase);
}

template <bool VEC, typename CODE>
int launch(const sc::Args& a, int blocks, cudaStream_t st) {
  const size_t smem = sc::WIN_BYTES + 2 * sc::MAX_TILE * sizeof(int) +
                      sw::table_smem(a.K);
  banded_scores_kernel<VEC, CODE><<<blocks, sc::THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K6 on `stream`: B pairs, codes (B, NP) / (B, MP) of
// code_bytes-wide codes (1: uint8, 2: int16) with every code below K, true
// lengths n, m (B,) int32 (m <= MP), table (K, K) f32; writes S (B, NP, W)
// f32, in tiles of T rows (1 .. sw::scores::MAX_TILE) over `blocks` blocks.
// Stores 16 bytes at a time when W % 4 == 0 and S is 16-byte aligned, 4
// otherwise; *vec says which.  Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for arguments the kernel does
// not take.
int sw_banded_scores_launch(const float* table, int K, int code_bytes,
                            const void* codes1, const void* codes2,
                            const int32_t* n, const int32_t* m, int64_t B,
                            int64_t NP, int64_t MP, int W, float* S, int T,
                            int blocks, int* vec, void* stream) {
  if (B <= 0 || B > 65535 || NP <= 0 || MP <= 0 || W <= 0 || K <= 0 ||
      (code_bytes != 1 && code_bytes != 2) || T < 1 || T > sc::MAX_TILE ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  const sc::Args a{table, K, codes1, codes2, n, m, B, NP, MP, W, S, T,
                   sc::WIN_BYTES, sc::CHUNK_COLS, sc::tiles_of(NP, T)};
  *vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    return *vec ? launch<true, uint8_t>(a, blocks, st)
                : launch<false, uint8_t>(a, blocks, st);
  return *vec ? launch<true, int16_t>(a, blocks, st)
              : launch<false, int16_t>(a, blocks, st);
}

}  // extern "C"
