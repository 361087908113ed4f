// K3: the checkpointed score-only fill, and K4: the band refill, of the
// long-sequence route (smithwaterman_tpu_torch/ops/longseq.py).
//
// Replaces: smithwaterman_tpu/ops/pallas_dp.py fill_checkpointed (:890,
// pallas_call :935; _kernel with ckpt=True) by K3, and fill_band (:958,
// pallas_call :989; _kernel with seeded=True) by K4.
//
// What bounds them on an H100: the dependency chain inside one pair.  These
// pairs are long (tens of thousands of residues a side) and few, so one
// thread per pair (K1's design) would leave the card idle and take minutes
// per pass.  Within a pair, cell (i, j) needs (i, j-1), (i-1, j) and
// (i-1, j-1); the cells of one anti-diagonal are independent.  Bytes are
// small: K3 writes 12 bytes per column every C rows, K4 one pointer byte
// per cell of its band.
//
// What the design does about it: one block of C threads per pair runs a
// wavefront over a band of C rows (sw_band.cuh): thread t owns row
// base + t + 1 and at step k computes column k - t + 1, taking the cell
// above from thread t-1 through shared memory, one barrier per step.  Every
// cell gets the sequential fill's inputs and calls the same sw::cell, so
// values and pointer bytes are the sequential ones bit for bit; the LOCAL
// first maximum is each thread's strict-`>` first maximum merged in
// (value, i, j) order (sw::better).  K3 loops over the pair's bands inside
// the block and stores each full band's bottom row as checkpoint k (the row
// after global row (k+1)*C); K4 refills one band of every pair from its
// seed (row 0's closed form for band 0, else checkpoint sk-1) and writes
// the band's pointer bytes skewed, so each step's C stores are contiguous.
// Only as many SMs work as there are pairs, and a band's first and last
// C-1 steps leave threads idle; pipelining one pair's bands across blocks
// is later work.  The substitution table lives in shared memory, as in K1.
#include <cuda_runtime.h>

#include "sw_band.cuh"

namespace {

struct Smem {
  float* tab;
  sw::BandSmem band;
  sw::Best* best;
};

// Dynamic shared memory: the (K, K) table, then up[2C] and seed[2C] cells,
// best[C], code[4C] bytes.
__host__ __device__ size_t smem_bytes(int K, int C) {
  return (size_t)K * K * sizeof(float) + (size_t)4 * C * sizeof(sw::Cell) +
         (size_t)C * sizeof(sw::Best) + (size_t)4 * C;
}

__device__ Smem carve(unsigned char* raw, int K, int C) {
  Smem s;
  s.tab = (float*)raw;
  s.band.up = (sw::Cell*)(s.tab + K * K);
  s.band.seed = s.band.up + 2 * C;
  s.best = (sw::Best*)(s.band.seed + 2 * C);
  s.band.code = (uint8_t*)(s.best + C);
  return s;
}

// One band of one pair, by all C threads of the block.
template <int MODE>
__device__ void run_band(int C, const sw::BandIO& io, const sw::Pen& p,
                         const sw::BandSmem& sm, sw::Best* best) {
  const int t = threadIdx.x;
  sw::Lane L = sw::lane_begin<MODE>(t, C, io, p);
  sw::tile_put(t, C, 0, L, sm);
  __syncthreads();
  const int steps = sw::band_steps(C, io);
  for (int k = 0; k < steps; ++k) {
    sw::band_step<MODE>(t, C, k, io, p, &L, sm, best);
    __syncthreads();
  }
}

template <int MODE>
__global__ void ckpt_kernel(const float* __restrict__ table, int K,
                            const uint8_t* __restrict__ codes1,
                            const uint8_t* __restrict__ codes2,
                            const int32_t* __restrict__ n_,
                            const int32_t* __restrict__ m_, int64_t NP,
                            int64_t MP, int C, int64_t NCK, float* ckm,
                            float* ckx, float* cky, float* stats, float og,
                            float eg) {
  extern __shared__ unsigned char raw[];
  const Smem s = carve(raw, K, C);
  const int t = threadIdx.x;
  for (int q = t; q < K * K; q += blockDim.x) s.tab[q] = table[q];
  const int64_t b = blockIdx.x;
  float* st = stats + b * sw::STATS_W;
  if (t == 0)
    for (int q = 0; q < sw::STATS_W; ++q) st[q] = 0.0f;
  __syncthreads();
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  sw::BandIO io;
  io.tab = s.tab;
  io.K = K;
  io.c1 = codes1 + b * NP;
  io.c2 = codes2 + b * MP;
  io.n = n_[b];
  io.m = m_[b];
  io.tb = nullptr;
  io.fin = MODE == sw::LOCAL ? nullptr : st + 3;
  sw::Best best = sw::no_best();
  const int nb = (io.n + C - 1) / C;
  for (int kb = 0; kb < nb; ++kb) {
    io.base = kb * C;
    const int64_t prev = (b * NCK + kb - 1) * MP, row = (b * NCK + kb) * MP;
    io.seed_m = kb ? ckm + prev : nullptr;
    io.seed_x = kb ? ckx + prev : nullptr;
    io.seed_y = kb ? cky + prev : nullptr;
    io.out_m = ckm + row;
    io.out_x = ckx + row;
    io.out_y = cky + row;
    run_band<MODE>(C, io, p, s.band, &best);
  }
  if (MODE == sw::LOCAL) {
    s.best[t] = best;
    __syncthreads();
    if (t == 0) sw::finish_stats(true, s.best, C, st);
  }
}

template <int MODE>
__global__ void band_kernel(const float* __restrict__ table, int K,
                            const uint8_t* __restrict__ codes1,
                            const uint8_t* __restrict__ codes2,
                            const int32_t* __restrict__ n_,
                            const int32_t* __restrict__ m_, int64_t NP,
                            int64_t MP, int C, int64_t NCK, int sk,
                            const float* __restrict__ ckm,
                            const float* __restrict__ ckx,
                            const float* __restrict__ cky, uint8_t* band,
                            float og, float eg) {
  const int64_t b = blockIdx.x;
  const int base = sk * C;
  const int n = n_[b];
  if (base >= n) return;  // the pair has no row in this band
  extern __shared__ unsigned char raw[];
  const Smem s = carve(raw, K, C);
  for (int q = threadIdx.x; q < K * K; q += blockDim.x) s.tab[q] = table[q];
  __syncthreads();
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  sw::BandIO io;
  io.tab = s.tab;
  io.K = K;
  io.c1 = codes1 + b * NP;
  io.c2 = codes2 + b * MP;
  io.n = n;
  io.m = m_[b];
  io.base = base;
  const int64_t prev = (b * NCK + sk - 1) * MP;
  io.seed_m = sk ? ckm + prev : nullptr;
  io.seed_x = sk ? ckx + prev : nullptr;
  io.seed_y = sk ? cky + prev : nullptr;
  io.tb = band + b * sw::band_bytes(C, MP);
  io.out_m = io.out_x = io.out_y = nullptr;
  io.fin = nullptr;
  run_band<MODE>(C, io, p, s.band, nullptr);
}

bool bad_args(int64_t B, int K, int C) {
  // C threads, a power of two (the tile rings index by masks), and the
  // shared memory within the 48 KiB a block gets without opting in
  return B <= 0 || K <= 0 || K > 64 || C < 32 || C > 512 || (C & (C - 1)) ||
         smem_bytes(K, C) > 48 * 1024;
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: B pairs, codes (B, NP) / (B, MP) uint8, true
// lengths n, m (B,) int32, table (K, K) f32; writes the checkpoints ckm,
// ckx, cky (B, NCK, MP) f32 with NCK = ceil(NP / C) (row k after global
// row (k+1)*C, columns < m, for (k+1)*C <= n) and stats (B, 8) f32.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_ckpt_fill_launch(int mode, const float* table, int K,
                        const uint8_t* codes1, const uint8_t* codes2,
                        const int32_t* n, const int32_t* m, int64_t B,
                        int64_t NP, int64_t MP, int C, float* ckm, float* ckx,
                        float* cky, float* stats, float og, float eg,
                        void* stream) {
  if (bad_args(B, K, C)) return (int)cudaErrorInvalidValue;
  const int64_t NCK = (NP + C - 1) / C;
  const size_t smem = smem_bytes(K, C);
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CKPT(MODE)                                                      \
  ckpt_kernel<MODE><<<(unsigned)B, C, smem, st>>>(                         \
      table, K, codes1, codes2, n, m, NP, MP, C, NCK, ckm, ckx, cky, stats, \
      og, eg)
  if (mode == sw::LOCAL)
    SW_CKPT(sw::LOCAL);
  else if (mode == sw::GLOCAL)
    SW_CKPT(sw::GLOCAL);
  else if (mode == sw::GLOBAL)
    SW_CKPT(sw::GLOBAL);
  else
    return (int)cudaErrorInvalidValue;
#undef SW_CKPT
  return (int)cudaGetLastError();
}

// Launches K4 on `stream`: refills band sk (rows sk*C+1 .. sk*C+C) of every
// pair that has rows there, seeded from checkpoint sk-1 (row 0's closed
// form for sk == 0), into band (B, (C + MP) * C) uint8 (sw_band.cuh
// layout).  Same return convention.
int sw_band_fill_launch(int mode, const float* table, int K,
                        const uint8_t* codes1, const uint8_t* codes2,
                        const int32_t* n, const int32_t* m, int64_t B,
                        int64_t NP, int64_t MP, int C, int sk,
                        const float* ckm, const float* ckx, const float* cky,
                        uint8_t* band, float og, float eg, void* stream) {
  if (bad_args(B, K, C) || sk < 0) return (int)cudaErrorInvalidValue;
  const int64_t NCK = (NP + C - 1) / C;
  const size_t smem = smem_bytes(K, C);
  cudaStream_t st = (cudaStream_t)stream;
#define SW_BAND(MODE)                                                    \
  band_kernel<MODE><<<(unsigned)B, C, smem, st>>>(                       \
      table, K, codes1, codes2, n, m, NP, MP, C, NCK, sk, ckm, ckx, cky, \
      band, og, eg)
  if (mode == sw::LOCAL)
    SW_BAND(sw::LOCAL);
  else if (mode == sw::GLOCAL)
    SW_BAND(sw::GLOCAL);
  else if (mode == sw::GLOBAL)
    SW_BAND(sw::GLOBAL);
  else
    return (int)cudaErrorInvalidValue;
#undef SW_BAND
  return (int)cudaGetLastError();
}

}  // extern "C"
