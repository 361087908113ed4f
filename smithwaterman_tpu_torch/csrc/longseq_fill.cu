// K3: the checkpointed score-only fill, and K4: the band refill, of the
// long-sequence route (smithwaterman_tpu_torch/ops/longseq.py).
//
// Replaces: smithwaterman_tpu/ops/pallas_dp.py fill_checkpointed (:890,
// pallas_call :935; _kernel with ckpt=True) by K3, and fill_band (:958,
// pallas_call :989; _kernel with seeded=True) by K4.
//
// What bounds them on an H100: the dependency chain inside one pair.  These
// pairs are long (tens of thousands of residues a side) and few; within a
// pair, cell (i, j) needs (i, j-1), (i-1, j) and (i-1, j-1).  Bytes are
// small: K3 writes 12 bytes per column every C rows, K4 one pointer byte
// per cell of its bands.
//
// What the design does about it: warps fill bands without block barriers
// per step and without shared memory per cell (sw_band.cuh): lane l owns
// R rows and at step k computes column k - l for them, taking the cell
// above its first row from lane l-1 by a shuffle.  Every cell gets the
// sequential fill's inputs and calls the same sw::cell, so values and
// pointer bytes are the sequential ones bit for bit; the LOCAL first
// maximum is each lane's first maximum under sw::better, merged in the
// same order.
//
// K3 fills a band with one warp (R = C / 32, blocks of one warp) and keeps
// a pair's bands in flight on many SMs at once: band kb+1 needs only
// checkpoint kb, which band kb stores a 32-column tile at a time and
// publishes (a per-band tile count, stored with release semantics after
// the tile's stores and a fence; read with acquire semantics, the
// checkpoint values then loaded through L2).  Persistent warps take bands
// in order (band-major over the pairs) by an atomic ticket, so a warp only
// ever waits on a band whose ticket was taken earlier by a warp already
// running: nothing deadlocks, whatever order the blocks are scheduled in.
// Each band writes its LOCAL best to a scratch slot and counts itself
// done; the last band of a pair merges them into the stats row (better is
// a total order, so the merge order does not matter).  The stats rows are
// zeroed before the launch; non-LOCAL, the band holding row n writes
// (M, X, Y) of cell (n, m).
//
// K4 refills G bands of every pair in one launch, a block of C / 32 warps
// of one row a lane a band: a band's refill needs only checkpoint sk-1,
// written by K3 in an earlier launch, so the bands are independent, and a
// warp of one-row lanes has a short step (a warp is a chain of m + 31
// dependent steps, latency-bound).  The warps of a band hand their bottom
// rows down through rings in shared memory, LAG steps apart, with a
// barrier every 32 steps.  A warp's 32 pointer bytes of a step are one
// diagonal's, so its store coalesces.
//
// Tables of at most sw::SMEM_K symbols are copied into shared memory,
// larger ones are read from device memory; codes are uint8, or int16 for
// tables past 255 symbols (the CODE template parameter).
#include <cuda_runtime.h>

#include "sw_band.cuh"

namespace {

constexpr unsigned kFull = sw::FULL;
using sw::shfl_cell;
using sw::shfl_up_cell;
using sw::warp_best;

// Waits until seed tile T of the warp may be read.
template <typename CODE>
__device__ __forceinline__ void await_tile(int T,
                                           const sw::BandIO<CODE>& io) {
  while (!sw::seed_ready(T, io)) __nanosleep(64);
}

// Warp w of a band's NW warps; returns lane l's LOCAL best.  TB (K4): the
// band is a block of one-row warps, every thread of the block runs the same
// block steps, warp w's step k at block step k + w * LAG, with a barrier
// every 32; else (K3) the band is one warp's.
template <int MODE, int R, bool TB, typename CODE>
__device__ sw::Best run_band(int l, int w, int NW, const sw::BandIO<CODE>& io,
                             const sw::Pen& p) {
  sw::Lane<R> L = sw::lane_begin<MODE, R>(l, io, p);
  sw::TileReg cur{}, nxt{};
  const int steps = sw::band_steps<R>(io);
  const int total = TB ? sw::block_steps(NW, io) : steps;
  for (int K = 0; K < total; ++K) {
    const int k = TB ? K - w * sw::LAG : K;
    if (!TB || (k >= 0 && k < steps)) {
      const int q = k & (sw::WARP - 1);
      if (k == 0) {
        await_tile(0, io);
        cur = sw::tile_fetch(l, 0, io, p);
      }
      if (q == sw::WARP / 2) {  // the next tile, half a tile ahead
        const int T = k / sw::WARP + 1;
        await_tile(T, io);
        nxt = sw::tile_fetch(l, T, io, p);
      }
      sw::Cell u = shfl_up_cell(L.left[R - 1]);
      int code = __shfl_up_sync(kFull, L.code, 1);
      const sw::Cell s0 = shfl_cell(cur.seed, q);
      const int c0 = __shfl_sync(kFull, cur.code, q);
      if (l == 0) {
        u = s0;
        code = c0;
      }
      L.code = code;
      sw::lane_step<MODE, R, TB ? sw::TB_SKEW : sw::TB_NONE>(l, k, &L, u,
                                                           io, p);
      if (TB) {
        sw::ring_put<R>(l, k, L, io);
      } else if (io.out_m) {
        const sw::Cell bottom = shfl_cell(L.left[R - 1], sw::WARP - 1);
        const int T = sw::ck_collect<R>(l, k, &L, bottom, io);
        if (T >= 0) {
          sw::ck_store<R>(l, T, L, io);
          __threadfence();
          __syncwarp();
          if (l == 0) sw::st_release(io.publish, T + 1);
        }
      }
      if (q == sw::WARP - 1) cur = nxt;
    }
    if (TB && (K & (sw::WARP - 1)) == sw::WARP - 1) __syncthreads();
  }
  return L.best;
}

template <typename CODE>
struct Pairs {
  const float* tab;
  int K;
  const CODE* codes1;
  const CODE* codes2;
  const int32_t* n;
  const int32_t* m;
  int64_t B, NP, MP, NCK;
};

// The part of band kb of pair b that warp w of NW owns, R rows a lane: warp
// 0 is seeded by the row above the band (row 0's closed form, or
// checkpoint kb-1), warp w > 0 by ring w-1 of `rings` (NW - 1 rings of
// 3 * RING floats); warp w < NW-1 writes ring w.
template <typename CODE>
__device__ sw::BandIO<CODE> band_io(const Pairs<CODE>& a, int64_t b, int kb,
                                    int C, int R, int w, int NW, float* rings,
                                    const float* ckm, const float* ckx,
                                    const float* cky) {
  sw::BandIO<CODE> io{};
  io.tab = a.tab;
  io.K = a.K;
  io.c1 = a.codes1 + b * a.NP;
  io.c2 = a.codes2 + b * a.MP;
  io.n = a.n[b];
  io.m = a.m[b];
  io.C = C;
  io.base = kb * C;
  io.r0 = w * sw::WARP * R;
  io.rows_w = sw::WARP * R;
  if (w > 0) {
    io.ring_in = rings + (w - 1) * 3 * sw::RING;
  } else if (kb > 0) {
    const int64_t prev = (b * a.NCK + kb - 1) * a.MP;
    io.seed_m = ckm + prev;
    io.seed_x = ckx + prev;
    io.seed_y = cky + prev;
  }
  if (w < NW - 1) io.ring_out = rings + w * 3 * sw::RING;
  return io;
}

template <int MODE, int R, typename CODE>
__global__ void __launch_bounds__(sw::WARP)
    ckpt_kernel(Pairs<CODE> a, float* ckm, float* ckx, float* cky,
                float* stats, int32_t* scratch, float og, float eg) {
  constexpr int C = sw::WARP * R;
  extern __shared__ float smem[];
  a.tab = sw::block_table(a.tab, a.K, smem);
  const int l = threadIdx.x;
  const sw::CkptScratch s = sw::ckpt_scratch(scratch, a.B, a.NCK);
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  const int64_t tickets = a.NCK * a.B;
  for (;;) {
    int t = 0;
    if (l == 0) t = atomicAdd(s.ticket, 1);
    t = __shfl_sync(kFull, t, 0);
    if (t >= tickets) return;
    const int kb = (int)(t / a.B);
    const int64_t b = t % a.B;
    const int n = a.n[b];
    if (kb * C >= n) continue;  // the pair has no rows in this band
    sw::BandIO<CODE> io =
        band_io(a, b, kb, C, R, 0, 1, nullptr, ckm, ckx, cky);
    if (kb > 0) io.wait = s.prog + b * a.NCK + kb - 1;
    if (io.base + C <= n) {  // a full band: its bottom row is checkpoint kb
      const int64_t row = (b * a.NCK + kb) * a.MP;
      io.out_m = ckm + row;
      io.out_x = ckx + row;
      io.out_y = cky + row;
      io.publish = s.prog + b * a.NCK + kb;
    }
    float* st = stats + b * sw::STATS_W;
    if (MODE != sw::LOCAL && n <= io.base + C) io.fin = st + 3;
    const sw::Best mine = run_band<MODE, R, false>(l, 0, 1, io, p);
    if (MODE != sw::LOCAL) continue;
    const sw::Best band = warp_best(mine);
    int before = 0;
    if (l == 0) {
      sw::put_best(s.best + 3 * (b * a.NCK + kb), band);
      __threadfence();
      before = atomicAdd(s.done + b, 1);
    }
    before = __shfl_sync(kFull, before, 0);
    const int nb = (n + C - 1) / C;
    if (before != nb - 1) continue;
    __threadfence();  // the last band of the pair: merge every band's best
    sw::Best all = sw::no_best();
    for (int q = l; q < nb; q += sw::WARP)
      all = sw::better(all, sw::get_best(s.best + 3 * (b * a.NCK + q)));
    all = warp_best(all);
    if (l == 0) sw::local_stats(all, st);
  }
}

template <int MODE, typename CODE>
__global__ void band_kernel(Pairs<CODE> a, int C, int sk0,
                            const float* __restrict__ ckm,
                            const float* __restrict__ ckx,
                            const float* __restrict__ cky, uint8_t* band,
                            float og, float eg) {
  extern __shared__ float smem[];
  a.tab = sw::block_table(a.tab, a.K, smem);
  float* rings = smem + (a.K <= sw::SMEM_K ? a.K * a.K : 0);
  const int NW = C / sw::WARP;
  const int l = threadIdx.x % sw::WARP, w = threadIdx.x / sw::WARP;
  const int64_t blk = blockIdx.x;  // band sk0 + g of pair b
  const int sk = sk0 + (int)(blk / a.B);
  const int64_t b = blk % a.B;
  if (sk * C >= a.n[b]) return;  // the pair has no rows in this band
  sw::BandIO<CODE> io =
      band_io(a, b, sk, C, 1, w, NW, rings, ckm, ckx, cky);
  io.tb = band + blk * sw::band_bytes(C, a.MP);
  run_band<MODE, 1, true>(l, w, NW, io, sw::make_pen<MODE>(og, eg));
}

template <int MODE, int R, typename CODE>
int launch_ckpt(const Pairs<CODE>& a, float* ckm, float* ckx, float* cky,
                float* stats, int32_t* scratch, float og, float eg,
                cudaStream_t st) {
  const size_t smem = sw::table_smem(a.K);
  auto kern = ckpt_kernel<MODE, R, CODE>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, sw::WARP,
                                                smem);
  const int64_t need = a.NCK * a.B;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(need < resident ? need : resident);
  cudaMemsetAsync(stats, 0, (size_t)a.B * sw::STATS_W * sizeof(float), st);
  kern<<<grid, sw::WARP, smem, st>>>(a, ckm, ckx, cky, stats, scratch, og,
                                     eg);
  return (int)cudaGetLastError();
}

template <int MODE, typename CODE>
int launch_band(const Pairs<CODE>& a, int C, int sk0, int G, const float* ckm,
                const float* ckx, const float* cky, uint8_t* band, float og,
                float eg, cudaStream_t st) {
  const int NW = sw::band_r(C);
  const size_t smem = sw::table_smem(a.K) +
                      (size_t)(NW - 1) * 3 * sw::RING * sizeof(float);
  band_kernel<MODE, CODE><<<(unsigned)(G * a.B), NW * sw::WARP, smem, st>>>(
      a, C, sk0, ckm, ckx, cky, band, og, eg);
  return (int)cudaGetLastError();
}

template <typename CODE>
Pairs<CODE> pairs(const float* table, int K, const void* codes1,
                  const void* codes2, const int32_t* n, const int32_t* m,
                  int64_t B, int64_t NP, int64_t MP, int C) {
  return {table, K, (const CODE*)codes1, (const CODE*)codes2, n, m,
          B, NP, MP, (NP + C - 1) / C};
}

bool bad_args(int64_t B, int K, int code_bytes, int C) {
  return B <= 0 || K <= 0 || (code_bytes != 1 && code_bytes != 2) ||
         (C != 32 && C != 64 && C != 128 && C != 256);
}

template <int MODE, typename CODE>
int launch_ckpt_r(const Pairs<CODE>& a, int C, float* ckm, float* ckx, float* cky,
           float* stats, int32_t* scratch, float og, float eg,
           cudaStream_t st) {
  switch (sw::band_r(C)) {
    case 1:
      return launch_ckpt<MODE, 1>(a, ckm, ckx, cky, stats, scratch, og, eg,
                                  st);
    case 2:
      return launch_ckpt<MODE, 2>(a, ckm, ckx, cky, stats, scratch, og, eg,
                                  st);
    case 4:
      return launch_ckpt<MODE, 4>(a, ckm, ckx, cky, stats, scratch, og, eg,
                                  st);
    default:
      return launch_ckpt<MODE, 8>(a, ckm, ckx, cky, stats, scratch, og, eg,
                                  st);
  }
}

template <typename CODE>
int ckpt_code(int mode, const float* table, int K, const void* codes1,
              const void* codes2, const int32_t* n, const int32_t* m,
              int64_t B, int64_t NP, int64_t MP, int C, float* ckm,
              float* ckx, float* cky, float* stats, int32_t* scratch,
              float og, float eg, cudaStream_t st) {
  const Pairs<CODE> a =
      pairs<CODE>(table, K, codes1, codes2, n, m, B, NP, MP, C);
  if (mode == sw::LOCAL)
    return launch_ckpt_r<sw::LOCAL>(a, C, ckm, ckx, cky, stats, scratch, og, eg, st);
  if (mode == sw::GLOCAL)
    return launch_ckpt_r<sw::GLOCAL>(a, C, ckm, ckx, cky, stats, scratch, og, eg,
                              st);
  if (mode == sw::GLOBAL)
    return launch_ckpt_r<sw::GLOBAL>(a, C, ckm, ckx, cky, stats, scratch, og, eg,
                              st);
  return (int)cudaErrorInvalidValue;
}

template <typename CODE>
int band_code(int mode, const float* table, int K, const void* codes1,
              const void* codes2, const int32_t* n, const int32_t* m,
              int64_t B, int64_t NP, int64_t MP, int C, int sk0, int G,
              const float* ckm, const float* ckx, const float* cky,
              uint8_t* band, float og, float eg, cudaStream_t st) {
  const Pairs<CODE> a =
      pairs<CODE>(table, K, codes1, codes2, n, m, B, NP, MP, C);
  if (sk0 < 0 || G < 1 || sk0 + G > a.NCK) return (int)cudaErrorInvalidValue;
  if (mode == sw::LOCAL)
    return launch_band<sw::LOCAL>(a, C, sk0, G, ckm, ckx, cky, band, og, eg,
                                  st);
  if (mode == sw::GLOCAL)
    return launch_band<sw::GLOCAL>(a, C, sk0, G, ckm, ckx, cky, band, og, eg,
                                   st);
  if (mode == sw::GLOBAL)
    return launch_band<sw::GLOBAL>(a, C, sk0, G, ckm, ckx, cky, band, og, eg,
                                   st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: B pairs, codes (B, NP) / (B, MP) of
// code_bytes-wide codes (1: uint8, 2: int16) below K, true lengths n, m
// (B,) int32, table (K, K) f32, C in {32, 64, 128, 256}; scratch:
// sw::ckpt_scratch_words(B, NCK) int32 words, zeroed; writes the
// checkpoints ckm, ckx, cky (B, NCK, MP) f32 with NCK = ceil(NP / C) (row k
// after global row (k+1)*C, columns < m, for (k+1)*C <= n) and stats (B, 8)
// f32.  Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_ckpt_fill_launch(int mode, const float* table, int K, int code_bytes,
                        const void* codes1, const void* codes2,
                        const int32_t* n, const int32_t* m, int64_t B,
                        int64_t NP, int64_t MP, int C, float* ckm, float* ckx,
                        float* cky, float* stats, int32_t* scratch, float og,
                        float eg, void* stream) {
  if (bad_args(B, K, code_bytes, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return code_bytes == 1
             ? ckpt_code<uint8_t>(mode, table, K, codes1, codes2, n, m, B, NP,
                                  MP, C, ckm, ckx, cky, stats, scratch, og,
                                  eg, st)
             : ckpt_code<int16_t>(mode, table, K, codes1, codes2, n, m, B, NP,
                                  MP, C, ckm, ckx, cky, stats, scratch, og,
                                  eg, st);
}

// Launches K4 on `stream`: refills bands sk0 .. sk0+G-1 (band sk: rows
// sk*C+1 .. sk*C+C) of every pair that has rows there, band sk seeded
// from checkpoint sk-1 (row 0's closed form for sk == 0), into band
// (G, B, (C + MP) * C) uint8 (sw_band.cuh layout; band sk0+g of pair b at
// [g, b]).  Same arguments otherwise, same return convention.
int sw_band_fill_launch(int mode, const float* table, int K, int code_bytes,
                        const void* codes1, const void* codes2,
                        const int32_t* n, const int32_t* m, int64_t B,
                        int64_t NP, int64_t MP, int C, int sk0, int G,
                        const float* ckm, const float* ckx, const float* cky,
                        uint8_t* band, float og, float eg, void* stream) {
  if (bad_args(B, K, code_bytes, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return code_bytes == 1
             ? band_code<uint8_t>(mode, table, K, codes1, codes2, n, m, B, NP,
                                  MP, C, sk0, G, ckm, ckx, cky, band, og, eg,
                                  st)
             : band_code<int16_t>(mode, table, K, codes1, codes2, n, m, B, NP,
                                  MP, C, sk0, G, ckm, ckx, cky, band, og, eg,
                                  st);
}

}  // extern "C"
