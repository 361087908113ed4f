// K1: the batched three-state affine DP fill, one warp per pair.
//
// Replaces: smithwaterman_tpu/ops/pallas_dp.py _kernel (:197) as called by
// fill_tiled (:705), traceback and score-only variants, together with the
// dense score precompute ops/batch.py scores_tiled (:39) that fed it.
//
// What bounds it on an H100: the dependency chain inside a pair.  Cell
// (i, j) needs (i, j-1), (i-1, j) and (i-1, j-1), a few dependent f32
// compares and adds each (22-27 operations, sw_cell.cuh cell); one pointer
// byte a cell is far below the card's bandwidth.  A batch of a few
// thousand pairs is a few thousand chains, about one warp's worth per
// scheduler if a pair were a thread.
//
// What the design does about it: a pair is a warp (sw_band.cuh).  Its rows
// are cut into stripes of C = 32 R rows, filled top to bottom; lane l owns
// R consecutive rows of a stripe and at step k computes column k - l of
// them, the cell above its first row handed over by lane l-1 with a
// shuffle, lane 0's from the stripe above's bottom row (row 0's closed
// form for the first stripe), which the bottom lane left in the pair's
// carry scratch: 12 bytes a column a stripe, not a cell.  seq2's codes
// and that seed row arrive a 32-column tile at a time.  Every cell gets
// the sequential fill's inputs and runs sw::cell, so values and pointer
// bytes are the sequential ones bit for bit; the LOCAL first maximum is
// each lane's first maximum under sw::better, merged across the warp.
// The pointer pool holds a pair's bytes together, row-major (D_CS = 1,
// D_RS a multiple of 4), and each lane packs four columns of each row into
// a register and stores words, so a warp's store touches 8 R lines, not
// 32 R.  A warp keeps a line a row of its stripe half written until its
// lanes pass the line's 128 columns, so R (1, 2, 4 or 8) is picked per
// launch (ops/fill_dp.stripe_rows) from the chunks' rows, the pairs and
// the pools written: the deepest stripe (fewest steps, fewest 31-step
// ramps: a few pairs are latency-bound) whose lines in flight fit in L2
// (many pairs: a shallow stripe, whose lines are not written back half
// filled).  One launch covers the pairs of one R (a list of descriptor
// rows, the costliest first).  A pair is a block of NW warps, stripe s on
// warp s mod NW: while the pairs fill the card NW = 1, so pairs spread
// over all SMs and the warp runs its stripes back to back; when they are
// few (ops/fill_dp.launch_plan), stripe s runs LAG steps (or a warp's
// cycle) behind stripe s - 1, the stripe above's bottom row handed over
// through the pair's two carry rows under the block's barrier every 32
// steps (K4's ring rule, sw_band.cuh stripe_gap), so one pair runs up to
// 32 stripes at once.
// The substitution score comes from a shared-memory copy of the (K, K)
// table (device memory past sw::SMEM_K symbols), so the dense score
// tensor is never built; codes are uint8, or int16 for tables past 255
// symbols (the CODE template parameter).
//
// K10: the same kernel with RUNS, replacing pallas_dp.py _kernel's
// emit_runs branch (:505-547) as called by fill_tiled(emit_runs=True)
// (:820).  Besides the pointer byte it writes each cell's match-run byte
// (sw_cell.cuh run_byte) into a second pool in the pointer pool's layout,
// which the token walk (token_walk.cu, K11) reads.  The diagonal's run byte
// travels as the diagonal's values do (registers, lane l-1's shuffle, the
// seed row), so K10 reads no pool back.  K1 is the RUNS = false
// specialization.
#include <cuda_runtime.h>

#include "sw_band.cuh"

namespace {

// A warp's stripe in flight: its inputs, its lanes and its seed tiles.
template <int R, typename CODE>
struct Stripe {
  sw::BandIO<CODE> io;
  sw::Lane<R> L;
  sw::TileReg cur, nxt;
  int steps;
};

template <int MODE, int R, typename CODE>
__device__ __forceinline__ void stripe_begin(int l, int s,
                                             const sw::BandIO<CODE>& io,
                                             float* carry, bool two,
                                             const sw::Pen& p,
                                             Stripe<R, CODE>* t) {
  __syncwarp();  // one warp a pair: the stripe above's row, its own stores
  t->io = sw::stripe_io<R>(io, s, carry, two);
  t->steps = sw::band_steps<R>(t->io);
  t->L = sw::lane_begin<MODE, R>(l, t->io, p);
  t->cur = sw::tile_fetch(l, 0, t->io, p);
}

// Step k of lane l in its warp's stripe.
template <int MODE, int R, bool TB, bool RUNS, typename CODE>
__device__ __forceinline__ void stripe_step(int l, int k,
                                            Stripe<R, CODE>* t,
                                            const sw::Pen& p) {
  const int q = k & (sw::WARP - 1);
  if (q == sw::WARP / 2)  // the next tile, half a tile ahead
    t->nxt = sw::tile_fetch(l, k / sw::WARP + 1, t->io, p);
  sw::Cell u = sw::shfl_up_cell(t->L.left[R - 1]);
  int code = __shfl_up_sync(sw::FULL, t->L.code, 1);
  uint32_t ru = RUNS ? __shfl_up_sync(sw::FULL, t->L.rleft[R - 1], 1) : 0u;
  const sw::Cell s0 = sw::shfl_cell(t->cur.seed, q);
  const int c0 = __shfl_sync(sw::FULL, t->cur.code, q);
  const uint32_t r0 = RUNS ? __shfl_sync(sw::FULL, t->cur.run, q) : 0u;
  if (l == 0) {
    u = s0;
    code = c0;
    ru = r0;
  }
  t->L.code = code;
  sw::lane_step<MODE, R, TB ? sw::TB_ROWS : sw::TB_NONE, RUNS>(l, k, &t->L,
                                                                u, t->io, p,
                                                                ru);
  sw::stripe_put<R, RUNS>(l, k, t->L, t->io);
  if (q == sw::WARP - 1) t->cur = t->nxt;
}

// The pair's stats row: zeroed by the caller before the fill; non-LOCAL
// slots 3-5 come from the lane holding (n, m), LOCAL's first three from
// `best`, every warp's merged (by warp 0 through shared memory `slot`
// when NW > 1).
template <int MODE, bool TB>
__device__ __forceinline__ void finish(sw::Best best, int NW, sw::Best* slot,
                                       float* st) {
  if (MODE != sw::LOCAL) return;
  const int l = threadIdx.x % sw::WARP, w = threadIdx.x / sw::WARP;
  best = sw::warp_best(best);
  if (NW > 1) {
    if (l == 0) slot[w] = best;
    __syncthreads();
    if (w == 0) best = sw::warp_best(l < NW ? slot[l] : sw::no_best());
  }
  if (threadIdx.x == 0) {
    st[0] = best.v;
    if (TB) {
      st[1] = (float)best.i;
      st[2] = (float)best.j;
    }
  }
}

// The block's barrier after block step B when B mod 32 == 31, with more
// than one warp (sw_band.cuh stripe_gap); NW is the same for the block.
__device__ __forceinline__ void block_step_done(int B, int NW) {
  if (NW > 1 && (B & (sw::WARP - 1)) == sw::WARP - 1) __syncthreads();
}

// Pair order[blockIdx.x], a block of NW warps: warp w fills stripes w,
// w + NW, ..., stripe s running its step k at block step s * stripe_gap + k
// (one warp: its stripes back to back, in one carry row), each warp
// counting the block steps it idles through for the barriers.
template <int MODE, int R, bool TB, bool RUNS, typename CODE>
__global__ void fill_kernel(const float* __restrict__ table, int K,
                            const CODE* __restrict__ codes1,
                            const CODE* __restrict__ codes2,
                            const int64_t* __restrict__ desc,
                            const int32_t* __restrict__ order, uint8_t* tb,
                            uint8_t* run, float* carry, float* stats,
                            float og, float eg, int NW) {
  extern __shared__ float smem[];
  const int l = threadIdx.x % sw::WARP, w = threadIdx.x / sw::WARP;
  const int64_t b = order[blockIdx.x];
  const int64_t* d = desc + b * sw::DESC_W;
  float* st = stats + b * sw::STATS_W;
  // zeroed before block_table's barrier, which precedes every fill step
  if (threadIdx.x < sw::STATS_W) st[threadIdx.x] = 0.0f;
  const float* tab = sw::block_table(table, K, smem);
  const sw::BandIO<CODE> io = sw::fill_io<MODE>(tab, K, codes1, codes2, d,
                                                TB ? tb : nullptr,
                                                RUNS ? run : nullptr, st);
  const sw::Pen p = sw::make_pen<MODE>(og, eg);
  float* cy = carry + d[sw::D_CARRY];
  const bool two = NW > 1;
  const int S = sw::stripes(io.n, R);
  const int gap = sw::stripe_gap(NW, S, io.m + sw::WARP - 1);
  sw::Best best = sw::no_best();
  Stripe<R, CODE> t;
  int B = 0;
  for (int s = w; s < S; s += NW) {
    for (; B < s * gap; ++B) block_step_done(B, NW);
    stripe_begin<MODE, R>(l, s, io, cy, two, p, &t);
    for (int k = 0; k < t.steps; ++k, ++B) {
      stripe_step<MODE, R, TB, RUNS>(l, k, &t, p);
      block_step_done(B, NW);
    }
    best = sw::better(best, t.L.best);
  }
  if (two) {
    const int total = (S - 1) * gap +
                      sw::band_steps<R>(sw::stripe_io<R>(io, S - 1, cy, two));
    for (; B < total; ++B) block_step_done(B, NW);
  }
  finish<MODE, TB>(
      best, NW,
      reinterpret_cast<sw::Best*>(smem + (K <= sw::SMEM_K ? K * K : 0)), st);
}

struct Args {
  const float* table;
  int K;
  const void* codes1;
  const void* codes2;
  const int64_t* desc;
  const int32_t* order;
  int64_t B;
  uint8_t* tb;
  uint8_t* run;
  float* carry;
  float* stats;
  float og, eg;
  int NW;
  cudaStream_t st;
};

template <int MODE, int R, bool TB, bool RUNS, typename CODE>
int launch(const Args& a) {
  auto kern = fill_kernel<MODE, R, TB, RUNS, CODE>;
  // as many warps a pair as asked, within what the kernel's registers let
  // a block have
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  const int cap = fa.maxThreadsPerBlock / sw::WARP;
  const int NW = a.NW < cap ? a.NW : cap;
  const size_t smem = sw::table_smem(a.K) + NW * sizeof(sw::Best);
  kern<<<(unsigned)a.B, NW * sw::WARP, smem, a.st>>>(
      a.table, a.K, (const CODE*)a.codes1, (const CODE*)a.codes2, a.desc,
      a.order, a.tb, a.run, a.carry, a.stats, a.og, a.eg, NW);
  return (int)cudaGetLastError();
}

template <int MODE, int R, typename CODE>
int launch_out(int traceback, const Args& a) {
  if (a.run) return launch<MODE, R, true, true, CODE>(a);
  if (traceback) return launch<MODE, R, true, false, CODE>(a);
  return launch<MODE, R, false, false, CODE>(a);
}

template <int MODE, typename CODE>
int launch_r(int traceback, int R, const Args& a) {
  switch (R) {
    case 1:
      return launch_out<MODE, 1, CODE>(traceback, a);
    case 2:
      return launch_out<MODE, 2, CODE>(traceback, a);
    case 4:
      return launch_out<MODE, 4, CODE>(traceback, a);
    case 8:
      return launch_out<MODE, 8, CODE>(traceback, a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename CODE>
int launch_mode(int mode, int traceback, int R, const Args& a) {
  if (mode == sw::LOCAL) return launch_r<sw::LOCAL, CODE>(traceback, R, a);
  if (mode == sw::GLOCAL) return launch_r<sw::GLOCAL, CODE>(traceback, R, a);
  if (mode == sw::GLOBAL) return launch_r<sw::GLOBAL, CODE>(traceback, R, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over the B pairs order[0 .. B-1], rows of desc
// (·, 8) int64 (sw_cell.cuh Desc; D_CS = 1, D_RS and D_TB multiples of 4),
// with R rows a lane (1, 2, 4 or 8) and NW warps a pair (at least 1; as
// many as the kernel's registers allow a block, at most).  table: (K, K) f32; codes: flat
// buffers of code_bytes-wide codes (1: uint8, 2: int16), each below K; tb:
// uint8 pool (ignored when traceback == 0); run: NULL, or a second uint8
// pool in tb's layout that receives each cell's match-run byte (K10, which
// needs traceback); carry: f32 scratch, sw::carry_floats(D_RS) at each
// pair's D_CARRY; stats: (·, 8) f32, the rows of the pairs filled.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_fill_launch(int mode, int traceback, int R, int NW,
                   const float* table, int K, int code_bytes,
                   const void* codes1, const void* codes2,
                   const int64_t* desc, const int32_t* order, int64_t B,
                   uint8_t* tb, uint8_t* run, float* carry, float* stats,
                   float og, float eg, void* stream) {
  if (B <= 0 || B > 0x7fffffff || K <= 0 || NW < 1 || (run && !traceback) ||
      (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const Args a{table, K,     codes1, codes2, desc, order, B,  tb,
               run,   carry, stats,  og,     eg,   NW,    (cudaStream_t)stream};
  return code_bytes == 1 ? launch_mode<uint8_t>(mode, traceback, R, a)
                         : launch_mode<int16_t>(mode, traceback, R, a);
}

}  // extern "C"
