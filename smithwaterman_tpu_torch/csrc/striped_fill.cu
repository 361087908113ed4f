// K12: the striped block fill, and K13: the single-device grid fill.
//
// Replaces: smithwaterman_tpu/parallel/seq_tiled.py _block_pallas_call
// (:821, pallas_call :846; body _make_block_kernel :287-442) and its B = 1
// sublane-folded form _block_pallas_call_folded (:586, :610; body
// _make_block_kernel_folded :445-583), which are both K12 here (the fold is
// a TPU register layout; on the card B = 1 is K12 with one block a shard);
// and _fold_grid_fill (:765, :806; body _make_grid_kernel_folded
// :621-762), which is K13.  The row rule is sw_striped.cuh's.
//
// K12 computes K rows of every shard of a launch, for B pairs, at one step
// t of the wavefront: shard d runs its row block r = t - d, reading its left
// edges from shard d-1's outbox of step t-1 and writing its own for shard
// d+1 (the boxes alternate by step parity, so a launch that holds both
// shards reads and writes different ones).  Per (shard, pair) state lives
// in global memory between launches: the (M, X, Y) rows by row parity, the
// above edge, the LOCAL per-lane best and its row, the non-LOCAL
// accumulator; the pointer bytes of a traceback band go straight to uint8.
// K13 computes the whole D = 1 fill of NP rows in one launch, one block a
// pair, writing the carries every C rows and keeping the LOCAL per-lane best
// or the non-LOCAL accumulator; it reads f32 or int8 scores (widened in the
// kernel, as the JAX kernel does).  The lanes' merge is PyTorch code.
//
// What bounds them on an H100: the chain of rows.  Row i needs row i-1 and,
// through X, every lane to its left in the same row, so a shard's rows run
// in order; a row of W lanes is ~60 f32 operations and 4-5 bytes a lane.
// With one block a (shard, pair), a launch keeps at most D * B SMs busy.
//
// What the design does about it: one block of THREADS threads per (shard,
// pair) walks each row in column tiles of TILE lanes, each thread owning
// LANES adjacent lanes of a tile, so a warp touches consecutive addresses:
// per tile, phase A (M, Y, their pointer bits and h's prefix over the
// thread's lanes), a block-wide exclusive max scan (its warp totals double
// buffered by tile parity), phase C (X, its pointer, the best or the final
// cell, the edge out) with the prefix carried from the earlier tiles; a
// barrier ends the row.
// Spreading one pair's shards over more blocks of the card (a wavefront
// across blocks) is later work (ROADMAP Queue D).
#include <cuda_runtime.h>

#include "sw_striped.cuh"

namespace {

namespace st = sw::striped;

// The shards of one K12 launch, passed by value in its parameters.
struct Shards {
  int d[st::MAX_SHARDS];
};

template <int MODE, bool TB>
__global__ void __launch_bounds__(st::THREADS)
    block_kernel(Shards shards, st::BlockArgs a) {
  __shared__ float warp_max[2][st::WARPS];
  const int t = threadIdx.x;
  const int d = shards.d[blockIdx.x];
  const int64_t b = blockIdx.y;
  const st::Block k = st::block_at(a, d, b);
  const int n = a.n[b], m = a.m[b];
  sw::Cell ab = k.in ? sw::Cell{k.above[0], k.above[1], k.above[2]}
                     : st::column0(k.i_start, a.p);
  for (int q = 0; q < a.K; ++q) {
    const int i = k.i_start + q + 1;
    const float* in = k.in ? k.in + 4 * q : nullptr;
    const st::Row r = st::row_begin<MODE>(a.p, i, k.col0, n, m, ab, in);
    const st::Buf up = st::row_buf(a.rows, a.B, a.MP, b, k.col0, i - 1);
    const st::Buf cur = st::row_buf(a.rows, a.B, a.MP, b, k.col0, i);
    uint8_t* tb = TB ? st::block_tb(a, k, b, i) : nullptr;
    float carry = sw::NEG;  // h's maximum over the row's earlier tiles
    for (int j = 0; j < st::tiles(a.W); ++j) {
      st::Left left;
      const float own = st::phase_a<MODE, TB>(
          t, j, a.W, a.p, r, st::block_scores(a, k, b, i), up, cur, tb,
          &left);
      float total;
      const float excl = sw::banded::block_excl_max<st::WARPS>(
          own, warp_max[j & 1], sw::NEG, &total);
      st::phase_c<MODE, TB>(t, j, a.W, a.p, r, sw::mx(carry, excl), left,
                            cur, tb, a.best + b * a.MP + k.col0,
                            a.best_i + b * a.MP + k.col0, k.acc,
                            k.out + 4 * q);
      carry = sw::mx(carry, total);
    }
    __syncthreads();
    ab = in ? sw::Cell{in[0], in[1], in[2]} : st::column0(i, a.p);
  }
  if (k.in && t == 0) {
    k.above[0] = ab.m;
    k.above[1] = ab.x;
    k.above[2] = ab.y;
  }
}

template <int MODE, typename ST>
__global__ void __launch_bounds__(st::THREADS)
    grid_kernel(const ST* __restrict__ S, int64_t NP, int64_t MP,
                const int32_t* __restrict__ n_,
                const int32_t* __restrict__ m_, int C, float* rows,
                float* best, int32_t* best_i, float* acc, float* ckm,
                float* ckx, float* cky, st::Pen p) {
  __shared__ float warp_max[2][st::WARPS];
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t B = gridDim.x;
  const int n = n_[b], m = m_[b];
  const int W = (int)MP;
  float* bst = best + b * MP;
  int32_t* bsi = best_i + b * MP;
  float* ac = acc + b * 4;
  const int nt = st::tiles(W);
  const st::Buf r0 = st::row_buf(rows, B, MP, b, 0, 0);
  for (int j = 0; j < nt; ++j) {
    int w0, w1;
    st::lanes(t, j, W, &w0, &w1);
    for (int w = w0; w < w1; ++w) {
      const sw::Cell c = st::row0(w + 1, p);
      r0.m[w] = c.m;
      r0.x[w] = c.x;
      r0.y[w] = c.y;
      bst[w] = sw::NEG;
      bsi[w] = st::BIGI;
    }
  }
  if (t == 0)
    for (int q = 0; q < 4; ++q) ac[q] = 0.0f;
  __syncthreads();
  const int64_t nck = C ? NP / C : 0;
  for (int i = 1; i <= (int)NP; ++i) {
    const st::Row r =
        st::row_begin<MODE>(p, i, 0, n, m, st::column0(i - 1, p), nullptr);
    const st::Buf up = st::row_buf(rows, B, MP, b, 0, i - 1);
    const st::Buf cur = st::row_buf(rows, B, MP, b, 0, i);
    const ST* srow = S + (b * NP + i - 1) * MP;
    float carry = sw::NEG;  // h's maximum over the row's earlier tiles
    for (int j = 0; j < nt; ++j) {
      st::Left left;
      const float own =
          st::phase_a<MODE, false>(t, j, W, p, r, srow, up, cur, nullptr,
                                   &left);
      float total;
      const float excl = sw::banded::block_excl_max<st::WARPS>(
          own, warp_max[j & 1], sw::NEG, &total);
      st::phase_c<MODE, false>(t, j, W, p, r, sw::mx(carry, excl), left, cur,
                               nullptr, bst, bsi, ac, nullptr);
      carry = sw::mx(carry, total);
    }
    if (C && i % C == 0) {
      const int64_t o = (b * nck + i / C - 1) * MP;
      for (int j = 0; j < nt; ++j) {
        int w0, w1;
        st::lanes(t, j, W, &w0, &w1);
        for (int w = w0; w < w1; ++w) {
          ckm[o + w] = cur.m[w];
          ckx[o + w] = cur.x[w];
          cky[o + w] = cur.y[w];
        }
      }
    }
    __syncthreads();
  }
}

st::Pen pen(float og, float eg, float so, float se, float sent, float sose) {
  return st::Pen{og, eg, so, se, sent, sose};
}

template <int MODE>
void launch_block(bool tb, unsigned nds, const Shards& sh,
                  const st::BlockArgs& a, cudaStream_t s) {
  const dim3 grid(nds, (unsigned)a.B);
  if (tb)
    block_kernel<MODE, true><<<grid, st::THREADS, 0, s>>>(sh, a);
  else
    block_kernel<MODE, false><<<grid, st::THREADS, 0, s>>>(sh, a);
}

template <int MODE>
void launch_grid(bool s_int8, const void* S, int64_t B, int64_t NP,
                 int64_t MP, const int32_t* n, const int32_t* m, int C,
                 float* rows, float* best, int32_t* best_i, float* acc,
                 float* ckm, float* ckx, float* cky, const st::Pen& p,
                 cudaStream_t s) {
  if (s_int8)
    grid_kernel<MODE, int8_t><<<(unsigned)B, st::THREADS, 0, s>>>(
        (const int8_t*)S, NP, MP, n, m, C, rows, best, best_i, acc, ckm, ckx,
        cky, p);
  else
    grid_kernel<MODE, float><<<(unsigned)B, st::THREADS, 0, s>>>(
        (const float*)S, NP, MP, n, m, C, rows, best, best_i, acc, ckm, ckx,
        cky, p);
}

}  // namespace

extern "C" {

// Launches K12 on `stream`: step t of the wavefront for the nds shards
// listed in ds (a host array; each d in 0..D-1 with 0 <= t - d < NB), one
// block per (shard, pair).  Shard d computes global rows i0 + r*K + 1 ..
// i0 + r*K + K (r = t - d) at columns [d*W, d*W + W) of B pairs:
//   S:      f32 scores of row i0 + 1 at column s_lo, pair stride s_b, row
//           stride s_r (unit column stride);
//   n, m:   (B,) int32 true lengths;
//   rows:   (2, 3, B, MP) f32, row i's (M, X, Y) in [i & 1], read at row
//           i0 + r*K and written through the block's last row;
//   box:    (2, D, B, K, 4) f32: shard d reads [(t-1) & 1][d-1] (d > 0)
//           and writes [t & 1][d], the [M, X, Y, C] at its last column;
//   above:  (D, B, 4) f32, [M, X, Y] at (i0 + r*K, d*W), read and
//           advanced by shards d > 0;
//   best, best_i: (B, MP) f32 / int32 LOCAL per-lane best and its row;
//   acc:    (D, B, 4) f32, the non-LOCAL (M, X, Y) of cell (n, m);
//   tb:     (B, tb_rows, MP) uint8 pointer bytes of rows i0 + 1 .. (when
//           emit_tb), row i at [i - i0 - 1].
// og .. sose are the penalty constants (sw_striped.cuh Pen).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sw_striped_block_launch(int mode, int emit_tb, const int32_t* ds,
                            int nds, int t, int i0, int K, int W, int D,
                            int64_t B, int64_t MP, const float* S,
                            int64_t s_b, int64_t s_r, int64_t s_lo,
                            const int32_t* n, const int32_t* m, float* rows,
                            float* box, float* above, float* best,
                            int32_t* best_i, float* acc, uint8_t* tb,
                            int64_t tb_rows, float og, float eg, float so,
                            float se, float sent, float sose, void* stream) {
  if (nds <= 0 || nds > st::MAX_SHARDS || K <= 0 || W <= 0 || D <= 0 ||
      B <= 0 || B > 65535 || (int64_t)W * D != MP || (emit_tb && !tb))
    return (int)cudaErrorInvalidValue;
  Shards sh;
  for (int q = 0; q < nds; ++q) {
    if (ds[q] < 0 || ds[q] >= D || t - ds[q] < 0)
      return (int)cudaErrorInvalidValue;
    sh.d[q] = ds[q];
  }
  st::BlockArgs a;
  a.t = t;
  a.i0 = i0;
  a.K = K;
  a.W = W;
  a.D = D;
  a.B = B;
  a.MP = MP;
  a.S = S;
  a.s_b = s_b;
  a.s_r = s_r;
  a.s_lo = s_lo;
  a.n = n;
  a.m = m;
  a.rows = rows;
  a.box = box;
  a.above = above;
  a.best = best;
  a.best_i = best_i;
  a.acc = acc;
  a.tb = emit_tb ? tb : nullptr;
  a.tb_rows = tb_rows;
  a.p = pen(og, eg, so, se, sent, sose);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == sw::LOCAL)
    launch_block<sw::LOCAL>(emit_tb != 0, (unsigned)nds, sh, a, s);
  else if (mode == sw::GLOCAL)
    launch_block<sw::GLOCAL>(emit_tb != 0, (unsigned)nds, sh, a, s);
  else if (mode == sw::GLOBAL)
    launch_block<sw::GLOBAL>(emit_tb != 0, (unsigned)nds, sh, a, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Launches K13 on `stream`: the single-device fill of B pairs, one block a
// pair, over all NP rows and MP columns:
//   S:      (B, NP, MP) scores, f32 or (s_int8) int8;
//   n, m:   (B,) int32 true lengths;
//   rows:   (2, 3, B, MP) f32 scratch;
//   best, best_i: (B, MP) f32 / int32, the LOCAL per-lane best and its row;
//   acc:    (B, 4) f32, the non-LOCAL (M, X, Y) of cell (n, m);
//   ckm, ckx, cky: (B, NP / C, MP) f32, the carries after row (k+1)*C in
//           row k, when C > 0 (NP % C == 0).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
int sw_striped_grid_launch(int mode, int s_int8, const void* S, int64_t B,
                           int64_t NP, int64_t MP, const int32_t* n,
                           const int32_t* m, int C, float* rows, float* best,
                           int32_t* best_i, float* acc, float* ckm,
                           float* ckx, float* cky, float og, float eg,
                           float so, float se, float sent, float sose,
                           void* stream) {
  if (B <= 0 || B > 65535 || NP <= 0 || MP <= 0 || MP > (1 << 30) ||
      C < 0 || (C && (NP % C || !ckm || !ckx || !cky)))
    return (int)cudaErrorInvalidValue;
  const st::Pen p = pen(og, eg, so, se, sent, sose);
  cudaStream_t s = (cudaStream_t)stream;
  const bool i8 = s_int8 != 0;
  if (mode == sw::LOCAL)
    launch_grid<sw::LOCAL>(i8, S, B, NP, MP, n, m, C, rows, best, best_i, acc,
                           ckm, ckx, cky, p, s);
  else if (mode == sw::GLOCAL)
    launch_grid<sw::GLOCAL>(i8, S, B, NP, MP, n, m, C, rows, best, best_i,
                            acc, ckm, ckx, cky, p, s);
  else if (mode == sw::GLOBAL)
    launch_grid<sw::GLOBAL>(i8, S, B, NP, MP, n, m, C, rows, best, best_i,
                            acc, ckm, ckx, cky, p, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
