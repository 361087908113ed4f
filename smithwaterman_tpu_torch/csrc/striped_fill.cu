// K12: the striped block fill, and K13: the single-device grid fill.
//
// Replaces: smithwaterman_tpu/parallel/seq_tiled.py _block_pallas_call
// (:821, pallas_call :846; body _make_block_kernel :287-442) and its B = 1
// sublane-folded form _block_pallas_call_folded (:586, :610; body
// _make_block_kernel_folded :445-583), which are both K12 here (the fold is
// a TPU register layout; on the card B = 1 is K12 with one pair); and
// _fold_grid_fill (:765, :806; body _make_grid_kernel_folded :621-762),
// which is K13.  The row rule and the tiles are sw_striped.cuh's.
//
// K12 computes K rows of every shard of a launch, for B pairs, at one step
// t of the wavefront: shard d runs its row block r = t - d, reading its left
// edges from shard d-1's outbox of step t-1 and writing its own for shard
// d+1 (the boxes alternate by step parity, so a launch that holds both
// shards reads and writes different ones).  Between launches the (M, X, Y)
// rows by row parity, the above edge, the LOCAL per-lane best and its row
// and the non-LOCAL accumulator live in global memory; the pointer bytes of
// a traceback band go straight to uint8.  K13 computes the whole D = 1 fill
// of NP rows in one launch, writing the carries every C rows and keeping
// the LOCAL per-lane best or the non-LOCAL accumulator; it reads f32 or
// int8 scores (widened in the kernel, as the JAX kernel does).  The lanes'
// merge is PyTorch code.
//
// What bounds them on an H100: dependencies, not bytes or operations.  Row
// i needs row i-1 and, through X, every lane to its left in the same row; a
// row of W lanes is ~60 f32 operations and 4-5 bytes a lane, so the bytes
// of a 2048 x 65,536 fill take ~0.16 ms.  The rows of a column tile run one
// after another, and the tiles of a row left to right, each waiting for its
// left neighbour's edge: a launch of R rows over a chain of T tiles takes
// about R + T * E tile rows (~1.5 us each for a warp of 512 lanes on an
// H100) plus T handovers (a fence, a flag and a load through L2: ~6 us).
//
// What the design does about it: a shard's W lanes are cut into column
// tiles of TW = 32 L lanes (L = 8 or 16 lanes a thread), each tile one
// warp, and the tiles run at once on many SMs.  A tile is a shard of its own
// inside the launch: it keeps its lanes' row, and its LOCAL bests, in
// registers for every row; of its state only its right edge [M, X, Y, C]
// leaves the chip each row, for the tile to its right; the next two rows'
// scores are asked of L2 ahead.  Within a row a warp needs no barrier:
// phase A (M, Y, h over the thread's lanes), a warp max scan of
// h by shuffles, then the left edge of the row (column 0's closed form or
// the inbox on tile 0, else the left tile's), then phase C (X, its pointer,
// the best or the accumulator, the edge out).  The edges go through global
// memory in slots (slot 0 the tile's last lane in the row above its first)
// and are published every E rows as K3 publishes its checkpoint tiles: the
// stores, a fence, then the count of slots with release semantics; the
// reader takes the count with acquire semantics, then loads up to HELD
// slots through L2 at once, a float a thread.  Persistent one-warp blocks
// take tiles by an atomic ticket, pair-major, then the launch's shards in
// order, then tiles left to right, so a tile only ever waits on the tile
// whose ticket came just before, held by a block already running: nothing
// deadlocks, whatever order the blocks are scheduled in.  L and E are
// picked a launch from the lanes, rows, chains and SMs
// (ops/kernels.striped_plan): tiles narrow enough to give a short row,
// wide enough for a short chain, and E balancing the chain's fill against
// the fences.
#include <cuda_runtime.h>

#include "sw_striped.cuh"

namespace {

namespace st = sw::striped;
constexpr unsigned kFull = sw::FULL;

// The edges a tile holds of its left neighbour's: slots [base, held), lane
// l holding float l % 4 of slot base + l / 4.
struct Reader {
  int base, held;
  float v;
};

// Slot s of the left neighbour's edges: waits until it is published, then
// loads it with the slots after it.
__device__ __forceinline__ st::Edge read_edge(Reader* rd,
                                              const st::Chain& ch, int s,
                                              int t) {
  if (s >= rd->held) {
    int v;
    while ((v = sw::ld_acquire(ch.ctr)) <= s) __nanosleep(32);
    v = __reduce_min_sync(kFull, v);
    rd->base = s;
    rd->held = min(s + st::HELD, v);
    const int slot = s + t / 4;
    rd->v = slot < rd->held ? sw::ld_l2(ch.slots + 4 * slot + (t & 3)) : 0.0f;
  }
  const int o = 4 * (s - rd->base);
  return st::Edge{{__shfl_sync(kFull, rd->v, o),
                   __shfl_sync(kFull, rd->v, o + 1),
                   __shfl_sync(kFull, rd->v, o + 2)},
                  __shfl_sync(kFull, rd->v, o + 3)};
}

// The maximum of v over the warp's threads before this one (NEG for 0).
__device__ __forceinline__ float warp_excl_max(float v, int t) {
#pragma unroll
  for (int d = 1; d < sw::WARP; d <<= 1) {
    const float o = __shfl_up_sync(kFull, v, d);
    if (t >= d) v = sw::mx(v, o);
  }
  const float e = __shfl_up_sync(kFull, v, 1);
  return t == 0 ? sw::NEG : e;
}

// One tile's rows, as thread t of its warp.
template <int MODE, bool TB, int L, typename ST, bool GRID>
__device__ void run_tile(const st::Launch& a, const st::Job& J, int t) {
  st::Thread<L> th;
  st::thread_begin<L, GRID>(a, J, t, &th);
  const int nv = st::lanes_in(J, t, L), kl = st::last_lane(J, t, L);
  const int jg0 = J.col0 + t * L + 1, jgt = J.col0 + 1;
  float* acc = st::acc_of(a, J, GRID);
  Reader rd{0, 0, 0.0f};
  sw::Cell ab = J.left.slots ? read_edge(&rd, J.left, 0, t).v
                             : st::box_above(a.p, J);
  if (J.right.slots && kl >= 0)
    st::put_edge(J.right, 0, st::Edge{st::lane_cell(th, kl), sw::NEG});
  for (int q = 0; q < a.K; ++q) {
    const int i = J.i_start + q + 1;
    const st::Row r = st::row_at<MODE>(a.p, i, J.n, J.m);
    for (int k = 1; k <= 2; ++k)
      if (q + k < a.K)
        st::prefetch_s(st::row_scores<ST>(a, J, i + k) + t * L, nv);
    float s[L];
    st::get_s<L>(st::row_scores<ST>(a, J, i) + t * L, nv, s);
    const sw::Cell nb = sw::shfl_up_cell(
        sw::Cell{th.pm[L - 1], th.px[L - 1], th.py[L - 1]});
    st::thread_a<MODE, TB, L>(a.p, r, jg0, s, st::first_diag(t, ab, nb),
                              &th);
    const float lm = __shfl_up_sync(kFull, th.cm[L - 1], 1);
    const float ly = __shfl_up_sync(kFull, th.cy[L - 1], 1);
    const float excl =
        warp_excl_max(st::thread_h<L>(r, jg0, t > 0, lm, ly, &th), t);
    const st::Edge e = J.left.slots ? read_edge(&rd, J.left, q + 1, t)
                                    : st::box_edge(a.p, J, q, i);
    st::Edge eo;
    st::thread_c<MODE, TB, L>(a.p, r, jg0, t, excl, st::left_c(r, jgt, e), e,
                              lm, ly, nv, kl, &th, acc, &eo);
    // the edge first: the fence then waits for it alone, not for the row's
    // pointer bytes and checkpoint
    if (kl >= 0) {
      if (J.right.slots) {
        st::put_edge(J.right, q + 1, eo);
        if (st::publishes(q, a.K, a.E)) st::publish(J.right, q + 2);
      } else if (J.out) {
        *reinterpret_cast<float4*>(J.out + 4 * q) =
            make_float4(eo.v.m, eo.v.x, eo.v.y, eo.c);
      }
    }
    st::thread_row_out<TB, L, GRID>(a, J, t, q, i, th);
    ab = e.v;
  }
  st::thread_end<MODE, L, GRID>(a, J, t, th);
  if (J.in && t == 0) {
    J.above[0] = ab.m;
    J.above[1] = ab.x;
    J.above[2] = ab.y;
  }
}

template <int MODE, bool TB, int L, typename ST, bool GRID>
__global__ void __launch_bounds__(sw::WARP) tile_kernel(st::Launch a) {
  const int t = threadIdx.x;
  for (;;) {
    int tk = 0;
    if (t == 0) tk = atomicAdd(a.ticket, 1);
    tk = __shfl_sync(kFull, tk, 0);
    if (tk >= a.tiles) return;
    run_tile<MODE, TB, L, ST, GRID>(a, st::job_at(a, tk), t);
  }
}

// Launches one persistent one-warp block per tile, at most as many as the
// card holds at once; the grid goes to *grid when given.
template <int MODE, bool TB, int L, typename ST, bool GRID>
int launch(const st::Launch& a, int* grid, cudaStream_t s) {
  auto kern = tile_kernel<MODE, TB, L, ST, GRID>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, sw::WARP, 0);
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int g = (int)(a.tiles < resident ? a.tiles : resident);
  if (grid) *grid = g;
  kern<<<g, sw::WARP, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool TB, int L, typename ST, bool GRID>
int by_mode(int mode, const st::Launch& a, int* grid, cudaStream_t s) {
  if (mode == sw::LOCAL) return launch<sw::LOCAL, TB, L, ST, GRID>(a, grid, s);
  if (mode == sw::GLOCAL)
    return launch<sw::GLOCAL, TB, L, ST, GRID>(a, grid, s);
  if (mode == sw::GLOBAL)
    return launch<sw::GLOBAL, TB, L, ST, GRID>(a, grid, s);
  return (int)cudaErrorInvalidValue;
}

template <bool TB, typename ST, bool GRID>
int by_lanes(int mode, const st::Launch& a, int* grid, cudaStream_t s) {
  if (a.L == 8) return by_mode<TB, 8, ST, GRID>(mode, a, grid, s);
  return by_mode<TB, 16, ST, GRID>(mode, a, grid, s);
}

}  // namespace

extern "C" {

// Launches K12 on `stream`: step t of the wavefront for the nds shards
// listed in ds (a host array; each d in 0..D-1 with t - d >= 0).  Shard d
// computes global rows i0 + r*K + 1 .. i0 + r*K + K (r = t - d) at columns
// [d*W, d*W + W) of B pairs:
//   S:      f32 scores of row i0 + 1 at column s_lo, pair stride s_b, row
//           stride s_r (unit column stride);
//   n, m:   (B,) int32 true lengths;
//   rows:   (2, 3, B, MP) f32, row i's (M, X, Y) in [i & 1], read at row
//           i0 + r*K and written at the block's last two rows;
//   box:    (2, D, B, K, 4) f32: shard d reads [(t-1) & 1][d-1] (d > 0)
//           and writes [t & 1][d], the [M, X, Y, C] at its last column;
//   above:  (D, B, 4) f32, [M, X, Y] at (i0 + r*K, d*W), read and
//           advanced by shards d > 0;
//   best, best_i: (B, MP) f32 / int32 LOCAL per-lane best and its row;
//   acc:    (D, B, 4) f32, the non-LOCAL (M, X, Y) of cell (n, m);
//   tb:     (B, tb_rows, MP) uint8 pointer bytes of rows i0 + 1 .. (when
//           emit_tb), row i at [i - i0 - 1].
// og .. sose are the penalty constants (sw_striped.cuh Pen); L (8 or 16)
// lanes a thread and E (1 .. 8) rows a publication the tiling; scratch:
// sw::striped::scratch_words(tiles, K) int32 words, the first
// scratch_zeroed(tiles) of them zero (tiles = nds * B * ceil(W / 32 L));
// the grid goes to *grid when given.  Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int sw_striped_block_launch(int mode, int emit_tb, const int32_t* ds,
                            int nds, int t, int i0, int K, int W, int D,
                            int64_t B, int64_t MP, const float* S,
                            int64_t s_b, int64_t s_r, int64_t s_lo,
                            const int32_t* n, const int32_t* m, float* rows,
                            float* box, float* above, float* best,
                            int32_t* best_i, float* acc, uint8_t* tb,
                            int64_t tb_rows, float og, float eg, float so,
                            float se, float sent, float sose, int L, int E,
                            int32_t* scratch, int* grid, void* stream) {
  st::Launch a;
  if (!scratch ||
      !st::block_launch(&a, emit_tb, ds, nds, t, i0, K, W, D, B, MP, S, s_b,
                        s_r, s_lo, n, m, rows, box, above, best, best_i, acc,
                        tb, tb_rows, st::Pen{og, eg, so, se, sent, sose}, L,
                        E))
    return (int)cudaErrorInvalidValue;
  st::set_scratch(&a, scratch);
  cudaStream_t s = (cudaStream_t)stream;
  return emit_tb ? by_lanes<true, float, false>(mode, a, grid, s)
                 : by_lanes<false, float, false>(mode, a, grid, s);
}

// Launches K13 on `stream`: the single-device fill of B pairs over all NP
// rows and MP columns:
//   S:      (B, NP, MP) scores, f32 or (s_int8) int8;
//   n, m:   (B,) int32 true lengths;
//   best, best_i: (B, MP) f32 / int32, the LOCAL per-lane best and its row;
//   acc:    (B, 4) f32, the non-LOCAL (M, X, Y) of cell (n, m);
//   ckm, ckx, cky: (B, NP / C, MP) f32, the carries after row (k+1)*C in
//           row k, when C > 0 (NP % C == 0).
// L, E, scratch (with K = NP) and grid as sw_striped_block_launch's.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
int sw_striped_grid_launch(int mode, int s_int8, const void* S, int64_t B,
                           int64_t NP, int64_t MP, const int32_t* n,
                           const int32_t* m, int C, float* best,
                           int32_t* best_i, float* acc, float* ckm,
                           float* ckx, float* cky, float og, float eg,
                           float so, float se, float sent, float sose, int L,
                           int E, int32_t* scratch, int* grid,
                           void* stream) {
  st::Launch a;
  if (!scratch ||
      !st::grid_launch(&a, S, B, NP, MP, n, m, C, best, best_i, acc, ckm,
                       ckx, cky, st::Pen{og, eg, so, se, sent, sose}, L, E))
    return (int)cudaErrorInvalidValue;
  st::set_scratch(&a, scratch);
  cudaStream_t s = (cudaStream_t)stream;
  return s_int8 ? by_lanes<false, int8_t, true>(mode, a, grid, s)
                : by_lanes<false, float, true>(mode, a, grid, s);
}

}  // extern "C"
