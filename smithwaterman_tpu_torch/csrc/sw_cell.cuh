// Per-cell rules of the three-state affine DP fill, written once.
//
// nvcc compiles this header into the fill kernels (fill.cu,
// longseq_fill.cu, through sw_band.cuh); g++ compiles it into the host twin
// (cell_twin.cpp), which the tier-1 tests hold against the JAX package's
// exact oracle (smithwaterman_tpu/ops/scan_dp.py).  So the tie-break
// cascades checked on a CPU are the ones the card runs.
//
// Semantics are scan_dp.fill's (bit-exact, tie-breaks included): every
// cell gets the inputs of the reference's sequential recurrence (row by
// row, column by column), whatever order the kernels visit cells in.
//   * M from (i-1, j-1): max(M, X, Y) + s, ties M >= X >= Y.
//   * Y (gap in seq2) from (i-1, j); X (gap in seq1) from (i, j-1).
//     LOCAL breaks the extend-vs-open ties with strict `>` for the extend,
//     the other modes with `>=` (scan_dp.py:131-147, :180-191).
//   * GLOCAL: gaps are free (the start penalties so = se = 0) along the
//     last row for X and the last column for Y.
//   * Boundary: (0,0) is (0,-1,-1); row 0 and column 0 carry the sentinel
//     10*og + 10*eg on the states a gap chain cannot be in.
//   * LOCAL clamps all three states at 0 and marks a zero state's pointer
//     CELL_STOP.
// The sequential X recurrence X[j] = max(G[j-1], X[j-1] + pe) equals
// scan_dp's max-plus prefix exactly when every partial sum is exact in
// f32, which quarter-integer penalties guarantee (config.AlignConfig
// warns otherwise).  Build with no FMA contraction (nvcc --fmad=false,
// g++ -ffp-contract=off): a fused multiply-add rounds once where the
// reference rounds twice, and one ulp can flip a tie.
#pragma once

#include <cstddef>
#include <cstdint>

#if defined(__CUDACC__)
#define SW_HD __host__ __device__ __forceinline__
#else
#define SW_HD inline
#endif

namespace sw {

constexpr int GLOBAL = 0;
constexpr int GLOCAL = 1;
constexpr int LOCAL = 2;

constexpr int MATCH = 0;
constexpr int GAPINX = 1;  // gap in seq1: consumes j
constexpr int GAPINY = 2;  // gap in seq2: consumes i
constexpr int STOP = 3;

constexpr float NEG = -3.0e38f;

// Tables of at most SMEM_K symbols are copied into each block's shared
// memory (16 KiB at 64); larger ones, up to any size the codes address
// (255 symbols with uint8 codes, 32767 with int16), are read from device
// memory, where the few hundred KiB of a wide table stay in L1 and L2.
constexpr int SMEM_K = 64;

// stats row per pair: [best, best_i, best_j, finalM, finalX, finalY, 0, 0]
// (the Pallas kernel's contract, smithwaterman_tpu/ops/pallas_dp.py:105)
constexpr int STATS_W = 8;

// per-pair descriptor row (int64), shared by the fill and the walk
enum Desc {
  D_OFF1 = 0,   // offset of seq1's codes in the flat codes1 buffer
  D_OFF2 = 1,   // offset of seq2's codes in the flat codes2 buffer
  D_N = 2,      // true length of seq1
  D_M = 3,      // true length of seq2
  D_TB = 4,     // offset of cell (1,1)'s pointer byte in the tb pool
  D_CS = 5,     // tb stride between columns j and j+1 (bytes)
  D_RS = 6,     // tb stride between rows i and i+1 (bytes)
  D_CARRY = 7,  // offset of the pair's (M,X,Y) row carry, in floats
  DESC_W = 8,
};

struct Cell {
  float m, x, y;
};

#if defined(__CUDACC__)
// The table a kernel reads: a shared-memory copy of up to SMEM_K symbols
// (`smem` holds K*K floats; the block fills it, then waits), else the
// device-memory table itself.  Every thread of the block must call it.
__device__ __forceinline__ const float* block_table(const float* table, int K,
                                                    float* smem) {
  if (K > SMEM_K) return table;
  for (int t = threadIdx.x; t < K * K; t += blockDim.x) smem[t] = table[t];
  __syncthreads();
  return smem;
}

// Dynamic shared memory a block needs for block_table.
inline size_t table_smem(int K) {
  return K <= SMEM_K ? (size_t)K * K * sizeof(float) : 0;
}
#endif

SW_HD float mx(float a, float b) { return a >= b ? a : b; }

// The boundary cells in closed form.  so/se are the start penalties (og/eg
// in GLOBAL, 0 otherwise) and sent = 10*og + 10*eg the sentinel on the
// states a gap chain along the boundary cannot be in.
// (0, j), j >= 1: the chain along row 0 lives in X.
SW_HD Cell row0_cell(int j, float so, float se, float sent) {
  const float lsc = (float)j * se + (so - se);
  return {lsc + sent, lsc, lsc + sent};
}

// (i, 0): the origin (0, -1, -1) for i == 0, else the chain down column 0
// in Y.
SW_HD Cell col0_cell(int i, float so, float se, float sent) {
  if (i == 0) return {0.0f, -1.0f, -1.0f};
  const float lsc = (float)i * se + (so - se);
  return {lsc + sent, lsc + sent, lsc};
}

// One interior cell (i, j).  d, u, l are the (M, X, Y) values at the
// diagonal (i-1, j-1), up (i-1, j) and left (i, j-1) cells; po/pe are
// the row's X penalties and qo/qe the column's Y penalties (both equal
// og/eg except on GLOCAL's free last row / column).  Writes the cell's
// values to *out and returns its packed pointer byte: predecessor state
// of M in bits 0-1, of X in bits 2-3, of Y in bits 4-5.
template <int MODE>
SW_HD uint32_t cell(float s, Cell d, Cell u, Cell l, float og, float eg,
                    float po, float pe, float qo, float qe, Cell* out) {
  // M: from (i-1, j-1); tie order M >= X >= Y
  uint32_t pm = (d.m >= d.x) ? ((d.m >= d.y) ? MATCH : GAPINY)
                             : ((d.x >= d.y) ? GAPINX : GAPINY);
  float vm = mx(mx(d.m, d.x), d.y) + s;

  // Y: from (i-1, j)
  float vy;
  uint32_t py;
  if (MODE == LOCAL) {
    const bool c1 = u.m + og >= u.y + eg;
    const bool c2 = u.m > u.x;
    const bool c3 = u.y + eg > u.x + og;
    vy = c1 ? (c2 ? u.m + og : u.x + og) : (c3 ? u.y + eg : u.x + og);
    py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
  } else {
    const bool c1 = u.m + qo > u.y + qe;
    const bool c2 = u.m >= u.x;
    const bool c3 = u.y + qe >= u.x + qo;
    vy = mx(mx(u.m + qo, u.y + qe), u.x + qo);
    py = c1 ? (c2 ? MATCH : GAPINX) : (c3 ? GAPINY : GAPINX);
  }
  if (MODE == LOCAL) {
    vm = mx(vm, 0.0f);
    vy = mx(vy, 0.0f);
  }

  // X: from (i, j-1), the left cell's final (clamped) values
  float vx = mx(mx(l.m, l.y) + po, l.x + pe);
  bool d1, d2, d3;
  if (MODE == LOCAL) {
    d1 = l.m + og >= l.x + eg;
    d2 = l.m > l.y;
    d3 = l.x + eg > l.y + og;
  } else {
    d1 = l.m + po > l.x + pe;
    d2 = l.m >= l.y;
    d3 = l.x + pe >= l.y + po;
  }
  uint32_t px = d1 ? (d2 ? MATCH : GAPINY) : (d3 ? GAPINX : GAPINY);
  if (MODE == LOCAL) {
    vx = mx(vx, 0.0f);
    if (vm == 0.0f) pm = STOP;
    if (vx == 0.0f) px = STOP;
    if (vy == 0.0f) py = STOP;
  }
  out->m = vm;
  out->x = vx;
  out->y = vy;
  return pm | (px << 2) | (py << 4);
}

// The match-run byte of one cell (smithwaterman_tpu/ops/pallas_dp.py
// :505-547, fill_tiled(emit_runs=True)): e in bits 0-3 is the number of
// EXTRA diagonal M-steps a walk arriving here in state M may take in one
// jump (1+e cells, at most 16), x in bits 4-5 the state after them.  pm is
// the cell's M pointer (bits 0-1 of its pointer byte), rdiag the run byte
// of the diagonal cell (i-1, j-1); row 0 and column 0 read RUN_EDGE, the
// capped (15, M), so a jump ends one step onto the boundary, where the
// walk's boundary rules take over.
//   pm == STOP (LOCAL zero cell)   -> (15, STOP), a marker reserved for
//                                     these cells: landing on it in state M
//                                     ends the walk without emission;
//   pm != M                        -> (0, pm), one step;
//   pm == M, diagonal is a marker  -> (0, STOP): emit this cell, then stop;
//   pm == M, diagonal capped       -> (0, M): the jump restarts here;
//   pm == M, otherwise             -> (e_d + 1, x_d).
// A chain whose exit is STOP caps one earlier (e <= 14), or a 16-long match
// chain ending at a zero cell would forge the marker and cut walks short.
constexpr uint32_t RUN_EDGE = 15;  // (15, M)

SW_HD uint32_t run_byte(uint32_t pm, uint32_t rdiag) {
  if (pm == STOP) return 15u | (STOP << 4);
  if (pm != MATCH) return pm << 4;
  const uint32_t ed = rdiag & 15u, xd = (rdiag >> 4) & 3u;
  const bool diag_stop = ed == 15u && xd == STOP;
  const uint32_t ecap = xd == STOP ? 14u : 15u;
  if (!diag_stop && ed < ecap) return (ed + 1u) | (xd << 4);
  return (diag_stop ? STOP : MATCH) << 4;
}

}  // namespace sw
