// The banded scores' tiling (kernel K6, banded_scores.cu), written once.
//
// nvcc compiles it into the kernel; g++ compiles it into the host twin
// (cell_twin.cpp), which runs every thread of a block in turn between the
// block's barriers and checks every code read from the staged window.
//
// K6 writes S[b, i-1, w] = table[c1[b, i-1], c2[b, off_b(i) + w]] where
// off_b(i) + w < m_b, else 0, for rows i = 1 .. NP (sw_banded.cuh's offset
// rule, the one K7 and the host use).  A tile is T consecutive rows of one
// pair, one block's work at a time:
//
//   1. one thread a row computes the row's offset (a 64-bit division) and
//      its table row (c1's code times K) into shared memory;
//   2. the row's W columns are cut into chunks of at most `chunk` columns
//      (CHUNK_COLS on the card); for each chunk the rows are cut into
//      sub-tiles whose window [off(s) + w0, off(e-1) + w0 + cols) of seq2's
//      codes fits `win_bytes` (WIN_BYTES on the card) together with the
//      16-byte lead: a sub-tile ends before the first row whose offset rises
//      more than rise_room codes past its first row's.  Pairs with m ~ n
//      rise by (m - W) / n ~ 0 columns a row, so one sub-tile takes the
//      tile; a skewed pair (n = 100, m = 5,000, W = 128: ~49 a row) is cut;
//   3. the window is staged into shared memory in 16-byte pieces at the
//      source's address mod 16 (vector loads of the pieces wholly inside
//      the pair's codes [0, min(m, MP)), one code at a time at the two ends,
//      zeros past them), and every code is read from there;
//   4. each thread builds 4 consecutive columns of a row (a quad: 4 codes
//      from the window, 4 table reads, the < m mask) and stores them as one
//      16-byte float4 when W % 4 == 0 and S is 16-byte aligned (the
//      launcher checks both), else as 4-byte stores below W.
//
// Nothing is read past a window's staged bytes: the twin returns 3 for a
// code no piece of the current window brought.
#pragma once

#include "sw_banded.cuh"

namespace sw {
namespace scores {

constexpr int THREADS = 256;
// tile rows the launcher may pick (ops/kernels.scores_plan), at most
constexpr int MAX_TILE = 64;
// the card's window: bytes of seq2's codes a block stages at once, and the
// columns of a row one window covers at most.  (WIN_BYTES - 16) / 2 - 2048
// = 2040 codes of rise room at int16 codes and W >= 2048, 6128 at uint8.
constexpr int WIN_BYTES = 8192;
constexpr int CHUNK_COLS = 2048;

// A launch as the kernel and the twin see it.
struct Args {
  const float* table;  // (K, K), shared memory or device memory
  int K;
  const void* codes1;  // (B, NP)
  const void* codes2;  // (B, MP)
  const int32_t* n;
  const int32_t* m;
  int64_t B, NP, MP;
  int W;
  float* S;  // (B, NP, W)
  int T;     // rows a tile
  int win_bytes, chunk;
  int64_t tiles;  // tiles a pair, ceil(NP / T)
};

SW_HD int64_t tiles_of(int64_t NP, int T) { return (NP + T - 1) / T; }

// The columns w0 .. w0 + cols - 1 of a chunk, rounded up to 4: the last
// quad of a row of W % 4 != 0 columns builds columns past W, never stores
// them.
SW_HD int chunk_cols(int W, int w0, int chunk) {
  const int c = W - w0 < chunk ? W - w0 : chunk;
  return (c + 3) & ~3;
}

// Codes a window holds past a chunk's cols4 columns: the offset's rise
// over a sub-tile is at most this (16 bytes kept for the lead).
SW_HD int rise_room(int win_bytes, int code_bytes, int cols4) {
  return (win_bytes - 16) / code_bytes - cols4;
}

// A window of win_bytes takes chunks of `chunk` columns with no rise.
SW_HD bool window_fits(int win_bytes, int chunk, int code_bytes) {
  return win_bytes > 16 && win_bytes % 16 == 0 && chunk > 0 &&
         chunk % 4 == 0 && rise_room(win_bytes, code_bytes, chunk) >= 0;
}

// The end of the sub-tile that starts at row s of a tile's `rows` offsets
// (non-decreasing): the first row past s whose offset is more than `room`
// past offs[s], else rows.
SW_HD int sub_tile_end(const int* offs, int s, int rows, int room) {
  const int64_t lim = (int64_t)offs[s] + room;
  int lo = s + 1, hi = rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= lim)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// A staged window: codes c0 .. c0 + span - 1 of a pair's row sit at window
// index lead .. lead + span - 1; the window holds `bytes` bytes (a multiple
// of 16) from row byte rel0 = c0 * code_bytes - lead * code_bytes on, which
// keeps each code at its source's address mod 16.
struct Window {
  int64_t rel0;
  int lead, bytes;
};

SW_HD Window window(uint64_t row_addr, int code_bytes, int64_t c0,
                    int64_t span) {
  Window w;
  const int lead_bytes = (int)((row_addr + (uint64_t)(c0 * code_bytes)) & 15);
  w.lead = lead_bytes / code_bytes;
  w.rel0 = c0 * code_bytes - lead_bytes;
  w.bytes = (int)((lead_bytes + span * code_bytes + 15) & ~(int64_t)15);
  return w;
}

// Stages piece k (bytes 16k .. 16k + 15) of window w from a pair's row of
// `valid` codes: one 16-byte load when the piece lies inside them, else one
// code at a time, zeros outside.  Mem: load16(dst, src) copies 16 bytes,
// load(const CODE*) -> CODE reads a code, put16(dst, codes) writes a piece.
template <typename CODE, class Mem>
SW_HD void stage_piece(Mem& mem, const CODE* row, const Window& w, int k,
                       int64_t valid, CODE* win) {
  constexpr int CB = (int)sizeof(CODE);
  const int64_t rel = w.rel0 + 16 * (int64_t)k;
  CODE* dst = win + 16 / CB * k;
  if (rel >= 0 && rel + 16 <= valid * CB) {
    mem.load16(dst, row + rel / CB);
    return;
  }
  CODE piece[16 / CB];
  for (int e = 0; e < 16 / CB; ++e) {
    const int64_t c = rel / CB + e;  // rel is a multiple of CB
    piece[e] = c >= 0 && c < valid ? mem.load(row + c) : (CODE)0;
  }
  mem.put16(dst, piece);
}

// A thread's (row, quad) items of a sub-tile of Q quads a row: item
// tid, tid + THREADS, ... in row-major order.
struct Items {
  int r, q, dr, dq, Q;
};

SW_HD Items items(int tid, int Q) {
  return {tid / Q, tid % Q, THREADS / Q, THREADS % Q, Q};
}

SW_HD void next(Items& it) {
  it.r += it.dr;
  it.q += it.dq;
  if (it.q >= it.Q) {
    it.q -= it.Q;
    ++it.r;
  }
}

// Tile t of a launch (pairs major): the block's shared memory is `win`
// (win_bytes), offs and rbase (T ints each).  Exec: each(f) runs f(tid) for
// every thread of the block and then the block's barrier; Mem as
// stage_piece, plus code(win, j) -> CODE for a window read and store4 /
// store1 for S.
template <bool VEC, typename CODE, class Exec, class Mem>
SW_HD void run_tile(Exec& ex, Mem& mem, const Args& a, const float* tab,
                    int64_t t, CODE* win, int* offs, int* rbase) {
  const int64_t b = t / a.tiles;
  const int64_t r0 = t % a.tiles * a.T;
  const int rows = (int)(a.NP - r0 < a.T ? a.NP - r0 : a.T);
  const banded::Geom g = banded::geom(a.n[b], a.m[b], a.W);
  const CODE* c1 = static_cast<const CODE*>(a.codes1) + b * a.NP + r0;
  const CODE* c2 = static_cast<const CODE*>(a.codes2) + b * a.MP;
  const int64_t valid = g.m < a.MP ? (g.m > 0 ? g.m : 0) : a.MP;
  float* S = a.S + (b * a.NP + r0) * a.W;
  ex.each([&](int tid) {
    if (tid < rows) {
      offs[tid] = banded::offset(g, r0 + tid + 1);
      rbase[tid] = (int)mem.load(c1 + tid) * a.K;
    }
  });
  for (int w0 = 0; w0 < a.W; w0 += a.chunk) {
    const int cols4 = chunk_cols(a.W, w0, a.chunk);
    const int room = rise_room(a.win_bytes, (int)sizeof(CODE), cols4);
    for (int s = 0; s < rows;) {
      const int e = sub_tile_end(offs, s, rows, room);
      const Window w = window((uint64_t)c2, (int)sizeof(CODE),
                              (int64_t)offs[s] + w0,
                              (int64_t)cols4 + offs[e - 1] - offs[s]);
      ex.each([&](int tid) {
        for (int k = tid; k < w.bytes / 16; k += THREADS)
          stage_piece(mem, c2, w, k, valid, win);
      });
      ex.each([&](int tid) {
        for (Items it = items(tid, cols4 / 4); it.r < e - s; next(it)) {
          const int r = s + it.r;
          const int wc = w0 + 4 * it.q;
          const int64_t col = (int64_t)offs[r] + wc;
          const int j = w.lead + (offs[r] - offs[s]) + 4 * it.q;
          const float* trow = tab + rbase[r];
          float v[4];
          for (int k = 0; k < 4; ++k) {
            const float x = trow[mem.code(win, j + k)];
            v[k] = col + k < g.m ? x : 0.0f;
          }
          float* out = S + (int64_t)r * a.W + wc;
          if (VEC) {
            mem.store4(out, v);
          } else {
            for (int k = 0; k < 4; ++k)
              if (wc + k < a.W) mem.store1(out + k, v[k]);
          }
        }
      });
      s = e;
    }
  }
}

}  // namespace scores
}  // namespace sw
