// The traceback walks' rules, written once: the main path's pooled walks K2
// (walk.cu) and K11 (token_walk.cu), the long route's segment walk K5
// (seg_walk.cu) and the window ring K5 and K8 (banded_walk.cu) read through.
// nvcc compiles them into the kernels, g++ into the host twin
// (cell_twin.cpp).
//
// K2's semantics are smithwaterman_tpu/ops/device_walk.py
// walk_bundle_pooled (:220), step for step:
//   * start: LOCAL at (best_i, best_j) in M, done at once when best <= 0;
//     otherwise at (n, m) in the first maximum of the final (M, X, Y);
//   * each step normalizes the state on a boundary (ops/traceback.py
//     normalize_boundary_state), reads the interior pointer or the closed
//     form on row 0 / column 0, stops a LOCAL path at CELL_STOP without
//     emitting, and otherwise emits the state and moves;
//   * a non-LOCAL path stops at its first boundary cell (i == 0 or
//     j == 0): the rest is a fixed terminal-gap run that the host rebuild
//     (csrc/reconstruct.cpp) synthesizes.
// Moves are 2 bits each, four to a byte, in walk order (move 0 is the
// path's end cell): move t of the pair is bits 2*(t&3) of byte t>>2.
#pragma once

#include <climits>

#include "sw_cell.cuh"

namespace sw {

SW_HD int normalize_boundary_state(int i, int j, int s) {
  if (j == 0 && i > 0) return GAPINY;
  if (i == 0 && j > 0) return GAPINX;
  return s;
}

SW_HD int boundary_prev(int i, int j, int s, bool local) {
  const int b = (i == 0 && j == 0) ? MATCH : (i == 0 ? GAPINX : GAPINY);
  return (local && s == b) ? STOP : b;
}

// A long-sequence walk (kernel K5, seg_walk.cu) between bands: the walk
// state {i, j, s, done}, the move count and the moves of the byte being
// filled, kept in registers across the bands of a launch.
struct SegState {
  int i, j, s;
  bool done;
  int32_t cnt;
  uint32_t acc;
};

// The state from memory: walk {i, j, s, done}, *cnt and, when the last
// launch left a byte part-filled, that byte of `moves` (byte t at
// moves[t * mv_stride]).
SW_HD SegState seg_load(const int32_t* w, const int32_t* cnt,
                        const uint8_t* moves, int64_t mv_stride) {
  SegState st;
  st.i = w[0];
  st.j = w[1];
  st.s = w[2];
  st.done = w[3] != 0;
  st.cnt = *cnt;
  st.acc = (st.cnt & 3) ? moves[(int64_t)(st.cnt >> 2) * mv_stride] : 0u;
  return st;
}

// The state back to memory, a part-filled byte included (of L4 bytes).
SW_HD void seg_store(const SegState& st, int32_t* w, int32_t* cnt,
                     uint8_t* moves, int64_t mv_stride, int64_t L4) {
  if ((st.cnt & 3) && (st.cnt >> 2) < L4)
    moves[(int64_t)(st.cnt >> 2) * mv_stride] = (uint8_t)st.acc;
  w[0] = st.i;
  w[1] = st.j;
  w[2] = st.s;
  w[3] = st.done ? 1 : 0;
  *cnt = st.cnt;
}

// One band's share of a long-sequence walk (kernel K5, seg_walk.cu).
// Semantics are smithwaterman_tpu/ops/longseq.py _packed_walk_segments'
// loop body w_body (:359-388), step for step.  Unlike walk_pair, the walk
// does not stop at the first boundary cell: it follows the boundary down to
// (0, 0), so the stream is complete.
//   fetch: the band's pointer bytes through Windows (shared-memory
//          windows on the card, the twin's checked copies on the host):
//          cell (base + r + 1, c + 1) is byte r of anti-diagonal r + c,
//          fetch.byte(r + c, r) after fetch.to(r + c) (sw_band.cuh
//          band_bytes);
//   st:    the walk state, read and advanced;
//   moves: byte t of the pair's packed moves at moves[t * mv_stride], of
//          L4 bytes; full bytes are stored when `store` (one lane of a
//          warp stores, every lane steps).
// The pair steps while it is not done and needs this band (i > base) or
// stands on a DP boundary (i == 0 or j == 0), at most L + 8 steps.  A step
// inside the band (i > base, j >= 1) needs no boundary state: it takes the
// short path, a byte and a few integer operations.
template <class Fetch>
SW_HD void walk_segment(bool local, Fetch& fetch, int base, int64_t L,
                        SegState* st, uint8_t* moves, int64_t mv_stride,
                        int64_t L4, bool store = true) {
  int i = st->i, j = st->j, s = st->s;
  bool done = st->done;
  int32_t cnt = st->cnt;
  uint32_t acc = st->acc;
  for (int64_t it = 0; it < L + 8 && !done; ++it) {
    int prev;
    if (i > base && j >= 1) {
      const int r = i - 1 - base;
      fetch.to(r + j - 1);
      prev = (int)((fetch.byte(r + j - 1, r) >> (2 * s)) & 3);
    } else {
      if (!(i == 0 || j == 0)) break;  // the band below's
      s = normalize_boundary_state(i, j, s);
      prev = boundary_prev(i, j, s, local);
    }
    if (local && prev == STOP) {
      done = true;
      break;
    }
    acc |= (uint32_t)s << (2 * (cnt & 3));
    if ((cnt & 3) == 3) {
      if (store && (cnt >> 2) < L4)
        moves[(int64_t)(cnt >> 2) * mv_stride] = (uint8_t)acc;
      acc = 0;
    }
    ++cnt;
    i -= s != GAPINX;
    j -= s != GAPINY;
    s = prev;
    done = i == 0 && j == 0;
  }
  st->i = i;
  st->j = j;
  st->s = s;
  st->done = done;
  st->cnt = cnt;
  st->acc = acc;
}

// A ring of shared-memory windows over a source read in non-increasing
// order of its units, filled ahead of the reads: K5's anti-diagonals of a
// band (seg_walk.cu) and K8's band rows (banded_walk.cu).
//
// The source is nu units of ub bytes, unit u at src + u * ub, and, when
// `side` is not null, one int32 a unit at side[u] (K8's row offsets).  A
// window is D consecutive units (at least two, so a read that lowers the
// unit by one or two never skips a window: K5's window_units, 16 KB; K8's
// sw_banded.cuh walk_rows, 48 KB), in one of WINDOWS slots.  The first
// read, at unit `top`, opens the ring: window t holds units top - (t+1) D
// + 1 .. top - t D, in slot t mod WINDOWS, and windows 0 .. WINDOWS - 1
// are copied at once.  A read
// below the current window moves to the next one, starts the copy of the
// window WINDOWS - 1 ahead of that into the slot it leaves (the warp's
// barrier first: every lane has read from it), and waits for its own.
// Units outside 0 .. nu-1 are not copied: no byte outside the source.
// Each slot keeps a window's bytes (and its side words after them) at the
// source's address mod 16, so a copy takes 16-byte pieces wherever the
// source is 16-byte aligned, whatever ub (pieces).
//
// A reader calls to(u) before reading unit u (byte(u, k), word(u)).
// Copy moves the bytes: `load(slot, dst, src, bytes)` starts a copy (all
// of the warp's lanes call it), `commit()` closes a window's copies,
// `wait_ahead()` waits for every window's but the last WINDOWS - 1
// committed, `wait_all()` for every one; `ok(slot, at)` lets the host
// twin check that byte `at` of a slot holds a copied byte.  A source the
// reads never touch costs no copy; close() waits for the copies in
// flight, so the slots may take the next source's.
constexpr int WINDOWS = 4;
constexpr int WINDOW_BYTES = 16 << 10;  // K5's

SW_HD int window_units(int64_t ub) {
  const int64_t d = WINDOW_BYTES / ub;
  return d < 2 ? 2 : (int)d;
}

SW_HD int64_t round16(int64_t v) { return (v + 15) & ~(int64_t)15; }

// Bytes of a slot of D units of ub bytes, with D side words when `side`:
// each area 16 bytes longer than its data, for the alignment.
SW_HD int64_t window_slot_bytes(int D, int64_t ub, bool side) {
  return round16(D * ub + 16) + (side ? round16(4 * (int64_t)D + 16) : 0);
}

// How a copy of n bytes from address s0 is cut: bytes [0, w0), 4-byte
// words [w0, q0), 16-byte pieces [q0, q1), words [q1, w1), bytes [w1, n),
// every word and piece aligned to its size at the source (and so at the
// destination, which shares the source's address mod 16).  At most three
// bytes and three words at each end.
struct Pieces {
  int64_t w0, q0, q1, w1;
};

SW_HD Pieces pieces(uint64_t s0, int64_t n) {
  const uint64_t s1 = s0 + (uint64_t)n;
  uint64_t w0 = (s0 + 3) & ~(uint64_t)3;
  if (w0 > s1) w0 = s1;
  uint64_t w1 = s1 & ~(uint64_t)3;
  if (w1 < w0) w1 = w0;
  uint64_t q0 = (w0 + 15) & ~(uint64_t)15;
  if (q0 > w1) q0 = w1;
  uint64_t q1 = w1 & ~(uint64_t)15;
  if (q1 < q0) q1 = q0;
  return {(int64_t)(w0 - s0), (int64_t)(q0 - s0), (int64_t)(q1 - s0),
          (int64_t)(w1 - s0)};
}

template <class Copy>
struct Windows {
  const uint8_t* src;   // unit u at src + u * ub
  const int32_t* side;  // unit u's word at side[u], or null
  int64_t ub, sb;       // bytes a unit, bytes a slot
  int nu, D;
  uint8_t* ring;  // WINDOWS slots of sb bytes, 16-byte aligned
  int top, lo;    // the opening unit, the current window's lowest
  unsigned t;     // the current window
  int a;          // the current window's first unit in the source
  int ub32;       // ub (a window's bytes fit an int)
  const uint8_t* bcur;  // unit a's bytes
  const int32_t* wcur;  // unit a's side word
  bool open;
  Copy copy;

  static SW_HD int phase(const void* p) {
    return (int)((uintptr_t)p & 15);
  }
  SW_HD uint8_t* slot_at(unsigned w) { return ring + (w % WINDOWS) * sb; }
  // The first unit of window w the source holds, and where its bytes and
  // side word land.
  SW_HD int first(unsigned w) const {
    const int low = top - ((int)w + 1) * D + 1;
    return low > 0 ? low : 0;
  }
  SW_HD uint8_t* bytes_at(unsigned w, int u) {
    return slot_at(w) + phase(src + (int64_t)u * ub);
  }
  SW_HD uint8_t* side_at(unsigned w, int u) {
    return slot_at(w) + round16(D * ub + 16) + phase(side + u);
  }

  // Starts copying window w.
  SW_HD void start(unsigned w) {
    const int low = top - ((int)w + 1) * D + 1;
    const int f = first(w);
    const int e = low + D < nu ? low + D : nu;
    const int64_t k = e > f ? e - f : 0;  // units to copy, maybe none
    const int slot = (int)(w % WINDOWS);
    copy.load(slot, bytes_at(w, f), src + (int64_t)f * ub, k * ub);
    if (side)
      copy.load(slot, side_at(w, f), (const uint8_t*)(side + f), 4 * k);
    copy.commit();
  }

  SW_HD void enter() {
    a = first(t);
    bcur = bytes_at(t, a);
    if (side) wcur = (const int32_t*)side_at(t, a);
  }

  // Makes unit u readable: u at most the last unit made readable.  One
  // compare when u lies in the current window (lo is INT_MAX until the
  // ring opens).
  SW_HD void to(int u) {
    if (u < lo) move(u);
  }
  SW_HD void move(int u) {
    if (!open) {
      open = true;
      top = u;
      t = 0;
      lo = u - D + 1;
      for (unsigned w = 0; w < WINDOWS; ++w) start(w);
    } else {
      ++t;
      lo -= D;
      start(t + WINDOWS - 1);
    }
    copy.wait_ahead();
    enter();
  }

  // Byte k of unit u, and unit u's side word: u made readable by to(u).
  SW_HD uint32_t byte(int u, int k) {
    const uint8_t* at = bcur + ((u - a) * ub32 + k);
    copy.ok((int)(t % WINDOWS), at - slot_at(t));
    return *at;
  }
  SW_HD int32_t word(int u) {
    const int32_t* at = wcur + (u - a);
    copy.ok((int)(t % WINDOWS), (const uint8_t*)at - slot_at(t));
    return *at;
  }

  SW_HD void close() {
    if (open) copy.wait_all();
    open = false;
    lo = INT_MAX;
  }
};

template <class Copy>
SW_HD Windows<Copy> windows(const uint8_t* src, int64_t ub, int nu,
                            const int32_t* side, int D, uint8_t* smem,
                            Copy copy) {
  Windows<Copy> w;
  w.src = src;
  w.side = side;
  w.ub = ub;
  w.ub32 = (int)ub;
  w.nu = nu;
  w.D = D;
  w.sb = window_slot_bytes(D, ub, side != nullptr);
  w.ring = smem;
  w.top = w.a = 0;
  w.lo = INT_MAX;
  w.t = 0;
  w.bcur = smem;
  w.wcur = nullptr;
  w.open = false;
  w.copy = copy;
  return w;
}

// K5's windows over a band's skewed pointer bytes (sw_band.cuh band_bytes:
// cell (base + r + 1, c + 1) at byte (r + c) * C + r): diagonal d = r + c
// is C contiguous bytes, and every step of a walk lowers d by one (a gap)
// or two (a match), so a walk reads a band's diagonals in strictly
// decreasing order.
template <class Copy>
SW_HD Windows<Copy> seg_windows(const uint8_t* band, int C, int64_t MP,
                                int D, uint8_t* smem, Copy copy) {
  return windows(band, C, (int)(C + MP), nullptr, D, smem, copy);
}

#if defined(__CUDACC__)
// A warp's copies into its windows (pieces: 16-byte cp.async pieces, 4-byte
// ones at the ends, and the few bytes left by plain loads and stores), one
// commit group a window (every lane commits, so all count the same
// groups); a window's copies start after the warp's barrier, so no lane
// still reads the slot.
struct WarpCopy {
  static constexpr int kLanes = 32;
  int lane;

  __device__ void load(int, uint8_t* dst, const uint8_t* src,
                       int64_t bytes) {
    __syncwarp();
    const Pieces p = pieces((uint64_t)src, bytes);
    for (int64_t o = p.q0 + (int64_t)lane * 16; o < p.q1;
         o += kLanes * 16) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + o);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(src + o)
                   : "memory");
    }
    // lanes 0-2 the head's words, 3-5 the tail's, 6-8 the head's bytes,
    // 9-11 the tail's
    int64_t o = -1;
    if (lane < 3)
      o = p.w0 + 4 * lane < p.q0 ? p.w0 + 4 * lane : -1;
    else if (lane < 6)
      o = p.q1 + 4 * (lane - 3) < p.w1 ? p.q1 + 4 * (lane - 3) : -1;
    if (o >= 0) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + o);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                   "l"(src + o)
                   : "memory");
    }
    o = -1;
    if (lane >= 6 && lane < 9)
      o = lane - 6 < p.w0 ? lane - 6 : -1;
    else if (lane >= 9 && lane < 12)
      o = p.w1 + lane - 9 < bytes ? p.w1 + lane - 9 : -1;
    if (o >= 0) dst[o] = src[o];
  }
  __device__ void commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __device__ void wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
  }
  __device__ void wait_ahead() {
    asm volatile("cp.async.wait_group %0;" ::"n"(WINDOWS - 1) : "memory");
    __syncwarp();
  }
  __device__ void ok(int, int64_t) {}
};
#endif


// ---- K2 and K11: a pair's walk from shared-memory tiles of its block.
//
// The pools hold a pair's block row-major: DP cell (r + 1, c + 1) at byte
// r * rs + c of each pool (fill_dp.layout: D_CS = 1, D_RS = rs, rows
// 4-byte aligned).  A walk lowers r and c and never raises them, so it
// reads the block from the bottom-right towards the top-left.  A warp
// walks a pair through TILE_SLOTS = 2 slots of shared memory, each a
// tile of up to T rows x C columns of the block (of both pools for K11, at
// the same offsets):
//   * the current tile holds the walk's cell; its bottom-right corner was
//     the walk's cell, or the walk's row or column, when it was copied;
//   * once the walk passes the tile's middle row (or, first, its middle
//     column), the neighbour it heads for is copied into the other slot:
//     the T rows above, up to the walk's column, or the C columns to the
//     left, up to the walk's row;
//   * a walk that leaves the current tile into that neighbour waits for
//     its copy and goes on there; one that leaves it elsewhere (a gap that
//     passes the neighbour, a K11 jump over it, a column trigger followed
//     by an exit through the top) copies a tile anchored at its cell into
//     the slot it leaves and waits for it.
// A copy takes only bytes of the pair's block: a tile row's columns
// widened to whole 16-byte pieces of the source inside its row (the
// pieces at a row's two ends cut into 4- and 1-byte ones), rows q, q +
// 32, ... by lane q of the warp.  A slot keeps every row at the
// source's address mod 16 (row stride tile_stride, equal to rs mod 16), so
// a cell's shared offset is linear in (r, c), and a step moves it by
// SW + 1, 1 or SW.
constexpr int TILE_SLOTS = 2;
// a block's shared memory on Hopper (227 KB)
constexpr int64_t BLOCK_SMEM = 232448;

// Shared bytes between a tile's rows, for a block of rs bytes a row: at
// least C + 30 (a row's columns widened to 16-byte pieces end before the
// next row's first piece) and equal to rs mod 16.
SW_HD int tile_stride(int C, int64_t rs) {
  const int lo = C + 30;
  return lo + (int)((rs - lo) & 15);
}

// A slot's bytes of one pool for tiles of T rows x C columns.
SW_HD int64_t tile_slot_bytes(int T, int C) {
  return round16((int64_t)T * (C + 45));
}

// A warp's tiles of a pair's P pools (K2 1, K11 2), read through Copy:
// on the card LaneCopy, in the host twin a checked copy.  Copy moves and
// reads the bytes: begin(slot, bytes) before a copy into a slot,
// piece(dst, src, n) copies n <= 16 bytes within one 16-byte piece of the
// source (dst at src's address mod 16), commit() closes a tile's copies,
// wait_all() waits for every copy of the warp and syncs its lanes,
// sync() syncs them, read(off) reads the byte at offset off of the
// warp's slots; lanes first .. last - 1 of the warp copy through it.
template <class Copy, int P>
struct Tiles {
  const uint8_t* src[P];  // pool q's block: cell (r, c) at src[q] + r*rs + c
  int64_t rs;
  int T, C, SW, SB;  // tile rows, columns; shared bytes a row, a slot's pool
  uint8_t* smem;     // the warp's TILE_SLOTS slots of P * SB bytes
  Copy copy;
  // The current tile: slot k, first row ra and column ca, cell (ra, ca)
  // at offset o0.  The walk asks for a neighbour once below row mr or
  // column mc; cells at or past (fr, fc) need no event: (mr, mc) until it
  // has asked, (ra, ca) after.
  int k, ra, ca, o0, mr, mc, fr, fc;
  bool open, asked;
  bool pending;  // a neighbour, rows nra..nrb, columns nca..ncb, in slot k^1
  int nra, nrb, nca, ncb, no0;

  SW_HD bool fast(int r, int c) const { return r >= fr && c >= fc; }
  // The byte of pool q at offset p of the current tile.
  SW_HD uint32_t read(int p, int q = 0) { return copy.read(p + q * SB); }

  // Copies rows r0..r1, columns c0..c1 of the block into slot s; returns
  // the offset of cell (r0, c0).
  SW_HD int load(int s, int r0, int r1, int c0, int c1) {
    uint8_t* slot = smem + (int64_t)s * P * SB;
    copy.begin(slot, (int64_t)P * SB);
    const int ph = (int)((uintptr_t)(src[0] + r0 * rs + c0) & 15);
    for (int l = copy.first; l < copy.last; ++l)
      for (int q = l; q <= r1 - r0; q += 32)
        for (int p = 0; p < P; ++p) {
          const uint8_t* row = src[p] + (int64_t)(r0 + q) * rs;
          const uint8_t* hi = row + c1 + 1;
          const uint8_t* end = row + rs;
          // byte c of the row lands at slot + at + c
          const int64_t at = (int64_t)p * SB + ph + (int64_t)q * SW - c0;
          for (const uint8_t* a = (const uint8_t*)((uintptr_t)(row + c0) &
                                                   ~(uintptr_t)15);
               a < hi; a += 16) {
            const uint8_t* x = a < row ? row : a;
            const uint8_t* y = a + 16 < end ? a + 16 : end;
            copy.piece(slot + at + (x - row), x, (int)(y - x));
          }
        }
    copy.commit();
    return (int)(slot - smem) + ph;
  }

  SW_HD void enter(int r1, int c1) {  // the current tile ends at (r1, c1)
    mr = ra + (r1 - ra + 1) / 2;
    mc = ca + (c1 - ca + 1) / 2;
    asked = false;
  }

  // Makes cell (r, c) readable (r, c >= 0, neither below nor right of a
  // cell read before) and returns its offset.
  SW_HD int to(int r, int c) {
    if (!open || r < ra || c < ca) {
      if (pending && r >= nra && r <= nrb && c >= nca && c <= ncb) {
        copy.wait_all();
        k ^= 1;
        ra = nra;
        ca = nca;
        o0 = no0;
        enter(nrb, ncb);
      } else {
        copy.sync();  // every lane has read slot k
        ra = r - T + 1 > 0 ? r - T + 1 : 0;
        ca = c - C + 1 > 0 ? c - C + 1 : 0;
        o0 = load(k, ra, r, ca, c);
        copy.wait_all();
        enter(r, c);
      }
      open = true;
      pending = false;
    }
    if (!asked && (r < mr || c < mc)) {
      asked = true;
      if (r < mr) {
        if (ra > 0)
          ask(ra - T > 0 ? ra - T : 0, ra - 1, c - C + 1 > 0 ? c - C + 1 : 0,
              c);
      } else if (ca > 0) {
        ask(r - T + 1 > 0 ? r - T + 1 : 0, r, ca - C > 0 ? ca - C : 0,
            ca - 1);
      }
    }
    fr = asked ? ra : mr;
    fc = asked ? ca : mc;
    return o0 + (r - ra) * SW + (c - ca);
  }

  // Copies the neighbour rows r0..r1, columns c0..c1 into slot k ^ 1,
  // which no lane reads (the last switch or reload synced the lanes).
  SW_HD void ask(int r0, int r1, int c0, int c1) {
    nra = r0;
    nrb = r1;
    nca = c0;
    ncb = c1;
    no0 = load(k ^ 1, r0, r1, c0, c1);
    pending = true;
  }

  // Waits for the copies in flight: the slots may take the next pair's.
  SW_HD void close() {
    if (pending) copy.wait_all();
    pending = false;
  }
};

template <int P, class Copy>
SW_HD Tiles<Copy, P> tiles(const uint8_t* const* src, int64_t rs, int T,
                           int C, uint8_t* smem, Copy copy) {
  Tiles<Copy, P> t;
  for (int q = 0; q < P; ++q) t.src[q] = src[q];
  t.rs = rs;
  t.T = T;
  t.C = C;
  t.SW = tile_stride(C, rs);
  t.SB = (int)tile_slot_bytes(T, C);
  t.smem = smem;
  t.copy = copy;
  t.k = t.ra = t.ca = t.o0 = t.mr = t.mc = t.fr = t.fc = 0;
  t.open = t.asked = t.pending = false;
  t.nra = t.nrb = t.nca = t.ncb = t.no0 = 0;
  return t;
}

// The walk's start (device_walk._walk_starts): LOCAL at the argmax in M,
// done when best <= 0; otherwise (n, m) in the first maximum of the final
// (M, X, Y), as np.argmax.
SW_HD bool walk_start(bool local, int n, int m, const float* st, int* i,
                      int* j, int* s) {
  *s = MATCH;
  if (local) {
    const bool done = st[0] <= 0.0f;
    *i = done ? 0 : (int)st[1];
    *j = done ? 0 : (int)st[2];
    return done;
  }
  *i = n;
  *j = m;
  if (st[4] > st[3]) *s = GAPINX;
  if (st[5] > st[3 + *s]) *s = GAPINY;
  return false;
}

// The shared-memory offset a step from state s moves by, and the state a
// pointer byte gives the step after (prev, 3 = STOP).
SW_HD int step_delta(int s, int SW) {
  return (s != GAPINX ? SW : 0) + (s != GAPINY ? 1 : 0);
}
SW_HD int decode(uint32_t b, int s) { return (int)((b >> (2 * s)) & 3); }
SW_HD int popc8(uint32_t v) {
#if defined(__CUDA_ARCH__)
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// Walks one pair (kernel K2) through `cells` (Tiles); writes its packed
// moves to moves[t * mv_stride] for byte t (every byte up to the last one
// holding a move) and returns the move count.  L bounds the steps
// (device_walk.max_path_len).  Every lane of the warp steps the same walk
// and stores the same bytes.
//
// A lone walk is a chain of dependent instructions, so a step should be
// few of them.  While the walk's cell lies at least four rows and four
// columns inside the part of the tile that needs no event (fr, fc), the
// next four cells do too whatever the moves: the walk takes four steps a
// block with no bounds or boundary test, stores their byte at once and
// tests LOCAL's STOP once (a block that meets it is taken again one step
// at a time).  A step's move depends only on its state, known before its
// pointer byte, so cell t + 1's byte is read before cell t's is decoded:
// two reads are in flight and the chain is a read and a few operations
// every two steps.  Elsewhere the walk takes single steps with exact
// tests (Tiles::to at an event).
template <bool LOCAL_, class Cells>
SW_HD int32_t walk_moves(Cells& cells, int n, int m, const float* st,
                         int64_t L, uint8_t* moves, int64_t mv_stride) {
  int i, j, s;
  bool done = walk_start(LOCAL_, n, m, st, &i, &j, &s);
  int32_t cnt = 0;
  uint32_t acc = 0;      // the moves from move cnt & ~3 on, not yet stored
  uint8_t* out = moves;  // the byte of move cnt
  const int SW = cells.SW;
  while (!done && cnt < L) {
    if (i < 1 || j < 1) {  // a start on the DP's edge
      s = normalize_boundary_state(i, j, s);
      const int prev = boundary_prev(i, j, s, LOCAL_);
      if (LOCAL_ && prev == STOP) break;
      acc |= (uint32_t)s << (2 * (cnt & 3));
      if ((cnt & 3) == 3) {
        *out = (uint8_t)acc;
        out += mv_stride;
        acc = 0;
      }
      ++cnt;
      if (s != GAPINX) --i;
      if (s != GAPINY) --j;
      s = prev;
      done = i == 0 || j == 0;
      continue;
    }
    int p = cells.to(i - 1, j - 1);
    int dr = i - 1 - cells.fr, dc = j - 1 - cells.fc;  // >= 0
    uint32_t b = cells.read(p);
    for (;;) {  // to the next event
      // the byte of move cnt's field in acc, the same for every block
      const int sh = 2 * (cnt & 3);
      while ((dr < dc ? dr : dc) >= 4 && cnt + 4 <= L) {
        // cells 1 and 2 need only the states before them: both reads go
        // out together, then each further read waits on one decode
        const int s1 = decode(b, s);
        const int p1 = p - step_delta(s, SW);
        const int p2 = p1 - step_delta(s1, SW);
        const uint32_t b1 = cells.read(p1), b2 = cells.read(p2);
        const int s2 = decode(b1, s1);
        const int p3 = p2 - step_delta(s2, SW);
        const uint32_t b3 = cells.read(p3);
        const int s3 = decode(b2, s2);
        const int p4 = p3 - step_delta(s3, SW);
        const uint32_t b4 = cells.read(p4);
        const int s4 = decode(b3, s3);
        if (LOCAL_ &&
            (s1 == STOP || s2 == STOP || s3 == STOP || s4 == STOP))
          break;
        // the four moves, 2 bits each; fields 1 (X) keep i, fields 2 (Y)
        // keep j
        const uint32_t mv = (uint32_t)(s | s1 << 2 | s2 << 4 | s3 << 6);
        const int di = 4 - popc8(mv & ~(mv >> 1) & 0x55u);
        const int dj = 4 - popc8((mv >> 1) & ~mv & 0x55u);
        acc |= mv << sh;
        *out = (uint8_t)acc;
        out += mv_stride;
        acc >>= 8;
        cnt += 4;
        i -= di;
        j -= dj;
        dr -= di;
        dc -= dj;
        p = p4;
        b = b4;
        s = s4;
      }
      // one step with exact tests
      const int di = s != GAPINX, dj = s != GAPINY;
      dr -= di;
      dc -= dj;
      const bool nf = (dr | dc) >= 0;
      const int np = p - (di ? SW : 0) - dj;
      const uint32_t nb = cells.read(nf ? np : p);
      const int prev = decode(b, s);
      if (LOCAL_ && prev == STOP) {
        done = true;
        break;
      }
      acc |= (uint32_t)s << (2 * (cnt & 3));
      if ((cnt & 3) == 3) {
        *out = (uint8_t)acc;
        out += mv_stride;
        acc = 0;
      }
      ++cnt;
      i -= di;
      j -= dj;
      s = prev;
      if (!nf || cnt >= L) {
        done = i == 0 || j == 0;
        break;
      }
      p = np;
      b = nb;
    }
  }
  cells.close();
  if (cnt & 3) *out = (uint8_t)acc;
  return cnt;
}

template <class Cells>
SW_HD int32_t walk_pair(bool local, Cells& cells, int n, int m,
                        const float* st, int64_t L, uint8_t* moves,
                        int64_t mv_stride) {
  return local ? walk_moves<true>(cells, n, m, st, L, moves, mv_stride)
               : walk_moves<false>(cells, n, m, st, L, moves, mv_stride);
}

// Walks one pair over its pointer bytes (pool 0) and match-run bytes
// (pool 1: run_byte, sw_cell.cuh) and emits tokens: the token walk
// (kernel K11).  Semantics are smithwaterman_tpu/ops/device_walk.py
// walk_bundle_pooled_tokens (:392-432), step for step:
//   * the start, the boundary normalisation and the boundary pointers are
//     walk_pair's;
//   * in state M inside the matrix, the run byte's reserved (15, STOP)
//     marker (not the pointer) says the path has ended; otherwise the walk
//     consumes 1 + e cells on both i and j and goes on in the byte's exit
//     state; in any other state it takes one step to the pointer's state;
//   * a LOCAL path ends after the token whose next state is STOP, a
//     non-LOCAL one at its first boundary cell.
// Token t of the pair is the byte s | e << 2 (e = 0 outside state M) at
// toks[t * tok_stride]; only tokens t < the returned count are written.
// A token's cell depends on the run byte read the token before (a jump of
// up to 16 cells, which may leave the tile: Tiles::to copies the cell's),
// so K2's guesses do not apply: every lane steps the same walk, a token an
// iteration of an inner loop that runs while no event is due.
template <bool LOCAL_, class Cells>
SW_HD int32_t walk_tokens(Cells& cells, int n, int m, const float* st,
                          int64_t L, uint8_t* toks, int64_t tok_stride) {
  int i, j, s;
  bool done = walk_start(LOCAL_, n, m, st, &i, &j, &s);
  int32_t cnt = 0;
  uint8_t* out = toks;  // token cnt's byte
  const int SW = cells.SW;
  while (!done && cnt < L) {
    if (i < 1 || j < 1) {  // a start on the DP's edge
      s = normalize_boundary_state(i, j, s);
      const int prev = boundary_prev(i, j, s, LOCAL_);
      if (LOCAL_ && prev == STOP) break;
      *out = (uint8_t)s;
      out += tok_stride;
      ++cnt;
      if (s != GAPINX) --i;
      if (s != GAPINY) --j;
      s = prev;
      done = i == 0 || j == 0 || (LOCAL_ && s == STOP);
      continue;
    }
    int p = cells.to(i - 1, j - 1);
    int dr = i - 1 - cells.fr, dc = j - 1 - cells.fc;
#pragma unroll 2
    for (;;) {
      const uint32_t b = cells.read(p), rb = cells.read(p, 1);
      int prev, e = 0, xs = 0;
      bool stop;
      if (s == MATCH) {
        e = (int)(rb & 15);
        xs = (int)((rb >> 4) & 3);
        prev = (int)(b & 3);
        stop = LOCAL_ && e == 15 && xs == STOP;
      } else {
        prev = (int)((b >> (2 * s)) & 3);
        stop = LOCAL_ && prev == STOP;
      }
      if (stop) {
        done = true;
        break;
      }
      *out = (uint8_t)(s | (e << 2));
      out += tok_stride;
      ++cnt;
      const int adv = 1 + e;
      const int di = s != GAPINX ? adv : 0, dj = s != GAPINY ? adv : 0;
      i -= di;
      j -= dj;
      dr -= di;
      dc -= dj;
      s = s == MATCH ? xs : prev;
      done = i == 0 || j == 0 || (LOCAL_ && s == STOP);
      if (done || cnt >= L || (dr | dc) < 0) break;
      p -= di * SW + dj;
    }
  }
  cells.close();
  return cnt;
}

template <class Cells>
SW_HD int32_t walk_tokens_pair(bool local, Cells& cells, int n, int m,
                               const float* st, int64_t L, uint8_t* toks,
                               int64_t tok_stride) {
  return local ? walk_tokens<true>(cells, n, m, st, L, toks, tok_stride)
               : walk_tokens<false>(cells, n, m, st, L, toks, tok_stride);
}

#if defined(__CUDACC__)
// The card's copies and reads of a warp's tiles: this lane's rows of a
// tile by cp.async (16-byte pieces, 4-byte ones at a row's ends, and plain
// loads and stores for any bytes left), one commit group a tile (every
// lane commits, so all count the same groups), reads by ld.shared (LDS)
// from the warp's slots.
struct LaneCopy {
  int first, last;  // this lane, and one past it
  unsigned base;    // the warp's slots in the shared window

  __device__ void begin(uint8_t*, int64_t) {}
  __device__ void piece(uint8_t* dst, const uint8_t* src, int n) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (n == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(src)
                   : "memory");
      return;
    }
    const Pieces p = pieces((uint64_t)src, n);
    for (int o = 0; o < (int)p.w0; ++o) dst[o] = src[o];
    for (int o = (int)p.w0; o < (int)p.w1; o += 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d + o),
                   "l"(src + o)
                   : "memory");
    for (int o = (int)p.w1; o < n; ++o) dst[o] = src[o];
  }
  __device__ void commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  __device__ void wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
  }
  __device__ void sync() { __syncwarp(); }
  // LDS, kept after the copies it reads (and, measured, no slower than a
  // plain load the compiler may move: PERF.md)
  __device__ uint32_t read(int off) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(base + off));
    return v;
  }
};
#endif

}  // namespace sw
