// Per-pair traceback walk over the fill's pointer bytes, written once.
//
// nvcc compiles it into the walk kernel (walk.cu), g++ into the host twin
// (cell_twin.cpp).  Semantics are smithwaterman_tpu/ops/device_walk.py
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

// Walks one pair; writes its packed moves to moves[t * mv_stride] for
// byte t (every byte up to the last one holding a move) and returns the
// move count.  L bounds the steps (device_walk.max_path_len).
SW_HD int32_t walk_pair(bool local, const uint8_t* tb, int64_t tb_rs,
                        int64_t tb_cs, int n, int m, const float* st,
                        int64_t L, uint8_t* moves, int64_t mv_stride) {
  int i, j, s;
  bool done;
  if (local) {
    done = st[0] <= 0.0f;
    i = done ? 0 : (int)st[1];
    j = done ? 0 : (int)st[2];
    s = MATCH;
  } else {
    i = n;
    j = m;
    s = MATCH;  // first maximum, as np.argmax
    if (st[4] > st[3]) s = GAPINX;
    if (st[5] > st[3 + s]) s = GAPINY;
    done = false;
  }
  int32_t cnt = 0;
  uint32_t acc = 0;
  for (int64_t step = 0; step < L && !done; ++step) {
    s = normalize_boundary_state(i, j, s);
    int prev;
    if (i >= 1 && j >= 1) {
      prev = (tb[(int64_t)(i - 1) * tb_rs + (int64_t)(j - 1) * tb_cs] >>
              (2 * s)) & 3;
    } else {
      prev = boundary_prev(i, j, s, local);
    }
    if (local && prev == STOP) break;
    acc |= (uint32_t)s << (2 * (cnt & 3));
    if ((cnt & 3) == 3) {
      moves[(int64_t)(cnt >> 2) * mv_stride] = (uint8_t)acc;
      acc = 0;
    }
    ++cnt;
    if (s != GAPINX) --i;
    if (s != GAPINY) --j;
    s = prev;
    done = i == 0 || j == 0;
  }
  if (cnt & 3) moves[(int64_t)(cnt >> 2) * mv_stride] = (uint8_t)acc;
  return cnt;
}

// Walks one pair over its pointer bytes and match-run bytes (run_byte,
// sw_cell.cuh) and emits tokens: the token walk (kernel K11,
// token_walk.cu).  Semantics are smithwaterman_tpu/ops/device_walk.py
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
SW_HD int32_t walk_tokens_pair(bool local, const uint8_t* tb,
                               const uint8_t* run, int64_t tb_rs,
                               int64_t tb_cs, int n, int m, const float* st,
                               int64_t L, uint8_t* toks, int64_t tok_stride) {
  int i, j, s;
  bool done;
  if (local) {
    done = st[0] <= 0.0f;
    i = done ? 0 : (int)st[1];
    j = done ? 0 : (int)st[2];
    s = MATCH;
  } else {
    i = n;
    j = m;
    s = MATCH;
    if (st[4] > st[3]) s = GAPINX;
    if (st[5] > st[3 + s]) s = GAPINY;
    done = false;
  }
  int32_t cnt = 0;
  for (int64_t step = 0; step < L && !done; ++step) {
    s = normalize_boundary_state(i, j, s);
    const bool interior = i >= 1 && j >= 1;
    int prev, e = 0, xs = 0;
    bool stop;
    if (interior) {
      const int64_t at = (int64_t)(i - 1) * tb_rs + (int64_t)(j - 1) * tb_cs;
      prev = (tb[at] >> (2 * s)) & 3;
      if (s == MATCH) {
        const int rb = run[at];
        e = rb & 15;
        xs = (rb >> 4) & 3;
        stop = local && e == 15 && xs == STOP;
      } else {
        stop = local && prev == STOP;
      }
    } else {
      prev = boundary_prev(i, j, s, local);
      stop = local && prev == STOP;
    }
    if (stop) break;
    toks[cnt * tok_stride] = (uint8_t)(s | (e << 2));
    ++cnt;
    const int adv = 1 + e;
    if (s != GAPINX) i -= adv;
    if (s != GAPINY) j -= adv;
    s = (interior && s == MATCH) ? xs : prev;
    done = i == 0 || j == 0 || (local && s == STOP);
  }
  return cnt;
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

}  // namespace sw
