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
//   fetch: fetch(r, c) is the band's pointer byte of cell (base + r + 1,
//          c + 1), read through SegWindows (shared-memory windows on the
//          card, the twin's checked copies on the host);
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
      prev = (int)((fetch(i - 1 - base, j - 1) >> (2 * s)) & 3);
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

// K5's windows: a ring of SEG_WINDOWS slots of SEG_WINDOW_BYTES each, D
// diagonals a window (C bytes a diagonal; at least two, so one step, which
// lowers the diagonal by one or two, never skips a window).
constexpr int SEG_WINDOWS = 4;
constexpr int SEG_WINDOW_BYTES = 16 << 10;
SW_HD int seg_window_diags(int C) {
  const int d = SEG_WINDOW_BYTES / C;
  return d < 2 ? 2 : d;
}

// A band's skewed pointer bytes (sw_band.cuh band_bytes: cell (base + r +
// 1, c + 1) at byte (r + c) * C + r) read through a ring of SEG_WINDOWS
// slots of D diagonals each: diagonal d = r + c is C contiguous bytes,
// and every step of a walk lowers d by one (a gap) or two (a match), so a
// walk reads a band's diagonals in strictly decreasing order.  The first
// read, at diagonal `top`, opens the band: window t holds diagonals
// top - (t+1) D + 1 .. top - t D, in slot t mod SEG_WINDOWS, and windows
// 0 .. SEG_WINDOWS - 1 are copied at once.  A read below the current
// window moves to the next one, starts the copy of the window
// SEG_WINDOWS - 1 ahead of that into the slot it leaves (the warp's
// barrier first: every lane has read from it), and waits for its own.
// Diagonals outside the band's 0 .. nd-1 are not copied.  Copy moves the
// bytes: `load(slot, dst, src, bytes)` starts one copy (all of the warp's
// lanes call it), `wait_ahead()` waits for every copy but the last
// SEG_WINDOWS - 1 started, `wait_all()` for every one; `ok(slot, at)` lets
// the host twin check that byte `at` of a slot holds a copied byte.  A
// band the walk reads nothing of costs no copy; close() waits for the
// copies in flight, so the slots may take the next band's.
template <class Copy>
struct SegWindows {
  const uint8_t* band;
  int C, nd, D;
  uint8_t* ring;  // SEG_WINDOWS slots of D * C bytes
  int top, lo;    // the opening diagonal, the current window's lowest
  unsigned t;     // the current window
  uint8_t* cur;   // where diagonal d, row r is: cur + d * C + r
  bool open;
  Copy copy;

  // Starts copying window w (diagonals lo_w .. lo_w + D - 1 of the band).
  SW_HD void start(unsigned w) {
    const int slot = (int)(w % SEG_WINDOWS);
    const int low = top - ((int)w + 1) * D + 1;
    const int a = low > 0 ? low : 0;
    const int e = low + D < nd ? low + D : nd;
    copy.load(slot, ring + slot * D * C + (a - low) * C,
              band + (int64_t)a * C, e > a ? (e - a) * C : 0);
  }

  SW_HD void enter() {
    const int slot = (int)(t % SEG_WINDOWS);
    cur = ring + slot * D * C - (int64_t)lo * C;
  }

  SW_HD uint32_t operator()(int r, int c) {
    const int d = r + c;
    if (!open) {
      open = true;
      top = d;
      t = 0;
      lo = d - D + 1;
      for (unsigned w = 0; w < SEG_WINDOWS; ++w) start(w);
      copy.wait_ahead();
      enter();
    } else if (d < lo) {
      ++t;
      lo -= D;
      start(t + SEG_WINDOWS - 1);
      copy.wait_ahead();
      enter();
    }
    const uint8_t* at = cur + (int64_t)d * C + r;
    copy.ok((int)(t % SEG_WINDOWS), at - (ring + (t % SEG_WINDOWS) * D * C));
    return *at;
  }

  SW_HD void close() {
    if (open) copy.wait_all();
    open = false;
  }
};

template <class Copy>
SW_HD SegWindows<Copy> seg_windows(const uint8_t* band, int C, int64_t MP,
                                   int D, uint8_t* smem, Copy copy) {
  SegWindows<Copy> w;
  w.band = band;
  w.C = C;
  w.nd = (int)(C + MP);
  w.D = D;
  w.ring = smem;
  w.top = w.lo = 0;
  w.t = 0;
  w.cur = smem;
  w.open = false;
  w.copy = copy;
  return w;
}

}  // namespace sw
