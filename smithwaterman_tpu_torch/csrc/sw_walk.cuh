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

// One band's share of a long-sequence walk (kernel K5, seg_walk.cu).
// Semantics are smithwaterman_tpu/ops/longseq.py _packed_walk_segments'
// loop body w_body (:359-388), step for step.  Unlike walk_pair, the walk
// does not stop at the first boundary cell: it follows the boundary down to
// (0, 0), so the stream is complete.
//   w:     the pair's walk state {i, j, s, done}, read and written back;
//   cnt:   its move count so far, read and written back;
//   band:  the band's pointer bytes, cell (i, j) for base < i <= base + C
//          at band[(i - 1 - base) * rs + (j - 1) * cs];
//   moves: byte t of the pair's packed moves at moves[t * mv_stride], of
//          L4 bytes (zeroed before the first band; a byte the last band
//          left part-filled is read back).
// The pair steps while it is not done and needs this band (i > base) or
// stands on a DP boundary (i == 0 or j == 0), at most L + 8 steps.
SW_HD void walk_segment(bool local, const uint8_t* band, int64_t rs,
                        int64_t cs, int base, int64_t L, int32_t* w,
                        int32_t* cnt_io, uint8_t* moves, int64_t mv_stride,
                        int64_t L4) {
  int i = w[0], j = w[1], s = w[2];
  bool done = w[3] != 0;
  int32_t cnt = *cnt_io;
  uint32_t acc = (cnt & 3) ? moves[(int64_t)(cnt >> 2) * mv_stride] : 0u;
  for (int64_t it = 0; it < L + 8; ++it) {
    if (done || !(i > base || i == 0 || j == 0)) break;
    s = normalize_boundary_state(i, j, s);
    int prev;
    if (i >= 1 && j >= 1) {
      prev = (band[(int64_t)(i - 1 - base) * rs + (int64_t)(j - 1) * cs] >>
              (2 * s)) & 3;
    } else {
      prev = boundary_prev(i, j, s, local);
    }
    if (local && prev == STOP) {
      done = true;
      break;
    }
    acc |= (uint32_t)s << (2 * (cnt & 3));
    if ((cnt & 3) == 3) {
      if ((cnt >> 2) < L4) moves[(int64_t)(cnt >> 2) * mv_stride] = (uint8_t)acc;
      acc = 0;
    }
    ++cnt;
    if (s != GAPINX) --i;
    if (s != GAPINY) --j;
    s = prev;
    done = i == 0 && j == 0;
  }
  if ((cnt & 3) && (cnt >> 2) < L4)
    moves[(int64_t)(cnt >> 2) * mv_stride] = (uint8_t)acc;
  w[0] = i;
  w[1] = j;
  w[2] = s;
  w[3] = done ? 1 : 0;
  *cnt_io = cnt;
}

}  // namespace sw
