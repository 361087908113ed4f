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

}  // namespace sw
