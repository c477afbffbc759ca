// Device functions shared by the SafeLife kernels: the cell bit layout
// (safelife_torch/cells.py), the spawnless CA rule and the point table.
//
// Boards are (H, W, B) uint16 with the environment batch innermost, so the
// threads of a warp, one environment each, read cell (r, c) of 32
// neighbouring environments in one coalesced 64-byte access.  All
// arithmetic is int32, as in the plain PyTorch versions.
#pragma once

#include <cstdint>

namespace safelife {

constexpr int ALIVE = 1 << 0;
constexpr int AGENT = 1 << 1;
constexpr int PUSHABLE = 1 << 2;
constexpr int DESTRUCTIBLE = 1 << 3;
constexpr int FROZEN = 1 << 4;
constexpr int PRESERVING = 1 << 5;
constexpr int INHIBITING = 1 << 6;
constexpr int EXIT = 1 << 8;
constexpr int COLOR_BIT = 9;
constexpr int COLOR_R = 1 << 9;
constexpr int COLOR_B = 1 << 11;
constexpr int COLORS = 7 << 9;
constexpr int PULLABLE = 1 << 15;
constexpr int PLAYER = AGENT | INHIBITING | PRESERVING | FROZEN | DESTRUCTIBLE;
constexpr int LEVEL_EXIT = FROZEN | EXIT;
constexpr int LIFE = ALIVE | DESTRUCTIBLE;

// Floor modulo, as Python's and torch's % (C++'s % truncates).
__device__ __forceinline__ int floor_mod(int x, int n) {
  const int r = x % n;
  return r < 0 ? r + n : r;
}

// Spawnless full-rule board -> one 28-bit count word of 4-bit fields:
// alive@0, r@4, g@8, b@12, destructible@16, preserving@20, inhibiting@24
// (life_pallas._pack_full4).  A 3x3 sum of these words never carries
// between fields (counts <= 9).
__device__ __forceinline__ int pack_full4(int cell) {
  const int alive = cell & 1;
  const int spread = (((cell >> COLOR_BIT) & 7) * 0x49) & 0x111;
  const int has_d = ((cell >> 3) | (cell >> 8)) & 1;
  const int pi2 = (cell >> 5) & 3;
  return alive + ((spread * alive) << 4) + ((has_d * alive) << 16) +
         ((pi2 * 0x900000) & 0x1100000);
}

// The CA rule for one cell of a spawnless board given the 3x3 sum of its
// packed words (life_pallas._extract4 and _core_full with spawn=None).
__device__ __forceinline__ int spawnless_rule(int cell, int counts) {
  const int n_alive = counts & 15;
  int m = (counts >> 1) & ((7 << 4) | (7 << 8) | (7 << 12) | (7 << 16));
  m |= m >> 2;
  m |= m >> 1;
  const int t = m & ((1 << 4) | (1 << 8) | (1 << 12));
  const int inherit = ((t >> 3) * 0x124) & COLORS;
  const int born_d = (m >> 13) & DESTRUCTIBLE;
  const bool preserved = ((counts >> 20) & 15) != 0;
  const bool inhibited = ((counts >> 24) & 15) != 0;
  const bool frozen = (cell & FROZEN) != 0;
  const bool three = n_alive == 3;
  if (cell & 1) {
    return (frozen || preserved || three || n_alive == 4) ? cell : 0;
  }
  return (three && !frozen && !inhibited) ? (ALIVE | inherit | born_d) : cell;
}

// Advance row r of environment b of a spawnless board and hand each new
// cell to emit(c, new_cell).  Column sums of packed words slide along the
// row, so each cell's word is packed three times instead of nine.
template <class Emit>
__device__ __forceinline__ void advance_row_spawnless(
    const uint16_t* __restrict__ board, int r, int H, int W, long long B,
    long long b, Emit emit) {
  const long long row = static_cast<long long>(W) * B;
  const uint16_t* up = board + ((r + H - 1) % H) * row + b;
  const uint16_t* mid = board + r * row + b;
  const uint16_t* dn = board + ((r + 1) % H) * row + b;
  auto column = [&](int c) {
    const long long o = c * B;
    return pack_full4(up[o]) + pack_full4(mid[o]) + pack_full4(dn[o]);
  };
  const int first = column(0);
  int prev = column(W - 1);
  int cur = first;
  for (int c = 0; c < W; ++c) {
    const int next = (c + 1 < W) ? column(c + 1) : first;
    emit(c, spawnless_rule(mid[c * B], prev + cur + next));
    prev = cur;
    cur = next;
  }
}

// point_table[gc, cc]: each goal-color row packed into one int32 as
// value + 3 in bits [4c, 4c + 4) (env_step_pallas._PACKED_ROWS), picked
// with a select tree on the goal-color bits.
__device__ __forceinline__ int pts_cell(int gc, int cc) {
  constexpr int R0 = 0x33333323, R1 = 0x00303060, R2 = 0x36333803,
                R3 = 0x33336330, R4 = 0x66683606, R5 = 0x00803060,
                R6 = 0x68363606, R7 = 0x33333323;
  const bool b0 = gc & 1, b1 = gc & 2, b2 = gc & 4;
  const int t01 = b0 ? R1 : R0, t23 = b0 ? R3 : R2;
  const int t45 = b0 ? R5 : R4, t67 = b0 ? R7 : R6;
  const int packed = b2 ? (b1 ? t67 : t45) : (b1 ? t23 : t01);
  return ((packed >> (cc * 4)) & 15) - 3;
}

}  // namespace safelife
