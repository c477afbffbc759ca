// Device functions shared by the SafeLife kernels: the cell bit layout
// (safelife_torch/cells.py), the CA rules and the point table.
//
// Boards are (H, W, B) uint16 with the environment batch innermost, so the
// threads of a warp, one environment each, read cell (r, c) of 32
// neighbouring environments in one coalesced 64-byte access (RowStream,
// K4-K8), or from a slab of E environments staged in shared memory
// (SlabStream, K2/K3).  All arithmetic is int32, as in the plain PyTorch
// versions.
//
// The rule of a cell needs counts over its 3x3 torus neighbourhood.  Each
// rule below is a struct with a count Word, pack(cell) -> Word, and
// rule(cell, 3x3 sum of Words, spawn) -> new cell, where spawn() is asked
// only where a spawn could fire (a dead cell, not frozen, not inhibited,
// not born, beside a spawner), so a kernel draws random bits only there.
//   SpawnlessRule  boards without spawners (life_pallas._advance_spawnless);
//   SimpleRule     certified simple goal boards (_advance_goals_simple);
//   FullRule<PI>   any board, spawners included (_advance_core, and with
//                  PI = false _core_full on spawn-simple goal boards, whose
//                  PRESERVING/INHIBITING bits are certified absent).
// The TPU packs counts to save VMEM passes; these packings are chosen for
// the card and are equal to the plain versions on every board the bank
// flags certify (most of them on any board).
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
constexpr int SPAWNING = 1 << 7;
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

// Spawnless full rule: one 28-bit count word of 4-bit fields alive@0, r@4,
// g@8, b@12, destructible@16, preserving@20, inhibiting@24
// (life_pallas._pack_full4, _extract4).  Counts <= 9 never carry.
struct SpawnlessRule {
  using Word = int;
  static __device__ __forceinline__ Word pack(int cell) {
    const int alive = cell & 1;
    const int spread = (((cell >> COLOR_BIT) & 7) * 0x49) & 0x111;
    const int has_d = ((cell >> 3) | (cell >> 8)) & 1;
    const int pi2 = (cell >> 5) & 3;
    return alive + ((spread * alive) << 4) + ((has_d * alive) << 16) +
           ((pi2 * 0x900000) & 0x1100000);
  }
  template <class Spawn>
  static __device__ __forceinline__ int rule(int cell, Word counts, Spawn) {
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
};

// Certified simple goal boards: no PRESERVING, INHIBITING, SPAWNING or
// EXIT, so nothing is preserved, inhibited or spawned and the destructible
// count reads only the DESTRUCTIBLE bit (life_pallas._advance_goals_simple,
// its fold included).
struct SimpleRule {
  using Word = int;
  static __device__ __forceinline__ Word pack(int cell) {
    const int alive = cell & 1;
    const int spread = (((cell >> COLOR_BIT) & 7) * 0x49) & 0x111;
    return alive + ((spread * alive) << 4) + (((cell >> 3) & alive) << 16);
  }
  template <class Spawn>
  static __device__ __forceinline__ int rule(int cell, Word counts, Spawn) {
    const int n_alive = counts & 15;
    int m = (counts >> 1) & ((7 << 4) | (7 << 8) | (7 << 12) | (7 << 16));
    m |= m >> 1;
    m |= m >> 1;
    const int t = m & ((1 << 4) | (1 << 8) | (1 << 12));
    const int inherit = ((t >> 3) * 0x124) & COLORS;
    const bool frozen = (cell & FROZEN) != 0;
    const bool three = n_alive == 3;
    if (cell & 1) return (frozen || three || n_alive == 4) ? cell : 0;
    return (three && !frozen) ? (ALIVE | inherit | ((m >> 13) & DESTRUCTIBLE))
                              : cell;
  }
};

// Full rule with spawners: two 32-bit words of 8-bit fields,
//   lo: alive@0, r@8, g@16, b@24 (colour weights: live 1, spawner 2, <= 27)
//   hi: destructible@0, preserving@8, inhibiting@16, spawning@24.
// With PI = false the preserving and inhibiting fields are left out.
struct Counts2 {
  uint32_t lo, hi;
};
__device__ __forceinline__ Counts2 operator+(Counts2 a, Counts2 b) {
  return {a.lo + b.lo, a.hi + b.hi};
}

template <bool PI>
struct FullRule {
  using Word = Counts2;
  static __device__ __forceinline__ Word pack(int cell) {
    const uint32_t alive = cell & 1;
    const uint32_t spawning = (cell >> 7) & 1;
    const uint32_t cw = alive + 2 * spawning;
    const uint32_t c = static_cast<uint32_t>(cell) >> COLOR_BIT;
    const uint32_t spread = ((c & 1) << 8) | ((c & 2) << 15) | ((c & 4) << 22);
    const uint32_t has_d = ((cell >> 3) | (cell >> 8)) & 1;
    uint32_t hi = (has_d & alive) | (spawning << 24);
    if (PI) hi |= (((cell >> 5) & 1) << 8) | (((cell >> 6) & 1) << 16);
    return {alive | spread * cw, hi};
  }
  template <class Spawn>
  static __device__ __forceinline__ int rule(int cell, Word n, Spawn spawn) {
    const int n_alive = n.lo & 255;
    const bool frozen = (cell & FROZEN) != 0;
    const bool preserved = PI && ((n.hi >> 8) & 255) != 0;
    const bool inhibited = PI && ((n.hi >> 16) & 255) != 0;
    if (cell & 1) {
      return (frozen || preserved || n_alive == 3 || n_alive == 4) ? cell : 0;
    }
    const int inherit = (((n.lo >> 8) & 255) >= 2 ? COLOR_R : 0) |
                        (((n.lo >> 16) & 255) >= 2 ? COLOR_R << 1 : 0) |
                        ((n.lo >> 24) >= 2 ? COLOR_B : 0);
    if (frozen || inhibited) return cell;
    if (n_alive == 3) {
      return ALIVE | inherit | ((n.hi & 255) >= 2 ? DESTRUCTIBLE : 0);
    }
    if ((n.hi >> 24) != 0 && spawn()) return ALIVE | DESTRUCTIBLE | inherit;
    return cell;
  }
};

// Goal boards that never change: no stencil, the cell as it is.
struct StaticRule {};

// Slides the 3x3 sum of Rule's words along row r of environment b: column
// sums of three rows move along the row, so each cell is packed three
// times instead of nine.  advance(c, spawn) returns the new cell at
// column c; call it for c = 0, 1, ..., W - 1 in order.
template <class Rule>
struct RowStream {
  using Word = typename Rule::Word;
  const uint16_t* up;
  const uint16_t* mid;
  const uint16_t* dn;
  long long B;
  int W;
  Word first, prev, cur;

  __device__ __forceinline__ RowStream(const uint16_t* __restrict__ board,
                                       int r, int H, int W_, long long B_,
                                       long long b)
      : B(B_), W(W_) {
    const long long row = static_cast<long long>(W) * B;
    up = board + ((r + H - 1) % H) * row + b;
    mid = board + r * row + b;
    dn = board + ((r + 1) % H) * row + b;
    first = column(0);
    prev = column(W - 1);
    cur = first;
  }
  __device__ __forceinline__ Word column(int c) const {
    const long long o = c * B;
    return Rule::pack(up[o]) + Rule::pack(mid[o]) + Rule::pack(dn[o]);
  }
  template <class Spawn>
  __device__ __forceinline__ int advance(int c, Spawn spawn) {
    const Word next = (c + 1 < W) ? column(c + 1) : first;
    const int out = Rule::rule(mid[c * B], prev + cur + next, spawn);
    prev = cur;
    cur = next;
    return out;
  }
};

template <>
struct RowStream<StaticRule> {
  const uint16_t* mid;
  long long B;
  __device__ __forceinline__ RowStream(const uint16_t* __restrict__ board,
                                       int r, int, int W, long long B_,
                                       long long b)
      : mid(board + r * static_cast<long long>(W) * B_ + b), B(B_) {}
  template <class Spawn>
  __device__ __forceinline__ int advance(int c, Spawn) {
    return mid[c * B];
  }
};

// RowStream over a (H * W, S) slab, environment e: the same sliding 3x3
// sum along row r, from column c0 on (K2/K3's layout,
// csrc/env_step_kernels.cu).  Off is the offset type: int for a slab of E
// environments in shared memory (S = E), long long for a board in device
// memory (S = B).  Call advance(c, spawn) for c = c0, c0 + 1, ... in
// order, at most to the end of the row.
template <class Rule, class Off = int>
struct SlabStream {
  using Word = typename Rule::Word;
  const uint16_t* up;
  const uint16_t* mid;
  const uint16_t* dn;
  Off S;
  int W;
  Word prev, cur;

  __device__ __forceinline__ SlabStream(const uint16_t* slab, int r, int H,
                                        int W_, Off S_, int e, int c0)
      : S(S_), W(W_) {
    const Off row = W * S;
    up = slab + (r == 0 ? H - 1 : r - 1) * row + e;
    mid = slab + r * row + e;
    dn = slab + (r + 1 == H ? 0 : r + 1) * row + e;
    prev = column(c0 == 0 ? W - 1 : c0 - 1);
    cur = column(c0);
  }
  __device__ __forceinline__ Word column(int c) const {
    const Off o = c * S;
    return Rule::pack(up[o]) + Rule::pack(mid[o]) + Rule::pack(dn[o]);
  }
  template <class Spawn>
  __device__ __forceinline__ int advance(int c, Spawn spawn) {
    const Word next = column(c + 1 < W ? c + 1 : 0);
    const int out = Rule::rule(mid[c * S], prev + cur + next, spawn);
    prev = cur;
    cur = next;
    return out;
  }
};

template <class Off>
struct SlabStream<StaticRule, Off> {
  const uint16_t* mid;
  Off S;
  __device__ __forceinline__ SlabStream(const uint16_t* slab, int r, int,
                                        int W, Off S_, int e, int)
      : mid(slab + r * W * S_ + e), S(S_) {}
  template <class Spawn>
  __device__ __forceinline__ int advance(int c, Spawn) {
    return mid[c * S];
  }
};

// A spawn functor for rules and boards that never spawn.
struct NoSpawn {
  __device__ __forceinline__ bool operator()() const { return false; }
};

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
