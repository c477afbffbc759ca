// Philox4x32-10 as a device function: the spawn draw of the CA kernels.
//
// Replaces the TPU's in-core PRNG (safelife_tpu/ops/life_pallas.py
// _spawn_field, _spawn_field_pair).  Key (seed, 0), counter (cell index
// r * W + c, environment index, 0, 0): a cell's word depends on nothing but
// the seed and its own position, so a kernel draws only where the rule
// reads the draw and still equals the full fields of the plain version
// (safelife_torch/ops/rng.py, which holds the same constants).
#pragma once

#include <cstdint>

namespace safelife {

__device__ __forceinline__ uint32_t philox_word(uint32_t seed, uint32_t cell,
                                                uint32_t env) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
  uint32_t c0 = cell, c1 = env, c2 = 0, c3 = 0, k0 = seed, k1 = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// How a kernel draws: not at all, 24 bits for the board, or one word split
// into a low half for the board and a high half for the goal board.
enum Draw { DRAW_NONE = 0, DRAW_U24 = 1, DRAW_PAIR = 2 };

// int32(float32(p) * 2^bits), truncated as the TPU kernel's astype(int32).
template <int DRAW>
__device__ __forceinline__ int spawn_threshold(float p) {
  return static_cast<int>(__fmul_rn(p, DRAW == DRAW_PAIR ? 65536.0f
                                                          : 16777216.0f));
}

// Does the spawn fire at this cell?  HALF 0 is the board's draw, HALF 1
// the goal board's (the pair's high half).
template <int DRAW, int HALF>
__device__ __forceinline__ bool spawn_draw(uint32_t seed, uint32_t cell,
                                           uint32_t env, int thresh) {
  if (DRAW == DRAW_NONE) return false;
  const uint32_t word = philox_word(seed, cell, env);
  if (DRAW == DRAW_U24) {
    return static_cast<int>((word >> 8) & 0xFFFFFFu) < thresh;
  }
  return static_cast<int>(HALF ? word >> 16 : word & 0xFFFFu) < thresh;
}

}  // namespace safelife
