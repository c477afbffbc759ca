// K4-K8: standalone CA advances of (H, W, B) uint16 boards, one templated
// kernel.
//
// Replaces the TPU kernels of safelife_tpu/ops/life_pallas.py:
//   K4  _spawnless_kernel   (advance_spawnless): boards without spawners;
//   K5  _field_kernel       (advance_with_field): the full rule with a given
//                           spawn field (_advance_block);
//   K6  _simple_kernel      (advance_simple): certified simple goal boards
//                           (_advance_goals_simple);
//   K7  _pair_field_kernel  (advance_pair_spawnsimple_with_fields): a board
//                           and a spawn-simple goal board with given fields
//                           (_advance_pair_spawnsimple);
//   K8  _kernel             (advance_both): the general pair with the paired
//                           16-bit spawn draw (_advance_pair,
//                           _spawn_field_pair), here Philox (philox.cuh).
// The advance kernel of env_step_kernels.cu inlines the same rules
// (safelife_rule.cuh).
//
// Bound: bytes.  Each board cell is read once and written once, each field
// cell read once: 4 bytes per cell for K4 and K6, 5 for K5, 10 for K7 and 8
// for K8 (at B = 65536 on 26x26 boards 0.053, 0.066, 0.13 and 0.11 ms at
// 3.35 TB/s).  The rules are 40-80 integer operations per cell; K8 adds a
// ten-round Philox draw where a spawn could fire, a few cells per board.
//
// Design: one thread per (environment, row), 128 environments per block,
// so a warp reads and writes 64 contiguous bytes per cell.  Each thread
// slides a three-row column sum along its row (RowStream); the rows above
// and below are reread by neighbouring rows' threads and come from L2.
// The draw is counter-based, so a thread draws only at the cells where the
// rule reads it and still equals the plain version's full field.
#include <cuda_runtime.h>

#include <type_traits>

#include "philox.cuh"
#include "safelife_rule.cuh"

namespace {

using namespace safelife;

constexpr int THREADS = 128;

// RuleG = StaticRule advances the board alone.  FIELDS reads given spawn
// fields; otherwise DRAW says how the kernel draws its own.
template <class RuleB, class RuleG, bool FIELDS, int DRAW>
__global__ void __launch_bounds__(THREADS) rule_kernel(
    const int32_t* __restrict__ seed, const float* __restrict__ prob,
    const uint16_t* __restrict__ board, const bool* __restrict__ field_b,
    const uint16_t* __restrict__ goals, const bool* __restrict__ field_g,
    uint16_t* __restrict__ out_b, uint16_t* __restrict__ out_g, int H, int W,
    int B) {
  constexpr bool PAIR = !std::is_same<RuleG, StaticRule>::value;
  const long long b = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (b >= B) return;
  const long long BB = B;
  const int r = blockIdx.y;
  const uint32_t key = DRAW != DRAW_NONE ? static_cast<uint32_t>(seed[0]) : 0;
  const int thresh = DRAW != DRAW_NONE ? spawn_threshold<DRAW>(prob[b]) : 0;
  const uint32_t env = static_cast<uint32_t>(b);
  RowStream<RuleB> sb(board, r, H, W, BB, b);
  RowStream<RuleG> sg(PAIR ? goals : board, r, H, W, BB, b);
  for (int c = 0; c < W; ++c) {
    const long long o = (static_cast<long long>(r) * W + c) * BB + b;
    const uint32_t cell = r * W + c;
    out_b[o] = static_cast<uint16_t>(sb.advance(c, [&] {
      return FIELDS ? field_b[o] : spawn_draw<DRAW, 0>(key, cell, env, thresh);
    }));
    if constexpr (PAIR) {
      out_g[o] = static_cast<uint16_t>(sg.advance(c, [&] {
        return FIELDS ? field_g[o]
                      : spawn_draw<DRAW, 1>(key, cell, env, thresh);
      }));
    }
  }
}

template <class RuleB, class RuleG, bool FIELDS, int DRAW>
int launch(const int32_t* seed, const float* prob, const uint16_t* board,
           const bool* field_b, const uint16_t* goals, const bool* field_g,
           uint16_t* out_b, uint16_t* out_g, int H, int W, int B,
           cudaStream_t stream) {
  const dim3 grid((B + THREADS - 1) / THREADS, H);
  rule_kernel<RuleB, RuleG, FIELDS, DRAW><<<grid, THREADS, 0, stream>>>(
      seed, prob, board, field_b, goals, field_g, out_b, out_g, H, W, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sl_advance_spawnless(const uint16_t* in, uint16_t* out, int H,
                                    int W, int B, cudaStream_t stream) {
  return launch<SpawnlessRule, StaticRule, false, DRAW_NONE>(
      nullptr, nullptr, in, nullptr, nullptr, nullptr, out, nullptr, H, W, B,
      stream);
}

extern "C" int sl_advance_with_field(const uint16_t* board, const bool* spawn,
                                     uint16_t* out, int H, int W, int B,
                                     cudaStream_t stream) {
  return launch<FullRule<true>, StaticRule, true, DRAW_NONE>(
      nullptr, nullptr, board, spawn, nullptr, nullptr, out, nullptr, H, W, B,
      stream);
}

extern "C" int sl_advance_simple(const uint16_t* goals, uint16_t* out, int H,
                                 int W, int B, cudaStream_t stream) {
  return launch<SimpleRule, StaticRule, false, DRAW_NONE>(
      nullptr, nullptr, goals, nullptr, nullptr, nullptr, out, nullptr, H, W,
      B, stream);
}

extern "C" int sl_advance_pair_fields(const uint16_t* board,
                                      const bool* spawn_b,
                                      const uint16_t* goals,
                                      const bool* spawn_g, uint16_t* out_b,
                                      uint16_t* out_g, int H, int W, int B,
                                      cudaStream_t stream) {
  return launch<FullRule<true>, FullRule<false>, true, DRAW_NONE>(
      nullptr, nullptr, board, spawn_b, goals, spawn_g, out_b, out_g, H, W, B,
      stream);
}

extern "C" int sl_advance_both(const int32_t* seed, const float* prob,
                               const uint16_t* board, const uint16_t* goals,
                               uint16_t* out_b, uint16_t* out_g, int H, int W,
                               int B, cudaStream_t stream) {
  return launch<FullRule<true>, FullRule<true>, false, DRAW_PAIR>(
      seed, prob, board, nullptr, goals, nullptr, out_b, out_g, H, W, B,
      stream);
}
