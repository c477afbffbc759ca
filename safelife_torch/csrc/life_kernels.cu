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
// Bound: bytes.  Each board cell is read once and written once: 4 bytes
// per cell for K4 and K6, 8 for K7 and K8 (at B = 65536 on 26x26 boards
// 0.053 and 0.106 ms at 3.35 TB/s); a given spawn field is read only where
// the rule asks for a draw.  The rules are 40-80 integer operations per
// cell; K8 adds a ten-round Philox draw where a spawn could fire, a few
// cells per board.  At the ALU's INT32 rate the operations alone take about
// as long as the bytes, so the design keeps the instructions a cell few.
//
// Design (staged): a block owns a slab of E environments (8, 16 or 32;
// ops/life_kernels.py rule_geometry picks it against the shared-memory
// budget) and advances one board at a time, the board, then on the pair
// rules the goal board:
//   1. stage the board's (H * W, E) slab in shared memory with 16-byte
//      cp.async (slab.cuh): each byte is read from device memory once;
//   2. vertical sums: one thread per (environment, column) walks down the
//      column, packs each cell once into the rule's count word and writes
//      the sum of the words of rows r - 1, r and r + 1 into a shared slab
//      of words;
//   3. the rule: one thread per (environment, row) slides the sum of three
//      neighbouring vertical sums along the row and writes each new cell
//      over the old one in the staged slab (only that thread reads it);
//   4. write the slab out in 16-byte vectors.
// Lane = environment, so a warp's shared accesses are consecutive words.
// The spawn draw is counter-based, so a thread draws only at the cells where
// the rule asks and still equals the plain version's full field; a given
// field is read from device memory there, one byte.  B % 8 != 0, or a
// tensor that is not 16-byte aligned, takes the same kernel with 2-byte
// accesses.  A board too large for a slab of 8 environments takes the
// streamed variant: one thread per (environment, row), 128 environments a
// block, sliding a three-row column sum along its row in device memory
// (RowStream).
#include <cuda_runtime.h>

#include <type_traits>

#include "philox.cuh"
#include "safelife_rule.cuh"
#include "slab.cuh"

namespace {

using namespace safelife;

// Limits of the launch geometry, which ops/life_kernels.py rule_geometry
// computes and launch only checks: a staged slab of at most MAX_ENVS
// environments (a multiple of 8) and MAX_THREADS threads a block, two
// blocks an SM (at most 64 registers a thread); the streamed variant runs
// STREAM_THREADS environments a block.
constexpr int MAX_ENVS = 32;
constexpr int MAX_THREADS = 512;
constexpr int MIN_BLOCKS = 2;
constexpr int STREAM_THREADS = 128;

// seed, prob: the step's int32 seed and the (B,) spawn probabilities (read
// only when DRAW != DRAW_NONE).  Geometry: envs (slab width E), slots
// (threads per environment), vector (16-byte path), staged.
struct RuleArgs {
  const int32_t* seed;
  const float* prob;
  const uint16_t* board;
  const bool* field_b;
  const uint16_t* goals;
  const bool* field_g;
  uint16_t* out_b;
  uint16_t* out_g;
  int H, W, B, envs, slots, vector, staged;
};

// Step 2: sums[r][c] = pack(r - 1, c) + pack(r, c) + pack(r + 1, c) on the
// torus, for the columns s, s + slots, ... of environment e.
template <class Rule>
__device__ __forceinline__ void vertical_sums(const uint16_t* slab,
                                              typename Rule::Word* sums,
                                              int H, int W, int E, int e,
                                              int s, int slots) {
  using Word = typename Rule::Word;
  const int row = W * E;
  const int limit = (H - 2) * row;
  for (int c = s; c < W; c += slots) {
    const uint16_t* col = slab + c * E + e;
    Word* out = sums + c * E + e;
    const Word last = Rule::pack(col[(H - 1) * row]);
    const Word first = H > 1 ? Rule::pack(col[0]) : last;
    Word prev = last, cur = first;
    int o = 0;
    for (; o < limit; o += row) {
      const Word next = Rule::pack(col[o + row]);
      out[o] = prev + cur + next;
      prev = cur;
      cur = next;
    }
    // Rows H - 2 and H - 1: their lower neighbours are packed already.
    if (H > 1) {
      out[o] = prev + cur + last;
      prev = cur;
      cur = last;
      o += row;
    }
    out[o] = prev + cur + first;
  }
}

// Step 3: the rule along rows s, s + slots, ... of environment e, each new
// cell written over the old one.  spawn(o) answers the draw at slab offset
// o.
template <class Rule, class Spawn>
__device__ __forceinline__ void rule_rows(uint16_t* slab,
                                          const typename Rule::Word* sums,
                                          int H, int W, int E, int e, int s,
                                          int slots, Spawn spawn) {
  using Word = typename Rule::Word;
  const int row = W * E;
  for (int r = s; r < H; r += slots) {
    const int o0 = r * row + e;
    const int end = o0 + (W - 1) * E;
    const Word first = sums[o0];
    Word prev = sums[end], cur = first;
    int o = o0;
    for (; o < end; o += E) {
      const Word next = sums[o + E];
      slab[o] = static_cast<uint16_t>(
          Rule::rule(slab[o], prev + cur + next, [&] { return spawn(o); }));
      prev = cur;
      cur = next;
    }
    slab[o] = static_cast<uint16_t>(
        Rule::rule(slab[o], prev + cur + first, [&] { return spawn(o); }));
  }
}

// Steps 1-4 for one board of the block's slab.  HALF picks the board's
// (0) or the goal board's (1) half of the paired draw.
template <class Rule, bool FIELDS, int DRAW, int HALF>
__device__ __forceinline__ void advance_slab(
    const RuleArgs& a, uint16_t* slab, typename Rule::Word* sums,
    const int* thresh, const uint16_t* __restrict__ src,
    const bool* __restrict__ field, uint16_t* __restrict__ dst) {
  const int H = a.H, W = a.W, E = a.envs, n = H * W;
  const int t = threadIdx.x;
  const long long BB = a.B;
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + E));
  const bool vec = a.vector != 0;
  stage(slab, src + b0, n, E, lanes, BB, vec);
  cp_async_wait_all();
  __syncthreads();
  const int e = t % E, s = t / E;
  const bool live = e < lanes;
  if (live) vertical_sums<Rule>(slab, sums, H, W, E, e, s, a.slots);
  __syncthreads();
  if (live) {
    rule_rows<Rule>(slab, sums, H, W, E, e, s, a.slots, [&](int o) {
      // Rare (a dead cell beside a spawner): the cell index is worked
      // out here rather than carried through the row loop.
      const int cell = (o - e) / E;
      if (FIELDS) return field[cell * BB + b0 + e];
      return spawn_draw<DRAW, HALF>(a.seed[0], static_cast<uint32_t>(cell),
                                    static_cast<uint32_t>(b0 + e), thresh[e]);
    });
  }
  __syncthreads();
  unstage(dst + b0, slab, n, E, lanes, BB, vec);
}

// RuleG = StaticRule advances the board alone.  FIELDS reads given spawn
// fields; otherwise DRAW says how the kernel draws its own.  Shared memory:
// the words slab, then the 16-bit slab.
template <class RuleB, class RuleG, bool FIELDS, int DRAW>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    staged_rule_kernel(const RuleArgs a) {
  constexpr bool PAIR = !std::is_same<RuleG, StaticRule>::value;
  using Word = typename RuleB::Word;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int thresh[MAX_ENVS];
  const int nE = a.H * a.W * a.envs;
  Word* sums = reinterpret_cast<Word*>(smem);
  uint16_t* slab = reinterpret_cast<uint16_t*>(sums + nE);
  if (DRAW != DRAW_NONE) {
    const long long b = static_cast<long long>(blockIdx.x) * a.envs +
                        threadIdx.x;
    if (threadIdx.x < a.envs && b < a.B) {
      thresh[threadIdx.x] = spawn_threshold<DRAW>(a.prob[b]);
    }
  }
  advance_slab<RuleB, FIELDS, DRAW, 0>(a, slab, sums, thresh, a.board,
                                       a.field_b, a.out_b);
  if constexpr (PAIR) {
    static_assert(sizeof(typename RuleG::Word) == sizeof(Word),
                  "both boards share the words slab");
    // The board's write-out reads the slab the goals are staged into.
    __syncthreads();
    advance_slab<RuleG, FIELDS, DRAW, 1>(
        a, slab, reinterpret_cast<typename RuleG::Word*>(smem), thresh,
        a.goals, a.field_g, a.out_g);
  }
}

// The streamed variant: one thread per (environment, row) on the boards in
// device memory.
template <class RuleB, class RuleG, bool FIELDS, int DRAW>
__global__ void __launch_bounds__(STREAM_THREADS)
    streamed_rule_kernel(const RuleArgs a) {
  constexpr bool PAIR = !std::is_same<RuleG, StaticRule>::value;
  const long long b = static_cast<long long>(blockIdx.x) * STREAM_THREADS +
                      threadIdx.x;
  if (b >= a.B) return;
  const int H = a.H, W = a.W;
  const long long BB = a.B;
  const int r = blockIdx.y;
  const uint32_t key = DRAW != DRAW_NONE ? static_cast<uint32_t>(a.seed[0])
                                         : 0;
  const int thresh = DRAW != DRAW_NONE ? spawn_threshold<DRAW>(a.prob[b]) : 0;
  const uint32_t env = static_cast<uint32_t>(b);
  RowStream<RuleB> sb(a.board, r, H, W, BB, b);
  RowStream<RuleG> sg(PAIR ? a.goals : a.board, r, H, W, BB, b);
  for (int c = 0; c < W; ++c) {
    const long long o = (static_cast<long long>(r) * W + c) * BB + b;
    const uint32_t cell = r * W + c;
    a.out_b[o] = static_cast<uint16_t>(sb.advance(c, [&] {
      return FIELDS ? a.field_b[o]
                    : spawn_draw<DRAW, 0>(key, cell, env, thresh);
    }));
    if constexpr (PAIR) {
      a.out_g[o] = static_cast<uint16_t>(sg.advance(c, [&] {
        return FIELDS ? a.field_g[o]
                      : spawn_draw<DRAW, 1>(key, cell, env, thresh);
      }));
    }
  }
}

template <class RuleB, class RuleG, bool FIELDS, int DRAW>
int launch(const RuleArgs& a, cudaStream_t stream) {
  if (!a.staged) {
    if (a.vector) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((a.B + STREAM_THREADS - 1) / STREAM_THREADS, a.H);
    streamed_rule_kernel<RuleB, RuleG, FIELDS, DRAW>
        <<<grid, STREAM_THREADS, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = a.envs * a.slots;
  if (a.envs % 8 != 0 || a.envs > MAX_ENVS || a.slots < 1 ||
      threads > MAX_THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The words slab and the 16-bit slab; the wrapper has checked that they
  // fit.
  const int smem = a.H * a.W * a.envs *
                   static_cast<int>(sizeof(typename RuleB::Word) +
                                    sizeof(uint16_t));
  auto kernel = staged_rule_kernel<RuleB, RuleG, FIELDS, DRAW>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.B + a.envs - 1) / a.envs);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sl_advance_spawnless(const uint16_t* in, uint16_t* out, int H,
                                    int W, int B, int envs, int slots,
                                    int vector, int staged,
                                    cudaStream_t stream) {
  const RuleArgs a{nullptr, nullptr, in,    nullptr, nullptr, nullptr, out,
                   nullptr, H,       W,     B,       envs,    slots,   vector,
                   staged};
  return launch<SpawnlessRule, StaticRule, false, DRAW_NONE>(a, stream);
}

extern "C" int sl_advance_with_field(const uint16_t* board, const bool* spawn,
                                     uint16_t* out, int H, int W, int B,
                                     int envs, int slots, int vector,
                                     int staged, cudaStream_t stream) {
  const RuleArgs a{nullptr, nullptr, board, spawn, nullptr, nullptr, out,
                   nullptr, H,       W,     B,     envs,    slots,   vector,
                   staged};
  return launch<FullRule<true>, StaticRule, true, DRAW_NONE>(a, stream);
}

extern "C" int sl_advance_simple(const uint16_t* goals, uint16_t* out, int H,
                                 int W, int B, int envs, int slots, int vector,
                                 int staged, cudaStream_t stream) {
  const RuleArgs a{nullptr, nullptr, goals, nullptr, nullptr, nullptr, out,
                   nullptr, H,       W,     B,       envs,    slots,   vector,
                   staged};
  return launch<SimpleRule, StaticRule, false, DRAW_NONE>(a, stream);
}

extern "C" int sl_advance_pair_fields(const uint16_t* board,
                                      const bool* spawn_b,
                                      const uint16_t* goals,
                                      const bool* spawn_g, uint16_t* out_b,
                                      uint16_t* out_g, int H, int W, int B,
                                      int envs, int slots, int vector,
                                      int staged, cudaStream_t stream) {
  const RuleArgs a{nullptr, nullptr, board, spawn_b, goals, spawn_g, out_b,
                   out_g,   H,       W,     B,       envs,  slots,   vector,
                   staged};
  return launch<FullRule<true>, FullRule<false>, true, DRAW_NONE>(a, stream);
}

extern "C" int sl_advance_both(const int32_t* seed, const float* prob,
                               const uint16_t* board, const uint16_t* goals,
                               uint16_t* out_b, uint16_t* out_g, int H, int W,
                               int B, int envs, int slots, int vector,
                               int staged, cudaStream_t stream) {
  const RuleArgs a{seed,  prob, board, nullptr, goals, nullptr, out_b,
                   out_g, H,    W,     B,       envs,  slots,   vector,
                   staged};
  return launch<FullRule<true>, FullRule<true>, false, DRAW_PAIR>(a, stream);
}
