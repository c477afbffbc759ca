// The environment step core on (H, W, B) uint16 boards: K1 (action) and
// K2/K3 (advance, scoring, exit recolour, side-effect count, and for K2 the
// auto-reset fold and the packed agent-centred view).
//
// Replaces the TPU kernels of safelife_tpu/ops/env_step_pallas.py:
//   K1  _action_kernel (with _apply_action), launched by fused_step, and
//       relaunched alone by scripts/stepbench.py:111 (S1) and over block
//       widths by scripts/ablock_bench.py:42 (S2);
//   K2  _advance_kernel with time_limit > 0 (fold, optional view);
//   K3  _advance_kernel with time_limit == 0 (no fold, no view).
// K2/K3 inline the CA rule the bank's flags pick (env_step_pallas.py
// :303-335, rules in safelife_rule.cuh): static goals with or without
// spawners, certified simple goals, spawn-simple goals, or the general
// pair, with the spawn draw of philox.cuh (none on spawnless banks, the
// paired 16-bit draw where the goals spawn too, 24 bits otherwise).
//
// Bound.
//   K1 reads the board and writes a new one: bytes, 4 per cell (177 MB at
//      B = 65536 on 26x26 boards, 0.053 ms at 3.35 TB/s); its decode is
//      about 60 operations per environment, not per cell.
//   K2/K3: bytes, as a guaranteed least time: K2 moves 12 bytes a cell
//      (three boards in, three out; K3 10), about 0.17 ms at B = 65536.
//      The work is integer, 70-165 operations a cell on the rules, scoring
//      and side effects (and 90 a Philox draw where one is asked for): at
//      the ALU's 64 INT32 results per SM and clock (about 16.7 T/s) that
//      is an estimate of 0.2 ms on static spawnless goals and 0.44 ms on
//      spawn-simple goals, not a bound, since IMAD also issues on the FMA
//      pipe and LOP3 / IADD3 fold two or three of the counted operations
//      into one instruction.  So the design keeps the integer instructions
//      a cell few (32-bit offsets, no second pass over init) as well as
//      the bytes.
//
// Design.
//   K1: a block owns 16, 32 or 64 environments over all H rows (by block
//   width, action_envs).  One thread per environment reads its si rows and
//   the four cells around its agent once, decodes the action and keeps the
//   at most four patches in registers; meanwhile every thread copies the
//   block's (H, W, E) slab in 16-byte vectors.  After a barrier (which
//   orders the block's global writes) the deciding thread writes its
//   patches in the TPU kernel's order p3, p1, p2, p0, so the later write
//   wins where two land on one cell.  The output never aliases the input.
//   K2/K3: a block owns a slab of E environments (8, 16 or 32; the wrapper
//   picks it against the shared-memory budget, ops/env_step_kernels.py
//   advance_geometry) and stages the slab's board, goal board and initial
//   board, (H * W, E) uint16 each, in shared memory with 16-byte cp.async:
//   each byte comes from device memory once.  Pass 1 gives each thread a
//   row segment of one environment (lane = environment, so a warp reads
//   consecutive 2-byte words of shared memory, without bank conflicts) and
//   slides the 3x3 sums along it from shared memory (SlabStream), writing
//   the advanced boards into shared output slabs, summing points, score,
//   side effects and (dynamic goals) the possible score over the segment,
//   and marking the exit cells of the initial board in a register bit mask
//   instead of writing them.  The sums meet per environment in shared
//   memory; then comp, poss and the exit gate ce1.  Pass 2 writes the
//   marked exit cells of the environments that did not reset.  The output
//   slabs then go out in 16-byte vectors, the fresh levels blended in for
//   the environments that reset (read only for their 8-environment
//   groups); the view is gathered from the final slabs (a torus crop:
//   every view cell has one source cell) and written in 16-byte vectors,
//   and after a barrier the exit pixels over it.  Offsets within the slab
//   are 32-bit; global pointers advance by a stride.  B % 8 != 0, or a
//   pointer that is not 16-byte aligned, takes the same kernel with 2-byte
//   accesses.  A board
//   too large for a slab of 8 environments (about 2900 cells on the
//   dynamic goal rules, 3600 on the static ones) takes the streamed
//   variant of the same template: 32 environments a block read and write
//   the boards in device memory, 2 bytes a thread.  Template flags give K2
//   and K3, both variants and every rule from one source.
#include <cuda_runtime.h>

#include <type_traits>

#include "philox.cuh"
#include "safelife_rule.cuh"
#include "slab.cuh"

namespace {

using namespace safelife;

__device__ __forceinline__ int select_by_orient(int o, int t0, int t1, int t2,
                                                int t3) {
  int out = t0;
  out = o == 1 ? t1 : out;
  out = o == 2 ? t2 : out;
  return o == 3 ? t3 : out;
}

// The 16-bit lanes of an 8-lane vector whose bit is set in m, as a mask.
__device__ __forceinline__ uint4 lane_mask(unsigned m) {
  auto word = [](unsigned bits) {
    return ((bits & 1) ? 0xFFFFu : 0u) | ((bits & 2) ? 0xFFFF0000u : 0u);
  };
  return make_uint4(word(m), word(m >> 2), word(m >> 4), word(m >> 6));
}

__device__ __forceinline__ uint4 blend(uint4 v, uint4 f, uint4 m) {
  return make_uint4((v.x & ~m.x) | (f.x & m.x), (v.y & ~m.y) | (f.y & m.y),
                    (v.z & ~m.z) | (f.z & m.z), (v.w & ~m.w) | (f.w & m.w));
}

// ---------------------------------------------------------------------------
// K1: action
// ---------------------------------------------------------------------------

// si rows: 0 action, 1 agent_row, 2 agent_col, 3 orientation, 4 game_over,
// 5 can_exit0, 6 baseline_score, 7 episode_length, 8 perf_possible.
// out_i rows: 0 agent_row', 1 agent_col', 2 orientation', 3 exited.
// BLOCK threads per block: 128 on the main path (sl_action); the other
// widths are the block sweep of scripts/ablock_bench.py (sl_action_block).
// vec: B % 8 == 0 and both boards 16-byte aligned.

// The environments a block of BLOCK threads owns (a thread decodes each):
// for each width the fastest of 16, 32 and 64 on the H100 (PERF.md §6).
__host__ __device__ constexpr int action_envs(int block) {
  return block <= 64 ? 16 : (block <= 256 ? 32 : 64);
}

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    action_kernel(const int32_t* __restrict__ si,
                  const uint16_t* __restrict__ board,
                  uint16_t* __restrict__ out, int32_t* __restrict__ out_i,
                  int H, int W, int B, int vec) {
  constexpr int ENVS = action_envs(BLOCK);
  const int t = threadIdx.x;
  const int n = H * W;
  const long long BB = B;
  const long long b0 = static_cast<long long>(blockIdx.x) * ENVS;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + ENVS));

  // ---- decode: one thread per environment ----------------------------------
  bool set3 = false, set1 = false, pulled = false, moved = false;
  int i0 = 0, i1 = 0, i2 = 0, i3 = 0, v1 = 0, p1 = 0, p0 = 0;
  if (t < lanes) {
    const long long b = b0 + t;
    const int action = si[0 * BB + b];
    const int r0 = si[1 * BB + b];
    const int c0 = si[2 * BB + b];
    const int game_over = si[4 * BB + b];
    const int can_exit0 = si[5 * BB + b];
    const bool is_move = action >= 1 && action <= 4 && game_over == 0;
    const bool is_toggle = action >= 5 && action <= 8 && game_over == 0;
    const int orient =
        (is_move || is_toggle) ? floor_mod(action - 1, 4) : si[3 * BB + b];
    const int dr = select_by_orient(orient, -1, 0, 1, 0);
    const int dc = select_by_orient(orient, 0, 1, 0, -1);
    i0 = r0 * W + c0;
    i1 = floor_mod(r0 + dr, H) * W + floor_mod(c0 + dc, W);
    i2 = floor_mod(r0 - dr, H) * W + floor_mod(c0 - dc, W);
    i3 = floor_mod(r0 + 2 * dr, H) * W + floor_mod(c0 + 2 * dc, W);
    const uint16_t* cells = board + b;
    const int v0 = cells[i0 * BB];
    v1 = cells[i1 * BB];
    const int v2 = cells[i2 * BB];
    const int v3 = cells[i3 * BB];

    const bool front_empty = v1 == 0;
    const bool front_exit = !front_empty && (v1 & EXIT) && can_exit0 != 0;
    const bool pushable = !front_empty && !front_exit && (v1 & PUSHABLE);
    const bool push_to_empty = pushable && v3 == 0;
    const bool push_out_exit = pushable && v3 != 0 && (v3 & EXIT);
    moved = is_move && (front_empty || push_to_empty || push_out_exit);
    const bool exited = is_move && front_exit;
    pulled = moved && (v2 & PULLABLE);
    const bool tgl_create = is_toggle && v1 == 0;
    const bool tgl_destroy = is_toggle && v1 != 0 && (v1 & DESTRUCTIBLE);
    set3 = is_move && push_to_empty;
    set1 = moved || tgl_create || tgl_destroy;
    p1 = moved ? v0 : (tgl_create ? (LIFE | (v0 & COLORS)) : 0);
    p0 = pulled ? v2 : 0;
    out_i[0 * BB + b] = moved ? i1 / W : r0;
    out_i[1 * BB + b] = moved ? i1 % W : c0;
    out_i[2 * BB + b] = orient;
    out_i[3 * BB + b] = exited;
  }

  // ---- copy the slab --------------------------------------------------------
  if (vec) {
    // Thread t copies 8 environments (group t % G) of every STEP-th cell.
    constexpr int G = ENVS / 8, STEP = BLOCK / G;
    const int g = t % G;
    if (g * 8 < lanes) {
      const long long stride = STEP * BB;
      const long long first = (t / G) * BB + b0 + g * 8;
      const uint16_t* src = board + first;
      uint16_t* dst = out + first;
      int cell = t / G;
      for (; cell + 3 * STEP < n; cell += 4 * STEP) {
        const uint4 x0 = ldg16(src), x1 = ldg16(src + stride),
                    x2 = ldg16(src + 2 * stride), x3 = ldg16(src + 3 * stride);
        store16(dst, x0);
        store16(dst + stride, x1);
        store16(dst + 2 * stride, x2);
        store16(dst + 3 * stride, x3);
        src += 4 * stride;
        dst += 4 * stride;
      }
      for (; cell < n; cell += STEP, src += stride, dst += stride) {
        store16(dst, ldg16(src));
      }
    }
  } else {
    constexpr int STEP = BLOCK / ENVS;
    const int e = t % ENVS;
    if (e < lanes) {
      const long long stride = STEP * BB;
      const long long first = (t / ENVS) * BB + b0 + e;
      const uint16_t* src = board + first;
      uint16_t* dst = out + first;
      for (int cell = t / ENVS; cell < n;
           cell += STEP, src += stride, dst += stride) {
        *dst = *src;
      }
    }
  }

  // ---- patches, after the copy ---------------------------------------------
  __syncthreads();
  if (t < lanes) {
    uint16_t* cells = out + b0 + t;
    if (set3) cells[i3 * BB] = static_cast<uint16_t>(v1);
    if (set1) cells[i1 * BB] = static_cast<uint16_t>(p1);
    if (pulled) cells[i2 * BB] = 0;
    if (moved) cells[i0 * BB] = static_cast<uint16_t>(p0);
  }
}

// ---------------------------------------------------------------------------
// K2/K3: advance, scoring, exit recolour, side effects, fold, view
// ---------------------------------------------------------------------------

// Limits of the launch geometry, which ops/env_step_kernels.py
// advance_geometry computes and launch_advance only checks: at most
// MAX_THREADS threads a block and row segments of at most MAX_SEG cells; a
// staged slab of at most MAX_ENVS environments (a multiple of 8) and
// MAX_CELLS cells a thread (the exit bit mask); the streamed variant takes
// MAX_ENVS environments.  Two blocks an SM (the staged slabs' target) cap
// a thread at 64 registers; without the hint ptxas picked a lower target
// for one streamed instantiation and spilled.
constexpr int MAX_ENVS = 32;
constexpr int MAX_THREADS = 512;
constexpr int MIN_BLOCKS = 2;
constexpr int MAX_SEG = 32;
constexpr int MAX_CELLS = 64;

// seed: the step's int32 seed (read only when DRAW != DRAW_NONE); env0 the
// global index of environment 0 in the draw's counter (a rank's first
// environment when the batch is split over ranks; 0 otherwise).
// sf rows: 0 spawn_prob, 1 min_performance.
// act_i: K1's out_i.  obs_i rows: fresh agent_row, fresh agent_col, then K
// rows each of live exit_row, exit_col, exit_valid, fresh exit_row,
// exit_col, exit_valid, live exit_gcol, fresh exit_gcol, and the fresh
// levels' reset-time exit gate.
// out_i rows: 0 points, 1 perf_completed, 2 perf_possible, 3 can_exit1,
// 4 side-effect count.
// Geometry: envs (slab width E), slots (threads per environment), seg
// (cells a row segment), vector (16-byte path), staged (the slabs in
// shared memory, else streamed).
struct AdvanceArgs {
  const int32_t* seed;
  const int32_t* si;
  const float* sf;
  const int32_t* act_i;
  const int32_t* obs_i;
  const uint16_t *board, *goals, *init, *fresh_b, *fresh_g, *fresh_i;
  uint16_t *out_board, *out_goals, *out_init, *out_view;
  int32_t* out_i;
  int H, W, B, time_limit, vh, vw, K, remove_white_goals;
  int envs, slots, seg, vector, staged, env0;
};

// The view pixel of a final cell: its goal colour in bits 12-14, an add
// that wraps at 16 bits (ops/obs.py combine_board_goals).
__device__ __forceinline__ uint32_t view_pixel(int cell, int goal,
                                               int remove_white_goals) {
  int gcol = goal & COLORS;
  if (remove_white_goals && gcol == COLORS) gcol = 0;
  return static_cast<uint16_t>(cell + (gcol << 3));
}

// RuleB advances the board; RuleG the goal board (StaticRule: unchanged).
// STAGED: the slabs live in shared memory.  Otherwise (a board too large
// for a slab of 8 environments) the same code runs on the boards in device
// memory: the "slabs" are the input and output tensors from the block's
// first environment, with the environment stride B and 64-bit offsets;
// pass 1 writes the advanced boards out directly and pass 2 finds the exit
// cells by reading init again.
template <class RuleB, class RuleG, int DRAW, bool DO_RESET, bool EMIT_OBS,
          bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    advance_kernel(const AdvanceArgs a) {
  constexpr bool DYNAMIC = !std::is_same<RuleG, StaticRule>::value;
  using Off = typename std::conditional<STAGED, int, long long>::type;
  extern __shared__ __align__(16) uint16_t slab[];
  // Per environment: points, score, side effects, possible score.
  __shared__ int sums[4][MAX_ENVS];
  // Per environment: spawn threshold, ce1, view row and column start,
  // post-reset agent row and column.
  __shared__ int env_v[6][MAX_ENVS];
  __shared__ uint32_t done_bits;
  const int H = a.H, W = a.W, E = a.envs;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const long long BB = a.B;
  const long long b0 = static_cast<long long>(blockIdx.x) * E;
  const int lanes = static_cast<int>(min(BB - b0, 0LL + E));
  const int n = H * W;
  const int nE = n * E;
  const bool vec = STAGED && a.vector != 0;
  // Cell c of environment e lies at c * S + e from a slab's start.
  const Off S = STAGED ? static_cast<Off>(E) : static_cast<Off>(BB);
  const uint16_t* const s_board = STAGED ? slab : a.board + b0;
  const uint16_t* const s_goals = STAGED ? slab + nE : a.goals + b0;
  const uint16_t* const s_init = STAGED ? slab + 2 * nE : a.init + b0;
  uint16_t* const s_out = STAGED ? slab + 3 * nE : a.out_board + b0;
  // The final goal slab: the advanced goals, or the static goals as staged
  // (streamed: the goals output, written in pass 1 or the write-out).
  uint16_t* const s_outg = STAGED ? slab + (DYNAMIC ? 4 : 1) * nE
                                  : a.out_goals + b0;

  // ---- per environment: reset, spawn threshold, view origin ----------------
  bool done = false;
  if (t < E) {
    sums[0][t] = sums[1][t] = sums[2][t] = sums[3][t] = 0;
    if (t < lanes) {
      const long long b = b0 + t;
      if (DO_RESET) {
        done = a.si[7 * BB + b] + 1 > a.time_limit || a.si[4 * BB + b] != 0 ||
               a.act_i[3 * BB + b] != 0;
      }
      if (DRAW != DRAW_NONE) env_v[0][t] = spawn_threshold<DRAW>(a.sf[b]);
      if (EMIT_OBS) {
        // The view is of the post-reset boards around the post-reset agent.
        const int ar = done ? a.obs_i[0 * BB + b] : a.act_i[0 * BB + b];
        const int ac = done ? a.obs_i[1 * BB + b] : a.act_i[1 * BB + b];
        env_v[2][t] = floor_mod(ar - a.vh / 2, H);
        env_v[3][t] = floor_mod(ac - a.vw / 2, W);
        env_v[4][t] = ar;
        env_v[5][t] = ac;
      }
    }
  }
  if (DO_RESET && t < 32) {
    // The environments of the block are the lanes of warp 0.
    const unsigned bits =
        __ballot_sync(T >= 32 ? 0xFFFFFFFFu : (1u << T) - 1, done);
    if (t == 0) done_bits = bits;
  }

  // ---- stage the slabs ------------------------------------------------------
  if (STAGED) {
    stage(slab, a.board + b0, n, E, lanes, BB, vec);
    stage(slab + nE, a.goals + b0, n, E, lanes, BB, vec);
    stage(slab + 2 * nE, a.init + b0, n, E, lanes, BB, vec);
    cp_async_wait_all();
  }
  __syncthreads();

  // ---- pass 1: advance, scoring, side effects -------------------------------
  // Thread t takes row segments s, s + slots, ... of environment e; bit
  // (segment's rank * seg + column within it) of `exits` marks an exit.
  const int e = t % E, s = t / E;
  const bool live = e < lanes;
  const int L = a.seg;
  const int per_row = (W + L - 1) / L;
  const int items = H * per_row;
  uint64_t exits = 0;
  if (live) {
    constexpr int red_life = ALIVE | COLOR_R;
    for (int item = s, bit = 0; item < items; item += a.slots, bit += L) {
      const int r = item / per_row;
      const int c0 = (item - r * per_row) * L;
      const int c1 = min(c0 + L, W);
      // Two sums a register over the segment (fewer registers across the
      // loop): points * 2^16 + score, and effect + possible * 2^16.  A
      // segment has at most MAX_SEG cells, so |points| <= 5 * MAX_SEG and
      // |score|, effect, possible <= MAX_SEG never reach the other half.
      // For the same reason the spawn draw (rare: a dead cell beside a
      // spawner) reads its key, threshold and environment where it is
      // asked.
      int pts_score = 0, effect_poss = 0;
      SlabStream<RuleB, Off> sb(s_board, r, H, W, S, e, c0);
      SlabStream<RuleG, Off> sg(s_goals, r, H, W, S, e, c0);
      for (int c = c0; c < c1; ++c) {
        const uint32_t id = r * W + c;
        const Off o = static_cast<Off>(id) * S + e;
        const int cell = sb.advance(c, [&] {
          return spawn_draw<DRAW, 0>(a.seed[0], id,
                                     static_cast<uint32_t>(a.env0 + b0 + e),
                                     env_v[0][e]);
        });
        const int gv = sg.advance(c, [&] {
          return spawn_draw<DRAW, 1>(a.seed[0], id,
                                     static_cast<uint32_t>(a.env0 + b0 + e),
                                     env_v[0][e]);
        });
        const int iv = s_init[o];
        const int gc = (gv >> COLOR_BIT) & 7;
        if (DYNAMIC) effect_poss += (gc != 0 && gc != 7) << 16;
        if (cell & 1) {
          const int pts = pts_cell(gc, (cell >> COLOR_BIT) & 7);
          const bool counts =
              (cell & (FROZEN | PUSHABLE | PULLABLE)) != FROZEN;
          pts_score += pts * 65536 + (counts ? (pts > 0) - (pts < 0) : 0);
        }
        // The recoloured exit cells count as their initial value, so the
        // count does not wait for the exit gate.
        const int sb0 = iv & ~PLAYER;
        const int bb = (iv & EXIT) ? sb0 : (cell & ~PLAYER);
        const bool start_red = (sb0 & red_life) == red_life;
        const bool end_red = (bb & red_life) == red_life;
        const bool goal_cell = (gv & COLORS) == COLOR_B;
        const bool end_alive = (bb & red_life) == ALIVE;
        effect_poss +=
            !(bb == sb0 || (start_red && !end_red) || (goal_cell && end_alive));
        if (iv & EXIT) {
          if (STAGED) exits |= 1ull << (bit + c - c0);
        } else {
          s_out[o] = static_cast<uint16_t>(cell);
        }
        if (DYNAMIC) s_outg[o] = static_cast<uint16_t>(gv);
      }
      const int score = static_cast<int16_t>(pts_score & 0xFFFF);
      atomicAdd(&sums[0][e], (pts_score - score) >> 16);
      atomicAdd(&sums[1][e], score);
      atomicAdd(&sums[2][e], effect_poss & 0xFFFF);
      if (DYNAMIC) atomicAdd(&sums[3][e], effect_poss >> 16);
    }
  }
  __syncthreads();

  // ---- per environment: comp, poss, the exit gate ---------------------------
  if (t < lanes) {
    const long long b = b0 + t;
    const int points = sums[0][t];
    const int score = sums[1][t];
    const int effect = sums[2][t];
    const int baseline = a.si[6 * BB + b];
    const int comp = score - baseline;
    // Static goals: the live per-env value; dynamic goals: the possible
    // score of the advanced goal board.
    const int poss = DYNAMIC ? sums[3][t] - baseline : a.si[8 * BB + b];
    const float min_perf = a.sf[1 * BB + b];
    const bool ce1 = min_perf < 0.0f || static_cast<float>(comp) >=
                                            min_perf * static_cast<float>(poss);
    a.out_i[0 * BB + b] = points;
    a.out_i[1 * BB + b] = comp;
    a.out_i[2 * BB + b] = poss;
    a.out_i[3 * BB + b] = ce1;
    a.out_i[4 * BB + b] = effect;
    env_v[1][t] = ce1;
  }
  __syncthreads();

  // ---- pass 2: the exit cells, where the environment did not reset ----------
  const bool kept = live && !(DO_RESET && ((done_bits >> e) & 1));
  if (STAGED ? exits != 0 && kept : kept) {
    const uint16_t exit_cell =
        env_v[1][e] ? (LEVEL_EXIT | COLOR_R) : LEVEL_EXIT;
    const uint32_t seg_mask = L == 32 ? 0xFFFFFFFFu : (1u << L) - 1;
    for (int item = s, bit = 0; item < items; item += a.slots, bit += L) {
      const int r = item / per_row;
      const int c0 = (item - r * per_row) * L;
      if (STAGED) {
        // The cells pass 1 marked.
        uint32_t m = static_cast<uint32_t>(exits >> bit) & seg_mask;
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          s_out[static_cast<Off>(r * W + c0 + j) * S + e] = exit_cell;
        }
      } else {
        const int c1 = min(c0 + L, W);
        for (int c = c0; c < c1; ++c) {
          const Off o = static_cast<Off>(r * W + c) * S + e;
          if (s_init[o] & EXIT) s_out[o] = exit_cell;
        }
      }
    }
  }
  __syncthreads();

  // ---- write the boards out, the fresh levels blended in --------------------
  const uint32_t dbits = DO_RESET ? done_bits : 0;
  if (vec) {
    const int G = E >> 3, g = t % G, step = T / G;
    if (g * 8 < lanes) {
      const unsigned dm = (dbits >> (g * 8)) & 0xFF;
      const uint4 m = lane_mask(dm);
      const long long stride = step * BB;
      long long o = (t / G) * BB + b0 + g * 8;
      for (int cell = t / G; cell < n; cell += step, o += stride) {
        const int so = cell * E + g * 8;
        uint4 vb = load16(s_out + so), vg = load16(s_outg + so);
        if (DO_RESET && dm) {
          vb = blend(vb, ldg16(a.fresh_b + o), m);
          vg = blend(vg, ldg16(a.fresh_g + o), m);
          if (EMIT_OBS) {
            store16(s_out + so, vb);
            store16(s_outg + so, vg);
          }
        }
        store16(a.out_board + o, vb);
        store16(a.out_goals + o, vg);
        if (DO_RESET) {
          uint4 vi = load16(s_init + so);
          if (dm) vi = blend(vi, ldg16(a.fresh_i + o), m);
          store16(a.out_init + o, vi);
        }
      }
    }
  } else if (live) {
    // 2-byte accesses.  Streamed, pass 1 has written the advanced boards
    // out already: only the fresh levels and the static goals are left.
    const bool fresh = DO_RESET && ((dbits >> e) & 1);
    const long long stride = a.slots * BB;
    long long o = s * BB + b0 + e;
    for (int cell = s; cell < n; cell += a.slots, o += stride) {
      const Off so = static_cast<Off>(cell) * S + e;
      if (fresh) {
        const uint16_t vb = a.fresh_b[o], vg = a.fresh_g[o];
        a.out_board[o] = vb;
        a.out_goals[o] = vg;
        if (EMIT_OBS && STAGED) {
          s_out[so] = vb;
          s_outg[so] = vg;
        }
      } else if (STAGED) {
        a.out_board[o] = s_out[so];
        a.out_goals[o] = s_outg[so];
      } else if (!DYNAMIC) {
        a.out_goals[o] = s_goals[so];
      }
      if (DO_RESET) a.out_init[o] = fresh ? a.fresh_i[o] : s_init[so];
    }
  }

  if (EMIT_OBS) {
    // ---- the view, gathered from the final slabs ----------------------------
    __syncthreads();
    const int vh = a.vh, vw = a.vw, nv = vh * vw;
    const int rwg = a.remove_white_goals;
    if (vec) {
      const int G = E >> 3, g = t % G, step = T / G;
      if (g * 8 < lanes) {
        const long long stride = step * BB;
        uint16_t* out = a.out_view + (t / G) * BB + b0 + g * 8;
        for (int v = t / G; v < nv; v += step, out += stride) {
          const int i = v / vw, j = v - i * vw;
          const int ii = i % H, jj = j % W;
          // Two pixels a word, shifted in.
          uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
#pragma unroll 1
          for (int k = g * 8; k < g * 8 + 8; k += 2) {
            uint32_t word = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              int r = env_v[2][k + h] + ii;
              r -= r >= H ? H : 0;
              int c = env_v[3][k + h] + jj;
              c -= c >= W ? W : 0;
              const int so = (r * W + c) * E + k + h;
              word |= view_pixel(s_out[so], s_outg[so], rwg) << (16 * h);
            }
            w0 = w1;
            w1 = w2;
            w2 = w3;
            w3 = word;
          }
          store16(out, make_uint4(w0, w1, w2, w3));
        }
      }
    } else if (live) {
      const int rs = env_v[2][e], cs = env_v[3][e];
      const long long stride = a.slots * BB;
      uint16_t* out = a.out_view + s * BB + b0 + e;
      for (int v = s; v < nv; v += a.slots, out += stride) {
        const int i = v / vw, j = v - i * vw;
        int r = rs + i % H;
        r -= r >= H ? H : 0;
        int c = cs + j % W;
        c -= c >= W ? W : 0;
        const Off so = static_cast<Off>(r * W + c) * S + e;
        *out = static_cast<uint16_t>(view_pixel(s_out[so], s_outg[so], rwg));
      }
    }
    // This barrier orders the exit pixels after the view cells they cover.
    __syncthreads();
    // Exit pixels: the combined word of the final exit cell (LEVEL_EXIT,
    // red when the gate is open, and the goal color under the exit in bits
    // 12-14).  In row-major order the last exit wins.
    if (t < lanes) {
      const long long b = b0 + t;
      const int K = a.K;
      const bool fresh = (dbits >> t) & 1;
      const int gate = fresh ? a.obs_i[(2 + 8 * K) * BB + b] : env_v[1][t];
      const int sel = fresh ? 3 * K : 0;
      const int ar = env_v[4][t], ac = env_v[5][t];
      for (int k = 0; k < K; ++k) {
        const int er = a.obs_i[(2 + sel + k) * BB + b];
        const int ec = a.obs_i[(2 + K + sel + k) * BB + b];
        if (a.obs_i[(2 + 2 * K + sel + k) * BB + b] == 0) continue;
        uint32_t v;
        if (DYNAMIC) {
          const Off so = static_cast<Off>(er * W + ec) * S + t;
          v = view_pixel(s_out[so], s_outg[so], rwg);
        } else {
          int gc = a.obs_i[(2 + 6 * K + (fresh ? K : 0) + k) * BB + b];
          if (rwg && gc == 7) gc = 0;
          v = LEVEL_EXIT | (gate ? COLOR_R : 0) | (gc << (COLOR_BIT + 3));
        }
        int jy = floor_mod(er - ar + H / 2, H) - H / 2 + vh / 2;
        int jx = floor_mod(ec - ac + W / 2, W) - W / 2 + vw / 2;
        jy = min(max(jy, 0), vh - 1);
        jx = min(max(jx, 0), vw - 1);
        a.out_view[(jy * vw + jx) * BB + b] = static_cast<uint16_t>(v);
      }
    }
  }
}

template <class RuleB, class RuleG, int DRAW, bool DO_RESET, bool EMIT_OBS,
          bool STAGED>
int launch_advance(const AdvanceArgs& a, cudaStream_t stream) {
  constexpr bool DYNAMIC = !std::is_same<RuleG, StaticRule>::value;
  const int threads = a.envs * a.slots;
  if (a.slots < 1 || a.seg < 1 || a.seg > MAX_SEG) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int items = a.H * ((a.W + a.seg - 1) / a.seg);
  const int per_thread = (items + a.slots - 1) / a.slots;
  const bool fits =
      threads <= MAX_THREADS &&
      (STAGED ? a.envs % 8 == 0 && a.envs <= MAX_ENVS &&
                    per_thread * a.seg <= MAX_CELLS
              : a.envs == MAX_ENVS && !a.vector);
  if (!fits) return static_cast<int>(cudaErrorInvalidValue);
  // Board, goals, init and the advanced board; the advanced goals beside
  // them on dynamic goal rules.  The wrapper has checked that they fit.
  const int smem = STAGED ? (DYNAMIC ? 5 : 4) * a.H * a.W * a.envs *
                                static_cast<int>(sizeof(uint16_t))
                          : 0;
  auto kernel = advance_kernel<RuleB, RuleG, DRAW, DO_RESET, EMIT_OBS, STAGED>;
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

template <class RuleB, class RuleG, int DRAW, bool STAGED>
int launch_modes(const AdvanceArgs& a, cudaStream_t stream) {
  if (a.out_view != nullptr) {
    return launch_advance<RuleB, RuleG, DRAW, true, true, STAGED>(a, stream);
  }
  if (a.time_limit > 0) {
    return launch_advance<RuleB, RuleG, DRAW, true, false, STAGED>(a, stream);
  }
  return launch_advance<RuleB, RuleG, DRAW, false, false, STAGED>(a, stream);
}

template <class RuleB, class RuleG, int DRAW>
int launch_rule(const AdvanceArgs& a, cudaStream_t stream) {
  return a.staged ? launch_modes<RuleB, RuleG, DRAW, true>(a, stream)
                  : launch_modes<RuleB, RuleG, DRAW, false>(a, stream);
}

// The rules of ops/env_step_kernels.py RULES, in order.
enum Rule {
  RULE_STATIC_SPAWNLESS = 0,
  RULE_STATIC = 1,
  RULE_SIMPLE = 2,
  RULE_SPAWN_SIMPLE = 3,
  RULE_GENERAL = 4
};

template <int BLOCK>
int launch_action(const int32_t* si, const uint16_t* board,
                  uint16_t* out_board, int32_t* out_i, int H, int W, int B,
                  int vec, cudaStream_t stream) {
  constexpr int ENVS = action_envs(BLOCK);
  const dim3 grid((B + ENVS - 1) / ENVS);
  action_kernel<BLOCK><<<grid, BLOCK, 0, stream>>>(si, board, out_board, out_i,
                                                   H, W, B, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sl_action(const int32_t* si, const uint16_t* board,
                         uint16_t* out_board, int32_t* out_i, int H, int W,
                         int B, int vec, cudaStream_t stream) {
  return launch_action<128>(si, board, out_board, out_i, H, W, B, vec, stream);
}

// K1 at a block width of 64, 128, 256, 512 or 1024 threads.
extern "C" int sl_action_block(const int32_t* si, const uint16_t* board,
                               uint16_t* out_board, int32_t* out_i, int H,
                               int W, int B, int block, int vec,
                               cudaStream_t stream) {
  switch (block) {
    case 64:
      return launch_action<64>(si, board, out_board, out_i, H, W, B, vec,
                               stream);
    case 128:
      return launch_action<128>(si, board, out_board, out_i, H, W, B, vec,
                                stream);
    case 256:
      return launch_action<256>(si, board, out_board, out_i, H, W, B, vec,
                                stream);
    case 512:
      return launch_action<512>(si, board, out_board, out_i, H, W, B, vec,
                                stream);
    case 1024:
      return launch_action<1024>(si, board, out_board, out_i, H, W, B, vec,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int sl_advance(const int32_t* seed, const int32_t* si,
                          const float* sf, const int32_t* act_i,
                          const int32_t* obs_i, const uint16_t* board,
                          const uint16_t* goals, const uint16_t* init,
                          const uint16_t* fresh_b, const uint16_t* fresh_g,
                          const uint16_t* fresh_i, uint16_t* out_board,
                          uint16_t* out_goals, uint16_t* out_init,
                          uint16_t* out_view, int32_t* out_i, int H, int W,
                          int B, int time_limit, int vh, int vw, int K,
                          int remove_white_goals, int rule, int draw,
                          int envs, int slots, int seg, int vector,
                          int staged, int env0, cudaStream_t stream) {
  if (out_view != nullptr && time_limit <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((draw != DRAW_NONE) != (seed != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdvanceArgs a{seed,      si,        sf,        act_i,    obs_i,
                      board,     goals,     init,      fresh_b,  fresh_g,
                      fresh_i,   out_board, out_goals, out_init, out_view,
                      out_i,     H,         W,         B,        time_limit,
                      vh,        vw,        K,         remove_white_goals,
                      envs,      slots,     seg,       vector,   staged,
                      env0};
  using Spawnless = SpawnlessRule;
  using Full = FullRule<true>;
  if (rule == RULE_STATIC_SPAWNLESS && draw == DRAW_NONE) {
    return launch_rule<Spawnless, StaticRule, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_STATIC && draw == DRAW_U24) {
    return launch_rule<Full, StaticRule, DRAW_U24>(a, stream);
  }
  if (rule == RULE_SIMPLE && draw == DRAW_NONE) {
    return launch_rule<Spawnless, SimpleRule, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_SIMPLE && draw == DRAW_U24) {
    return launch_rule<Full, SimpleRule, DRAW_U24>(a, stream);
  }
  // Spawn-simple and general goal boards on a spawnless bank: neither
  // board holds a spawner, so both take the spawnless full rule.
  if ((rule == RULE_SPAWN_SIMPLE || rule == RULE_GENERAL) &&
      draw == DRAW_NONE) {
    return launch_rule<Spawnless, Spawnless, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_SPAWN_SIMPLE && draw == DRAW_PAIR) {
    return launch_rule<Full, FullRule<false>, DRAW_PAIR>(a, stream);
  }
  if (rule == RULE_GENERAL && draw == DRAW_PAIR) {
    return launch_rule<Full, Full, DRAW_PAIR>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
