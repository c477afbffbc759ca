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
// Bound: bytes.
//   K1 reads the board and writes a new one: 4 bytes per cell (177 MB at
//      B = 65536 on 26x26 boards, 0.053 ms at 3.35 TB/s).
//   K2 reads 3 boards and writes 3 (12 bytes per cell), plus the 3 fresh
//      boards of the environments that reset and the 2-byte view cells
//      (about 0.17 ms at B = 65536), under every rule: dynamic goals cost
//      operations (a second stencil, a Philox draw beside spawners), not
//      bytes.  K3 reads 3 boards and writes 2.
//
// Design.
//   K1: one thread per (environment, row).  Every thread decodes its
//   environment's action from the four neighbourhood cells (the reads hit
//   L2 after the first row), then copies its row with the at most four
//   changed cells patched in, applied in the TPU kernel's order p3, p1,
//   p2, p0.  The output never aliases the input.
//   K2/K3: four threads per environment, each taking every fourth row, in
//   blocks of 32 environments x 4 row groups (a warp reads one cell of 32
//   neighbouring environments).  Pass 1 advances the board, and on dynamic
//   goals the goal board in a second stream beside it, into the outputs
//   while summing points, score, the side-effect count and (dynamic goals)
//   the possible score over the advanced goals; a resetting environment
//   writes its fresh boards instead (read only there).  With a view, pass 1
//   also drops each final cell into the block's view tile in shared memory
//   at view[(r - rs) mod H][(c - cs) mod W] (a torus crop: every view cell
//   has one source cell), so the boards are never gathered back.  The four
//   partial sums meet in shared memory; then comp, poss and the exit gate
//   ce1.  Pass 2 recolours the exit cells of the environments that did not
//   reset (and their view cells).  Last, the exit pixels go into the tile:
//   on static goals built from per-environment values, on dynamic goals
//   read back from the block's own final boards after a barrier.  The tile
//   is written out coalesced.  Template flags give K2 and K3 and every rule
//   from one source.
#include <cuda_runtime.h>

#include <type_traits>

#include "philox.cuh"
#include "safelife_rule.cuh"

namespace {

using namespace safelife;

__device__ __forceinline__ int select_by_orient(int o, int t0, int t1, int t2,
                                                int t3) {
  int out = t0;
  out = o == 1 ? t1 : out;
  out = o == 2 ? t2 : out;
  return o == 3 ? t3 : out;
}

// si rows: 0 action, 1 agent_row, 2 agent_col, 3 orientation, 4 game_over,
// 5 can_exit0, 6 baseline_score, 7 episode_length, 8 perf_possible.
// out_i rows: 0 agent_row', 1 agent_col', 2 orientation', 3 exited.
// BLOCK threads per block: 128 on the main path (sl_action); the other
// widths are the block sweep of scripts/ablock_bench.py (sl_action_block).
template <int BLOCK>
__global__ void __launch_bounds__(BLOCK)
    action_kernel(const int32_t* __restrict__ si,
                  const uint16_t* __restrict__ board,
                  uint16_t* __restrict__ out, int32_t* __restrict__ out_i,
                  int H, int W, int B) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const int r = blockIdx.y;
  const int action = si[0 * B + b];
  const int r0 = si[1 * B + b];
  const int c0 = si[2 * B + b];
  const int game_over = si[4 * B + b];
  const int can_exit0 = si[5 * B + b];

  const bool is_move = action >= 1 && action <= 4 && game_over == 0;
  const bool is_toggle = action >= 5 && action <= 8 && game_over == 0;
  const int orient =
      (is_move || is_toggle) ? floor_mod(action - 1, 4) : si[3 * B + b];
  const int dr = select_by_orient(orient, -1, 0, 1, 0);
  const int dc = select_by_orient(orient, 0, 1, 0, -1);
  const int i0 = r0 * W + c0;
  const int i1 = floor_mod(r0 + dr, H) * W + floor_mod(c0 + dc, W);
  const int i2 = floor_mod(r0 - dr, H) * W + floor_mod(c0 - dc, W);
  const int i3 = floor_mod(r0 + 2 * dr, H) * W + floor_mod(c0 + 2 * dc, W);
  const int v0 = board[i0 * static_cast<long long>(B) + b];
  const int v1 = board[i1 * static_cast<long long>(B) + b];
  const int v2 = board[i2 * static_cast<long long>(B) + b];
  const int v3 = board[i3 * static_cast<long long>(B) + b];

  const bool front_empty = v1 == 0;
  const bool front_exit = !front_empty && (v1 & EXIT) && can_exit0 != 0;
  const bool pushable = !front_empty && !front_exit && (v1 & PUSHABLE);
  const bool push_to_empty = pushable && v3 == 0;
  const bool push_out_exit = pushable && v3 != 0 && (v3 & EXIT);
  const bool moved = is_move && (front_empty || push_to_empty || push_out_exit);
  const bool exited = is_move && front_exit;
  const bool pulled = moved && (v2 & PULLABLE);
  const bool tgl_create = is_toggle && v1 == 0;
  const bool tgl_destroy = is_toggle && v1 != 0 && (v1 & DESTRUCTIBLE);

  const bool set3 = is_move && push_to_empty;
  const bool set1 = moved || tgl_create || tgl_destroy;
  const int p1 = moved ? v0 : (tgl_create ? (LIFE | (v0 & COLORS)) : 0);
  const int p0 = pulled ? v2 : 0;

  if (r == 0) {
    out_i[0 * B + b] = moved ? i1 / W : r0;
    out_i[1 * B + b] = moved ? i1 % W : c0;
    out_i[2 * B + b] = orient;
    out_i[3 * B + b] = exited;
  }
  for (int c = 0; c < W; ++c) {
    const int i = r * W + c;
    const long long o = i * static_cast<long long>(B) + b;
    int v = board[o];
    if (set3 && i == i3) v = v1;
    if (set1 && i == i1) v = p1;
    if (pulled && i == i2) v = 0;
    if (moved && i == i0) v = p0;
    out[o] = static_cast<uint16_t>(v);
  }
}

// Environments per block of K2/K3 (one warp's width) and threads per
// environment, each taking every GROUPS-th row.
constexpr int ENVS = 32;
constexpr int GROUPS = 4;

// seed: the step's int32 seed (read only when DRAW != DRAW_NONE).
// sf rows: 0 spawn_prob, 1 min_performance.
// act_i: K1's out_i.  obs_i rows: fresh agent_row, fresh agent_col, then K
// rows each of live exit_row, exit_col, exit_valid, fresh exit_row,
// exit_col, exit_valid, live exit_gcol, fresh exit_gcol, and the fresh
// levels' reset-time exit gate.
// out_i rows: 0 points, 1 perf_completed, 2 perf_possible, 3 can_exit1,
// 4 side-effect count.
// RuleB advances the board; RuleG the goal board (StaticRule: unchanged).
// With EMIT_OBS the block's views are assembled in dynamic shared memory,
// (vh * vw, ENVS) uint16, and written out coalesced at the end.
template <class RuleB, class RuleG, int DRAW, bool DO_RESET, bool EMIT_OBS>
__global__ void __launch_bounds__(ENVS * GROUPS) advance_kernel(
    const int32_t* __restrict__ seed, const int32_t* __restrict__ si,
    const float* __restrict__ sf, const int32_t* __restrict__ act_i,
    const int32_t* __restrict__ obs_i, const uint16_t* __restrict__ board,
    const uint16_t* __restrict__ goals, const uint16_t* __restrict__ init,
    const uint16_t* __restrict__ fresh_b, const uint16_t* __restrict__ fresh_g,
    const uint16_t* __restrict__ fresh_i, uint16_t* __restrict__ out_board,
    uint16_t* __restrict__ out_goals, uint16_t* __restrict__ out_init,
    uint16_t* __restrict__ out_view, int32_t* __restrict__ out_i, int H, int W,
    int B, int time_limit, int vh, int vw, int K, int remove_white_goals) {
  constexpr bool DYNAMIC = !std::is_same<RuleG, StaticRule>::value;
  extern __shared__ uint16_t view_s[];
  __shared__ int partial[4][GROUPS][ENVS];
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const long long BB = B;
  const long long b = static_cast<long long>(blockIdx.x) * ENVS + lane;
  // Threads past the batch edge skip the work but keep to the barriers.
  const bool live = b < B;

  bool done = false;
  if (DO_RESET && live) {
    const bool game_over = si[4 * BB + b] != 0 || act_i[3 * BB + b] != 0;
    done = si[7 * BB + b] + 1 > time_limit || game_over;
  }
  // The view is of the post-reset boards around the post-reset agent.
  int ar = 0, ac = 0, rs = 0, cs = 0;
  if (EMIT_OBS && live) {
    ar = done ? obs_i[0 * BB + b] : act_i[0 * BB + b];
    ac = done ? obs_i[1 * BB + b] : act_i[1 * BB + b];
    rs = floor_mod(ar - vh / 2, H);
    cs = floor_mod(ac - vw / 2, W);
  }
  // Cell (r, c) appears at view[i][j] for i = (r - rs) mod H + k H < vh and
  // j = (c - cs) mod W + l W < vw: every view cell has one source cell.
  auto put_view = [&](int r, int c, int cell, int goal) {
    int gcol = goal & COLORS;
    if (remove_white_goals && gcol == COLORS) gcol = 0;
    const uint16_t v = static_cast<uint16_t>(cell + (gcol << 3));
    for (int i = floor_mod(r - rs, H); i < vh; i += H) {
      for (int j = c >= cs ? c - cs : c - cs + W; j < vw; j += W) {
        view_s[(i * vw + j) * ENVS + lane] = v;
      }
    }
  };

  // ---- pass 1: advance, scoring, side effects, fold, view ------------------
  const uint32_t key = (DRAW != DRAW_NONE && live) ? seed[0] : 0;
  const int thresh =
      (DRAW != DRAW_NONE && live) ? spawn_threshold<DRAW>(sf[b]) : 0;
  const uint32_t env = static_cast<uint32_t>(b);
  int points = 0, score = 0, effect = 0, possible = 0;
  constexpr int red_life = ALIVE | COLOR_R;
  for (int r = g; live && r < H; r += GROUPS) {
    RowStream<RuleB> sb(board, r, H, W, BB, b);
    RowStream<RuleG> sg(goals, r, H, W, BB, b);
    for (int c = 0; c < W; ++c) {
      const long long o = (static_cast<long long>(r) * W + c) * BB + b;
      const uint32_t id = r * W + c;
      const int cell = sb.advance(
          c, [&] { return spawn_draw<DRAW, 0>(key, id, env, thresh); });
      const int gv = sg.advance(
          c, [&] { return spawn_draw<DRAW, 1>(key, id, env, thresh); });
      const int iv = init[o];
      const int gc = (gv >> COLOR_BIT) & 7;
      if (DYNAMIC) possible += gc != 0 && gc != 7;
      if (cell & 1) {
        const int pts = pts_cell(gc, (cell >> COLOR_BIT) & 7);
        points += pts;
        if ((cell & (FROZEN | PUSHABLE | PULLABLE)) != FROZEN) {
          score += (pts > 0) - (pts < 0);
        }
      }
      // The recoloured exit cells count as their initial value, so the
      // count does not wait for the exit gate.
      const int sb0 = iv & ~PLAYER;
      const int bb = (iv & EXIT) ? sb0 : (cell & ~PLAYER);
      const bool start_red = (sb0 & red_life) == red_life;
      const bool end_red = (bb & red_life) == red_life;
      const bool goal_cell = (gv & COLORS) == COLOR_B;
      const bool end_alive = (bb & red_life) == ALIVE;
      effect +=
          !(bb == sb0 || (start_red && !end_red) || (goal_cell && end_alive));
      if (DO_RESET && done) {
        const int fb = fresh_b[o], fg = fresh_g[o];
        out_board[o] = static_cast<uint16_t>(fb);
        out_goals[o] = static_cast<uint16_t>(fg);
        out_init[o] = fresh_i[o];
        if (EMIT_OBS) put_view(r, c, fb, fg);
      } else {
        out_board[o] = static_cast<uint16_t>(cell);
        out_goals[o] = static_cast<uint16_t>(gv);
        if (DO_RESET) out_init[o] = static_cast<uint16_t>(iv);
        if (EMIT_OBS) put_view(r, c, cell, gv);
      }
    }
  }
  partial[0][g][lane] = points;
  partial[1][g][lane] = score;
  partial[2][g][lane] = effect;
  partial[3][g][lane] = possible;
  __syncthreads();
  points = score = effect = possible = 0;
  for (int k = 0; k < GROUPS; ++k) {
    points += partial[0][k][lane];
    score += partial[1][k][lane];
    effect += partial[2][k][lane];
    possible += partial[3][k][lane];
  }
  bool ce1 = false;
  if (live) {
    const int baseline = si[6 * BB + b];
    const int comp = score - baseline;
    // Static goals: the live per-env value; dynamic goals: the possible
    // score of the advanced goal board.
    const int poss = DYNAMIC ? possible - baseline : si[8 * BB + b];
    const float min_perf = sf[1 * BB + b];
    ce1 = min_perf < 0.0f ||
          static_cast<float>(comp) >= min_perf * static_cast<float>(poss);
    if (g == 0) {
      out_i[0 * BB + b] = points;
      out_i[1 * BB + b] = comp;
      out_i[2 * BB + b] = poss;
      out_i[3 * BB + b] = ce1;
      out_i[4 * BB + b] = effect;
    }
  }

  // ---- pass 2: exit recolour -----------------------------------------------
  if (live && !(DO_RESET && done)) {
    const int exit_cell = ce1 ? (LEVEL_EXIT | COLOR_R) : LEVEL_EXIT;
    for (int r = g; r < H; r += GROUPS) {
      for (int c = 0; c < W; ++c) {
        const long long o = (static_cast<long long>(r) * W + c) * BB + b;
        if (init[o] & EXIT) {
          out_board[o] = static_cast<uint16_t>(exit_cell);
          // This thread wrote out_goals[o] in pass 1.
          if (EMIT_OBS) put_view(r, c, exit_cell, out_goals[o]);
        }
      }
    }
  }

  if (EMIT_OBS) {
    // After this barrier the block's final boards are visible to all its
    // threads, so dynamic goals read the exit pixels back from them.
    __syncthreads();
    // Exit pixels: the combined word of the final exit cell (LEVEL_EXIT,
    // red when the gate is open, and the goal color under the exit in bits
    // 12-14).  In row-major order the last exit wins.
    if (live && g == 0) {
      const int gate = done ? obs_i[(2 + 8 * K) * BB + b] : ce1;
      const int sel = done ? 3 * K : 0;
      for (int k = 0; k < K; ++k) {
        const int er = obs_i[(2 + sel + k) * BB + b];
        const int ec = obs_i[(2 + K + sel + k) * BB + b];
        if (obs_i[(2 + 2 * K + sel + k) * BB + b] == 0) continue;
        int v;
        if (DYNAMIC) {
          const long long oe = (static_cast<long long>(er) * W + ec) * BB + b;
          int gcol = out_goals[oe] & COLORS;
          if (remove_white_goals && gcol == COLORS) gcol = 0;
          v = out_board[oe] + (gcol << 3);
        } else {
          int gc = obs_i[(2 + 6 * K + (done ? K : 0) + k) * BB + b];
          if (remove_white_goals && gc == 7) gc = 0;
          v = LEVEL_EXIT | (gate ? COLOR_R : 0) | (gc << (COLOR_BIT + 3));
        }
        int jy = floor_mod(er - ar + H / 2, H) - H / 2 + vh / 2;
        int jx = floor_mod(ec - ac + W / 2, W) - W / 2 + vw / 2;
        jy = min(max(jy, 0), vh - 1);
        jx = min(max(jx, 0), vw - 1);
        view_s[(jy * vw + jx) * ENVS + lane] = static_cast<uint16_t>(v);
      }
    }
    __syncthreads();
    // Coalesced write-out: each warp stores one view cell of 32 envs.
    const long long b0 = static_cast<long long>(blockIdx.x) * ENVS;
    for (int i = g * ENVS + lane; i < vh * vw * ENVS; i += GROUPS * ENVS) {
      const int cell = i / ENVS, l = i % ENVS;
      if (b0 + l < B) out_view[cell * BB + b0 + l] = view_s[i];
    }
  }
}

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
};

template <class RuleB, class RuleG, int DRAW, bool DO_RESET, bool EMIT_OBS>
int launch_advance(const AdvanceArgs& a, cudaStream_t stream) {
  const dim3 grid((a.B + ENVS - 1) / ENVS);
  const dim3 block(ENVS, GROUPS);
  const int smem =
      EMIT_OBS ? a.vh * a.vw * ENVS * static_cast<int>(sizeof(uint16_t)) : 0;
  auto kernel = advance_kernel<RuleB, RuleG, DRAW, DO_RESET, EMIT_OBS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, smem, stream>>>(
      a.seed, a.si, a.sf, a.act_i, a.obs_i, a.board, a.goals, a.init,
      a.fresh_b, a.fresh_g, a.fresh_i, a.out_board, a.out_goals, a.out_init,
      a.out_view, a.out_i, a.H, a.W, a.B, a.time_limit, a.vh, a.vw, a.K,
      a.remove_white_goals);
  return static_cast<int>(cudaGetLastError());
}

template <class RuleB, class RuleG, int DRAW>
int launch_modes(const AdvanceArgs& a, cudaStream_t stream) {
  if (a.out_view != nullptr) {
    return launch_advance<RuleB, RuleG, DRAW, true, true>(a, stream);
  }
  if (a.time_limit > 0) {
    return launch_advance<RuleB, RuleG, DRAW, true, false>(a, stream);
  }
  return launch_advance<RuleB, RuleG, DRAW, false, false>(a, stream);
}

// The rules of ops/env_step_kernels.py RULES, in order.
enum Rule {
  RULE_STATIC_SPAWNLESS = 0,
  RULE_STATIC = 1,
  RULE_SIMPLE = 2,
  RULE_SPAWN_SIMPLE = 3,
  RULE_GENERAL = 4
};

}  // namespace

extern "C" int sl_action(const int32_t* si, const uint16_t* board,
                         uint16_t* out_board, int32_t* out_i, int H, int W,
                         int B, cudaStream_t stream) {
  const dim3 grid((B + 127) / 128, H);
  action_kernel<128>
      <<<grid, 128, 0, stream>>>(si, board, out_board, out_i, H, W, B);
  return static_cast<int>(cudaGetLastError());
}

// K1 at a block width of 64, 128, 256, 512 or 1024 threads.
extern "C" int sl_action_block(const int32_t* si, const uint16_t* board,
                               uint16_t* out_board, int32_t* out_i, int H,
                               int W, int B, int block, cudaStream_t stream) {
  const dim3 grid((B + block - 1) / block, H);
  switch (block) {
    case 64:
      action_kernel<64><<<grid, 64, 0, stream>>>(si, board, out_board, out_i,
                                                 H, W, B);
      break;
    case 128:
      action_kernel<128><<<grid, 128, 0, stream>>>(si, board, out_board,
                                                   out_i, H, W, B);
      break;
    case 256:
      action_kernel<256><<<grid, 256, 0, stream>>>(si, board, out_board,
                                                   out_i, H, W, B);
      break;
    case 512:
      action_kernel<512><<<grid, 512, 0, stream>>>(si, board, out_board,
                                                   out_i, H, W, B);
      break;
    case 1024:
      action_kernel<1024><<<grid, 1024, 0, stream>>>(si, board, out_board,
                                                     out_i, H, W, B);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
                          cudaStream_t stream) {
  if (out_view != nullptr && time_limit <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((draw != DRAW_NONE) != (seed != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdvanceArgs a{seed,      si,       sf,         act_i,    obs_i,
                      board,     goals,    init,       fresh_b,  fresh_g,
                      fresh_i,   out_board, out_goals, out_init, out_view,
                      out_i,     H,        W,          B,        time_limit,
                      vh,        vw,       K,          remove_white_goals};
  using Spawnless = SpawnlessRule;
  using Full = FullRule<true>;
  if (rule == RULE_STATIC_SPAWNLESS && draw == DRAW_NONE) {
    return launch_modes<Spawnless, StaticRule, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_STATIC && draw == DRAW_U24) {
    return launch_modes<Full, StaticRule, DRAW_U24>(a, stream);
  }
  if (rule == RULE_SIMPLE && draw == DRAW_NONE) {
    return launch_modes<Spawnless, SimpleRule, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_SIMPLE && draw == DRAW_U24) {
    return launch_modes<Full, SimpleRule, DRAW_U24>(a, stream);
  }
  // Spawn-simple and general goal boards on a spawnless bank: neither
  // board holds a spawner, so both take the spawnless full rule.
  if ((rule == RULE_SPAWN_SIMPLE || rule == RULE_GENERAL) &&
      draw == DRAW_NONE) {
    return launch_modes<Spawnless, Spawnless, DRAW_NONE>(a, stream);
  }
  if (rule == RULE_SPAWN_SIMPLE && draw == DRAW_PAIR) {
    return launch_modes<Full, FullRule<false>, DRAW_PAIR>(a, stream);
  }
  if (rule == RULE_GENERAL && draw == DRAW_PAIR) {
    return launch_modes<Full, Full, DRAW_PAIR>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
