// The environment step core on (H, W, B) uint16 boards: K1 (action) and
// K2/K3 (advance, scoring, exit recolour, side-effect count, and for K2 the
// auto-reset fold and the packed agent-centred view).
//
// Replaces the TPU kernels of safelife_tpu/ops/env_step_pallas.py:
//   K1  _action_kernel (with _apply_action), launched by fused_step;
//   K2  _advance_kernel with time_limit > 0 (fold, optional view);
//   K3  _advance_kernel with time_limit == 0 (no fold, no view).
// Only the CA rule of banks with static goals and no spawners
// (life_pallas._advance_spawnless) is compiled in.
//
// Bound: bytes.
//   K1 reads the board and writes a new one: 4 bytes per cell (177 MB at
//      B = 65536 on 26x26 boards, 0.053 ms at 3.35 TB/s).
//   K2 reads 3 boards and writes 3 (12 bytes per cell), plus the 3 fresh
//      boards of the environments that reset and the 2-byte view cells
//      (about 0.17 ms at B = 65536).  K3 reads 3 boards and writes 2.
//
// Design.
//   K1: one thread per (environment, row).  Every thread decodes its
//   environment's action from the four neighbourhood cells (the reads hit
//   L2 after the first row), then copies its row with the at most four
//   changed cells patched in, applied in the TPU kernel's order p3, p1,
//   p2, p0.  The output never aliases the input.
//   K2/K3: four threads per environment, each taking every fourth row, in
//   blocks of 32 environments x 4 row groups (a warp reads one cell of 32
//   neighbouring environments).  Pass 1 advances the board into the
//   output while summing points, score and the side-effect count; a
//   resetting environment writes its fresh boards instead (read only
//   there).  With a view, pass 1 also drops each final cell into the
//   block's view tile in shared memory at view[(r - rs) mod H][(c - cs)
//   mod W] (a torus crop: every view cell has one source cell), so the
//   boards are never gathered back.  The four partial sums meet in shared
//   memory; then comp, poss and the exit gate ce1.  Pass 2 recolours the
//   exit cells of the environments that did not reset (and their view
//   cells).  Last, the exit pixels, built from per-environment values, go
//   into the tile, and the tile is written out coalesced.  The template
//   flags DO_RESET and EMIT_OBS give K2 and K3 from one source.
#include <cuda_runtime.h>

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
__global__ void __launch_bounds__(128)
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

// sf rows: 0 spawn_prob (unused by the spawnless rule), 1 min_performance.
// act_i: K1's out_i.  obs_i rows: fresh agent_row, fresh agent_col, then K
// rows each of live exit_row, exit_col, exit_valid, fresh exit_row,
// exit_col, exit_valid, live exit_gcol, fresh exit_gcol, and the fresh
// levels' reset-time exit gate.
// out_i rows: 0 points, 1 perf_completed, 2 perf_possible, 3 can_exit1,
// 4 side-effect count.
// With EMIT_OBS the block's views are assembled in dynamic shared memory,
// (vh * vw, ENVS) uint16, and written out coalesced at the end.
template <bool DO_RESET, bool EMIT_OBS>
__global__ void __launch_bounds__(ENVS * GROUPS) advance_kernel(
    const int32_t* __restrict__ si, const float* __restrict__ sf,
    const int32_t* __restrict__ act_i, const int32_t* __restrict__ obs_i,
    const uint16_t* __restrict__ board, const uint16_t* __restrict__ goals,
    const uint16_t* __restrict__ init, const uint16_t* __restrict__ fresh_b,
    const uint16_t* __restrict__ fresh_g, const uint16_t* __restrict__ fresh_i,
    uint16_t* __restrict__ out_board, uint16_t* __restrict__ out_goals,
    uint16_t* __restrict__ out_init, uint16_t* __restrict__ out_view,
    int32_t* __restrict__ out_i, int H, int W, int B, int time_limit, int vh,
    int vw, int K, int remove_white_goals) {
  extern __shared__ uint16_t view_s[];
  __shared__ int partial[3][GROUPS][ENVS];
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
  int points = 0, score = 0, effect = 0;
  constexpr int red_life = ALIVE | COLOR_R;
  for (int r = g; live && r < H; r += GROUPS) {
    advance_row_spawnless(board, r, H, W, BB, b, [&](int c, int cell) {
      const long long o = (static_cast<long long>(r) * W + c) * BB + b;
      const int gv = goals[o];
      const int iv = init[o];
      if (cell & 1) {
        const int pts = pts_cell((gv >> COLOR_BIT) & 7, (cell >> COLOR_BIT) & 7);
        points += pts;
        if ((cell & (FROZEN | PUSHABLE | PULLABLE)) != FROZEN) {
          score += (pts > 0) - (pts < 0);
        }
      }
      // The recoloured exit cells count as their initial value, so the
      // count does not wait for the exit gate.
      const int sb = iv & ~PLAYER;
      const int bb = (iv & EXIT) ? sb : (cell & ~PLAYER);
      const bool start_red = (sb & red_life) == red_life;
      const bool end_red = (bb & red_life) == red_life;
      const bool goal_cell = (gv & COLORS) == COLOR_B;
      const bool end_alive = (bb & red_life) == ALIVE;
      effect += !(bb == sb || (start_red && !end_red) || (goal_cell && end_alive));
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
    });
  }
  partial[0][g][lane] = points;
  partial[1][g][lane] = score;
  partial[2][g][lane] = effect;
  __syncthreads();
  points = score = effect = 0;
  for (int k = 0; k < GROUPS; ++k) {
    points += partial[0][k][lane];
    score += partial[1][k][lane];
    effect += partial[2][k][lane];
  }
  bool ce1 = false;
  if (live) {
    const int comp = score - si[6 * BB + b];
    const int poss = si[8 * BB + b];
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
          if (EMIT_OBS) put_view(r, c, exit_cell, goals[o]);
        }
      }
    }
  }

  if (EMIT_OBS) {
    __syncthreads();
    // Exit pixels: LEVEL_EXIT, red when the gate is open, and the goal
    // color under the exit in bits 12-14.  In row-major order the last
    // exit wins.
    if (live && g == 0) {
      const int gate = done ? obs_i[(2 + 8 * K) * BB + b] : ce1;
      const int sel = done ? 3 * K : 0;
      for (int k = 0; k < K; ++k) {
        const int er = obs_i[(2 + sel + k) * BB + b];
        const int ec = obs_i[(2 + K + sel + k) * BB + b];
        if (obs_i[(2 + 2 * K + sel + k) * BB + b] == 0) continue;
        int gc = obs_i[(2 + 6 * K + (done ? K : 0) + k) * BB + b];
        if (remove_white_goals && gc == 7) gc = 0;
        int jy = floor_mod(er - ar + H / 2, H) - H / 2 + vh / 2;
        int jx = floor_mod(ec - ac + W / 2, W) - W / 2 + vw / 2;
        jy = min(max(jy, 0), vh - 1);
        jx = min(max(jx, 0), vw - 1);
        view_s[(jy * vw + jx) * ENVS + lane] = static_cast<uint16_t>(
            LEVEL_EXIT | (gate ? COLOR_R : 0) | (gc << (COLOR_BIT + 3)));
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

}  // namespace

extern "C" int sl_action(const int32_t* si, const uint16_t* board,
                         uint16_t* out_board, int32_t* out_i, int H, int W,
                         int B, cudaStream_t stream) {
  const dim3 grid((B + 127) / 128, H);
  action_kernel<<<grid, 128, 0, stream>>>(si, board, out_board, out_i, H, W, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sl_advance(const int32_t* si, const float* sf,
                          const int32_t* act_i, const int32_t* obs_i,
                          const uint16_t* board, const uint16_t* goals,
                          const uint16_t* init, const uint16_t* fresh_b,
                          const uint16_t* fresh_g, const uint16_t* fresh_i,
                          uint16_t* out_board, uint16_t* out_goals,
                          uint16_t* out_init, uint16_t* out_view,
                          int32_t* out_i, int H, int W, int B, int time_limit,
                          int vh, int vw, int K, int remove_white_goals,
                          cudaStream_t stream) {
  const dim3 grid((B + ENVS - 1) / ENVS);
  const dim3 block(ENVS, GROUPS);
  const bool do_reset = time_limit > 0;
  const bool emit_obs = out_view != nullptr;
  if (emit_obs && !do_reset) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = emit_obs ? vh * vw * ENVS * static_cast<int>(sizeof(uint16_t)) : 0;
#define SL_ADVANCE(R, O)                                                      \
  do {                                                                        \
    if (smem > 48 * 1024) {                                                   \
      const cudaError_t err = cudaFuncSetAttribute(                           \
          advance_kernel<R, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
          smem);                                                              \
      if (err != cudaSuccess) return static_cast<int>(err);                   \
    }                                                                         \
    advance_kernel<R, O><<<grid, block, smem, stream>>>(                      \
        si, sf, act_i, obs_i, board, goals, init, fresh_b, fresh_g, fresh_i,  \
        out_board, out_goals, out_init, out_view, out_i, H, W, B, time_limit, \
        vh, vw, K, remove_white_goals);                                       \
  } while (0)
  if (emit_obs) {
    SL_ADVANCE(true, true);
  } else if (do_reset) {
    SL_ADVANCE(true, false);
  } else {
    SL_ADVANCE(false, false);
  }
#undef SL_ADVANCE
  return static_cast<int>(cudaGetLastError());
}
