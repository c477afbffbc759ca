"""Episode recording: trajectory npz capture and GIF rendering (port of
``safelife_tpu.metrics.recording``).

Capability parity with the reference's ``SafeLifeRecorder`` /
``RecordingSafeLifeWrapper`` (``env_wrappers.py:97-286``): capture the
board/goals/orientation at every step of an episode, save as npz, and
render to an animation.  In the batched world recording is a dedicated
rollout of a single environment (the training path never leaves the
device), run at checkpoint time with the current policy.
"""

import os

import numpy as np
import torch

from .. import bits16


def record_episode(env, bank, policy, generator=None, level_idx=0,
                   max_steps=1000):
    """Roll one episode of ``env`` (one environment, on the bank's device)
    from bank level ``level_idx`` with ``policy(obs, generator=None) ->
    actions`` (a recurrent one, with ``.recurrent`` and ``.init_carry``:
    ``policy(obs, carry, generator=None) -> (actions, carry)``) for
    ``max_steps`` steps, and capture the trajectory.  ``generator`` (a
    ``torch.Generator`` on the device) draws the policy's actions and the
    environment's spawns.  Returns a dict with stacked boards, goals and
    orientations, plus reward, length and level_idx, and each step's
    reward (``rewards``, float32).

    Each step writes its frame into one record preallocated on the device
    and nothing is read back inside the loop: the record comes to the host
    in one transfer at the end, and the frames after the first episode end
    are dropped there.
    """
    from ..env.wrappers import unwrap

    dev = bank.board.device
    recurrent = bool(getattr(policy, "recurrent", False))
    carry = policy.init_carry(1) if recurrent else None
    state = env.reset_to_levels(
        bank, torch.tensor([level_idx], dtype=torch.int32, device=dev))
    obs = env.observe(unwrap(state))
    h, w = unwrap(state).board.shape[:2]
    hw = h * w
    # A step's int32 record: board, goals, orientation, the reward's
    # float32 bits, done.
    rec = torch.empty((max_steps, 2 * hw + 3), dtype=torch.int32,
                      device=dev)
    for t in range(max_steps):
        core = unwrap(state)
        rec[t, :hw].copy_(bits16(core.board[..., 0]).reshape(-1))
        rec[t, hw:2 * hw].copy_(bits16(core.goals[..., 0]).reshape(-1))
        rec[t, 2 * hw:2 * hw + 1].copy_(core.orientation[:1])
        if recurrent:
            action, carry = policy(obs, carry, generator=generator)
        else:
            action = policy(obs, generator=generator)
        state, ts = env.step(state, bank, action, generator)
        rec[t, 2 * hw + 1:2 * hw + 2].copy_(ts.reward[:1].view(torch.int32))
        rec[t, 2 * hw + 2:].copy_(ts.done[:1])
        obs = ts.obs

    rec = rec.cpu().numpy()
    ends = np.flatnonzero(rec[:, 2 * hw + 2])
    steps = int(ends[0]) + 1 if len(ends) else max_steps
    rec = rec[:steps]
    rewards = np.ascontiguousarray(rec[:, 2 * hw + 1]).view(np.float32)
    return {
        "board": rec[:, :hw].astype(np.uint16).reshape(steps, h, w),
        "goals": rec[:, hw:2 * hw].astype(np.uint16).reshape(steps, h, w),
        "orientation": rec[:, 2 * hw],
        "reward": float(rewards.sum()),
        "rewards": rewards,
        "length": steps,
        "level_idx": level_idx,
    }


def save_trajectory(traj, base_path, render=True):
    """Save a recorded trajectory as npz (+ gif when render=True).
    Returns the list of files written."""
    os.makedirs(os.path.dirname(os.path.abspath(base_path)), exist_ok=True)
    npz_path = base_path + ".npz"
    np.savez_compressed(
        npz_path, board=traj["board"], goals=traj["goals"],
        orientation=traj["orientation"])
    written = [npz_path]
    if render:
        from ..render.graphics import render_file
        written.append(render_file(npz_path))
    return written
