"""The reference's run beside the program's first batches, for a learner
and a net that the caller brings: ``replay.train``'s loop, with the
rollout's logits kept.

The new training cells use it: the GTrXL cell (its net keeps a memory as
its carry) and the four-rank cell (its learner draws each data shard's
minibatch rows as the program's ranks do).
"""

import torch

from . import env as E
from . import learner as L
from .replay import REWARD_TOL, _half


def train(config, traffic, levels_path, rec, device, learner,
          carry=None, reset=None, precision="f32", fault=None):
    """Follow the program's batches recorded in ``rec`` (as
    ``replay.train`` takes it) with ``learner`` (a ``learner.Learner``,
    its ``net`` the configuration's).  ``carry``: the net's first carry
    (None: a feed-forward net); ``reset(carry, done)`` resets it after a
    step.  ``fault="half_batch"``: a learner that leaves every other
    environment out.  Returns ``replay.train``'s dict and ``logits``: each
    batch's (T + 1, B, A) logits, the last the bootstrap step's."""
    ppo = config["ppo"]
    lv = E.levels_on(E.load_levels(levels_path), device)
    env = E.TrainingEnv(lv, tuple(config["view_shape"]),
                        traffic["time_limit"],
                        penalty=traffic["impact_penalty"])
    view = tuple(config["view_shape"])
    s = env.reset(rec["init_idx"])
    obs = E.observe(s, view, config["channels"])
    bad = int((E.digest(obs) != rec["init_digest"]).sum())
    net = learner.net
    out = dict(batches=[], logits=[])
    for b, br in enumerate(rec["batches"]):
        carry0 = carry
        keep = dict(obs=[], action=[], old_pi=[], reward=[], done=[],
                    value=[], logits=[])
        for st in br["steps"]:
            with torch.no_grad(), L.precision_mode(precision):
                (logits, value), nxt = net.forward(obs, carry)
            action = st["action"].to(device, torch.int64)
            keep["obs"].append(obs)
            keep["action"].append(action)
            keep["logits"].append(logits)
            keep["old_pi"].append(torch.softmax(logits, -1).gather(
                1, action[:, None])[:, 0])
            keep["value"].append(value)
            s, ts = env.step(s, action, br["fresh_idx"])
            if carry is not None:
                carry = reset(nxt, ts["done"])
            obs = E.observe(s, view, config["channels"])
            bad += int(((E.digest(obs) != st["digest"])
                        | ((ts["reward"] - st["reward"]).abs() > REWARD_TOL)
                        | (ts["done"] != st["done"])).sum())
            keep["reward"].append(ts["reward"])
            keep["done"].append(ts["done"])
        with torch.no_grad(), L.precision_mode(precision):
            (logits, last), _ = net.forward(obs, carry)
        keep["logits"].append(logits)
        out["logits"].append(torch.stack(keep.pop("logits")))
        traj = {k: torch.stack(v) for k, v in keep.items()}
        traj["value"] = torch.cat([traj["value"], last[None]])
        returns, adv = L.gae(ppo, traj["reward"], traj["done"], traj["value"])
        gen = torch.Generator(device)
        gen.set_state(br["gen_after"])
        if fault == "half_batch":
            traj, returns, adv = _half(traj, returns, adv)
            carry0 = carry0 and tuple(c[::2] for c in carry0)
        terms, sq = learner.update(traj, returns, adv, gen, carry0)
        out["batches"].append(dict(
            {k: float(v) for k, v in terms.items()},
            mean_value=float(traj["value"].mean()),
            mean_return=float(returns.mean())))
        if b == 0:
            out["grad_sq"] = sq
            out["params1"] = {n: p.detach().clone() for n, p in
                              zip(learner.names, learner.leaves)}
    out["exp_avg"] = learner.first_moment
    out["losses"] = learner.losses
    out["params"] = {n: p.detach().clone() for n, p in
                     zip(learner.names, learner.leaves)}
    out["env_mismatches"] = bad
    return out


def logit_gap(prog, ref):
    """The widest gap over the first check batch's steps, where both sides
    hold the same parameters, between the program's rollout logits and the
    reference's: a step's norm of the difference over the norm of the
    reference's logits."""
    p, r = prog[0], ref[0]
    p = p.to(r.device, torch.float64)
    r = r.double()
    num = torch.linalg.vector_norm(p - r, dim=(1, 2))
    den = torch.linalg.vector_norm(r, dim=(1, 2)).clamp(min=1e-30)
    return float((num / den).max())
