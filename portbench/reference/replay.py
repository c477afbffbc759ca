"""The reference's own run beside the program's: from the same levels and
weights, and the draws that the program's outputs carry, it works out the
env, the policy, GAE and the update again.

What it reads of the program's run are its outputs and its draws: the
levels each reset drew, each step's actions, and the run generator's state
where a draw starts (so it draws the same minibatch permutations, Gumbel
uniforms and spawn seeds itself).  It judges the rest: observations (by
fingerprint), rewards, ``done``, each level's record and side effects, and
the learner's numbers, which the caller compares.
"""

import torch

from . import env as E
from . import learner as L
from . import side_effects as SE
from . import spawns

REWARD_TOL = 1e-5  # float32 rounding of the movement bonus, far below
                   # the 7e-4 between two of its values


def train(config, traffic, levels_path, weights, rec, device,
          precision="f32", fault=None):
    """Follow the program's first batches (``fault``: "half_batch", a
    learner at fault put in the program's place).
    ``rec``: ``init_idx``, ``init_digest`` and ``batches``, each with
    ``fresh_idx``, ``gen_after`` and ``steps`` of (``action``,
    ``digest``, ``reward``, ``done``), all on ``device``.  Returns the env mismatches, each
    batch's last loss terms and means, each step's loss, Adam's first
    moments after the first step, each leaf's summed squared gradient
    over the first batch, and the parameters after the first batch and
    after the last."""
    ppo = config["ppo"]
    lv = E.levels_on(E.load_levels(levels_path), device)
    env = E.TrainingEnv(lv, tuple(config["view_shape"]),
                        traffic["time_limit"],
                        penalty=traffic["impact_penalty"])
    view = tuple(config["view_shape"])
    s = env.reset(rec["init_idx"])
    obs = E.observe(s, view, config["channels"])
    bad = int((E.digest(obs) != rec["init_digest"]).sum())
    learner = L.Learner(config, weights, precision)
    net = learner.net
    units = [l for l in config["layers"] if l["kind"] == "lstm"]
    batch = obs.shape[0]
    carry = ((torch.zeros(batch, units[0]["units"], device=device),) * 2
             if units else None)
    out = dict(batches=[])
    for b, br in enumerate(rec["batches"]):
        carry0 = carry
        keep = dict(obs=[], action=[], old_pi=[], reward=[], done=[],
                    value=[])
        for st in br["steps"]:
            with torch.no_grad(), L.precision_mode(precision):
                (logits, value), nxt = net.forward(obs, carry)
            action = st["action"].to(device, torch.int64)
            keep["obs"].append(obs)
            keep["action"].append(action)
            keep["old_pi"].append(torch.softmax(logits, -1).gather(
                1, action[:, None])[:, 0])
            keep["value"].append(value)
            s, ts = env.step(s, action, br["fresh_idx"])
            if carry is not None:
                m = (~ts["done"]).to(torch.float32)[:, None]
                carry = (nxt[0] * m, nxt[1] * m)
            obs = E.observe(s, view, config["channels"])
            bad += int(((E.digest(obs) != st["digest"])
                        | ((ts["reward"] - st["reward"]).abs() > REWARD_TOL)
                        | (ts["done"] != st["done"])).sum())
            keep["reward"].append(ts["reward"])
            keep["done"].append(ts["done"])
        with torch.no_grad(), L.precision_mode(precision):
            (_, last), _ = net.forward(obs, carry)
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


def _half(traj, returns, adv):
    """Every other environment: a learner that leaves half the batch out."""
    return ({k: v[:, ::2] for k, v in traj.items()}, returns[:, ::2],
            adv[:, ::2])


def evaluate(config, traffic, levels_path, weights, steps, device,
             control=False):
    """Follow one suite of the program's evaluation.  ``steps``: each
    step's (the observation's fingerprint, the generator's state before
    the policy's draw, the actions, the state after it).  Returns each
    level's first-episode record, its side-effect score, the observations
    whose fingerprint differs from the reference's, and the widest gap by which a taken action's
    Gumbel-perturbed logit lies below the best.  With ``control`` it also
    returns the control's readings on the same steps: the gap of the
    action the low-precision net puts first, and the scores with the
    Sinkhorn iterations in TF32."""
    lv = E.levels_on(E.load_levels(levels_path), device)
    n = lv["board"].shape[-1]
    view = tuple(config["view_shape"])
    s = E.fresh(lv, torch.arange(n, device=device))
    params = {k: v.float() for k, v in weights.items()}
    net = L.Net(config, params)
    low = L.Net(config, params, "low") if control else None
    gen = torch.Generator(device)
    rec = dict(done=torch.zeros(n, dtype=torch.bool, device=device),
               length=torch.zeros(n, dtype=torch.int64, device=device),
               reward=torch.zeros(n, device=device),
               completed=torch.zeros(n, dtype=torch.int64, device=device),
               possible=torch.zeros(n, dtype=torch.int64, device=device))
    fields = dict(length="episode_length", reward="episode_reward",
                  completed="perf_completed", possible="perf_possible")
    tiny = torch.finfo(torch.float32).tiny
    gap = torch.zeros((), device=device)
    low_gap = torch.zeros((), device=device)
    obs_bad = 0
    for digest, before, action, after in steps:
        action = action.to(device, torch.int64)
        obs = E.observe(s, view, config["channels"])
        obs_bad += int((E.digest(obs) != digest).sum())
        with torch.no_grad(), L.precision_mode("f32"):
            (logits, _), _ = net.forward(obs)
        gen.set_state(before)
        u = torch.rand(logits.shape, generator=gen, device=device)
        noise = -torch.log(-torch.log(u.clamp(min=tiny)))
        z = logits + noise
        best = z.max(-1).values
        gap = torch.maximum(gap, (best - z.gather(1, action[:, None])[:, 0])
                            .max())
        if low is not None:
            with torch.no_grad(), L.precision_mode("low"):
                (lo, _), _ = low.forward(obs)
            pick = (lo + noise).argmax(-1)
            low_gap = torch.maximum(low_gap, (best - z.gather(
                1, pick[:, None])[:, 0]).max())
        gen.set_state(after)
        seed = spawns.step_seed(gen, device)
        if lv["spawnless"]:
            sb = sg = torch.zeros_like(s["board"], dtype=torch.bool)
        else:
            sb, sg = spawns.fields(seed, s["spawn_prob"], s["board"].shape,
                                   lv["static_goals"])
        s, ts = E.step(s, lv, action, sb, sg, traffic["time_limit"])
        newly = ts["done"] & ~rec["done"]
        for key, name in fields.items():
            rec[key] = torch.where(newly, ts[name], rec[key])
        rec["done"] |= ts["done"]
    args = (s["init_board"], s["board"], s["spawn_prob"], s["episode_length"],
            traffic["side_effect_samples"])
    state = gen.get_state()
    out = dict(rec, side_effects=SE.scores(*args, gen, traffic["time_limit"]),
               action_gap=float(gap), obs_mismatches=obs_bad)
    if control:
        gen.set_state(state)
        out["control"] = dict(rec, action_gap=float(low_gap),
                              side_effects=SE.scores(
                                  *args, gen, traffic["time_limit"], tf32=True))
    return out
