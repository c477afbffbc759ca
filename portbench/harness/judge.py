"""The numbers that decide ``correct``: the program's run against the
reference's, each number beside its limit (``portbench/limits/<cell>.json``,
set from the readings ``PERF.md`` gives)."""

import statistics

import torch

LOSS_KEYS = ("value_loss", "entropy", "mean_value", "mean_return")


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gaps(prog, ref, leaves=None):
    """Each leaf's gap between the program's and the reference's norms,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    p, r = _norms(prog), _norms(ref)
    leaves = list(r) if leaves is None else leaves
    med = statistics.median(r[k] for k in leaves)
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in leaves}


def leaf_gap(prog, ref, leaves=None):
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, leaves).values())


def moving_leaves(grad_sq):
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's."""
    norm = {k: float(v) ** 0.5 for k, v in grad_sq.items()}
    med = statistics.median(norm.values())
    return [k for k, v in norm.items() if v >= 1e-3 * med]


def train_readings(prog, ref, weights0, more=False):
    """``prog``: the program's losses of each minibatch, Adam's first
    moments after its first step, the parameters after the first and the
    last batch (by leaf) and each batch's report.  The readings: the
    env's mismatches; each batch's loss (its first minibatch's, where the
    program and the reference hold the same parameters up to the earlier
    batches' rounding); the first gradient as Adam got it; the change of
    the parameters over all the batches (``change_gap``) and over the
    first (``change1_gap``).  A cell's limits file names those it
    compares (PERF.md says why).  ``more`` adds each leaf's gaps and the
    gap of each batch's report, which are not compared."""
    steps = len(ref["losses"]) // len(ref["batches"])
    firsts = range(0, len(ref["losses"]), steps)
    loss = max(abs(prog["losses"][i] - ref["losses"][i])
               / max(abs(ref["losses"][i]), 1e-6) for i in firsts)
    spe = ref["params"]["spe"]
    start = dict(weights0, spe=torch.ones((), device=spe.device))
    moving = moving_leaves(ref["grad_sq"])

    def change(params):
        return {k: params[k].double() - start[k].double() for k in moving}
    change_p, change_r = change(prog["params"]), change(ref["params"])
    out = dict(env_mismatches=ref["env_mismatches"], loss_gap=loss,
               grad_gap=leaf_gap(prog["exp_avg"], ref["exp_avg"]),
               change_gap=leaf_gap(change_p, change_r),
               change1_gap=leaf_gap(change(prog["params1"]),
                                    change(ref["params1"])))
    if more:
        out["change_leaves"] = leaf_gaps(change_p, change_r)
        out["grad_leaves"] = leaf_gaps(prog["exp_avg"], ref["exp_avg"])
        out["report_gap"] = max(
            abs(p[k] - r[k]) / max(abs(r[k]), 1e-6)
            for p, r in zip(prog["batches"], ref["batches"])
            for k in LOSS_KEYS)
    return out


def eval_readings(prog, ref, more=False):
    """``prog``: one suite's per-level records and side-effect scores.
    The numbers compared: the observations (a level a step) and the
    levels' records that differ from the reference's, and the widest gap of a level's side-effect score.
    ``more`` adds the widest gap by which a taken action's perturbed
    logit lies below the reference's best, which is not compared
    (PERF.md: the control's reading of it is 0 on some seeds)."""
    dev = ref["length"].device
    bad = torch.tensor(ref["obs_mismatches"], dtype=torch.int64, device=dev)
    for k in ("length", "completed", "possible"):
        bad += (torch.as_tensor(prog[k], device=dev).to(torch.int64)
                != ref[k]).sum()
    bad += ((torch.as_tensor(prog["reward"], device=dev) - ref["reward"])
            .abs() > 1e-4).sum()
    p = torch.as_tensor(prog["side_effects"], device=dev, dtype=torch.float64)
    r = ref["side_effects"].double()
    scale = torch.maximum(r.abs(), r.abs().median()).clamp(min=1e-12)
    out = dict(level_mismatches=int(bad),
               side_effect_gap=float(((p - r).abs() / scale).max()))
    if more:
        out["action_gap"] = ref["action_gap"]
    return out


def decide(ctx, readings, limits):
    """Each reading that has a limit beside it into ``ctx.checks``;
    ``correct`` when every one is at or below its limit (and is a
    number)."""
    ok = True
    for name, limit in limits.items():
        value = readings[name]
        ctx.checks.append((name, value, limit))
        ok = ok and value == value and value <= limit
    ctx.correct = ok
    return ok
