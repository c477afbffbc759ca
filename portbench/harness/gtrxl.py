"""The GTrXL configuration's weights and counts (``safelife-gtrxl``).

Weights as ``weights.make`` makes the other nets': one normal draw from
``--seed`` on the card, each weight at ``gain / sqrt(fan_in)``, biases 0;
and the core's constants: layer norms 1 and 0, ``u`` and ``v`` 0, the
gates' ``b_g`` at ``gate_bias``.  Named as the program's state dict
names them.

Model FLOPs count two operations a multiply-add of every product the
model needs, whatever computes it:

- a query of a layer: its q and output projections, the two gates'
  six products, the MLP, and against each of the ``memory + 1`` keys of
  its window the content score, the position score and the weighted sum;
- a key's k and v projections, once a token in the rollout (the work a
  key/value cache would leave), and for the memory's ``memory`` tokens
  and the segment's again in each update forward;
- a backward pass: twice its forward, except the memory's k and v
  projections, once (their input is a stopped gradient, only the
  weights' gradient is wanted), and the first conv, once.

The position table's projection (``memory + 1`` rows a layer a call,
whatever the batch) and element-wise work are not counted.  The core's
least time: the update's forwards at the bf16 peak; a rollout step's the
larger of its FLOPs at the peak and its bytes at the peak bandwidth, the
bytes being the memory read once a layer a step (bf16) and the core's
weights (bf16).
"""

import math

import torch

from . import counts


def shapes(config):
    """{name: (shape, fan_in, gain, fill)}: a normal weight where
    ``fan_in``, else a constant ``fill``."""
    out = {}
    c = config["channels"]
    for layer in config["layers"]:
        n, g = layer["name"], layer.get("gain", 1.0)
        if layer["kind"] == "conv":
            k = layer["kernel"]
            out[n + ".weight"] = ((layer["out"], c, k, k), c * k * k, g, 0.0)
            c = layer["out"]
        else:
            out[n + ".weight"] = ((layer["out"], layer["in"]), layer["in"],
                                  g, 0.0)
        out[n + ".bias"] = ((layer["out"],), 0, 0.0, 0.0)
    cc = config["core"]
    d, inner, mlp = cc["d_model"], cc["heads"] * cc["head_dim"], cc["mlp"]
    for i in range(cc["layers"]):
        p = f"core.layers.{i}."
        out[p + "u"] = ((cc["heads"], cc["head_dim"]), 0, 0.0, 0.0)
        out[p + "v"] = ((cc["heads"], cc["head_dim"]), 0, 0.0, 0.0)
        for ln in ("ln1", "ln2"):
            out[p + ln + ".weight"] = ((d,), 0, 0.0, 1.0)
            out[p + ln + ".bias"] = ((d,), 0, 0.0, 0.0)
        for name, rows, cols in (("q", inner, d), ("kv", 2 * inner, d),
                                 ("r", inner, d), ("o", d, inner)):
            out[p + name + ".weight"] = ((rows, cols), cols, 1.0, 0.0)
        for name, rows, cols in (("mlp1", mlp, d), ("mlp2", d, mlp)):
            out[p + name + ".weight"] = ((rows, cols), cols, 1.0, 0.0)
            out[p + name + ".bias"] = ((rows,), 0, 0.0, 0.0)
        for gate in ("gate1", "gate2"):
            out[p + gate + ".bias"] = ((d,), 0, 0.0, cc["gate_bias"])
            for name, rows in (("w", 3 * d), ("u", 2 * d), ("ug", d)):
                out[p + gate + "." + name + ".weight"] = ((rows, d), d, 1.0,
                                                          0.0)
    return out


def make(config, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    table = shapes(config)
    total = sum(math.prod(s) for s, fan, _, _ in table.values() if fan)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, fan_in, gain, fill) in table.items():
        if not fan_in:
            out[name] = torch.full(shape, float(fill), device=device)
            continue
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * (gain / math.sqrt(fan_in))).reshape(
            shape).contiguous()
        at += n
    return out


def query_flops(config):
    """FLOPs of one query of one layer, its window's keys included."""
    cc = config["core"]
    d, inner, mlp = cc["d_model"], cc["heads"] * cc["head_dim"], cc["mlp"]
    keys = cc["memory"] + 1
    return 2 * (2 * d * inner + 12 * d * d + 2 * d * mlp + 3 * inner * keys)


def key_flops(config):
    """FLOPs of one token's k and v projections in one layer."""
    cc = config["core"]
    return 2 * 2 * cc["d_model"] * cc["heads"] * cc["head_dim"]


def rollout_step(config, envs):
    """(FLOPs, bytes) of one rollout step of the core over ``envs``."""
    cc = config["core"]
    flops = envs * cc["layers"] * (query_flops(config) + key_flops(config))
    weights = sum(math.prod(s) for n, (s, _, _, _) in shapes(config).items()
                  if n.startswith("core."))
    memory = envs * cc["layers"] * cc["memory"] * cc["d_model"]
    return flops, 2 * (memory + weights)


def update_forward(config, envs, steps):
    """FLOPs of the core's forward over ``envs`` segments of ``steps``."""
    cc = config["core"]
    return envs * cc["layers"] * (steps * query_flops(config) + (
        cc["memory"] + steps) * key_flops(config))


def update_backward(config, envs, steps):
    cc = config["core"]
    return envs * cc["layers"] * (2 * steps * query_flops(config) + (
        cc["memory"] + 2 * steps) * key_flops(config))


def train_flops(config, envs):
    """{precision: FLOPs} of a PPO batch of ``envs`` environments: the
    trunk, embedding and heads as ``counts.train_flops`` counts them, the
    core as the module's docstring says."""
    ppo = config["ppo"]
    steps, epochs = ppo["steps_per_env"], ppo["epochs_per_batch"]
    samples = envs * steps
    flops = counts.train_flops(config, samples, epochs, samples + envs)
    core_flops = (rollout_step(config, envs)[0] * (steps + 1) + epochs * (
        update_forward(config, envs, steps)
        + update_backward(config, envs, steps)))
    p = config["core"]["precision"]
    flops[p] = flops.get(p, 0) + core_flops
    return flops


def core_least_seconds(config, envs):
    """The least time a batch of the ops inside the core's calls: the
    rollout's ``steps + 1`` steps and the update's forwards."""
    ppo = config["ppo"]
    steps = ppo["steps_per_env"]
    peak = counts.PEAK_FLOPS[config["core"]["precision"]]
    flops, nbytes = rollout_step(config, envs)
    rollout = (steps + 1) * max(flops / peak, nbytes / counts.PEAK_BYTES)
    update = ppo["epochs_per_batch"] * update_forward(config, envs,
                                                      steps) / peak
    return rollout + update
