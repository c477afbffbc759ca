"""The run's weights, made from ``--seed`` on the card in one draw: each
weight normal with standard deviation ``gain / sqrt(fan_in)``, each bias
zero, float32 (the parameters' type; the trunk computes in bf16 from
them), named as the program's state dict names them."""

import math

import torch


def shapes(config):
    """{name: (shape, fan_in, gain)} of every parameter."""
    c = config["channels"]
    out = {}
    for layer in config["layers"]:
        n, g = layer["name"], layer.get("gain", 1.0)
        if layer["kind"] == "conv":
            k = layer["kernel"]
            out[n + ".weight"] = ((layer["out"], c, k, k), c * k * k, g)
            out[n + ".bias"] = ((layer["out"],), 0, 0.0)
            c = layer["out"]
        elif layer["kind"] == "dense":
            out[n + ".weight"] = ((layer["out"], layer["in"]), layer["in"], g)
            out[n + ".bias"] = ((layer["out"],), 0, 0.0)
        else:
            u, i = layer["units"], layer["in"]
            out[n + ".weight_ih"] = ((4 * u, i), i, g)
            out[n + ".weight_hh"] = ((4 * u, u), u, g)
            out[n + ".bias_ih"] = ((4 * u,), 0, 0.0)
            out[n + ".bias_hh"] = ((4 * u,), 0, 0.0)
    return out


def make(config, seed, device):
    gen = torch.Generator(device).manual_seed(seed)
    table = shapes(config)
    total = sum(math.prod(s) for s, _, _ in table.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, fan_in, gain) in table.items():
        n = math.prod(shape)
        scale = gain / math.sqrt(fan_in) if fan_in else 0.0
        out[name] = (flat[at:at + n] * scale).reshape(shape).contiguous()
        at += n
    return out
