"""Policy/value network for SafeLife PPO, in PyTorch (port of
``safelife_tpu.training.model``).

Architecture matches the reference's TF1 CNN
(``training/safelife_ppo.py:141-202``): one-hot 15-channel input ->
conv 32x5x5/s2 -> conv 64x3x3/s2 -> conv 64x3x3/s1 (VALID padding, relu,
orthogonal init scaled sqrt(2)) -> dense 512 -> policy logits (ortho scale
0.01) + one value head per discount factor (ortho scale 1.0).

The observation arrives as ``(B, vh, vw, C)`` uint8 binary channels from
:mod:`safelife_torch.ops.obs` and is read as NCHW through a permute, so
the convolutions see it in ``channels_last`` memory format with no copy.
The trunk computes in ``compute_dtype`` (bfloat16 by default, under
``torch.autocast``; parameters stay float32) and the two heads in float32
on the trunk's features, as the JAX model does.  The last feature map is
flattened channels-last, in flax's (h, w, c) order, so the dense layer's
weight is the transpose of flax's kernel (:func:`params_from_flax`).
"""

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

# (features, kernel, stride) of the three VALID-padded convolutions.
TRUNK = ((32, 5, 2), (64, 3, 2), (64, 3, 1))


def feature_shape(view_shape):
    """(h, w) of the trunk's last feature map for a ``view_shape`` view."""
    h, w = view_shape
    for _, k, s in TRUNK:
        h, w = (h - k) // s + 1, (w - k) // s + 1
    return h, w


def min_view_for_net() -> Tuple[int, int]:
    """Smallest view the VALID-padded trunk accepts (the reference trains at
    33x33; its 15x15 default view is for humans/render and would produce an
    empty feature map here too).

    Chain: v -> (v-5)//2+1 -> (.-3)//2+1 -> (.-3)+1, which needs v >= 17
    to keep the last feature map non-empty."""
    return (17, 17)


def _ortho_(layer, gain, generator):
    nn.init.orthogonal_(layer.weight, gain, generator=generator)
    nn.init.zeros_(layer.bias)


class SafeLifeCNN(nn.Module):
    """Feed-forward trunk + policy/value heads.

    Call with obs of shape (..., vh, vw, C) uint8/float; leading dims are
    treated as batch.  Returns (logits (..., num_actions) float32,
    values (..., n_gamma) float32).  ``generator`` (a CPU
    ``torch.Generator``) draws the orthogonal initial weights.
    """

    def __init__(self, view_shape=(33, 33), in_channels=15, num_actions=9,
                 n_gamma=1, compute_dtype=torch.bfloat16, generator=None):
        super().__init__()
        fh, fw = feature_shape(view_shape)
        if fh <= 0 or fw <= 0:
            raise ValueError(
                f"view {tuple(view_shape)} too small for the VALID-padded "
                f"conv trunk (needs >= {min_view_for_net()}); the last "
                f"feature map would be {fh}x{fw}")
        self.view_shape = tuple(view_shape)
        self.num_actions = num_actions
        self.n_gamma = n_gamma
        self.compute_dtype = compute_dtype
        convs = []
        for features, kernel, stride in TRUNK:
            convs.append(nn.Conv2d(in_channels, features, kernel, stride))
            in_channels = features
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(fh * fw * in_channels, 512)
        self.policy = nn.Linear(512, num_actions)
        self.value = nn.Linear(512, n_gamma)
        for layer in (*self.convs, self.dense):
            _ortho_(layer, math.sqrt(2), generator)
        _ortho_(self.policy, 0.01, generator)
        _ortho_(self.value, 1.0, generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, obs):
        batch_shape = obs.shape[:-3]
        x = obs.reshape((-1,) + tuple(obs.shape[-3:])).permute(0, 3, 1, 2)
        x = x.to(self.compute_dtype)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            for conv in self.convs:
                x = torch.relu(conv(x))
            # Flatten in (h, w, c) order: a view of channels-last memory.
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = torch.relu(self.dense(x))
        x = x.float()
        logits = self.policy(x)
        values = self.value(x)
        return (logits.reshape(batch_shape + (self.num_actions,)),
                values.reshape(batch_shape + (self.n_gamma,)))


# Flax module names of the layers, in the order flax numbers them.
FLAX_LAYERS = (("Conv_0", "convs.0"), ("Conv_1", "convs.1"),
               ("Conv_2", "convs.2"), ("Dense_0", "dense"),
               ("Dense_1", "policy"), ("Dense_2", "value"))


def params_from_flax(net, flax_params):
    """The state dict of ``net`` holding a flax ``SafeLifeCNN``'s params
    (``{'params': {'Conv_0': {'kernel', 'bias'}, ...}}`` or its inner
    dict, as numpy arrays).  Conv kernels go from (kh, kw, in, out) to
    (out, in, kh, kw), dense kernels are transposed; both models flatten
    the last feature map in (h, w, c) order, so no row moves."""
    tree = flax_params.get("params", flax_params)
    ref = net.state_dict()
    out = {}
    for flax_name, name in FLAX_LAYERS:
        kernel = np.asarray(tree[flax_name]["kernel"])
        kernel = (kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                  else kernel.T)
        for key, value in ((f"{name}.weight", kernel),
                           (f"{name}.bias", tree[flax_name]["bias"])):
            value = torch.from_numpy(np.array(value))  # a writable copy
            if value.shape != ref[key].shape:
                raise ValueError(f"{flax_name} -> {key}: shape "
                                 f"{tuple(value.shape)}, net has "
                                 f"{tuple(ref[key].shape)}")
            out[key] = value.to(ref[key])
    return out


def params_to_flax(net):
    """The flax param tree (``{'params': ...}``, numpy float32) of
    ``net``'s weights: the inverse of :func:`params_from_flax`."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    tree = {}
    for flax_name, name in FLAX_LAYERS:
        weight = sd[f"{name}.weight"]
        kernel = (weight.transpose(2, 3, 1, 0) if weight.ndim == 4
                  else weight.T)
        tree[flax_name] = {"kernel": np.ascontiguousarray(kernel),
                           "bias": sd[f"{name}.bias"]}
    return {"params": tree}
