"""Policy/value networks for SafeLife PPO, in PyTorch (port of
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

:class:`SafeLifeLSTMNet` is the recurrent variant: the same trunk, then
an LSTM of 512 units in float32 (outside the autocast region, as the JAX
model casts to float32 before its ``OptimizedLSTMCell``) in place of the
dense layer.  Its carry is ``(c, h)``, flax's order.

:class:`SafeLifeGTrXLNet` is the third policy: the same trunk, a dense
embedding to 256, then the 12-layer gated Transformer-XL core of
:mod:`.gtrxl` over a 512-step memory, then the heads in float32.  It has
no flax counterpart: its checkpoints are the port's own state dicts.
"""

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..utils.profiling import span
from . import gtrxl

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


def _make_trunk(view_shape, in_channels, generator):
    """The three convolutions (orthogonal init, gain sqrt(2)) and the size
    of their flattened output on a ``view_shape`` view."""
    fh, fw = feature_shape(view_shape)
    if fh <= 0 or fw <= 0:
        raise ValueError(
            f"view {tuple(view_shape)} too small for the VALID-padded "
            f"conv trunk (needs >= {min_view_for_net()}); the last "
            f"feature map would be {fh}x{fw}")
    convs = []
    for features, kernel, stride in TRUNK:
        convs.append(nn.Conv2d(in_channels, features, kernel, stride))
        in_channels = features
    for conv in convs:
        _ortho_(conv, math.sqrt(2), generator)
    return nn.ModuleList(convs), fh * fw * in_channels


def _trunk(convs, obs, compute_dtype):
    """(N, vh, vw, C) observations -> (N, features) in ``compute_dtype``
    (autocast), flattened in (h, w, c) order."""
    x = obs.permute(0, 3, 1, 2).to(compute_dtype)
    with torch.autocast(x.device.type, dtype=compute_dtype,
                        enabled=compute_dtype != torch.float32):
        for conv in convs:
            x = torch.relu(conv(x))
    # A view of channels-last memory.
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


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
        self.view_shape = tuple(view_shape)
        self.num_actions = num_actions
        self.n_gamma = n_gamma
        self.compute_dtype = compute_dtype
        self.convs, features = _make_trunk(view_shape, in_channels,
                                           generator)
        self.dense = nn.Linear(features, 512)
        self.policy = nn.Linear(512, num_actions)
        self.value = nn.Linear(512, n_gamma)
        _ortho_(self.dense, math.sqrt(2), generator)
        _ortho_(self.policy, 0.01, generator)
        _ortho_(self.value, 1.0, generator)
        self.to(memory_format=torch.channels_last)

    def forward(self, obs):
        batch_shape = obs.shape[:-3]
        x = _trunk(self.convs, obs.reshape((-1,) + tuple(obs.shape[-3:])),
                   self.compute_dtype)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            x = torch.relu(self.dense(x))
        x = x.float()
        logits = self.policy(x)
        values = self.value(x)
        return (logits.reshape(batch_shape + (self.num_actions,)),
                values.reshape(batch_shape + (self.n_gamma,)))


LSTM_UNITS = 512


def lstm_step(x, carry, weight_ih, weight_hh, bias_ih, bias_hh):
    """One LSTM step in plain tensor ops, the reference ``nn.LSTMCell`` is
    held to: gates stacked (i, f, g, o) as in ``weight_ih``; ``carry`` and
    the returned carry are ``(c, h)``.  Returns (carry', h')."""
    c, h = carry
    gates = x @ weight_ih.T + bias_ih + h @ weight_hh.T + bias_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (c, h), h


class SafeLifeLSTMNet(nn.Module):
    """CNN trunk + LSTM(512) core + policy/value heads, the reference's
    optional recurrent path (safelife_ppo.py:168-189).

    ``net(obs, carry) -> (carry', (logits, values))`` takes one step of
    (B, vh, vw, C) observations; the caller threads the carry through a
    rollout and resets it with ``done`` masks (carry * ~done).  The trunk
    computes in ``compute_dtype`` (bfloat16 by default); the LSTM and the
    heads in float32.  The input kernels of flax's cell have no bias, so
    ``lstm.bias_ih`` stays zero and is not trained.
    """

    def __init__(self, view_shape=(33, 33), in_channels=15, num_actions=9,
                 n_gamma=1, compute_dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.view_shape = tuple(view_shape)
        self.num_actions = num_actions
        self.n_gamma = n_gamma
        self.compute_dtype = compute_dtype
        self.convs, features = _make_trunk(view_shape, in_channels,
                                           generator)
        self.lstm = nn.LSTMCell(features, LSTM_UNITS)
        self.policy = nn.Linear(LSTM_UNITS, num_actions)
        self.value = nn.Linear(LSTM_UNITS, n_gamma)
        # As flax initialises its cell: input kernels normal with variance
        # 1 / fan_in, recurrent kernels orthogonal (each gate its own),
        # zero biases.
        with torch.no_grad():
            self.lstm.weight_ih.normal_(0.0, 1.0 / math.sqrt(features),
                                        generator=generator)
            for gate in self.lstm.weight_hh.chunk(4):
                nn.init.orthogonal_(gate, generator=generator)
            self.lstm.bias_ih.zero_()
            self.lstm.bias_hh.zero_()
        self.lstm.bias_ih.requires_grad_(False)
        _ortho_(self.policy, 0.01, generator)
        _ortho_(self.value, 1.0, generator)
        self.to(memory_format=torch.channels_last)

    def initial_carry(self, batch, segment=0):
        """The zero carry ``(c, h)`` of ``batch`` environments, float32 on
        the net's device.  ``segment``, the steps a rollout takes between
        updates, is for a net whose carry keeps them (the GTrXL's
        memory); this carry holds one step."""
        z = torch.zeros((batch, LSTM_UNITS),
                        device=self.lstm.weight_ih.device)
        return (z, z.clone())

    def features(self, obs):
        """(..., vh, vw, C) observations -> (N, features) float32, the
        trunk's output with the leading dims flattened."""
        return _trunk(self.convs, obs.reshape((-1,) + tuple(obs.shape[-3:])),
                      self.compute_dtype).float()

    def cell(self, x, carry):
        """One LSTM step on trunk features: (carry', h')."""
        c, h = carry
        h, c = self.lstm(x, (h, c))
        return (c, h), h

    def heads(self, h):
        """(logits, values) of the cell's output ``h``."""
        return self.policy(h), self.value(h)

    def forward(self, obs, carry):
        carry, h = self.cell(self.features(obs), carry)
        return carry, self.heads(h)


class SafeLifeGTrXLNet(nn.Module):
    """CNN trunk + dense embedding + GTrXL core (:mod:`.gtrxl`) +
    policy/value heads.

    The recurrent interface of :class:`SafeLifeLSTMNet`: ``net(obs,
    carry) -> (carry', (logits, values))`` for one step, ``features``,
    ``heads``, ``initial_carry``; and two of its own, which the PPO code
    uses where a net has them: ``reset_carry(carry, done)`` (the finished
    environments' memories emptied) and ``sequence(features, done,
    carry0)`` (a whole segment replayed at once).  ``initial_carry(batch,
    segment)`` makes room in the memory for the ``segment`` steps a
    rollout takes between updates (``steps_per_env``).  The trunk, the
    embedding and the core's products compute in ``compute_dtype``; the
    heads in float32.
    """

    def __init__(self, view_shape=(33, 33), in_channels=15, num_actions=9,
                 n_gamma=1, compute_dtype=torch.bfloat16, generator=None,
                 layers=gtrxl.LAYERS, d_model=gtrxl.D_MODEL,
                 heads=gtrxl.HEADS, head_dim=gtrxl.HEAD_DIM, mlp=gtrxl.MLP,
                 memory=gtrxl.MEMORY):
        super().__init__()
        self.view_shape = tuple(view_shape)
        self.num_actions = num_actions
        self.n_gamma = n_gamma
        self.compute_dtype = compute_dtype
        self.convs, features = _make_trunk(view_shape, in_channels,
                                           generator)
        self.embed = nn.Linear(features, d_model)
        self.core = gtrxl.GTrXL(layers, d_model, heads, head_dim, mlp,
                                memory, compute_dtype, generator)
        self.policy = nn.Linear(d_model, num_actions)
        self.value = nn.Linear(d_model, n_gamma)
        gtrxl.normal_init(self.embed, 1.0, generator)
        _ortho_(self.policy, 0.01, generator)
        _ortho_(self.value, 1.0, generator)
        self.to(memory_format=torch.channels_last)

    def initial_carry(self, batch, segment=0):
        return self.core.initial_carry(batch, segment)

    def reset_carry(self, carry, done):
        return self.core.reset_carry(carry, done)

    def take_memory_fill(self):
        return self.core.take_memory_fill()

    def features(self, obs):
        """(..., vh, vw, C) observations -> (N, d_model) float32: the
        trunk, then the embedding."""
        x = _trunk(self.convs, obs.reshape((-1,) + tuple(obs.shape[-3:])),
                   self.compute_dtype)
        return gtrxl.linear(x, self.embed, self.compute_dtype).float()

    def heads(self, h):
        return self.policy(h), self.value(h)

    def forward(self, obs, carry):
        carry, h = self.core.step(self.features(obs), carry)
        return carry, self.heads(h)

    def sequence(self, features, done, carry0):
        """(T, M, d_model) features of a segment and its ``done`` (T, M),
        replayed from ``carry0``: (T, M, d_model) core outputs."""
        with span("gtrxl.replay"):
            return self.core.segment(features, done, carry0)


# Flax module names of the layers, in the order flax numbers them.
FLAX_LAYERS = (("Conv_0", "convs.0"), ("Conv_1", "convs.1"),
               ("Conv_2", "convs.2"), ("Dense_0", "dense"),
               ("Dense_1", "policy"), ("Dense_2", "value"))
LSTM_FLAX_LAYERS = (("Conv_0", "convs.0"), ("Conv_1", "convs.1"),
                    ("Conv_2", "convs.2"), ("Dense_0", "policy"),
                    ("Dense_1", "value"))
LSTM_FLAX_CELL = "OptimizedLSTMCell_0"
GATES = "ifgo"   # nn.LSTMCell's order of the gates in its weights


def _layers(net):
    if isinstance(net, SafeLifeGTrXLNet):
        raise ValueError("SafeLifeGTrXLNet has no flax counterpart: its "
                         "checkpoints are the port's own .pt state dicts")
    return (LSTM_FLAX_LAYERS if isinstance(net, SafeLifeLSTMNet)
            else FLAX_LAYERS)


def params_from_flax(net, flax_params):
    """The state dict of ``net`` holding a flax ``SafeLifeCNN``'s or
    ``SafeLifeLSTMNet``'s params (``{'params': {'Conv_0': {'kernel',
    'bias'}, ...}}`` or its inner dict, as numpy arrays).  Conv kernels go
    from (kh, kw, in, out) to (out, in, kh, kw), dense kernels are
    transposed; both models flatten the last feature map in (h, w, c)
    order, so no row moves.  The LSTM cell's per-gate kernels (``ii``..
    ``io`` without bias, ``hi``..``ho`` with one) stack transposed into
    ``weight_ih`` and ``weight_hh`` in (i, f, g, o) order; ``bias_hh``
    takes the biases and ``bias_ih`` is zero."""
    tree = flax_params.get("params", flax_params)
    ref = net.state_dict()
    values = {}
    for flax_name, name in _layers(net):
        kernel = np.asarray(tree[flax_name]["kernel"])
        values[f"{name}.weight"] = flax_name, (
            kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T)
        values[f"{name}.bias"] = flax_name, tree[flax_name]["bias"]
    if isinstance(net, SafeLifeLSTMNet):
        cell = tree[LSTM_FLAX_CELL]
        for side in "ih":
            values[f"lstm.weight_{side}h"] = LSTM_FLAX_CELL, np.concatenate(
                [np.asarray(cell[side + g]["kernel"]).T for g in GATES])
        bias = np.concatenate(
            [np.asarray(cell["h" + g]["bias"]) for g in GATES])
        values["lstm.bias_hh"] = LSTM_FLAX_CELL, bias
        values["lstm.bias_ih"] = LSTM_FLAX_CELL, np.zeros_like(bias)
    out = {}
    for key, (flax_name, value) in values.items():
        value = torch.from_numpy(np.array(value))  # a writable copy
        if value.shape != ref[key].shape:
            raise ValueError(f"{flax_name} -> {key}: shape "
                             f"{tuple(value.shape)}, net has "
                             f"{tuple(ref[key].shape)}")
        out[key] = value.to(ref[key])
    return out


def params_to_flax(net):
    """The flax param tree (``{'params': ...}``, numpy float32) of
    ``net``'s weights: the inverse of :func:`params_from_flax` (the LSTM's
    ``bias_ih``, zero there, is added to the hidden biases)."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    tree = {}
    for flax_name, name in _layers(net):
        weight = sd[f"{name}.weight"]
        kernel = (weight.transpose(2, 3, 1, 0) if weight.ndim == 4
                  else weight.T)
        tree[flax_name] = {"kernel": np.ascontiguousarray(kernel),
                           "bias": sd[f"{name}.bias"]}
    if isinstance(net, SafeLifeLSTMNet):
        w_ih, w_hh = (np.split(sd[f"lstm.weight_{s}h"], 4) for s in "ih")
        bias = np.split(sd["lstm.bias_ih"] + sd["lstm.bias_hh"], 4)
        cell = {}
        for g, wi, wh, b in zip(GATES, w_ih, w_hh, bias):
            cell["i" + g] = {"kernel": np.ascontiguousarray(wi.T)}
            cell["h" + g] = {"kernel": np.ascontiguousarray(wh.T), "bias": b}
        tree[LSTM_FLAX_CELL] = cell
    return {"params": tree}
