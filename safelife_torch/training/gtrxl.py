"""GTrXL, the gated Transformer-XL memory core (Parisotto et al.,
"Stabilizing Transformers for Reinforcement Learning", ICML 2020,
arXiv:1910.06764), as the recurrent core of ``SafeLifeGTrXLNet``.

Per layer, with ``E`` the layer's input and ``M`` its memory (its inputs
at the last ``memory`` steps, gradients stopped)::

    Y_ = RelMHA(LN(E), LN([sg(M), E]))     Transformer-XL attention
    Y  = g(E, relu(Y_))
    E_ = MLP(LN(Y))
    E' = g(Y, relu(E_))

with the relative score ``q.k + q.W_R R(i-j) + u.k + v.W_R R(i-j)`` (Dai et
al. 2019, arXiv:1901.02860, section 3.3; ``R`` sinusoidal, ``u`` and ``v``
learned a head) and the GRU-type gate ``g(x, y) = (1 - z) x + z h``,
``r = sigmoid(W_r y + U_r x)``, ``z = sigmoid(W_z y + U_z x - b_g)``,
``h = tanh(W_g y + U_g (r x))``, ``b_g`` starting at 2.

**Window.**  The query of a step attends to itself and to at most
``memory`` steps before it, none from before its episode's start.

**Memory.**  A ring of ``memory + segment + 1`` slots a layer
(``segment``: the rollout's steps a batch, given to :meth:`initial_carry`;
the step and the replay read the ring's size from the carry).  A step
writes its inputs to layer ``l`` into slot ``head`` of that layer's ring
(one write a layer a step, nothing copied whole) and attends over every
slot, the slot's age ``(head - slot) % slots`` giving the distance; slots
older than the episode's valid ``length`` are masked.  The rollout's
writes land in the ``segment + 1`` slots after the ones the update reads,
so the update replays each minibatch against the very ring the rollout
started from (its rows of it) with no copy taken before the rollout.
The carry is ``(ring_0, ..., ring_{L-1}, length, head)``, each indexed by
environment on dim 0.

**Precision.**  The products run in ``dtype`` (bfloat16: float32
accumulation, bfloat16 results), the layer norms, the softmax (inside
``scaled_dot_product_attention``), the gates' sigmoid and tanh and the
residual stream in float32; the rings hold ``dtype``, and the keys' layer
norm, on the ring, computes its statistics in float32 and returns
``dtype``.  The position term and the masks enter the attention as an
additive bias in ``dtype``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span

# The paper's DMLab-30 setting.
LAYERS, D_MODEL, HEADS, HEAD_DIM, MLP, MEMORY = 12, 256, 8, 64, 1024, 512
GATE_BIAS = 2.0


def sinusoid(n, dim):
    """(n, dim) float32 encodings of the distances 0 .. n - 1: the sines
    then the cosines of ``d / 10000 ** (2i / dim)``."""
    inv = 1.0 / 10000 ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    angle = torch.arange(n, dtype=torch.float64)[:, None] * inv
    return torch.cat([angle.sin(), angle.cos()], -1).float()


def linear(x, layer, dtype):
    """``layer`` (an ``nn.Linear``) on ``x``, computed in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def normal_init(layer, gain, generator):
    """``layer``'s weight normal at ``gain / sqrt(fan_in)``, its bias 0."""
    with torch.no_grad():
        layer.weight.normal_(0.0, gain / math.sqrt(layer.in_features),
                             generator=generator)
        if layer.bias is not None:
            layer.bias.zero_()


class Gate(nn.Module):
    """The GRU-type gate ``g(x, y)``: ``w`` holds W_r, W_z, W_g (on y),
    ``u`` holds U_r, U_z (on x), ``ug`` U_g, ``bias`` b_g."""

    def __init__(self, d, generator=None):
        super().__init__()
        self.w = nn.Linear(d, 3 * d, bias=False)
        self.u = nn.Linear(d, 2 * d, bias=False)
        self.ug = nn.Linear(d, d, bias=False)
        self.bias = nn.Parameter(torch.full((d,), GATE_BIAS))
        for layer in (self.w, self.u, self.ug):
            normal_init(layer, 1.0, generator)

    def forward(self, x, y, dtype):
        wr, wz, wg = linear(y, self.w, dtype).float().chunk(3, -1)
        ur, uz = linear(x, self.u, dtype).float().chunk(2, -1)
        r = torch.sigmoid(wr + ur)
        z = torch.sigmoid(wz + uz - self.bias)
        h = torch.tanh(wg + linear(r * x, self.ug, dtype).float())
        return (1.0 - z) * x + z * h


class Layer(nn.Module):
    """One GTrXL layer."""

    def __init__(self, d, heads, head_dim, mlp, generator=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.ln1 = nn.LayerNorm(d)
        self.q = nn.Linear(d, inner, bias=False)
        self.kv = nn.Linear(d, 2 * inner, bias=False)
        self.r = nn.Linear(d, inner, bias=False)
        self.o = nn.Linear(inner, d, bias=False)
        self.u = nn.Parameter(torch.zeros(heads, head_dim))
        self.v = nn.Parameter(torch.zeros(heads, head_dim))
        self.gate1 = Gate(d, generator)
        self.ln2 = nn.LayerNorm(d)
        self.mlp1 = nn.Linear(d, mlp)
        self.mlp2 = nn.Linear(mlp, d)
        self.gate2 = Gate(d, generator)
        for layer in (self.q, self.kv, self.r, self.o, self.mlp1, self.mlp2):
            normal_init(layer, 1.0, generator)

    def attend(self, x, src, dist, valid, rel, dtype):
        """Relative attention of the queries' inputs ``x`` (N, Q, D)
        float32 over the keys' inputs ``src`` (N, K, D), at distances
        ``dist`` (N, Q, K) (rows of ``rel``, the encodings), where
        ``valid`` (N, Q, K).  Returns (N, Q, D) float32."""
        n, nq, _ = x.shape
        nk = src.shape[1]
        h, e = self.heads, self.head_dim
        q = linear(self.ln1(x), self.q, dtype).view(n, nq, h, e).float()
        # The keys' inputs stay in the memory's dtype: the norm computes
        # its statistics in float32 and applies its weights in that dtype.
        ln = self.ln1
        src = F.layer_norm(src, ln.normalized_shape, ln.weight.to(src.dtype),
                           ln.bias.to(src.dtype), ln.eps)
        k, v = linear(src, self.kv, dtype).view(n, nk, 2, h, e).unbind(2)
        pos = linear(rel, self.r, dtype).view(-1, h, e)
        pos = torch.einsum("nqhe,rhe->nhqr", (q + self.v).to(dtype), pos)
        bias = pos.gather(-1, dist[:, None].expand(n, h, nq, nk))
        bias = (bias / math.sqrt(e)).masked_fill(~valid[:, None],
                                                 float("-inf"))
        out = F.scaled_dot_product_attention(
            (q + self.u).to(dtype).transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2), attn_mask=bias)
        out = out.transpose(1, 2).reshape(n, nq, h * e)
        return linear(out, self.o, dtype).float()

    def forward(self, x, src, dist, valid, rel, dtype):
        y = self.gate1(x, torch.relu(self.attend(x, src, dist, valid, rel,
                                                 dtype)), dtype)
        mlp = linear(torch.relu(linear(self.ln2(y), self.mlp1, dtype)),
                     self.mlp2, dtype).float()
        return self.gate2(y, torch.relu(mlp), dtype)


class GTrXL(nn.Module):
    """The stack of ``layers`` GTrXL layers and its memory rings (see the
    module's docstring)."""

    def __init__(self, layers=LAYERS, d_model=D_MODEL, heads=HEADS,
                 head_dim=HEAD_DIM, mlp=MLP, memory=MEMORY,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.d_model, self.memory, self.dtype = d_model, memory, dtype
        self.layers = nn.ModuleList(
            Layer(d_model, heads, head_dim, mlp, generator)
            for _ in range(layers))
        self.register_buffer("rel", sinusoid(memory + 1, d_model),
                             persistent=False)
        self._fill, self._fill_steps = None, 0

    def initial_carry(self, batch, segment=0):
        """Empty rings with room for a ``segment`` of steps beyond the
        memory, ``length`` 0 and ``head`` 0 for ``batch`` environments, on
        the core's device."""
        dev = self.rel.device
        slots = self.memory + segment + 1
        rings = tuple(torch.zeros((batch, slots, self.d_model),
                                  dtype=self.dtype, device=dev)
                      for _ in self.layers)
        zero = torch.zeros(batch, dtype=torch.int64, device=dev)
        return rings + (zero, zero.clone())

    def reset_carry(self, carry, done):
        """``carry`` with the finished environments' valid lengths zeroed
        (their slots untouched); adds the memory's fill before the reset
        to the counter that :meth:`take_memory_fill` reads."""
        *rings, length, head = carry
        with span("gtrxl.memory"):
            fill = length.float().mean() / self.memory
            self._fill = fill if self._fill is None else self._fill + fill
            self._fill_steps += 1
            length = length.masked_fill(done, 0)
        return (*rings, length, head)

    def take_memory_fill(self):
        """The mean valid memory length over the steps :meth:`reset_carry`
        saw since the last call, a share of ``memory`` (a device scalar),
        or None; restarts the count."""
        fill, steps = self._fill, self._fill_steps
        self._fill, self._fill_steps = None, 0
        return None if fill is None else fill / steps

    def step(self, x, carry):
        """One step of the acting path on the embedded features ``x`` (N,
        D) float32: writes each layer's input into its ring, attends over
        the ring.  Returns (carry', output (N, D) float32).  The ring holds
        detached values: the update trains through :meth:`segment`."""
        *rings, length, head = carry
        n, slots = x.shape[0], rings[0].shape[1]
        rows = torch.arange(n, device=x.device)
        age = (head[:, None] - torch.arange(slots, device=x.device)) % slots
        valid = (age <= length[:, None])[:, None]
        dist = age.clamp(max=self.memory)[:, None]
        x = x[:, None]
        with span("gtrxl.core"):
            for layer, ring in zip(self.layers, rings):
                with span("gtrxl.memory"):
                    ring[rows, head] = x[:, 0].detach().to(ring.dtype)
                x = layer(x, ring, dist, valid, self.rel, self.dtype)
        carry = (*rings, (length + 1).clamp(max=self.memory),
                 (head + 1) % slots)
        return carry, x[:, 0]

    def segment(self, x, done, carry0):
        """Replay a segment of embedded features ``x`` (T, M, D) float32
        with its ``done`` (T, M) from ``carry0``, the carry before its first
        step: query ``t`` attends to the segment's steps up to ``t`` and to
        the ring's slots ``t + age <= memory`` back, within its episode.
        Returns (T, M, D) float32."""
        *rings, length, head = carry0
        steps, m = done.shape
        slots = rings[0].shape[1]
        if steps > slots - self.memory - 1:
            raise ValueError(f"a segment of {steps} steps; the rings hold "
                             f"{slots - self.memory - 1}")
        dev = x.device
        t = torch.arange(steps, device=dev)
        age = (head[:, None] - torch.arange(slots, device=dev)) % slots
        done = done.to(torch.int64)
        episode = (done.cumsum(0) - done).T                      # (M, T)
        ring_dist = t[:, None] + age[:, None]                    # (M, T, C)
        ring_ok = ((episode == 0)[:, :, None] & (age >= 1)[:, None]
                   & (age <= length[:, None])[:, None]
                   & (ring_dist <= self.memory))
        own_dist = (t[:, None] - t[None]).expand(m, steps, steps)
        own_ok = ((own_dist >= 0) & (own_dist <= self.memory)
                  & (episode[:, :, None] == episode[:, None]))
        dist = torch.cat([ring_dist, own_dist], -1).clamp(0, self.memory)
        valid = torch.cat([ring_ok, own_ok], -1)
        x = x.transpose(0, 1)
        with span("gtrxl.core"):
            for layer, ring in zip(self.layers, rings):
                src = torch.cat([ring, x.to(ring.dtype)], 1)
                x = layer(x, src, dist, valid, self.rel, self.dtype)
        return x.transpose(0, 1)
