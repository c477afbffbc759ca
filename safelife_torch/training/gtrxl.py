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

**Key/value cache.**  The weights do not change inside a rollout, so
neither do a slot's keys and values.  A step without grad reads them from
a cache that the core keeps beside the rings (each layer's
``kv(LN(slot))`` for every slot), projects only the slot it writes, and
rebuilds the cache where the rings or the projection's weights are not
the ones it was built from.  The update's replay drops it: in training it
lives from the rollout's first step to the update.  With the ring's
projection gone a step is some thousand small launches, so on a card the
steps after a cache's first replay one CUDA graph of the step.

**Precision.**  The products run in ``dtype`` (bfloat16: float32
accumulation, bfloat16 results), the layer norms, the softmax (inside
``scaled_dot_product_attention``), the gates' sigmoid and tanh and the
residual stream in float32; the rings hold ``dtype``, and the keys' layer
norm, on the ring, computes its statistics in float32 and returns
``dtype``.  The position term and the masks enter the attention as an
additive bias in ``dtype``.
"""

import math
import weakref

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

    def keys(self, src, dtype):
        """The keys' and values' projection ``kv(LN(src))`` of the keys'
        inputs ``src`` (N, K, D): (N, K, 2 * heads * head_dim) in
        ``dtype``, the keys then the values of each head."""
        # The keys' inputs stay in the memory's dtype: the norm computes
        # its statistics in float32 and applies its weights in that dtype.
        ln = self.ln1
        src = F.layer_norm(src, ln.normalized_shape, ln.weight.to(src.dtype),
                           ln.bias.to(src.dtype), ln.eps)
        return linear(src, self.kv, dtype)

    def attend(self, x, kv, dist, valid, rel, dtype):
        """Relative attention of the queries' inputs ``x`` (N, Q, D)
        float32 over the keys' projection ``kv`` (N, K, 2 * heads *
        head_dim, :meth:`keys`), at distances ``dist`` (N, Q, K) (rows of
        ``rel``, the encodings), where ``valid`` (N, Q, K).  Returns (N, Q,
        D) float32."""
        n, nq, _ = x.shape
        nk = kv.shape[1]
        h, e = self.heads, self.head_dim
        q = linear(self.ln1(x), self.q, dtype).view(n, nq, h, e).float()
        k, v = kv.view(n, nk, 2, h, e).unbind(2)
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
        """The layer on the queries' inputs ``x`` over the keys' inputs
        ``src`` (see :meth:`attend`)."""
        return self.cached(x, self.keys(src, dtype), dist, valid, rel, dtype)

    def cached(self, x, kv, dist, valid, rel, dtype):
        """The layer over the keys' projection ``kv`` (:meth:`keys`), as
        the rollout's key/value cache holds it."""
        y = self.gate1(x, torch.relu(self.attend(x, kv, dist, valid, rel,
                                                 dtype)), dtype)
        mlp = linear(torch.relu(linear(self.ln2(y), self.mlp1, dtype)),
                     self.mlp2, dtype).float()
        return self.gate2(y, torch.relu(mlp), dtype)


class KVCache:
    """The rollout's key/value cache of one carry's rings: ``kv[l]`` is
    ``layers[l].keys(rings[l])``, (N, slots, 2 * heads * head_dim) in the
    core's dtype, built in the span ``gtrxl.kv_refresh``.  It is not a
    buffer: it stays out of the state dict, and a copy of the core leaves
    it behind.  On a card it also holds one CUDA graph of the cached step
    on its rings and caches, captured at its second step.  The graph reads
    the core's weights where they lie, so an optimizer's step in place
    reaches it; moving the core moves ``ln1`` and ``kv`` too, which
    rebuilds the cache and so the graph."""

    def __init__(self, core, rings, state):
        with span("gtrxl.kv_refresh"):
            self.kv = [layer.keys(ring, core.dtype)
                       for layer, ring in zip(core.layers, rings)]
        self.rings = [weakref.ref(ring) for ring in rings]
        self.state = state  # GTrXL._kv_state after its last step
        self.steps = 0
        self.graph = self.inputs = self.outputs = None

    def holds(self, rings, state):
        """Whether the cache is that of ``rings`` in ``state``."""
        return self.state == state and all(
            ref() is ring for ref, ring in zip(self.rings, rings))

    def replay(self, core, x, rings, length, head):
        """``core._layers`` on the caches as a replay of the graph (its
        inputs copied in, its outputs copied out); captures the graph
        first where there is none yet, after an eager step has made any
        lazy set-up of the step's kernels."""
        if self.graph is None:
            self.inputs = (x.clone(), length.clone(), head.clone())
            stream = torch.cuda.Stream(x.device)
            stream.wait_stream(torch.cuda.current_stream(x.device))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                # Thread-local: the trainer's bank refresh may use the
                # device from its own thread meanwhile.
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    static_x, static_length, static_head = self.inputs
                    self.outputs = core._layers(static_x, rings, self.kv,
                                                static_length, static_head)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(x.device).wait_stream(stream)
        for static, value in zip(self.inputs, (x, length, head)):
            static.copy_(value)
        self.graph.replay()
        return tuple(out.clone() for out in self.outputs)


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
        self._kv = None  # the rollout's KVCache

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
        detached values: the update trains through :meth:`segment`.

        Without grad the keys and values come from the key/value cache
        (:class:`KVCache`): the step projects only the slot it writes, and
        on a card each step after the cache's first replays one CUDA graph
        of the step.  With grad it projects the whole ring, so that
        gradients reach the projection."""
        *rings, length, head = carry
        # Inference tensors keep no version counter for the cache to read.
        cached = not (torch.is_grad_enabled()
                      or torch.is_inference_mode_enabled())
        with span("gtrxl.core"):
            if not cached:
                x, length, head = self._layers(x, rings, None, length, head)
            else:
                cache = self._kv_cache(rings)
                if x.is_cuda and cache.steps:
                    x, length, head = cache.replay(self, x, rings, length,
                                                   head)
                else:
                    x, length, head = self._layers(x, rings, cache.kv,
                                                   length, head)
                cache.steps += 1
                cache.state = self._kv_state(rings)
        return (*rings, length, head), x

    def _layers(self, x, rings, caches, length, head):
        """The body of :meth:`step`, keys and values from ``caches`` where
        given (the slot written also written there), else projected from
        the whole ring.  Returns (output, length', head')."""
        n, slots = x.shape[0], rings[0].shape[1]
        rows = torch.arange(n, device=x.device)
        age = (head[:, None] - torch.arange(slots, device=x.device)) % slots
        valid = (age <= length[:, None])[:, None]
        dist = age.clamp(max=self.memory)[:, None]
        x = x[:, None]
        for layer, ring, kv in zip(self.layers, rings,
                                   caches or [None] * len(rings)):
            new = x.detach().to(ring.dtype)
            with span("gtrxl.memory"):
                ring[rows, head] = new[:, 0]
                if kv is not None:
                    kv[rows, head] = layer.keys(new, self.dtype)[:, 0]
            if kv is None:
                kv = layer.keys(ring, self.dtype)
            x = layer.cached(x, kv, dist, valid, self.rel, self.dtype)
        return (x[:, 0], (length + 1).clamp(max=self.memory),
                (head + 1) % slots)

    def _kv_cache(self, rings):
        """The :class:`KVCache` of ``rings``, rebuilt where it was built
        for other rings, where a ring has been written since other than by
        a step that kept the cache, or where a layer's ``ln1`` or ``kv``
        parameters have changed (an optimizer's step bumps their version
        counters): in training, at the rollout's first step, the update's
        :meth:`segment` having dropped it."""
        state, cache = self._kv_state(rings), self._kv
        if cache is not None and cache.holds(rings, state):
            return cache
        cache = self._kv = None  # the stale cache goes before the new one
        self._kv = KVCache(self, rings, state)
        return self._kv

    def _kv_state(self, rings):
        """What the key/value cache depends on: the rings and each layer's
        ``ln1`` and ``kv`` parameters, by storage and version counter."""
        params = [p for layer in self.layers
                  for p in (layer.ln1.weight, layer.ln1.bias, layer.kv.weight)]
        return [(t.data_ptr(), t._version) for t in params + list(rings)]

    def __getstate__(self):
        """A pickle or a copy leaves the key/value cache behind."""
        return dict(super().__getstate__(), _kv=None)

    def segment(self, x, done, carry0):
        """Replay a segment of embedded features ``x`` (T, M, D) float32
        with its ``done`` (T, M) from ``carry0``, the carry before its first
        step: query ``t`` attends to the segment's steps up to ``t`` and to
        the ring's slots ``t + age <= memory`` back, within its episode.
        Returns (T, M, D) float32."""
        # The update replays before each change of the weights, so the
        # key/value cache's memory serves its activations instead.
        self._kv = None
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
