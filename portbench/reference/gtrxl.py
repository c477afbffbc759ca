"""GTrXL plainly: the gated Transformer-XL core of Parisotto et al.,
"Stabilizing Transformers for Reinforcement Learning" (ICML 2020,
arXiv:1910.06764), on SafeLife's conv trunk, in float32 with TF32 off.

Per layer, ``E`` its input and ``M`` its memory (its inputs at the last
``memory`` steps, kept as a time-ordered window, oldest first)::

    Y_ = RelMHA(LN(E), LN([M, E]))
    Y  = g(E, relu(Y_));  E_ = MLP(LN(Y));  E' = g(Y, relu(E_))

The relative score of a query ``i`` and a key ``j`` is Transformer-XL's
(Dai et al. 2019, arXiv:1901.02860, section 3.3) ``(q_i + u).k_j + (q_i +
v).W_R R(i - j)``, scaled by ``1 / sqrt(head_dim)``, ``R`` the sines and
cosines of the distance; the gate is ``g(x, y) = (1 - z) x + z tanh(W_g y
+ U_g (r x))`` with ``r = sigmoid(W_r y + U_r x)`` and ``z = sigmoid(W_z
y + U_z x - b_g)``.

Departures from the paper, each stated in the configuration too:

- the embedding is a dense layer from SafeLife's v1.0 conv trunk (1600
  features) to ``d_model``, not the paper's ResNet;
- episodes end inside a segment: a step attends to itself and at most
  ``memory`` steps before it, none from before its episode's start (the
  paper's memory carries across; an episode's start empties it here);
- the update replays each stored segment against the memory the rollout
  started from (the paper trains on unrolls the same way; the window of
  every query is the acting window);
- head dimension 64 and MLP width 1024 are assumed; the q, k, v, r and
  output projections and the gates' products have no bias.

``precision="low"`` is the control: the trunk as ``learner.Net`` makes it
(int8), and every product of the core with its inputs and weights
rounded to int8 forward and its output's gradient rounded backward.
``fault`` plants what a wrong ring would do: ``"shift"`` places every
memory key one step further than it is (and the oldest out of the
window), ``"no_reset"`` keeps the memory across an episode's end.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import learner as L


def sinusoid(n, dim, device):
    inv = 1.0 / 10000 ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    angle = torch.arange(n, dtype=torch.float64)[:, None] * inv
    return torch.cat([angle.sin(), angle.cos()], -1).float().to(device)


class GTrXLNet(L.Net):
    """The configuration's net on a dict of float32 parameters named as
    the program's state dict names them.  Its carry is ``(M_0, ...,
    M_{L-1}, length)``: each layer's window (N, memory, d_model), oldest
    first, and each environment's valid length."""

    def __init__(self, config, params, precision="f32", fault=None):
        super().__init__(config, params, precision)
        self.core = config["core"]
        self.fault = fault
        self.n_mem = self.core["memory"]

    # -- products ----------------------------------------------------------

    def _mm(self, x, w, b=None):
        if not self.low:
            return F.linear(x, w, b)
        return L._LowGrad.apply(F.linear(L._low(x), L._low(w), b))

    def _einsum(self, eq, a, b):
        if not self.low:
            return torch.einsum(eq, a, b)
        return L._LowGrad.apply(torch.einsum(eq, L._low(a), L._low(b)))

    def _ln(self, x, name):
        p = self.p
        return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                            p[name + ".bias"])

    def _gate(self, name, x, y):
        p = self.p
        d = x.shape[-1]
        wy = self._mm(y, p[name + ".w.weight"])
        ux = self._mm(x, p[name + ".u.weight"])
        r = torch.sigmoid(wy[..., :d] + ux[..., :d])
        z = torch.sigmoid(wy[..., d:2 * d] + ux[..., d:] - p[name + ".bias"])
        h = torch.tanh(wy[..., 2 * d:]
                       + self._mm(r * x, p[name + ".ug.weight"]))
        return (1.0 - z) * x + z * h

    # -- one layer ---------------------------------------------------------

    def layer(self, i, x, src, dist, valid):
        """Layer ``i`` on the queries' inputs ``x`` (N, Q, D) over the keys'
        inputs ``src`` (N, K, D), at distances ``dist`` (Q, K) where
        ``valid`` (N, Q, K)."""
        p, c = self.p, self.core
        pre = f"core.layers.{i}."
        n, nq, _ = x.shape
        nk = src.shape[1]
        h, e = c["heads"], c["head_dim"]
        q = self._mm(self._ln(x, pre + "ln1"), p[pre + "q.weight"])
        q = q.view(n, nq, h, e)
        kv = self._mm(self._ln(src, pre + "ln1"), p[pre + "kv.weight"])
        k, v = kv.view(n, nk, 2, h, e).unbind(2)
        table = sinusoid(self.n_mem + 2, c["d_model"], x.device)
        r = self._mm(table, p[pre + "r.weight"]).view(-1, h, e)[
            dist.clamp(max=self.n_mem + 1)]
        scores = (self._einsum("nqhe,nkhe->nhqk", q + p[pre + "u"], k)
                  + self._einsum("nqhe,qkhe->nhqk", q + p[pre + "v"], r))
        scores = (scores / math.sqrt(e)).masked_fill(~valid[:, None],
                                                     float("-inf"))
        attn = self._einsum("nhqk,nkhe->nqhe", torch.softmax(scores, -1), v)
        y = self._mm(attn.reshape(n, nq, h * e), p[pre + "o.weight"])
        y = self._gate(pre + "gate1", x, torch.relu(y))
        m = torch.relu(self._mm(self._ln(y, pre + "ln2"),
                                p[pre + "mlp1.weight"], p[pre + "mlp1.bias"]))
        m = self._mm(m, p[pre + "mlp2.weight"], p[pre + "mlp2.bias"])
        return self._gate(pre + "gate2", y, torch.relu(m))

    # -- the net -----------------------------------------------------------

    def features(self, obs):
        x = obs.reshape((-1,) + tuple(obs.shape[-3:])).permute(0, 3, 1, 2)
        x = x.to(torch.float32)
        for l in self.convs:
            x = self._trunk_layer(x, l["name"], F.conv2d, stride=l["stride"])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self._mm(x, self.p["embed.weight"], self.p["embed.bias"])

    def initial_carry(self, batch, device):
        c = self.core
        return tuple(torch.zeros(batch, self.n_mem, c["d_model"],
                                 device=device)
                     for _ in range(c["layers"])) + (
            torch.zeros(batch, dtype=torch.int64, device=device),)

    def reset(self, carry, done):
        if self.fault == "no_reset":
            return carry
        return carry[:-1] + (carry[-1].masked_fill(done, 0),)

    def _memory_keys(self, length, queries):
        """Distances (Q, memory) and validity (N, Q, memory) of the window's
        slots for queries 0 .. Q-1 of a segment starting after it."""
        dev = length.device
        back = self.n_mem - torch.arange(self.n_mem, device=dev)  # to step 0
        t = torch.arange(queries, device=dev)
        dist = t[:, None] + back[None]
        if self.fault == "shift":
            dist = dist + 1
        valid = ((back <= length[:, None])[:, None]
                 & (dist <= self.n_mem)[None])
        return dist, valid

    def forward(self, obs, carry=None):
        """One step: ((logits, values), carry')."""
        *mems, length = carry
        x = self.features(obs)[:, None]
        mdist, mvalid = self._memory_keys(length, 1)
        dist = torch.cat([mdist, torch.zeros_like(mdist[:, :1])], 1)
        valid = torch.cat([mvalid, torch.ones_like(mvalid[..., :1])], 2)
        new = []
        for i, mem in enumerate(mems):
            new.append(torch.cat([mem[:, 1:], x], 1))
            x = self.layer(i, x, torch.cat([mem, x], 1), dist, valid)
        logits, values = self.heads(x[:, 0])
        length = (length + 1).clamp(max=self.n_mem)
        return (logits, values), tuple(new) + (length,)

    def replay(self, obs_seq, done_seq, carry0):
        """(T, M) sequences from ``carry0``; a query attends to the window's
        slots within ``memory`` steps and to the segment's steps up to
        itself, within its episode."""
        steps, batch = done_seq.shape
        *mems, length = carry0
        x = self.features(obs_seq).reshape(steps, batch, -1).transpose(0, 1)
        done = done_seq.to(torch.int64)
        episode = (done.cumsum(0) - done).T                 # (M, T)
        if self.fault == "no_reset":
            episode = torch.zeros_like(episode)
        mdist, mvalid = self._memory_keys(length, steps)
        mvalid = mvalid & (episode == 0)[:, :, None]
        t = torch.arange(steps, device=x.device)
        sdist = t[:, None] - t[None]
        svalid = (((sdist >= 0) & (sdist <= self.n_mem))[None]
                  & (episode[:, :, None] == episode[:, None]))
        dist = torch.cat([mdist, sdist.clamp(min=0)], 1)
        valid = torch.cat([mvalid, svalid], 2)
        for i, mem in enumerate(mems):
            x = checkpoint(self.layer, i, x, torch.cat([mem, x], 1), dist,
                           valid, use_reentrant=False)
        return self.heads(x.transpose(0, 1))


def learner(config, weights, precision="f32", fault=None):
    """``learner.Learner`` of the configuration's PPO on the GTrXL net."""
    lrn = L.Learner(config, weights, precision)
    lrn.net = GTrXLNet(config, lrn.params, precision, fault)
    return lrn
