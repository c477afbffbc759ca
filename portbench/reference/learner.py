"""SafeLife's PPO learner, plainly: the policy nets, multi-discount GAE,
the clipped PPO loss and the clipped Adam step, in float32 with TF32 off.

The nets are SafeLife v1.0's (``training/safelife_ppo.py:141-202`` of the
reference; arXiv:1912.01217): the 15-channel one-hot 33x33 view through
conv 32x5x5/2, conv 64x3x3/2, conv 64x3x3/1 (VALID, relu), flattened in
(h, w, c) order, then dense 512 (relu) or an LSTM of 512 units, then 9
policy logits and one value a discount.  The loss is the reference's
(``training/ppo.py:242-305``): ``|A| * elu-rectified(sign(A) * (1 -
pi / pi_old), eps)``, the clipped value loss scaled by the smoothed
pseudo-entropy ``spe`` (a trained scalar pulled toward the minibatch's mean
pseudo-entropy), and an entropy bonus on the clipped mean pseudo-entropy.
The gradient of every parameter and ``spe`` is clipped to a global norm,
then Adam steps.  Minibatches are whole environments: each epoch draws
``torch.randperm`` of the environments from the run's generator, and
minibatch ``k`` takes the ``k``-th slice of it.

``precision="low"`` is the control: the trunk's layers in int8 (one
symmetric scale a tensor) forward and backward, and the float32 layers in
TF32, the next step down from what the configuration states (int8 for
the bf16 trunk; float8 e4m3 separated the CNN's readings less, PERF.md).
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision_mode(precision):
    """TF32 off for "f32", on for the control's float32 layers."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "low"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_low(x):
    """``x`` rounded to int8, one symmetric scale a tensor."""
    scale = x.abs().amax().clamp(min=1e-12) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class _LowGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded to int8 backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _round_low(grad)


def _low(x):
    """``x`` rounded to int8 forward, its gradient passed straight through
    (the layer's own backward reads the rounded values)."""
    return x + (_round_low(x.detach()) - x.detach())


class Net:
    """The configuration's net on a dict of float32 parameter tensors,
    named as the configuration's ``layers`` name them."""

    def __init__(self, config, params, precision="f32"):
        self.cfg = config
        self.p = params
        self.low = precision == "low"
        self.convs = [l for l in config["layers"] if l["kind"] == "conv"]
        self.recurrent = any(l["kind"] == "lstm" for l in config["layers"])

    def _trunk_layer(self, x, name, op, **kw):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if not self.low:
            return torch.relu(op(x, w, b, **kw))
        # Forward and backward in int8: inputs and weights rounded, and
        # the output's gradient rounded before the layer's backward.
        return torch.relu(_LowGrad.apply(op(_low(x), _low(w), b, **kw)))

    def features(self, obs):
        """(..., vh, vw, C) uint8 -> (N, features) float32."""
        x = obs.reshape((-1,) + tuple(obs.shape[-3:])).permute(0, 3, 1, 2)
        x = x.to(torch.float32)
        for l in self.convs:
            x = self._trunk_layer(x, l["name"], F.conv2d, stride=l["stride"])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if not self.recurrent:
            x = self._trunk_layer(x, "dense", F.linear)
        return x

    def heads(self, h):
        p = self.p
        return (F.linear(h, p["policy.weight"], p["policy.bias"]),
                F.linear(h, p["value.weight"], p["value.bias"]))

    def cell(self, x, carry):
        p = self.p
        c, h = carry
        gates = (x @ p["lstm.weight_ih"].T + p["lstm.bias_ih"]
                 + h @ p["lstm.weight_hh"].T + p["lstm.bias_hh"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h

    def forward(self, obs, carry=None):
        """(logits, values), and the next carry for the LSTM net."""
        lead = tuple(obs.shape[:-3])
        x = self.features(obs)
        if self.recurrent:
            carry, x = self.cell(x, carry)
        logits, values = self.heads(x)
        return (logits.reshape(lead + (-1,)),
                values.reshape(lead + (-1,))), carry

    def replay(self, obs_seq, done_seq, carry0):
        """(T, M) sequences of the LSTM net from ``carry0``, the carry
        zeroed after each step where ``done``."""
        steps, batch = done_seq.shape
        x = self.features(obs_seq).reshape(steps, batch, -1)
        carry, hidden = carry0, []
        for xt, d in zip(x, done_seq):
            carry, h = self.cell(xt, carry)
            keep = (~d).to(torch.float32)[:, None]
            carry = (carry[0] * keep, carry[1] * keep)
            hidden.append(h)
        return self.heads(torch.stack(hidden))


def gae(ppo, reward, done, value):
    """(returns, advantages), (T, B, n_gamma), of rewards clipped to
    ``reward_clip`` with bootstrapped values (T + 1, B, n_gamma)."""
    gamma = torch.tensor(ppo["gamma"], dtype=torch.float32,
                         device=value.device)
    reward = reward.clamp(-ppo["reward_clip"], ppo["reward_clip"])[..., None]
    mask = (~done)[..., None].to(torch.float32)
    delta = reward + gamma * mask * value[1:] - value[:-1]
    ret, adv = value[-1], torch.zeros_like(value[-1])
    returns, advantages = [], []
    for t in reversed(range(reward.shape[0])):
        ret = reward[t] + gamma * mask[t] * ret
        adv = delta[t] + ppo["lmda"] * gamma * mask[t] * adv
        returns.append(ret)
        advantages.append(adv)
    return torch.stack(returns[::-1]), torch.stack(advantages[::-1])


def loss_terms(ppo, logits, value, spe, action, old_pi, old_value, returns,
               advantages):
    """(total loss, dict of its terms) over a minibatch."""
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    a_pi = probs.gather(-1, action[..., None])[..., 0]
    pw = torch.tensor(ppo["policy_discount_weights"], device=dev)
    vw = torch.tensor(ppo["value_discount_weights"], device=dev)
    x = torch.sign(advantages) * (1.0 - a_pi / old_pi)[..., None]
    eps = ppo["eps_clip"]
    # Ties split the gradient half and half (torch.minimum / maximum): on
    # the first minibatch pi == pi_old and the rectifier sits on its kink.
    zero = torch.zeros_like(x)
    rect = (eps * (torch.exp(torch.minimum(x / eps, zero)) - 1.0)
            + torch.maximum(x, zero))
    policy = torch.mean(advantages.abs() * rect * pw)
    entropy = torch.mean(-torch.sum(probs * torch.log(probs + 1e-12), -1))
    pe = torch.sum(probs * (1.0 - probs), dim=-1).detach()
    avg_pe = pe.mean()
    v_clip = old_value + torch.clamp(value - old_value, -eps, eps)
    vloss = torch.maximum((value - returns) ** 2, (v_clip - returns) ** 2)
    vloss = 0.5 * torch.mean(vloss * spe.detach() * vw)
    ent = -ppo["entropy_reg"] * torch.clamp(avg_pe, max=ppo["entropy_clip"])
    ent = ent + 0.5 * (avg_pe - spe) ** 2
    total = policy + ppo["vf_coef"] * vloss + ent
    return total, dict(policy_loss=policy.detach(), value_loss=vloss.detach(),
                       entropy=entropy.detach())


SUPPORTED = dict(value_grad_rescaling="smooth", policy_rectifier="elu",
                 rescale_policy_eps=False, entropy_grad=False,
                 lr_decay_steps=0)


def check_ppo(ppo):
    """The reference covers the options SafeLife's PPO defaults use."""
    for key, want in SUPPORTED.items():
        if ppo[key] != want:
            raise ValueError(f"the reference learner has {key}={want!r}, "
                             f"the configuration {ppo[key]!r}")


class Learner:
    """The parameters, ``spe`` and Adam of one run, stepped as the
    configuration's PPO steps them."""

    def __init__(self, config, weights, precision="f32"):
        self.ppo = config["ppo"]
        check_ppo(self.ppo)
        self.precision = precision
        self.params = {
            k: v.detach().clone().float().requires_grad_(k != "lstm.bias_ih")
            for k, v in weights.items()}
        self.spe = torch.ones((), device=next(iter(weights.values())).device,
                              requires_grad=True)
        self.net = Net(config, self.params, precision)
        self.names = [k for k, v in self.params.items() if v.requires_grad]
        self.leaves = [self.params[k] for k in self.names] + [self.spe]
        self.names.append("spe")
        self.adam = torch.optim.Adam(self.leaves, lr=self.ppo["learning_rate"],
                                     eps=self.ppo["adam_epsilon"],
                                     foreach=False)
        self.losses = []        # each step's total loss
        self.first_moment = None  # Adam's exp_avg after the first step

    def step(self, loss):
        """Backward, global-norm clip, one Adam step; returns the grads
        as Adam got them."""
        for p in self.leaves:
            p.grad = None
        loss.backward()
        grads = [p.grad for p in self.leaves]
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            cap = self.ppo["max_gradient_norm"]
            for g in grads:
                g.copy_(torch.where(norm < cap, g, g / norm * cap))
        self.adam.step()
        return grads

    def exp_avg(self):
        """{leaf: Adam's first moment}."""
        return {n: self.adam.state[p]["exp_avg"].detach().clone()
                for n, p in zip(self.names, self.leaves)}

    def update(self, traj, returns, advantages, generator, carry0=None):
        """The epochs of minibatch steps on one batch; returns the last
        minibatch's loss terms and each leaf's summed squared gradient."""
        ppo = self.ppo
        steps, batch = traj["action"].shape
        mb = batch // ppo["num_minibatches"]
        dev = traj["action"].device
        sq = {n: 0.0 for n in self.names}
        for _ in range(ppo["epochs_per_batch"]):
            perm = torch.randperm(batch, generator=generator, device=dev)
            for k in range(ppo["num_minibatches"]):
                idx = perm[k * mb:(k + 1) * mb]
                with precision_mode(self.precision):
                    if carry0 is None:
                        (logits, value), _ = self.net.forward(
                            traj["obs"][:, idx])
                    else:
                        logits, value = self.net.replay(
                            traj["obs"][:, idx], traj["done"][:, idx],
                            tuple(c[idx] for c in carry0))
                    loss, terms = loss_terms(
                        ppo, logits, value, self.spe, traj["action"][:, idx],
                        traj["old_pi"][:, idx], traj["value"][:-1, idx],
                        returns[:, idx], advantages[:, idx])
                    grads = self.step(loss)
                self.losses.append(float(loss.detach()))
                if self.first_moment is None:
                    self.first_moment = self.exp_avg()
                for n, g in zip(self.names, grads):
                    sq[n] = sq[n] + g.detach().double().square().sum()
        return terms, sq
