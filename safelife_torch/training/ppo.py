"""PPO on the device: batched rollout, multi-discount GAE, clipped update
(port of ``safelife_tpu.training.ppo``, feed-forward and recurrent).

The rollout steps the batched (wrapped) env ``steps_per_env`` times with
actions drawn from the policy, GAE is a reverse loop over time, and the
update runs ``epochs_per_batch`` epochs of ``num_minibatches`` Adam steps
on minibatches of whole environments.  Nothing reads a device value back
to the host inside :meth:`PPO.train_batch`.

:class:`RecurrentPPO` trains a recurrent policy (``SafeLifeLSTMNet``): the
rollout threads the LSTM carry and zeroes it where an episode ends, and
the loss replays each minibatch's sequences from the carry the rollout
started with.  Minibatches are whole environments, so sequences stay
intact (the reference's scheme, ppo.py:510-533).

Reference-faithful loss details (all optional, defaults mirror the
reference; see the JAX module for their sources):

* Policy loss via ``|A| * rect(sign(A) * (1 - pi/pi_old), eps)`` with a
  relu/elu rectifier — gradient-equivalent to the standard PPO clipped
  surrogate, with the elu giving a smooth clip.
* Optional eps rescaling by ``(1 + min_eps_rescale - pi_old)``.
* Pseudo-entropy bookkeeping: the pseudo-entropy is detached unless
  ``entropy_grad``, and a *smoothed pseudo-entropy* ``spe`` (an optimised
  parameter, updated by a quadratic tracking loss) rescales the value loss.
* Clipped value loss, multi-gamma heads with per-gamma weights.

Ties go half and half in ``max``/``min`` (``torch.maximum``), as in JAX:
on the first minibatch ``pi == pi_old`` exactly and the rectifier sits on
its kink.

Data shards (``PPOConfig.data_shards = S``): the batch is S contiguous
shards of B / S environments, each epoch every shard shuffles only its
own environments, and minibatch k takes rows ``[k * M, (k + 1) * M)`` of
each shard's permutation, shard-major (M = B / S / num_minibatches), as
the JAX learner's ``dynamic_slice_in_dim(..., axis=2).swapaxes(0, 1)``
does.  All S permutations come from the one generator, so one process
holding the S shards and S ranks holding one each (``PPO(mesh=)``, see
``safelife_torch.parallel``) take the same minibatches.  On a mesh the
loss's means are means over every rank's rows (``DataMesh.global_means``:
the entropy clip and the per-batch value rescaling read the minibatch's
global mean pseudo-entropy, as under GSPMD) and the gradient is averaged
over the ranks before the clipped Adam step.
"""

import dataclasses
from typing import Tuple

import torch

from ..env.wrappers import unwrap, unwrap_env
from ..utils.profiling import span, spanned


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: Tuple[float, ...] = (0.97,)
    lmda: float = 0.9
    policy_discount_weights: Tuple[float, ...] = (1.0,)
    value_discount_weights: Tuple[float, ...] = (1.0,)

    learning_rate: float = 3e-4
    # Linear LR decay to learning_rate * lr_final_frac over this many
    # OPTIMIZER updates (epochs x minibatches per train_batch); 0 = constant
    # LR (the reference's setting).
    lr_decay_steps: int = 0
    lr_final_frac: float = 0.1
    entropy_reg: float = 5e-2
    entropy_clip: float = 1.0
    entropy_grad: bool = False   # reference detaches the bonus
    vf_coef: float = 1.0
    max_gradient_norm: float = 1.0
    eps_clip: float = 0.1
    rescale_policy_eps: bool = False
    min_eps_rescale: float = 1e-3
    reward_clip: float = 30.0
    value_grad_rescaling: str = "smooth"  # False|'smooth'|'per_batch'|'per_state'
    policy_rectifier: str = "elu"  # 'relu' | 'elu'

    steps_per_env: int = 20
    num_minibatches: int = 4
    epochs_per_batch: int = 3
    adam_epsilon: float = 1e-6

    # Number of data-parallel shards of the env batch (the mesh's 'data'
    # axis size).  Minibatch shuffling is done independently within each
    # shard, so the epoch loop never moves trajectory data across ranks:
    # only gradients (and the loss's few means) are all-reduced.  1 = a
    # global shuffle.
    data_shards: int = 1

    @property
    def n_gamma(self):
        return len(self.gamma)


@dataclasses.dataclass(frozen=True)
class Trajectory:
    obs: torch.Tensor     # (T, B, vh, vw, C) uint8
    action: torch.Tensor  # (T, B) int64
    old_pi: torch.Tensor  # (T, B) float32 — pi_old(action), a probability
    reward: torch.Tensor  # (T, B) float32
    done: torch.Tensor    # (T, B) bool
    value: torch.Tensor   # (T+1, B, n_gamma) float32


class Optimizer:
    """Global-norm clip then Adam over the net's parameters and ``spe``,
    with optax's arithmetic: gradients at or above ``max_gradient_norm``
    are scaled by ``max_norm / norm`` (no epsilon), and the learning rate
    of update ``k`` (counted from 0) is ``optax.linear_schedule``'s."""

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=cfg.learning_rate,
                                     eps=cfg.adam_epsilon)
        self.count = 0

    def lr(self, count):
        cfg = self.cfg
        if cfg.lr_decay_steps <= 0:
            return cfg.learning_rate
        frac = 1 - min(count, cfg.lr_decay_steps) / cfg.lr_decay_steps
        end = cfg.learning_rate * cfg.lr_final_frac
        return (cfg.learning_rate - end) * frac + end

    @torch.no_grad()
    def clip(self):
        """Scale the gradients as ``optax.clip_by_global_norm``, on the
        device (no host read of the norm)."""
        max_norm = self.cfg.max_gradient_norm
        if max_norm <= 0:
            return
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for g in grads:
            g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))

    def step(self):
        """Clip the gradients, then one Adam update."""
        self.clip()
        for group in self.adam.param_groups:
            group["lr"] = self.lr(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self):
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


@dataclasses.dataclass
class TrainState:
    net: torch.nn.Module
    spe: torch.nn.Parameter   # () float32 smoothed pseudo-entropy
    optimizer: Optimizer
    update_step: int = 0      # number of train_batch updates


def make_optimizer(cfg: PPOConfig, params):
    """The clipped Adam of ``cfg`` over ``params`` (the net's and spe)."""
    return Optimizer(cfg, params)


def init_train_state(cfg: PPOConfig, net):
    """Train state of ``net`` (already on its device): ``spe`` starts at 1.
    The optimizer takes the parameters that require gradients."""
    device = next(net.parameters()).device
    spe = torch.nn.Parameter(torch.ones((), device=device))
    params = [p for p in net.parameters() if p.requires_grad] + [spe]
    return TrainState(net=net, spe=spe, optimizer=make_optimizer(cfg, params))


# ---------------------------------------------------------------------------
# Rollout
# ---------------------------------------------------------------------------

def sample_actions(logits, generator=None, shard=(0, 1)):
    """One draw per row of the categorical ``softmax(logits)``: Gumbel-max
    (as ``jax.random.categorical``) on uniforms from ``generator``, on the
    logits' device.  With ``shard=(index, count)`` the rows are shard
    ``index`` of ``count``: the uniforms are drawn for the whole batch and
    this shard's rows kept (the env's ``shard``)."""
    index, count = shard
    b = logits.shape[0]
    u = torch.rand((b * count,) + logits.shape[1:], generator=generator,
                   device=logits.device)[index * b:(index + 1) * b]
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def mask_carry(carry, done):
    """The recurrent carry with the rows of finished episodes zeroed."""
    keep = (~done).to(torch.float32)[:, None]
    return tuple(x * keep for x in carry)


@torch.no_grad()
@spanned("ppo.rollout")
def _rollout(cfg, net, env, bank, env_state, obs, carry, generator, actions,
             fresh):
    """The loop of :func:`rollout` and :func:`rollout_recurrent`; ``carry``
    None for a feed-forward net.  Returns (env_state, obs, carry, traj,
    episode stats)."""
    core = unwrap_env(env)
    if fresh is None and env.config.auto_reset:
        with span("rollout.fresh_levels"):
            fresh = core.sample_fresh_levels(
                bank, unwrap(env_state).batch_size, generator)

    def forward(obs, carry):
        if carry is None:
            return None, net(obs)
        return net(obs, carry)

    steps = []
    for t in range(cfg.steps_per_env):
        with span("rollout.policy"):
            carry, (logits, value) = forward(obs, carry)
            action = (sample_actions(logits, generator, core.shard)
                      if actions is None
                      else actions[t].to(logits.device, torch.int64))
            probs = torch.softmax(logits, dim=-1)
            old_pi = probs.gather(1, action[:, None])[:, 0]
        env_state, ts = env.step(env_state, bank, action, generator,
                                 fresh_levels=fresh)
        if carry is not None:
            carry = mask_carry(carry, ts.done)
        steps.append(dict(
            obs=obs, action=action, old_pi=old_pi, reward=ts.reward,
            done=ts.done, value=value, times_up=ts.times_up,
            episode_length=ts.episode_length,
            episode_reward=ts.episode_reward,
            perf_completed=ts.perf_completed,
            perf_possible=ts.perf_possible, level_idx=ts.level_idx,
            # Pre-reset side-effect cell count, free from the env kernels;
            # logged per finished episode like the reference's training
            # records (env_wrappers.py:195-231).
            side_effects=ts.side_effect_count))
        obs = ts.obs
    with span("rollout.policy"):
        _, (_, final_value) = forward(obs, carry)
    seq = {k: torch.stack([s[k] for s in steps]) for k in steps[0]}
    traj = Trajectory(
        obs=seq.pop("obs"), action=seq.pop("action"),
        old_pi=seq.pop("old_pi"), reward=seq.pop("reward"),
        done=seq["done"],
        value=torch.cat([seq.pop("value"), final_value[None]]))
    return env_state, obs, carry, traj, seq


def rollout(cfg: PPOConfig, net, env, bank, env_state, obs, generator=None,
            actions=None, fresh=None):
    """Collect ``cfg.steps_per_env`` lockstep steps from the batched env.

    ``env`` is a :class:`BatchedSafeLifeEnv` or a wrapper of one.  With
    auto-reset, the rollout's reset levels are gathered once up front
    (``sample_fresh_levels``) unless ``fresh`` gives them; ``actions``
    (T, B) replaces the policy's draws (to replay a recorded rollout).
    Returns (env_state, obs, Trajectory, episode stats of (T, B)).
    """
    env_state, obs, _, traj, seq = _rollout(
        cfg, net, env, bank, env_state, obs, None, generator, actions, fresh)
    return env_state, obs, traj, seq


def rollout_recurrent(cfg: PPOConfig, net, env, bank, env_state, obs, carry,
                      generator=None, actions=None, fresh=None):
    """:func:`rollout` for a recurrent ``net`` (``net(obs, carry) ->
    (carry, (logits, values))``), threading ``carry`` and zeroing it where
    an episode ends.  Returns (env_state, obs, carry, Trajectory, carry0,
    episode stats), carry0 the carry the rollout started from (the loss
    replays the sequences from it)."""
    env_state, obs, carry_out, traj, seq = _rollout(
        cfg, net, env, bank, env_state, obs, carry, generator, actions,
        fresh)
    return env_state, obs, carry_out, traj, carry, seq


# ---------------------------------------------------------------------------
# Advantages (multi-gamma GAE) — reference ppo.py:466-508
# ---------------------------------------------------------------------------

@spanned("ppo.gae")
def compute_gae(cfg: PPOConfig, reward, done, value):
    """reward/done: (T, B); value: (T+1, B, n_gamma).
    Returns (returns, advantages): (T, B, n_gamma)."""
    gamma = torch.tensor(cfg.gamma, dtype=torch.float32, device=value.device)
    lam_gamma = cfg.lmda * gamma
    if cfg.reward_clip > 0:
        reward = reward.clamp(-cfg.reward_clip, cfg.reward_clip)
    r = reward[..., None]                                # (T, B, 1)
    mask = (~done)[..., None].to(torch.float32)          # (T, B, 1)
    delta = r + gamma * mask * value[1:] - value[:-1]
    ret, adv = value[-1], torch.zeros_like(value[-1])
    returns, advantages = [], []
    for t in reversed(range(reward.shape[0])):
        ret = r[t] + gamma * mask[t] * ret
        adv = delta[t] + lam_gamma * mask[t] * adv
        returns.append(ret)
        advantages.append(adv)
    return torch.stack(returns[::-1]), torch.stack(advantages[::-1])


# ---------------------------------------------------------------------------
# Losses — reference ppo.py:242-305
# ---------------------------------------------------------------------------

def _rectifier(name):
    if name == "relu":
        return lambda x, eps: torch.maximum(x, -eps)
    if name == "elu":
        return lambda x, eps: eps * (
            torch.exp(torch.minimum(x / eps, torch.zeros_like(x))) - 1.0) \
            + torch.maximum(x, torch.zeros_like(x))
    raise ValueError(f"unknown rectifier '{name}'")


def _loss_terms(cfg: PPOConfig, logits, value, spe, action, old_pi,
                old_value, returns, advantages, rescaling, mesh=None):
    """The loss of the policy's ``logits`` and ``value`` on a minibatch
    (any leading batch layout; all reductions are full means), the value
    loss rescaled as ``rescaling`` says.  On a ``mesh`` the minibatch is
    every rank's rows: each mean is taken over all of them
    (``DataMesh.global_means``) before the terms that are not linear in
    it."""
    probs = torch.softmax(logits, dim=-1)
    a_pi = probs.gather(-1, action[..., None].to(torch.int64))[..., 0]
    dev = logits.device

    pw = torch.tensor(cfg.policy_discount_weights, dtype=torch.float32,
                      device=dev)
    vw = torch.tensor(cfg.value_discount_weights, dtype=torch.float32,
                      device=dev)

    prob_diff = torch.sign(advantages) * (1.0 - a_pi / old_pi)[..., None]
    if cfg.rescale_policy_eps:
        eps = cfg.eps_clip * (1.0 + cfg.min_eps_rescale - old_pi)[..., None]
    else:
        eps = torch.tensor(cfg.eps_clip, dtype=torch.float32, device=dev)
    rect = _rectifier(cfg.policy_rectifier)
    policy_loss = torch.mean(advantages.abs() * rect(prob_diff, eps) * pw)

    entropy = torch.mean(-torch.sum(probs * torch.log(probs + 1e-12), dim=-1))
    pseudo_entropy = torch.sum(probs * (1.0 - probs), dim=-1)
    if not cfg.entropy_grad:
        pseudo_entropy = pseudo_entropy.detach()
    avg_pe = torch.mean(pseudo_entropy)

    v_clip = old_value + torch.clamp(value - old_value, -cfg.eps_clip,
                                     cfg.eps_clip)
    value_loss = torch.maximum(
        torch.square(value - returns), torch.square(v_clip - returns))
    if rescaling == "per_state":
        value_loss = value_loss * pseudo_entropy[..., None]
    elif rescaling == "smooth":
        value_loss = value_loss * spe.detach()
    elif rescaling and rescaling != "per_batch":
        raise ValueError(f"unknown value_grad_rescaling '{rescaling}'")
    value_loss = 0.5 * torch.mean(value_loss * vw)
    if mesh is not None:
        policy_loss, value_loss, entropy, avg_pe = mesh.global_means(
            policy_loss, value_loss, entropy, avg_pe)
    if rescaling == "per_batch":
        value_loss = value_loss * avg_pe

    entropy_loss = -cfg.entropy_reg * torch.minimum(
        avg_pe, torch.tensor(cfg.entropy_clip, device=dev))
    entropy_loss = entropy_loss + 0.5 * torch.square(avg_pe.detach() - spe)

    total = policy_loss + cfg.vf_coef * value_loss + entropy_loss
    metrics = dict(
        policy_loss=policy_loss, value_loss=value_loss,
        entropy=entropy, pseudo_entropy=avg_pe,
        smoothed_pseudo_entropy=spe)
    return total, {k: v.detach() for k, v in metrics.items()}


def ppo_loss(cfg: PPOConfig, net, spe, obs, action, old_pi, old_value,
             returns, advantages, mesh=None):
    """Loss over one minibatch (any leading batch layout; all reductions
    are full means, over every rank's rows on a ``mesh``).  Returns
    (total, metrics of detached tensors)."""
    logits, value = net(obs)
    return _loss_terms(cfg, logits, value, spe, action, old_pi, old_value,
                       returns, advantages, cfg.value_grad_rescaling, mesh)


def recurrent_forward(net, obs_seq, done_seq, carry0):
    """Replay a (T, M, ...) observation sequence through the recurrent
    ``net`` from ``carry0``, zeroing the carry at episode ends.  Returns
    (logits (T, M, A), values (T, M, n_gamma)).  The trunk does not read
    the carry, so it runs once over all T * M observations; only the cell
    steps through time."""
    steps, batch = done_seq.shape
    features = net.features(obs_seq).reshape(steps, batch, -1)
    carry, hidden = carry0, []
    for x, done in zip(features, done_seq):
        carry, h = net.cell(x, carry)
        carry = mask_carry(carry, done)
        hidden.append(h)
    return net.heads(torch.stack(hidden))


def ppo_loss_recurrent(cfg: PPOConfig, net, spe, obs, done, carry0, action,
                       old_pi, old_value, returns, advantages, mesh=None):
    """:func:`ppo_loss` of a recurrent ``net``: the (T, M) sequences of
    whole environments are replayed from ``carry0`` ((M, 512) pairs).  As
    the reference's recurrent loss (safelife_tpu/training/ppo.py:512-513),
    it applies only the 'smooth' value rescaling and ignores the others."""
    logits, value = recurrent_forward(net, obs, done, carry0)
    rescaling = "smooth" if cfg.value_grad_rescaling == "smooth" else False
    return _loss_terms(cfg, logits, value, spe, action, old_pi, old_value,
                       returns, advantages, rescaling, mesh)


# ---------------------------------------------------------------------------
# One training batch: rollout + GAE + epochs x minibatches
# ---------------------------------------------------------------------------

def minibatch_rows(perms, k, mb):
    """The rows of minibatch ``k``: rows ``[k * mb, (k + 1) * mb)`` of each
    shard's permutation (``perms`` (S, B / S), shard s's environments are
    rows ``[s * B / S, (s + 1) * B / S)`` of the batch), shard-major."""
    shards, local = perms.shape
    first = torch.arange(0, shards * local, local, device=perms.device)
    return (perms[:, k * mb:(k + 1) * mb] + first[:, None]).reshape(-1)


class PPO:
    """Binds config + env into the training batch.

    Usage::

        ppo = PPO(cfg, env)
        ts = init_train_state(cfg, net)
        env_state, obs, metrics = ppo.train_batch(ts, env_state, obs, bank,
                                                  generator)

    On a ``mesh`` (``safelife_torch.parallel.mesh.DataMesh``) of more than
    one rank, each rank's env holds its data shard (``data_shards`` must
    be the world size) and the update averages the ranks' gradients.
    """

    def __init__(self, cfg: PPOConfig, env, mesh=None):
        world = mesh.world_size if mesh is not None else 1
        if cfg.data_shards < 1 or (world > 1 and cfg.data_shards != world):
            raise ValueError(f"data_shards={cfg.data_shards} on "
                             f"{world} ranks: each rank holds one shard")
        self.cfg = cfg
        self.env = env
        self.mesh = mesh

    @spanned("ppo.update")
    def _epochs(self, train_state, batch, loss_of, generator):
        """``epochs_per_batch`` epochs of ``num_minibatches`` clipped Adam
        steps on this process's ``batch`` environments; each minibatch is
        the environments ``idx`` of :func:`minibatch_rows` on fresh
        per-shard permutations, and ``loss_of(idx)`` its (loss, metrics).
        Returns the last minibatch's metrics."""
        cfg, mesh = self.cfg, self.mesh
        world = mesh.world_size if mesh is not None else 1
        held = cfg.data_shards // world  # the shards this process holds
        if batch % held:
            raise ValueError(f"{batch} environments do not divide into "
                             f"{held} data shards")
        local = batch // held
        if local % cfg.num_minibatches:
            raise ValueError(f"{local} environments a data shard do not "
                             f"divide into {cfg.num_minibatches} minibatches")
        mb = local // cfg.num_minibatches
        device = train_state.spe.device
        params = train_state.optimizer.params
        for _ in range(cfg.epochs_per_batch):
            # Every process draws every shard's permutation: the
            # generators stay in step, and each rank keeps its own.
            perms = torch.stack([
                torch.randperm(local, generator=generator, device=device)
                for _ in range(cfg.data_shards)])
            if world > 1:
                perms = perms[mesh.rank:mesh.rank + 1]
            for k in range(cfg.num_minibatches):
                with span("update.minibatch"):
                    with span("update.loss"):
                        loss, metrics = loss_of(minibatch_rows(perms, k, mb))
                    with span("update.backward"):
                        for p in params:
                            p.grad = None
                        loss.backward()
                        if mesh is not None:
                            mesh.average_gradients(params)
                    with span("update.optimizer"):
                        train_state.optimizer.step()
        return metrics

    def update(self, train_state, traj, returns, advantages, generator=None):
        """The epochs of Adam steps on T x (B / num_minibatches) whole
        environments a minibatch; returns the last minibatch's metrics."""
        data = (traj.obs, traj.action, traj.old_pi, traj.value[:-1],
                returns, advantages)
        return self._epochs(
            train_state, traj.action.shape[1],
            lambda idx: ppo_loss(self.cfg, train_state.net, train_state.spe,
                                 *(x[:, idx] for x in data), mesh=self.mesh),
            generator)

    def _finish(self, train_state, traj, returns, advantages, metrics,
                epstats):
        metrics.update(
            mean_reward=traj.reward.mean(),
            mean_return=returns.mean(dim=(0, 1)),
            mean_advantage=advantages.mean(dim=(0, 1)),
            mean_value=traj.value.mean(dim=(0, 1)),
            episodes=epstats)
        train_state.update_step += 1
        return metrics

    @spanned("ppo.train_batch")
    def train_batch(self, train_state, env_state, obs, bank, generator=None):
        """Rollout, GAE and update; returns (env_state, obs, metrics),
        metrics holding device tensors and the rollout's episode stats
        under ``episodes``."""
        cfg = self.cfg
        env_state, obs, traj, epstats = rollout(
            cfg, train_state.net, self.env, bank, env_state, obs, generator)
        returns, advantages = compute_gae(cfg, traj.reward, traj.done,
                                          traj.value)
        metrics = self.update(train_state, traj, returns, advantages,
                              generator)
        return env_state, obs, self._finish(
            train_state, traj, returns, advantages, metrics, epstats)


class RecurrentPPO(PPO):
    """PPO over a recurrent policy (``SafeLifeLSTMNet``)::

        ppo = RecurrentPPO(cfg, env)
        carry = net.initial_carry(B)
        env_state, obs, carry, metrics = ppo.train_batch(
            ts, env_state, obs, carry, bank, generator)
    """

    def update(self, train_state, traj, returns, advantages, carry0,
               generator=None):
        """The epochs of Adam steps, each minibatch's sequences replayed
        from their rows of ``carry0``; returns the last minibatch's
        metrics."""
        data = (traj.obs, traj.done)
        rest = (traj.action, traj.old_pi, traj.value[:-1], returns,
                advantages)
        return self._epochs(
            train_state, traj.action.shape[1],
            lambda idx: ppo_loss_recurrent(
                self.cfg, train_state.net, train_state.spe,
                *(x[:, idx] for x in data), tuple(c[idx] for c in carry0),
                *(x[:, idx] for x in rest), mesh=self.mesh),
            generator)

    @spanned("ppo.train_batch")
    def train_batch(self, train_state, env_state, obs, carry, bank,
                    generator=None):
        """Rollout (threading ``carry``), GAE and update; returns
        (env_state, obs, carry, metrics)."""
        cfg = self.cfg
        env_state, obs, carry, traj, carry0, epstats = rollout_recurrent(
            cfg, train_state.net, self.env, bank, env_state, obs, carry,
            generator)
        returns, advantages = compute_gae(cfg, traj.reward, traj.done,
                                          traj.value)
        metrics = self.update(train_state, traj, returns, advantages, carry0,
                              generator)
        return env_state, obs, carry, self._finish(
            train_state, traj, returns, advantages, metrics, epstats)
