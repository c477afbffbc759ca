"""The learner of a data-parallel run, plainly: ``learner.Learner`` whose
minibatches take each data shard's rows as the program's ranks take
them.

The batch is ``shards`` contiguous blocks of environments, one a rank.
Each epoch draws one ``torch.randperm`` of a block's environments per
shard, in shard order, from the one generator; minibatch ``k`` is rows
``[k * m, (k + 1) * m)`` of every shard's permutation, shard-major.  One
loss over those rows, every mean taken over all of them, is what the
ranks' all-reduced means and averaged gradients make of it: the
reference computes that loss on one card.

``exchange=False`` is the fault that only a run over several cards can
have, the gradient exchange left out: each minibatch's loss, and so its
gradient, comes from shard 0's rows alone, the rows rank 0 steps on when
no all-reduce joins the others' to its own.
"""

import torch

from . import learner as L


class ShardedLearner(L.Learner):

    def __init__(self, config, weights, shards, precision="f32",
                 exchange=True):
        super().__init__(config, weights, precision)
        self.shards = shards
        self.exchange = exchange

    def update(self, traj, returns, advantages, generator, carry0=None):
        """``Learner.update`` with the data shards' minibatch rows."""
        ppo = self.ppo
        steps, batch = traj["action"].shape
        local = batch // self.shards
        mb = local // ppo["num_minibatches"]
        dev = traj["action"].device
        first = torch.arange(0, batch, local, device=dev)[:, None]
        joined = self.shards if self.exchange else 1
        sq = {n: 0.0 for n in self.names}
        for _ in range(ppo["epochs_per_batch"]):
            perms = torch.stack([
                torch.randperm(local, generator=generator, device=dev)
                for _ in range(self.shards)])
            for k in range(ppo["num_minibatches"]):
                idx = (perms[:joined, k * mb:(k + 1) * mb]
                       + first[:joined]).reshape(-1)
                with L.precision_mode(self.precision):
                    (logits, value), _ = self.net.forward(traj["obs"][:, idx])
                    loss, terms = L.loss_terms(
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
