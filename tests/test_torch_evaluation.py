"""``Trainer`` with frozen-suite evaluation and with the recurrent policy,
on the CPU at a tiny size: evaluations fall on the ``eval_every`` grid of
the global step and the last batch is evaluated unless that step already
was; ``eval.yaml`` and the ``eval/*`` scalars are written; a recurrent run
trains, checkpoints, restores, reloads through ``load_policy`` as a
recurrent policy and drives ``run_benchmark`` with its carry."""

import numpy as np
import pytest
import torch
import yaml

from safelife_torch.benchmarking import run_benchmark
from safelife_torch.levels import synth
from safelife_torch.training import driver, ppo

torch.set_num_threads(1)

VIEW = (17, 17)


class Scalars:
    """A summary writer that keeps what it is given."""

    def __init__(self):
        self.seen = []

    def add_scalar(self, tag, value, step):
        self.seen.append((tag, float(value), step))

    def flush(self):
        pass


def _trainer(logdir=None, **kw):
    cfg = dict(num_envs=8, total_steps=64, report_every=32, save_every=32,
               view_shape=VIEW, time_limit=5, logdir=logdir,
               record_videos=False)
    cfg.update(kw)
    tr = driver.Trainer(
        driver.TrainerConfig(**cfg),
        ppo.PPOConfig(steps_per_env=4, num_minibatches=2, epochs_per_batch=1),
        bank=synth.synth_bank(4, h=13, w=13, device="cpu"), device="cpu")
    if tr.writer is not None:
        tr.writer.close()  # leave no event-file thread behind
    tr.writer = Scalars()
    return tr


@pytest.mark.parametrize("eval_every,total,steps", [
    (64, 64, [64]),          # the last batch is on the grid: no second eval
    (0, 96, [32, 64, 96]),   # eval_every 0: the checkpoint grid
    (64, 96, [64, 96]),      # the last batch off the grid: a final eval
])
def test_trainer_evaluates_on_the_step_grid(tmp_path, eval_every, total,
                                            steps):
    suite = synth.synth_bank(3, h=13, w=13, device="cpu")
    tr = _trainer(str(tmp_path), eval_suite=suite, eval_every=eval_every,
                  eval_side_effect_samples=4)
    evaluated = []
    evaluate = tr.evaluate
    tr.evaluate = lambda: evaluated.append(tr.global_step()) or evaluate()
    tr.train(total_steps=total)
    assert evaluated == steps
    records = yaml.safe_load((tmp_path / "eval.yaml").read_text())
    assert len(records) == 3 * len(steps)
    assert all(r["name"].startswith("level-") for r in records)
    assert all(isinstance(v, list) and len(v) == 2
               for r in records for v in r["side_effects_by_type"].values())
    tags = {tag for tag, _, step in tr.writer.seen if step in steps}
    assert {"eval/performance", "eval/reward", "eval/length",
            "eval/side_effects", "eval/dead_start"} <= tags
    assert tr.dead_start_evals == 0


def test_evaluate_without_a_suite_is_a_no_op():
    assert _trainer().evaluate() is None


def test_recurrent_trainer_end_to_end(tmp_path):
    """``recurrent=True`` drives the whole loop: RecurrentPPO batches with
    the carry, checkpoints, the recurrent eval, a restore, and
    ``load_policy`` as a recurrent policy that drives a suite eval."""
    bank = synth.synth_bank(4, h=13, w=13, device="cpu")
    tr = _trainer(str(tmp_path), recurrent=True, eval_suite=bank,
                  eval_side_effect_samples=0, time_limit=20)
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    tr.train(total_steps=64)
    assert tr.global_step() == 64 and tr.train_state.update_step == 2
    assert [tuple(c.shape) for c in tr.carry] == [(8, 512)] * 2
    assert any(c.any() for c in tr.carry)
    after = tr.net.state_dict()
    changed = {k for k in after if not torch.equal(before[k], after[k])}
    assert changed == set(after) - {"lstm.bias_ih"}
    assert (tmp_path / "eval.yaml").read_text().count("- {name:") == 8

    again = _trainer(str(tmp_path), recurrent=True)
    assert again.restore_checkpoint() and again.global_step() == 64
    for k, v in after.items():
        assert torch.equal(again.net.state_dict()[k], v), k

    policy, view = driver.load_policy(str(tmp_path), device="cpu")
    assert view == VIEW and policy.recurrent
    own = tr.policy_fn()
    carry = policy.init_carry(8)
    actions, carry2 = policy(tr.obs, carry, torch.Generator().manual_seed(0))
    want, _ = own(tr.obs, own.init_carry(8), torch.Generator().manual_seed(0))
    assert torch.equal(actions, want)
    assert carry2[1].abs().sum() > 0
    results = run_benchmark(bank, policy, view_shape=view, time_limit=20,
                            chunk=10)
    assert len(results["performance"]) == bank.num_levels
    assert np.isfinite(results["reward"]).all()

    # A bank switch starts fresh episodes, and a fresh carry.
    tr.bank_schedule = [(0, bank)]
    tr._maybe_switch_bank()
    assert not any(c.any() for c in tr.carry)
