"""What the benchmark keeps of the program's run for the reference to
judge: at the env's boundary in training, at the policy's in evaluation.
Everything kept is an output of the program or the state of the run's
generator where a draw begins."""

import torch

from portbench.reference import env as E


def recorder(wrapper_base):
    """A class wrapping the program's training env that keeps each step's
    actions, the fresh levels its resets draw from, the observations'
    fingerprints, rewards and ``done``, and the generator's state after
    the step (``wrapper_base``: the program's env wrapper class, so that
    the program sees through it to its env)."""

    class Recorder(wrapper_base):
        def __init__(self, env):
            super().__init__(env)
            self.batches = []

        def begin(self):
            self.batches.append(dict(steps=[], fresh_idx=None,
                                     gen_after=None))

        def step(self, state, bank, action, generator=None, **kw):
            cur = self.batches[-1]
            fresh = kw.get("fresh_levels")
            if fresh is not None and cur["fresh_idx"] is None:
                cur["fresh_idx"] = fresh[0].clone()
            state, ts = self.env.step(state, bank, action, generator, **kw)
            cur["steps"].append(dict(
                action=action.clone(), digest=E.digest(ts.obs),
                reward=ts.reward.clone(), done=ts.done.clone()))
            cur["gen_after"] = generator.get_state()
            return state, ts

    return Recorder


class RecordingPolicy:
    """The program's policy, with each call's observation fingerprints,
    generator states (before and after its draw) and the actions it
    returned kept for the suites that ``begin`` marks to keep; a suite not
    kept is played with nothing added to the policy's work."""

    def __init__(self, policy):
        self.policy = policy
        self.suites = {}
        self.steps = None
        self.calls = 0

    def begin(self, key, keep=True):
        self.steps = self.suites.setdefault(key, []) if keep else None

    def __call__(self, obs, generator=None):
        self.calls += 1
        if self.steps is None:
            return self.policy(obs, generator=generator)
        before = generator.get_state()
        action = self.policy(obs, generator=generator)
        self.steps.append((E.digest(obs), before, action,
                           generator.get_state()))
        return action
