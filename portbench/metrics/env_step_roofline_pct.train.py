"""The env step's least time over the device time of the kernels launched
inside BatchedSafeLifeEnv.step, in training."""

from portbench.harness import readers


def read(raw):
    return readers.env_step_roofline(raw, "train")
