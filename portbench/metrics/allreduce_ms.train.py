"""Device ms a training batch of the ops launched inside the gradient
all-reduce (``DataMesh.average_gradients``, spanned
``portbench.allreduce``; the program's span there is
``update.allreduce``) on rank 0, from the profiled stretch."""

from portbench.harness import owned


def read(raw):
    return owned.device_ms(raw, "train", "allreduce")
