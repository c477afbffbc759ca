"""Convergence of the partitioned level factories on the CPU: the JAX
package's ``gen_partitioned_levels`` and the port's, side by side, for one
task at its default 1200 iterations (not a test; tier-1 runs nothing
here).

    JAX_PLATFORMS=cpu python tests/procgen_convergence.py navigation 128 0 1

prints, for each seed, the share of levels whose pattern layers all
converged, and the pooled share of each package.  ``chip_smoke.py`` phase
11 holds the port's factory to ``REFERENCE_CONVERGENCE`` there, which this
script measures for the JAX package.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(task, levels, seeds):
    from safelife_torch.procgen import batched as tb
    from safelife_tpu.procgen import batched as jb

    torch.set_num_threads(1)
    pooled = {"jax": [], "port": []}
    for seed in seeds:
        for name in ("jax", "port"):
            t0 = time.perf_counter()
            if name == "jax":
                _, conv = jb.gen_partitioned_levels(task, levels, seed=seed)
            else:
                _, conv = tb.gen_partitioned_levels(task, levels, seed=seed,
                                                    device="cpu")
            conv = np.asarray(conv)
            pooled[name].append(conv)
            print(f"{name} {task} {levels} levels seed {seed}: converged "
                  f"{conv.mean():.4f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
    for name, convs in pooled.items():
        conv = np.concatenate(convs)
        print(f"{name} pooled: {conv.mean():.4f} of {conv.size} levels")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), [int(s) for s in sys.argv[3:]])
