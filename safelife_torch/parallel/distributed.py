"""Multi-process runtime: process groups and data-parallel scale-out (port
of ``safelife_tpu.parallel.distributed``).

* :func:`initialize` starts ``torch.distributed`` for a job of one process
  per device: NCCL on CUDA, gloo on the CPU (or for CUDA tensors, where
  the caller names it: two ranks sharing one card).
* :func:`make_global_mesh` is this rank's :class:`~.mesh.DataMesh`.
* The Trainer accepts a ``mesh``: each rank steps its block of the
  environments (boards are per device: no traffic during the rollout),
  parameters and optimizer state are replicated, and the gradient is
  all-reduced before every clipped Adam step.  Level banks are made on
  rank 0 and broadcast.

Environment-variable driven setup (for launchers)::

    SAFELIFE_COORDINATOR  host:port of process 0
    SAFELIFE_NUM_PROCS    total process count
    SAFELIFE_PROC_ID      this process's id
"""

import datetime
import logging
import os
import time

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.profiling import wait
from . import mesh as pmesh

logger = logging.getLogger(__name__)

# How long a rank waits for the others, at start and in any collective,
# before the group fails instead of hanging: long enough for rank 0's
# frozen-suite evaluation, which the other ranks wait for at a barrier.
TIMEOUT_S = 1800


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, timeout=TIMEOUT_S):
    """Join the process group (a no-op for single-process runs).

    Arguments default to the SAFELIFE_* environment variables; when no
    coordinator is given either way this returns False and nothing starts.
    ``device`` is ``cuda`` unless the caller passes another: without one,
    process ``i`` takes card ``i`` modulo the cards present (one rank per
    card).  ``backend`` defaults to NCCL on a CUDA device and to gloo on
    the CPU; a caller may name gloo for CUDA tensors (ranks that share a
    card).  Nothing switches backend on its own: NCCL failing to come up
    raises.  Every collective of the group fails after ``timeout`` seconds
    instead of waiting forever.  Returns True once the group is up (a
    first barrier has passed); the log line says how long that took.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "SAFELIFE_COORDINATOR")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes or os.environ["SAFELIFE_NUM_PROCS"])
    process_id = int(process_id if process_id is not None
                     else os.environ["SAFELIFE_PROC_ID"])
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t = time.perf_counter()
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    # The first collective brings the communicators up: every rank joined.
    dist.barrier(device_ids=[device.index] if backend == "nccl" else None)
    logger.info("process group up: rank %d/%d, %s on %s in %.3f s",
                process_id, num_processes, backend, device,
                time.perf_counter() - t)
    return True


def make_global_mesh(device=None):
    """This rank's (data, model) mesh over every process of the job."""
    return pmesh.make_mesh(device=device)


def shutdown():
    """Leave the process group (after every rank's last collective)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def scaling_report(step_fn, sizes, *, make_args, repeats=3, mode="weak"):
    """Measure wall-clock scaling of ``step_fn(*make_args(n_devices))``.

    mode="weak": work grows with ``n``; ideal time is flat, so
    ``efficiency = t_base / t_n``.
    mode="strong": work is fixed; ideal time is ``t_base * n_base / n``, so
    ``efficiency = t_base * n_base / (t_n * n)``.

    Each timed call ends when its result's CUDA work has (a
    ``torch.cuda.synchronize`` of the result's device).  Only meaningful
    where the ``n`` devices are real ones that run at once; use
    :func:`collective_stats` + :func:`dp_efficiency_model` elsewhere.

    Returns a list of dicts: {devices, time, efficiency}.
    """
    results = []
    for n in sizes:
        args = make_args(n)
        wait(step_fn(*args))  # warm up
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            wait(step_fn(*args))
            best = min(best, time.perf_counter() - t0)
        results.append({"devices": n, "time": best})
    base = results[0]
    for r in results:
        if mode == "weak":
            r["efficiency"] = base["time"] / r["time"]
        else:
            r["efficiency"] = (base["time"] * base["devices"]
                               / (r["time"] * r["devices"]))
    return results


def collective_stats(fn, mesh):
    """Communication profile of one call of ``fn()`` on this rank.

    There is no compiled program to read, so the profile is counted while
    ``fn`` runs: ``collective_bytes`` are the bytes each kind of collective
    that went through ``mesh`` delivered to this rank (the names of the
    JAX package's HLO ops: ``all-reduce``, ``all-gather``,
    ``collective-permute`` for the halo's sends and receives, plus
    ``broadcast``, which has no HLO op there), and ``flops`` are the
    floating-point operations of the matrix products and convolutions
    that ``torch.utils.flop_counter.FlopCounterMode`` counts, forward and
    backward (XLA's cost analysis counts elementwise work as well).
    ``bytes_accessed`` is None: XLA's cost analysis estimates it from the
    compiled program, and the port has no such estimate.  ``fn``'s result
    is returned under ``result``.
    """
    from torch.utils.flop_counter import FlopCounterMode

    before = mesh.collective_bytes.copy()
    with FlopCounterMode(display=False) as counter:
        result = fn()
    wait(result)
    moved = mesh.collective_bytes - before
    return {"collective_bytes": dict(moved),
            "flops": float(counter.get_total_flops()),
            "bytes_accessed": None,
            "result": result}


def dp_efficiency_model(n_devices, flops_per_device, allreduce_bytes,
                        peak_flops=989e12, link_bw=4.5e11, util=0.4):
    """Data-parallel weak-scaling efficiency bound from first principles.

    T_compute = flops / (peak * util); T_comm = ring all-reduce time,
    2 * (n-1)/n * bytes / link_bw.  Efficiency = T_c / (T_c + T_comm).
    Defaults are one H100 SXM from NVIDIA's data sheet: 989 TFLOP/s dense
    bf16 on the tensor cores and 450 GB/s of NVLink each way, with a 40%
    utilization, a generic guess: pass a measured ``util`` (the port's
    learner reaches about 3.7% of that peak on one H100, as phase 12 of
    ``chip_smoke.py`` prints).  Cards joined otherwise (PCIe, a network
    between hosts) pass their own ``link_bw``.
    """
    if n_devices <= 1:
        return 1.0
    t_compute = flops_per_device / (peak_flops * util)
    t_comm = 2.0 * (n_devices - 1) / n_devices * allreduce_bytes / link_bw
    return t_compute / (t_compute + t_comm)
