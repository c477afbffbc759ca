"""The data mesh: one process per device, joined by ``torch.distributed``
(port of ``safelife_tpu.parallel.mesh``).

JAX drives every device of a mesh from one program and lets GSPMD place
the arrays.  PyTorch runs one process per device, so the port's mesh is
the view one rank has of the job: its rank, the world size, its device
and the process group, and the collectives that cross ranks.  The
``data`` axis is the world; the ``model`` axis is 1 (the model is a small
CNN: tensor or pipeline parallelism is not needed, SURVEY.md §2.3).

Layout (batch-trailing boards, see ops/life.py), as in the JAX package:

====================  =========================  ========================
array                 shape                      PartitionSpec
====================  =========================  ========================
boards/goals          (H, W, B)                  (None, None, 'data')
per-env scalars       (B,)                       ('data',)
exit tables           (K, B)                     (None, 'data')
global counters       ()                         ()   [replicated]
observations          (B, vh, vw, C)             ('data', ...)
trajectories          (T, B, ...)                (None, 'data', ...)
level bank            any                        ()   [replicated per host]
network params        any                        ()   [replicated]
====================  =========================  ========================

A sharded leaf is held on each rank as its block of B / world
environments (:func:`shard_env`, :func:`shard_batch_leading`); a
replicated one as a full copy, rank 0's (:func:`replicate`).  Every
collective of the port goes through :class:`DataMesh`, which counts the
bytes of each kind (``distributed.collective_stats`` reads them).

NCCL runs one rank per card.  Gloo runs on the CPU, and also moves CUDA
tensors (staged through host copies here), which is how two ranks can
share one card.
"""

import collections
import dataclasses
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..env.state import LevelBank
from ..env.wrappers import WrapperState

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(eq=False)
class DataMesh:
    """One rank's view of the data-parallel job.

    ``group`` is the process group, or None for a single process without
    one (then every collective is the identity).  ``collective_bytes``
    counts, by kind, the bytes each collective delivers to this rank, as
    XLA's HLO counts a collective's output: ``all-reduce``, ``all-gather``,
    ``broadcast`` and ``collective-permute`` (the halo's sends and
    receives)."""
    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    collective_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self):
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}

    @property
    def backend(self):
        return None if self.group is None else dist.get_backend(self.group)

    def _wire(self, tensor, bits=False):
        """The tensor the backend moves: gloo moves CUDA tensors through
        host copies, NCCL moves them in place.  With ``bits`` (a copy, no
        arithmetic) 16-bit integers travel as bytes: neither backend has
        a 16-bit integer type."""
        if bits and tensor.dtype in (torch.uint16, torch.int16):
            tensor = tensor.view(torch.uint8)
        if self.backend == "gloo" and tensor.device.type == "cuda":
            return tensor.cpu()
        return tensor

    @staticmethod
    def _unwire(wire, like):
        """``wire`` as a tensor of ``like``'s dtype and device."""
        return wire.view(like.dtype).to(like.device)

    def _active(self):
        if self.group is None:
            if self.world_size != 1:
                raise RuntimeError(f"a mesh of {self.world_size} ranks has "
                                   f"no process group")
            return False
        return True

    def all_reduce(self, tensor):
        """Sum ``tensor`` over the ranks, in place; returns it."""
        if not self._active():
            return tensor
        self.collective_bytes["all-reduce"] += _nbytes(tensor)
        wire = self._wire(tensor)
        dist.all_reduce(wire, group=self.group)
        if wire is not tensor:
            tensor.copy_(wire)
        return tensor

    def broadcast(self, tensor):
        """Rank 0's ``tensor`` on every rank, in place; returns it."""
        if not self._active():
            return tensor
        self.collective_bytes["broadcast"] += _nbytes(tensor)
        wire = self._wire(tensor, bits=tensor.dim() > 0)
        dist.broadcast(wire, 0, group=self.group)
        if wire.data_ptr() != tensor.data_ptr():
            tensor.copy_(self._unwire(wire, tensor))
        return tensor

    def all_gather(self, tensor, dim=0):
        """Every rank's ``tensor`` concatenated along ``dim`` in rank
        order (the same shape on every rank)."""
        if not self._active():
            return tensor
        if tensor.dtype == torch.bool:  # as bytes: gloo has no bool
            return self.all_gather(tensor.to(torch.uint8), dim).bool()
        wire = self._wire(tensor.contiguous(), bits=True)
        parts = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(parts, wire, group=self.group)
        out = self._unwire(torch.cat(parts, dim), tensor)
        self.collective_bytes["all-gather"] += _nbytes(out)
        return out

    def exchange(self, sends, recvs):
        """Point-to-point transfers: ``sends`` is [(tensor, peer, tag)],
        ``recvs`` [(like, peer, tag)] with ``like`` a tensor of the shape,
        dtype and device to receive.  Returns the received tensors, in
        order."""
        if not self._active():
            raise RuntimeError("point-to-point transfers need ranks")
        ops, out = [], []
        for tensor, peer, tag in sends:
            ops.append(dist.P2POp(dist.isend, self._wire(
                tensor.contiguous(), bits=True), peer, self.group, tag))
        for like, peer, tag in recvs:
            buf = self._wire(torch.empty_like(like), bits=True)
            out.append((buf, like))
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.collective_bytes["collective-permute"] += sum(
            _nbytes(buf) for buf, _ in out)
        return [self._unwire(buf, like) for buf, like in out]

    def broadcast_object(self, obj):
        """Rank 0's picklable ``obj`` on every rank (the bytes of a pickle
        this job wrote; no other rank's object is read)."""
        if not self._active():
            return obj
        size = torch.zeros(1, dtype=torch.int64, device=self.device)
        if self.rank == 0:
            data = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
            size.fill_(data.size)
        self.broadcast(size)
        buf = torch.empty(int(size), dtype=torch.uint8, device=self.device)
        if self.rank == 0:
            buf.copy_(torch.from_numpy(data.copy()))
        self.broadcast(buf)
        return pickle.loads(buf.cpu().numpy().tobytes())

    def barrier(self):
        if self._active():
            nccl = self.backend == "nccl"
            dist.barrier(group=self.group,
                         device_ids=[self.device.index] if nccl else None)

    def global_means(self, *means):
        """Each rank's scalar ``means`` (one per term, over its rows) as the
        means over all ranks' rows, keeping each rank's own gradient path:
        ``m_r - stop_grad(m_r) + mean_r'(m_r')``.  A loss built from these
        is the global loss on every rank, and its gradients averaged over
        the ranks are the global loss's gradient (the ranks' row counts
        are equal).  One all-reduce of ``len(means)`` floats."""
        if not self._active():
            return means
        total = torch.stack([m.detach().to(torch.float32) for m in means])
        self.all_reduce(total)
        total /= self.world_size
        return tuple(m - m.detach() + g for m, g in zip(means, total))

    def average_gradients(self, params):
        """All-reduce the gradients of ``params`` as one flat buffer and
        divide by the world size, in place."""
        if not self._active():
            return
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce(flat)
        flat /= self.world_size
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def rows(self, batch):
        """This rank's slice of a batch of ``batch`` global rows."""
        if batch % self.world_size:
            raise ValueError(f"{batch} rows do not divide over "
                             f"{self.world_size} ranks")
        local = batch // self.world_size
        return slice(self.rank * local, (self.rank + 1) * local)


def _nbytes(tensor):
    return tensor.numel() * tensor.element_size()


def make_mesh(n_data=None, device=None):
    """This rank's (data, model) mesh over every rank of the default group
    when ``torch.distributed`` is initialized, else one rank without a
    group; the model axis is 1.  ``n_data``, where given, must be the
    world size.  ``device`` is ``cuda`` unless the caller passes
    another."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    else:
        group, rank, world = None, 0, 1
    if n_data is not None and n_data != world:
        raise ValueError(f"a data axis of {n_data} on {world} ranks")
    return DataMesh(rank=rank, world_size=world,
                    device=resolve_device(device), group=group)


def batch_trailing_spec(x):
    """The axis of ``x`` sharded over 'data' in env state: the trailing
    one (None for a scalar, which is replicated)."""
    return None if getattr(x, "ndim", 0) == 0 else x.ndim - 1


def batch_leading_spec(x):
    """The axis of ``x`` sharded over 'data' in observations, actions,
    rewards and the LSTM carry: the leading one."""
    return None if getattr(x, "ndim", 0) == 0 else 0


def env_state_shardings(state):
    """{leaf name: sharded axis or None} of an EnvState."""
    return {f.name: batch_trailing_spec(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def bank_shardings(mesh, bank):
    """{leaf name: None}: level banks are replicated.  Resets gather random
    levels, so sharding the bank would turn every reset into an
    all-to-all; banks are small (100 levels x 26x26 u16 ~ 135 KB)."""
    del mesh
    return {f.name: None for f in dataclasses.fields(bank)
            if f.type is torch.Tensor}


def _take(mesh, x, axis):
    if not isinstance(x, torch.Tensor) or axis is None:
        return x
    sl = mesh.rows(x.shape[axis])
    return x.narrow(axis, sl.start, sl.stop - sl.start).contiguous().to(
        mesh.device)


def shard_env(mesh, state, bank=None):
    """This rank's block of a whole-batch env ``state`` (an EnvState or a
    wrapper state over one): every leaf's trailing axis, scalars and host
    values kept; and, given a ``bank``, the bank replicated from rank 0."""
    if isinstance(state, WrapperState):
        inner = shard_env(mesh, state.inner)
        extra = {k: _take(mesh, v, batch_trailing_spec(v))
                 for k, v in state.extra.items()}
        state = WrapperState(inner=inner, extra=extra)
    else:
        state = dataclasses.replace(state, **{
            name: _take(mesh, getattr(state, name), axis)
            for name, axis in env_state_shardings(state).items()})
    if bank is None:
        return state
    return state, replicate_bank(mesh, bank)


def shard_batch_leading(mesh, tree):
    """This rank's block of the leading axis of every tensor in ``tree``
    (a tensor, or a tuple, list or dict of them)."""
    if isinstance(tree, dict):
        return {k: shard_batch_leading(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch_leading(mesh, v) for v in tree)
    return _take(mesh, tree, batch_leading_spec(tree))


def replicate(mesh, tree):
    """Rank 0's values of every tensor in ``tree`` (a tensor, a module, or
    a tuple, list or dict of them) on every rank, in place; returns it."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in tree.state_dict().values():
                mesh.broadcast(t)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v)
        return tree
    if isinstance(tree, (tuple, list)):
        for v in tree:
            replicate(mesh, v)
        return tree
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            mesh.broadcast(tree)
    return tree


def replicate_bank(mesh, bank: Optional[LevelBank]):
    """Rank 0's ``bank`` on every rank, on the mesh's device; the other
    ranks may pass None (only rank 0 need make the bank)."""
    if mesh.world_size == 1:
        return bank
    arrays = mesh.broadcast_object(
        bank.to_numpy() if mesh.rank == 0 else None)
    return LevelBank.from_numpy(arrays, mesh.device)

