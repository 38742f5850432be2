"""Data parallelism over a 1-D mesh (counterpart of
vcrnet_tpu/parallel/mesh.py).

The JAX package runs one process per host over a ``jax.sharding.Mesh``:
the batch is sharded over the 'data' axis, the parameters are replicated,
and jit's partitioner inserts the gradient psum and takes BatchNorm's
statistics over the whole sharded batch. PyTorch's idiom is one process
per GPU (``torchrun --nproc_per_node N``) in a process group, with the
collectives written out: a :class:`Mesh` made in such a process is the
group (``size`` its world size, ``rank`` this process's). A mesh can also
live inside one process, over the devices that process drives
(``make_mesh(devices=...)``): the ``Registrar`` serves over one, a replica
of the model on each device.

The collectives of a group mesh (:meth:`Mesh.all_reduce_`,
:meth:`Mesh.all_reduce`, :meth:`Mesh.gather_rows`, :meth:`Mesh.broadcast_`)
take tensors on the rank's device; the rows of one member are gathered by
an all-reduce of a zero-filled buffer, so every collective is an
all-reduce or a broadcast, which the NCCL and the Gloo backends both take
on a CUDA tensor. In a mesh without a group they do nothing: the process
holds every shard.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward all-reduces the cotangent: every
    rank's loss reaches every rank's input (the semantics of
    ``torch.distributed.nn.functional.all_reduce``, which torch 2.13
    deprecates with a warning at every call)."""

    @staticmethod
    def forward(ctx, group, tensor):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, _AllReduceSum.apply(ctx.group, grad)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh of ``size`` members. In a process group (``group``
    set) a member is a process: ``rank`` is this one's, ``devices`` is
    empty (each rank names its own device). Without a group the members
    are ``devices``, all driven by this process, and ``rank`` is 0."""

    size: int = 1
    rank: int = 0
    group: object = None
    devices: tuple = ()

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """SUM ``tensor`` over the group's ranks, in place; returns it."""
        if self.group is not None:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """SUM over the group's ranks, differentiable: the backward sums
        the cotangent over the ranks the same way."""
        if self.group is None:
            return tensor
        return _AllReduceSum.apply(self.group, tensor)

    def gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """[b, ...] of every rank -> [size * b, ...], rank 0's rows first
        (the global batch order of equal contiguous shards): each rank
        writes its rows into a zero buffer and the buffers are summed."""
        if self.group is None:
            return tensor
        b = tensor.shape[0]
        out = tensor.new_zeros((self.size * b,) + tuple(tensor.shape[1:]))
        out[self.rank * b:(self.rank + 1) * b] = tensor
        return self.all_reduce_(out)

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s values into ``tensor`` on every rank; returns it."""
        if self.group is not None:
            dist.broadcast(tensor, src=src, group=self.group)
        return tensor

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the files of a run (rank 0)."""
        return self.rank == 0


def world_size() -> int:
    """The size of the default process group, 1 where none is up."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The data mesh. With ``devices``: a mesh inside this process over
    them (the first ``n_devices`` where given; a device may repeat). Else,
    where a process group is up: the group, whose world size
    ``n_devices`` must equal when given. Else: this process alone
    (``n_devices`` None or 1), or its first ``n_devices`` CUDA devices."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)[:n_devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(size=len(devs), devices=devs)
    world = world_size()
    if dist.is_available() and dist.is_initialized():
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"a mesh of {n_devices} devices in a process group of world size {world}: "
                f"data parallelism runs one process per device "
                f"(torchrun --nproc_per_node {n_devices})"
            )
        return Mesh(size=world, rank=dist.get_rank(), group=dist.group.WORLD)
    if n_devices is None or n_devices == 1:
        return Mesh()
    count = torch.cuda.device_count()
    if n_devices > count:
        raise ValueError(
            f"a mesh of {n_devices} devices, but this process sees {count} CUDA devices "
            f"and no process group (world size {world})"
        )
    return Mesh(size=n_devices, devices=tuple(torch.device("cuda", i) for i in range(n_devices)))


class Sharding(NamedTuple):
    """How a batch lies on a mesh: ``split`` in equal contiguous row
    ranges, one a member (the batch sharding), or whole on every member
    (replicated). The port's counterpart of a ``NamedSharding``: PyTorch
    has no global array, so it only names the rows each member holds."""

    mesh: Mesh
    split: bool

    def rows(self, b: int) -> list:
        """Each member's rows of a leading axis of ``b`` (which the mesh
        size must divide when split)."""
        n = self.mesh.size
        if not self.split:
            return [slice(0, b)] * n
        if b % n:
            raise ValueError(f"batch axis {b} does not divide the mesh size {n}; "
                             "pad to a mesh-size multiple first")
        per = b // n
        return [slice(i * per, (i + 1) * per) for i in range(n)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (batch) axis split over the mesh."""
    return Sharding(mesh, True)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """The shards of ``batch`` (a dict of arrays or tensors with one
    leading axis) that this process holds, split as
    :func:`batch_sharding`: in a mesh of devices, one dict per device,
    moved to it; in a process group, this rank's rows alone (a list of
    one, where they lie; the whole batch in a mesh of this process
    alone)."""
    lead = next(iter(batch.values())).shape[0]
    rows = batch_sharding(mesh).rows(lead)
    if mesh.group is not None or not mesh.devices:
        return [{k: v[rows[mesh.rank]] for k, v in batch.items()}]
    return [{k: torch.as_tensor(v)[r].to(dev) for k, v in batch.items()}
            for r, dev in zip(rows, mesh.devices)]


def _pad_rows(v, pad: int):
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)


def pad_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the batch axis so it divides the mesh (padding rows get
    valid=0 so metrics ignore them): the last row repeated, numpy arrays
    or tensors."""
    lead = "src" if "src" in batch else next(iter(batch))
    b = batch[lead].shape[0]
    rem = b % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    out = {k: _pad_rows(v, pad) for k, v in batch.items()}
    if "valid" in out:
        out["valid"][-pad:] = 0.0
    return out
