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

Point-axis sharding (``point_sharding``, ``sp_model``, ``sp_flagship``)
adds :meth:`Mesh.all_gather` (the tiled gather of
``jax.lax.all_gather(..., tiled=True)``, also an all-reduce of a
zero-filled buffer), :meth:`Mesh.all_reduce_max` (no gradient) and
:func:`make_mesh_2d`, the world as a batch x points grid of groups. Its
gradients follow one convention, so that one SUM all-reduce of the
parameters' gradients over the world gives the single device's gradient:

* a value that every rank of a group computes whole (a replicated value:
  the 3 x 3 solve, the partial head's selections, the loss) holds on each
  rank a partial cotangent, and the ranks' partials sum to its cotangent;
  the loss starts them, 1/world on each rank (:meth:`Mesh.replicated`);
* a value a rank holds alone (its shard of the points) holds its whole
  cotangent, which :meth:`Mesh.all_reduce` (psum, whose backward
  all-reduces the cotangent) and :meth:`Mesh.all_gather` (whose backward
  all-reduces the cotangent and keeps this rank's slice: psum_scatter)
  assemble from the ranks' partials;
* a parameter's gradient on a rank is that rank's share: every rank uses
  the parameters on its own shard, so :meth:`Mesh.all_reduce_grads` sums
  the shares over the world once, after the backward.

JAX gets the same from ``shard_map``'s transposes.
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


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim`` (rank 0's slice first): each rank
    writes its slice into a zero buffer and the buffers are summed. The
    backward all-reduces the cotangent and keeps this rank's slice
    (psum_scatter)."""

    @staticmethod
    def forward(ctx, group, size, rank, dim, tensor):
        n = tensor.shape[dim]
        ctx.group, ctx.rank, ctx.dim, ctx.n = group, rank, dim, n
        shape = list(tensor.shape)
        shape[dim] *= size
        out = tensor.new_zeros(shape)
        out.narrow(dim, rank * n, n).copy_(tensor)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        full = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(full, group=ctx.group)
        return None, None, None, None, full.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)


class _Replicated(torch.autograd.Function):
    """Identity whose backward hands this rank ``scale`` of the cotangent."""

    @staticmethod
    def forward(ctx, scale, tensor):
        ctx.scale = scale
        return tensor.view_as(tensor)

    @staticmethod
    def backward(ctx, grad):
        return None, grad * ctx.scale


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
        (the global batch order of equal contiguous shards)."""
        return self.all_gather(tensor, 0)

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``tensor`` concatenated along ``dim``, rank 0's
        first (``jax.lax.all_gather(..., tiled=True)``); differentiable as
        the module docstring says. Integer tensors are gathered alike."""
        if self.group is None:
            return tensor
        return _AllGather.apply(self.group, self.size, self.rank, dim, tensor)

    def all_reduce_max(self, tensor: torch.Tensor) -> torch.Tensor:
        """Elementwise MAX over the group's ranks, as a new tensor with no
        gradient (``jax.lax.pmax`` of a stopped gradient)."""
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        if self.group is not None:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def replicated(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor``, a value that every rank of the group computes whole
        (a loss), marked so: its backward starts each rank's partial
        cotangent at 1/size of the value's."""
        if self.size == 1:
            return tensor
        return _Replicated.apply(1.0 / self.size, tensor)

    def all_reduce_grads(self, params) -> None:
        """SUM the ``.grad`` of ``params`` over the group, in one flat
        buffer; a parameter no path reached gets a zero gradient first."""
        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.group is None:
            return
        grads = [p.grad for p in params]
        flat = self.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The world as an ``n_batch x n_points`` grid (``jax.sharding.Mesh``
    with the axes ("batch", "data")): ``points`` is this rank's row, the
    group over which its point collectives run (the inner axis, "data"),
    ``batch`` its column, ``world`` every rank."""

    points: Mesh
    batch: Mesh
    world: Mesh

    @property
    def n_batch(self) -> int:
        return self.batch.size

    @property
    def n_points(self) -> int:
        return self.points.size

    @property
    def size(self) -> int:
        return self.world.size


def make_mesh_2d(n_batch: int, n_points: Optional[int] = None) -> Mesh2D:
    """The process group's world as an ``n_batch x n_points`` grid
    (``n_points`` defaults to world // n_batch): rank r sits at batch row
    r // n_points and point index r % n_points, the point axis inner, as
    JAX's ``grid.reshape(n_batch, n_points)``. Every rank makes every row's
    and every column's group (``dist.new_group``), in one order. Without a
    process group the grid is 1 x 1, this process alone."""
    world = make_mesh()
    if n_points is None:
        n_points = world.size // n_batch
    if n_batch < 1 or n_points < 1 or n_batch * n_points != world.size:
        raise ValueError(f"a {n_batch} x {n_points} mesh in a world of {world.size} processes")
    if world.group is None:
        return Mesh2D(world, world, world)
    grid = np.arange(world.size).reshape(n_batch, n_points)
    row, col = divmod(world.rank, n_points)
    points = batch = None
    for b in range(n_batch):
        group = dist.new_group(grid[b].tolist())
        if b == row:
            points = Mesh(size=n_points, rank=col, group=group)
    for p in range(n_points):
        group = dist.new_group(grid[:, p].tolist())
        if p == col:
            batch = Mesh(size=n_batch, rank=row, group=group)
    return Mesh2D(points, batch, world)


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
