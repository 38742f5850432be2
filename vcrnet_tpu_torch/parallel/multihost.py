"""Multi-process execution (counterpart of vcrnet_tpu/parallel/multihost.py).

The JAX package runs one process per host, each seeing its local chips,
all running one jit program over a global mesh. The port runs one process
per GPU in a ``torch.distributed`` process group, as ``torchrun`` launches
it. Each process iterates the same batches in the same order and keeps
only its rows (no data service between processes); the Trainer's
collectives (the gradient all-reduce, BatchNorm's statistics, the epoch
sums) make its step the step of the whole batch. This module supplies:

* :func:`initialize`: the process group from torchrun's environment
  (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``) or from the caller's arguments, a no-op in a single
  process, so one entry point runs on one card or under torchrun;
* :func:`local_batch_slice`: the rows of a (padded) global host batch
  that this process owns;
* :func:`global_batch_from_local`: this rank's rows as tensors on its
  device.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from vcrnet_tpu_torch.parallel.mesh import Mesh, world_size
from vcrnet_tpu_torch.utils.device import resolve_device

DEFAULT_TIMEOUT = timedelta(seconds=60)  # a collective that waits longer fails


def launched_world_size() -> int:
    """The world size the environment announces (torchrun's
    ``WORLD_SIZE``), 1 where it announces none."""
    raw = os.environ.get("WORLD_SIZE", "").strip()
    return int(raw) if raw.isdigit() else 1


def initialize(**kwargs) -> bool:
    """Start the default process group if this looks like a multi-process
    launch; return True when the world holds more than one process.

    ``torch.distributed.init_process_group(**kwargs)`` runs when the caller
    passes kwargs (``init_method``, ``rank``, ``world_size``, ``backend``,
    ``timeout``, ...) or the environment announces ``WORLD_SIZE`` > 1
    (torchrun; the rendezvous is then ``env://``). Before it, where
    ``LOCAL_RANK`` is set and CUDA is there, ``torch.cuda.set_device``
    makes the rank's card the current device, so the port's default
    ``"cuda"`` means that card and the kernels launch there. The backend is
    NCCL where CUDA is available and Gloo otherwise, unless ``backend`` is
    given; the timeout of every collective is 60 s unless ``timeout`` is
    given. Failures propagate (a misconfigured job must fail, not train one
    model per process); a group that is already up is kept. Without kwargs
    and without the environment this is a no-op."""
    if not kwargs and launched_world_size() <= 1:
        return world_size() > 1
    if dist.is_initialized():
        return world_size() > 1
    local = os.environ.get("LOCAL_RANK", "").strip()
    if local.isdigit() and torch.cuda.is_available():
        torch.cuda.set_device(int(local))
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    kwargs.setdefault("timeout", DEFAULT_TIMEOUT)
    dist.init_process_group(**kwargs)
    return world_size() > 1


def local_batch_slice(
    batch: dict,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> dict:
    """Rows of a (padded) global host batch owned by this process.

    The batch's leading axis must divide process_count: the trainer pads to
    a mesh-size multiple first (``pad_to_multiple``)."""
    pi = (dist.get_rank() if world_size() > 1 else 0) if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if pc == 1:
        return batch
    out = {}
    for key, val in batch.items():
        b = val.shape[0]
        if b % pc:
            raise ValueError(
                f"batch axis {b} does not divide process_count {pc}; "
                "pad to a mesh-size multiple first"
            )
        per = b // pc
        out[key] = val[pi * per:(pi + 1) * per]
    return out


def global_batch_from_local(local_batch: dict, mesh: Mesh, global_b: int,
                            device=None) -> dict:
    """This rank's rows (from :func:`local_batch_slice`) as f32 tensors on
    ``device`` (default the current CUDA device, raising where there is
    none), checked to be ``global_b / mesh.size`` rows. PyTorch has no
    global array, so unlike the JAX function this assembles nothing: the
    rows stay the rank's own, and the collectives of the step make it the
    step of the global batch."""
    dev = resolve_device(device)
    if global_b % mesh.size:
        raise ValueError(f"global batch {global_b} does not divide the mesh size {mesh.size}")
    per = global_b // mesh.size
    out = {}
    for key, val in local_batch.items():
        if val.shape[0] != per:
            raise ValueError(f"{key}: {val.shape[0]} rows, this rank owns {per} of {global_b}")
        out[key] = torch.as_tensor(val, dtype=torch.float32).to(dev)
    return out
