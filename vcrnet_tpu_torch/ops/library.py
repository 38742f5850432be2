"""The port's forward kernels as torch ops in the ``vcrnet_torch`` namespace.

Each kernel module defines its op here when it is imported: the schema,
one implementation registered under the ``CPU`` and ``CUDA`` keys (the
plain version for CPU tensors, the kernel for CUDA tensors: it builds the
extension lazily, allocates the outputs and scratch, launches and adds one
to the wrapper's ``.launches``), and a fake implementation that gives the
outputs' shapes, dtypes and devices alone. Through the fake, ``torch.export``
traces a model that runs the kernels without building or launching any, and
an exported program calls the ops by name, so a loaded artifact launches
(and counts) the same kernels.

Ops are functional: they return the tensors the kernels fill. An optional
output (the training forward's winners or logsumexp) is a bool argument;
when it is off the op returns an empty tensor in its place and the kernel
writes nothing there. The four backward kernels stay direct extension calls
inside their ``autograd.Function``s: no eval artifact holds them.

The wrapper in each module keeps the device routing, the kernel's gates
and the dtype, shape and contiguity checks, which read shapes alone and so
run while tracing too; the data alignment is checked where the kernel is
launched.
"""

from __future__ import annotations

import torch

NAMESPACE = "vcrnet_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, impl, fake):
    """Define ``vcrnet_torch::{name}{schema}`` with ``impl`` for CPU and CUDA
    tensors and ``fake`` for tracing; returns the op's overload to call."""
    _LIB.define(name + schema)
    _LIB.impl(name, impl, "CPU")
    _LIB.impl(name, impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def empty_output(like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The placeholder of an optional output that was not asked for."""
    return like.new_empty((0,), dtype=dtype)


def stat_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype of the plain versions' f32 statistics: f32, or f64 for f64
    inputs (they compute in f32 and keep f64 in f64)."""
    return torch.promote_types(t.dtype, torch.float32)


def op_counts(graph) -> dict:
    """Nodes of an exported graph that call an op of this namespace, by op
    name (the name of the kernel in ``ops.KERNELS``)."""
    counts = {}
    for node in graph.nodes:
        if node.op == "call_function" and str(node.target).startswith(NAMESPACE + "."):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts
