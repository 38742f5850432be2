"""Layer helpers shared by the model modules."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from vcrnet_tpu_torch.ops.int8_linear import int8_linear_shared, int8_linear_shared_ref


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` when given (parameters stay f32
    and are cast per call, as flax's ``Dense(dtype=...)`` does)."""
    w, b = layer.weight, layer.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return F.linear(x, w, b)


def int8_dense(layers, x: torch.Tensor, dtype: torch.dtype | None, kernel: bool) -> tuple:
    """:func:`dense` of each of ``layers`` (1 to 3 ``nn.Linear`` that share
    the input x) with both operands quantized to int8, in one call: x, the
    weights and the biases are cast to ``dtype`` first, so the compute-dtype
    values are quantized, as flax's ``promote_dtype`` casts them before the
    JAX package's int8_linear (vcrnet_tpu/models/transformer.py:93-100).
    ``kernel`` (the model's kernel route) calls
    ``ops.int8_linear.int8_linear_shared``, which launches its kernel once on
    a CUDA tensor; otherwise its plain version ``int8_linear_shared_ref``
    runs on any device. Returns a tensor a layer."""
    pairs = []
    for layer in layers:
        w, b = layer.weight, layer.bias
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        pairs.append((w, b))
    if dtype is not None:
        x = x.to(dtype)
    return (int8_linear_shared if kernel else int8_linear_shared_ref)(x, pairs)


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    axis of a channels-last tensor, statistics over every other axis.

    Not ``nn.BatchNorm*d``: flax updates the running variance with the
    BIASED batch variance (torch takes the unbiased one) and keeps
    ``momentum`` as the share of the old value (0.9 here is torch's 0.1).
    flax computes that variance as ``mean(x^2) - mean(x)^2`` clipped at 0;
    here it is ``mean((x - mean(x))^2)``, the same value without the
    cancellation: on a T-Net's activations (mean large against the
    deviation) the one-pass form's f32 gradient missed the f64 one by 1.2%
    where the JAX package's jitted f32 gradient is within 1.1e-4
    (tests/test_torch_tnet.py). Statistics are taken
    in f32 whatever the input, and the result is f32 (the parameters' type).
    In training mode each call updates ``running_mean`` / ``running_var``
    in place, so two calls in one step compound, as they do in flax.
    Parameters keep torch's names (flax ``scale`` is ``weight``).

    With ``mesh`` set (a data mesh of a process group,
    :func:`sync_batch_stats`) the training statistics are those of the
    global batch, as the JAX package's are over its sharded batch (padding
    rows included: BatchNorm does not see ``valid``): the per-channel sums
    and the row count are all-reduced, then the sums of (x - mean)^2, both
    through the mesh's differentiable all-reduce, so the gradient crosses
    the ranks."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True  # off while a rematerialised forward runs again
        self.mesh = None  # the data mesh whose global batch the statistics cover

    def _global_stats(self, x: torch.Tensor, dims: tuple):
        rows = x.new_full((1,), float(x[..., 0].numel()))
        sums = self.mesh.all_reduce(torch.cat([x.sum(dim=dims), rows]))
        mean = sums[:-1] / sums[-1]
        var = self.mesh.all_reduce((x - mean).square().sum(dim=dims)) / sums[-1]
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.mesh is not None and self.mesh.group is not None:
                mean, var = self._global_stats(x, dims)
            else:
                mean = x.mean(dim=dims)
                var = (x - mean).square().mean(dim=dims)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                    self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias


def sync_batch_stats(model: nn.Module, mesh) -> None:
    """Every FlaxBatchNorm of ``model`` takes its training statistics over
    the global batch of ``mesh`` (a process group's; a mesh without a group
    leaves them local)."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.mesh = mesh


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
    """No FlaxBatchNorm of ``model`` updates its running statistics inside
    the block (a rematerialised forward runs the training forward again)."""
    norms = [m for m in model.modules() if isinstance(m, FlaxBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """flax's ``nn.Dropout``: each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate), the others 0; the mask drawn from
    ``gen`` (a generator on x's device)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class DropoutRng:
    """The explicit generator of a model's dropout masks, on its device.
    ``seed`` is set for each training step; the model's forward calls
    :meth:`reseed` on entry, so a recomputed forward draws the same masks."""

    def __init__(self, device):
        self.generator = torch.Generator(device=device)
        self.seed = 0

    def reseed(self) -> None:
        self.generator.manual_seed(self.seed)


class Dropout(nn.Module):
    """Dropout at ``rate`` in training mode from ``rng``'s generator; the
    identity in eval mode and at rate 0."""

    def __init__(self, rate: float = 0.0, rng: DropoutRng | None = None):
        super().__init__()
        if rate > 0 and rng is None:
            raise ValueError("dropout at a positive rate needs a DropoutRng")
        self.rate = rate
        self.rng = rng

    @property
    def active(self) -> bool:
        return self.training and self.rate > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.rng.generator) if self.active else x
