"""LayerNorm with torch ``x.std(-1)`` semantics and an analytic backward.

Counterpart of vcrnet_tpu/ops/layernorm.py:layer_norm_torch: f32 math,
unbiased std (not variance), eps added to the std, output cast back to the
input dtype. The backward (plain PyTorch, the JAX custom VJP) saves x and
the per-row mean and std and recomputes h = (x - mean) / (std + eps):

    dh = dy * a
    dx = (dh - mean(dh)) / (std + eps) - h * sum(dh * h) / ((d - 1) * std)
    da = sum_rows dy * h,   db = sum_rows dy

On a zero-variance row h is 0 and the last term of dx is 0 * (c / 0):
autodiff through ``std`` gives NaN there, so the h -> 0 limit (the term
vanishes) is taken instead, as the JAX VJP does.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops._common import upcast


def _stats(xf: torch.Tensor):
    mean = xf.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((xf - mean) ** 2).sum(dim=-1, keepdim=True) / (xf.shape[-1] - 1))
    return mean, std


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, eps):
        xf = upcast(x)
        mean, std = _stats(xf)
        ctx.save_for_backward(x, a, mean, std)
        ctx.eps = eps
        ctx.b_dtype = b.dtype
        return (a * (xf - mean) / (std + eps) + b).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, a, mean, std = ctx.saved_tensors
        d = x.shape[-1]
        xf = upcast(x)
        dyf = upcast(dy)
        h = (xf - mean) / (std + ctx.eps)
        dh = dyf * a
        c1 = dh.mean(dim=-1, keepdim=True)
        c2 = (dh * h).sum(dim=-1, keepdim=True)
        safe_std = torch.where(std > 0, std, torch.ones_like(std))
        dx = (dh - c1) / (std + ctx.eps) - h * (c2 / ((d - 1) * safe_std))
        rows = tuple(range(x.dim() - 1))
        da = (dyf * h).sum(dim=rows)
        db = dyf.sum(dim=rows)
        return dx.to(x.dtype), da.to(a.dtype), db.to(ctx.b_dtype), None


def layer_norm_torch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    return _LayerNorm.apply(x, a, b, eps)
