"""LayerNorm with torch ``x.std(-1)`` semantics, forward only.

Counterpart of vcrnet_tpu/ops/layernorm.py:layer_norm_torch: f32 math,
unbiased std (not variance), eps added to the std, output cast back to the
input dtype.
"""

from __future__ import annotations

import torch


def layer_norm_torch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((xf - mean) ** 2).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1))
    return (a * (xf - mean) / (std + eps) + b).to(x.dtype)
