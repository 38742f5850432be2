"""Layer helpers shared by the model modules."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype`` when given (parameters stay f32
    and are cast per call, as flax's ``Dense(dtype=...)`` does)."""
    w, b = layer.weight, layer.bias
    if dtype is not None:
        x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    return F.linear(x, w, b)
