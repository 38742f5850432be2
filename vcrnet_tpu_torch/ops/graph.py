"""Graph primitives: pairwise distances, kNN selection, neighbour gathers.

PyTorch counterpart of vcrnet_tpu/ops/graph.py (the XLA formulation).
Channels-last [B, N, C] throughout. ``knn`` keeps the JAX rule
``top_k(k+1)[..., 1:]``: the best column is dropped whether or not it is
the point itself, and ties go to the smaller column.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops._common import select_topk


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, N, C], y [B, M, C] (default x) -> [B, N, M] f32 squared
    distances by ``|x|^2 - 2 x.y + |y|^2``, all in f32 (a bf16 product is
    exact in f32, so bf16 inputs get JAX's f32-accumulated inner product)."""
    if y is None:
        y = x
    xf, yf = x.float(), y.float()
    inner = torch.matmul(xf, yf.transpose(1, 2))
    xx = (xf * xf).sum(-1)[:, :, None]
    yy = (yf * yf).sum(-1)[:, None, :]
    return xx - 2.0 * inner + yy


def neg_pairwise_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    return -pairwise_sqdist(x, y)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, N, k] (int32) of the k nearest neighbours, excluding
    self: the top k+1 of the negated distance with the first dropped."""
    return select_topk(neg_pairwise_sqdist(x), k + 1)[..., 1:]


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, N, C], idx [B, M, k] -> [B, M, k, C] by indexed load."""
    B, M, k = idx.shape
    flat = idx.reshape(B, M * k).long()
    out = torch.gather(feats, 1, flat[..., None].expand(B, M * k, feats.shape[-1]))
    return out.reshape(B, M, k, feats.shape[-1])


def gather_max_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over each point's k neighbours: [B, N, C] x [B, M, k] -> [B, M, C]."""
    return gather_neighbors(feats, idx).amax(dim=2)
