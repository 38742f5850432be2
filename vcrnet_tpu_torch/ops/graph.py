"""Graph primitives: pairwise distances, kNN and kFN selection, neighbour
gathers.

PyTorch counterpart of vcrnet_tpu/ops/graph.py (the XLA formulation).
Channels-last [B, N, C] throughout. ``knn(method="exact")`` keeps the JAX
rule ``top_k(k+1)[..., 1:]``: the best column is dropped whether or not it
is the point itself, and ties go to the smaller column. ``method="auto"``
sends every CUDA tensor to the kNN kernel (``ops.knn.fused_knn``, which
raises on a shape it does not take), which masks the diagonal instead: the
two differ only on duplicate points.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops._common import select_topk
from vcrnet_tpu_torch.ops.knn import fused_knn


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


def knn(x: torch.Tensor, k: int, method: str = "auto") -> torch.Tensor:
    """Indices [B, N, k] (int32) of the k nearest neighbours, excluding
    self. Methods (vcrnet_tpu/ops/graph.py:knn):

      'kernel'  ``ops.knn.fused_knn``: the CUDA kernel (its plain version on
                a CPU tensor), diagonal masked
      'exact'   the top k+1 of the negated distance with the first dropped
      'auto'    'kernel' for a CUDA tensor, whatever its shape (the kernel's
                wrapper raises on what it does not take; nothing on the
                card gives way to the plain formulation), 'exact' for a
                CPU tensor, as the JAX package's 'auto' off the TPU
    """
    if method == "auto":
        method = "kernel" if x.device.type == "cuda" else "exact"
    if method == "kernel":
        return fused_knn(x, k)
    if method != "exact":
        raise ValueError(f"unknown knn method {method!r}")
    with torch.no_grad():
        return select_topk(neg_pairwise_sqdist(x), k + 1)[..., 1:]


def kfn(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, N, k] (int32) of the k FARTHEST points of each point
    (the LPD triplet loss's hard negatives): the top k of the squared
    distances, ties to the smaller column (vcrnet_tpu/ops/graph.py:kfn)."""
    with torch.no_grad():
        return select_topk(pairwise_sqdist(x), k)


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats [B, N, C], idx [B, M, k] -> [B, M, k, C] by indexed load."""
    B, M, k = idx.shape
    flat = idx.reshape(B, M * k).long()
    out = torch.gather(feats, 1, flat[..., None].expand(B, M * k, feats.shape[-1]))
    return out.reshape(B, M, k, feats.shape[-1])


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [B, K] of ``arr`` [B, N, C] -> [B, K, C]."""
    return torch.gather(arr, 1, idx[:, :, None].long().expand(-1, -1, arr.shape[-1]))


def graph_feature(feats: torch.Tensor, idx: torch.Tensor | None = None, k: int = 20) -> torch.Tensor:
    """Edge-conv input: feats [B, N, C] -> [B, N, k, 2C], the concat of each
    neighbour's features and the centre's (neighbour first; not the DGCNN
    paper's difference, as vcrnet_tpu/ops/graph.py:graph_feature)."""
    if idx is None:
        idx = knn(feats, k)
    neigh = gather_neighbors(feats, idx)
    return torch.cat([neigh, feats[:, :, None, :].expand_as(neigh)], dim=-1)


def gather_max_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Max over each point's k neighbours: [B, N, C] x [B, M, k] -> [B, M, C]."""
    return gather_neighbors(feats, idx).amax(dim=2)
