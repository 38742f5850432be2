"""Exact kNN indices as a kernel beside its plain version.

``fused_knn`` replaces vcrnet_tpu/ops/pallas_knn.py:fused_knn, the selection
behind ``graph.knn(method="auto")``: x [B, N, C] -> idx [B, N, k] int32, the
k nearest neighbours of each point in x's own space, self excluded by
masking the diagonal, ties to the smaller column, scores
``2 x_i . x_j - |x_j|^2`` compared exactly in f32. A CUDA tensor launches
``csrc/knn.cu`` (or raises); a CPU tensor runs ``fused_knn_ref``. On f32 xyz
(DGCNN's graph, the only input the models send) the kernel runs the scores
and two-pass selection of ``knn_gather_max.cu`` (``csrc/knn_scores.cuh``) and
returns its selection bit for bit, at any N; any other input (f32 or bf16,
C <= 512) takes a general path with an f32 multiply-add chain per key.

Indices carry no gradient (the JAX custom VJP returns zeros): the result
never requires grad, whatever x does.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import (
    SMEM_LIMIT, check_tensor, kernel_route, knn_scores, select_topk,
)

MAX_C = 512


def fused_knn_ref(x: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Plain version of :func:`fused_knn`."""
    with torch.no_grad():
        return select_topk(knn_scores(x), k)


def fused_knn(x: torch.Tensor, k: int = 20) -> torch.Tensor:
    """x [B, N, C] f32 or bf16 -> idx [B, N, k] int32; see the module
    docstring. The kernel takes k <= 32, k < N and, off the xyz path, C <= 512
    and an N whose f32 score row and query row fit a block's shared memory;
    it raises on anything else."""
    if not kernel_route(x):
        return fused_knn_ref(x, k)
    B, N, C = x.shape
    x = x.detach()
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_knn kernel takes f32 or bf16, got {x.dtype}")
    check_tensor("x", x, x.dtype, (B, N, C))
    if not 0 < k <= 32 or k >= N:
        raise ValueError(f"k={k} must be in [1, 32] and below N={N}")
    xyz = x.dtype == torch.float32 and C == 3  # any N: the cloud is staged in tiles
    if not xyz and (C > MAX_C or 4 * (N + C) + 128 > SMEM_LIMIT):
        raise ValueError(
            f"fused_knn kernel takes C <= {MAX_C} and a score row that fits "
            f"{SMEM_LIMIT} bytes of shared memory, got N={N} C={C}"
        )
    norms = x.float().square().sum(-1)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    _build.extension().knn(x, norms, idx)
    fused_knn.launches += 1
    return idx


fused_knn.launches = 0
