"""The LPDNet kNN blocks as fused kernels, each beside its plain version.

  fused_knn_gather_max  SN block: xyz kNN fused with out[i] = max_{j in knn(i)} values[j]
                  (vcrnet_tpu/ops/pallas_edgeconv.py:fused_knn_gather_max)
  fused_edge_conv       DG block: feature kNN, z_ij = act(a[j] + h[i]), x1 = max_j z,
                  x2 = max_j act(bf16(z) @ W2 + b2)
                  (vcrnet_tpu/ops/pallas_edgeconv.py:fused_edge_conv)

A CUDA tensor launches the kernel in ``csrc/`` (or raises); a CPU tensor
runs the ``*_ref`` plain version. Both select by exact f32 comparison with
ties to the smaller column and mask the diagonal, and both gather the
exact values: the TPU's int8 one-hot gather (``int8_gather=True`` there)
is not reproduced. Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import (
    check_tensor, kernel_route, knn_scores, leaky, select_topk,
)
from vcrnet_tpu_torch.ops.graph import gather_max_neighbors, gather_neighbors


def _check_k(k: int, n: int) -> None:
    if not 0 < k <= 32 or k >= n:
        raise ValueError(f"k={k} must be in [1, 32] and below N={n}")


def fused_knn_gather_max_ref(x, values, k: int = 20, idx=None):
    """Plain version of :func:`fused_knn_gather_max`; ``idx`` [B, N, k] skips the
    selection and gathers over the given neighbours."""
    if idx is None:
        idx = select_topk(knn_scores(x), k)
    return gather_max_neighbors(values, idx), idx


def fused_knn_gather_max(x: torch.Tensor, values: torch.Tensor, k: int = 20):
    """x [B, N, 3] f32, values [B, N, F] -> (out [B, N, F], idx [B, N, k]
    int32): per point, the channel-wise max of ``values`` over its k
    nearest neighbours in x (self excluded). The kernel takes bf16 values
    with F % 8 == 0."""
    if not kernel_route(x, values):
        return fused_knn_gather_max_ref(x, values, k)
    B, N, _ = x.shape
    F = values.shape[-1]
    check_tensor("x", x, torch.float32, (B, N, 3))
    check_tensor("values", values, torch.bfloat16, (B, N, F))
    _check_k(k, N)
    if F % 8:
        raise ValueError(f"values width {F} must be a multiple of 8")
    norms = (x * x).sum(-1)
    out = torch.empty_like(values)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    _build.extension().knn_gather_max(x, norms, values, out, idx, k)
    fused_knn_gather_max.launches += 1
    return out, idx


fused_knn_gather_max.launches = 0


def fused_edge_conv_ref(x, a, h, w2, b2, k: int = 20, negative_slope: float = 0.0,
                        idx=None):
    """Plain version of :func:`fused_edge_conv`; ``idx`` [B, N, k] skips the
    selection. Rounds z to w2's dtype before the product, as the kernel."""
    if idx is None:
        idx = select_topk(knn_scores(x), k)
    z = leaky(gather_neighbors(a, idx).float() + h.float()[:, :, None], negative_slope)
    y = torch.matmul(z.to(w2.dtype).float(), w2.float()) + b2.float()
    x1 = z.amax(dim=2)
    x2 = leaky(y, negative_slope).amax(dim=2)
    return x1.to(a.dtype), x2.to(a.dtype), idx


def fused_edge_conv(x, a, h, w2, b2, k: int = 20, negative_slope: float = 0.0):
    """x [B, N, C] (the kNN space), a/h [B, N, F], w2 [F, F] (in, out),
    b2 [F] -> (x1, x2 [B, N, F] in a's dtype, idx [B, N, k] int32). The
    kernel takes bf16 throughout, C in {32, 64, 128}, F = 128 and
    N % 16 == 0."""
    if not kernel_route(x, a, h, w2, b2):
        return fused_edge_conv_ref(x, a, h, w2, b2, k, negative_slope)
    B, N, C = x.shape
    bf16 = torch.bfloat16
    if C not in (32, 64, 128) or N % 16:
        raise ValueError(
            f"edge_conv kernel takes C in (32, 64, 128) and N % 16 == 0, got C={C} N={N}"
        )
    check_tensor("x", x, bf16, (B, N, C))
    for name, t in (("a", a), ("h", h)):
        check_tensor(name, t, bf16, (B, N, 128))
    check_tensor("w2", w2, bf16, (128, 128))
    check_tensor("b2", b2, bf16, (128,))
    _check_k(k, N)
    norms = x.float().square().sum(-1)
    x1 = torch.empty_like(a)
    x2 = torch.empty_like(a)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    _build.extension().edge_conv(
        x, norms, a, h, w2, b2, x1, x2, idx, k, float(negative_slope)
    )
    fused_edge_conv.launches += 1
    return x1, x2, idx


fused_edge_conv.launches = 0
