"""Helpers shared by the kernel wrappers: routing by device, argument
checks, and the selection rule of the kNN kernels' plain versions."""

from __future__ import annotations

import torch

SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90 (227 KB)


def kernel_route(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (run the plain version). Raises for
    tensors spread over several devices or on any other device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` has ``dtype``, matches ``shape`` (None entries
    match any size) and is contiguous. Reads no data, so it runs on the
    fake tensors of a trace too; :func:`check_aligned` checks the data
    where the kernel is launched."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and want != got for want, got in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_aligned(**tensors: torch.Tensor) -> None:
    """Raise unless each tensor's data is 32-byte aligned (the kernels use
    16-byte vector loads and warp-level mma tiles)."""
    for name, t in tensors.items():
        if t.data_ptr() % 32:
            raise ValueError(f"{name}: data must be 32-byte aligned")


def knn_scores(x: torch.Tensor) -> torch.Tensor:
    """[B, N, C] -> [B, N, N] f32 scores ``2 x_i . x_j - |x_j|^2`` with
    the diagonal at -inf and NaN mapped to -inf: the score rule of the
    fused kNN kernels (vcrnet_tpu/ops/pallas_edgeconv.py:_scores_and_ids).
    Dropping |x_i|^2 leaves each row's order unchanged."""
    xf = x.float()
    scores = 2.0 * torch.matmul(xf, xf.transpose(1, 2)) - (xf * xf).sum(-1)[:, None, :]
    scores = torch.nan_to_num(scores, nan=float("-inf"))
    scores.diagonal(dim1=1, dim2=2).fill_(float("-inf"))
    return scores


def select_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the k largest scores per row, in descending order, ties
    to the smaller column (``lax.top_k``'s rule): a stable descending
    sort. Returns int32 [..., k]."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :k].to(torch.int32)


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or as it is when it is f64: the plain versions compute
    in f32 and keep f64 inputs in f64 (so gradcheck can probe them)."""
    return t if t.dtype == torch.float64 else t.float()


def leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, v * slope)
