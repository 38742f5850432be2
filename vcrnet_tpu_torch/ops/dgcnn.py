"""DGCNN's eval chain as a kernel beside its plain version.

``fused_dgcnn_eval`` replaces vcrnet_tpu/ops/pallas_dgcnn.py:fused_dgcnn_eval:
x [B, N, 3], idx [B, N, k] (the xyz kNN selection) and the five folded
(W, b) pairs -> [B, N, emb_dims] f32: gather, four per-edge stages
``relu(h W + b)`` of widths 64, 64, 128, 256 with a max over the k
neighbours after each, and the projection of the 512-wide concat. Eval-mode
BatchNorm is an affine per channel and is folded into each stage's bias-free
Dense by ``fold_dgcnn_eval_params``. Products take bf16 operands (xyz, the
weights and every activation are rounded to bf16 before their product) and
accumulate in f32; bias and ReLU are f32; the output is f32.

A CUDA tensor launches ``csrc/dgcnn_eval.cu`` (two kernels: the edge chain,
streaming one neighbour slot of 64 queries at a time through the four stages
with running maxima, and the projection on ``csrc/gemm_wgmma.cuh``; one
counted launch) or raises; a CPU tensor runs
``fused_dgcnn_eval_ref``, which keeps the same rounding points. Eval only:
there is no backward, and the wrapper raises where a gradient is wanted.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build, library
from vcrnet_tpu_torch.ops._common import check_aligned, check_tensor, kernel_route
from vcrnet_tpu_torch.ops.graph import gather_neighbors

STAGE_WIDTHS = ((6, 64), (64, 64), (64, 128), (128, 256))
CAT_WIDTH = 512


def fold_bn_dense(kernel, scale, bias, mean, var, eps: float = 1e-5):
    """Eval-mode BatchNorm folded into the bias-free Dense before it:
    BN(x @ W) = x @ (W s) + (beta - mean s), s = gamma / sqrt(var + eps).
    ``kernel`` is [in, out]; returns (W' , b') in f32."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    return kernel.float() * s[None, :], bias.float() - mean.float() * s


def fold_dgcnn_eval_params(dgcnn, eps: float = 1e-5) -> list:
    """A ``models.embeddings.DGCNN`` module -> the kernel's folded weights
    [(W1', b1'), ..., (W5', b5')] (f32, W [in, out]) from its convs and the
    running statistics of its BatchNorms."""
    folded = []
    for i in range(1, 6):
        conv, bn = getattr(dgcnn, f"conv{i}"), getattr(dgcnn, f"bn{i}")
        folded.append(fold_bn_dense(conv.weight.t(), bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, eps))
    return folded


CLOUD_MAX = 4096  # points of a cloud the edge kernel stages in shared memory


def dgcnn_eval_smem_bytes() -> int:
    """Shared memory of the edge kernel (csrc/dgcnn_eval.cu), at any N and
    k: 1 KB of alignment, the weights W1..W4 as twelve [64, 64] bf16 boxes,
    two warpgroups' stage-4 running maxima ([64, 256] bf16 each), the
    biases b1..b4 (f32), a cloud of up to 4096 points (f32 xyz) and the
    weights' barrier."""
    box = 64 * 64 * 2
    return 1024 + 12 * box + 2 * 64 * 256 * 2 + 4 * 512 + 12 * CLOUD_MAX + 8


def fused_dgcnn_supported(n: int, k: int, emb_dims: int) -> bool:
    """Shapes the kernel takes: an output width the projection tiles (128
    columns a pass) and 0 < k < N. Any N: the edge kernel clamps the reads
    of a ragged last tile and skips its writes, and the projection takes
    any number of rows. The edge kernel streams the neighbour slots, so its
    shared memory depends on neither N nor k."""
    return emb_dims % 128 == 0 and 0 < k < n


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fused_dgcnn_eval_ref(x, idx, folded, emb_dims: int) -> torch.Tensor:
    """Plain version of :func:`fused_dgcnn_eval`, with its rounding points."""
    (w1, b1), *rest = [(w.float(), b.float()) for w, b in folded]
    if rest[-1][0].shape[1] != emb_dims:
        raise ValueError(f"W5 is {tuple(rest[-1][0].shape)}, emb_dims={emb_dims}")
    xb = _bf16_round(x.float())
    w1 = _bf16_round(w1)
    h = torch.matmul(gather_neighbors(xb, idx), w1[:3]) + torch.matmul(xb, w1[3:])[:, :, None]
    h = torch.relu(h + b1)
    pooled = [h.amax(dim=2)]
    for w, b in rest[:-1]:
        h = torch.relu(torch.matmul(_bf16_round(h), _bf16_round(w)) + b)
        pooled.append(h.amax(dim=2))
    w5, b5 = rest[-1]
    cat = _bf16_round(torch.cat(pooled, dim=-1))
    return torch.relu(torch.matmul(cat, _bf16_round(w5)) + b5)


def fused_dgcnn_eval(x: torch.Tensor, idx: torch.Tensor, folded, emb_dims: int) -> torch.Tensor:
    """x [B, N, 3] (any float dtype), idx [B, N, k] int32 with entries in
    [0, N), folded = :func:`fold_dgcnn_eval_params` -> [B, N, emb_dims] f32.
    The kernel takes :func:`fused_dgcnn_supported` shapes and raises on any
    other, as the Pallas wrapper does on an N it cannot tile. Runs the op
    ``vcrnet_torch::dgcnn_eval`` (``folded`` flattened to w1, b1, ..., w5,
    b5)."""
    tensors = [t for pair in folded for t in pair]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *tensors)):
        raise RuntimeError("fused_dgcnn_eval has no backward; call it under torch.no_grad()")
    if kernel_route(x, idx, *tensors):
        B, N, _ = x.shape
        k = idx.shape[-1]
        if not fused_dgcnn_supported(N, k, emb_dims):
            raise ValueError(
                f"fused_dgcnn_eval kernel does not take N={N} k={k} emb_dims={emb_dims} "
                f"(emb_dims % 128 == 0, 0 < k < N)"
            )
        x = x.float().contiguous()
        check_tensor("x", x, torch.float32, (B, N, 3))
        check_tensor("idx", idx, torch.int32, (B, N, k))
        tensors = []
        for (w, b), shape in zip(folded, STAGE_WIDTHS + ((CAT_WIDTH, emb_dims),)):
            w, b = w.to(torch.bfloat16).contiguous(), b.float().contiguous()
            check_tensor("folded weight", w, torch.bfloat16, shape)
            check_tensor("folded bias", b, torch.float32, shape[1:])
            tensors += [w, b]
    return _dgcnn_eval_op(x, idx, tensors, emb_dims)


def _dgcnn_eval_impl(x, idx, folded, emb_dims: int):
    if not kernel_route(x, idx, *folded):
        return fused_dgcnn_eval_ref(x, idx, list(zip(folded[::2], folded[1::2])), emb_dims)
    check_aligned(x=x, idx=idx, **{f"folded[{i}]": t for i, t in enumerate(folded)})
    B, N, _ = x.shape
    out = torch.empty((B, N, emb_dims), dtype=torch.float32, device=x.device)
    _build.extension().dgcnn_eval(x, idx, folded, out)
    fused_dgcnn_eval.launches += 1
    return out


def _dgcnn_eval_fake(x, idx, folded, emb_dims: int):
    return x.new_empty((*x.shape[:2], emb_dims), dtype=torch.float32)


_dgcnn_eval_op = library.define(
    "dgcnn_eval", "(Tensor x, Tensor idx, Tensor[] folded, int emb_dims) -> Tensor",
    _dgcnn_eval_impl, _dgcnn_eval_fake)


fused_dgcnn_eval.launches = 0
