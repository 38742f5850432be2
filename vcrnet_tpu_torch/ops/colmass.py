"""Column masses of a row softmax over packed heads, as a kernel beside its
plain version.

``softmax_colmass`` replaces vcrnet_tpu/ops/pallas_colmass.py:softmax_colmass
(its two kernels, row statistics and column sums): for q [B, Nq, H*dk] and
k [B, Nk, H*dk], head h being the column block [h*dk, (h+1)*dk),

    out[b, h, j] = sum_i softmax_j'(q_i . k_j' * sm_scale)[j]      [B, H, Nk] f32

without the [B, H, Nq, Nk] probabilities in device memory. The JAX function
takes heads merged into the batch ([G, N, dk]); the port keeps the packed
layout of its attention, so no head transpose is made. The partial-overlap
re-mask keeps the keys with the largest masses summed over heads
(models/transformer.py); that sum and the ``topk`` stay outside.

A CUDA tensor launches ``csrc/colmass.cu`` (or raises); a CPU tensor runs
``softmax_colmass_ref``. The wrapper counts its launches in ``.launches``
(one per call: the two kernels run back to back). No backward: the masses
only feed a hard selection.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build, library
from vcrnet_tpu_torch.ops._common import check_aligned, check_tensor, kernel_route
from vcrnet_tpu_torch.ops.attention import HEAD_DIM, _scores


def colmass_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the kernels take: dk == 128 and any lengths (the last query
    tile adds the masses of its real rows alone, by a count; the last key
    block stores only its real keys)."""
    return d_model % n_heads == 0 and d_model // n_heads == HEAD_DIM and nq > 0 and nk > 0


def softmax_colmass_ref(q, k, sm_scale: float, n_heads: int):
    """Plain version: the f32 row softmax written out and summed over the
    queries."""
    return torch.softmax(_scores(q, k, sm_scale, n_heads), dim=-1).sum(dim=2)


def softmax_colmass(q: torch.Tensor, k: torch.Tensor, sm_scale: float, n_heads: int):
    """Column masses [B, H, Nk] f32; see the module docstring. The kernel
    takes bf16 with :func:`colmass_supported` shapes. Runs the op
    ``vcrnet_torch::softmax_colmass``."""
    if kernel_route(q, k):
        B, nq, d = q.shape
        nk = k.shape[1]
        if not colmass_supported(nq, nk, d, n_heads):
            raise ValueError(
                f"softmax_colmass kernel takes dk == {HEAD_DIM}, "
                f"got nq={nq} nk={nk} d_model={d} heads={n_heads}"
            )
        check_tensor("q", q, torch.bfloat16, (B, nq, d))
        check_tensor("k", k, torch.bfloat16, (B, nk, d))
    return _softmax_colmass_op(q, k, float(sm_scale), n_heads)


def _softmax_colmass_impl(q, k, sm_scale: float, n_heads: int):
    if not kernel_route(q, k):
        return softmax_colmass_ref(q, k, sm_scale, n_heads)
    check_aligned(q=q, k=k)
    B, nq, _ = q.shape
    nk = k.shape[1]
    # scratch of the row logsumexps, read back in whole 64-query tiles
    lse = torch.empty((B, n_heads, nq + -nq % 64), dtype=torch.float32, device=q.device)
    out = torch.empty((B, n_heads, nk), dtype=torch.float32, device=q.device)
    _build.extension().softmax_colmass(q, k, lse, out, n_heads, sm_scale)
    softmax_colmass.launches += 1
    return out


def _softmax_colmass_fake(q, k, sm_scale: float, n_heads: int):
    return q.new_empty((q.shape[0], n_heads, k.shape[1]), dtype=library.stat_dtype(q))


_softmax_colmass_op = library.define(
    "softmax_colmass", "(Tensor q, Tensor k, float sm_scale, int n_heads) -> Tensor",
    _softmax_colmass_impl, _softmax_colmass_fake)


softmax_colmass.launches = 0
