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

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import check_tensor, kernel_route
from vcrnet_tpu_torch.ops.attention import HEAD_DIM, _scores


def colmass_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the kernels take: dk == 128 and both lengths a multiple of 64."""
    return (
        d_model % n_heads == 0 and d_model // n_heads == HEAD_DIM
        and nq % 64 == 0 and nk % 64 == 0
    )


def softmax_colmass_ref(q, k, sm_scale: float, n_heads: int):
    """Plain version: the f32 row softmax written out and summed over the
    queries."""
    return torch.softmax(_scores(q, k, sm_scale, n_heads), dim=-1).sum(dim=2)


def softmax_colmass(q: torch.Tensor, k: torch.Tensor, sm_scale: float, n_heads: int):
    """Column masses [B, H, Nk] f32; see the module docstring. The kernel
    takes bf16 with :func:`colmass_supported` shapes."""
    if not kernel_route(q, k):
        return softmax_colmass_ref(q, k, sm_scale, n_heads)
    B, nq, d = q.shape
    nk = k.shape[1]
    if not colmass_supported(nq, nk, d, n_heads):
        raise ValueError(
            f"softmax_colmass kernel takes dk == {HEAD_DIM}, Nq % 64 == 0 and Nk % 64 == 0, "
            f"got nq={nq} nk={nk} d_model={d} heads={n_heads}"
        )
    check_tensor("q", q, torch.bfloat16, (B, nq, d))
    check_tensor("k", k, torch.bfloat16, (B, nk, d))
    lse = torch.empty((B, n_heads, nq), dtype=torch.float32, device=q.device)
    out = torch.empty((B, n_heads, nk), dtype=torch.float32, device=q.device)
    _build.extension().softmax_colmass(q, k, lse, out, n_heads, float(sm_scale))
    softmax_colmass.launches += 1
    return out


softmax_colmass.launches = 0
