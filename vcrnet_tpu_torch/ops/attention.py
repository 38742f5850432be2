"""Attention over packed heads, as a kernel beside its plain version.

``flash_mha_packed`` replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed:
q [B, Nq, H*dk], k/v [B, Nk, H*dk] -> [B, Nq, H*dk], head h being the
column block [h*dk, (h+1)*dk). A CUDA tensor launches ``csrc/flash_packed.cu``
(or raises); a CPU tensor runs :func:`flash_mha_packed_ref`. The wrapper counts
its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import check_tensor, kernel_route

HEAD_DIM = 128  # the kernel's dk


def flash_packed_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the kernel takes: dk == 128 and both lengths a multiple of
    64 (the TPU gate, pallas_attention.py:flash_packed_supported, asked
    for multiples of 128; every shape it accepts is accepted here)."""
    return (
        d_model % n_heads == 0 and d_model // n_heads == HEAD_DIM
        and nq % 64 == 0 and nk % 64 == 0
    )


def _split(x, n_heads):
    B, n, d = x.shape
    return x.reshape(B, n, n_heads, d // n_heads).transpose(1, 2)


def flash_mha_packed_ref(q, k, v, sm_scale: float, n_heads: int):
    """Plain version: f32 scores, softmax statistics against the row max,
    probabilities rounded to v's dtype before the product and divided by
    the f32 row sum afterwards (_fwd_packed_kernel's rounding points)."""
    B, nq, d = q.shape
    s = torch.matmul(_split(q, n_heads).float(), _split(k, n_heads).float().transpose(-1, -2))
    s = s * sm_scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(v.dtype).float(), _split(v, n_heads).float())
    o = o / e.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(B, nq, d).to(q.dtype)


def flash_mha_packed(q, k, v, sm_scale: float, n_heads: int):
    """Packed-head attention; see the module docstring. The kernel takes
    bf16 with :func:`flash_packed_supported` shapes."""
    if not kernel_route(q, k, v):
        return flash_mha_packed_ref(q, k, v, sm_scale, n_heads)
    B, nq, d = q.shape
    nk = k.shape[1]
    if not flash_packed_supported(nq, nk, d, n_heads):
        raise ValueError(
            f"flash_mha_packed kernel does not take nq={nq} nk={nk} d_model={d} heads={n_heads}"
        )
    check_tensor("q", q, torch.bfloat16, (B, nq, d))
    check_tensor("k", k, torch.bfloat16, (B, nk, d))
    check_tensor("v", v, torch.bfloat16, (B, nk, d))
    out = torch.empty_like(q)
    _build.extension().flash_packed(q, k, v, out, n_heads, float(sm_scale))
    flash_mha_packed.launches += 1
    return out


flash_mha_packed.launches = 0
