"""Attention over packed heads, as kernels beside their plain versions.

``flash_mha_packed`` replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed:
q [B, Nq, H*dk], k/v [B, Nk, H*dk] -> [B, Nq, H*dk], head h being the
column block [h*dk, (h+1)*dk). ``flash_bwd`` replaces the one-pass
backward ``_bwd_fused`` (its training forward, the stock TPU flash kernel
``_fwd_library``, is ``flash_mha_packed`` with the row logsumexp saved).
A CUDA tensor launches ``csrc/flash_packed.cu`` / ``csrc/flash_bwd.cu``
(or raises); a CPU tensor runs the ``*_ref`` plain version. Each wrapper
counts its launches in ``.launches``; ``attention`` is the differentiable
entry point, which the model calls in eval and in training.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import check_tensor, kernel_route, upcast

HEAD_DIM = 128  # the kernels' dk


def flash_packed_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the kernels take: dk == 128 and both lengths a multiple of
    64 (the TPU gate, pallas_attention.py:flash_packed_supported, asked
    for multiples of 128; every shape it accepts is accepted here)."""
    return (
        d_model % n_heads == 0 and d_model // n_heads == HEAD_DIM
        and nq % 64 == 0 and nk % 64 == 0
    )


def _split(x, n_heads):
    B, n, d = x.shape
    return x.reshape(B, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(x4):
    B, H, n, dk = x4.shape
    return x4.transpose(1, 2).reshape(B, n, H * dk)


def _scores(q, k, sm_scale, n_heads):
    return torch.matmul(upcast(_split(q, n_heads)),
                        upcast(_split(k, n_heads)).transpose(-1, -2)) * sm_scale


def flash_mha_packed_ref(q, k, v, sm_scale: float, n_heads: int, return_lse: bool = False):
    """Plain version: f32 scores, softmax statistics against the row max,
    probabilities rounded to v's dtype before the product and divided by
    the f32 row sum afterwards (_fwd_packed_kernel's rounding points).
    ``return_lse`` adds the row logsumexp [B, H, Nq] f32."""
    s = _scores(q, k, sm_scale, n_heads)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(upcast(e.to(v.dtype)), upcast(_split(v, n_heads))) / l
    o = _merge(o).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if return_lse else o


def flash_mha_packed(q, k, v, sm_scale: float, n_heads: int, return_lse: bool = False):
    """Packed-head attention; see the module docstring. The kernel takes
    bf16 with :func:`flash_packed_supported` shapes."""
    if not kernel_route(q, k, v):
        return flash_mha_packed_ref(q, k, v, sm_scale, n_heads, return_lse)
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
    lse = (torch.empty((B, n_heads, nq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _build.extension().flash_packed(q, k, v, out, lse, n_heads, float(sm_scale))
    flash_mha_packed.launches += 1
    return (out, lse) if return_lse else out


flash_mha_packed.launches = 0


def flash_mha_packed_bwd_ref(q, k, v, o, lse, do, sm_scale: float, n_heads: int):
    """Plain version of :func:`flash_bwd`, with _bwd_kernel's rounding
    points: do rounded to v's dtype before do @ v^T, ds and p rounded to
    q's dtype before the products, f32 accumulation, results in the inputs'
    dtypes. p is exp(s - lse) from the forward's logsumexp (the TPU kernel
    recomputes the row statistics; the function is the same)."""
    s = _scores(q, k, sm_scale, n_heads)
    p = torch.exp(s - lse[..., None])
    do4 = upcast(_split(do, n_heads))
    delta = (do4 * upcast(_split(o, n_heads))).sum(-1, keepdim=True)
    dp = torch.matmul(upcast(do4.to(v.dtype)), upcast(_split(v, n_heads)).transpose(-1, -2))
    ds = upcast((p * (dp - delta) * sm_scale).to(q.dtype))
    p_c = upcast(p.to(q.dtype))
    dq = torch.matmul(ds, upcast(_split(k, n_heads)))
    dk = torch.matmul(ds.transpose(-1, -2), upcast(_split(q, n_heads)))
    dv = torch.matmul(p_c.transpose(-1, -2), upcast(do4.to(v.dtype)))
    return _merge(dq).to(q.dtype), _merge(dk).to(k.dtype), _merge(dv).to(v.dtype)


def flash_bwd(q, k, v, o, lse, do, sm_scale: float, n_heads: int):
    """(dq, dk, dv) of packed-head attention, each in its input's layout
    and dtype, from the forward's output ``o`` and logsumexp ``lse``
    [B, H, Nq] f32. The kernel takes bf16 with :func:`flash_packed_supported`
    shapes."""
    if not kernel_route(q, k, v, o, lse, do):
        return flash_mha_packed_bwd_ref(q, k, v, o, lse, do, sm_scale, n_heads)
    B, nq, d = q.shape
    nk = k.shape[1]
    if not flash_packed_supported(nq, nk, d, n_heads):
        raise ValueError(
            f"flash_bwd kernel does not take nq={nq} nk={nk} d_model={d} heads={n_heads}"
        )
    bf16 = torch.bfloat16
    for name, t, n in (("q", q, nq), ("k", k, nk), ("v", v, nk), ("o", o, nq), ("do", do, nq)):
        check_tensor(name, t, bf16, (B, n, d))
    check_tensor("lse", lse, torch.float32, (B, n_heads, nq))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.extension().flash_bwd(q, k, v, o, do, lse, delta, dq, dk, dv, n_heads,
                                 float(sm_scale))
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, n_heads, grad_enabled):
        if not (grad_enabled and any(ctx.needs_input_grad[:3])):
            return flash_mha_packed(q, k, v, sm_scale, n_heads)
        o, lse = flash_mha_packed(q, k, v, sm_scale, n_heads, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, n_heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None


def attention(q, k, v, sm_scale: float, n_heads: int):
    """Differentiable :func:`flash_mha_packed`, for eval and training: the
    forward saves its logsumexp only when a gradient is wanted, and the
    backward is :func:`flash_bwd`."""
    return _Attention.apply(q, k, v, sm_scale, n_heads, torch.is_grad_enabled())
