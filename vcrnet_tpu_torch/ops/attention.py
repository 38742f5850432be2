"""Attention over packed heads, as kernels beside their plain versions.

``flash_mha_packed`` replaces vcrnet_tpu/ops/pallas_attention.py:flash_mha_packed:
q [B, Nq, H*dk], k/v [B, Nk, H*dk] -> [B, Nq, H*dk], head h being the
column block [h*dk, (h+1)*dk). ``flash_bwd`` replaces the one-pass
backward ``_bwd_fused`` (its training forward, the stock TPU flash kernel
``_fwd_library``, is ``flash_mha_packed`` with the row logsumexp saved).
A CUDA tensor launches ``csrc/flash_packed.cu`` / ``csrc/flash_bwd.cu``
(or raises); a CPU tensor runs the ``*_ref`` plain version. Each wrapper
counts its launches in ``.launches``; ``attention`` is the differentiable
entry point, which the model calls in eval and in training. The forward runs
through the op ``vcrnet_torch::flash_packed`` (``ops/library.py``), the
backward calls the extension directly.

``nk_valid`` is the count of real keys when k and v carry padding rows
behind them (the counterpart of ``nk_valid`` in pallas_attention.py:
_fwd_packed_kernel): keys at or beyond it are masked out of the softmax.
The kernels take any Nq and Nk: a last query tile stores only the rows
below Nq, and a last key tile masks the keys past Nk (the next item's rows,
or zeros past the end of the tensor) by a count, so no q, k or v is padded.
The backward streams each 64-query tile's lse and delta by one bulk copy,
so ``flash_bwd`` hands it the lse padded per (b, h) to whole tiles with
+inf (p = 0 there); ``flash_bwd`` takes no valid-key count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vcrnet_tpu_torch.ops import _build, library
from vcrnet_tpu_torch.ops._common import check_aligned, check_tensor, kernel_route, upcast

HEAD_DIM = 128  # the kernels' dk


def flash_packed_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the forward kernel takes: dk == 128 and any lengths (the TPU
    gate, pallas_attention.py:flash_packed_supported, asked for multiples
    of 128; every shape it accepts is accepted here)."""
    return d_model % n_heads == 0 and d_model // n_heads == HEAD_DIM and nq > 0 and nk > 0


def flash_bwd_supported(nq: int, nk: int, d_model: int, n_heads: int) -> bool:
    """Shapes the backward kernels take: the forward's (dk == 128, any
    lengths; the last tiles of each item are ragged)."""
    return flash_packed_supported(nq, nk, d_model, n_heads)


def _split(x, n_heads):
    B, n, d = x.shape
    return x.reshape(B, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(x4):
    B, H, n, dk = x4.shape
    return x4.transpose(1, 2).reshape(B, n, H * dk)


def _scores(q, k, sm_scale, n_heads):
    return torch.matmul(upcast(_split(q, n_heads)),
                        upcast(_split(k, n_heads)).transpose(-1, -2)) * sm_scale


def _check_nk_valid(nk_valid, nk: int) -> None:
    if nk_valid is not None and not 0 < nk_valid <= nk:
        raise ValueError(f"nk_valid={nk_valid} must be in [1, Nk={nk}]")


def flash_mha_packed_ref(q, k, v, sm_scale: float, n_heads: int, return_lse: bool = False,
                         nk_valid: int | None = None):
    """Plain version: f32 scores, softmax statistics against the row max,
    probabilities rounded to v's dtype before the product and divided by
    the f32 row sum afterwards (_fwd_packed_kernel's rounding points).
    ``return_lse`` adds the row logsumexp [B, H, Nq] f32; keys at or beyond
    ``nk_valid`` are masked out."""
    _check_nk_valid(nk_valid, k.shape[1])
    s = _scores(q, k, sm_scale, n_heads)
    if nk_valid is not None:
        s[..., nk_valid:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(upcast(e.to(v.dtype)), upcast(_split(v, n_heads))) / l
    o = _merge(o).to(q.dtype)
    return (o, (m + torch.log(l))[..., 0]) if return_lse else o


def flash_mha_packed(q, k, v, sm_scale: float, n_heads: int, return_lse: bool = False,
                     nk_valid: int | None = None):
    """Packed-head attention; see the module docstring. The kernel takes
    bf16 with :func:`flash_packed_supported` shapes; with ``nk_valid`` the
    rows of k and v at or beyond it must be finite (zeros). Runs the op
    ``vcrnet_torch::flash_packed``."""
    if kernel_route(q, k, v):
        B, nq, d = q.shape
        nk = k.shape[1]
        _check_nk_valid(nk_valid, nk)
        if not flash_packed_supported(nq, nk, d, n_heads):
            raise ValueError(
                f"flash_mha_packed kernel does not take nq={nq} nk={nk} d_model={d} "
                f"heads={n_heads}"
            )
        check_tensor("q", q, torch.bfloat16, (B, nq, d))
        check_tensor("k", k, torch.bfloat16, (B, nk, d))
        check_tensor("v", v, torch.bfloat16, (B, nk, d))
    out, lse = _flash_packed_op(q, k, v, float(sm_scale), n_heads, return_lse, nk_valid)
    return (out, lse) if return_lse else out


def _flash_packed_impl(q, k, v, sm_scale: float, n_heads: int, return_lse: bool,
                       nk_valid: int | None):
    if not kernel_route(q, k, v):
        out = flash_mha_packed_ref(q, k, v, sm_scale, n_heads, return_lse, nk_valid)
        return out if return_lse else (out, library.empty_output(q, library.stat_dtype(q)))
    check_aligned(q=q, k=k, v=v)
    B, nq, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, n_heads, nq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    _build.extension().flash_packed(q, k, v, out, lse, k.shape[1] if nk_valid is None else nk_valid,
                                    n_heads, sm_scale)
    flash_mha_packed.launches += 1
    return out, lse if return_lse else library.empty_output(q, torch.float32)


def _flash_packed_fake(q, k, v, sm_scale: float, n_heads: int, return_lse: bool,
                       nk_valid: int | None):
    B, nq, _ = q.shape
    lse_shape = (B, n_heads, nq) if return_lse else (0,)
    return q.new_empty(q.shape), q.new_empty(lse_shape, dtype=library.stat_dtype(q))


_flash_packed_op = library.define(
    "flash_packed",
    "(Tensor q, Tensor k, Tensor v, float sm_scale, int n_heads, bool return_lse, "
    "int? nk_valid) -> (Tensor, Tensor)",
    _flash_packed_impl, _flash_packed_fake)


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
    [B, H, Nq] f32. The kernel takes bf16 with :func:`flash_bwd_supported`
    shapes."""
    if not kernel_route(q, k, v, o, lse, do):
        return flash_mha_packed_bwd_ref(q, k, v, o, lse, do, sm_scale, n_heads)
    B, nq, d = q.shape
    nk = k.shape[1]
    if not flash_bwd_supported(nq, nk, d, n_heads):
        raise ValueError(
            f"flash_bwd kernel does not take nq={nq} nk={nk} d_model={d} heads={n_heads}"
        )
    bf16 = torch.bfloat16
    for name, t, n in (("q", q, nq), ("k", k, nk), ("v", v, nk), ("o", o, nq), ("do", do, nq)):
        check_tensor(name, t, bf16, (B, n, d))
    check_tensor("lse", lse, torch.float32, (B, n_heads, nq))
    if nq % 64:  # the kernels read whole 64-value tiles of lse: +inf past Nq gives p = 0
        lse = F.pad(lse, (0, -nq % 64), value=float("inf"))
    check_aligned(q=q, k=k, v=v, o=o, lse=lse, do=do)
    delta = torch.empty_like(lse)  # the kernels' scratch, 0 past Nq
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
    backward is :func:`flash_bwd`. Any lengths run, with a gradient too."""
    return _Attention.apply(q, k, v, sm_scale, n_heads, torch.is_grad_enabled())
