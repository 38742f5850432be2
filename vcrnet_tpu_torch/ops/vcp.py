"""Whole-cloud soft correspondence as streaming kernels beside their plain
versions.

``streaming_soft_correspondence`` replaces
vcrnet_tpu/ops/pallas_vcp.py:streaming_soft_correspondence:

    corr_i = sum_j softmax_j(2 e_i . f_j - |f_j|^2) * tgt_j

(the |e_i|^2 term of -|e_i - f_j|^2 is constant per row and cancels), and
``vcp_bwd`` its backward ``_vcp_bwd``. A CUDA tensor launches
``csrc/vcp_stream.cu`` / ``csrc/vcp_bwd.cu`` (or raises); a CPU tensor runs
the ``*_ref`` plain version. Each wrapper counts its launches in
``.launches``; ``soft_correspondence_vjp`` is the differentiable entry
point, which the model calls in eval and in training. The forward runs
through the op ``vcrnet_torch::vcp_stream`` (``ops/library.py``), the
backward calls the extension directly.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build, library
from vcrnet_tpu_torch.ops._common import check_aligned, check_tensor, kernel_route, upcast


def _scores(src_emb, tgt_emb):
    f = upcast(tgt_emb)
    return 2.0 * torch.matmul(upcast(src_emb), f.transpose(1, 2)) - (f * f).sum(-1)[:, None, :]


def streaming_soft_correspondence_ref(src_emb, tgt_emb, tgt, return_lse: bool = False):
    """Plain version: the full [B, Ns, Nt] softmax in f32; ``return_lse``
    adds the row logsumexp [B, Ns] f32."""
    s = _scores(src_emb, tgt_emb)
    corr = torch.matmul(torch.softmax(s, dim=-1), upcast(tgt))
    return (corr, torch.logsumexp(s, dim=-1)) if return_lse else corr


# Both kernels cut their rows and tiles into eight [64, 64] boxes at most,
# and the backward splits its [64, E] f32 accumulator between two
# warpgroups' registers: E <= 512 (ROADMAP C, "VCP kernels' gate").
MAX_E = 512


def streaming_supported(ns: int, nt: int, e: int) -> bool:
    """Shapes the forward kernel takes: whole k16 steps, E <= 512, any
    lengths (the last block stores only its real rows; the keys past Nt
    of the last tile have an infinite norm and score -inf)."""
    return ns > 0 and nt > 0 and e % 16 == 0 and e <= MAX_E


def streaming_soft_correspondence(src_emb, tgt_emb, tgt, return_lse: bool = False):
    """src_emb [B, Ns, E], tgt_emb [B, Nt, E], tgt [B, Nt, 3] -> [B, Ns, 3]
    f32 (and the row logsumexp [B, Ns] f32 with ``return_lse``). The kernel
    takes bf16 embeddings, f32 tgt, and :func:`streaming_supported` shapes.
    Runs the op ``vcrnet_torch::vcp_stream``."""
    if kernel_route(src_emb, tgt_emb, tgt):
        B, ns, e = src_emb.shape
        nt = tgt_emb.shape[1]
        if not streaming_supported(ns, nt, e):
            raise ValueError(f"vcp kernel does not take Ns={ns} Nt={nt} E={e}")
        check_tensor("src_emb", src_emb, torch.bfloat16, (B, ns, e))
        check_tensor("tgt_emb", tgt_emb, torch.bfloat16, (B, nt, e))
        check_tensor("tgt", tgt, torch.float32, (B, nt, 3))
    out, lse = _vcp_stream_op(src_emb, tgt_emb, tgt, return_lse)
    return (out, lse) if return_lse else out


def _vcp_stream_impl(src_emb, tgt_emb, tgt, return_lse: bool):
    if not kernel_route(src_emb, tgt_emb, tgt):
        out = streaming_soft_correspondence_ref(src_emb, tgt_emb, tgt, return_lse)
        return out if return_lse else (out, library.empty_output(out, out.dtype))
    check_aligned(src_emb=src_emb, tgt_emb=tgt_emb, tgt=tgt)
    B, ns, _ = src_emb.shape
    nt = tgt_emb.shape[1]
    f32 = torch.float32
    # x, y, z, |f|^2 of whole 64-key tiles (the kernel's packing pass
    # fills the entries past Nt with (0, 0, 0, +inf))
    keys = torch.empty((B, nt + -nt % 64, 4), dtype=f32, device=tgt.device)
    out = torch.empty((B, ns, 3), dtype=f32, device=tgt.device)
    lse = torch.empty((B, ns), dtype=f32, device=tgt.device) if return_lse else None
    _build.extension().vcp_stream(src_emb, tgt_emb, tgt, keys, out, lse)
    streaming_soft_correspondence.launches += 1
    return out, lse if return_lse else library.empty_output(out, f32)


def _vcp_stream_fake(src_emb, tgt_emb, tgt, return_lse: bool):
    B, ns, _ = src_emb.shape
    dtype = library.stat_dtype(src_emb)
    return (tgt.new_empty((B, ns, 3), dtype=dtype),
            tgt.new_empty((B, ns) if return_lse else (0,), dtype=dtype))


_vcp_stream_op = library.define(
    "vcp_stream", "(Tensor src_emb, Tensor tgt_emb, Tensor tgt, bool return_lse) -> (Tensor, Tensor)",
    _vcp_stream_impl, _vcp_stream_fake)


streaming_soft_correspondence.launches = 0


def streaming_vjp_supported(ns: int, nt: int, e: int) -> bool:
    """Shapes the backward kernels take (the counterpart of the TPU's VMEM
    gate pallas_vcp.py:streaming_vjp_supported): the forward's, at any
    lengths (the last tiles of each item are ragged: keys past Nt have an
    infinite norm, source rows past Ns a zero gradient and an lse of +inf,
    so both give p = 0)."""
    return streaming_supported(ns, nt, e)


def vcp_bwd_ref(src_emb, tgt_emb, tgt, corr, lse, dcorr):
    """Plain version of :func:`vcp_bwd`, with _vcp_bwd_kernel's rounding
    points: ds and p rounded to the embeddings' dtype before the products,
    dp and dtgt on f32 tgt and dcorr, f32 results."""
    p = torch.exp(_scores(src_emb, tgt_emb) - lse[..., None])
    g = upcast(dcorr)
    delta = (g * upcast(corr)).sum(-1, keepdim=True)
    dp = torch.matmul(g, upcast(tgt).transpose(1, 2))
    ds = upcast((p * (dp - delta)).to(src_emb.dtype))
    d_src = 2.0 * torch.matmul(ds, upcast(tgt_emb))
    d_tgt_emb = 2.0 * torch.matmul(ds.transpose(1, 2), upcast(src_emb))
    d_tgt_emb = d_tgt_emb - 2.0 * ds.sum(dim=1)[..., None] * upcast(tgt_emb)
    d_tgt = torch.matmul(upcast(p.to(src_emb.dtype)).transpose(1, 2), g)
    return d_src, d_tgt_emb, d_tgt


def vcp_bwd(src_emb, tgt_emb, tgt, corr, lse, dcorr):
    """Backward of the soft correspondence from the forward's output
    ``corr`` and logsumexp ``lse``: -> (d_src_emb [B, Ns, E], d_tgt_emb
    [B, Nt, E], d_tgt [B, Nt, 3]), f32. The kernel takes bf16 embeddings,
    f32 tgt/corr/dcorr/lse and :func:`streaming_vjp_supported` shapes."""
    if not kernel_route(src_emb, tgt_emb, tgt, corr, lse, dcorr):
        return vcp_bwd_ref(src_emb, tgt_emb, tgt, corr, lse, dcorr)
    B, ns, e = src_emb.shape
    nt = tgt_emb.shape[1]
    if not streaming_vjp_supported(ns, nt, e):
        raise ValueError(f"vcp_bwd kernel does not take Ns={ns} Nt={nt} E={e}")
    check_tensor("src_emb", src_emb, torch.bfloat16, (B, ns, e))
    check_tensor("tgt_emb", tgt_emb, torch.bfloat16, (B, nt, e))
    check_tensor("tgt", tgt, torch.float32, (B, nt, 3))
    for name, t in (("corr", corr), ("dcorr", dcorr)):
        check_tensor(name, t, torch.float32, (B, ns, 3))
    check_tensor("lse", lse, torch.float32, (B, ns))
    f32 = torch.float32
    # the kernels stream 64-row tiles of packed values a batch item, whole
    # tiles each: x, y, z, |f|^2 of the keys, (0, 0, 0, +inf) past Nt; g,
    # g . corr of the source rows, 0 past Ns (both written by the kernels'
    # packing passes), and lse, +inf past Ns
    keys = torch.empty((B, nt + -nt % 64, 4), dtype=f32, device=tgt.device)
    rows = torch.empty((B, ns + -ns % 64, 4), dtype=f32, device=tgt.device)
    check_aligned(src_emb=src_emb, tgt_emb=tgt_emb, tgt=tgt, corr=corr, lse=lse, dcorr=dcorr)
    if ns % 64:
        lse = torch.nn.functional.pad(lse, (0, -ns % 64), value=float("inf"))
    d_src = torch.empty((B, ns, e), dtype=f32, device=tgt.device)
    d_tgt_emb = torch.empty((B, nt, e), dtype=f32, device=tgt.device)
    d_tgt = torch.empty((B, nt, 3), dtype=f32, device=tgt.device)
    _build.extension().vcp_bwd(src_emb, tgt_emb, tgt, corr, dcorr, lse, keys, rows, d_src,
                               d_tgt_emb, d_tgt)
    vcp_bwd.launches += 1
    return d_src, d_tgt_emb, d_tgt


vcp_bwd.launches = 0


class _SoftCorrespondence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src_emb, tgt_emb, tgt, wants_grad):
        if not wants_grad:
            return streaming_soft_correspondence(src_emb, tgt_emb, tgt)
        corr, lse = streaming_soft_correspondence(src_emb, tgt_emb, tgt, return_lse=True)
        ctx.save_for_backward(src_emb, tgt_emb, tgt, corr, lse)
        return corr

    @staticmethod
    def backward(ctx, dcorr):
        src_emb, tgt_emb, tgt, corr, lse = ctx.saved_tensors
        d_src, d_tgt_emb, d_tgt = vcp_bwd(src_emb, tgt_emb, tgt, corr, lse, dcorr.contiguous())
        return d_src.to(src_emb.dtype), d_tgt_emb.to(tgt_emb.dtype), d_tgt.to(tgt.dtype), None


def soft_correspondence_vjp(src_emb, tgt_emb, tgt):
    """Differentiable streaming soft correspondence (pallas_vcp.py:
    soft_correspondence_vjp), for eval and training: where a gradient is
    wanted the forward saves its logsumexp and the backward is
    :func:`vcp_bwd`, and shapes :func:`streaming_vjp_supported` refuses
    (E > 512, E % 16) raise, on any device."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (src_emb, tgt_emb, tgt))
    B, ns, e = src_emb.shape
    if wants_grad and not streaming_vjp_supported(ns, tgt_emb.shape[1], e):
        raise ValueError(
            f"soft_correspondence_vjp does not take Ns={ns} Nt={tgt_emb.shape[1]} E={e}"
        )
    return _SoftCorrespondence.apply(src_emb, tgt_emb, tgt, wants_grad)
