"""Whole-cloud soft correspondence as a streaming kernel beside its plain
version.

``streaming_soft_correspondence`` replaces
vcrnet_tpu/ops/pallas_vcp.py:streaming_soft_correspondence:

    corr_i = sum_j softmax_j(2 e_i . f_j - |f_j|^2) * tgt_j

(the |e_i|^2 term of -|e_i - f_j|^2 is constant per row and cancels). A
CUDA tensor launches ``csrc/vcp_stream.cu`` (or raises); a CPU tensor runs
:func:`streaming_soft_correspondence_ref`. The wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops._common import check_tensor, kernel_route


def streaming_soft_correspondence_ref(src_emb, tgt_emb, tgt):
    """Plain version: the full [B, Ns, Nt] softmax in f32."""
    f = tgt_emb.float()
    s = 2.0 * torch.matmul(src_emb.float(), f.transpose(1, 2)) - (f * f).sum(-1)[:, None, :]
    return torch.matmul(torch.softmax(s, dim=-1), tgt.float())


def streaming_supported(ns: int, nt: int, e: int) -> bool:
    return ns % 64 == 0 and nt % 64 == 0 and e % 16 == 0


def streaming_soft_correspondence(src_emb, tgt_emb, tgt):
    """src_emb [B, Ns, E], tgt_emb [B, Nt, E], tgt [B, Nt, 3] -> [B, Ns, 3]
    f32. The kernel takes bf16 embeddings, f32 tgt, and
    :func:`streaming_supported` shapes."""
    if not kernel_route(src_emb, tgt_emb, tgt):
        return streaming_soft_correspondence_ref(src_emb, tgt_emb, tgt)
    B, ns, e = src_emb.shape
    nt = tgt_emb.shape[1]
    if not streaming_supported(ns, nt, e):
        raise ValueError(f"vcp kernel does not take Ns={ns} Nt={nt} E={e}")
    check_tensor("src_emb", src_emb, torch.bfloat16, (B, ns, e))
    check_tensor("tgt_emb", tgt_emb, torch.bfloat16, (B, nt, e))
    check_tensor("tgt", tgt, torch.float32, (B, nt, 3))
    norms = tgt_emb.float().square().sum(-1)
    out = torch.empty((B, ns, 3), dtype=torch.float32, device=tgt.device)
    _build.extension().vcp_stream(src_emb, tgt_emb, norms, tgt, out)
    streaming_soft_correspondence.launches += 1
    return out


streaming_soft_correspondence.launches = 0
