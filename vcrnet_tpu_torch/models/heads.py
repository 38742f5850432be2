"""Virtual-correspondence head, whole mode (counterpart of
vcrnet_tpu/models/heads.py:vcp_top_k_whole and the head choice of
vcrnet_tpu/models/vcrnet.py:VCRNet._vcp)."""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops.graph import neg_pairwise_sqdist
from vcrnet_tpu_torch.ops.vcp import soft_correspondence_vjp


def vcp_top_k_whole(src_emb, tgt_emb, src, tgt, fused: bool = False):
    """(srcK, src_corrK): each source point and its soft virtual
    correspondence, the softmax(-|e_i - f_j|^2)-weighted mean of the
    target points. ``fused`` (the CUDA bf16 route) streams it through the
    kernels of ``ops.vcp.soft_correspondence_vjp`` (the backward kernel too
    where a gradient is wanted), which raises on shapes they do not take.
    Otherwise the plain formulation of the JAX package's XLA path."""
    if fused:
        return src, soft_correspondence_vjp(src_emb, tgt_emb, tgt)
    scores = torch.softmax(neg_pairwise_sqdist(src_emb, tgt_emb), dim=2)
    return src, torch.matmul(scores, tgt.float())
