"""Virtual-correspondence head, whole mode (counterpart of
vcrnet_tpu/models/heads.py:vcp_top_k_whole)."""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops.graph import neg_pairwise_sqdist
from vcrnet_tpu_torch.ops.vcp import streaming_soft_correspondence


def vcp_top_k_whole(src_emb, tgt_emb, src, tgt, fused: bool = False):
    """(srcK, src_corrK): each source point and its soft virtual
    correspondence, the softmax(-|e_i - f_j|^2)-weighted mean of the
    target points. ``fused`` (the CUDA bf16 route) streams it through
    ``ops.vcp.streaming_soft_correspondence``, which raises on shapes its
    kernel does not take."""
    if fused:
        return src, streaming_soft_correspondence(src_emb, tgt_emb, tgt)
    scores = torch.softmax(neg_pairwise_sqdist(src_emb, tgt_emb), dim=2)
    return src, torch.matmul(scores, tgt.float())
