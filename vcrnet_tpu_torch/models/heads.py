"""Virtual-correspondence heads, whole and partial-overlap mode
(counterparts of vcrnet_tpu/models/heads.py:vcp_top_k_whole and
vcp_top_k_partial and the head choice of
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


def _take(arr, idx):
    """Rows ``idx`` [B, K] of ``arr`` [B, N, C] -> [B, K, C]."""
    return torch.gather(arr, 1, idx[:, :, None].expand(-1, -1, arr.shape[-1]))


def vcp_top_k_partial(src_emb, tgt_emb, src, tgt, overlap2: float):
    """Partial-overlap correspondence selection in two stages, every
    selection a fixed-size top-k + gather:

    1. score the full clouds; keep the ``K1 = int(N * 0.84 * overlap2)``
       target points with the largest column mass of the row softmax and
       the K1 source points with the largest row mass of the column
       softmax: the likely-overlap subsets;
    2. rescore the subsets; each kept source point's best target is its
       correspondence, and the ``K2 = int(K1 * 0.52 * overlap2)`` source
       points with the most confident best match stay.

    The JAX package runs this head outside any Pallas kernel, on both its
    routes; so does the port. Its bf16 one-hot row selection is exact, so
    the indexed gather here equals it."""
    k1_src = int(src.shape[1] * 0.84 * overlap2)
    k1_tgt = int(tgt.shape[1] * 0.84 * overlap2)
    scores = neg_pairwise_sqdist(src_emb, tgt_emb)  # [B, Ns, Nt]

    tgt_idx = torch.topk(torch.softmax(scores, dim=2).sum(dim=1), k1_tgt).indices
    src_idx = torch.topk(torch.softmax(scores, dim=1).sum(dim=2), k1_src).indices
    src_sel, src_emb_sel = _take(src, src_idx), _take(src_emb, src_idx)
    tgt_sel, tgt_emb_sel = _take(tgt, tgt_idx), _take(tgt_emb, tgt_idx)

    k2 = int(k1_src * 0.52 * overlap2)
    p = torch.softmax(neg_pairwise_sqdist(src_emb_sel, tgt_emb_sel), dim=2)  # [B, K1, K1]
    conf, best_idx = p.max(dim=-1)  # the first index on ties
    keep = torch.topk(conf, k2).indices  # [B, K2]
    corr_idx = torch.gather(best_idx, 1, keep)
    return _take(src_sel, keep), _take(tgt_sel, corr_idx)
