"""Virtual-correspondence heads: topK (whole and partial-overlap), dist
and att (counterparts of vcrnet_tpu/models/heads.py and the head choice of
vcrnet_tpu/models/vcrnet.py:VCRNet._vcp)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vcrnet_tpu_torch.ops.graph import neg_pairwise_sqdist, take_rows
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


def vcp_by_dis(src_emb, tgt_emb, src, tgt):
    """(srcK, src_corrK) by the scaled dot product (``vcp_nn="dist"``,
    reference VcpByDis): softmax_j(e_i . f_j / sqrt(d)) over the target
    points, then the weighted target points. The scores and the softmax in
    the embeddings' dtype, divided by sqrt(d) rounded to that dtype, as the
    JAX package divides; the correspondence product in the promotion of
    that dtype and the points' (f32 for f32 points). DCP's SVD head is the
    same correspondence (``models/dcp.py::svd_head_corr``)."""
    d_k = src_emb.shape[-1]
    scale = torch.full((), float(d_k), dtype=src_emb.dtype, device=src_emb.device).sqrt()
    scores = torch.matmul(src_emb, tgt_emb.transpose(1, 2)) / scale
    scores = torch.softmax(scores, dim=2)
    dt = torch.promote_types(scores.dtype, tgt.dtype)
    return src, torch.matmul(scores.to(dt), tgt.to(dt))


class VcpAtt(nn.Module):
    """(srcK, src_corrK) by a learned distance attention (``vcp_nn="att"``,
    reference VcpAtt): q = linear_emb_q(e), k = linear_emb_k(f), then the
    softmax(-|q_i - k_j|^2)-weighted target points. Both projections start
    at the identity with zero bias, so at init this is the topK head's
    whole-mode formulation. f32 throughout, as the JAX package's flax
    ``Dense`` (no dtype) promotes bf16 embeddings with its f32 parameters;
    the reference's two 3-d projections, unused in its forward, are not
    created."""

    def __init__(self, emb_dims: int = 512):
        super().__init__()
        self.linear_emb_q = nn.Linear(emb_dims, emb_dims)
        self.linear_emb_k = nn.Linear(emb_dims, emb_dims)
        self.reset_identity()

    def reset_identity(self) -> None:
        with torch.no_grad():
            for layer in (self.linear_emb_q, self.linear_emb_k):
                layer.weight.copy_(torch.eye(*layer.weight.shape))
                layer.bias.zero_()

    def forward(self, src_emb, tgt_emb, src, tgt):
        q = F.linear(src_emb.float(), self.linear_emb_q.weight, self.linear_emb_q.bias)
        k = F.linear(tgt_emb.float(), self.linear_emb_k.weight, self.linear_emb_k.bias)
        scores = torch.softmax(neg_pairwise_sqdist(q, k), dim=2)
        return src, torch.matmul(scores, tgt.float())


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
    src_sel, src_emb_sel = take_rows(src, src_idx), take_rows(src_emb, src_idx)
    tgt_sel, tgt_emb_sel = take_rows(tgt, tgt_idx), take_rows(tgt_emb, tgt_idx)

    k2 = int(k1_src * 0.52 * overlap2)
    p = torch.softmax(neg_pairwise_sqdist(src_emb_sel, tgt_emb_sel), dim=2)  # [B, K1, K1]
    conf, best_idx = p.max(dim=-1)  # the first index on ties
    keep = torch.topk(conf, k2).indices  # [B, K2]
    corr_idx = torch.gather(best_idx, 1, keep)
    return take_rows(src_sel, keep), take_rows(tgt_sel, corr_idx)
