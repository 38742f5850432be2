"""LPD embedding pretraining: the lazy triplet loss over FPS anchors
(counterpart of vcrnet_tpu/models/lpd.py; reference lpdnet_model.py:140-229).

The pairs keep their point correspondence (the target is the transformed
source, point for point), so each anchor's positive is the same index in
the target embedding and its negatives are the target embeddings of the
anchors farthest from it in xyz. The anchors (FPS) and the negatives (kFN)
are index selections on the coordinates and carry no gradient; the loss
reaches the parameters through the gathered embeddings and the norm
regulariser. The embedding is LPDNet at the slope 0.2, on the kernel route
(``use_kernels``, as in :class:`VCRNet`) through the edge kernels with
their backward. The loss is plain PyTorch in f32, as the JAX package leaves
it to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.vcrnet import compute_dtype, make_embedding
from vcrnet_tpu_torch.ops.fps import farthest_point_sample
from vcrnet_tpu_torch.ops.graph import kfn, take_rows
from vcrnet_tpu_torch.utils.device import resolve_device

ANCHORS = 32  # FPS anchors a cloud
NEGATIVES = 8  # hard negatives an anchor
NORM_WEIGHT = 0.03  # the embedding-norm regulariser's weight


def lazy_triplet_loss(src_emb_k, tgt_emb_k, neg_emb, margin: float = 1.0):
    """max(0, 1 - dn / (margin + dp)) per anchor (reference
    lpdnet_model.py:176-188). src_emb_k, tgt_emb_k [B, K, E]; neg_emb
    [B, K, neg_k, E] -> [B, K]; dn is the mean over dims and negatives."""
    dp = ((src_emb_k - tgt_emb_k) ** 2).mean(dim=-1)
    dn = ((src_emb_k[:, :, None, :] - neg_emb) ** 2).mean(dim=(-1, -2))
    return torch.clamp(1.0 - dn / (margin + dp), min=0.0)


def lpd_loss(src, src_emb, tgt_emb, k: int = ANCHORS, neg_k: int = NEGATIVES,
             per_sample: bool = False):
    """The LPD loss: the lazy triplet loss over ``k`` FPS anchors of src
    with ``neg_k`` hard negatives each, plus the embedding-norm regulariser
    x 0.03 (reference getLoss, lpdnet_model.py:191-229). A scalar, or with
    ``per_sample=True`` a [B] vector: each sample's mean triplet term and
    its own norm terms, so that padded samples can be masked. Embeddings
    are taken in f32."""
    src_emb, tgt_emb = src_emb.float(), tgt_emb.float()
    anchors = farthest_point_sample(src, k)  # [B, k]
    src_emb_k = take_rows(src_emb, anchors)
    tgt_emb_k = take_rows(tgt_emb, anchors)
    far = kfn(take_rows(src, anchors), neg_k)  # [B, k, neg_k], farthest anchors in xyz
    B, K, E = tgt_emb_k.shape  # the negatives' embeddings from the TARGET side
    neg = take_rows(tgt_emb_k, far.reshape(B, K * neg_k)).reshape(B, K, neg_k, E)
    triplet = lazy_triplet_loss(src_emb_k, tgt_emb_k, neg)  # [B, K]

    src_len = torch.linalg.vector_norm(src_emb, dim=-1)  # [B, N]
    tgt_len = torch.linalg.vector_norm(tgt_emb, dim=-1)
    if per_sample:
        norm1 = ((src_len - 1.0) ** 2).mean(dim=1).sqrt()
        norm2 = ((tgt_len - 1.0) ** 2).mean(dim=1).sqrt()
        return triplet.mean(dim=1) + (norm1 + norm2) / 2.0 * NORM_WEIGHT
    norm1 = ((src_len - 1.0) ** 2).mean().sqrt()
    norm2 = ((tgt_len - 1.0) ** 2).mean().sqrt()
    return triplet.mean() + (norm1 + norm2) / 2.0 * NORM_WEIGHT


class LPD(nn.Module):
    """forward(src, tgt) -> (src_emb, tgt_emb, loss, mse, mae) (reference
    lpdnet_model.py:149-161): mse and mae are the batch means of the
    embeddings' differences times B. ``cfg.emb_nn`` is LPDNet at the slope
    0.2; ``use_kernels`` as in :class:`VCRNet`."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None):
        super().__init__()
        if cfg.emb_nn != "lpdnet":
            raise ValueError(f"LPD pretrains the LPDNet embedding, not {cfg.emb_nn!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and compute_dtype(cfg) is not None
        self.use_kernels = use_kernels
        self.emb_nn = make_embedding(cfg, for_lpd_pretrain=True)
        self.to(self.device)

    def embed_pair(self, src, tgt):
        """(src_emb, tgt_emb): without a T-Net both clouds embedded in one
        call, stacked on the batch axis (LPDNet embeds each cloud alone and
        has no batch statistics, so this equals two calls); with one, two
        calls, as the JAX package makes them: in training mode the T-Net's
        running statistics are updated twice, the second time on top of the
        first."""
        emb_nn = self.emb_nn
        if emb_nn.t3d or emb_nn.tfea:
            return (emb_nn(src, fused=self.use_kernels)[0],
                    emb_nn(tgt, fused=self.use_kernels)[0])
        emb = emb_nn(torch.cat([src, tgt], dim=0), fused=self.use_kernels)[0]
        return emb.chunk(2, dim=0)

    def forward(self, src, tgt):
        B = src.shape[0]
        src_emb, tgt_emb = self.embed_pair(src, tgt)
        diff = src_emb.float() - tgt_emb.float()
        loss = lpd_loss(src, src_emb, tgt_emb)
        return src_emb, tgt_emb, loss, (diff ** 2).mean() * B, diff.abs().mean() * B
