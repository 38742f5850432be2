"""VCR-Net assembly and the eval-time refinement loop (counterpart of
vcrnet_tpu/models/vcrnet.py:81-371), for eval and training.

embed -> transformer pointer (residual) -> VCP head -> Procrustes SVD.
The port covers the LPDNet, DGCNN and PointNet embeddings (without
LPDNet's T-Nets), the transformer or identity pointer
and the topK head, whole and partial-overlap (``cfg.partial``: the
decoder's cross attention re-masks its keys and the head selects the
likely-overlap points), and the refinement loop with all its caches.

Routes: with ``use_kernels`` (default: a CUDA device and
``compute_dtype="bfloat16"``, where the JAX package runs its Pallas
kernels) the embedding, attention and VCP head go through the ``ops``
kernel wrappers, whose backward kernels carry the gradient in training;
otherwise through the plain PyTorch formulation of the JAX package's XLA
path. In training mode (``model.train()``) the kernel route's head is
the differentiable streaming one when ``cfg.streaming_vcp_train`` is
set, as in the JAX package, and the plain formulation otherwise.
"""

from __future__ import annotations

import torch
from torch import nn

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.embeddings import DGCNN, LPDNet, PointNet
from vcrnet_tpu_torch.models.heads import vcp_top_k_partial, vcp_top_k_whole
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.utils.device import resolve_device


def compute_dtype(cfg: Config) -> torch.dtype | None:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def make_embedding(cfg: Config) -> nn.Module:
    """The embedding ``cfg.emb_nn`` names (vcrnet_tpu/models/vcrnet.py:
    make_embedding). Each returns (embedding, spatial_idx, feature_idx) and
    takes the selections back, where it has them."""
    if cfg.emb_nn == "pointnet":
        return PointNet(cfg.emb_dims)
    if cfg.emb_nn == "dgcnn":
        return DGCNN(cfg.emb_dims, dtype=compute_dtype(cfg))
    if cfg.emb_nn == "lpdnet":
        return LPDNet(cfg.emb_dims, negative_slope=0.0, dtype=compute_dtype(cfg))
    raise ValueError(f"unknown emb_nn: {cfg.emb_nn}")


def check_supported(cfg: Config) -> None:
    unsupported = {
        "pointer": cfg.pointer not in ("transformer", "identity"),
        "vcp_nn": cfg.vcp_nn != "topK",
        "t3d": cfg.t3d,
        "tfea": cfg.tfea,
        "dropout": cfg.dropout > 0,
        "remat": cfg.remat,
        # the JAX package quantizes the pointer projections only in bf16
        "int8_eval": cfg.int8_eval and cfg.compute_dtype == "bfloat16",
    }
    bad = [name for name, is_bad in unsupported.items() if is_bad]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class VCRNet(nn.Module):
    """forward(src, tgt) with [B, N, 3] clouds returns
    (srcK, src_corrK, R_ab, t_ab, R_ba, t_ba)."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = compute_dtype(cfg)
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and dtype is not None
        self.use_kernels = use_kernels
        self.emb_nn = make_embedding(cfg)
        self.pointer = None
        if cfg.pointer == "transformer":
            self.pointer = TransformerPointer(
                cfg.emb_dims, cfg.n_blocks, cfg.n_heads, cfg.ff_dims, dtype=dtype,
                flash=use_kernels, partial=cfg.partial, overlap2=cfg.overlap2,
            )
        self.to(self.device)

    def embed(self, x, spatial_idx=None, feature_idx=None):
        """Embedding only -> (emb, spatial_idx, feature_idx), so refinement
        loops can cache the target embedding and pass the source's kNN
        selections back."""
        return self.emb_nn(x, spatial_idx=spatial_idx, feature_idx=feature_idx,
                           fused=self.use_kernels)

    def encode_target(self, tgt_emb):
        """The pointer's encoder pass over the target embedding."""
        return self.pointer.encode_memory(tgt_emb)

    def register_embedded(self, src, tgt, src_emb, tgt_emb, tgt_memory=None):
        """pointer -> VCP -> SVD on precomputed embeddings; ``tgt_memory``
        is an optional cached :meth:`encode_target` pass."""
        if self.pointer is not None:
            src_delta, tgt_delta = self.pointer(src_emb, tgt_emb, tgt_memory=tgt_memory)
            src_emb = src_emb + src_delta
            tgt_emb = tgt_emb + tgt_delta
        src_k, src_corr_k = self._vcp(src_emb, tgt_emb, src, tgt)
        R_ab, t_ab = geometry.procrustes(src_k, src_corr_k)
        if self.cfg.cycle:
            tgt_k, tgt_corr_k = self._vcp(tgt_emb, src_emb, tgt, src)
            R_ba, t_ba = geometry.procrustes(tgt_k, tgt_corr_k)
        else:
            R_ba, t_ba = geometry.invert_transform(R_ab, t_ab)
        return src_k, src_corr_k, R_ab, t_ab, R_ba, t_ba

    def _vcp(self, src_emb, tgt_emb, src, tgt):
        if self.cfg.partial:
            return vcp_top_k_partial(src_emb, tgt_emb, src, tgt, self.cfg.overlap2)
        fused = self.use_kernels and (not self.training or self.cfg.streaming_vcp_train)
        dtype = compute_dtype(self.cfg)
        if fused and dtype is not None:
            # the kernels take the compute dtype: a BatchNorm embedding's f32
            # output is rounded for them, as the TPU kernel's default-precision
            # product rounds it (LPDNet's is in that dtype already)
            src_emb, tgt_emb = src_emb.to(dtype), tgt_emb.to(dtype)
        return vcp_top_k_whole(src_emb, tgt_emb, src, tgt, fused=fused)

    def forward(self, src, tgt):
        # both clouds embedded in one call, stacked on the batch axis; not
        # when a BatchNorm embedding trains: stacking would pool the two
        # clouds' batch statistics (LPDNet has none; in eval the running
        # statistics make stacking exact)
        if self.cfg.emb_nn == "lpdnet" or not self.training:
            emb = self.embed(torch.cat([src, tgt], dim=0))[0]
            src_emb, tgt_emb = emb.chunk(2, dim=0)
        else:
            src_emb = self.embed(src)[0]
            tgt_emb = self.embed(tgt)[0]
        return self.register_embedded(src, tgt, src_emb, tgt_emb)


def vcrnet_iter(model: VCRNet, src, tgt, n_iter: int):
    """Eval refinement: run the net on the transformed source n_iter times
    and compose the transforms. Returns (srcK, src_corrK, R_ab, t_ab, R_ba,
    t_ba).

    Computed once: the target embedding, its encoder pass, and the
    source's xyz kNN (LPDNet and DGCNN; rigid transforms keep distances, so
    the selection of the transformed source equals the original's). All
    three are exact. PointNet has no graph to cache.

    With ``cfg.reuse_feature_knn`` the source's feature-space selection
    (the DG block's graph) is reused too, an approximation: the leading
    ``cfg.feature_knn_refresh`` iterations compute a fresh graph, later
    ones reuse the last. With ``cfg.refine_subsample = M`` (whole mode)
    iterations 2+ run on the first M points of each cloud, with their own
    target embedding, encoder pass and selections, computed on the first
    subsampled iteration; M >= N is the exact path."""
    cfg = model.cfg
    reuse_feat = cfg.reuse_feature_knn
    refresh = max(1, cfg.feature_knn_refresh) if reuse_feat else 1
    sub = 0
    if not cfg.partial and n_iter > 1:
        sub = min(max(0, cfg.refine_subsample), src.shape[1])

    def target_cache(cloud):
        emb = model.embed(cloud)[0]
        return cloud, emb, model.encode_target(emb) if model.pointer is not None else None

    # per-size caches: [0] the full clouds (iteration 1), [1] the subsample
    sp_idx = [None, None]
    ft_idx = [None, None]
    tgt_cache = [target_cache(tgt), None]
    transformed = src
    R_final = t_final = out = None
    for i in range(n_iter):
        use_sub = 0 < sub < tgt.shape[1] and i >= 1
        if use_sub and tgt_cache[1] is None:
            tgt_cache[1] = target_cache(tgt[:, :sub].contiguous())
        c = 1 if use_sub else 0
        cur_src = transformed[:, :sub].contiguous() if use_sub else transformed
        # a fresh feature graph on the first pass at this size, and on the
        # leading `refresh` iterations when reuse is on
        fresh = sp_idx[c] is None or (reuse_feat and i < refresh)
        src_emb, spatial, feature = model.embed(
            cur_src, spatial_idx=sp_idx[c], feature_idx=None if fresh else ft_idx[c])
        if fresh:
            sp_idx[c] = spatial
            if reuse_feat:
                ft_idx[c] = feature
        cur_tgt, cur_tgt_emb, cur_tgt_mem = tgt_cache[c]
        out = model.register_embedded(cur_src, cur_tgt, src_emb, cur_tgt_emb,
                                      tgt_memory=cur_tgt_mem)
        R_ab, t_ab = out[2], out[3]
        transformed = geometry.transform_points(transformed, R_ab, t_ab)
        if R_final is None:
            R_final, t_final = R_ab, t_ab
        else:
            R_final, t_final = geometry.compose_transforms(R_ab, t_ab, R_final, t_final)
    R_ba, t_ba = geometry.invert_transform(R_final, t_final)
    return out[0], out[1], R_final, t_final, R_ba, t_ba
