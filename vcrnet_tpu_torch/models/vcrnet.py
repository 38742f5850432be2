"""VCR-Net assembly and the eval-time refinement loop (counterpart of
vcrnet_tpu/models/vcrnet.py:81-371), for eval and training.

embed -> transformer pointer (residual) -> VCP head -> Procrustes SVD.
The port covers the default configuration: LPDNet embedding, transformer
or identity pointer, whole-mode topK head.

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
from vcrnet_tpu_torch.models.embeddings import LPDNet
from vcrnet_tpu_torch.models.heads import vcp_top_k_whole
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.utils.device import resolve_device


def _check_supported(cfg: Config) -> None:
    unsupported = {
        "emb_nn": cfg.emb_nn != "lpdnet",
        "pointer": cfg.pointer not in ("transformer", "identity"),
        "vcp_nn": cfg.vcp_nn != "topK",
        "partial": cfg.partial,
        "t3d": cfg.t3d,
        "tfea": cfg.tfea,
        "reuse_feature_knn": cfg.reuse_feature_knn,
        "refine_subsample": cfg.refine_subsample > 0,
        "dropout": cfg.dropout > 0,
        "remat": cfg.remat,
    }
    bad = [name for name, is_bad in unsupported.items() if is_bad]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class VCRNet(nn.Module):
    """forward(src, tgt) with [B, N, 3] clouds returns
    (srcK, src_corrK, R_ab, t_ab, R_ba, t_ba)."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        if use_kernels is None:
            use_kernels = self.device.type == "cuda" and dtype is not None
        self.use_kernels = use_kernels
        self.emb_nn = LPDNet(cfg.emb_dims, negative_slope=0.0, dtype=dtype)
        self.pointer = None
        if cfg.pointer == "transformer":
            self.pointer = TransformerPointer(
                cfg.emb_dims, cfg.n_blocks, cfg.n_heads, cfg.ff_dims, dtype=dtype,
                flash=use_kernels,
            )
        self.to(self.device)

    def embed(self, x, spatial_idx=None):
        """Embedding only -> (emb, spatial_idx, feature_idx), so refinement
        loops can cache the target embedding and the source's xyz kNN."""
        return self.emb_nn(x, spatial_idx=spatial_idx, fused=self.use_kernels)

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
        fused = self.use_kernels and (not self.training or self.cfg.streaming_vcp_train)
        return vcp_top_k_whole(src_emb, tgt_emb, src, tgt, fused=fused)

    def forward(self, src, tgt):
        # both clouds embedded in one call, stacked on the batch axis
        emb = self.embed(torch.cat([src, tgt], dim=0))[0]
        src_emb, tgt_emb = emb.chunk(2, dim=0)
        return self.register_embedded(src, tgt, src_emb, tgt_emb)


def vcrnet_iter(model: VCRNet, src, tgt, n_iter: int):
    """Eval refinement: run the net on the transformed source n_iter times
    and compose the transforms. The target embedding, its encoder pass and
    the source's xyz kNN (rigid transforms keep distances) are computed
    once. Returns (srcK, src_corrK, R_ab, t_ab, R_ba, t_ba)."""
    if model.use_kernels and n_iter > 1:
        raise NotImplementedError(
            "n_iter > 1 on the kernel route reuses the cached spatial kNN "
            "through gather_max_from_idx, which is not ported yet"
        )
    tgt_emb = model.embed(tgt)[0]
    tgt_memory = model.encode_target(tgt_emb) if model.pointer is not None else None
    transformed = src
    spatial_idx = None
    R_final = t_final = out = None
    for _ in range(n_iter):
        src_emb, spatial_idx, _ = model.embed(transformed, spatial_idx=spatial_idx)
        out = model.register_embedded(transformed, tgt, src_emb, tgt_emb, tgt_memory=tgt_memory)
        R_ab, t_ab = out[2], out[3]
        transformed = geometry.transform_points(transformed, R_ab, t_ab)
        if R_final is None:
            R_final, t_final = R_ab, t_ab
        else:
            R_final, t_final = geometry.compose_transforms(R_ab, t_ab, R_final, t_final)
    R_ba, t_ba = geometry.invert_transform(R_final, t_final)
    return out[0], out[1], R_final, t_final, R_ba, t_ba
