"""DCP baseline: embedding + pointer + (SVD | MLP-quaternion) head
(counterpart of vcrnet_tpu/models/dcp.py), for eval and training.

The embedding and the pointer are VCR-Net's modules (``make_embedding``,
``TransformerPointer``) with their kernel routes; the two heads are plain
PyTorch, as the JAX package leaves them to XLA outside any Pallas kernel.
The two clouds are embedded one after the other, never stacked: in training
mode a BatchNorm embedding updates its running statistics twice per step,
the second time on top of the first, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models._common import FlaxBatchNorm
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.models.vcrnet import compute_dtype, make_embedding
from vcrnet_tpu_torch.utils.device import resolve_device


class MLPHead(nn.Module):
    """Global-feature quaternion regression head: max over the points of
    concat(src_emb, tgt_emb), three Dense + BatchNorm + ReLU stages, a
    normalised quaternion and a translation. f32."""

    def __init__(self, emb_dims: int = 512):
        super().__init__()
        d = emb_dims
        widths = (2 * d, d // 2, d // 4, d // 8)
        for i, (c_in, c_out) in enumerate(zip(widths[:-1], widths[1:]), start=1):
            setattr(self, f"fc{i}", nn.Linear(c_in, c_out))
            setattr(self, f"bn{i}", FlaxBatchNorm(c_out))
        self.proj_rot = nn.Linear(d // 8, 4)
        self.proj_trans = nn.Linear(d // 8, 3)

    def forward(self, src_emb, tgt_emb):
        x = torch.cat([src_emb, tgt_emb], dim=-1).float().amax(dim=1)  # [B, 2E]
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        rot = self.proj_rot(x)
        rot = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
        return geometry.quat2mat(rot), self.proj_trans(x)


def svd_head_corr(src_emb, tgt_emb, src, tgt):
    """DCP's scaled-dot soft correspondence + Procrustes -> (R, t, src,
    src_corr). Scores and softmax in the embeddings' dtype, the
    correspondence product in f32 (the promotion of bf16 scores and f32
    points)."""
    d_k = src_emb.shape[-1]
    scores = torch.matmul(src_emb, tgt_emb.transpose(1, 2)) / d_k ** 0.5
    scores = torch.softmax(scores, dim=2)
    dt = torch.promote_types(scores.dtype, tgt.dtype)
    src_corr = torch.matmul(scores.to(dt), tgt.to(dt))
    R, t = geometry.procrustes(src, src_corr)
    return R, t, src, src_corr


class DCP(nn.Module):
    """forward(src, tgt) with [B, N, 3] clouds returns
    (R_ab, t_ab, R_ba, t_ba, src, src_corr). ``use_kernels`` as in
    :class:`vcrnet_tpu_torch.models.VCRNet`."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None):
        super().__init__()
        if cfg.pointer not in ("transformer", "identity"):
            raise ValueError(f"unknown pointer: {cfg.pointer}")
        if cfg.head not in ("svd", "mlp"):
            raise ValueError(f"unknown head: {cfg.head}")
        if cfg.dropout > 0 or cfg.remat or cfg.t3d or cfg.tfea:
            raise NotImplementedError("not ported yet: dropout, remat, t3d, tfea")
        if cfg.int8_eval and cfg.compute_dtype == "bfloat16":
            raise NotImplementedError("not ported yet: int8_eval")
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
        self.mlp_head = MLPHead(cfg.emb_dims) if cfg.head == "mlp" else None
        self.to(self.device)

    def _head(self, a_emb, b_emb, a, b):
        if self.mlp_head is None:
            return svd_head_corr(a_emb, b_emb, a, b)
        R, t = self.mlp_head(a_emb, b_emb)
        return R, t, a, a

    def forward(self, src, tgt):
        src_emb = self.emb_nn(src, fused=self.use_kernels)[0]
        tgt_emb = self.emb_nn(tgt, fused=self.use_kernels)[0]
        if self.pointer is not None:
            src_delta, tgt_delta = self.pointer(src_emb, tgt_emb)
            src_emb = src_emb + src_delta
            tgt_emb = tgt_emb + tgt_delta
        R_ab, t_ab, src_out, src_corr = self._head(src_emb, tgt_emb, src, tgt)
        if self.cfg.cycle:
            R_ba, t_ba = self._head(tgt_emb, src_emb, tgt, src)[:2]
        else:
            R_ba, t_ba = geometry.invert_transform(R_ab, t_ab)
        return R_ab, t_ab, R_ba, t_ba, src_out, src_corr
