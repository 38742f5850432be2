"""LPDNet point embedding (counterpart of vcrnet_tpu/models/embeddings.py).

Channels-last [B, N, C]; every kernel-size-1 conv is a Linear whose
parameter names match the flax tree (see utils/params.py). Two routes:

  * fused: the DG block runs ``ops.edgeconv.edge_conv`` and the SN block
    ``ops.edgeconv.knn_gather_max`` (on a CUDA tensor, the Hopper kernels,
    with their backward kernels when a gradient is wanted) — the JAX
    package's TPU bf16 route, for eval and training alike. Given a
    selection (refinement iterations 2+) they run ``edge_conv_from_idx``
    and ``gather_max_from_idx`` instead;
  * plain: ``graph.knn`` + gathers, the JAX package's XLA route, which
    takes the same precomputed selections.

Both use the decomposed edge conv: W @ [n_j ; c_i] + b = n_j @ A + (c_i @ B
+ b), so matmuls run per point, and the SN block reduces to a gather-max
(max_j act(a_j + h_i) = act(max_j a_j + h_i), act being monotone).
"""

from __future__ import annotations

import torch
from torch import nn

from vcrnet_tpu_torch.models._common import dense
from vcrnet_tpu_torch.ops._common import leaky
from vcrnet_tpu_torch.ops.edgeconv import (
    edge_conv, edge_conv_from_idx, gather_max_from_idx, knn_gather_max,
)
from vcrnet_tpu_torch.ops.graph import gather_max_neighbors, gather_neighbors, knn


class SplitEdgeDense(nn.Linear):
    """Linear over concat(neighbour, centre) in decomposed form. The weight
    is the fused [F, 2C] matrix; returns (a, h): the neighbour projection
    [B, N, F] (gathered by neighbour index) and the centre projection plus
    bias."""

    def __init__(self, c: int, features: int):
        super().__init__(2 * c, features)

    def split(self, x: torch.Tensor, dtype: torch.dtype | None):
        c = x.shape[-1]
        w, b = self.weight, self.bias
        if dtype is not None:
            x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
        return torch.matmul(x, w[:, :c].t()), torch.matmul(x, w[:, c:].t()) + b


class LPDNet(nn.Module):
    """[B, N, 3] -> [B, N, emb_dims] (without the optional T-Nets)."""

    def __init__(self, emb_dims: int = 512, k: int = 20, negative_slope: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.k = k
        self.slope = negative_slope
        self.dtype = dtype
        self.conv1_lpd = nn.Linear(3, 64)
        self.conv2_lpd = nn.Linear(64, 64)
        self.convDG1 = SplitEdgeDense(64, 128)
        self.convDG2 = nn.Linear(128, 128)
        self.convSN1 = SplitEdgeDense(128, 256)
        self.conv3_lpd = nn.Linear(512, emb_dims)

    def forward(self, x: torch.Tensor, spatial_idx: torch.Tensor | None = None,
                feature_idx: torch.Tensor | None = None, fused: bool = False):
        """Returns (embedding, spatial_idx, feature_idx): the xyz-kNN
        selection and the feature-space selection of the DG block, each
        computed here unless passed in. A passed ``spatial_idx`` is exact
        (rigid transforms keep distances, so refinement loops pass it
        back); a passed ``feature_idx`` is an approximation once the cloud
        has moved (Config.reuse_feature_knn), and is eval only on the
        fused route. ``fused`` selects the kernel route, whose selections
        are the kernels' own."""
        dt, k = self.dtype, self.k
        x_xyz = x
        x = leaky(dense(self.conv1_lpd, x, dt), self.slope)
        x = leaky(dense(self.conv2_lpd, x, dt), self.slope)

        a, h = self.convDG1.split(x, dt)
        w2, b2 = self.convDG2.weight.t(), self.convDG2.bias
        if dt is not None:
            w2, b2 = w2.to(dt), b2.to(dt)
        if fused and feature_idx is not None:
            x1, x2 = edge_conv_from_idx(
                feature_idx, a, h, w2.contiguous(), b2, negative_slope=self.slope
            )
        elif fused:
            x1, x2, feature_idx = edge_conv(
                x, a, h, w2.contiguous(), b2, k=k, negative_slope=self.slope
            )
        else:
            if feature_idx is None:
                feature_idx = knn(x, k)
            z = leaky(gather_neighbors(a, feature_idx) + h[:, :, None], self.slope)
            x1 = z.amax(dim=2)
            x2 = leaky(torch.matmul(z, w2) + b2, self.slope).amax(dim=2)

        a2, h2 = self.convSN1.split(x2, dt)
        if fused and spatial_idx is not None:
            gm = gather_max_from_idx(spatial_idx, a2)
        elif fused:
            gm, spatial_idx = knn_gather_max(x_xyz, a2, k=k)
        else:
            if spatial_idx is None:
                spatial_idx = knn(x_xyz, k)
            gm = gather_max_neighbors(a2, spatial_idx)
        x3 = leaky(gm + h2, self.slope)

        x = torch.cat([x1, x2, x3], dim=-1)
        return leaky(dense(self.conv3_lpd, x, dt), self.slope), spatial_idx, feature_idx
