"""Point embeddings: LPDNet (with its optional T-Nets), DGCNN and PointNet
(counterpart of vcrnet_tpu/models/embeddings.py).

Channels-last [B, N, C]; every kernel-size-1 conv is a Linear whose
parameter names match the flax tree (see utils/params.py). LPDNet's two
routes:

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

from vcrnet_tpu_torch.models._common import FlaxBatchNorm, dense
from vcrnet_tpu_torch.ops._common import leaky
from vcrnet_tpu_torch.ops.dgcnn import (
    CAT_WIDTH, STAGE_WIDTHS, fold_dgcnn_eval_params, fused_dgcnn_eval,
)
from vcrnet_tpu_torch.ops.edgeconv import (
    edge_conv, edge_conv_from_idx, gather_max_from_idx, knn_gather_max,
)
from vcrnet_tpu_torch.ops.graph import (
    gather_max_neighbors, gather_neighbors, graph_feature, knn,
)


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


class TransformNet(nn.Module):
    """PointNet's k x k alignment (T-Net; reference lpdnet_model.py:19-70):
    [B, N, k] -> [B, k, k]. Three convs, each with BatchNorm and ReLU, a max
    over the points, fc1 and fc2 with BatchNorm and ReLU, then fc3 plus the
    identity. f32 throughout, as the JAX package's flax layers without a
    dtype promote a bf16 input with their f32 parameters; its BatchNorms
    update their running statistics in training mode."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.k = k
        for i, (c_in, c_out) in enumerate(((k, 64), (64, 128), (128, 1024)), start=1):
            setattr(self, f"conv{i}", nn.Linear(c_in, c_out))
            setattr(self, f"bn{i}", FlaxBatchNorm(c_out))
        self.fc1 = nn.Linear(1024, 512)
        self.bn4 = FlaxBatchNorm(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn5 = FlaxBatchNorm(256)
        self.fc3 = nn.Linear(256, k * k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = x.amax(dim=1)  # [B, 1024]
        x = torch.relu(self.bn4(self.fc1(x)))
        x = torch.relu(self.bn5(self.fc2(x)))
        eye = torch.eye(self.k, dtype=x.dtype, device=x.device).reshape(1, -1)
        return (self.fc3(x) + eye).reshape(-1, self.k, self.k)


class LPDNet(nn.Module):
    """[B, N, 3] -> [B, N, emb_dims]. ``t3d`` puts a 3 x 3 T-Net
    (``t_net3d``) before ``conv1_lpd``, ``tfea`` a 64 x 64 one (``t_net_fea``)
    after ``conv2_lpd``; each multiplies its input by the transform it
    predicts, in f32. The SN block's kNN stays on the xyz from before the
    3 x 3 transform, so a refinement loop's cached spatial selection stays
    exact. With a T-Net LPDNet has BatchNorm statistics."""

    def __init__(self, emb_dims: int = 512, k: int = 20, negative_slope: float = 0.0,
                 dtype: torch.dtype | None = None, t3d: bool = False, tfea: bool = False):
        super().__init__()
        self.k = k
        self.slope = negative_slope
        self.dtype = dtype
        if t3d:
            self.t_net3d = TransformNet(3)
        self.conv1_lpd = nn.Linear(3, 64)
        self.conv2_lpd = nn.Linear(64, 64)
        if tfea:
            self.t_net_fea = TransformNet(64)
        self.convDG1 = SplitEdgeDense(64, 128)
        self.convDG2 = nn.Linear(128, 128)
        self.convSN1 = SplitEdgeDense(128, 256)
        self.conv3_lpd = nn.Linear(512, emb_dims)

    @property
    def t3d(self) -> bool:
        return hasattr(self, "t_net3d")

    @property
    def tfea(self) -> bool:
        return hasattr(self, "t_net_fea")

    def forward(self, x: torch.Tensor, spatial_idx: torch.Tensor | None = None,
                feature_idx: torch.Tensor | None = None, fused: bool = False):
        """Returns (embedding, spatial_idx, feature_idx): the xyz-kNN
        selection and the feature-space selection of the DG block, each
        computed here unless passed in. A passed ``spatial_idx`` is exact
        (rigid transforms keep distances, so refinement loops pass it
        back); a passed ``feature_idx`` is an approximation once the cloud
        has moved (Config.reuse_feature_knn), and is eval only on the
        fused route. ``fused`` selects the kernel route, whose selections
        are the kernels' own. After ``t_net_fea`` the kNN space is f32, and
        both routes select on the f32 values (the edge kernel's f32
        instance); without it the space is ``conv2_lpd``'s output in the
        compute dtype."""
        dt, k = self.dtype, self.k
        x_xyz = x
        if self.t3d:
            x = torch.matmul(x.float(), self.t_net3d(x))
        x = leaky(dense(self.conv1_lpd, x, dt), self.slope)
        x = leaky(dense(self.conv2_lpd, x, dt), self.slope)
        if self.tfea:
            x = torch.matmul(x.float(), self.t_net_fea(x))

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
                feature_idx = knn(x, k, method="exact")
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
                spatial_idx = knn(x_xyz, k, method="exact")
            gm = gather_max_neighbors(a2, spatial_idx)
        x3 = leaky(gm + h2, self.slope)

        x = torch.cat([x1, x2, x3], dim=-1)
        return leaky(dense(self.conv3_lpd, x, dt), self.slope), spatial_idx, feature_idx


class DGCNN(nn.Module):
    """[B, N, 3] -> [B, N, emb_dims]: four edge-conv blocks on the xyz kNN
    graph, multi-scale concat, projection (vcrnet_tpu/models/embeddings.py:
    DGCNN). Bias-free convs, each followed by BatchNorm and ReLU."""

    def __init__(self, emb_dims: int = 512, k: int = 20, dtype: torch.dtype | None = None):
        super().__init__()
        self.emb_dims = emb_dims
        self.k = k
        self.dtype = dtype
        for i, (c_in, c_out) in enumerate(STAGE_WIDTHS + ((CAT_WIDTH, emb_dims),), start=1):
            setattr(self, f"conv{i}", nn.Linear(c_in, c_out, bias=False))
            setattr(self, f"bn{i}", FlaxBatchNorm(c_out))

    def forward(self, x: torch.Tensor, spatial_idx: torch.Tensor | None = None,
                feature_idx: torch.Tensor | None = None, fused: bool = False):
        """Returns (embedding, spatial_idx, None): the xyz-kNN selection is
        computed here unless passed in (exact under rigid transforms, so
        refinement loops pass it back); DGCNN has no feature-space graph.
        ``fused`` selects the kernel route: the kNN kernel, and in eval
        mode in bf16, where no gradient is being recorded, the fused eval
        chain (it has no backward). On the card both raise on a shape they
        do not take: pass ``fused=False`` for the plain formulation."""
        if feature_idx is not None:
            raise ValueError("DGCNN has no feature-space graph to reuse")
        if spatial_idx is None:
            spatial_idx = knn(x, self.k, method="auto" if fused else "exact")
        if (fused and not self.training and not torch.is_grad_enabled()
                and self.dtype == torch.bfloat16):
            folded = fold_dgcnn_eval_params(self)
            return fused_dgcnn_eval(x, spatial_idx, folded, self.emb_dims), spatial_idx, None
        h = graph_feature(x, idx=spatial_idx)  # [B, N, k, 6]
        pooled = []
        for i in range(1, 5):
            h = torch.relu(getattr(self, f"bn{i}")(dense(getattr(self, f"conv{i}"), h, self.dtype)))
            pooled.append(h.amax(dim=2))
        h = torch.cat(pooled, dim=-1)  # [B, N, 512]
        return torch.relu(self.bn5(dense(self.conv5, h, self.dtype))), spatial_idx, None


class PointNet(nn.Module):
    """[B, N, 3] -> [B, N, emb_dims]: five pointwise Dense + BatchNorm + ReLU
    stages, f32 throughout (vcrnet_tpu/models/embeddings.py:PointNet)."""

    def __init__(self, emb_dims: int = 512):
        super().__init__()
        widths = (3, 64, 64, 64, 128, emb_dims)
        for i, (c_in, c_out) in enumerate(zip(widths[:-1], widths[1:]), start=1):
            setattr(self, f"conv{i}", nn.Linear(c_in, c_out, bias=False))
            setattr(self, f"bn{i}", FlaxBatchNorm(c_out))

    def forward(self, x: torch.Tensor, spatial_idx=None, feature_idx=None, fused: bool = False):
        """Returns (embedding, None, None): PointNet has no graph."""
        for i in range(1, 6):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x.float())))
        return x, None, None
