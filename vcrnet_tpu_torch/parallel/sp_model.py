"""Point-sharded (sequence-parallel) model forwards (counterpart of
vcrnet_tpu/parallel/sp_model.py).

  lpdnet_embed_sp    the LPDNet embedding with the POINT axis sharded:
                     each rank owns N/D points; the kNN key sets and the
                     neighbour projections are all-gathered, every
                     O(N^2/D) score block and per-point product stays local;
  register_whole_sp  whole-mode registration with the identity pointer:
                     sharded embedding, sharded soft correspondence, then
                     Procrustes from all-reduced sufficient statistics, so
                     no rank holds the whole cloud's correspondences.

They take the port's modules (``models/embeddings.py::LPDNet``, a
``VCRNet``), whose weights ``utils/params.py::from_jax_params`` carries
from the JAX package's tree, and compute in f32 whatever the model's
compute dtype, as the JAX functions do on the flax parameters. Like them,
``lpdnet_embed_sp`` reads conv1_lpd, conv2_lpd, convDG1, convDG2, convSN1
and conv3_lpd alone: an LPDNet's T-Nets (``t3d``, ``tfea``) are skipped
(ROADMAP C).
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.geometry import _svd_rotation
from vcrnet_tpu_torch.ops._common import leaky
from vcrnet_tpu_torch.ops.graph import gather_neighbors
from vcrnet_tpu_torch.parallel.mesh import Mesh
from vcrnet_tpu_torch.parallel.point_sharding import (
    local_knn, point_mesh, sharded_soft_correspondence,
)


def lpdnet_embed_sp(emb, x: torch.Tensor, mesh, batch_axis: str | None = None) -> torch.Tensor:
    """Point-sharded LPDNet forward: this rank's x [B, N/D, 3] -> its
    embeddings [B, N/D, emb_dims]. ``emb`` is an ``LPDNet`` module, whose
    ``k`` and ``slope`` it reads. Per call: all-gathers of the xyz and the
    features (kNN keys, no gradient) and of the two neighbour projections
    ([B, N, 128], [B, N, 256])."""
    pm = point_mesh(mesh, batch_axis)

    def act(v):
        return leaky(v, emb.slope)

    x0 = x.float()
    feat = act(emb.conv1_lpd(x0))
    feat = act(emb.conv2_lpd(feat))

    # dynamic graph in feature space, decomposed: W @ [neighbour; centre] = a[j] + h[i]
    a_loc, h_loc = emb.convDG1.split(feat, None)
    idx_f = local_knn(feat, pm.all_gather(feat.detach(), 1), emb.k, pm)
    z = act(gather_neighbors(pm.all_gather(a_loc, 1), idx_f) + h_loc[:, :, None, :])
    x1 = z.amax(dim=2)
    x2 = act(emb.convDG2(z)).amax(dim=2)

    # spatial neighbourhood on the original xyz, as a gather-max (act is monotone)
    a2_loc, h2_loc = emb.convSN1.split(x2, None)
    idx_s = local_knn(x0, pm.all_gather(x0.detach(), 1), emb.k, pm)
    x3 = act(gather_neighbors(pm.all_gather(a2_loc, 1), idx_s).amax(dim=2) + h2_loc)

    return act(emb.conv3_lpd(torch.cat([x1, x2, x3], dim=-1)))


def procrustes_sp(src: torch.Tensor, corr: torch.Tensor, pm: Mesh):
    """(R [B, 3, 3], t [B, 3]) aligning this rank's src shard to its corr
    shard together with every other rank's, from all-reduced sums: the
    means, then the covariance of the centred points. Replicated."""
    n_total = src.shape[1] * pm.size
    src = src.float()
    mean_src = pm.all_reduce(src.sum(dim=1)) / n_total  # [B, 3]
    mean_corr = pm.all_reduce(corr.sum(dim=1)) / n_total
    H = pm.all_reduce(torch.einsum("bni,bnj->bij", src - mean_src[:, None, :],
                                   corr - mean_corr[:, None, :]))
    R = _svd_rotation(H)
    return R, mean_corr - torch.einsum("bij,bj->bi", R, mean_src)


def register_whole_sp(model, src: torch.Tensor, tgt: torch.Tensor, mesh,
                      batch_axis: str | None = None):
    """Whole-mode registration with the identity pointer, point-sharded:
    (corr [B, N/D, 3], this rank's virtual correspondences; R_ab [B, 3, 3]
    and t_ab [B, 3], replicated over the point axis). ``model`` is a
    ``VCRNet`` (its ``emb_nn`` alone is used)."""
    pm = point_mesh(mesh, batch_axis)
    se = lpdnet_embed_sp(model.emb_nn, src, mesh, batch_axis)
    te = lpdnet_embed_sp(model.emb_nn, tgt, mesh, batch_axis)
    corr = sharded_soft_correspondence(se, te, tgt, mesh, batch_axis)
    R, t = procrustes_sp(src, corr, pm)
    return corr, R, t
