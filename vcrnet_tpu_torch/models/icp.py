"""Classical batched ICP (counterpart of vcrnet_tpu/models/icp.py).

Each iteration matches every current source point to its nearest target
point (one [B, N, M] distance product and an argmin), solves the rigid
transform by the batched Procrustes and moves the source. The loop stops
after ``max_iterations`` or when the batch-mean squared distance changes
by less than ``tolerance`` from the previous iteration's (the first
iteration compares with 0), as the reference does (icp_model.py:37-39):
one predicate for the whole batch, read on the host once an iteration.
Parameter-free, so plain PyTorch on any device.
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.ops.graph import pairwise_sqdist


def nearest_neighbor_corr(src: torch.Tensor, dst: torch.Tensor):
    """src [B, N, 3], dst [B, M, 3] -> (mean squared distance, a 0-d
    tensor; corr [B, N, 3], each source point's closest target point,
    ties to the smaller index)."""
    val, idx = pairwise_sqdist(src, dst).min(dim=-1)  # [B, N]
    corr = torch.gather(dst, 1, idx[:, :, None].expand(-1, -1, dst.shape[-1]))
    return val.mean(), corr


@torch.no_grad()
def icp_register(src: torch.Tensor, dst: torch.Tensor, max_iterations: int = 50,
                 tolerance: float = 1e-3, with_iters: bool = False):
    """Align src -> dst. Returns (src, src_aligned, R_ab, t_ab, R_ba, t_ba),
    the reference ICP.forward's signature; ``with_iters=True`` appends the
    number of iterations executed (an int)."""
    cur = src
    prev_err = torch.zeros((), dtype=src.dtype, device=src.device)
    n_iters = 0
    while n_iters < max_iterations:
        err, corr = nearest_neighbor_corr(cur, dst)
        R, t = geometry.procrustes(cur, corr)
        cur = geometry.transform_points(cur, R, t)
        n_iters += 1
        if ((prev_err - err).abs() < tolerance).item():  # in src's dtype, as JAX's
            break
        prev_err = err
    R_ab, t_ab = geometry.procrustes(src, cur)
    R_ba, t_ba = geometry.invert_transform(R_ab, t_ab)
    if with_iters:
        return src, cur, R_ab, t_ab, R_ba, t_ba, n_iters
    return src, cur, R_ab, t_ab, R_ba, t_ba
