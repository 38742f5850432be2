"""Farthest point sampling (counterpart of vcrnet_tpu/ops/fps.py).

The first sample is the point farthest from the cloud's barycenter; each
next one is the point farthest from the samples taken so far. The whole
batch advances together, ``npoint`` small steps in all (the JAX package
runs the same loop as a ``fori_loop``); every argmax takes the first index
on ties, as ``jnp.argmax`` does. Indices carry no gradient.
"""

from __future__ import annotations

import torch


def _sqdist_to(xyz: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, 1, 3] -> [B, N] squared distances, summed x + y + z
    in that order."""
    d = (xyz - centre) ** 2
    return d[..., 0] + d[..., 1] + d[..., 2]


@torch.no_grad()
def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz [B, N, 3] -> indices [B, npoint] (int64)."""
    B, N, _ = xyz.shape
    farthest = _sqdist_to(xyz, xyz.mean(dim=1, keepdim=True)).argmax(dim=-1)  # [B]
    centroids = torch.empty((B, npoint), dtype=torch.long, device=xyz.device)
    distance = torch.full((B, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    for i in range(npoint):
        centroids[:, i] = farthest
        centre = torch.gather(xyz, 1, farthest[:, None, None].expand(B, 1, 3))
        distance = torch.minimum(distance, _sqdist_to(xyz, centre))
        farthest = distance.argmax(dim=-1)
    return centroids
