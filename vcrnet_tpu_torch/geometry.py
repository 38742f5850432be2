"""Batched rigid-transform math (counterpart of vcrnet_tpu/geometry.py).

Conventions as in the JAX package: points are row vectors [B, N, 3];
rotations R [B, 3, 3] act on column vectors, p' = p @ R^T + t; euler
angles follow scipy's extrinsic lowercase convention ('zyx': R = Rx@Ry@Rz).
"""

from __future__ import annotations

import torch


def transform_points(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, 3, 3] x [B, 3] -> [B, N, 3]."""
    return torch.einsum("bij,bnj->bni", R, points) + t[:, None, :]


def invert_transform(R: torch.Tensor, t: torch.Tensor):
    """(R, t) -> (R^T, -R^T t)."""
    R_inv = R.transpose(-1, -2)
    return R_inv, -torch.einsum("bij,bj->bi", R_inv, t)


def compose_transforms(R2, t2, R1, t1):
    """(R2, t2) o (R1, t1): first apply 1, then 2."""
    return (
        torch.einsum("bij,bjk->bik", R2, R1),
        torch.einsum("bij,bj->bi", R2, t1) + t2,
    )


def euler_to_mat_zyx(angles: torch.Tensor) -> torch.Tensor:
    """angles [..., 3] = [z, y, x] (radians), extrinsic 'zyx' -> R = Rx@Ry@Rz."""
    az, ay, ax = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(az), torch.sin(az)
    cb, sb = torch.cos(ay), torch.sin(ay)
    cg, sg = torch.cos(ax), torch.sin(ax)
    rows = (
        (cb * ca, -cb * sa, sb),
        (cg * sa + sg * sb * ca, cg * ca - sg * sb * sa, -sg * cb),
        (sg * sa - cg * sb * ca, sg * ca + cg * sb * sa, cg * cb),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mat_to_euler_zyx(R: torch.Tensor, degrees: bool = False) -> torch.Tensor:
    """R [..., 3, 3] -> [z, y, x] angles, extrinsic 'zyx' (R = Rx@Ry@Rz),
    matching scipy's ``as_euler('zyx')`` away from gimbal lock."""
    y = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    z = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    x = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    out = torch.stack([z, y, x], dim=-1)
    return torch.rad2deg(out) if degrees else out


def mat_to_euler_xyz(R: torch.Tensor, degrees: bool = False) -> torch.Tensor:
    """R [..., 3, 3] -> [x, y, z] angles, extrinsic 'xyz' (R = Rz@Ry@Rx),
    matching scipy's ``as_euler('xyz')`` away from gimbal lock (the B->A
    metrics)."""
    y = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    out = torch.stack([x, y, z], dim=-1)
    return torch.rad2deg(out) if degrees else out


def _svd_rotation(H: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] covariance -> proper rotation V @ U^T. f32 SVD with the
    1e-12 I tie-breaker for exactly degenerate H, and a branchless flip of
    V's last column where the solution would be a reflection. Differentiable:
    the SVD's backward is ``jnp.linalg.svd``'s (the same formula)."""
    eye = torch.eye(3, dtype=torch.float32, device=H.device)
    U, _, Vh = torch.linalg.svd(H.float() + 1e-12 * eye)
    V = Vh.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum("bij,bkj->bik", V, U)).detach()
    flip = torch.ones(V.shape[0], 1, 3, dtype=V.dtype, device=V.device)
    flip[:, 0, 2] = torch.where(det < 0, -1.0, 1.0)
    return torch.einsum("bij,bkj->bik", V * flip, U)


def procrustes(src: torch.Tensor, corr: torch.Tensor, weights: torch.Tensor | None = None):
    """Least-squares rigid transform aligning src -> corr ([B, N, 3] each,
    optional weights [B, N] >= 0). Returns R [B, 3, 3], t [B, 3] with
    corr ~= src @ R^T + t."""
    if weights is None:
        src_mean = src.mean(dim=1, keepdim=True)
        corr_mean = corr.mean(dim=1, keepdim=True)
        H = torch.einsum("bni,bnj->bij", src - src_mean, corr - corr_mean)
    else:
        w = weights[:, :, None]
        wsum = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        src_mean = (src * w).sum(dim=1, keepdim=True) / wsum
        corr_mean = (corr * w).sum(dim=1, keepdim=True) / wsum
        H = torch.einsum("bni,bnj->bij", (src - src_mean) * w, corr - corr_mean)
    R = _svd_rotation(H)
    t = corr_mean[:, 0, :] - torch.einsum("bij,bj->bi", R, src_mean[:, 0, :])
    return R, t
