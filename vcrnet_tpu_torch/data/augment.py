"""Registration-pair augmentation (counterpart of vcrnet_tpu/data/augment.py).

Two paths:

1. ``make_pair_from_cloud`` and ``nn_crop``, on the host (numpy): the
   GLOBAL numpy generator in the JAX package's draw order, test items
   reseeded with their index first, so the pairs (whole and
   partial-overlap) are bit-equal to the JAX package's for the same seed.
2. ``device_augment_batch``, on the batch's device (torch): the same
   distributions for a whole batch of raw clouds, drawn from an explicit
   ``torch.Generator``, with no host round trip. Not bit-compatible with
   either numpy or the JAX package's generator, by design.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config

PAIR_KEYS = ("src", "tgt", "R_ab", "t_ab", "R_ba", "t_ba", "euler_ab", "euler_ba")


@dataclasses.dataclass
class RegistrationPair:
    """One training example ([N, 3] clouds, channels last)."""

    src: np.ndarray  # [N, 3]
    tgt: np.ndarray  # [N, 3]
    R_ab: np.ndarray  # [3, 3]
    t_ab: np.ndarray  # [3]
    R_ba: np.ndarray  # [3, 3]
    t_ba: np.ndarray  # [3]
    euler_ab: np.ndarray  # [3] radians, (z, y, x)
    euler_ba: np.ndarray  # [3] radians, (x, y, z) negated-reversed
    label: int

    def astuple(self):
        return (
            self.src, self.tgt, self.R_ab, self.t_ab, self.R_ba, self.t_ba,
            self.euler_ab, self.euler_ba, self.label,
        )


def euler_zyx_mat(anglez, angley, anglex) -> np.ndarray:
    """R = Rx @ Ry @ Rz (float64)."""
    cosx, cosy, cosz = np.cos(anglex), np.cos(angley), np.cos(anglez)
    sinx, siny, sinz = np.sin(anglex), np.sin(angley), np.sin(anglez)
    Rx = np.array([[1, 0, 0], [0, cosx, -sinx], [0, sinx, cosx]])
    Ry = np.array([[cosy, 0, siny], [0, 1, 0], [-siny, 0, cosy]])
    Rz = np.array([[cosz, -sinz, 0], [sinz, cosz, 0], [0, 0, 1]])
    return Rx.dot(Ry).dot(Rz)


def nn_crop(points: np.ndarray, reserve: float) -> np.ndarray:
    """Keep the ``int(N * reserve)`` nearest neighbours of the LAST point,
    sorted by distance: a contiguous missing chunk. [N, 3] ->
    [int(N * reserve), 3]."""
    n_keep = int(points.shape[0] * reserve)
    d = ((points - points[-1]) ** 2).sum(-1)
    return points[np.argsort(d, kind="stable")[:n_keep]]


def make_pair_from_cloud(pointcloud: np.ndarray, item: int, cfg: Config,
                         partition: str = "train", label: int = 0) -> RegistrationPair:
    """A registration pair from a raw cloud [M, 3], M >= cfg.num_points:
    optional jitter, rotation angles from [0, pi/factor), translation from
    [-0.5, 0.5)^3, subsample, transform, permute and, with ``cfg.partial``,
    crop each cloud to its ``cfg.n_cropped`` points nearest a point of its
    own. Draws from the global numpy generator; a test item seeds it with
    ``item`` first."""
    pointcloud = np.array(pointcloud, dtype=np.float32)
    if cfg.gaussian_noise:
        n, c = pointcloud.shape
        pointcloud += np.clip(0.01 * np.random.randn(n, c), -0.05, 0.05).astype(np.float32)
    if partition != "train":
        np.random.seed(item)

    anglex = np.random.uniform() * np.pi / cfg.factor
    angley = np.random.uniform() * np.pi / cfg.factor
    anglez = np.random.uniform() * np.pi / cfg.factor
    R_ab = euler_zyx_mat(anglez, angley, anglex)
    R_ba = R_ab.T
    t_ab = np.array([np.random.uniform(-0.5, 0.5) for _ in range(3)])
    t_ba = -R_ba.dot(t_ab)

    pc1 = np.random.permutation(pointcloud)[: cfg.num_points]
    pc2 = pc1 @ R_ab.T + t_ab
    euler_ab = np.asarray([anglez, angley, anglex])
    euler_ba = -euler_ab[::-1]
    if cfg.model != "lpd":
        pc1 = np.random.permutation(pc1)
        if cfg.partial:
            pc1 = nn_crop(pc1, cfg.reserve)
        pc2 = np.random.permutation(pc2)
        if cfg.partial:
            pc2 = nn_crop(pc2, cfg.reserve)
    else:  # LPD keeps the correspondence: one joint permutation
        both = np.random.permutation(np.concatenate([pc1, pc2], axis=1))
        pc1, pc2 = both[:, :3], both[:, 3:]

    f32 = np.float32
    return RegistrationPair(
        src=pc1.astype(f32), tgt=pc2.astype(f32), R_ab=R_ab.astype(f32),
        t_ab=t_ab.astype(f32), R_ba=R_ba.astype(f32), t_ba=t_ba.astype(f32),
        euler_ab=euler_ab.astype(f32), euler_ba=euler_ba.astype(f32), label=label,
    )


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, 3] gathered along the points by idx [B, n]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _random_perm(gen: torch.Generator, b: int, n: int, device) -> torch.Tensor:
    """[b, n] independent uniform permutations of range(n), one a row."""
    return torch.rand((b, n), generator=gen, device=device).argsort(dim=1)


def device_augment_batch(gen: torch.Generator, clouds: torch.Tensor, cfg: Config) -> dict:
    """Registration pairs of a batch of raw clouds [B, M, 3] f32, drawn from
    ``gen`` (a generator on the clouds' device) on that device: optional
    jitter (clip(0.01 N(0, 1), +-0.05) on every raw point), rotation angles
    (z, y, x) from U[0, pi/factor), a translation from U[-0.5, 0.5)^3, a
    per-row random subsample to ``cfg.num_points`` points, the target
    transformed from it, per-row shuffles of both clouds and, with
    ``cfg.partial``, each cloud cropped to its ``int(N * reserve)`` points
    nearest its last point (nearest first). Returns the dict of
    :data:`PAIR_KEYS`, as the JAX function does."""
    B, M, _ = clouds.shape
    n = cfg.num_points
    if n > M:
        raise ValueError(f"num_points={n} > the raw clouds' {M} points")
    dev = clouds.device
    if cfg.gaussian_noise:
        noise = torch.randn(clouds.shape, generator=gen, device=dev, dtype=clouds.dtype)
        clouds = clouds + (0.01 * noise).clamp(-0.05, 0.05)
    angles = torch.rand((B, 3), generator=gen, device=dev) * (math.pi / cfg.factor)  # z, y, x
    R_ab = geometry.euler_to_mat_zyx(angles)
    t_ab = torch.rand((B, 3), generator=gen, device=dev) - 0.5

    pc1 = _rows(clouds, _random_perm(gen, B, M, dev)[:, :n])
    pc2 = geometry.transform_points(pc1, R_ab, t_ab)
    pc1 = _rows(pc1, _random_perm(gen, B, n, dev))
    pc2 = _rows(pc2, _random_perm(gen, B, n, dev))
    if cfg.partial:
        n_keep = int(n * cfg.reserve)

        def crop(pc):
            d = ((pc - pc[:, -1:]) ** 2).sum(-1)  # [B, N]
            return _rows(pc, torch.topk(d, n_keep, dim=1, largest=False).indices)

        pc1, pc2 = crop(pc1), crop(pc2)
    R_ba, t_ba = geometry.invert_transform(R_ab, t_ab)
    return {"src": pc1, "tgt": pc2, "R_ab": R_ab, "t_ab": t_ab, "R_ba": R_ba, "t_ba": t_ba,
            "euler_ab": angles, "euler_ba": -angles.flip(-1)}
