"""Synthetic registration pairs with known ground truth (numpy).

Copies of vcrnet_tpu/data/synthetic.py:random_shape_cloud and the
whole-cloud part of vcrnet_tpu/data/augment.py:make_pair_from_cloud, with
the same RNG draw order: for an eval item the JAX package seeds numpy's
global generator with the item index, and ``make_pair`` draws the same
numbers from ``np.random.RandomState(item)``.
"""

from __future__ import annotations

import numpy as np


def random_shape_cloud(rng: np.random.RandomState, n_points: int) -> np.ndarray:
    """A random composition of 2-4 primitive surfaces (sphere, box,
    cylinder, plane) normalised to the unit ball: [n_points, 3] f32."""
    n_parts = rng.randint(2, 5)
    counts = np.full(n_parts, n_points // n_parts)
    counts[: n_points - counts.sum()] += 1
    parts = []
    for m in counts:
        kind = rng.randint(4)
        center = rng.uniform(-0.4, 0.4, 3)
        if kind == 0:  # sphere surface
            u = rng.randn(m, 3)
            u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
            p = center + rng.uniform(0.1, 0.35) * u
        elif kind == 1:  # box surface
            half = rng.uniform(0.08, 0.3, 3)
            p = rng.uniform(-1, 1, (m, 3)) * half
            face_axis = rng.randint(0, 3, m)
            face_sign = rng.choice([-1.0, 1.0], m)
            p[np.arange(m), face_axis] = half[face_axis] * face_sign
            p = center + p
        elif kind == 2:  # cylinder shell
            r = rng.uniform(0.05, 0.25)
            h = rng.uniform(0.1, 0.5)
            ang = rng.uniform(0, 2 * np.pi, m)
            p = np.stack(
                [r * np.cos(ang), r * np.sin(ang), rng.uniform(-h, h, m)], axis=1,
            ) + center
        else:  # planar patch
            extent = rng.uniform(0.15, 0.4, 2)
            p2 = rng.uniform(-1, 1, (m, 2)) * extent
            normal = rng.randn(3)
            normal /= np.linalg.norm(normal) + 1e-9
            b1 = np.cross(normal, [1.0, 0.0, 0.0])
            if np.linalg.norm(b1) < 1e-6:
                b1 = np.cross(normal, [0.0, 1.0, 0.0])
            b1 /= np.linalg.norm(b1)
            b2 = np.cross(normal, b1)
            p = center + p2[:, :1] * b1 + p2[:, 1:] * b2
        parts.append(p)
    cloud = np.concatenate(parts, axis=0).astype(np.float32)
    cloud -= cloud.mean(axis=0)
    cloud /= np.abs(cloud).max() + 1e-9
    return cloud


def _euler_zyx_mat(anglez, angley, anglex):
    """R = Rx @ Ry @ Rz."""
    cosx, cosy, cosz = np.cos(anglex), np.cos(angley), np.cos(anglez)
    sinx, siny, sinz = np.sin(anglex), np.sin(angley), np.sin(anglez)
    Rx = np.array([[1, 0, 0], [0, cosx, -sinx], [0, sinx, cosx]])
    Ry = np.array([[cosy, 0, siny], [0, 1, 0], [-siny, 0, cosy]])
    Rz = np.array([[cosz, -sinz, 0], [sinz, cosz, 0], [0, 0, 1]])
    return Rx.dot(Ry).dot(Rz)


def make_pair(cloud: np.ndarray, rng: np.random.RandomState, num_points: int,
              factor: float = 4.0) -> dict:
    """A whole-cloud registration pair from a raw cloud [M, 3], M >=
    num_points: rotation angles from [0, pi/factor), translation from
    [-0.5, 0.5)^3, subsample, transform, and permute both clouds. Returns
    numpy ``src``, ``tgt`` [num_points, 3], ``R_ab`` [3, 3], ``t_ab`` [3]
    and ``euler_ab`` [3] (radians, z-y-x), with tgt = src @ R_ab^T + t_ab
    up to the permutation."""
    cloud = np.array(cloud, dtype=np.float32)
    anglex = rng.uniform() * np.pi / factor
    angley = rng.uniform() * np.pi / factor
    anglez = rng.uniform() * np.pi / factor
    R_ab = _euler_zyx_mat(anglez, angley, anglex)
    t_ab = np.array([rng.uniform(-0.5, 0.5) for _ in range(3)])
    pc1 = rng.permutation(cloud)[:num_points]
    pc2 = pc1 @ R_ab.T + t_ab
    pc1 = rng.permutation(pc1)
    pc2 = rng.permutation(pc2)
    return {
        "src": pc1.astype(np.float32),
        "tgt": pc2.astype(np.float32),
        "R_ab": R_ab.astype(np.float32),
        "t_ab": t_ab.astype(np.float32),
        "euler_ab": np.asarray([anglez, angley, anglex], np.float32),
    }


def shapes_eval_set(n_items: int, num_points: int = 1024, cloud_points: int = 2048,
                    seed: int = 7) -> dict:
    """The JAX package's synthetic 'shapes' eval set
    (``SyntheticDataset(cfg, 'test', kind='shapes')``): clouds from
    ``RandomState(seed + 1)``, item i paired with ``RandomState(i)``.
    Returns stacked numpy arrays keyed as :func:`make_pair`."""
    rng = np.random.RandomState(seed + 1)
    clouds = [random_shape_cloud(rng, cloud_points) for _ in range(n_items)]
    pairs = [make_pair(c, np.random.RandomState(i), num_points) for i, c in enumerate(clouds)]
    return {key: np.stack([p[key] for p in pairs]) for key in pairs[0]}
