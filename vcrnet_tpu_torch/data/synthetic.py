"""Synthetic registration pairs with known ground truth (numpy).

Copies of vcrnet_tpu/data/synthetic.py (``random_shape_cloud``,
``SyntheticDataset``). Pairs come from ``augment.make_pair_from_cloud``
with the JAX package's draw order, so a dataset built from the same seed
gives the same pairs. ``collate`` and ``Loader`` live in ``pipeline`` and
are importable from here too.
"""

from __future__ import annotations

import numpy as np

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import PAIR_KEYS, RegistrationPair, make_pair_from_cloud
from vcrnet_tpu_torch.data.pipeline import Loader, collate

__all__ = ["PAIR_KEYS", "Loader", "SyntheticDataset", "collate", "random_shape_cloud",
           "shapes_eval_set"]


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


class SyntheticDataset:
    """Map-style dataset of synthetic clouds through ``make_pair_from_cloud``.
    kind='uniform': unit-cube noise; kind='shapes': random primitive
    compositions with real local geometry. The clouds come from
    ``RandomState(seed)`` (train) or ``RandomState(seed + 1)`` (test)."""

    def __init__(self, cfg: Config, partition: str = "train", n_items: int = 256,
                 cloud_points: int = 2048, seed: int = 7, kind: str = "uniform"):
        if kind not in ("uniform", "shapes"):
            raise ValueError(f"unknown synthetic kind {kind!r}")
        self.cfg = cfg
        self.partition = partition
        rng = np.random.RandomState(seed if partition == "train" else seed + 1)
        if kind == "shapes":
            self.data = np.stack([random_shape_cloud(rng, cloud_points) for _ in range(n_items)])
        else:
            self.data = rng.rand(n_items, cloud_points, 3).astype(np.float32) - 0.5

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int) -> RegistrationPair:
        return make_pair_from_cloud(self.data[item], item, self.cfg, self.partition)

    def raw_clouds(self) -> np.ndarray:
        """[n_items, cloud_points, 3] raw clouds, for ``Trainer.train_epoch_raw``."""
        return self.data


EVAL_OVERLAP = 0.575  # the partial eval protocol's expected overlap of the two crops


def shapes_eval_set(n_items: int, num_points: int = 1024, cloud_points: int = 2048,
                    seed: int = 7, partial: bool = False, overlap: float = EVAL_OVERLAP) -> dict:
    """The JAX package's synthetic 'shapes' eval set
    (``SyntheticDataset(cfg, 'test', kind='shapes')``) as stacked numpy
    arrays keyed as :data:`PAIR_KEYS`. ``partial`` crops each cloud to the
    ``Config(partial=True, overlap=overlap).n_cropped`` points around one of
    its own; ``cloud_points`` must be at least ``num_points``."""
    if cloud_points < num_points:
        raise ValueError(f"cloud_points={cloud_points} < num_points={num_points}")
    kw = dict(partial=True, overlap=overlap) if partial else {}
    ds = SyntheticDataset(Config(num_points=num_points, **kw), "test", n_items, cloud_points,
                          seed, kind="shapes")
    return collate([ds[i] for i in range(n_items)])
