"""Fake dataset trees with the real datasets' on-disk layout (a copy of
vcrnet_tpu/data/fixtures.py, built on this package's ``random_shape_cloud``).

The same seed writes the same arrays as the JAX package's writer, so the
two packages' readers can be held against each other on one tree.

ModelNet40 (modelnet40_ply_hdf5_2048): ``ply_data_train{0..4}.h5`` and
``ply_data_test{0,1}.h5``, each with ``data`` [M, 2048, 3] f32, ``label``
[M, 1] uint8, ``normal`` [M, 2048, 3] f32 and ``faceId`` [M, 2048] int32,
beside ``shape_names.txt``, ``{train,test}_files.txt`` and the
``*_id2file.json`` sidecars.

KITTI (kitti_down): ``h5/<seq>.h5`` with ``idx_train`` /
``rotations_train`` / ``translations_train`` for sequences 00/03/05/07/10
and ``idx_odo`` / ``rotations_odo`` / ``translations_odo`` for
02/04/06/08/09; ``bin/<seq>/velodyne/<n>.bin`` raw [N, 4] f32 frames. Idx
rows are (seq, bin, bin_next).

The velodyne frames are written with numpy alone; h5py is imported only by
the code that writes an ``.h5`` file, so ``make_fake_kitti_tree(...,
with_index=False)`` runs where h5py is not installed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vcrnet_tpu_torch.data.synthetic import random_shape_cloud

MODELNET40_SHAPE_NAMES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]

# the real tree's items per file
FULL_TRAIN_COUNTS = (2048, 2048, 2048, 2048, 1648)
FULL_TEST_COUNTS = (2048, 420)

KITTI_TRAIN_SEQS = ("00", "03", "05", "07", "10")
KITTI_TEST_SEQS = ("02", "04", "06", "08", "09")


def make_fake_modelnet40_tree(root: str, items_per_train_file: tuple = (16, 16, 16, 16, 12),
                              items_per_test_file: tuple = (16, 8), cloud_points: int = 2048,
                              seed: int = 0) -> str:
    """Write a modelnet40_ply_hdf5_2048 tree under ``root`` and return its
    directory. The clouds are compositions of primitive surfaces in the unit
    ball. Needs h5py."""
    import h5py

    target = os.path.join(root, "modelnet40_ply_hdf5_2048")
    os.makedirs(target, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(target, "shape_names.txt"), "w") as f:
        f.write("\n".join(MODELNET40_SHAPE_NAMES) + "\n")

    for partition, counts in (("train", items_per_train_file), ("test", items_per_test_file)):
        names = []
        for i, m in enumerate(counts):
            name = f"ply_data_{partition}{i}.h5"
            data = np.stack([random_shape_cloud(rng, cloud_points) for _ in range(m)])
            label = rng.randint(0, 40, size=(m, 1)).astype(np.uint8)
            normal = rng.randn(m, cloud_points, 3).astype(np.float32)
            normal /= np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-9
            face_id = rng.randint(0, 4 * cloud_points, size=(m, cloud_points)).astype(np.int32)
            with h5py.File(os.path.join(target, name), "w") as f:
                f.create_dataset("data", data=data.astype(np.float32))
                f.create_dataset("label", data=label)
                f.create_dataset("normal", data=normal)
                f.create_dataset("faceId", data=face_id)
            id2file = [f"{partition}/{MODELNET40_SHAPE_NAMES[int(l)]}_{j:04d}.ply"
                       for j, l in enumerate(label[:, 0])]
            with open(os.path.join(target, f"ply_data_{partition}_{i}_id2file.json"), "w") as f:
                json.dump(id2file, f)
            names.append(name)
        with open(os.path.join(target, f"{partition}_files.txt"), "w") as f:
            f.write("\n".join(f"data/modelnet40_ply_hdf5_2048/{n}" for n in names) + "\n")
    return target


def street_like_frame(rng: np.random.RandomState, n: int) -> np.ndarray:
    """A velodyne-like frame [n, 4] f32 (x, y, z, intensity): a ground disc
    and a few vertical structures, in metres (the reader divides by 30)."""
    n_ground = int(n * 0.6)
    ang = rng.uniform(0, 2 * np.pi, n_ground)
    r = 25.0 * np.sqrt(rng.uniform(0.01, 1.0, n_ground))
    parts = [np.stack([r * np.cos(ang), r * np.sin(ang), rng.normal(-1.7, 0.05, n_ground)],
                      axis=1)]
    remaining = n - n_ground
    n_struct = rng.randint(3, 7)
    counts = np.full(n_struct, remaining // n_struct)
    counts[: remaining - counts.sum()] += 1
    for m in counts:
        cx, cy = rng.uniform(-20, 20, 2)
        w = rng.uniform(0.5, 4.0)
        h = rng.uniform(2.0, 10.0)
        parts.append(np.stack([cx + rng.uniform(-w, w, m), cy + rng.uniform(-w, w, m),
                               rng.uniform(-1.7, h, m)], axis=1))
    pts = np.concatenate(parts, axis=0).astype(np.float32)
    intensity = rng.uniform(0, 1, (pts.shape[0], 1)).astype(np.float32)
    return np.concatenate([pts, intensity], axis=1)


def make_fake_kitti_tree(root: str, frames_per_seq: int = 12, points_per_frame: int = 4096,
                         seed: int = 0, with_index: bool = True) -> str:
    """Write a kitti_down tree (both partitions, all ten sequences) under
    ``root`` and return its directory. Every fifth frame holds an eighth of
    ``points_per_frame`` points, shorter than a reader asks for, so the
    reader's padding runs. ``with_index=False`` writes the velodyne frames
    alone (no ``h5/``, no h5py) and draws the same numbers."""
    target = os.path.join(root, "kitti_down")
    rng = np.random.RandomState(seed)
    for seqs, idx_key, rot_key, tr_key in (
        (KITTI_TRAIN_SEQS, "idx_train", "rotations_train", "translations_train"),
        (KITTI_TEST_SEQS, "idx_odo", "rotations_odo", "translations_odo"),
    ):
        for seq in seqs:
            vel_dir = os.path.join(target, "bin", seq, "velodyne")
            os.makedirs(vel_dir, exist_ok=True)
            for b in range(frames_per_seq):
                n = (points_per_frame // 8 if b % 5 == 4
                     else points_per_frame + rng.randint(-256, 256))
                street_like_frame(rng, n).tofile(os.path.join(vel_dir, f"{b:06d}.bin"))
            m = frames_per_seq - 1
            idx = np.stack([np.full(m, int(seq), np.int32), np.arange(m, dtype=np.int32),
                            np.arange(1, m + 1, dtype=np.int32)], axis=1)
            rots = np.tile(np.eye(3, dtype=np.float32), (m, 1, 1))
            trans = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
            if not with_index:
                continue
            import h5py

            os.makedirs(os.path.join(target, "h5"), exist_ok=True)
            with h5py.File(os.path.join(target, "h5", f"{seq}.h5"), "w") as f:
                f.create_dataset(idx_key, data=idx)
                f.create_dataset(rot_key, data=rots)
                f.create_dataset(tr_key, data=trans)
    return target
