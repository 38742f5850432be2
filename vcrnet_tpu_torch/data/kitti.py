"""KITTI odometry velodyne frames (counterpart of vcrnet_tpu/data/kitti.py).

Training sequences 00/03/05/07/10 at a stride of 3, test sequences
02/04/06/08/09. An item reads a raw velodyne ``.bin`` (numpy alone), pads
or truncates it to ``int(num_points / reserve) + 1`` points, divides by
30, and draws the KITTI transform (x and y within 5 degrees, z within 30,
translations within (5, 5, 1) m / 30) from the global numpy generator in
the JAX package's order, a test item seeding it with its index first. The
index files are HDF5: ``_load_index`` imports h5py.
"""

from __future__ import annotations

import os

import numpy as np

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import RegistrationPair, euler_zyx_mat, nn_crop

TRAIN_SEQS = ["00", "03", "05", "07", "10"]
TEST_SEQS = ["02", "04", "06", "08", "09"]


def _load_index(data_dir: str, partition: str):
    """(idx [M, 3] int32, rotations [M, 3, 3], translations [M, 3]) of the
    partition's sequences, from ``<data_dir>/h5/<seq>.h5``."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"h5py is needed to read the KITTI index .h5 files ({e})") from e
    train = partition == "train"
    seqs = TRAIN_SEQS if train else TEST_SEQS
    suffix = "train" if train else "odo"
    stride = slice(None, None, 3) if train else slice(None)
    all_idx, rotations, translations = [], [], []
    for seq in seqs:
        with h5py.File(os.path.join(data_dir, "h5", f"{seq}.h5"), "r") as f:
            all_idx.append(f[f"idx_{suffix}"][stride].astype("int32"))
            rotations.append(f[f"rotations_{suffix}"][stride].astype("float32"))
            translations.append(f[f"translations_{suffix}"][stride].astype("float32"))
    return (np.concatenate(all_idx, axis=0), np.concatenate(rotations, axis=0),
            np.concatenate(translations, axis=0))


def read_velodyne_bin(path: str, num_points: int) -> np.ndarray:
    """xyz [num_points, 3] of a velodyne frame: the first ``num_points``
    points, or all of them followed by copies of point ``n // 6`` where the
    frame holds fewer."""
    pc = np.fromfile(path, dtype=np.float32, count=-1).reshape(-1, 4)[:, :3]
    n = pc.shape[0]
    if n < num_points:
        return np.concatenate([pc, np.tile(pc[n // 6, :], (num_points - n, 1))], axis=0)
    return pc[:num_points]


class KITTI:
    """Map-style dataset of registration pairs from ``<data_dir>/kitti_down``."""

    def __init__(self, cfg: Config, partition: str = "train"):
        self.cfg = cfg
        self.partition = partition
        base = cfg.data_dir or os.environ.get("VCRNET_DATA")
        if base is None:
            raise FileNotFoundError("KITTI data not found: set cfg.data_dir")
        self.data_dir = os.path.join(base, "kitti_down")
        self.all_idx, self.rotations, self.translations = _load_index(self.data_dir, partition)

    def __len__(self):
        return self.all_idx.shape[0]

    def __getitem__(self, item: int) -> RegistrationPair:
        cfg = self.cfg
        n_load = int(cfg.num_points / cfg.reserve) + 1
        seq, bin_num = int(self.all_idx[item, 0]), int(self.all_idx[item, 1])
        path = os.path.join(self.data_dir, "bin", f"{seq:02d}", "velodyne", f"{bin_num:06d}.bin")
        pointcloud = read_velodyne_bin(path, n_load) / 30.0
        if self.partition != "train":
            np.random.seed(item)

        anglex = (np.random.uniform() - 0.5) * 2 * 5.0 / 180.0 * np.pi
        angley = (np.random.uniform() - 0.5) * 2 * 5.0 / 180.0 * np.pi
        anglez = (np.random.uniform() - 0.5) * 2 * 30.0 / 180.0 * np.pi
        R_ab = euler_zyx_mat(anglez, angley, anglex)
        R_ba = R_ab.T
        t_ab = np.array([np.random.uniform(-5.0, 5.0) / 30.0, np.random.uniform(-5.0, 5.0) / 30.0,
                         np.random.uniform(-1.0, 1.0) / 30.0])
        t_ba = -R_ba.dot(t_ab)

        pc1 = np.random.permutation(pointcloud)
        pc2 = pc1 @ R_ab.T + t_ab
        euler_ab = np.asarray([anglez, angley, anglex])
        euler_ba = -euler_ab[::-1]
        if cfg.partial:
            pc1 = nn_crop(pc1, cfg.reserve)
        pc1 = np.random.permutation(pc1[: cfg.num_points])
        if cfg.partial:
            pc2 = nn_crop(pc2, cfg.reserve)
        pc2 = np.random.permutation(pc2[: cfg.num_points])

        f32 = np.float32
        return RegistrationPair(
            src=pc1.astype(f32), tgt=pc2.astype(f32), R_ab=R_ab.astype(f32),
            t_ab=t_ab.astype(f32), R_ba=R_ba.astype(f32), t_ba=t_ba.astype(f32),
            euler_ab=euler_ab.astype(f32), euler_ba=euler_ba.astype(f32), label=0,
        )
