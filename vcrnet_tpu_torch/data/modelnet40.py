"""ModelNet40 in HDF5 (counterpart of vcrnet_tpu/data/modelnet40.py).

Reads ``ply_data_{train,test}*.h5`` from the directory named by
``cfg.data_dir``, else ``$VCRNET_DATA``, else ``<repo>/dataset`` (each
either the ``modelnet40_ply_hdf5_2048`` directory or its parent). Where it
holds no such file, ``resolve_data_dir`` returns None and
``make_datasets`` falls back to synthetic clouds (the JAX package takes a
named directory as it is, and raises in ``load_h5`` where it is empty). The
port never downloads the dataset. Pairs come
from ``augment.make_pair_from_cloud`` in the JAX package's draw order;
``cfg.unseen`` keeps categories 0-19 for training and 20-39 for testing.
h5py is imported by ``load_h5`` alone.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import RegistrationPair, make_pair_from_cloud

SUBDIR = "modelnet40_ply_hdf5_2048"


def default_data_root() -> str:
    """``<repo>/dataset``: the dataset kept beside the repository."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "dataset")


def _holds_h5(d: str) -> bool:
    return bool(glob.glob(os.path.join(d, "ply_data_*.h5")))


def resolve_data_dir(cfg: Config) -> str | None:
    """The ModelNet40 directory to read, or None where there is none."""
    root = cfg.data_dir or os.environ.get("VCRNET_DATA") or default_data_root()
    for d in (os.path.join(root, SUBDIR), root):
        if _holds_h5(d):
            return d
    return None


def load_h5(data_dir: str, partition: str):
    """(clouds [M, 2048, 3] f32, labels [M, 1] int64) of every
    ``ply_data_{partition}*.h5`` under ``data_dir``, in name order."""
    files = sorted(glob.glob(os.path.join(data_dir, f"ply_data_{partition}*.h5")))
    if not files:
        raise FileNotFoundError(
            f"no ply_data_{partition}*.h5 under {data_dir}; set cfg.data_dir "
            f"or $VCRNET_DATA to a {SUBDIR} directory"
        )
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"h5py is needed to read the ModelNet40 .h5 files ({e})") from e
    all_data, all_label = [], []
    for name in files:
        with h5py.File(name, "r") as f:
            all_data.append(f["data"][:].astype("float32"))
            all_label.append(f["label"][:].astype("int64"))
    return np.concatenate(all_data, axis=0), np.concatenate(all_label, axis=0)


class ModelNet40:
    """Map-style dataset of registration pairs from the ModelNet40 clouds."""

    def __init__(self, cfg: Config, partition: str = "train"):
        self.cfg = cfg
        self.partition = partition
        data_dir = resolve_data_dir(cfg)
        if data_dir is None:
            raise FileNotFoundError("ModelNet40 data not found: set cfg.data_dir or $VCRNET_DATA")
        self.data, label = load_h5(data_dir, partition)
        self.label = label.squeeze()
        if cfg.unseen:
            keep = self.label >= 20 if partition == "test" else self.label < 20
            self.data = self.data[keep]
            self.label = self.label[keep]

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int) -> RegistrationPair:
        return make_pair_from_cloud(self.data[item], item, self.cfg, self.partition, label=0)

    def raw_clouds(self) -> np.ndarray:
        """[num_items, 2048, 3] raw clouds, for ``Trainer.train_epoch_raw``."""
        return self.data
