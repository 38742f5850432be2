"""Batching, prefetch and the dataset dispatch (counterpart of
vcrnet_tpu/data/pipeline.py).

``Loader`` stacks a map-style dataset's pairs into dicts of [B, ...] numpy
arrays; ``prefetch`` runs any batch iterable on a worker thread, a bounded
number of batches ahead of its consumer, with an optional ``map_fn``
applied there. The trainer's ``map_fn`` turns a batch into pinned host
tensors (``Trainer.stage``) and the consumer copies them to the card with
``non_blocking=True`` on the current stream, so the copy queues behind the
previous step's kernels while the worker prepares the next batch.
``make_datasets`` follows the CLI's dataset names, with the synthetic
fallback where ModelNet40 is not on disk.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import PAIR_KEYS


def collate(pairs) -> dict:
    """Stack pairs into a dict of [B, ...] float32 arrays (no labels)."""
    return {key: np.stack([getattr(p, key) for p in pairs]) for key in PAIR_KEYS}


class Loader:
    """Batches of a map-style dataset as dicts of numpy arrays. Train:
    shuffle (seeded) and drop the ragged tail; eval: in order, the last
    batch padded by repeating its last pair, with a 'valid' mask [B]
    (1 = real pair) that the metric sums weight by."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            batch = collate([self.dataset[int(i)] for i in idx])
            valid = np.ones(len(idx), np.float32)
            if len(idx) < bs:
                pad = bs - len(idx)
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
                valid = np.concatenate([valid, np.zeros(pad, np.float32)])
            batch["valid"] = valid
            yield batch


def prefetch(loader, map_fn=None, depth: int = 2):
    """Iterate ``loader`` on a worker thread, applying ``map_fn`` there, at
    most ``depth`` batches ahead of the consumer. An exception of the worker
    is raised again in the consumer. When the consumer stops early (the
    generator closed, or an exception in its loop) the worker is told to
    stop and the queue is drained, so no thread stays parked on a batch."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in loader:
                if not put(map_fn(item) if map_fn is not None else item):
                    return
            put(sentinel)
        except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while thread.is_alive():  # unblock a worker waiting to put, drop its batches
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()


def make_datasets(cfg: Config):
    """(train, test) datasets for ``cfg.dataset``: ``modelnet40`` (the
    synthetic shapes of uniform noise where the data is not on disk),
    ``kitti``, ``synthetic`` or ``synthetic_shapes``."""
    from vcrnet_tpu_torch.data.synthetic import SyntheticDataset

    if cfg.dataset == "modelnet40":
        from vcrnet_tpu_torch.data.modelnet40 import ModelNet40, resolve_data_dir

        if resolve_data_dir(cfg) is not None:
            return ModelNet40(cfg, "train"), ModelNet40(cfg, "test")
        return SyntheticDataset(cfg, "train"), SyntheticDataset(cfg, "test", n_items=128)
    if cfg.dataset == "kitti":
        from vcrnet_tpu_torch.data.kitti import KITTI

        return KITTI(cfg, "train"), KITTI(cfg, "test")
    if cfg.dataset in ("synthetic", "synthetic_shapes"):
        kind = "shapes" if cfg.dataset == "synthetic_shapes" else "uniform"
        return (SyntheticDataset(cfg, "train", n_items=1024, kind=kind),
                SyntheticDataset(cfg, "test", n_items=128, kind=kind))
    raise ValueError(f"unknown dataset: {cfg.dataset}")


def make_loaders(cfg: Config):
    """(train, test) Loaders: training shuffled from ``cfg.seed`` with the
    ragged tail dropped, test in order with the last batch padded."""
    train_ds, test_ds = make_datasets(cfg)
    return (Loader(train_ds, cfg.batch_size, shuffle=True, drop_last=True, seed=cfg.seed),
            Loader(test_ds, cfg.test_batch_size, shuffle=False, drop_last=False))
