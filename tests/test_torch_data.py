"""The port's dataset readers, loaders and prefetch against the JAX
package's (vcrnet_tpu/data/{fixtures,modelnet40,kitti,pipeline}.py), and
its on-device augmentation against the JAX function's distributions.

Readers and loaders run the same numpy draws in the same order, so pairs
and batches from the same tree and seed are held bit for bit. The on-device
augmentation draws from a torch generator where the JAX function draws from
its own, so it is held as distributions: two-sample Kolmogorov-Smirnov
tests of the angles and translations (p > 1e-3, 4000 clouds from fixed
seeds, so each p-value is a fixed number), their ranges, and the geometry
of every pair exactly (points from the raw cloud, tgt = R src + t, the
crop the nearest-to-seed set)."""

import os
import threading

import numpy as np
import pytest
import torch

import jax

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import augment as jaugment
from vcrnet_tpu.data import fixtures as jfixtures
from vcrnet_tpu.data import pipeline as jpipeline
from vcrnet_tpu.data.kitti import KITTI as JKITTI, read_velodyne_bin as j_read_bin
from vcrnet_tpu.data.modelnet40 import ModelNet40 as JModelNet40, load_h5 as j_load_h5
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data import fixtures, pipeline
from vcrnet_tpu_torch.data.augment import PAIR_KEYS, device_augment_batch
from vcrnet_tpu_torch.data.kitti import KITTI, read_velodyne_bin
from vcrnet_tpu_torch.data.modelnet40 import ModelNet40, load_h5, resolve_data_dir
from vcrnet_tpu_torch.data.synthetic import SyntheticDataset

MN_TRAIN = (4, 4, 4, 4, 3)
MN_TEST = (4, 3)
MN_POINTS = 256


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: these small tensors gain nothing
    from more, and the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One fake ModelNet40 and KITTI tree written by each package's writer."""
    out = {}
    for name, mod in (("port", fixtures), ("jax", jfixtures)):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_fake_modelnet40_tree(root, MN_TRAIN, MN_TEST, cloud_points=MN_POINTS, seed=3)
        mod.make_fake_kitti_tree(root, frames_per_seq=7, points_per_frame=512, seed=4)
        out[name] = root
    return out


def _files(root):
    found = []
    for dirpath, _, names in os.walk(root):
        found += [os.path.relpath(os.path.join(dirpath, n), root) for n in names]
    return sorted(found)


def test_fixture_writers_write_the_same_trees(trees):
    import h5py

    files = _files(trees["port"])
    assert files == _files(trees["jax"])
    assert sum(f.endswith(".bin") for f in files) == 70
    assert sum(f.endswith(".h5") for f in files) == 17
    for rel in files:
        a, b = (os.path.join(trees[k], rel) for k in ("port", "jax"))
        if not rel.endswith(".h5"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
            continue
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
            assert sorted(fa) == sorted(fb), rel
            for key in fa:
                assert fa[key].dtype == fb[key].dtype, (rel, key)
                np.testing.assert_array_equal(fa[key][:], fb[key][:], err_msg=f"{rel}:{key}")


def test_kitti_frames_without_the_index_need_no_h5py(tmp_path, trees):
    """with_index=False writes the same velodyne frames and no h5/."""
    root = fixtures.make_fake_kitti_tree(str(tmp_path), frames_per_seq=7, points_per_frame=512,
                                         seed=4, with_index=False)
    assert not os.path.exists(os.path.join(root, "h5"))
    for rel in _files(root):
        with open(os.path.join(root, rel), "rb") as fa, \
                open(os.path.join(trees["jax"], "kitti_down", rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("n", [40, 64, 200])
def test_read_velodyne_bin_pads_and_truncates_as_jax(tmp_path, n):
    pts = np.random.RandomState(n).rand(64, 4).astype(np.float32)
    path = str(tmp_path / "f.bin")
    pts.tofile(path)
    got = read_velodyne_bin(path, n)
    np.testing.assert_array_equal(got, j_read_bin(path, n))
    assert got.shape == (n, 3)
    if n > 64:
        np.testing.assert_array_equal(got[64:], np.tile(pts[64 // 6, :3], (n - 64, 1)))


def _mn_dir(root):
    return os.path.join(root, "modelnet40_ply_hdf5_2048")


@pytest.mark.parametrize("partition", ["train", "test"])
def test_load_h5_equals_jax(trees, partition):
    d = _mn_dir(trees["port"])
    data, label = load_h5(d, partition)
    j_data, j_label = j_load_h5(d, partition)
    np.testing.assert_array_equal(data, j_data)
    np.testing.assert_array_equal(label, j_label)
    assert data.dtype == np.float32 and label.dtype == np.int64
    assert data.shape == (sum(MN_TRAIN if partition == "train" else MN_TEST), MN_POINTS, 3)


def _same_pair(got, want):
    for key in PAIR_KEYS:
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


MN_CASES = [dict(), dict(unseen=True), dict(partial=True, overlap=0.575),
            dict(gaussian_noise=True)]


@pytest.mark.parametrize("kw", MN_CASES)
@pytest.mark.parametrize("partition", ["train", "test"])
def test_modelnet40_pairs_equal_jax(trees, kw, partition):
    cfg = dict(num_points=128, data_dir=trees["port"], **kw)
    ds, jds = ModelNet40(Config(**cfg), partition), JModelNet40(JConfig(**cfg), partition)
    assert len(ds) == len(jds) > 0
    np.testing.assert_array_equal(ds.raw_clouds(), jds.raw_clouds())
    for item in range(len(ds)):
        np.random.seed(100 + item)  # training items draw from the global generator
        got = ds[item]
        np.random.seed(100 + item)
        _same_pair(got, jds[item])
    assert got.src.shape == (Config(**cfg).n_cropped, 3)


@pytest.mark.parametrize("kw", [dict(), dict(partial=True, overlap=0.575)])
@pytest.mark.parametrize("partition", ["train", "test"])
def test_kitti_pairs_equal_jax(trees, kw, partition):
    """7 frames a sequence, 6 index rows: 2 a training sequence at the
    stride of 3, 6 a test one; every fifth frame is shorter than the 257
    (partial: 342) points an item loads (the padding). KITTI loads
    num_points / reserve points, so the crop keeps num_points."""
    cfg = dict(dataset="kitti", num_points=256, data_dir=trees["port"], **kw)
    ds, jds = KITTI(Config(**cfg), partition), JKITTI(JConfig(**cfg), partition)
    assert len(ds) == len(jds) == (10 if partition == "train" else 30)
    np.testing.assert_array_equal(ds.all_idx, jds.all_idx)
    for item in range(len(ds)):
        np.random.seed(7 + item)
        got = ds[item]
        np.random.seed(7 + item)
        _same_pair(got, jds[item])
    assert got.src.shape == (256, 3)


def _batches(loader):
    return [{k: v for k, v in b.items() if k != "label"} for b in loader]


def _same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("dataset", ["modelnet40", "synthetic", "synthetic_shapes", "kitti",
                                     "modelnet40_fallback"])
def test_make_loaders_give_the_jax_batches(trees, dataset, monkeypatch):
    """Both partitions, in order; the training loader shuffled from cfg.seed
    and the test loader's last batch padded. The fallback: no data on disk
    (nor $VCRNET_DATA; the JAX package makes no download attempt with
    $VCRNET_OFFLINE set) gives the synthetic sets in both packages."""
    monkeypatch.delenv("VCRNET_DATA", raising=False)
    monkeypatch.setenv("VCRNET_OFFLINE", "1")
    kw = dict(num_points=64, batch_size=8, test_batch_size=12, seed=5)
    if dataset == "modelnet40_fallback":
        kw["dataset"] = "modelnet40"
        assert resolve_data_dir(Config(**kw)) is None
        assert not os.path.isdir(os.path.join(os.path.dirname(pipeline.__file__), "..", "..",
                                              "dataset", "modelnet40_ply_hdf5_2048"))
    else:
        kw["dataset"] = dataset
        kw["data_dir"] = trees["port"]
    loaders = pipeline.make_loaders(Config(**kw))
    j_loaders = jpipeline.make_loaders(JConfig(**kw))
    assert type(loaders[0].dataset).__name__ == type(j_loaders[0].dataset).__name__
    for loader, j_loader in zip(loaders, j_loaders):
        assert len(loader) == len(j_loader)
        np.random.seed(11)
        got = _batches(loader)
        np.random.seed(11)
        _same_batches(got, _batches(j_loader))
    assert got[-1]["valid"].shape == (12,)


def test_a_named_directory_without_the_data_falls_back_to_synthetic(tmp_path, monkeypatch):
    """The port's resolve_data_dir asks for ply_data_*.h5 files, so an empty
    data_dir gives the synthetic fallback (the JAX package takes the
    directory as named and raises in load_h5)."""
    monkeypatch.delenv("VCRNET_DATA", raising=False)
    cfg = Config(dataset="modelnet40", data_dir=str(tmp_path), num_points=64)
    assert resolve_data_dir(cfg) is None
    train, test = pipeline.make_datasets(cfg)
    assert isinstance(train, SyntheticDataset) and isinstance(test, SyntheticDataset)
    assert (len(train), len(test)) == (256, 128)
    with pytest.raises(FileNotFoundError):
        JModelNet40(JConfig(dataset="modelnet40", data_dir=str(tmp_path), num_points=64))
    with pytest.raises(FileNotFoundError, match="not found"):
        ModelNet40(cfg)


def test_collate_and_loader_are_reexported_by_synthetic():
    from vcrnet_tpu_torch.data import synthetic

    assert synthetic.Loader is pipeline.Loader and synthetic.collate is pipeline.collate


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate() if t is not threading.current_thread()
            and t.daemon and t.is_alive()]


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_keeps_the_order_and_maps_on_its_worker(depth):
    before = len(_prefetch_threads())
    workers = set()

    def map_fn(x):
        workers.add(threading.get_ident())
        return x * 10

    assert list(pipeline.prefetch(range(37), map_fn, depth=depth)) == [10 * i for i in range(37)]
    assert workers and threading.get_ident() not in workers
    assert len(_prefetch_threads()) == before


def test_prefetch_raises_the_workers_exception_in_the_consumer():
    def items():
        yield 1
        yield 2
        raise KeyError("bad item")

    got = []
    with pytest.raises(KeyError, match="bad item"):
        for x in pipeline.prefetch(items()):
            got.append(x)
    assert got == [1, 2]
    with pytest.raises(ZeroDivisionError):
        list(pipeline.prefetch(range(3), lambda x: 1 // (x - 2)))


def test_prefetch_drains_and_stops_its_worker_on_an_early_exit():
    before = len(_prefetch_threads())
    produced = []

    def items():
        for i in range(1000):
            produced.append(i)
            yield i

    gen = pipeline.prefetch(items(), depth=2)
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    gen.close()
    assert len(_prefetch_threads()) == before
    assert len(produced) < 10  # the worker stopped a few batches ahead

    def consume():
        for x in pipeline.prefetch(items(), depth=2):
            if x == 5:
                raise RuntimeError("consumer failed")

    with pytest.raises(RuntimeError, match="consumer failed"):
        consume()
    assert len(_prefetch_threads()) == before


def test_cpu_trainer_stages_unpinned_tensors():
    from vcrnet_tpu_torch.train import Trainer

    tr = Trainer(Config(num_points=32, emb_dims=256, ff_dims=128, n_heads=2), device="cpu")
    np.random.seed(0)
    batch = next(iter(pipeline.Loader(SyntheticDataset(tr.cfg, n_items=4, cloud_points=64), 4)))
    batch["label"] = np.zeros(4, np.int32)
    staged = tr.stage(batch)
    assert set(staged) == set(PAIR_KEYS) | {"valid"}
    assert all(v.dtype == torch.float32 and not v.is_pinned() for v in staged.values())
    on_dev = tr.to_device(staged)
    for k in PAIR_KEYS:
        np.testing.assert_array_equal(on_dev[k].numpy(), batch[k])
    raw = tr.stage({"clouds": np.zeros((3, 64, 3), np.float32)})
    np.testing.assert_array_equal(raw["valid"].numpy(), np.ones(3))


# ---------------------------------------------------------------------------
# device_augment_batch
# ---------------------------------------------------------------------------

N_CLOUDS = 4000
RAW_POINTS = 48


def _raw_clouds(n=N_CLOUDS, m=RAW_POINTS, seed=0):
    return np.random.RandomState(seed).rand(n, m, 3).astype(np.float32) - 0.5


def _augment_both(cfg_kw, seed=0):
    clouds = _raw_clouds()
    gen = torch.Generator().manual_seed(seed)
    port = device_augment_batch(gen, torch.from_numpy(clouds), Config(**cfg_kw))
    port = {k: v.numpy().astype(np.float64) for k, v in port.items()}
    jx = jaugment.device_augment_batch(jax.random.PRNGKey(seed), jax.numpy.asarray(clouds),
                                       JConfig(**cfg_kw))
    jx = {k: np.asarray(v, np.float64) for k, v in jx.items()}
    return clouds.astype(np.float64), port, jx


def _nearest_sq(a, b):
    """Per item, the squared distance of each row of a [B, n, 3] to its
    nearest row of b [B, m, 3]."""
    return ((a[:, :, None, :] - b[:, None, :, :]) ** 2).sum(-1).min(-1)


@pytest.mark.parametrize("factor", [4.0, 2.0])
def test_device_augment_angles_and_translations_follow_the_jax_distributions(factor):
    from scipy import stats

    kw = dict(num_points=32, factor=factor)
    _, port, jx = _augment_both(kw)
    top = np.pi / factor
    for name, lo, hi in (("euler_ab", 0.0, top), ("t_ab", -0.5, 0.5)):
        p, j = port[name], jx[name]
        assert p.shape == j.shape == (N_CLOUDS, 3)
        assert p.min() >= lo and p.max() < hi
        # the draws span their range and centre on its middle (4 standard errors)
        assert p.min() < lo + 0.01 * (hi - lo) and p.max() > hi - 0.01 * (hi - lo)
        se = (hi - lo) / np.sqrt(12 * N_CLOUDS)
        np.testing.assert_allclose(p.mean(0), (lo + hi) / 2, atol=4 * se)
        np.testing.assert_allclose(j.mean(0), (lo + hi) / 2, atol=4 * se)
        for axis in range(3):
            assert stats.ks_2samp(p[:, axis], j[:, axis]).pvalue > 1e-3, (name, axis)
    for out in (port, jx):
        np.testing.assert_allclose(out["euler_ba"], -out["euler_ab"][:, ::-1])


@pytest.mark.parametrize("noise", [False, True])
def test_device_augment_pairs_are_rigid_copies_of_raw_points(noise):
    """Every source point is a raw point (moved by the jitter, at most
    0.05 a coordinate), the target is R src + t as a set, and R_ba, t_ba
    invert it; for both functions."""
    kw = dict(num_points=32, gaussian_noise=noise)
    clouds, port, jx = _augment_both(kw)
    for out in (port, jx):
        src, tgt = out["src"], out["tgt"]
        assert src.shape == tgt.shape == (N_CLOUDS, 32, 3)
        moved = np.einsum("bij,bnj->bni", out["R_ab"], src) + out["t_ab"][:, None]
        assert _nearest_sq(moved, tgt).max() < 1e-10
        if noise:
            assert _nearest_sq(src, clouds).max() <= 3 * 0.05 ** 2 + 1e-9
            assert _nearest_sq(src, clouds).max() > 1e-6
        else:
            assert _nearest_sq(src, clouds).max() == 0.0
        back = np.einsum("bij,bnj->bni", out["R_ba"], tgt) + out["t_ba"][:, None]
        assert _nearest_sq(back, src).max() < 1e-10
        eye = np.einsum("bij,bkj->bik", out["R_ab"], out["R_ab"])
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-6)
    # a subsample draws points without repeats, from all over the cloud
    uniq = [len(np.unique(s, axis=0)) for s in port["src"][:50]]
    assert min(uniq) == 32


def test_device_augment_shuffles_each_row_independently():
    gen = torch.Generator().manual_seed(1)
    same = torch.from_numpy(np.repeat(_raw_clouds(1, 64), 16, axis=0))
    out = device_augment_batch(gen, same, Config(num_points=64, factor=1e9))
    # all 16 rows hold the same 64 points (the rotation is ~identity) in other orders
    rows = out["src"].numpy()
    assert all(np.array_equal(np.sort(r, axis=0), np.sort(rows[0], axis=0)) for r in rows)
    assert len({r.tobytes() for r in rows}) == 16


def test_device_augment_crop_is_the_nearest_to_seed_set():
    """num_points = all the raw points, so the cloud before the crop is the
    raw cloud as a set: the crop keeps its int(N * reserve) points nearest
    the crop's first point (the seed, at distance 0), nearest first."""
    kw = dict(num_points=RAW_POINTS, partial=True, overlap=0.575)
    cfg = Config(**kw)
    n_keep = int(RAW_POINTS * cfg.reserve)
    clouds, port, jx = _augment_both(kw)
    for out in (port, jx):
        src = out["src"][:500]
        assert src.shape == (500, n_keep, 3)
        seed = src[:, :1]
        d_raw = np.sort(((clouds[:500] - seed) ** 2).sum(-1), axis=1)
        d_kept = ((src - seed) ** 2).sum(-1)
        assert (d_kept[:, 0] == 0).all()
        assert (np.diff(d_kept, axis=1) >= 0).all()
        np.testing.assert_allclose(d_kept, d_raw[:, :n_keep], rtol=1e-6, atol=1e-9)
        tgt_moved_back = np.einsum("bji,bnj->bni", out["R_ab"][:500],
                                   out["tgt"][:500] - out["t_ab"][:500, None])
        assert _nearest_sq(tgt_moved_back, clouds[:500]).max() < 1e-10


def test_device_augment_rejects_more_points_than_the_cloud_holds():
    with pytest.raises(ValueError, match="num_points"):
        device_augment_batch(torch.Generator(), torch.zeros(1, 16, 3), Config(num_points=32))


def test_chip_smoke_reads_the_fake_trees_where_h5py_imports(tmp_path):
    """The branch of chip_smoke.py's data phase that the card's machine
    skips (it has no h5py) runs here."""
    import chip_smoke

    chip_smoke.check_dataset_trees(str(tmp_path))
    assert os.path.isdir(os.path.join(str(tmp_path), "kitti_down", "h5"))
