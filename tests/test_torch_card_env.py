"""The port and chip_smoke.py on an installation like the card's machine,
which has neither h5py nor tensorboardX nor flax (nor, for the port, any
use of JAX or pandas): a subprocess in which those packages cannot be
imported (a ``sys.meta_path`` finder ahead of every other gives them a
loader that raises ``ImportError``) imports every module of the port and chip_smoke.py (and, by name,
the ICP, LPD and FPS modules and what chip_smoke.py's partial_train, icp
and lpd phases call), runs the synthetic datasets and loaders, the
synthetic fallback of ModelNet40, the velodyne frames written and read
back without h5py, an epoch of training through prefetch and one on raw
clouds, a partial-overlap step, an LPD epoch with a checkpoint merged into
VCR-Net, ICP and net + ICP evals, the port's CLI (its ``--help``, and ICP
refusing to train) with pandas blocked too, the data-parallel package and
chip_smoke.py's parallel phase (an epoch in a one-rank Gloo group), the
point-sharding package and chip_smoke.py's point_sharding phase (the
flagship's forward and gradient in that group), and
finds that the ModelNet40 and KITTI readers raise an ImportError that names
h5py."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("h5py", "tensorboardX", "jax", "jaxlib", "flax", "optax", "pandas")

# the preamble of each child: the names in BLOCKED (formatted in), and every
# module under one of them, cannot be imported
FINDER = r'''
import importlib, importlib.abc, importlib.machinery, os, pkgutil, sys, tempfile

BLOCKED = %r


class Absent(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """A spec without an origin whose loader raises ImportError: an import
    fails, and a probe such as torch._dynamo's of pandas (find_spec, then
    the spec's origin) finds nothing to read."""

    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ImportError(f"No module named {spec.name!r}")

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, Absent())
for name in BLOCKED:
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"{name} imported")
'''

CHILD = FINDER % (BLOCKED,) + r'''
import numpy as np

import vcrnet_tpu_torch
for m in pkgutil.walk_packages(vcrnet_tpu_torch.__path__, "vcrnet_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from chip_smoke import grad_cosine, phase_cli, phase_heads, phase_icp, phase_lpd, phase_partial_train
from chip_smoke import parallel_launches, parallel_rank, phase_parallel, run_parallel_tasks

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.icp import icp_register, nearest_neighbor_corr
from vcrnet_tpu_torch.models.lpd import LPD, lpd_loss
from vcrnet_tpu_torch.models.vcrnet import vcrnet_icp
from vcrnet_tpu_torch.ops.fps import farthest_point_sample
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train.checkpoint import merge_pretrained_embedding, save_checkpoint
from vcrnet_tpu_torch.data import fixtures, pipeline
from vcrnet_tpu_torch.data.kitti import KITTI, read_velodyne_bin
from vcrnet_tpu_torch.data.modelnet40 import ModelNet40
from vcrnet_tpu_torch.data.synthetic import SyntheticDataset
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.logging import MetricsWriter

tiny = dict(num_points=32, emb_dims=256, ff_dims=128, n_heads=2, batch_size=4,
            test_batch_size=4)
train, test = pipeline.make_datasets(Config(dataset="synthetic", **tiny))
assert isinstance(train, SyntheticDataset) and (len(train), len(test)) == (1024, 128)
tmp = tempfile.mkdtemp()
os.environ.pop("VCRNET_DATA", None)
empty = os.path.join(tmp, "empty")
os.makedirs(empty)
fb_train, fb_test = pipeline.make_datasets(Config(dataset="modelnet40", data_dir=empty, **tiny))
assert isinstance(fb_train, SyntheticDataset) and isinstance(fb_test, SyntheticDataset)

kitti = fixtures.make_fake_kitti_tree(tmp, frames_per_seq=5, points_per_frame=256, seed=1,
                                      with_index=False)
frames = os.path.join(kitti, "bin", "00", "velodyne")
short = read_velodyne_bin(os.path.join(frames, "000004.bin"), 100)  # 32 points, padded
assert short.shape == (100, 3) and (short[32:] == short[32 // 6]).all()
assert read_velodyne_bin(os.path.join(frames, "000000.bin"), 100).shape == (100, 3)

mn = os.path.join(tmp, "mn", "modelnet40_ply_hdf5_2048")
os.makedirs(mn)
for name in ("ply_data_train0.h5", "ply_data_test0.h5"):
    open(os.path.join(mn, name), "wb").close()
for make in (lambda: ModelNet40(Config(data_dir=os.path.dirname(mn), **tiny)),
             lambda: KITTI(Config(dataset="kitti", data_dir=tmp, **tiny))):
    try:
        make()
    except ImportError as e:
        assert "h5py" in str(e), e
    else:
        raise SystemExit("a reader of .h5 files ran without h5py")

writer = MetricsWriter(os.path.join(tmp, "logs"))
writer.scalar("a", 1.0, 0)
writer.close()

np.random.seed(0)
trainer = Trainer(Config(dataset="synthetic", **tiny), device="cpu", seed=0)
small = SyntheticDataset(trainer.cfg, n_items=8, cloud_points=64)
summary = trainer.train_epoch(pipeline.Loader(small, 4, shuffle=True, drop_last=True))
assert np.isfinite(summary["loss"]), summary
summary = trainer.train_epoch_raw(small.raw_clouds().reshape(2, 4, 64, 3))
assert np.isfinite(summary["loss"]) and trainer.step == 4, summary

partial = Trainer(Config(partial=True, overlap=0.575, **tiny), device="cpu", seed=0)
pairs = SyntheticDataset(partial.cfg, n_items=4, cloud_points=64)
partial.train_epoch(pipeline.Loader(pairs, 4))
assert len(partial.grads_filled) == len(list(partial.model.parameters()))

lpd = Trainer(Config(model="lpd", **tiny), device="cpu", seed=0)
summary = lpd.train_epoch(pipeline.Loader(small, 4))
assert np.isfinite(summary["loss"]) and "mse" in summary, summary
path = save_checkpoint(tmp, "lpd", lpd)
emb = lpd.model.emb_nn.state_dict()
trainer.model.load_state_dict(merge_pretrained_embedding(trainer.model.state_dict(), emb))

icp = Trainer(Config(model="icp", **tiny), device="cpu")
assert np.isfinite(icp.eval_epoch(pipeline.Loader(small, 4))["rot_ab_RMSE"])
net_icp = Registrar(Config(iter=0, **tiny), trainer.model.state_dict(), device="cpu")
clouds = small.raw_clouds()[:2, :32]
assert np.isfinite(net_icp.register(clouds, clouds)["R"]).all()

import contextlib, io
from vcrnet_tpu_torch import cli
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        cli.main(["--help"])
    except SystemExit as e:
        assert e.code == 0, e.code
assert "--use_kernels" in out.getvalue() and "--device" in out.getvalue(), out.getvalue()
os.chdir(tmp)
assert cli.main(["--model", "icp", "--dataset", "synthetic", "--num_points", "32",
                 "--device", "cpu"]) is None

from datetime import timedelta
import torch
from vcrnet_tpu_torch.parallel import initialize, make_mesh
assert initialize() is False and make_mesh().group is None
assert set(chip_smoke._parallel_configs()) == {"vcrnet", "dcp", "vcrnet_eval"}
assert parallel_launches([("v", "step", "vcrnet", None)]) == chip_smoke.TRAIN_LAUNCHES
initialize(init_method="file://" + os.path.join(tmp, "store"), rank=0, world_size=1,
           backend="gloo", timeout=timedelta(seconds=60))
ranked = Trainer(Config(dataset="synthetic", **tiny), device="cpu", seed=0)
assert ranked.mesh.group is not None and ranked.mesh.size == 1
assert np.isfinite(ranked.train_epoch(pipeline.Loader(small, 4))["loss"])
from chip_smoke import phase_point_sharding, point_sharding_rank, run_sp_tasks
from vcrnet_tpu_torch.parallel.mesh import make_mesh_2d
from vcrnet_tpu_torch.parallel.sp_flagship import register_flagship_sp, sp_value_and_grad
grid = make_mesh_2d(1)
assert grid.points.group is not None and grid.size == 1
pair = torch.as_tensor(clouds)
sp_out = register_flagship_sp(ranked.model, pair, pair, make_mesh())
sp_loss, sp_grads = sp_value_and_grad(ranked.model, pair, pair, torch.eye(3).repeat(2, 1, 1),
                                      torch.zeros(2, 3), grid, batch_axis="batch")
assert all(torch.isfinite(x).all() for x in sp_out) and torch.isfinite(sp_loss)
assert all(torch.isfinite(g).all() for g in sp_grads.values())
torch.distributed.destroy_process_group()

bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("card env ok")
'''

# the JAX package's artifact needs no model code, config or checkpoint at the
# destination; the port's needs its op library (vcrnet_tpu_torch.ops) alone
MODEL_CODE = tuple(f"vcrnet_tpu_torch.{m}" for m in ("models", "config", "train", "data"))

LOADER = FINDER % (BLOCKED + MODEL_CODE,) + r'''
import numpy as np

from vcrnet_tpu_torch.exported import load_exported

for name in ("vcrnet_tpu_torch.serve", "vcrnet_tpu_torch.models.vcrnet"):
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"{name} imported")
want = np.load(sys.argv[2])
reg = load_exported(sys.argv[1])
out = reg.register(want["src"], want["tgt"])
for key in ("R", "t", "R_inv", "t_inv"):
    assert np.array_equal(out[key], want[key]), key
bad = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print("loaded without model code")
'''


def _env():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("VCRNET_DATA", None)
    return env


def test_the_port_runs_without_h5py_tensorboardx_or_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=str(tmp_path), env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "card env ok" in r.stdout, r.stdout + r.stderr


def test_an_exported_artifact_loads_without_model_code(tmp_path):
    """A bucket exported here on the CPU (the kernel route: the graph calls
    the vcrnet_torch ops) loads in a subprocess where the port's models,
    config, train and data packages cannot be imported, nor JAX, h5py,
    tensorboardX or flax, and reproduces the live Registrar bit for bit."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.models import VCRNet
    from vcrnet_tpu_torch.serve import Registrar

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        torch.manual_seed(0)
        cfg = Config(num_points=32, emb_dims=64, ff_dims=128, n_heads=2, iter=2)
        reg = Registrar(cfg, VCRNet(cfg, device="cpu").state_dict(), buckets=(2,),
                        device="cpu", use_kernels=True)
        path = str(tmp_path / "bucket2.pt2")
        reg.export_bucket(2, path=path)
        rng = np.random.RandomState(0)
        src = rng.rand(2, 32, 3).astype(np.float32) - 0.5
        tgt = src[:, ::-1] + np.float32(0.1)
        np.savez(tmp_path / "want.npz", src=src, tgt=tgt, **reg.register(src, tgt))
    finally:
        torch.set_num_threads(n)
    r = subprocess.run([sys.executable, "-c", LOADER, path, str(tmp_path / "want.npz")],
                       cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "loaded without model code" in r.stdout, r.stdout + r.stderr
