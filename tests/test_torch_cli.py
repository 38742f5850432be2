"""The port's CLI (vcrnet_tpu_torch/cli.py) against the JAX package's
(vcrnet_tpu/cli.py), and its parameter utilities (utils/params_io.py).

Both parsers give equal configurations on the same argv; an ``--eval`` of
a narrow checkpoint that the JAX package writes gives the JAX CLI's
summary through the port's CLI on the CPU (``--platform cpu
--tpu_probe_timeout 0`` there, ``--device cpu`` here), within 1e-4 of each
value (f32 sums in another order); a one-epoch fit writes its run
directory; ICP refuses to train; the kernel route's gates name their
limits. Narrow widths, one torch thread."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu import cli as jcli
from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from vcrnet_tpu.train.engine import TrainState
from vcrnet_tpu.utils import params_io as j_params_io
from vcrnet_tpu_torch import cli
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.fixtures import make_fake_modelnet40_tree
from vcrnet_tpu_torch.models import VCRNet
from vcrnet_tpu_torch.utils import params_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["--num_points", "64", "--emb_dims", "64", "--ff_dims", "128", "--n_heads", "2"]


@pytest.fixture(scope="module")
def modelnet40(tmp_path_factory):
    """A ModelNet40 tree of 16 training and 12 test shapes: every run of
    both CLIs reads the same clouds, few enough for the CPU."""
    root = str(tmp_path_factory.mktemp("modelnet40"))
    make_fake_modelnet40_tree(root, items_per_train_file=(16,), items_per_test_file=(12,),
                              cloud_points=256)
    return ["--dataset", "modelnet40", "--data_dir", root]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARGV = {
    "defaults": [],
    "partial_eval": ["--partial", "--overlap", "0.575", "--iter", "3", "--eval",
                     "--test_batch_size", "24"],
    "heads_and_t_nets": ["--vcp_nn", "att", "--t3d", "--tfea", "--cycle", "--loss", "mixed"],
    "dcp": ["--model", "dcp", "--emb_nn", "dgcnn", "--head", "mlp", "--vcp_nn", "dist",
            "--pointer", "identity", "--use_sgd", "--momentum", "0.8"],
    "lpd": ["--model", "lpd", "--batch_size", "16", "--lr", "0.01", "--epochs", "3",
            "--gaussian_noise", "--unseen", "--factor", "2"],
    "knobs": ["--compute_dtype", "bfloat16", "--mesh_shape", "4", "--no-int8_train_gathers",
              "--reuse_feature_knn", "--feature_knn_refresh", "2", "--remat", "--dropout",
              "0.1", "--dataset", "kitti", "--data_dir", "/data", "--seed", "7",
              "--exp_name", "x", "--model_path", "m.pt", "--n_blocks", "2",
              "--max_iterations", "20", "--num_points", "512"],
}


@pytest.mark.parametrize("argv", list(ARGV.values()), ids=list(ARGV))
def test_both_parsers_give_equal_configs(argv):
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_the_flags_are_the_jax_clis_but_the_tpu_ones():
    """Every flag of the JAX CLI keeps its default and choices, but
    --platform and --tpu_probe_*; the port adds --device and
    --use_kernels."""
    def flags(parser):
        return {a.dest: (a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    want, got = flags(jcli.build_parser()), flags(cli.build_parser())
    tpu = {"platform", "tpu_probe_timeout", "tpu_probe_window"}
    assert set(want) - set(got) == tpu
    assert set(got) - set(want) == {"device", "use_kernels"}
    for dest in set(want) - tpu:
        assert got[dest] == want[dest], dest
    assert got["device"] == ("cuda", ()) and got["use_kernels"] == (True, ())
    args = cli.build_parser().parse_args(["--no-use_kernels"])
    assert args.use_kernels is False


def test_python_dash_m_runs_the_cli():
    r = subprocess.run([sys.executable, "-m", "vcrnet_tpu_torch.cli", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "--use_kernels" in r.stdout and "--tpu_probe_timeout" not in r.stdout


def _summary(run_log: str) -> dict:
    text = open(run_log).read()
    start = text.index("A--------->B\n") + len("A--------->B\n")
    return json.JSONDecoder().raw_decode(text[start:])[0]


def _latest(root, sub: str) -> str:
    runs = sorted((root / "checkpoints" / sub).iterdir())
    return str(runs[-1])


def test_eval_of_a_jax_checkpoint_gives_the_jax_clis_summary(modelnet40, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the identity pointer keeps the JAX CLI's eager init short
    common = NARROW + modelnet40 + ["--eval", "--test_batch_size", "8", "--pointer", "identity"]
    jcfg = JConfig(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, pointer="identity")
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    cloud = jnp.zeros((1, 64, 3), jnp.float32)
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(5), cloud, cloud)
    state = TrainState(params=variables["params"], batch_stats={},
                       opt_state=jtr.tx.init(variables["params"]), step=jnp.asarray(0, jnp.int32))
    path = j_save_checkpoint(str(tmp_path / "ckpt"), "narrow", state)

    jcli.main(common + ["--model_path", path, "--platform", "cpu", "--tpu_probe_timeout", "0"])
    want = _summary(os.path.join(_latest(tmp_path, "test"), "run.log"))
    got = cli.main(common + ["--model_path", path, "--device", "cpu"])
    run_dir = _latest(tmp_path, "test")
    log = open(os.path.join(run_dir, "run.log")).read()
    assert "loaded checkpoint" in log and log.rstrip().endswith("FINISH")
    assert _summary(os.path.join(run_dir, "run.log")) == json.loads(json.dumps(got))
    assert set(got) == set(want) and want["num_examples"] == 12
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    assert got["rot_ab_RMSE"] > 1.0  # an untrained net: the comparison is not of zeros


def test_a_one_epoch_fit_writes_its_run_directory(modelnet40, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    history = cli.main(NARROW + modelnet40 + ["--epochs", "1", "--batch_size", "8",
                                              "--test_batch_size", "12", "--device", "cpu"])
    run_dir = _latest(tmp_path, "train")
    assert len(history) == 1 and np.isfinite(history[0]["test"]["loss_pose"])
    assert json.load(open(os.path.join(run_dir, "history.json")))[0]["epoch"] == 0
    saved = set(os.listdir(os.path.join(run_dir, "models")))
    assert {"model.0.pt", "model.best.pt", "fit_state.json"} <= saved
    log = open(os.path.join(run_dir, "run.log")).read()
    assert "Model vcrnet: params:" in log and "epoch 0:" in log and "FINISH" in log
    assert history[0]["train"]["num_examples"] == 16 and history[0]["test"]["num_examples"] == 12


def test_runs_in_one_second_get_a_run_directory_each(tmp_path, monkeypatch):
    """The stamp has one-second resolution: a run that starts in the second
    of another (the JAX CLI's, or this CLI's) takes a new directory rather
    than appending to the other's run.log."""
    import datetime as dt

    class Frozen(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 10, 31, 23, 59, 59)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jcli, "datetime", Frozen)
    monkeypatch.setattr(cli, "datetime", Frozen)
    cfg = Config(eval=True)
    first = jcli.make_run_dir(JConfig(eval=True))
    dirs = [cli.make_run_dir(cfg) for _ in range(2)]
    assert dirs == [first + "-2", first + "-3"]
    assert all(os.path.isdir(os.path.join(d, "models")) for d in dirs)
    assert _latest(tmp_path, "test").endswith("-3")


def test_icp_cannot_be_trained(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--model", "icp", "--dataset", "synthetic", "--num_points", "64",
                     "--device", "cpu"]) is None
    assert "icp can't be trained" in capsys.readouterr().out
    log = open(os.path.join(_latest(tmp_path, "train"), "run.log")).read()
    assert log.rstrip().endswith("icp can't be trained")


def test_the_default_device_is_the_card_and_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--eval"])
    assert not (tmp_path / "checkpoints").exists()


def test_the_kernel_route_takes_the_full_width_configurations():
    for kw in (dict(), dict(eval=True, iter=3), dict(partial=True, overlap=0.575),
               dict(vcp_nn="att", t3d=True, tfea=True), dict(model="dcp", emb_nn="dgcnn"),
               dict(model="lpd"), dict(model="icp", emb_dims=64), dict(num_points=1000)):
        assert cli.kernel_route_refusals(Config(compute_dtype="bfloat16", **kw)) == [], kw


@pytest.mark.parametrize("kw, gate, limit", [
    (dict(emb_dims=64), "flash_packed_supported", "dk = 128 only (got emb_dims / n_heads = 64 / 4)"),
    (dict(n_heads=8), "flash_packed_supported", "(got emb_dims / n_heads = 512 / 8)"),
    (dict(emb_dims=1024, n_heads=8), "streaming_supported", "emb_dims <= 512 (got 1024)"),
    (dict(emb_dims=64, model="dcp", emb_nn="dgcnn", pointer="identity", eval=True),
     "fused_dgcnn_supported", "emb_dims % 128 == 0 and k = 20 < N (got emb_dims = 64, N = 1024)"),
    (dict(num_points=8000), "gather_max_bwd_supported", "N <= 7264 in training (got N = 8000)"),
    (dict(model="lpd", num_points=16, eval=True), "edge_conv_supported", "k = 20 < N (got N = 16)"),
])
def test_the_width_gates_name_their_limits(kw, gate, limit, tmp_path, monkeypatch):
    """A refused width names the gate and its limit; on the kernel route
    the CLI exits with it before it builds the trainer or a run
    directory."""
    cfg = Config(compute_dtype="bfloat16", **kw)
    refused = cli.kernel_route_refusals(cfg)
    assert len(refused) == 1 and gate in refused[0] and limit in refused[0], refused
    assert cli.kernel_route_refusals(cfg.replace(model="icp")) == []

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "resolve_device", lambda device: torch.device(device))
    argv = [f"--{k}" if v is True else f"--{k}={v}" for k, v in kw.items()]
    with pytest.raises(SystemExit, match=gate) as refusal:
        cli.main(argv + ["--compute_dtype", "bfloat16"])
    assert limit in str(refusal.value) and "--no-use_kernels" in str(refusal.value)
    assert not (tmp_path / "checkpoints").exists()


def test_params_io_counts_and_tables_as_jax(tmp_path):
    jcfg = JConfig(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, vcp_nn="att")
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    cloud = jnp.zeros((1, 64, 3), jnp.float32)
    params = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), cloud, cloud)["params"]
    model = VCRNet(Config(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, vcp_nn="att"),
                   device="cpu")
    assert params_io.count_params(model) == j_params_io.count_params(params)
    assert params_io.count_params(model.state_dict()) == params_io.count_params(model)

    path = params_io.save_params_table(model, str(tmp_path / "params.xlsx"))
    assert path.endswith("params.csv")
    rows = open(path).read().splitlines()
    assert rows[0] == "name,shape,params,mean,std,min,max"
    assert len(rows) == 1 + len(list(model.parameters()))
    assert rows[1].startswith("emb_nn.conv1_lpd.weight,\"(64, 3)\",192,")
    values = params_io.save_params_table({"w": torch.arange(4.0).reshape(2, 2)},
                                         str(tmp_path / "v.csv"), values=True)
    assert open(values).read().splitlines()[1] == 'w,"(2, 2)",4,[0. 1. 2. 3.]'
    assert params_io.device_memory_mb("cpu") is None
