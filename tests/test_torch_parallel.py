"""The port's data parallelism (vcrnet_tpu_torch/parallel/, the Trainer's
and the Registrar's mesh) against the JAX package's on the CPU.

The JAX side runs in this process on its 8 virtual CPU devices
(``make_mesh(2)``, ``make_mesh(4)``). The port's ranks are subprocesses
(``tests/_torch_dp_worker.py``, which imports no JAX) in a Gloo process
group that meets through a FileStore in ``tmp_path``, one torch thread
each; every rank is handed the same global batch and keeps its share.
Steps use SGD, as the JAX package's own mesh test does
(tests/test_train.py:319-340): its update is linear in the gradient, where
Adam's first step turns rounding of a near-zero gradient into a full step.

Tolerances: parameters after a step and running statistics at the JAX
test's atol 2e-5; metric sums and summaries at rtol 1e-4 against JAX (f32
sums in another order), 1e-5 against the port at world 1; gradients
against world 1 at 1e-4 of each parameter's largest gradient, floored at
1e-4 of the model's largest. DGCNN's are held to world 1 at 1e-2: the
statistics of a world-2 step differ from world 1's in the last bit, which
moves the winners of near-tied maxima of its edge convolutions (PointNet,
with BatchNorm and no maxima, holds 1e-4)."""

import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.parallel import make_mesh as j_make_mesh
from vcrnet_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple
from vcrnet_tpu.parallel.multihost import local_batch_slice as j_local_batch_slice
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch import parallel
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.parallel.mesh import pad_to_multiple
from vcrnet_tpu_torch.parallel.multihost import initialize, local_batch_slice
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dp_worker.py")
TINY = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2)
SGD = dict(use_sgd=True, lr=1e-5)  # SGD runs at lr x 100, momentum 0.9 (both packages)
RANK_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, n, partition="train", seed=7):
    np.random.seed(seed)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(JConfig(**cfg), partition, n_items=n,
                                                cloud_points=128), n)))
    batch.pop("label")
    return batch


def _batches(cfg, n_items, size, seed=7):
    np.random.seed(seed)
    loader = JLoader(JSyntheticDataset(JConfig(**cfg), "test", n_items=n_items,
                                       cloud_points=128), size)
    return [{k: v for k, v in b.items() if k != "label"} for b in loader]


class Ranks:
    """``world`` ranks of the worker over one job, started at once; their
    results are read (and the processes joined, with a timeout) on first
    use, so the JAX reference runs meanwhile."""

    def __init__(self, tmp_path, world: int, tasks: list):
        self.tmp, self.world = tmp_path, world
        job = tmp_path / "job.pt"
        torch.save(tasks, job)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(tmp_path / "store"), str(rank), str(world), str(job),
             str(tmp_path / f"out{rank}.pt")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=str(tmp_path),
        ) for rank in range(world)]
        self._results = None

    def results(self) -> list:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0].decode())
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)
            self._results = [torch.load(self.tmp / f"out{r}.pt", weights_only=False)
                             for r in range(self.world)]
            for rank, out in enumerate(self._results):
                assert out[-1] == {"rank": rank, "size": self.world, "jax_loaded": False}
        return self._results

    def task(self, i: int) -> list:
        return [out[i] for out in self.results()]


def _jax_trainer(cfg, n, batch):
    jtr = JTrainer(JConfig(**cfg), mesh=j_make_mesh(n))
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    return jtr, state


def _state_dict(state):
    return from_jax_params(jax.device_get(state.params),
                           jax.device_get(state.batch_stats) or None)


def _port(cfg, state_dict) -> Trainer:
    tr = Trainer(Config(**cfg), device="cpu")
    tr.model.load_state_dict(state_dict)
    return tr


def _sum_ranks(outs, key="sums") -> dict:
    return {k: sum(o[key][k] for o in outs) for k in outs[0][key]}


def _close_sums(got: dict, want: dict, rtol: float) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)


def _close_states(got: dict, want: dict, atol: float = 2e-5) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def _close_grads(got: dict, want: dict, rel: float) -> None:
    floor = rel * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        scale = max(float(w.abs().max()), floor / rel)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=rel * scale, rtol=0,
                                   err_msg=k)


def _world1_step(cfg, state_dict, batch):
    tr = _port(cfg, state_dict)
    loss, sums = tr.compute_grads(batch)
    grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()}
    tr.optimizer.step()
    return float(loss), {k: float(v) for k, v in sums.items()}, grads, tr.model.state_dict()


# ---------------------------------------------------------------------------
# the mesh arithmetic, and initialize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,world", [(6, 4), (8, 4), (5, 2), (1, 4), (7, 3), (3, 1)])
def test_pad_and_local_slice_equal_jax(b, world):
    rng = np.random.RandomState(b * 10 + world)
    batch = {"src": rng.rand(b, 4, 3).astype(np.float32),
             "valid": np.ones(b, np.float32), "R_ab": rng.rand(b, 3, 3).astype(np.float32)}
    want = j_pad_to_multiple({k: v.copy() for k, v in batch.items()}, world)
    got = pad_to_multiple({k: v.copy() for k, v in batch.items()}, world)
    got_t = pad_to_multiple({k: torch.from_numpy(v.copy()) for k, v in batch.items()}, world)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got_t[k].numpy(), want[k])
    for rank in range(world):
        j_rows = j_local_batch_slice(want, rank, world)
        rows = local_batch_slice(got, rank, world)
        assert set(rows) == set(j_rows)
        for k in j_rows:
            np.testing.assert_array_equal(rows[k], j_rows[k])
    if world > 1:
        with pytest.raises(ValueError, match="does not divide process_count"):
            local_batch_slice({"src": np.zeros((world + 1, 3))}, 0, world)


def test_the_package_names_the_jax_functions():
    import vcrnet_tpu.parallel as jparallel

    assert parallel.__all__ == jparallel.__all__
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.group is None
    assert parallel.batch_sharding(mesh).rows(6) == [slice(0, 3), slice(3, 6)]
    assert parallel.replicated_sharding(mesh).rows(6) == [slice(0, 6)] * 2
    shards = parallel.shard_batch({"src": np.arange(12.0).reshape(6, 2)}, mesh)
    assert [s["src"].shape for s in shards] == [(3, 2), (3, 2)]
    local = parallel.global_batch_from_local({"src": np.zeros((3, 2))}, mesh, 6, device="cpu")
    assert local["src"].dtype == torch.float32
    with pytest.raises(ValueError, match="owns 2 of 4"):
        parallel.global_batch_from_local({"src": np.zeros((3, 2))}, mesh, 4, device="cpu")


def test_initialize_is_a_no_op_without_the_environment(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert not dist.is_initialized()
    mesh = parallel.make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize() is False and not dist.is_initialized()


def test_initialize_errors_propagate(monkeypatch, tmp_path):
    """torchrun's environment without its rendezvous address, and an
    init_method of no known scheme: both raise, and no group is left
    behind."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize(backend="gloo", timeout=timedelta(seconds=5))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="No rendezvous handler"):
        initialize(backend="gloo", init_method=f"nosuch://{tmp_path}/store", rank=0,
                   world_size=1)
    assert not dist.is_initialized()


def test_a_mesh_shape_other_than_the_world_size_raises(tmp_path):
    with pytest.raises(ValueError, match="mesh_shape=2 but the world size is 1"):
        Trainer(Config(**TINY, mesh_shape=2), device="cpu")
    with pytest.raises(ValueError, match="does not train"):
        Trainer(Config(**TINY), device="cpu", mesh=parallel.make_mesh(devices=["cpu", "cpu"]))
    Trainer(Config(**TINY, mesh_shape=1), device="cpu")  # the world size is 1
    ranks = Ranks(tmp_path, 2, [dict(kind="refusals", cfg=dict(TINY, mesh_shape=4))])
    for out in ranks.task(0):
        trainer_error, mesh_error = out["errors"]
        assert "mesh_shape=4 but the world size is 2" in trainer_error
        assert "a mesh of 4 devices in a process group of world size 2" in mesh_error


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sgd_step_matches_the_jax_trainer_on_a_mesh(world, tmp_path):
    """VCR-Net on B = 6 (padded to 8 at four ranks): the step's parameters
    equal the JAX Trainer's on make_mesh(world) and the port's at world 1,
    the summed rank sums JAX's global sums, the all-reduced gradients the
    world-1 gradients."""
    cfg = dict(TINY, **SGD)
    batch = _batch(cfg, 6)
    jtr, state = _jax_trainer(cfg, world, batch)
    state_dict = _state_dict(state)
    ranks = Ranks(tmp_path, world, [dict(kind="step", cfg=cfg, state_dict=state_dict,
                                         batch=batch)])
    new_state, j_sums = jtr._train_step(state, jtr._to_device(batch))
    loss1, sums1, grads1, state1 = _world1_step(cfg, state_dict, batch)
    outs = ranks.task(0)
    for out in outs[1:]:  # one gradient on every rank
        for k, g in out["grads"].items():
            assert torch.equal(g, outs[0]["grads"][k]), k
    np.testing.assert_allclose(sum(o["loss"] for o in outs), loss1, rtol=1e-5)
    _close_sums(_sum_ranks(outs), jax.device_get(j_sums), rtol=1e-4)
    _close_sums(_sum_ranks(outs), sums1, rtol=1e-5)
    _close_grads(outs[0]["grads"], grads1, rel=1e-4)
    for out in outs:
        _close_states(out["state"], _state_dict(new_state))
        _close_states(out["state"], state1)


def test_dcp_dgcnn_step_matches_jax_with_global_batch_statistics(tmp_path):
    """DCP on DGCNN with the cycle term, B = 5 padded to 6 at two ranks:
    parameters and running statistics against the JAX Trainer on
    make_mesh(2), the cycle sum against its global one; the gradients
    against world 1 on the same padded batch (the padding row is in
    BatchNorm's statistics in both packages)."""
    cfg = dict(TINY, **SGD, model="dcp", emb_nn="dgcnn", cycle=True)
    batch = _batch(cfg, 5)
    jtr, state = _jax_trainer(cfg, 2, batch)
    state_dict = _state_dict(state)
    assert any(k.endswith("running_mean") for k in state_dict)
    ranks = Ranks(tmp_path, 2, [dict(kind="step", cfg=cfg, state_dict=state_dict, batch=batch)])
    new_state, j_sums = jtr._train_step(state, jtr._to_device(batch))
    _, sums1, grads1, state1 = _world1_step(cfg, state_dict, pad_to_multiple(batch, 2))
    outs = ranks.task(0)
    summed = _sum_ranks(outs)
    _close_sums(summed, jax.device_get(j_sums), rtol=1e-4)
    _close_sums(summed, sums1, rtol=1e-5)
    assert summed["cycle_loss"] > 0
    _close_grads(outs[0]["grads"], grads1, rel=1e-2)
    want = _state_dict(new_state)
    for out in outs:
        _close_states(out["state"], want)
        _close_states(out["state"], state1)
    moved = [k for k in want if "running" in k and not torch.equal(want[k], state_dict[k])]
    assert moved


def test_batchnorm_gradients_cross_the_ranks(tmp_path):
    """DCP on PointNet (BatchNorm, no maxima) with the cycle term, B = 5
    padded to 6: the all-reduced gradients equal world 1's on the padded
    batch at 1e-4, the running statistics too."""
    cfg = dict(TINY, **SGD, model="dcp", emb_nn="pointnet", cycle=True)
    batch = _batch(cfg, 5)
    state_dict = Trainer(Config(**cfg), device="cpu").model.state_dict()
    ranks = Ranks(tmp_path, 2, [dict(kind="step", cfg=cfg, state_dict=state_dict, batch=batch)])
    loss1, sums1, grads1, state1 = _world1_step(cfg, state_dict, pad_to_multiple(batch, 2))
    outs = ranks.task(0)
    np.testing.assert_allclose(sum(o["loss"] for o in outs), loss1, rtol=1e-5)
    _close_sums(_sum_ranks(outs), sums1, rtol=1e-5)
    _close_grads(outs[0]["grads"], grads1, rel=1e-4)
    _close_states(outs[1]["state"], state1)


def test_raw_epoch_at_world_2_is_the_world_1_epoch(tmp_path):
    """train_epoch_raw over two batches of 6 raw clouds: every rank stages
    the whole batch, draws its pairs from (seed, step) and keeps its rows."""
    cfg = dict(TINY, **SGD)
    clouds = np.random.RandomState(3).rand(2, 6, 128, 3).astype(np.float32) - 0.5
    tr = Trainer(Config(**cfg), device="cpu")
    state_dict = {k: v.clone() for k, v in tr.model.state_dict().items()}
    ranks = Ranks(tmp_path, 2, [dict(kind="raw", cfg=cfg, state_dict=state_dict,
                                     batches=list(clouds))])
    summary1 = tr.train_epoch_raw(list(clouds))
    for out in ranks.task(0):
        _close_sums(out["summary"], summary1, rtol=1e-5)
        _close_states(out["state"], tr.model.state_dict())


# ---------------------------------------------------------------------------
# eval, worst cases and fit
# ---------------------------------------------------------------------------

def test_eval_epoch_and_worst_cases_at_world_2(tmp_path):
    """7 eval pairs in batches of 3 (each padded to 4 at two ranks): the
    summary equals world 1's and the JAX Trainer's on make_mesh(2); the
    worst cases are the JAX mesh's positions (padding rows included, as
    in JAX) and world 1's pairs; padding never wins."""
    cfg = dict(TINY, iter=2, test_batch_size=3)
    batches = _batches(cfg, 7, 3)
    jtr, state = _jax_trainer(cfg, 2, batches[0])
    state_dict = _state_dict(state)
    ranks = Ranks(tmp_path, 2, [dict(kind="eval", cfg=cfg, state_dict=state_dict,
                                     batches=batches, k=3)])
    j_summary = jtr.eval_epoch(state, batches)
    j_worst = jtr.worst_cases(state, batches, k=3)
    tr = _port(cfg, state_dict)
    summary1, worst1 = tr.eval_epoch(batches), tr.worst_cases(batches, k=3)
    assert summary1["num_examples"] == 7

    def pairs(worst, key):  # positions -> the pair's place among the real rows
        real = np.flatnonzero(np.isfinite(worst["rot_se"]))
        return [int(np.searchsorted(real, i)) for i in worst[key]]

    # batches of 3 rows (the last holds 1 pair) padded to 4: rank 0's 2 rows first
    padding = np.isin(np.arange(12), [3, 7, 9, 10, 11])
    for out in ranks.task(0):
        _close_sums(out["summary"], summary1, rtol=1e-5)
        _close_sums(out["summary"], j_summary, rtol=1e-4)
        worst = out["worst"]
        for key in ("worst_rot_idx", "worst_trans_idx"):
            assert worst[key] == j_worst[key]
            assert pairs(worst, key) == pairs(worst1, key)
        np.testing.assert_array_equal(np.isinf(worst["rot_se"]), padding)
        for key in ("rot_se", "trans_se"):
            np.testing.assert_allclose(worst[key][~padding],
                                       worst1[key][np.isfinite(worst1[key])], rtol=1e-4)
            np.testing.assert_allclose(worst[key][~padding], j_worst[key][~padding], rtol=1e-4,
                                       atol=1e-6)
        assert all(worst["rot_se"][i] > -np.inf for i in worst["worst_rot_idx"])


def test_fit_at_world_2_writes_once_and_equals_world_1(tmp_path):
    """A one-epoch fit: rank 0 alone logs and writes the checkpoints and
    fit_state.json, both ranks keep the same history, which is world 1's."""
    cfg = dict(TINY, **SGD, batch_size=4, test_batch_size=4)
    train = [_batch(cfg, 4, seed=s) for s in (1, 2)]
    test = _batches(cfg, 6, 4)
    tr = Trainer(Config(**cfg), device="cpu")
    state_dict = {k: v.clone() for k, v in tr.model.state_dict().items()}
    ckpt = tmp_path / "ckpt"
    ranks = Ranks(tmp_path, 2, [dict(kind="fit", cfg=cfg, state_dict=state_dict, train=train,
                                     test=test, epochs=1, dir=str(ckpt))])
    history1 = tr.fit(train, test, epochs=1, log=lambda s: None)
    outs = ranks.task(0)
    assert outs[0]["logged"] and not outs[1]["logged"]
    assert outs[0]["files"] == outs[1]["files"] == ["fit_state.json", "model.0.pt",
                                                      "model.best.pt"]
    for out in outs:
        (got,), (want,) = out["history"], history1
        assert got["epoch"] == want["epoch"] and got["lr"] == want["lr"]
        _close_sums(got["train"], want["train"], rtol=1e-5)
        _close_sums(got["test"], want["test"], rtol=1e-5)
        _close_states(out["state"], tr.model.state_dict())


# ---------------------------------------------------------------------------
# serving over a mesh of devices
# ---------------------------------------------------------------------------

def test_mesh_registrar_matches_the_jax_mesh_registrar():
    """Two CPU devices: bucket 3 rounds up to 4 as on JAX's make_mesh(2);
    5 pairs (a full bucket, then 1 padded to 4) against JAX's mesh
    Registrar and the port's one-device Registrar; the exported bucket is
    a one-device artifact."""
    from vcrnet_tpu_torch.serve import load_exported

    cfg = dict(TINY, iter=1)
    rng = np.random.RandomState(5)
    src = rng.rand(5, 64, 3).astype(np.float32) - 0.5
    tgt = src[:, ::-1] @ np.diag([1.0, -1.0, -1.0]).astype(np.float32) + 0.1
    variables = jax.jit(JVCRNet(cfg=JConfig(**cfg)).init)(jax.random.PRNGKey(0), src[:1],
                                                         src[:1])
    jreg = JRegistrar(JConfig(**cfg), variables, buckets=(3,), mesh=j_make_mesh(2))
    state_dict = from_jax_params(jax.device_get(variables["params"]))
    mesh = parallel.make_mesh(devices=["cpu", "cpu"])
    reg = Registrar(Config(**cfg), state_dict, buckets=(1, 3), mesh=mesh)
    one = Registrar(Config(**cfg), state_dict, buckets=(4,), device="cpu")
    assert jreg._buckets == (4,) and reg._buckets == (2, 4)
    assert len(reg.replicas) == 2 and reg.replicas[0].model is not reg.replicas[1].model
    want, got, single = jreg.register(src, tgt), reg.register(src, tgt), one.register(src, tgt)
    for key in ("R", "t", "R_inv", "t_inv"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, err_msg=key)
        np.testing.assert_allclose(got[key], single[key], atol=1e-6, err_msg=key)
    assert reg.compiled_buckets == [2, 4]
    exported = load_exported(reg.export_bucket(4))
    assert exported.batch == 4 and exported.device == torch.device("cpu")
    np.testing.assert_allclose(exported.register(src[:4], tgt[:4])["R"], got["R"][:4], atol=1e-5)
    with pytest.raises(ValueError, match="one process"):
        Registrar(Config(**cfg), state_dict, mesh=parallel.make_mesh())
