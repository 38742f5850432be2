"""LPD pretraining in the port against the JAX package: farthest point
sampling and the k-farthest selection (bit for bit, with ties), the LPD
loss in both forms, the LPD model at the leaky slope 0.2 on both routes,
the training step's sums and gradients, the slope-0.2 init, the
scheduler of an LPD fit, and an LPD checkpoint: its round trip, and its
embedding merged into a VCR-Net trainer. Same seeded numpy inputs and the
same flax parameters (bridged by ``from_jax_params``), f32 on the CPU.

Tolerances: selections equal; losses rtol 1e-5, embeddings rtol and atol
1e-5 (f32 sums in another order); sums rtol 1e-4; gradients 1e-3 of each parameter's
largest gradient, floored at 1e-3 of the model's largest (the training
step tests' rule). The random f32 clouds here have no distance ties, so
FPS and kFN pick the same anchors in both packages."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import LPD as JLPD
from vcrnet_tpu.models.lpd import lpd_loss as j_lpd_loss
from vcrnet_tpu.ops import farthest_point_sample as j_fps, kfn as j_kfn
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train import optim as joptim
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.lpd import LPD, lpd_loss
from vcrnet_tpu_torch.ops.fps import farthest_point_sample
from vcrnet_tpu_torch.ops.graph import kfn
from vcrnet_tpu_torch.train import Trainer, checkpoint as ckpt
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=64, batch_size=3, test_batch_size=3, model="lpd")
quiet = lambda s: None  # noqa: E731


def _t(a):
    return torch.from_numpy(np.array(a))


def _grid(seed, b=2):
    """b shuffled copies of the 4 x 4 x 4 integer grid: every distance is
    an exact integer, so FPS and kFN meet ties at every step."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"), -1).reshape(64, 3)
    rng = np.random.RandomState(seed)
    return np.stack([g[rng.permutation(64)] for _ in range(b)]).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
def test_fps_and_kfn_are_bit_equal_to_jax(ties):
    xyz = _grid(0) if ties else np.random.RandomState(1).rand(2, 96, 3).astype(np.float32)
    got = farthest_point_sample(_t(xyz), 32)
    want = np.asarray(j_fps(jnp.asarray(xyz), 32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got[0].tolist())) == 32
    anchors = np.take_along_axis(xyz, want[:, :, None], axis=1)
    np.testing.assert_array_equal(kfn(_t(anchors), 8).numpy(),
                                  np.asarray(j_kfn(jnp.asarray(anchors), 8)))


def _embeddings(seed, b=3, n=64, e=16):
    rng = np.random.RandomState(seed)
    src = rng.rand(b, n, 3).astype(np.float32)
    return src, (0.3 * rng.randn(b, n, e)).astype(np.float32), \
        (0.3 * rng.randn(b, n, e)).astype(np.float32)


@pytest.mark.parametrize("per_sample", [False, True])
def test_lpd_loss_matches_jax(per_sample):
    src, se, te = _embeddings(2)
    got = lpd_loss(_t(src), _t(se), _t(te), per_sample=per_sample)
    want = j_lpd_loss(jnp.asarray(src), jnp.asarray(se), jnp.asarray(te), per_sample=per_sample)
    assert got.shape == want.shape == ((3,) if per_sample else ())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _batch(cfg, partition="train", n_items=3, seed=7):
    np.random.seed(seed)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(cfg, partition, n_items=n_items,
                                                cloud_points=128, kind="shapes"), n_items)))
    batch.pop("label")
    return batch


@pytest.fixture(scope="module")
def jax_lpd():
    """The flax LPD model at NARROW width, its variables (init jitted) and
    a training batch."""
    jcfg = JConfig(**NARROW)
    batch = _batch(jcfg)
    jmodel = JLPD(cfg=jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batch["src"]),
                                     jnp.asarray(batch["tgt"]))
    return jmodel, variables, batch


@pytest.fixture(scope="module")
def jax_lpd_step(jax_lpd):
    """The JAX trainer's LPD loss, sums and gradients on the fixture's
    batch with its last row padding, and its eval sums."""
    _, variables, batch = jax_lpd
    batch = dict(batch, valid=np.array([1.0, 1.0, 0.0], np.float32))
    jtr = JTrainer(JConfig(**NARROW), mesh=make_mesh(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        loss, sums, _ = jtr._lpd_loss_and_sums({"params": params}, jb, jb["valid"], train=True)
        return loss, sums

    (loss, sums), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return batch, loss, sums, grads, jtr._eval_step_impl(_State(variables), jb)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lpd_model_at_slope_02_matches_jax(jax_lpd, use_kernels):
    jmodel, variables, batch = jax_lpd
    model = LPD(Config(**NARROW), device="cpu", use_kernels=use_kernels)
    assert model.emb_nn.slope == 0.2
    model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    with torch.no_grad():
        got = model(_t(batch["src"]), _t(batch["tgt"]))
    want = jax.jit(jmodel.apply)(variables, batch["src"], batch["tgt"])
    for name, g, w in zip(("src_emb", "tgt_emb", "loss", "mse", "mae"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_lpd_train_step_sums_and_grads_match_jax(jax_lpd, jax_lpd_step, use_kernels):
    variables = jax_lpd[1]
    batch, j_loss, j_sums, j_grads, j_eval = jax_lpd_step
    tr = Trainer(Config(**NARROW), device="cpu", use_kernels=use_kernels)
    tr.model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    loss, sums = tr.compute_grads(batch)
    assert tr.grads_filled == []
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert set(sums) == set(j_sums) == {"loss", "mse", "mae", "count"}
    for key in j_sums:
        np.testing.assert_allclose(float(sums[key]), float(j_sums[key]), rtol=1e-4, err_msg=key)
    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)
    got_eval = tr.eval_step(batch)
    for key in j_eval:
        np.testing.assert_allclose(float(got_eval[key]), float(j_eval[key]), rtol=1e-4,
                                   err_msg=key)


class _State:
    """The part of the JAX TrainState that its eval step reads."""

    def __init__(self, variables):
        self._variables = variables

    def variables(self):
        return self._variables


def test_lpd_init_draws_kaiming_at_slope_02(jax_lpd):
    want = from_jax_params(jax.device_get(jax_lpd[1]["params"]))
    got = Trainer(Config(**NARROW), device="cpu", seed=3).model.state_dict()
    gain = (2.0 / (1.0 + 0.2 ** 2)) ** 0.5
    for name, val in got.items():
        if name.endswith("bias"):
            assert torch.equal(val, torch.zeros_like(val)), name
            continue
        bound = gain * (3.0 / val.shape[1]) ** 0.5
        top = float(val.abs().max())
        assert top <= bound, name  # a slope-0 draw reaches 1.0198 x this bound
        if val.numel() >= 4096:
            assert top > 0.995 * bound, name
        if name in want and want[name].numel() >= 256:
            assert 0.9 < float(val.std() / want[name].std()) < 1.1, name


def test_lpd_fit_steps_multistep_and_keeps_the_best_loss(tmp_path):
    """An LPD fit resumed at epoch 74 steps MultiStepLR past its first
    milestone (75): the rate falls tenfold in one epoch, where the plateau
    scheduler would wait its patience out, and the JAX scheduler gives the
    same sequence; the summaries carry mse and mae; model.best is kept on
    the test loss."""
    sched = joptim.MultiStepLR(1e-3)
    for _ in range(74):
        sched.step()
    ckpt.save_fit_state(str(tmp_path), {"epoch": 73, "best_loss": 10.0, "lr": sched.lr,
                                        "sched": dict(sched.__dict__)})
    jcfg = JConfig(**NARROW)
    train, test = _batch(jcfg, seed=3), _batch(jcfg, "test", seed=4)
    tr = Trainer(Config(**NARROW), device="cpu", seed=0)
    hist = tr.fit([train], [test], epochs=76, log=quiet, checkpoint_dir=str(tmp_path))
    assert [h["epoch"] for h in hist] == [74, 75]
    assert [h["lr"] for h in hist] == [sched.step(), sched.step()] == [1e-3 * 0.1] * 2
    assert tr.optimizer.param_groups[0]["lr"] == hist[-1]["lr"]
    for h in hist:
        assert {"loss", "mse", "mae", "num_examples"} <= set(h["test"]), h["test"]
    assert os.path.exists(tmp_path / "model.best.pt") and os.path.exists(tmp_path / "model.75.pt")


def test_lpd_checkpoint_round_trip_and_merge_into_vcrnet(tmp_path):
    jcfg = JConfig(**NARROW)
    batch = _batch(jcfg)
    tr = Trainer(Config(**NARROW), device="cpu", seed=0)
    tr.train_step(batch)
    path = ckpt.save_checkpoint(str(tmp_path), "lpd", tr)
    fresh = ckpt.load_checkpoint(path, Trainer(Config(**NARROW), device="cpu", seed=5))
    assert fresh.step == 1
    for name, val in tr.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], val), name
    st, st2 = tr.optimizer.state_dict()["state"], fresh.optimizer.state_dict()["state"]
    assert all(torch.equal(st[i][k], st2[i][k]) for i in st for k in ("exp_avg", "exp_avg_sq"))

    emb = tr.model.emb_nn.state_dict()
    vcr = Trainer(Config(**dict(NARROW, model="vcrnet", ff_dims=128, n_heads=2)), device="cpu",
                  seed=1)
    before = {k: v.clone() for k, v in vcr.model.state_dict().items()}
    vcr.model.load_state_dict(ckpt.merge_pretrained_embedding(vcr.model.state_dict(), emb))
    after = vcr.model.state_dict()
    for name, val in after.items():
        if name.startswith("emb_nn."):
            assert torch.equal(val, emb[name[len("emb_nn."):]]), name
        else:
            assert torch.equal(val, before[name]), name
    assert vcr.model.emb_nn.slope == 0.0  # the weights move; VCR-Net keeps its own slope
    assert np.isfinite(float(vcr.train_step(batch)["loss"]))
    # the JAX recipe's warm start (--model_path): the LPD checkpoint merged by name
    warm = ckpt.load_checkpoint(path, Trainer(Config(**dict(NARROW, model="vcrnet", ff_dims=128,
                                                            n_heads=2)), device="cpu", seed=1))
    for name, val in warm.model.state_dict().items():
        if name.startswith("emb_nn."):
            assert torch.equal(val, emb[name[len("emb_nn."):]]), name
