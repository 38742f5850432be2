"""The port's training path against the JAX package: one Trainer step
(loss, every metric sum, every gradient) on the same flax parameters
(bridged by from_jax_params) and the same numpy batch, f32 at narrow
width; eval sums; the optimizer and schedulers; the data pipeline; a few
fit epochs.

The JAX side runs its XLA path on the CPU (its Pallas route needs a TPU),
so its max-reductions split ties evenly where the port's kernel route
(use_kernels=True, autograd Functions with plain backwards here) routes
to the first winner: the random f32 inputs here have no ties that carry
a gradient. Gradients are compared, not updated parameters (Adam's first
step turns the sign of a near-zero gradient into a full step).
Tolerances: loss and sums rtol 1e-4; gradients 1e-3 of each parameter's
largest gradient, floored at 1e-3 of the largest gradient of the model
(f32 sums in another order through an SVD and up to two softmaxes)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.data.augment import make_pair_from_cloud as j_make_pair
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train import optim as joptim
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import make_pair_from_cloud
from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset, collate
from vcrnet_tpu_torch.train import Trainer, optim
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=256, ff_dims=128, n_heads=2, batch_size=4,
              test_batch_size=4)


def _batch(cfg, partition="train", n_items=4, seed=7):
    np.random.seed(seed)  # train items draw from the global generator
    loader = JLoader(JSyntheticDataset(cfg, partition, n_items=n_items, cloud_points=128,
                                       kind="shapes"), n_items)
    batch = next(iter(loader))
    batch.pop("label")
    return batch


def _jax_and_port(use_kernels, **kw):
    jcfg = JConfig(**NARROW, **kw)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    batch = _batch(jcfg)
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    tr = Trainer(Config(**NARROW, **kw), device="cpu", use_kernels=use_kernels)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    return jtr, state, tr, batch


def _close_sums(got, want, keys):
    for key in keys:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("loss", ["point", "pose"])
def test_train_step_loss_sums_and_grads_match_jax(loss, use_kernels):
    jtr, state, tr, batch = _jax_and_port(use_kernels, loss=loss)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jtr._apply({"params": params}, jb["src"], jb["tgt"], train=True)
        return jtr._vcrnet_loss_and_sums(out, jb, jb["valid"])

    (j_loss, j_sums), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    got_loss, sums = tr.compute_grads(batch)
    np.testing.assert_allclose(float(got_loss), float(j_loss), rtol=1e-4)
    assert set(sums) == set(j_sums)
    _close_sums(sums, j_sums, j_sums)

    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    # a gradient that is zero in exact arithmetic (the key bias under
    # softmax) is rounding noise on both sides: floor the scale
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("n_iter", [1, 2])
def test_eval_step_sums_match_jax(n_iter):
    jtr, state, tr, _ = _jax_and_port(False, iter=n_iter)
    batch = _batch(jtr.cfg, "test", n_items=3)
    batch["valid"][-1] = 0.0  # a padding row never counts
    want = jtr._eval_step_impl(state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tr.eval_step(batch)
    _close_sums(got, want, want)


def test_train_step_updates_parameters_with_adam():
    _, _, tr, batch = _jax_and_port(True)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    sums = tr.train_step(batch)
    assert np.isfinite(float(sums["loss"]))
    assert tr.step == 1
    moved = [k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)


@pytest.mark.parametrize("use_sgd", [False, True])
def test_optimizer_matches_optax_chain(use_sgd):
    rng = np.random.RandomState(0)
    w0 = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    g0 = {k: rng.randn(*v.shape).astype(np.float32) for k, v in w0.items()}
    kw = dict(lr=1e-3, use_sgd=use_sgd)
    tx = joptim.make_optimizer(JConfig(**kw))
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    opt_state = tx.init(params)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = optim.make_optimizer(Config(**kw), list(ps.values()))
    for _ in range(3):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g0.items()}, opt_state,
                                       params)
        params = jax.tree_util.tree_map(lambda a, b: a + b, params, updates)
        for k, p in ps.items():
            p.grad = torch.from_numpy(g0[k].copy())
        opt.step()
    for k, p in ps.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-6)


def test_schedulers_match_jax():
    rng = np.random.RandomState(1)
    ours = optim.ReduceLROnPlateau(0.1, patience=3)
    theirs = joptim.ReduceLROnPlateau(0.1, patience=3)
    metric = 1.0
    for step in range(40):
        metric = max(metric * (1 - 0.1 * rng.rand()), 0.3) if step < 15 else metric
        assert ours.step(metric) == theirs.step(metric)
    ours, theirs = optim.MultiStepLR(0.05, (3, 6, 9)), joptim.MultiStepLR(0.05, (3, 6, 9))
    assert [ours.step() for _ in range(12)] == [theirs.step() for _ in range(12)]
    assert optim.EARLY_STOP_LR == joptim.EARLY_STOP_LR
    assert optim.initial_lr(Config(use_sgd=True)) == joptim.initial_lr(JConfig(use_sgd=True))


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("partition", ["train", "test"])
def test_make_pair_from_cloud_is_bit_equal_to_jax(partition, noise):
    cloud = np.random.RandomState(3).rand(300, 3).astype(np.float32)
    kw = dict(num_points=128, gaussian_noise=noise)
    np.random.seed(11)
    want = j_make_pair(cloud, 5, JConfig(**kw), partition).astuple()
    np.random.seed(11)
    got = make_pair_from_cloud(cloud, 5, Config(**kw), partition).astuple()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_synthetic_loader_matches_jax_batches():
    cfg = JConfig(num_points=64)
    want = list(JLoader(JSyntheticDataset(cfg, "test", n_items=5, cloud_points=96,
                                          kind="uniform"), 2))
    got = list(Loader(SyntheticDataset(Config(num_points=64), "test", n_items=5,
                                       cloud_points=96, kind="uniform"), 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key, val in g.items():
            np.testing.assert_array_equal(val, w[key], err_msg=key)


def test_partial_dropout_and_remat_are_refused():
    """None of the three is refused any more: training in partial-overlap
    mode takes the JAX package's step on zero gradients
    (tests/test_torch_partial_train.py), dropout and remat are ported
    (tests/test_torch_regularise.py)."""
    cfg = Config(**NARROW, partial=True, overlap=0.575)
    pair = make_pair_from_cloud(np.random.RandomState(0).rand(80, 3).astype(np.float32), 0, cfg)
    tr = Trainer(cfg, device="cpu")
    sums = tr.train_step(collate([pair]))
    assert tr.step == 1 and np.isfinite(float(sums["loss"]))
    assert tr.grads_filled == [n for n, _ in tr.model.named_parameters()]
    for kw in (dict(dropout=0.1), dict(remat=True)):
        tr = Trainer(Config(**NARROW, **kw), device="cpu")
        assert (tr.cfg.dropout, tr.cfg.remat) == (kw.get("dropout", 0.0), kw.get("remat", False))


@pytest.mark.parametrize("model", ["vcrnet", "dcp"])
def test_int8_eval_is_refused_where_jax_would_quantize(model):
    """The JAX package quantizes the pointer projections when int8_eval
    meets bf16 (models/vcrnet.py:_use_int8); the port has no int8 path yet,
    so it refuses that pair, and takes the flag with f32, where it is a
    no-op in both packages."""
    with pytest.raises(NotImplementedError, match="int8_eval"):
        Trainer(Config(**NARROW, model=model, int8_eval=True, compute_dtype="bfloat16"),
                device="cpu")
    tr = Trainer(Config(**NARROW, model=model, int8_eval=True), device="cpu")
    assert tr.model.cfg.int8_eval


def test_fit_lowers_the_train_loss():
    cfg = Config(**NARROW, epochs=4)
    tr = Trainer(cfg, device="cpu", use_kernels=True, seed=0)
    np.random.seed(0)
    train = Loader(SyntheticDataset(cfg, "train", n_items=8, cloud_points=128, kind="shapes"),
                   4, shuffle=True, drop_last=True)
    test = Loader(SyntheticDataset(cfg, "test", n_items=4, cloud_points=128, kind="shapes"), 4)
    history = tr.fit(train, test, log=lambda _: None)
    assert len(history) == 4
    losses = [h["train"]["loss"] for h in history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.isfinite(history[-1]["test"]["rot_ab_RMSE"])


def test_euler_conversions_match_jax():
    from vcrnet_tpu import geometry as jgeo
    from vcrnet_tpu_torch import geometry

    ang = np.random.RandomState(4).uniform(-1.2, 1.2, (6, 3)).astype(np.float32)
    R = geometry.euler_to_mat_zyx(torch.from_numpy(ang))
    np.testing.assert_allclose(R.numpy(), np.asarray(jgeo.euler_to_mat_zyx(jnp.asarray(ang))),
                               atol=1e-6)
    for ours, theirs in ((geometry.mat_to_euler_zyx, jgeo.mat_to_euler_zyx),
                         (geometry.mat_to_euler_xyz, jgeo.mat_to_euler_xyz)):
        np.testing.assert_allclose(ours(R, degrees=True).numpy(),
                                   np.asarray(theirs(jnp.asarray(R.numpy()), degrees=True)),
                                   atol=1e-4)
    np.testing.assert_allclose(geometry.mat_to_euler_zyx(R).numpy(), ang, atol=1e-5)


def test_procrustes_gradient_matches_jax_svd():
    from vcrnet_tpu import geometry as jgeo
    from vcrnet_tpu_torch import geometry

    rng = np.random.RandomState(5)
    src = rng.rand(3, 32, 3).astype(np.float32) - 0.5
    corr = src @ np.asarray(jgeo.euler_to_mat_zyx(jnp.asarray(rng.rand(3, 3) * 0.5)))[0].T
    corr = (corr + 0.05 * rng.randn(*corr.shape)).astype(np.float32)
    gR, gt = rng.randn(3, 3, 3).astype(np.float32), rng.randn(3, 3).astype(np.float32)

    def j_obj(c):
        R, t = jgeo.procrustes(jnp.asarray(src), c)
        return jnp.sum(R * gR) + jnp.sum(t * gt)

    want = np.asarray(jax.grad(j_obj)(jnp.asarray(corr)))
    c = torch.from_numpy(corr).requires_grad_()
    R, t = geometry.procrustes(torch.from_numpy(src), c)
    obj = (R * torch.from_numpy(gR)).sum() + (t * torch.from_numpy(gt)).sum()
    (got,) = torch.autograd.grad(obj, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())



def test_init_follows_jax_distributions():
    """Same distributions, not the same bits: each weight's spread and
    support match the flax init's (kaiming-uniform in the embedding,
    truncated lecun-normal in the pointer); biases and LayerNorm shifts 0,
    LayerNorm scales 1."""
    _, state, _, _ = _jax_and_port(False)
    want = from_jax_params(jax.device_get(state.params))
    fresh = Trainer(Config(**NARROW), device="cpu", seed=3).model
    for name, p in fresh.named_parameters():
        got, ref = p.detach(), want[name]
        if name.endswith(("bias", "b_2")):
            assert torch.equal(got, torch.zeros_like(got)), name
        elif name.endswith("a_2"):
            assert torch.equal(got, torch.ones_like(got)), name
        else:
            assert 0.85 < float(got.std() / ref.std()) < 1.15, name
            assert float(got.abs().max()) <= 1.25 * float(ref.abs().max()), name
