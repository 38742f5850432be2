"""ICP and net + ICP in the port against the JAX package: the nearest
neighbour correspondence, ``icp_register`` (R, t and the number of
iterations executed, its batch-mean stop included), ``vcrnet_icp``,
``Trainer(model="icp")``'s eval sums and ``cfg.iter == 0`` in
``Trainer.eval_step`` and ``Registrar``, on the same seeded numpy clouds and
flax parameters (bridged by ``from_jax_params``), f32 on the CPU.

Tolerances: correspondences and iteration counts equal; R and t within
1e-5 (f32 Procrustes on the same points in another summation order; the
clouds' nearest neighbours are far apart against f32 rounding, so every
selection is the same); the net + ICP paths within 1e-4 (the net's f32
pass differs by about 1e-6 between the two packages before ICP starts);
eval sums rtol 1e-4, and atol 1e-4 for the rotation sums in degrees
(after ICP a rotation is exact to f32 rounding, about 1e-5 degrees an
angle, and its error sums are that rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models.icp import (
    icp_register as j_icp_register, nearest_neighbor_corr as j_nearest_neighbor_corr,
)
from vcrnet_tpu.models.vcrnet import vcrnet_icp as j_vcrnet_icp
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train.engine import TrainState
from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import VCRNet
from vcrnet_tpu_torch.models.icp import icp_register, nearest_neighbor_corr
from vcrnet_tpu_torch.models.vcrnet import vcrnet_icp
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, batch_size=3,
              test_batch_size=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved_pairs(seed, b=3, n=64, deg=12.0, noise=0.0):
    """Clouds in [-0.5, 0.5)^3 and each moved by a rotation of up to
    ``deg`` degrees about a random axis and a translation of up to 0.05."""
    rng = np.random.RandomState(seed)
    src = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    angles = torch.from_numpy(np.radians(rng.uniform(-deg, deg, (b, 3))).astype(np.float32))
    R = geometry.euler_to_mat_zyx(angles).numpy()
    t = rng.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    tgt = np.einsum("bij,bnj->bni", R, src) + t[:, None]
    tgt = tgt + noise * rng.randn(*tgt.shape)
    return src, tgt.astype(np.float32)


def test_nearest_neighbor_corr_matches_jax():
    src, tgt = _moved_pairs(0, n=80)
    err, corr = nearest_neighbor_corr(_t(src), _t(tgt[:, :50]))
    j_err, j_corr = j_nearest_neighbor_corr(jnp.asarray(src), jnp.asarray(tgt[:, :50]))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(j_corr))
    np.testing.assert_allclose(float(err), float(j_err), rtol=1e-5)


def test_nearest_neighbor_corr_takes_the_first_of_tied_points():
    dst = np.zeros((1, 4, 3), np.float32)
    dst[0, :, 0] = [1.0, -1.0, 1.0, 3.0]  # points 0 and 2 coincide
    src = np.zeros((1, 2, 3), np.float32)
    src[0, 1, 0] = 2.0  # equidistant from points 0, 2 and 3
    _, corr = nearest_neighbor_corr(_t(src), _t(dst))
    _, j_corr = j_nearest_neighbor_corr(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(j_corr))
    np.testing.assert_array_equal(corr.numpy()[0, :, 0], [1.0, 1.0])


@pytest.mark.parametrize("case", ["converges", "max_iterations", "noisy"])
def test_icp_register_matches_jax(case):
    src, tgt = _moved_pairs(1, noise=0.01 if case == "noisy" else 0.0)
    max_it = 3 if case == "max_iterations" else 50
    got = icp_register(_t(src), _t(tgt), max_iterations=max_it, with_iters=True)
    want = j_icp_register(jnp.asarray(src), jnp.asarray(tgt), max_iterations=max_it,
                          with_iters=True)
    assert got[-1] == int(want[-1])
    assert 1 < got[-1] <= max_it
    if case == "max_iterations":
        assert got[-1] == 3
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_icp_register_stops_after_one_iteration_on_equal_clouds():
    src, _ = _moved_pairs(2)
    got = icp_register(_t(src), _t(src), with_iters=True)
    want = j_icp_register(jnp.asarray(src), jnp.asarray(src), with_iters=True)
    assert got[-1] == int(want[-1]) == 1
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(np.eye(3), (3, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


@pytest.fixture(scope="module")
def jax_vcrnet():
    """A flax VCR-Net at NARROW width and its variables (init jitted: flax's
    eager init takes seconds per layer on the CPU)."""
    jmodel = JVCRNet(cfg=JConfig(**NARROW))
    src, tgt = _moved_pairs(0)
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt))


def _port_vcrnet(cfg, variables):
    model = VCRNet(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    return model.eval()


def test_vcrnet_icp_matches_jax(jax_vcrnet):
    jmodel, variables = jax_vcrnet
    src, tgt = _moved_pairs(3)
    want = jax.jit(lambda s, t: j_vcrnet_icp(lambda v, a, b: jmodel.apply(v, a, b), variables,
                                             s, t, 50))(jnp.asarray(src), jnp.asarray(tgt))
    model = _port_vcrnet(Config(**NARROW), variables)
    with torch.no_grad():
        got = vcrnet_icp(model, _t(src), _t(tgt), 50)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _batch(seed, b=3):
    src, tgt = _moved_pairs(seed, b=b)
    rng = np.random.RandomState(seed + 50)
    euler = rng.uniform(-0.2, 0.2, (b, 3)).astype(np.float32)
    R = geometry.euler_to_mat_zyx(_t(euler)).numpy()
    t_ab = rng.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + t_ab[:, None]).astype(np.float32)
    R_ba = R.transpose(0, 2, 1)
    return {"src": src, "tgt": tgt, "R_ab": R, "t_ab": t_ab, "R_ba": R_ba,
            "t_ba": -np.einsum("bij,bj->bi", R_ba, t_ab).astype(np.float32),
            "euler_ab": euler, "euler_ba": -euler[:, ::-1].copy(),
            "valid": np.array([1.0] * (b - 1) + [0.0], np.float32)}


def _close_sums(got, want):
    assert set(got) == set(want)
    for key in want:
        atol = 1e-4 if key.startswith("r_") else 1e-6
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=atol,
                                   err_msg=key)


def test_icp_trainer_eval_sums_match_jax_and_it_cannot_train():
    batch = _batch(4)
    jtr = JTrainer(JConfig(**NARROW, model="icp"), mesh=make_mesh(1))
    want = jtr._eval_step_impl(None, {k: jnp.asarray(v) for k, v in batch.items()})
    tr = Trainer(Config(**NARROW, model="icp"), device="cpu")
    assert tr.model is None and tr.optimizer is None
    _close_sums(tr.eval_step(batch), want)
    for train in (lambda: tr.train_step(batch), lambda: tr.fit([batch], [batch], epochs=1),
                  lambda: tr.train_step_raw({"clouds": batch["src"]})):
        with pytest.raises(ValueError, match="icp can't be trained"):
            train()
    assert tr.eval_epoch([batch])["num_examples"] == 2.0
    worst = tr.worst_cases([batch], k=2)
    assert worst["rot_se"][-1] == -np.inf and len(worst["worst_rot_idx"]) == 2


def test_net_plus_icp_eval_step_and_worst_cases_match_jax(jax_vcrnet):
    batch = _batch(5)
    jtr = JTrainer(JConfig(**NARROW, iter=0), mesh=make_mesh(1))
    variables = jax_vcrnet[1]
    state = TrainState(params=variables["params"], batch_stats={}, opt_state=None,
                       step=jnp.asarray(0))
    tr = Trainer(Config(**NARROW, iter=0), device="cpu")
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _close_sums(tr.eval_step(batch), jax.jit(jtr._eval_step_impl)(state, jb))
    got = [x.numpy() for x in tr._per_sample_errors(batch)]
    want = [np.asarray(x) for x in jax.jit(jtr._per_sample_errors_impl)(state, jb)]
    for g, w in zip(got, want):  # the net's one pass, as the JAX package mines it
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6)


def test_registrar_net_plus_icp_matches_jax_registrar(jax_vcrnet):
    src, tgt = _moved_pairs(6, b=3, deg=20.0)
    jcfg = JConfig(**NARROW, iter=0)
    variables = jax_vcrnet[1]
    jreg = JRegistrar(jcfg, variables, buckets=(1, 4))
    reg = Registrar(Config(**NARROW, iter=0), from_jax_params(jax.device_get(variables["params"])),
                    buckets=(1, 4), device="cpu")
    want = jreg.register(src, tgt)
    got = reg.register(src, tgt)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, err_msg=key)
    one = reg.register(src[0], tgt[0])  # a single pair: bucket 1
    np.testing.assert_allclose(one["R"], np.asarray(jreg.register(src[0], tgt[0])["R"]),
                               atol=1e-4)
