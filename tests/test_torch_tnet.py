"""LPDNet's T-Nets in the port (models/embeddings.py: ``TransformNet``,
``LPDNet(t3d=, tfea=)``) against the JAX package on the CPU, alone and in
VCR-Net (both clouds stacked, one update of the running statistics a step,
as the JAX package does), DCP and LPD (two calls, two updates): outputs in
eval and training, running statistics after one and two calls, the
training step's loss, sums, gradients and statistics, a partial step and a
remat step; the init distributions, a strict load of every converted
leaf, the refusal to merge a T-Net embedding, and the refinement loop's
spatial cache, exact with a 3 x 3 transform.

Same seeded numpy inputs and flax variables (bridged by
``from_jax_params``), f32. Tolerances: outputs 1e-4 absolute (f32 sums in
another order; the T-Net's BatchNorms divide by batch deviations); running
statistics 1e-5; loss and sums rtol 1e-4; gradients 1e-3 of each
parameter's largest, floored at 1e-3 of the model's largest (the training
step tests' rule; the port's BatchNorm takes the variance in two passes,
without which its f32 gradient missed by 1.2%). Narrow widths, one torch
thread."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import embeddings as jemb
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train.engine import TrainState
from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.models._common import FlaxBatchNorm
from vcrnet_tpu_torch.models.embeddings import LPDNet, TransformNet
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.train.checkpoint import merge_pretrained_embedding
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, batch_size=3,
              test_batch_size=3)
TNETS = dict(t3d=True, tfea=True)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, variables):
    module.load_state_dict(from_jax_params(jax.device_get(variables["params"]),
                                           jax.device_get(variables.get("batch_stats"))))
    return module


def _assert_stats_match(module, batch_stats, atol=1e-5):
    want = from_jax_params({}, jax.device_get(batch_stats))
    got = {k: v for k, v in module.state_dict().items() if "running_" in k}
    assert set(got) == set(want) and want
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), atol=atol, err_msg=key)


def _close(got, want, atol=1e-4):
    assert np.abs(np.asarray(want)).max() > 1e-3  # nothing compared is dead
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _check_train_and_eval(jmodel, variables, module, x, out=lambda o: o):
    """Eval output, two training calls (outputs and the running statistics
    after each), then eval on the updated statistics; flax jitted."""
    ev = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    tr = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    module.eval()
    with torch.no_grad():
        _close(out(module(_t(x))), ev(variables, jnp.asarray(x)))
    module.train()
    for _ in range(2):
        want, mut = tr(variables, jnp.asarray(x))
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        _close(out(module(_t(x))), want)
        _assert_stats_match(module, variables["batch_stats"])
    module.eval()
    with torch.no_grad():
        _close(out(module(_t(x))), ev(variables, jnp.asarray(x)))


def _init(jmodel, x):
    return jax.jit(lambda k, x: jmodel.init(k, x, train=False))(jax.random.PRNGKey(0),
                                                                 jnp.asarray(x))


def test_transform_net_matches_jax():
    """The 64 x 64 T-Net on relu'd features (its input in LPDNet), with fc
    layers away from their 1e-3 init so the transform is not the identity."""
    x = np.maximum(np.random.RandomState(0).randn(4, 48, 64), 0).astype(np.float32)
    jmodel = jemb.TransformNet(k=64)
    variables = _init(jmodel, x)
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.05 * rng.randn(*a.shape).astype(np.float32)
        if "fc" in jax.tree_util.keystr(p) else a, variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    module = _load(TransformNet(64), variables)
    assert len([m for m in module.modules() if isinstance(m, FlaxBatchNorm)]) == 5
    _check_train_and_eval(jmodel, variables, module, x)


def test_lpdnet_with_both_t_nets_matches_jax():
    x = (np.random.RandomState(2).rand(4, 64, 3) - 0.5).astype(np.float32)
    jmodel = jemb.LPDNet(emb_dims=64, **TNETS)
    variables = _init(jmodel, x)
    module = _load(LPDNet(64, **TNETS), variables)
    assert module.t3d and module.tfea and not LPDNet(64).t3d
    _check_train_and_eval(jmodel, variables, module, x, out=lambda o: o[0] if isinstance(
        o, tuple) else o)


def test_the_sn_block_selects_on_the_xyz_from_before_the_3x3_transform():
    """The spatial selection is the input cloud's, so it survives any rigid
    motion of the input: vcrnet_iter's cache is exact with t3d."""
    torch.manual_seed(0)
    module = LPDNet(64, t3d=True).eval()
    with torch.no_grad():
        module.t_net3d.fc3.bias.copy_(torch.randn(9))  # far from the identity
        x = torch.rand(2, 64, 3) - 0.5
        R = geometry.quat2mat(torch.nn.functional.normalize(torch.randn(2, 4), dim=-1))
        moved = geometry.transform_points(x, R, torch.randn(2, 3))
        _, sp_x, _ = module(x)
        _, sp_moved, _ = module(moved)
    from vcrnet_tpu_torch.ops.graph import knn

    assert torch.equal(sp_x, knn(x, 20, method="exact"))
    assert torch.equal(sp_moved, sp_x)
    model = VCRNet(Config(**NARROW, t3d=True), device="cpu").eval()
    src, tgt = torch.rand(2, 64, 3) - 0.5, torch.rand(2, 64, 3) - 0.5
    with torch.no_grad():
        cached = vcrnet_iter(model, src, tgt, 3)
        moved, R, t = src, None, None
        for _ in range(3):  # every pass from scratch
            out = model(moved, tgt)
            moved = geometry.transform_points(moved, out[2], out[3])
            R, t = (out[2], out[3]) if R is None else geometry.compose_transforms(
                out[2], out[3], R, t)
    np.testing.assert_allclose(cached[2].numpy(), R.numpy(), atol=1e-5)
    np.testing.assert_allclose(cached[3].numpy(), t.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the training step of each family with both T-Nets
# ---------------------------------------------------------------------------

FAMILIES = {
    # VCR-Net stacks both clouds: one update a step; with the att head
    "vcrnet_att": dict(vcp_nn="att"),
    "dcp": dict(model="dcp"),
    "lpd": dict(model="lpd"),
}


def _batch(cfg, seed=7, n_items=3):
    np.random.seed(seed)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(cfg, "train", n_items=n_items, cloud_points=128,
                                                kind="uniform"), n_items)))
    batch.pop("label")
    return batch


def _jax_state(jtr, batch):
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), jnp.asarray(batch["src"][:1]),
                                        jnp.asarray(batch["tgt"][:1]))
    params = variables["params"]
    return TrainState(params=params, batch_stats=variables["batch_stats"],
                      opt_state=jtr.tx.init(params), step=jnp.asarray(0, jnp.int32))


def _jax_step(kw):
    """The JAX trainer's loss, sums, gradients (jitted) and updated running
    statistics on one batch, beside its state."""
    jtr = JTrainer(JConfig(**NARROW, **TNETS, **kw), mesh=make_mesh(1))
    batch = _batch(jtr.cfg)
    state = _jax_state(jtr, batch)

    def loss_fn(params, stats, jb):
        variables = {"params": params, "batch_stats": stats}
        if jtr.cfg.model == "lpd":
            loss, sums, mut = jtr._lpd_loss_and_sums(variables, jb, jb["valid"], train=True)
            return loss, (sums, mut)
        out, mut = jtr._apply(variables, jb["src"], jb["tgt"], train=True)
        fn = jtr._dcp_loss_and_sums if jtr.cfg.model == "dcp" else jtr._vcrnet_loss_and_sums
        loss, sums = fn(out, jb, jb["valid"])
        return loss, (sums, mut)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (sums, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, jb)
    return batch, state, loss, sums, grads, mut["batch_stats"]


@pytest.fixture(scope="module", params=list(FAMILIES), ids=list(FAMILIES))
def family(request):
    kw = FAMILIES[request.param]
    return kw, _jax_step(kw)


def _port(kw, state, **extra):
    tr = Trainer(Config(**NARROW, **TNETS, **kw, **extra), device="cpu")
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params),
                                             jax.device_get(state.batch_stats)), strict=True)
    return tr


def _check_step(tr, batch, j_loss, j_sums, j_grads, j_stats):
    loss, sums = tr.compute_grads(batch)
    assert tr.grads_filled == []
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert set(sums) == set(j_sums)
    for key in j_sums:
        np.testing.assert_allclose(float(sums[key]), float(j_sums[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    _assert_stats_match(tr.model, j_stats)
    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)


def test_training_step_with_t_nets_matches_jax(family):
    kw, (batch, state, j_loss, j_sums, j_grads, j_stats) = family
    tr = _port(kw, state)
    updates = []
    for m in tr.model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.register_forward_hook(lambda mod, i, o: updates.append(mod.update_stats))
    _check_step(tr, batch, j_loss, j_sums, j_grads, j_stats)
    calls = 1 if kw.get("model", "vcrnet") == "vcrnet" else 2  # stacked, or two calls
    assert len(updates) == calls * 10 and all(updates)  # ten BatchNorms in two T-Nets


def test_remat_step_with_t_nets_matches_jax_and_updates_the_statistics_once(family):
    """The recompute runs the forward again without touching the running
    statistics: the step's statistics are the plain step's, as the JAX
    package's jax.checkpoint leaves them (LPD ignores remat in both)."""
    kw, (batch, state, j_loss, j_sums, j_grads, j_stats) = family
    tr = _port(kw, state, remat=True)
    _check_step(tr, batch, j_loss, j_sums, j_grads, j_stats)


def test_partial_vcrnet_step_with_t_nets_moves_the_statistics_as_jax():
    """A partial step runs the forward in training mode and no backward:
    the gradients are zeros, the stacked call updates the statistics once,
    and they and the parameters after the step are the JAX package's."""
    kw = dict(partial=True, overlap=0.575)
    jtr = JTrainer(JConfig(**NARROW, **TNETS, **kw), mesh=make_mesh(1))
    batch = _batch(jtr.cfg, seed=8)
    state = _jax_state(jtr, batch)
    tr = _port(kw, state)
    state, _ = jtr._train_step(state, batch)
    tr.train_step(batch)
    assert len(tr.grads_filled) == len(list(tr.model.parameters()))
    _assert_stats_match(tr.model, state.batch_stats)
    want = from_jax_params(jax.device_get(state.params))
    for name, val in tr.model.named_parameters():
        np.testing.assert_allclose(val.detach().numpy(), want[name].numpy(), atol=1e-7,
                                   rtol=2.4e-7, err_msg=name)


def test_init_follows_jax_distributions_for_t_nets_and_vcp_att(family):
    kw, (_, state, *_) = family
    want = from_jax_params(jax.device_get(state.params), jax.device_get(state.batch_stats))
    got = Trainer(Config(**NARROW, **TNETS, **kw), device="cpu", seed=3).model.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        val = got[name]
        if ".t_net" in name and name.rsplit(".", 2)[-2].startswith("fc") and name.endswith(
                "weight"):
            assert 0.9e-3 < float(val.std()) < 1.1e-3 and 0.9e-3 < float(ref.std()) < 1.1e-3
        if name.startswith("vcp_att.") or name.endswith(("bias", "running_mean", "running_var")) \
                or ".bn" in name:
            assert torch.equal(val, ref), name  # identity, zeros, ones
        elif ref.numel() >= 256:  # the convs: kaiming at the slope
            assert 0.8 < float(val.std() / ref.std()) < 1.25, name
            assert float(val.abs().max()) <= 1.3 * float(ref.abs().max()), name


def test_merging_a_t_net_embedding_is_refused():
    """The JAX package's merge raises AttributeError on a T-Net subtree;
    the port refuses it by name, and merges LPDNet's twelve tensors
    without T-Nets as before."""
    with_tnet = Trainer(Config(**NARROW, **TNETS), device="cpu", seed=0).model.state_dict()
    emb = LPDNet(64, t3d=True, tfea=True).state_dict()
    with pytest.raises(ValueError, match=r"T-Net \(\['t_net3d', 't_net_fea'\]\).*AttributeError"):
        merge_pretrained_embedding(with_tnet, emb)
    plain = Trainer(Config(**NARROW), device="cpu", seed=0).model.state_dict()
    merged = merge_pretrained_embedding(plain, emb)  # the model has no T-Net to merge into
    small = {k: v for k, v in emb.items() if not k.startswith("t_net")}
    assert len(small) == 12
    for key, val in small.items():
        assert torch.equal(merged[f"emb_nn.{key}"], val)
