"""Training in partial-overlap mode, the port against the JAX package.

VCR-Net's partial head returns gathers of the input points alone, so no
gradient reaches a parameter: the JAX package differentiates to a tree of
zeros and Adam steps on the weight decay alone (g = 1e-4 p), moving each
weight by about lr towards zero; the port runs no backward, fills every
gradient with zeros and takes the same step. DCP on partial crops has
real gradients, through the re-masked cross attention. Same seeded numpy
batches and flax parameters (bridged by ``from_jax_params``), f32 on the
CPU, at narrow width, on uniform random clouds (no two points at equal
distances, so the kNN graphs of both packages are the same).

Tolerances: parameters after the steps within 1e-7 and one f32 ulp of
their value (f32 Adam on the same gradients in another operation order;
a step moves a weight by about 1e-3); BatchNorm statistics rtol 1e-5;
sums rtol 1e-4; DCP's gradients 1e-3 of each parameter's largest, floored
at 1e-3 of the model's largest (the training step tests' rule).

VCR-Net's partial sums are not compared: at a seeded init the head's
confidences are nearly uniform, so its top-k selections turn the last-bit
differences between XLA's and PyTorch's sums into other point sets (the
eval tests hold the head on inputs with checked gaps). DCP's gradients are
held on LPDNet: on the CPU the JAX package's jitted gradient of DGCNN in
training mode differs from its eager one by 40-70% (in f64 finite
differences side with the eager one; the forward agrees to 2e-5), and the
port agrees with the eager one to 4e-6 (whole mode,
``tests/test_torch_dgcnn_dcp.py``); DCP on DGCNN is held by its partial
sums and running statistics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train.engine import TrainState
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, batch_size=3,
              test_batch_size=3)
PARTIAL = dict(partial=True, overlap=0.575)
LR = 1e-3


def _batch(cfg, seed=7, n_items=3):
    np.random.seed(seed)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(cfg, "train", n_items=n_items, cloud_points=128,
                                                kind="uniform"), n_items)))
    batch.pop("label")
    return batch


def _jax_state(jtr, batch):
    """A TrainState from a jitted init (flax's eager init is slow on the CPU)."""
    variables = jax.jit(jtr.model.init)(jax.random.PRNGKey(0), jnp.asarray(batch["src"][:1]),
                                        jnp.asarray(batch["tgt"][:1]))
    params = variables["params"]
    return TrainState(params=params, batch_stats=variables.get("batch_stats", {}),
                      opt_state=jtr.tx.init(params), step=jnp.asarray(0, jnp.int32))


def _port(kw, state, use_kernels=None):
    tr = Trainer(Config(**NARROW, **kw), device="cpu", use_kernels=use_kernels)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params),
                                             jax.device_get(state.batch_stats) or None))
    return tr


def _close_sums(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_partial_vcrnet_steps_on_weight_decay_alone_as_jax():
    """Two partial steps: every gradient zero (no backward), the parameters
    equal to the JAX package's after its two steps, each weight moved by
    at most 1.01 lr a step, zero-initialised biases not at all."""
    kw = dict(PARTIAL, lr=LR)
    jtr = JTrainer(JConfig(**NARROW, **kw), mesh=make_mesh(1))
    batches = [_batch(jtr.cfg, seed=s) for s in (7, 8)]
    state = _jax_state(jtr, batches[0])
    tr = _port(kw, state)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    for batch in batches:
        state, j_sums = jtr._train_step(state, batch)
        loss, sums = tr.compute_grads(batch)
        assert not loss.requires_grad
        names = [n for n, _ in tr.model.named_parameters()]
        assert tr.grads_filled == names
        assert all(torch.equal(p.grad, torch.zeros_like(p)) for p in tr.model.parameters())
        tr.optimizer.step()
        tr.step += 1
        assert set(sums) == set(j_sums) and float(sums["count"]) == float(j_sums["count"])
        assert all(np.isfinite(float(v)) for v in sums.values())
    want = from_jax_params(jax.device_get(state.params), jax.device_get(state.batch_stats) or None)
    got = tr.model.state_dict()
    assert set(got) == set(want)
    for name, val in got.items():
        np.testing.assert_allclose(val.numpy(), want[name].numpy(), atol=1e-7, rtol=2.4e-7,
                                   err_msg=name)
        moved = (val - before[name]).abs().max().item()
        assert moved <= 2 * 1.01 * LR, name
        if not before[name].abs().max() > 0:
            assert moved == 0.0, name


def test_partial_vcrnet_with_dropout_and_remat_still_has_zero_gradients():
    """Dropout and remat combine with partial mode as in the JAX package:
    the step still has no gradient path, and remat's forward updates the
    running statistics once, as a plain partial step does."""
    batch = _batch(JConfig(**NARROW, **PARTIAL))
    stats = []
    for remat in (False, True):
        tr = Trainer(Config(**NARROW, **PARTIAL, emb_nn="dgcnn", dropout=0.1, remat=remat),
                     device="cpu", seed=0)
        tr.train_step(batch)
        assert len(tr.grads_filled) == len(list(tr.model.parameters()))
        stats.append({n: b.clone() for n, b in tr.model.named_buffers()})
    for name, val in stats[0].items():
        assert torch.equal(val, stats[1][name]), name


def _jax_dcp_partial(emb_nn):
    """The JAX trainer's DCP partial loss, sums, gradients (jitted) and
    updated running statistics on one batch, beside its state."""
    kw = dict(PARTIAL, model="dcp", emb_nn=emb_nn)
    jtr = JTrainer(JConfig(**NARROW, **kw), mesh=make_mesh(1))
    batch = _batch(jtr.cfg, seed=9)
    state = _jax_state(jtr, batch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        variables = {"params": params, "batch_stats": state.batch_stats}
        out, mut = jtr._apply(variables, jb["src"], jb["tgt"], train=True)
        loss, sums = jtr._dcp_loss_and_sums(out, jb, jb["valid"])
        return loss, (sums, mut)

    (loss, (sums, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    return kw, batch, state, loss, sums, grads, mut.get("batch_stats", {})


@pytest.fixture(scope="module")
def jax_dcp_partial_lpdnet():
    return _jax_dcp_partial("lpdnet")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_partial_dcp_loss_and_grads_match_jax(jax_dcp_partial_lpdnet, use_kernels):
    """DCP on partial crops: real gradients through the re-masked cross
    attention, every parameter reached, equal to the JAX package's."""
    kw, batch, state, j_loss, j_sums, j_grads, _ = jax_dcp_partial_lpdnet
    tr = _port(kw, state, use_kernels)
    loss, sums = tr.compute_grads(batch)
    assert tr.grads_filled == []
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    _close_sums(sums, j_sums)
    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    assert floor > 0
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)


def test_partial_dcp_on_dgcnn_sums_and_running_stats_match_jax():
    """BatchNorm's running statistics update in partial mode as in whole
    mode: after the partial step, as the JAX package's."""
    kw, batch, state, j_loss, j_sums, _, j_stats = _jax_dcp_partial("dgcnn")
    tr = _port(kw, state)
    loss, sums = tr.compute_grads(batch)
    assert tr.grads_filled == []
    assert all(float(p.grad.abs().max()) > 0 for n, p in tr.model.named_parameters()
               if not n.endswith("linear_k.bias"))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    _close_sums(sums, j_sums)
    stats = from_jax_params({}, jax.device_get(j_stats))
    assert len(stats) == 10
    for name, val in stats.items():
        np.testing.assert_allclose(tr.model.state_dict()[name].numpy(), val.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


WHOLE = {
    "vcrnet_lpdnet": dict(),
    "vcrnet_dgcnn_cycle": dict(emb_nn="dgcnn", cycle=True),
    "vcrnet_pointnet_identity": dict(emb_nn="pointnet", pointer="identity"),
    "dcp_dgcnn": dict(model="dcp", emb_nn="dgcnn"),
    "dcp_mlp_cycle": dict(model="dcp", emb_nn="pointnet", head="mlp", cycle=True),
}


@pytest.mark.parametrize("kw", list(WHOLE.values()), ids=list(WHOLE))
def test_whole_mode_is_unchanged_by_the_zero_fill(kw):
    """In whole mode every parameter has a gradient before the fill, so the
    step is the one without it, bit for bit: a forward, a backward and
    Adam, as the training step was before partial mode was ported."""
    batch = _batch(JConfig(**NARROW, **kw), seed=11)
    a = Trainer(Config(**NARROW, **kw), device="cpu", seed=0)
    b = Trainer(Config(**NARROW, **kw), device="cpu", seed=0)
    a.train_step(batch)
    assert a.grads_filled == []
    bb = b.to_device(batch)
    b.model.train()
    b.optimizer.zero_grad(set_to_none=True)
    loss, _ = b.loss_and_sums(b.model(bb["src"], bb["tgt"]), bb)
    loss.backward()
    assert all(p.grad is not None for p in b.model.parameters())
    b.optimizer.step()
    for name, val in a.model.state_dict().items():
        assert torch.equal(val, b.model.state_dict()[name]), name
