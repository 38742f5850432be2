"""Dropout and rematerialisation of the port's training step (Config.dropout,
Config.remat) against the JAX package's.

Dropout draws its masks from a torch generator where the JAX package draws
from its own, so it is held by what the masks do, not by their bits: rate
0 and eval are the model without dropout, bit for bit; a rate p zeroes a
share p of a tensor (within 5 standard errors) and scales the rest by
1 / (1 - p); the mean over many masks approaches the undropped output; the
masks follow (seed, step) alone; the attention that drops takes the plain
route, as the JAX package's does; and both packages train with dropout on
one batch, their losses falling. Remat recomputes the forward in the
backward: on the CPU every gradient, loss and running statistic equals the
step without it bit for bit, with dropout too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models.vcrnet import VCRNet as JVCRNet
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import VCRNet
from vcrnet_tpu_torch.models import transformer
from vcrnet_tpu_torch.models._common import Dropout, DropoutRng, FlaxBatchNorm, dropout
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params
from vcrnet_tpu_torch.utils.rng import fold_seed

NARROW = dict(num_points=64, emb_dims=256, ff_dims=128, n_heads=2, batch_size=4,
              test_batch_size=4)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: these small tensors gain nothing
    from more, and the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, n_items=4, seed=7):
    np.random.seed(seed)
    loader = JLoader(JSyntheticDataset(cfg, "train", n_items=n_items, cloud_points=128,
                                       kind="shapes"), n_items)
    batch = next(iter(loader))
    batch.pop("label")
    return batch


def _grads(trainer):
    return {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}


def _stats(trainer):
    return {n: b.clone() for n, b in trainer.model.named_buffers() if "running_" in n}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_zeroes_a_share_p_and_scales_the_rest(rate):
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(1000, 1000) + 0.5
    y = dropout(x, rate, gen)
    zeros = (y == 0).double().mean().item()
    assert abs(zeros - rate) <= 5 * np.sqrt(rate * (1 - rate) / x.numel())
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    bf16 = dropout(x.bfloat16(), rate, gen)
    assert bf16.dtype == torch.bfloat16


def test_the_mean_over_many_masks_approaches_the_undropped_output():
    """E[drop(x)] = x, so the mean of a feed-forward that is linear in its
    dropped hidden activation approaches the undropped output: the error
    shrinks with the number of masks."""
    torch.manual_seed(0)
    rng = DropoutRng("cpu")
    ff = transformer.FeedForward(32, 64, dropout=0.2, dropout_rng=rng)
    x = torch.randn(2, 16, 32)
    with torch.no_grad():
        want = ff.eval()(x)
        ff.train()
        draws = torch.stack([ff(x) for _ in range(1600)])
    err = [(draws[:n].mean(0) - want).abs().max().item() for n in (25, 1600)]
    assert err[1] < err[0] / 3
    assert err[1] < 0.03 * want.abs().max().item()
    gen = torch.Generator().manual_seed(1)
    v = torch.linspace(-1, 1, 101)
    mean = torch.stack([dropout(v, 0.5, gen) for _ in range(4000)]).mean(0)
    assert (mean - v).abs().max().item() < 5 * 1.0 / np.sqrt(4000)


def test_dropout_at_rate_zero_and_in_eval_is_the_identity():
    x = torch.randn(3, 5)
    for module in (Dropout(0.0).train(), Dropout(0.3, DropoutRng("cpu")).eval()):
        assert module(x) is x
    with pytest.raises(ValueError, match="DropoutRng"):
        Dropout(0.1)
    model = VCRNet(Config(**NARROW), device="cpu")
    assert model.dropout_rng is None
    assert not any(m.active for m in model.modules() if isinstance(m, Dropout))


def _jax_model_and_variables(cfg_kw, src, tgt):
    jmodel = JVCRNet(cfg=JConfig(**cfg_kw))
    return jmodel, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(src), jnp.asarray(tgt))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eval_ignores_dropout_in_both_packages(use_kernels):
    """A dropout config in eval is the model without dropout: bit for bit in
    the port, and the JAX model's eval output (tolerance of the parity
    tests, 1e-4)."""
    batch = _batch(JConfig(**NARROW))
    src, tgt = batch["src"], batch["tgt"]
    jmodel, variables = _jax_model_and_variables(dict(NARROW, dropout=0.3), src, tgt)
    state = from_jax_params(jax.device_get(variables["params"]))
    outs = []
    for rate in (0.3, 0.0):
        model = VCRNet(Config(**NARROW, dropout=rate), device="cpu", use_kernels=use_kernels)
        model.load_state_dict(state)
        with torch.no_grad():
            outs.append(model.eval()(torch.from_numpy(src), torch.from_numpy(tgt)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = jmodel.apply(variables, jnp.asarray(src), jnp.asarray(tgt))
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _attn_drop_outputs(model):
    outs = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: outs.append(out.detach()))
             for name, m in model.named_modules() if name.endswith("attn_drop")]
    return outs, hooks


def test_a_training_forward_drops_a_share_p_of_the_attention_probabilities():
    """The six attention probability tensors of one training forward
    (encoder twice, decoder self and cross twice) lose a share p of their
    entries; eval keeps them all."""
    rate = 0.25
    tr = Trainer(Config(**NARROW, dropout=rate), device="cpu", use_kernels=False)
    outs, hooks = _attn_drop_outputs(tr.model)
    tr.compute_grads(_batch(JConfig(**NARROW)))
    assert len(outs) == 6
    zeros = torch.cat([(o == 0).reshape(-1).double() for o in outs])
    assert abs(zeros.mean().item() - rate) <= 5 * np.sqrt(rate * (1 - rate) / zeros.numel())
    outs.clear()
    tr.eval_step(_batch(JConfig(**NARROW)))
    assert len(outs) == 6 and not any((o == 0).any() for o in outs)
    for h in hooks:
        h.remove()


def test_dropout_masks_follow_the_seed_and_the_step_alone():
    batch = _batch(JConfig(**NARROW))
    grads = {}
    for seed, step in ((1, 0), (1, 0), (1, 1), (2, 0)):
        tr = Trainer(Config(**NARROW, dropout=0.2, seed=seed), device="cpu", seed=0)
        tr.step = step
        tr.compute_grads(batch)
        grads.setdefault((seed, step), []).append(_grads(tr))
    same = grads[(1, 0)]
    assert all(torch.equal(same[0][n], same[1][n]) for n in same[0])
    for other in ((1, 1), (2, 0)):
        g = grads[other][0]
        assert any(not torch.equal(same[0][n], g[n]) for n in g)
    assert fold_seed(1234, 3) == fold_seed(1234, 3) != fold_seed(1234, 4)


@pytest.mark.parametrize("model", ["vcrnet", "dcp"])
def test_the_attention_that_drops_takes_the_plain_route(model, monkeypatch):
    """With the kernel route, a training step with dropout runs no pointer
    attention through ``ops.attention`` (its probabilities are written
    out); eval, and a step without dropout, run all six through it."""
    calls = []
    real = transformer.attention
    monkeypatch.setattr(transformer, "attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = _batch(JConfig(**NARROW))
    kw = dict(NARROW, model=model)
    for rate, want_train in ((0.1, 0), (0.0, 6)):
        tr = Trainer(Config(**kw, dropout=rate), device="cpu", use_kernels=True)
        calls.clear()
        tr.compute_grads(batch)
        assert len(calls) == want_train
        calls.clear()
        tr.eval_step(batch)
        assert len(calls) == 6


def test_jax_and_port_train_with_dropout_and_their_losses_fall():
    """Ten Adam steps with dropout 0.1 on one batch from the same initial
    parameters: the loss falls in both packages."""
    kw = dict(NARROW, dropout=0.1)
    jcfg = JConfig(**kw)
    batch = _batch(jcfg)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    tr = Trainer(Config(**kw), device="cpu", use_kernels=True)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    j_losses, losses = [], []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(10):
        state, j_sums = jtr._train_step(state, jb)
        j_losses.append(float(j_sums["loss"]) / float(j_sums["count"]))
        sums = tr.train_step(batch)
        losses.append(float(sums["loss"]) / float(sums["count"]))
    assert np.isfinite(j_losses).all() and np.isfinite(losses).all()
    assert j_losses[-1] < 0.7 * j_losses[0]
    assert losses[-1] < 0.7 * losses[0]


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT_CASES = [
    ("vcrnet", dict()),
    ("vcrnet dropout", dict(dropout=0.2)),
    ("vcrnet dgcnn", dict(emb_nn="dgcnn")),
    ("dcp dgcnn", dict(model="dcp", emb_nn="dgcnn")),
    ("dcp dgcnn mlp dropout", dict(model="dcp", emb_nn="dgcnn", head="mlp", dropout=0.2)),
    ("dcp pointnet cycle", dict(model="dcp", emb_nn="pointnet", cycle=True)),
]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name,kw", REMAT_CASES, ids=[c[0] for c in REMAT_CASES])
def test_remat_step_equals_the_step_without_it(name, kw, use_kernels):
    """One training step with and without remat from the same parameters
    and batch: the loss, every metric sum and gradient, and the running
    statistics after it, bit for bit (one update of the statistics per
    call of a BatchNorm in the forward, none in the recompute)."""
    batch = _batch(JConfig(**NARROW))
    runs = []
    for remat in (False, True):
        tr = Trainer(Config(**NARROW, **kw, remat=remat), device="cpu", use_kernels=use_kernels,
                     seed=0)
        calls = []
        hook = tr.model.register_forward_pre_hook(lambda *_: calls.append(1))
        loss, sums = tr.compute_grads(batch)
        hook.remove()
        assert len(calls) == (2 if remat else 1)
        runs.append((loss, sums, _grads(tr), _stats(tr)))
        assert all(m.update_stats for m in tr.model.modules() if isinstance(m, FlaxBatchNorm))
    (loss_a, sums_a, grads_a, stats_a), (loss_b, sums_b, grads_b, stats_b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(sums_a[k], sums_b[k]) for k in sums_a)
    assert list(grads_a) == list(grads_b) and len(grads_a) > 10
    for n in grads_a:
        assert torch.equal(grads_a[n], grads_b[n]), n
    has_bn = kw.get("emb_nn", "lpdnet") != "lpdnet" or kw.get("head") == "mlp"
    assert bool(stats_a) == has_bn
    for n in stats_a:
        assert torch.equal(stats_a[n], stats_b[n]), n
    if has_bn:  # the statistics moved: the forward's updates were kept
        assert any(not torch.equal(v, torch.zeros_like(v)) for n, v in stats_a.items()
                   if n.endswith("running_mean"))


def test_remat_trains_the_same_parameters_over_steps():
    """Three Adam steps with remat and dropout end at the parameters of three
    steps without remat."""
    batch = _batch(JConfig(**NARROW))
    params = []
    for remat in (False, True):
        tr = Trainer(Config(**NARROW, dropout=0.1, remat=remat, emb_nn="dgcnn"), device="cpu",
                     seed=0)
        for _ in range(3):
            tr.train_step(batch)
        params.append(tr.model.state_dict())
    for n in params[0]:
        assert torch.equal(params[0][n], params[1][n]), n


def test_partial_training_is_still_refused():
    """No longer refused: partial mode with remat and dropout runs the
    forward (under the checkpoint) and, its loss having no gradient path,
    no backward; every gradient is zero, as in the JAX package."""
    cfg = Config(**NARROW, partial=True, overlap=0.575, remat=True, dropout=0.1)
    tr = Trainer(cfg, device="cpu")
    loss, _ = tr.compute_grads(_batch(JConfig(**NARROW, partial=True, overlap=0.575)))
    assert np.isfinite(float(loss)) and not loss.requires_grad
    assert tr.grads_filled == [n for n, _ in tr.model.named_parameters()]
    assert all(torch.equal(p.grad, torch.zeros_like(p)) for p in tr.model.parameters())
