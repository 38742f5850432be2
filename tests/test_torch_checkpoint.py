"""The port's checkpoints, resume and the rest of ``fit`` against the JAX
package (vcrnet_tpu/train/checkpoint.py, engine.py:fit and worst_cases,
utils/logging.py), on the CPU at narrow widths.

* a save/load round trip restores parameters, BatchNorm buffers, Adam's
  state and the step bit for bit; a state holding only the embedding
  merges non-strictly and keeps the template's optimizer state;
* a JAX TrainState msgpack (and a bare param tree) written by the JAX
  package loads into the port and gives the JAX model's eval sums (rtol
  1e-4, f32 sums in another order, as tests/test_torch_train_step.py);
* a fit that stops after two epochs and resumes from ``model.1.pt`` and
  ``fit_state.json`` gives the history of an uninterrupted fit exactly (the
  plain route on the CPU is deterministic); a ``fit_state.json`` of the
  JAX package resumes the port's scheduler as the JAX scheduler steps;
* every reference-layout converter equals the JAX converter bridged by
  ``from_jax_params`` on a seeded state dict, and exports round-trip;
* ``worst_cases`` gives the JAX trainer's indices on the same weights and
  batches, ``_board_scalars`` the JAX function's (tag, value) list.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu.train import checkpoint as jckpt
from vcrnet_tpu.train import engine as jengine
from vcrnet_tpu.train import optim as joptim
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.train import Trainer, checkpoint as ckpt, engine
from vcrnet_tpu_torch.utils import logging as tlog
from vcrnet_tpu_torch.utils.params import from_jax_params

TINY = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, batch_size=4,
            test_batch_size=4)


def _batches(cfg, partition, n_items, batch_size, seed):
    """Batches of the JAX package's synthetic loader, drawn once (numpy)."""
    np.random.seed(seed)  # train items draw from the global generator
    loader = JLoader(JSyntheticDataset(cfg, partition, n_items=n_items, cloud_points=128,
                                       kind="shapes"), batch_size)
    out = []
    for b in loader:
        b.pop("label")
        out.append(b)
    return out


def _jcfg(**kw):
    return JConfig(**{**TINY, **kw})


def _cfg(**kw):
    return Config(**{**TINY, **kw})


def _trainer(seed=0, **kw):
    return Trainer(_cfg(**kw), device="cpu", use_kernels=False, seed=seed)


def _optimizer_tensors(tr):
    st = tr.optimizer.state_dict()["state"]
    return {(i, k): v for i, s in st.items() for k, v in s.items() if torch.is_tensor(v)}


# ------------------------------------------------------------ full state


@pytest.mark.parametrize("kw", [{}, dict(model="dcp", emb_nn="dgcnn", emb_dims=128)],
                         ids=["vcrnet", "dcp_dgcnn"])
def test_round_trip_restores_everything_bit_for_bit(tmp_path, kw):
    tr = _trainer(**kw)
    batch = _batches(_jcfg(), "train", 4, 4, seed=3)[0]
    for _ in range(2):
        tr.train_step(batch)
    path = ckpt.save_checkpoint(str(tmp_path), "model.best", tr)
    assert path == str(tmp_path / "model.best.pt")

    fresh = _trainer(seed=1, **kw)
    assert not torch.equal(next(fresh.model.parameters()), next(tr.model.parameters()))
    assert ckpt.load_checkpoint(path, fresh) is fresh
    want, got = tr.model.state_dict(), fresh.model.state_dict()
    assert list(want) == list(got) and all(torch.equal(want[k], got[k]) for k in want)
    if kw:  # BatchNorm's running statistics moved from their init and came back
        assert any(k.endswith("running_var") for k in want)
    want_opt, got_opt = _optimizer_tensors(tr), _optimizer_tensors(fresh)
    assert want_opt and set(want_opt) == set(got_opt)
    assert all(torch.equal(want_opt[k], got_opt[k]) for k in want_opt)
    assert fresh.step == tr.step == 2
    # the restored trainer takes the same next step
    tr.train_step(batch)
    fresh.train_step(batch)
    assert all(torch.equal(a, b) for a, b in zip(tr.model.parameters(),
                                                 fresh.model.parameters()))


def test_an_embedding_only_state_merges_and_keeps_the_optimizer(tmp_path):
    """A state whose model holds the embedding alone (an LPD pretraining
    run's) restores just the embedding; the rest of the model, Adam's
    state and the step stay the template's."""
    tr = _trainer()
    batch = _batches(_jcfg(), "train", 4, 4, seed=3)[0]
    tr.train_step(batch)
    emb = {k: v + 1.0 for k, v in tr.model.state_dict().items() if k.startswith("emb_nn.")}
    path = ckpt.save_checkpoint(str(tmp_path), "lpd", {"model": {**emb, "other.w": torch.ones(2)},
                                                       "step": 99})
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    opt_before = {k: v.clone() for k, v in _optimizer_tensors(tr).items()}
    ckpt.load_checkpoint(path, tr)
    after = tr.model.state_dict()
    for k, v in after.items():
        assert torch.equal(v, emb[k] if k in emb else before[k]), k
    assert all(torch.equal(v, opt_before[k]) for k, v in _optimizer_tensors(tr).items())
    assert tr.step == 1
    # a merge that takes nothing is an error, not a silent no-op
    nothing = ckpt.save_checkpoint(str(tmp_path), "nothing", {"model": {"x.weight": torch.ones(1)}})
    with pytest.raises(ValueError, match="merged 0 leaves"):
        ckpt.load_checkpoint(nothing, tr)


@pytest.mark.parametrize("kind", ["train_state", "bare_params", "dcp_dgcnn"])
def test_a_jax_msgpack_loads_and_gives_the_jax_eval(tmp_path, kind):
    kw = dict(model="dcp", emb_nn="dgcnn", emb_dims=128) if kind == "dcp_dgcnn" else {}
    jcfg = _jcfg(**kw)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    train = _batches(jcfg, "train", 4, 4, seed=5)
    state = jtr.init_state(jax.random.PRNGKey(0), train[0])
    state, _ = jtr._train_step(state, jtr._to_device(train[0]))  # BN statistics move too
    if kind == "bare_params":
        path = str(tmp_path / "params.msgpack")
        jckpt.save_params(path, state.params)
    else:
        path = jckpt.save_checkpoint(str(tmp_path), "model.best", state)
    tr = _trainer(seed=3, **kw)
    opt_before = {k: v.clone() for k, v in _optimizer_tensors(tr).items()}
    ckpt.load_checkpoint(path, tr)
    want = from_jax_params(jax.device_get(state.params),
                           jax.device_get(state.batch_stats) or None)
    got = tr.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    if kind == "dcp_dgcnn":
        assert any(k.endswith("running_mean") for k in want)
    assert all(torch.equal(v, opt_before[k]) for k, v in _optimizer_tensors(tr).items())
    test = _batches(jcfg, "test", 3, 3, seed=6)[0]
    jsums = jtr._eval_step_impl(state, {k: jax.numpy.asarray(v) for k, v in test.items()})
    sums = tr.eval_step(test)
    for key in jsums:
        np.testing.assert_allclose(float(sums[key]), float(jsums[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_params_save_and_load_strictly(tmp_path):
    tr = _trainer()
    path = str(tmp_path / "sub" / "params.pt")
    ckpt.save_params(path, tr.model)
    fresh = _trainer(seed=2)
    sd = ckpt.load_params(path, fresh.model)
    assert all(torch.equal(v, tr.model.state_dict()[k]) for k, v in sd.items())
    assert all(torch.equal(v, sd[k]) for k, v in fresh.model.state_dict().items())
    with pytest.raises(ValueError, match="differ"):
        ckpt.load_params(path, _trainer(emb_dims=128).model)


# ------------------------------------------------------------ fit and resume


def test_fit_resumed_from_its_checkpoint_equals_an_uninterrupted_fit(tmp_path):
    cfg = _jcfg()
    train = _batches(cfg, "train", 8, 4, seed=11)
    test = _batches(cfg, "test", 6, 4, seed=12)  # the last batch padded: valid 0
    quiet = lambda s: None  # noqa: E731
    first = _trainer()
    h1 = first.fit(train, test, epochs=2, log=quiet, checkpoint_dir=str(tmp_path))
    assert [h["epoch"] for h in h1] == [0, 1]
    for name in ("model.best.pt", "model.0.pt", "model.1.pt", "fit_state.json"):
        assert (tmp_path / name).exists(), name
    saved = json.loads((tmp_path / "fit_state.json").read_text())
    assert set(saved) == {"epoch", "best_loss", "lr", "sched"} and saved["epoch"] == 1

    resumed = ckpt.load_checkpoint(str(tmp_path / "model.1.pt"), _trainer(seed=7))
    logs = []
    h2 = resumed.fit(train, test, epochs=3, log=logs.append, checkpoint_dir=str(tmp_path))
    assert logs[0] == "resumed fit state at epoch 2"
    assert [h["epoch"] for h in h2] == [2]

    whole = _trainer().fit(train, test, epochs=3, log=quiet)
    assert h2[0]["lr"] == whole[2]["lr"]
    for split in ("train", "test"):
        assert h2[0][split] == whole[2][split], split


def test_a_jax_fit_state_resumes_the_ports_scheduler(tmp_path):
    """fit_state.json written by the JAX package (its scheduler after three
    epochs, one of them bad) resumes the port's: the epoch after, the same
    learning rate in the optimizer, and each new epoch's rate as the JAX
    scheduler steps on the same best loss. The port's file reads back into
    the JAX scheduler."""
    sched = joptim.ReduceLROnPlateau(1e-3, patience=1)
    for loss in (0.5, 0.4, 0.45):
        sched.step(0.4 if loss > 0.4 else loss)
    jckpt.save_fit_state(str(tmp_path), {"epoch": 2, "best_loss": 0.4, "lr": sched.lr,
                                         "sched": dict(sched.__dict__)})
    cfg = _jcfg()
    train = _batches(cfg, "train", 4, 4, seed=13)
    test = _batches(cfg, "test", 4, 4, seed=14)
    tr = _trainer()
    seen = []
    orig = tr.train_epoch
    tr.train_epoch = lambda loader: (seen.append(tr.optimizer.param_groups[0]["lr"]),
                                     orig(loader))[1]
    hist = tr.fit(train, test, epochs=5, log=lambda s: None, checkpoint_dir=str(tmp_path))
    assert [h["epoch"] for h in hist] == [3, 4]
    assert seen[0] == sched.lr
    best = 0.4
    for h in hist:
        best = min(best, h["test"]["loss_pose"])
        assert h["lr"] == sched.step(best)
    back = jckpt.load_fit_state(str(tmp_path))
    again = joptim.ReduceLROnPlateau(1.0)
    again.__dict__.update(back["sched"])
    assert again.lr == hist[-1]["lr"] and back["epoch"] == 4


class _Recorder:
    def __init__(self):
        self.calls = []

    def scalar(self, tag, value, step):
        self.calls.append((tag, float(value), step))


def test_fit_writes_the_reference_scalar_matrix(tmp_path):
    cfg = _jcfg()
    train = _batches(cfg, "train", 4, 4, seed=15)
    test = _batches(cfg, "test", 4, 4, seed=16)
    rec = _Recorder()
    hist = _trainer().fit(train, test, epochs=1, log=lambda s: None, metrics_writer=rec)
    want = _Recorder()
    h = hist[0]
    jengine._board_scalars(want, "train", h["train"]["loss"], h["train"], 0)
    jengine._board_scalars(want, "test", h["test"]["loss"], h["test"], 0)
    jengine._board_scalars(want, "best_test", h["test"]["loss_pose"], h["test"], 0)
    want.scalar("A->B/train/lossPose", h["train"]["loss_pose"], 0)
    want.scalar("A->B/test/lossPose", h["test"]["loss_pose"], 0)
    want.scalar("A->B/best_test/lr", h["lr"], 0)
    assert rec.calls == want.calls
    assert len(rec.calls) == 3 * 2 * 10 + 3


def test_board_scalars_emit_the_jax_tags_and_values():
    summary = {"point_ab_MSE": 0.1, "point_ab_RMSE": 0.3, "rot_ab_MAE": 2.0,
               "trans_ba_RMSE": 0.01, "rot_ba_MSE": 4.0, "loss": 0.2, "unrelated": 5.0}
    got, want = _Recorder(), _Recorder()
    engine._board_scalars(got, "test", 0.25, summary, 3)
    jengine._board_scalars(want, "test", 0.25, summary, 3)
    assert got.calls == want.calls and len(got.calls) == 7


# ------------------------------------------------------------ worst cases


def test_worst_cases_give_the_jax_indices():
    jcfg = _jcfg(iter=2)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    batches = _batches(jcfg, "test", 10, 4, seed=17)  # 4 + 4 + 2 real, 2 padding rows
    state = jtr.init_state(jax.random.PRNGKey(0), batches[0])
    tr = Trainer(Config(**TINY, iter=2), device="cpu", use_kernels=False)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    want = jtr.worst_cases(state, batches, k=5)
    got = tr.worst_cases(batches, k=5)
    assert got["worst_rot_idx"] == want["worst_rot_idx"]
    assert got["worst_trans_idx"] == want["worst_trans_idx"]
    for key in ("rot_se", "trans_se"):
        assert got[key].shape == (12,) and np.isneginf(got[key][10:]).all()
        np.testing.assert_allclose(got[key][:10], want[key][:10], rtol=1e-3, atol=1e-6)


# ------------------------------------------------------------ converters


def _reference_state_dict(n_blocks=1, seed=21, emb=64, ff=128):
    """A seeded state dict in the reference implementation's layout: the
    LPDNet k = 1 convs, the transformer pointer, the VcpAtt projections."""
    rng = np.random.RandomState(seed)
    sd = {}
    convs = {"conv1_lpd": (64, 3, 1), "conv2_lpd": (64, 64, 1), "conv3_lpd": (emb, 512, 1),
             "convDG1.0": (128, 128, 2), "convDG2.0": (128, 128, 2), "convSN1.0": (256, 256, 2)}
    for key, (o, i, nd) in convs.items():
        sd[f"emb_nn.{key}.weight"] = rng.randn(o, i, *([1] * nd)).astype(np.float32)
        sd[f"emb_nn.{key}.bias"] = rng.randn(o).astype(np.float32)

    def lin(key, o, i):
        sd[f"{key}.weight"] = rng.randn(o, i).astype(np.float32)
        sd[f"{key}.bias"] = rng.randn(o).astype(np.float32)

    def norm(key):
        sd[f"{key}.a_2"] = rng.randn(emb).astype(np.float32)
        sd[f"{key}.b_2"] = rng.randn(emb).astype(np.float32)

    p = "pointer.model."
    for i in range(n_blocks):
        for side, attns, norms in (("encoder", ("self_attn",), 2),
                                   ("decoder", ("self_attn", "src_attn"), 3)):
            layer = f"{p}{side}.layers.{i}."
            for a in attns:
                for j in range(4):
                    lin(f"{layer}{a}.linears.{j}", emb, emb)
            for j in range(norms):
                norm(f"{layer}sublayer.{j}.norm")
            lin(f"{layer}feed_forward.w_1", ff, emb)
            lin(f"{layer}feed_forward.w_2", emb, ff)
    norm(f"{p}encoder.norm")
    norm(f"{p}decoder.norm")
    lin("head.linears_emb.0", emb, emb)
    lin("head.linears_emb.1", emb, emb)
    return sd


def _equal_dicts(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_converters_equal_the_jax_converters(n_blocks):
    sd = _reference_state_dict(n_blocks)
    _equal_dicts(ckpt.convert_lpdnet_state_dict(sd),
                 from_jax_params(jckpt.convert_lpdnet_state_dict(sd)))
    _equal_dicts(ckpt.convert_transformer_state_dict(sd, n_blocks),
                 from_jax_params(jckpt.convert_transformer_state_dict(sd, n_blocks)))
    _equal_dicts(ckpt.convert_vcrnet_state_dict(sd, n_blocks),
                 from_jax_params(jckpt.convert_vcrnet_state_dict(sd, n_blocks)))


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_exports_equal_the_jax_exports_and_round_trip(n_blocks):
    sd = _reference_state_dict(n_blocks)
    jparams = jckpt.convert_vcrnet_state_dict(sd, n_blocks)
    params = ckpt.convert_vcrnet_state_dict(sd, n_blocks)
    emb = {k[len("emb_nn."):]: v for k, v in params.items() if k.startswith("emb_nn.")}
    ptr = {k[len("pointer."):]: v for k, v in params.items() if k.startswith("pointer.")}
    _equal_dicts(ckpt.export_lpdnet_state_dict(emb),
                 jckpt.export_lpdnet_state_dict(jparams["emb_nn"]))
    _equal_dicts(ckpt.export_transformer_state_dict(ptr, n_blocks),
                 jckpt.export_transformer_state_dict(jparams["pointer"], n_blocks))
    exported = ckpt.export_vcrnet_state_dict(params, n_blocks)
    _equal_dicts(exported, jckpt.export_vcrnet_state_dict(jparams, n_blocks))
    # the reference layout without the VcpAtt projections comes back as it was
    _equal_dicts(exported, {k: v for k, v in sd.items() if not k.startswith("head.")})
    back = ckpt.convert_vcrnet_state_dict(exported, n_blocks)
    _equal_dicts(back, {k: v for k, v in params.items() if not k.startswith("vcp_att.")})


def test_a_converted_reference_model_loads_into_the_port():
    """The converted names are the port model's: exporting a VCRNet's
    state dict and converting it back covers every parameter of the
    embedding and the pointer, and loads strictly."""
    tr = _trainer()
    sd = tr.model.state_dict()
    params = ckpt.convert_vcrnet_state_dict(ckpt.export_vcrnet_state_dict(sd))
    assert set(params) == {k for k in sd if k.startswith(("emb_nn.", "pointer."))}
    fresh = _trainer(seed=4)
    fresh.model.load_state_dict(ckpt.merge_params(fresh.model.state_dict(), params))
    assert all(torch.equal(fresh.model.state_dict()[k], sd[k]) for k in params)


def test_t7_files_round_trip(tmp_path):
    sd = _reference_state_dict()
    emb = ckpt.convert_lpdnet_state_dict(sd)
    path = ckpt.export_lpdnet_t7(emb, str(tmp_path / "lpd.t7"))
    _equal_dicts(ckpt.load_t7_lpdnet(path), emb)
    _equal_dicts(ckpt.load_t7_lpdnet(path), from_jax_params(jckpt.load_t7_lpdnet(path)))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "vcr.t7"))
    _equal_dicts(ckpt.load_t7_vcrnet(str(tmp_path / "vcr.t7")), ckpt.convert_vcrnet_state_dict(sd))


def test_merge_params_counts_as_the_jax_merge():
    sd = _reference_state_dict()
    jparams = jckpt.convert_vcrnet_state_dict(sd)
    model_tree = jax.tree_util.tree_map(np.zeros_like, jparams)
    model_tree["pointer"]["enc_norm"]["a_2"] = np.zeros(3, np.float32)  # a shape mismatch
    model_tree.pop("vcp_att")  # names the model does not have
    jstats, stats = {}, {}
    jmerged = jckpt.merge_params(model_tree, jparams, stats=jstats)
    merged = ckpt.merge_params(from_jax_params(model_tree), ckpt.convert_vcrnet_state_dict(sd),
                               stats=stats)
    assert stats == jstats
    _equal_dicts(merged, from_jax_params(jmerged))
    with pytest.raises(ValueError, match="merged 0 leaves"):
        ckpt.merge_params(from_jax_params(model_tree), {"nothing.weight": np.ones(1)})
    assert ckpt.merge_params({}, {}, min_leaves=0) == {}


def test_merge_pretrained_embedding_grafts_the_lpdnet_layers():
    tr = _trainer()
    sd = tr.model.state_dict()
    emb = ckpt.convert_lpdnet_state_dict(_reference_state_dict())
    out = ckpt.merge_pretrained_embedding(sd, emb)
    for k, v in out.items():
        want = emb[k[len("emb_nn."):]] if k.startswith("emb_nn.") else sd[k]
        assert torch.equal(v, want), k
    with pytest.raises(ValueError, match="merged 0 leaves"):
        ckpt.merge_pretrained_embedding(sd, {"convX.weight": torch.ones(1)})


# ------------------------------------------------------------ logging


def test_metrics_writer_writes_an_event_file_and_is_a_no_op_without_a_dir(tmp_path):
    off = tlog.MetricsWriter(None)
    off.scalar("a", 1.0, 0)
    off.close()
    on = tlog.MetricsWriter(str(tmp_path))
    on.scalars("train", {"loss": 0.5, "name": "x"}, 1)
    on.close()
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))


def test_iostream_step_timer_progress_and_profile_trace(tmp_path, capsys):
    io = tlog.IOStream(str(tmp_path / "run.log"))
    io.cprint("epoch 0")
    io.close()
    assert (tmp_path / "run.log").read_text() == "epoch 0\n"
    assert capsys.readouterr().out == "epoch 0\n"
    timer = tlog.StepTimer()
    assert timer.tick() is None and timer.rate() is None
    assert timer.tick() >= 0.0 and timer.rate(8) > 0
    prog = tlog.Progress(desc="train")
    assert list(prog.wrap(range(3))) == [0, 1, 2] and prog.n == 3 and prog.total == 3
    with tlog.profile_trace(None):
        pass
    with tlog.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
