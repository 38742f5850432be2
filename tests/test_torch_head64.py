"""The port at a head width of 64 against the JAX package: the configurations
``--n_heads 8`` (d 512) and ``--emb_dims 256`` (4 heads) run the attention
kernels' dk = 64 instances on the card; here, at narrow width (emb 128 with
2 heads, and emb 256 with 4: dk = 64 both), their plain versions and the
kernel route's wrappers (which run the plain versions on a CPU tensor) are
held against the JAX model on the same seeded numpy clouds and the same
flax parameters (bridged by from_jax_params):

* ``vcrnet_iter`` at iter = 3: R and t within 1e-4 in f32 and 1e-2 in bf16
  (the tolerances of test_torch_slice.py);
* partial mode, the decoder's re-mask streamed through
  ``softmax_colmass`` by a small ``stream_above`` on the port's side (the
  JAX package streams above 2048 keys only: the same function, exp(-1e9)
  is 0), within 1e-4 in f32;
* one training step's loss and gradients against JAX's jitted ones (the
  tolerances of test_torch_train_step.py);
* the gates: dk = 64 and 128 taken (and 256 by the forward kernels), 16,
  32 and 512 refused with a message that names the gate, and a refused
  shape on a CUDA tensor raises before anything is built, with no plain
  version in its place.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch import ops
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.ops import _build, attention, colmass
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

N = 64
# (emb_dims, n_heads): dk = 64 both
WIDTHS = [(128, 2), (256, 4)]
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _narrow(emb, heads, **kw):
    return dict(num_points=kw.pop("num_points", N), emb_dims=emb, ff_dims=128, n_heads=heads,
                **kw)


def _models(dtype, emb, heads, **kw):
    fields = dict(_narrow(emb, heads, **kw), compute_dtype=dtype)
    jmodel = JVCRNet(cfg=JConfig(**fields))
    cloud = np.zeros((1, jmodel.cfg.n_cropped, 3), np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), cloud, cloud)
    weights = from_jax_params(jax.device_get(variables["params"]))
    models = []
    for use_kernels in (False, True):
        model = VCRNet(Config(**fields), device="cpu", use_kernels=use_kernels)
        model.load_state_dict(weights)
        models.append(model.eval())
    return jmodel, variables, models


def _close(got, want, atol):
    for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
        np.testing.assert_allclose(got[i].float().numpy(), np.asarray(want[i]), atol=atol, rtol=0)


@pytest.mark.parametrize("emb,heads", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcrnet_iter_matches_jax(dtype, emb, heads):
    """Both routes of the port (plain, and the kernel route's wrappers on the
    CPU) against the JAX model at iter = 3."""
    jmodel, variables, models = _models(dtype, emb, heads)
    assert emb // heads == 64
    data = shapes_eval_set(2, num_points=N, cloud_points=2 * N, seed=3)
    src, tgt = data["src"], data["tgt"]
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), 3, model=jmodel)
    for model in models:
        with torch.no_grad():
            got = vcrnet_iter(model, torch.from_numpy(src), torch.from_numpy(tgt), 3)
        _close(got, want, TOL[dtype])


def test_partial_streaming_remask_matches_jax(monkeypatch):
    """num_points 171 crops to 128 points, a shape the streaming re-mask
    takes; with stream_above = 64 the port's kernel route streams its
    re-mask through the column masses (their plain version on the CPU,
    counted here), the JAX model writes its scores out."""
    streamed = []
    real = colmass.softmax_colmass_ref

    def spy(*args):
        streamed.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(colmass, "softmax_colmass_ref", spy)
    jmodel, variables, models = _models("float32", 128, 2, num_points=171, partial=True,
                                        overlap=0.575)
    assert models[1].cfg.n_cropped == 128
    data = shapes_eval_set(2, num_points=171, cloud_points=256, seed=3, partial=True)
    src, tgt = data["src"], data["tgt"]
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), 3, model=jmodel)
    for model in models:
        remask = model.pointer.dec_layers[0].src_attn
        assert remask.remask
        remask.stream_above = 64
        streamed.clear()
        with torch.no_grad():
            got = vcrnet_iter(model, torch.from_numpy(src), torch.from_numpy(tgt), 3)
        # the kernel route streams (the decoder runs twice an iteration, q
        # [2, 128, 128]: two heads of 64); the plain route writes its
        # scores out
        assert streamed == ([(2, 128, 128)] * 6 if model.use_kernels else [])
        _close(got, want, TOL["float32"])


def _batch(cfg):
    np.random.seed(7)  # train items draw from the global generator
    loader = JLoader(JSyntheticDataset(cfg, "train", n_items=4, cloud_points=128,
                                       kind="shapes"), 4)
    batch = next(iter(loader))
    batch.pop("label")
    return batch


def test_train_step_grads_match_jax():
    """One step's loss and every gradient of the kernel route (its autograd
    Functions with plain backwards on the CPU) against the JAX Trainer's
    jitted value_and_grad, f32, at emb 128 with 2 heads."""
    fields = _narrow(*WIDTHS[0], batch_size=4, test_batch_size=4)
    jtr = JTrainer(JConfig(**fields), mesh=make_mesh(1))
    batch = _batch(jtr.cfg)
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    tr = Trainer(Config(**fields), device="cpu", use_kernels=True)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jtr._apply({"params": params}, jb["src"], jb["tgt"], train=True)
        return jtr._vcrnet_loss_and_sums(out, jb, jb["valid"])

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    got_loss, _ = tr.compute_grads(batch)
    np.testing.assert_allclose(float(got_loss), float(j_loss), rtol=1e-4)
    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)


GATES = [attention.flash_packed_supported, attention.flash_bwd_supported,
         colmass.colmass_supported]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.__name__)
def test_the_gates_take_dk_64_and_128(gate):
    for d, heads in ((512, 8), (256, 4), (128, 2), (512, 4), (256, 2)):
        for n in (64, 885, 1000, 1024, 3072):
            assert gate(n, n, d, heads), (d, heads, n)
    for d, heads in ((512, 32), (512, 16), (2048, 4), (256, 8), (384, 4), (512, 3)):
        assert not gate(1024, 1024, d, heads), (d, heads)
    # dk = 256 (--emb_dims 1024): the forward kernels take it, the backward not
    assert gate(1024, 1024, 1024, 4) is (gate is not attention.flash_bwd_supported)
    assert attention.HEAD_DIMS == (64, 128, 256) and attention.BWD_HEAD_DIMS == (64, 128)


def _fake_card(monkeypatch, module):
    """Route as a CUDA tensor would; building the extension fails the test."""
    def no_build():
        raise AssertionError("a refused shape reached the extension")

    monkeypatch.setattr(module, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", no_build)


@pytest.mark.parametrize("dk", [16, 32, 512])
@pytest.mark.parametrize("kernel", ["flash_packed", "flash_bwd", "softmax_colmass"])
def test_a_refused_head_dim_raises_on_the_card(monkeypatch, kernel, dk):
    heads = 4
    t = torch.zeros(1, 128, heads * dk, dtype=torch.bfloat16)
    if kernel == "softmax_colmass":
        _fake_card(monkeypatch, colmass)
        monkeypatch.setattr(colmass, "softmax_colmass_ref", None)  # no plain version there
        with pytest.raises(ValueError,
                           match=r"takes dk in \(64, 128, 256\) \(colmass_supported\)"):
            colmass.softmax_colmass(t, t, 0.1, heads)
        return
    _fake_card(monkeypatch, attention)
    monkeypatch.setattr(attention, "flash_mha_packed_ref", None)
    monkeypatch.setattr(attention, "flash_mha_packed_bwd_ref", None)
    name = "flash_mha_packed" if kernel == "flash_packed" else kernel
    dims = r"\(64, 128, 256\)" if kernel == "flash_packed" else r"\(64, 128\)"
    with pytest.raises(ValueError, match=rf"{name} kernel does not take .* heads={heads} "
                                         rf"\({kernel}_supported: dk in {dims}\)"):
        if kernel == "flash_packed":
            attention.flash_mha_packed(t, t, t, 0.1, heads)
        else:
            lse = torch.zeros(1, heads, 128)
            attention.flash_bwd(t, t, t, t, lse, t, 0.1, heads)


def test_dk64_reaches_the_extension_and_is_counted(monkeypatch):
    """On the card route a dk = 64 call goes to the extension with its packed
    width (the instance is chosen there by d_model / n_heads) and counts in
    ``.launches`` and ``.launches_dk64``; a dk = 128 call in ``.launches``
    alone."""
    calls = []

    class Ext:
        @staticmethod
        def flash_packed(q, k, v, out, lse, nk_valid, n_heads, sm_scale):
            calls.append(("flash_packed", q.shape[-1] // n_heads))

        @staticmethod
        def flash_bwd(q, k, v, o, do, lse, delta, dq, dk, dv, n_heads, sm_scale):
            calls.append(("flash_bwd", q.shape[-1] // n_heads))

        @staticmethod
        def softmax_colmass(q, k, lse, out, n_heads, sm_scale):
            calls.append(("softmax_colmass", q.shape[-1] // n_heads))

    for module in (attention, colmass):
        monkeypatch.setattr(module, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", lambda: Ext)
    ops.reset_launch_counts()
    for heads in (8, 4):  # dk = 64, then 128
        t = torch.zeros(2, 100, 512, dtype=torch.bfloat16)
        o, lse = attention.flash_mha_packed(t, t, t, 0.125, heads, return_lse=True)
        attention.flash_bwd(t, t, t, o, lse, t, 0.125, heads)
        colmass.softmax_colmass(t, t, 0.125, heads)
    assert calls == [(k, dk) for dk in (64, 128)
                     for k in ("flash_packed", "flash_bwd", "softmax_colmass")]
    counts = ops.launch_counts()
    assert [counts[k] for k in ops.HEAD64_KERNELS] == [2, 2, 2]
    assert ops.launch_counts_dk64() == {f"{k}_dk64": 1 for k in ops.HEAD64_KERNELS}
    ops.reset_launch_counts()
    assert ops.launch_counts_dk64() == {f"{k}_dk64": 0 for k in ops.HEAD64_KERNELS}
