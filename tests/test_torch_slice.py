"""The port's main path as a whole against the JAX package: VCRNet,
vcrnet_iter and Registrar on the same seeded numpy clouds and the same
flax parameters (bridged by from_jax_params). Tolerances on R and t:
f32 1e-4, bf16 1e-2; the committed checkpoint at full width agrees to
0.01 degree of rotation in f32."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.utils.params import from_jax_params, read_msgpack

N = 64
NARROW = dict(num_points=N, emb_dims=64, ff_dims=128, n_heads=2)
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "pretrained",
                          "vcrnet_shapes_best.msgpack")


def _pair(seed, b, n=N):
    data = shapes_eval_set(b, num_points=n, cloud_points=2 * n, seed=seed)
    return data["src"], data["tgt"]


def _models(dtype, use_kernels=False, **kw):
    jmodel = JVCRNet(cfg=JConfig(compute_dtype=dtype, **NARROW, **kw))
    src, _ = _pair(0, 1)
    variables = jmodel.init(jax.random.PRNGKey(0), src, src)
    model = VCRNet(Config(compute_dtype=dtype, **NARROW, **kw), device="cpu",
                   use_kernels=use_kernels)
    model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    return jmodel, variables, model.eval()


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcrnet_forward_matches_jax(dtype, use_kernels):
    jmodel, variables, model = _models(dtype, use_kernels)
    src, tgt = _pair(1, 2)
    want = jmodel.apply(variables, src, tgt)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(tgt))
    for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
        _close(got[i], want[i], dtype)


def test_vcrnet_cycle_matches_jax():
    jmodel, variables, model = _models("float32", cycle=True)
    src, tgt = _pair(2, 2)
    want = jmodel.apply(variables, src, tgt)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(tgt))
    for i in (2, 3, 4, 5):
        _close(got[i], want[i], "float32")


@pytest.mark.parametrize("n_iter", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcrnet_iter_matches_jax(dtype, n_iter):
    jmodel, variables, model = _models(dtype)
    src, tgt = _pair(3, 2)
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), n_iter,
                         model=jmodel)
    with torch.no_grad():
        got = vcrnet_iter(model, torch.from_numpy(src), torch.from_numpy(tgt), n_iter)
    for i in (2, 3, 4, 5):
        _close(got[i], want[i], dtype)


def test_kernel_route_refuses_refinement_iterations():
    _, _, model = _models("bfloat16", use_kernels=True)
    src, tgt = (torch.from_numpy(a) for a in _pair(4, 1))
    with torch.no_grad():
        vcrnet_iter(model, src, tgt, 1)
        with pytest.raises(NotImplementedError, match="gather_max_from_idx"):
            vcrnet_iter(model, src, tgt, 2)


def _rot_deg(Ra, Rb):
    cos = (np.einsum("bij,bij->b", Ra, Rb) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def test_checkpoint_registrar_matches_jax_full_width():
    raw = read_msgpack(CHECKPOINT)
    jcfg = JConfig(num_points=512, iter=1)
    cfg = Config(num_points=512, iter=1)
    assert (cfg.emb_dims, cfg.ff_dims, cfg.n_heads) == (512, 1024, 4)
    src, tgt = _pair(5, 2, n=512)
    want = JRegistrar(jcfg, {"params": raw["params"]}, buckets=(2,)).register(src, tgt)
    reg = Registrar(cfg, from_jax_params(raw["params"]), buckets=(2,), device="cpu")
    got = reg.register(src, tgt)
    assert _rot_deg(got["R"], want["R"]).max() <= 0.01
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-4)


@pytest.fixture(scope="module")
def registrar():
    _, _, model = _models("float32")
    cfg = Config(**NARROW, iter=2)
    return Registrar(cfg, model.state_dict(), buckets=(2, 4), device="cpu")


def test_registrar_padding_never_contaminates(registrar):
    src, tgt = _pair(6, 3)
    batched = registrar.register(src, tgt)  # 3 pads to bucket 4
    assert batched["R"].shape == (3, 3, 3)
    for i in range(3):
        solo = registrar.register(src[i], tgt[i])  # one pair, bucket 2
        np.testing.assert_allclose(batched["R"][i], solo["R"], atol=1e-5)
        np.testing.assert_allclose(batched["t"][i], solo["t"], atol=1e-5)


def test_registrar_splits_above_top_bucket(registrar):
    src, tgt = _pair(7, 9)  # chunks of 4, 4, 1
    out = registrar.register(src, tgt)
    assert out["R"].shape == (9, 3, 3) and out["t_inv"].shape == (9, 3)
    np.testing.assert_allclose(
        np.einsum("bij,bjk->bik", out["R"], out["R_inv"]), np.broadcast_to(np.eye(3), (9, 3, 3)),
        atol=1e-5)


def test_registrar_subsamples_and_rejects_undersized(registrar):
    src, tgt = _pair(8, 1, n=N + 40)
    out = registrar.register(src, tgt)
    np.testing.assert_array_equal(out["R"], registrar.register(src, tgt)["R"])
    with pytest.raises(ValueError, match="needs >="):
        registrar.register(src[:, :N - 1], tgt[:, :N - 1])
