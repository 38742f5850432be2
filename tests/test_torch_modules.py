"""Modules of the PyTorch port (vcrnet_tpu_torch) against their JAX
counterparts on the same seeded numpy inputs and the same random flax
parameters, bridged by from_jax_params. Narrow widths (emb 64, ff 128,
2 heads). Tolerances: f32 atol 1e-4; bf16 atol 2e-2 plus rtol 2e-2, about
five bf16 ulps (2^-8 of the value each): the two frameworks round the
bf16 intermediates at different points, and a pointer pass chains a dozen
of them."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu import geometry as jgeo
from vcrnet_tpu.data.synthetic import SyntheticDataset
from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models.embeddings import LPDNet as JLPDNet
from vcrnet_tpu.models.transformer import TransformerPointer as JPointer
from vcrnet_tpu.ops import graph as jgraph
from vcrnet_tpu.ops.layernorm import layer_norm_torch as j_layer_norm
from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.models.embeddings import LPDNet
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.ops import graph
from vcrnet_tpu_torch.ops.layernorm import layer_norm_torch
from vcrnet_tpu_torch.utils.params import from_jax_params

N = 64
TOL = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rotations(rng, b):
    ang = rng.uniform(0, np.pi / 4, (b, 3))
    return np.asarray(jgeo.euler_to_mat_zyx(jnp.asarray(ang)), np.float32)


def test_procrustes_matches_jax():
    rng = np.random.RandomState(0)
    src = rng.rand(3, N, 3).astype(np.float32) - 0.5
    corr = np.einsum("bij,bnj->bni", _rotations(rng, 3), src) + 0.1
    corr += 0.01 * rng.randn(*corr.shape).astype(np.float32)
    w = rng.rand(3, N).astype(np.float32)
    for weights in (None, w):
        R_j, t_j = jgeo.procrustes(jnp.asarray(src), jnp.asarray(corr),
                                   None if weights is None else jnp.asarray(weights))
        R, t = geometry.procrustes(_t(src), _t(corr), None if weights is None else _t(weights))
        np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-5)
        assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)


def test_procrustes_reflection_is_flipped():
    # a mirrored target: the unconstrained optimum is a reflection
    rng = np.random.RandomState(1)
    src = rng.rand(2, N, 3).astype(np.float32) - 0.5
    corr = src * np.array([1.0, 1.0, -1.0], np.float32)
    R, _ = geometry.procrustes(_t(src), _t(corr))
    R_j, _ = jgeo.procrustes(jnp.asarray(src), jnp.asarray(corr))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), atol=1e-5)
    assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)


def test_transform_compose_invert_match_jax():
    rng = np.random.RandomState(2)
    R1, R2 = _rotations(rng, 4), _rotations(rng, 4)
    t1, t2 = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    p = rng.randn(4, N, 3).astype(np.float32)
    np.testing.assert_allclose(
        geometry.transform_points(_t(p), _t(R1), _t(t1)).numpy(),
        np.asarray(jgeo.transform_points(p, R1, t1)), atol=1e-5)
    for got, want in zip(geometry.compose_transforms(_t(R2), _t(t2), _t(R1), _t(t1)),
                         jgeo.compose_transforms(R2, t2, R1, t1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for got, want in zip(geometry.invert_transform(_t(R1), _t(t1)), jgeo.invert_transform(R1, t1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        geometry.mat_to_euler_zyx(_t(R1), degrees=True).numpy(),
        np.asarray(jgeo.mat_to_euler_zyx(R1, degrees=True)), atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_matches_jax_including_ties(dtype):
    rng = np.random.RandomState(3)
    # integer grid coordinates: exact distance ties everywhere
    x = rng.randint(0, 4, (2, N, 3)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jgraph.knn(jnp.asarray(x, jdt), 8, method="exact"))
    got = graph.knn(_t(x).to(getattr(torch, dtype)), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pairwise_sqdist_matches_jax():
    rng = np.random.RandomState(4)
    x, y = rng.randn(2, N, 16).astype(np.float32), rng.randn(2, 32, 16).astype(np.float32)
    np.testing.assert_allclose(graph.pairwise_sqdist(_t(x), _t(y)).numpy(),
                               np.asarray(jgraph.pairwise_sqdist(x, y)), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, N, 64) * 3 + 1).astype(np.float32)
    a, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(j_layer_norm(jnp.asarray(x, jdt), a, b)).astype(np.float32)
    got = layer_norm_torch(_t(x).to(getattr(torch, dtype)), _t(a), _t(b))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def _jdtype(dtype):
    return (jnp.bfloat16, jax.lax.Precision.DEFAULT) if dtype == "bfloat16" else (
        None, jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lpdnet_matches_jax(dtype, fused):
    rng = np.random.RandomState(6)
    x = (rng.rand(2, N, 3) - 0.5).astype(np.float32)
    jdt, prec = _jdtype(dtype)
    jnet = JLPDNet(emb_dims=64, dtype=jdt, precision=prec)
    variables = jnet.init(jax.random.PRNGKey(0), x)
    net = LPDNet(emb_dims=64, dtype=None if jdt is None else torch.bfloat16)
    net.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    with torch.no_grad():
        emb, sp_idx, ft_idx = net(_t(x), fused=fused)
    # the port's own selections fed to JAX isolate the arithmetic from
    # near-tie flips; the fused route masks the diagonal where the plain
    # route drops column 0, which differs only on duplicate points
    want = jnet.apply(variables, x, spatial_idx=jnp.asarray(sp_idx.numpy()),
                      feature_idx=jnp.asarray(ft_idx.numpy()))
    np.testing.assert_allclose(emb.float().numpy(), np.asarray(want).astype(np.float32),
                               **TOL[dtype])
    if dtype == "float32":  # no near ties at f32 on this input
        _, inter = jnet.apply(variables, x, mutable=["intermediates"])
        inter = inter["intermediates"]
        np.testing.assert_array_equal(sp_idx.numpy(), np.asarray(inter["spatial_idx"][0]))
        np.testing.assert_array_equal(ft_idx.numpy(), np.asarray(inter["feature_idx"][0]))


def test_lpdnet_plain_route_reuses_given_spatial_idx():
    rng = np.random.RandomState(7)
    x = _t((rng.rand(2, N, 3) - 0.5).astype(np.float32))
    net = LPDNet(emb_dims=64)
    with torch.no_grad():
        emb, sp_idx, _ = net(x)
        emb2, sp_idx2, _ = net(x, spatial_idx=sp_idx)
        with pytest.raises(NotImplementedError, match="gather_max_from_idx"):
            net(x, spatial_idx=sp_idx, fused=True)
    assert sp_idx2 is sp_idx
    assert torch.equal(emb, emb2)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_pointer_matches_jax(dtype, flash):
    rng = np.random.RandomState(8)
    # dk = 128 keeps the packed-head route's shapes valid
    d, heads = 256, 2
    src, tgt = ((rng.randn(2, N, d) * 0.5).astype(np.float32) for _ in range(2))
    jdt, prec = _jdtype(dtype)
    jp = JPointer(emb_dims=d, n_heads=heads, ff_dims=128, dtype=jdt, precision=prec)
    variables = jp.init(jax.random.PRNGKey(1), src, tgt)
    p = TransformerPointer(d, 1, heads, 128, dtype=None if jdt is None else torch.bfloat16,
                           flash=flash)
    p.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    tdt = torch.float32 if jdt is None else torch.bfloat16
    xs, xt = _t(src).to(tdt), _t(tgt).to(tdt)
    want = jp.apply(variables, jnp.asarray(src, jdt or jnp.float32),
                    jnp.asarray(tgt, jdt or jnp.float32))
    with torch.no_grad():
        got = p(xs, xt)
        memory = p.encode_memory(xt)
        cached = p(xs, xt, tgt_memory=memory)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w).astype(np.float32),
                                   **TOL[dtype])
    for g, c in zip(got, cached):
        assert torch.equal(g, c)
    np.testing.assert_allclose(
        memory.float().numpy(),
        np.asarray(jp.apply(variables, jnp.asarray(tgt, jdt or jnp.float32),
                            method=JPointer.encode_memory)).astype(np.float32),
        **TOL[dtype])


def test_shapes_eval_set_matches_jax_dataset():
    cfg = JConfig(num_points=256)
    ds = SyntheticDataset(cfg, "test", n_items=3, cloud_points=512, kind="shapes")
    got = shapes_eval_set(3, num_points=256, cloud_points=512)
    for i in range(3):
        pair = ds[i]
        np.testing.assert_array_equal(got["src"][i], pair.src)
        np.testing.assert_array_equal(got["tgt"][i], pair.tgt)
        np.testing.assert_array_equal(got["R_ab"][i], pair.R_ab)
        np.testing.assert_array_equal(got["t_ab"][i], pair.t_ab)
        np.testing.assert_array_equal(got["euler_ab"][i], pair.euler_ab)
