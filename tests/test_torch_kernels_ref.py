"""The port's plain kernel versions (vcrnet_tpu_torch/ops/*_ref) held
against the JAX package's Pallas kernels run in interpret mode, on the
same seeded numpy inputs, f32, small shapes. The Pallas kNN kernels run
with exact-f32 selection and exact gathers (packed_select=False,
int8_gather=False), the rule the port's kernels follow."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcrnet_tpu.ops.pallas_attention import _flash_packed_impl
from vcrnet_tpu.ops.pallas_edgeconv import (
    _fused_edge_conv_fwd_impl, _fused_gather_max_impl,
)
from vcrnet_tpu.ops.pallas_vcp import streaming_soft_correspondence
from vcrnet_tpu_torch.ops import attention, edgeconv, vcp

B, N, F, K = 2, 64, 32, 8


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("c", [3, 16])
def test_gather_max_ref_matches_pallas(c, deferred):
    rng = np.random.RandomState(c)
    x, values = _rand(rng, B, N, c), _rand(rng, B, N, F)
    j_out, j_idx = _fused_gather_max_impl(
        jnp.asarray(x), jnp.asarray(values), K, None, True,
        packed_select=False, int8_gather=False, deferred_gather=deferred,
    )
    out, idx = edgeconv.fused_knn_gather_max(torch.from_numpy(x), torch.from_numpy(values), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    # f32 max of gathered rows: exact up to the one-hot matmul's rounding
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5, rtol=0)


@pytest.mark.parametrize("slope", [0.0, 0.2])
@pytest.mark.parametrize("deferred", [False, True])
def test_edge_conv_ref_matches_pallas(deferred, slope):
    rng = np.random.RandomState(11)
    x = _rand(rng, B, N, 16)
    a, h = _rand(rng, B, N, F), _rand(rng, B, N, F)
    w2, b2 = _rand(rng, F, F, scale=F ** -0.5), _rand(rng, F, scale=0.1)
    j1, j2, j_idx = _fused_edge_conv_fwd_impl(
        *(jnp.asarray(v) for v in (x, a, h, w2, b2)), K, slope, None, True,
        packed_select=False, int8_gather=False, deferred_gather=deferred,
    )
    x1, x2, idx = edgeconv.fused_edge_conv(
        *(torch.from_numpy(v) for v in (x, a, h, w2, b2)), k=K, negative_slope=slope
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(x1.numpy(), np.asarray(j1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x2.numpy(), np.asarray(j2), atol=1e-5, rtol=0)


def test_edge_conv_ref_with_given_idx_matches_its_own_selection():
    rng = np.random.RandomState(12)
    x, a, h = (torch.from_numpy(_rand(rng, B, N, F)) for _ in range(3))
    w2, b2 = torch.from_numpy(_rand(rng, F, F)), torch.from_numpy(_rand(rng, F))
    x1, x2, idx = edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, K)
    y1, y2, _ = edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, K, idx=idx)
    assert torch.equal(x1, y1) and torch.equal(x2, y2)


def test_knn_ref_ties_go_to_smaller_column_and_skip_self():
    # integer coordinates on a line: many exact distance ties
    x3 = torch.zeros(1, 6, 3)
    x3[0, :, 0] = torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0, 2.0])
    _, idx = edgeconv.fused_knn_gather_max_ref(x3, torch.zeros(1, 6, 8), k=3)
    # point 2 has a duplicate (point 5): distance 0 first, then 1 and 3 tie
    assert idx[0, 2].tolist() == [5, 1, 3]
    assert idx[0, 0].tolist() == [1, 2, 5]
    assert all(i not in idx[0, i].tolist() for i in range(6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_packed_ref_matches_pallas(dtype):
    rng = np.random.RandomState(3)
    q, k, v = (_rand(rng, B, 128, 256) for _ in range(3))
    scale = 128 ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(
        _flash_packed_impl(*(jnp.asarray(t, jdt) for t in (q, k, v)), scale, 2, interpret=True)
    ).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = attention.flash_mha_packed(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)), scale, 2)
    # f32: summation order only; bf16: same rounding points, one bf16 ulp
    tol = 1e-4 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_vcp_ref_matches_pallas():
    rng = np.random.RandomState(5)
    se, te = _rand(rng, B, N, 32, scale=0.3), _rand(rng, B, N, 32, scale=0.3)
    tgt = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    want = np.asarray(streaming_soft_correspondence(
        jnp.asarray(se), jnp.asarray(te), jnp.asarray(tgt), interpret=True,
    ))
    got = vcp.streaming_soft_correspondence(*(torch.from_numpy(t) for t in (se, te, tgt)))
    # the Pallas kernel's hi/lo bf16 split of tgt costs ~2^-18 relative
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
