"""The port's backward plain versions (vcrnet_tpu_torch/ops/*_bwd_ref and
the LayerNorm backward) against the JAX package's custom VJPs, whose Pallas
kernels run in interpret mode, on the same seeded numpy inputs at small
shapes; and the port's autograd Functions on the CPU route against
gradcheck (smooth functions, f64) or autograd of the plain forward
(max-reductions, tie-free inputs).

The Pallas kNN kernels run with exact-f32 selection and exact gathers
(packed_select=False, int8_gather=False), the rule the port follows.
Tolerances: winners exact; f32 gradients 1e-5 absolute (sums in another
order of values of order one); bf16 attention one bf16 ulp of the largest
gradient (ds is rounded to bf16 at f32 values that differ in the last
bits)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.ops.layernorm import layer_norm_torch as j_layer_norm
from vcrnet_tpu.ops.pallas_attention import _bwd_fused
from vcrnet_tpu.ops.pallas_edgeconv import (
    _fused_edge_conv_fwd_impl, _fused_edge_conv_vjp, _fused_gather_max_impl,
    fused_knn_gather_max as j_knn_gather_max,
)
from vcrnet_tpu.ops.pallas_vcp import soft_correspondence_vjp as j_soft_correspondence
from vcrnet_tpu_torch.ops import attention, edgeconv, vcp
from vcrnet_tpu_torch.ops.graph import gather_neighbors
from vcrnet_tpu_torch.ops.layernorm import layer_norm_torch

B, N, F, K = 2, 64, 32, 8


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ties", [False, True])
def test_gather_max_bwd_ref_matches_pallas_vjp(ties):
    rng = np.random.RandomState(20 + ties)
    x = _rand(rng, B, N, 3)
    # ties: values on three levels, so most channels tie among neighbours
    values = rng.randint(0, 3, (B, N, F)).astype(np.float32) if ties else _rand(rng, B, N, F)
    ct = _rand(rng, B, N, F)
    _, _, j_win = _fused_gather_max_impl(
        jnp.asarray(x), jnp.asarray(values), K, None, True,
        packed_select=False, int8_gather=False, emit_winners=True,
    )
    _, vjp = jax.vjp(
        lambda v: j_knn_gather_max(jnp.asarray(x), v, K, interpret=True,
                                   packed_select=False, int8_gather=False),
        jnp.asarray(values),
    )
    (j_dv,) = vjp(jnp.asarray(ct))
    _, idx, win = edgeconv.fused_knn_gather_max(_t(x), _t(values), K, winners=True)
    np.testing.assert_array_equal(win.numpy(), np.asarray(j_win))
    dv = edgeconv.gather_max_bwd(idx, win, _t(ct))
    np.testing.assert_allclose(dv.numpy(), np.asarray(j_dv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_edge_conv_bwd_ref_matches_pallas_vjp(slope):
    rng = np.random.RandomState(22)
    x = _rand(rng, B, N, 16)
    a, h = _rand(rng, B, N, F), _rand(rng, B, N, F)
    w2, b2 = _rand(rng, F, F, scale=F ** -0.5), _rand(rng, F, scale=0.1)
    ct1, ct2 = _rand(rng, B, N, F), _rand(rng, B, N, F)
    jx = jnp.asarray(x)
    _, _, _, j_win1, j_win2 = _fused_edge_conv_fwd_impl(
        *(jnp.asarray(v) for v in (x, a, h, w2, b2)), K, slope, None, True,
        packed_select=False, int8_gather=False, emit_winners=True,
    )
    _, vjp = jax.vjp(
        lambda a_, h_, w_, b_: _fused_edge_conv_vjp(jx, a_, h_, w_, b_, K, slope, None, True,
                                                    False, False),
        *(jnp.asarray(v) for v in (a, h, w2, b2)),
    )
    want = vjp((jnp.asarray(ct1), jnp.asarray(ct2)))
    _, x2, idx, win1, win2 = edgeconv.fused_edge_conv(
        *(_t(v) for v in (x, a, h, w2, b2)), k=K, negative_slope=slope, winners=True
    )
    np.testing.assert_array_equal(win1.numpy(), np.asarray(j_win1))
    np.testing.assert_array_equal(win2.numpy(), np.asarray(j_win2))
    got = edgeconv.edge_conv_bwd(idx, win1, win2, _t(a), _t(h), _t(w2), x2, _t(ct1), _t(ct2),
                                 slope)
    for g, w in zip(got, want):  # da, dh, dW2, db2
        # dW2 and db2 sum over all B*N*K edges: values of order ten
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5 * max(1.0, np.abs(w).max()),
                                   rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_ref_matches_pallas(dtype):
    rng = np.random.RandomState(23)
    q, k, v, do = (_rand(rng, B, 128, 256) for _ in range(4))
    scale, heads = 128 ** -0.5, 2
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (_t(a).to(tdt) for a in (q, k, v, do))
    o, lse = attention.flash_mha_packed(tq, tk, tv, scale, heads, return_lse=True)
    got = attention.flash_bwd(tq, tk, tv, o, lse, tdo, scale, heads)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def split(t):
        return jnp.asarray(t.float().numpy(), jdt).reshape(B, 128, heads, 128).transpose(0, 2, 1, 3)

    want = _bwd_fused(*(split(t) for t in (tq, tk, tv, o, tdo)), scale, 128, interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w.transpose(0, 2, 1, 3).reshape(B, 128, 256).astype(jnp.float32))
        tol = 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol, rtol=0)


def test_vcp_bwd_ref_matches_pallas_vjp():
    rng = np.random.RandomState(24)
    se, te = _rand(rng, B, N, 32, scale=0.3), _rand(rng, B, N, 32, scale=0.3)
    tgt = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    dcorr = _rand(rng, B, N, 3)
    _, vjp = jax.vjp(lambda a, b, c: j_soft_correspondence(a, b, c, True),
                     *(jnp.asarray(t) for t in (se, te, tgt)))
    want = vjp(jnp.asarray(dcorr))
    corr, lse = vcp.streaming_soft_correspondence(_t(se), _t(te), _t(tgt), return_lse=True)
    got = vcp.vcp_bwd(_t(se), _t(te), _t(tgt), corr, lse, _t(dcorr))
    for g, w in zip(got, want):  # d_src_emb, d_tgt_emb, d_tgt
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_vcp_vjp_refuses_shapes_its_kernel_does_not_take():
    # the gate holds where a gradient is wanted: E % 16 != 0 is refused (a
    # ragged length, 48 rows, is taken since the backward kernels' ragged
    # last tiles)
    e = torch.zeros(1, 48, 24, requires_grad=True)
    with pytest.raises(ValueError, match="does not take"):
        vcp.soft_correspondence_vjp(e, e, torch.zeros(1, 48, 3))
    assert vcp.streaming_vjp_supported(48, 48, 16)
    assert vcp.streaming_vjp_supported(1024, 1024, 512)
    assert not vcp.streaming_vjp_supported(1024, 1024, 1024)


def test_attention_function_gradcheck():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 6, 8, generator=g, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: attention.attention(a, b, c, 0.5, 2),
                                    (q, k, v))


def test_soft_correspondence_function_gradcheck():
    g = torch.Generator().manual_seed(1)
    se, te = (torch.randn(1, 64, 16, generator=g, dtype=torch.float64) * 0.3 for _ in range(2))
    tgt = torch.rand(1, 64, 3, generator=g, dtype=torch.float64)
    inputs = tuple(t.requires_grad_() for t in (se, te, tgt))
    assert torch.autograd.gradcheck(vcp.soft_correspondence_vjp, inputs)


def test_knn_gather_max_function_matches_autograd_of_plain_forward():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, N, 3, generator=g)
    values = torch.randn(B, N, F, generator=g, requires_grad=True)
    ct = torch.randn(B, N, F, generator=g)
    out, idx = edgeconv.knn_gather_max(x, values, K)
    (got,) = torch.autograd.grad(out, values, ct)
    want_out = gather_neighbors(values, idx).amax(dim=2)  # continuous values: no ties
    (want,) = torch.autograd.grad(want_out, values, ct)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_edge_conv_function_matches_autograd_of_plain_forward(slope):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, N, 16, generator=g)
    a, h = (torch.randn(B, N, F, generator=g, requires_grad=True) for _ in range(2))
    w2 = (torch.randn(F, F, generator=g) * F ** -0.5).requires_grad_()
    b2 = (torch.randn(F, generator=g) * 0.1).requires_grad_()
    ct1, ct2 = torch.randn(B, N, F, generator=g), torch.randn(B, N, F, generator=g)
    x1, x2, idx = edgeconv.edge_conv(x, a, h, w2, b2, K, slope)
    got = torch.autograd.grad((x1, x2), (a, h, w2, b2), (ct1, ct2))

    def act(t):
        return torch.where(t >= 0, t, t * slope)

    z = act(gather_neighbors(a, idx) + h[:, :, None])
    # with slope 0 many z are exactly 0: a tie, but act' = 0 there on both routes
    want = torch.autograd.grad(
        (z.amax(dim=2), act(z @ w2 + b2).amax(dim=2)), (a, h, w2, b2), (ct1, ct2)
    )
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, atol=1e-5, rtol=1e-5)


def test_layer_norm_backward_matches_jax_vjp_with_a_zero_variance_row():
    rng = np.random.RandomState(25)
    x = _rand(rng, 3, 5, 16)
    # a zero-variance row (its f32 mean is exact, its std 0): autodiff
    # through std gives NaN there
    x[1, 2] = 0.75
    a, b = _rand(rng, 16) + 1.0, _rand(rng, 16)
    dy = _rand(rng, 3, 5, 16)
    _, vjp = jax.vjp(lambda x_, a_, b_: j_layer_norm(x_, a_, b_, 1e-6),
                     *(jnp.asarray(t) for t in (x, a, b)))
    want = vjp(jnp.asarray(dy))
    tx, ta, tb = (_t(t).requires_grad_() for t in (x, a, b))
    got = torch.autograd.grad(layer_norm_torch(tx, ta, tb), (tx, ta, tb), _t(dy))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_layer_norm_function_gradcheck():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 6, generator=g, dtype=torch.float64, requires_grad=True)
    a = torch.randn(6, generator=g, dtype=torch.float64, requires_grad=True)
    b = torch.randn(6, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x_, a_, b_: layer_norm_torch(x_, a_, b_, 1e-6),
                                    (x, a, b))
