"""The eval protocol of the PyTorch port against the JAX package: the
refinement loop with its caches (given kNN selections, reuse of the feature
graph, the subsample) and partial-overlap registration (crop, key re-mask,
two-stage head), on the same seeded numpy inputs and the same flax
parameters (bridged by from_jax_params). Small sizes (N <= 171, emb 64 or
256, 1 block). The Pallas kernels run in interpret mode with exact gathers
(int8_gather=False), the rule the port's kernels follow.

Hard selections (top-k over masses and confidences) turn a last-bit
difference between XLA's and PyTorch's sums into another point set, so the
selecting stages are held in f32 on seeded inputs whose gap at the cut is
checked to be far above the rounding error, and in bf16 by the share of
equal indices."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data.augment import make_pair_from_cloud as j_make_pair, nn_crop as j_nn_crop
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models import heads as jheads
from vcrnet_tpu.models.embeddings import LPDNet as JLPDNet
from vcrnet_tpu.models.transformer import (
    MultiHeadAttention as JMultiHeadAttention, TransformerPointer as JPointer,
    _remask_topk_keys as j_remask_topk_keys,
)
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.ops import pallas_colmass, pallas_edgeconv
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import make_pair_from_cloud, nn_crop
from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset, shapes_eval_set
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.models._common import dense
from vcrnet_tpu_torch.models.embeddings import LPDNet
from vcrnet_tpu_torch.models.heads import vcp_top_k_partial
from vcrnet_tpu_torch.models.transformer import (
    MultiHeadAttention, TransformerPointer, _remask_topk_keys,
)
from vcrnet_tpu_torch.ops import attention, colmass, edgeconv
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.train.engine import init_like_jax
from vcrnet_tpu_torch.utils.params import from_jax_params, read_msgpack

B, N, F, K = 2, 64, 32, 8
NARROW = dict(num_points=N, emb_dims=64, ff_dims=128, n_heads=2)
PARTIAL = dict(partial=True, overlap=0.575)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _values(rng, ties):
    """[B, N, F] f32; with ``ties`` small integers, so that most maxima are
    reached by several neighbours."""
    if ties:
        return rng.randint(0, 3, (B, N, F)).astype(np.float32)
    return _rand(rng, B, N, F)


def _idx(rng):
    return rng.randint(0, N, (B, N, K)).astype(np.int32)


# ---------------------------------------------------------------------------
# plain versions of the new kernels against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
def test_gather_max_from_idx_ref_matches_pallas(ties):
    rng = np.random.RandomState(0)
    idx, values = _idx(rng), _values(rng, ties)
    want = pallas_edgeconv.gather_max_from_idx(jnp.asarray(idx), jnp.asarray(values),
                                               interpret=True, int8_gather=False)
    got = edgeconv.gather_max_from_idx(_t(idx), _t(values))
    ref = edgeconv.gather_max_from_idx_ref(_t(idx), _t(values))
    assert torch.equal(got, ref)
    # a max of gathered f32 rows: exact up to the one-hot matmul's rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ties", [False, True])
def test_gather_max_from_idx_backward_matches_pallas_vjp(ties):
    rng = np.random.RandomState(1)
    idx, values, ct = _idx(rng), _values(rng, ties), _rand(rng, B, N, F)
    _, vjp = jax.vjp(
        lambda v: pallas_edgeconv.gather_max_from_idx(jnp.asarray(idx), v, interpret=True),
        jnp.asarray(values))
    (want,) = vjp(jnp.asarray(ct))
    v = _t(values).requires_grad_()
    edgeconv.gather_max_from_idx(_t(idx), v).backward(_t(ct))
    # the first neighbour reaching the max takes the whole gradient on both
    # sides; sums of a few f32 terms in another order
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if ties:  # the routing is by first winner, not an even split among the tied
        out, win = edgeconv.fused_gather_max_from_idx(_t(idx), _t(values), winners=True)
        gathered = _t(values)[torch.arange(B)[:, None, None], _t(idx).long()]  # [B, N, K, F]
        first = (gathered == out[:, :, None]).float().argmax(dim=2)
        assert torch.equal(win.long(), first)
        assert ((gathered == out[:, :, None]).sum(2) > 1).float().mean() > 0.5


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_edge_conv_from_idx_ref_matches_pallas(slope):
    rng = np.random.RandomState(2)
    idx = _idx(rng)
    a, h = _rand(rng, B, N, F), _rand(rng, B, N, F)
    w2, b2 = _rand(rng, F, F, scale=F ** -0.5), _rand(rng, F, scale=0.1)
    j1, j2 = pallas_edgeconv.edge_conv_from_idx(
        *(jnp.asarray(v) for v in (idx, a, h, w2, b2)), negative_slope=slope,
        interpret=True, int8_gather=False)
    with torch.no_grad():
        x1, x2 = edgeconv.edge_conv_from_idx(*(_t(v) for v in (idx, a, h, w2, b2)),
                                             negative_slope=slope)
    # f32 throughout: summation order of the F-long products only
    np.testing.assert_allclose(x1.numpy(), np.asarray(j1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x2.numpy(), np.asarray(j2), atol=1e-5, rtol=0)


def test_edge_conv_from_idx_refuses_a_gradient():
    rng = np.random.RandomState(3)
    idx, a, h = _t(_idx(rng)), _t(_rand(rng, B, N, F)), _t(_rand(rng, B, N, F))
    w2, b2 = _t(_rand(rng, F, F)), _t(_rand(rng, F))
    edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)  # nothing asks for a gradient
    with pytest.raises(RuntimeError, match="no backward"):
        edgeconv.edge_conv_from_idx(idx, a.requires_grad_(), h, w2, b2)


def test_from_idx_plain_versions_repeat_the_fused_ones_on_their_idx():
    rng = np.random.RandomState(4)
    x = _t(_rand(rng, B, N, 16))
    a, h = _t(_rand(rng, B, N, F)), _t(_rand(rng, B, N, F))
    w2, b2 = _t(_rand(rng, F, F)), _t(_rand(rng, F))
    out, idx = edgeconv.fused_knn_gather_max(x[..., :3].contiguous(), a, K)
    assert torch.equal(edgeconv.gather_max_from_idx(idx, a), out)
    x1, x2, idx = edgeconv.fused_edge_conv(x, a, h, w2, b2, K, negative_slope=0.2)
    y1, y2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2, negative_slope=0.2)
    assert torch.equal(x1, y1) and torch.equal(x2, y2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_colmass_ref_matches_pallas(dtype):
    rng = np.random.RandomState(5)
    nq, nk, heads, dk = 128, 256, 2, 128
    q, k = _rand(rng, B, nq, heads * dk), _rand(rng, B, nk, heads * dk)
    scale = dk ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def merged(x):  # packed [B, N, H*dk] -> the JAX layout [B*H, N, dk]
        return jnp.asarray(x, jdt).reshape(B, -1, heads, dk).transpose(0, 2, 1, 3).reshape(
            B * heads, -1, dk)

    want = np.asarray(pallas_colmass.softmax_colmass(merged(q), merged(k), scale,
                                                     interpret=True)).reshape(B, heads, nk)
    tdt = getattr(torch, dtype)
    got = colmass.softmax_colmass(_t(q).to(tdt), _t(k).to(tdt), scale, heads)
    assert got.shape == (B, heads, nk) and got.dtype == torch.float32
    # masses are sums of 128 probabilities around 0.5: f32 summation order
    np.testing.assert_allclose(got.numpy(), want, atol=0, rtol=1e-4)
    np.testing.assert_allclose(got.sum(-1).numpy(), np.full((B, heads), nq), rtol=1e-5)


@pytest.mark.parametrize("entry", ["ref", "attention"])
def test_attention_valid_key_count_matches_unpadded_keys(entry):
    rng = np.random.RandomState(6)
    nq, nk, d, heads = 64, 96, 256, 2
    q, k, v = _t(_rand(rng, B, nq, d)), _t(_rand(rng, B, nk, d)), _t(_rand(rng, B, nk, d))
    scale = 128 ** -0.5
    want = attention.flash_mha_packed_ref(q, k, v, scale, heads)
    if entry == "ref":
        # garbage (finite) rows behind the count must not matter, zeros must
        pad = _t(_rand(rng, B, 32, d))
        got, lse = attention.flash_mha_packed(q, torch.cat([k, pad], 1),
                                              torch.cat([v, torch.zeros_like(pad)], 1), scale,
                                              heads, return_lse=True, nk_valid=nk)
        _, want_lse = attention.flash_mha_packed_ref(q, k, v, scale, heads, return_lse=True)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6)
    else:  # the entry point hands the 96 keys over as they are (no padding)
        got = attention.attention(q, k, v, scale, heads)
    # the same f32 arithmetic over the same 96 keys
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_attention_under_a_gradient_takes_no_valid_key_count():
    # flash_bwd knows no count: under a gradient nothing is padded (the
    # backward kernels take 96 keys as they are, as the plain versions do);
    # without one nothing is padded either: the forward kernel masks the
    # keys past a ragged count itself
    rng = np.random.RandomState(7)
    q, k = _t(_rand(rng, 1, 64, 256)).requires_grad_(), _t(_rand(rng, 1, 96, 256))
    calls = []
    real = attention.flash_mha_packed

    def spy(*a, **kw):
        calls.append((a[1].shape[1], kw.get("nk_valid")))
        return real(*a, **kw)

    attention.flash_mha_packed = spy
    try:
        out = attention.attention(q, k, k, 0.1, 2)
        with torch.no_grad():
            attention.attention(q, k, k, 0.1, 2)
    finally:
        attention.flash_mha_packed = real
    assert calls == [(96, None), (96, None)]
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    with pytest.raises(ValueError, match="nk_valid"):
        attention.flash_mha_packed(q.detach(), k, k, 0.1, 2, nk_valid=97)


# ---------------------------------------------------------------------------
# the partial-overlap stages against the JAX functions
# ---------------------------------------------------------------------------


def _gap_at_cut(mass, k):
    """Smallest gap between the k-th and (k+1)-th largest entry per row."""
    s = np.sort(np.asarray(mass, np.float64), axis=-1)[:, ::-1]
    return float((s[:, k - 1] - s[:, k]).min())


def _head_inputs(seed, n=96, e=64, scale=0.35):
    rng = np.random.RandomState(seed)
    src = (rng.rand(B, n, 3) - 0.5).astype(np.float32)
    tgt = (rng.rand(B, n, 3) - 0.5).astype(np.float32)
    return _rand(rng, B, n, e, scale=scale), _rand(rng, B, n, e, scale=scale), src, tgt


def test_vcp_top_k_partial_matches_jax():
    overlap2 = Config(**PARTIAL).overlap2
    se, te, src, tgt = _head_inputs(8)
    want = jheads.vcp_top_k_partial(*(jnp.asarray(v) for v in (se, te, src, tgt)), overlap2,
                                    precision=jax.lax.Precision.HIGHEST)
    got = vcp_top_k_partial(_t(se), _t(te), _t(src), _t(tgt), overlap2)
    k1 = int(96 * 0.84 * overlap2)
    assert got[0].shape == (B, int(k1 * 0.52 * overlap2), 3) == np.asarray(want[0]).shape
    # stage 1 masses: no near tie at the cut on this seed (gap >> 1e-6, the
    # f32 rounding of a 96-term sum), so both frameworks select the same set
    from vcrnet_tpu_torch.ops.graph import neg_pairwise_sqdist
    scores = neg_pairwise_sqdist(_t(se), _t(te))
    for mass in (torch.softmax(scores, 2).sum(1), torch.softmax(scores, 1).sum(2)):
        assert _gap_at_cut(mass.numpy(), k1) > 1e-4
    # same points in the same order, gathered exactly
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_vcp_top_k_partial_bf16_selects_mostly_the_same_points():
    overlap2 = Config(**PARTIAL).overlap2
    se, te, src, tgt = _head_inputs(9)
    want = jheads.vcp_top_k_partial(jnp.asarray(se, jnp.bfloat16), jnp.asarray(te, jnp.bfloat16),
                                    jnp.asarray(src), jnp.asarray(tgt), overlap2)
    got = vcp_top_k_partial(_t(se).bfloat16(), _t(te).bfloat16(), _t(src), _t(tgt), overlap2)
    # bf16 embeddings, f32 scores on both sides: the products of bf16 values
    # are exact in f32, so only summation order separates them; a point set
    # may still differ at a near tie, so hold the share of equal rows
    same = (got[0].numpy() == np.asarray(want[0])).all(-1).mean()
    assert same >= 0.9, same


def test_remask_topk_keys_matches_jax():
    rng = np.random.RandomState(10)
    scores = _rand(rng, B, 2, 48, 96)
    keep_k = int(96 * Config(**PARTIAL).overlap2)
    p = torch.softmax(_t(scores), dim=-1)
    assert _gap_at_cut(p.sum(dim=(1, 2)).numpy(), keep_k) > 1e-4  # no near tie at the cut
    want = j_remask_topk_keys(jnp.asarray(scores), jax.nn.softmax(jnp.asarray(scores), -1), keep_k)
    got = _remask_topk_keys(_t(scores), p, keep_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    kept = (got.sum(dim=(1, 2)) > 0).sum(-1)
    assert kept.tolist() == [keep_k] * B  # dropped keys carry exactly no mass


@pytest.mark.parametrize("flash", [False, True])
def test_partial_pointer_matches_jax(flash):
    rng = np.random.RandomState(11)
    d, heads, n = 256, 2, 96
    overlap2 = Config(**PARTIAL).overlap2
    src, tgt = _rand(rng, B, n, d, scale=0.5), _rand(rng, B, n, d, scale=0.5)
    jp = JPointer(emb_dims=d, n_heads=heads, ff_dims=128, partial=True, overlap2=overlap2,
                  precision=jax.lax.Precision.HIGHEST)
    variables = jp.init(jax.random.PRNGKey(1), src, tgt)
    p = TransformerPointer(d, 1, heads, 128, flash=flash, partial=True, overlap2=overlap2)
    p.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    want = jp.apply(variables, src, tgt)
    with torch.no_grad():
        got = p(_t(src), _t(tgt))
    # f32; with flash the self attentions take the packed plain version and
    # the re-masked cross attention the written-out scores, as in JAX
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_streaming_remask_matches_the_written_out_route():
    rng = np.random.RandomState(12)
    d, heads, n = 256, 2, 128
    x, mem = _t(_rand(rng, B, n, d, scale=0.5)), _t(_rand(rng, B, n, d, scale=0.5))
    kw = dict(flash=True, remask=True, overlap2=Config(**PARTIAL).overlap2)
    stream = MultiHeadAttention(d, heads, stream_above=64, **kw)
    written = MultiHeadAttention(d, heads, **kw)  # 128 keys < 2048: scores written out
    written.load_state_dict(stream.state_dict())
    launches = []
    real = colmass.softmax_colmass_ref

    def spy(*a):
        launches.append(1)
        return real(*a)

    colmass.softmax_colmass_ref = spy
    try:
        with torch.no_grad():
            got, want = stream(x, mem, mem), written(x, mem, mem)
    finally:
        colmass.softmax_colmass_ref = real
    assert len(launches) == 1  # only the streaming module asked for the masses
    # the same function: exp(-1e9) is exactly 0; f32 sums in another order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_streaming_remask_model_matches_the_written_out_route():
    # num_points 171 crops to 128 points, a shape the streaming gate takes
    cfg = Config(num_points=171, emb_dims=256, ff_dims=128, n_heads=2, **PARTIAL)
    assert cfg.n_cropped == 128
    written = VCRNet(cfg, device="cpu", use_kernels=True).eval()
    # weights from the JAX package's init distributions: the key masses then
    # spread, and their gap at the cut (>= 3e-4 on this seed, four re-masks)
    # is far above the 1e-6 by which the two routes' sums differ
    init_like_jax(written, 0)
    stream = VCRNet(cfg, device="cpu", use_kernels=True).eval()
    stream.load_state_dict(written.state_dict())
    stream.pointer.dec_layers[0].src_attn.stream_above = 64
    data = shapes_eval_set(2, num_points=171, cloud_points=256, seed=3, partial=True)
    with torch.no_grad():
        got = vcrnet_iter(stream, _t(data["src"]), _t(data["tgt"]), 2)
        want = vcrnet_iter(written, _t(data["src"]), _t(data["tgt"]), 2)
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_lpdnet_given_selections_match_jax(fused):
    rng = np.random.RandomState(13)
    x = (rng.rand(B, N, 3) - 0.5).astype(np.float32)
    sp_idx = rng.randint(0, N, (B, N, 20)).astype(np.int32)
    ft_idx = rng.randint(0, N, (B, N, 20)).astype(np.int32)
    jnet = JLPDNet(emb_dims=64, precision=jax.lax.Precision.HIGHEST)
    variables = jnet.init(jax.random.PRNGKey(0), x)
    net = LPDNet(emb_dims=64)
    net.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    want = jnet.apply(variables, x, spatial_idx=jnp.asarray(sp_idx),
                      feature_idx=jnp.asarray(ft_idx))
    with torch.no_grad():
        emb, sp_out, ft_out = net(_t(x), spatial_idx=_t(sp_idx), feature_idx=_t(ft_idx),
                                  fused=fused)
        only_sp = net(_t(x), spatial_idx=_t(sp_idx), fused=fused)
    assert torch.equal(sp_out, _t(sp_idx)) and torch.equal(ft_out, _t(ft_idx))
    np.testing.assert_allclose(emb.numpy(), np.asarray(want), atol=1e-4, rtol=0)  # f32
    # with the spatial selection alone the feature graph is computed afresh
    assert torch.equal(only_sp[1], _t(sp_idx)) and not torch.equal(only_sp[2], _t(ft_idx))


# ---------------------------------------------------------------------------
# the refinement loop and the entry points as a whole
# ---------------------------------------------------------------------------


def _models(dtype="float32", use_kernels=True, **kw):
    cfg_kw = dict(NARROW, compute_dtype=dtype, **kw)
    jmodel = JVCRNet(cfg=JConfig(**cfg_kw))
    n = jmodel.cfg.n_cropped
    cloud = np.zeros((1, n, 3), np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), cloud, cloud)
    model = VCRNet(Config(**cfg_kw), device="cpu", use_kernels=use_kernels)
    model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    return jmodel, variables, model.eval()


def _pair(seed, b, **kw):
    data = shapes_eval_set(b, num_points=N, cloud_points=2 * N, seed=seed, **kw)
    return data["src"], data["tgt"]


def _iter_both(jmodel, variables, model, src, tgt, n_iter):
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), n_iter,
                         model=jmodel)
    with torch.no_grad():
        got = vcrnet_iter(model, _t(src), _t(tgt), n_iter)
    return got, want


def _close(got, want, atol):
    for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
        np.testing.assert_allclose(got[i].float().numpy(), np.asarray(want[i]), atol=atol, rtol=0)


@pytest.mark.parametrize("n_iter", [2, 3])
def test_vcrnet_iter_kernel_route_matches_jax(n_iter):
    # the kernel route on the CPU: the wrappers' plain versions, with the
    # cached xyz selection through gather_max_from_idx. f32, 1e-4 on R and t
    got, want = _iter_both(*_models(), *_pair(3, 2), n_iter)
    _close(got, want, 1e-4)


def test_vcrnet_iter_kernel_route_matches_jax_bf16():
    got, want = _iter_both(*_models("bfloat16"), *_pair(3, 2), 3)
    _close(got, want, 1e-2)  # bf16 rounds at other points in the two frameworks


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("refresh", [1, 2])
def test_vcrnet_iter_reuse_feature_knn_matches_jax(refresh, use_kernels):
    kw = dict(reuse_feature_knn=True, feature_knn_refresh=refresh)
    got, want = _iter_both(*_models(use_kernels=use_kernels, **kw), *_pair(4, 2), 3)
    _close(got, want, 1e-4)
    # and the reuse is really taken: it changes the result of the exact loop
    exact, _ = _iter_both(*_models(use_kernels=use_kernels), *_pair(4, 2), 3)
    assert not torch.equal(exact[2], got[2])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_vcrnet_iter_refine_subsample_matches_jax(use_kernels):
    got, want = _iter_both(*_models(use_kernels=use_kernels, refine_subsample=32),
                           *_pair(5, 2), 3)
    _close(got, want, 1e-4)
    assert got[0].shape == (2, 32, 3)  # the last iteration ran on the subsample
    # M >= N is the exact path
    clamped, _ = _iter_both(*_models(use_kernels=use_kernels, refine_subsample=N),
                            *_pair(5, 2), 3)
    exact, _ = _iter_both(*_models(use_kernels=use_kernels), *_pair(5, 2), 3)
    assert torch.equal(clamped[2], exact[2])


# the partial sizes of N = 64 at the eval protocol's overlap and at the
# CLI's default (whose crops are ragged at every N the CLI takes)
PARTIAL_SIZES = {0.575: (48, 36, 30, 11), 0.75: (55, 47, 40, 18)}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("overlap", sorted(PARTIAL_SIZES))
def test_vcrnet_iter_partial_matches_jax(overlap, use_kernels):
    jmodel, variables, model = _models(use_kernels=use_kernels, partial=True, overlap=overlap)
    cfg = model.cfg
    assert (cfg.n_cropped, cfg.attn_mask_k, cfg.select_k, cfg.pair_k) == PARTIAL_SIZES[overlap]
    src, tgt = _pair(6, 2, partial=True, overlap=overlap)
    assert src.shape == (2, cfg.n_cropped, 3)
    got, want = _iter_both(jmodel, variables, model, src, tgt, 3)
    assert got[0].shape == (2, cfg.pair_k, 3)
    # f32; three chained passes of hard selections: the selected sets agree
    # on this seed, and R, t then differ by summation order only
    _close(got, want, 1e-4)


def test_nn_crop_is_bit_equal():
    rng = np.random.RandomState(14)
    pts = rng.rand(100, 3).astype(np.float32)
    pts[40] = pts[7]  # a duplicate: equal distances, the stable sort decides
    reserve = Config(**PARTIAL).reserve
    got, want = nn_crop(pts, reserve), j_nn_crop(pts, reserve)
    assert got.shape == (int(100 * reserve), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], pts[-1])  # the seed point comes first


@pytest.mark.parametrize("partition", ["train", "test"])
def test_partial_pairs_are_bit_equal(partition):
    rng = np.random.RandomState(15)
    cloud = rng.rand(300, 3).astype(np.float32)
    pairs = []
    for make, cfg in ((make_pair_from_cloud, Config(num_points=128, **PARTIAL)),
                      (j_make_pair, JConfig(num_points=128, **PARTIAL))):
        np.random.seed(5)
        pairs.append(make(cloud, 3, cfg, partition))
    assert pairs[0].src.shape == (Config(num_points=128, **PARTIAL).n_cropped, 3)
    for got, want in zip(pairs[0].astuple(), pairs[1].astuple()):
        np.testing.assert_array_equal(got, want)


def test_shapes_eval_set_partial_matches_jax_dataset():
    from vcrnet_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

    want = JSyntheticDataset(JConfig(num_points=N, **PARTIAL), "test", 3, 2 * N, kind="shapes")
    got = shapes_eval_set(3, num_points=N, cloud_points=2 * N, partial=True)
    for i in range(3):
        np.testing.assert_array_equal(got["src"][i], want[i].src)
        np.testing.assert_array_equal(got["tgt"][i], want[i].tgt)
    with pytest.raises(ValueError, match="cloud_points"):
        shapes_eval_set(1, num_points=4093, cloud_points=2048)


@pytest.mark.parametrize("mode", ["whole", "partial"])
def test_registrar_iter3_on_cpu_matches_vcrnet_iter(mode):
    kw = PARTIAL if mode == "partial" else {}
    _, _, model = _models("bfloat16", **kw)
    cfg = Config(**NARROW, compute_dtype="bfloat16", iter=3, **kw)
    reg = Registrar(cfg, model.state_dict(), buckets=(2,), device="cpu", use_kernels=True)
    assert reg.n_points == cfg.n_cropped
    src, tgt = _pair(7, 2, **({"partial": True} if kw else {}))
    out = reg.register(src, tgt)
    with torch.no_grad():
        want = vcrnet_iter(model, _t(src), _t(tgt), 3)
    np.testing.assert_array_equal(out["R"], want[2].numpy())
    np.testing.assert_array_equal(out["t"], want[3].numpy())
    assert np.isfinite(out["R_inv"]).all() and out["t_inv"].shape == (2, 3)


def test_registrar_at_a_ragged_cloud_size_matches_jax():
    """num_points = 1000, no multiple of 64 (ROADMAP C1): the port's
    Registrar on its kernel route (the plain versions on the CPU) against
    the JAX package's, f32, iter = 3, on the same weights and pairs."""
    n = 1000
    kw = dict(NARROW, num_points=n, iter=3)
    jcfg = JConfig(**kw)
    jmodel = JVCRNet(cfg=jcfg)
    cloud = np.zeros((1, n, 3), np.float32)
    variables = jmodel.init(jax.random.PRNGKey(1), cloud, cloud)
    data = shapes_eval_set(2, num_points=n, cloud_points=2 * n, seed=8)
    want = JRegistrar(jcfg, {"params": variables["params"]}, buckets=(2,)).register(
        data["src"], data["tgt"])
    reg = Registrar(Config(**kw), from_jax_params(jax.device_get(variables["params"])),
                    buckets=(2,), device="cpu", use_kernels=True)
    assert reg.n_points == n and reg.model.use_kernels
    got = reg.register(data["src"], data["tgt"])
    # f32 on both sides; the selections agree on this seed
    np.testing.assert_allclose(got["R"], want["R"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["t"], want["t"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["whole", "partial"])
def test_trainer_eval_step_iter3_matches_jax(mode):
    from vcrnet_tpu.parallel import make_mesh
    from vcrnet_tpu.train import Trainer as JTrainer

    kw = dict(NARROW, iter=3, batch_size=2, test_batch_size=2,
              **(PARTIAL if mode == "partial" else {}))
    cfg = Config(**kw)
    ds = SyntheticDataset(cfg, "test", n_items=2, cloud_points=2 * N, kind="shapes")
    batch = next(iter(Loader(ds, 2)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jtr = JTrainer(JConfig(**kw), mesh=make_mesh(1))
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    want = jtr._eval_step_impl(state, jb)
    tr = Trainer(cfg, device="cpu", use_kernels=True)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    got = tr.eval_step(batch)
    assert set(got) == set(want)
    for key in want:  # f32 metric sums of the two frameworks
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-3, atol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the committed checkpoint at full width in both packages
# ---------------------------------------------------------------------------

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "pretrained",
                          "vcrnet_shapes_best.msgpack")
N_CKPT = 256  # 192 points per cloud in partial mode


def _rot_between_deg(Ra, Rb):
    """Angle of Ra^T Rb per pair, degrees, from the Frobenius distance in f64
    (arccos of the trace loses small angles in f32)."""
    diff = np.linalg.norm((np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)).reshape(-1, 9),
                          axis=1)
    return np.degrees(2.0 * np.arcsin(np.clip(diff / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


@pytest.fixture(scope="module", params=["whole", "partial"])
def checkpoint_iter3(request):
    """Three pairs through ``Registrar`` at iter=3, f32, full width, with the
    committed weights, in both packages; and the (query, memory) inputs the
    port's decoder cross attention saw on the way."""
    partial = request.param == "partial"
    kw = dict(num_points=N_CKPT, iter=3, **(PARTIAL if partial else {}))
    raw = read_msgpack(CHECKPOINT)
    data = shapes_eval_set(3, num_points=N_CKPT, cloud_points=2 * N_CKPT, seed=5, partial=partial)
    want = JRegistrar(JConfig(**kw), {"params": raw["params"]}, buckets=(3,)).register(
        data["src"], data["tgt"])
    reg = Registrar(Config(**kw), from_jax_params(raw["params"]), buckets=(3,), device="cpu")
    assert (reg.cfg.emb_dims, reg.cfg.ff_dims, reg.cfg.n_heads) == (512, 1024, 4)
    src_attn, seen = reg.model.pointer.dec_layers[0].src_attn, []
    hook = src_attn.register_forward_hook(lambda mod, args, out: seen.append(args[:2]))
    got = reg.register(data["src"], data["tgt"])
    hook.remove()
    assert len(seen) == 6 and src_attn.remask == partial  # two decoder passes per iteration
    return dict(mode=request.param, got=got, want=want, data=data, seen=seen, src_attn=src_attn,
                jax_src_attn=raw["params"]["pointer"]["dec_layers_0"]["src_attn"])


def test_checkpoint_iter3_matches_jax_full_width(checkpoint_iter3):
    c = checkpoint_iter3
    between = _rot_between_deg(c["got"]["R"], c["want"]["R"])
    if c["mode"] == "whole":
        # f32 on both sides, no hard selection: summation order only
        assert between.max() <= 0.01, between
        np.testing.assert_allclose(c["got"]["t"], c["want"]["t"], atol=1e-4, rtol=0)
        # and both are the model's headline result on these pairs
        for out in (c["got"], c["want"]):
            assert _rot_between_deg(out["R"], c["data"]["R_ab"]).max() <= 0.5
    else:
        # the re-mask ranks rounding noise with these weights (next test), so
        # the two packages keep other keys and single pairs move by degrees
        # (as either package does against itself when its sums are reordered):
        # no tolerance on R would mean anything. Held: proper rotations from
        # the partial head's pair_k points, and the stages, in the next test
        for out in (c["got"], c["want"]):
            R = np.asarray(out["R"], np.float64)
            np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                                       atol=1e-5)
            np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
        print("rotation between the two packages, per pair, deg:", between)


def test_checkpoint_cross_attention_is_uniform_in_both_packages(checkpoint_iter3):
    """On the activations the decoder's cross attention really sees, the
    JAX module and the port give the same scores and key masses from the
    committed weights, and in both every key's mass is Nq * H / Nk = 4 to
    within rounding: a top-k over these masses (the partial re-mask) ranks
    rounding noise in either package."""
    c = checkpoint_iter3
    mha = c["src_attn"]
    jmha = JMultiHeadAttention(n_heads=4, d_model=512, capture_attention=True,
                               precision=jax.lax.Precision.HIGHEST)
    for query, memory in c["seen"]:
        b, nq, nk = query.shape[0], query.shape[1], memory.shape[1]
        jq, jm = jnp.asarray(query.numpy()), jnp.asarray(memory.numpy())
        _, sown = jmha.apply({"params": c["jax_src_attn"]}, jq, jm, jm, mutable=["intermediates"])
        want_p = np.asarray(sown["intermediates"]["attn"][0])  # [B, Nq, Nk], summed over heads
        with torch.no_grad():
            q, k = dense(mha.linear_q, query, mha.dtype), dense(mha.linear_k, memory, mha.dtype)
            heads = [t.reshape(b, -1, 4, 128).transpose(1, 2) for t in (q, k)]
            scores = heads[0] @ heads[1].transpose(-1, -2) * 128 ** -0.5
            got_p = torch.softmax(scores, -1).sum(1).numpy()
            got_mass = colmass.softmax_colmass_ref(q, k, 128 ** -0.5, 4).sum(1).numpy()
        assert scores.abs().max().item() <= 1e-4  # the trained projections are that small
        np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)  # probabilities of ~4/Nk
        want_mass = want_p.sum(1)
        np.testing.assert_allclose(got_mass, want_mass, rtol=1e-5, atol=0)
        uniform = nq * 4 / nk
        for mass in (got_mass, want_mass):
            assert np.abs(mass / uniform - 1.0).max() <= 1e-5, (mass.min(), mass.max())


def test_checkpoint_iter3_accuracy_equals_the_jax_report_on_the_cpu():
    """The JAX package's own accuracy report (bench.accuracy_report, exact
    f32 profile, N = 1024) and the port's ``Trainer.eval_epoch`` on the same
    8 pairs: both read a few hundredths of a degree at iter=3 on the CPU."""
    import bench

    report = bench.accuracy_report(n_items=8, test_batch_size=8, profiles=("exact",),
                                   protocols=("whole_iter3",))
    want = report["whole_iter3"]["exact"]
    cfg = Config(num_points=1024, iter=3, test_batch_size=8)
    tr = Trainer(cfg, device="cpu", use_kernels=False)
    tr.model.load_state_dict(from_jax_params(read_msgpack(CHECKPOINT)["params"]))
    ds = SyntheticDataset(cfg, "test", n_items=8, cloud_points=2048, kind="shapes")
    got = tr.eval_epoch(Loader(ds, 8))
    assert report["merged_leaves"] == 58
    assert want["rot_RMSE_deg"] <= 0.1 and float(got["rot_ab_RMSE"]) <= 0.1
    # the report rounds to 1e-4 deg; f32 sums of the two frameworks beyond that
    assert abs(float(got["rot_ab_RMSE"]) - want["rot_RMSE_deg"]) <= 5e-3
    assert abs(float(got["trans_ab_RMSE"]) - want["trans_RMSE"]) <= 5e-5
