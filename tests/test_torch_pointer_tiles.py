"""The fused attention sublayer's arithmetic in its kernels' order, on the CPU.

csrc/pointer_mha.cu runs only on the card, as three kernels: the q, k and v
projections as products over all B * N rows at once (csrc/gemm_wgmma.cuh),
the attention over the projected q, k and v (csrc/flash_fwd.cuh), and the
out projection (the product again). This file writes that order of work in
PyTorch and holds it against the port's plain version (``fused_mha_ref``)
and against the JAX package's Pallas kernel in interpret mode
(``pallas_pointer.fused_mha``), on the same seeded numpy inputs:

* projections: bf16(A @ W + b) on the [B * N, D] rows, f32 accumulation,
  the bf16 bias added in f32, one rounding;
* attention: 64-key tiles read at row b * Nk + t * 64 of the flattened K
  and V (where Nk % 64 != 0 the last tile reaches into the next batch
  item's rows, or zeros past the end, and those keys are masked to -inf);
  the online softmax in base 2 with the scale folded into log2(e), P
  rounded to bf16 against the RUNNING max, O rescaled when the max moves,
  O = bf16(o / l) written over Q;
* the out projection on O.

Tolerances: the order above and the plain version (which rounds P against
each row's FINAL max, as the Pallas kernel does) differ by at most one bf16
ulp of P before the rounding of O (ROADMAP C, "Online softmax in
pointer_mha.cu"), which the out projection carries into the result: both
are held within 2^-6 of the output's largest value, the card's tolerance.
The projections equal the plain version's within one bf16 ulp (f32 sums
of the same products in another order). The gate takes every shape the
served paths give the sublayer, and a CUDA tensor with a shape the kernels
refuse raises, with no plain version in its place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vcrnet_tpu.ops.pallas_pointer as pp
from vcrnet_tpu_torch.ops import _build, pointer

TILE = 64
DK = 128
LOG2E = 1.4426950408889634


def _bf(t):
    return t.to(torch.bfloat16)


def projection(a, w, b):
    """gemm_wgmma.cuh: [..., D] rows as one [rows, D] product."""
    rows = _bf(a).float().reshape(-1, a.shape[-1])
    out = _bf(rows @ _bf(w).float() + _bf(b).float())
    return out.reshape(*a.shape[:-1], w.shape[1])


def attention(q, k, v, heads):
    """flash_fwd.cuh's fwd_kernel with nk_valid = Nk: O [B, Nq, D] bf16."""
    B, nq, d = q.shape
    nk = k.shape[1]
    scale_log2 = DK ** -0.5 * LOG2E
    n_tiles = -(-nk // TILE)
    # the flattened [B * Nk, D] matrices as the TMA boxes see them: zeros past the end
    pad = n_tiles * TILE - nk
    kf = torch.cat([k.reshape(B * nk, d).float(), torch.zeros(pad, d)])
    vf = torch.cat([v.reshape(B * nk, d).float(), torch.zeros(pad, d)])
    qh = q.float().reshape(B, nq, heads, DK).transpose(1, 2)  # [B, H, Nq, dk]
    m = torch.full((B, heads, nq), float("-inf"))
    l = torch.zeros(B, heads, nq)
    o = torch.zeros(B, heads, nq, DK)
    for t in range(n_tiles):
        rows = torch.arange(B)[:, None] * nk + t * TILE + torch.arange(TILE)  # [B, 64]
        kt = kf[rows].reshape(B, TILE, heads, DK).transpose(1, 2)
        vt = vf[rows].reshape(B, TILE, heads, DK).transpose(1, 2)
        s = qh @ kt.transpose(-1, -2)
        s[..., t * TILE + torch.arange(TILE) >= nk] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _bf(p).float() @ vt
        m = m_new
    return _bf(o / l[..., None]).transpose(1, 2).reshape(B, nq, d)


def tiled_fused_mha(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, heads):
    q, k, v = projection(yq, wq, bq), projection(ykv, wk, bk), projection(ykv, wv, bv)
    return projection(attention(q, k, v, heads), wo, bo)


def _rand(rng, *shape, scale=0.5):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _inputs(nq, nk, d, seed, b=2):
    rng = np.random.RandomState(seed)
    yq = _rand(rng, b, nq, d)
    ykv = yq if nk is None else _rand(rng, b, nk, d)
    weights = []
    for _ in range(4):
        weights += [_rand(rng, d, d, scale=0.15), _rand(rng, d, scale=0.05)]
    return yq, ykv, weights


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# (Nq, Nk or None for self-attention, D): one head and two; keys in 32s
# (the last tile reaches into the next batch item); Nq % 128 == 64; several
# key tiles
SHAPES = [(128, None, 128), (256, None, 256), (128, 96, 256), (192, 320, 256),
          (64, 160, 128)]


@pytest.mark.parametrize("nq,nk,d", SHAPES)
def test_tiled_order_matches_plain_version(nq, nk, d):
    yq, ykv, w = _inputs(nq, nk, d, seed=21)
    heads = d // DK
    got = tiled_fused_mha(yq, ykv, *w, heads)
    want = pointer.fused_mha_ref(yq, ykv, *w, heads)
    assert got.shape == want.shape == (2, nq, d) and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 2 ** -6


@pytest.mark.parametrize("nq,nk,d", [(256, None, 256), (256, 128, 128)])
def test_tiled_order_matches_pallas_kernel(nq, nk, d):
    yq, ykv, w = _inputs(nq, nk, d, seed=22)
    heads = d // DK
    want = pp.fused_mha(jnp.asarray(yq.numpy()), jnp.asarray(ykv.numpy()),
                        *(jnp.asarray(t.numpy()) for t in w), n_heads=heads, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _rel(tiled_fused_mha(yq, ykv, *w, heads), want) <= 2 ** -6


def test_whole_row_projections_match_per_item_products():
    """The product over all B * N rows at once is the plain version's
    per-item product, within one bf16 ulp."""
    yq, _, w = _inputs(192, None, 256, seed=23, b=3)
    got = projection(yq, w[0], w[1]).float()
    want = pointer._dense_bf16(yq, w[0], w[1]).float()
    assert torch.all((got - want).abs() <= 2 ** -7 * want.abs())


def test_masked_keys_of_the_next_item_change_nothing():
    """Keys in 32s: the kernel's last tile holds the next item's keys. With
    them masked the result equals attention over each item's keys alone."""
    rng = np.random.RandomState(24)
    q, k, v = (_bf(_rand(rng, 2, n, 256)) for n in (64, 96, 96))
    both = attention(q, k, v, 2)
    for b in range(2):
        assert torch.equal(attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], 2), both[b:b + 1])


def test_gate_takes_every_served_shape(monkeypatch):
    """The pointer's sublayers at the served sizes: N = 1024 (whole clouds)
    and 768 (the partial crop of 1024), self and cross attention, D = 512,
    4 heads; the partial-3072 re-masked cross attention stays unfused."""
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    for n in (1024, 768, 512, 3072):
        assert pointer.fused_mha_supported(n, n, 512, 4), n
    assert pointer.fused_mha_supported(1024, 992, 512, 4)  # keys in 32s
    assert pointer.pointer_mha_smem_bytes(512) == pointer.pointer_mha_smem_bytes(128) == 214064


def _as_if_on_the_card(monkeypatch):
    calls = []

    class Ext:
        @staticmethod
        def pointer_mha(yq, ykv, *rest):
            calls.append((tuple(yq.shape), tuple(ykv.shape), rest[-1]))

    monkeypatch.setattr(pointer, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", lambda: Ext)
    monkeypatch.setattr(pointer, "fused_mha_ref", None)  # no plain version on the card
    return calls


@pytest.mark.parametrize("nq,nk,d,heads", [(1000, 1024, 1024, 8), (1024, 1000, 384, 4),
                                           (1024, 1024, 512, 8), (1024, 1024, 640, 5)])
def test_a_refused_shape_raises_on_the_card(monkeypatch, nq, nk, d, heads):
    calls = _as_if_on_the_card(monkeypatch)
    _, _, w = _inputs(64, None, d, seed=25, b=1)
    yq, ykv = torch.zeros(1, nq, d), torch.zeros(1, nk, d)
    before = pointer.fused_mha.launches
    with torch.no_grad(), pytest.raises(ValueError, match="fused_mha kernel does not take"):
        pointer.fused_mha(yq, ykv, *w, heads)
    assert not calls and pointer.fused_mha.launches == before


def test_a_served_shape_launches_once(monkeypatch):
    calls = _as_if_on_the_card(monkeypatch)
    _, _, w = _inputs(64, None, 512, seed=26, b=1)
    y = torch.zeros(2, 1024, 512)
    before = pointer.fused_mha.launches
    with torch.no_grad():
        out = pointer.fused_mha(y, y, *w, 4)
    assert out.shape == (2, 1024, 512) and out.dtype == torch.bfloat16
    assert calls == [((2, 1024, 512), (2, 1024, 512), 4)]
    assert pointer.fused_mha.launches == before + 1
