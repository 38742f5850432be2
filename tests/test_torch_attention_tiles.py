"""The attention kernels' arithmetic in their own order, on the CPU.

csrc/flash_packed.cu and csrc/flash_bwd.cu run only on the card. This file
writes what they compute in PyTorch, at their tile width and rounding
points, and holds it against the port's plain versions
(``flash_mha_packed_ref``, ``flash_mha_packed_bwd_ref``) and against the JAX
package's Pallas kernels in interpret mode (``_flash_packed_impl``,
``_bwd_fused``), on the same seeded numpy inputs:

* forward: 64-key tiles with an online softmax: a running row max m and
  sum l, P = exp(s - m) rounded to v's dtype against the RUNNING max, O
  rescaled by exp(m_old - m_new) when the max moves, f32 throughout; keys
  at or beyond ``nk_valid`` masked to -inf in the last tile, tiles wholly
  past it never visited; lse = m + log l. The Pallas kernel and the plain
  version round P against the row's FINAL max instead (ROADMAP C, "Online
  softmax"): these tests bound that divergence. At lengths that are no
  multiple of 64 the tiles are read as the kernel's TMA boxes read the
  flattened [B * N, H * dk] matrices (the next item's rows, then zeros past
  the end), keys past Nk are masked by the count and query rows past Nq
  are not stored;
* backward: dK and dV summed tile by tile over 64-row query tiles (the
  dK/dV kernel's loop), dQ over 64-key tiles (the dQ kernel's loop), each
  tile's product added to an f32 accumulator; p = exp(s - lse), dS and P
  rounded to q's dtype before their products. At lengths that are no
  multiple of 64 the owned rows (blocks of 128) and the streamed tiles are
  read as the TMA boxes read them; the dK/dV kernel takes each q tile's lse
  and delta from rows padded per (b, h) to whole tiles (lse +inf, delta 0
  past Nq), the dQ kernel masks keys past Nk by the count, and rows past
  Nq or Nk are not stored.

The forward kernel takes dk = 64, 128 and 256, the backward kernels 64 and
128 (an instance each, the same loop over the same tiles): each check runs
at every head dim its kernel has an instance of (the ``dk`` parameter),
against the same plain versions and the same Pallas kernels in interpret
mode, with the same tolerances.

Tolerances, each with its reason:
* f32: 1e-5 absolute (sums of values of order one in another order);
* bf16 forward: 2^-8 of max |v| (each P rounded at another scale moves by at
  most one bf16 ulp of P: 2^-8 relative, at most 2^-8 max |v| in the
  weighted mean) plus one bf16 ulp of the largest output (2^-8 of max |o|:
  the two round f32 values that differ in the last bits);
* bf16 backward: one bf16 ulp of the largest gradient (dS is rounded to
  bf16 at f32 values that differ in the last bits).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcrnet_tpu.ops.pallas_attention import _bwd_fused, _flash_packed_impl
from vcrnet_tpu_torch.ops import attention

TILE = 64  # the kernels' key tile (forward, dQ) and query tile (dK/dV)
B, HEADS, DK = 2, 2, 128
SCALE = DK ** -0.5
FORWARD_DKS = (64, 128, 256)  # the forward kernel's instances
BACKWARD_DKS = (64, 128)      # the backward kernels' instances


def _scale(x):
    """The attention scale of [B, n, H*dk] heads: dk ** -0.5."""
    return (x.shape[-1] // HEADS) ** -0.5


def _split(x):
    """[B, n, H*dk] -> f32 [B, H, n, dk]."""
    return x.float().reshape(x.shape[0], x.shape[1], HEADS, x.shape[-1] // HEADS).transpose(1, 2)


def _merge(x4, dtype):
    return x4.transpose(1, 2).reshape(x4.shape[0], x4.shape[2], HEADS * x4.shape[-1]).to(dtype)


def tiled_forward(q, k, v, nk_valid=None):
    """flash_packed.cu's order: returns (out in q's dtype, lse f32 [B, H, Nq])."""
    scale = _scale(q)
    nk = k.shape[1]
    nkv = nk if nk_valid is None else nk_valid
    qh, kh, vh = _split(q), _split(k), _split(v)
    m = torch.full(qh.shape[:3], float("-inf"))
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    for t0 in range(0, nkv, TILE):  # tiles wholly past nk_valid are not visited
        s = qh @ kh[:, :, t0:t0 + TILE].transpose(-1, -2) * scale
        s[..., torch.arange(t0, t0 + TILE) >= nkv] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(v.dtype).float() @ vh[:, :, t0:t0 + TILE]
        m = m_new
    return _merge(o / l[..., None], q.dtype), m + torch.log(l)


def tiled_backward(q, k, v, o, lse, do):
    """flash_bwd.cu's order: returns (dq, dk, dv) in the inputs' dtypes."""
    scale = _scale(q)
    qh, kh, vh, oh, doh = (_split(t) for t in (q, k, v, o, do))
    delta = (doh * oh).sum(-1)
    do_c = doh.to(v.dtype).float()
    nq, nk = qh.shape[2], kh.shape[2]

    def ds_of(s, p_rows_lse, dp, delta_rows):
        p = torch.exp(s - p_rows_lse)
        return p, (p * (dp - delta_rows) * scale).to(q.dtype).float()

    # dK/dV kernel: every key block loops over the 64-row query tiles
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    for t0 in range(0, nq, TILE):
        rows = slice(t0, t0 + TILE)
        st = kh @ qh[:, :, rows].transpose(-1, -2) * scale  # S^T [keys, tile]
        dpt = vh @ do_c[:, :, rows].transpose(-1, -2)
        pt, dst = ds_of(st, lse[:, :, None, rows], dpt, delta[:, :, None, rows])
        dv += pt.to(q.dtype).float() @ do_c[:, :, rows]
        dk += dst @ qh[:, :, rows]
    # dQ kernel: every query block loops over the 64-key tiles
    dq = torch.zeros(qh.shape)
    for t0 in range(0, nk, TILE):
        keys = slice(t0, t0 + TILE)
        s = qh @ kh[:, :, keys].transpose(-1, -2) * scale
        dp = do_c @ vh[:, :, keys].transpose(-1, -2)
        _, ds = ds_of(s, lse[..., None], dp, delta[..., None])
        dq += ds @ kh[:, :, keys]
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _inputs(seed, dtype, nq, nk, nk_valid=None, n=3, dk=DK):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, nq, HEADS * dk).astype(np.float32)]
    arrays += [rng.randn(B, nk, HEADS * dk).astype(np.float32) for _ in range(2)]
    arrays += [rng.randn(B, nq, HEADS * dk).astype(np.float32) for _ in range(n - 3)]
    if nk_valid is not None:  # the wrapper's padding: zero rows behind the real keys
        arrays[1][:, nk_valid:] = 0
        arrays[2][:, nk_valid:] = 0
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _forward_tol(dtype, v, o):
    if dtype == "float32":
        return 1e-5
    return 2 ** -8 * (v.float().abs().max().item() + o.float().abs().max().item())


# (Nq, Nk, nk_valid): Nq % 128 == 64, one key tile, one valid key, valid
# keys ending at a tile boundary and inside a tile, several tiles
FORWARD_SHAPES = [(320, 320, None), (128, 64, None), (64, 192, 1), (128, 192, 128),
                  (128, 192, 100), (128, 256, None)]


def _check_tiled_forward(dtype, nq, nk, nk_valid, dk):
    q, k, v = _inputs(30, dtype, nq, nk, nk_valid, dk=dk)
    got, got_lse = tiled_forward(q, k, v, nk_valid)
    want, want_lse = attention.flash_mha_packed_ref(q, k, v, dk ** -0.5, HEADS, return_lse=True,
                                                    nk_valid=nk_valid)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=_forward_tol(dtype, v, want), rtol=0)
    # lse: f32 sums of exponentials in another order and at other maxima
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dk", FORWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,nk_valid", FORWARD_SHAPES)
def test_tiled_forward_matches_plain_version(dtype, nq, nk, nk_valid, dk):
    _check_tiled_forward(dtype, nq, nk, nk_valid, dk)


def test_tiled_forward_with_one_tile_rounds_as_the_plain_version():
    """With one key tile the running max is the final max: P is rounded at
    the same values, so bf16 outputs agree to one ulp of the f32 sum order."""
    q, k, v = _inputs(31, "bfloat16", 128, 64)
    got, _ = tiled_forward(q, k, v)
    want = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2 ** -8 * want.float().abs().max().item(), rtol=0)


PALLAS_FORWARD_SHAPES = [(128, 256, None), (256, 384, 256)]


def _check_forward_against_pallas(dtype, nq, nk, nk_valid, dk):
    q, k, v = _inputs(32, dtype, nq, nk, nk_valid, dk=dk)
    got, _ = tiled_forward(q, k, v, nk_valid)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    nkv = nk if nk_valid is None else nk_valid
    want = np.asarray(_flash_packed_impl(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, k[:, :nkv], v[:, :nkv])),
        dk ** -0.5, HEADS, interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=_forward_tol(dtype, v, torch.from_numpy(want)), rtol=0)


@pytest.mark.parametrize("dk", FORWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,nk_valid", PALLAS_FORWARD_SHAPES)
def test_tiled_forward_matches_pallas(dtype, nq, nk, nk_valid, dk):
    """_flash_packed_impl takes multiples of 128 and no valid-key count: with
    one, it sees the real keys alone (nk_valid at a 128-key boundary). The
    Pallas kernel in interpret mode runs at dk = 64 too (on the TPU its gate
    asks dk % 128, and the JAX package takes dk = 64 through its stock flash
    kernel; the function is the same)."""
    _check_forward_against_pallas(dtype, nq, nk, nk_valid, dk)


def _box_rows(x, r0, rows):
    """Rows r0 .. r0 + rows of every item as a TMA box of the flattened
    [B * N, D] matrix sees them: past the item's N, the next item's rows,
    and zeros past the end of the tensor."""
    b, n, d = x.shape
    flat = torch.cat([x.reshape(b * n, d), torch.zeros(rows + TILE, d, dtype=x.dtype)])
    return flat[torch.arange(b)[:, None] * n + r0 + torch.arange(rows)]


def ragged_forward(q, k, v, q_block=128):
    """fwd_kernel at any Nq and Nk (nk_valid = Nk): blocks of 128 query rows
    and 64-key tiles read as the TMA boxes read them; keys past Nk set to
    -inf by the count; only rows below Nq stored. (out, lse)."""
    b, nq, d = q.shape
    nk = k.shape[1]
    scale = _scale(q)
    out = torch.full((b, nq, d), float("nan"), dtype=q.dtype)
    lse = torch.full((b, HEADS, nq), float("nan"))
    for r0 in range(0, nq, q_block):
        qh = _split(_box_rows(q, r0, q_block))
        m = torch.full(qh.shape[:3], float("-inf"))
        l = torch.zeros(qh.shape[:3])
        o = torch.zeros(qh.shape)
        for t0 in range(0, nk, TILE):
            kh, vh = _split(_box_rows(k, t0, TILE)), _split(_box_rows(v, t0, TILE))
            s = qh @ kh.transpose(-1, -2) * scale
            s[..., torch.arange(t0, t0 + TILE) >= nk] = float("-inf")
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.to(v.dtype).float() @ vh
            m = m_new
        stored = min(q_block, nq - r0)
        out[:, r0:r0 + stored] = _merge(o / l[..., None], q.dtype)[:, :stored]
        lse[:, :, r0:r0 + stored] = (m + torch.log(l))[:, :, :stored]
    return out, lse


RAGGED_FORWARD_SHAPES = [(100, 100), (130, 70), (64, 150), (245, 200)]


def _check_ragged_forward(dtype, nq, nk, dk):
    q, k, v = _inputs(35, dtype, nq, nk, dk=dk)
    got, got_lse = ragged_forward(q, k, v)
    want, want_lse = attention.flash_mha_packed_ref(q, k, v, dk ** -0.5, HEADS, return_lse=True)
    assert not torch.isnan(got.float()).any()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=_forward_tol(dtype, v, want), rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dk", FORWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", RAGGED_FORWARD_SHAPES)
def test_ragged_forward_matches_plain_version(dtype, nq, nk, dk):
    _check_ragged_forward(dtype, nq, nk, dk)


def test_ragged_tiles_of_the_next_item_change_nothing():
    """Item 0's last query block and key tile hold item 1's rows: redrawing
    them leaves item 0's output and lse the same bit for bit, and equal to
    the attention over item 0 alone."""
    q, k, v = _inputs(36, "bfloat16", 100, 150)
    first = ragged_forward(q, k, v)
    alone = ragged_forward(q[:1], k[:1], v[:1])
    rng = np.random.RandomState(37)
    for t in (q, k, v):
        t[1] = torch.from_numpy(rng.randn(*t[1].shape).astype(np.float32)).to(t.dtype)
    second = ragged_forward(q, k, v)
    for a, b, c in zip(first, second, alone):
        assert torch.equal(a[0], b[0]) and torch.equal(a[:1], c)


def test_attention_pads_nothing_on_the_card(monkeypatch):
    """Without a gradient the eval attention hands a ragged key count to the
    kernel as it is (no padding copy); the backward gate takes any lengths
    (ROADMAP C1b) and refuses only what the forward's refuses."""
    calls = []

    class Ext:
        @staticmethod
        def flash_packed(q, k, v, out, lse, nk_valid, n_heads, sm_scale):
            calls.append((tuple(q.shape), tuple(k.shape), nk_valid))

    monkeypatch.setattr(attention, "kernel_route", lambda *t: True)
    monkeypatch.setattr(attention._build, "extension", lambda: Ext)
    q, k, v = _inputs(38, "bfloat16", 100, 150)
    with torch.no_grad():
        attention.attention(q, k, v, SCALE, HEADS)
    assert calls == [((B, 100, HEADS * DK), (B, 150, HEADS * DK), 150)]
    assert attention.flash_packed_supported(885, 885, 512, 4)
    assert attention.flash_bwd_supported(885, 885, 512, 4)
    assert attention.flash_bwd_supported(1024, 1000, 512, 4)
    assert attention.flash_bwd_supported(1024, 768, 512, 4)
    assert attention.flash_bwd_supported(885, 885, 256, 4)  # dk = 64
    assert not attention.flash_bwd_supported(885, 885, 128, 4)  # dk = 32


# (Nq, Nk): equal, Nq % 128 == 64 for both kernels' blocks, Nq != Nk
BACKWARD_SHAPES = [(128, 128), (320, 320), (256, 192)]


def _backward_tol(dtype, want):
    return 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(want).max()


def _check_tiled_backward(dtype, nq, nk, dk):
    q, k, v, do = _inputs(33, dtype, nq, nk, n=4, dk=dk)
    o, lse = attention.flash_mha_packed_ref(q, k, v, dk ** -0.5, HEADS, return_lse=True)
    got = tiled_backward(q, k, v, o, lse, do)
    want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, dk ** -0.5, HEADS)
    for g, w in zip(got, want):  # dq, dk, dv
        w = w.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol(dtype, w), rtol=0)


@pytest.mark.parametrize("dk", BACKWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", BACKWARD_SHAPES)
def test_tiled_backward_matches_plain_version(dtype, nq, nk, dk):
    _check_tiled_backward(dtype, nq, nk, dk)


def _check_backward_against_pallas(dtype, nq, nk, dk):
    q, k, v, do = _inputs(34, dtype, nq, nk, n=4, dk=dk)
    o, lse = tiled_forward(q, k, v)
    got = tiled_backward(q, k, v, o, lse, do)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def split(t):
        return jnp.asarray(_split(t).numpy(), jdt)

    want = _bwd_fused(*(split(t) for t in (q, k, v, o, do)), dk ** -0.5, nk, interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(g.shape)
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol(dtype, w), rtol=0)


@pytest.mark.parametrize("dk", BACKWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", BACKWARD_SHAPES)
def test_tiled_backward_matches_pallas(dtype, nq, nk, dk):
    """The whole chain in tile order (forward, then backward from its own
    output and lse) against _bwd_fused, which derives its row statistics
    from the whole score block (at any head dim)."""
    _check_backward_against_pallas(dtype, nq, nk, dk)


def ragged_backward(q, k, v, o, lse_tiles, do, block=128):
    """flash_bwd.cu at any Nq and Nk, from ``lse_tiles`` [B, H, ld] (ld = Nq
    rounded up to 64, +inf past Nq, as the wrapper hands it over): the
    delta pass writes delta in the same layout, 0 past Nq; the dK/dV kernel
    owns blocks of 128 keys and streams 64-row q tiles with the tile's lse
    and delta; the dQ kernel owns blocks of 128 queries (rows past Nq read
    row 0's statistics) and streams 64-key tiles, the keys past Nk masked
    to p = 0 by the count. Every tile is read as the TMA boxes read the
    flattened matrices; only rows below Nq (dq) and Nk (dk, dv) are
    stored. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, nq, d = q.shape
    nk = k.shape[1]
    scale = _scale(q)
    ld = lse_tiles.shape[-1]
    delta = torch.zeros(b, HEADS, ld)
    delta[..., :nq] = (_split(do) * _split(o)).sum(-1)
    dq = torch.full(q.shape, float("nan"), dtype=q.dtype)
    dk = torch.full(k.shape, float("nan"), dtype=k.dtype)
    dv = torch.full(v.shape, float("nan"), dtype=v.dtype)
    for key0 in range(0, nk, block):
        kh, vh = _split(_box_rows(k, key0, block)), _split(_box_rows(v, key0, block))
        acc_k, acc_v = torch.zeros(kh.shape), torch.zeros(vh.shape)
        for t0 in range(0, ld, TILE):
            qh = _split(_box_rows(q, t0, TILE))
            do_c = _split(_box_rows(do, t0, TILE)).to(v.dtype).float()
            st = kh @ qh.transpose(-1, -2) * scale
            pt = torch.exp(st - lse_tiles[:, :, None, t0:t0 + TILE])
            dst = (pt * (vh @ do_c.transpose(-1, -2) - delta[:, :, None, t0:t0 + TILE])
                   * scale).to(q.dtype).float()
            acc_v += pt.to(q.dtype).float() @ do_c
            acc_k += dst @ qh
        stored = min(block, nk - key0)
        dk[:, key0:key0 + stored] = _merge(acc_k, k.dtype)[:, :stored]
        dv[:, key0:key0 + stored] = _merge(acc_v, v.dtype)[:, :stored]
    for q0 in range(0, nq, block):
        qh = _split(_box_rows(q, q0, block))
        do_c = _split(_box_rows(do, q0, block)).to(v.dtype).float()
        rows = torch.arange(q0, q0 + block)
        rows = torch.where(rows < nq, rows, 0)
        lse_r, delta_r = lse_tiles[..., rows, None], delta[..., rows, None]
        acc = torch.zeros(qh.shape)
        for t0 in range(0, nk, TILE):
            kh, vh = _split(_box_rows(k, t0, TILE)), _split(_box_rows(v, t0, TILE))
            p = torch.exp(qh @ kh.transpose(-1, -2) * scale - lse_r)
            p[..., torch.arange(t0, t0 + TILE) >= nk] = 0.0
            ds = (p * (do_c @ vh.transpose(-1, -2) - delta_r) * scale).to(q.dtype).float()
            acc += ds @ kh
        stored = min(block, nq - q0)
        dq[:, q0:q0 + stored] = _merge(acc, q.dtype)[:, :stored]
    return dq, dk, dv


def _lse_tiles(lse):
    """The wrapper's padding of the forward's lse: whole 64-value tiles,
    +inf past Nq."""
    return torch.nn.functional.pad(lse, (0, -lse.shape[-1] % TILE), value=float("inf"))


# (Nq, Nk): both ragged; Nq ragged in a second q tile and a block of 128
# with one warpgroup's rows past the end; Nk ragged alone; Nq ragged alone
RAGGED_BACKWARD_SHAPES = [(100, 100), (130, 70), (64, 150), (245, 192)]


def _check_ragged_backward(dtype, nq, nk, dk):
    q, k, v, do = _inputs(39, dtype, nq, nk, n=4, dk=dk)
    o, lse = attention.flash_mha_packed_ref(q, k, v, dk ** -0.5, HEADS, return_lse=True)
    got = ragged_backward(q, k, v, o, _lse_tiles(lse), do)
    want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, dk ** -0.5, HEADS)
    for g, w in zip(got, want):  # dq, dk, dv: every row written
        assert not torch.isnan(g.float()).any()
        w = w.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol(dtype, w), rtol=0)


@pytest.mark.parametrize("dk", BACKWARD_DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", RAGGED_BACKWARD_SHAPES)
def test_ragged_backward_matches_plain_version(dtype, nq, nk, dk):
    _check_ragged_backward(dtype, nq, nk, dk)


def test_ragged_backward_tiles_of_the_next_item_change_nothing():
    """Item 0's last q tile, key tile and owned blocks hold item 1's rows:
    redrawing item 1 leaves item 0's dq, dk and dv the same bit for bit."""
    q, k, v, do = _inputs(40, "bfloat16", 100, 150, n=4)

    def grads(q, k, v, do):
        o, lse = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS, return_lse=True)
        return ragged_backward(q, k, v, o, _lse_tiles(lse), do)

    first = grads(q, k, v, do)
    rng = np.random.RandomState(41)
    for t in (q, k, v, do):
        t[1] = torch.from_numpy(rng.randn(*t[1].shape).astype(np.float32)).to(t.dtype)
    second = grads(q, k, v, do)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(first, second))


def test_flash_bwd_hands_the_kernels_lse_in_whole_tiles(monkeypatch):
    """On the kernel route a ragged Nq reaches the kernels with the lse
    padded per (b, h) to whole 64-value tiles with +inf and a delta scratch
    of the same shape; q, k, v, o and do go as they are. A stand-in for the
    extension runs ragged_backward on what it is given, which must equal
    the plain version."""
    seen = {}

    class Ext:
        @staticmethod
        def flash_bwd(q, k, v, o, do, lse, delta, dq, dk, dv, n_heads, sm_scale):
            seen.update(q=tuple(q.shape), k=tuple(k.shape), lse=lse.clone(),
                        delta=tuple(delta.shape))
            for out, got in zip((dq, dk, dv), ragged_backward(q, k, v, o, lse, do)):
                out.copy_(got)

    monkeypatch.setattr(attention, "kernel_route", lambda *t: True)
    monkeypatch.setattr(attention._build, "extension", lambda: Ext)
    q, k, v, do = _inputs(42, "bfloat16", 100, 70, n=4)
    o, lse = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS, return_lse=True)
    got = attention.flash_bwd(q, k, v, o, lse, do, SCALE, HEADS)
    assert seen["q"] == (B, 100, HEADS * DK) and seen["k"] == (B, 70, HEADS * DK)
    assert seen["lse"].shape == seen["delta"] == (B, HEADS, 128)
    assert torch.equal(seen["lse"][..., :100], lse)
    assert torch.isinf(seen["lse"][..., 100:]).all() and (seen["lse"][..., 100:] > 0).all()
    want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, SCALE, HEADS)
    for g, w in zip(got, want):
        w = w.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol("bfloat16", w),
                                   rtol=0)
