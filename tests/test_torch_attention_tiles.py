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
  softmax"): these tests bound that divergence;
* backward: dK and dV summed tile by tile over 64-row query tiles (the
  dK/dV kernel's loop), dQ over 64-key tiles (the dQ kernel's loop), each
  tile's product added to an f32 accumulator; p = exp(s - lse), dS and P
  rounded to q's dtype before their products.

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


def _split(x):
    """[B, n, H*dk] -> f32 [B, H, n, dk]."""
    return x.float().reshape(x.shape[0], x.shape[1], HEADS, DK).transpose(1, 2)


def _merge(x4, dtype):
    return x4.transpose(1, 2).reshape(x4.shape[0], x4.shape[2], HEADS * DK).to(dtype)


def tiled_forward(q, k, v, nk_valid=None):
    """flash_packed.cu's order: returns (out in q's dtype, lse f32 [B, H, Nq])."""
    nk = k.shape[1]
    nkv = nk if nk_valid is None else nk_valid
    qh, kh, vh = _split(q), _split(k), _split(v)
    m = torch.full(qh.shape[:3], float("-inf"))
    l = torch.zeros(qh.shape[:3])
    o = torch.zeros(qh.shape)
    for t0 in range(0, nkv, TILE):  # tiles wholly past nk_valid are not visited
        s = qh @ kh[:, :, t0:t0 + TILE].transpose(-1, -2) * SCALE
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
    qh, kh, vh, oh, doh = (_split(t) for t in (q, k, v, o, do))
    delta = (doh * oh).sum(-1)
    do_c = doh.to(v.dtype).float()
    nq, nk = qh.shape[2], kh.shape[2]

    def ds_of(s, p_rows_lse, dp, delta_rows):
        p = torch.exp(s - p_rows_lse)
        return p, (p * (dp - delta_rows) * SCALE).to(q.dtype).float()

    # dK/dV kernel: every key block loops over the 64-row query tiles
    dk, dv = torch.zeros(kh.shape), torch.zeros(vh.shape)
    for t0 in range(0, nq, TILE):
        rows = slice(t0, t0 + TILE)
        st = kh @ qh[:, :, rows].transpose(-1, -2) * SCALE  # S^T [keys, tile]
        dpt = vh @ do_c[:, :, rows].transpose(-1, -2)
        pt, dst = ds_of(st, lse[:, :, None, rows], dpt, delta[:, :, None, rows])
        dv += pt.to(q.dtype).float() @ do_c[:, :, rows]
        dk += dst @ qh[:, :, rows]
    # dQ kernel: every query block loops over the 64-key tiles
    dq = torch.zeros(qh.shape)
    for t0 in range(0, nk, TILE):
        keys = slice(t0, t0 + TILE)
        s = qh @ kh[:, :, keys].transpose(-1, -2) * SCALE
        dp = do_c @ vh[:, :, keys].transpose(-1, -2)
        _, ds = ds_of(s, lse[..., None], dp, delta[..., None])
        dq += ds @ kh[:, :, keys]
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _inputs(seed, dtype, nq, nk, nk_valid=None, n=3):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, nq, HEADS * DK).astype(np.float32)]
    arrays += [rng.randn(B, nk, HEADS * DK).astype(np.float32) for _ in range(2)]
    arrays += [rng.randn(B, nq, HEADS * DK).astype(np.float32) for _ in range(n - 3)]
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,nk_valid", FORWARD_SHAPES)
def test_tiled_forward_matches_plain_version(dtype, nq, nk, nk_valid):
    q, k, v = _inputs(30, dtype, nq, nk, nk_valid)
    got, got_lse = tiled_forward(q, k, v, nk_valid)
    want, want_lse = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS, return_lse=True,
                                                    nk_valid=nk_valid)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=_forward_tol(dtype, v, want), rtol=0)
    # lse: f32 sums of exponentials in another order and at other maxima
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-5, rtol=0)


def test_tiled_forward_with_one_tile_rounds_as_the_plain_version():
    """With one key tile the running max is the final max: P is rounded at
    the same values, so bf16 outputs agree to one ulp of the f32 sum order."""
    q, k, v = _inputs(31, "bfloat16", 128, 64)
    got, _ = tiled_forward(q, k, v)
    want = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2 ** -8 * want.float().abs().max().item(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk,nk_valid", [(128, 256, None), (256, 384, 256)])
def test_tiled_forward_matches_pallas(dtype, nq, nk, nk_valid):
    """_flash_packed_impl takes multiples of 128 and no valid-key count: with
    one, it sees the real keys alone (nk_valid at a 128-key boundary)."""
    q, k, v = _inputs(32, dtype, nq, nk, nk_valid)
    got, _ = tiled_forward(q, k, v, nk_valid)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    nkv = nk if nk_valid is None else nk_valid
    want = np.asarray(_flash_packed_impl(
        *(jnp.asarray(t.float().numpy(), jdt) for t in (q, k[:, :nkv], v[:, :nkv])),
        SCALE, HEADS, interpret=True)).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=_forward_tol(dtype, v, torch.from_numpy(want)), rtol=0)


# (Nq, Nk): equal, Nq % 128 == 64 for both kernels' blocks, Nq != Nk
BACKWARD_SHAPES = [(128, 128), (320, 320), (256, 192)]


def _backward_tol(dtype, want):
    return 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", BACKWARD_SHAPES)
def test_tiled_backward_matches_plain_version(dtype, nq, nk):
    q, k, v, do = _inputs(33, dtype, nq, nk, n=4)
    o, lse = attention.flash_mha_packed_ref(q, k, v, SCALE, HEADS, return_lse=True)
    got = tiled_backward(q, k, v, o, lse, do)
    want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, SCALE, HEADS)
    for g, w in zip(got, want):  # dq, dk, dv
        w = w.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol(dtype, w), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", BACKWARD_SHAPES)
def test_tiled_backward_matches_pallas(dtype, nq, nk):
    """The whole chain in tile order (forward, then backward from its own
    output and lse) against _bwd_fused, which derives its row statistics
    from the whole score block."""
    q, k, v, do = _inputs(34, dtype, nq, nk, n=4)
    o, lse = tiled_forward(q, k, v)
    got = tiled_backward(q, k, v, o, lse, do)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def split(t):
        return jnp.asarray(_split(t).numpy(), jdt)

    want = _bwd_fused(*(split(t) for t in (q, k, v, o, do)), SCALE, nk, interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3).reshape(g.shape)
        np.testing.assert_allclose(g.float().numpy(), w, atol=_backward_tol(dtype, w), rtol=0)
