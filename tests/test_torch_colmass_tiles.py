"""The column-mass kernels' arithmetic in their own order, on the CPU.

csrc/colmass.cu runs only on the card. This file writes what its two
kernels compute in PyTorch, in their order of work, and holds it against
the port's plain version (``softmax_colmass_ref``) and against the JAX
package's Pallas kernels in interpret mode (``pallas_colmass.
softmax_colmass``), on the same seeded numpy inputs:

* the row logsumexps (flash_fwd.cuh's lse_kernel): 64-key tiles of
  S = Q . K^T in f32, a running max m of s * scale * log2(e) and a running
  sum l of exp2(s * scale * log2(e) - m), rescaled by exp2(m_old - m_new);
  one base-2 logsumexp m + log2(l) a row;
* the column masses: S^T = K . Q^T with the keys as rows, in 64-query tiles
  taken in ascending order, each key's sum of exp2(s * scale * log2(e) -
  lse2_i) kept across the tiles (in the kernel a lane adds its 16 columns
  of a tile and the quad's four sums are added at the end; here a tile's
  64 columns are one sum: the same terms in another order of f32
  additions).

Tolerances: f32 sums in another order and exp2 of the folded scale against
exp: 2e-5 of the largest mass (masses here are sums of at most 256
probabilities; the card is held to 1e-3 at 3072); every row's
probabilities sum to one, so the masses of a head sum to Nq (1e-5
relative). The gate takes every shape a served path gives it and a CUDA
tensor with a shape it refuses raises, with no plain version in its place.

The kernels take dk = 64, 128 and 256 (an instance each): each check runs
at every one of them (the ``dk`` parameter), with the same tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcrnet_tpu.ops import pallas_colmass
from vcrnet_tpu_torch.ops import _build, colmass

TILE = 64  # the key tile of the lse pass and the query tile of the mass pass
DK = 128
DKS = (64, 128, 256)  # the kernels' instances
LOG2E = 1.4426950408889634


def _split(x, heads):
    """[B, n, H*dk] -> f32 [B, H, n, dk]."""
    return x.float().reshape(x.shape[0], x.shape[1], heads, x.shape[-1] // heads).transpose(1, 2)


def tiled_lse2(q, k, scale, heads):
    """The first kernel: base-2 row logsumexps [B, H, Nq] f32."""
    qh, kh = _split(q, heads), _split(k, heads)
    scale_log2 = scale * LOG2E
    m = torch.full(qh.shape[:3], float("-inf"))
    l = torch.zeros(qh.shape[:3])
    for t0 in range(0, kh.shape[2], TILE):
        s = qh @ kh[:, :, t0:t0 + TILE].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        l = l * torch.exp2(m - m_new) + torch.exp2(s * scale_log2 - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log2(l)


def tiled_colmass(q, k, scale, heads):
    """Both kernels in their order: masses [B, H, Nk] f32."""
    lse2 = tiled_lse2(q, k, scale, heads)
    qh, kh = _split(q, heads), _split(k, heads)
    scale_log2 = scale * LOG2E
    mass = torch.zeros(kh.shape[:3])
    for t0 in range(0, qh.shape[2], TILE):
        st = kh @ qh[:, :, t0:t0 + TILE].transpose(-1, -2)  # [B, H, keys, 64 queries]
        mass += torch.exp2(st * scale_log2 - lse2[:, :, None, t0:t0 + TILE]).sum(-1)
    return mass


def _inputs(seed, b, nq, nk, heads, dtype, dk=DK):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nq, heads * dk).astype(np.float32)
    k = rng.randn(b, nk, heads * dk).astype(np.float32)
    return (torch.from_numpy(q).to(getattr(torch, dtype)),
            torch.from_numpy(k).to(getattr(torch, dtype)))


def _close(got, want, nq):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-5 * want.abs().max().item())
    np.testing.assert_allclose(got.sum(-1).numpy(), np.full(got.shape[:2], nq), rtol=1e-5)


# (B, Nq, Nk, heads): one batch item, Nq = Nk = 128 (one key block, two
# query tiles), Nq != Nk both ways, Nk % 128 == 64 (the last key block's
# second warpgroup owns no keys), Nq % 128 == 64 (the lse pass's likewise)
SHAPES = [(1, 128, 128, 1), (2, 128, 256, 2), (2, 256, 128, 2), (2, 128, 192, 2),
          (1, 192, 128, 1), (2, 256, 256, 4)]


def _check_tiled_colmass(dtype, b, nq, nk, heads, dk):
    q, k = _inputs(11, b, nq, nk, heads, dtype, dk)
    scale = dk ** -0.5
    got = tiled_colmass(q, k, scale, heads)
    want = colmass.softmax_colmass_ref(q, k, scale, heads)
    assert got.shape == want.shape == (b, heads, nk)
    _close(got, want, nq)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(colmass.softmax_colmass(q, k, scale, heads), want)


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,heads", SHAPES)
def test_tiled_colmass_matches_plain_version(dtype, b, nq, nk, heads, dk):
    _check_tiled_colmass(dtype, b, nq, nk, heads, dk)



def _check_lse2(dtype, dk):
    q, k = _inputs(12, 2, 128, 320, 2, dtype, dk)
    scale = dk ** -0.5
    s = torch.matmul(_split(q, 2), _split(k, 2).transpose(-1, -2)) * scale
    want = torch.logsumexp(s, -1) * LOG2E
    np.testing.assert_allclose(tiled_lse2(q, k, scale, 2).numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_lse2_is_the_base2_logsumexp(dtype, dk):
    _check_lse2(dtype, dk)



def _check_against_pallas(dtype, b, nq, nk, heads, dk):
    q, k = _inputs(13, b, nq, nk, heads, dtype, dk)
    scale = dk ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def merged(x):  # packed [B, N, H*dk] -> the JAX layout [B*H, N, dk]
        return jnp.asarray(x.float().numpy(), jdt).reshape(b, -1, heads, dk).transpose(
            0, 2, 1, 3).reshape(b * heads, -1, dk)

    want = np.array(pallas_colmass.softmax_colmass(merged(q), merged(k), scale,
                                                    interpret=True)).reshape(b, heads, nk)
    _close(tiled_colmass(q, k, scale, heads), torch.from_numpy(want), nq)


PALLAS_SHAPES = [(2, 128, 256, 2), (1, 256, 128, 1)]


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nk,heads", PALLAS_SHAPES)
def test_tiled_colmass_matches_pallas(dtype, b, nq, nk, heads, dk):
    _check_against_pallas(dtype, b, nq, nk, heads, dk)



def _box_rows(x, r0, rows):
    """Rows r0 .. r0 + rows of every item as a TMA box of the flattened
    [B * N, D] matrix sees them: the next item's rows past N, zeros past the
    end of the tensor."""
    b, n, d = x.shape
    flat = torch.cat([x.float().reshape(b * n, d), torch.zeros(rows + TILE, d)])
    return flat[torch.arange(b)[:, None] * n + r0 + torch.arange(rows)]


def ragged_colmass(q, k, scale, heads):
    """Both kernels at any Nq and Nk, their tiles read as the TMA boxes
    read them. The lse pass masks keys past Nk by the count and writes the
    rows below Nq into a scratch of whole 64-row tiles (the rest holds
    whatever was there: NaN here); the mass pass gives the columns of its
    last query tile past Nq a score of 0 and an lse of +inf, and stores the
    keys below Nk."""
    b, nq, _ = q.shape
    nk = k.shape[1]
    scale_log2 = scale * LOG2E
    n_tiles = -(-nq // TILE)
    lse2 = torch.full((b, heads, n_tiles * TILE), float("nan"))
    qh = _split(q, heads)
    m = torch.full(qh.shape[:3], float("-inf"))
    l = torch.zeros(qh.shape[:3])
    for t0 in range(0, nk, TILE):
        s = qh @ _split(_box_rows(k, t0, TILE), heads).transpose(-1, -2)
        s[..., torch.arange(t0, t0 + TILE) >= nk] = float("-inf")
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        l = l * torch.exp2(m - m_new) + torch.exp2(s * scale_log2 - m_new[..., None]).sum(-1)
        m = m_new
    lse2[..., :nq] = m + torch.log2(l)
    kh = _split(_box_rows(k, 0, -(-nk // TILE) * TILE), heads)  # keys past Nk: not stored
    mass = torch.zeros(kh.shape[:3])
    for t in range(n_tiles):
        st = kh @ _split(_box_rows(q, t * TILE, TILE), heads).transpose(-1, -2)
        lt = lse2[:, :, None, t * TILE:(t + 1) * TILE].clone()
        past = torch.arange(t * TILE, (t + 1) * TILE) >= nq
        st[..., past] = 0.0
        lt[..., past] = float("inf")
        mass += torch.exp2(st * scale_log2 - lt).sum(-1)
    return mass[..., :nk]


RAGGED_SHAPES = [(100, 100), (130, 70), (70, 200), (245, 185)]


def _check_ragged(dtype, nq, nk, dk):
    q, k = _inputs(14, 2, nq, nk, 2, dtype, dk)
    scale = dk ** -0.5
    got = ragged_colmass(q, k, scale, 2)
    assert not torch.isnan(got).any()
    _close(got, colmass.softmax_colmass_ref(q, k, scale, 2), nq)


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", RAGGED_SHAPES)
def test_ragged_colmass_matches_plain_version(dtype, nq, nk, dk):
    _check_ragged(dtype, nq, nk, dk)



def test_ragged_tiles_of_the_next_item_change_nothing():
    """Item 0's last query tile and key block hold item 1's rows: redrawing
    them leaves item 0's masses the same bit for bit."""
    q, k = _inputs(15, 2, 100, 150, 2, "bfloat16")
    scale = DK ** -0.5
    first = ragged_colmass(q, k, scale, 2)
    rng = np.random.RandomState(16)
    for t in (q, k):
        t[1] = torch.from_numpy(rng.randn(*t[1].shape).astype(np.float32)).to(t.dtype)
    assert torch.equal(first[0], ragged_colmass(q, k, scale, 2)[0])


def test_gate_takes_every_served_shape():
    """The decoder streams the re-mask at nk > stream_above with Nq and Nk
    in 128s (models/transformer.py); the partial-3072 request gives 3072 by
    3072, and the kernels also take the edges the card is held to."""
    for nq, nk in [(3072, 3072), (1024, 3072), (3072, 1024), (128, 128), (4096, 4096)]:
        assert colmass.colmass_supported(nq, nk, 512, 4), (nq, nk)
    for n in range(128, 8193, 128):
        assert colmass.colmass_supported(n, n, 512, 4)
    assert colmass.colmass_supported(192, 320, 256, 2)  # lengths in 64s
    assert colmass.colmass_supported(3072, 3072, 512, 8)  # dk = 64
    assert colmass.colmass_supported(3072, 3072, 1024, 4)  # dk = 256 (--emb_dims 1024)
    assert not colmass.colmass_supported(3072, 3072, 256, 8)  # dk = 32
    assert not colmass.colmass_supported(3072, 3072, 2048, 4)  # dk = 512
    # ragged lengths: the last tiles mask by counts (ROADMAP C1)
    assert colmass.colmass_supported(3000, 3072, 512, 4)
    assert colmass.colmass_supported(3072, 3000, 512, 4)


def _as_if_on_the_card(monkeypatch):
    """Route as a CUDA tensor would, and record what reaches the extension."""
    calls = []

    class Ext:
        @staticmethod
        def softmax_colmass(q, k, lse, out, heads, scale):
            calls.append((tuple(q.shape), tuple(k.shape), tuple(lse.shape), tuple(out.shape)))

    monkeypatch.setattr(colmass, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", lambda: Ext)
    monkeypatch.setattr(colmass, "softmax_colmass_ref", None)  # no plain version on the card
    return calls


@pytest.mark.parametrize("nq,nk,d,heads", [(3072, 3072, 384, 4), (3072, 3072, 2048, 4),
                                           (3072, 3072, 256, 8)])
def test_a_refused_shape_raises_on_the_card(monkeypatch, nq, nk, d, heads):
    calls = _as_if_on_the_card(monkeypatch)
    q = torch.zeros(1, nq, d, dtype=torch.bfloat16)
    k = torch.zeros(1, nk, d, dtype=torch.bfloat16)
    before = colmass.softmax_colmass.launches
    with pytest.raises(ValueError, match="softmax_colmass kernel takes"):
        colmass.softmax_colmass(q, k, 0.1, heads)
    assert not calls and colmass.softmax_colmass.launches == before


def test_a_served_shape_launches_the_kernel_once(monkeypatch):
    calls = _as_if_on_the_card(monkeypatch)
    q = torch.zeros(2, 3072, 512, dtype=torch.bfloat16)
    before = colmass.softmax_colmass.launches
    out = colmass.softmax_colmass(q, q, 128 ** -0.5, 4)
    assert out.shape == (2, 4, 3072) and out.dtype == torch.float32
    assert calls == [((2, 3072, 512), (2, 3072, 512), (2, 4, 3072), (2, 4, 3072))]
    assert colmass.softmax_colmass.launches == before + 1
    # a ragged Nq: the row logsumexps' scratch fills whole 64-query tiles
    colmass.softmax_colmass(q[:, :3000].contiguous(), q, 128 ** -0.5, 4)
    assert calls[-1] == ((2, 3000, 512), (2, 3072, 512), (2, 4, 3008), (2, 4, 3072))
    with pytest.raises(TypeError, match="bfloat16"):  # the kernel takes bf16 alone
        colmass.softmax_colmass(q.float(), q.float(), 128 ** -0.5, 4)
