"""The soft-correspondence kernels' arithmetic in their own order, on the CPU.

csrc/vcp_stream.cu and csrc/vcp_bwd.cu run only on the card. This file
writes what they compute in PyTorch, in their tile order and at their
rounding points, and holds it against the port's plain versions
(``streaming_soft_correspondence_ref``, ``vcp_bwd_ref``) and against the
JAX package's Pallas kernels in interpret mode (``_run_streaming``, and the
VJP of ``soft_correspondence_vjp``), on the same seeded numpy inputs:

* forward: blocks of 128 source rows (a last block with fewer real rows
  runs other rows in place of the missing ones, and drops them); 64-key
  tiles read as the TMA boxes read the flattened [B * Nt, E] matrix (past
  Nt the next item's rows, then zeros), whose keys past Nt have an infinite
  norm and xyz 0 (the packing pass): they score -inf and add nothing;
  each tile's scores summed over E in chunks of 128 columns (two boxes; E padded with
  zeros to whole 64-column boxes, as TMA fills them); an online softmax
  in base 2 with a running max m, the sum l and the xyz sums rescaled by
  exp2(m_old - m_new); lse = m ln 2 + log l;
* backward, d_src kernel: 64-row blocks over 64-key tiles; d_tgt_emb
  kernel: 64-key blocks over 64-row source tiles, S^T computed directly.
  In both, each consumer warpgroup computes partial scores over its half
  of E (256 columns; E padded with zeros to 512), and each score is the
  sum of the two partials, the owning warpgroup's first (warpgroup 0 owns
  the tile's first 32 columns); p = exp2((2 s - |f|^2 - lse) log2 e);
  ds = p (dp - delta) rounded to the embeddings' dtype, and p likewise for d_tgt;
  the -2 colsum(ds) f term is applied once at the end, as 2 (acc - cs f).
  At lengths that are no multiple of 64 the owned rows and the streamed
  tiles are read as the TMA boxes read the flattened matrices, and the
  packed values come in whole 64-row tiles an item: keys past Nt (0, 0, 0,
  +inf), source rows past Ns (g, delta) = 0 with lse +inf, so p = 0 there;
  rows past Ns or Nt are not stored.

Tolerances, each with its reason:
* f32 forward: 1e-5 absolute (sums of values of order one in another order,
  base-2 exponentials); the Pallas kernel's hi/lo bf16 split of tgt adds
  ~2^-18 relative;
* backward: 1e-5 of the largest gradient in f32 (sums in another order);
  in bf16 one bf16 ulp of the largest gradient, 2^-8 of it (ds is rounded
  to bf16 at f32 values that differ in the last bits).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.ops.pallas_vcp import _run_streaming, soft_correspondence_vjp
from vcrnet_tpu_torch.ops import vcp

ROWS = 128   # source rows of a forward block (two warpgroups of 64)
TILE = 64    # keys (forward, d_src) or source rows (d_tgt_emb) of a streamed tile
CHUNK = 128  # columns of E of one forward ring stage
BOX = 64
HALF_E = 256  # columns of E a backward consumer warpgroup owns
LOG2E = 1.0 / math.log(2.0)
B = 2


def _pad_e(x):
    """[B, n, E] f32, zero-padded to whole 64-column boxes."""
    e = x.shape[-1]
    return torch.nn.functional.pad(x.float(), (0, -e % BOX))


def _scores_in_halves(own, tile):
    """own [B, 64, E], tile [B, 64, E] -> [B, 64, 64]: the partial scores
    over each half of 512 columns (E padded with zeros), added, the half
    that owns the column first."""
    own, tile = (torch.nn.functional.pad(t, (0, HALF_E * 2 - t.shape[-1])) for t in (own, tile))
    part = [own[..., h * HALF_E:(h + 1) * HALF_E] @ tile[..., h * HALF_E:(h + 1) * HALF_E]
            .transpose(1, 2) for h in range(2)]
    return torch.cat([part[0][..., :32] + part[1][..., :32], part[1][..., 32:] + part[0][..., 32:]],
                     -1)


def tiled_forward(se, te, tgt):
    """vcp_stream.cu's order: (corr [B, Ns, 3], lse [B, Ns]) in f32."""
    q, f = _pad_e(se), _pad_e(te)
    ns, nt, e = q.shape[1], f.shape[1], q.shape[2]
    pad = -nt % TILE
    # the packing pass: -|f|^2 log2(e) of whole tiles, -inf (norm +inf) and
    # xyz 0 past Nt
    nb2 = torch.nn.functional.pad(-(f * f).sum(-1) * LOG2E, (0, pad), value=float("-inf"))
    xyz = torch.nn.functional.pad(tgt.float(), (0, 0, 0, pad))
    # the key tiles as the TMA boxes see the flattened [B * Nt, E] matrix
    f = torch.cat([f.reshape(B * nt, e), torch.zeros(TILE, e)])
    f = f[torch.arange(B)[:, None] * nt + torch.arange(nt + pad)]
    corr, lse = torch.zeros(B, ns, 3), torch.zeros(B, ns)
    for b in range(B):
        for r0 in range(0, ns, ROWS):
            rows = q[b, torch.arange(r0, r0 + ROWS).clamp(max=ns - 1)][None]
            m = torch.full((1, ROWS), float("-inf"))
            l, acc = torch.zeros(1, ROWS), torch.zeros(1, ROWS, 3)
            for t0 in range(0, nt + pad, TILE):
                keys = f[b:b + 1, t0:t0 + TILE]
                s = torch.zeros(1, ROWS, TILE)
                for c0 in range(0, e, CHUNK):
                    s = s + rows[..., c0:c0 + CHUNK] @ keys[..., c0:c0 + CHUNK].transpose(1, 2)
                s2 = s * (2 * LOG2E) + nb2[b, t0:t0 + TILE]
                m_new = torch.maximum(m, s2.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s2 - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ xyz[b:b + 1, t0:t0 + TILE]
                m = m_new
            n = min(ROWS, ns - r0)
            corr[b, r0:r0 + n] = (acc / l[..., None])[0, :n]
            lse[b, r0:r0 + n] = (m * math.log(2.0) + torch.log(l))[0, :n]
    return corr, lse


def tiled_backward(se, te, tgt, corr, lse, dcorr):
    """vcp_bwd.cu's order: (d_src, d_tgt_emb, d_tgt) in f32."""
    dt = se.dtype
    q, f = _pad_e(se), _pad_e(te)
    ns, nt, e = q.shape[1], f.shape[1], se.shape[2]
    g = dcorr.float()
    delta = (g * corr.float()).sum(-1)  # [B, Ns]
    xyz = tgt.float()
    nb2 = -(f * f).sum(-1) * LOG2E
    nl2 = -lse * LOG2E

    def ds_and_p(s, nbias, dp, dlt):
        p = torch.exp2(s * (2 * LOG2E) + nbias)
        return (p * (dp - dlt)).to(dt).float(), p.to(dt).float()

    # d_src kernel: every 64-row block loops over the 64-key tiles
    d_src = torch.zeros(B, ns, q.shape[2])
    for r0 in range(0, ns, TILE):
        own, rows = q[:, r0:r0 + TILE], slice(r0, r0 + TILE)
        for t0 in range(0, nt, TILE):
            keys = slice(t0, t0 + TILE)
            s = _scores_in_halves(own, f[:, keys])
            dp = g[:, rows] @ xyz[:, keys].transpose(1, 2)
            ds, _ = ds_and_p(s, nb2[:, None, keys] + nl2[:, rows, None], dp, delta[:, rows, None])
            d_src[:, rows] += ds @ f[:, keys]
    # d_tgt_emb kernel: every 64-key block loops over the 64-row source tiles
    d_tgt_emb, d_tgt = torch.zeros(B, nt, q.shape[2]), torch.zeros(B, nt, 3)
    for k0 in range(0, nt, TILE):
        own, keys = f[:, k0:k0 + TILE], slice(k0, k0 + TILE)
        acc, cs = torch.zeros(B, TILE, q.shape[2]), torch.zeros(B, TILE)
        for t0 in range(0, ns, TILE):
            rows = slice(t0, t0 + TILE)
            st = _scores_in_halves(own, q[:, rows])  # S^T: [keys, source rows]
            dpt = xyz[:, keys] @ g[:, rows].transpose(1, 2)
            dst, pt = ds_and_p(st, nb2[:, keys, None] + nl2[:, None, rows], dpt,
                               delta[:, None, rows])
            cs += dst.sum(-1)
            d_tgt[:, keys] += pt @ g[:, rows]
            acc += dst @ q[:, rows]
        d_tgt_emb[:, keys] = 2.0 * (acc - cs[..., None] * own)
    return 2.0 * d_src[..., :e], d_tgt_emb[..., :e], d_tgt


def _inputs(seed, dtype, ns, nt, e):
    rng = np.random.RandomState(seed)
    se = (rng.randn(B, ns, e) * 0.3).astype(np.float32)
    te = (rng.randn(B, nt, e) * 0.3).astype(np.float32)
    tgt = rng.uniform(-1, 1, (B, nt, 3)).astype(np.float32)
    dcorr = rng.randn(B, ns, 3).astype(np.float32)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(se).to(tdt), torch.from_numpy(te).to(tdt), torch.from_numpy(tgt),
            torch.from_numpy(dcorr))


def _bwd_tol(dtype, want):
    scale = np.abs(want).max()
    return 1e-5 * max(1.0, scale) if dtype == "float32" else 2 ** -8 * scale


# (Ns, Nt, E): one tile each way; Ns % 128 == 64 with Ns != Nt both ways;
# E with a box partly past it (zero-filled); two 128-column chunks; ragged
# lengths (the last tiles reach into the next item, or past the end)
SHAPES = [(64, 64, 128), (320, 192, 256), (192, 320, 80), (128, 256, 256)]
RAGGED_SHAPES = [(100, 100, 128), (130, 70, 80), (70, 150, 256)]


@pytest.mark.parametrize("ns,nt,e", SHAPES + RAGGED_SHAPES)
def test_tiled_forward_matches_plain_version(ns, nt, e):
    se, te, tgt, _ = _inputs(40, "bfloat16", ns, nt, e)
    got, got_lse = tiled_forward(se, te, tgt)
    want, want_lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(),
                               atol=1e-5 * max(1.0, want_lse.abs().max().item()), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,nt,e", SHAPES)
def test_tiled_backward_matches_plain_version(dtype, ns, nt, e):
    se, te, tgt, dcorr = _inputs(41, dtype, ns, nt, e)
    corr, lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
    got = tiled_backward(se, te, tgt, corr, lse, dcorr)
    want = vcp.vcp_bwd_ref(se, te, tgt, corr, lse, dcorr)
    for g, w in zip(got, want):  # d_src, d_tgt_emb, d_tgt
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=_bwd_tol(dtype, w), rtol=0)


@pytest.mark.parametrize("ns,nt,e", [(192, 128, 128), (128, 320, 80)])
def test_tiled_forward_matches_pallas(ns, nt, e):
    se, te, tgt, _ = _inputs(42, "bfloat16", ns, nt, e)
    got, got_lse = tiled_forward(se, te, tgt)
    want, want_lse = _run_streaming(*(jnp.asarray(t.float().numpy(), d) for t, d in (
        (se, jnp.bfloat16), (te, jnp.bfloat16), (tgt, jnp.float32))), 128, 1024, True, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    want_lse = np.asarray(want_lse)[..., 0]
    np.testing.assert_allclose(got_lse.numpy(), want_lse,
                               atol=1e-5 * max(1.0, np.abs(want_lse).max()), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,nt,e", [(192, 128, 128), (128, 320, 80)])
def test_tiled_chain_matches_pallas_vjp(dtype, ns, nt, e):
    """The whole chain in tile order (forward, then the backward from its
    own corr and lse) against jax.vjp of the Pallas pair."""
    se, te, tgt, dcorr = _inputs(43, dtype, ns, nt, e)
    corr, lse = tiled_forward(se, te, tgt)
    got = tiled_backward(se, te, tgt, corr, lse, dcorr)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b, c: soft_correspondence_vjp(a, b, c, True),
                     jnp.asarray(se.float().numpy(), jdt), jnp.asarray(te.float().numpy(), jdt),
                     jnp.asarray(tgt.numpy()))
    want = vjp(jnp.asarray(dcorr.numpy()))
    for g, w in zip(got, want):  # the Pallas VJP returns the inputs' dtypes
        w = np.asarray(w.astype(jnp.float32))
        g = g.to(getattr(torch, dtype)).float().numpy()
        np.testing.assert_allclose(g, w, atol=_bwd_tol(dtype, w), rtol=0)


def test_ragged_tiles_of_the_next_item_change_nothing():
    """Item 0's last key tile holds item 1's rows (and its last block item
    1's source rows): redrawing item 1 leaves item 0's corr and lse the same
    bit for bit."""
    se, te, tgt, _ = _inputs(44, "bfloat16", 100, 150, 128)
    first = tiled_forward(se, te, tgt)
    rng = np.random.RandomState(45)
    for t in (se, te, tgt):
        t[1] = torch.from_numpy(rng.randn(*t[1].shape).astype(np.float32)).to(t.dtype)
    second = tiled_forward(se, te, tgt)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(first, second))


def test_vcp_gates_take_every_served_and_trained_shape():
    """The kernels' gate (ROADMAP C, "VCP kernels' gate"): every N the
    served and trained paths give, Ns != Nt, E = 512; never E > 512. Both
    take any lengths (ROADMAP C1, C1b)."""
    for ns, nt in ((1024, 1024), (512, 512), (512, 1024), (1024, 512), (320, 320), (64, 64)):
        assert vcp.streaming_supported(ns, nt, 512)
        assert vcp.streaming_vjp_supported(ns, nt, 512)
    assert vcp.streaming_supported(64, 64, 16) and vcp.streaming_supported(64, 64, 80)
    for ns, nt, e in ((1024, 1024, 1024), (1024, 1024, 520)):
        assert not vcp.streaming_supported(ns, nt, e)
        assert not vcp.streaming_vjp_supported(ns, nt, e)
    for ns, nt, e in ((1024, 48, 512), (96, 64, 512), (885, 885, 512), (1000, 1000, 512)):
        assert vcp.streaming_supported(ns, nt, e)
        assert vcp.streaming_vjp_supported(ns, nt, e)


def _flat_rows(x, pad_to):
    """[B, n, E] -> [B, pad_to, E]: each item's rows 0 .. pad_to - 1 as a TMA
    box of the flattened [B * n, E] matrix sees them (past n the next
    item's rows, then zeros)."""
    b, n, e = x.shape
    flat = torch.cat([x.reshape(b * n, e), torch.zeros(pad_to, e)])
    return flat[torch.arange(b)[:, None] * n + torch.arange(pad_to)]


def ragged_backward(se, te, tgt, corr, lse, dcorr):
    """vcp_bwd.cu at any Ns and Nt: (d_src, d_tgt_emb, d_tgt) in f32, every
    row past Ns or Nt left NaN if it were stored. The packing passes write
    whole 64-row tiles an item (keys past Nt: xyz 0, norm +inf; source rows
    past Ns: g = 0, delta = 0), the wrapper pads lse with +inf; the tiles
    and owned rows are read as the TMA boxes read them."""
    dt = se.dtype
    q, f = _pad_e(se), _pad_e(te)
    ns, nt, e = q.shape[1], f.shape[1], se.shape[2]
    ns_p, nt_p = ns + -ns % TILE, nt + -nt % TILE
    pad = torch.nn.functional.pad
    g = pad(dcorr.float(), (0, 0, 0, ns_p - ns))
    delta = pad((dcorr.float() * corr.float()).sum(-1), (0, ns_p - ns))
    nl2 = -pad(lse, (0, ns_p - ns), value=float("inf")) * LOG2E
    xyz = pad(tgt.float(), (0, 0, 0, nt_p - nt))
    nb2 = -pad((f * f).sum(-1), (0, nt_p - nt), value=float("inf")) * LOG2E
    qb, fb = _flat_rows(q, ns_p), _flat_rows(f, nt_p)  # owned rows and tiles

    def ds_and_p(s, nbias, dp, dlt):
        p = torch.exp2(s * (2 * LOG2E) + nbias)
        return (p * (dp - dlt)).to(dt).float(), p.to(dt).float()

    d_src = torch.full((B, ns, q.shape[2]), float("nan"))
    for r0 in range(0, ns_p, TILE):
        own, rows = qb[:, r0:r0 + TILE], slice(r0, r0 + TILE)
        acc = torch.zeros(B, TILE, q.shape[2])
        for t0 in range(0, nt_p, TILE):
            keys = slice(t0, t0 + TILE)
            s = _scores_in_halves(own, fb[:, keys])
            dp = g[:, rows] @ xyz[:, keys].transpose(1, 2)
            ds, _ = ds_and_p(s, nb2[:, None, keys] + nl2[:, rows, None], dp, delta[:, rows, None])
            acc += ds @ fb[:, keys]
        n = min(TILE, ns - r0)
        d_src[:, r0:r0 + n] = 2.0 * acc[:, :n]
    d_tgt_emb = torch.full((B, nt, q.shape[2]), float("nan"))
    d_tgt = torch.full((B, nt, 3), float("nan"))
    for k0 in range(0, nt_p, TILE):
        own, keys = fb[:, k0:k0 + TILE], slice(k0, k0 + TILE)
        acc, cs, dxyz = torch.zeros(B, TILE, q.shape[2]), torch.zeros(B, TILE), torch.zeros(B, TILE, 3)
        for t0 in range(0, ns_p, TILE):
            rows = slice(t0, t0 + TILE)
            st = _scores_in_halves(own, qb[:, rows])  # S^T: [keys, source rows]
            dpt = xyz[:, keys] @ g[:, rows].transpose(1, 2)
            dst, pt = ds_and_p(st, nb2[:, keys, None] + nl2[:, None, rows], dpt,
                               delta[:, None, rows])
            cs += dst.sum(-1)
            dxyz += pt @ g[:, rows]
            acc += dst @ qb[:, rows]
        n = min(TILE, nt - k0)
        d_tgt_emb[:, k0:k0 + n] = (2.0 * (acc - cs[..., None] * own))[:, :n]
        d_tgt[:, k0:k0 + n] = dxyz[:, :n]
    return d_src[..., :e], d_tgt_emb[..., :e], d_tgt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,nt,e", RAGGED_SHAPES + [(64, 70, 128)])
def test_ragged_backward_matches_plain_version(dtype, ns, nt, e):
    se, te, tgt, dcorr = _inputs(46, dtype, ns, nt, e)
    corr, lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
    got = ragged_backward(se, te, tgt, corr, lse, dcorr)
    want = vcp.vcp_bwd_ref(se, te, tgt, corr, lse, dcorr)
    for g, w in zip(got, want):  # d_src, d_tgt_emb, d_tgt: every row written
        assert not torch.isnan(g).any()
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=_bwd_tol(dtype, w), rtol=0)


def test_ragged_backward_tiles_of_the_next_item_change_nothing():
    """Item 0's last source and key tiles (streamed and owned) hold item 1's
    rows: redrawing item 1 leaves item 0's three gradients the same bit for
    bit."""
    se, te, tgt, dcorr = _inputs(47, "bfloat16", 100, 150, 128)

    def grads(se, te, tgt, dcorr):
        corr, lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
        return ragged_backward(se, te, tgt, corr, lse, dcorr)

    first = grads(se, te, tgt, dcorr)
    rng = np.random.RandomState(48)
    for t in (se, te, tgt, dcorr):
        t[1] = torch.from_numpy(rng.randn(*t[1].shape).astype(np.float32)).to(t.dtype)
    second = grads(se, te, tgt, dcorr)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(first, second))


def test_vcp_bwd_hands_the_kernels_whole_tiles(monkeypatch):
    """On the kernel route ragged lengths reach the kernels with the keys
    and rows scratch in whole 64-row tiles an item and the lse padded with
    +inf past Ns; the embeddings go as they are."""
    seen = {}

    class Ext:
        @staticmethod
        def vcp_bwd(se, te, tgt, corr, dcorr, lse, keys, rows, d_src, d_tgt_emb, d_tgt):
            seen.update(keys=tuple(keys.shape), rows=tuple(rows.shape), lse=lse.clone(),
                        se=tuple(se.shape), te=tuple(te.shape))

    monkeypatch.setattr(vcp, "kernel_route", lambda *t: True)
    monkeypatch.setattr(vcp._build, "extension", lambda: Ext)
    se, te, tgt, dcorr = (t.clone() for t in _inputs(49, "bfloat16", 100, 70, 128))
    corr, lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
    vcp.vcp_bwd(se, te, tgt, corr, lse, dcorr)
    assert seen["se"] == (B, 100, 128) and seen["te"] == (B, 70, 128)
    assert seen["keys"] == (B, 128, 4) and seen["rows"] == (B, 128, 4)
    assert seen["lse"].shape == (B, 128) and torch.equal(seen["lse"][:, :100], lse)
    assert torch.isinf(seen["lse"][:, 100:]).all() and (seen["lse"][:, 100:] > 0).all()
