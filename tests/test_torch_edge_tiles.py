"""The edge-conv kernels' arithmetic in their own order, on the CPU.

csrc/edge_conv.cu, csrc/edge_conv_from_idx.cu (through csrc/edge_tile.cuh)
and csrc/edge_conv_bwd.cu run only on the card. This file writes what they
compute in PyTorch, in their order and at their rounding points, and holds
it against the port's plain versions (``fused_edge_conv_ref``,
``edge_conv_bwd_ref``) and against the JAX package's Pallas kernels in
interpret mode (``_fused_edge_conv_fwd_impl`` with the exact selection, and
the VJP of ``_fused_edge_conv_vjp``), on the same seeded numpy inputs:

* selection: a key is the order-preserving uint32 of the f32 score (-0 made
  +0) above the complement of the column. Lane l of a warp sees columns l
  and l + 32 of every 64-column tile; past N (a ragged last tile) the
  columns score -inf (the kernel gives their keys an infinite norm). Pass 1
  keeps each lane's two best keys; the k-th best of the 64 is the
  threshold. Pass 2 inserts every key at or above it, tile by tile and lane
  by lane, into a 32-slot list sorted by key; its first k slots are the
  selection. It must equal the plain stable sort exactly, on ties,
  duplicate points, the -inf diagonal, NaN and ragged clouds;
* edge phase: m64 tiles of two queries, each query's k rows padded to 32 by
  repeating neighbour 0; blocks of 64 query rows (of a cloud for
  edge_conv, of the flattened [B*N] for edge_conv_from_idx), where a query
  slot past the block's rows repeats the tile's first query and is not
  written; z in f32, rounded to bf16 for the product with
  W2 (f32 accumulation); each warp's 16 rows reduce first (a thread's rows
  g and g + 8, then the eight lanes of a column), then the query's two
  warps, keeping the larger value and the smaller row on ties. Without
  winners the maxima are taken on bf16 values;
* backward: the routed matrix (row j, column o holds bf16(dp_o) where
  win2_o == j) times W2^T densely in f32, ct1 added at x1's winner row,
  act'(z) applied; da from bf16(dq) of the rows below k; dh from each
  thread's two rows, then the 16 partial rows of the two warps in order;
  dW2 and db2 summed per block over rounds of four queries in the kernel's
  order, then the blocks' partials in block order. The rounds walk the
  flattened [B*N], ceil(B*N / 4) of them: a query slot past the end loads
  the last query's rows and adds and stores nothing.

Tolerances, each with its reason: selections, winners and the forward's
bf16 outputs exact (the same f32 values in the same comparisons); the
product and the backward's sums 1e-5 of the largest value (f32 sums of
the same products in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.ops.pallas_edgeconv import _fused_edge_conv_fwd_impl, _fused_edge_conv_vjp
from vcrnet_tpu_torch.ops import edgeconv
from vcrnet_tpu_torch.ops._common import knn_scores, leaky, select_topk
from vcrnet_tpu_torch.ops.graph import gather_neighbors

F = 128     # edge-conv width
ROWS = 32   # edge rows of a query after padding
TILE = 64   # key columns of a score tile
LANES = 32
B, K = 2, 20


def _rand(rng, *shape, scale=1.0):
    """f32 values that bf16 holds exactly."""
    v = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return v.to(torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ selection


def rank_key(s: float, j: int) -> int:
    """The kernel's 64-bit selection key of score s at column j."""
    s = np.float32(0.0) if s == 0 else np.float32(s)
    u = int(np.array(s, dtype=np.float32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return u << 32 | (~j & 0xFFFFFFFF)


def two_pass_select(row: np.ndarray, k: int) -> list:
    """edge_conv.cu's selection of one score row (f32, NaN already -inf),
    over whole 64-column tiles: the columns past the row's end score -inf."""
    n = -(-row.shape[0] // TILE) * TILE
    row = np.concatenate([row, np.full(n - row.shape[0], -np.inf, np.float32)])
    keys = [rank_key(row[j], j) for j in range(n)]
    top2 = []  # pass 1: each lane's two best keys
    for lane in range(LANES):
        top2 += sorted((keys[j] for j in range(lane, n, LANES)), reverse=True)[:2]
    thr = sorted(top2, reverse=True)[k - 1]
    assert sum(key >= thr for key in keys) >= k
    lst = [0] * LANES  # pass 2: a sorted list over the lanes, slot r = rank r
    for t0 in range(0, n, TILE):
        for half in (0, 32):
            for lane in range(LANES):  # the ballot's set bits, lowest lane first
                x = keys[t0 + half + lane]
                if x >= thr:
                    pos = sum(v > x for v in lst)
                    lst = lst[:pos] + [x] + lst[pos:LANES - 1]
    return [~(key & 0xFFFFFFFF) & 0xFFFFFFFF for key in lst[:k]]


def tiled_select(x: torch.Tensor, k: int) -> torch.Tensor:
    scores = knn_scores(x)
    out = [[two_pass_select(scores[b, i].numpy(), k) for i in range(x.shape[1])]
           for b in range(x.shape[0])]
    return torch.tensor(out, dtype=torch.int32)


def _clouds(kind: str, n: int, c: int = 64) -> torch.Tensor:
    rng = np.random.RandomState(7)
    if kind == "random":
        x = rng.randn(B, n, c)
    elif kind == "ties":  # coordinates on three levels: most scores tie
        x = rng.randint(-1, 2, (B, n, c)).astype(np.float64)
    elif kind == "duplicates":  # every point twice
        x = np.repeat(rng.randn(B, n // 2, c), 2, axis=1)
    else:  # "nan": some points NaN, so whole rows of scores are -inf
        x = rng.randn(B, n, c)
        x[:, ::5, 3] = np.nan
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


@pytest.mark.parametrize("kind", ["random", "ties", "duplicates", "nan"])
@pytest.mark.parametrize("n", [64, 128, 100])
def test_two_pass_selection_equals_the_plain_selection(kind, n):
    x = _clouds(kind, n)
    np.testing.assert_array_equal(tiled_select(x, K).numpy(),
                                  select_topk(knn_scores(x), K).numpy())


def test_two_pass_selection_takes_the_minus_inf_diagonal_in_its_order():
    # a row of NaN scores but the diagonal: every key is -inf, so the
    # selection is the k smallest columns, the diagonal among them
    row = np.full(64, -np.inf, np.float32)
    assert two_pass_select(row, K) == list(range(K))
    # zeros of both signs tie: the smaller column first
    row = np.zeros(64, np.float32)
    row[::2] = -0.0
    assert two_pass_select(row, 5) == [0, 1, 2, 3, 4]


# ----------------------------------------------------------------- edge phase


def _pad_rows(idx: torch.Tensor) -> torch.Tensor:
    """[B, N, k] -> [B, N, 32]: padding rows repeat neighbour 0."""
    k = idx.shape[-1]
    return torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], ROWS - k)], -1)


def _keep(m, r, om, orow):
    """The kernel's pairwise rule: the larger value, the smaller row on ties."""
    take = (om > m) | ((om == m) & (orow < r))
    return torch.where(take, om, m), torch.where(take, orow, r)


def _warp_reduce(v: torch.Tensor):
    """v [..., 32 rows, F] of queries -> (max, row) [..., F]: per warp (rows
    0..15 and 16..31) each thread's rows g, g + 8, then lanes g = 0..7 by
    the xor tree over g (1, 2, 4), then the two warps."""
    rows = torch.arange(ROWS).view(ROWS, 1).expand(ROWS, v.shape[-1])
    out = []
    for w in range(2):
        g = torch.arange(8) + 16 * w
        m, r = _keep(v[..., g, :], rows[g], v[..., g + 8, :], rows[g + 8])  # [..., 8, F]
        for off in (1, 2, 4):
            partner = torch.arange(8) ^ off
            m, r = _keep(m, r, m[..., partner, :], r[..., partner, :])
        out.append((m[..., 0, :], r[..., 0, :]))
    (m0, r0), (m1, r1) = out
    return _keep(m0, r0, m1, r1)


def tiled_edge_phase(idx, a, h, w2, b2, slope, winners):
    """edge_tile.cuh's order: (x1, x2[, win1, win2]); x1, x2 rounded to bf16.
    A row of the product depends only on its own z row, so the m64 tiles of
    two queries are written here as all queries at once."""
    bf = torch.bfloat16
    z = leaky(gather_neighbors(a.float(), _pad_rows(idx)) + h.float()[:, :, None], slope)
    y = leaky(z.to(bf).float() @ w2.float() + b2.float(), slope)  # [B, N, 32, F]
    if not winners:  # bf16 maxima
        return z.to(bf).float().amax(2), y.to(bf).float().amax(2)
    x1, w1 = _warp_reduce(z)
    x2, ww2 = _warp_reduce(y)
    return x1.to(bf).float(), x2.to(bf).float(), w1.to(torch.uint8), ww2.to(torch.uint8)


def _edge_inputs(n, seed=11):
    rng = np.random.RandomState(seed)
    x = _rand(rng, B, n, 64)
    a, h = _rand(rng, B, n, F, scale=0.5), _rand(rng, B, n, F, scale=0.5)
    w2, b2 = _rand(rng, F, F, scale=F ** -0.5), _rand(rng, F, scale=0.1)
    return x, a, h, w2, b2


def _t(v):
    return torch.from_numpy(np.array(v))


@pytest.mark.parametrize("slope", [0.0, 0.2])
@pytest.mark.parametrize("n", [64, 128])
def test_tiled_forward_matches_plain_and_pallas(n, slope):
    x, a, h, w2, b2 = _edge_inputs(n)
    tx, ta, th, tw, tb = (_t(v) for v in (x, a, h, w2, b2))
    idx = tiled_select(tx, K)
    # W2 in bf16: the plain version and the Pallas kernel round z to W2's dtype
    r1, r2, r_idx, rw1, rw2 = edgeconv.fused_edge_conv_ref(tx, ta, th, tw.to(torch.bfloat16),
                                                           tb, K, slope, winners=True)
    np.testing.assert_array_equal(idx.numpy(), r_idx.numpy())
    x1, x2, w1, ww2 = tiled_edge_phase(idx, ta, th, tw, tb, slope, winners=True)
    e1, e2 = tiled_edge_phase(idx, ta, th, tw, tb, slope, winners=False)
    # the kernel rounds to bf16; the plain version here keeps f32
    bf = torch.bfloat16
    torch.testing.assert_close(x1, r1.to(bf).float(), rtol=0, atol=0)
    assert torch.equal(w1, rw1)
    assert torch.equal(e1, x1)  # bf16 maxima give the same x1 ...
    assert torch.equal(e2, x2)  # ... and x2
    # y's f32 sums in another order than the plain matmul: one bf16 ulp
    torch.testing.assert_close(x2, r2.to(bf).float(), rtol=2 ** -8, atol=1e-6)
    assert (ww2 == rw2).float().mean() >= 0.99
    j1, j2, j_idx, j_w1, j_w2 = _fused_edge_conv_fwd_impl(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(h), jnp.asarray(w2, jnp.bfloat16),
        jnp.asarray(b2), K, slope, None, True,
        packed_select=False, int8_gather=False, emit_winners=True,
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(w1.numpy(), np.asarray(j_w1))
    assert (ww2.numpy() == np.asarray(j_w2)).mean() >= 0.99
    np.testing.assert_allclose(x1.numpy(), np.asarray(j1).astype(np.float32), rtol=2 ** -8, atol=1e-6)
    np.testing.assert_allclose(x2.numpy(), np.asarray(j2).astype(np.float32), rtol=2 ** -8, atol=1e-6)


def test_tiled_winners_take_the_first_row_on_ties():
    # a on two levels: most channels tie among the neighbours
    rng = np.random.RandomState(3)
    n = 64
    x = _rand(rng, B, n, 64)
    a = rng.randint(0, 2, (B, n, F)).astype(np.float32)
    h = np.zeros((B, n, F), np.float32)
    w2 = np.eye(F, dtype=np.float32)
    b2 = np.zeros(F, np.float32)
    tx, ta, th, tw, tb = (_t(v) for v in (x, a, h, w2, b2))
    idx = tiled_select(tx, K)
    _, _, w1, ww2 = tiled_edge_phase(idx, ta, th, tw, tb, 0.0, winners=True)
    _, _, _, rw1, rw2 = edgeconv.fused_edge_conv_ref(tx, ta, th, tw, tb, K, idx=idx, winners=True)
    assert torch.equal(w1, rw1) and torch.equal(ww2, rw2)
    assert int(w1.max()) < K  # padding rows never win


def flat_edge_rows(idx, a, h, w2, b2, slope):
    """edge_conv_from_idx.cu's blocks: 64 rows of the flattened [B*N] a
    block, tiles of two queries; a query slot at or past the block's rows
    (the end of B*N) computes the tile's first query again and is not
    written. Each query gathers from its own cloud (flat row i / N)."""
    b, n, k = idx.shape
    rows = b * n
    flat_idx, flat_h = idx.reshape(rows, k), h.reshape(rows, F)
    x1, x2 = torch.full((rows, F), float("nan")), torch.full((rows, F), float("nan"))
    for row0 in range(0, rows, 64):
        n_valid = min(64, rows - row0)
        for t in range(-(-n_valid // 2)):
            for p in range(2):
                qp = 2 * t + p if 2 * t + p < n_valid else 2 * t
                i = row0 + qp
                cloud = a[i // n]
                one = tiled_edge_phase(flat_idx[i].view(1, 1, k), cloud[None],
                                       flat_h[i].view(1, 1, F), w2, b2, slope, winners=False)
                if 2 * t + p < n_valid:
                    x1[row0 + 2 * t + p], x2[row0 + 2 * t + p] = one[0][0, 0], one[1][0, 0]
    return x1.reshape(b, n, F), x2.reshape(b, n, F)


def test_flat_blocks_with_an_odd_row_count_write_every_row_once():
    """B*N = 3 * 33 = 99 rows: two blocks, the last tile of the second holds
    one real query. Every row is written, and equals the plain version."""
    rng = np.random.RandomState(12)
    b, n = 3, 33
    a, h = _t(_rand(rng, b, n, F, scale=0.5)), _t(_rand(rng, b, n, F, scale=0.5))
    w2, b2 = _t(_rand(rng, F, F, scale=F ** -0.5)), _t(_rand(rng, F, scale=0.1))
    idx = torch.from_numpy(rng.randint(0, n, (b, n, K)).astype(np.int32))
    x1, x2 = flat_edge_rows(idx, a, h, w2, b2, 0.0)
    r1, r2 = edgeconv.edge_conv_from_idx_ref(idx, a, h, w2.to(torch.bfloat16), b2)
    bf = torch.bfloat16
    assert not (torch.isnan(x1).any() or torch.isnan(x2).any())
    assert torch.equal(x1, r1.to(bf).float())
    torch.testing.assert_close(x2, r2.to(bf).float(), rtol=2 ** -8, atol=1e-6)


def test_ragged_tiles_of_the_next_item_change_nothing():
    """B = 2 clouds of N = 100 points, whose last key tile and last block of
    64 queries are ragged: redrawing item 1 leaves item 0's selection and
    both outputs the same bit for bit, and they equal the plain version."""
    n = 100
    x, a, h, w2, b2 = (_t(v) for v in _edge_inputs(n, seed=13))

    def forward(x, a, h):
        idx = tiled_select(x, K)
        return (idx, *flat_edge_rows(idx, a, h, w2, b2, 0.0))

    first = forward(x, a, h)
    r1, r2, r_idx = edgeconv.fused_edge_conv_ref(x, a, h, w2.to(torch.bfloat16), b2, K)
    assert torch.equal(first[0], r_idx)
    assert torch.equal(first[1], r1.to(torch.bfloat16).float())
    rng = np.random.RandomState(14)
    for t in (x, a, h):
        t[1] = _t(_rand(rng, *t[1].shape))
    second = forward(x, a, h)
    assert all(torch.equal(u[0], v[0]) for u, v in zip(first, second))
    assert not torch.equal(first[1][1], second[1][1])


# ------------------------------------------------------------------- backward


def tiled_backward(idx, win1, win2, a, h, w2, x2, ct1, ct2, slope, rounding=torch.bfloat16,
                   blocks=3):
    """edge_conv_bwd.cu's order: (da, dh, dW2, db2) in f32, with dp and dq
    rounded to ``rounding`` (the kernel's bf16; f32 to compare with the
    Pallas kernel on f32 inputs). Every query's rows at once; the sums whose
    order the kernel fixes (dh, dW2, db2) in that order."""
    Bn, n, k = idx.shape
    sel = _pad_rows(idx)
    rowid = torch.arange(ROWS).view(1, 1, ROWS, 1)
    z = leaky(gather_neighbors(a.float(), sel) + h.float()[:, :, None], slope)  # [B, N, 32, F]
    dp = ct2.float() * torch.where(x2.float() > 0, 1.0, slope)  # [B, N, F]
    routed = torch.where(win2.long()[:, :, None] == rowid, dp.to(rounding).float()[:, :, None], 0.0)
    dz = routed @ w2.float().t()  # the dense product over o
    dz = dz + torch.where(win1.long()[:, :, None] == rowid, ct1.float()[:, :, None], 0.0)
    dq = dz * torch.where(z > 0, 1.0, slope)
    da = torch.zeros(Bn, n, F)
    for r in range(k):  # rows past k are padding: not scattered
        da.scatter_add_(1, idx[:, :, r:r + 1].long().expand(Bn, n, F),
                        dq[:, :, r].to(rounding).float())
    # dh: each thread's rows g + g + 8, then the 16 row pairs of the two warps
    pairs = torch.cat([dq[:, :, 0:8] + dq[:, :, 8:16], dq[:, :, 16:24] + dq[:, :, 24:32]], 2)
    dh = torch.zeros(Bn, n, F)
    for r in range(16):
        dh = dh + pairs[:, :, r]
    # dW2[c, o] += z[win2[o], c] dp[o], query by query; rounds of four
    # queries go to the blocks in turn; then the blocks' partials in order
    zw = torch.gather(z, 2, win2.long()[:, :, :, None].expand(Bn, n, F, F)).transpose(2, 3)
    contrib = (zw * dp[:, :, None, :]).reshape(Bn * n, F, F)  # [query, c, o]
    dpq = dp.reshape(Bn * n, F)
    partial = torch.zeros(blocks, F, F)
    part_b = torch.zeros(blocks, F)
    for i in range(Bn * n):
        blk = (i // 4) % blocks
        partial[blk] += contrib[i]
        part_b[blk] += dpq[i]
    dw2 = torch.zeros(F, F)
    db2 = torch.zeros(F)
    for blk in range(blocks):
        dw2 = dw2 + partial[blk]
        db2 = db2 + part_b[blk]
    return da, dh, dw2, db2


@pytest.mark.parametrize("slope", [0.0, 0.2])
@pytest.mark.parametrize("n", [64, 96])
def test_tiled_backward_matches_plain_and_pallas(n, slope):
    x, a, h, w2, b2 = _edge_inputs(n, seed=22)
    rng = np.random.RandomState(23)
    ct1, ct2 = _rand(rng, B, n, F), _rand(rng, B, n, F)
    tx, ta, th, tw, tb = (_t(v) for v in (x, a, h, w2, b2))
    _, x2, idx, win1, win2 = edgeconv.fused_edge_conv_ref(tx, ta, th, tw, tb, K, slope,
                                                          winners=True)
    bf = torch.bfloat16
    # the kernel's rounding points: the plain version rounds dp to W2's
    # dtype and dq to h's, so it gets them in bf16 (the same values)
    args = (idx, win1, win2, ta, th, tw, x2, _t(ct1), _t(ct2))
    got = tiled_backward(*args, slope)
    want = edgeconv.edge_conv_bwd_ref(idx, win1, win2, ta, th.to(bf), tw.to(bf), x2, _t(ct1),
                                      _t(ct2), slope)
    for gv, wv in zip(got, want):  # da, dh, dW2, db2
        torch.testing.assert_close(gv, wv, rtol=0, atol=1e-5 * float(wv.abs().max()))
    # without the rounding, against the Pallas kernel's VJP on f32 inputs
    got = tiled_backward(*args, slope, rounding=torch.float32)
    jx = jnp.asarray(x)
    _, vjp = jax.vjp(
        lambda a_, h_, w_, b_: _fused_edge_conv_vjp(jx, a_, h_, w_, b_, K, slope, None, True,
                                                    False, False),
        *(jnp.asarray(v) for v in (a, h, w2, b2)),
    )
    for gv, jv in zip(got, vjp((jnp.asarray(ct1), jnp.asarray(ct2)))):
        jv = np.asarray(jv)
        np.testing.assert_allclose(gv.numpy(), jv, rtol=0, atol=1e-5 * max(1.0, np.abs(jv).max()))


# ---------------------------------------------------------------------- gates


def test_edge_gates_take_every_served_and_trained_shape():
    """The kernels' gates (ROADMAP C, "Edge-conv kernels' gate"): every N the
    served, refined, partial and trained paths give at k = 20, C = 64."""
    for n in (512, 768, 1024, 3072):
        assert edgeconv.edge_conv_supported(n, 64, K)
        assert edgeconv.edge_conv_from_idx_supported(n, K)
        assert edgeconv.edge_conv_bwd_supported(n, K)
    for c in (32, 128):
        assert edgeconv.edge_conv_supported(1024, c, K)
    assert edgeconv.edge_conv_supported(64, 64, 32) and edgeconv.edge_conv_supported(4096, 64, K)
    # a ragged last tile: any N (ROADMAP C1)
    assert edgeconv.edge_conv_supported(1000, 64, K) and edgeconv.edge_conv_supported(96, 64, K)
    for n, c, k in ((1024, 48, K), (1024, 64, 33), (64, 64, 64)):
        assert not edgeconv.edge_conv_supported(n, c, k)
    assert edgeconv.edge_conv_from_idx_supported(1000, K)
    assert not edgeconv.edge_conv_from_idx_supported(1000, 33)
    assert edgeconv.edge_conv_bwd_supported(1000, K)  # a ragged last round (C1b)
    assert edgeconv.edge_conv_bwd_supported(885, K) and edgeconv.edge_conv_bwd_supported(75, K)
    assert not edgeconv.edge_conv_bwd_supported(1024, 33)
    assert not edgeconv.edge_conv_bwd_supported(20, K)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_refused_cuda_shapes_raise_and_do_not_fall_back():
    bf = torch.bfloat16
    n = 96  # a ragged N is taken now; C = 48 is refused

    def fake(shape, dtype=bf):
        return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)

    x, a, h = fake((1, n, 48)), fake((1, n, F)), fake((1, n, F))
    w2, b2 = fake((F, F)), fake((F,))
    with pytest.raises(ValueError, match="C in"):
        edgeconv.fused_edge_conv(x, a, h, w2, b2, K)
    with pytest.raises(ValueError, match=r"k in \[1, 32\]"):
        edgeconv.edge_conv_from_idx(fake((1, 100, 33), torch.int32), fake((1, 100, F)),
                                    fake((1, 100, F)), w2, b2)
    idx = fake((1, 100, 33), torch.int32)  # a ragged N is taken now; k = 33 is refused
    win = fake((1, 100, F), torch.uint8)
    t = fake((1, 100, F))
    with pytest.raises(ValueError, match=r"k in \[1, 32\] below N"):
        edgeconv.edge_conv_bwd(idx, win, win, t, t, w2, t, t, t)


def flat_backward(idx, win1, win2, a, h, w2, x2, ct1, ct2, slope, blocks=3):
    """edge_conv_bwd.cu's walk at any B*N: rounds of four query slots of the
    flattened [B*N], ceil(B*N / 4) of them, round r to block r % blocks; a
    slot at or past B*N loads the last query's rows (and computes on them)
    but adds nothing to da, dW2 or db2 and stores no dh. Per query the
    arithmetic of tiled_backward. (da, dh, dW2, db2) in f32; dh rows never
    stored stay NaN."""
    Bn, n, k = idx.shape
    rows = Bn * n
    sel = _pad_rows(idx).reshape(rows, ROWS)
    flat = [t.reshape(rows, F) for t in (a, h, x2, ct1, ct2)]
    w1f, w2f = win1.reshape(rows, F).long(), win2.reshape(rows, F).long()
    rowid = torch.arange(ROWS)[:, None]
    da = torch.zeros(rows, F)
    dh = torch.full((rows, F), float("nan"))
    partial, part_b = torch.zeros(blocks, F, F), torch.zeros(blocks, F)
    for rnd in range(-(-rows // 4)):
        for slot in range(4):
            i = 4 * rnd + slot
            j = min(i, rows - 1)  # the row the slot loads
            cloud = j // n * n
            _, hq, x2q, c1, c2 = (t[j].float() for t in flat)
            z = leaky(flat[0][cloud + sel[j]].float() + hq, slope)  # [32, F]
            dp = c2 * torch.where(x2q > 0, 1.0, slope)
            routed = torch.where(w2f[j] == rowid, dp.to(torch.bfloat16).float(), 0.0)
            dz = routed @ w2.float().t() + torch.where(w1f[j] == rowid, c1, 0.0)
            dq = dz * torch.where(z > 0, 1.0, slope)
            if i >= rows:
                continue
            da.index_add_(0, cloud + idx.reshape(rows, k)[j].long(),
                          dq[:k].to(torch.bfloat16).float())
            pairs = torch.cat([dq[0:8] + dq[8:16], dq[16:24] + dq[24:32]])
            acc = torch.zeros(F)
            for r in range(16):
                acc = acc + pairs[r]
            dh[i] = acc
            # dW2[c, o] += z[win2[o], c] dp[o]
            partial[rnd % blocks] += torch.gather(z.t(), 1, w2f[j][None].expand(F, F)) * dp
            part_b[rnd % blocks] += dp
    dw2, db2 = torch.zeros(F, F), torch.zeros(F)
    for blk in range(blocks):
        dw2 = dw2 + partial[blk]
        db2 = db2 + part_b[blk]
    return da.reshape(Bn, n, F), dh.reshape(Bn, n, F), dw2, db2


def _ragged_bwd_args(b, n, seed):
    rng = np.random.RandomState(seed)
    x = _t(_rand(rng, b, n, 64))
    a, h = _t(_rand(rng, b, n, F, scale=0.5)), _t(_rand(rng, b, n, F, scale=0.5))
    w2, b2 = _t(_rand(rng, F, F, scale=F ** -0.5)), _t(_rand(rng, F, scale=0.1))
    _, x2, idx, win1, win2 = edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, K, 0.0, winners=True)
    ct1, ct2 = _t(_rand(rng, b, n, F)), _t(_rand(rng, b, n, F))
    return [idx, win1, win2, a, h, w2, x2, ct1, ct2]


# (B, N): B*N = 99 (the last round holds three queries), 150 (two: the
# second tile wholly past the end), 2 * 75 and 3 * 75 (one)
@pytest.mark.parametrize("b,n", [(3, 33), (2, 75), (3, 75)])
def test_flat_backward_with_a_ragged_last_round_matches_plain(b, n):
    args = _ragged_bwd_args(b, n, seed=24)
    got = flat_backward(*args, 0.0)
    idx, win1, win2, a, h, w2, x2, ct1, ct2 = args
    want = edgeconv.edge_conv_bwd_ref(idx, win1, win2, a, h.to(torch.bfloat16),
                                      w2.to(torch.bfloat16), x2, ct1, ct2, 0.0)
    for gv, wv in zip(got, want):  # da, dh, dW2, db2: every row of dh written
        assert not torch.isnan(gv).any()
        torch.testing.assert_close(gv, wv, rtol=0, atol=1e-5 * float(wv.abs().max()))


def test_ragged_backward_round_of_the_next_item_changes_nothing():
    """B = 2 clouds of N = 75: rounds span both clouds. Redrawing item 1's
    inputs and gradients leaves item 0's da and dh the same bit for bit."""
    args = _ragged_bwd_args(2, 75, seed=25)
    first = flat_backward(*args, 0.0)
    rng = np.random.RandomState(26)
    for t in (args[3], args[4], args[7], args[8]):  # a, h, ct1, ct2
        t[1] = _t(_rand(rng, *t[1].shape))
    second = flat_backward(*args, 0.0)
    assert torch.equal(first[0][0], second[0][0]) and torch.equal(first[1][0], second[1][0])


def test_edge_conv_parts_cuts_apply_to_the_backward_source():
    """train/edge_conv_parts.py times builds of edge_conv_bwd.cu with parts cut
    from its text; each cut must still find its text, or the timing of that
    part would be skipped on the card."""
    from vcrnet_tpu_torch.ops import _build
    from vcrnet_tpu_torch.train import edge_conv_parts

    for variant, cuts in edge_conv_parts.BWD_VARIANTS.items():
        text = edge_conv_parts._source(_build.CSRC_DIR, "edge_conv_bwd.cu", cuts)
        assert text is not None, variant
        assert 'extern "C" int shim(' in text
    assert "red_add_v4(...) ((void)0)" in edge_conv_parts._source(
        _build.CSRC_DIR, "edge_conv_bwd.cu", edge_conv_parts.BWD_VARIANTS["no_da"])
