"""The SN-block kernels' arithmetic in their own order, on the CPU.

csrc/knn_gather_max.cu and knn.cu's xyz path (both through
csrc/knn_scores.cuh and csrc/topk.cuh), csrc/gather_max_from_idx.cu
(through common.cuh:warp_gather_max) and csrc/gather_max_bwd.cu run only on
the card. This file writes what they compute in numpy and PyTorch, in their
order, and holds it against the port's plain versions
(``fused_knn_gather_max_ref``, ``gather_max_bwd_ref``) and against the JAX
package's Pallas kernels in interpret mode (``_fused_gather_max_impl`` with
the exact selection and exact gathers, and the VJP of
``fused_knn_gather_max``), on the same seeded numpy inputs:

* scores (knn_scores.cuh:xyz_score): d = fma(z, z', fma(y, y', x x')) in
  f32, then 2 d - |x'|^2 rounded once; the diagonal and NaN at -inf. Its
  bits equal ``ops/_common.py::knn_scores`` on the CPU, whose matrix
  product over C = 3 accumulates by the same chain;
* selection (topk.cuh): the 64-bit key of score and column; lane l takes
  columns l, l + 32, ...; pass 1 keeps each lane's two best keys and the
  k-th of the 64 is the threshold; pass 2 inserts every key at or above it,
  in column order (a ballot's lowest lane first), into a 32-slot list
  ranked across the lanes. It must equal the plain stable sort exactly, on
  duplicate points, exact ties, a NaN coordinate and the -inf diagonal;
* gather (common.cuh:warp_gather_max): the k rows in the order of r, each
  channel's maximum taken with a strict >, so each winner is the first
  position that reaches the max;
* backward (gather_max_bwd.cu): a block per cloud and slice of S channels
  (the widest of 32, 16, 8 that divides F and whose [N, S] f32 slice fits
  shared memory), the slice cleared, every query's contribution added at
  its winner's row, the slice written whole.

Tolerances, each with its reason: scores, selections, winners and the
gathered maxima exact (the same f32 values in the same comparisons); the
backward 1e-6 absolute against the plain version (f32 sums of a few bf16
values of order one, in another order) and 1e-5 against the Pallas kernel
(its scatter is a one-hot f32 matmul).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.ops.pallas_edgeconv import _fused_gather_max_impl
from vcrnet_tpu.ops.pallas_edgeconv import fused_knn_gather_max as j_knn_gather_max
from vcrnet_tpu_torch.ops import edgeconv
from vcrnet_tpu_torch.ops._common import SMEM_LIMIT, knn_scores, select_topk

B, K, F = 2, 20, 32
LANES = 32
f32 = np.float32


def _fma32(a, b, c):
    """fmaf(a, b, c) on f32 arrays, rounded once: a b is exact in f64, the
    sum's error is kept by TwoSum, and a sum that lands on a midpoint
    between two f32 values goes the way its error points."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.astype(f32)
    up, dn = np.nextafter(r, f32(np.inf)), np.nextafter(r, f32(-np.inf))
    r64 = r.astype(np.float64)
    on_up = s == (r64 + up.astype(np.float64)) / 2
    on_dn = s == (r64 + dn.astype(np.float64)) / 2
    return np.where(on_up & (e > 0), up, np.where(on_dn & (e < 0), dn, r))


def xyz_scores(x: np.ndarray) -> np.ndarray:
    """knn_scores.cuh:xyz_score for every pair of a [B, N, 3] f32 cloud, with
    the norms as the wrappers compute them ((x * x).sum(-1))."""
    norms = (torch.from_numpy(x) * torch.from_numpy(x)).sum(-1).numpy()
    q, p = x[:, :, None, :], x[:, None, :, :]
    with np.errstate(invalid="ignore", over="ignore"):
        d = _fma32(q[..., 2], p[..., 2], _fma32(q[..., 1], p[..., 1], q[..., 0] * p[..., 0]))
        s = (f32(2) * d - norms[:, None, :]).astype(f32)
    s[np.isnan(s)] = -np.inf
    n = x.shape[1]
    s[:, np.arange(n), np.arange(n)] = -np.inf
    return s


def rank_keys(s: np.ndarray) -> np.ndarray:
    """topk.cuh:rank_key of every score (columns along the last axis)."""
    s = np.where(s == 0, f32(0), s).astype(f32)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    cols = np.arange(s.shape[-1], dtype=np.uint64)
    return (u << np.uint64(32)) | (~cols & np.uint64(0xFFFFFFFF))


def score_orders(s: np.ndarray) -> np.ndarray:
    """topk.cuh:score_order: the order-preserving int32 of each score."""
    i = (s.astype(f32) + f32(0)).view(np.int32)  # -0 + 0 = +0
    return i ^ ((i >> 31) & np.int32(0x7FFFFFFF))


def order_keys(o: np.ndarray, j: np.ndarray) -> np.ndarray:
    """topk.cuh:order_key of orders o at columns j."""
    hi = (o.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    return (hi << np.uint64(32)) | (~j.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF))


def two_pass_select(scores: np.ndarray, k: int) -> np.ndarray:
    """knn_scores.cuh:block_xyz_topk on rows of scores [..., N] -> [..., k]."""
    rows = scores.reshape(-1, scores.shape[-1])
    r, n = rows.shape
    orders = score_orders(rows)
    # pass 1: lane l walks columns l, l + 32, ... and keeps its two best
    # (order, column) by a strict > (INT_MIN, -1: none)
    o1 = np.full((r, LANES), np.iinfo(np.int32).min, np.int32)
    o2, j1, j2 = o1.copy(), np.full((r, LANES), -1), np.full((r, LANES), -1)
    for c0 in range(0, n, LANES):
        m = min(LANES, n - c0)
        o, j = orders[:, c0:c0 + m], np.arange(c0, c0 + m)[None, :]
        first, second = o > o1[:, :m], o > o2[:, :m]
        o2[:, :m] = np.where(first, o1[:, :m], np.where(second, o, o2[:, :m]))
        j2[:, :m] = np.where(first, j1[:, :m], np.where(second, j, j2[:, :m]))
        o1[:, :m] = np.where(first, o, o1[:, :m])
        j1[:, :m] = np.where(first, j, j1[:, :m])
    top = np.concatenate([order_keys(o1, j1), order_keys(o2, j2)], axis=1)  # the 64
    thr = np.sort(top, axis=1)[:, ::-1][:, k - 1]
    keys = order_keys(orders, np.broadcast_to(np.arange(n), (r, n)))
    assert ((keys >= thr[:, None]).sum(1) >= k).all()
    lst = np.zeros((r, LANES), np.uint64)  # pass 2: slot q holds rank q
    for j in range(n):  # column order: the ballot's lowest lane first
        x = keys[:, j]
        on = x >= thr
        pos = (lst > x[:, None]).sum(1)
        slot = np.arange(LANES)[None, :]
        up = np.concatenate([lst[:, :1], lst[:, :-1]], axis=1)
        new = np.where(slot > pos[:, None], up, np.where(slot == pos[:, None], x[:, None], lst))
        lst = np.where(on[:, None], new, lst)
    cols = (~lst[:, :k] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return cols.reshape(*scores.shape[:-1], k)


def _cloud(kind: str, n: int) -> np.ndarray:
    rng = np.random.RandomState(5)
    if kind == "random":
        x = rng.rand(B, n, 3) * 2 - 1
    elif kind == "ties":  # a grid of three levels: most scores tie
        x = rng.randint(-1, 2, (B, n, 3)).astype(np.float64)
    elif kind == "duplicates":  # every point twice
        x = np.repeat(rng.rand(B, n // 2, 3) * 2 - 1, 2, axis=1)
    else:  # "nan": a NaN coordinate, so whole rows and columns are -inf
        x = rng.rand(B, n, 3) * 2 - 1
        x[:, ::7, 1] = np.nan
    return x.astype(f32)


# ---------------------------------------------------------------- the scores


@pytest.mark.parametrize("kind", ["random", "duplicates", "nan"])
@pytest.mark.parametrize("n", [64, 96, 512])
def test_xyz_score_order_equals_knn_scores_to_the_bit(kind, n):
    x = _cloud(kind, n)
    got = xyz_scores(x)
    want = knn_scores(torch.from_numpy(x)).numpy()
    # bit for bit, but for the sign of a zero, which one key stands for
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(rank_keys(got), rank_keys(want))


def test_fma_rounds_once():
    # 24929 * 673 = 2^24 + 1, the midpoint between two f32 neighbours; a tiny
    # addend decides the rounding, which a product rounded first (or a sum
    # rounded through f64) loses
    a, b = np.array([24929], f32), np.array([673], f32)
    for c, want in ((2.0 ** -30, 2 ** 24 + 2), (-(2.0 ** -30), 2 ** 24)):
        c = np.array([c], f32)
        assert _fma32(a, b, c)[0] == f32(want)
        assert (a * b + c)[0] == f32(2 ** 24)
        assert f32(a.astype(np.float64) * b + c.astype(np.float64))[0] == f32(2 ** 24)


# ------------------------------------------------------------- the selection


def test_order_keys_are_the_rank_keys():
    # knn_scores.cuh compares 32-bit orders in pass 1 and builds the keys from
    # them; they must be rank_key's keys (edge_conv.cu's), special values too
    tiny = np.float32(1e-45)
    s = np.array([0.0, -0.0, np.inf, -np.inf, tiny, -tiny, 1.0, -1.0, 3.4e38, -3.4e38,
                  *np.random.RandomState(0).randn(64)], f32)
    cols = np.arange(s.size)
    np.testing.assert_array_equal(order_keys(score_orders(s), cols), rank_keys(s))
    o = score_orders(s)
    for a in range(s.size):  # the orders order as the floats, +-0 one value
        np.testing.assert_array_equal(o[a] > o, s[a] > s)
        np.testing.assert_array_equal(o[a] == o, s[a] == s)
    assert order_keys(np.array([np.iinfo(np.int32).min], np.int32), np.array([-1]))[0] == 0




@pytest.mark.parametrize("kind", ["random", "ties", "duplicates", "nan"])
@pytest.mark.parametrize("n", [64, 96, 512])
def test_two_pass_selection_equals_the_plain_stable_sort(kind, n):
    scores = xyz_scores(_cloud(kind, n))
    want = select_topk(torch.from_numpy(scores), K).numpy()
    np.testing.assert_array_equal(two_pass_select(scores, K), want)


def test_selection_takes_the_minus_inf_diagonal_in_its_order():
    # a NaN row: every score -inf, so the k smallest columns, the diagonal
    # among them; zeros of both signs tie: the smaller column first
    row = np.full((1, 64), -np.inf, f32)
    assert two_pass_select(row, K)[0].tolist() == list(range(K))
    row = np.zeros((1, 64), f32)
    row[0, ::2] = -0.0
    assert two_pass_select(row, 5)[0].tolist() == [0, 1, 2, 3, 4]
    # fewer columns than lanes: lanes past the end hold no key
    row = np.arange(21, dtype=f32)[None, :]
    assert two_pass_select(row, K)[0].tolist() == list(range(20, 0, -1))


# ------------------------------------------------------------------ the gather


def tiled_gather_max(values: np.ndarray, idx: np.ndarray):
    """warp_gather_max on bf16-exact values [B, N, F] over idx [B, N, k] ->
    (max, winner) in the kernel's order: the rows in the order of r, strict >."""
    rows = values[np.arange(values.shape[0])[:, None, None], idx]  # [B, N, k, F]
    m = np.full(rows.shape[:2] + rows.shape[3:], -np.inf, f32)
    w = np.zeros(m.shape, np.uint8)
    for r in range(idx.shape[-1]):
        take = rows[:, :, r] > m
        m = np.where(take, rows[:, :, r], m)
        w = np.where(take, np.uint8(r), w)
    return m, w


def _table(rng, n, ties: bool):
    if ties:  # three levels: most channels tie among the neighbours
        return rng.randint(0, 3, (B, n, F)).astype(f32)
    return torch.from_numpy(rng.randn(B, n, F).astype(f32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [64, 96])
def test_tiled_forward_matches_plain_and_pallas(n, ties):
    rng = np.random.RandomState(30 + n + ties)
    x = _cloud("random", n)
    values = _table(rng, n, ties)
    idx = two_pass_select(xyz_scores(x), K)
    out, win = tiled_gather_max(values, idx)
    r_out, r_idx, r_win = edgeconv.fused_knn_gather_max_ref(
        torch.from_numpy(x), torch.from_numpy(values), K, winners=True)
    np.testing.assert_array_equal(idx, r_idx.numpy())
    np.testing.assert_array_equal(out, r_out.numpy())
    np.testing.assert_array_equal(win, r_win.numpy())
    j_out, j_idx, j_win = _fused_gather_max_impl(
        jnp.asarray(x), jnp.asarray(values), K, None, True,
        packed_select=False, int8_gather=False, emit_winners=True,
    )
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_array_equal(win, np.asarray(j_win))
    np.testing.assert_array_equal(out, np.asarray(j_out))  # one-hot rows: exact on bf16 values


def test_gather_from_idx_is_the_same_gather():
    # gather_max_from_idx.cu runs warp_gather_max on a given idx: the same
    # maxima and winners as the fused kernel on its own selection
    rng = np.random.RandomState(41)
    x = _cloud("duplicates", 96)
    values = _table(rng, 96, ties=True)
    idx = two_pass_select(xyz_scores(x), K)
    out, win = tiled_gather_max(values, idx)
    r_out, r_win = edgeconv.fused_gather_max_from_idx(torch.from_numpy(idx),
                                                      torch.from_numpy(values), winners=True)
    np.testing.assert_array_equal(out, r_out.numpy())
    np.testing.assert_array_equal(win, r_win.numpy())


# ---------------------------------------------------------------- the backward


def slice_width(n: int, f: int) -> int:
    """gather_max_bwd.cu:slice_shift as a width (0: refused)."""
    for s in (32, 16, 8):
        if f % s == 0 and 4 * n * s <= SMEM_LIMIT:
            return s
    return 0


def tiled_backward(idx: np.ndarray, win: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """gather_max_bwd.cu: a block per (cloud, slice), the [N, S] slice
    cleared, each query's value added at its winner's row, in the order the
    block's warps walk the queries (per slice), then written whole."""
    b_, n, f = ct.shape
    s = slice_width(n, f)
    per_step = 1024 // 32 * (32 // s)  # queries the block takes at once
    dv = np.full((b_, n, f), np.nan, f32)  # every element is written
    for b in range(b_):
        for c0 in range(0, f, s):
            acc = np.zeros((n, s), f32)
            cols = np.arange(s)
            for i0 in range(0, n, per_step):
                for i in range(i0, min(i0 + per_step, n)):
                    t = idx[b, i, win[b, i, c0:c0 + s]]
                    np.add.at(acc, (t, cols), ct[b, i, c0:c0 + s])
            dv[b, :, c0:c0 + s] = acc
    return dv


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [64, 96])
def test_tiled_backward_matches_plain_and_pallas(n, ties):
    rng = np.random.RandomState(50 + n + ties)
    x = _cloud("random", n)
    values = _table(rng, n, ties)
    ct = torch.from_numpy(rng.randn(B, n, F).astype(f32)).to(torch.bfloat16).float().numpy()
    idx = two_pass_select(xyz_scores(x), K)
    _, win = tiled_gather_max(values, idx)
    dv = tiled_backward(idx, win, ct)
    want = edgeconv.gather_max_bwd_ref(torch.from_numpy(idx), torch.from_numpy(win),
                                       torch.from_numpy(ct)).numpy()
    np.testing.assert_allclose(dv, want, atol=1e-6, rtol=0)
    _, vjp = jax.vjp(
        lambda v: j_knn_gather_max(jnp.asarray(x), v, K, interpret=True,
                                   packed_select=False, int8_gather=False),
        jnp.asarray(values),
    )
    (j_dv,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(dv, np.asarray(j_dv), atol=1e-5, rtol=0)


def test_backward_slices_narrow_with_n():
    assert [slice_width(n, 256) for n in (512, 768, 1024, 3072)] == [32, 32, 32, 16]
    assert slice_width(7264, 256) == 8 and slice_width(7265, 256) == 0
    assert slice_width(1024, 24) == 8 and slice_width(1024, 48) == 16


# ------------------------------------------------------------------- the gates


def test_gates_take_every_served_and_trained_shape():
    """Every N of the served, refined and partial paths (512, 768, 1024,
    3072) at the SN block's F = 256 and k = 20, and the trained one (1024);
    the backward's gate is where its slice stops fitting."""
    for n in (512, 768, 1024, 3072):
        assert edgeconv.knn_gather_max_supported(n, 256, K)
        assert edgeconv.gather_max_bwd_supported(n, 256, K)
    assert edgeconv.knn_gather_max_supported(8192, 256, K)  # tiles: any N
    assert edgeconv.knn_gather_max_supported(1001, 8, 32)
    for n in range(K + 1, 8000, 97):
        assert edgeconv.gather_max_bwd_supported(n, 256, K) == (slice_width(n, 256) > 0)
    for n, f, k in ((1024, 12, K), (1024, 256, 33), (1024, 256, 0), (20, 256, K)):
        assert not edgeconv.knn_gather_max_supported(n, f, k)
        assert not edgeconv.gather_max_bwd_supported(n, f, k)
    assert not edgeconv.gather_max_bwd_supported(8192, 256, K)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_refused_cuda_shapes_raise_and_do_not_fall_back(monkeypatch):
    from vcrnet_tpu_torch.ops import _build

    def refuse(*a, **k):
        raise AssertionError("a refused shape must raise before the extension is built")

    monkeypatch.setattr(_build, "extension", refuse)

    def fake(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)

    x = fake((1, 64, 3), torch.float32)
    with pytest.raises(ValueError, match="F % 8"):
        edgeconv.fused_knn_gather_max(x, fake((1, 64, 12)), K)
    with pytest.raises(ValueError, match="k in"):
        edgeconv.fused_knn_gather_max(x, fake((1, 64, 16)), 33)
    n = 8192  # the slice of 8 channels outgrows shared memory
    with pytest.raises(ValueError, match="N <="):
        edgeconv.gather_max_bwd(fake((1, n, K), torch.int32), fake((1, n, 8), torch.uint8),
                                fake((1, n, 8)))
