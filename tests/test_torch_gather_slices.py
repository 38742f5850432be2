"""gather_max_from_idx by channel slices, in the kernel's order, on the CPU.

csrc/gather_max_from_idx.cu runs only on the card. This file writes what it
computes in PyTorch, in its order, and holds it bit for bit against the
port's plain version (``gather_max_from_idx_ref`` and its winners) and
against the JAX package's Pallas kernel in interpret mode
(``pallas_edgeconv.gather_max_from_idx`` and its winners), on the same
seeded numpy inputs:

* the plan: a block stages one cloud's slice of 2W channels (W 32-bit words
  of bf16 pairs a point: 32, 16, 8 or 4, the widest that fits beside the
  ring of indices in a block's shared memory); the last slice of a width
  that W does not divide is narrower; past the slices of 8 channels the
  rows are read from device memory, one warp a query;
* a query's k indices fill whole int4s, the slots past k repeating index
  k - 1; the running max of a channel pair takes a row's value where it is
  strictly above the max so far (bf16 comparisons, NaN never), and its
  position r with it: the first row reaching the max wins, and a repeated
  row never does.

Tolerance: none. Every output is a bf16 value of the table or -inf, every
winner a position, chosen by the same comparisons.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcrnet_tpu.ops import pallas_edgeconv
from vcrnet_tpu_torch.ops import edgeconv

BUDGET = 232448  # bytes of shared memory a block can use
CHUNK = 128      # queries whose indices one of the ring's two buffers holds
K = 20


def slice_smem(n: int, w: int, k: int) -> int:
    return n * w * 4 + 2 * CHUNK * ((k + 3) & ~3) * 4


def plan(n: int, k: int):
    """The words W of a slice, or None where the rows come from device memory."""
    for w in (32, 16, 8, 4):
        if slice_smem(n, w, k) <= BUDGET:
            return w
    return None


def sliced_gather_max(idx: torch.Tensor, values: torch.Tensor):
    """The kernel's order: (out [B, N, F] bf16, win [B, N, F] uint8)."""
    b, n, k = idx.shape
    f = values.shape[-1]
    w = plan(n, k)
    kk = (k + 3) & ~3 if w is not None else k  # the rows path reads idx as it is
    sel = torch.cat([idx.long(), idx[..., -1:].long().expand(b, n, kk - k)], -1)
    table = values.float()
    out = torch.full((b, n, f), float("-inf"))
    win = torch.zeros((b, n, f), dtype=torch.uint8)
    width = f if w is None else 2 * w
    for c0 in range(0, f, width):  # the slices; the last may be narrower
        cols = slice(c0, min(f, c0 + width))
        m, pos = out[..., cols], win[..., cols]
        for r in range(kk):
            v = table[torch.arange(b)[:, None], sel[..., r]][..., cols]
            gt = v > m  # strict, NaN never
            m = torch.where(gt, v, m)
            pos = torch.where(gt, torch.tensor(r, dtype=torch.uint8), pos)
        out[..., cols], win[..., cols] = m, pos
    return out.to(torch.bfloat16), win


def _inputs(seed, b, n, f, k=K, kind="random"):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    if kind == "duplicates":  # every neighbour twice, in a row
        idx = np.repeat(idx[..., : (k + 1) // 2], 2, axis=-1)[..., :k].copy()
    if kind == "ties":  # three levels: most maxima reached by several rows
        values = rng.randint(-1, 2, (b, n, f)).astype(np.float32)
    else:
        values = rng.randn(b, n, f).astype(np.float32)
    if kind == "zeros":  # zeros of both signs tie: the first in idx's order wins
        values = np.where(rng.rand(b, n, f) < 0.5, -0.0, 0.0).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(values).to(torch.bfloat16)


def test_the_plan_widens_the_slice_as_far_as_it_fits():
    # 64 channels a block up to about 1650 points at k = 20, then 32, 16, 8
    assert [plan(n, K) for n in (768, 885, 1000, 1024, 1650)] == [32] * 5
    assert [plan(n, K) for n in (1700, 3072)] == [16, 16]
    assert plan(6600, K) == 8 and plan(13000, K) == 4
    assert plan(13300, K) is None and plan(16384, K) is None
    assert plan(1024, 32) == 32  # the ring grows with k


@pytest.mark.parametrize("n,f", [(885, 256), (1024, 256), (3072, 64), (16384, 8)])
def test_sliced_order_equals_the_plain_version(n, f):
    idx, values = _inputs(1, 2 if n < 3000 else 1, n, f)
    out, win = sliced_gather_max(idx, values)
    ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx, winners=True)
    assert torch.equal(out, ref_out) and torch.equal(win, ref_win)
    assert torch.equal(out, edgeconv.fused_gather_max_from_idx(idx, values))  # the CPU route


@pytest.mark.parametrize("kind", ["duplicates", "ties", "zeros"])
@pytest.mark.parametrize("k", [1, 7, 32])
def test_first_row_wins_in_idx_order(kind, k):
    idx, values = _inputs(2, 2, 96, 8, k=k, kind=kind)
    out, win = sliced_gather_max(idx, values)
    gathered = values[torch.arange(2)[:, None, None], idx.long()]  # [B, N, k, F]
    # the first row whose value equals the max (zeros of both signs equal)
    first = (gathered.float() == out.float()[:, :, None]).to(torch.uint8).argmax(dim=2)
    assert torch.equal(win, first)
    assert torch.equal(out, gathered[torch.arange(2)[:, None, None], torch.arange(96)[:, None],
                                     win.long(), torch.arange(8)])  # the first row's bits
    assert int(win.max()) < k  # a repeated index slot never wins
    if kind != "zeros":  # the plain version keeps bits where values are distinct
        ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx,
                                                                winners=True)
        assert torch.equal(out, ref_out) and torch.equal(win, ref_win)


# the Pallas kernel tiles N in 8s at least (the JAX package serves 885 points
# by XLA); 885 is held against the plain version above
@pytest.mark.parametrize("n,f", [(1000, 8), (1024, 32), (3072, 8)])
def test_sliced_order_equals_the_pallas_kernel(n, f):
    idx, values = _inputs(3, 1, n, f)
    out, win = sliced_gather_max(idx, values)
    j_out, j_win = pallas_edgeconv._gather_max_from_idx_impl(
        jnp.asarray(idx.numpy()), jnp.asarray(values.float().numpy(), jnp.bfloat16), None,
        True, False, emit_winners=True)
    # a one-hot product of bf16 rows sums one nonzero term: exact
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(j_out.astype(jnp.float32)))
    np.testing.assert_array_equal(win.numpy(), np.asarray(j_win))
    assert torch.equal(out, edgeconv.gather_max_from_idx(idx, values))


def test_the_gate_takes_every_shape_it_took_before():
    for n in (64, 768, 885, 1000, 1024, 3072, 16384, 100000):
        assert edgeconv.gather_max_from_idx_supported(n, 256, K)
    assert edgeconv.gather_max_from_idx_supported(1024, 8, 1)
    assert edgeconv.gather_max_from_idx_supported(1024, 264, 32)
    assert not edgeconv.gather_max_from_idx_supported(1024, 12, K)  # 16-byte rows
    assert not edgeconv.gather_max_from_idx_supported(1024, 256, 33)  # uint8 winners < 32
