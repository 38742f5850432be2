"""The edge kernel's f32 instance: its split pass and its split scores, on the CPU.

csrc/edge_conv.cu's f32 instance takes an f32 kNN space (LPDNet's after
t_net_fea) as three bf16 planes, x0 = bf16(x), x1 = bf16(x - x0),
x2 = bf16(x - x0 - x1) (the split pass ``edge_split_kernel``; its plain
version ``ops/edgeconv.py:split_planes_ref``), and its scores as the f32 sum
of the six exact products of plane pairs xa . yb with a + b <= 2
(``test_torch_edge_tiles.split_scores`` writes that order). This file holds:

* the split is exact, x0 + x1 + x2 == x in f64, for every |x| >= 2^-108,
  and within 2^-133 below (x2 falls into bf16's subnormals there);
* NaN, +-inf and finite values beyond bf16's largest (x0 rounds to inf)
  leave NaN in x2, so every score of their row and column is -inf;
* the plain version equals a numpy writing of the split bit for bit (round
  to nearest even on the bits; a NaN as a NaN, its payload aside);
* the split scores lie within 2^-22 of (2 sum_c |x_ic x_jc| + |x_j|^2) of
  the f64 scores on seeded clouds, no farther than the plain f32 product
  (``knn_scores``) lies;
* ``train/edge_conv_parts.py`` runs the split pass before the f32 instance
  in the sources that have it.
"""

import numpy as np
import pytest
import torch

from test_torch_edge_tiles import split_scores
from vcrnet_tpu_torch.ops import edgeconv
from vcrnet_tpu_torch.ops._common import knn_scores

BF16_MAX = float(np.float32((2 - 2 ** -7) * 2.0 ** 127))  # bf16's largest finite value
# the largest f32 that bf16 rounds to a finite value (the midpoint to inf, a tie, goes up)
ROUNDS_FINITE = float(np.nextafter(np.float32((2 - 2 ** -8) * 2.0 ** 127), np.float32(0)))


def bf16_bits(v: np.ndarray) -> np.ndarray:
    """bf16(v) rounded to nearest even, as uint16 bits (NaN 0x7FC0)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(v), np.uint16(0x7FC0), bits)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def numpy_split(x: np.ndarray) -> np.ndarray:
    """The split pass written on the bits: [3, ...] uint16."""
    with np.errstate(invalid="ignore"):
        p0 = bf16_bits(x)
        r = x - bf16_value(p0)
        p1 = bf16_bits(r)
        p2 = bf16_bits(r - bf16_value(p1))
    return np.stack([p0, p1, p2])


def _values(kind: str) -> np.ndarray:
    rng = np.random.RandomState(23)
    sign = rng.choice([-1.0, 1.0], 4096)
    if kind == "normal":  # every exponent the split holds exactly, random significands
        e = rng.randint(-108, 128, 4096)
        v = np.ldexp(1 + rng.rand(4096), e) * sign
        v[:2] = [2.0 ** -108, -(2.0 ** -108)]
        v = np.clip(v, -ROUNDS_FINITE, ROUNDS_FINITE)
        v[2:4] = [ROUNDS_FINITE, -BF16_MAX]
    elif kind == "bf16":  # values bf16 holds: x1 = x2 = 0
        v = bf16_value(bf16_bits(rng.randn(4096).astype(np.float32))).astype(np.float64)
    elif kind == "zeros":
        v = np.where(sign > 0, 0.0, -0.0)
    else:  # "tiny": below 2^-108, f32 subnormals included
        v = np.ldexp(1 + rng.rand(4096), rng.randint(-149, -108, 4096)) * sign
    return v.astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "bf16", "zeros", "tiny"])
def test_the_split_sums_to_x(kind):
    x = _values(kind)
    planes = edgeconv.split_planes(torch.from_numpy(x))
    assert planes.shape == (3, x.size) and planes.dtype == torch.bfloat16
    total = planes.double().sum(0).numpy()
    if kind == "tiny":
        np.testing.assert_array_less(np.abs(total - x.astype(np.float64)), 2.0 ** -133 + 1e-300)
    else:
        np.testing.assert_array_equal(total, x.astype(np.float64))
    if kind in ("bf16", "zeros"):
        assert not planes[1:].float().abs().sum()


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf, 3.397e38, -3.4e38],
                         ids=["nan", "inf", "-inf", "x0-overflows", "-x0-overflows"])
def test_values_the_split_cannot_hold_score_minus_inf(value):
    value = np.float32(value)
    if np.isfinite(value):  # finite, but rounds x0 to inf
        assert abs(value) > BF16_MAX and np.isinf(bf16_value(bf16_bits(value)))
    rng = np.random.RandomState(29)
    x = rng.randn(1, 16, 64).astype(np.float32)
    x[0, 5, 17] = value
    planes = edgeconv.split_planes(torch.from_numpy(x))
    assert torch.isnan(planes[2, 0, 5, 17])
    s = split_scores(torch.from_numpy(x)).numpy()
    assert np.all(s[0, 5] == -np.inf) and np.all(s[0, :, 5] == -np.inf)
    others = np.delete(np.delete(s[0], 5, axis=0), 5, axis=1)
    assert np.isfinite(others[~np.eye(15, dtype=bool)]).all()


def test_the_plain_split_equals_its_numpy_writing_bit_for_bit():
    parts = [_values(kind) for kind in ("normal", "bf16", "zeros", "tiny")]
    x = np.concatenate(parts + [np.float32([np.nan, np.inf, -np.inf, 3.397e38, -3.4e38,
                                            2.0 ** -126, 2.0 ** -149])])
    got = edgeconv.split_planes_ref(torch.from_numpy(x)).view(torch.int16).numpy().view(np.uint16)
    want = numpy_split(x)
    nan = np.isnan(bf16_value(want))
    np.testing.assert_array_equal(np.isnan(bf16_value(got)), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])


def test_split_scores_lie_within_the_bound_of_the_f64_scores():
    """Within 2^-22 of 2 sum_c |x_ic x_jc| + |x_j|^2 (the f32 sums of
    exact products and the dropped terms, below 2^-26 of |x||y| a channel),
    and no farther than the plain f32 product's scores, on clouds of three
    scales."""
    for seed, scale in ((3, 1.0), (4, 30.0), (5, 1e-3)):
        x = (np.random.RandomState(seed).randn(2, 128, 64) * scale).astype(np.float32)
        x64 = x.astype(np.float64)
        want = 2 * np.einsum("bic,bjc->bij", x64, x64) - (x64 ** 2).sum(-1)[:, None, :]
        mag = (2 * np.einsum("bic,bjc->bij", np.abs(x64), np.abs(x64))
               + (x64 ** 2).sum(-1)[:, None, :])
        off = np.broadcast_to(~np.eye(128, dtype=bool), want.shape)
        err = (np.abs(split_scores(torch.from_numpy(x)).numpy() - want) / mag)[off]
        plain = (np.abs(knn_scores(torch.from_numpy(x)).numpy() - want) / mag)[off]
        assert err.max() <= 2.0 ** -22, (scale, err.max())
        assert err.max() <= plain.max(), (scale, err.max(), plain.max())


def test_edge_conv_parts_splits_before_the_f32_instance(tmp_path):
    """train/edge_conv_parts.py's f32 shim runs the split pass (shim_split,
    vcr_edge_split) into its scratch and then the f32 instance where the
    sources have vcr_edge_split, and calls the f32 instance on x alone in
    sources from before it."""
    from vcrnet_tpu_torch.ops import _build
    from vcrnet_tpu_torch.train import edge_conv_parts

    text = edge_conv_parts._source(_build.CSRC_DIR, "edge_conv.cu", ())
    shim = text.split('extern "C" int shim_f32(')[1]
    assert shim.index("shim_split(") < shim.index("vcr_edge_conv_f32knn(")
    assert "vcr_edge_split(" in text.split('extern "C" int shim_split(')[1]
    with open(f"{_build.CSRC_DIR}/edge_conv.cu") as fh:
        source = fh.read()
    start = source.index("// The split pass: x f32 [count]")
    end = source.index("// The f32 instance: x the split pass's planes")
    (tmp_path / "edge_conv.cu").write_text(source[:start] + source[end:])
    shim = edge_conv_parts._source(str(tmp_path), "edge_conv.cu", ()).split(
        'extern "C" int shim_f32(')[1]
    assert "shim_split(" not in shim and "vcr_edge_conv_f32knn(" in shim
