"""The feed-forward and DGCNN eval kernels' arithmetic in their own order, on the CPU.

csrc/pointer_ff.cu and csrc/dgcnn_eval.cu run only on the card. This file
writes what they compute in PyTorch, in their order, and holds it against
the port's plain versions (``fused_ff_ref``, ``fused_dgcnn_eval_ref``) and
against the JAX package's Pallas kernels in interpret mode
(``pallas_pointer.fused_ff``, ``pallas_dgcnn.fused_dgcnn_eval``), on the
same seeded numpy inputs:

* the product (csrc/gemm_wgmma.cuh) over all rows at once: bf16 operands,
  f32 sums over 64-deep slices of the depth in order (one slice a stage of
  its ring), then the bias in f32, the ReLU where the epilogue has one and
  one rounding to the output's type;
* fused_ff: the product twice, the first with a ReLU into a bf16 hidden
  scratch [rows, F], the second reading it back;
* dgcnn_eval: the neighbour-slot stream. For each slot j the row [x_j ; x_i
  ; 0 ...] (xyz rounded to bf16) goes through stage 1 as one product of
  depth 16 (W1 padded with zero rows), then stages 2-4; each stage's
  relu(acc + b) rounded to bf16 is folded into a running max of bf16
  values that starts at zero (stage 4 folds bf16(acc + b4), its ReLU being
  the zero start), its 256 columns in two halves; then the concat of the
  four maxima and the projection relu(cat W5 + b5) in f32.

Tolerances, each with its reason: the feed-forward's order and the plain
version round at the same points and differ only in the order of f32 sums,
which can move a bf16 rounding of h or of the output by one ulp: within
2^-8 of the output's largest value (the card's tolerance is 2^-6). The
stream's running maxima of rounded values are the rounded maxima exactly,
so the concat equals the plain version's wherever the f32 sums round the
same; held within 1e-3 of the largest output (the card's 2e-2). Against the
Pallas kernels the same bounds hold. The gates take every served and
trained shape, and on a CUDA tensor a refused shape raises, with no plain
version in its place.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vcrnet_tpu.ops.pallas_dgcnn as pd
import vcrnet_tpu.ops.pallas_pointer as pp
from vcrnet_tpu_torch.ops import _build, dgcnn, pointer
from vcrnet_tpu_torch.ops.graph import gather_neighbors

SLICE = 64  # depth of one stage of the product's ring


def _bf(t):
    return t.to(torch.bfloat16)


def _bfr(t):
    return _bf(t).float()


def product(a, w, bias, relu, out_dtype):
    """gemm_wgmma.cuh: act(a [rows, depth] @ w [depth, n] + bias) with bf16
    operands, f32 sums over 64-deep slices in order, one rounding."""
    a, w = _bfr(a), _bfr(w)
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], SLICE):
        acc = acc + a[:, k0:k0 + SLICE] @ w[k0:k0 + SLICE]
    v = acc + bias.float()
    return (torch.relu(v) if relu else v).to(out_dtype)


def ff_order(y, w1, b1, w2, b2):
    """pointer_ff.cu: two launches of the product through a bf16 hidden
    scratch."""
    rows = y.reshape(-1, y.shape[-1])
    hidden = product(rows, w1, _bfr(b1), True, torch.bfloat16)
    return product(hidden, w2, _bfr(b2), False, torch.bfloat16).reshape(*y.shape[:-1], -1)


def dgcnn_order(x, idx, folded, emb):
    """dgcnn_eval.cu: the edge kernel's stream over the neighbour slots,
    then the projection."""
    (w1, b1), (w2, b2), (w3, b3), (w4, b4), (w5, b5) = [(_bfr(w), b.float()) for w, b in folded]
    xb = _bfr(x.float())
    B, n, k = idx.shape
    w1p = torch.zeros(16, 64)
    w1p[:6] = w1  # depth 16: rows [x_j y_j z_j x_i y_i z_i] then zeros
    m = [torch.zeros(B, n, c) for c in (64, 64, 128, 256)]
    for j in range(k):
        row = torch.cat([gather_neighbors(xb, idx[:, :, j:j + 1])[:, :, 0], xb,
                         torch.zeros(B, n, 10)], dim=-1)
        h = _bfr(torch.relu(row @ w1p + b1))
        m[0] = torch.maximum(m[0], h)
        h = _bfr(torch.relu(h @ w2 + b2))
        m[1] = torch.maximum(m[1], h)
        h = _bfr(torch.relu(h @ w3 + b3))
        m[2] = torch.maximum(m[2], h)
        for half in (slice(0, 128), slice(128, 256)):
            m[3][..., half] = torch.maximum(m[3][..., half], _bfr(h @ w4[:, half] + b4[half]))
    cat = torch.cat(m, dim=-1).reshape(B * n, -1)
    return product(cat, w5, b5, True, torch.float32).reshape(B, n, emb)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the feed-forward sublayer
# ---------------------------------------------------------------------------

def _ff_inputs(b, n, d, f, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, n, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return y, w1, b1, w2, b2


@pytest.mark.parametrize("b,n,d,f", [(2, 80, 128, 256), (1, 64, 256, 512), (3, 40, 128, 384)])
def test_ff_order_matches_plain_version(b, n, d, f):
    arrays = _ff_inputs(b, n, d, f, seed=b * n + f)
    t = [torch.from_numpy(a) for a in arrays]
    got, want = ff_order(*t), pointer.fused_ff_ref(*t)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == (b, n, d)
    assert _rel(got.float(), want.float()) <= 2 ** -8


@pytest.mark.parametrize("b,n,d,f", [(2, 128, 128, 256), (1, 256, 256, 384)])
def test_ff_order_matches_pallas_kernel(b, n, d, f):
    arrays = _ff_inputs(b, n, d, f, seed=7 + n + f)
    got = ff_order(*[torch.from_numpy(a) for a in arrays])
    want = pp.fused_ff(*[jnp.asarray(a) for a in arrays], interpret=True)
    assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) <= 2 ** -8


def test_ff_hidden_is_rounded_after_the_relu():
    """The hidden scratch holds bf16(relu(y W1 + b1)): no negative value and
    every value a bf16."""
    y, w1, b1, _, _ = (torch.from_numpy(a) for a in _ff_inputs(1, 64, 128, 256, seed=3))
    hidden = product(y.reshape(-1, 128), w1, _bfr(b1), True, torch.bfloat16)
    assert bool((hidden >= 0).all()) and (hidden == 0).float().mean() > 0.2


# ---------------------------------------------------------------------------
# DGCNN's eval chain
# ---------------------------------------------------------------------------

def _dgcnn_inputs(b, n, k, emb, seed, duplicates=False):
    rng = np.random.default_rng(seed)
    pts = 8 if duplicates else n
    x = rng.uniform(-1, 1, (b, pts, 3)).astype(np.float32)
    if duplicates:
        x = np.tile(x, (1, n // pts, 1))
    # any neighbour list in [0, N) is a valid input; the diagonal excluded as kNN does
    idx = np.stack([np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                              for i in range(n)]) for _ in range(b)]).astype(np.int32)
    folded = [((rng.standard_normal((i, o)) * i ** -0.5).astype(np.float32),
               (rng.standard_normal(o) * 0.1).astype(np.float32))
              for i, o in dgcnn.STAGE_WIDTHS + ((dgcnn.CAT_WIDTH, emb),)]
    return x, idx, folded


def _torch_folded(folded):
    return [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in folded]


@pytest.mark.parametrize("b,n,k,dup", [(2, 64, 20, False), (1, 80, 4, False), (2, 64, 1, False),
                                       (1, 64, 20, True)])
def test_dgcnn_stream_matches_plain_version(b, n, k, dup):
    x, idx, folded = _dgcnn_inputs(b, n, k, 128, seed=n + k, duplicates=dup)
    tx, tidx, tf = torch.from_numpy(x), torch.from_numpy(idx), _torch_folded(folded)
    got = dgcnn_order(tx, tidx, tf, 128)
    want = dgcnn.fused_dgcnn_eval_ref(tx, tidx, tf, 128)
    assert got.dtype == torch.float32 and got.shape == (b, n, 128)
    assert float(want.abs().max()) > 0.1 and float((want > 0).float().mean()) > 0.2
    assert _rel(got, want) <= 1e-3


@pytest.mark.parametrize("b,n,k", [(1, 64, 20), (2, 80, 4)])
def test_dgcnn_stream_matches_pallas_kernel(b, n, k):
    x, idx, folded = _dgcnn_inputs(b, n, k, 128, seed=31 + n + k)
    got = dgcnn_order(torch.from_numpy(x), torch.from_numpy(idx), _torch_folded(folded), 128)
    want = pd.fused_dgcnn_eval(jnp.asarray(x), jnp.asarray(idx),
                               [(jnp.asarray(w), jnp.asarray(c)) for w, c in folded], 128,
                               interpret=True)
    assert _rel(got, np.asarray(want)) <= 1e-3


def test_running_max_of_rounded_values_is_the_rounded_max():
    """What lets the kernel fold bf16 pairs: max_j bf16(v_j) == bf16(max_j v_j)
    (rounding to nearest is monotone), and a running max that starts at
    zero is the max of the ReLUs."""
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((20, 4096)).astype(np.float32))
    assert torch.equal(_bfr(v).amax(0), _bfr(v.amax(0)))
    running = torch.zeros(4096)
    for row in v:
        running = torch.maximum(running, _bfr(row))
    assert torch.equal(running, _bfr(torch.relu(v).amax(0)))


# ---------------------------------------------------------------------------
# gates and refusals
# ---------------------------------------------------------------------------

def test_gates_take_every_served_and_trained_shape(monkeypatch):
    """The pointer's feed-forward at the served lengths (whole clouds 1024,
    the partial crops 768 and 3072, the subsample 512) at D = 512, F = 1024;
    DGCNN at the served and trained N with k = 20, emb 512, and k up to
    N - 1 now that the edge kernel streams the neighbour slots."""
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    for n in (512, 768, 1024, 3072, 992, 1):
        assert pointer.fused_ff_supported(n, 512, 1024), n
    for n in (512, 768, 1024, 3072):
        assert dgcnn.fused_dgcnn_supported(n, 20, 512), n
    assert dgcnn.fused_dgcnn_supported(1024, 1023, 512)
    assert not dgcnn.fused_dgcnn_supported(1024, 1024, 512)
    assert pointer.pointer_ff_smem_bytes(512, 1024) == pointer.pointer_mha_smem_bytes(512)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.fixture
def no_extension(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a refused shape must raise before the extension is built")

    monkeypatch.setattr(_build, "extension", refuse)
    monkeypatch.setattr(pointer, "fused_ff_ref", None)  # no plain version on the card
    monkeypatch.setattr(dgcnn, "fused_dgcnn_eval_ref", None)


@pytest.mark.parametrize("d,f", [(512, 8192), (1152, 1024), (512, 1000), (100, 256)])
def test_refused_ff_widths_raise_on_the_card(no_extension, d, f):
    before = pointer.fused_ff.launches
    with torch.no_grad(), pytest.raises(ValueError, match="fused_ff kernel does not take"):
        pointer.fused_ff(_fake((1, 64, d)), _fake((d, f)), _fake((f,)), _fake((f, d)),
                         _fake((d,)))
    assert pointer.fused_ff.launches == before


# N = 1000 is taken since the ragged tiles of ROADMAP C1: its refusal is by
# the projection's width (320 is no whole number of 128-column passes)
@pytest.mark.parametrize("n,k,emb", [(1000, 20, 320), (64, 64, 128), (64, 0, 128),
                                     (1024, 20, 500)])
def test_refused_dgcnn_shapes_raise_on_the_card(no_extension, n, k, emb):
    folded = [(_fake((i, o)), _fake((o,)))
              for i, o in dgcnn.STAGE_WIDTHS + ((dgcnn.CAT_WIDTH, emb),)]
    before = dgcnn.fused_dgcnn_eval.launches
    with torch.no_grad(), pytest.raises(ValueError, match="does not take"):
        dgcnn.fused_dgcnn_eval(_fake((1, n, 3)), _fake((1, n, k), torch.int32), folded, emb)
    assert dgcnn.fused_dgcnn_eval.launches == before


def test_served_shapes_launch_once(monkeypatch):
    """On the card each wrapper makes one counted launch of its extension
    function, whatever number of kernels that runs."""
    calls = []

    class Ext:
        @staticmethod
        def pointer_ff(y, *rest):
            calls.append(("ff", tuple(y.shape), tuple(rest[0].shape)))

        @staticmethod
        def dgcnn_eval(x, idx, args, out):
            calls.append(("dgcnn", tuple(x.shape), idx.shape[-1], tuple(out.shape)))

    for module in (pointer, dgcnn):
        monkeypatch.setattr(module, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", lambda: Ext)
    ff0, dg0 = pointer.fused_ff.launches, dgcnn.fused_dgcnn_eval.launches
    with torch.no_grad():
        y = torch.zeros(2, 992, 512)
        out = pointer.fused_ff(y, torch.zeros(512, 1024), torch.zeros(1024),
                               torch.zeros(1024, 512), torch.zeros(512))
        assert out.shape == (2, 992, 512) and out.dtype == torch.bfloat16
        folded = [(torch.zeros(i, o), torch.zeros(o))
                  for i, o in dgcnn.STAGE_WIDTHS + ((dgcnn.CAT_WIDTH, 512),)]
        emb = dgcnn.fused_dgcnn_eval(torch.zeros(1, 784, 3),
                                     torch.zeros(1, 784, 32, dtype=torch.int32), folded, 512)
        assert emb.shape == (1, 784, 512) and emb.dtype == torch.float32
    assert calls == [("ff", (2, 992, 512), (512, 1024)), ("dgcnn", (1, 784, 3), 32, (1, 784, 512))]
    assert pointer.fused_ff.launches == ff0 + 1 and dgcnn.fused_dgcnn_eval.launches == dg0 + 1
