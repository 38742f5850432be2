"""One int8 call for the projections that share an input (ops/int8_linear.py's
``int8_linear_shared`` and the grouping in models/transformer.py's
``MultiHeadAttention``), on the CPU, where the port runs the plain version,
against the JAX package's eager ``int8_linear`` (vcrnet_tpu/ops/int8_linear.py).

Tolerances, stated:
  * the plain route of a call of 1, 2 or 3 pairs against ``int8_linear_ref``
    on each pair and against the eager JAX function on each pair: bit for bit
    (one quantization of x serves every pair, and it is the one each pair's
    own call makes);
  * the kernel's division (Markstein's step on the reciprocal, written here
    in exact rational arithmetic with each f32 operation rounded to nearest
    even) against the correctly rounded quotient: every code equal.
"""

import importlib
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vcrnet_tpu.ops.int8_linear import int8_linear as j_int8_linear
from vcrnet_tpu_torch.models import _common
from vcrnet_tpu_torch.models.transformer import MultiHeadAttention
from vcrnet_tpu_torch.ops import flop_meter as fm

i8 = importlib.import_module("vcrnet_tpu_torch.ops.int8_linear")
ops = importlib.import_module("vcrnet_tpu_torch.ops")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """The same bf16 values for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _call_inputs(rows, k, fs, seed):
    """bf16 x [rows, K] with a zero row and a row of one huge value, and a
    pair (JAX kernel [K, F], port weight [F, K], bias) for each F in ``fs``,
    each weight with a zero output channel."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, k).astype(np.float32)
    x[1] = 0.0
    x[2, 5] = 3e4
    jx, tx = _bf16(x)
    pairs = []
    for i, f in enumerate(fs):
        kernel = (rng.randn(k, f) / np.sqrt(k)).astype(np.float32)
        kernel[:, i] = 0.0
        (jk, tk), (jb, tb) = _bf16(kernel), _bf16(rng.randn(f).astype(np.float32))
        pairs.append(((jk, jb), (tk.t().contiguous(), tb)))
    return jx, tx, pairs


@pytest.mark.parametrize("n_pairs", [1, 2, 3])
@pytest.mark.parametrize("rows,k,f", [(130, 64, 64), (70, 576, 320)])
def test_a_shared_call_equals_each_pair_alone_and_eager_jax(rows, k, f, n_pairs):
    jx, tx, pairs = _call_inputs(rows, k, [f] * n_pairs, seed=n_pairs)
    outs = i8.int8_linear_shared(tx, [tp for _, tp in pairs])
    refs = i8.int8_linear_shared_ref(tx, [tp for _, tp in pairs])
    assert len(outs) == n_pairs
    for out, ref, ((jk, jb), (tw, tb)) in zip(outs, refs, pairs):
        assert out.dtype == torch.bfloat16 and out.shape == (rows, f) and out.is_contiguous()
        assert torch.equal(out, ref)
        assert torch.equal(out, i8.int8_linear_ref(tx, tw, tb))
        want = np.asarray(j_int8_linear(jx, jk, jb).astype(jnp.float32))
        np.testing.assert_array_equal(out.float().numpy(), want)
    # the parts: one row-scale vector for x, the weights' codes stacked
    parts, xs, wq, ws = i8.int8_linear_parts(tx, [tp for _, tp in pairs])
    assert all(torch.equal(a, b) for a, b in zip(parts, outs))
    assert xs.shape == (rows, 1) and wq.shape == (n_pairs * f, k) and ws.shape == (n_pairs * f, 1)
    assert torch.equal(xs, i8.quantize_rows_ref(tx)[1])


def test_a_shared_call_takes_pairs_of_other_widths_and_leading_axes():
    _, tx, pairs = _call_inputs(96, 128, [64, 128, 320], seed=7)
    x3 = tx.reshape(2, 48, 128)
    outs = i8.int8_linear_shared(x3, [tp for _, tp in pairs])
    for out, (_, (tw, tb)) in zip(outs, pairs):
        assert out.shape == (2, 48, tw.shape[0])
        assert torch.equal(out, i8.int8_linear_ref(x3, tw, tb))
    # the call of one pair is the shared call of one
    tw, tb = pairs[2][1]
    assert torch.equal(i8.int8_linear(x3, tw, tb), outs[2])


def test_the_gate_takes_the_widths_of_a_call():
    assert i8.int8_supported(65536, 512, [512, 512, 512])
    assert i8.int8_supported(1, 64, (64,)) and i8.int8_supported(7, 1024, [1024, 64])
    assert not i8.int8_supported(8, 512, [])
    assert not i8.int8_supported(8, 512, [512] * 4)
    assert not i8.int8_supported(8, 512, [512, 96])
    assert not i8.int8_supported(8, 512, [2048])
    assert not i8.int8_supported(8, 96, [512])
    assert not i8.int8_supported(0, 512, [512])


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("why", ["no_pair", "four_pairs", "one_f", "one_dtype", "one_bias",
                                 "one_layout", "one_gradient"])
def test_a_cuda_call_of_pairs_the_kernel_refuses_raises(monkeypatch, why):
    """A refused call of several pairs raises before the extension is built;
    nothing runs the plain version in the kernel's place."""
    def no_build():
        raise AssertionError("a refused call reached the extension")

    monkeypatch.setattr(i8._build, "extension", no_build)

    def fake(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)

    x = fake(8, 64)
    pairs = [(fake(64, 64), fake(64)) for _ in range(3)]
    if why == "no_pair":
        pairs = []
    elif why == "four_pairs":
        pairs = pairs + pairs[:1]
    elif why == "one_f":
        pairs[1] = (fake(96, 64), fake(96))
    elif why == "one_dtype":
        pairs[1] = (fake(64, 64, dtype=torch.float32), fake(64))
    elif why == "one_bias":
        pairs[2] = (fake(64, 64), fake(32))
    elif why == "one_layout":
        pairs[2] = (fake(64, 64).t(), fake(64))
    elif why == "one_gradient":
        pairs[1][0].requires_grad_(True)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        i8.int8_linear_shared(x, pairs)


class _NoKernels:
    """An extension whose every entry point records its call and returns."""

    calls = []

    def __getattr__(self, name):
        return lambda *args: _NoKernels.calls.append((name, args))


def test_the_kernel_route_counts_one_launch_a_call_and_a_product_a_pair(monkeypatch):
    """A call of three pairs down the kernel route (CPU tensors, the
    extension's entry points replaced) is one launch of the extension with
    the three weights, biases and outputs as lists, three projections, and
    the meter's formula once for each pair."""
    monkeypatch.setattr(i8._build, "extension", _NoKernels)
    monkeypatch.setattr(i8, "kernel_route", lambda *t: True)
    _NoKernels.calls = []
    bf = torch.bfloat16
    x = torch.zeros(2, 64, 256, dtype=bf)
    pairs = [(torch.zeros(f, 256, dtype=bf), torch.zeros(f, dtype=bf)) for f in (256, 256, 128)]
    ops.reset_launch_counts()
    with torch.no_grad(), fm.meter() as acc:
        outs = i8.int8_linear_shared(x, pairs)
    assert [o.shape for o in outs] == [(2, 64, 256), (2, 64, 256), (2, 64, 128)]
    assert ops.launch_counts()["int8_linear"] == 1 and ops.int8_linear.projections == 3
    assert acc[0] == 2 * fm.int8_linear_flops(128, 256, 256) + fm.int8_linear_flops(128, 128, 256)
    (name, args), = _NoKernels.calls
    assert name == "int8_linear" and len(args[1]) == len(args[2]) == len(args[3]) == 3
    assert args[6] is None  # no row scales asked for
    ops.reset_launch_counts()
    assert ops.int8_linear.projections == 0


def _count_calls(monkeypatch, kernel: bool):
    """The number of pairs of each int8 call the model makes, on the route
    ``kernel`` names: the op ``vcrnet_torch::int8_linear`` (its list of
    weights and biases) or the plain version."""
    calls = []
    if kernel:
        real = i8._int8_linear_op

        def counted(x, params):
            calls.append(len(params) // 2)
            return real(x, params)

        monkeypatch.setattr(i8, "_int8_linear_op", counted)
    else:
        real = _common.int8_linear_shared_ref

        def counted(x, pairs):
            calls.append(len(pairs))
            return real(x, pairs)

        monkeypatch.setattr(_common, "int8_linear_shared_ref", counted)
    return calls


def _mha(**kw):
    torch.manual_seed(0)
    return MultiHeadAttention(128, 1, dtype=torch.bfloat16, int8=True, **kw).eval()


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("case", ["self", "cross", "remask", "remask_streaming", "distinct"])
def test_multi_head_attention_groups_its_projections_by_input(monkeypatch, case, flash):
    """Self-attention: one call of three (q, k, v) and the out projection;
    cross attention and the re-mask (written out, or streaming through the
    column masses): q alone, one call of two (k, v of the memory), out; three
    inputs: a call each. The grouped outputs equal the projections one pair
    at a time."""
    n = 128 if case == "remask_streaming" else 64
    g = torch.Generator().manual_seed(1)
    x, m, y = (torch.randn(2, n, 128, generator=g).bfloat16() for _ in range(3))
    kw = {}
    if case.startswith("remask"):
        kw = dict(remask=True, overlap2=0.75)
        if case == "remask_streaming":
            kw["stream_above"] = 64
    mha = _mha(flash=flash, **kw)
    args = {"self": (x, x, x), "cross": (x, m, m), "remask": (x, m, m),
            "remask_streaming": (x, m, m), "distinct": (x, m, y)}[case]
    calls = _count_calls(monkeypatch, kernel=flash)
    with torch.no_grad():
        got = mha(*args)
    want = {"self": [3, 1], "distinct": [1, 1, 1, 1]}.get(case, [1, 2, 1])
    assert calls == want
    # the same projections one pair at a time give the same output
    monkeypatch.undo()
    one = _mha(flash=flash, **kw)
    one.load_state_dict(mha.state_dict())

    def project_alone(layers, inp):
        return tuple(_common.int8_dense((layer,), inp, one.dtype, kernel=one.flash)[0]
                     for layer in layers)

    monkeypatch.setattr(one, "_proj", project_alone)
    with torch.no_grad():
        assert torch.equal(one(*args), got)


# --- the kernel's division, in exact arithmetic

def _rn32(v: Fraction) -> Fraction:
    """v rounded to the nearest f32 (normal range), ties to even."""
    if v == 0:
        return Fraction(0)
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()  # 2^(e-1) < a < 2^(e+1)
    if a >= Fraction(2) ** e:
        e += 1  # 2^(e-1) <= a < 2^e: the ulp is 2^(e-24)
    scale = Fraction(2) ** (24 - e)
    return Fraction(round(v * scale)) / scale  # round() on a Fraction: half to even


def _kernel_code(v: Fraction, s: Fraction) -> int:
    """csrc/int8_linear.cu's code() for a scale of the normal range: inv =
    fl(1 / s), q0 = fl(v inv), e = v - s q0 (one fma: exact), fl(q0 + e inv),
    rounded half to even."""
    inv = _rn32(1 / s)
    q0 = _rn32(v * inv)
    e = _rn32(v - s * q0)
    return round(_rn32(q0 + e * inv))


def test_the_kernel_division_gives_the_correctly_rounded_codes():
    """Markstein's step gives round(fl(v / s)) for bf16 v under a bf16 row
    maximum a (s = fl(a / 127)), here for the bf16 values whose quotient
    lies within 1e-6 of a half-integer, where the product by the reciprocal
    alone can round the other way, and a sample of the others (the card
    holds every pair: train/int8_parts.py)."""
    rng = np.random.RandomState(3)
    bits = np.arange(1, 0x7F80, dtype=np.uint32)  # the positive finite bf16 values
    values = (bits << 16).view(np.float32).astype(np.float64)
    cases = []
    for a in values[rng.randint(0x3000, 0x4A00, 60)]:  # row maxima from about 1e-9 to 1e6
        s = _rn32(Fraction(a) / 127)
        v = values[values <= a]
        q = v / float(s)
        near = np.abs(q - np.floor(q) - 0.5) < 1e-6
        for x in np.concatenate([v[near], v[rng.randint(0, len(v), 20)]]):
            cases += [(x, a), (-x, a)]
    assert len(cases) > 2400
    product_misses = 0
    for v, a in cases:
        s = _rn32(Fraction(a) / 127)
        want = round(_rn32(Fraction(v) / s))
        assert _kernel_code(Fraction(v), s) == want, (v, a)
        product_misses += round(_rn32(Fraction(v) * _rn32(1 / s))) != want
    assert product_misses > 0  # the cases reach where the plain product rounds otherwise
