"""Dynamic-int8 pointer projections of the port (ops/int8_linear.py and the
``int8`` path of models/transformer.py) against the JAX package's
(vcrnet_tpu/ops/int8_linear.py, ``TransformerPointer(int8=True)``), on the
CPU, where the port runs the plain version.

Tolerances, stated:
  * the plain versions against the EAGER JAX functions: bit for bit (codes,
    scales and outputs; true divisions, round half to even, an exact
    product, the epilogue's three roundings in the same order);
  * against the JITTED JAX functions (XLA rewrites the divisions, so its
    scales differ by an f32 ulp and a few codes by one step): codes that
    differ in fewer than 0.1% of the entries; outputs within one bf16 ulp
    where no code of their row of x or column of the weight differs, and
    elsewhere within that ulp plus one code step for each code that differs
    there (127 * x_scale * w_scale each);
  * the int8 pointer against the JAX int8 pointer on the same weights: the
    bf16 pointer parity's 2e-2 (tests/test_torch_modules.py) widened to
    4e-2 for the int8 gap: a last-bit difference of a LayerNorm output moves
    a code by one step, 1/127 of its row's largest value;
  * ``vcrnet_iter`` at iter=3 with int8 against the JAX model: 2e-2 on R and
    t, twice the bf16 loop's 1e-2 (tests/test_torch_refine_partial.py), for
    the same reason;
  * training with the flag against training without it: bit for bit, as
    tests/test_int8.py holds the JAX package.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models.transformer import TransformerPointer as JPointer
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.ops.int8_linear import int8_linear as j_int8_linear
from vcrnet_tpu.ops.int8_linear import quantize_rows as j_quantize_rows
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.models import DCP, VCRNet, vcrnet_iter
from vcrnet_tpu_torch.models import _common
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.utils.params import from_jax_params

# the module (ops/__init__.py binds the name ops.int8_linear to its wrapper)
i8 = importlib.import_module("vcrnet_tpu_torch.ops.int8_linear")

N = 64
NARROW = dict(num_points=N, emb_dims=64, ff_dims=128, n_heads=2)
POINTER_TOL = dict(atol=4e-2, rtol=4e-2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_pair(a):
    """The same bf16 values for both packages: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _operands(rows, k, f, seed):
    """bf16 x [rows, K] with a zero row, a row of one huge value and a row
    of tiny values; a JAX kernel [K, F] and the port's weight [F, K]; a bias."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, k).astype(np.float32)
    x[1] = 0.0
    x[2, 5] = 3e4
    x[3] *= 1e-20
    kernel = (rng.randn(k, f) / np.sqrt(k)).astype(np.float32)
    kernel[:, 0] = 0.0  # a zero output channel
    bias = rng.randn(f).astype(np.float32)
    (jx, tx), (jk, tk), (jb, tb) = map(_bf16_pair, (x, kernel, bias))
    return (jx, jk, jb), (tx, tk.t().contiguous(), tb)


def _ulp_bf16(v):
    """One bf16 ulp at each |v| (the spacing above it)."""
    v = np.abs(np.asarray(v, np.float32))
    e = np.floor(np.log2(np.maximum(v, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("rows,k,f", [(128, 64, 64), (300, 512, 192)])
def test_quantize_rows_ref_equals_eager_jax(rows, k, f):
    (jx, jk, _), (tx, tw, _) = _operands(rows, k, f, 0)
    for ja, ta in ((jx, tx), (jk.T, tw)):
        q, s = j_quantize_rows(ja)
        tq, ts = i8.quantize_rows_ref(ta)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (len(ta), 1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    # the zero row: finite scale, zero codes
    tq, ts = i8.quantize_rows_ref(tx)
    assert torch.isfinite(ts).all() and not tq[1].any()


@pytest.mark.parametrize("rows,k,f", [(128, 64, 64), (300, 512, 192)])
def test_int8_linear_ref_equals_eager_jax(rows, k, f):
    (jx, jk, jb), (tx, tw, tb) = _operands(rows, k, f, 1)
    want = np.asarray(j_int8_linear(jx, jk, jb).astype(jnp.float32))
    got = i8.int8_linear_ref(tx, tw, tb)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, f)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the wrapper on CPU tensors is the plain version, any leading axes
    assert torch.equal(i8.int8_linear(tx.reshape(2, rows // 2, k) if rows % 2 == 0 else tx, tw,
                                      tb).reshape(rows, f), got)
    outs, xs, wq, ws = i8.int8_linear_parts(tx, ((tw, tb),))
    assert torch.equal(outs[0], got) and xs.shape == (rows, 1) and wq.shape == (f, k)
    assert ws.shape == (f, 1)


def test_plain_versions_are_within_one_bf16_ulp_of_jitted_jax():
    (jx, jk, jb), (tx, tw, tb) = _operands(1024, 512, 256, 2)
    want = np.asarray(jax.jit(j_int8_linear)(jx, jk, jb).astype(jnp.float32))
    got = i8.int8_linear_ref(tx, tw, tb).float().numpy()
    assert (got != want).any()  # the jitted function is not the eager one
    diff_codes = []
    for ja, ta in ((jx, tx), (jk.T, tw)):
        q, s = jax.jit(j_quantize_rows)(ja)
        tq, ts = i8.quantize_rows_ref(ta)
        differ = tq.numpy() != np.asarray(q)
        assert differ.mean() < 1e-3
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=2.0 ** -23, atol=0)
        diff_codes.append((differ.sum(axis=1), ts.numpy()[:, 0]))
    (nx, xs), (nw, ws) = diff_codes
    ulp = _ulp_bf16(want)
    clean = (nx[:, None] == 0) & (nw[None, :] == 0)
    assert clean.mean() > 0.9 and np.all(np.abs(got - want)[clean] <= ulp[clean])
    step = 127.0 * xs[:, None] * ws[None, :] * (nx[:, None] + nw[None, :])
    assert np.all(np.abs(got - want) <= ulp + step)


def test_gate():
    assert i8.int8_supported(1, 64, 64) and i8.int8_supported(885 * 8, 512, 512)
    assert i8.int8_supported(7, 1024, 1024)
    assert not i8.int8_supported(8, 96, 512)  # K % 64
    assert not i8.int8_supported(8, 512, 520)  # F % 64
    assert not i8.int8_supported(8, 2048, 512)  # past the widths held on the card
    assert not i8.int8_supported(0, 512, 512)
    # the list form: the widths of a call's pairs
    assert i8.int8_supported(885 * 8, 512, [512, 512, 512]) and i8.int8_supported(7, 576, (320,))
    assert i8.int8_supported(7, 1024, [64, 1024])
    assert not i8.int8_supported(8, 512, [])  # no pair
    assert not i8.int8_supported(8, 512, [512] * 4)  # more pairs than q, k and v
    assert not i8.int8_supported(8, 512, [512, 520])  # one F % 64
    assert not i8.int8_supported(8, 512, [512, 2048])  # one F past the widths held


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrapper takes the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("why", ["k", "f", "wide", "dtype", "layout", "gradient"])
def test_a_cuda_call_the_kernel_refuses_raises(monkeypatch, why):
    """Refused shapes, dtypes, layouts and gradients raise before the
    extension is built; nothing runs the plain version in the kernel's
    place."""
    def no_build():
        raise AssertionError("a refused call reached the extension")

    monkeypatch.setattr(i8._build, "extension", no_build)
    k, f = {"k": (96, 64), "f": (64, 100), "wide": (2048, 64)}.get(why, (64, 64))
    dtype = torch.float32 if why == "dtype" else torch.bfloat16

    def fake(*shape):
        return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)

    x, w, b = fake(8, k), fake(f, k), fake(f)
    if why == "layout":
        w = fake(k, f).t()
    if why == "gradient":
        w.requires_grad_(True)
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        i8.int8_linear(x, w, b)


@pytest.mark.cuda
def test_the_kernel_refuses_a_k_it_does_not_take_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py's int8 phase on the H100)")
    x = torch.zeros(64, 96, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(64, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiples of 64"):
        i8.int8_linear(x, w, torch.zeros(64, dtype=torch.bfloat16, device="cuda"))


def _count_int8(monkeypatch, kernel: bool, groups: list | None = None):
    """Records (rows, K, F) of each int8 projection, which must take the
    route ``kernel`` names: ``ops.int8_linear``'s call of shared pairs (the
    model's kernel route) or its plain version; the other one raises.
    ``groups``, where given, receives the number of pairs of each call."""
    calls = []
    taken, other = ("int8_linear_shared", "int8_linear_shared_ref")[::1 if kernel else -1]
    real = getattr(_common, taken)

    def counted(x, pairs):
        pairs = tuple(pairs)
        calls.extend((x.numel() // x.shape[-1], x.shape[-1], w.shape[0]) for w, _ in pairs)
        if groups is not None:
            groups.append(len(pairs))
        return real(x, pairs)

    def refused(x, pairs):
        raise AssertionError(f"an int8 projection took {other} on the other route")

    monkeypatch.setattr(_common, taken, counted)
    monkeypatch.setattr(_common, other, refused)
    return calls


@pytest.mark.parametrize("flash", [False, True])
def test_int8_pointer_eval_matches_jax(monkeypatch, flash):
    rng = np.random.RandomState(8)
    d, heads = 256, 2  # dk = 128 keeps the packed-head route's shapes valid
    src, tgt = ((rng.randn(2, N, d) * 0.5).astype(np.float32) for _ in range(2))
    kw = dict(emb_dims=d, n_heads=heads, ff_dims=128, dtype=jnp.bfloat16)
    jp = JPointer(int8=True, **kw)
    variables = jax.jit(JPointer(**kw).init)(jax.random.PRNGKey(1), src, tgt)
    p = TransformerPointer(d, 1, heads, 128, dtype=torch.bfloat16, flash=flash, int8=True)
    p.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    p.eval()
    groups = []
    calls = _count_int8(monkeypatch, kernel=flash, groups=groups)
    want = jp.apply(variables, jnp.asarray(src, jnp.bfloat16), jnp.asarray(tgt, jnp.bfloat16))
    with torch.no_grad():
        got = p(_t(src).bfloat16(), _t(tgt).bfloat16())
    # 6 attention sublayers (two encoder passes, two decoders of two), 4
    # projections each, every one at K = F = d; the 4 self-attentions in
    # calls of 3 and 1, the 2 cross attentions in calls of 1, 2 and 1
    assert len(calls) == 24 and {c[1:] for c in calls} == {(d, d)}
    assert len(groups) == 4 * 2 + 2 * 3 and sorted(groups) == [1] * 8 + [2] * 2 + [3] * 4
    bf16 = JPointer(**kw).apply(variables, jnp.asarray(src, jnp.bfloat16),
                                jnp.asarray(tgt, jnp.bfloat16))
    for g, w, b in zip(got, want, bf16):
        w = np.asarray(w).astype(np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, **POINTER_TOL)
        # and int8 is really taken: the JAX int8 pointer is not its bf16 one
        assert not np.array_equal(w, np.asarray(b).astype(np.float32))


def test_int8_pointer_training_equals_the_bf16_pointer():
    torch.manual_seed(0)
    kw = dict(dtype=torch.bfloat16, flash=True)
    p8 = TransformerPointer(128, 1, 1, 128, int8=True, **kw)
    pb = TransformerPointer(128, 1, 1, 128, **kw)
    pb.load_state_dict(p8.state_dict())
    x = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(1))
    outs, grads = [], []
    for p in (p8, pb):
        p.train()
        out = p(x, x.flip(1))
        sum(o.float().square().sum() for o in out).backward()
        outs.append(out)
        grads.append([q.grad for q in p.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # and in eval the flag is taken
    p8.eval()
    pb.eval()
    with torch.no_grad():
        assert not torch.equal(p8(x, x.flip(1))[0], pb(x, x.flip(1))[0])


def _jax_vcrnet(**kw):
    jmodel = JVCRNet(cfg=JConfig(**NARROW, compute_dtype="bfloat16", **kw))
    cloud = np.zeros((1, N, 3), np.float32)
    return jmodel, jax.jit(jmodel.init)(jax.random.PRNGKey(0), cloud, cloud)


def _pair(seed, b):
    data = shapes_eval_set(b, num_points=N, cloud_points=2 * N, seed=seed)
    return data["src"], data["tgt"]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_vcrnet_iter_int8_matches_jax(monkeypatch, use_kernels):
    jmodel, variables = _jax_vcrnet(int8_eval=True)
    model = VCRNet(Config(**NARROW, compute_dtype="bfloat16", int8_eval=True), device="cpu",
                   use_kernels=use_kernels)
    model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
    model.eval()
    src, tgt = _pair(3, 2)
    calls = _count_int8(monkeypatch, kernel=use_kernels)
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), 3, model=jmodel)
    with torch.no_grad():
        got = vcrnet_iter(model, _t(src), _t(tgt), 3)
    # the target is encoded once (1 attention), each of the 3 iterations runs
    # the source's encoder and two decoders of two attentions: 16 attentions
    assert len(calls) == 16 * 4
    for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
        np.testing.assert_allclose(got[i].float().numpy(), np.asarray(want[i]), atol=2e-2,
                                   rtol=0)


def test_vcrnet_and_dcp_take_int8_eval_in_bf16(monkeypatch):
    src, tgt = _pair(4, 2)
    for model_cls, model in ((VCRNet, "vcrnet"), (DCP, "dcp")):
        torch.manual_seed(0)
        m8 = model_cls(Config(**NARROW, model=model, compute_dtype="bfloat16", int8_eval=True),
                       device="cpu")
        mb = model_cls(Config(**NARROW, model=model, compute_dtype="bfloat16"), device="cpu")
        mb.load_state_dict(m8.state_dict())
        calls = _count_int8(monkeypatch, kernel=False)  # a CPU model's default route
        with torch.no_grad():
            out8 = m8.eval()(_t(src), _t(tgt))
            outb = mb.eval()(_t(src), _t(tgt))
        assert len(calls) == 6 * 4, model  # 6 attention sublayers, 4 projections each
        assert all(torch.isfinite(o).all() for o in out8)
        assert not torch.equal(out8[2 if model == "vcrnet" else 0], outb[2 if model == "vcrnet" else 0])
        monkeypatch.undo()


@pytest.mark.parametrize("partial", [False, True])
def test_the_fused_branch_bypasses_int8(monkeypatch, partial):
    """With VCRNET_FUSED_POINTER=1 the fused sublayer takes the bf16 weights,
    as the JAX package's fused branch takes ``params_tuple()``: in whole mode
    no projection is quantized, in partial mode only the re-masked cross
    attention's (two decoder passes, four projections each)."""
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    calls = _count_int8(monkeypatch, kernel=True)
    p = TransformerPointer(128, 1, 1, 128, dtype=torch.bfloat16, flash=True, partial=partial,
                           overlap2=0.75, int8=True).eval()
    x = torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        p(x, x.flip(1))
    assert len(calls) == (8 if partial else 0)


def test_an_int8_bucket_exports_with_the_op(tmp_path):
    """``export_bucket`` of an int8_eval Registrar traces the
    ``vcrnet_torch::int8_linear`` op (on the CPU the kernel route's graph,
    whose ops run their plain versions here), one node a projection, and
    the loaded artifact returns the live Registrar's results bit for bit."""
    from vcrnet_tpu_torch.ops import library
    from vcrnet_tpu_torch.serve import Registrar, load_exported

    torch.manual_seed(0)
    cfg = Config(**NARROW, compute_dtype="bfloat16", int8_eval=True, iter=2)
    reg = Registrar(cfg, VCRNet(cfg, device="cpu").state_dict(), buckets=(2,), device="cpu",
                    use_kernels=True)
    path = str(tmp_path / "bucket2.pt2")
    reg.export_bucket(2, path=path)
    loaded = load_exported(path)
    # the target encoded once (a self-attention), 5 attention sublayers a
    # pass (3 self, 2 cross): a self-attention's projections are 2 nodes
    # (q, k, v together; out), a cross attention's 3 (q; k, v; out)
    assert library.op_counts(loaded.program.graph)["int8_linear"] == (1 + 2 * 3) * 2 + 2 * 2 * 3
    src, tgt = _pair(5, 2)
    live = reg.register(src, tgt)
    out = loaded.register(src, tgt)
    for key in live:
        np.testing.assert_array_equal(out[key], live[key], err_msg=key)
