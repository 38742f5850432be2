"""The fused pointer sublayers of the port (ops/pointer.py and their two
branches in models/transformer.py) against the JAX package's Pallas kernels
in interpret mode, on the CPU, where the port runs its plain versions.

Tolerances: the plain versions share the Pallas kernels' rounding points
(q, k, v, exp(s - m), the per-head outputs, the hidden tile and the result
rounded to bf16; f32 sums), so they agree within ONE bf16 ulp of the
output's largest value (2^-8 relative), where the JAX package's own tests
allow 0.12 / 0.15 absolute against f32 math. The wired module against the
unfused module on the same parameters: 2^-6 of the largest value (bf16
roundings at other places), as in the JAX package's wiring test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vcrnet_tpu.ops.pallas_pointer as pp
from vcrnet_tpu_torch.models import transformer
from vcrnet_tpu_torch.models.transformer import TransformerPointer
from vcrnet_tpu_torch.ops import pointer

ONE_BF16_ULP = 2.0 ** -8


def _rand(rng, *shape, scale=0.5):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


def _mha_inputs(nq, nk, d, seed=0):
    rng = np.random.RandomState(seed)
    yq = _rand(rng, 2, nq, d)
    ykv = yq if nq == nk else _rand(rng, 2, nk, d)
    weights = []
    for _ in range(4):
        weights += [_rand(rng, d, d, scale=0.15), _rand(rng, d, scale=0.05)]
    return yq, ykv, weights


@pytest.mark.parametrize("nq,nk,heads,d", [(256, 256, 2, 256), (256, 128, 1, 128)])
def test_fused_mha_ref_matches_pallas_kernel(nq, nk, heads, d):
    yq, ykv, weights = _mha_inputs(nq, nk, d)
    want = pp.fused_mha(jnp.asarray(yq), jnp.asarray(ykv), *(jnp.asarray(w) for w in weights),
                        n_heads=heads, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tyq = _t(yq)
    got = pointer.fused_mha_ref(tyq, tyq if nq == nk else _t(ykv), *map(_t, weights), heads)
    assert got.shape == (2, nq, d) and got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= ONE_BF16_ULP
    # the wrapper on CPU tensors is the plain version (no gradient recorded)
    with torch.no_grad():
        again = pointer.fused_mha(tyq, tyq if nq == nk else _t(ykv), *map(_t, weights), heads)
    assert torch.equal(again, got)


def test_fused_ff_ref_matches_pallas_kernel():
    rng = np.random.RandomState(1)
    d, f = 128, 256
    y = _rand(rng, 2, 256, d)
    params = (_rand(rng, d, f, scale=0.15), _rand(rng, f, scale=0.05),
              _rand(rng, f, d, scale=0.15), _rand(rng, d, scale=0.05))
    want = pp.fused_ff(jnp.asarray(y), *(jnp.asarray(p) for p in params), interpret=True)
    got = pointer.fused_ff_ref(_t(y), *map(_t, params))
    assert got.shape == (2, 256, d) and got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= ONE_BF16_ULP
    with torch.no_grad():
        assert torch.equal(pointer.fused_ff(_t(y), *map(_t, params)), got)


MHA_SHAPES = [(1024, 1024, 512, 4), (768, 768, 512, 4), (1000, 1024, 512, 4),
              (1024, 1024, 512, 8), (8192, 8192, 512, 4), (256, 256, 128, 1),
              (256, 128, 256, 2), (1024, 1024, 384, 3)]
FF_SHAPES = [(1024, 512, 1024), (1000, 512, 1024), (8192, 512, 4096), (256, 128, 256),
             (768, 512, 1024), (768, 1024, 1024), (1024, 1024, 1024), (3072, 1024, 1024),
             (1024, 1024, 4096), (768, 1024, 2048)]


@pytest.mark.parametrize("flag", ["1", "0", None])
def test_gates_match_jax(monkeypatch, flag):
    """The port's gates are the variable and its kernels' own limits: off
    with the JAX gates when the variable is unset, and on wherever JAX's are
    (at the dk = 128, D <= 512 the CUDA attention takes). They are wider
    only where the JAX gate models its own chip: the on-chip budget for K
    and V (8192 keys), the VMEM budget of the feed-forward's weights (F =
    4096) and lengths in 128s."""
    if flag is None:
        monkeypatch.delenv("VCRNET_FUSED_POINTER", raising=False)
    else:
        monkeypatch.setenv("VCRNET_FUSED_POINTER", flag)
    on = flag == "1"
    for shape in MHA_SHAPES:
        ours, theirs = pointer.fused_mha_supported(*shape), pp.fused_mha_supported(*shape)
        assert ours is (on and ours) and (ours or not theirs), shape
    for shape in FF_SHAPES:
        ours, theirs = pointer.fused_ff_supported(*shape), pp.fused_ff_supported(*shape)
        assert ours is (on and ours) and (ours or not theirs), shape
    assert pointer.fused_mha_supported(1024, 1024, 512, 4) is on
    assert pointer.fused_mha_supported(768, 768, 512, 4) is on
    assert pointer.fused_ff_supported(1024, 512, 1024) is on
    assert not pointer.fused_mha_supported(1024, 1024, 512, 8)  # dk = 64
    # ragged lengths: the last query tile stores its real rows alone, the
    # last key tile masks the next item's keys (ROADMAP C1)
    assert pointer.fused_mha_supported(1000, 1024, 512, 4) is on
    assert pointer.fused_mha_supported(1024, 1000, 512, 4) is on
    assert pointer.fused_mha_supported(885, 885, 512, 4) is on
    # K and V live in device memory, so the JAX package's budget does not bind
    assert not pp.fused_mha_supported(8192, 8192, 512, 4)
    assert pointer.fused_mha_supported(8192, 8192, 512, 4) is on
    # the feed-forward kernel masks a ragged last tile of rows
    assert not pp.fused_ff_supported(1000, 512, 1024)
    assert pointer.fused_ff_supported(1000, 512, 1024) is on
    # the feed-forward's kernels keep no width in shared memory: F = 4096 is
    # held on the card, where JAX's weights outgrow its VMEM budget
    assert not pp.fused_ff_supported(8192, 512, 4096)
    assert pointer.fused_ff_supported(8192, 512, 4096) is on
    assert not pointer.fused_ff_supported(8192, 512, 8192)  # past the widths held on the card
    # --emb_dims 1024: the JAX package runs its feed-forward kernel at D = F =
    # 1024 for the clouds it serves (768, 1024 and 3072 points), and so does
    # the port; the fused attention stays refused by both at D = 1024
    for n in (768, 1024, 3072):
        assert pp.fused_ff_supported(n, 1024, 1024) is on
        assert pointer.fused_ff_supported(n, 1024, 1024) is on
        assert not pp.fused_mha_supported(n, n, 1024, 4)
        assert not pointer.fused_mha_supported(n, n, 1024, 4)


def test_the_cuda_kernels_own_limits_narrow_the_gate(monkeypatch):
    """dk must be exactly 128 and D at most 512 for csrc/pointer_mha.cu,
    where the JAX gate asks only for dk % 128 == 0."""
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    assert pp.fused_mha_supported(256, 256, 512, 2)  # dk = 256
    assert not pointer.fused_mha_supported(256, 256, 512, 2)
    assert pointer.pointer_mha_smem_bytes(512) == 214064
    # the feed-forward runs the product twice, whose shared memory depends
    # on no width; the gate stops at the widths held on the card
    assert pointer.pointer_ff_smem_bytes(512, 1024) == 214064 <= pointer.SMEM_LIMIT
    assert pointer.pointer_ff_smem_bytes(512, 4096) == pointer.pointer_ff_smem_bytes(128, 256)
    assert pointer.fused_ff_supported(1024, 512, 2048)
    assert not pointer.fused_ff_supported(1024, 512, 8192)  # F > 4096
    assert pointer.fused_ff_supported(1024, 1024, 1024)  # D = 1024 (--emb_dims 1024)
    assert not pointer.fused_ff_supported(1024, 1152, 1024)  # D > 1024
    assert not pointer.fused_mha_supported(1024, 1024, 640, 5)  # the attention: D > 512


def test_fused_wrappers_refuse_a_gradient():
    yq, _, weights = _mha_inputs(128, 128, 128)
    w = [_t(v) for v in weights]
    w[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        pointer.fused_mha(_t(yq), _t(yq), *w, 1)
    with pytest.raises(RuntimeError, match="no backward"):
        pointer.fused_ff(_t(yq).requires_grad_(), w[2], w[1], w[4], w[3])
    with torch.no_grad():  # the same call without a recorded gradient runs
        pointer.fused_mha(_t(yq), _t(yq), *w, 1)


# ---------------------------------------------------------------------------
# the two branches in models/transformer.py
# ---------------------------------------------------------------------------

def _pointer(partial, flash, seed=0, n_heads=1):
    torch.manual_seed(seed)
    model = TransformerPointer(128, 1, n_heads, 256, dtype=torch.bfloat16, flash=flash,
                               partial=partial, overlap2=0.75)
    return model.eval()


def _count_calls(monkeypatch):
    calls = {"mha": 0, "ff": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(transformer, "fused_mha", counting("mha", pointer.fused_mha))
    monkeypatch.setattr(transformer, "fused_ff", counting("ff", pointer.fused_ff))
    return calls


@pytest.mark.parametrize("partial", [False, True])
def test_fused_pointer_matches_unfused_module(monkeypatch, partial):
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    calls = _count_calls(monkeypatch)
    fused = _pointer(partial, flash=True)
    plain = _pointer(partial, flash=False)
    plain.load_state_dict(fused.state_dict())
    rng = np.random.RandomState(2)
    src, tgt = _t(_rand(rng, 2, 128, 128, scale=1.0)), _t(_rand(rng, 2, 128, 128, scale=1.0))
    with torch.no_grad():
        got = fused(src, tgt)
        want = plain(src, tgt)
    # two encoder passes (1 attention, 1 ff each) and two decoder passes (self
    # attention, cross attention, ff): the re-masked cross attention of
    # partial mode does not take the fused branch
    assert calls == {"mha": 4 if partial else 6, "ff": 4}
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), w.float().numpy()) <= 2.0 ** -6


@pytest.mark.parametrize("why", ["unset", "zero", "training", "gradient", "plain_route", "shape"])
def test_fused_branches_are_not_taken(monkeypatch, why):
    if why == "unset":
        monkeypatch.delenv("VCRNET_FUSED_POINTER", raising=False)
    else:
        monkeypatch.setenv("VCRNET_FUSED_POINTER", "0" if why == "zero" else "1")
    calls = _count_calls(monkeypatch)
    # two heads of 64 columns: the attention kernel takes dk = 128 alone (any
    # number of rows since the ragged tiles of ROADMAP C1)
    model = _pointer(False, flash=why != "plain_route", n_heads=2 if why == "shape" else 1)
    x = torch.randn(1, 128, 128, generator=torch.Generator().manual_seed(3))
    if why == "training":
        model.train()
    if why in ("training", "gradient"):
        out = model(x, x)  # a gradient is recorded: the kernels have no backward
        assert out[0].requires_grad
    else:
        with torch.no_grad():
            model(x, x)
    # the feed-forward kernel takes any number of rows, so it stays fused
    assert calls == {"mha": 0, "ff": 4 if why == "shape" else 0}


def test_cross_attention_with_distinct_key_and_value_is_not_fused(monkeypatch):
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    calls = _count_calls(monkeypatch)
    mha = transformer.MultiHeadAttention(128, 1, dtype=torch.bfloat16, flash=True).eval()
    x = torch.randn(1, 128, 128, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        mha(x, x, x.clone())
        assert calls["mha"] == 0
        mha(x, x, x)
    assert calls["mha"] == 1
