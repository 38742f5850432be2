"""The port at ``--emb_dims 1024`` against the JAX package. On the card that
width serves on the kernel route: the attention forward and the column
masses at dk = 256 (4 heads), the soft correspondence's forward at E =
1024 (its kernel for E > 512), and with ``VCRNET_FUSED_POINTER=1`` the fused
feed-forward at D = 1024; training at that width needs the backward kernels
at dk = 256 and E = 1024, which are not ported, so their gates refuse it.
Here, on the CPU, the same inputs (seeded numpy) go through the JAX
functions (the Pallas kernels in interpret mode) and the port's plain
versions, which the kernel route's wrappers run on a CPU tensor:

* ``vcrnet_iter`` at emb_dims 1024 (N = 64, B = 2, iter = 3, ff 128) on
  the same flax parameters, carried across by from_jax_params: R and t
  within 1e-4 in f32 and 1e-2 in bf16 (the tolerances of
  test_torch_slice.py);
* the attention at dk = 256 (d 512, 2 heads) against ``_flash_packed_impl``
  and its column masses against ``pallas_colmass.softmax_colmass``; the
  soft correspondence at E = 1024 against
  ``pallas_vcp.streaming_soft_correspondence``; the fused feed-forward at
  D = F = 1024 against ``pallas_pointer.fused_ff``: the tolerances of the
  tile-order tests (f32 1e-5; bf16 attention 2^-8 of max |v| plus one ulp
  of max |o|; masses 2e-5 of the largest; the feed-forward one bf16 ulp of
  its largest output);
* the gates: the forward kernels take dk = 256 and E = 1024, the backward
  kernels refuse both, and on a CUDA tensor (routed as one, the extension
  replaced) a gradient at either raises naming ``flash_bwd_supported`` or
  ``streaming_vjp_supported`` before anything is launched, while the
  forward reaches the extension and counts its wide instance; the CLI's
  kernel route takes ``--emb_dims 1024 --eval`` and refuses a fit with
  those two gates, one message each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.ops import pallas_colmass, pallas_pointer, pallas_vcp
from vcrnet_tpu.ops.pallas_attention import _flash_packed_impl
from vcrnet_tpu_torch import cli, ops
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.ops import _build, attention, colmass, pointer, vcp
from vcrnet_tpu_torch.utils.params import from_jax_params

N = 64
EMB, HEADS = 1024, 4  # dk = 256
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcrnet_iter_matches_jax(dtype):
    """Both routes of the port (plain, and the kernel route's wrappers on the
    CPU) against the JAX model at iter = 3, at emb_dims 1024 and 4 heads."""
    fields = dict(num_points=N, emb_dims=EMB, ff_dims=128, n_heads=HEADS, compute_dtype=dtype)
    jmodel = JVCRNet(cfg=JConfig(**fields))
    cloud = np.zeros((1, N, 3), np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), cloud, cloud)
    weights = from_jax_params(jax.device_get(variables["params"]))
    data = shapes_eval_set(2, num_points=N, cloud_points=2 * N, seed=3)
    src, tgt = data["src"], data["tgt"]
    want = j_vcrnet_iter(None, variables, jnp.asarray(src), jnp.asarray(tgt), 3, model=jmodel)
    for use_kernels in (False, True):
        model = VCRNet(Config(**fields), device="cpu", use_kernels=use_kernels)
        model.load_state_dict(weights)
        with torch.no_grad():
            got = vcrnet_iter(model.eval(), torch.from_numpy(src), torch.from_numpy(tgt), 3)
        for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
            np.testing.assert_allclose(got[i].float().numpy(), np.asarray(want[i]),
                                       atol=TOL[dtype], rtol=0)


def _heads_layout(x, heads):
    """Packed [B, N, H*dk] -> the JAX column-mass layout [B*H, N, dk]."""
    b, n, d = x.shape
    return x.reshape(b, n, heads, d // heads).transpose(0, 2, 1, 3).reshape(b * heads, n, -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_and_masses_at_dk_256_match_pallas(dtype):
    """d 512 at 2 heads (dk = 256): the plain attention against the Pallas
    forward and the plain column masses against the Pallas masses, both in
    interpret mode, at Nq = 128, Nk = 256 (the Pallas kernels take
    multiples of 128)."""
    rng = np.random.RandomState(60)
    d, heads, nq, nk = 512, 2, 128, 256
    q, k, v = (rng.randn(2, n, d).astype(np.float32) for n in (nq, nk, nk))
    scale = 256 ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    got = attention.flash_mha_packed_ref(tq, tk, tv, scale, heads)
    want = np.asarray(_flash_packed_impl(*(jnp.asarray(tt.float().numpy(), jdt)
                                           for tt in (tq, tk, tv)),
                                         scale, heads, interpret=True)).astype(np.float32)
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * (
        tv.float().abs().max().item() + np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)

    masses = colmass.softmax_colmass_ref(tq, tk, scale, heads)
    want = np.asarray(pallas_colmass.softmax_colmass(
        jnp.asarray(_heads_layout(tq.float().numpy(), heads), jdt),
        jnp.asarray(_heads_layout(tk.float().numpy(), heads), jdt), scale,
        interpret=True)).reshape(2, heads, nk)
    np.testing.assert_allclose(masses.numpy(), want, atol=2e-5 * np.abs(want).max(), rtol=0)


def test_soft_correspondence_at_e_1024_matches_pallas():
    """The plain soft correspondence at E = 1024 against the Pallas streaming
    kernel in interpret mode (the JAX package serves that width through it),
    bf16 embeddings, at Ns = 128, Nt = 192."""
    rng = np.random.RandomState(61)
    se = _t(rng.randn(2, 128, 1024) * 0.3, "bfloat16")
    te = _t(rng.randn(2, 192, 1024) * 0.3, "bfloat16")
    tgt = _t(rng.uniform(-1, 1, (2, 192, 3)))
    got = vcp.streaming_soft_correspondence_ref(se, te, tgt)
    want = pallas_vcp.streaming_soft_correspondence(
        jnp.asarray(se.float().numpy(), jnp.bfloat16), jnp.asarray(te.float().numpy(), jnp.bfloat16),
        jnp.asarray(tgt.numpy()), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with torch.no_grad():  # the kernel route's wrapper on a CPU tensor: the plain version
        assert torch.equal(vcp.soft_correspondence_vjp(se, te, tgt), got)


def test_fused_ff_at_d_1024_matches_pallas():
    """The fused feed-forward's plain version at D = F = 1024 against the
    Pallas kernel in interpret mode, within one bf16 ulp of the largest
    output (the two share their rounding points)."""
    rng = np.random.RandomState(62)
    d = f = 1024
    y = rng.randn(1, 256, d).astype(np.float32) * 0.5
    params = (rng.randn(d, f).astype(np.float32) * d ** -0.5,
              rng.randn(f).astype(np.float32) * 0.05,
              rng.randn(f, d).astype(np.float32) * f ** -0.5,
              rng.randn(d).astype(np.float32) * 0.05)
    want = np.asarray(pallas_pointer.fused_ff(jnp.asarray(y), *map(jnp.asarray, params),
                                              interpret=True).astype(jnp.float32))
    got = pointer.fused_ff_ref(_t(y), *map(_t, params)).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 ** -8 * np.abs(want).max(), rtol=0)


def test_the_forward_gates_take_the_width_and_the_backward_gates_refuse_it():
    for n in (64, 768, 885, 1000, 1024, 3072):
        assert attention.flash_packed_supported(n, n, EMB, HEADS)
        assert colmass.colmass_supported(n, n, EMB, HEADS)
        assert vcp.streaming_supported(n, n, EMB)
        assert not attention.flash_bwd_supported(n, n, EMB, HEADS)
        assert not vcp.streaming_vjp_supported(n, n, EMB)


def _fake_card(monkeypatch, calls):
    """Route as a CUDA tensor would, the extension a recorder, the plain
    versions gone (no path may give way to them)."""
    class Ext:
        @staticmethod
        def flash_packed(q, k, v, out, lse, nk_valid, n_heads, sm_scale):
            calls.append(("flash_packed", q.shape[-1] // n_heads))

        @staticmethod
        def softmax_colmass(q, k, lse, out, n_heads, sm_scale):
            calls.append(("softmax_colmass", q.shape[-1] // n_heads))

        @staticmethod
        def vcp_stream(se, te, tgt, keys, out, lse):
            calls.append(("vcp_stream", se.shape[-1]))

        def __getattr__(self, name):
            raise AssertionError(f"a refused shape reached the extension's {name}")

    for module in (attention, colmass, vcp):
        monkeypatch.setattr(module, "kernel_route", lambda *t: True)
    monkeypatch.setattr(_build, "extension", lambda: Ext())
    for module, name in ((attention, "flash_mha_packed_ref"),
                         (attention, "flash_mha_packed_bwd_ref"),
                         (colmass, "softmax_colmass_ref"),
                         (vcp, "streaming_soft_correspondence_ref"), (vcp, "vcp_bwd_ref")):
        monkeypatch.setattr(module, name, None)


def test_on_the_card_the_forward_launches_the_wide_instances(monkeypatch):
    calls = []
    _fake_card(monkeypatch, calls)
    ops.reset_launch_counts()
    t = torch.zeros(2, 100, EMB, dtype=torch.bfloat16)
    xyz = torch.zeros(2, 100, 3)
    with torch.no_grad():
        attention.attention(t, t, t, 256 ** -0.5, HEADS)
        colmass.softmax_colmass(t, t, 256 ** -0.5, HEADS)
        vcp.soft_correspondence_vjp(t, t, xyz)
    assert calls == [("flash_packed", 256), ("softmax_colmass", 256), ("vcp_stream", 1024)]
    assert ops.launch_counts_wide() == {"flash_packed_dk256": 1, "softmax_colmass_dk256": 1,
                                        "vcp_stream_e1024": 1}
    counts = ops.launch_counts()
    assert (counts["flash_packed"], counts["softmax_colmass"], counts["vcp_stream"]) == (1, 1, 1)
    ops.reset_launch_counts()
    assert set(ops.launch_counts_wide().values()) == {0}


@pytest.mark.parametrize("kernel", ["attention", "flash_bwd", "soft_correspondence", "vcp_bwd"])
def test_on_the_card_a_gradient_at_the_width_raises(monkeypatch, kernel):
    """Under a gradient the attention at dk = 256 and the soft
    correspondence at E = 1024 raise with the backward's gate named, before
    the forward runs; the backward wrappers raise likewise."""
    calls = []
    _fake_card(monkeypatch, calls)
    t = torch.zeros(1, 100, EMB, dtype=torch.bfloat16)
    xyz, lse = torch.zeros(1, 100, 3), torch.zeros(1, HEADS, 100)
    with pytest.raises(ValueError, match="flash_bwd_supported: dk in \\(64, 128\\)"
                       if kernel in ("attention", "flash_bwd")
                       else "streaming_vjp_supported: E % 16 == 0, E <= 512"):
        if kernel == "attention":
            attention.attention(t.clone().requires_grad_(), t, t, 256 ** -0.5, HEADS)
        elif kernel == "flash_bwd":
            attention.flash_bwd(t, t, t, t, lse, t, 256 ** -0.5, HEADS)
        elif kernel == "soft_correspondence":
            vcp.soft_correspondence_vjp(t.clone().requires_grad_(), t, xyz)
        else:
            vcp.vcp_bwd(t, t, xyz, xyz, lse[:, 0], xyz)
    assert calls == []


def test_the_cli_serves_the_width_and_refuses_a_fit_with_two_gates():
    width = dict(compute_dtype="bfloat16", emb_dims=EMB)
    for kw in (dict(eval=True), dict(eval=True, iter=3),
               dict(eval=True, partial=True, overlap=0.575), dict(eval=True, num_points=1000)):
        assert cli.kernel_route_refusals(Config(**width, **kw)) == [], kw
    refused = cli.kernel_route_refusals(Config(**width))
    assert len(refused) == 2, refused
    assert refused[0].startswith("ops/attention.py::flash_bwd_supported")
    assert "dk = 64 or 128 in training (got emb_dims / n_heads = 1024 / 4)" in refused[0]
    assert refused[1].startswith("ops/vcp.py::streaming_vjp_supported")
    assert "emb_dims <= 512 in training (got 1024)" in refused[1]
    # a fit that trains the soft correspondence on its plain route needs only
    # the attention's backward
    assert len(cli.kernel_route_refusals(Config(**width, streaming_vcp_train=False))) == 1
