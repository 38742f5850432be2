"""The dist and att heads of the port (models/heads.py: ``vcp_by_dis``,
``VcpAtt``) and VCR-Net with them, against the JAX package on the CPU.

Same seeded numpy inputs and the same flax parameters (bridged by
``from_jax_params``). Tolerances: the heads in f32 1e-5 (f32 sums in
another order); ``vcp_by_dis`` in bf16 2e-2 of the points' range, the
scores and softmax rounded to bf16 in both packages (one bf16 ulp of a
softmax weight, 2^-8, moves a correspondence by at most that share of the
range), and the scale sqrt(d) rounded to bf16 alike (22.625 for d = 512,
checked exactly); ``VcpAtt`` 1e-5 in bf16 too (both promote to f32 before
anything is computed); ``att`` at its identity init against the topK head
bit for bit in f32. VCR-Net with either head, whole, partial and cycle:
``vcrnet_iter`` at iter=3 within 1e-4 of the JAX package's (the transforms
of three composed passes), the training step's loss and sums rtol 1e-4,
its gradients 1e-3 of each parameter's largest, floored at 1e-3 of the
model's largest (the training step tests' rule). Narrow widths, one torch
thread."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import heads as jheads
from vcrnet_tpu.models.vcrnet import vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.models.heads import VcpAtt, vcp_by_dis, vcp_top_k_whole
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=64, ff_dims=128, n_heads=2, batch_size=3,
              test_batch_size=3)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _head_inputs(seed, e, b=2, n=24):
    rng = np.random.RandomState(seed)
    emb = [(rng.randn(b, n, e) / np.sqrt(e) * 4).astype(np.float32) for _ in range(2)]
    pts = [rng.rand(b, n, 3).astype(np.float32) for _ in range(2)]
    return emb + pts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcp_by_dis_matches_jax(dtype):
    e = 512 if dtype == "bfloat16" else 32  # sqrt(512) is 22.625 in bf16
    se, te, src, tgt = _head_inputs(1, e)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = jheads.vcp_by_dis(jnp.asarray(se, jd), jnp.asarray(te, jd), jnp.asarray(src),
                             jnp.asarray(tgt))
    got = vcp_by_dis(_t(se).to(td), _t(te).to(td), _t(src), _t(tgt))
    assert got[1].dtype == torch.float32 and np.asarray(want[1]).dtype == np.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    atol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=atol, rtol=0)
    # the scale is sqrt(d) rounded to the embeddings' dtype in both: 22.625 in bf16
    scale = torch.full((), float(e), dtype=td).sqrt()
    assert scale.item() == float(jnp.sqrt(jnp.asarray(e, jd)))
    assert (scale.item() == 22.625) == (dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vcp_att_matches_jax(dtype):
    """Projections away from the identity: f32 from the embeddings on, in
    both packages (flax's Dense without a dtype promotes bf16 inputs)."""
    se, te, src, tgt = _head_inputs(2, 32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jhead = jheads.VcpAtt(emb_dims=32)
    args = [jnp.asarray(se, jd), jnp.asarray(te, jd), jnp.asarray(src), jnp.asarray(tgt)]
    params = jhead.init(jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)),
        params)
    head = VcpAtt(32)
    head.load_state_dict(from_jax_params(jax.device_get(params)))
    want = jhead.apply({"params": params}, *args)
    got = head(_t(se).to(td), _t(te).to(td), _t(src), _t(tgt))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), atol=1e-5, rtol=0)


def test_att_at_its_identity_init_is_the_top_k_head_bit_for_bit():
    se, te, src, tgt = _head_inputs(4, 32)
    head = VcpAtt(32)
    assert torch.equal(head.linear_emb_q.weight, torch.eye(32))
    assert not head.linear_emb_k.bias.any()
    got = head(_t(se), _t(te), _t(src), _t(tgt))[1]
    want = vcp_top_k_whole(_t(se), _t(te), _t(src), _t(tgt))[1]
    assert torch.equal(got, want)
    jparams = jheads.VcpAtt(emb_dims=32).init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in (se, te, src, tgt)))["params"]
    for name, val in from_jax_params(jax.device_get(jparams)).items():
        assert torch.equal(head.state_dict()[name], val), name


# whole and partial, cycle or not, for each head (att whole is the topK
# head at its identity init, held above)
VARIANTS = {
    "dist_cycle_pose": dict(vcp_nn="dist", cycle=True, loss="pose"),
    "dist_partial": dict(vcp_nn="dist", partial=True, overlap=0.575),
    "att_partial_cycle": dict(vcp_nn="att", partial=True, overlap=0.575, cycle=True),
}


def _batch(cfg, seed=7, n_items=3):
    np.random.seed(seed)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(cfg, "train", n_items=n_items, cloud_points=128,
                                                kind="uniform"), n_items)))
    batch.pop("label")
    return batch


def _perturbed(params, seed):
    """``vcp_att``'s projections away from their identity init, so its
    gradients and outputs are not the topK head's; every other leaf as
    initialised."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        if "vcp_att" not in jax.tree_util.keystr(path):
            return a
        return jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32))

    return jax.tree_util.tree_map_with_path(leaf, params)


class _Jax:
    """The JAX package's model of one variant on one seeded batch: its
    parameters, and (each computed once, jitted) its iter=3 eval and its
    training step's loss, sums and gradients."""

    def __init__(self, kw):
        self.kw = kw
        self.jtr = JTrainer(JConfig(**NARROW, **kw), mesh=make_mesh(1))
        self.batch = _batch(self.jtr.cfg)
        src, tgt = jnp.asarray(self.batch["src"]), jnp.asarray(self.batch["tgt"])
        self.params = _perturbed(jax.jit(self.jtr.model.init)(
            jax.random.PRNGKey(0), src[:1], tgt[:1])["params"], 5)
        self._iterated = self._step = None

    def iterated(self):
        if self._iterated is None:
            model = self.jtr.model
            it = jax.jit(lambda v, s, t: j_vcrnet_iter(None, v, s, t, 3, model=model))
            self._iterated = it({"params": self.params}, jnp.asarray(self.batch["src"]),
                                jnp.asarray(self.batch["tgt"]))
        return self._iterated

    def step(self):
        if self._step is None:
            jtr = self.jtr

            def loss_fn(p, jb):
                out, _ = jtr._apply({"params": p}, jb["src"], jb["tgt"], train=True)
                return jtr._vcrnet_loss_and_sums(out, jb, jb["valid"])

            jb = {k: jnp.asarray(v) for k, v in self.batch.items()}
            self._step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(self.params, jb)
        return self._step


@pytest.fixture(scope="module")
def jax_models():
    return {name: _Jax(kw) for name, kw in VARIANTS.items()}


def _port(kw, params):
    tr = Trainer(Config(**NARROW, **kw), device="cpu")
    tr.model.load_state_dict(from_jax_params(jax.device_get(params)))
    return tr


@pytest.mark.parametrize("name", ["dist_cycle_pose", "att_partial_cycle"])
def test_vcrnet_iter_with_the_head_matches_jax(jax_models, name):
    jm = jax_models[name]
    want = jm.iterated()
    tr = _port(jm.kw, jm.params)
    tr.model.eval()
    with torch.no_grad():
        got = vcrnet_iter(tr.model, _t(jm.batch["src"]), _t(jm.batch["tgt"]), 3)
    for i in (2, 3, 4, 5):  # R_ab, t_ab, R_ba, t_ba
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=1e-4, rtol=0)
    if not jm.kw.get("partial"):
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_training_step_with_the_head_matches_jax(jax_models, name):
    """The head takes the whole clouds in partial mode too (the pointer
    still re-masks), so every parameter gets a real gradient."""
    jm = jax_models[name]
    (j_loss, j_sums), j_grads = jm.step()
    tr = _port(jm.kw, jm.params)
    loss, sums = tr.compute_grads(jm.batch)
    assert tr.grads_filled == []
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    assert set(sums) == set(j_sums)
    for key in j_sums:
        np.testing.assert_allclose(float(sums[key]), float(j_sums[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = from_jax_params(jax.device_get(j_grads))
    params_t = dict(tr.model.named_parameters())
    assert set(params_t) == set(want)
    assert ("vcp_att.linear_emb_q.weight" in want) == (jm.kw["vcp_nn"] == "att")
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for pname, p in params_t.items():
        w = want[pname].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=pname)


def test_the_heads_never_take_the_streaming_kernels(monkeypatch):
    """dist and att are plain PyTorch on the kernel route too: on CPU
    tensors the route's wrappers would run, so a call to them shows."""
    from vcrnet_tpu_torch.models import heads

    def refuse(*args, **kw):
        raise AssertionError("the streaming head was called")

    monkeypatch.setattr(heads, "soft_correspondence_vjp", refuse)
    rng = np.random.RandomState(9)
    src, tgt = (_t(rng.rand(2, 64, 3).astype(np.float32)) for _ in range(2))
    for vcp_nn in ("dist", "att"):
        model = VCRNet(Config(**NARROW, vcp_nn=vcp_nn, compute_dtype="bfloat16"), device="cpu",
                       use_kernels=True)
        assert hasattr(model, "vcp_att") == (vcp_nn == "att")
        model.eval()
        with torch.no_grad():
            out = vcrnet_iter(model, src, tgt, 2)
        assert torch.isfinite(out[2]).all()
        model.train()
        model(src, tgt)[1].sum().backward()
    with pytest.raises(AssertionError, match="streaming head"):
        VCRNet(Config(**NARROW, compute_dtype="bfloat16"), device="cpu", use_kernels=True)(src, tgt)
