"""Cloud sizes that are no multiple of 64 (ROADMAP C1, C1b) at the port's gates.

The JAX package serves and trains at every cloud size: its Pallas kernels
where their gates take the shape, XLA elsewhere. On the card the port has
no plain fallback, so each kernel of the served and trained paths takes a
ragged last tile: its gate must take every size the partial protocol crops
to (``Config(partial=True, overlap=o).n_cropped``, 707 to 971 points for
the overlaps users pick) and whole clouds of 1000 points, forward and
backward. What stays refused (k >= N, E > 512, dk != 128, the winners'
scatter past N = 7264) raises on a CUDA tensor, never running the plain
formulation in the kernels' place; the training step at a ragged size
matches the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset
from vcrnet_tpu_torch.ops import attention, colmass, dgcnn, edgeconv, pointer, vcp
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

OVERLAPS = (0.5, 0.6, 0.7, 0.75, 0.8, 0.9)
RAGGED = [Config(partial=True, overlap=o).n_cropped for o in OVERLAPS] + [1000]
K, D, H = 20, 512, 4


def test_the_cropped_sizes_are_ragged():
    assert RAGGED == [707, 787, 854, 885, 915, 971, 1000]
    assert all(n % 16 for n in RAGGED[:-1]) and RAGGED[-1] % 64


@pytest.mark.parametrize("n", RAGGED)
def test_every_forward_gate_takes_the_size(monkeypatch, n):
    monkeypatch.setenv("VCRNET_FUSED_POINTER", "1")
    assert edgeconv.edge_conv_supported(n, 64, K)
    assert edgeconv.edge_conv_from_idx_supported(n, K)
    assert edgeconv.knn_gather_max_supported(n, 256, K)
    assert edgeconv.gather_max_from_idx_supported(n, 256, K)
    assert attention.flash_packed_supported(n, n, D, H)
    assert colmass.colmass_supported(n, n, D, H)
    assert vcp.streaming_supported(n, n, D)
    assert dgcnn.fused_dgcnn_supported(n, K, D)
    assert pointer.fused_mha_supported(n, n, D, H)
    assert pointer.fused_ff_supported(n, D, 1024)


@pytest.mark.parametrize("n", RAGGED)
def test_the_backward_gates_refuse_the_size(n):
    """Every backward gate takes the size (C1b, repaired); at the same size
    each still refuses the shapes its kernel does not take."""
    assert edgeconv.edge_conv_bwd_supported(n, K)
    assert attention.flash_bwd_supported(n, n, D, H)
    assert attention.flash_bwd_supported(n, 1024, D, H) and attention.flash_bwd_supported(1024, n, D, H)
    assert vcp.streaming_vjp_supported(n, n, D) and vcp.streaming_vjp_supported(n, 1024, D)
    # the winners' scatter keeps a cloud's slice in shared memory: any N to 7264
    assert edgeconv.gather_max_bwd_supported(n, 256, K)
    assert not edgeconv.edge_conv_bwd_supported(n, 33)  # k > 32
    assert not edgeconv.edge_conv_bwd_supported(K, K)  # k >= N
    assert not attention.flash_bwd_supported(n, n, 256, H)  # dk = 64
    assert not vcp.streaming_vjp_supported(n, n, 528)  # E > 512
    assert not edgeconv.gather_max_bwd_supported(7300, 256, K)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so the wrappers take the
    kernel route (and must raise before launching anything)."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("kernel", ["edge_conv_bwd", "flash_bwd", "vcp_bwd"])
def test_a_cuda_call_at_a_refused_backward_shape_raises(monkeypatch, kernel):
    """At N = 1000, which every backward kernel takes, a shape that stays
    refused (k = 33, dk = 64, E = 528) raises before the extension is
    built, and nothing runs the plain version in the kernel's place."""
    from vcrnet_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("a refused shape reached the extension")

    monkeypatch.setattr(_build, "extension", no_build)
    n, f32 = 1000, torch.float32
    with pytest.raises(ValueError, match="does not take|k in"):
        if kernel == "edge_conv_bwd":
            t, win = _fake(1, n, 128), _fake(1, n, 128, dtype=torch.uint8)
            edgeconv.edge_conv_bwd(_fake(1, n, 33, dtype=torch.int32), win, win, t, t,
                                   _fake(128, 128), t, t, t)
        elif kernel == "flash_bwd":
            t = _fake(1, n, 256)
            attention.flash_bwd(t, t, t, t, _fake(1, H, n, dtype=f32), t, 0.1, H)
        else:
            e, xyz = _fake(1, n, 528), _fake(1, n, 3, dtype=f32)
            vcp.vcp_bwd(e, e, xyz, xyz, _fake(1, n, dtype=f32), xyz)


def test_the_soft_correspondence_refuses_a_gradient_at_the_size():
    """soft_correspondence_vjp checks its backward's gate before the
    forward, on any device: a ragged cloud under a gradient runs now, and
    a width the backward kernels refuse (E > 512) raises."""
    rng = np.random.RandomState(0)
    e = torch.from_numpy(rng.randn(1, 1000, 64).astype(np.float32)).requires_grad_()
    xyz = torch.from_numpy(rng.randn(1, 1000, 3).astype(np.float32))
    out = vcp.soft_correspondence_vjp(e, e, xyz)
    assert out.shape == (1, 1000, 3)
    out.sum().backward()
    assert e.grad.shape == e.shape and torch.isfinite(e.grad).all()
    wide = torch.from_numpy(rng.randn(1, 1000, 528).astype(np.float32)).requires_grad_()
    with pytest.raises(ValueError, match="does not take Ns=1000 Nt=1000 E=528"):
        vcp.soft_correspondence_vjp(wide, wide, xyz)
    with torch.no_grad():  # the same call without a gradient runs
        assert vcp.soft_correspondence_vjp(wide, wide, xyz).shape == (1, 1000, 3)


def test_the_training_step_at_a_ragged_size_raises_from_a_backward_gate():
    """The kernel route's training step runs at N = 1000 (every backward
    gate takes it) and raises from soft_correspondence_vjp's gate where the
    embedding is wider than its backward kernels take (E = 528)."""
    cfg = Config(num_points=1000, emb_dims=64, ff_dims=128, n_heads=2)
    trainer = Trainer(cfg, seed=0, device="cpu", use_kernels=True)
    assert trainer.model.use_kernels
    ds = SyntheticDataset(cfg, "train", n_items=2, cloud_points=2000, seed=1, kind="shapes")
    sums = trainer.train_step(next(iter(Loader(ds, 2))))
    assert np.isfinite(float(sums["loss"])) and trainer.step == 1
    cfg = Config(num_points=100, emb_dims=528, ff_dims=128, n_heads=4)
    trainer = Trainer(cfg, seed=0, device="cpu", use_kernels=True)
    ds = SyntheticDataset(cfg, "train", n_items=2, cloud_points=200, seed=1, kind="shapes")
    with pytest.raises(ValueError, match="soft_correspondence_vjp does not take"):
        trainer.train_step(next(iter(Loader(ds, 2))))


NARROW = dict(emb_dims=256, ff_dims=128, n_heads=2)


@pytest.mark.parametrize("n", [200, 75])
def test_the_kernel_routes_training_step_at_a_ragged_size_matches_jax(n):
    """A use_kernels=True training step at N = 200 and 75 (B = 3: the edge
    conv's last round of four queries is ragged) against the JAX Trainer's
    on the same parameters (from_jax_params) and batch: loss and sums rtol
    1e-4, gradients 1e-3 of each parameter's largest gradient (floored at
    1e-3 of the model's largest), the tolerances of
    test_torch_train_step.py at N = 64. On the CPU the kernel route's
    autograd Functions run their plain backward versions; the card holds
    the kernels to them (chip_smoke.py)."""
    kw = dict(NARROW, num_points=n)
    jcfg = JConfig(**kw)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    np.random.seed(8)  # train items draw from the global generator
    batch = next(iter(JLoader(JSyntheticDataset(jcfg, "train", n_items=3, cloud_points=2 * n,
                                                kind="shapes"), 3)))
    batch.pop("label")
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    tr = Trainer(Config(**kw), device="cpu", use_kernels=True)
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jtr._apply({"params": params}, jb["src"], jb["tgt"], train=True)
        return jtr._vcrnet_loss_and_sums(out, jb, jb["valid"])

    (j_loss, j_sums), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    got_loss, sums = tr.compute_grads(batch)
    assert batch["src"].shape == (3, n, 3)
    np.testing.assert_allclose(float(got_loss), float(j_loss), rtol=1e-4)
    for key in j_sums:
        np.testing.assert_allclose(float(sums[key]), float(j_sums[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)
