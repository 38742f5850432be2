"""Cloud sizes that are no multiple of 64 (ROADMAP C1) at the port's gates.

The JAX package serves every cloud size: its Pallas kernels where their
gates take the shape, XLA elsewhere. On the card the port has no plain
fallback, so each forward kernel of the served paths takes a ragged last
tile: its gate must take every size the partial protocol crops to
(``Config(partial=True, overlap=o).n_cropped``, 707 to 971 points for the
overlaps users pick) and whole clouds of 1000 points. The gradient half is
not done (C1b, with partial training): the backward gates still refuse
those sizes, and a call there raises on a CUDA tensor and in the training
step, never running the plain formulation in the kernels' place.
"""

import numpy as np
import pytest
import torch

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset
from vcrnet_tpu_torch.ops import attention, colmass, dgcnn, edgeconv, pointer, vcp
from vcrnet_tpu_torch.train import Trainer

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
    assert not edgeconv.edge_conv_bwd_supported(n, K)
    assert not attention.flash_bwd_supported(n, n, D, H)
    assert not vcp.streaming_vjp_supported(n, n, D)
    # the winners' scatter keeps a cloud's slice in shared memory: any N to 7264
    assert edgeconv.gather_max_bwd_supported(n, 256, K)


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
    from vcrnet_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("a refused shape reached the extension")

    monkeypatch.setattr(_build, "extension", no_build)
    n, f32 = 1000, torch.float32
    with pytest.raises(ValueError, match="does not take|N % 16"):
        if kernel == "edge_conv_bwd":
            t, win = _fake(1, n, 128), _fake(1, n, 128, dtype=torch.uint8)
            edgeconv.edge_conv_bwd(_fake(1, n, K, dtype=torch.int32), win, win, t, t,
                                   _fake(128, 128), t, t, t)
        elif kernel == "flash_bwd":
            t = _fake(1, n, D)
            attention.flash_bwd(t, t, t, t, _fake(1, H, n, dtype=f32), t, 0.1, H)
        else:
            e, xyz = _fake(1, n, D), _fake(1, n, 3, dtype=f32)
            vcp.vcp_bwd(e, e, xyz, xyz, _fake(1, n, dtype=f32), xyz)


def test_the_soft_correspondence_refuses_a_gradient_at_the_size():
    """soft_correspondence_vjp checks its backward's gate before the
    forward, on any device: a ragged cloud under a gradient raises."""
    rng = np.random.RandomState(0)
    e = torch.from_numpy(rng.randn(1, 1000, 64).astype(np.float32)).requires_grad_()
    xyz = torch.from_numpy(rng.randn(1, 1000, 3).astype(np.float32))
    with pytest.raises(ValueError, match="does not take Ns=1000"):
        vcp.soft_correspondence_vjp(e, e, xyz)
    with torch.no_grad():  # the same call without a gradient runs
        assert vcp.soft_correspondence_vjp(e, e, xyz).shape == (1, 1000, 3)


def test_the_training_step_at_a_ragged_size_raises_from_a_backward_gate():
    cfg = Config(num_points=1000, emb_dims=64, ff_dims=128, n_heads=2)
    trainer = Trainer(cfg, seed=0, device="cpu", use_kernels=True)
    assert trainer.model.use_kernels
    ds = SyntheticDataset(cfg, "train", n_items=2, cloud_points=2000, seed=1, kind="shapes")
    with pytest.raises(ValueError, match="soft_correspondence_vjp does not take"):
        trainer.train_step(next(iter(Loader(ds, 2))))
