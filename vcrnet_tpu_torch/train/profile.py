"""Where the time of one training step, or of one served request, goes on
the card.

    python3 -m vcrnet_tpu_torch.train.profile [--batch 64 8] [--top 25] [--model dcp]
    python3 -m vcrnet_tpu_torch.train.profile --serve iter3 partial partial3072 dgcnn

Builds a full-width bf16 Trainer (``Config`` defaults, N = 1024; with
``--model dcp`` DCP on the DGCNN embedding) from a
seeded init on synthetic shape pairs and takes two warm-up steps. Then it
times 5 steps on the host clock (each ending in a synchronise; median),
traces 3 more with ``torch.profiler`` (CPU and CUDA activities), and
prints: the step's wall time, the device time per step summed over every
CUDA kernel of the trace, the device's idle share (1 - device / wall,
against the untraced wall time: tracing slows the host), and the device
time per kernel, largest first. The first line is the card's
``nvidia-smi`` name and power limit. Needs a CUDA device.

``--serve`` does the same for one ``Registrar.register`` request of
``--batch`` pairs with the committed checkpoint, in place of the training
step: ``iter3`` (whole clouds of 1024 points, three refinement passes),
``partial`` (overlap 0.575, 1024 -> 768 points, iter=3) and ``partial3072``
(4093 -> 3072 points, where the re-mask streams; at most 8 pairs).
``dgcnn`` serves VCR-Net on the DGCNN embedding at iter=3; the repository
holds no DGCNN weights, so they are a seeded init after a few DCP training
steps (which move the BatchNorm statistics off their initial values). With
``VCRNET_FUSED_POINTER=1`` in the environment the served requests run the
fused pointer sublayers.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset, shapes_eval_set
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train.engine import Trainer
from vcrnet_tpu_torch.utils.params import load_checkpoint

CHECKPOINT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints", "pretrained", "vcrnet_shapes_best.msgpack")
SERVE_CONFIGS = {  # name: (Config fields, largest request)
    "iter3": (dict(num_points=1024), 64),
    "partial": (dict(num_points=1024, partial=True, overlap=0.575), 64),
    "partial3072": (dict(num_points=4093, partial=True, overlap=0.575), 8),
    "dgcnn": (dict(num_points=1024, emb_nn="dgcnn"), 64),
}
DGCNN_WARM_STEPS = 5


def _is_kernel(event) -> bool:
    """A device kernel or copy, not a user annotation spanning kernels (such
    as the optimizer's step range, which would count them twice)."""
    return (getattr(event, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.key.startswith("Optimizer."))


def _device_us(event) -> float:
    """Self device time of a profiler average (the attribute was renamed)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


TRACED_STEPS = 3


def profile_call(what: str, call, top: int) -> None:
    """Time and trace ``call()``, one unit of work that it leaves to the
    caller to end: a synchronise follows each call here."""
    for _ in range(2):
        call()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(TRACED_STEPS):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if _is_kernel(e) and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / TRACED_STEPS
    print(f"{what}: wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, "
          f"device idle share {1.0 - device_ms / wall_ms:.4f}", flush=True)
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        ms = _device_us(e) / 1e3 / TRACED_STEPS
        print(f"  {ms:9.3f} ms/call {100 * ms / device_ms:6.2f}%  "
              f"x{e.count // TRACED_STEPS:<4d} {e.key[:110]}")


def profile_step(trainer: Trainer, cfg: Config, b: int, top: int) -> None:
    batch = trainer.to_device(_train_batch(cfg, b))
    profile_call(f"train step {cfg.model}/{cfg.emb_nn} B={b}",
                 lambda: trainer.train_step(batch), top)


def _train_batch(cfg: Config, b: int) -> dict:
    np.random.seed(0)
    ds = SyntheticDataset(cfg, "train", n_items=b, cloud_points=2 * cfg.num_points,
                          kind="shapes")
    return next(iter(Loader(ds, b)))


def trained_dgcnn_weights(steps: int = DGCNN_WARM_STEPS) -> dict:
    """Weights for VCR-Net on the DGCNN embedding: a seeded DCP trainer's
    state after ``steps`` Adam steps on one synthetic batch of 8 (DCP with
    the SVD head has VCR-Net's parameter tree)."""
    cfg = Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16")
    trainer = Trainer(cfg, seed=0)
    batch = trainer.to_device(_train_batch(cfg, 8))
    for _ in range(steps):
        trainer.train_step(batch)
    return trainer.model.state_dict()


def profile_request(name: str, b: int, top: int) -> None:
    fields, largest = SERVE_CONFIGS[name]
    b = min(b, largest)
    cfg = Config(compute_dtype="bfloat16", iter=3, **fields)
    weights = trained_dgcnn_weights() if name == "dgcnn" else load_checkpoint(CHECKPOINT)
    reg = Registrar(cfg, weights)
    data = shapes_eval_set(b, num_points=cfg.num_points, cloud_points=max(2048, cfg.num_points),
                           partial=cfg.partial)
    profile_call(f"request {name} of {b} pairs", lambda: reg.register(data["src"], data["tgt"]),
                 top)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[64])
    ap.add_argument("--top", type=int, default=25, help="kernels to list per batch size")
    ap.add_argument("--model", choices=("vcrnet", "dcp"), default="vcrnet",
                    help="the training step to profile: default VCR-Net, or DCP on DGCNN")
    ap.add_argument("--serve", nargs="+", choices=sorted(SERVE_CONFIGS), default=[],
                    help="profile served requests of these configurations instead of training")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {smi.strip().splitlines()[0]}; torch {torch.__version__}", flush=True)
    if args.serve:
        for name in args.serve:
            for b in args.batch:
                profile_request(name, b, args.top)
        return 0
    cfg = Config(compute_dtype="bfloat16")
    if args.model == "dcp":
        cfg = Config(compute_dtype="bfloat16", model="dcp", emb_nn="dgcnn")
    trainer = Trainer(cfg, seed=0)
    for b in args.batch:
        profile_step(trainer, cfg, b, args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
