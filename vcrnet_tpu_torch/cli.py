"""The port's command line (counterpart of vcrnet_tpu/cli.py): the
reference's flags and its dispatch on (model, eval), on PyTorch.

    python -m vcrnet_tpu_torch.cli --model vcrnet --eval --iter 3 \\
        --compute_dtype bfloat16 --model_path checkpoints/pretrained/vcrnet_shapes_best.msgpack
    python -m vcrnet_tpu_torch.cli --model lpd --batch_size 16 --device cpu

Every flag of the JAX package's CLI keeps its name, default and choices,
so ``config_from_args`` of the two parsers gives equal configurations;
runs land in ``checkpoints/{train,test}/<model>-<emb_nn>-<stamp>-<host>``
under the working directory, with ``run.log``, ``models/`` (the port's
``.pt`` checkpoints) and, after a fit, ``history.json``. ``--model_path``
reads the port's checkpoints and the JAX package's msgpack files alike.

Where the flags differ:
  * ``--platform`` and ``--tpu_probe_*`` are about the TPU and are gone;
    ``--device`` (default ``cuda``) takes their place and raises where
    there is no GPU; the CPU runs only when asked for (``--device cpu``);
  * ``--use_kernels`` / ``--no-use_kernels`` (default on): the CUDA kernel
    route wherever the trainer takes it (a CUDA device and bfloat16).
    The kernels take only some widths (ROADMAP C4): before it builds the
    trainer, a run on the kernel route checks its configuration against
    their gates and exits with a message that names each gate and its
    limit; ``--no-use_kernels`` runs the plain PyTorch route there;
  * ``--int8_train_gathers`` is accepted and ignored (the port gathers
    the exact bf16 rows).

Data parallelism runs one process per device, as ``torchrun`` launches
them (the JAX CLI runs one process per host over a device mesh):

    torchrun --nproc_per_node 4 -m vcrnet_tpu_torch.cli --mesh_shape 4 --batch_size 32 ...

Each rank calls ``parallel.initialize()`` (NCCL on the card, Gloo with
``--device cpu``), reads the same batches and trains or evaluates its
share of each (``Trainer``'s mesh); ``--mesh_shape`` is the world size
(or omitted), another number raises. Rank 0 makes the run directory and
hands its path to the others, and alone prints, logs and writes. The
kernel gates take no batch size, so a rank's share of the batch passes
them wherever the whole batch does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.ops.attention import flash_bwd_supported, flash_packed_supported
from vcrnet_tpu_torch.ops.colmass import colmass_supported
from vcrnet_tpu_torch.ops.dgcnn import fused_dgcnn_supported
from vcrnet_tpu_torch.ops.edgeconv import (
    edge_conv_bwd_supported, edge_conv_from_idx_supported, edge_conv_supported,
    gather_max_bwd_supported, gather_max_from_idx_supported, knn_gather_max_supported,
)
from vcrnet_tpu_torch.ops.vcp import MAX_E, streaming_supported, streaming_vjp_supported
from vcrnet_tpu_torch.parallel.mesh import make_mesh
from vcrnet_tpu_torch.parallel.multihost import initialize, launched_world_size
from vcrnet_tpu_torch.utils.device import resolve_device
from vcrnet_tpu_torch.utils.logging import IOStream, MetricsWriter
from vcrnet_tpu_torch.utils.params_io import count_params, device_memory_mb

K = 20  # the embeddings' neighbours (LPDNet, DGCNN)
LPDNET_DG_WIDTH = 64  # LPDNet's kNN space in the DG block
LPDNET_SN_WIDTH = 256  # the SN block's gathered table


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Point Cloud Registration (PyTorch/CUDA)")
    p.add_argument("--iter", type=int, default=1)
    p.add_argument("--overlap", type=float, default=0.75)
    p.add_argument("--model", type=str, default="vcrnet", choices=["dcp", "lpd", "vcrnet", "icp"])
    p.add_argument("--gaussian_noise", action="store_true", default=False)
    p.add_argument("--unseen", action="store_true", default=False)
    p.add_argument("--factor", type=float, default=4, help="rotations drawn from [0, pi/factor]")
    p.add_argument("--emb_nn", type=str, default="lpdnet", choices=["pointnet", "dgcnn", "lpdnet"])
    p.add_argument("--vcp_nn", type=str, default="topK", choices=["topK", "att", "dist"])
    p.add_argument("--emb_dims", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--test_batch_size", type=int, default=24)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--max_iterations", type=int, default=50)
    p.add_argument("--ff_dims", type=int, default=1024)
    p.add_argument("--eval", action="store_true", default=False)
    p.add_argument("--partial", action="store_true", default=False)
    p.add_argument("--t3d", action="store_true", default=False)
    p.add_argument("--tfea", action="store_true", default=False)
    p.add_argument("--loss", type=str, default="point", choices=["pose", "point", "mixed"])
    p.add_argument("--cycle", action="store_true", default=False)
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--dataset", type=str, default="modelnet40",
                   choices=["modelnet40", "kitti", "synthetic", "synthetic_shapes"])
    p.add_argument("--n_blocks", type=int, default=1)
    p.add_argument("--n_heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--use_sgd", action="store_true", default=False)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--exp_name", type=str, default="exp")
    p.add_argument("--pointer", type=str, default="transformer",
                   choices=["identity", "transformer"])
    p.add_argument("--head", type=str, default="svd", choices=["mlp", "svd"])
    # the port's own
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; raises where there is no GPU); "
                        "'cpu' runs the plain route on the CPU")
    p.add_argument("--use_kernels", action=argparse.BooleanOptionalAction, default=True,
                   help="the CUDA kernel route wherever the trainer takes it (a CUDA device "
                        "and bfloat16); a width the kernels refuse exits with the gate's "
                        "limit; --no-use_kernels runs the plain PyTorch route")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--mesh_shape", type=int, default=None,
                   help="data-parallel devices: the world size under torchrun (one process "
                        "per device); default the world size")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--int8_train_gathers", action=argparse.BooleanOptionalAction, default=True,
                   help="accepted and ignored: the port's kernels gather the exact bf16 rows")
    p.add_argument("--reuse_feature_knn", action="store_true", default=False,
                   help="eval refinement: reuse an earlier iteration's feature-graph kNN in "
                        "later ones (approximate)")
    p.add_argument("--feature_knn_refresh", type=int, default=1,
                   help="with --reuse_feature_knn: leading iterations that compute a fresh "
                        "feature graph (see Config)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute the training forward in the backward (exact)")
    p.add_argument("--pretrained_t7", type=str, default="",
                   help="optional reference VCR-Net .t7 to warm-start from (non-strict)")
    p.add_argument("--show_worst", type=int, default=0,
                   help="after eval, report the K worst rot/trans cases")
    return p


def config_from_args(args) -> Config:
    fields = {f.name for f in dataclasses.fields(Config) if f.init}
    return Config(**{k: v for k, v in vars(args).items() if k in fields})


def make_run_dir(cfg: Config) -> str:
    """A new directory ``checkpoints/{train,test}/<model>-<emb_nn>-<stamp>-<host>``
    with ``models/`` in it. The stamp has one-second resolution, so a run
    that starts in the same second as another (of this CLI or the JAX
    package's) would share its directory and append to its ``run.log``: it
    takes the name with ``-2``, ``-3``, ... appended instead."""
    sub = "test" if cfg.eval else "train"
    stamp = datetime.now().strftime("%d-%H-%M-%S")
    base = os.path.join("checkpoints", sub,
                        f"{cfg.model}-{cfg.emb_nn}-{stamp}-{socket.gethostname()[:3]}")
    os.makedirs(os.path.dirname(base), exist_ok=True)
    run_dir, n = base, 1
    while True:
        try:
            os.mkdir(run_dir)
            break
        except FileExistsError:
            n += 1
            run_dir = f"{base}-{n}"
    os.mkdir(os.path.join(run_dir, "models"))
    return run_dir


class _Quiet:
    """The log of a rank other than 0: prints and writes nothing."""

    def cprint(self, text: str) -> None:
        pass

    def close(self) -> None:
        pass


def shared_run_dir(cfg: Config, mesh) -> str:
    """``make_run_dir`` on rank 0, its path handed to every rank: the
    stamp has one-second resolution, so two ranks could name two."""
    run_dir = [make_run_dir(cfg) if mesh.is_writer else None]
    if mesh.group is not None:
        dist.broadcast_object_list(run_dir, src=0, group=mesh.group)
    return run_dir[0]


def kernel_route_refusals(cfg: Config) -> list:
    """The kernel gates that ``cfg`` fails on the paths its run takes (a
    fit trains and evaluates; ``--eval`` evaluates), one message each,
    naming the gate and its limit; empty where the kernel route takes it.
    Under torchrun a rank runs its share of each batch; no gate takes a
    batch size, so the shares pass wherever the whole batch does."""
    if cfg.model == "icp":
        return []
    n, e, h = cfg.n_cropped, cfg.emb_dims, cfg.n_heads
    train = not cfg.eval
    out = []

    def need(ok: bool, gate: str, limit: str) -> None:
        if not ok:
            out.append(f"{gate}: {limit}")

    if cfg.model != "lpd" and cfg.pointer == "transformer":
        dk = f"emb_dims / n_heads = {e} / {h}"
        need(flash_packed_supported(n, n, e, h) and (not train or flash_bwd_supported(n, n, e, h)),
             "ops/attention.py::flash_packed_supported, flash_bwd_supported",
             f"the attention kernels take dk = 128 only (got {dk})")
        if cfg.partial:
            need(colmass_supported(n, n, e, h), "ops/colmass.py::colmass_supported",
                 f"the column-mass kernels take dk = 128 only (got {dk})")
    if cfg.model == "vcrnet" and cfg.vcp_nn == "topK" and not cfg.partial:
        need(streaming_supported(n, n, e) and not (
            train and cfg.streaming_vcp_train and not streaming_vjp_supported(n, n, e)),
             "ops/vcp.py::streaming_supported, streaming_vjp_supported",
             f"the soft-correspondence kernels take emb_dims % 16 == 0 and emb_dims <= {MAX_E} "
             f"(got {e})")
    if cfg.emb_nn == "lpdnet":
        need(edge_conv_supported(n, LPDNET_DG_WIDTH, K) and knn_gather_max_supported(
            n, LPDNET_SN_WIDTH, K),
             "ops/edgeconv.py::edge_conv_supported, knn_gather_max_supported",
             f"the edge-conv and SN-block kernels take k = {K} < N (got N = {n})")
        if cfg.model == "vcrnet" and cfg.iter > 1:
            need(gather_max_from_idx_supported(n, LPDNET_SN_WIDTH, K)
                 and edge_conv_from_idx_supported(n, K),
                 "ops/edgeconv.py::gather_max_from_idx_supported, edge_conv_from_idx_supported",
                 f"the cached-selection kernels take 0 < k <= 32 (got k = {K})")
        if train:
            need(gather_max_bwd_supported(n, LPDNET_SN_WIDTH, K) and edge_conv_bwd_supported(n, K),
                 "ops/edgeconv.py::gather_max_bwd_supported, edge_conv_bwd_supported",
                 f"the backward kernels take k = {K} < N <= 7264 in training (got N = {n})")
    elif cfg.emb_nn == "dgcnn":
        need(fused_dgcnn_supported(n, K, e), "ops/dgcnn.py::fused_dgcnn_supported",
             f"the DGCNN eval kernel takes emb_dims % 128 == 0 and k = {K} < N "
             f"(got emb_dims = {e}, N = {n})")
    return out


def main(argv=None):
    """Run the CLI on ``argv``; returns the eval summary, the fit's history,
    or None (ICP asked to train)."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if launched_world_size() > 1:
        initialize(backend="gloo" if device.type == "cpu" else "nccl")
    mesh = make_mesh()
    use_kernels = None if args.use_kernels else False
    kernel_route = (args.use_kernels and device.type == "cuda"
                    and cfg.compute_dtype == "bfloat16")
    if kernel_route:
        refused = kernel_route_refusals(cfg)
        if refused:
            raise SystemExit("the kernel route refuses this configuration:\n  "
                             + "\n  ".join(refused)
                             + "\n(--no-use_kernels runs the plain PyTorch route)")
    np.random.seed(cfg.seed)

    run_dir = shared_run_dir(cfg, mesh)
    textio = IOStream(os.path.join(run_dir, "run.log")) if mesh.is_writer else _Quiet()
    textio.cprint(str(cfg))

    from vcrnet_tpu_torch.data.pipeline import make_loaders
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train.checkpoint import load_checkpoint, load_t7_vcrnet, merge_params

    train_loader, test_loader = make_loaders(cfg)
    trainer = Trainer(cfg, device=device, use_kernels=use_kernels)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    textio.cprint(f"device: {device} ({name}); kernel route: "
                  f"{'on' if trainer.model is not None and trainer.model.use_kernels else 'off'}")

    if cfg.model == "icp":
        if not cfg.eval:
            textio.cprint("icp can't be trained")  # reference main.py:33
            textio.close()
            return None
    else:
        textio.cprint(f"Model {cfg.model}: params: {count_params(trainer.model) * 4 / 1e6:4f}M")
        if args.model_path:
            load_checkpoint(args.model_path, trainer)
            textio.cprint(f"loaded checkpoint {args.model_path}")
        if args.pretrained_t7:
            converted = load_t7_vcrnet(args.pretrained_t7, n_blocks=cfg.n_blocks)
            trainer.model.load_state_dict(merge_params(trainer.model.state_dict(), converted))
            textio.cprint(f"loaded .t7 (components: {sorted({k.split('.')[0] for k in converted})}) "
                          f"from {args.pretrained_t7}")

    boardio = MetricsWriter(run_dir if mesh.is_writer else None)
    if cfg.eval:
        result = trainer.eval_epoch(test_loader)
        textio.cprint("==FINAL TEST==")
        textio.cprint("A--------->B")
        textio.cprint(json.dumps(result, indent=2, default=float))
        if args.show_worst > 0 and cfg.model != "lpd":
            worst = trainer.worst_cases(test_loader, k=args.show_worst)
            textio.cprint(f"worst rotation cases (dataset idx): {worst['worst_rot_idx']}")
            textio.cprint(f"worst translation cases: {worst['worst_trans_idx']}")
    else:
        result = trainer.fit(train_loader, test_loader, log=textio.cprint,
                             checkpoint_dir=os.path.join(run_dir, "models"),
                             metrics_writer=boardio)
        if mesh.is_writer:
            with open(os.path.join(run_dir, "history.json"), "w") as f:
                json.dump(result, f, default=float)
    memory = device_memory_mb(device)
    if memory is not None:
        textio.cprint(f"device memory allocated: {memory} MB")
    textio.cprint("FINISH")
    boardio.close()
    textio.close()
    return result


if __name__ == "__main__":
    main()
