"""Registration server around a trained VCRNet (counterpart of
vcrnet_tpu/serve.py).

Numpy in, numpy out. Request batches are padded up a ladder of bucket
sizes by repeating their first pair (the JAX package compiles one program
per bucket; here the ladder keeps the kernels' batch shapes to a small
set), oversized clouds are subsampled deterministically to
``cfg.n_cropped`` points (``cfg.num_points``, or its partial-overlap crop),
the request runs ``cfg.iter`` refinement passes (net + ICP at
``cfg.iter == 0``, ``cfg.max_iterations`` ICP iterations at most), and
batches above the top bucket are split. Padding
rows never reach the results: registration has no cross-pair coupling,
but for ICP's stop, a batch-mean predicate, in which the padding rows take
part, as in the JAX package.

Over a mesh of devices (``mesh=parallel.make_mesh(devices=[...])``, the
counterpart of the JAX Registrar's ``mesh``) the buckets round up to
multiples of the mesh size, the model is replicated on each of its
devices, and a bucket's pairs split into equal contiguous shards over
them, run in this process and come back in order. Each pair's result is
the one-device result: no kernel couples the pairs of a batch. Net + ICP
(``cfg.iter == 0``) takes its batch-mean stop per shard, where the JAX
package's jit takes it over the whole sharded batch.

One bucket's forward is a :class:`BucketForward` module: the Registrar
runs it, and :meth:`Registrar.export_bucket` exports it through
``torch.export`` into an artifact that :func:`load_exported` (module
``exported``, which needs no model code) turns back into a server of that
bucket.
"""

from __future__ import annotations

import io
from typing import Sequence

import numpy as np
import torch
from torch import nn

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.exported import ExportedRegistrar, load_exported, results_to_numpy
from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_icp, vcrnet_iter
from vcrnet_tpu_torch.parallel.mesh import make_mesh, shard_batch
from vcrnet_tpu_torch.utils.device import resolve_device

__all__ = ["BucketForward", "ExportedRegistrar", "Registrar", "load_exported"]


class BucketForward(nn.Module):
    """(src, tgt) [b, n, 3] -> (R_ab, t_ab, R_ba, t_ba): ``vcrnet_iter`` at
    ``cfg.iter`` passes, or ``vcrnet_icp`` at ``cfg.iter == 0`` (the
    function the JAX Registrar jits per bucket, vcrnet_tpu/serve.py:117-131)."""

    def __init__(self, model: VCRNet):
        super().__init__()
        self.model = model

    def forward(self, src: torch.Tensor, tgt: torch.Tensor):
        cfg = self.model.cfg
        if cfg.iter > 0:
            out = vcrnet_iter(self.model, src, tgt, cfg.iter)
        else:
            out = vcrnet_icp(self.model, src, tgt, cfg.max_iterations)
        return out[2:]


class Registrar:
    """>>> reg = Registrar(cfg, state_dict)            # on the CUDA device
    >>> out = reg.register(src, tgt)                  # numpy [b, n, 3] x2
    >>> out["R"], out["t"]                            # numpy [b, 3, 3], [b, 3]

    ``cfg.emb_nn`` picks the embedding (``lpdnet``, ``dgcnn``, ``pointnet``;
    a BatchNorm embedding's ``state_dict`` carries its running statistics).
    ``device`` defaults to ``"cuda"`` and raises where there is none;
    ``use_kernels`` is passed to :class:`VCRNet`. ``mesh``, a mesh of
    devices of this process (``make_mesh(devices=...)``), serves each
    bucket in shards over a replica on each device, ``device`` unused."""

    def __init__(
        self,
        cfg: Config,
        state_dict: dict,
        buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        device=None,
        use_kernels: bool | None = None,
        mesh=None,
    ):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        if mesh is None:
            mesh = make_mesh(devices=[resolve_device(device)])
        elif mesh.group is not None or not mesh.devices:
            raise ValueError("a Registrar serves from one process: give it a mesh of "
                             "devices, make_mesh(devices=[...])")
        else:  # every bucket's pairs split evenly over the mesh
            buckets = sorted({-(-int(b) // mesh.size) * mesh.size for b in buckets})
        self.cfg = cfg
        self.mesh = mesh
        self.replicas = []
        for dev in mesh.devices:
            model = VCRNet(cfg, device=dev, use_kernels=use_kernels)
            model.load_state_dict(state_dict)
            self.replicas.append(BucketForward(model.eval()))
        self.bucket_forward = self.replicas[0]
        self.model = self.bucket_forward.model
        self._buckets = tuple(int(b) for b in buckets)
        self._ran = set()  # buckets whose forward has run
        self.n_points = cfg.n_cropped

    def _bucket_for(self, b: int) -> int:
        return next((cap for cap in self._buckets if b <= cap), self._buckets[-1])

    def _fit_points(self, cloud: np.ndarray, seed: int) -> np.ndarray:
        """[b, n, 3] -> [b, n_points, 3] by a seeded permute-and-take;
        rejects clouds smaller than the model's num_points."""
        n = cloud.shape[1]
        if n < self.n_points:
            raise ValueError(
                f"got {n} points; the model needs >= {self.n_points} "
                "(re-create the Registrar with a smaller cfg.num_points)"
            )
        if n == self.n_points:
            return cloud
        perm = np.random.RandomState(seed).permutation(n)[: self.n_points]
        return cloud[:, perm]

    @property
    def compiled_buckets(self):
        """The buckets that have run, sorted. The port runs eagerly, so
        nothing is compiled per bucket: a bucket is listed once its first
        run, through :meth:`register` or :meth:`warmup`, has paid the
        one-time costs (the kernels' extension build, the cuBLAS and
        cuSOLVER handles, the allocator's first blocks)."""
        return sorted(self._ran)

    def warmup(self, buckets: Sequence[int] | None = None) -> None:
        """Run the given buckets (default all) once, on
        ``RandomState(0).rand(bucket, n_points, 3) - 0.5``, so that the
        first real request pays no one-time cost."""
        for bucket in buckets if buckets is not None else self._buckets:
            if bucket not in self._buckets:
                raise ValueError(f"{bucket} is not one of {self._buckets}")
            cloud = np.random.RandomState(0).rand(
                bucket, self.n_points, 3
            ).astype(np.float32) - 0.5
            self._run_chunk(cloud, cloud)

    def export_bucket(self, bucket: int, path: str | None = None) -> bytes:
        """Serialize one bucket's forward (:class:`BucketForward`, what
        :meth:`register` runs) through ``torch.export``, static shapes,
        weights embedded, in eval mode and without a gradient; write it to
        ``path`` too where one is given. :func:`load_exported` reloads it
        with no model code, config or checkpoint. A mesh Registrar exports
        the whole bucket on its first device alone. The kernels stay ops of
        the ``vcrnet_torch`` library, which the loader imports. The
        artifact keeps this Registrar's device, and the routes decided
        while tracing: the kernel route or the plain one, and the fused
        pointer sublayers as ``VCRNET_FUSED_POINTER`` stands at export.
        Net + ICP (``cfg.iter == 0``) is not exportable: ICP reads its stop
        on the host each iteration."""
        if bucket not in self._buckets:
            raise ValueError(f"{bucket} is not one of {self._buckets}")
        if self.cfg.iter == 0:
            raise ValueError(
                "net + ICP (cfg.iter == 0) cannot be exported: ICP reads its stop on the "
                "host each iteration (models/icp.py, icp_register's .item()), which a "
                "traced graph cannot hold; export a Registrar with cfg.iter >= 1"
            )
        src = torch.zeros((bucket, self.n_points, 3), device=self.model.device)
        with torch.no_grad():
            program = torch.export.export(self.bucket_forward, (src, torch.zeros_like(src)),
                                          strict=False)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blob = buf.getvalue()
        if path is not None:
            with open(path, "wb") as fh:
                fh.write(blob)
        return blob

    def register(self, src: np.ndarray, tgt: np.ndarray, seed: int = 0) -> dict:
        """Register src onto tgt: {"R", "t", "R_inv", "t_inv"} as numpy,
        tgt ~= src @ R^T + t per pair. src/tgt: [b, n, 3] or one [n, 3]
        pair, n >= the model's num_points."""
        src = np.asarray(src, np.float32)
        tgt = np.asarray(tgt, np.float32)
        single = src.ndim == 2
        if single:
            src, tgt = src[None], tgt[None]
        if src.shape != tgt.shape or src.ndim != 3 or src.shape[-1] != 3:
            raise ValueError(f"bad shapes {src.shape} vs {tgt.shape}")
        src = self._fit_points(src, seed)
        tgt = self._fit_points(tgt, seed + 1)
        top = self._buckets[-1]
        outs = [
            self._run_chunk(src[lo:lo + top], tgt[lo:lo + top])
            for lo in range(0, src.shape[0], top)
        ]
        result = {key: np.concatenate([o[key] for o in outs]) for key in outs[0]}
        if single:
            result = {key: val[0] for key, val in result.items()}
        return result

    @torch.inference_mode()
    def _run_chunk(self, src: np.ndarray, tgt: np.ndarray) -> dict:
        b = src.shape[0]
        bucket = self._bucket_for(b)
        if b < bucket:  # pad by repeating the first pair (never NaNs)
            src = np.concatenate([src, np.repeat(src[:1], bucket - b, axis=0)])
            tgt = np.concatenate([tgt, np.repeat(tgt[:1], bucket - b, axis=0)])
        shards = [fwd(pair["src"], pair["tgt"]) for fwd, pair in
                  zip(self.replicas, shard_batch({"src": src, "tgt": tgt}, self.mesh))]
        self._ran.add(bucket)
        if len(shards) == 1:
            return results_to_numpy(*shards[0], b)
        return results_to_numpy(*(torch.cat([o[i].cpu() for o in shards]) for i in range(4)), b)
