"""Registration server around a trained VCRNet (counterpart of
vcrnet_tpu/serve.py:Registrar).

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
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_icp, vcrnet_iter


class Registrar:
    """>>> reg = Registrar(cfg, state_dict)            # on the CUDA device
    >>> out = reg.register(src, tgt)                  # numpy [b, n, 3] x2
    >>> out["R"], out["t"]                            # numpy [b, 3, 3], [b, 3]

    ``cfg.emb_nn`` picks the embedding (``lpdnet``, ``dgcnn``, ``pointnet``;
    a BatchNorm embedding's ``state_dict`` carries its running statistics).
    ``device`` defaults to ``"cuda"`` and raises where there is none;
    ``use_kernels`` is passed to :class:`VCRNet`."""

    def __init__(
        self,
        cfg: Config,
        state_dict: dict,
        buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
        device=None,
        use_kernels: bool | None = None,
    ):
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError("buckets must be sorted, unique, non-empty")
        self.cfg = cfg
        self.model = VCRNet(cfg, device=device, use_kernels=use_kernels)
        self.model.load_state_dict(state_dict)
        self.model.eval()
        self._buckets = tuple(int(b) for b in buckets)
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
        dev = self.model.device
        src, tgt = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
        if self.cfg.iter > 0:
            out = vcrnet_iter(self.model, src, tgt, self.cfg.iter)
        else:
            out = vcrnet_icp(self.model, src, tgt, self.cfg.max_iterations)
        _, _, R_ab, t_ab, R_ba, t_ba = out
        # one device-to-host copy for all four results
        flat = torch.cat([R_ab.reshape(bucket, 9), t_ab, R_ba.reshape(bucket, 9), t_ba], 1)
        flat = flat.cpu().numpy()[:b]
        return {
            "R": flat[:, 0:9].reshape(b, 3, 3),
            "t": flat[:, 9:12],
            "R_inv": flat[:, 12:21].reshape(b, 3, 3),
            "t_inv": flat[:, 21:24],
        }
