"""Loading an exported serving artifact (counterpart of
vcrnet_tpu/serve.py:load_exported and ExportedRegistrar).

``Registrar.export_bucket`` (serve.py) writes one bucket's forward through
``torch.export``, weights inside. Loading it needs this module, torch,
numpy and the port's op library (``vcrnet_tpu_torch.ops``, imported here:
the graph calls the Hopper kernels as ``vcrnet_torch`` ops by name), and
no model code, config or checkpoint. The JAX package's StableHLO artifact
needs no library of its own. The artifact keeps the device it was
exported on: one exported on the card loads only where there is one, and
fails loudly, rather than moving to the CPU, where there is none.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch

import vcrnet_tpu_torch.ops  # noqa: F401  (registers the ops the artifact calls)


def results_to_numpy(R_ab, t_ab, R_ba, t_ba, b: int) -> dict:
    """The four results of a bucket's forward as numpy, the first ``b``
    pairs, through one device-to-host copy."""
    bucket = R_ab.shape[0]
    flat = torch.cat([R_ab.reshape(bucket, 9), t_ab, R_ba.reshape(bucket, 9), t_ba], 1)
    flat = flat.cpu().numpy()[:b]
    return {
        "R": flat[:, 0:9].reshape(b, 3, 3),
        "t": flat[:, 9:12],
        "R_inv": flat[:, 12:21].reshape(b, 3, 3),
        "t_inv": flat[:, 21:24],
    }


def load_exported(blob_or_path) -> "ExportedRegistrar":
    """Rehydrate a :meth:`Registrar.export_bucket` artifact (raw bytes, or
    a path to one) into a callable that registers fixed-size numpy
    batches."""
    if isinstance(blob_or_path, (str, os.PathLike)):
        program = torch.export.load(blob_or_path)
    else:
        program = torch.export.load(io.BytesIO(bytes(blob_or_path)))
    return ExportedRegistrar(program)


class ExportedRegistrar:
    """Numpy-in/out wrapper over a loaded export artifact. The batch and
    point counts are baked in (``.batch``, ``.n_points``), and so is the
    device (``.device``)."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()
        names = set(program.graph_signature.user_inputs)
        src = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name in names)
        spec = src.meta["val"]
        self.batch, self.n_points, _ = spec.shape
        self.device = spec.device

    @torch.inference_mode()
    def register(self, src: np.ndarray, tgt: np.ndarray) -> dict:
        src = np.asarray(src, np.float32)
        tgt = np.asarray(tgt, np.float32)
        want = (self.batch, self.n_points, 3)
        if src.shape != want or tgt.shape != want:
            raise ValueError(
                f"exported artifact takes exactly {want}, got {src.shape} / {tgt.shape}"
            )
        out = self._module(torch.from_numpy(src).to(self.device),
                           torch.from_numpy(tgt).to(self.device))
        return results_to_numpy(*out, self.batch)
