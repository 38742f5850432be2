"""Parameter introspection (counterpart of vcrnet_tpu/utils/params_io.py;
reference util/initPara.py and util/util.py):

  count_params       the number of parameter entries of a model or a
                     ``state_dict`` (the CLI's param-count banner)
  save_params_table  a name / shape / statistics table of the parameters,
                     written as CSV by the ``csv`` module (reference
                     saveNetAsExcel; an ``.xlsx`` path becomes ``.csv``, as
                     the JAX package's does without openpyxl)
  device_memory_mb   the bytes the caching allocator holds on a CUDA
                     device, in MB (None on the CPU)
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np
import torch


def _named(params) -> list:
    """[(name, numpy array)] of a module's parameters or a ``state_dict``."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return [(name, np.asarray(torch.as_tensor(t).detach().float().cpu()))
            for name, t in items]


def count_params(params) -> int:
    """Entries of every parameter of a module, or of every tensor of a
    ``state_dict``."""
    return sum(int(arr.size) for _, arr in _named(params))


def save_params_table(params, path: str, values: bool = False) -> str:
    """Write one row a parameter: name, shape, entries and mean / std / min
    / max, or with ``values=True`` every value flattened (the reference's
    (name, tensor) sheet). Returns the path written, ``.csv`` for ``.xlsx``."""
    rows = []
    for name, arr in _named(params):
        row = {"name": name, "shape": str(arr.shape), "params": int(arr.size)}
        if values:
            row["values"] = np.array2string(arr.ravel(), precision=5, separator=" ",
                                            threshold=np.inf, max_line_width=np.inf)
        else:
            row.update(mean=float(arr.mean()), std=float(arr.std()),
                       min=float(arr.min()), max=float(arr.max()))
        rows.append(row)
    if path.endswith(".xlsx"):
        path = path[:-5] + ".csv"
    fields = list(rows[0]) if rows else ["name", "shape", "params"]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)
    return path


def device_memory_mb(device=None) -> Optional[float]:
    """MB allocated by tensors on a CUDA device (``torch.cuda.memory_allocated``;
    default the current one); None for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.memory_allocated(dev) / 1024 / 1024
