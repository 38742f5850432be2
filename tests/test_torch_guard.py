"""Boundaries of the PyTorch port: it imports nothing of JAX, flax or the
JAX package, never moves to the CPU on its own, and runs its plain
versions on CPU tensors without building the CUDA extension."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from vcrnet_tpu_torch import ops
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.ops import _build, attention, edgeconv, vcp
from vcrnet_tpu_torch.serve import Registrar

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vcrnet_tpu")


def _port_files():
    pkg = os.path.join(ROOT, "vcrnet_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax_or_the_jax_package():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(_port_files()) > 15
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, vcrnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(vcrnet_tpu_torch.__path__, 'vcrnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vcrnet_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_registrar_without_device_raises_when_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Registrar(Config(num_points=64, emb_dims=64, ff_dims=128), {})


def test_cpu_tensors_run_plain_versions_without_building(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA extension must not be built for CPU tensors")

    monkeypatch.setattr(_build, "extension", refuse)
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 64, 3, generator=g)
    edgeconv.fused_knn_gather_max(x, torch.rand(1, 64, 16, generator=g), 4)
    f = torch.rand(1, 64, 32, generator=g)
    edgeconv.fused_edge_conv(f, f, f, torch.rand(32, 32, generator=g), torch.rand(32), 4)
    q = torch.rand(1, 64, 256, generator=g)
    attention.flash_mha_packed(q, q, q, 0.1, 2)
    vcp.streaming_soft_correspondence(q, q, x)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_wrappers_refuse_other_and_mixed_devices():
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        edgeconv.fused_knn_gather_max(meta, torch.empty(1, 64, 8, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        vcp.streaming_soft_correspondence(torch.zeros(1, 64, 16), meta, meta)
