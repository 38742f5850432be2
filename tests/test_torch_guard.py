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
from vcrnet_tpu_torch.ops import _build, attention, colmass, dgcnn, edgeconv, knn, pointer, vcp
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train import Trainer

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


def test_trainer_without_device_raises_when_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(num_points=64, emb_dims=64, ff_dims=128))


def test_cpu_backward_wrappers_run_plain_versions_without_building(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA extension must not be built for CPU tensors")

    monkeypatch.setattr(_build, "extension", refuse)
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1, 64, 3, generator=g)
    v = torch.rand(1, 64, 16, generator=g)
    _, idx, win = edgeconv.fused_knn_gather_max(x, v, 4, winners=True)
    edgeconv.gather_max_bwd(idx, win, v)
    f = torch.rand(1, 64, 32, generator=g)
    w2 = torch.rand(32, 32, generator=g)
    _, x2, idx, w1, w2w = edgeconv.fused_edge_conv(f, f, f, w2, torch.rand(32), 4, winners=True)
    edgeconv.edge_conv_bwd(idx, w1, w2w, f, f, w2, x2, f, f)
    q = torch.rand(1, 64, 256, generator=g)
    o, lse = attention.flash_mha_packed(q, q, q, 0.1, 2, return_lse=True)
    attention.flash_bwd(q, q, q, o, lse, q, 0.1, 2)
    corr, lse = vcp.streaming_soft_correspondence(q, q, x, return_lse=True)
    vcp.vcp_bwd(q, q, x, corr, lse, x)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


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
    attention.flash_mha_packed(q, q, q, 0.1, 2, nk_valid=40)
    vcp.streaming_soft_correspondence(q, q, x)
    # the eval protocol's three: given selections and the column masses
    idx = torch.randint(0, 64, (1, 64, 4), generator=g, dtype=torch.int32)
    edgeconv.gather_max_from_idx(idx, f)
    edgeconv.fused_gather_max_from_idx(idx, f, winners=True)
    edgeconv.edge_conv_from_idx(idx, f, f, torch.rand(32, 32, generator=g), torch.rand(32))
    colmass.softmax_colmass(q, q, 0.1, 2)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cpu_tensors_run_the_dgcnn_and_pointer_plain_versions_without_building(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CUDA extension must not be built for CPU tensors")

    monkeypatch.setattr(_build, "extension", refuse)
    assert len(ops.KERNELS) == 15
    assert {"knn", "dgcnn_eval", "fused_mha", "fused_ff"} <= set(ops.KERNELS)
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(2)
    x = torch.rand(1, 32, 3, generator=g)
    idx = knn.fused_knn(x, 4)
    knn.fused_knn(torch.rand(1, 32, 16, generator=g).to(torch.bfloat16), 4)
    folded = [(torch.rand(i, o, generator=g), torch.rand(o, generator=g))
              for i, o in dgcnn.STAGE_WIDTHS + ((512, 128),)]
    assert dgcnn.fused_dgcnn_eval(x, idx, folded, 128).shape == (1, 32, 128)
    y = torch.rand(1, 32, 128, generator=g)
    w = [t for _ in range(4) for t in (torch.rand(128, 128, generator=g), torch.rand(128))]
    assert pointer.fused_mha(y, y, *w, 1).dtype == torch.bfloat16
    assert pointer.fused_ff(y, w[0], w[1], w[2], w[3]).shape == (1, 32, 128)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_dgcnn_and_pointer_wrappers_refuse_other_and_mixed_devices():
    meta = torch.empty(1, 32, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        knn.fused_knn(meta, 4)
    idx = torch.zeros(1, 32, 4, dtype=torch.int32)
    folded = [(torch.zeros(i, o), torch.zeros(o)) for i, o in dgcnn.STAGE_WIDTHS + ((512, 128),)]
    with pytest.raises(ValueError, match="several devices"):
        dgcnn.fused_dgcnn_eval(meta, idx, folded, 128)
    with pytest.raises(ValueError, match="no kernel"):
        dgcnn.fused_dgcnn_eval(meta, idx.to("meta"), [(w.to("meta"), b.to("meta"))
                                                      for w, b in folded], 128)
    y, ym = torch.zeros(1, 32, 128), torch.empty(1, 32, 128, device="meta")
    w = [t for _ in range(4) for t in (torch.zeros(128, 128), torch.zeros(128))]
    with pytest.raises(ValueError, match="several devices"):
        pointer.fused_mha(y, ym, *w, 1)
    with pytest.raises(ValueError, match="several devices"):
        pointer.fused_ff(ym, w[0], w[1], w[2], w[3])
    wm = [t.to("meta") for t in w]
    with pytest.raises(ValueError, match="no kernel"):
        pointer.fused_mha(ym, ym, *wm, 1)
    with pytest.raises(ValueError, match="no kernel"):
        pointer.fused_ff(ym, wm[0], wm[1], wm[2], wm[3])


@pytest.mark.parametrize("kw", [dict(model="dcp", emb_nn="dgcnn"), dict(emb_nn="dgcnn")])
def test_dgcnn_entry_points_without_device_raise_when_there_is_no_gpu(kw):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(num_points=64, emb_dims=64, ff_dims=128, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    if cfg.model == "vcrnet":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Registrar(cfg, {})


def test_wrappers_refuse_other_and_mixed_devices():
    meta = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        edgeconv.fused_knn_gather_max(meta, torch.empty(1, 64, 8, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        vcp.streaming_soft_correspondence(torch.zeros(1, 64, 16), meta, meta)
    idx = torch.zeros(1, 64, 4, dtype=torch.int32)
    cpu, meta8 = torch.zeros(1, 64, 8), torch.empty(1, 64, 8, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        edgeconv.gather_max_from_idx(idx, meta8)
    with pytest.raises(ValueError, match="several devices"):
        edgeconv.edge_conv_from_idx(idx, cpu, meta8, torch.zeros(8, 8), torch.zeros(8))
    with pytest.raises(ValueError, match="several devices"):
        colmass.softmax_colmass(cpu, meta8, 0.1, 1)
    with pytest.raises(ValueError, match="no kernel"):
        colmass.softmax_colmass(meta8, meta8, 0.1, 1)
