#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vcrnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   compile the port's CUDA extension from csrc/ (sm_90a) and print
           the build time and the card's name and power limit;
2. kernels run each hand-written kernel against its plain PyTorch version
           on the card at the serving shapes (B = 8 and 64, N = 1024), with
           the tolerances below, and time kernel, plain version and, where
           one PyTorch call computes the same function, that call (CUDA
           events, median of 25 after 3 warm-up calls);
3. serve   load checkpoints/pretrained/vcrnet_shapes_best.msgpack with the
           port's own reader, serve requests of 1, 8 and 64 synthetic shape
           pairs (N = 1024) through Registrar at full width, bf16, iter=1,
           check the launch counts of every kernel on that run, the rotation
           error (<= 5 deg) and its agreement with the plain path on the card
           (<= 0.25 deg), and print per-request latency.

The last lines are a JSON object with one entry per kernel, the card's
``nvidia-smi`` name and power limit, and the result object
``{"ok": true, "device": {...}}``. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(HERE, "checkpoints", "pretrained", "vcrnet_shapes_best.msgpack")
N = 1024
K = 20
BATCHES = (8, 64)
REQUESTS = (1, 8, 64)  # pairs per request in the serve phase
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
ROT_LIMIT_DEG = 5.0  # the JAX package's whole_iter1 reference is 2.519 / 2.471 deg
PLAIN_AGREEMENT_DEG = 0.25
KNN_ROW_AGREEMENT = 0.995


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def same_rows(idx, ref_idx) -> float:
    """Share of rows whose neighbour SETS agree."""
    return (idx.sort(-1).values == ref_idx.sort(-1).values).all(-1).float().mean().item()


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.ops import attention, edgeconv, vcp

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    bf16 = torch.bfloat16
    rows = {}
    for B in BATCHES:
        # --- SN block: xyz kNN + gather-max of the bf16 [B, N, 256] table
        x = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
        values = randn(B, N, 256, dtype=bf16)
        out, idx = edgeconv.fused_knn_gather_max(x, values, K)
        torch.cuda.synchronize()
        _, ref_idx = edgeconv.fused_knn_gather_max_ref(x, values, K)
        ref_out, _ = edgeconv.fused_knn_gather_max_ref(x, values, K, idx=idx)
        agree = same_rows(idx, ref_idx)
        err = (out.float() - ref_out.float()).abs().max().item()
        check(agree >= KNN_ROW_AGREEMENT, f"knn_gather_max B={B}: rows agree {agree}")
        check(err == 0.0, f"knn_gather_max B={B}: gather-max not exact ({err})")
        b, by = bound_ms(nbytes(x, values, out, idx), B * N * N * (2 * 3 + 2), F32_FLOPS)
        rows.setdefault("knn_gather_max", []).append(dict(
            B=B, rows_agree=agree, max_abs_err=err, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: edgeconv.fused_knn_gather_max(x, values, K)),
            plain_ms=cuda_time_ms(lambda: edgeconv.fused_knn_gather_max_ref(x, values, K)),
            library_ms=None,
        ))

        # --- DG block: feature kNN on 64-d bf16 + edge conv (F = 128).
        # Scales keep outputs below 4, where one bf16 ulp is <= 1.6e-2.
        xf = randn(B, N, 64, dtype=bf16)
        a = randn(B, N, 128, scale=0.5, dtype=bf16)
        h = randn(B, N, 128, scale=0.5, dtype=bf16)
        w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
        b2 = randn(128, scale=0.1, dtype=bf16)
        x1, x2, idx = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K)
        torch.cuda.synchronize()
        _, _, ref_idx = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K)
        r1, r2, _ = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, idx=idx)
        agree = same_rows(idx, ref_idx)
        err = max((x1.float() - r1.float()).abs().max().item(),
                  (x2.float() - r2.float()).abs().max().item())
        check(agree >= KNN_ROW_AGREEMENT, f"edge_conv B={B}: rows agree {agree}")
        check(err <= 2e-2, f"edge_conv B={B}: max abs err {err} > 2e-2")
        flops = B * N * N * 2 * 64 + B * N * K * 2 * 128 * 128
        b, by = bound_ms(nbytes(xf, a, h, w2, b2, x1, x2, idx), flops, BF16_TENSOR_FLOPS)
        rows.setdefault("edge_conv", []).append(dict(
            B=B, rows_agree=agree, max_abs_err=err, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: edgeconv.fused_edge_conv(xf, a, h, w2, b2, K)),
            plain_ms=cuda_time_ms(lambda: edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K)),
            library_ms=None,
        ))

        # --- packed-head attention, 4 heads of 128
        q, k, v = (randn(B, N, 512, dtype=bf16) for _ in range(3))
        scale = 128 ** -0.5
        o = attention.flash_mha_packed(q, k, v, scale, 4)
        torch.cuda.synchronize()
        err = (o.float() - attention.flash_mha_packed_ref(q, k, v, scale, 4).float()).abs().max().item()
        check(err <= 2e-2, f"flash_packed B={B}: max abs err {err} > 2e-2")
        q4, k4, v4 = (t.reshape(B, N, 4, 128).transpose(1, 2).contiguous() for t in (q, k, v))
        b, by = bound_ms(nbytes(q, k, v, o), 4 * B * 4 * N * N * 128, BF16_TENSOR_FLOPS)
        rows.setdefault("flash_packed", []).append(dict(
            B=B, max_abs_err=err, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: attention.flash_mha_packed(q, k, v, scale, 4)),
            plain_ms=cuda_time_ms(lambda: attention.flash_mha_packed_ref(q, k, v, scale, 4)),
            library_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)),
        ))

        # --- streaming soft correspondence on unit-scale embeddings/clouds
        se = randn(B, N, 512, scale=512 ** -0.5, dtype=bf16)
        te = randn(B, N, 512, scale=512 ** -0.5, dtype=bf16)
        tgt = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
        c = vcp.streaming_soft_correspondence(se, te, tgt)
        torch.cuda.synchronize()
        err = (c - vcp.streaming_soft_correspondence_ref(se, te, tgt)).abs().max().item()
        check(err <= 1e-3, f"vcp_stream B={B}: max abs err {err} > 1e-3")
        sef, tef = se.float(), te.float()
        mask = -(tef * tef).sum(-1)[:, None, :].expand(B, N, N).contiguous()
        b, by = bound_ms(nbytes(se, te, tgt, c), 2 * B * N * N * 512, BF16_TENSOR_FLOPS)
        rows.setdefault("vcp_stream", []).append(dict(
            B=B, max_abs_err=err, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: vcp.streaming_soft_correspondence(se, te, tgt)),
            plain_ms=cuda_time_ms(lambda: vcp.streaming_soft_correspondence_ref(se, te, tgt)),
            library_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(sef, tef, tgt, attn_mask=mask, scale=2.0)),
        ))
    for name, per_b in rows.items():
        for r in per_b:
            print(f"kernel {name} B={r['B']}: " + " ".join(
                f"{key}={val}" for key, val in r.items() if key != "B"), flush=True)
    return rows


def rot_rmse_deg(R_pred, euler_gt):
    import numpy as np
    import torch

    from vcrnet_tpu_torch.geometry import mat_to_euler_zyx

    e = mat_to_euler_zyx(torch.from_numpy(R_pred).double(), degrees=True).numpy()
    return float(np.sqrt(np.mean((e - np.degrees(euler_gt.astype(np.float64))) ** 2)))


def phase_serve():
    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    check(len(state_dict) == 58, f"checkpoint gave {len(state_dict)} tensors, expected 58")
    cfg = Config(compute_dtype="bfloat16", iter=1, num_points=N)
    check((cfg.emb_dims, cfg.ff_dims, cfg.n_heads, cfg.n_blocks) == (512, 1024, 4, 1),
          "serve phase must run the full-width default configuration")
    reg = Registrar(cfg, state_dict)
    plain = Registrar(cfg, state_dict, use_kernels=False)
    check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")

    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    bounds = np.cumsum((0,) + REQUESTS)
    requests = [(data["src"][lo:hi], data["tgt"][lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]
    for src, tgt in requests:  # warm-up: cuBLAS/cuSOLVER handles, allocator
        reg.register(src, tgt)

    ops.reset_launch_counts()
    outs = [reg.register(src, tgt) for src, tgt in requests]
    launches = ops.launch_counts()
    print(f"serve launches on the main path: {launches}", flush=True)
    # per request at iter=1: embed tgt + src (1 edge conv + 1 gather-max
    # each), 6 attentions (target encoder 1, source encoder 1, two decoders
    # 2 each), 1 soft correspondence
    per_request = {"knn_gather_max": 2, "edge_conv": 2, "flash_packed": 6, "vcp_stream": 1}
    for name, n in per_request.items():
        check(launches[name] == n * len(requests),
              f"{name}: {launches[name]} launches on the main path, expected {n * len(requests)}")

    R = np.concatenate([o["R"] for o in outs])
    t = np.concatenate([o["t"] for o in outs])
    check(R.shape == (len(data["src"]), 3, 3) and t.shape == (len(data["src"]), 3), "bad result shapes")
    check(bool(np.isfinite(R).all() and np.isfinite(t).all()), "non-finite result")
    rmse = rot_rmse_deg(R, data["euler_ab"])
    R_plain = np.concatenate([plain.register(src, tgt)["R"] for src, tgt in requests])
    rmse_plain = rot_rmse_deg(R_plain, data["euler_ab"])
    print(f"serve rot RMSE deg: kernels {rmse} plain {rmse_plain} over {len(R)} pairs", flush=True)
    check(rmse <= ROT_LIMIT_DEG, f"rot RMSE {rmse} deg > {ROT_LIMIT_DEG}")
    check(abs(rmse - rmse_plain) <= PLAIN_AGREEMENT_DEG,
          f"kernel vs plain rot RMSE differ by {abs(rmse - rmse_plain)} deg")

    for (src, tgt), b in zip(requests, REQUESTS):
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            reg.register(src, tgt)  # returns host numpy: the device work is done
            lat.append((time.perf_counter() - t0) * 1e3)
        print(f"serve request of {b} pairs: median latency {statistics.median(lat)} ms "
              f"(5 runs: {lat})", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "vcrnet_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from vcrnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.extension()
    print(f"build: {time.perf_counter() - t0} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    rows = phase_kernels(dev)
    launches = phase_serve()

    sources = {
        "knn_gather_max": ("vcrnet_tpu_torch/csrc/knn_gather_max.cu",
                           "vcrnet_tpu/ops/pallas_edgeconv.py:420"),
        "edge_conv": ("vcrnet_tpu_torch/csrc/edge_conv.cu",
                      "vcrnet_tpu/ops/pallas_edgeconv.py:324"),
        "flash_packed": ("vcrnet_tpu_torch/csrc/flash_packed.cu",
                         "vcrnet_tpu/ops/pallas_attention.py:239"),
        "vcp_stream": ("vcrnet_tpu_torch/csrc/vcp_stream.cu",
                       "vcrnet_tpu/ops/pallas_vcp.py:29"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        top = rows[name][-1]  # B = 64, the largest serving bucket
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        })
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
