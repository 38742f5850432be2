#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vcrnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   compile the port's CUDA extension from csrc/ (sm_90a) and print
           the build time, the registers and spills of the soft-correspondence,
           edge-conv and SN-block kernels (nvcc -Xptxas -v; a spill fails) and
           the card's name and power limit;
2. kernels run each hand-written forward kernel against its plain PyTorch
           version on the card at the serving shapes (B = 8 and 64,
           N = 1024; the column masses and attention with a valid-key count
           at B = 2 and 8, N = 3072; every kernel of the served paths again
           at N = 512, 768 and 3072), and each backward kernel at the
           training shapes (the LPDNet blocks see 2B = 16 and 128 stacked
           clouds), with the tolerances below, and time kernel, plain version and, where one
           PyTorch call computes the same function, that call (CUDA events,
           median of 25 after 3 warm-up calls);
3. train   a Trainer at full width, bf16, from a seeded init on synthetic
           shape pairs: the cosine of the kernel route's whole-model
           gradient against the plain route's on one batch of 8 (>= 0.99,
           and >= 0.98 for each parameter whose gradient is not zero in
           exact arithmetic), the exact launches of every kernel in one step, the loss after
           20 Adam steps on one batch below the first step's, and the
           median step time at B = 8 and 64;
4. serve   load checkpoints/pretrained/vcrnet_shapes_best.msgpack with the
           port's own reader, serve requests of 1, 8 and 64 synthetic shape
           pairs (N = 1024) through Registrar at full width, bf16, iter=1,
           check the launch counts of every kernel on that run, the rotation
           error (<= 5 deg) and its agreement with the plain path on the card
           (<= 0.25 deg), and print per-request latency;
5. refine  the same 73 pairs at iter=3: exact, with the feature graph
           reused (refresh 1 and 2) and with iterations 2+ on a 512-point
           subsample, each through the kernels and through the plain route:
           rotation and translation RMSE, the exact launches of a 1-pair
           request, latency for 1 / 8 / 64 pairs;
6. partial partial-overlap registration (overlap 0.575, iter=3): the 73
           pairs cropped from 1024 to 768 points, kernels and plain route;
           then 16 pairs cropped from 4093 to 3072 points at B = 8, where the
           decoder's re-mask streams (column-mass kernels, gather of the
           kept keys, attention with a valid-key count), against the same
           route with the scores written out and against the plain route,
           with the share of kept keys on which the two re-masks agree;
7. dgcnn   the DGCNN / DCP family: a DCP Trainer on the DGCNN embedding
           (bf16, full width) takes 20 Adam steps on one batch (the loss
           falls, the launches of one step, step time at B = 8 and 64), its
           eval step on the kernel route (kNN kernel, fused eval chain on the
           trained running statistics) against the plain route, then VCR-Net
           on DGCNN served with those weights at iter=1 and iter=3 (launches
           of a 1-pair request, kernel route against plain route, latency);
8. fused   the default VCR-Net with VCRNET_FUSED_POINTER=1 for this phase
   pointer only: launches of a 1-pair request at iter=1 and iter=3, rot RMSE
           over the 73 pairs against the unfused kernel route (0.25 / 0.1
           deg), the rotation between the two routes' results pair by pair
           (median <= 0.05, max <= 0.5 deg), latency beside the unfused
           route's.

The kernels phase also holds the four kernels of phases 7 and 8 (knn,
dgcnn_eval, fused_mha, fused_ff) against their plain versions at B = 8 and
64, N = 1024 and at N = 768, and the attention kernels at the edges of
their tiling: the forward (output and logsumexp) at Nq % 128 == 64, one key
tile, one valid key, valid keys ending at and inside a tile, B = 1; the
backward at Nq != Nk and at Nq = Nk = 320; and the soft-correspondence
kernels (forward with lse, then backward) at B = 1, at Ns = Nt = 320 and
at Ns != Nt (512 and 1024 both ways); and the edge-conv kernels (the
forward with and without winners, edge_conv_from_idx on its idx, the
backward from them) at B = 1, at N = 512, 768 and 3072, at C = 32 and 128
and with the slope 0.2; and the SN-block kernels (knn_gather_max with knn
on the same xyz, whose idx must equal it bit for bit, and
gather_max_from_idx) at N = 512, 768, 1024 and 3072 and on a cloud of
duplicate points, and gather_max_bwd at N = 1024 and 3072 into a dv filled
with NaN.

The last lines are a JSON object with one entry per kernel (fifteen), the card's
``nvidia-smi`` name and power limit, and the result object
``{"ok": true, "device": {...}}``. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
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


def bound_ms(nbytes: float, flops, peak_flops: float | None = None):
    """The larger of the bytes' and the operations' least times, in ms.

    ``flops`` is a count of operations at ``peak_flops``, or, without it,
    pairs (count, peak) of work done at different rates.
    """
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    work = flops if peak_flops is None else [(flops, peak_flops)]
    t_ops = sum(f / p for f, p in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def same_rows(idx, ref_idx) -> float:
    """Share of rows whose neighbour SETS agree."""
    return (idx.sort(-1).values == ref_idx.sort(-1).values).all(-1).float().mean().item()


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.ops import attention, edgeconv, knn, vcp

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
        knn_idx = knn.fused_knn(x, K)
        torch.cuda.synchronize()
        _, ref_idx = edgeconv.fused_knn_gather_max_ref(x, values, K)
        ref_out, _ = edgeconv.fused_knn_gather_max_ref(x, values, K, idx=idx)
        agree = same_rows(idx, ref_idx)
        err = (out.float() - ref_out.float()).abs().max().item()
        check(agree >= KNN_ROW_AGREEMENT, f"knn_gather_max B={B}: rows agree {agree}")
        check(err == 0.0, f"knn_gather_max B={B}: gather-max not exact ({err})")
        check(torch.equal(knn_idx, idx), f"knn B={B}: differs from knn_gather_max's idx")
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

    # --- packed-head attention at the edges of its tiling (128-row query
    # blocks of two 64-row warpgroups, 64-key tiles): output 2e-2 absolute,
    # lse 1e-3, as above
    for B, nq, nk, nk_valid in FLASH_EDGE_SHAPES:
        q, k, v = randn(B, nq, 512, dtype=bf16), randn(B, nk, 512, dtype=bf16), randn(B, nk, 512, dtype=bf16)
        if nk_valid is not None:  # the wrapper's padding: zero rows behind the real keys
            k[:, nk_valid:] = 0
            v[:, nk_valid:] = 0
        o, lse = attention.flash_mha_packed(q, k, v, scale, 4, return_lse=True, nk_valid=nk_valid)
        torch.cuda.synchronize()
        want, want_lse = attention.flash_mha_packed_ref(q, k, v, scale, 4, return_lse=True,
                                                        nk_valid=nk_valid)
        err = (o.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        what = f"flash_packed B={B} Nq={nq} Nk={nk} nk_valid={nk_valid}"
        check(err <= 2e-2, f"{what}: max abs err {err} > 2e-2")
        check(lse_err <= 1e-3, f"{what}: lse max abs err {lse_err} > 1e-3")
        rows.setdefault("flash_packed_edge", []).append(dict(
            B=B, Nq=nq, Nk=nk, nk_valid=nk_valid, max_abs_err=err, lse_err=lse_err))
    print_rows(rows)
    return rows


# (B, Nq, Nk, nk_valid): Nq % 128 == 64 (the second warpgroup of the last
# query block owns no rows), a single 64-key tile, one valid key, valid keys
# ending at a tile boundary and inside a tile, and one batch item
FLASH_EDGE_SHAPES = ((2, 320, 320, None), (2, 128, 64, None), (2, 192, 192, 1),
                     (2, 192, 192, 128), (2, 192, 192, 100), (1, N, N, None))
# (B, Nq, Nk) of the backward's edge cases: Nq != Nk, and both % 128 == 64
FLASH_BWD_EDGE_SHAPES = ((8, 1024, 768), (2, 320, 320))
# (B, N, C, slope) of the edge-conv kernels' edge cases: one batch item, the
# other point counts of the served paths (512, 768, 3072), the other kNN
# widths the wrapper takes (32, 128), and the LPD pretraining slope
EDGE_CONV_EDGE_SHAPES = ((1, N, 64, 0.0), (8, 512, 32, 0.0), (8, 768, 128, 0.0),
                         (2, 3072, 64, 0.2))
# (B, Ns, Nt) of the soft-correspondence kernels' edge cases: one batch item,
# Ns % 128 == 64 (the forward's last block has a warpgroup without rows),
# and Ns != Nt both ways
VCP_EDGE_SHAPES = ((1, N, N), (2, 320, 320), (8, 512, N), (8, N, 512))


NUM_POINTS_LARGE = 4093  # the large partial configuration: crops to 3072, a multiple of 128
N_LARGE = 3072       # its model input
KEEP_LARGE = 2353    # keys its re-mask keeps: int(3072 * overlap2)
LARGE_BATCHES = (2, 8)
# (N, B) of the served paths beside N = 1024: the subsample and the partial
# crop of 1024 at the largest request, the large partial crop at its batch
PATH_SHAPES = ((512, 64), (768, 64), (N_LARGE, 8))


def phase_eval_kernels(dev):
    """The kernels of the eval protocol against their plain versions:
    gather_max_from_idx (exact) and edge_conv_from_idx (2e-2 absolute: one
    bf16 ulp below 4) at B = 8 and 64, N = 1024, each also against the fused
    kernel that made the selection (bit for bit; x2 within 2^-7 relative);
    softmax_colmass at B = 2 and 8, N = 3072 (1e-3 of the largest mass: f32
    sums of 3072 probabilities in another order, expf against exp);
    flash_packed with 2353 valid keys of 2368 (2e-2 absolute); and every
    kernel of the served paths at their other sizes (N = 512, 768, 3072)
    with the same tolerances."""
    import torch

    from vcrnet_tpu_torch.ops import attention, colmass, edgeconv, knn, vcp

    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    bf16 = torch.bfloat16
    rows = {}
    for B in BATCHES:
        x = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
        values = randn(B, N, 256, dtype=bf16)
        fused_out, idx = edgeconv.fused_knn_gather_max(x, values, K)
        out, win = edgeconv.fused_gather_max_from_idx(idx, values, winners=True)
        torch.cuda.synchronize()
        ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx, winners=True)
        err = (out.float() - ref_out.float()).abs().max().item()
        check(err == 0.0, f"gather_max_from_idx B={B}: not exact ({err})")
        check(torch.equal(win, ref_win), f"gather_max_from_idx B={B}: winners differ from plain")
        check(torch.equal(out, fused_out),
              f"gather_max_from_idx B={B}: differs from knn_gather_max on its own idx")
        b, by = bound_ms(nbytes(idx, values, out), B * N * K * 256, F32_FLOPS)
        rows.setdefault("gather_max_from_idx", []).append(dict(
            B=B, max_abs_err=err, equals_fused=True, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: edgeconv.fused_gather_max_from_idx(idx, values)),
            plain_ms=cuda_time_ms(lambda: edgeconv.gather_max_from_idx_ref(idx, values)),
            library_ms=None,
        ))

        xf = randn(B, N, 64, dtype=bf16)
        a = randn(B, N, 128, scale=0.5, dtype=bf16)
        h = randn(B, N, 128, scale=0.5, dtype=bf16)
        w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
        b2 = randn(128, scale=0.1, dtype=bf16)
        f1, f2, idx = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K)
        x1, x2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)
        torch.cuda.synchronize()
        r1, r2 = edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2)
        err = max((x1.float() - r1.float()).abs().max().item(),
                  (x2.float() - r2.float()).abs().max().item())
        check(err <= 2e-2, f"edge_conv_from_idx B={B}: max abs err {err} > 2e-2")
        x2_rel = rel_err(x2, f2)
        check(torch.equal(x1, f1), f"edge_conv_from_idx B={B}: x1 differs from edge_conv on its idx")
        check(x2_rel <= 2 ** -7, f"edge_conv_from_idx B={B}: x2 vs edge_conv {x2_rel} > 2^-7")
        b, by = bound_ms(nbytes(idx, a, h, w2, b2, x1, x2), B * N * K * 2 * 128 * 128,
                         BF16_TENSOR_FLOPS)
        rows.setdefault("edge_conv_from_idx", []).append(dict(
            B=B, max_abs_err=err, x2_rel_vs_fused=x2_rel, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)),
            plain_ms=cuda_time_ms(lambda: edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2)),
            library_ms=None,
        ))

    # every kernel again at the other sizes the served paths give it: 512
    # points (iterations 2+ on a subsample), 768 (the partial crop of 1024)
    # and 3072 (of 4093), with the tolerances above
    for n, B in PATH_SHAPES:
        x = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
        values = randn(B, n, 256, dtype=bf16)
        fused_out, idx = edgeconv.fused_knn_gather_max(x, values, K)
        out, win = edgeconv.fused_gather_max_from_idx(idx, values, winners=True)
        knn_idx = knn.fused_knn(x, K)
        torch.cuda.synchronize()
        agree = same_rows(idx, edgeconv.fused_knn_gather_max_ref(x, values, K)[1])
        ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx, winners=True)
        check(agree >= KNN_ROW_AGREEMENT, f"knn_gather_max N={n}: rows agree {agree}")
        check(torch.equal(fused_out, ref_out), f"knn_gather_max N={n}: gather-max not exact")
        check(torch.equal(out, ref_out) and torch.equal(win, ref_win),
              f"gather_max_from_idx N={n}: differs from plain")
        check(torch.equal(knn_idx, idx), f"knn N={n}: differs from knn_gather_max's idx")
        rows.setdefault("knn_gather_max_path_shapes", []).append(dict(
            B=B, N=n, rows_agree=agree, max_abs_err=0.0, equals_knn=True,
            ms=cuda_time_ms(lambda: edgeconv.fused_knn_gather_max(x, values, K))))
        rows.setdefault("knn_path_shapes", []).append(dict(
            B=B, N=n, max_abs_err=0.0, equals_knn_gather_max=True,
            ms=cuda_time_ms(lambda: knn.fused_knn(x, K))))
        rows.setdefault("gather_max_from_idx_path_shapes", []).append(dict(
            B=B, N=n, max_abs_err=0.0, equals_fused=True,
            ms=cuda_time_ms(lambda: edgeconv.fused_gather_max_from_idx(idx, values))))

        xf = randn(B, n, 64, dtype=bf16)
        a = randn(B, n, 128, scale=0.5, dtype=bf16)
        h = randn(B, n, 128, scale=0.5, dtype=bf16)
        f1, f2, idx = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K)
        x1, x2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)
        torch.cuda.synchronize()
        agree = same_rows(idx, edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K)[2])
        r1, r2, _ = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, idx=idx)
        err = max((f1.float() - r1.float()).abs().max().item(),
                  (f2.float() - r2.float()).abs().max().item())
        check(agree >= KNN_ROW_AGREEMENT, f"edge_conv N={n}: rows agree {agree}")
        check(err <= 2e-2, f"edge_conv N={n}: max abs err {err} > 2e-2")
        r1, r2 = edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2)
        err_idx = max((x1.float() - r1.float()).abs().max().item(),
                      (x2.float() - r2.float()).abs().max().item())
        x2_rel = rel_err(x2, f2)
        check(err_idx <= 2e-2, f"edge_conv_from_idx N={n}: max abs err {err_idx} > 2e-2")
        check(torch.equal(x1, f1) and x2_rel <= 2 ** -7,
              f"edge_conv_from_idx N={n}: differs from edge_conv on its idx (x2 {x2_rel})")
        rows.setdefault("edge_conv_path_shapes", []).append(dict(
            B=B, N=n, rows_agree=agree, max_abs_err=err,
            ms=cuda_time_ms(lambda: edgeconv.fused_edge_conv(xf, a, h, w2, b2, K))))
        rows.setdefault("edge_conv_from_idx_path_shapes", []).append(dict(
            B=B, N=n, max_abs_err=err_idx, x2_rel_vs_fused=x2_rel,
            ms=cuda_time_ms(lambda: edgeconv.edge_conv_from_idx(idx, a, h, w2, b2))))

        q, k, v = (randn(B, n, 512, dtype=bf16) for _ in range(3))
        o = attention.flash_mha_packed(q, k, v, 128 ** -0.5, 4)
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_ref(q, k, v, 128 ** -0.5, 4)
        err = (o.float() - want.float()).abs().max().item()
        check(err <= 2e-2, f"flash_packed N={n}: max abs err {err} > 2e-2")
        rows.setdefault("flash_packed_path_shapes", []).append(dict(
            B=B, N=n, max_abs_err=err,
            ms=cuda_time_ms(lambda: attention.flash_mha_packed(q, k, v, 128 ** -0.5, 4))))
        del want, o

        se = randn(B, n, 512, scale=512 ** -0.5, dtype=bf16)
        te = randn(B, n, 512, scale=512 ** -0.5, dtype=bf16)
        tgt = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
        c = vcp.streaming_soft_correspondence(se, te, tgt)
        torch.cuda.synchronize()
        err = (c - vcp.streaming_soft_correspondence_ref(se, te, tgt)).abs().max().item()
        check(err <= 1e-3, f"vcp_stream N={n}: max abs err {err} > 1e-3")
        rows.setdefault("vcp_stream_path_shapes", []).append(dict(
            B=B, N=n, max_abs_err=err,
            ms=cuda_time_ms(lambda: vcp.streaming_soft_correspondence(se, te, tgt))))

    scale = 128 ** -0.5
    pad = -KEEP_LARGE % 64
    for B in LARGE_BATCHES:
        q, k = randn(B, N_LARGE, 512, dtype=bf16), randn(B, N_LARGE, 512, dtype=bf16)
        cm = colmass.softmax_colmass(q, k, scale, 4)
        torch.cuda.synchronize()
        want = colmass.softmax_colmass_ref(q, k, scale, 4)
        rel = rel_err(cm, want)
        err = (cm - want).abs().max().item()
        check(rel <= 1e-3, f"softmax_colmass B={B}: relative err {rel} > 1e-3")
        again = colmass.softmax_colmass(q, k, scale, 4)
        check(torch.equal(cm, again), f"softmax_colmass B={B}: two runs differ")
        kept = set_agreement(cm.sum(1).topk(KEEP_LARGE).indices, want.sum(1).topk(KEEP_LARGE).indices,
                             N_LARGE)
        # the function needs one score product; the kernels' second pass
        # over the scores belongs to their design, not to the bound
        b, by = bound_ms(nbytes(q, k, cm), 2 * B * 4 * N_LARGE * N_LARGE * 128,
                         BF16_TENSOR_FLOPS)
        rows.setdefault("softmax_colmass", []).append(dict(
            B=B, max_abs_err=err, rel_err=rel, kept_keys_agree=kept, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: colmass.softmax_colmass(q, k, scale, 4)),
            plain_ms=cuda_time_ms(lambda: colmass.softmax_colmass_ref(q, k, scale, 4), reps=5),
            library_ms=None,
        ))
        del want

        # attention over the kept keys: 2353 real rows, 15 rows of zeros
        kk, vv = (torch.nn.functional.pad(randn(B, KEEP_LARGE, 512, dtype=bf16), (0, 0, 0, pad))
                  for _ in range(2))
        o = attention.flash_mha_packed(q, kk, vv, scale, 4, nk_valid=KEEP_LARGE)
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_ref(q, kk, vv, scale, 4, nk_valid=KEEP_LARGE)
        err = (o.float() - want.float()).abs().max().item()
        check(err <= 2e-2, f"flash_packed nk_valid B={B}: max abs err {err} > 2e-2")
        unmasked = attention.flash_mha_packed(q, kk, vv, scale, 4)
        check(not torch.equal(o, unmasked), "flash_packed: the valid-key count changed nothing")
        rows.setdefault("flash_packed_nk_valid", []).append(dict(
            B=B, max_abs_err=err,
            ms=cuda_time_ms(
                lambda: attention.flash_mha_packed(q, kk, vv, scale, 4, nk_valid=KEEP_LARGE)),
            plain_ms=cuda_time_ms(lambda: attention.flash_mha_packed_ref(
                q, kk, vv, scale, 4, nk_valid=KEEP_LARGE), reps=5),
        ))
        del want, o, unmasked
    print_rows(rows)
    return rows


def set_agreement(idx_a, idx_b, n: int) -> float:
    """Share of the entries of index sets ``idx_a`` [B, K] that are also in
    ``idx_b`` [B, K] (indices below ``n``)."""
    import torch

    in_a = torch.zeros((idx_a.shape[0], n), dtype=torch.bool, device=idx_a.device)
    in_b = torch.zeros_like(in_a)
    in_a.scatter_(1, idx_a, True)
    in_b.scatter_(1, idx_b, True)
    return ((in_a & in_b).sum() / in_a.sum()).item()


def print_rows(rows):
    for name, per_b in rows.items():
        for r in per_b:
            print(f"kernel {name} B={r['B']}: " + " ".join(
                f"{key}={val}" for key, val in r.items() if key != "B"), flush=True)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    scale = want.float().abs().max().clamp_min(1e-30)
    return ((got.float() - want.float()).abs().max() / scale).item()


def phase_sn_kernels(dev):
    """The SN-block kernels where their selection and scatter are hardest:
    a cloud of duplicate points (every point twice: exact ties of score, and
    each point's twin its nearest neighbour) at B = 8, N = 1024, where
    knn_gather_max's gather-max and winners equal the plain version's on its
    idx, its rows agree with the plain selection on >= 99.5%, each row
    starts with the twin, and knn's idx equals it bit for bit; and
    gather_max_bwd at 2B = 128, N = 1024 (slices of 32 channels) and at
    2B = 16, N = 3072 (slices of 16), within 1e-5 of the plain version
    (shared-memory atomics reorder sums of a few bf16 terms), written by the
    kernel into a dv filled with NaN first: it must write every element."""
    import torch

    from vcrnet_tpu_torch.ops import _build, edgeconv, knn

    g = torch.Generator(device=dev).manual_seed(4)
    bf16 = torch.bfloat16
    rows = {}
    B = 8
    half = torch.rand(B, N // 2, 3, generator=g, device=dev) * 2 - 1
    x = half.repeat_interleave(2, dim=1).contiguous()
    values = torch.randn(B, N, 256, generator=g, device=dev).to(bf16)
    out, idx, win = edgeconv.fused_knn_gather_max(x, values, K, winners=True)
    knn_idx = knn.fused_knn(x, K)
    torch.cuda.synchronize()
    ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx, winners=True)
    agree = same_rows(idx, edgeconv.fused_knn_gather_max_ref(x, values, K)[1])
    twin_first = (idx[..., 0] == torch.arange(N, device=dev) ^ 1).float().mean().item()
    check(torch.equal(out, ref_out) and torch.equal(win, ref_win),
          "knn_gather_max on duplicate points: differs from the plain version on its idx")
    check(agree >= KNN_ROW_AGREEMENT, f"knn_gather_max on duplicate points: rows agree {agree}")
    check(twin_first == 1.0, f"knn_gather_max on duplicate points: twin first in {twin_first}")
    check(torch.equal(knn_idx, idx), "knn on duplicate points: differs from knn_gather_max's idx")
    rows["knn_gather_max_edge"] = [dict(B=B, N=N, duplicates=True, rows_agree=agree,
                                        twin_first=twin_first, max_abs_err=0.0)]
    rows["knn_edge"] = [dict(B=B, N=N, duplicates=True, equals_knn_gather_max=True,
                             max_abs_err=0.0)]

    for B2, n in ((2 * BATCHES[-1], N), (2 * LARGE_BATCHES[-1], N_LARGE)):
        x = torch.rand(B2, n, 3, generator=g, device=dev) * 2 - 1
        values = torch.randn(B2, n, 256, generator=g, device=dev).to(bf16)
        _, idx, win = edgeconv.fused_knn_gather_max(x, values, K, winners=True)
        ct = torch.randn(B2, n, 256, generator=g, device=dev).to(bf16)
        dv = torch.full((B2, n, 256), float("nan"), device=dev)
        _build.extension().gather_max_bwd(idx, win, ct, dv)
        torch.cuda.synchronize()
        err = (dv - edgeconv.gather_max_bwd_ref(idx, win, ct)).abs().max().item()
        check(err <= 1e-5, f"gather_max_bwd B={B2} N={n}: max abs err {err} > 1e-5 "
                           "(NaN: an element left unwritten)")
        rows.setdefault("gather_max_bwd_edge", []).append(dict(
            B=B2, N=n, max_abs_err=err, nan_filled=True,
            ms=cuda_time_ms(lambda: edgeconv.gather_max_bwd(idx, win, ct))))
    print_rows(rows)
    return rows


def phase_backward(dev):
    """The four backward kernels at the training shapes (the LPDNet blocks
    see the stacked batch 2B = 16 and 128, attention and VCP B = 8 and
    64), each fed the same saved indices, winners and logsumexp as its
    plain version. Tolerances: gather-max bwd 1e-5 absolute (f32 atomics
    reorder sums of a few bf16 terms); edge conv bwd 2^-7 of the largest
    value for da (dq is rounded to bf16 before the scatter, at f32 values
    that differ in the last bits) and 1e-4 relative for dh, dW2, db2 (f32
    sums in another order); attention and VCP 1e-2 relative (ds is rounded
    to bf16 at f32 values that differ in the last bits); the VCP library
    call 5e-2 relative against the plain version (it keeps ds and p in f32,
    where the kernel and its plain version round them to bf16)."""
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.ops import attention, edgeconv, vcp

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def timed(row, kernel, plain, library=None):
        row["ms"] = cuda_time_ms(kernel)
        row["plain_ms"] = cuda_time_ms(plain)
        row["library_ms"] = cuda_time_ms(library) if library is not None else None
        return row

    bf16 = torch.bfloat16
    rows = {}
    for B in BATCHES:
        B2 = 2 * B  # the embedding runs src and tgt stacked
        # --- SN block backward: winners of the forward, then the scatter
        x = torch.rand(B2, N, 3, generator=g, device=dev) * 2 - 1
        values = randn(B2, N, 256, dtype=bf16)
        _, idx, win = edgeconv.fused_knn_gather_max(x, values, K, winners=True)
        _, _, ref_win = edgeconv.fused_knn_gather_max_ref(x, values, K, idx=idx, winners=True)
        check(torch.equal(win, ref_win), f"knn_gather_max B={B2}: winners differ from plain")
        ct = randn(B2, N, 256, dtype=bf16)
        dv = edgeconv.gather_max_bwd(idx, win, ct)
        torch.cuda.synchronize()
        err = (dv - edgeconv.gather_max_bwd_ref(idx, win, ct)).abs().max().item()
        check(err <= 1e-5, f"gather_max_bwd B={B2}: max abs err {err} > 1e-5")
        b, by = bound_ms(nbytes(idx, win, ct, dv), B2 * N * 256, F32_FLOPS)
        rows.setdefault("gather_max_bwd", []).append(timed(
            dict(B=B2, max_abs_err=err, bound_ms=b, bound_by=by),
            lambda: edgeconv.gather_max_bwd(idx, win, ct),
            lambda: edgeconv.gather_max_bwd_ref(idx, win, ct)))

        # --- DG block backward from the forward's idx and winners
        xf = randn(B2, N, 64, dtype=bf16)
        a = randn(B2, N, 128, scale=0.5, dtype=bf16)
        h = randn(B2, N, 128, scale=0.5, dtype=bf16)
        w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
        b2 = randn(128, scale=0.1, dtype=bf16)
        _, x2, idx, win1, win2 = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K, winners=True)
        _, _, _, rw1, rw2 = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, idx=idx,
                                                         winners=True)
        check(torch.equal(win1, rw1), f"edge_conv B={B2}: x1 winners differ from plain")
        w2_agree = (win2 == rw2).float().mean().item()  # y sums in another order
        check(w2_agree >= 0.99, f"edge_conv B={B2}: x2 winners agree on {w2_agree}")
        ct1, ct2 = randn(B2, N, 128, dtype=bf16), randn(B2, N, 128, dtype=bf16)
        args = (idx, win1, win2, a, h, w2, x2, ct1, ct2)
        got = edgeconv.edge_conv_bwd(*args)
        torch.cuda.synchronize()
        want = edgeconv.edge_conv_bwd_ref(*args)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(errs[0] <= 2 ** -7 and max(errs[1:]) <= 1e-4,
              f"edge_conv_bwd B={B2}: relative errors (da, dh, dW2, db2) {errs}")
        err = max((gv - wv).abs().max().item() for gv, wv in zip(got, want))
        # dz = bf16(dp) W2^T runs on the tensor cores at the bf16 rate; dW2,
        # db2 and the elementwise work stay in f32
        work = [(B2 * N * 2 * 128 * 128, BF16_TENSOR_FLOPS),
                (B2 * N * (2 * 128 * 128 + 4 * K * 128), F32_FLOPS)]
        b, by = bound_ms(nbytes(*args, *got), work)
        rows.setdefault("edge_conv_bwd", []).append(timed(
            dict(B=B2, rel_errs=errs, x2_winners_agree=w2_agree, max_abs_err=err,
                 bound_ms=b, bound_by=by),
            lambda: edgeconv.edge_conv_bwd(*args),
            lambda: edgeconv.edge_conv_bwd_ref(*args)))

        # --- attention backward from the forward's output and logsumexp
        q, k, v = (randn(B, N, 512, dtype=bf16) for _ in range(3))
        scale = 128 ** -0.5
        o, lse = attention.flash_mha_packed(q, k, v, scale, 4, return_lse=True)
        _, ref_lse = attention.flash_mha_packed_ref(q, k, v, scale, 4, return_lse=True)
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-3, f"flash_packed B={B}: lse max abs err {lse_err} > 1e-3")
        do = randn(B, N, 512, dtype=bf16)
        got = attention.flash_bwd(q, k, v, o, lse, do, scale, 4)
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, scale, 4)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"flash_bwd B={B}: relative errors (dq, dk, dv) {errs}")
        err = max((gv.float() - wv.float()).abs().max().item() for gv, wv in zip(got, want))
        q4, k4, v4 = (t.reshape(B, N, 4, 128).transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        do4 = do.reshape(B, N, 4, 128).transpose(1, 2).contiguous()
        b, by = bound_ms(nbytes(q, k, v, o, lse, do, *got), 10 * B * 4 * N * N * 128,
                         BF16_TENSOR_FLOPS)
        rows.setdefault("flash_bwd", []).append(timed(
            dict(B=B, rel_errs=errs, lse_err=lse_err, max_abs_err=err, bound_ms=b, bound_by=by),
            lambda: attention.flash_bwd(q, k, v, o, lse, do, scale, 4),
            lambda: attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, scale, 4),
            lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)))

        # --- soft correspondence backward from the forward's corr and lse
        se = randn(B, N, 512, scale=512 ** -0.5, dtype=bf16)
        te = randn(B, N, 512, scale=512 ** -0.5, dtype=bf16)
        tgt = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
        corr, lse = vcp.streaming_soft_correspondence(se, te, tgt, return_lse=True)
        _, ref_lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= 1e-3, f"vcp_stream B={B}: lse max abs err {lse_err} > 1e-3")
        dcorr = randn(B, N, 3)
        vargs = (se, te, tgt, corr, lse, dcorr)
        got = vcp.vcp_bwd(*vargs)
        torch.cuda.synchronize()
        want = vcp.vcp_bwd_ref(*vargs)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"vcp_bwd B={B}: relative errors (de, df, dtgt) {errs}")
        err = max((gv - wv).abs().max().item() for gv, wv in zip(got, want))
        # the library's counterpart: SDPA with the -|f|^2 mask built from a
        # tgt_emb inside the graph, so its backward adds the -2 colsum(ds) f
        # term; it keeps ds and p in f32, where the kernel rounds them to
        # bf16, hence the looser agreement
        sef, tef, tgtg = (t.float().requires_grad_() for t in (se, te, tgt))
        mask = -(tef * tef).sum(-1)[:, None, :].expand(B, N, N)
        c_lib = F.scaled_dot_product_attention(sef, tef, tgtg, attn_mask=mask, scale=2.0)
        lib = torch.autograd.grad(c_lib, (sef, tef, tgtg), dcorr, retain_graph=True)
        lib_errs = [rel_err(lv, wv) for lv, wv in zip(lib, want)]
        check(max(lib_errs) <= 5e-2, f"vcp_bwd B={B}: library relative errors {lib_errs}")
        b, by = bound_ms(nbytes(*vargs, *got), 6 * B * N * N * 512, BF16_TENSOR_FLOPS)
        rows.setdefault("vcp_bwd", []).append(timed(
            dict(B=B, rel_errs=errs, lib_rel_errs=lib_errs, lse_err=lse_err, max_abs_err=err,
                 bound_ms=b, bound_by=by),
            lambda: vcp.vcp_bwd(*vargs), lambda: vcp.vcp_bwd_ref(*vargs),
            lambda: torch.autograd.grad(c_lib, (sef, tef, tgtg), dcorr, retain_graph=True)))

    # --- attention backward where the key and query counts differ, and where
    # both leave the last block's second warpgroup without rows (1e-2 relative)
    for B, nq, nk in FLASH_BWD_EDGE_SHAPES:
        q, do = randn(B, nq, 512, dtype=bf16), randn(B, nq, 512, dtype=bf16)
        k, v = randn(B, nk, 512, dtype=bf16), randn(B, nk, 512, dtype=bf16)
        o, lse = attention.flash_mha_packed(q, k, v, scale, 4, return_lse=True)
        got = attention.flash_bwd(q, k, v, o, lse, do, scale, 4)
        torch.cuda.synchronize()
        want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, scale, 4)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"flash_bwd B={B} Nq={nq} Nk={nk}: relative errors {errs}")
        err = max((gv.float() - wv.float()).abs().max().item() for gv, wv in zip(got, want))
        rows.setdefault("flash_bwd_edge", []).append(dict(
            B=B, Nq=nq, Nk=nk, rel_errs=errs, max_abs_err=err,
            ms=cuda_time_ms(lambda: attention.flash_bwd(q, k, v, o, lse, do, scale, 4))))

    # --- soft correspondence at the edges of its tiling, forward with lse
    # (1e-3 absolute each) and backward from them (1e-2 relative)
    for B, ns, nt in VCP_EDGE_SHAPES:
        se = randn(B, ns, 512, scale=512 ** -0.5, dtype=bf16)
        te = randn(B, nt, 512, scale=512 ** -0.5, dtype=bf16)
        tgt = torch.rand(B, nt, 3, generator=g, device=dev) * 2 - 1
        corr, lse = vcp.streaming_soft_correspondence(se, te, tgt, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
        err = (corr - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        what = f"B={B} Ns={ns} Nt={nt}"
        check(err <= 1e-3, f"vcp_stream {what}: max abs err {err} > 1e-3")
        check(lse_err <= 1e-3, f"vcp_stream {what}: lse max abs err {lse_err} > 1e-3")
        rows.setdefault("vcp_stream_edge", []).append(dict(
            B=B, Ns=ns, Nt=nt, max_abs_err=err, lse_err=lse_err))
        vargs = (se, te, tgt, corr, lse, randn(B, ns, 3))
        got = vcp.vcp_bwd(*vargs)
        torch.cuda.synchronize()
        want = vcp.vcp_bwd_ref(*vargs)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"vcp_bwd {what}: relative errors (de, df, dtgt) {errs}")
        rows.setdefault("vcp_bwd_edge", []).append(dict(
            B=B, Ns=ns, Nt=nt, rel_errs=errs,
            max_abs_err=max((gv - wv).abs().max().item() for gv, wv in zip(got, want))))
    # --- the edge-conv kernels at the edges of their tiling: the forward
    # with and without winners against the plain version, edge_conv_from_idx
    # on its idx, and the backward from them, with the tolerances above
    for B, n, c, slope in EDGE_CONV_EDGE_SHAPES:
        xf = randn(B, n, c, dtype=bf16)
        a = randn(B, n, 128, scale=0.5, dtype=bf16)
        h = randn(B, n, 128, scale=0.5, dtype=bf16)
        w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
        b2 = randn(128, scale=0.1, dtype=bf16)
        what = f"B={B} N={n} C={c} slope={slope}"
        x1, x2, idx = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K, slope)
        t1, t2, t_idx, win1, win2 = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K, slope,
                                                             winners=True)
        f1, f2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2, slope)
        torch.cuda.synchronize()
        _, _, ref_idx = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, slope)
        r1, r2, _, rw1, rw2 = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, slope, idx=idx,
                                                           winners=True)
        agree = same_rows(idx, ref_idx)
        err = max((x1.float() - r1.float()).abs().max().item(),
                  (x2.float() - r2.float()).abs().max().item())
        check(agree >= KNN_ROW_AGREEMENT, f"edge_conv {what}: rows agree {agree}")
        check(err <= 2e-2, f"edge_conv {what}: max abs err {err} > 2e-2")
        check(torch.equal(t_idx, idx) and torch.equal(t1, x1) and torch.equal(t2, x2),
              f"edge_conv {what}: the forward with winners differs from the one without")
        check(torch.equal(win1, rw1), f"edge_conv {what}: x1 winners differ from plain")
        w2_agree = (win2 == rw2).float().mean().item()
        check(w2_agree >= 0.99, f"edge_conv {what}: x2 winners agree on {w2_agree}")
        f2_rel = rel_err(f2, x2)
        check(torch.equal(f1, x1) and f2_rel <= 2 ** -7,
              f"edge_conv_from_idx {what}: differs from edge_conv on its idx (x2 {f2_rel})")
        rows.setdefault("edge_conv_edge", []).append(dict(
            B=B, N=n, C=c, slope=slope, rows_agree=agree, x2_winners_agree=w2_agree,
            max_abs_err=err))
        rows.setdefault("edge_conv_from_idx_edge", []).append(dict(
            B=B, N=n, C=c, slope=slope, x2_rel_vs_fused=f2_rel,
            max_abs_err=max((f1.float() - r1.float()).abs().max().item(),
                            (f2.float() - r2.float()).abs().max().item())))
        ct1, ct2 = randn(B, n, 128, dtype=bf16), randn(B, n, 128, dtype=bf16)
        args = (idx, win1, win2, a, h, w2, x2, ct1, ct2, slope)
        got = edgeconv.edge_conv_bwd(*args)
        torch.cuda.synchronize()
        want = edgeconv.edge_conv_bwd_ref(*args)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(errs[0] <= 2 ** -7 and max(errs[1:]) <= 1e-4,
              f"edge_conv_bwd {what}: relative errors (da, dh, dW2, db2) {errs}")
        rows.setdefault("edge_conv_bwd_edge", []).append(dict(
            B=B, N=n, slope=slope, rel_errs=errs,
            max_abs_err=max((gv - wv).abs().max().item() for gv, wv in zip(got, want))))
    print_rows(rows)
    return rows


# kernel launches in one training step: the forward embeds src and tgt
# stacked (1 edge conv, 1 gather-max), the pointer runs 6 attentions, the
# head 1 soft correspondence; the backward launches one backward kernel each
# (check_launches holds every kernel not named here to zero launches)
TRAIN_LAUNCHES = {"knn_gather_max": 1, "edge_conv": 1, "flash_packed": 6, "vcp_stream": 1,
                  "gather_max_bwd": 1, "edge_conv_bwd": 1, "flash_bwd": 6, "vcp_bwd": 1}
GRAD_COSINE_MIN = 0.99
LEAF_COSINE_MIN = 0.98
# leaves whose gradient is zero in exact arithmetic, so both routes give
# rounding noise there and their cosine means nothing: the key
# projections' biases (q . b_k is one constant along a softmax row) and the
# decoder's final LayerNorm shift (it moves both clouds' embeddings alike,
# which shifts each VCP score row by a constant)
ZERO_GRAD_LEAVES = ("linear_k.bias", "pointer.dec_norm.b_2")
TRAIN_STEPS = 20


def _train_batch(cfg, b: int, seed: int) -> dict:
    import numpy as np

    from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset

    np.random.seed(seed)  # training pairs draw from the global generator
    ds = SyntheticDataset(cfg, "train", n_items=b, cloud_points=2 * N, seed=seed, kind="shapes")
    return next(iter(Loader(ds, b)))


def _cosine(a, b) -> float:
    a, b = a.double(), b.double()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


def phase_train():
    """The training step at full width, bf16, N = 1024, from a seeded init
    on synthetic shape pairs: kernel-route vs plain-route gradients on one
    batch of 8, the launches of one step, 20 Adam steps on one batch, and
    the step time at B = 8 and 64."""
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.train import Trainer

    cfg = Config(compute_dtype="bfloat16", num_points=N)
    check((cfg.emb_dims, cfg.ff_dims, cfg.n_heads, cfg.n_blocks, cfg.loss, cfg.cycle,
           cfg.dropout, cfg.streaming_vcp_train) == (512, 1024, 4, 1, "point", False, 0.0, True),
          "train phase must run the default configuration")
    batch8 = _train_batch(cfg, 8, seed=1)
    kern = Trainer(cfg, seed=0)
    plain = Trainer(cfg, seed=0, use_kernels=False)
    check(kern.model.use_kernels and not plain.model.use_kernels, "routes not as asked")

    # gradients of the two routes on one batch of 8, from the same init
    loss_k, _ = kern.compute_grads(batch8)
    loss_p, _ = plain.compute_grads(batch8)
    names, gk, gp = [], [], []
    for (name, pk), (_, pp) in zip(kern.model.named_parameters(), plain.model.named_parameters()):
        names.append(name)
        gk.append(pk.grad.reshape(-1))
        gp.append(pp.grad.reshape(-1))
    low = []
    for name, a, b in zip(names, gk, gp):
        leaf_cos = _cosine(a, b)
        print(f"train grad cosine {name}: {leaf_cos}", flush=True)
        if not name.endswith(ZERO_GRAD_LEAVES) and not leaf_cos >= LEAF_COSINE_MIN:
            low.append((name, leaf_cos))
    cos = _cosine(torch.cat(gk), torch.cat(gp))
    print(f"train loss at init: kernels {loss_k.item()} plain {loss_p.item()}; "
          f"whole-model grad cosine {cos}", flush=True)
    check(math.isfinite(loss_k.item()), "non-finite training loss")
    check(cos >= GRAD_COSINE_MIN, f"kernel vs plain gradient cosine {cos} < {GRAD_COSINE_MIN}")
    check(not low, f"kernel vs plain gradient cosine below {LEAF_COSINE_MIN}: {low}")
    exempt = [n for n in names if n.endswith(ZERO_GRAD_LEAVES)]
    check(len(exempt) == 4, f"zero-gradient leaves {exempt}: expected 3 key biases + 1 shift")
    del plain

    # launches of one training step on the main path (after a warm-up step)
    kern.train_step(batch8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kern.train_step(batch8)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"train launches in one step: {launches}", flush=True)
    check_launches(launches, TRAIN_LAUNCHES, "train step")

    # Adam on one fixed batch: the loss must fall
    tr = Trainer(cfg, seed=0)
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        sums = tr.train_step(batch8)
        losses.append((sums["loss"] / sums["count"]).item())
    print(f"train losses over {TRAIN_STEPS} Adam steps on one batch: {losses}", flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite loss in the Adam steps")
    check(losses[-1] < losses[0],
          f"loss after {TRAIN_STEPS} steps {losses[-1]} >= first {losses[0]}")

    step_ms = {}
    for b in BATCHES:
        times = timed_steps_ms(tr, tr.to_device(_train_batch(cfg, b, seed=2)))
        step_ms[b] = statistics.median(times)
        print(f"train step at B={b}: median {step_ms[b]} ms (5 steps: {times})", flush=True)
    return launches, step_ms


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
    check_launches(launches, {name: n * len(requests) for name, n in LAUNCHES_ITER1.items()},
                   "serve, all requests")

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


# ---------------------------------------------------------------------------
# the eval protocol: iter=3 refinement and partial-overlap registration
# ---------------------------------------------------------------------------

ROT_LIMIT_ITER3_DEG = 1.0  # the JAX package's whole_iter3 reference is 0.3946 / 0.2825 deg
ROT_LIMIT_PARTIAL_DEG = 12.0  # its partial_iter3 reference is 9.209 / 8.678 deg
# Launches of a request at iter=1: embed tgt + src (1 edge conv + 1 gather-max
# each), 6 attentions (target encoder 1, source encoder 1, two decoders 2
# each), 1 soft correspondence
LAUNCHES_ITER1 = {"knn_gather_max": 2, "edge_conv": 2, "flash_packed": 6, "vcp_stream": 1}
# Launches of a 1-pair request at iter=3. Exact: the target is embedded and
# encoded once (1 kNN gather-max, 1 edge conv, 1 attention); the source runs
# the fused kNN gather-max in iteration 1 and gather_max_from_idx after, a
# fresh edge conv each iteration, 5 attentions (its encoder, two decoders of
# 2) and 1 soft correspondence per iteration.
LAUNCHES_ITER3 = {"knn_gather_max": 2, "edge_conv": 4, "gather_max_from_idx": 2,
                  "flash_packed": 16, "vcp_stream": 3}
REFINE_CONFIGS = {
    # name: (Config fields, launches that differ from LAUNCHES_ITER3)
    "exact": ({}, {}),
    # the feature graph of iteration 1 (refresh 2: of iteration 2) is reused
    "reuse_refresh1": (dict(reuse_feature_knn=True, feature_knn_refresh=1),
                       {"edge_conv": 2, "edge_conv_from_idx": 2}),
    "reuse_refresh2": (dict(reuse_feature_knn=True, feature_knn_refresh=2),
                       {"edge_conv": 3, "edge_conv_from_idx": 1}),
    # iterations 2+ on 512 points: a second target embedding and encoder
    # pass, and a fresh source selection at that size in iteration 2
    "subsample512": (dict(refine_subsample=512),
                     {"knn_gather_max": 4, "edge_conv": 5, "gather_max_from_idx": 1,
                      "flash_packed": 17}),
}
# partial mode: the head is plain PyTorch (no soft-correspondence kernel), the
# re-masked cross attentions (2 per iteration) write their scores out at 768
# keys and stream at 3072 (one column-mass launch and one attention each)
LAUNCHES_PARTIAL = dict(LAUNCHES_ITER3, flash_packed=10, vcp_stream=0)
LAUNCHES_PARTIAL_LARGE = dict(LAUNCHES_ITER3, flash_packed=16, vcp_stream=0, softmax_colmass=6)
KEPT_KEYS_AGREEMENT = 0.995
SHARPEN_CROSS_ATTENTION = 1e6  # the checkpoint's cross-attention scores are ~1e-5


def split_requests(data, sizes):
    import numpy as np

    bounds = np.cumsum((0,) + tuple(sizes))
    return [(data["src"][lo:hi], data["tgt"][lo:hi]) for lo, hi in zip(bounds[:-1], bounds[1:])]


def serve_all(reg, requests):
    import numpy as np

    outs = [reg.register(src, tgt) for src, tgt in requests]
    R = np.concatenate([o["R"] for o in outs])
    t = np.concatenate([o["t"] for o in outs])
    check(bool(np.isfinite(R).all() and np.isfinite(t).all()), "non-finite result")
    return R, t


def pair_rot_errors_deg(R_pred, R_gt):
    """Angle of R_pred^T R_gt per pair, degrees: 2 asin(|R_pred - R_gt|_F / (2 sqrt 2))."""
    import numpy as np

    diff = np.linalg.norm((R_pred.astype(np.float64) - R_gt).reshape(-1, 9), axis=1)
    return np.degrees(2.0 * np.arcsin(np.clip(diff / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def accuracy(R, t, data) -> dict:
    import numpy as np

    err = pair_rot_errors_deg(R, data["R_ab"])
    return {"rot_rmse_deg": rot_rmse_deg(R, data["euler_ab"]),
            "trans_rmse": float(np.sqrt(np.mean((t - data["t_ab"]) ** 2))),
            "pair_rot_err_median_deg": float(np.median(err)),
            "pair_rot_err_max_deg": float(err.max())}


def one_request_launches(reg, src, tgt, expected: dict, what: str) -> dict:
    import torch

    from vcrnet_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reg.register(src, tgt)
    launches = ops.launch_counts()
    print(f"{what}: launches of one request: {launches}", flush=True)
    check_launches(launches, expected, what)
    return launches


def print_latency(reg, requests, what: str) -> None:
    for src, tgt in requests:
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            reg.register(src, tgt)  # returns host numpy: the device work is done
            lat.append((time.perf_counter() - t0) * 1e3)
        print(f"{what}: request of {len(src)} pairs: median latency {statistics.median(lat)} ms "
              f"(5 runs: {lat})", flush=True)


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def phase_refine():
    """iter=3 over the 73 pairs with the committed checkpoint: exact, with
    the feature graph reused, and on a subsample; kernels and plain route."""
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    requests = split_requests(data, REQUESTS)
    total, results = {}, {}
    for name, (fields, launch_delta) in REFINE_CONFIGS.items():
        cfg = Config(compute_dtype="bfloat16", iter=3, num_points=N, **fields)
        reg = Registrar(cfg, state_dict)
        plain = Registrar(cfg, state_dict, use_kernels=False)
        check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
        serve_all(reg, requests)  # warm-up
        add_launches(total, one_request_launches(
            reg, *requests[0], {**LAUNCHES_ITER3, **launch_delta}, f"refine {name}"))
        acc = accuracy(*serve_all(reg, requests), data)
        acc_plain = accuracy(*serve_all(plain, requests), data)
        results[name] = acc
        print(f"refine {name}: kernels {acc} plain {acc_plain} over {len(data['src'])} pairs",
              flush=True)
        print_latency(reg, requests, f"refine {name}")
        if name == "subsample512":
            # the embedding sees half the density it was trained at, so the
            # error grows on both routes alike (the JAX package's own finding,
            # config.py); held against the plain route only
            check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 0.5,
                  f"refine {name}: kernel vs plain rot RMSE differ by more than 0.5 deg")
            continue
        check(acc["rot_rmse_deg"] <= ROT_LIMIT_ITER3_DEG,
              f"refine {name}: rot RMSE {acc['rot_rmse_deg']} deg > {ROT_LIMIT_ITER3_DEG}")
        if name == "exact":
            check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 0.1,
                  "refine exact: kernel vs plain rot RMSE differ by more than 0.1 deg")
        else:
            check(abs(acc["rot_rmse_deg"] - results["exact"]["rot_rmse_deg"]) <= 0.3,
                  f"refine {name}: rot RMSE more than 0.3 deg from the exact kernel route")
    return total


def phase_partial():
    """Partial-overlap registration at iter=3 with the committed checkpoint:
    (c) 1024 -> 768 points, 73 pairs; (d) 4093 -> 3072 points, 16 pairs at
    B = 8, streaming re-mask against the written-out scores."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.models._common import dense
    from vcrnet_tpu_torch.models.transformer import MultiHeadAttention
    from vcrnet_tpu_torch.ops.colmass import softmax_colmass, softmax_colmass_ref
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    total = {}

    # --- (c) num_points 1024: 768 points per cloud, the re-mask keeps 588 keys
    cfg = Config(compute_dtype="bfloat16", iter=3, num_points=N, partial=True, overlap=0.575)
    check((cfg.n_cropped, cfg.attn_mask_k, cfg.select_k, cfg.pair_k) == (768, 588, 494, 196),
          f"partial sizes {cfg.n_cropped, cfg.attn_mask_k, cfg.select_k, cfg.pair_k}")
    data = shapes_eval_set(sum(REQUESTS), num_points=N, partial=True)
    check(data["src"].shape == (sum(REQUESTS), 768, 3), f"cropped clouds {data['src'].shape}")
    requests = split_requests(data, REQUESTS)
    reg = Registrar(cfg, state_dict)
    plain = Registrar(cfg, state_dict, use_kernels=False)
    serve_all(reg, requests)  # warm-up
    add_launches(total, one_request_launches(reg, *requests[0], LAUNCHES_PARTIAL, "partial 768"))
    acc = accuracy(*serve_all(reg, requests), data)
    acc_plain = accuracy(*serve_all(plain, requests), data)
    print(f"partial 768: kernels {acc} plain {acc_plain} over {len(data['src'])} pairs", flush=True)
    print_latency(reg, requests, "partial 768")
    check(acc["rot_rmse_deg"] <= ROT_LIMIT_PARTIAL_DEG,
          f"partial 768: rot RMSE {acc['rot_rmse_deg']} deg > {ROT_LIMIT_PARTIAL_DEG}")
    check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 2.0,
          "partial 768: kernel vs plain rot RMSE differ by more than 2.0 deg")
    del reg, plain

    # --- (d) num_points 4093: 3072 points per cloud, 2353 keys kept: the
    # kernel route's re-mask streams; the same route with its threshold out
    # of reach writes the scores out
    cfg = Config(compute_dtype="bfloat16", iter=3, num_points=NUM_POINTS_LARGE, partial=True,
                 overlap=0.575)
    check((cfg.n_cropped, cfg.attn_mask_k, cfg.select_k, cfg.pair_k)
          == (N_LARGE, KEEP_LARGE, 1976, 787), "large partial sizes")
    data = shapes_eval_set(16, num_points=NUM_POINTS_LARGE, cloud_points=NUM_POINTS_LARGE + 3,
                           partial=True)
    requests = split_requests(data, (8, 8))

    def two_routes(weights):
        reg = Registrar(cfg, weights, buckets=(8,))
        written = Registrar(cfg, weights, buckets=(8,))
        written.model.pointer.dec_layers[0].src_attn.stream_above = 10 ** 9
        return reg, written

    def kept_keys(reg, request) -> list:
        """The keys each route keeps, on the activations the re-masked
        attention really sees: its (query, memory) inputs during one
        streaming request."""
        remasked = [m for m in reg.model.modules()
                    if isinstance(m, MultiHeadAttention) and m.remask]
        check(len(remasked) == 1, f"{len(remasked)} re-masked attention modules, expected 1")
        mha, seen, rows = remasked[0], [], []
        hook = mha.register_forward_hook(lambda mod, args, out: seen.append(args[:2]))
        reg.register(*request)
        hook.remove()
        check(len(seen) == 6, f"the re-masked attention ran {len(seen)} times, expected 6")
        with torch.inference_mode():
            for query, memory in seen:
                q = dense(mha.linear_q, query, mha.dtype)
                k = dense(mha.linear_k, memory, mha.dtype)
                streamed = softmax_colmass(q, k, 128 ** -0.5, 4).sum(1)
                masses = softmax_colmass_ref(q, k, 128 ** -0.5, 4).sum(1)  # scores written out
                keep_s = streamed.topk(KEEP_LARGE).indices
                keep_w = masses.topk(KEEP_LARGE).indices
                rows.append({
                    "kept_equal": set_agreement(keep_s, keep_w, N_LARGE),
                    "mass_min": masses.min().item(), "mass_max": masses.max().item(),
                    "masses_rel_err": rel_err(streamed, masses),
                })
                del masses
        return rows

    reg, written = two_routes(state_dict)
    serve_all(reg, requests[:1])  # warm-up
    add_launches(total, one_request_launches(reg, *requests[0], LAUNCHES_PARTIAL_LARGE,
                                             "partial 3072"))
    one_request_launches(written, *requests[0], dict(LAUNCHES_PARTIAL_LARGE, flash_packed=10,
                                                     softmax_colmass=0), "partial 3072 written-out")
    for row in kept_keys(reg, requests[1]):
        # the committed checkpoint's cross attention is uniform to rounding
        # (its scores are ~1e-5), so every key's mass is Nq * H / Nk = 4 and
        # their order is rounding noise in either route: printed, not held
        print(f"partial 3072: kept keys of the two routes on one call: {row}", flush=True)
    acc = accuracy(*serve_all(reg, requests), data)
    acc_written = accuracy(*serve_all(written, requests), data)
    plain = Registrar(cfg, state_dict, buckets=(8,), use_kernels=False)
    check(not plain.model.use_kernels, "routes not as asked")
    acc_plain = accuracy(*serve_all(plain, requests), data)
    del plain
    print(f"partial 3072: streaming {acc} written-out {acc_written} plain {acc_plain} "
          f"over {len(data['src'])} pairs", flush=True)
    print_latency(reg, requests[:1], "partial 3072 streaming")
    print_latency(written, requests[:1], "partial 3072 written-out")
    torch.cuda.reset_peak_memory_stats()
    reg.register(*requests[0])
    peak_stream = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    written.register(*requests[0])
    print(f"partial 3072: peak device memory of one request: streaming {peak_stream} B, "
          f"written-out {torch.cuda.max_memory_allocated()} B", flush=True)
    check(abs(acc["rot_rmse_deg"] - acc_written["rot_rmse_deg"]) <= 2.0,
          "partial 3072: streaming vs written-out rot RMSE differ by more than 2.0 deg")
    check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 2.0,
          "partial 3072: kernel vs plain rot RMSE differ by more than 2.0 deg")
    del reg, written

    # the same with the cross attention's query projection scaled up so that
    # its key masses spread (weights that are no trained model's: the two
    # routes are held against each other, not against the ground truth)
    sharp = dict(state_dict)
    for name in ("weight", "bias"):
        key = f"pointer.dec_layers.0.src_attn.linear_q.{name}"
        sharp[key] = state_dict[key] * SHARPEN_CROSS_ATTENTION
    reg, written = two_routes(sharp)
    rows = kept_keys(reg, requests[1])
    for row in rows:
        print(f"partial 3072 sharpened: kept keys of the two routes on one call: {row}",
              flush=True)
    check(min(r["mass_max"] / r["mass_min"] for r in rows) >= 1.5,
          "partial 3072 sharpened: the key masses do not spread")
    check(min(r["kept_equal"] for r in rows) >= KEPT_KEYS_AGREEMENT,
          f"partial 3072 sharpened: kept keys agree on less than {KEPT_KEYS_AGREEMENT}")
    between = pair_rot_errors_deg(serve_all(reg, requests)[0], serve_all(written, requests)[0])
    print(f"partial 3072 sharpened: rotation between the two routes' results, per pair: "
          f"median {float(np.median(between))} max {float(between.max())} deg", flush=True)
    check(float(np.median(between)) <= 2.0,
          "partial 3072 sharpened: the two routes' rotations differ by more than 2.0 deg (median)")
    return total


# ---------------------------------------------------------------------------
# the DGCNN / DCP family and the fused pointer
# ---------------------------------------------------------------------------

EDGE_FLOPS = 2 * (6 * 64 + 64 * 64 + 64 * 128 + 128 * 256)  # per edge, stages 1-4
# (N, B) at which the four kernels of this family are held and timed; the
# last entry is the one the kernels line reports
FAMILY_SHAPES = ((768, 64), (N, 8), (N, 64))


def param_bytes(*tensors) -> int:
    """Bytes of weights the kernels read as bf16 (matrices) and of biases as
    they are stored."""
    return sum(t.numel() * (2 if t.dim() == 2 else t.element_size()) for t in tensors)


def phase_family_kernels(dev):
    """knn, dgcnn_eval, fused_mha and fused_ff against their plain versions
    at B = 8 and 64, N = 1024, and at N = 768, full width (k = 20, emb 512, D
    512, 4 heads, F 1024). Tolerances: the selection of ``knn`` on f32 xyz
    equals ``knn_gather_max``'s bit for bit and agrees with the plain
    version's on >= 99.5% of the rows (f32 sums in another order at
    near-ties); on its general path (C = 64, bf16 and f32) it agrees on
    >= 99.5% of the rows with the plain version and, on bf16, with
    ``edge_conv``'s own selection (tensor-core sums in another order);
    ``dgcnn_eval`` within 2e-2 of the output's largest value (bf16
    roundings of four chained stages at f32 sums that differ in their last
    bits); ``fused_mha`` and ``fused_ff`` within 2^-6 of the output's
    largest value (two bf16 ulps: the output and one rounded intermediate).
    Then ``knn`` at N = 8192 and on its general path at N = 4096, and the
    refusals of what the kernels do not take, by the wrappers and by the
    DGCNN module on its kernel route."""
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.models.embeddings import DGCNN
    from vcrnet_tpu_torch.ops import _build, dgcnn, edgeconv, graph, knn, pointer

    ext = _build.extension()
    check(ext.dgcnn_eval_smem(K) == dgcnn.dgcnn_eval_smem_bytes(K),
          "dgcnn_eval: the wrapper's shared-memory formula is not the kernel's")
    check(ext.pointer_mha_smem(512) == pointer.pointer_mha_smem_bytes(512),
          "fused_mha: the wrapper's shared-memory formula is not the kernel's")
    check(ext.pointer_ff_smem(512, 1024) == pointer.pointer_ff_smem_bytes(512, 1024),
          "fused_ff: the wrapper's shared-memory formula is not the kernel's")

    g = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    bf16 = torch.bfloat16
    emb, D, H, FF = 512, 512, 4, 1024
    folded = [(randn(i, o, scale=i ** -0.5), randn(o, scale=0.1))
              for i, o in dgcnn.STAGE_WIDTHS + ((512, emb),)]
    mha_w = [t for _ in range(4) for t in (randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))]
    ff_w = (randn(D, FF, scale=D ** -0.5), randn(FF, scale=0.1),
            randn(FF, D, scale=FF ** -0.5), randn(D, scale=0.1))
    # the library's layout of the same sublayer: [out, in] weights, packed q/k/v
    wq, bq, wk, bk, wv, bv, wo, bo = (t.to(bf16) for t in mha_w)
    in_w = torch.cat([wq.t(), wk.t(), wv.t()]).contiguous()
    in_b = torch.cat([bq, bk, bv])
    out_w = wo.t().contiguous()

    rows = {}
    for n, B in FAMILY_SHAPES:
        # --- knn on f32 xyz: the selection of knn_gather_max, bit for bit
        x = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
        idx = knn.fused_knn(x, K)
        torch.cuda.synchronize()
        _, fused_idx = edgeconv.fused_knn_gather_max(x, randn(B, n, 8, dtype=bf16), K)
        check(torch.equal(idx, fused_idx), f"knn N={n} B={B}: differs from knn_gather_max's idx")
        agree = same_rows(idx, knn.fused_knn_ref(x, K))
        check(agree >= KNN_ROW_AGREEMENT, f"knn N={n} B={B}: rows agree {agree}")
        # the general path on bf16 features, C = 64: edge_conv's input
        xf = randn(B, n, 64, dtype=bf16)
        idx64 = knn.fused_knn(xf, K)
        a = randn(B, n, 128, scale=0.5, dtype=bf16)
        _, _, edge_idx = edgeconv.fused_edge_conv(xf, a, a, randn(128, 128, dtype=bf16),
                                                  randn(128, dtype=bf16), K)
        agree_edge = same_rows(idx64, edge_idx)
        check(agree_edge >= KNN_ROW_AGREEMENT,
              f"knn C=64 N={n} B={B}: rows agree with edge_conv's idx {agree_edge}")
        agree64 = same_rows(idx64, knn.fused_knn_ref(xf, K))
        check(agree64 >= KNN_ROW_AGREEMENT, f"knn C=64 N={n} B={B}: rows agree {agree64}")
        # and on f32 features
        xg = xf[:8].float().contiguous()
        agree_g = same_rows(knn.fused_knn(xg, K), knn.fused_knn_ref(xg, K))
        check(agree_g >= KNN_ROW_AGREEMENT, f"knn general N={n}: rows agree {agree_g}")
        b, by = bound_ms(nbytes(x, idx), B * n * n * (2 * 3 + 2), F32_FLOPS)
        rows.setdefault("knn", []).append(dict(
            B=B, N=n, rows_agree=agree, rows_agree_c64=agree64, rows_agree_edge_conv=agree_edge,
            rows_agree_general=agree_g, equals_knn_gather_max=True, max_abs_err=0.0, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: knn.fused_knn(x, K)),
            ms_c64=cuda_time_ms(lambda: knn.fused_knn(xf, K)),
            plain_ms=cuda_time_ms(lambda: knn.fused_knn_ref(x, K)), library_ms=None))

        # --- dgcnn_eval on that selection
        out = dgcnn.fused_dgcnn_eval(x, idx, folded, emb)
        torch.cuda.synchronize()
        want = dgcnn.fused_dgcnn_eval_ref(x, idx, folded, emb)
        err, rel = (out - want).abs().max().item(), rel_err(out, want)
        check(out.shape == (B, n, emb) and bool(torch.isfinite(out).all()), "dgcnn_eval output")
        check(rel <= 2e-2, f"dgcnn_eval N={n} B={B}: relative err {rel} > 2e-2")
        flops = B * n * (K * EDGE_FLOPS + 2 * 512 * emb)
        b, by = bound_ms(nbytes(x, idx, out) + param_bytes(*(t for p in folded for t in p)),
                         flops, BF16_TENSOR_FLOPS)
        rows.setdefault("dgcnn_eval", []).append(dict(
            B=B, N=n, max_abs_err=err, rel_err=rel, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: dgcnn.fused_dgcnn_eval(x, idx, folded, emb)),
            plain_ms=cuda_time_ms(lambda: dgcnn.fused_dgcnn_eval_ref(x, idx, folded, emb), reps=5),
            library_ms=None))
        del want, out

        # --- fused_mha: self attention and cross attention share the shapes
        yq, ykv = randn(B, n, D, dtype=bf16), randn(B, n, D, dtype=bf16)
        out = pointer.fused_mha(yq, ykv, *mha_w, H)
        torch.cuda.synchronize()
        want = pointer.fused_mha_ref(yq, ykv, *mha_w, H)
        err, rel = (out.float() - want.float()).abs().max().item(), rel_err(out, want)
        check(rel <= 2 ** -6, f"fused_mha N={n} B={B}: relative err {rel} > 2^-6")
        self_out = pointer.fused_mha(yq, yq, *mha_w, H)
        rel_self = rel_err(self_out, pointer.fused_mha_ref(yq, yq, *mha_w, H))
        check(rel_self <= 2 ** -6, f"fused_mha self N={n} B={B}: relative err {rel_self} > 2^-6")

        def library_mha():
            return F.multi_head_attention_forward(
                yq.transpose(0, 1), ykv.transpose(0, 1), ykv.transpose(0, 1), D, H, in_w, in_b,
                None, None, False, 0.0, out_w, bo, training=False, need_weights=False)[0]

        lib_rel = rel_err(library_mha().transpose(0, 1), want)
        check(lib_rel <= 5e-2, f"fused_mha N={n} B={B}: the library call is another function "
                               f"({lib_rel})")
        flops = B * (2 * n * D * D * 2 + 2 * n * D * D * 2 + 4 * n * n * D)
        b, by = bound_ms(nbytes(yq, ykv, out) + param_bytes(*mha_w), flops, BF16_TENSOR_FLOPS)
        rows.setdefault("fused_mha", []).append(dict(
            B=B, N=n, max_abs_err=err, rel_err=rel, rel_err_self=rel_self,
            library_rel_err=lib_rel, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: pointer.fused_mha(yq, ykv, *mha_w, H)),
            plain_ms=cuda_time_ms(lambda: pointer.fused_mha_ref(yq, ykv, *mha_w, H), reps=5),
            library_ms=cuda_time_ms(library_mha)))
        del want, out, self_out

        # --- fused_ff
        out = pointer.fused_ff(yq, *ff_w)
        torch.cuda.synchronize()
        want = pointer.fused_ff_ref(yq, *ff_w)
        err, rel = (out.float() - want.float()).abs().max().item(), rel_err(out, want)
        check(rel <= 2 ** -6, f"fused_ff N={n} B={B}: relative err {rel} > 2^-6")
        b, by = bound_ms(nbytes(yq, out) + param_bytes(*ff_w), 4 * B * n * D * FF,
                         BF16_TENSOR_FLOPS)
        rows.setdefault("fused_ff", []).append(dict(
            B=B, N=n, max_abs_err=err, rel_err=rel, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: pointer.fused_ff(yq, *ff_w)),
            plain_ms=cuda_time_ms(lambda: pointer.fused_ff_ref(yq, *ff_w)), library_ms=None))
        del want, out
    # knn beyond the shapes above: N = 8192 on xyz and N = 4096 on bf16
    # features (fewer queries per block, so that their score rows fit shared
    # memory)
    x = torch.rand(2, 8192, 3, generator=g, device=dev) * 2 - 1
    agree = same_rows(knn.fused_knn(x, K), knn.fused_knn_ref(x, K))
    xf = randn(2, 4096, 64, dtype=bf16)
    agree_bf = same_rows(knn.fused_knn(xf, K), knn.fused_knn_ref(xf, K))
    torch.cuda.synchronize()
    print(f"kernel knn large: rows agree {agree} at N=8192 (f32 xyz), {agree_bf} at N=4096 "
          f"(bf16, C=64)", flush=True)
    check(min(agree, agree_bf) >= KNN_ROW_AGREEMENT, "knn at large N: rows disagree")

    # on the card nothing gives way to the plain formulation: graph.knn's
    # "auto" launches the kernel on a ragged N too, a wrapper raises on what
    # its kernel does not take, and so does the DGCNN module on its kernel route
    ragged = x[:, :1001].contiguous()
    before = knn.fused_knn.launches
    agree = same_rows(graph.knn(ragged, K), knn.fused_knn_ref(ragged, K))
    check(knn.fused_knn.launches == before + 1, "graph.knn on the card did not launch the kernel")
    check(agree >= KNN_ROW_AGREEMENT, f"knn at N=1001: rows agree {agree}")
    module = DGCNN(emb, k=K, dtype=bf16).to(dev).eval()

    def module_on_ragged():
        with torch.no_grad():
            module(x[:, :1000].contiguous(), fused=True)

    idx = knn.fused_knn(x[:, :1024].contiguous(), K)
    refused = {
        "knn k > 32": lambda: knn.fused_knn(x, 33),
        "knn_gather_max F % 8": lambda: edgeconv.fused_knn_gather_max(
            x[:, :1024].contiguous(), randn(2, 1024, 12, dtype=bf16), K),
        "gather_max_bwd N > 7264": lambda: edgeconv.gather_max_bwd(
            idx.new_zeros(1, 8192, K), torch.zeros(1, 8192, 8, dtype=torch.uint8, device=dev),
            torch.zeros(1, 8192, 8, dtype=bf16, device=dev)),
        "DGCNN module, kernel route, N % 16": module_on_ragged,
        "dgcnn_eval N % 16": lambda: dgcnn.fused_dgcnn_eval(
            x[:, :1000].contiguous(), idx[:, :1000].contiguous(), folded, emb),
        "fused_mha dk = 64": lambda: pointer.fused_mha(yq, yq, *mha_w, 8),
        "fused_ff hidden tile": lambda: pointer.fused_ff(
            yq, randn(D, 2 * FF), randn(2 * FF), randn(2 * FF, D), randn(D)),
    }
    for what, call in refused.items():
        try:
            call()
        except ValueError:
            continue
        raise RuntimeError(f"{what}: the wrapper did not raise")
    print_rows(rows)
    return rows


# launches of one DCP training step on the DGCNN embedding: the two clouds
# are embedded one after the other through the plain formulation (BatchNorm
# on batch statistics), each behind one kNN launch; the pointer runs its 6
# attentions forward and backward; DCP's SVD head is plain PyTorch
DCP_TRAIN_LAUNCHES = {"knn": 2, "dgcnn_eval": 0, "flash_packed": 6, "flash_bwd": 6}
# its eval step: one pass, each cloud through the kNN and the fused eval chain
DCP_EVAL_LAUNCHES = {"knn": 2, "dgcnn_eval": 2, "flash_packed": 6}
# VCR-Net on DGCNN, 1-pair request: the target is embedded once (1 kNN, 1
# eval chain), the source once per iteration with its kNN cached after the
# first; attention and the head as in LAUNCHES_ITER3
DGCNN_SERVE_LAUNCHES = {1: {"knn": 2, "dgcnn_eval": 2, "flash_packed": 6, "vcp_stream": 1},
                        3: {"knn": 2, "dgcnn_eval": 4, "flash_packed": 16, "vcp_stream": 3}}
DGCNN_EMB_REL = 5e-2  # kernel vs plain embedding, of the largest value: the plain route rounds
# each conv output to bf16 before its BatchNorm, the fused chain rounds the folded weights instead
DGCNN_ROUTE_ROT_DEG = 0.5  # kernel vs plain route, median rotation between results per pair
DGCNN_ROUTE_TRANS = 0.01


def check_launches(launches: dict, expected: dict, what: str) -> None:
    """``launches`` equals ``expected``, with every kernel of the port that
    ``expected`` does not name at zero."""
    from vcrnet_tpu_torch import ops

    for name, n in {**dict.fromkeys(ops.KERNELS, 0), **expected}.items():
        check(launches[name] == n, f"{what}: {name} launched {launches[name]} times, expected {n}")


def timed_steps_ms(trainer, batch, reps: int = 5) -> list:
    import torch

    trainer.train_step(batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_dgcnn():
    """The DGCNN / DCP family at full width, bf16, N = 1024: a DCP Trainer
    on the DGCNN embedding takes 20 Adam steps on one synthetic batch (the
    loss falls; launches of one step; step time at B = 8 and at the largest of
    64 / 32 that fits the card), its eval step on the kernel route against the
    plain route on the trained running statistics, then VCR-Net on DGCNN served
    through Registrar with those weights at iter=1 and iter=3 (launches of a
    1-pair request, kernel route against plain route, latency)."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.train import Trainer

    cfg = Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N)
    check((cfg.emb_dims, cfg.ff_dims, cfg.n_heads, cfg.n_blocks, cfg.head, cfg.pointer,
           cfg.loss, cfg.cycle) == (512, 1024, 4, 1, "svd", "transformer", "point", False),
          "dgcnn phase must run DCP's default configuration")
    batch8 = _train_batch(cfg, 8, seed=1)
    tr = Trainer(cfg, seed=0)
    check(tr.model.use_kernels, "route not as asked")
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        sums = tr.train_step(batch8)
        losses.append((sums["loss"] / sums["count"]).item())
    print(f"dgcnn: DCP losses over {TRAIN_STEPS} Adam steps on one batch: {losses}", flush=True)
    check(all(math.isfinite(v) for v in losses), "dgcnn: non-finite loss in the Adam steps")
    check(losses[-1] < losses[0],
          f"dgcnn: loss after {TRAIN_STEPS} steps {losses[-1]} >= first {losses[0]}")
    stats = [(name, buf) for name, buf in tr.model.named_buffers() if "running_" in name]
    moved = min((buf - (1.0 if name.endswith("var") else 0.0)).abs().max().item()
                for name, buf in stats)
    check(len(stats) == 10 and moved > 1e-4, f"dgcnn: running statistics still at init ({moved})")

    total = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tr.train_step(batch8)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"dgcnn: launches of one DCP training step: {launches}", flush=True)
    check_launches(launches, DCP_TRAIN_LAUNCHES, "dgcnn train step")
    add_launches(total, launches)

    # eval on the trained statistics: kernel route against plain route
    plain = Trainer(cfg, seed=0, use_kernels=False)
    plain.model.load_state_dict(tr.model.state_dict())
    check(not plain.model.use_kernels, "route not as asked")
    b8 = tr.to_device(batch8)
    tr.model.eval()
    plain.model.eval()
    with torch.no_grad():
        emb_k, idx_k, _ = tr.model.emb_nn(b8["src"], fused=True)
        emb_p, idx_p, _ = plain.model.emb_nn(b8["src"], fused=False)
    emb_rel = rel_err(emb_k, emb_p)
    rows_agree = same_rows(idx_k, idx_p)
    print(f"dgcnn: embedding on the trained statistics, kernel vs plain route: relative err "
          f"{emb_rel}, kNN rows agree {rows_agree}, largest value {emb_p.abs().max().item()}",
          flush=True)
    check(emb_rel <= DGCNN_EMB_REL, f"dgcnn: kernel vs plain embedding {emb_rel} > {DGCNN_EMB_REL}")
    check(rows_agree >= KNN_ROW_AGREEMENT, f"dgcnn: kNN rows agree {rows_agree}")
    ops.reset_launch_counts()
    sums_k = tr.eval_step(batch8)
    launches = ops.launch_counts()
    print(f"dgcnn: launches of one DCP eval step: {launches}", flush=True)
    check_launches(launches, DCP_EVAL_LAUNCHES, "dgcnn eval step")
    add_launches(total, launches)
    sums_p = plain.eval_step(batch8)
    eval_k = {k: (v / sums_k["count"]).item() for k, v in sums_k.items() if k in ("loss", "r_se_ab")}
    eval_p = {k: (v / sums_p["count"]).item() for k, v in sums_p.items() if k in ("loss", "r_se_ab")}
    print(f"dgcnn: DCP eval step per pair: kernels {eval_k} plain {eval_p}", flush=True)
    check(all(math.isfinite(v) for v in eval_k.values()), "dgcnn: non-finite eval sums")
    check(abs(eval_k["loss"] - eval_p["loss"]) <= 0.05 * abs(eval_p["loss"]) + 1e-4,
          "dgcnn: DCP eval loss of the kernel route more than 5% from the plain route")

    timed_at = []
    for b in (8, 64, 32):
        try:
            batch = tr.to_device(_train_batch(cfg, b, seed=2))
            torch.cuda.reset_peak_memory_stats()
            times = timed_steps_ms(tr, batch)
        except torch.cuda.OutOfMemoryError:
            print(f"dgcnn: DCP train step at B={b} does not fit the card", flush=True)
            del batch
            tr.optimizer.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
            continue
        print(f"dgcnn: DCP train step at B={b}: median {statistics.median(times)} ms "
              f"(5 steps: {times}), peak device memory {torch.cuda.max_memory_allocated()} B",
              flush=True)
        timed_at.append(b)
        if b == 64:
            break
    check(max(timed_at, default=0) >= 32, f"dgcnn: no DCP step at B >= 32 was timed ({timed_at})")
    weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    del tr, plain, batch
    torch.cuda.empty_cache()

    # VCR-Net trains on the same DGCNN module: its head streams through the
    # soft-correspondence kernels (forward and backward) on the f32 embedding
    vtr = Trainer(Config(emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N), seed=0)
    first = vtr.train_step(batch8)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    second = vtr.train_step(batch8)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    v_losses = [(s["loss"] / s["count"]).item() for s in (first, second)]
    print(f"dgcnn: VCR-Net on DGCNN, two training steps: losses {v_losses}; launches of one "
          f"step: {launches}", flush=True)
    check(all(math.isfinite(v) for v in v_losses), "dgcnn: non-finite VCR-Net training loss")
    check_launches(launches, {**DCP_TRAIN_LAUNCHES, "vcp_stream": 1, "vcp_bwd": 1},
                   "dgcnn VCR-Net train step")
    add_launches(total, launches)
    del vtr
    torch.cuda.empty_cache()

    # VCR-Net on DGCNN with those weights (DCP's SVD head has no parameters)
    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    requests = split_requests(data, REQUESTS)
    for n_iter in (1, 3):
        scfg = Config(emb_nn="dgcnn", compute_dtype="bfloat16", iter=n_iter, num_points=N)
        reg = Registrar(scfg, weights)
        plain = Registrar(scfg, weights, use_kernels=False)
        check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
        serve_all(reg, requests)  # warm-up
        add_launches(total, one_request_launches(
            reg, *requests[0], DGCNN_SERVE_LAUNCHES[n_iter], f"dgcnn serve iter={n_iter}"))
        R, t = serve_all(reg, requests)
        R_p, t_p = serve_all(plain, requests)
        check(R.shape == (len(data["src"]), 3, 3), "dgcnn serve: bad result shapes")
        ortho = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
        between = pair_rot_errors_deg(R, R_p.astype(np.float64))
        dt = float(np.abs(t - t_p).max())
        print(f"dgcnn serve iter={n_iter}: rotation between the routes' results per pair: median "
              f"{float(np.median(between))} max {float(between.max())} deg; max |dt| {dt}; "
              f"|R R^T - I| {ortho}; vs ground truth (weights barely trained) "
              f"{accuracy(R, t, data)}", flush=True)
        check(ortho <= 1e-4, f"dgcnn serve: R not orthonormal ({ortho})")
        check(float(np.median(between)) <= DGCNN_ROUTE_ROT_DEG,
              f"dgcnn serve iter={n_iter}: routes differ by more than {DGCNN_ROUTE_ROT_DEG} deg "
              f"(median)")
        check(float(np.median(np.abs(t - t_p).max(axis=1))) <= DGCNN_ROUTE_TRANS,
              f"dgcnn serve iter={n_iter}: translations differ by more than {DGCNN_ROUTE_TRANS}")
        print_latency(reg, requests, f"dgcnn serve iter={n_iter}")
        print_latency(plain, requests[-1:], f"dgcnn serve iter={n_iter} plain route")
        del reg, plain
    return total


# the default VCR-Net with the fused pointer on: every attention that is not
# re-masked and every feed-forward is one fused launch, flash_packed none;
# the embedding and the head as on the default route
FUSED_LAUNCHES = {
    1: {"knn_gather_max": 2, "edge_conv": 2, "vcp_stream": 1, "fused_mha": 6, "fused_ff": 4},
    3: {"knn_gather_max": 2, "edge_conv": 4, "gather_max_from_idx": 2, "vcp_stream": 3,
        "fused_mha": 16, "fused_ff": 10},
}
FUSED_AGREEMENT_DEG = {1: 0.25, 3: 0.1}
# fused vs unfused result of the same pair: rotation between them (median and
# max over the pairs) and the largest translation difference
FUSED_PAIR_ROT_DEG = {"median": 0.05, "max": 0.5}
FUSED_PAIR_TRANS = 0.005


def phase_fused_pointer():
    """The default VCR-Net with the committed checkpoint and
    VCRNET_FUSED_POINTER=1 (set for this phase only): launches of a 1-pair
    request, rot RMSE over the 73 pairs against the unfused kernel route,
    the two routes' results pair by pair, latency beside the unfused
    route's."""
    import numpy as np

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    requests = split_requests(data, REQUESTS)
    total = {}
    check("VCRNET_FUSED_POINTER" not in os.environ, "VCRNET_FUSED_POINTER is set outside the phase")
    for n_iter in (1, 3):
        reg = Registrar(Config(compute_dtype="bfloat16", iter=n_iter, num_points=N), state_dict)
        check(reg.model.use_kernels, "route not as asked")
        serve_all(reg, requests)  # warm-up, unfused
        R_u, t_u = serve_all(reg, requests)
        acc_unfused = accuracy(R_u, t_u, data)
        print_latency(reg, requests, f"fused pointer iter={n_iter}: unfused route")
        os.environ["VCRNET_FUSED_POINTER"] = "1"
        try:
            serve_all(reg, requests)  # warm-up, fused
            add_launches(total, one_request_launches(
                reg, *requests[0], FUSED_LAUNCHES[n_iter], f"fused pointer iter={n_iter}"))
            R_f, t_f = serve_all(reg, requests)
            acc = accuracy(R_f, t_f, data)
            print_latency(reg, requests, f"fused pointer iter={n_iter}: fused route")
        finally:
            del os.environ["VCRNET_FUSED_POINTER"]
        print(f"fused pointer iter={n_iter}: fused {acc} unfused {acc_unfused} over "
              f"{len(data['src'])} pairs", flush=True)
        gap = abs(acc["rot_rmse_deg"] - acc_unfused["rot_rmse_deg"])
        check(gap <= FUSED_AGREEMENT_DEG[n_iter],
              f"fused pointer iter={n_iter}: rot RMSE {gap} deg from the unfused route")
        between = pair_rot_errors_deg(R_f, R_u.astype(np.float64))
        dt = float(np.abs(t_f - t_u).max())
        print(f"fused pointer iter={n_iter}: rotation between the fused and unfused results per "
              f"pair: median {float(np.median(between))} max {float(between.max())} deg; "
              f"max |dt| {dt}", flush=True)
        check(float(np.median(between)) <= FUSED_PAIR_ROT_DEG["median"]
              and float(between.max()) <= FUSED_PAIR_ROT_DEG["max"],
              f"fused pointer iter={n_iter}: a pair's fused and unfused rotations differ by "
              f"median {float(np.median(between))} max {float(between.max())} deg")
        check(dt <= FUSED_PAIR_TRANS,
              f"fused pointer iter={n_iter}: translations differ by {dt} > {FUSED_PAIR_TRANS}")
        # with the variable gone the same Registrar is back on the unfused kernels
        one_request_launches(reg, *requests[0], LAUNCHES_ITER3 if n_iter == 3 else LAUNCHES_ITER1,
                             f"fused pointer iter={n_iter}: variable unset")
    return total


# sources whose registers and spills the script prints (nvcc -Xptxas -v,
# started beside the extension's build); a spill fails the run
PTXAS_REPORTED = ("vcp_stream.cu", "vcp_bwd.cu", "edge_conv.cu", "edge_conv_from_idx.cu",
                  "edge_conv_bwd.cu", "knn_gather_max.cu", "knn.cu", "gather_max_from_idx.cu",
                  "gather_max_bwd.cu")
# template arguments of the kernels as ptxas names them, mangled
TEMPLATE_ARGS = {"IfE": "<float>", "I13__nv_bfloat16E": "<bf16>"}


def start_ptxas_reports() -> dict:
    from torch.utils.cpp_extension import CUDA_HOME

    from vcrnet_tpu_torch.ops import _build

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    return {src: subprocess.Popen(
        [nvcc, "-c", *_build.CUDA_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
         os.path.join(_build.CSRC_DIR, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in PTXAS_REPORTED}


def print_ptxas_reports(procs: dict) -> None:
    """One line a source: each kernel's registers and spill bytes (stores /
    loads), and how many wgmma fences ptxas added on its own (C7519: it
    could not prove a register safe while a product was in flight)."""
    for src, proc in procs.items():
        out, _ = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"nvcc -Xptxas -v {src} failed:\n{out}")
        kernels = re.findall(r"Compiling entry function '[^']*?\d+([a-z][a-z_]*_kernel)(I[^']*?E)?E"
                             r"[^']*'.*?(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                             r"Used (\d+) registers", out, re.S)
        # a template's arguments as they are mangled (ILi64ELb1E: <64, true>)
        report = "; ".join(
            f"{name}{TEMPLATE_ARGS.get(args) or args.replace('ILi', '<').replace('ELb', ',').rstrip('E')}"
            f"{'>' if args and args not in TEMPLATE_ARGS else ''} {regs} registers, "
            f"spills {st}/{ld} bytes" for name, args, st, ld, regs in kernels)
        print(f"ptxas {src}: {report}; added wgmma fences (C7519): {out.count('C7519')}",
              flush=True)
        spills = [int(n) for _, _, st, ld, _ in kernels for n in (st, ld)]
        check(kernels and not any(spills), f"{src}: the kernels spill registers ({spills} bytes)")


PHASES = ("kernels", "backward", "train", "serve", "refine", "partial", "dgcnn",
          "fused_pointer")


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

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    ptxas = start_ptxas_reports()
    _build.extension()
    print(f"build: {time.perf_counter() - t0} s", flush=True)
    print_ptxas_reports(ptxas)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    rows, launches = {}, {}
    for name in PHASES:
        t0 = time.perf_counter()
        if name == "kernels":
            rows.update(phase_kernels(dev))
            rows.update(phase_eval_kernels(dev))
            rows.update(phase_sn_kernels(dev))
            rows.update(phase_family_kernels(dev))
        elif name == "backward":
            rows.update(phase_backward(dev))
        elif name == "train":
            launches[name] = phase_train()[0]
        elif name == "serve":
            launches[name] = phase_serve()
        elif name == "refine":
            launches[name] = phase_refine()
        elif name == "partial":
            launches[name] = phase_partial()
        elif name == "dgcnn":
            launches[name] = phase_dgcnn()
        elif name == "fused_pointer":
            launches[name] = phase_fused_pointer()
        print(f"phase {name}: {time.perf_counter() - t0} s", flush=True)

    sources = {
        "knn_gather_max": ("vcrnet_tpu_torch/csrc/knn_gather_max.cu",
                           "vcrnet_tpu/ops/pallas_edgeconv.py:420"),
        "edge_conv": ("vcrnet_tpu_torch/csrc/edge_conv.cu",
                      "vcrnet_tpu/ops/pallas_edgeconv.py:324"),
        "flash_packed": ("vcrnet_tpu_torch/csrc/flash_packed.cu",
                         "vcrnet_tpu/ops/pallas_attention.py:239"),
        "vcp_stream": ("vcrnet_tpu_torch/csrc/vcp_stream.cu",
                       "vcrnet_tpu/ops/pallas_vcp.py:29"),
        "gather_max_bwd": ("vcrnet_tpu_torch/csrc/gather_max_bwd.cu",
                           "vcrnet_tpu/ops/pallas_edgeconv.py:714"),
        "edge_conv_bwd": ("vcrnet_tpu_torch/csrc/edge_conv_bwd.cu",
                          "vcrnet_tpu/ops/pallas_edgeconv.py:485"),
        "flash_bwd": ("vcrnet_tpu_torch/csrc/flash_bwd.cu",
                      "vcrnet_tpu/ops/pallas_attention.py:76"),
        "vcp_bwd": ("vcrnet_tpu_torch/csrc/vcp_bwd.cu",
                    "vcrnet_tpu/ops/pallas_vcp.py:174"),
        "gather_max_from_idx": ("vcrnet_tpu_torch/csrc/gather_max_from_idx.cu",
                                "vcrnet_tpu/ops/pallas_edgeconv.py:585"),
        "edge_conv_from_idx": ("vcrnet_tpu_torch/csrc/edge_conv_from_idx.cu",
                               "vcrnet_tpu/ops/pallas_edgeconv.py:620"),
        "softmax_colmass": ("vcrnet_tpu_torch/csrc/colmass.cu",
                            "vcrnet_tpu/ops/pallas_colmass.py:31"),
        "knn": ("vcrnet_tpu_torch/csrc/knn.cu", "vcrnet_tpu/ops/pallas_knn.py:31"),
        "dgcnn_eval": ("vcrnet_tpu_torch/csrc/dgcnn_eval.cu",
                       "vcrnet_tpu/ops/pallas_dgcnn.py:102"),
        "fused_mha": ("vcrnet_tpu_torch/csrc/pointer_mha.cu",
                      "vcrnet_tpu/ops/pallas_pointer.py:98"),
        "fused_ff": ("vcrnet_tpu_torch/csrc/pointer_ff.cu",
                     "vcrnet_tpu/ops/pallas_pointer.py:197"),
    }
    check(set(sources) == set(ops.KERNELS) and len(sources) == 15,
          "the kernels line must list every kernel of the port")
    kernels = []
    for name, (source, replaces) in sources.items():
        # the largest batch: B = 64 pairs (2B = 128 in the LPDNet blocks of the
        # training step; B = 8 at N = 3072 for the column masses)
        top = rows[name][-1]
        errs = [r["max_abs_err"] for r in rows[name]]
        errs += [r["max_abs_err"] for r in rows.get(name + "_path_shapes", ())]
        errs += [r["max_abs_err"] for r in rows.get(name + "_edge", ())]
        if name == "flash_packed":
            errs += [r["max_abs_err"] for r in rows["flash_packed_nk_valid"]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per_phase[name] for per_phase in launches.values()),
            "launches_train_step": launches["train"][name],
            "launches_serve": launches["serve"][name],
            "launches_refine": launches["refine"][name],
            "launches_partial": launches["partial"][name],
            "launches_dgcnn": launches["dgcnn"][name],
            "launches_fused_pointer": launches["fused_pointer"][name],
            "max_abs_err": max(errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        })
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on the main paths: {kernels}")
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
