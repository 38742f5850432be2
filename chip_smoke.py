#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vcrnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build   compile the port's CUDA extension from csrc/ (sm_90a) and print
           the build time, the registers and spills of the soft-correspondence,
           edge-conv, SN-block, attention forward, column-mass, fused
           attention, feed-forward, DGCNN eval and int8 kernels (nvcc -Xptxas -v;
           a spill fails) and the card's name and power limit;
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
7. ragged  cloud sizes that are no multiple of 64, through the kernels:
           the partial protocol at the CLI's default overlap 0.75 (1024 ->
           885 points, iter=3, the 73 pairs) within 2.0 deg of the plain
           route, a whole request at num_points = 1000 (iter=3) within
           0.1 deg of it, the launches of a 1-pair request of each, and the
           training step through the kernels at N = 1000 (B = 8 and 64) and
           N = 885 (B = 3), held as the train phase holds N = 1024;
8. fit     a full-width Trainer at N = 1000 fits two epochs with
           checkpoints and a metrics writer, a fresh one reloads model.1.pt
           bit for bit and resumes to epoch 2 within 1e-3 of an
           uninterrupted fit, the committed checkpoint read by
           train/checkpoint.py serves what utils/params.py's reader serves;
           save and load timed;
9. dgcnn   the DGCNN / DCP family: a DCP Trainer on the DGCNN embedding
           (bf16, full width) takes 20 Adam steps on one batch (the loss
           falls, the launches of one step, step time at B = 8 and 64), its
           eval step on the kernel route (kNN kernel, fused eval chain on the
           trained running statistics) against the plain route, then VCR-Net
           on DGCNN served with those weights at iter=1 and iter=3 (launches
           of a 1-pair request, kernel route against plain route, latency);
10. fused  the default VCR-Net with VCRNET_FUSED_POINTER=1 for this phase
   pointer only: launches of a 1-pair request at iter=1 and iter=3, rot RMSE
           over the 73 pairs against the unfused kernel route (0.25 / 0.1
           deg), the rotation between the two routes' results pair by pair
           (median <= 0.05, max <= 0.5 deg), latency beside the unfused
           route's;
11. data   the data path on the card's installation (no h5py there): the
           port's fixture writer writes velodyne frames and
           read_velodyne_bin reads them back (padding, truncation);
           make_datasets on ModelNet40 with an empty data directory gives the
           synthetic sets; where h5py imports, fake ModelNet40 and KITTI trees
           through make_loaders at N = 1024 (printed either way); a
           full-width Trainer at N = 1024 trains an epoch of 16 batches of 8
           through prefetch (staged host tensors pinned, batches on the card,
           the summary within 1e-3 of the same epoch fed directly, the
           launches of 16 steps; both epochs timed) and an epoch of
           2048-point raw clouds through train_epoch_raw (pairs drawn on the
           card; the launches of one raw step);
12. regularise  dropout 0.1 and remat at full width, N = 1024, B = 8: the
           exact launches of each step (dropout: no flash kernel for the
           pointer; remat: the forward kernels twice), the dropped share of
           the attention probabilities within 0.1 +- 0.005, masks that follow
           (seed, step), eval with a dropout config equal to eval without it;
           remat's gradient against the plain step's (cosine >= 0.9999, the
           largest relative difference within twice that of two plain
           passes), both peak memories printed, and a DCP/DGCNN remat step's
           running statistics within 1e-5 of a plain step's;
13. converge  make_loaders on the synthetic set (N = 256, B = 32, 1024
           training and 128 test pairs) and fit through prefetch at full
           width, bf16: VCR-Net 12 epochs, rot RMSE at iter=3 <= 1.0 deg and
           <= 1/5 of the untrained model's; DCP on DGCNN 15 epochs, <= 0.75 of
           the untrained model's, its kernel route within 0.5 deg (median per
           pair) and 0.01 of the plain route on the trained statistics; the
           exact launches of both fits;
14. partial_train  training in partial-overlap mode at full width, bf16:
           VCR-Net from the committed checkpoint at overlap 0.575 (768
           points), B = 8, kernels and plain route: a finite loss, every
           gradient exactly zero, the forward kernels alone launched; after 3
           steps the routes' parameters equal, no weight moved more than
           1.01 lr a step; after 20 steps the 73-pair partial protocol served
           beside the untouched checkpoint (printed); DCP on DGCNN at overlap
           0.575 and 0.75 from a seeded init: gradient cosine to the plain
           route >= 0.99, the loss falls over 20 Adam steps, the launches of
           a step, step time at B = 8 and 64;
15. icp     Trainer(model="icp").eval_epoch on the synthetic eval set (128
           pairs, N = 1024, B = 32): rot and trans RMSE, the iterations
           executed, one batch on the CPU within 1e-3 deg per pair (median);
           Registrar at iter=0 (net + ICP) on the committed checkpoint: the
           launches of a 1-pair request as iter=1's, within 0.25 deg of the
           plain route, latency for 1 / 8 / 64 pairs;
16. lpd     LPD pretraining at N = 1024 (LPDNet at the slope 0.2 through the
           edge kernels): gradient cosine to the plain route >= 0.99 at
           B = 8, the launches of a step, the loss falls over 20 Adam steps,
           step time at B = 16 and 32; a 2-epoch fit with checkpoints whose
           best embedding merges into a VCR-Net Trainer bit for bit, which
           then takes a step;
17. heads   the dist and att heads and LPDNet's T-Nets (phase_heads): with
           tfea every edge_conv launch is the f32 instance's and the DG-block
           rows of VCR-Net, DCP and LPD agree with the plain route's f32
           selection on >= 0.995;
18. cli     the port's CLI: an iter=3 eval of the checkpoint and a one-epoch
           fit (phase_cli);
19. export  Registrar.warmup over the seven buckets, the bucket-8 iter=3
           artifact (torch.export, the kernels as vcrnet_torch ops) bit for
           bit against the live Registrar here and in a fresh process without
           model code, every other forward op from an artifact with its
           launch table, and the op dispatcher's cost (phase_export);
20. int8    dynamic-int8 pointer projections (phase_int8): the int8_linear
           kernel against its plain version at 65536 x 512 x 512, 7080 rows,
           1024 x 1024, 64 x 64 and 576 x 320 with 1, 2 and 3 pairs (outputs,
           row scales and weight codes and scales equal, three runs of each
           call equal; one projection and q, k and v of one input timed
           beside torch._int_mm on the same codes and the bf16 F.linear); the
           checkpoint with int8_eval at iter=1, iter=3 and partial 768
           against the plain int8 route (section 2's limits), the gap to
           bf16 and the latencies in turns, launches with and without
           VCRNET_FUSED_POINTER; a training step bit-equal with and without
           the flag; a DCP-on-DGCNN eval and an exported bucket with int8;
           the FLOP meter's totals of a 64-pair request and a B = 64 step
           against launches (int8: projections) x formula, as a rate;
21. parallel data parallelism over torch.distributed on the one card
           (phase_parallel): two ranks on cuda:0 over Gloo (a FileStore),
           each on its half of a global batch, against one process on the
           whole batch: full-width VCR-Net and DCP on DGCNN (BatchNorm over
           the global batch), one SGD step each at B = 64 and 62 (padded to
           64, 2 rows at valid 0): gradient cosine >= 0.9999, parameters and
           running statistics after the step; an iter=3 eval epoch of the
           committed checkpoint and a DCP eval epoch against world 1; a
           one-rank NCCL group, one step each, held the same way; the
           Registrar over the mesh (cuda:0, cuda:0) on 64 pairs against the
           one-device Registrar. The ranks report their kernel launches.
           It shows that the code runs with real collectives and kernels,
           not a multi-GPU speed.
22. point_sharding  point-axis sharding (phase_point_sharding), the committed
           checkpoint at full width in f32, every rank a process on cuda:0:
           (a) two Gloo ranks of a 1-D point mesh: register_flagship_sp in
           whole mode at B = 2, N = 4096, R and t within 1e-3 of the single
           device's plain route (f32) and within 0.25 deg of its kernel route
           (bf16); partial mode at overlap 0.575 on 768-point clouds (the
           cross attention sharpened as in the partial phase) within 1e-3;
           register_whole_sp within 1e-3 of the identity-pointer model; the
           whole-mode gradient of the point loss (sp_value_and_grad) at
           cosine >= 0.9999 to the single device's, and the partial-mode
           backward finite with every gradient zero; (b) four Gloo ranks as
           make_mesh_2d(2, 2), the batch axis sharded: the same whole-mode
           forward and gradient; (c) a one-rank NCCL group: the same, equal
           to this process's mesh of itself within 1e-6; (d) at sizes the
           kernel route refuses, printed: a whole-mode forward at B = 1,
           N = 16384 on two ranks beside one process's plain route on the
           whole cloud (peak memory each), and a training step at B = 1,
           N = 8192 on two ranks (finite; peak memory a rank). The ranks'
           kernel launches (launches_sp) must be zero: the path is plain
           PyTorch, as the JAX package's is XLA.

The kernels phase also holds the four kernels of phases 9 and 10 (knn,
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
with NaN; and softmax_colmass at Nq != Nk (1024 and 3072 both ways), B = 1,
Nq = Nk = 128 and lengths whose last block of 128 keys holds 64 (each run
twice: the results must be equal), and fused_mha at B = 1 and 8 with
N = 768 and 1024, self and cross attention, and over 992 keys, each beside
the library call; and fused_ff at B = 1 over 992 and 1024 rows a cloud
and at the other widths its gate takes (D = 128 and 384, F up to 4096),
and dgcnn_eval at N = 784 (no whole tile of 64 queries), N = 5120 (a cloud
read from device memory), k = 1, 30, 32 and 40, B = 1 and 2, and on a cloud
of duplicate points. And every forward kernel of the served paths at
N = 885 and 1000 (edge_conv and vcp_stream also 707 and 971), B = 2 and 64,
against its plain version, with item 0's results unchanged when item 1's
inputs are drawn again (its last tiles reach into item 1's rows); and
edge_conv's f32 instance (an f32 kNN space at C = 64, LPDNet's after
t_net_fea) at B = 8 and 64 with N = 1024 and at B = 2 and 64 with N = 885
and 1000, without and with winners, edge_conv_from_idx on its idx and
edge_conv_bwd on its winners (also at 2B = 16 and 128 clouds of 1024); and
gather_max_from_idx, redesigned by channel slices, equal bit for bit
(winners too) to its plain version and to knn_gather_max at B = 64 with
N = 768, 885, 1024 and 3072, at N = 16384 (rows read from device memory),
on duplicate indices and tied values, at k = 1, 7 and 32 and F = 8 and
264. The backward phase also holds the three backward kernels of the
training step at N = 885 and 1000 (B = 1, 2 and 64; also 707, 971 and
Nq = 885 over Nk = 1000), flash_bwd and vcp_bwd equal from run to run at
every shape, item 0's gradients unchanged when item 1 is drawn again.

Each phase prints its seconds. The last lines are a JSON object with one entry per kernel
(sixteen; edge_conv's with its f32 instance's launches, time, plain time and bound
beside; the launches of each phase's main path beside the total, the ranks' of the
parallel phase as launches_parallel; the point_sharding phase prints its ranks' as
launches_sp, all zero), the card's
``nvidia-smi`` name and power limit, and the result object
``{"ok": true, "device": {...}}``. Needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
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


def f32_edge_conv_checked(xs, a, h, w2, b2, slope: float, what: str):
    """The edge kernel's f32 instance on an f32 kNN space xs (LPDNet's after
    t_net_fea), without and with winners: both launch the f32 instance; its
    rows agree with the plain version's f32 selection on >= KNN_ROW_AGREEMENT;
    on its own idx x1 and x1's winners equal the plain version's, x2 is
    within 2e-2 (one bf16 ulp below 4) and x2's winners agree on >= 0.99 (y
    sums in another order), as the bf16 instance is held; the forward with
    winners equals the one without. Returns (a row of figures, (idx, x2,
    win1, win2))."""
    import torch

    from vcrnet_tpu_torch.ops import edgeconv

    check(xs.dtype == torch.float32, f"{what}: the kNN space is {xs.dtype}, not f32")
    before = edgeconv.fused_edge_conv.launches_f32
    x1, x2, idx = edgeconv.fused_edge_conv(xs, a, h, w2, b2, K, slope)
    t1, t2, t_idx, win1, win2 = edgeconv.fused_edge_conv(xs, a, h, w2, b2, K, slope,
                                                         winners=True)
    torch.cuda.synchronize()
    check(edgeconv.fused_edge_conv.launches_f32 == before + 2,
          f"{what}: the f32 instance did not launch")
    ref_idx = edgeconv.fused_edge_conv_ref(xs, a, h, w2, b2, K, slope)[2]
    r1, r2, _, rw1, rw2 = edgeconv.fused_edge_conv_ref(xs, a, h, w2, b2, K, slope, idx=idx,
                                                       winners=True)
    agree = same_rows(idx, ref_idx)
    err = max((x1.float() - r1.float()).abs().max().item(),
              (x2.float() - r2.float()).abs().max().item())
    w2_agree = (win2 == rw2).float().mean().item()
    check(agree >= KNN_ROW_AGREEMENT, f"{what}: rows agree {agree}")
    check(torch.equal(x1, r1), f"{what}: x1 differs from the plain version on its idx")
    check(err <= 2e-2, f"{what}: max abs err {err} > 2e-2")
    check(torch.equal(t_idx, idx) and torch.equal(t1, x1) and torch.equal(t2, x2),
          f"{what}: the forward with winners differs from the one without")
    check(torch.equal(win1, rw1), f"{what}: x1 winners differ from plain")
    check(w2_agree >= 0.99, f"{what}: x2 winners agree on {w2_agree}")
    row = dict(B=xs.shape[0], N=xs.shape[1], rows_agree=agree, x2_winners_agree=w2_agree,
               max_abs_err=err)
    return row, (idx, x2, win1, win2)


def phase_kernels(dev):
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.ops import attention, edgeconv, knn, vcp

    g = torch.Generator(device=dev).manual_seed(0)
    g32 = torch.Generator(device=dev).manual_seed(10)

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

        # --- the same block on an f32 kNN space (LPDNet's after t_net_fea):
        # the f32 instance, its scores at the f32 rate, the edge phase at bf16
        # (its own generator: the other inputs stay those of earlier runs)
        xs = torch.randn(B, N, 64, generator=g32, device=dev)
        row, _ = f32_edge_conv_checked(xs, a, h, w2, b2, 0.0, f"edge_conv f32 B={B}")
        work = [(B * N * N * 2 * 64, F32_FLOPS), (B * N * K * 2 * 128 * 128, BF16_TENSOR_FLOPS)]
        b, by = bound_ms(nbytes(xs, a, h, w2, b2, x1, x2, idx), work)
        row.update(bound_ms=b, bound_by=by,
                   ms=cuda_time_ms(lambda: edgeconv.fused_edge_conv(xs, a, h, w2, b2, K)),
                   plain_ms=cuda_time_ms(lambda: edgeconv.fused_edge_conv_ref(xs, a, h, w2, b2, K)),
                   library_ms=None)
        rows.setdefault("edge_conv_f32", []).append(row)

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
# softmax_colmass at the edges of its tiling: (B, Nq, Nk)
COLMASS_EDGES = ((2, 1024, 3072), (2, 3072, 1024), (1, 3072, 3072), (2, 128, 128),
                 (2, 192, 320))
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
    g32 = torch.Generator(device=dev).manual_seed(12)  # the f32 spaces: g's draws stay as they were

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

        # the feature graph reused under t_net_fea: the f32 instance's idx
        xs = torch.randn(B, N, 64, generator=g32, device=dev)
        f1, f2, idx = edgeconv.fused_edge_conv(xs, a, h, w2, b2, K)
        x1, x2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)
        torch.cuda.synchronize()
        x2_rel = rel_err(x2, f2)
        check(torch.equal(x1, f1) and x2_rel <= 2 ** -7,
              f"edge_conv_from_idx B={B}: differs from the f32 instance on its idx (x2 {x2_rel})")
        r1, r2 = edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2)
        rows.setdefault("edge_conv_from_idx_f32", []).append(dict(
            B=B, x2_rel_vs_fused=x2_rel,
            max_abs_err=max((x1.float() - r1.float()).abs().max().item(),
                            (x2.float() - r2.float()).abs().max().item())))

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

    # the column masses at the edges of their tiling: Nq != Nk both ways, one
    # batch item, one key block of 128, and lengths whose last block of 128
    # holds 64 (the second warpgroup of that block owns nothing), with the
    # tolerance above and the two-runs check
    for B, nq, nk in COLMASS_EDGES:
        q, k = randn(B, nq, 512, dtype=bf16), randn(B, nk, 512, dtype=bf16)
        cm = colmass.softmax_colmass(q, k, scale, 4)
        torch.cuda.synchronize()
        want = colmass.softmax_colmass_ref(q, k, scale, 4)
        rel, err = rel_err(cm, want), (cm - want).abs().max().item()
        check(rel <= 1e-3, f"softmax_colmass B={B} Nq={nq} Nk={nk}: relative err {rel} > 1e-3")
        check(torch.equal(cm, colmass.softmax_colmass(q, k, scale, 4)),
              f"softmax_colmass B={B} Nq={nq} Nk={nk}: two runs differ")
        rows.setdefault("softmax_colmass_edge", []).append(dict(
            B=B, Nq=nq, Nk=nk, max_abs_err=err, rel_err=rel,
            ms=cuda_time_ms(lambda: colmass.softmax_colmass(q, k, scale, 4))))
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
    g32 = torch.Generator(device=dev).manual_seed(11)  # the f32 spaces: g's draws stay as they were

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

        # --- the same from the f32 instance's idx and winners (t_net_fea's space)
        xs = torch.randn(B2, N, 64, generator=g32, device=dev)
        row, (idx, x2, win1, win2) = f32_edge_conv_checked(xs, a, h, w2, b2, 0.0,
                                                           f"edge_conv f32 B={B2}")
        rows.setdefault("edge_conv_f32_winners", []).append(row)
        args = (idx, win1, win2, a, h, w2, x2, ct1, ct2)
        got = edgeconv.edge_conv_bwd(*args)
        torch.cuda.synchronize()
        want = edgeconv.edge_conv_bwd_ref(*args)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(errs[0] <= 2 ** -7 and max(errs[1:]) <= 1e-4,
              f"edge_conv_bwd f32 B={B2}: relative errors (da, dh, dW2, db2) {errs}")
        rows.setdefault("edge_conv_bwd_f32", []).append(dict(
            B=B2, rel_errs=errs,
            max_abs_err=max((gv - wv).abs().max().item() for gv, wv in zip(got, want))))

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
        check(all(torch.equal(a, b) for a, b in zip(
            got, attention.flash_bwd(q, k, v, o, lse, do, scale, 4))),
              f"flash_bwd B={B}: two runs differ")
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
        check(all(torch.equal(a, b) for a, b in zip(got, vcp.vcp_bwd(*vargs))),
              f"vcp_bwd B={B}: two runs differ")
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
        check(all(torch.equal(a, b) for a, b in zip(
            got, attention.flash_bwd(q, k, v, o, lse, do, scale, 4))),
              f"flash_bwd B={B} Nq={nq} Nk={nk}: two runs differ")
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
        check(all(torch.equal(a, b) for a, b in zip(got, vcp.vcp_bwd(*vargs))),
              f"vcp_bwd {what}: two runs differ")
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


# (B, N) of the backward kernels at cloud sizes that are no multiple of 64:
# the partial crop at the CLI's default overlap (885) and num_points = 1000
# at B = 1, 2 (item 0's last tiles border item 1's rows) and 64, the crops
# of overlaps 0.5 and 0.9 (707, 971) at B = 2; edge_conv_bwd at 885 and
# 1000 (B clouds; 885 and 2 * 885 rows leave a ragged last round of four,
# and 3 * 885 too)
RAGGED_BWD_SHAPES = tuple((b, n) for n in (885, 1000) for b in (1, 2, 64)) + ((2, 707), (2, 971))
RAGGED_EDGE_BWD_SHAPES = tuple((b, n) for n in (885, 1000) for b in (1, 2, 64)) + ((3, 885),)


def phase_ragged_backward(dev):
    """The three backward kernels of the training step at cloud sizes that
    are no multiple of 64 (RAGGED_BWD_SHAPES; attention and soft
    correspondence also at Nq = 885 over Nk = 1000), each against its plain
    version with the tolerances of phase_backward, flash_bwd and vcp_bwd
    equal from run to run, and at B = 2 with item 1's inputs drawn again:
    item 0's gradients must stay the same bit for bit (dh; da within 1e-6
    of its largest value, its sums land by atomics in a varying order).
    Times at B = 64, N = 885 and 1000."""
    import torch

    from vcrnet_tpu_torch.ops import attention, edgeconv, vcp

    g = torch.Generator(device=dev).manual_seed(6)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def redraw_item1(inputs):
        out = []
        for t in inputs:
            t = t.clone()
            if t.dtype == torch.int32:  # indices: a permutation of item 1's rows
                t[1] = t[1].flip(0)
            elif t.dtype == torch.uint8:  # winners: other k-positions
                t[1] = torch.randint(0, K, t[1].shape, generator=g, device=dev).to(t.dtype)
            else:
                t[1] = torch.randn(t[1].shape, generator=g, device=dev).to(t.dtype)
            out.append(t)
        return out

    bf16, scale = torch.bfloat16, 128 ** -0.5
    rows = {}

    def flash_grads(q, k, v, do):
        o, lse = attention.flash_mha_packed(q, k, v, scale, 4, return_lse=True)
        return o, lse, attention.flash_bwd(q, k, v, o, lse, do, scale, 4)

    def vcp_grads(se, te, tgt, dcorr):
        corr, lse = vcp.streaming_soft_correspondence(se, te, tgt, return_lse=True)
        return corr, lse, vcp.vcp_bwd(se, te, tgt, corr, lse, dcorr)

    for B, n in RAGGED_BWD_SHAPES + ((2, None),):
        nq, nk = (885, 1000) if n is None else (n, n)
        what = f"B={B} Nq={nq} Nk={nk}"
        # --- attention backward from the forward's output and logsumexp
        inputs = [randn(B, nq, 512, dtype=bf16), randn(B, nk, 512, dtype=bf16),
                  randn(B, nk, 512, dtype=bf16), randn(B, nq, 512, dtype=bf16)]
        o, lse, got = flash_grads(*inputs)
        torch.cuda.synchronize()
        q, k, v, do = inputs
        check(all(torch.equal(a, b) for a, b in zip(
            got, attention.flash_bwd(q, k, v, o, lse, do, scale, 4))),
              f"flash_bwd {what}: two runs differ")
        want = attention.flash_mha_packed_bwd_ref(q, k, v, o, lse, do, scale, 4)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"flash_bwd {what}: relative errors (dq, dk, dv) {errs}")
        row = dict(B=B, Nq=nq, Nk=nk, rel_errs=errs, equal_run_to_run=True,
                   max_abs_err=max((gv.float() - wv.float()).abs().max().item()
                                   for gv, wv in zip(got, want)))
        del want
        if B == 2:
            again = flash_grads(*redraw_item1(inputs))[2]
            check(all(torch.equal(a[0], b[0]) for a, b in zip(got, again)),
                  f"flash_bwd {what}: item 0 moved when item 1's rows changed")
        elif B == 64:
            row["ms"] = cuda_time_ms(lambda: attention.flash_bwd(q, k, v, o, lse, do, scale, 4))
        rows.setdefault("flash_bwd_ragged", []).append(row)
        del inputs, q, k, v, do, o, got

        # --- soft correspondence backward from the forward's corr and lse
        inputs = [randn(B, nq, 512, scale=512 ** -0.5, dtype=bf16),
                  randn(B, nk, 512, scale=512 ** -0.5, dtype=bf16),
                  torch.rand(B, nk, 3, generator=g, device=dev) * 2 - 1, randn(B, nq, 3)]
        corr, lse, got = vcp_grads(*inputs)
        torch.cuda.synchronize()
        se, te, tgt, dcorr = inputs
        vargs = (se, te, tgt, corr, lse, dcorr)
        check(all(torch.equal(a, b) for a, b in zip(got, vcp.vcp_bwd(*vargs))),
              f"vcp_bwd {what}: two runs differ")
        want = vcp.vcp_bwd_ref(*vargs)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(max(errs) <= 1e-2, f"vcp_bwd {what}: relative errors (de, df, dtgt) {errs}")
        row = dict(B=B, Ns=nq, Nt=nk, rel_errs=errs, equal_run_to_run=True,
                   max_abs_err=max((gv - wv).abs().max().item() for gv, wv in zip(got, want)))
        if B == 2:
            again = vcp_grads(*redraw_item1(inputs))[2]
            check(all(torch.equal(a[0], b[0]) for a, b in zip(got, again)),
                  f"vcp_bwd {what}: item 0 moved when item 1's rows changed")
        elif B == 64:
            row["ms"] = cuda_time_ms(lambda: vcp.vcp_bwd(*vargs))
        rows.setdefault("vcp_bwd_ragged", []).append(row)
        del inputs, vargs, got, want

    # --- the DG block's backward from the forward's idx and winners
    w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
    b2 = randn(128, scale=0.1, dtype=bf16)
    for B, n in RAGGED_EDGE_BWD_SHAPES:
        what = f"B={B} N={n}"
        xf = randn(B, n, 64, dtype=bf16)
        a = randn(B, n, 128, scale=0.5, dtype=bf16)
        h = randn(B, n, 128, scale=0.5, dtype=bf16)
        _, x2, idx, win1, win2 = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K, winners=True)
        ct1, ct2 = randn(B, n, 128, dtype=bf16), randn(B, n, 128, dtype=bf16)
        args = [idx, win1, win2, a, h, w2, x2, ct1, ct2]
        got = edgeconv.edge_conv_bwd(*args)
        torch.cuda.synchronize()
        want = edgeconv.edge_conv_bwd_ref(*args)
        errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
        check(errs[0] <= 2 ** -7 and max(errs[1:]) <= 1e-4,
              f"edge_conv_bwd {what}: relative errors (da, dh, dW2, db2) {errs}")
        row = dict(B=B, N=n, rows=B * n, rel_errs=errs,
                   max_abs_err=max((gv - wv).abs().max().item() for gv, wv in zip(got, want)))
        if B == 2:
            item1 = redraw_item1([idx, win1, win2, a, h, x2, ct1, ct2])
            again = edgeconv.edge_conv_bwd(*item1[:5], w2, *item1[5:])
            da_moved = rel_err(again[0][0], got[0][0])
            check(torch.equal(got[1][0], again[1][0]) and da_moved <= 1e-6,
                  f"edge_conv_bwd {what}: item 0 moved when item 1 changed (da {da_moved})")
            row["item0_da_moved"] = da_moved
        elif B == 64:
            row["ms"] = cuda_time_ms(lambda: edgeconv.edge_conv_bwd(*args))
        rows.setdefault("edge_conv_bwd_ragged", []).append(row)
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


def check_training(cfg, what: str, grad_batch: int, time_batches) -> tuple:
    """The training step of ``cfg`` (bf16, full width) from a seeded init on
    synthetic shape pairs: kernel-route vs plain-route gradients on one
    batch of ``grad_batch`` (cosine >= 0.99 whole, >= 0.98 per parameter
    but the four with a zero exact gradient), the launches of one step, 20
    Adam steps on one batch (the loss must fall), and the median step time
    at each of ``time_batches``. Returns (launches, step_ms)."""
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.train import Trainer

    batch = _train_batch(cfg, grad_batch, seed=1)
    kern = Trainer(cfg, seed=0)
    plain = Trainer(cfg, seed=0, use_kernels=False)
    check(kern.model.use_kernels and not plain.model.use_kernels, "routes not as asked")

    # gradients of the two routes on one batch, from the same init
    loss_k, _ = kern.compute_grads(batch)
    loss_p, _ = plain.compute_grads(batch)
    names, gk, gp = [], [], []
    for (name, pk), (_, pp) in zip(kern.model.named_parameters(), plain.model.named_parameters()):
        names.append(name)
        gk.append(pk.grad.reshape(-1))
        gp.append(pp.grad.reshape(-1))
    low = []
    for name, a, b in zip(names, gk, gp):
        leaf_cos = _cosine(a, b)
        print(f"{what} grad cosine {name}: {leaf_cos}", flush=True)
        if not name.endswith(ZERO_GRAD_LEAVES) and not leaf_cos >= LEAF_COSINE_MIN:
            low.append((name, leaf_cos))
    cos = _cosine(torch.cat(gk), torch.cat(gp))
    print(f"{what} loss at init: kernels {loss_k.item()} plain {loss_p.item()}; "
          f"whole-model grad cosine {cos}", flush=True)
    check(math.isfinite(loss_k.item()), f"{what}: non-finite training loss")
    check(cos >= GRAD_COSINE_MIN,
          f"{what}: kernel vs plain gradient cosine {cos} < {GRAD_COSINE_MIN}")
    check(not low, f"{what}: kernel vs plain gradient cosine below {LEAF_COSINE_MIN}: {low}")
    exempt = [n for n in names if n.endswith(ZERO_GRAD_LEAVES)]
    check(len(exempt) == 4, f"zero-gradient leaves {exempt}: expected 3 key biases + 1 shift")
    del plain

    # launches of one training step on the main path (after a warm-up step)
    kern.train_step(batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kern.train_step(batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"{what} launches in one step: {launches}", flush=True)
    check_launches(launches, TRAIN_LAUNCHES, f"{what} step")

    # Adam on one fixed batch: the loss must fall
    tr = Trainer(cfg, seed=0)
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        sums = tr.train_step(batch)
        losses.append((sums["loss"] / sums["count"]).item())
    print(f"{what} losses over {TRAIN_STEPS} Adam steps on one batch: {losses}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss in the Adam steps")
    check(losses[-1] < losses[0],
          f"{what}: loss after {TRAIN_STEPS} steps {losses[-1]} >= first {losses[0]}")

    step_ms = {}
    for b in time_batches:
        times = timed_steps_ms(tr, tr.to_device(_train_batch(cfg, b, seed=2)))
        step_ms[b] = statistics.median(times)
        print(f"{what} step at B={b}: median {step_ms[b]} ms (5 steps: {times})", flush=True)
    return launches, step_ms


def phase_train():
    """The training step at full width, bf16, N = 1024, from a seeded init
    on synthetic shape pairs (check_training): kernel-route vs plain-route
    gradients on one batch of 8, the launches of one step, 20 Adam steps on
    one batch, and the step time at B = 8 and 64."""
    from vcrnet_tpu_torch.config import Config

    cfg = Config(compute_dtype="bfloat16", num_points=N)
    check((cfg.emb_dims, cfg.ff_dims, cfg.n_heads, cfg.n_blocks, cfg.loss, cfg.cycle,
           cfg.dropout, cfg.streaming_vcp_train) == (512, 1024, 4, 1, "point", False, 0.0, True),
          "train phase must run the default configuration")
    return check_training(cfg, "train", 8, BATCHES)


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


OVERLAP_CLI = 0.75  # the default of Config.overlap and of the JAX CLI's --overlap
N_RAGGED = 1000       # a whole-cloud size that is no multiple of 64


def phase_ragged():
    """Cloud sizes that are no multiple of 64, through the kernels: the
    partial protocol at the CLI's default overlap 0.75 (1024 -> 885 points,
    iter=3, the 73 pairs), within 2.0 deg of the plain route; a whole
    request at num_points = 1000 (iter=3, 73 pairs), <= 1.0 deg and within
    0.1 deg of the plain route; launches of a 1-pair request of each; then
    the training step through the kernels (check_training) at N = 1000
    (gradients on a batch of 8, step times at B = 8 and 64) and at N = 885
    with B = 3, whose stacked 2B * N = 5310 query rows leave edge_conv_bwd a
    ragged last round of four."""
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    total = {}

    cfg = Config(compute_dtype="bfloat16", iter=3, num_points=N, partial=True,
                 overlap=OVERLAP_CLI)
    check(cfg.n_cropped == 885, f"partial at overlap {OVERLAP_CLI}: {cfg.n_cropped} points")
    data = shapes_eval_set(sum(REQUESTS), num_points=N, partial=True, overlap=OVERLAP_CLI)
    check(data["src"].shape == (sum(REQUESTS), 885, 3), f"cropped clouds {data['src'].shape}")
    requests = split_requests(data, REQUESTS)
    reg = Registrar(cfg, state_dict)
    plain = Registrar(cfg, state_dict, use_kernels=False)
    check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
    serve_all(reg, requests)  # warm-up
    add_launches(total, one_request_launches(reg, *requests[0], LAUNCHES_PARTIAL, "partial 885"))
    acc = accuracy(*serve_all(reg, requests), data)
    acc_plain = accuracy(*serve_all(plain, requests), data)
    print(f"partial 885: kernels {acc} plain {acc_plain} over {len(data['src'])} pairs",
          flush=True)
    print_latency(reg, requests, "partial 885")
    check(acc["rot_rmse_deg"] <= ROT_LIMIT_PARTIAL_DEG,
          f"partial 885: rot RMSE {acc['rot_rmse_deg']} deg > {ROT_LIMIT_PARTIAL_DEG}")
    check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 2.0,
          "partial 885: kernel vs plain rot RMSE differ by more than 2.0 deg")
    del reg, plain

    cfg = Config(compute_dtype="bfloat16", iter=3, num_points=N_RAGGED)
    data = shapes_eval_set(sum(REQUESTS), num_points=N_RAGGED)
    requests = split_requests(data, REQUESTS)
    reg = Registrar(cfg, state_dict)
    plain = Registrar(cfg, state_dict, use_kernels=False)
    serve_all(reg, requests)  # warm-up
    add_launches(total, one_request_launches(reg, *requests[0], LAUNCHES_ITER3,
                                             f"whole {N_RAGGED}"))
    acc = accuracy(*serve_all(reg, requests), data)
    acc_plain = accuracy(*serve_all(plain, requests), data)
    print(f"whole {N_RAGGED}: kernels {acc} plain {acc_plain} over {len(data['src'])} pairs",
          flush=True)
    print_latency(reg, requests, f"whole {N_RAGGED}")
    check(acc["rot_rmse_deg"] <= ROT_LIMIT_ITER3_DEG,
          f"whole {N_RAGGED}: rot RMSE {acc['rot_rmse_deg']} deg > {ROT_LIMIT_ITER3_DEG}")
    check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= 0.1,
          f"whole {N_RAGGED}: kernel vs plain rot RMSE differ by more than 0.1 deg")
    del reg, plain

    step_ms = {}
    for n, grad_batch, time_batches in ((N_RAGGED, 8, BATCHES), (885, 3, (3,))):
        cfg = Config(compute_dtype="bfloat16", num_points=n)
        launches, ms = check_training(cfg, f"train N={n}", grad_batch, time_batches)
        add_launches(total, launches)
        step_ms[n] = ms
    return total, step_ms


FIT_TRAIN_BATCHES = 4  # batches of 8 pairs an epoch
FIT_RESUME_REL = 1e-3     # resumed vs uninterrupted epoch-2 losses, relative


def phase_fit():
    """Checkpoints, resume and the rest of ``fit`` at full width, bf16,
    N = 1000 (a ragged size), through the kernels, on synthetic shape pairs
    (four batches of 8 an epoch, 16 test pairs):

    1. ``fit(epochs=2, checkpoint_dir, metrics_writer)`` writes
       model.best.pt, model.0.pt, model.1.pt and fit_state.json, and hands
       the writer the reference's 63 scalars an epoch; the MetricsWriter
       writes them to an event file where tensorboardX is installed (it is
       a no-op without it, as the JAX package's is);
    2. a fresh Trainer (another seed) loads model.1.pt: parameters, buffers,
       Adam's moments and the step equal bit for bit to the first trainer's;
       its ``fit(epochs=3)`` resumes at epoch 2 at the scheduler's rate;
    3. its epoch-2 losses within 1e-3 relative of an uninterrupted fit of
       three epochs from the first seed (not bit-equal: gather_max_bwd and
       edge_conv_bwd add in an order that changes from run to run);
    4. the committed checkpoint read by checkpoint.load_checkpoint into a
       Trainer serves the rotations that utils/params.py::load_checkpoint's
       state dict serves, bit for bit (iter=1, 8 pairs at N = 1024);
    5. the time of one save_checkpoint and one load_checkpoint."""
    import importlib.util
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset, shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train import checkpoint as ckpt
    from vcrnet_tpu_torch.utils import params
    from vcrnet_tpu_torch.utils.logging import MetricsWriter

    cfg = Config(compute_dtype="bfloat16", num_points=N_RAGGED)
    train = [_train_batch(cfg, 8, seed=20 + i) for i in range(FIT_TRAIN_BATCHES)]
    test = list(Loader(SyntheticDataset(cfg, "test", n_items=16, cloud_points=2 * N, seed=30,
                                        kind="shapes"), 8))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fit_", dir=os.path.join(HERE, "build"))
    logs, tags = [], []

    class Tee:  # hands each scalar to the MetricsWriter and keeps its tag
        def __init__(self, writer):
            self.writer = writer

        def scalar(self, tag, value, step):
            tags.append(tag)
            self.writer.scalar(tag, value, step)

    try:
        first = Trainer(cfg, seed=0)
        writer = MetricsWriter(tmp)
        h1 = first.fit(train, test, epochs=2, log=logs.append, checkpoint_dir=tmp,
                       metrics_writer=Tee(writer))
        writer.close()
        names = sorted(os.listdir(tmp))
        print(f"fit: files {names}; (epoch, lr, train loss, test loss_pose) "
              f"{[(h['epoch'], h['lr'], h['train']['loss'], h['test']['loss_pose']) for h in h1]}",
              flush=True)
        for name in ("model.best.pt", "model.0.pt", "model.1.pt", "fit_state.json"):
            check(name in names, f"fit: {name} not written")
        check(len(tags) == 2 * 63, f"fit: {len(tags)} scalars written, expected 126")
        tensorboard = importlib.util.find_spec("tensorboardX") is not None
        print(f"fit: tensorboardX installed: {tensorboard}", flush=True)
        check(not tensorboard or any(n.startswith("events.out.tfevents") for n in names),
              "fit: no event file")
        fit_state = ckpt.load_fit_state(tmp)
        check(fit_state["epoch"] == 1, f"fit: fit_state.json {fit_state}")

        resumed = Trainer(cfg, seed=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_checkpoint(os.path.join(tmp, "model.1.pt"), resumed)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        want, got = first.model.state_dict(), resumed.model.state_dict()
        check(list(want) == list(got) and all(torch.equal(want[k], got[k]) for k in want),
              "fit: the loaded parameters or buffers differ from the saved trainer's")
        opt_w, opt_g = first.optimizer.state_dict(), resumed.optimizer.state_dict()
        moments = [(i, k) for i, st in opt_w["state"].items() for k in st]
        check(bool(moments) and all(torch.equal(opt_w["state"][i][k], opt_g["state"][i][k])
                                    for i, k in moments),
              "fit: the loaded Adam state differs from the saved trainer's")
        check(resumed.step == first.step == 2 * FIT_TRAIN_BATCHES, f"fit: step {resumed.step}")
        h2 = resumed.fit(train, test, epochs=3, log=logs.append, checkpoint_dir=tmp)
        check([h["epoch"] for h in h2] == [2] and logs[-2] == "resumed fit state at epoch 2",
              f"fit: resumed at {[h['epoch'] for h in h2]}; log {logs}")
        check(h2[0]["lr"] == fit_state["lr"], f"fit: resumed lr {h2[0]['lr']} vs {fit_state}")

        whole = Trainer(cfg, seed=0).fit(train, test, epochs=3, log=logs.append)
        rel = {split: {k: abs(h2[0][split][k] - whole[2][split][k])
                       / max(abs(whole[2][split][k]), 1e-12)
                       for k in ("loss", "loss_pose")} for split in ("train", "test")}
        print(f"fit: epoch 2 losses resumed "
              f"{[h2[0][sp][k] for sp in ('train', 'test') for k in ('loss', 'loss_pose')]} "
              f"uninterrupted "
              f"{[whole[2][sp][k] for sp in ('train', 'test') for k in ('loss', 'loss_pose')]}; "
              f"relative {rel}", flush=True)
        check(max(v for d in rel.values() for v in d.values()) <= FIT_RESUME_REL,
              f"fit: resumed epoch 2 differs from the uninterrupted fit by {rel}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(tmp, "timed", resumed)
        save_ms = (time.perf_counter() - t0) * 1e3
        size_mb = os.path.getsize(os.path.join(tmp, "timed.pt")) / 2 ** 20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    serve_cfg = Config(compute_dtype="bfloat16", num_points=N)
    data = shapes_eval_set(8, num_points=N)
    template = ckpt.load_checkpoint(CHECKPOINT, Trainer(serve_cfg, seed=9))
    R_new = Registrar(serve_cfg, template.model.state_dict()).register(data["src"], data["tgt"])
    R_old = Registrar(serve_cfg, params.load_checkpoint(CHECKPOINT)).register(data["src"],
                                                                              data["tgt"])
    check(np.array_equal(R_new["R"], R_old["R"]) and np.array_equal(R_new["t"], R_old["t"]),
          "fit: the committed checkpoint serves otherwise through checkpoint.load_checkpoint")
    print(f"fit: save_checkpoint {save_ms} ms, load_checkpoint {load_ms} ms "
          f"({size_mb} MiB, full width); the committed checkpoint serves the same rotations "
          "through both readers", flush=True)
    return dict(save_ms=save_ms, load_ms=load_ms, size_mb=size_mb)


# ---------------------------------------------------------------------------
# the DGCNN / DCP family and the fused pointer
# ---------------------------------------------------------------------------

EDGE_FLOPS = 2 * (6 * 64 + 64 * 64 + 64 * 128 + 128 * 256)  # per edge, stages 1-4
# (N, B) at which the four kernels of this family are held and timed; the
# last entry is the one the kernels line reports
FAMILY_SHAPES = ((768, 64), (N, 8), (N, 64))
# fused_mha beyond them: (Nq, Nk, B)
MHA_EDGES = ((768, 768, 1), (768, 768, 8), (N, N, 1), (N, 992, 8))
# fused_ff beyond them: (B, N, D, F), rows not in 128s and every width the gate
# takes the largest of
FF_EDGES = ((1, 992, 512, 1024), (1, N, 512, 1024), (1, N, 512, 2048), (2, N, 512, 4096),
            (1, N, 128, 256), (1, 768, 384, 2048))
# dgcnn_eval beyond them: (B, N, k, duplicate points); N = 784 has no whole
# tile of 64 queries, N = 5120 is a cloud the edge kernel reads from device
# memory (it stages clouds up to 4096 points), k = 40 is past the kNN
# kernel's 32 (the plain selection gives its idx)
DGCNN_EDGES = ((1, 784, K, False), (1, N, 1, False), (1, N, 30, False), (1, N, 32, False),
               (2, N, 40, False), (1, 5120, K, False), (2, N, K, True))


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
    check(ext.dgcnn_eval_smem() == dgcnn.dgcnn_eval_smem_bytes(),
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
        # no single PyTorch call computes the sublayer; the library's
        # sequence of three (bf16 products by cuBLAS) is timed beside it
        ff_lib = (ff_w[0].to(bf16).t().contiguous(), ff_w[1].to(bf16),
                  ff_w[2].to(bf16).t().contiguous(), ff_w[3].to(bf16))

        def library_ff():
            return F.linear(torch.relu(F.linear(yq, ff_lib[0], ff_lib[1])), ff_lib[2], ff_lib[3])

        lib_rel = rel_err(library_ff(), want)
        check(lib_rel <= 5e-2, f"fused_ff N={n} B={B}: the library sequence is another function "
                               f"({lib_rel})")
        rows.setdefault("fused_ff", []).append(dict(
            B=B, N=n, max_abs_err=err, rel_err=rel, bound_ms=b, bound_by=by,
            ms=cuda_time_ms(lambda: pointer.fused_ff(yq, *ff_w)),
            plain_ms=cuda_time_ms(lambda: pointer.fused_ff_ref(yq, *ff_w)), library_ms=None,
            library_seq_ms=cuda_time_ms(library_ff), library_seq_rel_err=lib_rel))
        del want, out
    # fused_mha at the other batches and lengths of the served paths, self and
    # cross attention, beside the library call; cross attention also over
    # keys in 32s (the attention's last 64-key tile reaches into the next
    # batch item's keys, which are masked out)
    for nq, nk, B in MHA_EDGES:
        yq, ykv = randn(B, nq, D, dtype=bf16), randn(B, nk, D, dtype=bf16)
        for kind, kv in (("cross", ykv), ("self", yq)):
            if kind == "self" and nq != nk:
                continue
            out = pointer.fused_mha(yq, kv, *mha_w, H)
            torch.cuda.synchronize()
            want = pointer.fused_mha_ref(yq, kv, *mha_w, H)
            err, rel = (out.float() - want.float()).abs().max().item(), rel_err(out, want)
            check(rel <= 2 ** -6,
                  f"fused_mha {kind} Nq={nq} Nk={nk} B={B}: relative err {rel} > 2^-6")

            def library_mha(yq=yq, kv=kv):
                return F.multi_head_attention_forward(
                    yq.transpose(0, 1), kv.transpose(0, 1), kv.transpose(0, 1), D, H, in_w,
                    in_b, None, None, False, 0.0, out_w, bo, training=False,
                    need_weights=False)[0]

            rows.setdefault("fused_mha_edge", []).append(dict(
                B=B, Nq=nq, Nk=nk, kind=kind, max_abs_err=err, rel_err=rel,
                ms=cuda_time_ms(lambda: pointer.fused_mha(yq, kv, *mha_w, H)),
                library_ms=cuda_time_ms(library_mha)))
            del want, out

    # fused_ff at rows not in 128s, B = 1 and the widths its gate takes
    for B, n, d, f in FF_EDGES:
        y = randn(B, n, d, dtype=bf16)
        w = (randn(d, f, scale=d ** -0.5), randn(f, scale=0.1), randn(f, d, scale=f ** -0.5),
             randn(d, scale=0.1))
        out = pointer.fused_ff(y, *w)
        torch.cuda.synchronize()
        want = pointer.fused_ff_ref(y, *w)
        err, rel = (out.float() - want.float()).abs().max().item(), rel_err(out, want)
        check(out.shape == (B, n, d) and bool(torch.isfinite(out.float()).all()),
              f"fused_ff B={B} N={n} D={d} F={f} output")
        check(rel <= 2 ** -6, f"fused_ff B={B} N={n} D={d} F={f}: relative err {rel} > 2^-6")
        rows.setdefault("fused_ff_edge", []).append(dict(
            B=B, N=n, D=d, F=f, max_abs_err=err, rel_err=rel,
            ms=cuda_time_ms(lambda: pointer.fused_ff(y, *w))))
        del want, out
    # dgcnn_eval at a ragged N, a cloud past the staged size, k from 1 to 40,
    # B = 1 and on duplicate points (64 distinct points, each 16 times)
    for B, n, k, dup in DGCNN_EDGES:
        x = torch.rand(B, 64 if dup else n, 3, generator=g, device=dev) * 2 - 1
        if dup:
            x = x.repeat(1, n // 64, 1)
        idx = knn.fused_knn(x, k) if k <= 32 else knn.fused_knn_ref(x, k)
        out = dgcnn.fused_dgcnn_eval(x, idx, folded, emb)
        torch.cuda.synchronize()
        want = dgcnn.fused_dgcnn_eval_ref(x, idx, folded, emb)
        err, rel = (out - want).abs().max().item(), rel_err(out, want)
        check(out.shape == (B, n, emb) and bool(torch.isfinite(out).all()),
              f"dgcnn_eval B={B} N={n} k={k} output")
        check(rel <= 2e-2, f"dgcnn_eval B={B} N={n} k={k} dup={dup}: relative err {rel} > 2e-2")
        rows.setdefault("dgcnn_eval_edge", []).append(dict(
            B=B, N=n, k=k, duplicates=dup, max_abs_err=err, rel_err=rel,
            ms=cuda_time_ms(lambda: dgcnn.fused_dgcnn_eval(x, idx, folded, emb))))
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
    module = DGCNN(500, k=K, dtype=bf16).to(dev).eval()

    def module_on_refused():
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
        "DGCNN module, kernel route, emb % 128": module_on_refused,
        "dgcnn_eval emb % 128": lambda: dgcnn.fused_dgcnn_eval(
            x[:, :1000].contiguous(), idx[:, :1000].contiguous(), folded, 500),
        "fused_mha dk = 64": lambda: pointer.fused_mha(yq, yq, *mha_w, 8),
        "fused_ff F > 4096": lambda: pointer.fused_ff(
            yq, randn(D, 8 * FF), randn(8 * FF), randn(8 * FF, D), randn(D)),
        "fused_ff D > 512": lambda: pointer.fused_ff(
            randn(1, 64, 2 * D, dtype=bf16), randn(2 * D, FF), randn(FF), randn(FF, 2 * D),
            randn(2 * D)),
        "dgcnn_eval k = N": lambda: dgcnn.fused_dgcnn_eval(
            x[:1, :32].contiguous(), idx[:1, :32, :1].expand(1, 32, 32).contiguous(), folded,
            emb),
    }
    for what, call in refused.items():
        try:
            call()
        except ValueError:
            continue
        raise RuntimeError(f"{what}: the wrapper did not raise")
    print_rows(rows)
    return rows


# (B, N) of the ragged-cloud checks: the partial crop at the CLI's default
# overlap (0.75 of 1024: 885 points) and num_points = 1000, each at B = 2
# (item 0's last tiles border item 1's rows) and B = 64; edge_conv and
# vcp_stream also at the crops of overlaps 0.5 and 0.9 (707, 971)
RAGGED_SHAPES = ((2, 885), (64, 885), (2, 1000), (64, 1000))
RAGGED_EXTRA = ((2, 707), (2, 971))
# gather_max_from_idx: (B, N) held bit for bit at B = 64 over the slice
# widths (N = 1024, 768 and 885: 64 channels; 3072: 32), and a cloud
# beyond the slices (rows from device memory)
GATHER_SHAPES = ((64, 1024), (64, 768), (64, 885), (64, 3072), (8, 3072), (1, 16384))


def phase_ragged_kernels(dev):
    """Every forward kernel of the served paths at cloud sizes that are no
    multiple of 64 (885, 1000; edge_conv and vcp_stream also 707 and 971),
    against its plain version with the tolerances of the kernels phase, and
    at B = 2 with item 1's inputs changed: item 0's results must stay the
    same bit for bit (its last tiles reach into item 1's rows, which are
    masked or not written). Times at B = 64."""
    import torch

    from vcrnet_tpu_torch.ops import attention, colmass, dgcnn, edgeconv, knn, pointer, vcp

    g = torch.Generator(device=dev).manual_seed(5)
    g32 = torch.Generator(device=dev).manual_seed(15)  # the f32 instance's: g's draws stay

    def randn(*shape, scale=1.0, dtype=torch.float32, gen=None):
        gen = g if gen is None else gen
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def item0_unchanged(fn, inputs, what, gen=None):
        """fn(*inputs) -> tuple of tensors; item 1 of every input is drawn
        again (from ``gen``, default g) and item 0 of every output must not
        move."""
        before = [t[0].clone() for t in fn(*inputs)]
        again = []
        for t in inputs:
            t = t.clone()
            if t.dtype == torch.int32:  # indices: a permutation of item 1's
                t[1] = t[1].flip(0)
            else:
                t[1] = torch.randn(t[1].shape, generator=g if gen is None else gen,
                                   device=dev).to(t.dtype)
            again.append(t)
        after = fn(*again)
        check(all(torch.equal(x, y[0]) for x, y in zip(before, after)),
              f"{what}: item 0 moved when item 1's rows changed")

    bf16, scale = torch.bfloat16, 128 ** -0.5
    w2 = randn(128, 128, scale=128 ** -0.5, dtype=bf16)
    b2 = randn(128, scale=0.1, dtype=bf16)
    emb, D, H = 512, 512, 4
    folded = [(randn(i, o, scale=i ** -0.5), randn(o, scale=0.1))
              for i, o in dgcnn.STAGE_WIDTHS + ((512, emb),)]
    mha_w = [t for _ in range(4) for t in (randn(D, D, scale=D ** -0.5), randn(D, scale=0.1))]
    rows = {}
    for B, n in RAGGED_SHAPES + RAGGED_EXTRA:
        extra = (B, n) in RAGGED_EXTRA
        # --- the DG block: edge_conv (with and without winners), then
        # edge_conv_from_idx on its selection
        xf = randn(B, n, 64, dtype=bf16)
        a = randn(B, n, 128, scale=0.5, dtype=bf16)
        h = randn(B, n, 128, scale=0.5, dtype=bf16)
        x1, x2, idx = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K)
        torch.cuda.synchronize()
        agree = same_rows(idx, edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K)[2])
        r1, r2, _ = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, idx=idx)
        err = max((x1.float() - r1.float()).abs().max().item(),
                  (x2.float() - r2.float()).abs().max().item())
        check(agree >= KNN_ROW_AGREEMENT, f"edge_conv B={B} N={n}: rows agree {agree}")
        check(err <= 2e-2, f"edge_conv B={B} N={n}: max abs err {err} > 2e-2")
        check(int(idx.min()) >= 0 and int(idx.max()) < n, f"edge_conv B={B} N={n}: idx past N")
        row = dict(B=B, N=n, rows_agree=agree, max_abs_err=err)
        if B == 2:
            w1_, w2_ = edgeconv.fused_edge_conv(xf, a, h, w2, b2, K, winners=True)[3:]
            _, _, _, rw1, rw2 = edgeconv.fused_edge_conv_ref(xf, a, h, w2, b2, K, idx=idx,
                                                             winners=True)
            check(torch.equal(w1_, rw1) and torch.equal(w2_, rw2),
                  f"edge_conv B={B} N={n}: winners differ from the plain version")
            item0_unchanged(lambda *t: edgeconv.fused_edge_conv(*t, w2, b2, K), (xf, a, h),
                            f"edge_conv N={n}")
        else:
            row["ms"] = cuda_time_ms(lambda: edgeconv.fused_edge_conv(xf, a, h, w2, b2, K))
        rows.setdefault("edge_conv_ragged", []).append(row)

        if not extra:  # the f32 instance (t_net_fea's space), then the backward on its winners
            xs = randn(B, n, 64, gen=g32)
            what = f"edge_conv f32 B={B} N={n}"
            row, (idx_s, x2_s, win1, win2) = f32_edge_conv_checked(xs, a, h, w2, b2, 0.0, what)
            check(int(idx_s.min()) >= 0 and int(idx_s.max()) < n, f"{what}: idx past N")
            ct1, ct2 = (randn(B, n, 128, dtype=bf16, gen=g32) for _ in range(2))
            args = (idx_s, win1, win2, a, h, w2, x2_s, ct1, ct2)
            got = edgeconv.edge_conv_bwd(*args)
            torch.cuda.synchronize()
            errs = [rel_err(gv, wv) for gv, wv in zip(got, edgeconv.edge_conv_bwd_ref(*args))]
            check(errs[0] <= 2 ** -7 and max(errs[1:]) <= 1e-4,
                  f"edge_conv_bwd {what}: relative errors (da, dh, dW2, db2) {errs}")
            row["bwd_rel_errs"] = errs
            if B == 2:
                item0_unchanged(lambda *t: edgeconv.fused_edge_conv(*t, w2, b2, K), (xs, a, h),
                                what, gen=g32)
            else:
                row["ms"] = cuda_time_ms(lambda: edgeconv.fused_edge_conv(xs, a, h, w2, b2, K))
            rows.setdefault("edge_conv_f32_ragged", []).append(row)

        # --- soft correspondence (forward with lse)
        se = randn(B, n, 512, scale=512 ** -0.5, dtype=bf16)
        te = randn(B, n + 5 if extra else n, 512, scale=512 ** -0.5, dtype=bf16)
        tgt = torch.rand(B, te.shape[1], 3, generator=g, device=dev) * 2 - 1
        c, lse = vcp.streaming_soft_correspondence(se, te, tgt, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = vcp.streaming_soft_correspondence_ref(se, te, tgt, return_lse=True)
        err = (c - want).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        check(err <= 1e-3 and lse_err <= 1e-3,
              f"vcp_stream B={B} Ns={n} Nt={te.shape[1]}: max abs err {err}, lse {lse_err}")
        check(torch.equal(c, vcp.streaming_soft_correspondence(se, te, tgt)),
              f"vcp_stream B={B} Ns={n}: two runs differ")
        row = dict(B=B, N=n, Nt=te.shape[1], max_abs_err=err, lse_err=lse_err)
        if B == 2:
            item0_unchanged(lambda *t: vcp.streaming_soft_correspondence(*t, return_lse=True),
                            (se, te, tgt), f"vcp_stream N={n}")
        else:
            row["ms"] = cuda_time_ms(lambda: vcp.streaming_soft_correspondence(se, te, tgt))
        rows.setdefault("vcp_stream_ragged", []).append(row)
        if extra:
            continue

        r1, r2 = edgeconv.edge_conv_from_idx(idx, a, h, w2, b2)
        torch.cuda.synchronize()
        p1, p2 = edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2)
        err = max((r1.float() - p1.float()).abs().max().item(),
                  (r2.float() - p2.float()).abs().max().item())
        x2_rel = rel_err(r2, x2)
        check(err <= 2e-2, f"edge_conv_from_idx B={B} N={n}: max abs err {err} > 2e-2")
        check(torch.equal(r1, x1) and x2_rel <= 2 ** -7,
              f"edge_conv_from_idx B={B} N={n}: differs from edge_conv on its idx ({x2_rel})")
        row = dict(B=B, N=n, max_abs_err=err, x2_rel_vs_fused=x2_rel)
        if B == 64:
            row["ms"] = cuda_time_ms(lambda: edgeconv.edge_conv_from_idx(idx, a, h, w2, b2))
        rows.setdefault("edge_conv_from_idx_ragged", []).append(row)

        # --- the SN block and the kNN kernel, which take any N
        x = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
        values = randn(B, n, 256, dtype=bf16)
        fused_out, xyz_idx = edgeconv.fused_knn_gather_max(x, values, K)
        torch.cuda.synchronize()
        check(torch.equal(knn.fused_knn(x, K), xyz_idx), f"knn N={n}: differs from knn_gather_max")
        check(torch.equal(fused_out, edgeconv.gather_max_from_idx_ref(xyz_idx, values)),
              f"knn_gather_max B={B} N={n}: gather-max not exact")
        agree = same_rows(xyz_idx, edgeconv.fused_knn_gather_max_ref(x, values, K)[1])
        check(agree >= KNN_ROW_AGREEMENT, f"knn_gather_max B={B} N={n}: rows agree {agree}")
        rows.setdefault("knn_gather_max_ragged", []).append(dict(
            B=B, N=n, rows_agree=agree, max_abs_err=0.0, equals_knn=True))

        # --- packed-head attention (output and lse), self lengths
        q, k, v = (randn(B, n, 512, dtype=bf16) for _ in range(3))
        o, lse = attention.flash_mha_packed(q, k, v, scale, 4, return_lse=True)
        torch.cuda.synchronize()
        want, want_lse = attention.flash_mha_packed_ref(q, k, v, scale, 4, return_lse=True)
        err = (o.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        check(err <= 2e-2 and lse_err <= 1e-3,
              f"flash_packed B={B} N={n}: max abs err {err}, lse {lse_err}")
        row = dict(B=B, N=n, max_abs_err=err, lse_err=lse_err)
        del want
        if B == 2:
            item0_unchanged(lambda *t: attention.flash_mha_packed(*t, scale, 4, return_lse=True),
                            (q, k, v), f"flash_packed N={n}")
        else:
            row["ms"] = cuda_time_ms(lambda: attention.flash_mha_packed(q, k, v, scale, 4))
        rows.setdefault("flash_packed_ragged", []).append(row)

        # --- column masses (Nq != Nk too), twice: the results must be equal
        kk = randn(B, n + 61, 512, dtype=bf16)
        for kind, keys in (("self", k), ("cross", kk)):
            cm = colmass.softmax_colmass(q, keys, scale, 4)
            torch.cuda.synchronize()
            want = colmass.softmax_colmass_ref(q, keys, scale, 4)
            rel = rel_err(cm, want)
            check(rel <= 1e-3, f"softmax_colmass {kind} B={B} N={n}: relative err {rel} > 1e-3")
            check(torch.equal(cm, colmass.softmax_colmass(q, keys, scale, 4)),
                  f"softmax_colmass {kind} B={B} N={n}: two runs differ")
            row = dict(B=B, N=n, Nk=keys.shape[1], max_abs_err=(cm - want).abs().max().item(),
                       rel_err=rel)
            if B == 2:
                item0_unchanged(lambda *t: (colmass.softmax_colmass(*t, scale, 4),), (q, keys),
                                f"softmax_colmass {kind} N={n}")
            elif kind == "self":
                row["ms"] = cuda_time_ms(lambda: colmass.softmax_colmass(q, keys, scale, 4))
            rows.setdefault("softmax_colmass_ragged", []).append(row)

        # --- DGCNN's eval chain and the fused attention sublayer
        idx_x = knn.fused_knn(x, K)
        out = dgcnn.fused_dgcnn_eval(x, idx_x, folded, emb)
        torch.cuda.synchronize()
        rel = rel_err(out, dgcnn.fused_dgcnn_eval_ref(x, idx_x, folded, emb))
        check(rel <= 2e-2, f"dgcnn_eval B={B} N={n}: relative err {rel} > 2e-2")
        row = dict(B=B, N=n, max_abs_err=rel, rel_err=rel)
        if B == 64:
            row["ms"] = cuda_time_ms(lambda: dgcnn.fused_dgcnn_eval(x, idx_x, folded, emb))
        rows.setdefault("dgcnn_eval_ragged", []).append(row)
        yq = randn(B, n, D, dtype=bf16)
        for kind, kv in (("self", yq), ("cross", randn(B, n + 61, D, dtype=bf16))):
            out = pointer.fused_mha(yq, kv, *mha_w, H)
            torch.cuda.synchronize()
            rel = rel_err(out, pointer.fused_mha_ref(yq, kv, *mha_w, H))
            check(rel <= 2 ** -6, f"fused_mha {kind} B={B} N={n}: relative err {rel} > 2^-6")
            row = dict(B=B, N=n, Nk=kv.shape[1], max_abs_err=rel, rel_err=rel)
            if B == 64 and kind == "self":
                row["ms"] = cuda_time_ms(lambda: pointer.fused_mha(yq, yq, *mha_w, H))
            rows.setdefault("fused_mha_ragged", []).append(row)
    print_rows(rows)
    return rows


def phase_gather_kernels(dev):
    """gather_max_from_idx, redesigned by channel slices: out and winners
    equal to the plain version's bit for bit at every slice width it runs
    (N = 768, 885, 1024: 64 channels; 3072: 32) and beyond the slices (N =
    16384: rows from device memory), on duplicate indices, at k = 1, 7 (the
    indices read one by one) and 32, at F = 8 and 264 (a narrower last
    slice); equal to knn_gather_max's out on its idx; and timed at B = 64,
    N = 1024 without winners (the serving route) and with them (the
    training route's), beside its bound and the plain version."""
    import torch

    from vcrnet_tpu_torch.ops import edgeconv

    g = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    rows = {}

    def exact(idx, values, what):
        out, win = edgeconv.fused_gather_max_from_idx(idx, values, winners=True)
        plain_out = edgeconv.fused_gather_max_from_idx(idx, values)
        torch.cuda.synchronize()
        ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx,
                                                                winners=True)
        check(torch.equal(out, ref_out) and torch.equal(plain_out, ref_out),
              f"gather_max_from_idx {what}: out differs from the plain version")
        check(torch.equal(win, ref_win), f"gather_max_from_idx {what}: winners differ")

    for B, n in GATHER_SHAPES:
        x = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
        values = torch.randn(B, n, 256, generator=g, device=dev).to(bf16)
        fused_out, idx = edgeconv.fused_knn_gather_max(x, values, K)
        exact(idx, values, f"B={B} N={n}")
        check(torch.equal(edgeconv.fused_gather_max_from_idx(idx, values), fused_out),
              f"gather_max_from_idx B={B} N={n}: differs from knn_gather_max on its idx")
        rows.setdefault("gather_max_from_idx_slices", []).append(dict(
            B=B, N=n, max_abs_err=0.0, equals_fused=True,
            ms=cuda_time_ms(lambda: edgeconv.fused_gather_max_from_idx(idx, values))))
    # duplicate indices (every neighbour twice), and ties of value: a table
    # of a few distinct values, so that many rows reach each maximum
    B, n = 8, N
    idx = torch.randint(0, n, (B, n, K // 2), generator=g, device=dev, dtype=torch.int32)
    idx = idx.repeat_interleave(2, dim=2).contiguous()
    values = torch.randint(-3, 4, (B, n, 256), generator=g, device=dev).to(bf16)
    exact(idx, values, "duplicate indices, tied values")
    for k, f in ((1, 256), (7, 256), (32, 256), (K, 8), (K, 264)):
        idx = torch.randint(0, n, (B, n, k), generator=g, device=dev, dtype=torch.int32)
        values = torch.randn(B, n, f, generator=g, device=dev).to(bf16)
        exact(idx, values, f"k={k} F={f}")
    rows["gather_max_from_idx_edge"] = [dict(B=B, N=n, duplicates=True, ks=(1, 7, 32),
                                             fs=(8, 264), max_abs_err=0.0)]

    # with winners (the training route's forward) at B = 64, N = 1024: one
    # more byte an output element
    B, n = 64, N
    x = torch.rand(B, n, 3, generator=g, device=dev) * 2 - 1
    values = torch.randn(B, n, 256, generator=g, device=dev).to(bf16)
    _, idx = edgeconv.fused_knn_gather_max(x, values, K)
    out, win = edgeconv.fused_gather_max_from_idx(idx, values, winners=True)
    b, by = bound_ms(nbytes(idx, values, out, win), B * n * K * 256, F32_FLOPS)
    rows["gather_max_from_idx_winners"] = [dict(
        B=B, N=n, max_abs_err=0.0, bound_ms=b, bound_by=by,
        ms=cuda_time_ms(lambda: edgeconv.fused_gather_max_from_idx(idx, values, winners=True)))]
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


# ---------------------------------------------------------------------------
# the training path the CLI runs: datasets, loaders and prefetch, dropout and
# remat, and convergence
# ---------------------------------------------------------------------------

DATA_BATCHES = 16       # batches of 8 pairs in the data phase's epochs
DATA_EPOCH_REL = 1e-3   # prefetch vs direct feed: the epoch summary, relative
RAW_CLOUD_POINTS = 2048
# a training step's launches with dropout: the pointer's six attentions (and
# their backward) take the plain route, their probabilities written out
DROPOUT_LAUNCHES = {k: n for k, n in TRAIN_LAUNCHES.items() if k not in ("flash_packed",
                                                                          "flash_bwd")}
DROPOUT_RATE = 0.1
DROPOUT_SHARE_TOL = 0.005
# remat runs the forward twice (its kernels twice), the backward once
REMAT_LAUNCHES = {k: n * (2 if k in ("knn_gather_max", "edge_conv", "flash_packed",
                                     "vcp_stream") else 1) for k, n in TRAIN_LAUNCHES.items()}
DCP_REMAT_LAUNCHES = {"knn": 4, "dgcnn_eval": 0, "flash_packed": 12, "flash_bwd": 6}
REMAT_COSINE_MIN = 0.9999
REMAT_SPREAD_FACTOR = 2.0  # remat vs plain gradient, against two plain passes
BN_STATS_ATOL = 1e-5
# converge: the JAX package's runs (STATUS.md) at N = 256, B = 32 on the
# uniform synthetic set: VCR-Net 12 epochs, rot RMSE 0.19-0.316 deg at iter=3
# (about 12.6 untrained); DCP on DGCNN 15 epochs, 14.5 deg (about 26)
CONVERGE = dict(dataset="synthetic", num_points=256, batch_size=32, test_batch_size=32,
                compute_dtype="bfloat16")
VCRNET_EPOCHS = 12
DCP_EPOCHS = 15
VCRNET_ROT_LIMIT_DEG = 1.0    # three times the record's worst reading
VCRNET_UNTRAINED_SHARE = 0.2  # of the untrained model's error, same eval set
DCP_UNTRAINED_SHARE = 0.75


def importable(name: str) -> bool:
    """Whether ``name`` imports here (an optional package is printed as
    present or absent, never worked around)."""
    import importlib

    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def check_dataset_trees(root: str) -> None:
    """Fake ModelNet40 and KITTI trees written under ``root`` and read
    through ``make_loaders`` at N = 1024: two reads from one seed give equal
    batches. Needs h5py."""
    import numpy as np

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data import fixtures, pipeline

    fixtures.make_fake_modelnet40_tree(root, (16, 16, 16, 16, 12), (16, 8), seed=0)
    fixtures.make_fake_kitti_tree(root, frames_per_seq=5, points_per_frame=4096, seed=0)
    for dataset in ("modelnet40", "kitti"):
        cfg = Config(dataset=dataset, data_dir=root, num_points=N, batch_size=8)
        reads = []
        for _ in range(2):
            np.random.seed(0)  # training pairs draw from the global generator
            reads.append([b for loader in pipeline.make_loaders(cfg) for b in loader])
        check(len(reads[0]) >= 2 and all(
            all(np.array_equal(a[k], b[k]) for k in a) for a, b in zip(*reads)),
              f"data: {dataset}: two reads from one seed differ")
        check(reads[0][0]["src"].shape == (8, N, 3), f"data: {dataset}: batch shape")
        print(f"data: {dataset} tree through make_loaders: {len(reads[0])} batches, two reads "
              f"equal", flush=True)


def phase_data():
    """Datasets, loaders and the prefetch feed (on the card's installation):

    1. the port's fixture writer writes velodyne frames (numpy alone) and
       ``read_velodyne_bin`` reads them back, padded and truncated;
    2. ``make_datasets`` on ModelNet40 with an empty data directory gives the
       synthetic sets;
    3. where h5py imports, fake ModelNet40 and KITTI trees go through
       ``make_loaders`` at N = 1024, two reads from one seed bit-equal;
    4. a full-width Trainer at N = 1024, B = 8 trains one epoch of 16 batches
       through ``prefetch``: every staged host tensor pinned, every batch on
       the card, the epoch's summary within 1e-3 relative of the same epoch
       fed without prefetch, the exact launches of 16 steps; then two more
       epochs of each feed, timed in turns (printed, no gate);
    5. ``train_epoch_raw``: one epoch of 2048-point raw clouds at B = 8 (the
       pairs drawn on the card), the launches of one raw step.
    Returns the launches of the two epochs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data import fixtures, pipeline
    from vcrnet_tpu_torch.data.kitti import read_velodyne_bin
    from vcrnet_tpu_torch.data.synthetic import SyntheticDataset
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train import metrics as M

    has_h5py = importable("h5py")
    print(f"data: h5py: {'installed' if has_h5py else 'not installed'}", flush=True)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="data_", dir=os.path.join(HERE, "build"))
    try:
        kitti = fixtures.make_fake_kitti_tree(tmp, frames_per_seq=5, points_per_frame=4096,
                                              seed=0, with_index=False)
        frames = os.path.join(kitti, "bin", "00", "velodyne")
        n_load = N + 1
        for name in ("000000.bin", "000004.bin"):  # a whole frame, and one of 512 points
            raw = np.fromfile(os.path.join(frames, name), dtype=np.float32).reshape(-1, 4)[:, :3]
            got = read_velodyne_bin(os.path.join(frames, name), n_load)
            n = min(len(raw), n_load)
            check(got.shape == (n_load, 3) and np.array_equal(got[:n], raw[:n])
                  and (len(raw) >= n_load or (got[n:] == raw[len(raw) // 6]).all()),
                  f"data: read_velodyne_bin on {name} ({len(raw)} points)")
        print(f"data: velodyne frames written and read back: {len(raw)} points padded to "
              f"{n_load}", flush=True)
        empty = os.path.join(tmp, "empty")
        os.makedirs(empty)
        sets = pipeline.make_datasets(Config(dataset="modelnet40", data_dir=empty))
        check(all(isinstance(s, SyntheticDataset) for s in sets),
              f"data: the fallback gave {[type(s).__name__ for s in sets]}")
        if has_h5py:
            check_dataset_trees(tmp)
        else:
            print("data: h5py not installed: the ModelNet40 and KITTI readers are held on the "
                  "CPU only (tests/test_torch_data.py)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cfg = Config(compute_dtype="bfloat16", num_points=N)
    dataset = SyntheticDataset(cfg, "train", n_items=8 * DATA_BATCHES, cloud_points=2 * N,
                               seed=40, kind="shapes")

    def loader():
        np.random.seed(41)  # training pairs draw from the global generator
        return pipeline.Loader(dataset, 8, shuffle=True, drop_last=True, seed=42)

    warm = _train_batch(cfg, 8, seed=43)
    fed = Trainer(cfg, seed=0)
    staged, arrived = [], []
    stage, to_device = fed.stage, fed.to_device

    def spy_stage(batch):
        out = stage(batch)
        staged.append(all(v.is_pinned() for v in out.values()))
        return out

    def spy_to_device(batch):
        out = to_device(batch)
        arrived.append(all(v.is_cuda for v in out.values()))
        return out

    fed.stage, fed.to_device = spy_stage, spy_to_device
    fed.train_step(warm)
    staged.clear()
    arrived.clear()
    direct = Trainer(cfg, seed=0)
    direct.train_step(warm)

    def direct_epoch():
        acc = M.EpochAccumulator()
        for batch in loader():
            acc.add(direct.train_step(batch))
        return M.summarize(acc)

    # the two trainers take the same epochs in step: the first of each is
    # compared, then the feeds are timed in turns (prefetch first, then
    # direct first)
    times = {"prefetch": [], "direct": []}
    summaries = {}
    for kind in ("prefetch", "direct", "direct", "prefetch", "prefetch", "direct"):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = fed.train_epoch(loader()) if kind == "prefetch" else direct_epoch()
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
        if kind == "prefetch" and kind not in summaries:
            launches = ops.launch_counts()
            check(len(staged) == DATA_BATCHES and all(staged),
                  f"data: staged host batches pinned: {staged}")
            check(len(arrived) == DATA_BATCHES and all(arrived),
                  f"data: batches on the card: {arrived}")
            check_launches(launches, {k: n * DATA_BATCHES for k, n in TRAIN_LAUNCHES.items()},
                           "data: prefetch epoch")
        summaries.setdefault(kind, summary)
    with_prefetch, without = summaries["prefetch"], summaries["direct"]
    rel = {k: abs(with_prefetch[k] - without[k]) / max(abs(without[k]), 1e-12)
           for k in ("loss", "loss_pose", "rot_ab_RMSE", "trans_ab_RMSE")}
    print(f"data: epochs of {DATA_BATCHES} batches of 8 at N = {N}, s: with prefetch "
          f"{times['prefetch']}, fed directly {times['direct']} (in the order prefetch, direct, "
          f"direct, prefetch, prefetch, direct); device idle share not measured; first epochs' "
          f"summaries relative difference {rel}; loss {with_prefetch['loss']} / "
          f"{without['loss']}", flush=True)
    check(all(math.isfinite(v) for v in with_prefetch.values()), "data: non-finite epoch summary")
    check(max(rel.values()) <= DATA_EPOCH_REL,
          f"data: the prefetch epoch differs from the direct one by {rel}")
    del direct

    raw = dataset.raw_clouds()
    check(raw.shape[1] == RAW_CLOUD_POINTS, f"data: raw clouds {raw.shape}")
    batches = raw.reshape(DATA_BATCHES, 8, RAW_CLOUD_POINTS, 3)
    staged.clear()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    raw_sum = fed.train_epoch_raw(batches)
    torch.cuda.synchronize()
    raw_s = time.perf_counter() - t0
    raw_launches = ops.launch_counts()
    check_launches(raw_launches, {k: n * DATA_BATCHES for k, n in TRAIN_LAUNCHES.items()},
                   "data: raw epoch")
    check(len(staged) == DATA_BATCHES and all(staged),
          f"data: staged raw batches pinned: {staged}")
    ops.reset_launch_counts()
    fed.train_step_raw({"clouds": batches[0]})
    torch.cuda.synchronize()
    check_launches(ops.launch_counts(), TRAIN_LAUNCHES, "data: one raw step")
    print(f"data: train_epoch_raw over {DATA_BATCHES} batches of 8 raw clouds of "
          f"{RAW_CLOUD_POINTS} points: {raw_s} s, loss {raw_sum['loss']}, rot_ab_RMSE "
          f"{raw_sum['rot_ab_RMSE']} deg", flush=True)
    check(all(math.isfinite(v) for v in raw_sum.values()), "data: non-finite raw epoch summary")
    total = {}
    add_launches(total, launches)
    add_launches(total, raw_launches)
    return total


def _flat_grads(trainer):
    import torch

    return torch.cat([p.grad.reshape(-1).float() for p in trainer.model.parameters()])


def _max_rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase_regularise():
    """Dropout and remat at full width, bf16, N = 1024, B = 8:

    1. dropout 0.1: the exact launches of a step (the pointer's attention off
       the flash kernels: its probabilities are written out), the share of
       zeros in the dropped attention probabilities within 0.1 +- 0.005, two
       training forwards at one (seed, step) equal and at another step not,
       eval with the dropout config equal bit for bit to eval without it;
    2. remat: the exact launches of a step (the forward kernels twice), the
       gradient against the step without remat (cosine >= 0.9999, largest
       relative difference within twice that of two plain backward passes),
       the peak device memory of both steps (printed), and a DCP/DGCNN remat
       step's running statistics within 1e-5 of a plain step's.
    Returns the launches of the dropout and remat steps."""
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.models.vcrnet import vcrnet_iter
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train.engine import DROPOUT_SEED_OFFSET
    from vcrnet_tpu_torch.utils.rng import fold_seed

    total = {}
    cfg = Config(compute_dtype="bfloat16", num_points=N, dropout=DROPOUT_RATE)
    batch = _train_batch(cfg, 8, seed=1)
    tr = Trainer(cfg, seed=0)
    tr.train_step(batch)
    drop_mods = [m for name, m in tr.model.named_modules() if name.endswith("attn_drop")]
    seen = []

    def share(mod, inp, out):
        live = inp[0] != 0
        seen.append((((out == 0) & live).sum().item(), live.sum().item()))

    hooks = [m.register_forward_hook(share) for m in drop_mods]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sums = tr.train_step(batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    for h in hooks:
        h.remove()
    check_launches(launches, DROPOUT_LAUNCHES, "regularise: dropout step")
    add_launches(total, launches)
    zeros = sum(z for z, _ in seen) / sum(n for _, n in seen)
    print(f"regularise: dropout {DROPOUT_RATE}: launches of a step {launches}; zeros in the "
          f"{len(seen)} dropped attention probability tensors: {zeros}; loss "
          f"{(sums['loss'] / sums['count']).item()}", flush=True)
    check(len(seen) == 6 and abs(zeros - DROPOUT_RATE) <= DROPOUT_SHARE_TOL,
          f"regularise: dropped share {zeros} over {len(seen)} tensors")

    b = tr.to_device(batch)
    tr.model.train()
    outs = []
    with torch.no_grad():
        for step in (5, 5, 6):
            tr.model.dropout_rng.seed = fold_seed(cfg.seed + DROPOUT_SEED_OFFSET, step)
            outs.append(tr.model(b["src"], b["tgt"]))
    same = all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    other = any(not torch.equal(x, y) for x, y in zip(outs[0], outs[2]))
    print(f"regularise: training forwards at one (seed, step) equal: {same}; at another step "
          f"different: {other}", flush=True)
    check(same and other, "regularise: the dropout masks do not follow (seed, step)")

    plain_eval = Trainer(Config(compute_dtype="bfloat16", num_points=N), seed=3)
    plain_eval.model.load_state_dict(tr.model.state_dict())
    tr.model.eval()
    plain_eval.model.eval()
    with torch.no_grad():
        e_drop = vcrnet_iter(tr.model, b["src"], b["tgt"], 3)
        e_plain = vcrnet_iter(plain_eval.model, b["src"], b["tgt"], 3)
    check(all(torch.equal(x, y) for x, y in zip(e_drop, e_plain)),
          "regularise: eval with a dropout config differs from eval without it")
    print("regularise: eval at iter=3 with dropout 0.1 in the config equals eval without it, "
          "bit for bit", flush=True)
    del tr, plain_eval, outs

    # remat: gradients of one batch from one initial state
    cfg = Config(compute_dtype="bfloat16", num_points=N)
    plain = Trainer(cfg, seed=0)
    remat = Trainer(cfg.replace(remat=True), seed=0)
    plain.compute_grads(batch)
    remat.compute_grads(batch)  # warm-up
    peak = {}
    grads = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        plain.compute_grads(batch)
        torch.cuda.synchronize()
        peak["plain"] = torch.cuda.max_memory_allocated()
        grads.append(_flat_grads(plain))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    remat.compute_grads(batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak["remat"] = torch.cuda.max_memory_allocated()
    check_launches(launches, REMAT_LAUNCHES, "regularise: remat step")
    add_launches(total, launches)
    g_remat = _flat_grads(remat)
    cos = _cosine(g_remat, grads[0])
    rel_remat, rel_plain = _max_rel(g_remat, grads[0]), _max_rel(grads[1], grads[0])
    print(f"regularise: remat: launches of a step {launches}; gradient cosine against the plain "
          f"step {cos}, largest relative difference {rel_remat} (two plain passes: "
          f"{rel_plain}); peak device memory of a step: plain {peak['plain']} B, remat "
          f"{peak['remat']} B", flush=True)
    check(cos >= REMAT_COSINE_MIN, f"regularise: remat gradient cosine {cos}")
    check(rel_remat <= REMAT_SPREAD_FACTOR * rel_plain,
          f"regularise: remat gradient {rel_remat} from the plain step, two plain passes "
          f"{rel_plain}")
    del plain, remat, grads

    dcfg = Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N)
    stats = []
    for flag in (False, True):
        dtr = Trainer(dcfg.replace(remat=flag), seed=0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dtr.train_step(batch)
        torch.cuda.synchronize()
        if flag:
            launches = ops.launch_counts()
            check_launches(launches, DCP_REMAT_LAUNCHES, "regularise: DCP remat step")
            add_launches(total, launches)
        stats.append({n: b.clone() for n, b in dtr.model.named_buffers() if "running_" in n})
        del dtr
    diff = max((stats[0][n] - stats[1][n]).abs().max().item() for n in stats[0])
    print(f"regularise: DCP/DGCNN remat step: running statistics of {len(stats[0])} buffers "
          f"within {diff} of a plain step's; launches {launches}", flush=True)
    check(len(stats[0]) == 10 and diff <= BN_STATS_ATOL,
          f"regularise: remat running statistics {diff} from the plain step's")
    return total


def _route_results(model, loader, device):
    """(R_ab, t_ab) numpy of every valid pair of ``loader`` through a DCP
    model in eval."""
    import numpy as np
    import torch

    model.eval()
    Rs, ts = [], []
    with torch.no_grad():
        for batch in loader:
            keep = batch["valid"] > 0
            src, tgt = (torch.as_tensor(batch[k]).to(device) for k in ("src", "tgt"))
            R, t = model(src, tgt)[:2]
            Rs.append(R.double().cpu().numpy()[keep])
            ts.append(t.double().cpu().numpy()[keep])
    return np.concatenate(Rs), np.concatenate(ts)


def phase_converge():
    """Training the way the CLI trains, to a useful accuracy (ROADMAP A3):
    ``make_loaders`` on the synthetic set at N = 256, B = 32 (1024 training
    pairs, 128 test pairs), ``fit`` through prefetch at full width, bf16:

    1. VCR-Net, 12 epochs, eval at iter=3: rot RMSE <= 1.0 deg and <= 1/5 of
       the untrained model's on the same eval set;
    2. DCP on DGCNN, 15 epochs: rot RMSE <= 0.75 of the untrained model's;
       on the trained statistics the kernel route's rotations within 0.5 deg
       of the plain route's (median per pair), translations within 0.01.
    Returns the launches of the two fits."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.pipeline import make_loaders
    from vcrnet_tpu_torch.train import Trainer

    total = {}
    results = {}
    for name, cfg, epochs, train_l, eval_l in (
        ("VCR-Net", Config(iter=3, **CONVERGE), VCRNET_EPOCHS, TRAIN_LAUNCHES, LAUNCHES_ITER3),
        ("DCP/DGCNN", Config(model="dcp", emb_nn="dgcnn", **CONVERGE), DCP_EPOCHS,
         DCP_TRAIN_LAUNCHES, DCP_EVAL_LAUNCHES),
    ):
        np.random.seed(0)  # training pairs draw from the global generator
        train, test = make_loaders(cfg)
        check((len(train), len(test.dataset)) == (32, 128), f"converge: loaders {len(train)}")
        tr = Trainer(cfg, seed=0)
        untrained = tr.eval_epoch(test)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        history = tr.fit(train, test, epochs=epochs, log=lambda s: None)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        add_launches(total, launches)
        trained = history[-1]["test"]
        curve = [round(h["test"]["rot_ab_RMSE"], 4) for h in history]
        print(f"converge: {name}: {epochs} epochs in {fit_s} s ({fit_s / (epochs * len(train))} s "
              f"a step with its share of the evals); test rot RMSE untrained "
              f"{untrained['rot_ab_RMSE']} deg, by epoch {curve}; trained: rot RMSE "
              f"{trained['rot_ab_RMSE']} MAE {trained['rot_ab_MAE']} deg, trans RMSE "
              f"{trained['trans_ab_RMSE']}; launches {launches}", flush=True)
        results[name] = (untrained, trained)
        check(all(math.isfinite(v) for v in trained.values()), f"converge: {name}: non-finite")
        expected = {k: epochs * len(train) * n for k, n in train_l.items()}
        for k, n in eval_l.items():
            expected[k] = expected.get(k, 0) + epochs * len(test) * n
        check_launches(launches, expected, f"converge: {name} fit")
        if cfg.model == "vcrnet":
            check(trained["rot_ab_RMSE"] <= VCRNET_ROT_LIMIT_DEG,
                  f"converge: {name}: rot RMSE {trained['rot_ab_RMSE']} > "
                  f"{VCRNET_ROT_LIMIT_DEG} deg")
            check(trained["rot_ab_RMSE"] <= VCRNET_UNTRAINED_SHARE * untrained["rot_ab_RMSE"],
                  f"converge: {name}: rot RMSE {trained['rot_ab_RMSE']} > "
                  f"{VCRNET_UNTRAINED_SHARE} x untrained {untrained['rot_ab_RMSE']}")
            del tr
            continue
        check(trained["rot_ab_RMSE"] <= DCP_UNTRAINED_SHARE * untrained["rot_ab_RMSE"],
              f"converge: {name}: rot RMSE {trained['rot_ab_RMSE']} > {DCP_UNTRAINED_SHARE} x "
              f"untrained {untrained['rot_ab_RMSE']}")
        plain = Trainer(cfg, seed=0, use_kernels=False)
        plain.model.load_state_dict(tr.model.state_dict())
        check(tr.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
        R_k, t_k = _route_results(tr.model, test, tr.device)
        R_p, t_p = _route_results(plain.model, test, plain.device)
        between = pair_rot_errors_deg(R_k, R_p)
        dt = np.abs(t_k - t_p).max(axis=1)
        print(f"converge: {name}: kernel vs plain route on the trained statistics over "
              f"{len(R_k)} pairs: rotation between them median {float(np.median(between))} max "
              f"{float(between.max())} deg; |dt| median {float(np.median(dt))} max "
              f"{float(dt.max())}", flush=True)
        check(float(np.median(between)) <= DGCNN_ROUTE_ROT_DEG,
              f"converge: {name}: routes differ by more than {DGCNN_ROUTE_ROT_DEG} deg (median)")
        check(float(np.median(dt)) <= DGCNN_ROUTE_TRANS,
              f"converge: {name}: translations differ by more than {DGCNN_ROUTE_TRANS}")
        del tr, plain
    return total


# ---------------------------------------------------------------------------
# the last model families: partial-overlap training, ICP and net + ICP, LPD
# ---------------------------------------------------------------------------

BACKWARD_KERNELS = ("gather_max_bwd", "edge_conv_bwd", "flash_bwd", "vcp_bwd")
# VCR-Net's partial training step: the forward kernels only (LPDNet's two
# blocks on the stacked clouds; 4 attentions, the 2 re-masked cross
# attentions write their scores out; the head is plain), no backward: the
# loss has no gradient path
PARTIAL_TRAIN_LAUNCHES = {"knn_gather_max": 1, "edge_conv": 1, "flash_packed": 4}
# DCP on DGCNN on partial crops: both clouds' kNN, 4 flash attentions and
# their backward (the re-masked ones are plain)
DCP_PARTIAL_LAUNCHES = {"knn": 2, "flash_packed": 4, "flash_bwd": 4}
# LPD's step: LPDNet on the stacked clouds, forward with winners and backward
LPD_LAUNCHES = {"knn_gather_max": 1, "edge_conv": 1, "edge_conv_bwd": 1, "gather_max_bwd": 1}
PARTIAL_STEPS = 3          # steps through both routes, parameters held equal
PARTIAL_FINE_TUNE = 20     # steps before the partial protocol is served again
PARTIAL_MOVE_FACTOR = 1.01  # a weight-decay-only Adam step moves a weight by <= 1.01 lr
ICP_CPU_AGREEMENT_DEG = 1e-3  # ICP on the card against the CPU, median per pair
LPD_FIT_EPOCHS = 2


def grad_cosine(cfg, batch, what: str):
    """Gradients of a kernel-route and a plain-route Trainer of ``cfg``
    (seed 0) on ``batch``: prints each parameter's cosine and returns
    (whole-model cosine, kernel-route loss, the two trainers)."""
    import torch

    from vcrnet_tpu_torch.train import Trainer

    kern = Trainer(cfg, seed=0)
    plain = Trainer(cfg, seed=0, use_kernels=False)
    check(kern.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
    loss_k, _ = kern.compute_grads(batch)
    loss_p, _ = plain.compute_grads(batch)
    gk, gp = [], []
    for (name, pk), (_, pp) in zip(kern.model.named_parameters(), plain.model.named_parameters()):
        gk.append(pk.grad.reshape(-1).float())
        gp.append(pp.grad.reshape(-1).float())
        print(f"{what} grad cosine {name}: {_cosine(gk[-1], gp[-1])}", flush=True)
    cos = _cosine(torch.cat(gk), torch.cat(gp))
    print(f"{what}: loss kernels {loss_k.item()} plain {loss_p.item()}; whole-model grad cosine "
          f"{cos}", flush=True)
    check(math.isfinite(loss_k.item()) and math.isfinite(loss_p.item()), f"{what}: non-finite loss")
    return cos, loss_k.item(), kern, plain


def step_launches(trainer, batch, expected: dict, what: str) -> dict:
    """The launches of one training step (after the steps already taken)."""
    import torch

    from vcrnet_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"{what}: launches of one step: {launches}", flush=True)
    check_launches(launches, expected, what)
    return launches


def losses_fall(trainer, batch, what: str) -> list:
    """``TRAIN_STEPS`` + 1 Adam steps on one batch; the loss per pair must
    fall."""
    losses = []
    for _ in range(TRAIN_STEPS + 1):
        sums = trainer.train_step(batch)
        losses.append((sums["loss"] / sums["count"]).item())
    print(f"{what}: losses over {TRAIN_STEPS} Adam steps on one batch: {losses}", flush=True)
    check(all(math.isfinite(v) for v in losses), f"{what}: non-finite loss in the Adam steps")
    check(losses[-1] < losses[0], f"{what}: loss after {TRAIN_STEPS} steps {losses[-1]} >= "
          f"first {losses[0]}")
    return losses


def print_step_times(trainer, cfg, batches, what: str) -> None:
    for b in batches:
        times = timed_steps_ms(trainer, trainer.to_device(_train_batch(cfg, b, seed=2)))
        print(f"{what}: step at B={b}: median {statistics.median(times)} ms (5 steps: {times})",
              flush=True)


def phase_partial_train():
    """Training in partial-overlap mode (ROADMAP A4), full width, bf16:

    1. VCR-Net from the committed checkpoint at overlap 0.575 (768 points),
       B = 8, through the kernels and the plain route: the loss finite,
       every gradient exactly zero, no backward kernel launched; after 3
       steps the two routes' parameters equal, each step moving a weight by
       at most 1.01 lr (weight decay alone); the step time; after 20 such
       steps the 73-pair partial protocol (iter=3) served again beside the
       untouched checkpoint (a record: finite, no limit);
    2. DCP on DGCNN at overlap 0.575 and 0.75 (768, 885 points) from a
       seeded init: kernel vs plain gradient cosine >= 0.99 at B = 8, the
       loss falls over 20 Adam steps, the launches of a step, the step time
       at B = 8 and 64.
    Returns the launches of the steps counted."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    total = {}
    state_dict = load_checkpoint(CHECKPOINT)
    cfg = Config(compute_dtype="bfloat16", num_points=N, partial=True, overlap=0.575)
    batch = _train_batch(cfg, 8, seed=1)
    check(batch["src"].shape == (8, cfg.n_cropped, 3) and cfg.n_cropped == 768,
          f"partial_train: batch {batch['src'].shape}")
    kern = Trainer(cfg, seed=0)
    plain = Trainer(cfg, seed=0, use_kernels=False)
    check(kern.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
    names = [n for n, _ in kern.model.named_parameters()]
    for tr in (kern, plain):
        tr.model.load_state_dict(state_dict)
        loss, _ = tr.compute_grads(batch)
        print(f"partial_train VCR-Net: loss {loss.item()} (kernels: {tr.model.use_kernels})",
              flush=True)
        check(math.isfinite(loss.item()), "partial_train: non-finite loss")
        check(tr.grads_filled == names, "partial_train: a gradient path reached a parameter")
        check(all(not p.grad.any() for p in tr.model.parameters()),
              "partial_train: a gradient is not exactly zero")
    lr = kern.optimizer.param_groups[0]["lr"]
    worst = 0.0
    for i in range(PARTIAL_STEPS):
        before = [p.detach().clone() for p in kern.model.parameters()]
        if i == PARTIAL_STEPS - 1:
            add_launches(total, step_launches(kern, batch, PARTIAL_TRAIN_LAUNCHES,
                                              "partial_train VCR-Net"))
        else:
            kern.train_step(batch)
        plain.train_step(batch)
        worst = max(worst, max((p - q).abs().max().item()
                               for p, q in zip(kern.model.parameters(), before)))
        check(all(torch.equal(p, q) for p, q in zip(kern.model.parameters(),
                                                     plain.model.parameters())),
              f"partial_train: the routes' parameters differ after step {i + 1}")
    print(f"partial_train VCR-Net: {PARTIAL_STEPS} steps, the routes' parameters equal; the "
          f"largest move of a weight in a step {worst} (lr {lr})", flush=True)
    check(worst <= PARTIAL_MOVE_FACTOR * lr, f"partial_train: a weight moved {worst} > "
          f"{PARTIAL_MOVE_FACTOR} lr in one step")
    del plain
    print_step_times(kern, cfg, (8,), "partial_train VCR-Net")
    while kern.step < PARTIAL_FINE_TUNE:  # the timing took steps too
        kern.train_step(batch)
    scfg = Config(compute_dtype="bfloat16", iter=3, num_points=N, partial=True, overlap=0.575)
    data = shapes_eval_set(sum(REQUESTS), num_points=N, partial=True)
    requests = split_requests(data, REQUESTS)
    accs = {}
    for name, weights in (("untouched checkpoint", state_dict),
                          (f"after {PARTIAL_FINE_TUNE} partial steps", kern.model.state_dict())):
        accs[name] = accuracy(*serve_all(Registrar(scfg, weights), requests), data)
    print(f"partial_train VCR-Net: the partial protocol (73 pairs, iter=3): {accs}", flush=True)
    check(all(math.isfinite(v) for a in accs.values() for v in a.values()),
          "partial_train: non-finite accuracy")
    del kern
    torch.cuda.empty_cache()

    for overlap, n_crop in ((0.575, 768), (0.75, 885)):
        what = f"partial_train DCP/DGCNN overlap {overlap}"
        cfg = Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N,
                     partial=True, overlap=overlap)
        batch = _train_batch(cfg, 8, seed=1)
        check(batch["src"].shape == (8, n_crop, 3), f"{what}: batch {batch['src'].shape}")
        cos, _, kern, plain = grad_cosine(cfg, batch, what)
        check(kern.grads_filled == [] and plain.grads_filled == [],
              f"{what}: a parameter got no gradient")
        check(cos >= GRAD_COSINE_MIN, f"{what}: kernel vs plain gradient cosine {cos} < "
              f"{GRAD_COSINE_MIN}")
        del kern, plain
        tr = Trainer(cfg, seed=0)
        losses_fall(tr, batch, what)
        add_launches(total, step_launches(tr, batch, DCP_PARTIAL_LAUNCHES, what))
        print_step_times(tr, cfg, BATCHES, what)
        del tr
        torch.cuda.empty_cache()
    return total


def phase_icp():
    """ICP and net + ICP (ROADMAP A5):

    1. ``Trainer(model="icp").eval_epoch`` on the synthetic eval set (128
       pairs, N = 1024, B = 32): rot and trans RMSE, the mean number of
       iterations executed (of 50), and one batch again on the CPU through
       the port, within 1e-3 deg per pair (median);
    2. ``Registrar(Config(iter=0))`` on the committed checkpoint at 1, 8 and
       64 pairs: the launches of a 1-pair request as iter=1's (the net's
       pass), rot RMSE through the kernels within 0.25 deg of the plain
       route, beside iter=1's; latency.
    Returns the launches of the 1-pair request."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.pipeline import make_loaders
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.models.icp import icp_register
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    cfg = Config(model="icp", dataset="synthetic", num_points=N, test_batch_size=32)
    np.random.seed(0)
    _, test = make_loaders(cfg)
    batches = list(test)
    check(len(test.dataset) == 128 and len(batches) == 4, f"icp: eval set {len(test.dataset)}")
    tr = Trainer(cfg)
    check(tr.model is None and tr.optimizer is None, "icp: a parameter-free trainer")
    tr.eval_epoch(batches[:1])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = tr.eval_epoch(batches)
    eval_s = time.perf_counter() - t0
    iters = []
    for b in batches:
        src, tgt = (torch.as_tensor(b[k]).to(tr.device) for k in ("src", "tgt"))
        iters.append(icp_register(src, tgt, max_iterations=cfg.max_iterations,
                                  with_iters=True)[-1])
    print(f"icp: eval_epoch over {len(test.dataset)} pairs in {eval_s} s: rot RMSE "
          f"{summary['rot_ab_RMSE']} deg, trans RMSE {summary['trans_ab_RMSE']}; iterations "
          f"executed per batch {iters} (mean {statistics.mean(iters)} of {cfg.max_iterations})",
          flush=True)
    check(math.isfinite(summary["rot_ab_RMSE"]) and math.isfinite(summary["trans_ab_RMSE"]),
          "icp: non-finite RMSE")
    check(all(1 <= n <= cfg.max_iterations for n in iters), f"icp: iterations {iters}")
    src, tgt = batches[0]["src"], batches[0]["tgt"]
    on_card = icp_register(torch.as_tensor(src).to(tr.device), torch.as_tensor(tgt).to(tr.device),
                           with_iters=True)
    on_cpu = icp_register(torch.as_tensor(src), torch.as_tensor(tgt), with_iters=True)
    between = pair_rot_errors_deg(on_card[2].double().cpu().numpy(), on_cpu[2].double().numpy())
    print(f"icp: one batch of 32 on the card and on the CPU: iterations {on_card[-1]} / "
          f"{on_cpu[-1]}, rotation between them per pair median {float(np.median(between))} max "
          f"{float(between.max())} deg", flush=True)
    check(float(np.median(between)) <= ICP_CPU_AGREEMENT_DEG,
          f"icp: card vs CPU rotations differ by more than {ICP_CPU_AGREEMENT_DEG} deg (median)")

    state_dict = load_checkpoint(CHECKPOINT)
    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    requests = split_requests(data, REQUESTS)
    cfg0 = Config(compute_dtype="bfloat16", iter=0, num_points=N)
    reg = Registrar(cfg0, state_dict)
    plain = Registrar(cfg0, state_dict, use_kernels=False)
    check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
    serve_all(reg, requests)  # warm-up
    launches = one_request_launches(reg, *requests[0], LAUNCHES_ITER1, "icp net + ICP")
    acc = accuracy(*serve_all(reg, requests), data)
    acc_plain = accuracy(*serve_all(plain, requests), data)
    acc1 = accuracy(*serve_all(Registrar(Config(compute_dtype="bfloat16", iter=1, num_points=N),
                                         state_dict), requests), data)
    print(f"icp net + ICP (iter=0): kernels {acc} plain {acc_plain}; iter=1 through the kernels "
          f"{acc1}; over {len(data['src'])} pairs", flush=True)
    check(abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"]) <= PLAIN_AGREEMENT_DEG,
          f"icp net + ICP: kernel vs plain rot RMSE differ by more than {PLAIN_AGREEMENT_DEG} deg")
    print_latency(reg, requests, "icp net + ICP")
    return launches


def phase_lpd():
    """LPD pretraining (ROADMAP A6), full width, bf16, N = 1024: LPDNet at
    the slope 0.2 through the edge kernels and their backward. Kernel vs
    plain gradient cosine >= 0.99 at B = 8, the launches of a step, the loss
    falls over 20 Adam steps, the step time at B = 16 and 32; then a 2-epoch
    fit with checkpoints, and its best embedding merged into a VCR-Net
    Trainer (bit-equal) that takes one step. Returns the launches of the
    step counted."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train.checkpoint import merge_pretrained_embedding

    cfg = Config(model="lpd", compute_dtype="bfloat16", num_points=N, batch_size=16,
                 test_batch_size=16)
    batch = _train_batch(cfg, 8, seed=1)
    cos, _, kern, plain = grad_cosine(cfg, batch, "lpd")
    check(kern.model.emb_nn.slope == 0.2, "lpd: LPDNet not at the slope 0.2")
    check(kern.grads_filled == [] and plain.grads_filled == [], "lpd: a parameter got no gradient")
    check(cos >= GRAD_COSINE_MIN, f"lpd: kernel vs plain gradient cosine {cos} < {GRAD_COSINE_MIN}")
    del kern, plain
    tr = Trainer(cfg, seed=0)
    losses_fall(tr, batch, "lpd")
    launches = step_launches(tr, batch, LPD_LAUNCHES, "lpd")
    print_step_times(tr, cfg, (16, 32), "lpd")
    del tr
    torch.cuda.empty_cache()

    np.random.seed(0)  # training pairs draw from the global generator
    train = Loader(SyntheticDataset(cfg, "train", n_items=64, cloud_points=2 * N, seed=40,
                                    kind="shapes"), 16, shuffle=True, drop_last=True)
    test = Loader(SyntheticDataset(cfg, "test", n_items=32, cloud_points=2 * N, seed=41,
                                   kind="shapes"), 16)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lpd_", dir=os.path.join(HERE, "build"))
    try:
        lpd = Trainer(cfg, seed=0)
        t0 = time.perf_counter()
        history = lpd.fit(train, test, epochs=LPD_FIT_EPOCHS, log=lambda s: None,
                          checkpoint_dir=tmp)
        fit_s = time.perf_counter() - t0
        print(f"lpd: fit of {LPD_FIT_EPOCHS} epochs ({len(train)} steps each) in {fit_s} s: "
              + "; ".join(f"epoch {h['epoch']} lr {h['lr']} train loss {h['train']['loss']} "
                          f"test loss {h['test']['loss']} mse {h['test']['mse']} mae "
                          f"{h['test']['mae']}" for h in history), flush=True)
        check(len(history) == LPD_FIT_EPOCHS and all(math.isfinite(h["test"]["loss"])
                                                     for h in history), "lpd: the fit failed")
        check(all(h["lr"] == cfg.lr for h in history), "lpd: MultiStepLR moved before epoch 75")
        saved = torch.load(os.path.join(tmp, "model.best.pt"), map_location="cpu",
                           weights_only=True)["model"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emb = {k[len("emb_nn."):]: v for k, v in saved.items() if k.startswith("emb_nn.")}
    vcr = Trainer(Config(compute_dtype="bfloat16", num_points=N), seed=0)
    vcr.model.load_state_dict(merge_pretrained_embedding(vcr.model.state_dict(), emb))
    merged = {k: v for k, v in vcr.model.state_dict().items() if k.startswith("emb_nn.")}
    check(len(merged) == len(emb) == 12 and all(
        torch.equal(v.cpu(), emb[k[len("emb_nn."):]]) for k, v in merged.items()),
          "lpd: the merged embedding is not the LPD checkpoint's")
    sums = vcr.train_step(batch)
    loss = (sums["loss"] / sums["count"]).item()
    print(f"lpd: the embedding of model.best merged into a VCR-Net Trainer ({len(emb)} tensors, "
          f"bit-equal); its first step's loss {loss}", flush=True)
    check(math.isfinite(loss), "lpd: non-finite VCR-Net loss after the merge")
    return launches


# ---------------------------------------------------------------------------
# the dist and att heads and the T-Nets (ROADMAP A7), and the port's CLI (A8b)
# ---------------------------------------------------------------------------

HEADS_ROUTE_DEG = {1: 0.25, 3: 0.1}  # att at its identity init against the topK head
# dist and att are plain PyTorch on the kernel route: a step or a request
# launches what the topK head's does but the soft-correspondence kernels
HEAD_TRAIN_LAUNCHES = {k: n for k, n in TRAIN_LAUNCHES.items() if k not in ("vcp_stream",
                                                                             "vcp_bwd")}
TNETS = dict(t3d=True, tfea=True)
TNET_BATCHNORMS = 10  # five in each T-Net
TNET_ROUTE_ROT_DEG = 0.5  # median rotation between the routes' results per pair, as dgcnn
# DCP and LPD embed the two clouds in two calls with a T-Net: every edge kernel twice
DCP_TNET_LAUNCHES = {"knn_gather_max": 2, "edge_conv": 2, "flash_packed": 6,
                     "gather_max_bwd": 2, "edge_conv_bwd": 2, "flash_bwd": 6}
LPD_TNET_LAUNCHES = {"knn_gather_max": 2, "edge_conv": 2, "gather_max_bwd": 2, "edge_conv_bwd": 2}
CLI_ROUTE_DEG = 0.1  # the CLI's iter=3 eval through the kernels against --no-use_kernels


def att_state_dict(state_dict: dict) -> dict:
    """The committed checkpoint with VcpAtt's projections at their identity
    init (the checkpoint was trained with the topK head)."""
    from vcrnet_tpu_torch.models.heads import VcpAtt

    eye = {f"vcp_att.{k}": v for k, v in VcpAtt(512).state_dict().items()}
    return {**state_dict, **eye}


def f32_launches(launches: dict, tfea: bool, what: str) -> int:
    """The edge kernel's f32-instance launches of the run ``launches`` counts
    (since the last ops.reset_launch_counts): every edge_conv launch with a
    feature T-Net (its kNN space is f32), none without."""
    from vcrnet_tpu_torch.ops import edgeconv

    n = edgeconv.fused_edge_conv.launches_f32
    want = launches["edge_conv"] if tfea else 0
    print(f"{what}: f32-instance launches {n} of {launches['edge_conv']} edge_conv", flush=True)
    check(n == want and (n > 0 or not tfea),
          f"{what}: {n} launches of the f32 edge instance, expected {want}")
    return n


def tnet_rows_agree(model, src, what: str) -> float:
    """Share of the DG-block rows of ``src`` (eval mode) whose selection on
    the kernel route (the f32 instance on the f32 space after t_net_fea)
    equals the plain route's f32 selection, checked at KNN_ROW_AGREEMENT."""
    import torch

    training = model.training
    model.eval()
    with torch.inference_mode():
        src = torch.as_tensor(src, device=model.device)
        idx_k = model.emb_nn(src, fused=True)[2]
        idx_p = model.emb_nn(src, fused=False)[2]
    model.train(training)
    agree = same_rows(idx_k, idx_p)
    print(f"{what}: DG-block rows whose kernel-route selection (the f32 instance) equals the "
          f"plain route's f32 selection: {agree} of {idx_k.shape[0] * idx_k.shape[1]} rows "
          f"({idx_k.shape[0]} clouds; limit {KNN_ROW_AGREEMENT})", flush=True)
    check(agree >= KNN_ROW_AGREEMENT, f"{what}: DG-block rows agree {agree} < {KNN_ROW_AGREEMENT}")
    return agree


def train_head_config(cfg, what: str, expected: dict):
    """A training configuration's four checks (full width, bf16, N = 1024):
    kernel vs plain gradient cosine >= 0.99 at B = 8, the loss falling over
    20 Adam steps, the launches of a step (and the running statistics'
    updates in it, returned with them), the step time at B = 8 and 64.
    Returns (trainer, launches, BatchNorm updates of the step)."""
    import torch

    from vcrnet_tpu_torch.models._common import FlaxBatchNorm
    from vcrnet_tpu_torch.train import Trainer

    batch = _train_batch(cfg, 8, seed=1)
    cos, _, kern, plain = grad_cosine(cfg, batch, what)
    check(kern.grads_filled == [] and plain.grads_filled == [],
          f"{what}: a parameter got no gradient")
    check(cos >= GRAD_COSINE_MIN, f"{what}: kernel vs plain gradient cosine {cos} < "
          f"{GRAD_COSINE_MIN}")
    del kern, plain
    tr = Trainer(cfg, seed=0)
    losses_fall(tr, batch, what)
    updates = []
    hooks = [m.register_forward_hook(lambda mod, i, o: updates.append(mod.update_stats))
             for m in tr.model.modules() if isinstance(m, FlaxBatchNorm)]
    launches = step_launches(tr, batch, expected, what)
    launches["edge_conv_f32"] = f32_launches(launches, cfg.tfea, what)
    for h in hooks:
        h.remove()
    print_step_times(tr, cfg, BATCHES, what)
    torch.cuda.empty_cache()
    return tr, launches, sum(updates)


def phase_heads():
    """The dist and att heads and LPDNet's T-Nets (ROADMAP A7), full width,
    bf16, N = 1024:

    1. att on the committed checkpoint (VcpAtt at its identity init) served
       through Registrar over the 73 pairs: rot RMSE within 0.25 deg
       (iter=1) and 0.1 deg (iter=3) of the topK head on the same pairs; the
       launches of a 1-pair request: the topK request's without vcp_stream;
    2. dist and att from a seeded init: gradient cosine to the plain route,
       the loss falling over 20 Adam steps, the launches of a step, the step
       time at B = 8 and 64;
    3. VCR-Net with t3d and tfea: the same four checks, the T-Nets' running
       statistics updated once a step (both clouds in one stacked call);
       after the steps served at iter=3 through both routes (median rotation
       between them per pair <= 0.5 deg, printed beside that limit), and the
       share of DG-block rows whose selection on the kernel route (the edge
       kernel's f32 instance on the f32 space after t_net_fea) equals the
       plain route's f32 selection, >= KNN_ROW_AGREEMENT;
    4. DCP and LPD with both T-Nets: gradient cosine >= 0.99, the launches
       of one step (two embedding calls) and the same share of rows.
    Every edge_conv launch with tfea is the f32 instance's (none without:
    the dist and att steps). Returns the launches of the steps and requests
    counted, the f32 instance's under ``edge_conv_f32``."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    total = {}
    state_dict = load_checkpoint(CHECKPOINT)
    data = shapes_eval_set(sum(REQUESTS), num_points=N)
    requests = split_requests(data, REQUESTS)
    for n_iter, base in ((1, LAUNCHES_ITER1), (3, LAUNCHES_ITER3)):
        top = Registrar(Config(compute_dtype="bfloat16", iter=n_iter, num_points=N), state_dict)
        att = Registrar(Config(compute_dtype="bfloat16", iter=n_iter, num_points=N,
                               vcp_nn="att"), att_state_dict(state_dict))
        check(att.model.use_kernels, "heads: att not on the kernel route")
        serve_all(att, requests)  # warm-up
        add_launches(total, one_request_launches(att, *requests[0], {**base, "vcp_stream": 0},
                                                 f"heads att iter={n_iter}"))
        acc_att = accuracy(*serve_all(att, requests), data)
        acc_top = accuracy(*serve_all(top, requests), data)
        diff = abs(acc_att["rot_rmse_deg"] - acc_top["rot_rmse_deg"])
        print(f"heads att on the checkpoint, iter={n_iter}: att {acc_att} topK {acc_top}; rot "
              f"RMSE differs by {diff} deg", flush=True)
        check(diff <= HEADS_ROUTE_DEG[n_iter], f"heads att iter={n_iter}: rot RMSE {diff} deg "
              f"from the topK head's (> {HEADS_ROUTE_DEG[n_iter]})")
        print_latency(att, requests[:1], f"heads att iter={n_iter}")
    del top, att

    for vcp_nn in ("dist", "att"):
        cfg = Config(compute_dtype="bfloat16", num_points=N, vcp_nn=vcp_nn)
        _, launches, _ = train_head_config(cfg, f"heads {vcp_nn}", HEAD_TRAIN_LAUNCHES)
        add_launches(total, launches)
        torch.cuda.empty_cache()

    cfg = Config(compute_dtype="bfloat16", num_points=N, **TNETS)
    tr, launches, updates = train_head_config(cfg, "heads t-nets", TRAIN_LAUNCHES)
    add_launches(total, launches)
    print(f"heads t-nets: BatchNorm updates in one step {updates} ({TNET_BATCHNORMS} "
          f"BatchNorms, both clouds in one stacked call)", flush=True)
    check(updates == TNET_BATCHNORMS, f"heads t-nets: {updates} BatchNorm updates in a step, "
          f"expected {TNET_BATCHNORMS}")
    weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    del tr
    scfg = Config(compute_dtype="bfloat16", iter=3, num_points=N, **TNETS)
    reg = Registrar(scfg, weights)
    plain = Registrar(scfg, weights, use_kernels=False)
    check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
    serve_all(reg, requests)  # warm-up
    request = one_request_launches(reg, *requests[0], LAUNCHES_ITER3, "heads t-nets iter=3")
    request["edge_conv_f32"] = f32_launches(request, True, "heads t-nets iter=3")
    add_launches(total, request)
    R, t = serve_all(reg, requests)
    R_p, t_p = serve_all(plain, requests)
    between = pair_rot_errors_deg(R, R_p.astype(np.float64))
    print(f"heads t-nets iter=3: rotation between the routes' results per pair: median "
          f"{float(np.median(between))} deg (limit {TNET_ROUTE_ROT_DEG}) max "
          f"{float(between.max())} deg; max |dt| {float(np.abs(t - t_p).max())}; kernels "
          f"{accuracy(R, t, data)} plain {accuracy(R_p, t_p, data)}", flush=True)
    check(float(np.median(between)) <= TNET_ROUTE_ROT_DEG, f"heads t-nets: routes differ by "
          f"more than {TNET_ROUTE_ROT_DEG} deg (median)")
    tnet_rows_agree(reg.model, data["src"], "heads t-nets")
    print_latency(reg, requests, "heads t-nets iter=3")
    del reg, plain
    torch.cuda.empty_cache()

    for model, expected in (("dcp", DCP_TNET_LAUNCHES), ("lpd", LPD_TNET_LAUNCHES)):
        what = f"heads t-nets {model}"
        cfg = Config(model=model, compute_dtype="bfloat16", num_points=N, **TNETS)
        batch = _train_batch(cfg, 8, seed=1)
        cos, _, kern, plain = grad_cosine(cfg, batch, what)
        check(kern.grads_filled == [] and plain.grads_filled == [],
              f"{what}: a parameter got no gradient")
        check(cos >= GRAD_COSINE_MIN, f"{what}: kernel vs plain gradient cosine {cos} < "
              f"{GRAD_COSINE_MIN}")
        del plain
        launches = step_launches(kern, batch, expected, what)
        launches["edge_conv_f32"] = f32_launches(launches, True, what)
        add_launches(total, launches)
        tnet_rows_agree(kern.model, data["src"], what)
        del kern
        torch.cuda.empty_cache()
    return total


def phase_cli():
    """The port's CLI (ROADMAP A8b), called in this process
    (``vcrnet_tpu_torch.cli.main``) from a scratch working directory:

    1. ``--eval --iter 3 --compute_dtype bfloat16 --dataset synthetic_shapes
       --model_path <the committed checkpoint>``: its printed summary equals
       ``Trainer.eval_epoch`` on the same loader's, and its rot RMSE lies
       within 0.1 deg of the same call with ``--no-use_kernels``; the
       launches of the eval;
    2. a one-epoch fit at full width, bf16, N = 1024, B = 8 with its run
       directory, ``history.json`` and ``models/``; its launches;
    3. ``--model icp`` without ``--eval`` prints "icp can't be trained";
    4. ``--emb_dims 64`` exits with the attention gate's message.
    Returns the launches of the eval and the fit."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from vcrnet_tpu_torch import cli, ops
    from vcrnet_tpu_torch.data.pipeline import make_loaders
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.train.checkpoint import load_checkpoint

    total = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(HERE, "build"))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        argv = ["--eval", "--iter", "3", "--compute_dtype", "bfloat16", "--dataset",
                "synthetic_shapes", "--model_path", CHECKPOINT]
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        np.random.seed(cfg.seed)
        _, test = make_loaders(cfg)
        ref = Trainer(cfg)
        load_checkpoint(CHECKPOINT, ref)
        want = ref.eval_epoch(test)
        del ref
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got = cli.main(argv)
        eval_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        printed = json.dumps(got, indent=2, default=float)
        runs = sorted(os.listdir(os.path.join("checkpoints", "test")))
        log = open(os.path.join("checkpoints", "test", runs[-1], "run.log")).read()
        print(f"cli eval (iter=3, {len(test.dataset)} pairs, {len(test)} batches) in {eval_s} s: "
              f"rot_ab_RMSE {got['rot_ab_RMSE']} trans_ab_RMSE {got['trans_ab_RMSE']}; "
              f"launches {launches}", flush=True)
        check(printed in log and "==FINAL TEST==" in log and log.rstrip().endswith("FINISH"),
              "cli eval: the summary is not in run.log")
        check(printed == json.dumps(want, indent=2, default=float),
              f"cli eval: the summary differs from Trainer.eval_epoch's: {got} vs {want}")
        check_launches(launches, {k: n * len(test) for k, n in LAUNCHES_ITER3.items()},
                       "cli eval")
        add_launches(total, launches)
        plain = cli.main(argv + ["--no-use_kernels"])
        diff = abs(plain["rot_ab_RMSE"] - got["rot_ab_RMSE"])
        print(f"cli eval --no-use_kernels: rot_ab_RMSE {plain['rot_ab_RMSE']}; the routes "
              f"differ by {diff} deg", flush=True)
        check(diff <= CLI_ROUTE_DEG, f"cli eval: kernels vs --no-use_kernels {diff} deg > "
              f"{CLI_ROUTE_DEG}")

        fit_argv = ["--compute_dtype", "bfloat16", "--dataset", "synthetic_shapes", "--epochs",
                    "1", "--batch_size", "8", "--num_points", str(N)]
        fcfg = cli.config_from_args(cli.build_parser().parse_args(fit_argv))
        train, test = make_loaders(fcfg)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        history = cli.main(fit_argv)
        fit_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        run = os.path.join("checkpoints", "train", sorted(os.listdir(
            os.path.join("checkpoints", "train")))[-1])
        saved = sorted(os.listdir(os.path.join(run, "models")))
        print(f"cli fit of one epoch ({len(train)} steps of 8, {len(test.dataset)} test pairs) "
              f"in {fit_s} s: {history}; {run}: {sorted(os.listdir(run))}, models/ {saved}; "
              f"launches {launches}", flush=True)
        check(len(history) == 1 and math.isfinite(history[0]["test"]["loss_pose"]),
              "cli fit: no finite test loss")
        check(json.load(open(os.path.join(run, "history.json")))[0]["epoch"] == 0,
              "cli fit: history.json")
        check({"model.0.pt", "model.best.pt", "fit_state.json"} <= set(saved),
              "cli fit: models/ lacks a checkpoint")
        check_launches(launches, {k: TRAIN_LAUNCHES.get(k, 0) * len(train)
                                  + LAUNCHES_ITER1.get(k, 0) * len(test)
                                  for k in set(TRAIN_LAUNCHES) | set(LAUNCHES_ITER1)},
                       "cli fit")
        add_launches(total, launches)

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = cli.main(["--model", "icp", "--dataset", "synthetic_shapes"])
        print(f"cli --model icp: {out.getvalue().splitlines()[-1]!r}", flush=True)
        check(result is None and "icp can't be trained" in out.getvalue(),
              "cli: icp trained")
        try:
            cli.main(["--emb_dims", "64", "--compute_dtype", "bfloat16", "--dataset",
                      "synthetic_shapes"])
        except SystemExit as refusal:
            message = str(refusal)
        else:
            message = ""
        print(f"cli --emb_dims 64: {message!r}", flush=True)
        check("ops/attention.py::flash_packed_supported" in message and "dk = 128" in message,
              "cli: --emb_dims 64 was not refused by the attention gate")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# the rest of the serving API: warmup, compiled_buckets and exported artifacts
# ---------------------------------------------------------------------------

EXPORT_BUCKET = 8       # the main artifact: bucket 8 at iter=3 exact
EXPORT_REQUESTS = 9     # requests of 8 pairs: the first 72 of the 73 pairs
# PR 12's per-request latencies of the serve and refine phases (ms, 1 / 8 / 64
# pairs; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
PR12_LATENCY_MS = {1: (6.87, 6.38, 24.21), 3: (18.38, 13.78, 59.79)}
# the other forward ops in an artifact: (name, Config fields, bucket, the
# environment while tracing, the launches of one request); DGCNN and the fused
# pointer at iter=1, whose graphs trace in less than half iter=3's time
EXPORT_CONFIGS = (
    ("reuse_refresh1", dict(iter=3, num_points=N, **REFINE_CONFIGS["reuse_refresh1"][0]), 1,
     {}, {**LAUNCHES_ITER3, **REFINE_CONFIGS["reuse_refresh1"][1]}),
    ("partial 3072", dict(iter=3, num_points=NUM_POINTS_LARGE, partial=True, overlap=0.575), 8,
     {}, LAUNCHES_PARTIAL_LARGE),
    ("dgcnn", dict(iter=1, num_points=N, emb_nn="dgcnn"), 1, {}, DGCNN_SERVE_LAUNCHES[1]),
    ("fused pointer", dict(iter=1, num_points=N), 1, {"VCRNET_FUSED_POINTER": "1"},
     FUSED_LAUNCHES[1]),
)
# a fresh process loads an artifact with the port's model code unimportable
FRESH_LOAD = r'''
import importlib.abc, importlib.machinery, json, sys

MODEL_CODE = tuple(f"vcrnet_tpu_torch.{m}" for m in ("models", "config", "train", "data"))


class Absent(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, name, path, target=None):
        if any(name == m or name.startswith(m + ".") for m in MODEL_CODE):
            return importlib.machinery.ModuleSpec(name, self)
        return None

    def create_module(self, spec):
        raise ImportError(f"No module named {spec.name!r}")

    def exec_module(self, module):
        pass


sys.meta_path.insert(0, Absent())
import numpy as np
import torch

from vcrnet_tpu_torch import ops
from vcrnet_tpu_torch.exported import load_exported

torch.backends.cuda.matmul.allow_tf32 = False
reg = load_exported(sys.argv[1])
clouds = np.load(sys.argv[2])
ops.reset_launch_counts()
outs = [reg.register(s, t) for s, t in zip(clouds["src"], clouds["tgt"])]
np.savez(sys.argv[3], R=np.stack([o["R"] for o in outs]), t=np.stack([o["t"] for o in outs]))
loaded = sorted(m for m in sys.modules if m.startswith("vcrnet_tpu_torch."))
print(json.dumps({"device": str(reg.device), "launches": ops.launch_counts(), "modules": loaded}))
'''
# the same artifact where no card is visible: the load must fail
NO_CARD_LOAD = r'''
import sys
from vcrnet_tpu_torch.exported import load_exported
reg = load_exported(sys.argv[1])
print("loaded on", reg.device, "and registered", reg.register(*[__import__("numpy").zeros(
    (reg.batch, reg.n_points, 3), "float32")] * 2)["R"].shape)
'''


def start_logged(cmd, log: str, env):
    """Start ``cmd`` from the checkout with its stdout and stderr in files
    (``log``.out, ``log``.err), so that no pipe fills while it runs."""
    with open(log + ".out", "w") as out, open(log + ".err", "w") as err:
        return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=out, stderr=err, text=True)


def finish_logged(proc, log: str, timeout: float = 600) -> tuple:
    """Wait for a :func:`start_logged` process; its (stdout, stderr)."""
    proc.wait(timeout=timeout)
    with open(log + ".out") as out, open(log + ".err") as err:
        return out.read(), err.read()


def export_checked(reg, bucket: int, expected: dict, what: str, path=None):
    """Export ``bucket``, load the bytes, and hold the graph's op nodes to
    ``expected``. Returns (loaded artifact, bytes, export seconds)."""
    from vcrnet_tpu_torch.exported import load_exported
    from vcrnet_tpu_torch.ops.library import op_counts

    t0 = time.perf_counter()
    blob = reg.export_bucket(bucket, path=path)
    seconds = time.perf_counter() - t0
    loaded = load_exported(blob)
    nodes = op_counts(loaded.program.graph)
    print(f"export {what}: bucket {bucket}, {len(blob)} bytes, exported in {seconds} s; "
          f"op nodes of the graph: {nodes}", flush=True)
    check(nodes == {k: n for k, n in expected.items() if n}, f"export {what}: op nodes {nodes}, "
          f"expected {expected}")
    check((loaded.batch, loaded.n_points) == (bucket, reg.n_points) and loaded.device.type == "cuda",
          f"export {what}: artifact takes {loaded.batch, loaded.n_points} on {loaded.device}")
    return loaded, blob, seconds


def artifact_launches(loaded, src, tgt, expected: dict, what: str) -> tuple:
    """One call of a loaded artifact: (its results, its launches), the
    launches held to ``expected``."""
    import torch

    from vcrnet_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = loaded.register(src, tgt)
    launches = ops.launch_counts()
    print(f"export {what}: launches of one artifact call: {launches}", flush=True)
    check_launches(launches, expected, f"export {what}")
    return out, launches


def same_results(got: dict, want: dict, what: str) -> None:
    import numpy as np

    diff = max(float(np.abs(got[k] - want[k]).max()) for k in ("R", "t"))
    equal = all(np.array_equal(got[k], want[k]) for k in ("R", "t"))
    print(f"export {what}: artifact against the live Registrar: bit-equal {equal}, "
          f"max |diff| {diff}", flush=True)
    check(equal, f"export {what}: R and t differ from the live Registrar's by {diff}")


def call_us(fn, reps: int = 2000) -> float:
    """Host time of one call in microseconds, over ``reps`` calls in a row."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


# the op handle and the implementation behind it, by module: the pairs that
# direct_calls swaps to take the dispatcher out of a wrapper's path
OP_IMPLS = {"attention": ("flash_packed",), "colmass": ("softmax_colmass",),
            "dgcnn": ("dgcnn_eval",), "knn": ("knn",),
            "edgeconv": ("knn_gather_max", "gather_max_from_idx", "edge_conv",
                         "edge_conv_from_idx"),
            "pointer": ("fused_mha", "fused_ff"), "vcp": ("vcp_stream",),
            "int8_linear": ("int8_linear",)}


class direct_calls:
    """While active, each wrapper calls its op's implementation as a plain
    Python function, around torch's dispatcher: the path the wrappers took
    before the kernels were ops. For measuring the dispatcher's cost."""

    def __enter__(self):
        import importlib

        self.saved = []
        for mod_name, names in OP_IMPLS.items():
            mod = importlib.import_module(f"vcrnet_tpu_torch.ops.{mod_name}")
            for name in names:
                self.saved.append((mod, f"_{name}_op", getattr(mod, f"_{name}_op")))
                setattr(mod, f"_{name}_op", getattr(mod, f"_{name}_impl"))
        return self

    def __exit__(self, *exc):
        for mod, attr, op in self.saved:
            setattr(mod, attr, op)


def print_dispatch_cost(state_dict, requests) -> None:
    """One op call against one call of its implementation with the
    dispatcher bypassed and one bare extension call (flash_packed at B = 1,
    64 rows, one head: a launch the host outruns), then the 1 / 8 / 64-pair
    latencies at iter=1 and iter=3 through the ops and with the dispatcher
    bypassed, in turns (ops, bypassed, bypassed, ops), beside PR 12's."""
    import torch

    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.ops import _build, attention
    from vcrnet_tpu_torch.serve import Registrar

    q = torch.randn(1, 64, 128, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(q)
    ext = _build.extension()
    calls = {
        "op": lambda: attention._flash_packed_op(q, q, q, 0.1, 1, False, None),
        "implementation": lambda: attention._flash_packed_impl(q, q, q, 0.1, 1, False, None),
        "extension": lambda: ext.flash_packed(q, q, q, out, None, 64, 1, 0.1),
    }
    times = {name: [] for name in calls}
    for name in ("op", "implementation", "extension", "extension", "implementation", "op"):
        times[name].append(call_us(calls[name]))
    print(f"export dispatch: host time of one flash_packed call, us (two runs of 2000 each, in "
          f"turns): {times}; the dispatcher adds "
          f"{statistics.mean(times['op']) - statistics.mean(times['implementation'])} us a "
          f"launch", flush=True)
    for n_iter in (1, 3):
        reg = Registrar(Config(compute_dtype="bfloat16", iter=n_iter, num_points=N), state_dict)
        reg.warmup([len(src) for src, _ in requests])
        lat = {"ops": {}, "bypassed": {}}
        for route in ("ops", "bypassed", "bypassed", "ops"):
            with direct_calls() if route == "bypassed" else contextlib.nullcontext():
                for src, tgt in requests:
                    runs = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        reg.register(src, tgt)
                        runs.append((time.perf_counter() - t0) * 1e3)
                    lat[route].setdefault(len(src), []).append(statistics.median(runs))
        for (b, ops_ms), pr12 in zip(lat["ops"].items(), PR12_LATENCY_MS[n_iter]):
            print(f"export dispatch iter={n_iter}: request of {b} pairs: median latency through "
                  f"the ops {ops_ms} ms, dispatcher bypassed {lat['bypassed'][b]} ms (two turns "
                  f"each); PR 12: {pr12} ms", flush=True)
        del reg


def phase_export():
    """The rest of the serving API (ROADMAP A8c), full width, bf16, the
    committed checkpoint:

    1. ``Registrar.warmup()`` at iter=3 over all seven buckets: each bucket's
       first run and its second, timed; ``compiled_buckets`` lists all seven;
    2. bucket 8 at iter=3 exact exported to bytes and to a file (size and
       export time printed): its graph's op nodes equal LAUNCHES_ITER3, as
       do the launches of one call of the loaded artifact; the first 72 of
       the 73 pairs in 9 requests through the artifact loaded here and in a
       fresh process in which the port's models, config, train and data
       cannot be imported, R and t equal to the live Registrar's bit for bit;
       iter=0 refuses to export; the artifact fails to load in a process
       that sees no card;
    3. reuse refresh 1 (edge_conv_from_idx), partial at 3072 points
       (softmax_colmass), VCR-Net on DGCNN with seeded weights (knn,
       dgcnn_eval; iter=1) and VCRNET_FUSED_POINTER=1 while tracing
       (fused_mha, fused_ff; iter=1; the variable unset when the artifact
       runs), while the two processes of 2 run: op nodes and
       the launches of one artifact call equal their launch tables, results
       equal the live Registrar's;
    4. the dispatcher's cost: one op call against its implementation called
       directly and a bare extension call, and the 1 / 8 / 64-pair latencies
       at iter=1 and iter=3 with the dispatcher in and bypassed, in turns,
       beside PR 12's.
    Returns the launches of the artifact calls."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.models import VCRNet
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    state_dict = load_checkpoint(CHECKPOINT)
    tmp = tempfile.mkdtemp(prefix="export_", dir=os.path.join(HERE, "build"))
    total, procs = {}, []
    try:
        # --- 1. warmup over the seven buckets
        reg = Registrar(Config(compute_dtype="bfloat16", iter=3, num_points=N), state_dict)
        check(reg.compiled_buckets == [], "a fresh Registrar lists buckets that have not run")
        first, second = {}, {}
        for runs in (first, second):
            for bucket in reg._buckets:
                t0 = time.perf_counter()
                reg.warmup([bucket])
                runs[bucket] = (time.perf_counter() - t0) * 1e3
        print(f"export warmup iter=3: first run of each bucket {first} ms; second {second} ms",
              flush=True)
        check(reg.compiled_buckets == [1, 2, 4, 8, 16, 32, 64],
              f"warmup left compiled_buckets at {reg.compiled_buckets}")

        # --- 2. the main artifact: bucket 8, iter=3 exact
        data = shapes_eval_set(sum(REQUESTS), num_points=N)
        n = EXPORT_BUCKET * EXPORT_REQUESTS
        src = data["src"][:n].reshape(EXPORT_REQUESTS, EXPORT_BUCKET, N, 3)
        tgt = data["tgt"][:n].reshape(EXPORT_REQUESTS, EXPORT_BUCKET, N, 3)
        path = os.path.join(tmp, "bucket8_iter3.pt2")
        loaded, blob, _ = export_checked(reg, EXPORT_BUCKET, LAUNCHES_ITER3, "iter=3 bucket 8",
                                         path=path)
        with open(path, "rb") as fh:
            check(fh.read() == blob, "export: the file and the bytes differ")
        live = [reg.register(s, t) for s, t in zip(src, tgt)]
        _, launches = artifact_launches(loaded, src[0], tgt[0], LAUNCHES_ITER3, "iter=3 bucket 8")
        total = dict(launches)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = [loaded.register(s, t) for s, t in zip(src, tgt)]
        add_launches(total, ops.launch_counts())
        stack = {k: np.stack([o[k] for o in got]) for k in ("R", "t")}
        want = {k: np.stack([o[k] for o in live]) for k in ("R", "t")}
        same_results(stack, want, "iter=3 bucket 8, 72 pairs in this process")
        acc = accuracy(stack["R"].reshape(n, 3, 3), stack["t"].reshape(n, 3),
                       {k: v[:n] for k, v in data.items()})
        print(f"export iter=3 bucket 8: the artifact's accuracy over {n} pairs: {acc}", flush=True)
        check(acc["rot_rmse_deg"] <= ROT_LIMIT_ITER3_DEG, f"export: rot RMSE {acc}")

        # a fresh process, and one that sees no card, load the artifact while
        # this one exports the others
        clouds = os.path.join(tmp, "clouds.npz")
        np.savez(clouds, src=src, tgt=tgt)
        results = os.path.join(tmp, "fresh.npz")
        t_fresh = time.perf_counter()
        fresh = start_logged([sys.executable, "-c", FRESH_LOAD, path, clouds, results],
                             os.path.join(tmp, "fresh"), dict(os.environ, PYTHONPATH=HERE))
        no_card = start_logged([sys.executable, "-c", NO_CARD_LOAD, path],
                               os.path.join(tmp, "no_card"),
                               dict(os.environ, PYTHONPATH=HERE, CUDA_VISIBLE_DEVICES=""))
        procs += [fresh, no_card]
        try:
            Registrar(Config(compute_dtype="bfloat16", iter=0, num_points=N),
                      state_dict).export_bucket(1)
        except ValueError as e:
            print(f"export iter=0: export_bucket refuses net + ICP: {e}", flush=True)
            check("host" in str(e), f"export iter=0: the refusal does not name its reason: {e}")
        else:
            raise RuntimeError("export iter=0: export_bucket exported net + ICP")
        del reg, loaded, live, got

        # --- 3. the other forward ops in an artifact
        for what, fields, bucket, env, expected in EXPORT_CONFIGS:
            cfg = Config(compute_dtype="bfloat16", **fields)
            weights = state_dict
            if cfg.emb_nn == "dgcnn":  # the repository has no DGCNN weights: a seeded init
                torch.manual_seed(0)
                weights = VCRNet(cfg).state_dict()
            if cfg.partial:
                pairs = shapes_eval_set(bucket, num_points=NUM_POINTS_LARGE,
                                        cloud_points=NUM_POINTS_LARGE + 3, partial=True)
                s, t = pairs["src"], pairs["tgt"]
            else:
                s, t = src[0][:bucket], tgt[0][:bucket]
            reg = Registrar(cfg, weights, buckets=(bucket,))
            os.environ.update(env)
            try:
                loaded, _, _ = export_checked(reg, bucket, expected, what)
                live = reg.register(s, t)
            finally:
                for key in env:
                    del os.environ[key]
            # the environment is back as it was: the artifact keeps its route
            got, launches = artifact_launches(loaded, s, t, expected, what)
            add_launches(total, launches)
            same_results(got, live, what)
            del reg, loaded
        torch.cuda.empty_cache()

        out, err = finish_logged(fresh, os.path.join(tmp, "fresh"))
        check(fresh.returncode == 0, f"export: the fresh process failed:\n{out}\n{err}")
        report = json.loads(out.strip().splitlines()[-1])
        print(f"export fresh process (ended {time.perf_counter() - t_fresh} s after its start): "
              f"{report}", flush=True)
        check(not any(m.split(".")[1] in ("models", "config", "train", "data")
                      for m in report["modules"]), "export: the fresh process loaded model code")
        check_launches(report["launches"], {k: v * EXPORT_REQUESTS for k, v in LAUNCHES_ITER3.items()},
                       "export fresh process, 9 requests")
        same_results(dict(np.load(results)), want, "iter=3 bucket 8, 72 pairs in a fresh process")
        out, err = finish_logged(no_card, os.path.join(tmp, "no_card"))
        last = (err.strip().splitlines() or [""])[-1]
        print(f"export without a visible card: exit {no_card.returncode}: {last}", flush=True)
        check(no_card.returncode != 0 and "loaded on" not in out,
              f"export: the card's artifact loaded where no card is visible:\n{out}")

        # --- 4. the dispatcher's cost
        print_dispatch_cost(state_dict, split_requests(data, REQUESTS))
    finally:
        for proc in procs:  # stopped, where a check failed before they were read
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


PARALLEL_WORLD = 2
PARALLEL_BATCHES = (64, 62)  # 62 pads to 64 at two ranks: rank 1 holds 2 rows at valid 0
PARALLEL_NCCL_DCP_BATCH = 8
PARALLEL_EVAL_PAIRS = 128    # two eval batches of 64 (32 a rank)
PARALLEL_COSINE_MIN = 0.9999  # all-reduced gradient against one process on the whole batch
PARALLEL_STATE_REL = 1e-2    # parameters and running statistics after the step, of the largest
PARALLEL_EVAL_REL = 1e-2     # eval summary's RMSEs, world 2 against world 1
PARALLEL_PAIR_ROT_DEG = {"median": 0.05, "max": 0.5}  # mesh Registrar against one device
PARALLEL_PAIR_TRANS = 0.005
PARALLEL_RANK_TIMEOUT_S = 300
# the kernels of the table in PERF.md marked "on path" for this phase: every
# one of them must launch in the ranks' steps and evals or the mesh Registrar
PARALLEL_ON_PATH = ("knn_gather_max", "edge_conv", "gather_max_bwd", "edge_conv_bwd",
                    "gather_max_from_idx", "flash_packed", "flash_bwd", "vcp_stream", "vcp_bwd",
                    "knn", "dgcnn_eval")


def _parallel_configs() -> dict:
    from vcrnet_tpu_torch.config import Config

    return {"vcrnet": Config(compute_dtype="bfloat16", num_points=N, use_sgd=True),
            "dcp": Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N,
                          use_sgd=True),
            "vcrnet_eval": Config(compute_dtype="bfloat16", num_points=N, iter=3)}


def run_parallel_tasks(tasks: list) -> dict:
    """The parallel phase's work in this process, the same in a rank and in
    the single process it is held to: for each (name, kind, config, data)
    a "step" (a seeded Trainer, ``compute_grads`` on the global batch, one
    SGD step: the flat gradient, parameters and running statistics on the
    host) or an "eval" (``eval_epoch`` over the batches; VCR-Net on the
    committed checkpoint)."""
    import torch

    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    configs = _parallel_configs()
    out = {}
    for name, kind, cfg_name, data in tasks:
        t0 = time.perf_counter()
        cfg = configs[cfg_name]
        tr = Trainer(cfg, seed=0)
        check(tr.model.use_kernels, f"parallel {name}: not on the kernel route")
        if kind == "step":
            tr.compute_grads(data)
            grads = _flat_grads(tr).cpu()
            tr.optimizer.step()
            out[name] = {
                "grads": grads,
                "params": {k: p.detach().float().cpu() for k, p in tr.model.named_parameters()},
                "stats": {k: b.float().cpu() for k, b in tr.model.named_buffers()
                          if "running_" in k},
            }
        else:
            if cfg.model == "vcrnet":
                tr.model.load_state_dict(load_checkpoint(CHECKPOINT))
            out[name] = {"summary": tr.eval_epoch(data)}
        del tr
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the processes of the phase share the card
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def parallel_launches(tasks: list) -> dict:
    """The launches of a rank's tasks: a step's by its model's table, an
    eval epoch's as one request a batch (VCR-Net at iter=3; DCP's eval
    step)."""
    total = {}
    for _, kind, cfg_name, data in tasks:
        if kind == "step":
            add_launches(total, TRAIN_LAUNCHES if cfg_name == "vcrnet" else DCP_TRAIN_LAUNCHES)
        for _ in data if kind == "eval" else ():
            add_launches(total, LAUNCHES_ITER3 if cfg_name == "vcrnet_eval" else DCP_EVAL_LAUNCHES)
    return total


def parallel_rank(store: str, rank: int, world: int, backend: str, job: str, out: str) -> None:
    """One rank of the parallel phase, in a process of its own: LOCAL_RANK 0
    (every rank on the one card), the process group through the FileStore
    ``store``, the extension the parent built, the tasks of ``job`` from
    zero launch counts; writes the results and the counts to ``out``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    sys.path.insert(0, HERE)
    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.ops import _build
    from vcrnet_tpu_torch.parallel import initialize, make_mesh

    initialize(init_method=f"file://{store}", rank=rank, world_size=world, backend=backend,
               timeout=timedelta(seconds=60))
    t_group = time.perf_counter() - t0
    _build.extension()
    t_ext = time.perf_counter() - t0 - t_group
    mesh = make_mesh()
    check((mesh.rank, mesh.size) == (rank, world) and mesh.group is not None,
          f"rank {rank}: mesh {mesh}")
    ops.reset_launch_counts()
    tasks = torch.load(job, weights_only=False)
    results = run_parallel_tasks(tasks)
    results["launches"] = ops.launch_counts()
    check_launches(results["launches"], parallel_launches(tasks), f"parallel rank {rank}")
    if rank > 0:  # one gradient on every rank (checked); one copy of the state is enough
        for res in results.values():
            if isinstance(res, dict) and "seconds" in res:
                res.pop("params", None)
                res.pop("stats", None)
    results["backend"] = dist.get_backend()
    results["seconds"] = {"imports and group": t_group, "extension": t_ext,
                          "tasks": {k: v["seconds"] for k, v in results.items()
                                    if isinstance(v, dict) and "seconds" in v}}
    torch.save(results, out)
    dist.destroy_process_group()


def _start_ranks(tmp: str, tag: str, world: int, backend: str, tasks: list) -> list:
    import torch

    job = os.path.join(tmp, f"{tag}_job.pt")
    torch.save(tasks, job)
    procs = []
    for rank in range(world):
        args = (os.path.join(tmp, f"{tag}_store"), rank, world, backend, job,
                os.path.join(tmp, f"{tag}_out{rank}.pt"))
        log = open(os.path.join(tmp, f"{tag}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.parallel_rank{args!r}"],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT), log, args[-1]))
    return procs


def _join_ranks(procs: list, deadline: float, what: str) -> list:
    """Wait for every rank (killing all at the deadline), then their results."""
    import torch

    try:
        for proc, _, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, log, _) in enumerate(procs):
        if proc.returncode != 0:
            with open(log.name) as f:
                print(f"parallel {what} rank {rank} exited {proc.returncode}:\n{f.read()[-6000:]}",
                      flush=True)
    check(all(proc.returncode == 0 for proc, _, _ in procs), f"parallel {what}: a rank failed")
    return [torch.load(out, weights_only=False) for _, _, out in procs]


def _state_rel(got: dict, want: dict) -> float:
    """Largest difference over the largest value, of all the tensors of the
    dict together (a leaf whose exact gradient is zero stays near zero)."""
    if not want:
        return 0.0
    return rel_err(_cat_flat(got, want), _cat_flat(want, want))


def _cat_flat(tensors: dict, order: dict):
    import torch

    return torch.cat([tensors[k].reshape(-1) for k in order])


def _summary_rel(got: dict, want: dict) -> float:
    keys = ("rot_ab_RMSE", "trans_ab_RMSE", "loss")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys)


def _eval_batches(data: dict, size: int) -> list:
    import numpy as np

    n = len(data["src"])
    return [dict({k: v[lo:lo + size] for k, v in data.items()},
                 valid=np.ones(min(size, n - lo), np.float32)) for lo in range(0, n, size)]


def phase_parallel():
    """Data parallelism on the one card (ROADMAP A9a): the ranks of two
    process groups (two ranks over Gloo, one over NCCL) in processes of
    their own, against this process on the whole batch; then the Registrar
    over a mesh of (cuda:0, cuda:0). Returns the ranks' launches and the
    mesh Registrar's."""
    import tempfile

    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.parallel import make_mesh
    from vcrnet_tpu_torch.parallel.mesh import pad_to_multiple
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    configs = _parallel_configs()
    check((configs["vcrnet"].emb_dims, configs["vcrnet"].n_heads, configs["dcp"].emb_nn)
          == (512, 4, "dgcnn"), "parallel phase must run the full-width configurations")
    batches = {b: {k: v for k, v in _train_batch(configs["vcrnet"], b, seed=3).items()
                   if k != "label"} for b in PARALLEL_BATCHES + (PARALLEL_NCCL_DCP_BATCH,)}
    eval_data = shapes_eval_set(PARALLEL_EVAL_PAIRS, num_points=N)
    evals = _eval_batches(eval_data, 64)
    gloo_tasks = [(f"{m}_{b}", "step", m, batches[b]) for m in ("vcrnet", "dcp")
                  for b in PARALLEL_BATCHES]
    gloo_tasks += [("dcp_eval", "eval", "dcp", evals), ("vcrnet_eval", "eval", "vcrnet_eval", evals)]
    nccl_tasks = [(f"vcrnet_{PARALLEL_BATCHES[0]}", "step", "vcrnet", batches[PARALLEL_BATCHES[0]]),
                  (f"dcp_{PARALLEL_NCCL_DCP_BATCH}", "step", "dcp",
                   batches[PARALLEL_NCCL_DCP_BATCH])]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: three more processes share the card

    # this process on the whole batch, while the ranks run: the 62-pair batch padded
    # as the ranks pad it (BatchNorm's statistics take the padding rows in both)
    ref_tasks = [(name, kind, cfg, pad_to_multiple(dict(data), PARALLEL_WORLD)
                  if kind == "step" else data) for name, kind, cfg, data in gloo_tasks]
    ref_tasks.append(nccl_tasks[1])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gloo = _start_ranks(tmp, "gloo", PARALLEL_WORLD, "gloo", gloo_tasks)
        nccl = _start_ranks(tmp, "nccl", 1, "nccl", nccl_tasks)
        try:
            ref = run_parallel_tasks(ref_tasks)
        except BaseException:
            for proc, log, _ in gloo + nccl:
                proc.kill()
                proc.wait()
                log.close()
            raise
        t_ref = time.perf_counter() - t0
        deadline = time.perf_counter() + PARALLEL_RANK_TIMEOUT_S
        gloo_out = _join_ranks(gloo, deadline, "gloo")
        nccl_out = _join_ranks(nccl, deadline, "nccl")
    print(f"parallel: ranks done in {time.perf_counter() - t0} s (two over "
          f"{gloo_out[0]['backend']}, one over {nccl_out[0]['backend']}, all on cuda:0; this "
          f"process's world-1 runs beside them {t_ref} s); seconds of each rank: "
          f"{[o['seconds'] for o in gloo_out + nccl_out]}", flush=True)

    for what, outs, names in (("gloo x2", gloo_out, [t[0] for t in gloo_tasks]),
                              ("nccl x1", nccl_out, [t[0] for t in nccl_tasks])):
        for name in names:
            want = ref[name]
            if "summary" in want:
                got = outs[0][name]["summary"]
                rel = _summary_rel(got, want["summary"])
                check(all(_summary_rel(o[name]["summary"], got) == 0.0 for o in outs),
                      f"parallel {what} {name}: the ranks' summaries differ")
                print(f"parallel {what} {name}: eval summary rot RMSE {got['rot_ab_RMSE']} deg, "
                      f"trans RMSE {got['trans_ab_RMSE']}, loss {got['loss']} over "
                      f"{got['num_examples']} pairs; world 1: {want['summary']['rot_ab_RMSE']}, "
                      f"{want['summary']['trans_ab_RMSE']}, {want['summary']['loss']}; largest "
                      f"relative difference {rel}", flush=True)
                check(got["num_examples"] == PARALLEL_EVAL_PAIRS, f"{name}: pairs counted")
                check(rel <= PARALLEL_EVAL_REL, f"parallel {what} {name}: summary {rel} from "
                                                f"world 1 > {PARALLEL_EVAL_REL}")
                continue
            got = outs[0][name]
            check(all(torch.equal(o[name]["grads"], got["grads"]) for o in outs),
                  f"parallel {what} {name}: the ranks hold different gradients")
            cos = _cosine(got["grads"], want["grads"])
            p_rel = _state_rel(got["params"], want["params"])
            s_rel = _state_rel(got["stats"], want["stats"])
            print(f"parallel {what} {name}: gradient cosine to one process {cos}, parameters "
                  f"after the SGD step {p_rel} of the largest, running statistics {s_rel} "
                  f"({len(want['stats'])} buffers)", flush=True)
            check(cos >= PARALLEL_COSINE_MIN, f"parallel {what} {name}: cosine {cos}")
            check(p_rel <= PARALLEL_STATE_REL and s_rel <= PARALLEL_STATE_REL,
                  f"parallel {what} {name}: state after the step {p_rel}, {s_rel}")
            check(name.startswith("vcrnet") or len(want["stats"]) == 10,
                  f"parallel {what} {name}: DGCNN's running statistics missing")

    # the Registrar over a mesh of two devices of this process (one card twice)
    state_dict = load_checkpoint(CHECKPOINT)
    cfg = Config(compute_dtype="bfloat16", iter=3, num_points=N)
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    reg = Registrar(cfg, state_dict, mesh=mesh)
    one = Registrar(cfg, state_dict)
    check(reg._buckets == (2, 4, 8, 16, 32, 64) and len(reg.replicas) == 2,
          f"mesh buckets {reg._buckets}")
    src, tgt = eval_data["src"][:64], eval_data["tgt"][:64]
    reg.register(src, tgt)  # first run: the replicas' handles and blocks
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = reg.register(src, tgt)
    serve_launches = ops.launch_counts()
    want = one.register(src, tgt)
    rot = pair_rot_errors_deg(got["R"], want["R"])
    trans = float(np.abs(got["t"] - want["t"]).max())
    print(f"parallel: Registrar over (cuda:0, cuda:0), 64 pairs at iter=3, against one device: "
          f"rotation between results median {float(np.median(rot))} max {float(rot.max())} deg, "
          f"translation {trans}; rot RMSE {rot_rmse_deg(got['R'], eval_data['euler_ab'][:64])} "
          f"deg; launches {serve_launches}", flush=True)
    check(float(np.median(rot)) <= PARALLEL_PAIR_ROT_DEG["median"]
          and float(rot.max()) <= PARALLEL_PAIR_ROT_DEG["max"]
          and trans <= PARALLEL_PAIR_TRANS, "parallel: mesh Registrar differs from one device")
    check(serve_launches == {k: 2 * n for k, n in LAUNCHES_ITER3.items()} | {
        k: 0 for k in ops.KERNELS if k not in LAUNCHES_ITER3},
          f"parallel: mesh Registrar launches {serve_launches}")

    launches = dict(serve_launches)
    for out in gloo_out + nccl_out:
        add_launches(launches, out["launches"])
    print(f"parallel: launches of the ranks and the mesh Registrar: {launches}", flush=True)
    missing = [k for k in PARALLEL_ON_PATH if launches.get(k, 0) == 0]
    check(not missing, f"parallel: on-path kernels never launched: {missing}")
    return launches


SP_POINTS = 4096          # (a)-(c): B = 2 whole clouds of 4096 points
SP_BATCH = 2
SP_PARTIAL_POINTS = 1024  # partial mode: cfg.n_cropped = 768 points at overlap 0.575
SP_LARGE_FORWARD = 16384  # (d): B = 1, the whole-mode forward under no_grad
SP_LARGE_TRAIN = 8192     # (d): B = 1, forward and backward, above gather_max_bwd's 7264
SP_ATOL = 1e-3            # R and t against the single device's plain route (f32)
SP_KERNEL_ROUTE_DEG = 0.25  # against the kernel route (bf16), per pair
SP_COSINE_MIN = 0.9999    # the summed gradient against the single device's
SP_ONE_RANK_ATOL = 1e-6   # the one-rank NCCL group against this process's mesh of itself
SP_RANK_TIMEOUT_S = 420


def _sp_data(b: int, n: int, partial: bool = False) -> dict:
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set

    kw = dict(partial=True, overlap=0.575) if partial else {}
    return shapes_eval_set(b, num_points=n, cloud_points=max(2 * N, n), **kw)


def _sp_model(dev, partial: bool = False, sharpen: bool = False):
    """The committed checkpoint in a full-width f32 VCRNet on the plain
    route; ``sharpen`` scales the decoder's cross-attention queries as the
    partial phase does, so that its re-mask selects by the weights and not
    by rounding."""
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.models.vcrnet import VCRNet
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    kw = dict(partial=True, overlap=0.575) if partial else {}
    model = VCRNet(Config(num_points=N, **kw), device=dev, use_kernels=False)
    state_dict = load_checkpoint(CHECKPOINT)
    if sharpen:
        for name in ("weight", "bias"):
            key = f"pointer.dec_layers.0.src_attn.linear_q.{name}"
            state_dict[key] = state_dict[key] * SHARPEN_CROSS_ATTENTION
    model.load_state_dict(state_dict)
    check((model.cfg.emb_dims, model.cfg.n_heads, model.cfg.ff_dims, model.cfg.n_blocks,
           model.emb_nn.k) == (512, 4, 1024, 1, K), "point sharding: not the full-width model")
    return model.eval()


def run_sp_tasks(tasks: list, mesh, batch_axis=None) -> dict:
    """The point_sharding phase's work on this rank's shards: for each
    (name, kind, data) a "forward" (register_flagship_sp, whole mode under
    no_grad), "partial" (the same in partial mode at overlap 0.575, the
    cross attention sharpened), "whole_sp" (register_whole_sp), "grads" or
    "partial_grads" (sp_value_and_grad of the point loss against the
    pairs' ground truth: the world's summed gradient, flat), each with its
    peak device memory and seconds."""
    import torch

    from vcrnet_tpu_torch.parallel.point_sharding import batch_mesh, shard_points
    from vcrnet_tpu_torch.parallel.sp_flagship import register_flagship_sp, sp_value_and_grad
    from vcrnet_tpu_torch.parallel.sp_model import register_whole_sp

    dev = torch.device("cuda")
    models = {}
    out = {}
    bm = batch_mesh(mesh, batch_axis)
    for name, kind, data in tasks:
        partial = kind.startswith("partial")
        if partial not in models:
            models[partial] = _sp_model(dev, partial=partial, sharpen=partial)
        model = models[partial]
        src, tgt = (shard_points(data[k], mesh, batch_axis, device=dev) for k in ("src", "tgt"))
        rows = slice(None) if bm is None else slice(bm.rank * len(data["src"]) // bm.size,
                                                    (bm.rank + 1) * len(data["src"]) // bm.size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if kind in ("forward", "partial"):
            with torch.no_grad():
                src_k, corr, R, t = register_flagship_sp(model, src, tgt, mesh, batch_axis)
            res = {"R": R.cpu(), "t": t.cpu()}
            if partial:
                res.update(src_k=src_k.cpu(), corr=corr.cpu())
        elif kind == "whole_sp":
            with torch.no_grad():
                _, R, t = register_whole_sp(model, src, tgt, mesh, batch_axis)
            res = {"R": R.cpu(), "t": t.cpu()}
        else:
            R_gt = torch.as_tensor(data["R_ab"][rows], device=dev)
            t_gt = torch.as_tensor(data["t_ab"][rows], device=dev)
            loss, grads = sp_value_and_grad(model, src, tgt, R_gt, t_gt, mesh, batch_axis)
            res = {"loss": float(loss), "grads": torch.cat([g.reshape(-1) for g in grads.values()])
                   .cpu()}
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        res["peak_bytes"] = torch.cuda.max_memory_allocated()
        out[name] = res
    del models
    torch.cuda.empty_cache()  # the processes of the phase share the card
    return out


def point_sharding_rank(store: str, rank: int, world: int, backend: str, grid, job: str,
                        out: str) -> None:
    """One rank of the point_sharding phase, in a process of its own:
    LOCAL_RANK 0 (every rank on the one card), the process group through
    the FileStore ``store``, ``make_mesh()`` or ``make_mesh_2d(*grid)`` with
    the batch axis sharded, the tasks of ``job`` from zero launch counts;
    writes the results and the counts to ``out``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    t0 = time.perf_counter()
    sys.path.insert(0, HERE)
    os.environ["LOCAL_RANK"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.parallel import initialize, make_mesh
    from vcrnet_tpu_torch.parallel.mesh import make_mesh_2d

    initialize(init_method=f"file://{store}", rank=rank, world_size=world, backend=backend,
               timeout=timedelta(seconds=60))
    mesh = make_mesh_2d(*grid) if grid else make_mesh()
    check(mesh.size == world, f"point sharding rank {rank}: mesh of {mesh.size}")
    ops.reset_launch_counts()
    results = run_sp_tasks(torch.load(job, weights_only=False), mesh, "batch" if grid else None)
    results["launches"] = ops.launch_counts()
    results["backend"] = dist.get_backend()
    results["seconds"] = time.perf_counter() - t0
    torch.save(results, out)
    dist.destroy_process_group()


def _start_sp_ranks(tmp: str, tag: str, world: int, backend: str, grid, tasks: list) -> list:
    import torch

    job = os.path.join(tmp, f"{tag}_job.pt")
    torch.save(tasks, job)
    procs = []
    for rank in range(world):
        args = (os.path.join(tmp, f"{tag}_store"), rank, world, backend, grid, job,
                os.path.join(tmp, f"{tag}_out{rank}.pt"))
        log = open(os.path.join(tmp, f"{tag}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.point_sharding_rank{args!r}"],
            cwd=HERE, stdout=log, stderr=subprocess.STDOUT), log, args[-1]))
    return procs


def _rot_between_deg(R_a, R_b):
    return pair_rot_errors_deg(R_a.double().numpy(), R_b.double().numpy())


def _held_forward(what: str, R, t, R_ref, t_ref, atol: float) -> None:
    dR = float((R - R_ref).abs().max())
    dt = float((t - t_ref).abs().max())
    rot = _rot_between_deg(R, R_ref)
    print(f"point_sharding {what}: max |dR| {dR}, max |dt| {dt}, rotation between results "
          f"{rot.tolist()} deg", flush=True)
    check(dR <= atol and dt <= atol, f"point_sharding {what}: {dR}, {dt} > {atol}")


def _mib(nbytes) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


def phase_point_sharding():
    """Point-axis sharding (ROADMAP A9b) on the one card: Gloo ranks of a
    1-D point mesh (two) and of make_mesh_2d(2, 2) (four), and a one-rank
    NCCL group, in processes of their own, against this process's
    single-device model on the whole clouds; then forwards and a training
    step at cloud sizes the kernel route refuses, with each rank's peak
    memory. Returns the ranks' launches (the path is plain PyTorch, as the
    JAX package's is XLA: none)."""
    import tempfile

    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.models.vcrnet import VCRNet
    from vcrnet_tpu_torch.parallel import make_mesh
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    dev = torch.device("cuda")
    whole = _sp_data(SP_BATCH, SP_POINTS)
    part = _sp_data(SP_BATCH, SP_PARTIAL_POINTS, partial=True)
    check(part["src"].shape[1] == 768 and part["src"].shape[1] % 2 == 0,
          f"point sharding: partial clouds of {part['src'].shape[1]} points")
    large = _sp_data(1, SP_LARGE_FORWARD)
    large_train = _sp_data(1, SP_LARGE_TRAIN)
    gloo2 = [("whole", "forward", whole), ("whole_sp", "whole_sp", whole),
             ("partial", "partial", part), ("grads", "grads", whole),
             ("partial_grads", "partial_grads", part)]
    grid_tasks = [("whole", "forward", whole), ("grads", "grads", whole)]
    large_tasks = [("large_forward", "forward", large), ("large_train", "grads", large_train)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: nine more processes share the card

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {"gloo x2": _start_sp_ranks(tmp, "gloo2", 2, "gloo", None, gloo2),
                "gloo 2x2": _start_sp_ranks(tmp, "grid", 4, "gloo", (2, 2), grid_tasks),
                "nccl x1": _start_sp_ranks(tmp, "nccl", 1, "nccl", None, grid_tasks),
                "gloo x2 large": _start_sp_ranks(tmp, "large", 2, "gloo", None, large_tasks)}
        try:
            # this process on the whole clouds, meanwhile: the single device's plain
            # route (f32) and kernel route (bf16), and the one-rank tasks on a mesh
            # of this process alone
            model = _sp_model(dev)
            ref = {"self": run_sp_tasks(grid_tasks, make_mesh())}
            src, tgt = (torch.as_tensor(whole[k], device=dev) for k in ("src", "tgt"))
            with torch.no_grad():
                ref["whole"] = model(src, tgt)[2:4]
                kernel = VCRNet(Config(num_points=N, compute_dtype="bfloat16"), device=dev)
                kernel.load_state_dict(load_checkpoint(CHECKPOINT))
                check(kernel.use_kernels, "point sharding: the kernel route is off")
                ref["kernel"] = kernel.eval()(src, tgt)[2:4]
                del kernel
                ident = VCRNet(Config(num_points=N, pointer="identity"), device=dev,
                               use_kernels=False)
                ident.load_state_dict({k: v for k, v in load_checkpoint(CHECKPOINT).items()
                                       if not k.startswith("pointer.")})
                ref["whole_sp"] = ident.eval()(src, tgt)[2:4]
                del ident
                pmodel = _sp_model(dev, partial=True, sharpen=True)
                psrc, ptgt = (torch.as_tensor(part[k], device=dev) for k in ("src", "tgt"))
                ref["partial"] = pmodel(psrc, ptgt)[:4]
                del pmodel
            model.zero_grad(set_to_none=True)
            out = model(src, tgt)
            moved = (torch.einsum("bij,bnj->bni", torch.as_tensor(whole["R_ab"], device=dev),
                                  out[0]) + torch.as_tensor(whole["t_ab"], device=dev)[:, None])
            loss = ((moved - out[1]) ** 2).mean()
            loss.backward()
            ref["loss"] = float(loss.detach())
            ref["grads"] = torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu()
            del model, out, moved, loss
            torch.cuda.empty_cache()
            # (d)'s baselines, each peak less what this process held before it: the
            # sharded path at world 1 (a mesh of this process), and the plain route
            ref["large_base"] = torch.cuda.memory_allocated()
            ref["large_w1"] = run_sp_tasks(large_tasks, make_mesh())
            torch.cuda.reset_peak_memory_stats()
            big = _sp_model(dev)
            with torch.no_grad():
                lsrc, ltgt = (torch.as_tensor(large[k], device=dev) for k in ("src", "tgt"))
                ref["large"] = big(lsrc, ltgt)[2:4]
            torch.cuda.synchronize()
            ref["large_peak"] = torch.cuda.max_memory_allocated()
            del big, lsrc, ltgt
            torch.cuda.empty_cache()
            t_ref = time.perf_counter() - t0
            deadline = time.perf_counter() + SP_RANK_TIMEOUT_S
            outs = {what: _join_ranks(procs, deadline, f"point_sharding {what}")
                    for what, procs in jobs.items()}
        finally:  # a failed job, or a failure here, leaves no rank on the card
            for procs in jobs.values():
                for proc, log, _ in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    log.close()
    print(f"point_sharding: ranks done in {time.perf_counter() - t0} s (this process's "
          f"references beside them {t_ref} s); seconds of each rank: "
          f"{ {what: [o['seconds'] for o in o_] for what, o_ in outs.items()} }; backends "
          f"{ {what: o_[0]['backend'] for what, o_ in outs.items()} }", flush=True)

    R_ref, t_ref_ = (x.cpu() for x in ref["whole"])
    R_kernel = ref["kernel"][0].cpu()
    for what in ("gloo x2", "gloo 2x2", "nccl x1"):
        o_ = outs[what]
        R = torch.cat([o["whole"]["R"] for o in o_]) if what == "gloo 2x2" else o_[0]["whole"]["R"]
        t = torch.cat([o["whole"]["t"] for o in o_]) if what == "gloo 2x2" else o_[0]["whole"]["t"]
        if what == "gloo 2x2":  # rank r holds batch row r // 2: one copy a row
            R, t = R[::2], t[::2]
            for row in range(2):
                check(torch.equal(o_[2 * row]["whole"]["R"], o_[2 * row + 1]["whole"]["R"]),
                      "point_sharding gloo 2x2: a row's ranks hold different R")
        else:
            check(all(torch.equal(o["whole"]["R"], R) for o in o_),
                  f"point_sharding {what}: the ranks hold different R")
        _held_forward(f"{what} whole B = {SP_BATCH}, N = {SP_POINTS} against the plain route",
                      R, t, R_ref, t_ref_, SP_ATOL)
        rot = _rot_between_deg(R, R_kernel)
        print(f"point_sharding {what}: rotation to the kernel route (bf16) {rot.tolist()} deg",
              flush=True)
        check(float(rot.max()) <= SP_KERNEL_ROUTE_DEG,
              f"point_sharding {what}: {float(rot.max())} deg from the kernel route")
        g = o_[0]["grads"]
        check(all(torch.equal(o["grads"]["grads"], g["grads"]) for o in o_),
              f"point_sharding {what}: the ranks hold different gradients")
        cos = _cosine(g["grads"], ref["grads"])
        rel = rel_err(g["grads"], ref["grads"])
        print(f"point_sharding {what}: loss {g['loss']} (single device {ref['loss']}), gradient "
              f"cosine {cos}, largest difference {rel} of the largest gradient; peak memory a rank "
              f"{[_mib(o['grads']['peak_bytes']) for o in o_]} (forward "
              f"{[_mib(o['whole']['peak_bytes']) for o in o_]})", flush=True)
        check(cos >= SP_COSINE_MIN, f"point_sharding {what}: gradient cosine {cos}")
    one, mine = outs["nccl x1"][0], ref["self"]
    d_one = max(float((one["whole"][k] - mine["whole"][k]).abs().max()) for k in ("R", "t"))
    d_grad = float((one["grads"]["grads"] - mine["grads"]["grads"]).abs().max())
    print(f"point_sharding nccl x1 against this process's mesh of itself: max |d(R, t)| {d_one}, "
          f"max |d grad| {d_grad}", flush=True)
    check(d_one <= SP_ONE_RANK_ATOL and d_grad <= SP_ONE_RANK_ATOL * max(
        1.0, float(mine["grads"]["grads"].abs().max())), "point_sharding nccl x1: differs")

    g2 = outs["gloo x2"]
    _held_forward(f"gloo x2 register_whole_sp N = {SP_POINTS} against the identity-pointer model",
                  g2[0]["whole_sp"]["R"], g2[0]["whole_sp"]["t"],
                  *(x.cpu() for x in ref["whole_sp"]), SP_ATOL)
    p = g2[0]["partial"]
    src_k_ref, corr_ref, R_p, t_p = (x.cpu() for x in ref["partial"])
    same = (p["src_k"] == src_k_ref).all(dim=-1).float().mean().item()
    print(f"point_sharding gloo x2 partial (overlap 0.575, {part['src'].shape[1]} points, "
          f"sharpened cross attention): {p['src_k'].shape[1]} pairs, share equal to the single "
          f"device's {same}, max |d corr| {float((p['corr'] - corr_ref).abs().max())}", flush=True)
    _held_forward("gloo x2 partial", p["R"], p["t"], R_p, t_p, SP_ATOL)
    pg = g2[0]["partial_grads"]
    check(math.isfinite(pg["loss"]) and bool((pg["grads"] == 0).all()),
          f"point_sharding partial backward: loss {pg['loss']}, nonzero gradients")
    print(f"point_sharding gloo x2 partial backward: loss {pg['loss']}, every gradient zero",
          flush=True)

    lg, w1, base = outs["gloo x2 large"], ref["large_w1"], ref["large_base"]
    lrot = _rot_between_deg(lg[0]["large_forward"]["R"], ref["large"][0].cpu())
    w1rot = _rot_between_deg(lg[0]["large_forward"]["R"], w1["large_forward"]["R"])
    print(f"point_sharding (d) whole forward B = 1, N = {SP_LARGE_FORWARD}: peak memory a rank "
          f"of two {[_mib(o['large_forward']['peak_bytes']) for o in lg]}; the sharded path at "
          f"world 1 in one process {_mib(w1['large_forward']['peak_bytes'] - base)}; the plain "
          f"route on the whole cloud in one process {_mib(ref['large_peak'] - base)} (this "
          f"process held {_mib(base)} before, taken off both); rotation to world 1 "
          f"{w1rot.tolist()} deg, to the plain route {lrot.tolist()} deg; seconds a rank "
          f"{[o['large_forward']['seconds'] for o in lg]}, at world 1 "
          f"{w1['large_forward']['seconds']}", flush=True)
    lt = [o["large_train"] for o in lg]
    check(all(math.isfinite(x["loss"]) and bool(torch.isfinite(x["grads"]).all()) for x in lt),
          "point_sharding (d) training step: not finite")
    lt1 = w1["large_train"]
    print(f"point_sharding (d) training step B = 1, N = {SP_LARGE_TRAIN}: loss {lt[0]['loss']} "
          f"(world 1 {lt1['loss']}), gradient cosine to world 1 "
          f"{_cosine(lt[0]['grads'], lt1['grads'])}, gradient norm {float(lt[0]['grads'].norm())}, "
          f"peak memory a rank of two {[_mib(x['peak_bytes']) for x in lt]}, at world 1 in one "
          f"process {_mib(lt1['peak_bytes'] - base)}; seconds {[x['seconds'] for x in lt]}, at "
          f"world 1 {lt1['seconds']}", flush=True)

    launches = {k: 0 for k in ops.KERNELS}
    for o_ in outs.values():
        for o in o_:
            add_launches(launches, o["launches"])
    print(f"point_sharding: launches_sp {launches}", flush=True)
    check(not any(launches.values()), "point_sharding: the path launched a kernel")
    return launches


# ---------------------------------------------------------------------------
# dynamic-int8 pointer projections (ops/int8_linear.py) and the FLOP meter
# ---------------------------------------------------------------------------

# (rows, K, F) held against the plain version: the pointer's projections of a
# 64-pair request (timed), a ragged row count, the widest width held, the
# narrowest (one slice, half of it past K; one weight box of four) and a
# ragged slice (K = 576: 4.5 slices of 128) with F = 320 (the second column
# tile one box wide)
INT8_SHAPES = ((64 * N, 512, 512), (885 * 8, 512, 512), (8 * N, 1024, 1024), (885 * 8, 64, 64),
               (885 * 8, 576, 320))
INT8_TOPS = 1979e12  # H100 SXM dense int8
# int8_linear launches of the attention sublayers: a self-attention's
# projections are two calls (q, k and v of its one input together; out), a
# cross attention's three (q; k and v of the memory together; out)
INT8_SELF, INT8_CROSS = 2, 3
# the served checkpoint with int8_eval: Config fields, the launches of a
# 1-pair request (iter=1: 4 self-attention sublayers, two encoder passes and
# the two decoders' own, and 2 cross attentions; iter=3: 10 and 6, the
# target encoded once; in partial mode the 6 re-masked cross attentions are
# written out), and the limits of PERF.md section 2 (rot RMSE, and its gap
# to the plain int8 route)
INT8_CONFIGS = {
    "iter1": (dict(iter=1, num_points=N),
              {**LAUNCHES_ITER1, "int8_linear": 4 * INT8_SELF + 2 * INT8_CROSS},
              ROT_LIMIT_DEG, PLAIN_AGREEMENT_DEG),
    "iter3": (dict(iter=3, num_points=N),
              {**LAUNCHES_ITER3, "int8_linear": 10 * INT8_SELF + 6 * INT8_CROSS},
              ROT_LIMIT_ITER3_DEG, 0.1),
    "partial768": (dict(iter=3, num_points=N, partial=True, overlap=0.575),
                   {**LAUNCHES_PARTIAL, "int8_linear": 10 * INT8_SELF + 6 * INT8_CROSS},
                   ROT_LIMIT_PARTIAL_DEG, 2.0),
}
# the kernel route's rot RMSE (deg) with the two-pass kernel (a quantization
# pass through device memory, then the product), printed beside this run's:
# both kernels equal the plain version bit for bit
INT8_ROT_TWO_PASS_DEG = {"iter1": 2.1530, "iter3": 0.0762, "partial768": 7.1984}
# the fused pointer bypasses int8 (the JAX package's branch order): whole mode
# quantizes nothing; partial mode only the re-masked cross attentions' (two an
# iteration), whose sublayer stays unfused
INT8_FUSED_LAUNCHES = {
    "iter1": FUSED_LAUNCHES[1],
    "partial768": {k: n for k, n in {**LAUNCHES_PARTIAL, "flash_packed": 0, "fused_mha": 10,
                                     "fused_ff": 10, "int8_linear": 6 * INT8_CROSS}.items() if n},
}
INT8_DCP_EVAL_LAUNCHES = {**DCP_EVAL_LAUNCHES, "int8_linear": 4 * INT8_SELF + 2 * INT8_CROSS}
INT8_EXPORT_BUCKET = 8
LPD_FEATURES = 64  # the DG block's kNN space (conv2_lpd's width)
EDGE_F = 128       # the DG block's edge features
# the kernels the FLOP meter does not count, as the JAX package's does not
METER_UNCOUNTED = {"fused_mha", "fused_ff", "vcp_stream", "vcp_bwd", "gather_max_from_idx",
                   "gather_max_bwd"}


def int8_kernel_rows(dev) -> list:
    """(a): the kernel against its plain version on the same CUDA tensors at
    INT8_SHAPES with 1, 2 and 3 pairs (an activation with a zero row, a row
    of one huge value and a row of tiny values; each weight with a zero
    row): each call run three times and the runs equal; outputs, the row
    scales and the weights' codes and scales torch.equal to the plain
    version's; the op route (3-D activations) equal to the parts. Then, at
    the first shape, the kernel's time for one projection and for q, k and v
    of one input (one call of three pairs) beside the plain version's,
    torch._int_mm on the same codes (the product alone, checked against the
    exact product), the bf16 projections it stands in for (F.linear once and
    three times) and the bounds. Rows of the kernels line, the timed one
    last."""
    import torch
    import torch.nn.functional as F

    from vcrnet_tpu_torch.ops.int8_linear import (
        int8_linear, int8_linear_parts, int8_linear_ref, int8_linear_shared,
        int8_linear_shared_ref, quantize_rows_ref,
    )

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(20)
    out_rows = []
    for rows, k, f in reversed(INT8_SHAPES):
        x = torch.randn(rows, k, generator=g, device=dev)
        x[0] = 0.0
        x[1, 3] = 3e4
        x[2] *= 1e-20
        x = x.to(bf)
        pairs = []
        for p in range(3):
            w = (torch.randn(f, k, generator=g, device=dev) / k ** 0.5).to(bf)
            w[p] = 0.0
            pairs.append((w, torch.randn(f, generator=g, device=dev).to(bf)))
        _, rs = quantize_rows_ref(x)
        errs = []
        for n in (1, 2, 3):
            use = pairs[:n]
            runs = [int8_linear_parts(x, use) for _ in range(3)]
            torch.cuda.synchronize()
            outs, xs, wq, ws = runs[0]
            repeat = all(all(torch.equal(a, b) for a, b in zip(run[0], outs))
                         and all(torch.equal(a, b) for a, b in zip(run[1:], (xs, wq, ws)))
                         for run in runs[1:])
            rwq, rws = quantize_rows_ref(torch.cat([w for w, _ in use]))
            refs = int8_linear_shared_ref(x, use)
            codes = torch.equal(wq, rwq)
            scales = torch.equal(xs, rs) and torch.equal(ws, rws)
            equal = all(torch.equal(o, r) for o, r in zip(outs, refs))
            err = max((o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs))
            op_equal = all(torch.equal(o.view(rows, f), a)
                           for o, a in zip(int8_linear_shared(x.unsqueeze(0), use), outs))
            what = f"int8 kernel rows={rows} K={k} F={f} pairs={n}"
            print(f"{what}: weight codes equal {codes} (differ {int((wq != rwq).sum())}), "
                  f"scales equal {scales}, outputs equal {equal} (max |err| {err}), three runs "
                  f"equal {repeat}, op route equal {op_equal}", flush=True)
            check(codes and scales, f"{what}: weight codes or scales differ")
            check(equal, f"{what}: output off by {err}")
            check(repeat, f"{what}: three runs of one call differ")
            check(op_equal, f"{what}: the op route differs from the parts")
            errs.append(err)
        row = {"shape": (rows, k, f), "max_abs_err": max(errs)}
        if (rows, k, f) == INT8_SHAPES[0]:
            (w, b), rq = pairs[0], quantize_rows_ref(x)[0]
            rwq = quantize_rows_ref(w)[0]
            acc = torch._int_mm(rq, rwq.t())
            exact = torch.matmul(rq.double(), rwq.double().t())
            check(torch.equal(acc.double(), exact), "torch._int_mm differs from the exact product")
            out = int8_linear(x, w, b)
            outs = int8_linear_shared(x, pairs)
            row["ms"] = cuda_time_ms(lambda: int8_linear(x, w, b))
            row["plain_ms"] = cuda_time_ms(lambda: int8_linear_ref(x, w, b))
            row["library_ms"] = cuda_time_ms(lambda: torch._int_mm(rq, rwq.t()))
            row["bf16_linear_ms"] = cuda_time_ms(lambda: F.linear(x, w, b))
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes(x, w, b, out), 2.0 * rows * f * k,
                                                        INT8_TOPS)
            row["qkv_ms"] = cuda_time_ms(lambda: int8_linear_shared(x, pairs))
            row["qkv_plain_ms"] = cuda_time_ms(lambda: int8_linear_shared_ref(x, pairs))
            row["qkv_bf16_linear_ms"] = cuda_time_ms(lambda: [F.linear(x, w, b) for w, b in pairs])
            row["qkv_bound_ms"], row["qkv_bound_by"] = bound_ms(
                nbytes(x, *(t for pair in pairs for t in pair), *outs), 3 * 2.0 * rows * f * k,
                INT8_TOPS)
            print(f"int8 kernel rows={rows} K={k} F={f}: one projection {row['ms']} ms; plain "
                  f"{row['plain_ms']} ms; torch._int_mm on the same codes (the product alone, "
                  f"no quantization or epilogue) {row['library_ms']} ms; the bf16 projection it "
                  f"stands in for (F.linear) {row['bf16_linear_ms']} ms; bound {row['bound_ms']} "
                  f"ms ({row['bound_by']}). q, k and v of one input (one call of three pairs) "
                  f"{row['qkv_ms']} ms; plain {row['qkv_plain_ms']} ms; three bf16 F.linear "
                  f"{row['qkv_bf16_linear_ms']} ms; bound {row['qkv_bound_ms']} ms "
                  f"({row['qkv_bound_by']})", flush=True)
        out_rows.append(row)
    return out_rows


def meter_total(fn) -> tuple:
    """(FLOPs the kernels reported, launches, wall seconds) of ``fn()``,
    which ends synchronised."""
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.ops import flop_meter

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with flop_meter.meter() as acc:
        fn()
        torch.cuda.synchronize()
    return acc[0], ops.launch_counts(), time.perf_counter() - t0


def phase_int8():
    """Dynamic-int8 pointer projections on the card (ROADMAP A10):

    (a) the kernel against its plain version (int8_kernel_rows);
    (b) the committed checkpoint with int8_eval=True at iter=1, iter=3 and
        partial 768 at iter=3 over the 73 pairs (1 / 8 / 64 per request):
        kernel route against the plain int8 route to section 2's limits
        (the plain route launches no int8_linear), each route's gap to the bf16 route without int8 printed, the
        launches of a 1-pair request, the latencies in turns against the
        bf16 route (int8, bf16, bf16, int8), and with VCRNET_FUSED_POINTER=1
        the launches at iter=1 (no int8) and partial 768 (the re-masked
        cross attentions alone);
    (c) training is inert to the flag: a VCR-Net step at B = 8 with and
        without int8_eval from one seed gives the same loss bit for bit, the
        same launches (int8_linear none), and the pointer's parameters after
        the step bit for bit (the embedding's gradients pass through the
        scatter backward kernels, whose additions land in an order that
        changes from run to run, so its parameters are printed against the
        spread of two steps without int8); a DCP-on-DGCNN eval step with
        int8 launches the kernel;
    (d) an exported bucket of 8 at iter=1 with int8: op nodes, the launches
        of one artifact call, R and t bit-equal to the live Registrar's;
    (e) the FLOP meter: one 64-pair iter=3 request with int8 and one B = 64
        bf16 training step, each total equal to sum(launches x formula),
        printed over the wall time as a rate (no share of a peak claimed).
    Returns (the launches of the main paths, the kernels-line rows)."""
    import numpy as np
    import torch

    from vcrnet_tpu_torch import ops
    from vcrnet_tpu_torch.config import Config
    from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
    from vcrnet_tpu_torch.ops import flop_meter as fm
    from vcrnet_tpu_torch.serve import Registrar
    from vcrnet_tpu_torch.train import Trainer
    from vcrnet_tpu_torch.utils.params import load_checkpoint

    dev = torch.device("cuda")
    rows = int8_kernel_rows(dev)
    state_dict = load_checkpoint(CHECKPOINT)
    total = {}

    # --- (b) the served checkpoint
    check("VCRNET_FUSED_POINTER" not in os.environ, "VCRNET_FUSED_POINTER is set outside the phase")
    for name, (fields, expected, rot_limit, plain_gap) in INT8_CONFIGS.items():
        partial = fields.get("partial", False)
        data = shapes_eval_set(sum(REQUESTS), num_points=N, partial=partial)
        requests = split_requests(data, REQUESTS)
        cfg = Config(compute_dtype="bfloat16", int8_eval=True, **fields)
        reg = Registrar(cfg, state_dict)
        plain = Registrar(cfg, state_dict, use_kernels=False)
        bf16 = Registrar(Config(compute_dtype="bfloat16", **fields), state_dict)
        check(reg.model.use_kernels and not plain.model.use_kernels, "routes not as asked")
        serve_all(reg, requests)  # warm-up
        serve_all(bf16, requests)
        add_launches(total, one_request_launches(reg, *requests[0], expected, f"int8 {name}"))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        plain.register(*requests[0])
        plain_launches = ops.launch_counts()
        print(f"int8 {name} plain route: launches of one request: {plain_launches}", flush=True)
        check(plain_launches["int8_linear"] == 0, f"int8 {name}: the plain route launched the kernel")
        acc = accuracy(*serve_all(reg, requests), data)
        acc_plain = accuracy(*serve_all(plain, requests), data)
        acc_bf16 = accuracy(*serve_all(bf16, requests), data)
        print(f"int8 {name}: kernels {acc} plain int8 {acc_plain} bf16 kernels without int8 "
              f"{acc_bf16} over {len(data['src'])} pairs; rot RMSE gap to bf16: kernels "
              f"{acc['rot_rmse_deg'] - acc_bf16['rot_rmse_deg']} deg, plain int8 "
              f"{acc_plain['rot_rmse_deg'] - acc_bf16['rot_rmse_deg']} deg; the two-pass "
              f"kernel's rot RMSE {INT8_ROT_TWO_PASS_DEG[name]} deg", flush=True)
        check(acc["rot_rmse_deg"] <= rot_limit,
              f"int8 {name}: rot RMSE {acc['rot_rmse_deg']} deg > {rot_limit}")
        gap = abs(acc["rot_rmse_deg"] - acc_plain["rot_rmse_deg"])
        check(gap <= plain_gap, f"int8 {name}: kernel vs plain int8 rot RMSE differ by {gap} deg")
        for src, tgt in requests:
            lat = {"int8": [], "bf16": []}
            for _ in range(3):
                for route in ("int8", "bf16", "bf16", "int8"):
                    t0 = time.perf_counter()
                    (reg if route == "int8" else bf16).register(src, tgt)
                    lat[route].append((time.perf_counter() - t0) * 1e3)
            print(f"int8 {name}: request of {len(src)} pairs: median latency int8 "
                  f"{statistics.median(lat['int8'])} ms, bf16 {statistics.median(lat['bf16'])} ms "
                  f"(in turns, 6 runs each: {lat})", flush=True)
        if name in INT8_FUSED_LAUNCHES:
            os.environ["VCRNET_FUSED_POINTER"] = "1"
            try:
                reg.register(*requests[0])  # warm-up, fused
                add_launches(total, one_request_launches(
                    reg, *requests[0], INT8_FUSED_LAUNCHES[name], f"int8 {name} fused pointer"))
            finally:
                del os.environ["VCRNET_FUSED_POINTER"]
        del reg, plain, bf16

    # --- (c) training is inert to the flag; DCP on DGCNN evaluates with it
    cfg = Config(compute_dtype="bfloat16", num_points=N)
    cfg8 = Config(compute_dtype="bfloat16", num_points=N, int8_eval=True)
    batch = _train_batch(cfg, 8, seed=3)
    steps = {}
    for what, c in (("int8", cfg8), ("bf16", cfg), ("bf16 again", cfg)):
        tr = Trainer(c, seed=0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        sums = tr.train_step(batch)
        torch.cuda.synchronize()
        steps[what] = (sums["loss"].item(), ops.launch_counts(),
                       {k: v.detach().clone() for k, v in tr.model.state_dict().items()})
        del tr
    (l8, n8, p8), (lb, nb, pb), (_, _, pb2) = steps["int8"], steps["bf16"], steps["bf16 again"]
    check_launches(n8, TRAIN_LAUNCHES, "int8 training step")
    add_launches(total, n8)
    pointer = [k for k in p8 if k.startswith("pointer.")]
    pointer_equal = all(torch.equal(p8[k], pb[k]) for k in pointer)
    emb_diff = {k: (float((p8[k].float() - pb[k].float()).abs().max()),
                    float((pb2[k].float() - pb[k].float()).abs().max()))
                for k in p8 if not k.startswith("pointer.") and p8[k].is_floating_point()}
    print(f"int8 training step B = 8: loss with int8_eval {l8!r}, without {lb!r}; launches "
          f"equal {n8 == nb}; the pointer's {len(pointer)} tensors bit-equal {pointer_equal}; the "
          f"other tensors' max |diff| with int8 against without, beside two steps without "
          f"(run-to-run order of the scatter backward kernels): {emb_diff}", flush=True)
    check(l8 == lb, f"int8 training step: loss {l8} with the flag, {lb} without")
    check(n8 == nb, f"int8 training step: launches {n8} with the flag, {nb} without")
    check(pointer_equal, "int8 training step: the pointer's parameters differ with the flag")

    tr = Trainer(Config(model="dcp", emb_nn="dgcnn", compute_dtype="bfloat16", num_points=N,
                        int8_eval=True), seed=0)
    tr.eval_step(batch)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sums = tr.eval_step(batch)
    launches = ops.launch_counts()
    print(f"int8 DCP on DGCNN eval step B = 8: launches {launches}, loss per pair "
          f"{(sums['loss'] / sums['count']).item()}", flush=True)
    check_launches(launches, INT8_DCP_EVAL_LAUNCHES, "int8 DCP eval step")
    check(math.isfinite(sums["loss"].item()), "int8 DCP eval step: non-finite loss")
    add_launches(total, launches)
    del tr

    # --- (d) an exported int8 bucket
    cfg = Config(compute_dtype="bfloat16", int8_eval=True, iter=1, num_points=N)
    reg = Registrar(cfg, state_dict)
    data = shapes_eval_set(INT8_EXPORT_BUCKET, num_points=N)
    expected = INT8_CONFIGS["iter1"][1]
    loaded, _, _ = export_checked(reg, INT8_EXPORT_BUCKET, expected, "int8 iter=1")
    loaded.register(data["src"], data["tgt"])  # warm-up
    out, launches = artifact_launches(loaded, data["src"], data["tgt"], expected, "int8 iter=1")
    add_launches(total, launches)
    same_results(out, reg.register(data["src"], data["tgt"]), "int8 iter=1")
    del reg, loaded

    # --- (e) the FLOP meter: a 64-pair iter=3 request with int8, a B = 64 step
    b = REQUESTS[-1]
    data = shapes_eval_set(b, num_points=N)
    reg = Registrar(Config(compute_dtype="bfloat16", int8_eval=True, iter=3, num_points=N),
                    state_dict)
    reg.register(data["src"], data["tgt"])  # warm-up
    flops, launches, secs = meter_total(lambda: reg.register(data["src"], data["tgt"]))
    per_launch = {"knn_gather_max": fm.knn_gather_max_flops(b, N, 3),
                  "edge_conv": fm.edge_conv_flops(b, N, LPD_FEATURES, EDGE_F),
                  "flash_packed": fm.flash_fwd_flops(b, N, N, 512, 4),
                  "int8_linear": fm.int8_linear_flops(b * N, 512, 512)}
    # a launch of int8_linear counts the product of each of its pairs
    projections = ops.int8_linear.projections
    print(f"meter: int8 iter=3 request of {b} pairs: {launches['int8_linear']} int8_linear "
          f"launches of {projections} projections", flush=True)
    check(projections == 16 * 4, f"meter: {projections} int8 projections, not 16 x 4")
    check_metered(flops, launches, per_launch, secs, f"meter: int8 iter=3 request of {b} pairs",
                  counts={"int8_linear": projections})
    add_launches(total, launches)
    del reg
    tr = Trainer(Config(compute_dtype="bfloat16", num_points=N), seed=0)
    batch = tr.to_device(_train_batch(tr.cfg, b, seed=2))
    tr.train_step(batch)  # warm-up
    flops, launches, secs = meter_total(lambda: tr.train_step(batch))
    per_launch = {"knn_gather_max": fm.knn_gather_max_flops(2 * b, N, 3),
                  "edge_conv": fm.edge_conv_flops(2 * b, N, LPD_FEATURES, EDGE_F),
                  "edge_conv_bwd": fm.edge_conv_bwd_flops(2 * b, N, EDGE_F),
                  "flash_packed": fm.flash_fwd_flops(b, N, N, 512, 4),
                  "flash_bwd": fm.flash_bwd_flops(b, N, N, 512, 4)}
    check_metered(flops, launches, per_launch, secs, f"meter: bf16 training step at B = {b}")
    add_launches(total, launches)
    return total, rows


def check_metered(flops: float, launches: dict, per_launch: dict, secs: float, what: str,
                  counts: dict | None = None) -> None:
    """The meter's total equals sum(launches x formula) over the counted
    kernels of ``per_launch`` (exact: integer terms; ``counts`` replaces a
    kernel's launches by the count its formula is taken for, such as the
    projections of int8_linear's launches), and every other kernel launched
    is one the meter does not count; prints the total over the wall time as a
    rate."""
    counts = {**launches, **(counts or {})}
    want = sum(counts[k] * f for k, f in per_launch.items())
    others = {k: n for k, n in launches.items() if n and k not in per_launch}
    print(f"{what}: the meter's total {flops} FLOPs, launches x formula {want} (counts "
          f"{ {k: counts[k] for k in per_launch} }, other kernels launched {others}); "
          f"{secs * 1e3} ms wall, {flops / secs / 1e12} TFLOP/s of counted kernel work",
          flush=True)
    check(all(launches[k] for k in per_launch), f"{what}: a counted kernel did not launch")
    check(set(others) <= METER_UNCOUNTED,
          f"{what}: a counted kernel outside the formula table launched: {others}")
    check(flops == want, f"{what}: the meter counted {flops}, launches x formula {want}")


# sources whose registers and spills the script prints (nvcc -Xptxas -v,
# started beside the extension's build); a spill fails the run
PTXAS_REPORTED = ("vcp_stream.cu", "vcp_bwd.cu", "edge_conv.cu", "edge_conv_from_idx.cu",
                  "edge_conv_bwd.cu", "knn_gather_max.cu", "knn.cu", "gather_max_from_idx.cu",
                  "gather_max_bwd.cu", "flash_packed.cu", "flash_bwd.cu", "colmass.cu",
                  "pointer_mha.cu", "pointer_ff.cu", "dgcnn_eval.cu", "int8_linear.cu")
# template arguments of the kernels as ptxas names them, mangled
TEMPLATE_ARGS = {"IfE": "<float>", "I13__nv_bfloat16E": "<bf16>"}
# gemm_wgmma.cuh's kernel: its operand and epilogue classes, the bools of one
GEMM_CLASSES = re.compile(r"(Bf16Operands|Epilogue)((?:ILb[01]E|Lb[01]E)*)")


def template_args(args: str) -> str:
    """A kernel's mangled template arguments as ``<...>`` ("" for none)."""
    if not args or args in TEMPLATE_ARGS:
        return TEMPLATE_ARGS.get(args, "")
    classes = GEMM_CLASSES.findall(args)
    if classes:
        return "<" + ", ".join(
            name + (f"<{','.join(re.findall(r'Lb([01])', bools))}>" if bools else "")
            for name, bools in classes) + ">"
    # integers and bools (ILi64ELb1E: <64,1>)
    return args.replace("ILi", "<").replace("ILb", "<").replace("ELb", ",").rstrip("E") + ">"


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
        report = "; ".join(f"{name}{template_args(args)} {regs} registers, spills {st}/{ld} bytes"
                           for name, args, st, ld, regs in kernels)
        print(f"ptxas {src}: {report}; added wgmma fences (C7519): {out.count('C7519')}",
              flush=True)
        spills = [int(n) for _, _, st, ld, _ in kernels for n in (st, ld)]
        check(kernels and not any(spills), f"{src}: the kernels spill registers ({spills} bytes)")


PHASES = ("kernels", "backward", "train", "serve", "refine", "partial", "ragged", "fit", "dgcnn",
          "fused_pointer", "data", "regularise", "converge", "partial_train", "icp", "lpd", "heads",
          "cli", "export", "int8", "parallel", "point_sharding")


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
            rows.update(phase_ragged_kernels(dev))
            rows.update(phase_gather_kernels(dev))
        elif name == "backward":
            rows.update(phase_backward(dev))
            rows.update(phase_ragged_backward(dev))
        elif name == "train":
            launches[name] = phase_train()[0]
        elif name == "serve":
            launches[name] = phase_serve()
        elif name == "refine":
            launches[name] = phase_refine()
        elif name == "partial":
            launches[name] = phase_partial()
        elif name == "ragged":
            launches[name] = phase_ragged()[0]
        elif name == "fit":
            phase_fit()
        elif name == "dgcnn":
            launches[name] = phase_dgcnn()
        elif name == "fused_pointer":
            launches[name] = phase_fused_pointer()
        elif name == "data":
            launches[name] = phase_data()
        elif name == "regularise":
            launches[name] = phase_regularise()
        elif name == "converge":
            launches[name] = phase_converge()
        elif name == "partial_train":
            launches[name] = phase_partial_train()
        elif name == "icp":
            launches[name] = phase_icp()
        elif name == "lpd":
            launches[name] = phase_lpd()
        elif name == "heads":
            launches[name] = phase_heads()
        elif name == "cli":
            launches[name] = phase_cli()
        elif name == "export":
            launches[name] = phase_export()
        elif name == "int8":
            launches[name], rows["int8_linear"] = phase_int8()
        elif name == "parallel":
            launches[name] = phase_parallel()
        elif name == "point_sharding":
            launches[name] = phase_point_sharding()
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
        "int8_linear": ("vcrnet_tpu_torch/csrc/int8_linear.cu",
                        "none: vcrnet_tpu/ops/int8_linear.py:48 (XLA)"),
    }
    check(set(sources) == set(ops.KERNELS) and len(sources) == 16,
          "the kernels line must list every kernel of the port")
    kernels = []
    for name, (source, replaces) in sources.items():
        # the largest batch: B = 64 pairs (2B = 128 in the LPDNet blocks of the
        # training step; B = 8 at N = 3072 for the column masses)
        top = rows[name][-1]
        errs = [r["max_abs_err"] for r in rows[name]]
        errs += [r["max_abs_err"] for r in rows.get(name + "_path_shapes", ())]
        errs += [r["max_abs_err"] for r in rows.get(name + "_edge", ())]
        errs += [r["max_abs_err"] for r in rows.get(name + "_ragged", ())]
        errs += [r["max_abs_err"] for r in rows.get(name + "_slices", ())]
        if name == "flash_packed":
            errs += [r["max_abs_err"] for r in rows["flash_packed_nk_valid"]]
        f32 = {}
        if name == "edge_conv":  # its f32 instance (the kNN space after t_net_fea)
            f32_rows = rows["edge_conv_f32"] + rows["edge_conv_f32_ragged"]
            errs += [r["max_abs_err"] for r in f32_rows]
            top32 = rows["edge_conv_f32"][-1]
            f32 = {"launches_f32": sum(p.get("edge_conv_f32", 0) for p in launches.values()),
                   "f32_ms": top32["ms"], "f32_plain_ms": top32["plain_ms"],
                   "f32_bound_ms": top32["bound_ms"], "f32_bound_by": top32["bound_by"],
                   "f32_max_abs_err": max(r["max_abs_err"] for r in f32_rows)}
            check(f32["launches_f32"] > 0, "the f32 edge instance was never launched on a path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per_phase[name] for per_phase in launches.values()),
            "launches_train_step": launches["train"][name],
            "launches_serve": launches["serve"][name],
            "launches_refine": launches["refine"][name],
            "launches_partial": launches["partial"][name],
            "launches_ragged": launches["ragged"].get(name, 0),
            "launches_dgcnn": launches["dgcnn"][name],
            "launches_fused_pointer": launches["fused_pointer"][name],
            "launches_data": launches["data"].get(name, 0),
            "launches_regularise": launches["regularise"].get(name, 0),
            "launches_converge": launches["converge"].get(name, 0),
            "launches_partial_train": launches["partial_train"].get(name, 0),
            "launches_icp": launches["icp"].get(name, 0),
            "launches_lpd": launches["lpd"].get(name, 0),
            "launches_heads": launches["heads"].get(name, 0),
            "launches_cli": launches["cli"].get(name, 0),
            "launches_export": launches["export"].get(name, 0),
            "launches_int8": launches["int8"].get(name, 0),
            "launches_parallel": launches["parallel"].get(name, 0),
            "max_abs_err": max(errs),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            **({"library_seq_ms": top["library_seq_ms"]} if "library_seq_ms" in top else {}),
            # int8_linear: q, k and v of one input in one call, and the bf16 yardsticks
            **{key: v for key, v in top.items() if key.startswith("qkv_") or key == "bf16_linear_ms"},
            **f32,
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
