"""The LPDNet kNN blocks as fused kernels, each beside its plain version.

  fused_knn_gather_max  SN block: xyz kNN fused with out[i] = max_{j in knn(i)} values[j]
                  (vcrnet_tpu/ops/pallas_edgeconv.py:fused_knn_gather_max)
  fused_edge_conv       DG block: feature kNN, z_ij = act(a[j] + h[i]), x1 = max_j z,
                  x2 = max_j act(bf16(z) @ W2 + b2)
                  (vcrnet_tpu/ops/pallas_edgeconv.py:fused_edge_conv)
  gather_max_bwd        dv[idx[i, win[i, c]], c] += ct[i, c]
                  (pallas_edgeconv.py:_gather_max_bwd_from_winners)
  edge_conv_bwd         (da, dh, dW2, db2) from the saved idx and winners
                  (pallas_edgeconv.py:_fused_edge_conv_bwd)
  fused_gather_max_from_idx  the SN block over a GIVEN selection
                  (pallas_edgeconv.py:gather_max_from_idx)
  edge_conv_from_idx    the DG block over a GIVEN selection, eval only
                  (pallas_edgeconv.py:edge_conv_from_idx)

A CUDA tensor launches the kernel in ``csrc/`` (or raises); a CPU tensor
runs the ``*_ref`` plain version. Both select by exact f32 comparison with
ties to the smaller column and mask the diagonal, and both gather the
exact values: the TPU's int8 one-hot gather (``int8_gather=True`` there)
is not reproduced. Each wrapper counts its launches in ``.launches``
(``fused_edge_conv`` those of its f32 instance also in ``.launches_f32``; that
instance's split pass, :func:`split_planes`, counts its own). The
four forward wrappers run through the ops ``vcrnet_torch::knn_gather_max``,
``edge_conv``, ``gather_max_from_idx`` and ``edge_conv_from_idx``
(``ops/library.py``); the two backward wrappers call the extension
directly.

The from-idx pair serves the refinement loop, which computes a selection
once and passes it back: given the fused kernels' own idx they return the
fused kernels' outputs bit for bit (one device function each).

``knn_gather_max``, ``gather_max_from_idx`` and ``edge_conv`` are the
differentiable entry points (the JAX custom VJPs), which the model calls
in eval and in training:
where a gradient is wanted, the forward also emits each output channel's
max winner (its k-position, uint8, the first on ties) and the backward
kernel routes the gradient by it; x gets no gradient (the JAX VJP's
zeros: kNN indices carry none).
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build, flop_meter, library
from vcrnet_tpu_torch.ops._common import (
    SMEM_LIMIT, check_aligned, check_tensor, kernel_route, knn_scores, leaky, select_topk,
)
from vcrnet_tpu_torch.ops.graph import gather_neighbors


def knn_gather_max_supported(n: int, f: int, k: int) -> bool:
    """The gate of the ``knn_gather_max`` kernel: table rows of 16-byte
    loads (F % 8 == 0), 0 < k <= 32 and k < N. Any N: the cloud is staged in
    tiles of at most 3072 points."""
    return f % 8 == 0 and 0 < k <= 32 and k < n


def gather_max_bwd_supported(n: int, f: int, k: int) -> bool:
    """The gate of the ``gather_max_bwd`` kernel: a block keeps one cloud's
    dv for a slice of at least 8 channels in shared memory (N <= 7264 on
    sm_90), F % 8 == 0, 0 < k <= 32 and k < N."""
    return f % 8 == 0 and 0 < k <= 32 and k < n and 4 * 8 * n <= SMEM_LIMIT


def edge_conv_supported(n: int, c: int, k: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """The gate of the ``edge_conv`` kernel: a bf16 kNN space of width C in
    (32, 64, 128), or an f32 one of width 64 (the f32 instance: LPDNet's
    space after ``t_net_fea``), 0 < k <= 32 and k < N. Any N: blocks of 64
    queries of one cloud over 64-key tiles, the last of each ragged (keys
    past N score -inf, queries past N are not written); shared memory does
    not grow with N."""
    widths = {torch.bfloat16: (32, 64, 128), torch.float32: (64,)}.get(dtype, ())
    return c in widths and 0 < k <= 32 and k < n


def edge_conv_from_idx_supported(n: int, k: int) -> bool:
    """The gate of the ``edge_conv_from_idx`` kernel: 0 < k <= 32. Any N:
    blocks of 64 rows of the flattened [B*N] in tiles of two query rows;
    the kernel gates on rows, and a last block or tile that runs past B*N
    repeats a real query and writes nothing."""
    return n > 0 and 0 < k <= 32


def gather_max_from_idx_supported(n: int, f: int, k: int) -> bool:
    """The gate of the ``gather_max_from_idx`` kernel: F % 8 == 0 and
    0 < k <= 32. Any N: a cloud's slice of up to 64 channels in shared
    memory up to N = 14528, rows read from device memory beyond."""
    return n > 0 and f % 8 == 0 and 0 < k <= 32


def edge_conv_bwd_supported(n: int, k: int) -> bool:
    """The gate of the ``edge_conv_bwd`` kernel: 0 < k <= 32 and k < N.
    Any N: rounds of four query rows of the flattened [B*N], the last of
    which may be ragged (a slot past B*N repeats the last query and adds
    and stores nothing)."""
    return 0 < k <= 32 and k < n


def _max_and_winner(v: torch.Tensor):
    """[B, N, k, F] -> (max over k, first k-position reaching it as uint8)."""
    return v.amax(dim=2), v.argmax(dim=2).to(torch.uint8)


def fused_knn_gather_max_ref(x, values, k: int = 20, idx=None, winners: bool = False):
    """Plain version of :func:`fused_knn_gather_max`; ``idx`` [B, N, k] skips the
    selection and gathers over the given neighbours."""
    if idx is None:
        idx = select_topk(knn_scores(x), k)
    out, win = _max_and_winner(gather_neighbors(values, idx))
    return (out, idx, win) if winners else (out, idx)


def fused_knn_gather_max(x: torch.Tensor, values: torch.Tensor, k: int = 20,
                         winners: bool = False):
    """x [B, N, 3] f32, values [B, N, F] -> (out [B, N, F], idx [B, N, k]
    int32[, win [B, N, F] uint8 with ``winners``]): per point, the
    channel-wise max of ``values`` over its k nearest neighbours in x (self
    excluded). The kernel takes bf16 values and the shapes
    :func:`knn_gather_max_supported` takes. Runs the op
    ``vcrnet_torch::knn_gather_max``."""
    if kernel_route(x, values):
        B, N, _ = x.shape
        F = values.shape[-1]
        check_tensor("x", x, torch.float32, (B, N, 3))
        check_tensor("values", values, torch.bfloat16, (B, N, F))
        if not knn_gather_max_supported(N, F, k):
            raise ValueError(
                f"knn_gather_max kernel takes F % 8 == 0 and k in [1, 32] below N, "
                f"got F={F} k={k} N={N}"
            )
    out, idx, win = _knn_gather_max_op(x, values, k, winners)
    return (out, idx, win) if winners else (out, idx)


def _knn_gather_max_impl(x, values, k: int, winners: bool):
    if not kernel_route(x, values):
        out, idx, *win = fused_knn_gather_max_ref(x, values, k, winners=winners)
        return out, idx, win[0] if winners else library.empty_output(values, torch.uint8)
    check_aligned(x=x, values=values)
    B, N, F = values.shape
    norms = (x * x).sum(-1)
    out = torch.empty_like(values)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    win = torch.empty((B, N, F), dtype=torch.uint8, device=x.device) if winners else None
    _build.extension().knn_gather_max(x, norms, values, out, idx, win, k)
    fused_knn_gather_max.launches += 1
    flop_meter.add(flop_meter.knn_gather_max_flops(*x.shape))
    return out, idx, win if winners else library.empty_output(values, torch.uint8)


def _knn_gather_max_fake(x, values, k: int, winners: bool):
    B, N, F = values.shape
    return (values.new_empty((B, N, F)), x.new_empty((B, N, k), dtype=torch.int32),
            values.new_empty((B, N, F) if winners else (0,), dtype=torch.uint8))


_knn_gather_max_op = library.define(
    "knn_gather_max", "(Tensor x, Tensor values, int k, bool winners) -> (Tensor, Tensor, Tensor)",
    _knn_gather_max_impl, _knn_gather_max_fake)


fused_knn_gather_max.launches = 0


def gather_max_bwd_ref(idx, win, ct):
    """Plain version of :func:`gather_max_bwd`."""
    B, N, F = ct.shape
    target = torch.gather(idx.long(), 2, win.long())  # [B, N, F]: the winning neighbour
    dv = torch.zeros((B, N, F), dtype=torch.float32, device=ct.device)
    return dv.scatter_add_(1, target, ct.float())


def gather_max_bwd(idx: torch.Tensor, win: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """idx [B, N, k] int32, win [B, N, F] uint8, ct [B, N, F] -> dv [B, N, F]
    f32 with dv[b, idx[b, i, win[b, i, c]], c] += ct[b, i, c]. The kernel
    takes bf16 ct and the shapes :func:`gather_max_bwd_supported` takes."""
    if not kernel_route(idx, win, ct):
        return gather_max_bwd_ref(idx, win, ct)
    B, N, F = ct.shape
    k = idx.shape[-1]
    check_tensor("idx", idx, torch.int32, (B, N, k))
    check_tensor("win", win, torch.uint8, (B, N, F))
    check_tensor("ct", ct, torch.bfloat16, (B, N, F))
    if not gather_max_bwd_supported(N, F, k):
        raise ValueError(
            f"gather_max_bwd kernel takes F % 8 == 0, k in [1, 32] below N and "
            f"N <= {SMEM_LIMIT // 32}, got F={F} k={k} N={N}"
        )
    check_aligned(idx=idx, win=win, ct=ct)
    dv = torch.empty((B, N, F), dtype=torch.float32, device=ct.device)  # every element written
    _build.extension().gather_max_bwd(idx, win, ct, dv)
    gather_max_bwd.launches += 1
    return dv


gather_max_bwd.launches = 0


class _KnnGatherMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, values, k, grad_enabled):
        winners = grad_enabled and ctx.needs_input_grad[1]
        out, idx, *win = fused_knn_gather_max(x, values, k, winners=winners)
        ctx.save_for_backward(idx, *win)
        ctx.dtype = values.dtype
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, d_out, _d_idx):
        if not ctx.needs_input_grad[1]:  # only x asked: it gets none
            return None, None, None, None
        idx, win = ctx.saved_tensors
        return None, gather_max_bwd(idx, win, d_out.contiguous()).to(ctx.dtype), None, None


def knn_gather_max(x: torch.Tensor, values: torch.Tensor, k: int = 20):
    """Differentiable :func:`fused_knn_gather_max` -> (out, idx), for eval
    and training: the forward emits the winners only when a gradient is
    wanted for ``values``, and the backward is :func:`gather_max_bwd` on
    them."""
    return _KnnGatherMax.apply(x, values, k, torch.is_grad_enabled())


def fused_gather_max_from_idx(idx: torch.Tensor, values: torch.Tensor, winners: bool = False):
    """idx [B, N, k] int32 with entries in [0, N), values [B, N, F] -> out
    [B, N, F] (or (out, win [B, N, F] uint8) with ``winners``): out[b, i] =
    channel-wise max of values[b, idx[b, i, :]]. The kernel takes bf16
    values with F % 8 == 0 and k <= 32. Runs the op
    ``vcrnet_torch::gather_max_from_idx``."""
    if kernel_route(idx, values):
        B, N, F = values.shape
        k = idx.shape[-1]
        check_tensor("idx", idx, torch.int32, (B, N, k))
        check_tensor("values", values, torch.bfloat16, (B, N, F))
        if not gather_max_from_idx_supported(N, F, k):
            raise ValueError(
                f"gather_max_from_idx kernel takes k in [1, 32] and F % 8 == 0, got k={k} F={F}"
            )
    out, win = _gather_max_from_idx_op(idx, values, winners)
    return (out, win) if winners else out


def _gather_max_from_idx_impl(idx, values, winners: bool):
    if not kernel_route(idx, values):
        out, _, *win = fused_knn_gather_max_ref(None, values, idx=idx, winners=winners)
        return out, win[0] if winners else library.empty_output(values, torch.uint8)
    check_aligned(idx=idx, values=values)
    out = torch.empty_like(values)
    win = torch.empty(values.shape, dtype=torch.uint8, device=idx.device) if winners else None
    _build.extension().gather_max_from_idx(idx, values, out, win)
    fused_gather_max_from_idx.launches += 1
    return out, win if winners else library.empty_output(values, torch.uint8)


def _gather_max_from_idx_fake(idx, values, winners: bool):
    return (values.new_empty(values.shape),
            values.new_empty(values.shape if winners else (0,), dtype=torch.uint8))


_gather_max_from_idx_op = library.define(
    "gather_max_from_idx", "(Tensor idx, Tensor values, bool winners) -> (Tensor, Tensor)",
    _gather_max_from_idx_impl, _gather_max_from_idx_fake)


fused_gather_max_from_idx.launches = 0


def gather_max_from_idx_ref(idx, values):
    """Plain version of :func:`gather_max_from_idx`."""
    return fused_knn_gather_max_ref(None, values, idx=idx)[0]


class _GatherMaxFromIdx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, values, grad_enabled):
        winners = grad_enabled and ctx.needs_input_grad[1]
        if not winners:
            return fused_gather_max_from_idx(idx, values)
        out, win = fused_gather_max_from_idx(idx, values, winners=True)
        ctx.save_for_backward(idx, win)
        ctx.dtype = values.dtype
        return out

    @staticmethod
    def backward(ctx, d_out):
        idx, win = ctx.saved_tensors
        return None, gather_max_bwd(idx, win, d_out.contiguous()).to(ctx.dtype), None


def gather_max_from_idx(idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`fused_gather_max_from_idx` -> out, for eval and
    training: the forward emits the winners only when a gradient is wanted
    for ``values``, and the backward is :func:`gather_max_bwd` on them (idx
    carries none)."""
    return _GatherMaxFromIdx.apply(idx, values, torch.is_grad_enabled())


def fused_edge_conv_ref(x, a, h, w2, b2, k: int = 20, negative_slope: float = 0.0,
                        idx=None, winners: bool = False):
    """Plain version of :func:`fused_edge_conv`; ``idx`` [B, N, k] skips the
    selection. Rounds z to w2's dtype before the product, as the kernel."""
    if idx is None:
        idx = select_topk(knn_scores(x), k)
    z = leaky(gather_neighbors(a, idx).float() + h.float()[:, :, None], negative_slope)
    y = torch.matmul(z.to(w2.dtype).float(), w2.float()) + b2.float()
    x1, win1 = _max_and_winner(z)
    x2, win2 = _max_and_winner(leaky(y, negative_slope))
    out = (x1.to(a.dtype), x2.to(a.dtype), idx)
    return out + (win1, win2) if winners else out


def fused_edge_conv(x, a, h, w2, b2, k: int = 20, negative_slope: float = 0.0,
                    winners: bool = False):
    """x [B, N, C] (the kNN space), a/h [B, N, F], w2 [F, F] (in, out),
    b2 [F] -> (x1, x2 [B, N, F] in a's dtype, idx [B, N, k] int32[, win1,
    win2 [B, N, F] uint8 with ``winners``]). The kernel takes bf16 a, h,
    w2, b2, F = 128, x in bf16 or (its f32 instance, counted apart in
    ``.launches_f32``, after the split pass :func:`split_planes`) in f32,
    and the shapes :func:`edge_conv_supported` takes. Runs the op
    ``vcrnet_torch::edge_conv``."""
    if kernel_route(x, a, h, w2, b2):
        B, N, C = x.shape
        bf16 = torch.bfloat16
        if not edge_conv_supported(N, C, k, x.dtype):
            raise ValueError(
                f"edge_conv kernel takes bf16 x at C in (32, 64, 128) or f32 x at C = 64, and "
                f"k in [1, 32] below N, got {x.dtype} x, C={C} N={N} k={k}"
            )
        check_tensor("x", x, x.dtype, (B, N, C))
        for name, t in (("a", a), ("h", h)):
            check_tensor(name, t, bf16, (B, N, 128))
        check_tensor("w2", w2, bf16, (128, 128))
        check_tensor("b2", b2, bf16, (128,))
    x1, x2, idx, win1, win2 = _edge_conv_op(x, a, h, w2, b2, k, float(negative_slope), winners)
    return (x1, x2, idx, win1, win2) if winners else (x1, x2, idx)


def split_planes_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`split_planes`."""
    x0 = x.to(torch.bfloat16)
    r = x - x0.float()
    x1 = r.to(torch.bfloat16)
    return torch.stack((x0, x1, (r - x1.float()).to(torch.bfloat16)))


def split_planes(x: torch.Tensor) -> torch.Tensor:
    """x f32 [...] -> [3, ...] bf16: x0 = bf16(x), x1 = bf16(x - x0),
    x2 = bf16(x - x0 - x1), rounded to nearest even, whose sum is x exactly
    for |x| >= 2^-108 (within 2^-133 below). NaN, +-inf and values beyond
    bf16's largest finite one leave NaN in x2. The split pass of the edge
    kernel's f32 instance, which takes its scores as the exact bf16
    products of these planes (csrc/edge_conv.cu); the kernel takes a
    contiguous x of a multiple of 8 values."""
    if not kernel_route(x):
        return split_planes_ref(x)
    check_tensor("x", x, torch.float32, x.shape)
    if x.numel() % 8:
        raise ValueError(f"edge_split kernel takes a multiple of 8 values, got {x.numel()}")
    check_aligned(x=x)
    planes = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    _build.extension().edge_split(x, planes)
    split_planes.launches += 1
    return planes


split_planes.launches = 0


def _edge_conv_impl(x, a, h, w2, b2, k: int, negative_slope: float, winners: bool):
    if not kernel_route(x, a, h, w2, b2):
        x1, x2, idx, *wins = fused_edge_conv_ref(x, a, h, w2, b2, k, negative_slope,
                                                 winners=winners)
        if not winners:
            wins = [library.empty_output(a, torch.uint8) for _ in range(2)]
        return x1, x2, idx, wins[0], wins[1]
    check_aligned(x=x, a=a, h=h, w2=w2, b2=b2)
    B, N, _ = x.shape
    norms = x.float().square().sum(-1)
    if N % 64:  # the kernel reads whole 64-key tiles: keys past N get an infinite norm
        norms = torch.nn.functional.pad(norms, (0, -N % 64), value=float("inf"))
    x1 = torch.empty_like(a)
    x2 = torch.empty_like(a)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=x.device)
    win1 = win2 = None
    if winners:
        win1 = torch.empty((B, N, 128), dtype=torch.uint8, device=x.device)
        win2 = torch.empty_like(win1)
    space = split_planes(x) if x.dtype == torch.float32 else x  # the f32 instance's planes
    _build.extension().edge_conv(space, norms, a, h, w2, b2, x1, x2, idx, win1, win2, k,
                                 negative_slope)
    fused_edge_conv.launches += 1
    if x.dtype == torch.float32:
        fused_edge_conv.launches_f32 += 1
    flop_meter.add(flop_meter.edge_conv_flops(*x.shape, a.shape[-1]))
    if not winners:  # two placeholders: an op's outputs may not alias each other
        win1, win2 = (library.empty_output(a, torch.uint8) for _ in range(2))
    return x1, x2, idx, win1, win2


def _edge_conv_fake(x, a, h, w2, b2, k: int, negative_slope: float, winners: bool):
    B, N, F = a.shape
    win_shape = (B, N, F) if winners else (0,)
    return (a.new_empty((B, N, F)), a.new_empty((B, N, F)),
            x.new_empty((B, N, k), dtype=torch.int32),
            a.new_empty(win_shape, dtype=torch.uint8), a.new_empty(win_shape, dtype=torch.uint8))


_edge_conv_op = library.define(
    "edge_conv",
    "(Tensor x, Tensor a, Tensor h, Tensor w2, Tensor b2, int k, float negative_slope, "
    "bool winners) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    _edge_conv_impl, _edge_conv_fake)


fused_edge_conv.launches = 0
fused_edge_conv.launches_f32 = 0  # of them, the f32 instance's


def edge_conv_from_idx_ref(idx, a, h, w2, b2, negative_slope: float = 0.0):
    """Plain version of :func:`edge_conv_from_idx`."""
    return fused_edge_conv_ref(None, a, h, w2, b2, negative_slope=negative_slope, idx=idx)[:2]


def edge_conv_from_idx(idx, a, h, w2, b2, negative_slope: float = 0.0):
    """idx [B, N, k] int32 with entries in [0, N), a/h [B, N, F], w2 [F, F]
    (in, out), b2 [F] -> (x1, x2 [B, N, F] in a's dtype): the DG block over
    the given selection. Eval only: it has no backward and raises where a
    gradient is wanted. The kernel takes bf16 throughout, F = 128 and the
    shapes :func:`edge_conv_from_idx_supported` takes. Runs the op
    ``vcrnet_torch::edge_conv_from_idx``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, h, w2, b2)):
        raise RuntimeError("edge_conv_from_idx has no backward; call it under torch.no_grad()")
    if kernel_route(idx, a, h, w2, b2):
        B, N, k = idx.shape
        bf16 = torch.bfloat16
        if not edge_conv_from_idx_supported(N, k):
            raise ValueError(f"edge_conv_from_idx kernel takes k in [1, 32], got N={N} k={k}")
        check_tensor("idx", idx, torch.int32, (B, N, k))
        for name, t in (("a", a), ("h", h)):
            check_tensor(name, t, bf16, (B, N, 128))
        check_tensor("w2", w2, bf16, (128, 128))
        check_tensor("b2", b2, bf16, (128,))
    return _edge_conv_from_idx_op(idx, a, h, w2, b2, float(negative_slope))


def _edge_conv_from_idx_impl(idx, a, h, w2, b2, negative_slope: float):
    if not kernel_route(idx, a, h, w2, b2):
        return edge_conv_from_idx_ref(idx, a, h, w2, b2, negative_slope)
    check_aligned(idx=idx, a=a, h=h, w2=w2, b2=b2)
    x1 = torch.empty_like(a)
    x2 = torch.empty_like(a)
    _build.extension().edge_conv_from_idx(idx, a, h, w2, b2, x1, x2, negative_slope)
    edge_conv_from_idx.launches += 1
    flop_meter.add(flop_meter.edge_conv_from_idx_flops(*a.shape))
    return x1, x2


def _edge_conv_from_idx_fake(idx, a, h, w2, b2, negative_slope: float):
    return a.new_empty(a.shape), a.new_empty(a.shape)


_edge_conv_from_idx_op = library.define(
    "edge_conv_from_idx",
    "(Tensor idx, Tensor a, Tensor h, Tensor w2, Tensor b2, float negative_slope) "
    "-> (Tensor, Tensor)",
    _edge_conv_from_idx_impl, _edge_conv_from_idx_fake)


edge_conv_from_idx.launches = 0


def _dleaky(post: torch.Tensor, slope: float) -> torch.Tensor:
    """act' from the post-activation sign, as the kernels take it."""
    return torch.where(post > 0, 1.0, slope)


def edge_conv_bwd_ref(idx, win1, win2, a, h, w2, x2, ct1, ct2, negative_slope: float = 0.0):
    """Plain version of :func:`edge_conv_bwd`, with the Pallas kernel's
    rounding points: dp rounded to w2's dtype before dp @ W2^T, dq rounded
    to h's dtype before the scatter into da."""
    k = idx.shape[-1]
    z = leaky(gather_neighbors(a, idx).float() + h.float()[:, :, None], negative_slope)
    kpos = torch.arange(k, device=idx.device).view(1, 1, k, 1)
    dp_row = ct2.float() * _dleaky(x2.float(), negative_slope)
    dp = torch.where(win2.long()[:, :, None] == kpos, dp_row[:, :, None], 0.0)  # [B,N,k,F]
    dw2 = torch.einsum("bnki,bnko->io", z, dp)
    db2 = dp.sum(dim=(0, 1, 2))
    dz = torch.where(win1.long()[:, :, None] == kpos, ct1.float()[:, :, None], 0.0)
    dz = dz + torch.matmul(dp.to(w2.dtype).float(), w2.float().t())
    dq = dz * _dleaky(z, negative_slope)
    B, N, _, F = dq.shape
    da = torch.zeros((B, N, F), dtype=torch.float32, device=a.device)
    flat = idx.long().reshape(B, N * k, 1).expand(B, N * k, F)
    da.scatter_add_(1, flat, dq.to(h.dtype).float().reshape(B, N * k, F))
    return da, dq.sum(dim=2), dw2, db2


def edge_conv_bwd(idx, win1, win2, a, h, w2, x2, ct1, ct2, negative_slope: float = 0.0):
    """Backward of the DG block from the forward's saved idx and winners:
    idx [B, N, k] int32, win1/win2 [B, N, F] uint8, a/h/x2/ct1/ct2 [B, N, F],
    w2 [F, F] -> (da, dh [B, N, F], dW2 [F, F], db2 [F]), all f32. The kernel
    takes bf16 with F = 128 and the shapes :func:`edge_conv_bwd_supported`
    takes."""
    if not kernel_route(idx, win1, win2, a, h, w2, x2, ct1, ct2):
        return edge_conv_bwd_ref(idx, win1, win2, a, h, w2, x2, ct1, ct2, negative_slope)
    B, N, k = idx.shape
    bf16 = torch.bfloat16
    check_tensor("idx", idx, torch.int32, (B, N, k))
    for name, t in (("win1", win1), ("win2", win2)):
        check_tensor(name, t, torch.uint8, (B, N, 128))
    for name, t in (("a", a), ("h", h), ("x2", x2), ("ct1", ct1), ("ct2", ct2)):
        check_tensor(name, t, bf16, (B, N, 128))
    check_tensor("w2", w2, bf16, (128, 128))
    if not edge_conv_bwd_supported(N, k):
        raise ValueError(
            f"edge_conv_bwd kernel takes k in [1, 32] below N, got N={N} k={k}"
        )
    check_aligned(idx=idx, win1=win1, win2=win2, a=a, h=h, w2=w2, x2=x2, ct1=ct1, ct2=ct2)
    dev = idx.device
    f32 = torch.float32
    da = torch.zeros((B, N, 128), dtype=f32, device=dev)
    dh = torch.empty((B, N, 128), dtype=f32, device=dev)
    dw2 = torch.empty((128, 128), dtype=f32, device=dev)
    db2 = torch.empty((128,), dtype=f32, device=dev)
    _build.extension().edge_conv_bwd(
        idx, win1, win2, a, h, w2, x2, ct1, ct2, da, dh, dw2, db2, float(negative_slope)
    )
    edge_conv_bwd.launches += 1
    flop_meter.add(flop_meter.edge_conv_bwd_flops(*a.shape))
    return da, dh, dw2, db2


edge_conv_bwd.launches = 0


class _EdgeConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, h, w2, b2, k, negative_slope, grad_enabled):
        winners = grad_enabled and any(ctx.needs_input_grad[1:5])
        x1, x2, idx, *wins = fused_edge_conv(x, a, h, w2, b2, k, negative_slope,
                                             winners=winners)
        if winners:
            ctx.save_for_backward(idx, *wins, a, h, w2, x2)
        ctx.slope = negative_slope
        ctx.b2_dtype = b2.dtype
        ctx.mark_non_differentiable(idx)
        return x1, x2, idx

    @staticmethod
    def backward(ctx, ct1, ct2, _d_idx):
        if not any(ctx.needs_input_grad[1:5]):  # only x asked: it gets none
            return (None,) * 8
        idx, win1, win2, a, h, w2, x2 = ctx.saved_tensors
        da, dh, dw2, db2 = edge_conv_bwd(idx, win1, win2, a, h, w2, x2, ct1.contiguous(),
                                         ct2.contiguous(), ctx.slope)
        return (None, da.to(a.dtype), dh.to(h.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                None, None, None)


def edge_conv(x, a, h, w2, b2, k: int = 20, negative_slope: float = 0.0):
    """Differentiable :func:`fused_edge_conv` -> (x1, x2, idx), for eval and
    training: the forward emits the winners only when a gradient is wanted
    for a, h, w2 or b2, and the backward is :func:`edge_conv_bwd` on them."""
    return _EdgeConv.apply(x, a, h, w2, b2, k, negative_slope, torch.is_grad_enabled())
