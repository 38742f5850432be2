"""Dynamically quantized int8 linear for the pointer's q/k/v/out projections
at eval (counterpart of vcrnet_tpu/ops/int8_linear.py, behind
``Config.int8_eval``), as a kernel beside its plain version.

Scheme (the JAX package's): symmetric per-row activation scales
``max|x| / 127`` over the last axis, symmetric per-output-channel weight
scales, int8 codes ``clip(round(x / s), -127, 127)`` with round half to
even, an exact integer product, then ``((acc * x_scale) * w_scale) + bias``
in f32, rounded once to the output's dtype. Weights come in ``nn.Linear``'s
[F, K] layout, so a weight's per-output-channel scale is its row's, and one
quantization rule serves both operands. Callers pass the weight and bias
cast to the compute dtype first, as flax's ``promote_dtype`` does in the
JAX package (models/_common.py:int8_dense): the bf16 values are quantized,
not the f32 parameters.

One call takes one activation and 1 to ``MAX_PAIRS`` (weight, bias) pairs
(:func:`int8_linear_shared`: q, k and v of self-attention, k and v of cross
attention) and returns an output for each; :func:`int8_linear` is the call
of one pair. The activation's codes are the same for every pair, so a call
of several pairs equals a call of each pair alone: the JAX package's
compiled graph quantizes an input that its projections share once
(vcrnet_tpu/models/transformer.py:158-160).

A CUDA tensor launches ``csrc/int8_linear.cu`` (a pass over the weight
rows of every pair, then one product kernel that quantizes each 128-row
tile of x in shared memory, so its codes never reach device memory, and
runs the s8 x s8 -> s32 products of every pair against it on the tensor
cores, with the dequantization and bias in its epilogue; one counted
launch a call) or raises: it takes bf16 with :func:`int8_supported` widths
and no gradient. A CPU tensor runs :func:`int8_linear_ref` on each pair.
The kernel equals the plain version bit for bit: the codes and scales by
correctly rounded division, the integer sums in any order, the epilogue
without contractions. Eval only, as in the JAX package: the rounding has a
zero gradient almost everywhere, so training keeps the bf16 projections.
Runs the op ``vcrnet_torch::int8_linear`` (the pairs as one tensor list).
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops import _build, flop_meter, library
from vcrnet_tpu_torch.ops._common import check_aligned, check_tensor, kernel_route

WIDTH_MULTIPLE = 64  # K and F: whole 64-column boxes of the kernel's tiles
MAX_WIDTH = 1024  # the widest K and F held to the plain version on the card
MAX_PAIRS = 3  # (weight, bias) pairs of one call: q, k and v


def int8_supported(rows: int, k: int, f) -> bool:
    """Shapes the kernel takes: any number of rows (the last 128-row tile
    is ragged), K and every F multiples of 64 up to ``MAX_WIDTH``; ``f`` is
    one output width or the widths of a call's 1 to ``MAX_PAIRS`` pairs.
    The card holds it bit-equal to the plain version with 1, 2 and 3 pairs
    at K = F = 64 (one 128-deep slice, half past K; one weight box of a
    256-column tile), K = 576 with F = 320 (a ragged last slice and column
    tile), 512 and 1024."""
    fs = (f,) if isinstance(f, int) else tuple(f)
    return (rows > 0 and 0 < k <= MAX_WIDTH and k % WIDTH_MULTIPLE == 0
            and 0 < len(fs) <= MAX_PAIRS
            and all(0 < v <= MAX_WIDTH and v % WIDTH_MULTIPLE == 0 for v in fs))


def quantize_rows_ref(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the last axis:
    (q int8 [..., K], scale f32 [..., 1]) with q * scale ~= x. The divisions
    are true divisions by tensors: PyTorch divides a CUDA tensor by a Python
    scalar as a multiplication by its reciprocal, which can move codes at the
    half-way points."""
    s = x.abs().amax(dim=-1, keepdim=True).float()
    s = torch.clamp_min(s, 1e-30) / torch.full_like(s, 127.0)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def int8_linear_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_linear`. The product is taken in f64,
    exact for any K the kernel takes (|sum| <= 127^2 K), as PyTorch has no
    int32 product on CUDA tensors."""
    xq, xs = quantize_rows_ref(x)
    wq, ws = quantize_rows_ref(weight)
    acc = torch.matmul(xq.double(), wq.double().t())
    y = acc.float() * xs * ws.reshape(-1) + bias.float()
    return y.to(x.dtype)


def int8_linear_shared_ref(x: torch.Tensor, pairs) -> tuple:
    """Plain version of :func:`int8_linear_shared`: :func:`int8_linear_ref`
    on each pair."""
    return tuple(int8_linear_ref(x, w, b) for w, b in pairs)


def _refuse_grad(tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("int8_linear has no backward; call it under torch.no_grad()")


def _check(x, pairs) -> None:
    """The kernel route's checks: dtype, shapes, contiguity, the gate."""
    _refuse_grad((x, *(t for pair in pairs for t in pair)))
    k = x.shape[-1]
    fs = [w.shape[0] for w, _ in pairs]
    rows = x.numel() // k if k else 0
    if not int8_supported(rows, k, fs):
        raise ValueError(
            f"int8_linear kernel takes K and F in multiples of {WIDTH_MULTIPLE} up to "
            f"{MAX_WIDTH}, at least one row and 1 to {MAX_PAIRS} pairs, got rows={rows} K={k} "
            f"F={fs}"
        )
    check_tensor("x", x, torch.bfloat16, x.shape)
    for i, ((w, b), f) in enumerate(zip(pairs, fs)):
        check_tensor(f"weight {i}", w, torch.bfloat16, (f, k))
        check_tensor(f"bias {i}", b, torch.bfloat16, (f,))


def int8_linear_shared(x: torch.Tensor, pairs) -> tuple:
    """x [..., K] and 1 to ``MAX_PAIRS`` pairs (weight [F_i, K], bias
    [F_i]) -> a contiguous [..., F_i] tensor in x's dtype for each pair:
    ``x @ weight.T + bias`` with both operands quantized to int8, one
    quantization of x for all pairs; see the module docstring."""
    pairs = tuple(pairs)
    flat = [t for pair in pairs for t in pair]
    if kernel_route(x, *flat):
        _check(x, pairs)
    return tuple(_int8_linear_op(x, flat))


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x [..., K], weight [F, K], bias [F] -> [..., F]: the call of one
    pair (:func:`int8_linear_shared`). Its ``.launches`` counts the kernel's
    launches of both."""
    return int8_linear_shared(x, ((weight, bias),))[0]


def int8_linear_parts(x: torch.Tensor, pairs):
    """(outputs, x's row scales [rows, 1], the weights' codes [sum F_i, K]
    and scales [sum F_i, 1]) of one call: the kernel's own on a CUDA tensor
    (a counted launch; x's codes stay in shared memory), the plain
    version's on the CPU. For holding the kernel's scales and weight codes
    against the plain version's."""
    pairs = tuple(pairs)
    flat = [t for pair in pairs for t in pair]
    if not kernel_route(x, *flat):
        _, xs = quantize_rows_ref(x.reshape(-1, x.shape[-1]))
        wq, ws = quantize_rows_ref(torch.cat([w for w, _ in pairs]))
        return int8_linear_shared_ref(x, pairs), xs, wq, ws
    _check(x, pairs)
    outs, wq, ws, xs = _launch(x, pairs, row_scales=True)
    return tuple(outs), xs[:, None], wq, ws[:, None]


def _launch(x, pairs, row_scales: bool = False):
    check_aligned(x=x, **{f"param {i}": t for i, t in enumerate(t for p in pairs for t in p)})
    k = x.shape[-1]
    fs = [w.shape[0] for w, _ in pairs]
    rows = x.numel() // k
    dev = x.device
    outs = [torch.empty((*x.shape[:-1], f), dtype=torch.bfloat16, device=dev) for f in fs]
    wq = torch.empty((sum(fs), k), dtype=torch.int8, device=dev)
    ws = torch.empty((sum(fs),), dtype=torch.float32, device=dev)
    xs = torch.empty((rows,), dtype=torch.float32, device=dev) if row_scales else None
    _build.extension().int8_linear(x, [w for w, _ in pairs], [b for _, b in pairs], outs, wq, ws,
                                   xs)
    int8_linear.launches += 1
    int8_linear.projections += len(pairs)
    flop_meter.add(sum(flop_meter.int8_linear_flops(rows, f, k) for f in fs))
    return outs, wq, ws, xs


def _pairs(params):
    return tuple(zip(params[::2], params[1::2]))


def _int8_linear_impl(x, params):
    if not kernel_route(x, *params):
        return list(int8_linear_shared_ref(x, _pairs(params)))
    return _launch(x, _pairs(params))[0]


def _int8_linear_fake(x, params):
    return [x.new_empty((*x.shape[:-1], w.shape[0])) for w in params[::2]]


_int8_linear_op = library.define(
    "int8_linear", "(Tensor x, Tensor[] params) -> Tensor[]",
    _int8_linear_impl, _int8_linear_fake)


int8_linear.launches = 0
int8_linear.projections = 0  # pairs of the launches: the product's count for the FLOP meter
