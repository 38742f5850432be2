"""The transformer pointer's sublayers as single kernel calls, beside their
plain versions. Off unless ``VCRNET_FUSED_POINTER=1`` (read at call time), as
in the JAX package, where they are kept as a measured negative result on the
TPU.

  fused_mha  q/k/v projections, per-head softmax(q k^T / sqrt(dk)) v, out
             projection (vcrnet_tpu/ops/pallas_pointer.py:fused_mha)
  fused_ff   w2(relu(w1 y)) (vcrnet_tpu/ops/pallas_pointer.py:fused_ff)

Both cast activations, weights and biases to bf16, accumulate in f32 and
return bf16, with the Pallas kernels' rounding points: q, k, v, the hidden
tile and the per-head outputs rounded to bf16; scores and softmax in f32;
``exp(s - m)`` rounded to bf16 before its product with v and divided by the
f32 row sum afterwards (the CUDA attention rounds it against the running max
of 64-key tiles, not the row's final max: ROADMAP C). A CUDA tensor launches
``csrc/pointer_mha.cu`` (three kernels: the q/k/v projections, the
attention, the out projection; one counted launch) / ``csrc/pointer_ff.cu``
(two launches of the product through a bf16 hidden scratch; one counted
launch), or raises; a CPU tensor runs the ``*_ref`` plain version. Eval only: no
backward, and the wrappers raise where a gradient is wanted. Weights are
[in, out] (a Linear's ``weight.t()``).
"""

from __future__ import annotations

import os

import torch

from vcrnet_tpu_torch.ops import _build, library
from vcrnet_tpu_torch.ops._common import SMEM_LIMIT, check_aligned, check_tensor, kernel_route

HEAD_DIM = 128  # the attention kernel's dk
MAX_D_MODEL = 512  # the widest sublayer whose kernels are held to the plain version on the card
MAX_D_FF = 4096  # the widest feed-forward hidden layer held on the card


def fused_pointer_enabled() -> bool:
    return os.environ.get("VCRNET_FUSED_POINTER", "0") == "1"


def gemm_smem_bytes() -> int:
    """Shared memory of the product (csrc/gemm_wgmma.cuh): a ring of three
    stages, each a [128, 64] slice of the activations and a [64, 256] slice
    of the weights, the [128, 256] bf16 output tile (or half of an f32 one),
    1 KB of alignment and the ring's barriers, at any widths."""
    box = 64 * 64 * 2
    return 1024 + 3 * (2 * box + 4 * box) + 8 * box + 2 * 3 * 8


def pointer_ff_smem_bytes(d: int, f: int) -> int:
    """Shared memory of the feed-forward sublayer's kernels
    (csrc/pointer_ff.cu: two launches of the product), which depends on
    neither width."""
    del d, f
    return gemm_smem_bytes()


def pointer_mha_smem_bytes(d: int) -> int:
    """Shared memory of the sublayer's largest kernel (csrc/pointer_mha.cu):
    the product's. The attention kernel takes less (99368 bytes), and
    neither depends on the model width ``d``."""
    del d
    return gemm_smem_bytes()


def fused_mha_supported(nq: int, nk: int, d: int, n_heads: int) -> bool:
    """Whether the model takes the fused attention branch: the environment
    variable, then the shapes the CUDA kernels are held to (dk == 128,
    D <= 512, any lengths: the projections take any number of rows, and the
    attention stores only the real query rows and masks the keys past Nk
    by a count, as ``flash_packed`` does). On dk == 128 and D <= 512
    this takes every shape the JAX gate takes (pallas_pointer.py:
    fused_mha_supported, lengths in 128s) and more: the JAX package's
    on-chip budget for a batch item's K and V does not bind here, where
    they live in device memory."""
    if not fused_pointer_enabled():
        return False
    return (d % n_heads == 0 and d // n_heads == HEAD_DIM and d <= MAX_D_MODEL
            and nq > 0 and nk > 0 and pointer_mha_smem_bytes(d) <= SMEM_LIMIT)


def fused_ff_supported(n: int, d: int, f: int) -> bool:
    """Whether the model takes the fused feed-forward branch: the
    environment variable, then the widths the CUDA kernels are held to on
    the card (D in 128s up to 512, F in 128s up to 4096; any number of
    rows). Their shared memory depends on neither width."""
    if not fused_pointer_enabled():
        return False
    return _ff_widths_held(d, f)


def _ff_widths_held(d: int, f: int) -> bool:
    return d % 128 == 0 and f % 128 == 0 and d <= MAX_D_MODEL and f <= MAX_D_FF


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def _dense_bf16(y, w, b):
    """bf16(y @ w + b) with bf16 operands, f32 accumulation and bias add."""
    return _bf(torch.matmul(_bf(y).float(), _bf(w).float()) + _bf(b).float())


def fused_mha_ref(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_mha`."""
    B, nq, d = yq.shape
    dk = d // n_heads

    def heads(t):
        return t.reshape(B, -1, n_heads, dk).transpose(1, 2).float()

    q, k, v = _dense_bf16(yq, wq, bq), _dense_bf16(ykv, wk, bk), _dense_bf16(ykv, wv, bv)
    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * (1.0 / dk ** 0.5)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(_bf(e).float(), heads(v)) / e.sum(dim=-1, keepdim=True)
    o = _bf(o).transpose(1, 2).reshape(B, nq, d)
    return _dense_bf16(o, wo, bo)


def _refuse_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; call it under torch.no_grad()")


def fused_mha(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int) -> torch.Tensor:
    """yq [B, Nq, D], ykv [B, Nk, D] (pass yq for self-attention), weights
    [D, D] (in, out) and biases [D] in any float dtype -> [B, Nq, D] bf16:
    the whole sublayer before the residual. The kernel takes dk == 128,
    D <= 512 and any lengths. Runs the op ``vcrnet_torch::fused_mha``."""
    tensors = (yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo)
    _refuse_grad("fused_mha", tensors)
    if kernel_route(*tensors):
        B, nq, d = yq.shape
        nk = ykv.shape[1]
        if (d % n_heads or d // n_heads != HEAD_DIM or d > MAX_D_MODEL
                or pointer_mha_smem_bytes(d) > SMEM_LIMIT):
            raise ValueError(
                f"fused_mha kernel does not take nq={nq} nk={nk} d_model={d} heads={n_heads}"
            )
        yq_b = _bf(yq).contiguous()
        ykv_b = yq_b if ykv is yq else _bf(ykv).contiguous()
        check_tensor("yq", yq_b, torch.bfloat16, (B, nq, d))
        check_tensor("ykv", ykv_b, torch.bfloat16, (B, nk, d))
        params = []
        for name, w, b in (("q", wq, bq), ("k", wk, bk), ("v", wv, bv), ("o", wo, bo)):
            w, b = _bf(w).contiguous(), _bf(b).contiguous()
            check_tensor(f"w{name}", w, torch.bfloat16, (d, d))
            check_tensor(f"b{name}", b, torch.bfloat16, (d,))
            params += [w, b]
        tensors = (yq_b, ykv_b, *params)
    return _fused_mha_op(*tensors, n_heads)


def _fused_mha_impl(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int):
    tensors = (yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo)
    if not kernel_route(*tensors):
        return fused_mha_ref(*tensors, n_heads)
    check_aligned(**dict(zip(("yq", "ykv", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"),
                             tensors)))
    out = torch.empty_like(yq)
    _build.extension().pointer_mha(*tensors, out, n_heads)
    fused_mha.launches += 1
    return out


def _fused_mha_fake(yq, ykv, wq, bq, wk, bk, wv, bv, wo, bo, n_heads: int):
    return yq.new_empty(yq.shape, dtype=torch.bfloat16)


_fused_mha_op = library.define(
    "fused_mha",
    "(Tensor yq, Tensor ykv, Tensor wq, Tensor bq, Tensor wk, Tensor bk, Tensor wv, Tensor bv, "
    "Tensor wo, Tensor bo, int n_heads) -> Tensor",
    _fused_mha_impl, _fused_mha_fake)


fused_mha.launches = 0


def fused_ff_ref(y, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of :func:`fused_ff`."""
    h = _bf(torch.relu(torch.matmul(_bf(y).float(), _bf(w1).float()) + _bf(b1).float()))
    return _dense_bf16(h, w2, b2)


def fused_ff(y, w1, b1, w2, b2) -> torch.Tensor:
    """y [B, N, D], w1 [D, F], b1 [F], w2 [F, D], b2 [D] in any float dtype
    -> [B, N, D] bf16. The kernels take D % 128 == 0, F % 128 == 0,
    D <= 512 and F <= 4096, any number of rows. Runs the op
    ``vcrnet_torch::fused_ff``."""
    tensors = (y, w1, b1, w2, b2)
    _refuse_grad("fused_ff", tensors)
    if kernel_route(*tensors):
        B, n, d = y.shape
        f = w1.shape[1]
        if not _ff_widths_held(d, f):
            raise ValueError(f"fused_ff kernel does not take d_model={d} d_ff={f}")
        tensors = tuple(_bf(t).contiguous() for t in tensors)
        for name, t, shape in zip(("y", "w1", "b1", "w2", "b2"), tensors,
                                  ((B, n, d), (d, f), (f,), (f, d), (d,))):
            check_tensor(name, t, torch.bfloat16, shape)
    return _fused_ff_op(*tensors)


def _fused_ff_impl(y, w1, b1, w2, b2):
    if not kernel_route(y, w1, b1, w2, b2):
        return fused_ff_ref(y, w1, b1, w2, b2)
    check_aligned(y=y, w1=w1, b1=b1, w2=w2, b2=b2)
    out = torch.empty_like(y)
    _build.extension().pointer_ff(y, w1, b1, w2, b2, out)
    fused_ff.launches += 1
    return out


def _fused_ff_fake(y, w1, b1, w2, b2):
    return y.new_empty(y.shape, dtype=torch.bfloat16)


_fused_ff_op = library.define(
    "fused_ff", "(Tensor y, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    _fused_ff_impl, _fused_ff_fake)


fused_ff.launches = 0
