"""Transformer pointer (counterpart of vcrnet_tpu/models/transformer.py).

One encoder-decoder shared by both directions, pre-norm residual
sublayers ``x + f(norm(x))``, a final norm after encoder and decoder, and
torch-style LayerNorm (unbiased std, eps added to the std).

Dropout at ``dropout`` (``Config.dropout``) in training mode, at the JAX
package's three sites (transformer.py:299-303, 338-341, 346-350): the
attention probabilities after the softmax (and the re-mask), the
feed-forward's hidden activation between ``relu(w_1)`` and ``w_2``, and
each residual branch ``x + drop(f(norm(x)))``. The masks come from the
model's :class:`DropoutRng`. Active dropout needs the probabilities
written out, so a sublayer that drops runs the plain attention, as the JAX
package does; eval, and rate 0, keep the kernels.

With ``flash=True`` (the CUDA bf16 route) attention runs the packed-head
kernels through ``ops.attention.attention`` (forward, and the backward
kernel when a gradient is wanted; both raise on shapes they do not take);
otherwise the plain f32-softmax path of transformer.py:287-310.

With ``VCRNET_FUSED_POINTER=1`` in the environment (read at each call, off
by default, as in the JAX package) the ``flash`` route runs whole sublayers
as single kernels where the JAX package does (transformer.py:176-194,
328-336): attention that is not re-masked and whose key is its value
through ``ops.pointer.fused_mha``, the feed-forward through
``ops.pointer.fused_ff``. Eval only: the module in eval mode and no gradient
being recorded (the kernels have no backward).

With ``int8`` (``Config.int8_eval`` in bf16, the JAX package's
transformer.py:134, 158-174) the q, k, v and out projections of every
attention sublayer run int8 (per-row dynamic int8 activations, per-channel
int8 weights) in eval mode, on every branch that projects: packed flash,
streaming and written-out re-mask, plain; the ``flash`` route through
``ops.int8_linear`` (its kernel on a CUDA tensor), the plain route through
its plain version on any device. Projections that share an input are one
call, which quantizes the input once: q, k and v of self-attention, k and
v of cross attention (the re-masked one too); q of cross attention and the
out projection are calls of one. Training
keeps the bf16 projections (the JAX package's ``not train``), and so the
flag leaves a training step bit for bit as it was. The fused sublayer
branch takes the bf16 weights and so bypasses int8, as in the JAX package
(its fused branch reads ``params_tuple()``): with the fused pointer in
whole mode no projection is quantized, in partial mode only the re-masked
cross attention's. The feed-forward never runs int8, in either package.

Partial-overlap mode re-masks the decoder's cross attention only: after
the first softmax the keys are ranked by their attention mass summed over
heads and queries, the top ``int(Nk * overlap2)`` stay, and the softmax is
taken again over them. Two routes, the JAX package's: the scores written
out with the dropped keys at -1e9 (plain PyTorch, as the JAX package
leaves it to XLA), and, with ``flash`` beyond ``stream_above`` keys, the
streaming one: ``ops.colmass.softmax_colmass`` for the masses, a gather of
the kept K and V rows, and the flash kernel over them (the same function:
exp(-1e9) is 0).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vcrnet_tpu_torch.models._common import Dropout, DropoutRng, dense, int8_dense
from vcrnet_tpu_torch.ops.attention import attention
from vcrnet_tpu_torch.ops.colmass import softmax_colmass
from vcrnet_tpu_torch.ops.layernorm import layer_norm_torch
from vcrnet_tpu_torch.ops.pointer import (
    fused_ff, fused_ff_supported, fused_mha, fused_mha_supported,
)

STREAM_REMASK_ABOVE = 2048  # keys; the JAX package's gate (transformer.py:262)


def _remask_topk_keys(scores: torch.Tensor, p_attn: torch.Tensor, keep_k: int) -> torch.Tensor:
    """scores/p_attn [B, H, Nq, Nk]: keep the ``keep_k`` keys with the
    largest attention mass summed over heads and queries, push the others'
    scores to -1e9 and take the softmax again."""
    col_mass = p_attn.sum(dim=(1, 2))  # [B, Nk]
    keep = torch.topk(col_mass, keep_k).indices
    mask = torch.zeros_like(col_mass, dtype=torch.bool).scatter_(1, keep, True)
    return torch.softmax(scores.masked_fill(~mask[:, None, None, :], -1e9), dim=-1)


class TorchLayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(d))
        self.b_2 = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm_torch(x, self.a_2, self.b_2, self.eps)


def _eval_only(module: nn.Module) -> bool:
    """Where the eval-only kernels may run: eval mode, no gradient recorded."""
    return not module.training and not torch.is_grad_enabled()


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around packed-head or plain attention;
    ``remask`` adds the partial-overlap key re-mask (see the module
    docstring), which streams beyond ``stream_above`` keys with ``flash``
    (an attribute, so a test can reach the streaming route at a small N);
    ``int8`` quantizes the projections in eval mode."""

    def __init__(self, d_model: int, n_heads: int, dtype=None, flash: bool = False,
                 remask: bool = False, overlap2: float = 1.0,
                 stream_above: int = STREAM_REMASK_ABOVE, dropout: float = 0.0,
                 dropout_rng: DropoutRng | None = None, int8: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.flash = flash
        self.int8 = int8
        self.remask = remask
        self.overlap2 = overlap2
        self.stream_above = stream_above
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)
        self.attn_drop = Dropout(dropout, dropout_rng)

    def _proj(self, layers, x) -> tuple:
        """x through each of ``layers``; with ``int8`` in eval, one int8
        call for all of them (one quantization of x)."""
        if self.int8 and not self.training:
            return int8_dense(layers, x, self.dtype, kernel=self.flash)
        return tuple(dense(layer, x, self.dtype) for layer in layers)

    def forward(self, query, key, value):
        B, nq, d = query.shape
        nk = key.shape[1]
        h = self.n_heads
        dk = d // h
        sm_scale = 1.0 / math.sqrt(dk)
        if (self.flash and not self.remask and _eval_only(self) and key is value
                and fused_mha_supported(nq, nk, d, h)):
            # the whole sublayer (projections, attention, out projection)
            # as one kernel call
            params = [t for lin in (self.linear_q, self.linear_k, self.linear_v, self.linear_out)
                      for t in (lin.weight.t(), lin.bias)]
            return fused_mha(query, key, *params, n_heads=h)
        # the projections that share an input go together: in int8, one
        # call quantizes the input once for all of them
        lq, lk, lv = self.linear_q, self.linear_k, self.linear_v
        if query is key and key is value:  # self-attention
            q, k, v = self._proj((lq, lk, lv), query)
        elif key is value:  # cross attention
            (q,) = self._proj((lq,), query)
            k, v = self._proj((lk, lv), key)
        else:
            (q,), (k,), (v,) = (self._proj((lin,), y) for lin, y in
                                ((lq, query), (lk, key), (lv, value)))
        dropping = self.attn_drop.active  # the probabilities are written out
        if self.flash and not self.remask and not dropping:
            x = attention(q, k, v, sm_scale, h)
        elif (self.flash and self.remask and not dropping and nk > self.stream_above
              and nk % 128 == 0 and nq % 128 == 0):
            col_mass = softmax_colmass(q, k, sm_scale, h).sum(dim=1)  # [B, Nk]
            keep = torch.topk(col_mass, int(nk * self.overlap2)).indices
            keep = keep[:, :, None].expand(-1, -1, d)
            x = attention(q, torch.gather(k, 1, keep), torch.gather(v, 1, keep), sm_scale, h)
        else:
            def heads(y):
                return y.reshape(B, -1, h, dk).transpose(1, 2).float()

            scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(dk)
            p = torch.softmax(scores, dim=-1)
            if self.remask:
                p = _remask_topk_keys(scores, p, int(nk * self.overlap2))
            p = self.attn_drop(p)
            x = torch.matmul(p.to(v.dtype).float(), heads(v))
            x = x.transpose(1, 2).reshape(B, nq, d)
        return self._proj((self.linear_out,), x)[0]


class FeedForward(nn.Module):
    """w_2(drop(relu(w_1(x)))); with ``flash`` the fused eval kernel where
    ``fused_ff_supported`` allows it."""

    def __init__(self, d_model: int, d_ff: int, dtype=None, flash: bool = False,
                 dropout: float = 0.0, dropout_rng: DropoutRng | None = None):
        super().__init__()
        self.dtype = dtype
        self.flash = flash
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)
        self.drop = Dropout(dropout, dropout_rng)

    def forward(self, x):
        if (self.flash and _eval_only(self)
                and fused_ff_supported(x.shape[1], self.w_1.in_features, self.w_1.out_features)):
            return fused_ff(x, self.w_1.weight.t(), self.w_1.bias, self.w_2.weight.t(),
                            self.w_2.bias)
        h = self.drop(torch.relu(dense(self.w_1, x, self.dtype)))
        return dense(self.w_2, h, self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dtype=None, flash=False, dropout=0.0,
                 dropout_rng=None, int8=False):
        super().__init__()
        drop = dict(dropout=dropout, dropout_rng=dropout_rng)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, flash, int8=int8, **drop)
        self.ff = FeedForward(d_model, d_ff, dtype, flash, **drop)
        self.norm0 = TorchLayerNorm(d_model)
        self.norm1 = TorchLayerNorm(d_model)
        self.drop = Dropout(dropout, dropout_rng)  # each residual branch, a mask a call

    def forward(self, x):
        y = self.norm0(x)
        x = x + self.drop(self.self_attn(y, y, y))
        return x + self.drop(self.ff(self.norm1(x)))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dtype=None, flash=False, partial=False,
                 overlap2=1.0, dropout=0.0, dropout_rng=None, int8=False):
        super().__init__()
        drop = dict(dropout=dropout, dropout_rng=dropout_rng)
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, flash, int8=int8, **drop)
        self.src_attn = MultiHeadAttention(d_model, n_heads, dtype, flash, remask=partial,
                                           overlap2=overlap2, int8=int8, **drop)
        self.ff = FeedForward(d_model, d_ff, dtype, flash, **drop)
        self.norm0 = TorchLayerNorm(d_model)
        self.norm1 = TorchLayerNorm(d_model)
        self.norm2 = TorchLayerNorm(d_model)
        self.drop = Dropout(dropout, dropout_rng)  # each residual branch, a mask a call

    def forward(self, x, memory):
        y = self.norm0(x)
        x = x + self.drop(self.self_attn(y, y, y))
        x = x + self.drop(self.src_attn(self.norm1(x), memory, memory))
        return x + self.drop(self.ff(self.norm2(x)))


class TransformerPointer(nn.Module):
    """(src_emb, tgt_emb) -> (src_delta, tgt_delta): tgt' = decode(tgt |
    encode(src)), src' = decode(src | encode(tgt)), shared weights.
    ``partial`` re-masks the decoder's cross attention to the
    ``int(Nk * overlap2)`` heaviest keys; ``dropout`` > 0 needs
    ``dropout_rng``; ``int8`` quantizes the attention projections in eval
    mode (see the module docstring)."""

    def __init__(self, emb_dims=512, n_blocks=1, n_heads=4, ff_dims=1024, dtype=None,
                 flash=False, partial=False, overlap2=1.0, dropout=0.0, dropout_rng=None,
                 int8=False):
        super().__init__()
        drop = dict(dropout=dropout, dropout_rng=dropout_rng, int8=int8)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(emb_dims, n_heads, ff_dims, dtype, flash, **drop)
            for _ in range(n_blocks)
        )
        self.dec_layers = nn.ModuleList(
            DecoderLayer(emb_dims, n_heads, ff_dims, dtype, flash, partial, overlap2, **drop)
            for _ in range(n_blocks)
        )
        self.enc_norm = TorchLayerNorm(emb_dims)
        self.dec_norm = TorchLayerNorm(emb_dims)

    def encode_memory(self, x):
        """Encoder pass only: refinement loops cache it for the target."""
        for layer in self.enc_layers:
            x = layer(x)
        return self.enc_norm(x)

    def _decode(self, x, memory):
        for layer in self.dec_layers:
            x = layer(x, memory)
        return self.dec_norm(x)

    def forward(self, src_emb, tgt_emb, tgt_memory=None):
        tgt_delta = self._decode(tgt_emb, self.encode_memory(src_emb))
        if tgt_memory is None:
            tgt_memory = self.encode_memory(tgt_emb)
        return self._decode(src_emb, tgt_memory), tgt_delta
