"""Transformer pointer (counterpart of vcrnet_tpu/models/transformer.py).

One encoder-decoder shared by both directions, pre-norm residual
sublayers ``x + f(norm(x))``, a final norm after encoder and decoder, and
torch-style LayerNorm (unbiased std, eps added to the std). No dropout.

With ``flash=True`` (the CUDA bf16 route) attention runs the packed-head
kernels through ``ops.attention.attention`` (forward, and the backward
kernel when a gradient is wanted; both raise on shapes they do not take);
otherwise the plain f32-softmax path of transformer.py:287-310.

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

from vcrnet_tpu_torch.models._common import dense
from vcrnet_tpu_torch.ops.attention import attention
from vcrnet_tpu_torch.ops.colmass import softmax_colmass
from vcrnet_tpu_torch.ops.layernorm import layer_norm_torch

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


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections around packed-head or plain attention;
    ``remask`` adds the partial-overlap key re-mask (see the module
    docstring), which streams beyond ``stream_above`` keys with ``flash``
    (an attribute, so a test can reach the streaming route at a small N)."""

    def __init__(self, d_model: int, n_heads: int, dtype=None, flash: bool = False,
                 remask: bool = False, overlap2: float = 1.0,
                 stream_above: int = STREAM_REMASK_ABOVE):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.flash = flash
        self.remask = remask
        self.overlap2 = overlap2
        self.stream_above = stream_above
        self.linear_q = nn.Linear(d_model, d_model)
        self.linear_k = nn.Linear(d_model, d_model)
        self.linear_v = nn.Linear(d_model, d_model)
        self.linear_out = nn.Linear(d_model, d_model)

    def forward(self, query, key, value):
        B, nq, d = query.shape
        nk = key.shape[1]
        h = self.n_heads
        dk = d // h
        sm_scale = 1.0 / math.sqrt(dk)
        q = dense(self.linear_q, query, self.dtype)
        k = dense(self.linear_k, key, self.dtype)
        v = dense(self.linear_v, value, self.dtype)
        if self.flash and not self.remask:
            x = attention(q, k, v, sm_scale, h)
        elif (self.flash and self.remask and nk > self.stream_above
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
            x = torch.matmul(p.to(v.dtype).float(), heads(v))
            x = x.transpose(1, 2).reshape(B, nq, d)
        return dense(self.linear_out, x, self.dtype)


class FeedForward(nn.Module):
    """w_2(relu(w_1(x)))."""

    def __init__(self, d_model: int, d_ff: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.w_1 = nn.Linear(d_model, d_ff)
        self.w_2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return dense(self.w_2, torch.relu(dense(self.w_1, x, self.dtype)), self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dtype=None, flash=False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, flash)
        self.ff = FeedForward(d_model, d_ff, dtype)
        self.norm0 = TorchLayerNorm(d_model)
        self.norm1 = TorchLayerNorm(d_model)

    def forward(self, x):
        y = self.norm0(x)
        x = x + self.self_attn(y, y, y)
        return x + self.ff(self.norm1(x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dtype=None, flash=False, partial=False,
                 overlap2=1.0):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, flash)
        self.src_attn = MultiHeadAttention(d_model, n_heads, dtype, flash, remask=partial,
                                           overlap2=overlap2)
        self.ff = FeedForward(d_model, d_ff, dtype)
        self.norm0 = TorchLayerNorm(d_model)
        self.norm1 = TorchLayerNorm(d_model)
        self.norm2 = TorchLayerNorm(d_model)

    def forward(self, x, memory):
        y = self.norm0(x)
        x = x + self.self_attn(y, y, y)
        x = x + self.src_attn(self.norm1(x), memory, memory)
        return x + self.ff(self.norm2(x))


class TransformerPointer(nn.Module):
    """(src_emb, tgt_emb) -> (src_delta, tgt_delta): tgt' = decode(tgt |
    encode(src)), src' = decode(src | encode(tgt)), shared weights.
    ``partial`` re-masks the decoder's cross attention to the
    ``int(Nk * overlap2)`` heaviest keys."""

    def __init__(self, emb_dims=512, n_blocks=1, n_heads=4, ff_dims=1024, dtype=None,
                 flash=False, partial=False, overlap2=1.0):
        super().__init__()
        self.enc_layers = nn.ModuleList(
            EncoderLayer(emb_dims, n_heads, ff_dims, dtype, flash) for _ in range(n_blocks)
        )
        self.dec_layers = nn.ModuleList(
            DecoderLayer(emb_dims, n_heads, ff_dims, dtype, flash, partial, overlap2)
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
