"""Point-sharded (sequence-parallel) flagship model: transformer pointer,
topK head in whole or partial mode, Procrustes, with gradients
(counterpart of vcrnet_tpu/parallel/sp_flagship.py).

Extends ``sp_model`` to the default configuration: every O(N^2) score
block (attention [Nq, Nk], the head's stage 1 [Ns, Nt] and stage 2
[K1, K1]) is computed for the rank's own rows against gathered keys, so a
rank holds O(N^2/D) of them plus O(N) gathered tables.

  * attention and its partial-mode re-mask follow ``models/transformer.py``;
    the re-mask's column masses (over heads and ALL queries) are a local
    sum all-reduced;
  * the head's stage-1 row masses are a softmax over the SHARDED source
    axis: a MAX all-reduce (no gradient: the shift cancels) then an
    all-reduced sum;
  * stage 2 re-shards the K1 selected source rows (padded to a multiple of
    the point shards, the padding at -inf confidence), and the final top-K2
    runs on the gathered confidences, replicated.

The selections are made by every rank on all-reduced values, which every
rank receives alike, so the ranks select alike. Gradients cross the ranks
by the convention of ``parallel/mesh.py``: ``sp_value_and_grad`` is the
counterpart of ``jax.value_and_grad(sp_train_loss)``.
"""

from __future__ import annotations

import math

import torch

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.ops.graph import neg_pairwise_sqdist, take_rows
from vcrnet_tpu_torch.parallel.mesh import Mesh
from vcrnet_tpu_torch.parallel.point_sharding import (
    batch_mesh, point_mesh, sharded_soft_correspondence, world_mesh,
)
from vcrnet_tpu_torch.parallel.sp_model import lpdnet_embed_sp, procrustes_sp


def _mha_sp(attn, q_in: torch.Tensor, kv_in: torch.Tensor, pm: Mesh) -> torch.Tensor:
    """Multi-head attention (a ``MultiHeadAttention``, whose ``n_heads``,
    ``remask`` and ``overlap2`` it reads) of this rank's queries
    [B, nq_loc, E] against the keys and values of every rank's kv_in
    [B, nk_loc, E] (projected here, then gathered). With ``remask`` the
    partial-overlap re-mask keeps the ``int(Nk * overlap2)`` keys of
    largest global column mass."""
    B, nq, E = q_in.shape
    n_heads = attn.n_heads
    dk = E // n_heads

    def heads(y):
        return y.reshape(B, -1, n_heads, dk).transpose(1, 2)

    q = heads(attn.linear_q(q_in))
    k = heads(pm.all_gather(attn.linear_k(kv_in), 1))
    v = heads(pm.all_gather(attn.linear_v(kv_in), 1))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
    p = torch.softmax(scores, dim=-1)
    if attn.remask:
        # the global column mass per key: over heads and every rank's queries
        col_mass = pm.all_reduce_(p.detach().sum(dim=(1, 2)))  # [B, Nk]
        keep = torch.topk(col_mass, int(k.shape[2] * attn.overlap2)).indices
        mask = torch.zeros_like(col_mass, dtype=torch.bool).scatter_(1, keep, True)
        p = torch.softmax(scores.masked_fill(~mask[:, None, None, :], -1e9), dim=-1)
    x = torch.matmul(p, v).transpose(1, 2).reshape(B, nq, E)
    return attn.linear_out(x)


def _ff(ff, x: torch.Tensor) -> torch.Tensor:
    return ff.w_2(torch.relu(ff.w_1(x)))


def _encoder_layer(layer, x, pm):
    y = layer.norm0(x)
    x = x + _mha_sp(layer.self_attn, y, y, pm)
    return x + _ff(layer.ff, layer.norm1(x))


def _decoder_layer(layer, x, memory, pm):
    y = layer.norm0(x)
    x = x + _mha_sp(layer.self_attn, y, y, pm)
    x = x + _mha_sp(layer.src_attn, layer.norm1(x), memory, pm)  # re-masked in partial mode
    return x + _ff(layer.ff, layer.norm2(x))


def _pointer_local(pointer, src_l, tgt_l, pm):
    """The shared bidirectional pointer (``TransformerPointer``) on shards:
    (src_delta, tgt_delta) of this rank's points."""

    def encode(x):
        for layer in pointer.enc_layers:
            x = _encoder_layer(layer, x, pm)
        return pointer.enc_norm(x)

    def decode(x, memory):
        for layer in pointer.dec_layers:
            x = _decoder_layer(layer, x, memory, pm)
        return pointer.dec_norm(x)

    tgt_delta = decode(tgt_l, encode(src_l))
    src_delta = decode(src_l, encode(tgt_l))
    return src_delta, tgt_delta


def _softmax_over_sharded_rows(scores_l: torch.Tensor, pm: Mesh) -> torch.Tensor:
    """This rank's rows of softmax(scores, dim=1) for a [B, n_loc, M] block
    whose row axis is sharded: the global column max (no gradient), then
    the all-reduced column sums."""
    m = pm.all_reduce_max(scores_l.amax(dim=1))  # [B, M]
    e = torch.exp(scores_l - m[:, None, :])
    return e / pm.all_reduce(e.sum(dim=1))[:, None, :]


def _vcp_partial_local(se_l, te_l, src_l, tgt_l, overlap2: float, n_total: int, pm: Mesh):
    """The partial topK head (``models/heads.py::vcp_top_k_partial``) with
    its score blocks sharded over this rank's rows: (src_k, src_corr_k)
    [B, K2, 3], replicated over the point axis. Both are points picked by
    selections, so no gradient reaches the parameters (as in JAX)."""
    k1 = int(n_total * 0.84 * overlap2)
    k2 = int(k1 * 0.52 * overlap2)
    te_full = pm.all_gather(te_l, 1)
    tgt_full = pm.all_gather(tgt_l.float(), 1)

    # stage 1: column mass of the row softmax, row mass of the column softmax
    with torch.no_grad():
        scores_l = neg_pairwise_sqdist(se_l, te_full)  # [B, n_loc, Nt]
        col_mass = pm.all_reduce_(torch.softmax(scores_l, dim=2).sum(dim=1))  # [B, Nt]
        tgt_idx = torch.topk(col_mass, k1).indices
        row_mass = pm.all_gather(_softmax_over_sharded_rows(scores_l, pm).sum(dim=2), 1)
        src_idx = torch.topk(row_mass, k1).indices  # [B, K1]
        del scores_l

    se_full = pm.all_gather(se_l, 1)
    src_full = pm.all_gather(src_l.float(), 1)
    tgt_sel = take_rows(tgt_full, tgt_idx)  # [B, K1, 3]
    tgt_emb_sel = take_rows(te_full, tgt_idx)

    # stage 2: each rank rescores its slice of the K1 rows, padded to a
    # multiple of the shards
    rows_per = -(-k1 // pm.size)
    my_rows = pm.rank * rows_per + torch.arange(rows_per, device=src_idx.device)
    in_range = my_rows < k1
    my_idx = src_idx[:, my_rows.clamp(max=k1 - 1)]  # [B, rows_per]
    src_sel_l = take_rows(src_full, my_idx)
    p2 = torch.softmax(neg_pairwise_sqdist(take_rows(se_full, my_idx), tgt_emb_sel), dim=2)
    conf_l, best_l = p2.max(dim=-1)  # the first index on ties
    conf_l = conf_l.detach().masked_fill(~in_range[None, :], float("-inf"))

    conf = pm.all_gather(conf_l, 1)  # [B, K1p]
    best = pm.all_gather(best_l, 1)
    src_sel = pm.all_gather(src_sel_l, 1)
    keep = torch.topk(conf, k2).indices  # [B, K2], positions in K1p
    return take_rows(src_sel, keep), take_rows(tgt_sel, torch.gather(best, 1, keep))


def register_flagship_sp(model, src: torch.Tensor, tgt: torch.Tensor, mesh,
                         batch_axis: str | None = None):
    """Point-sharded VCR-Net forward: LPDNet embedding, transformer pointer,
    topK head, Procrustes. ``model`` is a ``VCRNet``, whose modules and
    config give the heads, blocks, k, slope, and the partial mode and
    overlap; src, tgt [B, N/D, 3] are this rank's shards (its batch rows
    too, with ``batch_axis="batch"`` on a ``make_mesh_2d`` mesh, whose
    point collectives stay within the rank's row). Returns (src_k,
    src_corr_k, R_ab, t_ab), replicated over the point axis: in whole mode
    every point and its correspondence [B, N, 3], in partial mode the K2
    selected pairs. Differentiable."""
    pm = point_mesh(mesh, batch_axis)
    se = lpdnet_embed_sp(model.emb_nn, src, mesh, batch_axis)
    te = lpdnet_embed_sp(model.emb_nn, tgt, mesh, batch_axis)
    src_delta, tgt_delta = _pointer_local(model.pointer, se, te, pm)
    se, te = se + src_delta, te + tgt_delta

    if model.cfg.partial:
        n_total = src.shape[1] * pm.size
        src_k, src_corr_k = _vcp_partial_local(se, te, src, tgt, model.cfg.overlap2, n_total, pm)
        R, t = geometry.procrustes(src_k, src_corr_k)  # the K2 pairs are replicated
        return src_k, src_corr_k, R, t

    corr = sharded_soft_correspondence(se, te, tgt, mesh, batch_axis)
    R, t = procrustes_sp(src, corr, pm)
    return pm.all_gather(src.float(), 1), pm.all_gather(corr, 1), R, t


def pointer_sp(pointer, src_emb: torch.Tensor, tgt_emb: torch.Tensor, mesh,
               batch_axis: str | None = None):
    """The point-sharded transformer pointer alone (a ``TransformerPointer``
    module; its cross attention re-masks where it was built ``partial``):
    (src_delta, tgt_delta) of this rank's points."""
    return _pointer_local(pointer, src_emb, tgt_emb, point_mesh(mesh, batch_axis))


def sp_train_loss(model, src, tgt, R_gt, t_gt, mesh, batch_axis: str | None = None) -> torch.Tensor:
    """The point loss (mean squared distance between the ground-truth-moved
    source points and their correspondences) through the point-sharded
    forward, over the global batch: with ``batch_axis`` the batch rows'
    means are averaged over the mesh's batch axis. R_gt [B, 3, 3] and t_gt
    [B, 3] are this rank's batch rows. The value is every rank's; its
    backward leaves this rank's share of each parameter gradient (see
    ``parallel/mesh.py``), which ``sp_value_and_grad`` sums."""
    src_k, src_corr_k, _, _ = register_flagship_sp(model, src, tgt, mesh, batch_axis)
    moved = torch.einsum("bij,bnj->bni", R_gt.float(), src_k) + t_gt.float()[:, None, :]
    loss = ((moved - src_corr_k) ** 2).mean()
    bm = batch_mesh(mesh, batch_axis)
    if bm is not None:
        loss = bm.all_reduce(loss) / bm.size
    return world_mesh(mesh).replicated(loss)


def sp_value_and_grad(model, src, tgt, R_gt, t_gt, mesh, batch_axis: str | None = None):
    """``jax.value_and_grad(sp_train_loss)`` for the port: the loss, and
    every parameter's ``.grad`` set to the single device's gradient (the
    ranks' shares summed over the world in one all-reduce; zero for a
    parameter no path reaches, all of them in partial mode, where the
    loss has no gradient path). Returns (loss, {name: grad})."""
    model.zero_grad(set_to_none=True)
    loss = sp_train_loss(model, src, tgt, R_gt, t_gt, mesh, batch_axis)
    if loss.requires_grad:
        loss.backward()
    world_mesh(mesh).all_reduce_grads(model.parameters())
    return loss.detach(), {name: p.grad for name, p in model.named_parameters()}
