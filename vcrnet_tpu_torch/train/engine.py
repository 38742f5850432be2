"""Training engine for the four model families (counterpart of
vcrnet_tpu/train/engine.py): ``model="vcrnet"``, ``"dcp"``, ``"lpd"``
(LPDNet pretraining) and ``"icp"`` (parameter-free, eval only).

One step is the JAX package's ``Trainer._train_step_impl``: forward (the
model in training mode; VCR-Net's LPDNet embeds both clouds in one stacked
call, with a T-Net updating its running statistics once; DCP's embedding,
another BatchNorm embedding of VCR-Net and LPD's LPDNet with a T-Net one
after the other, updating them twice), loss, gradients (on the kernel route the backward kernels of
``ops``), and the optimizer update; the metric sums of the batch stay on
the device and are added up per epoch. VCR-Net's eval runs ``vcrnet_iter``
at ``cfg.iter``, or net + ICP (``vcrnet_icp``) at ``cfg.iter == 0``, whole
or partial-overlap; DCP's and LPD's are one pass, ICP's ``icp_register``
with DCP's sums.

The gradient is JAX's dense tree: a parameter that no gradient path
reaches gets a zero gradient, and the optimizer steps on it (its weight
decay moves it). In partial-overlap mode VCR-Net's head outputs are all
gathers, so no gradient reaches any parameter and its loss has none to
give: the step runs no backward and Adam sees only the weight decay, each
weight moving by about lr towards zero, as in the JAX package (whose
notes record that partial-mode gradients are zero). DCP on partial crops
has real gradients, through the re-masked cross attention.

With ``cfg.dropout`` > 0 the pointer's dropout masks are drawn from the
model's generator seeded from (``cfg.seed + 0xD0``, step), the JAX
package's fold. With ``cfg.remat`` the training forward runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint(fwd)``: its activations are recomputed in the backward,
where the BatchNorm running statistics are not updated a second time and
the dropout generator is seeded again, so the recompute draws the same
masks (LPD pretraining runs neither, as in the JAX package, which applies
its LPD model outside ``_apply``). The epochs feed batches through
``data.pipeline.prefetch``: a worker thread builds each batch and pins it
(``stage``), the training thread copies it to the card without blocking
(``to_device``).
``train_step_raw`` augments raw clouds on the card
(``data.augment.device_augment_batch``) from a generator seeded from
(``cfg.seed``, step).

Data parallelism (the JAX package's ``Trainer(cfg, mesh)``): one process
per device in a ``torch.distributed`` process group
(``parallel.multihost.initialize``; ``torchrun --nproc_per_node N`` with
``cfg.mesh_shape`` N or None), the mesh ``parallel.make_mesh()``. Every
rank is handed the same global batch: ``stage`` / ``to_device`` pad it to
a multiple of the mesh (``pad_to_multiple``: the last row repeated at
``valid`` 0) and keep the rank's equal contiguous share, with the padded
global ``valid`` as ``valid_all``. A rank's loss is its sum of
loss x valid over the global sum of ``valid``, and DCP's cycle term its
share of the mean over the global padded batch, so the losses of the ranks
add up to the JAX package's loss of the global batch; BatchNorm takes the
statistics of the global batch (``models._common.FlaxBatchNorm``); after
the backward one all-reduce sums every gradient (the zero-filled ones too)
through one flat buffer. A world-N step on a global batch is thus the
world-1 step on it, up to the order of the sums. The parameters and
buffers are broadcast from rank 0 at construction; dropout folds the rank
into its seed; ``train_step_raw`` draws the pairs of the whole padded
global batch on every rank and keeps its rows. The metric sums a step
returns are the rank's own; the epoch methods all-reduce theirs once an
epoch, so their summaries are the global batch's; ``worst_cases`` gathers
the per-sample errors in global order. In ``fit`` rank 0 alone logs and
writes the checkpoints, ``fit_state.json`` and the scalars, and every rank
waits at a barrier after each write.

VCR-Net losses (reference vcrnet_model.py:711-720):
  pose:  MSE(R_pred^T R_gt, I) + MSE(t_pred, t_gt)
  point: MSE(R_gt srcK + t_gt, src_corrK)
  mixed: pose + 0.1 * MSE(R_pred src + t_pred, tgt)
The cycle-consistency term (x0.1) is a metric only.

DCP losses (reference dcp_model.py:405-416):
  pose:  as above
  point: MSE(R_pred src + t_pred, src_corr)
with the cycle term (x0.1) INSIDE the loss that is differentiated.

LPD loss (reference lpdnet_model.py:191-229): the lazy triplet loss over
32 FPS anchors with 8 hard negatives each, plus 0.03 x the embedding-norm
regulariser, per sample; its sums are ``loss``, ``mse``, ``mae``, ``count``.

Parameters are initialised from the JAX package's distributions (the
same distributions, not the same bits): kaiming-uniform at the LPDNet's
own slope with zero bias in LPDNet (its T-Nets' convs too, their fc layers
normal(1e-3)), the identity for ``VcpAtt``'s projections, lecun-normal
(truncated) with zero bias everywhere else (the pointer, DGCNN's and
PointNet's bias-free convs, the MLP head), LayerNorm and BatchNorm scale
one and shift zero. ``fit``
saves and resumes through ``train/checkpoint.py`` and writes the reference's
TensorBoard scalars through a ``utils/logging.py::MetricsWriter``; LPD's
``fit`` steps ``MultiStepLR([75, 150, 200], 0.1)`` and keeps the best
``loss``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.augment import PAIR_KEYS, device_augment_batch
from vcrnet_tpu_torch.data.pipeline import prefetch
from vcrnet_tpu_torch.models._common import frozen_batch_stats, sync_batch_stats
from vcrnet_tpu_torch.models.dcp import DCP
from vcrnet_tpu_torch.models.embeddings import LPDNet
from vcrnet_tpu_torch.models.heads import VcpAtt
from vcrnet_tpu_torch.models.icp import icp_register
from vcrnet_tpu_torch.models.lpd import LPD, lpd_loss
from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_icp, vcrnet_iter
from vcrnet_tpu_torch.parallel.mesh import Mesh, make_mesh, pad_to_multiple, world_size
from vcrnet_tpu_torch.parallel.multihost import local_batch_slice
from vcrnet_tpu_torch.train import metrics as M
from vcrnet_tpu_torch.train.checkpoint import load_fit_state, save_checkpoint, save_fit_state
from vcrnet_tpu_torch.train.optim import (
    EARLY_STOP_LR, MultiStepLR, ReduceLROnPlateau, initial_lr, make_optimizer, set_lr,
)
from vcrnet_tpu_torch.utils.device import resolve_device
from vcrnet_tpu_torch.utils.rng import fold_seed

TNET_FC_STD = 1e-3  # a T-Net's fc layers (vcrnet_tpu/models/embeddings.py:TransformNet)
DROPOUT_SEED_OFFSET = 0xD0  # the JAX package's dropout key: PRNGKey(seed + 0xD0)
MODELS = {"vcrnet": VCRNet, "dcp": DCP, "lpd": LPD, "icp": None}


def init_like_jax(model: nn.Module, seed: int) -> None:
    """Draw every Linear of ``model`` (a VCRNet, DCP or LPD) from the JAX
    package's init distributions with a torch generator seeded by
    ``seed``; an LPDNet's kaiming gain at its own slope (0 in VCR-Net and
    DCP, 0.2 in LPD), its T-Nets' convs too, their fc layers normal(1e-3).
    ``VcpAtt``'s projections stay the identity. Biases zero; norm layers
    keep their construction values (scale 1, shift 0; running mean 0,
    variance 1)."""
    g = torch.Generator().manual_seed(seed)
    lpdnet = isinstance(model.emb_nn, LPDNet)
    gain = math.sqrt(2.0 / (1.0 + model.emb_nn.slope ** 2)) if lpdnet else None
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, VcpAtt):
                mod.reset_identity()
            if not isinstance(mod, nn.Linear) or name.startswith("vcp_att."):
                continue
            fan_in = mod.weight.shape[1]
            w = torch.empty(mod.weight.shape)
            if lpdnet and ".t_net" in name and name.rsplit(".", 1)[1].startswith("fc"):
                w.normal_(0.0, TNET_FC_STD, generator=g)
            elif lpdnet and name.startswith("emb_nn."):
                bound = gain * math.sqrt(3.0 / fan_in)
                w.uniform_(-bound, bound, generator=g)
            else:  # lecun_normal: N(0, 1/fan_in) truncated at 2 std, rescaled
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()


def _weighted_mean(per_sample, valid, valid_all=None):
    """sum(per_sample x valid) over the sum of the global batch's valid
    (``valid_all``; this batch's where None)."""
    total = valid if valid_all is None else valid_all
    return (per_sample * valid).sum() / total.sum().clamp_min(1e-12)


def _global_counts(batch: dict):
    """(the global batch's valid sum, this batch's share of its rows): the
    divisors of a rank's share of the global means."""
    valid, valid_all = batch["valid"], batch.get("valid_all")
    if valid_all is None:
        return valid.sum(), 1.0
    return valid_all.sum(), valid.shape[0] / valid_all.shape[0]


def _pose_loss_per_sample(R_pred, t_pred, R_gt, t_gt):
    eye = torch.eye(3, dtype=R_pred.dtype, device=R_pred.device)
    r = torch.einsum("bji,bjk->bik", R_pred, R_gt) - eye
    return (r ** 2).mean(dim=(1, 2)) + ((t_pred - t_gt) ** 2).mean(dim=1)


def _cycle_loss(R_ab, t_ab, R_ba, t_ba):
    eye = torch.eye(3, dtype=R_ab.dtype, device=R_ab.device)
    rot = ((torch.einsum("bij,bjk->bik", R_ba, R_ab) - eye) ** 2).mean()
    return rot + ((torch.einsum("bji,bj->bi", R_ba, t_ab) + t_ba) ** 2).mean()


def _board_scalars(writer, split: str, loss: float, summary: dict, epoch: int):
    """The reference's full TensorBoard scalar matrix (dcp_model.py:727-793):
    for each direction and split, the loss and the point / rotation /
    translation MSE, RMSE and MAE found in ``summary``."""
    for d, suf in (("A->B", "ab"), ("B->A", "ba")):
        writer.scalar(f"{d}/{split}/loss", loss, epoch)
        for tag, key in (
            ("MSE", f"point_{suf}_MSE"),
            ("RMSE", f"point_{suf}_RMSE"),
            ("MAE", f"point_{suf}_MAE"),
            ("rotation/MSE", f"rot_{suf}_MSE"),
            ("rotation/RMSE", f"rot_{suf}_RMSE"),
            ("rotation/MAE", f"rot_{suf}_MAE"),
            ("translation/MSE", f"trans_{suf}_MSE"),
            ("translation/RMSE", f"trans_{suf}_RMSE"),
            ("translation/MAE", f"trans_{suf}_MAE"),
        ):
            if key in summary:
                writer.scalar(f"{d}/{split}/{tag}", summary[key], epoch)


class Trainer:
    """>>> trainer = Trainer(cfg)                   # on the CUDA device
    >>> sums = trainer.train_step(batch)            # numpy batch from a Loader
    >>> history = trainer.fit(train_loader, test_loader, epochs=2, checkpoint_dir="ckpt")

    ``cfg.model`` picks :class:`VCRNet`, :class:`DCP` or :class:`LPD`;
    ``"icp"`` has no model and no optimizer (eval only). ``device``
    defaults to ``"cuda"`` and raises where there is none; ``use_kernels``
    is passed to the model; ``seed`` (default ``cfg.seed``) draws the
    initial parameters. ``mesh`` (default ``make_mesh()``: the process
    group where one is up, else this process alone) is the data mesh; a
    ``cfg.mesh_shape`` other than the world size raises."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None,
                 seed: int | None = None, mesh: Mesh | None = None):
        if cfg.model not in MODELS:
            raise ValueError(f"unknown model: {cfg.model}")
        world = world_size()
        if cfg.mesh_shape is not None and cfg.mesh_shape != world:
            raise ValueError(
                f"mesh_shape={cfg.mesh_shape} but the world size is {world}: the port runs "
                f"one process per device (torchrun --nproc_per_node {cfg.mesh_shape})"
            )
        self.mesh = make_mesh() if mesh is None else mesh
        if self.mesh.group is None and self.mesh.size > 1:
            raise ValueError(
                f"a mesh of {self.mesh.size} devices in one process serves (Registrar) but "
                "does not train: the Trainer runs one process per device in a process group"
            )
        self.cfg = cfg
        self.model = self.optimizer = None
        self.device = resolve_device(device)
        if cfg.model != "icp":
            self.model = MODELS[cfg.model](cfg, device=self.device, use_kernels=use_kernels)
            init_like_jax(self.model, cfg.seed if seed is None else seed)
            if self.mesh.group is not None:
                sync_batch_stats(self.model, self.mesh)
                with torch.no_grad():
                    for t in (*self.model.parameters(), *self.model.buffers()):
                        self.mesh.broadcast_(t)
            self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.step = 0
        self.grads_filled: list = []  # compute_grads: parameters no gradient reached
        self._augment_gen = None  # train_step_raw's generator, made at first use

    # ------------------------------------------------------------------
    # loss and metric sums
    # ------------------------------------------------------------------

    def loss_and_sums(self, out, batch: dict):
        """(loss, sums): the batch loss (differentiable) and the metric
        sums of the batch (detached), weighted by ``batch['valid']``, from
        the model's output tuple (LPD: the two embeddings)."""
        if self.cfg.model in ("dcp", "icp"):
            return self._dcp_loss_and_sums(out, batch)
        if self.cfg.model == "lpd":
            return self._lpd_loss_and_sums(out, batch)
        return self._vcrnet_loss_and_sums(out, batch)

    def _lpd_loss_and_sums(self, out, batch: dict):
        src_emb, tgt_emb = out
        valid = batch["valid"]
        loss_ps = lpd_loss(batch["src"], src_emb, tgt_emb, per_sample=True)
        loss = _weighted_mean(loss_ps, valid, batch.get("valid_all"))
        with torch.no_grad():
            diff = src_emb.float() - tgt_emb.float()
            sums = {
                "loss": (loss_ps * valid).sum(),
                "mse": ((diff ** 2).mean(dim=(1, 2)) * valid).sum(),
                "mae": (diff.abs().mean(dim=(1, 2)) * valid).sum(),
                "count": valid.sum(),
            }
        return loss, {k: v.detach() for k, v in sums.items()}

    def _pose_sums(self, out_rt, batch: dict) -> dict:
        """The rotation / translation error sums of both directions."""
        R_ab, t_ab, R_ba, t_ba = out_rt
        valid = batch["valid"]
        rt_ab = M.rotation_translation_sums(R_ab, t_ab, batch["euler_ab"], batch["t_ab"],
                                            valid, "zyx")
        rt_ba = M.rotation_translation_sums(R_ba, t_ba, batch["euler_ba"], batch["t_ba"],
                                            valid, "xyz")
        sums = {f"{k}_ab": v for k, v in rt_ab.items() if k != "count3"}
        sums.update({f"{k}_ba": v for k, v in rt_ba.items() if k != "count3"})
        sums["count3"] = rt_ab["count3"]
        return sums

    def _dcp_loss_and_sums(self, out, batch: dict):
        cfg = self.cfg
        valid = batch["valid"]
        R_ab, t_ab, R_ba, t_ba, src_out, src_corr = out
        moved = geometry.transform_points(src_out, R_ab, t_ab)
        if cfg.loss == "pose":
            loss_ps = _pose_loss_per_sample(R_ab, t_ab, batch["R_ab"], batch["t_ab"])
        else:  # point
            loss_ps = ((moved - src_corr) ** 2).mean(dim=(1, 2))
        loss = _weighted_mean(loss_ps, valid, batch.get("valid_all"))
        sums = {"loss": (loss_ps * valid).sum()}
        if cfg.cycle:
            n_valid, share = _global_counts(batch)
            cyc = _cycle_loss(R_ab, t_ab, R_ba, t_ba) * share
            loss = loss + 0.1 * cyc  # inside the DCP gradient
            sums["cycle_loss"] = 0.1 * cyc * n_valid
        with torch.no_grad():
            back = geometry.transform_points(batch["tgt"], R_ba, t_ba)
            ps_ab = M.point_sums(moved, batch["tgt"], valid)
            ps_ba = M.point_sums(back, batch["src"], valid)
            sums.update(p_se_ab=ps_ab["p_se"], p_ae_ab=ps_ab["p_ae"],
                        p_se_ba=ps_ba["p_se"], p_ae_ba=ps_ba["p_ae"], count=ps_ab["count"])
            sums.update(self._pose_sums((R_ab, t_ab, R_ba, t_ba), batch))
        return loss, {k: v.detach() for k, v in sums.items()}

    def _vcrnet_loss_and_sums(self, out, batch: dict):
        cfg = self.cfg
        valid = batch["valid"]
        src_k, src_corr_k, R_ab, t_ab, R_ba, t_ba = out
        pose_ps = _pose_loss_per_sample(R_ab, t_ab, batch["R_ab"], batch["t_ab"])
        moved_k = geometry.transform_points(src_k, batch["R_ab"], batch["t_ab"])
        point_ps = ((moved_k - src_corr_k) ** 2).mean(dim=(1, 2))
        if cfg.loss == "pose":
            loss_ps = pose_ps
        elif cfg.loss == "point":
            loss_ps = point_ps
        elif cfg.loss == "mixed":
            moved = geometry.transform_points(batch["src"], R_ab, t_ab)
            loss_ps = pose_ps + 0.1 * ((moved - batch["tgt"]) ** 2).mean(dim=(1, 2))
        else:
            raise ValueError(f"unknown loss {cfg.loss!r}")
        loss = _weighted_mean(loss_ps, valid, batch.get("valid_all"))

        with torch.no_grad():
            sums = {"loss": (loss_ps * valid).sum(), "loss_pose": (pose_ps * valid).sum()}
            if cfg.cycle:
                n_valid, share = _global_counts(batch)
                cyc = 0.1 * _cycle_loss(R_ab, t_ab, R_ba, t_ba) * share * n_valid
                sums["cycle_loss"] = cyc
                sums["loss_pose"] = sums["loss_pose"] + cyc
            back = geometry.transform_points(batch["tgt"], R_ba, t_ba)
            ps_ab = M.point_sums(moved_k, src_corr_k, valid)
            ps_ba = M.point_sums(back, batch["src"], valid)
            sums.update(p_se_ab=ps_ab["p_se"], p_ae_ab=ps_ab["p_ae"],
                        p_se_ba=ps_ba["p_se"], p_ae_ba=ps_ba["p_ae"], count=ps_ab["count"])
            sums.update(self._pose_sums((R_ab, t_ab, R_ba, t_ba), batch))
        return loss, {k: v.detach() for k, v in sums.items()}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    @staticmethod
    def _host(batch: dict) -> dict:
        """f32 tensors of a batch of numpy arrays (or tensors), with
        ``valid`` (default all ones) and without ``label``."""
        out = {k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v), dtype=torch.float32)
               for k, v in batch.items() if k != "label"}
        if "valid" not in out:
            out["valid"] = torch.ones(next(iter(out.values())).shape[0])
        return out

    def shard(self, batch: dict) -> dict:
        """This rank's rows of a global batch of tensors with ``valid``:
        padded to a multiple of the mesh (``pad_to_multiple``), the rank's
        equal contiguous share, and the padded global ``valid`` as
        ``valid_all``. The batch itself without a process group, and a
        batch of raw clouds (``clouds``), whose pairs ``train_step_raw``
        draws for the whole batch."""
        if self.mesh.group is None or "clouds" in batch:
            return batch
        padded = pad_to_multiple(dict(batch), self.mesh.size)
        local = local_batch_slice(padded, self.mesh.rank, self.mesh.size)
        local["valid_all"] = padded["valid"]
        return local

    def stage(self, batch: dict) -> dict:
        """A batch of numpy arrays (or tensors) as f32 host tensors with
        ``valid`` (default all ones), this rank's share of it
        (:meth:`shard`), pinned where the trainer's device is the card: the
        worker thread's share of the epoch feed. ``label`` is dropped."""
        out = self.shard(self._host(batch))
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def to_device(self, batch: dict) -> dict:
        """numpy or tensor batch -> f32 tensors on the trainer's device,
        with ``valid`` (default all ones); a global batch that ``stage``
        has not sharded is sharded first. Copies from pinned tensors
        (``stage``) do not block the host: they queue on the current
        stream behind the kernels already issued."""
        if self.mesh.group is not None and "valid_all" not in batch:
            batch = self.shard(self._host(batch))

        def put(x):
            return torch.as_tensor(x, dtype=torch.float32).to(self.device, non_blocking=True)

        out = {k: put(batch[k]) for k in PAIR_KEYS}
        valid = batch.get("valid")
        out["valid"] = (torch.ones(out["src"].shape[0], device=self.device) if valid is None
                        else put(valid))
        if "valid_all" in batch:
            out["valid_all"] = put(batch["valid_all"])
        return out

    def _forward(self, src, tgt):
        """The model's output tuple (LPD: the two embeddings alone)."""
        if self.cfg.model == "lpd":
            return self.model.embed_pair(src, tgt)
        return self.model(src, tgt)

    def _train_forward(self, src, tgt):
        """The model's training forward, under ``torch.utils.checkpoint``
        with ``cfg.remat`` (not for LPD); its recompute updates no running
        statistics."""
        if not self.cfg.remat or self.cfg.model == "lpd":
            return self._forward(src, tgt)
        calls = []

        def forward(s, t):
            calls.append(None)
            if len(calls) == 1:
                return self.model(s, t)
            with frozen_batch_stats(self.model):
                return self.model(s, t)

        return checkpoint(forward, src, tgt, use_reentrant=False)

    def _check_trainable(self) -> None:
        if self.model is None:
            raise ValueError(f"{self.cfg.model} can't be trained")

    def compute_grads(self, batch: dict):
        """Forward in training mode, loss, backward: leaves the gradients
        in the parameters' ``.grad`` and returns (loss, sums). A loss with
        no gradient path (VCR-Net in partial mode) runs no backward; every
        parameter whose gradient is then None gets zeros (their names in
        ``grads_filled``), JAX's dense gradient tree. Under a process group
        the loss and the sums are this rank's share and the gradients are
        summed over the ranks: those of the global batch's loss."""
        self._check_trainable()
        b = self.to_device(batch)
        self.model.train()
        if getattr(self.model, "dropout_rng", None) is not None:
            seed = fold_seed(self.cfg.seed + DROPOUT_SEED_OFFSET, self.step)
            if self.mesh.group is not None:  # no two ranks draw one mask
                seed = fold_seed(seed, self.mesh.rank)
            self.model.dropout_rng.seed = seed
        self.optimizer.zero_grad(set_to_none=True)
        loss, sums = self.loss_and_sums(self._train_forward(b["src"], b["tgt"]), b)
        if loss.requires_grad:
            loss.backward()
        self.grads_filled = [name for name, p in self.model.named_parameters() if p.grad is None]
        self.mesh.all_reduce_grads(self.model.parameters())  # zero-fills, one flat all-reduce
        return loss.detach(), sums

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on ``batch``; returns the batch's metric sums
        (device scalars; this rank's own under a process group)."""
        _, sums = self.compute_grads(batch)
        self.optimizer.step()
        self.step += 1
        return sums

    def train_step_raw(self, batch: dict) -> dict:
        """One optimizer step on raw clouds (``batch['clouds']`` [B, M, 3],
        optional ``valid``): the registration pairs are drawn on the
        trainer's device by ``device_augment_batch`` from a generator seeded
        from (``cfg.seed``, step), those of the whole global batch (padded
        to a multiple of the mesh) on every rank, which keeps its rows.
        Returns the batch's metric sums."""
        raw = {"clouds": torch.as_tensor(batch["clouds"], dtype=torch.float32).to(
            self.device, non_blocking=True)}
        valid = batch.get("valid")
        raw["valid"] = (torch.ones(raw["clouds"].shape[0], device=self.device) if valid is None
                        else torch.as_tensor(valid, dtype=torch.float32).to(
                            self.device, non_blocking=True))
        if self.mesh.group is not None:
            raw = pad_to_multiple(raw, self.mesh.size)
        if self._augment_gen is None:
            self._augment_gen = torch.Generator(device=self.device)
        self._augment_gen.manual_seed(fold_seed(self.cfg.seed, self.step))
        pairs = device_augment_batch(self._augment_gen, raw["clouds"], self.cfg)
        pairs["valid"] = raw["valid"]
        return self.train_step(self.shard(pairs))

    def _icp(self, b: dict):
        """ICP's output in DCP's layout: (R_ab, t_ab, R_ba, t_ba, src, src)."""
        R_ab, t_ab, R_ba, t_ba = icp_register(b["src"], b["tgt"],
                                              max_iterations=self.cfg.max_iterations)[2:]
        return R_ab, t_ab, R_ba, t_ba, b["src"], b["src"]

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Metric sums of ``batch`` in eval mode (running statistics
        frozen): VCR-Net through ``vcrnet_iter`` at ``cfg.iter`` (net +
        ICP at 0), DCP and LPD in one pass, ICP by ``icp_register``; this
        rank's own under a process group."""
        b = self.to_device(batch)
        if self.cfg.model == "icp":
            return self.loss_and_sums(self._icp(b), b)[1]
        self.model.eval()
        if self.cfg.model != "vcrnet":
            return self.loss_and_sums(self._forward(b["src"], b["tgt"]), b)[1]
        if self.cfg.iter > 0:
            out = vcrnet_iter(self.model, b["src"], b["tgt"], self.cfg.iter)
        else:
            out = vcrnet_icp(self.model, b["src"], b["tgt"], self.cfg.max_iterations)
        return self.loss_and_sums(out, b)[1]

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def _summarize(self, acc: M.EpochAccumulator) -> dict:
        """The epoch's summary, of the sums of every rank (one all-reduce)."""
        if self.mesh.group is not None:
            acc.reduce(self.mesh.all_reduce_)
        return M.summarize(acc)

    def train_epoch(self, loader) -> dict:
        """One epoch of ``train_step`` over a batch iterable, fed through
        ``prefetch``; returns the epoch's summary."""
        acc = M.EpochAccumulator()
        for batch in prefetch(loader, self.stage):
            acc.add(self.train_step(batch))
        return self._summarize(acc)

    def train_epoch_raw(self, cloud_batches) -> dict:
        """One epoch of ``train_step_raw`` over an iterable of raw-cloud
        batches [B, M, 3], fed through ``prefetch``."""
        acc = M.EpochAccumulator()
        for batch in prefetch(cloud_batches, lambda c: self.stage({"clouds": c})):
            acc.add(self.train_step_raw(batch))
        return self._summarize(acc)

    def eval_epoch(self, loader) -> dict:
        acc = M.EpochAccumulator()
        for batch in prefetch(loader, self.stage):
            acc.add(self.eval_step(batch))
        return self._summarize(acc)

    @torch.no_grad()
    def _per_sample_errors(self, batch: dict):
        """Per-sample squared errors of the A->B prediction in eval mode:
        rotation (euler z-y-x, degrees) and translation, and ``valid``; the
        reference's worst-case mining (testVCRNet:808-813). VCR-Net at
        ``cfg.iter == 0`` mines the net's one pass, as the JAX package does."""
        b = self.to_device(batch)
        if self.cfg.model == "lpd":
            raise ValueError("lpd predicts no transform to mine")
        if self.cfg.model == "icp":
            R_ab, t_ab = self._icp(b)[:2]
        elif self.cfg.model == "vcrnet":
            self.model.eval()
            R_ab, t_ab = vcrnet_iter(self.model, b["src"], b["tgt"], max(self.cfg.iter, 1))[2:4]
        else:
            self.model.eval()
            R_ab, t_ab = self.model(b["src"], b["tgt"])[:2]
        e_pred = geometry.mat_to_euler_zyx(R_ab, degrees=True)
        rot_se = ((e_pred - torch.rad2deg(b["euler_ab"])) ** 2).sum(-1)
        trans_se = ((b["t_ab"] - t_ab) ** 2).sum(-1)
        return rot_se, trans_se, b["valid"]

    def worst_cases(self, loader, k: int = 5) -> dict:
        """Indices (dataset order) of the k worst rotation and translation
        errors over the loader (padding rows never count), with the
        per-sample squared errors, gathered from every rank."""
        rot, trans = [], []
        for batch in loader:
            r, t, valid = (self.mesh.gather_rows(x).cpu().numpy()
                           for x in self._per_sample_errors(batch))
            rot.append(np.where(valid > 0, r, -np.inf))
            trans.append(np.where(valid > 0, t, -np.inf))
        rot, trans = np.concatenate(rot), np.concatenate(trans)
        return {
            "worst_rot_idx": np.argsort(rot)[-k:][::-1].tolist(),
            "worst_trans_idx": np.argsort(trans)[-k:][::-1].tolist(),
            "rot_se": rot,
            "trans_se": trans,
        }

    def fit(self, train_loader, test_loader, epochs: Optional[int] = None,
            log: Callable[[str], None] = print, checkpoint_dir: Optional[str] = None,
            metrics_writer=None) -> list:
        """Epochs of training and eval (vcrnet_tpu/train/engine.py:fit): the
        plateau scheduler stepped on the best test loss (VCR-Net:
        ``loss_pose``, patience 10; DCP: ``loss``, patience 5), LPD's
        ``MultiStepLR`` once an epoch (best loss ``loss``), the early
        stop at lr <= 1.1e-6. With ``checkpoint_dir``: resume from its
        ``fit_state.json`` (the epoch after the saved one, the scheduler
        and its learning rate, the best loss; the caller restores the model
        and optimizer with ``checkpoint.load_checkpoint``), save
        ``model.best`` whenever the test loss is at or below the best, and
        ``model.{epoch}`` and ``fit_state.json`` every epoch. With
        ``metrics_writer``: the reference's scalar matrix for train, test
        and best_test, the pose losses and the learning rate. Under a
        process group rank 0 alone logs and writes (every rank resumes from
        the files). Returns the per-epoch history of this call."""
        self._check_trainable()
        epochs = self.cfg.epochs if epochs is None else epochs
        lpd = self.cfg.model == "lpd"
        if lpd:
            sched = MultiStepLR(initial_lr(self.cfg))
        else:
            sched = ReduceLROnPlateau(initial_lr(self.cfg),
                                      patience=5 if self.cfg.model == "dcp" else 10)
        best_loss = float("inf")
        best_sum: dict = {}
        start_epoch = 0
        if checkpoint_dir is not None:
            fit_state = load_fit_state(checkpoint_dir)
            if fit_state is not None:
                best_loss = fit_state["best_loss"]
                start_epoch = fit_state["epoch"] + 1
                sched.__dict__.update(fit_state["sched"])
                set_lr(self.optimizer, sched.lr)
                if self.mesh.is_writer:
                    log(f"resumed fit state at epoch {start_epoch}")
        history = []
        for epoch in range(start_epoch, epochs):
            train_sum = self.train_epoch(train_loader)
            test_sum = self.eval_epoch(test_loader)
            key = "loss_pose" if self.cfg.model == "vcrnet" else "loss"
            test_loss = test_sum.get(key, test_sum.get("loss", 0.0))
            if test_loss <= best_loss:
                best_loss = test_loss
                best_sum = test_sum
                if checkpoint_dir is not None:
                    save_checkpoint(checkpoint_dir, "model.best", self)
            lr = sched.step(None if lpd else best_loss)  # the reference steps on the BEST loss
            set_lr(self.optimizer, lr)
            history.append({"epoch": epoch, "lr": lr, "train": train_sum, "test": test_sum})
            if metrics_writer is not None and self.mesh.is_writer:
                _board_scalars(metrics_writer, "train", train_sum.get("loss", 0.0), train_sum,
                               epoch)
                _board_scalars(metrics_writer, "test", test_sum.get("loss", 0.0), test_sum,
                               epoch)
                _board_scalars(metrics_writer, "best_test", best_loss, best_sum, epoch)
                metrics_writer.scalar("A->B/train/lossPose", train_sum.get("loss_pose", 0.0),
                                      epoch)
                metrics_writer.scalar("A->B/test/lossPose", test_sum.get("loss_pose", 0.0),
                                      epoch)
                metrics_writer.scalar("A->B/best_test/lr", lr, epoch)
            if self.mesh.is_writer:
                log(f"epoch {epoch}: lr={lr:.2e} "
                    f"train_loss={train_sum.get('loss', float('nan')):.6f} "
                    f"test_loss={test_loss:.6f} best={best_loss:.6f}")
            if checkpoint_dir is not None:
                save_checkpoint(checkpoint_dir, f"model.{epoch}", self)
                save_fit_state(checkpoint_dir, {"epoch": epoch, "best_loss": best_loss, "lr": lr,
                                                "sched": dict(sched.__dict__)})
            if lr <= EARLY_STOP_LR:
                break
        return history
