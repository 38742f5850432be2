"""Training engine for VCR-Net (counterpart of vcrnet_tpu/train/engine.py,
``model="vcrnet"``).

One step is the JAX package's ``Trainer._train_step_impl``: forward (the
model in training mode, both clouds embedded in one stacked call), loss,
gradients (on the kernel route the backward kernels of ``ops``), and the
optimizer update; the metric sums of the batch stay on the device and are
added up per epoch. Eval runs ``vcrnet_iter`` at ``cfg.iter``, whole or
partial-overlap; training in partial-overlap mode is not ported (its hard
selections need the JAX package's zero-gradient handling), so the
training step refuses ``cfg.partial``.

Losses (reference vcrnet_model.py:711-720):
  pose:  MSE(R_pred^T R_gt, I) + MSE(t_pred, t_gt)
  point: MSE(R_gt srcK + t_gt, src_corrK)
  mixed: pose + 0.1 * MSE(R_pred src + t_pred, tgt)
The cycle-consistency term (x0.1) is a metric only.

Parameters are initialised from the JAX package's distributions (the
same distributions, not the same bits): kaiming-uniform at the LPDNet
slope with zero bias in the embedding, lecun-normal (truncated) with zero
bias in the pointer, LayerNorm scale one and shift zero. Checkpoint
save/resume, the raw-cloud on-device augmentation and the DCP/LPD/ICP
families are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import PAIR_KEYS
from vcrnet_tpu_torch.models.vcrnet import VCRNet, vcrnet_iter
from vcrnet_tpu_torch.train import metrics as M
from vcrnet_tpu_torch.train.optim import (
    EARLY_STOP_LR, ReduceLROnPlateau, initial_lr, make_optimizer, set_lr,
)

LPDNET_SLOPE = 0.0  # the embedding's leaky slope inside VCR-Net


def init_like_jax(model: VCRNet, seed: int) -> None:
    """Draw every parameter of ``model`` from the JAX package's init
    distributions with a torch generator seeded by ``seed``."""
    g = torch.Generator().manual_seed(seed)
    gain = math.sqrt(2.0 / (1.0 + LPDNET_SLOPE ** 2))
    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, nn.Linear):
                continue
            fan_in = mod.weight.shape[1]
            if name.startswith("emb_nn."):
                bound = gain * math.sqrt(3.0 / fan_in)
                w = torch.empty(mod.weight.shape).uniform_(-bound, bound, generator=g)
            else:  # lecun_normal: N(0, 1/fan_in) truncated at 2 std, rescaled
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            mod.weight.copy_(w)
            mod.bias.zero_()


def _weighted_mean(per_sample, valid):
    return (per_sample * valid).sum() / valid.sum().clamp_min(1e-12)


def _pose_loss_per_sample(R_pred, t_pred, R_gt, t_gt):
    eye = torch.eye(3, dtype=R_pred.dtype, device=R_pred.device)
    r = torch.einsum("bji,bjk->bik", R_pred, R_gt) - eye
    return (r ** 2).mean(dim=(1, 2)) + ((t_pred - t_gt) ** 2).mean(dim=1)


def _cycle_loss(R_ab, t_ab, R_ba, t_ba):
    eye = torch.eye(3, dtype=R_ab.dtype, device=R_ab.device)
    rot = ((torch.einsum("bij,bjk->bik", R_ba, R_ab) - eye) ** 2).mean()
    return rot + ((torch.einsum("bji,bj->bi", R_ba, t_ab) + t_ba) ** 2).mean()


class Trainer:
    """>>> trainer = Trainer(cfg)                   # on the CUDA device
    >>> sums = trainer.train_step(batch)            # numpy batch from a Loader
    >>> history = trainer.fit(train_loader, test_loader, epochs=2)

    ``device`` defaults to ``"cuda"`` and raises where there is none;
    ``use_kernels`` is passed to :class:`VCRNet`; ``seed`` (default
    ``cfg.seed``) draws the initial parameters."""

    def __init__(self, cfg: Config, device=None, use_kernels: bool | None = None,
                 seed: int | None = None):
        if cfg.model != "vcrnet":
            raise NotImplementedError(f"model={cfg.model!r} is not ported yet")
        self.cfg = cfg
        self.model = VCRNet(cfg, device=device, use_kernels=use_kernels)
        self.device = self.model.device
        init_like_jax(self.model, cfg.seed if seed is None else seed)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.step = 0

    # ------------------------------------------------------------------
    # loss and metric sums
    # ------------------------------------------------------------------

    def loss_and_sums(self, out, batch: dict):
        """(loss, sums): the batch loss (differentiable) and the metric
        sums of the batch (detached), weighted by ``batch['valid']``."""
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
        loss = _weighted_mean(loss_ps, valid)

        with torch.no_grad():
            sums = {"loss": (loss_ps * valid).sum(), "loss_pose": (pose_ps * valid).sum()}
            if cfg.cycle:
                cyc = 0.1 * _cycle_loss(R_ab, t_ab, R_ba, t_ba) * valid.sum()
                sums["cycle_loss"] = cyc
                sums["loss_pose"] = sums["loss_pose"] + cyc
            back = geometry.transform_points(batch["tgt"], R_ba, t_ba)
            ps_ab = M.point_sums(moved_k, src_corr_k, valid)
            ps_ba = M.point_sums(back, batch["src"], valid)
            sums.update(p_se_ab=ps_ab["p_se"], p_ae_ab=ps_ab["p_ae"],
                        p_se_ba=ps_ba["p_se"], p_ae_ba=ps_ba["p_ae"], count=ps_ab["count"])
            rt_ab = M.rotation_translation_sums(R_ab, t_ab, batch["euler_ab"], batch["t_ab"],
                                                valid, "zyx")
            rt_ba = M.rotation_translation_sums(R_ba, t_ba, batch["euler_ba"], batch["t_ba"],
                                                valid, "xyz")
            sums.update({f"{k}_ab": v for k, v in rt_ab.items() if k != "count3"})
            sums.update({f"{k}_ba": v for k, v in rt_ba.items() if k != "count3"})
            sums["count3"] = rt_ab["count3"]
        return loss, {k: v.detach() for k, v in sums.items()}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def to_device(self, batch: dict) -> dict:
        """numpy or tensor batch -> f32 tensors on the trainer's device,
        with ``valid`` (default all ones)."""
        out = {k: torch.as_tensor(batch[k], dtype=torch.float32).to(self.device)
               for k in PAIR_KEYS}
        valid = batch.get("valid")
        out["valid"] = (torch.ones(out["src"].shape[0], device=self.device) if valid is None
                        else torch.as_tensor(valid, dtype=torch.float32).to(self.device))
        return out

    def compute_grads(self, batch: dict):
        """Forward in training mode, loss, backward: leaves the gradients
        in the parameters' ``.grad`` and returns (loss, sums)."""
        if self.cfg.partial:
            raise NotImplementedError("training in partial-overlap mode is not ported yet")
        b = self.to_device(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, sums = self.loss_and_sums(self.model(b["src"], b["tgt"]), b)
        loss.backward()
        return loss.detach(), sums

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on ``batch``; returns the batch's metric sums
        (device scalars)."""
        _, sums = self.compute_grads(batch)
        self.optimizer.step()
        self.step += 1
        return sums

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Metric sums of ``batch`` through ``vcrnet_iter`` at ``cfg.iter``."""
        if self.cfg.iter < 1:
            raise NotImplementedError("cfg.iter == 0 (net + ICP) is not ported yet")
        b = self.to_device(batch)
        self.model.eval()
        out = vcrnet_iter(self.model, b["src"], b["tgt"], self.cfg.iter)
        return self.loss_and_sums(out, b)[1]

    # ------------------------------------------------------------------
    # epochs
    # ------------------------------------------------------------------

    def train_epoch(self, loader) -> dict:
        acc = M.EpochAccumulator()
        for batch in loader:
            acc.add(self.train_step(batch))
        return M.summarize(acc)

    def eval_epoch(self, loader) -> dict:
        acc = M.EpochAccumulator()
        for batch in loader:
            acc.add(self.eval_step(batch))
        return M.summarize(acc)

    def fit(self, train_loader, test_loader, epochs: Optional[int] = None,
            log: Callable[[str], None] = print) -> list:
        """Epochs of training and eval with the plateau scheduler stepped on
        the best test ``loss_pose`` and the early stop at lr <= 1.1e-6.
        Returns the per-epoch history."""
        epochs = self.cfg.epochs if epochs is None else epochs
        sched = ReduceLROnPlateau(initial_lr(self.cfg), patience=10)
        best_loss = float("inf")
        history = []
        for epoch in range(epochs):
            train_sum = self.train_epoch(train_loader)
            test_sum = self.eval_epoch(test_loader)
            test_loss = test_sum.get("loss_pose", test_sum.get("loss", 0.0))
            best_loss = min(best_loss, test_loss)
            lr = sched.step(best_loss)
            set_lr(self.optimizer, lr)
            history.append({"epoch": epoch, "lr": lr, "train": train_sum, "test": test_sum})
            log(f"epoch {epoch}: lr={lr:.2e} train_loss={train_sum.get('loss', float('nan')):.6f} "
                f"test_loss={test_loss:.6f} best={best_loss:.6f}")
            if lr <= EARLY_STOP_LR:
                break
        return history
