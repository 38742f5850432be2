"""Registration metrics as per-batch sums (counterpart of
vcrnet_tpu/train/metrics.py).

Each batch contributes weighted SUMS (squared and absolute errors,
counts), kept on the device; the epoch summary divides once at the end:
mean = sum / count, RMSE = sqrt(MSE of the whole epoch).

  rot_MSE   mean over samples x 3 angles of (euler_pred_deg - euler_gt_deg)^2,
            euler order 'zyx' for A->B, 'xyz' for B->A
  trans_MSE mean over samples x 3 of (t_gt - t_pred)^2
  point     per-sample mean point errors, summed over samples
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch import geometry


def rotation_translation_sums(R_pred, t_pred, euler_gt_rad, t_gt, valid, euler_order: str):
    """R_pred [B,3,3], t_pred [B,3], euler_gt_rad [B,3], t_gt [B,3],
    valid [B] -> dict of scalar sums."""
    if euler_order == "zyx":
        e_pred = geometry.mat_to_euler_zyx(R_pred, degrees=True)
    else:
        e_pred = geometry.mat_to_euler_xyz(R_pred, degrees=True)
    w = valid[:, None]
    r_err = e_pred - torch.rad2deg(euler_gt_rad)
    t_err = t_gt - t_pred
    return {
        "r_se": (w * r_err ** 2).sum(),
        "r_ae": (w * r_err.abs()).sum(),
        "t_se": (w * t_err ** 2).sum(),
        "t_ae": (w * t_err.abs()).sum(),
        "count3": valid.sum() * 3.0,
    }


def point_sums(a, b, valid):
    """Weighted sums of per-sample mean point errors."""
    return {
        "p_se": (valid * ((a - b) ** 2).mean(dim=(1, 2))).sum(),
        "p_ae": (valid * (a - b).abs().mean(dim=(1, 2))).sum(),
        "count": valid.sum(),
    }


class EpochAccumulator:
    """Adds per-batch sum dicts on the device; the one host copy happens
    when the sums are first read."""

    def __init__(self):
        self._dev = {}
        self._host = None

    def add(self, sums: dict):
        for key, val in sums.items():
            val = val.detach().float()
            prev = self._dev.get(key)
            self._dev[key] = val if prev is None else prev + val
        self._host = None

    @property
    def sums(self) -> dict:
        if self._host is None:
            keys = list(self._dev)
            vals = torch.stack([self._dev[k] for k in keys]).cpu().tolist() if keys else []
            self._host = dict(zip(keys, vals))
        return self._host

    def __getitem__(self, key):
        return self.sums[key]

    def get(self, key, default=0.0):
        return self.sums.get(key, default)

    def reduce(self, fn) -> None:
        """Replace the sums by ``fn`` of their stacked vector, in the order
        they were first added (the same on every rank): an all-reduce over
        the ranks of a process group."""
        keys = list(self._dev)
        if keys:
            self._dev = dict(zip(keys, fn(torch.stack([self._dev[k] for k in keys])).unbind()))
        self._host = None


def summarize(acc: EpochAccumulator) -> dict:
    """Epoch summary in the reference's reporting vocabulary."""
    n = max(acc.get("count", 0.0), 1e-12)
    n3 = max(acc.get("count3_ab", acc.get("count3", 0.0)), 1e-12)
    out = {"num_examples": acc.get("count", 0.0)}

    def put(prefix, se_key, ae_key, denom):
        if se_key in acc.sums:
            mse = acc[se_key] / denom
            out[f"{prefix}_MSE"] = mse
            out[f"{prefix}_RMSE"] = mse ** 0.5
            out[f"{prefix}_MAE"] = acc[ae_key] / denom

    put("rot_ab", "r_se_ab", "r_ae_ab", n3)
    put("trans_ab", "t_se_ab", "t_ae_ab", n3)
    put("rot_ba", "r_se_ba", "r_ae_ba", n3)
    put("trans_ba", "t_se_ba", "t_ae_ba", n3)
    put("point_ab", "p_se_ab", "p_ae_ab", n)
    put("point_ba", "p_se_ba", "p_ae_ba", n)
    for key in ("loss", "loss_pose", "cycle_loss", "mse", "mae"):
        if key in acc.sums:
            out[key] = acc[key] / n
    return out
