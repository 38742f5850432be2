"""Checkpoints: the full training state, resume, and the reference-layout
converters (counterpart of vcrnet_tpu/train/checkpoint.py).

A checkpoint is ``f"{name}.pt"``, written by ``torch.save`` of plain CPU
tensors: the model's ``state_dict`` (parameters and BatchNorm buffers),
the optimizer's ``state_dict`` (Adam's moments and step counts) and the
trainer's step. ``load_checkpoint`` restores it strictly when the saved
structures match the template's; otherwise it merges the parameters that
match by name and shape (the reference loads with strict=False,
util/initPara.py:254), BatchNorm buffers with ``min_leaves=0``, and keeps
the template's optimizer state and step, as the JAX package's fallback
does. It also reads the JAX package's flax msgpack files (a full
TrainState, or a bare param tree from ``save_params``) through the port's
own reader, the same way.

``fit_state.json`` carries the epoch, the best loss, the learning rate and
the plateau scheduler with the JAX package's keys, so either package
resumes the other's file.

Under a ``torch.distributed`` process group every rank calls
``save_checkpoint`` and ``save_fit_state``: rank 0 writes, and every rank
waits at a barrier until it has, so a rank that reads the file next finds
it whole. Every rank loads.

The converters map the reference PyTorch implementation's state dicts
(``emb_nn.conv1_lpd.weight`` as a k = 1 conv weight [out, in, 1(, 1)],
``pointer.model.encoder.layers.0.self_attn.linears.0.weight``, ...) to the
port's ``state_dict`` keys and back. The port's layers are ``nn.Linear``
([out, in]), so a conv weight is reshaped, not transposed as the JAX
package does for its Dense kernels [in, out]. Each converter returns the
keys of the module it names: ``convert_lpdnet_state_dict`` the LPDNet
embedding's (``conv1_lpd.weight``), ``convert_transformer_state_dict``
the pointer's (``enc_layers.0.self_attn.linear_q.weight``),
``convert_vcrnet_state_dict`` the whole model's (``emb_nn.``,
``pointer.``, ``vcp_att.``). Values are float32 tensors; the exports
return numpy arrays in the reference layout.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from vcrnet_tpu_torch.utils.params import from_jax_params, read_msgpack


# ---------------------------------------------------------------------------
# the training state
# ---------------------------------------------------------------------------


def training_state(trainer) -> dict:
    """{"model": state_dict, "optimizer": state_dict, "step": int} of a
    Trainer (references to its live tensors)."""
    return {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict(),
            "step": trainer.step}


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _rank0_writes(write) -> None:
    """``write()`` on rank 0 of the process group (or without one), then a
    barrier of every rank."""
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped or dist.get_rank() == 0:
        write()
    if grouped:
        dist.barrier()


def save_checkpoint(directory: str, name: str, trainer_or_state) -> str:
    """Write ``{directory}/{name}.pt``: the training state of a Trainer, or
    a state dict as :func:`training_state` gives it, moved to the CPU (on
    rank 0 of a process group, the others waiting). Returns the path."""
    path = os.path.join(directory, f"{name}.pt")

    def write():
        os.makedirs(directory, exist_ok=True)
        state = (training_state(trainer_or_state) if hasattr(trainer_or_state, "optimizer")
                 else trainer_or_state)
        torch.save(_to_cpu(state), path)

    _rank0_writes(write)
    return path


def _shapes(sd: dict) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


def _optimizer_matches(saved: dict, template: dict) -> bool:
    """Same parameter groups holding the same parameter indices, and state
    tensors of the same shapes."""
    groups = [g["params"] for g in saved.get("param_groups", ())]
    if groups != [g["params"] for g in template["param_groups"]]:
        return False
    for i, st in saved.get("state", {}).items():
        mine = template["state"].get(i)
        if mine is not None and _shapes({k: v for k, v in st.items() if torch.is_tensor(v)}) != \
                _shapes({k: v for k, v in mine.items() if torch.is_tensor(v)}):
            return False
    return True


def _merge_into(model, saved_model: dict) -> None:
    """The non-strict restore: parameters that match by name and shape (at
    least one, or raise), then the buffers (BatchNorm statistics) that
    match, where none may (a BatchNorm-free model)."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = {k: v for k, v in model.named_buffers()}
    merged = merge_params(params, {k: v for k, v in saved_model.items() if k not in buffers})
    merged.update(merge_params(buffers, {k: v for k, v in saved_model.items() if k in buffers},
                               min_leaves=0))
    model.load_state_dict(merged)


def _restore(model, optimizer, saved: dict) -> bool:
    """Restore ``saved`` into model and optimizer; True when it was strict
    (every structure matched), False when it fell back to the merge."""
    sd = model.state_dict()
    opt = saved.get("optimizer")
    if (_shapes(saved["model"]) == _shapes(sd) and opt is not None
            and _optimizer_matches(opt, optimizer.state_dict())):
        model.load_state_dict(saved["model"])
        optimizer.load_state_dict(opt)
        return True
    _merge_into(model, saved["model"])
    return False


def _read(path: str) -> dict:
    """A checkpoint file as {"model": ...[, "optimizer": ..., "step": ...]}:
    the port's ``.pt`` (a zip archive), else the JAX package's msgpack (a
    TrainState with ``params`` and ``batch_stats``, or a bare param tree),
    its parameters through ``from_jax_params`` and no optimizer state."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    raw = read_msgpack(path)
    if "params" in raw:
        return {"model": from_jax_params(raw["params"], raw.get("batch_stats") or None)}
    return {"model": from_jax_params(raw)}


def load_checkpoint(path: str, template):
    """Restore the checkpoint at ``path`` into ``template``, a Trainer (the
    counterpart of the JAX package's TrainState), in place, and return it:
    strict when the structures match; otherwise the non-strict merge of
    the module docstring, the template's optimizer state and step kept."""
    saved = _read(path)
    if _restore(template.model, template.optimizer, saved):
        template.step = int(saved.get("step", template.step))
    return template


def save_fit_state(directory: str, fit_state: dict) -> str:
    """``{directory}/fit_state.json``: epoch, best_loss, lr and the
    scheduler's attributes (the JAX package's keys); rank 0 of a process
    group writes it, the others waiting."""
    path = os.path.join(directory, "fit_state.json")

    def write():
        with open(path, "w") as f:
            json.dump(fit_state, f)

    _rank0_writes(write)
    return path


def load_fit_state(directory: str):
    path = os.path.join(directory, "fit_state.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_params(path: str, params) -> None:
    """The parameters and buffers of a model (or a ``state_dict``), on the
    CPU, by ``torch.save``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    torch.save(_to_cpu(dict(sd)), path)


def load_params(path: str, template):
    """The ``state_dict`` saved by :func:`save_params`, strictly against
    ``template`` (a model, loaded in place, or a state dict): the same
    names and shapes, or raise."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    want = template.state_dict() if isinstance(template, torch.nn.Module) else template
    if _shapes(sd) != _shapes(want):
        raise ValueError(f"{path}: saved names or shapes differ from the template's")
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(sd)
    return sd


# ---------------------------------------------------------------------------
# the reference implementation's layouts
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# reference module path -> the port's LPDNet layer
_LPDNET_KEYS = {
    "conv1_lpd": "conv1_lpd",
    "conv2_lpd": "conv2_lpd",
    "conv3_lpd": "conv3_lpd",
    "convDG1.0": "convDG1",
    "convDG2.0": "convDG2",
    "convSN1.0": "convSN1",
}
_QKVO = ("linear_q", "linear_k", "linear_v", "linear_out")


def convert_lpdnet_state_dict(sd: dict, prefix: str = "emb_nn.") -> dict:
    """The reference LPDNet's state dict -> the port's LPDNet ``state_dict``
    keys ({layer}.weight [out, in], {layer}.bias). Keys it cannot map are
    skipped (the reference loads with strict=False)."""
    out = {}
    for ref_key, name in _LPDNET_KEYS.items():
        wk, bk = f"{prefix}{ref_key}.weight", f"{prefix}{ref_key}.bias"
        if wk not in sd:
            continue
        w = _np(sd[wk])
        out[f"{name}.weight"] = _f32(w.reshape(w.shape[0], w.shape[1]))  # k = 1 conv
        if bk in sd:
            out[f"{name}.bias"] = _f32(_np(sd[bk]))
    return out


def _linear(sd: dict, ref_key: str, name: str, out: dict) -> None:
    out[f"{name}.weight"] = _f32(_np(sd[f"{ref_key}.weight"]))  # nn.Linear in both: [out, in]
    if f"{ref_key}.bias" in sd:
        out[f"{name}.bias"] = _f32(_np(sd[f"{ref_key}.bias"]))


def _norm(sd: dict, ref_key: str, name: str, out: dict) -> None:
    out[f"{name}.a_2"] = _f32(_np(sd[f"{ref_key}.a_2"]))
    out[f"{name}.b_2"] = _f32(_np(sd[f"{ref_key}.b_2"]))


def convert_transformer_state_dict(sd: dict, n_blocks: int = 1,
                                   prefix: str = "pointer.model.") -> dict:
    """The reference Transformer's state dict (its EncoderDecoder at
    ``pointer.model``: four linears an attention, residual norms in the
    SublayerConnections, a final norm each side) -> the port's pointer
    ``state_dict`` keys."""
    out: dict = {}
    for i in range(n_blocks):
        enc, dec = f"{prefix}encoder.layers.{i}.", f"{prefix}decoder.layers.{i}."
        me, md = f"enc_layers.{i}.", f"dec_layers.{i}."
        for j, name in enumerate(_QKVO):
            _linear(sd, f"{enc}self_attn.linears.{j}", f"{me}self_attn.{name}", out)
        for j in range(2):
            _norm(sd, f"{enc}sublayer.{j}.norm", f"{me}norm{j}", out)
        for w in ("w_1", "w_2"):
            _linear(sd, f"{enc}feed_forward.{w}", f"{me}ff.{w}", out)
        for j, name in enumerate(_QKVO):
            _linear(sd, f"{dec}self_attn.linears.{j}", f"{md}self_attn.{name}", out)
            _linear(sd, f"{dec}src_attn.linears.{j}", f"{md}src_attn.{name}", out)
        for j in range(3):
            _norm(sd, f"{dec}sublayer.{j}.norm", f"{md}norm{j}", out)
        for w in ("w_1", "w_2"):
            _linear(sd, f"{dec}feed_forward.{w}", f"{md}ff.{w}", out)
    _norm(sd, f"{prefix}encoder.norm", "enc_norm", out)
    _norm(sd, f"{prefix}decoder.norm", "dec_norm", out)
    return out


def convert_vcrnet_state_dict(sd: dict, n_blocks: int = 1) -> dict:
    """A full reference VCRNet state dict -> the port's model ``state_dict``
    keys, best effort and non-strict like the reference's load: the LPDNet
    embedding, the transformer pointer and the VcpAtt projections."""
    out = {f"emb_nn.{k}": v for k, v in convert_lpdnet_state_dict(sd, prefix="emb_nn.").items()}
    if any(k.startswith("pointer.model.") for k in sd):
        out.update({f"pointer.{k}": v
                    for k, v in convert_transformer_state_dict(sd, n_blocks).items()})
    if "head.linears_emb.0.weight" in sd:
        _linear(sd, "head.linears_emb.0", "vcp_att.linear_emb_q", out)
        _linear(sd, "head.linears_emb.1", "vcp_att.linear_emb_k", out)
    return out


def _torch_numpy(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def load_t7_vcrnet(path: str, n_blocks: int = 1) -> dict:
    """A reference VCRNet ``.t7`` -> the port's model ``state_dict`` keys."""
    return convert_vcrnet_state_dict(_torch_numpy(path), n_blocks=n_blocks)


def export_lpdnet_state_dict(params_emb: dict, prefix: str = "emb_nn.") -> dict:
    """The port's LPDNet ``state_dict`` -> the reference layout (numpy;
    Conv2d weights [out, in, 1, 1], Conv1d [out, in, 1]); the inverse of
    :func:`convert_lpdnet_state_dict`."""
    sd = {}
    for ref_key, name in _LPDNET_KEYS.items():
        if f"{name}.weight" not in params_emb:
            continue
        w = _np(params_emb[f"{name}.weight"])
        w = w[:, :, None, None] if ref_key.endswith(".0") else w[:, :, None]
        sd[f"{prefix}{ref_key}.weight"] = np.ascontiguousarray(w)
        if f"{name}.bias" in params_emb:
            sd[f"{prefix}{ref_key}.bias"] = _np(params_emb[f"{name}.bias"])
    return sd


def export_transformer_state_dict(params_pointer: dict, n_blocks: int = 1,
                                  prefix: str = "pointer.model.") -> dict:
    """The port's pointer ``state_dict`` -> the reference Transformer's key
    layout (numpy); the inverse of :func:`convert_transformer_state_dict`."""
    sd: dict = {}

    def put_linear(ref_key: str, name: str) -> None:
        sd[f"{ref_key}.weight"] = _np(params_pointer[f"{name}.weight"])
        if f"{name}.bias" in params_pointer:
            sd[f"{ref_key}.bias"] = _np(params_pointer[f"{name}.bias"])

    def put_norm(ref_key: str, name: str) -> None:
        sd[f"{ref_key}.a_2"] = _np(params_pointer[f"{name}.a_2"])
        sd[f"{ref_key}.b_2"] = _np(params_pointer[f"{name}.b_2"])

    for i in range(n_blocks):
        enc, dec = f"{prefix}encoder.layers.{i}.", f"{prefix}decoder.layers.{i}."
        me, md = f"enc_layers.{i}.", f"dec_layers.{i}."
        for j, name in enumerate(_QKVO):
            put_linear(f"{enc}self_attn.linears.{j}", f"{me}self_attn.{name}")
        for j in range(2):
            put_norm(f"{enc}sublayer.{j}.norm", f"{me}norm{j}")
        for w in ("w_1", "w_2"):
            put_linear(f"{enc}feed_forward.{w}", f"{me}ff.{w}")
        for j, name in enumerate(_QKVO):
            put_linear(f"{dec}self_attn.linears.{j}", f"{md}self_attn.{name}")
            put_linear(f"{dec}src_attn.linears.{j}", f"{md}src_attn.{name}")
        for j in range(3):
            put_norm(f"{dec}sublayer.{j}.norm", f"{md}norm{j}")
        for w in ("w_1", "w_2"):
            put_linear(f"{dec}feed_forward.{w}", f"{md}ff.{w}")
    put_norm(f"{prefix}encoder.norm", "enc_norm")
    put_norm(f"{prefix}decoder.norm", "dec_norm")
    return sd


def _sub(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def export_vcrnet_state_dict(params: dict, n_blocks: int = 1) -> dict:
    """The port's model ``state_dict`` -> the reference layout (numpy): the
    LPDNet embedding and the transformer pointer, the trainable surface of
    the default configuration; the inverse of
    :func:`convert_vcrnet_state_dict`."""
    sd = export_lpdnet_state_dict(_sub(params, "emb_nn."))
    sd.update(export_transformer_state_dict(_sub(params, "pointer."), n_blocks))
    return sd


def export_lpdnet_t7(params_emb: dict, path: str) -> str:
    """The port's LPDNet ``state_dict`` -> a reference-layout state dict
    written by ``torch.save`` (read back by :func:`load_t7_lpdnet`)."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in export_lpdnet_state_dict(params_emb).items()}, path)
    return path


def load_t7_lpdnet(path: str, prefix: str = "emb_nn.") -> dict:
    """A reference LPDNet ``.t7`` -> the port's LPDNet ``state_dict`` keys."""
    return convert_lpdnet_state_dict(_torch_numpy(path), prefix=prefix)


def merge_params(params: dict, converted: dict, *, min_leaves: int = 1,
                 stats: dict | None = None) -> dict:
    """Non-strict merge of ``converted`` into ``params`` (both flat
    ``state_dict``-style {name: tensor}): an entry is taken from
    ``converted`` where its name exists in ``params`` with the same shape,
    in ``params``' dtype and device (the reference's strict=False load).

    Non-strict is not silent: a merge that takes fewer than
    ``min_leaves`` entries raises (``min_leaves=0`` only where an empty
    overlap is legitimate). ``stats``, if given, receives the merged,
    shape-mismatch and source-entry counts."""
    counts = {"merged": 0, "shape_mismatch": 0, "converted_leaves": 0}
    out = dict(params)
    for key, src in converted.items():
        counts["converted_leaves"] += 1
        if key not in out:
            continue
        dst = out[key]
        src = torch.as_tensor(src)
        if tuple(src.shape) == tuple(dst.shape):
            counts["merged"] += 1
            out[key] = src.to(dtype=dst.dtype, device=dst.device)
        else:
            counts["shape_mismatch"] += 1
    if stats is not None:
        stats.update(counts)
    if counts["merged"] < min_leaves:
        raise ValueError(
            f"merge_params merged {counts['merged']} leaves (< min_leaves={min_leaves}) out of "
            f"{counts['converted_leaves']} in the source ({counts['shape_mismatch']} shape "
            f"mismatches). Target names start {sorted({k.split('.')[0] for k in params})}; "
            f"source names start {sorted({k.split('.')[0] for k in converted})}. A zero-leaf "
            "merge almost always means the wrong dict was passed (a module's keys where the "
            "model's were wanted, or the reverse).")
    return out


def merge_pretrained_embedding(params: dict, emb_params: dict) -> dict:
    """Graft an LPDNet ``state_dict`` (e.g. from :func:`load_t7_lpdnet`)
    into a model ``state_dict`` under ``emb_nn.`` (non-strict); raises when
    nothing merges.

    An embedding with a T-Net (``t_net3d.*`` / ``t_net_fea.*``) that the
    model has too is refused with a ``ValueError``: the JAX package's merge
    descends one level of the parameter tree and raises an
    ``AttributeError`` on a T-Net's nested layers, so no merged result
    exists to hold the port to (ROADMAP C). The twelve LPDNet tensors
    without T-Nets merge as before."""
    tnet = sorted(k for k in emb_params
                  if k.split(".")[0] in ("t_net3d", "t_net_fea") and f"emb_nn.{k}" in params)
    if tnet:
        raise ValueError(
            "merge_pretrained_embedding does not merge a T-Net "
            f"({sorted({k.split('.')[0] for k in tnet})}): the JAX package's merge "
            "(vcrnet_tpu/train/checkpoint.py:merge_pretrained_embedding) descends one level "
            "of the tree and raises an AttributeError on a T-Net's nested layers; load the "
            "whole checkpoint with load_checkpoint instead")
    out = dict(params)
    n_merged = 0
    for key, value in emb_params.items():
        name = f"emb_nn.{key}"
        if name in out and tuple(out[name].shape) == tuple(value.shape):
            out[name] = torch.as_tensor(value).to(dtype=out[name].dtype, device=out[name].device)
            n_merged += 1
    if n_merged == 0:
        raise ValueError(
            "merge_pretrained_embedding merged 0 leaves: converted layers "
            f"{sorted({k.split('.')[0] for k in emb_params})} vs model emb_nn layers "
            f"{sorted({k.split('.')[1] for k in params if k.startswith('emb_nn.')})}")
    return out
