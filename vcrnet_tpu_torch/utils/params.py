"""Weights from the JAX package's flax checkpoints.

``read_msgpack`` decodes flax's msgpack checkpoint format in pure Python
(what ``flax.serialization.msgpack_restore`` returns: nested dicts of str
keys with numpy leaves), so loading a checkpoint needs neither flax nor
the ``msgpack`` package. ``from_jax_params`` turns flax variables (the
param tree and, for models with BatchNorm, the ``batch_stats`` tree) into a
``state_dict`` of the port's modules.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# msgpack type bytes beyond the fix* ranges: constants, fixed-width numbers
# (struct formats), length-prefixed types (length format, kind), fixext sizes
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q", 0xD0: "b", 0xD1: "h",
          0xD2: "i", 0xD3: "q", 0xCA: "f", 0xCB: "d"}
_SIZED = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
          0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
          0xDC: ("H", "array"), 0xDD: ("I", "array"),
          0xDE: ("H", "map"), 0xDF: ("I", "map"),
          0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """A msgpack decoder for the subset flax writes: nil, bool, int,
    float, str, bin, array, map and ext."""

    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax's inner ndarray records)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload, raw=True).value()
            if dtype == b"bfloat16":
                raise ValueError("bfloat16 leaves are not supported")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unknown msgpack ext type {code}")

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t in _SIMPLE:
            return _SIMPLE[t]
        if t in _FIXED:
            return self.unpack(_FIXED[t])
        if t in _SIZED:
            fmt, kind = _SIZED[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map_(n)
            return self.ext(self.unpack("b"), n)
        if t in _FIXEXT:
            return self.ext(self.unpack("b"), _FIXEXT[t])
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map_(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(tree):
    """flax splits arrays above 2**30 bytes into numbered chunks."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts with numpy leaves."""
    reader = _Reader(data, raw=False)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return _unchunk(tree)


def read_msgpack(path: str):
    with open(path, "rb") as fh:
        return msgpack_restore(fh.read())


_LIST_MODULES = re.compile(r"^(enc_layers|dec_layers)_(\d+)$")


def _walk(tree: dict, path: list, leaf) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            m = _LIST_MODULES.match(key)
            _walk(val, path + ([m.group(1), m.group(2)] if m else [key]), leaf)
        else:
            leaf(".".join(path), key, np.asarray(val, dtype=np.float32))


def from_jax_params(params: dict, batch_stats: dict | None = None) -> dict:
    """flax variables -> ``state_dict`` (float32 tensors) of the port's
    modules. Module paths keep their flax names (``enc_layers_0`` becomes
    ``enc_layers.0``); a Dense ``kernel`` [in, out] becomes ``weight``
    [out, in]; BatchNorm's ``scale`` becomes ``weight``; ``bias``, and
    LayerNorm's ``a_2``/``b_2``, keep their names. ``batch_stats`` leaves
    ``mean`` / ``var`` become the ``running_mean`` / ``running_var``
    buffers. Raises on any leaf it cannot map and on two leaves that map to
    one name."""
    out = {}

    def put(name: str, arr: np.ndarray) -> None:
        if name in out:
            raise KeyError(f"two leaves map to {name}")
        out[name] = torch.from_numpy(arr.copy())

    def param(name: str, key: str, arr: np.ndarray) -> None:
        if key == "kernel" and arr.ndim == 2:
            put(f"{name}.weight", arr.T)
        elif key == "scale" and arr.ndim == 1:
            put(f"{name}.weight", arr)
        elif key in ("bias", "a_2", "b_2") and arr.ndim == 1:
            put(f"{name}.{key}", arr)
        else:
            raise KeyError(f"cannot map param leaf {name}.{key} {arr.shape}")

    def stat(name: str, key: str, arr: np.ndarray) -> None:
        if key not in ("mean", "var") or arr.ndim != 1:
            raise KeyError(f"cannot map batch_stats leaf {name}.{key} {arr.shape}")
        put(f"{name}.running_{key}", arr)

    _walk(params, [], param)
    _walk(batch_stats or {}, [], stat)
    return out


def load_checkpoint(path: str) -> dict:
    """A flax checkpoint (a full TrainState with a ``params`` entry and,
    for models with BatchNorm, ``batch_stats``; or a bare param tree) ->
    ``state_dict`` for the port's model."""
    raw = read_msgpack(path)
    if "params" in raw:
        return from_jax_params(raw["params"], raw.get("batch_stats"))
    return from_jax_params(raw)
