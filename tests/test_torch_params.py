"""The port's pure-Python msgpack reader and the flax -> state_dict bridge
(vcrnet_tpu_torch/utils/params.py) against flax's own decoder."""

import os

import numpy as np
import pytest

import jax
from flax import serialization

from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import VCRNet
from vcrnet_tpu_torch.utils.params import (
    from_jax_params, load_checkpoint, msgpack_restore, read_msgpack,
)

CHECKPOINT = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "pretrained",
                          "vcrnet_shapes_best.msgpack")


def _leaves(tree):
    return [(jax.tree_util.keystr(path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_trees_bitwise_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def test_reader_matches_flax_on_committed_checkpoint():
    with open(CHECKPOINT, "rb") as fh:
        data = fh.read()
    _assert_trees_bitwise_equal(read_msgpack(CHECKPOINT), serialization.msgpack_restore(data))


def test_reader_matches_flax_on_every_type_flax_writes():
    tree = {
        "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i8": np.array([-3, 4], np.int8),
        "u16": np.array([70000 % 65536], np.uint16),
        "f64": np.array(1.5),
        "scalar": np.float32(2.5),
        "ints": {"small": 7, "neg": -40, "big": 2 ** 40, "negbig": -(2 ** 33)},
        "float": 0.25, "bool": True, "none": None, "text": "x" * 40,
        "list": [1, 2.0, "three"], "empty": {},
        "wide": np.zeros((300,), np.float16),
    }
    data = serialization.msgpack_serialize(tree)
    _assert_trees_bitwise_equal(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_rejects_trailing_bytes():
    data = serialization.msgpack_serialize({"a": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")


def test_from_jax_params_maps_all_58_leaves_into_vcrnet():
    state_dict = load_checkpoint(CHECKPOINT)
    assert len(state_dict) == 58
    model = VCRNet(Config(), device="cpu")
    model.load_state_dict(state_dict)  # strict: every key maps both ways
    raw = read_msgpack(CHECKPOINT)["params"]
    np.testing.assert_array_equal(
        model.pointer.enc_layers[0].self_attn.linear_q.weight.detach().numpy(),
        raw["pointer"]["enc_layers_0"]["self_attn"]["linear_q"]["kernel"].T)
    np.testing.assert_array_equal(model.pointer.dec_norm.a_2.detach().numpy(),
                                  raw["pointer"]["dec_norm"]["a_2"])


def test_from_jax_params_raises_on_unknown_leaf():
    params = {"emb_nn": {"conv1_lpd": {"kernel": np.zeros((3, 64), np.float32),
                                       "gain": np.ones(64, np.float32)}}}
    with pytest.raises(KeyError, match="conv1_lpd.gain"):
        from_jax_params(params)
    with pytest.raises(KeyError, match="kernel"):
        from_jax_params({"x": {"kernel": np.zeros((3, 3, 3), np.float32)}})
    # a BatchNorm scale maps to ``weight``: beside a kernel it would collide
    params["emb_nn"]["conv1_lpd"] = {"kernel": np.zeros((3, 64), np.float32),
                                     "scale": np.ones(64, np.float32)}
    with pytest.raises(KeyError, match="two leaves map to emb_nn.conv1_lpd.weight"):
        from_jax_params(params)
    with pytest.raises(KeyError, match="batch_stats leaf bn1.count"):
        from_jax_params({}, {"bn1": {"count": np.zeros(4, np.float32)}})


def test_from_jax_params_maps_batchnorm_variables_into_dgcnn_vcrnet():
    """flax variables of a BatchNorm model: ``scale`` -> ``weight``, and the
    ``batch_stats`` collection -> the running_mean / running_var buffers."""
    import jax.numpy as jnp

    from vcrnet_tpu.config import Config as JConfig
    from vcrnet_tpu.models.vcrnet import VCRNet as JVCRNet

    kw = dict(num_points=32, emb_dims=64, ff_dims=64, n_heads=2, emb_nn="dgcnn")
    x = jnp.zeros((1, 32, 3))
    variables = jax.device_get(JVCRNet(cfg=JConfig(**kw)).init(jax.random.PRNGKey(0), x, x))
    stats = jax.tree_util.tree_map(lambda a: a + 0.25, variables["batch_stats"])
    state_dict = from_jax_params(variables["params"], stats)
    model = VCRNet(Config(**kw), device="cpu")
    model.load_state_dict(state_dict)  # strict: parameters and buffers map both ways
    np.testing.assert_array_equal(model.emb_nn.bn3.weight.detach().numpy(),
                                  variables["params"]["emb_nn"]["bn3"]["scale"])
    np.testing.assert_array_equal(model.emb_nn.bn3.running_var.numpy(),
                                  stats["emb_nn"]["bn3"]["var"])
    np.testing.assert_array_equal(model.emb_nn.bn5.running_mean.numpy(),
                                  stats["emb_nn"]["bn5"]["mean"])
    np.testing.assert_array_equal(model.emb_nn.conv4.weight.detach().numpy(),
                                  variables["params"]["emb_nn"]["conv4"]["kernel"].T)
    assert len(state_dict) == len(model.state_dict())
    assert sum("running_" in k for k in state_dict) == 10


def test_load_checkpoint_keeps_batch_stats(tmp_path):
    tree = {"params": {"bn1": {"scale": np.full(4, 2.0, np.float32),
                               "bias": np.zeros(4, np.float32)}},
            "batch_stats": {"bn1": {"mean": np.arange(4, dtype=np.float32),
                                    "var": np.full(4, 3.0, np.float32)}},
            "step": 7}
    path = tmp_path / "state.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    state_dict = load_checkpoint(str(path))
    assert sorted(state_dict) == ["bn1.bias", "bn1.running_mean", "bn1.running_var", "bn1.weight"]
    np.testing.assert_array_equal(state_dict["bn1.running_mean"].numpy(), np.arange(4))
    bare = tmp_path / "bare.msgpack"
    bare.write_bytes(serialization.msgpack_serialize(tree["params"]))
    assert sorted(load_checkpoint(str(bare))) == ["bn1.bias", "bn1.weight"]
