"""The DGCNN / DCP family of the port against the JAX package on the CPU.

The same numpy inputs and the same flax variables (bridged by
``from_jax_params``, running statistics included) go through the JAX function
and its counterpart in the port. The Pallas kernels run in interpret mode, as
the JAX package's own tests run them; on CPU tensors the port runs its plain
versions. Tolerances: selections identical; folded weights 1e-6; the plain
DGCNN eval chain 2e-3 of the output's largest value against the Pallas kernel
(the same bf16 roundings, f32 sums in another order) and 2e-2 against the f32
module; modules in f32 1e-4 (5e-4 through the MLP head, whose three
BatchNorms divide by the deviation of a batch of 3 rows and so amplify f32
rounding); running statistics 1e-5; a Trainer step 1e-4 on
the loss and sums, 1e-3 of each parameter's largest gradient (floored) on the
gradients, 1e-5 on the new running statistics."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vcrnet_tpu import geometry as jgeo
from vcrnet_tpu import ops as jops
from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.data import Loader as JLoader, SyntheticDataset as JSyntheticDataset
from vcrnet_tpu.models import dcp as jdcp
from vcrnet_tpu.models import embeddings as jemb
from vcrnet_tpu.models.vcrnet import VCRNet as JVCRNet, vcrnet_iter as j_vcrnet_iter
from vcrnet_tpu.ops import pallas_dgcnn, pallas_knn
from vcrnet_tpu.parallel import make_mesh
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu.train import Trainer as JTrainer
from vcrnet_tpu_torch import geometry
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models import DCP, VCRNet, vcrnet_iter
from vcrnet_tpu_torch.models import embeddings as emb
from vcrnet_tpu_torch.models._common import FlaxBatchNorm
from vcrnet_tpu_torch.models.dcp import MLPHead, svd_head_corr
from vcrnet_tpu_torch.models.lpd import LPD
from vcrnet_tpu_torch.ops import dgcnn, graph, knn
from vcrnet_tpu_torch.ops._common import SMEM_LIMIT
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.train import Trainer
from vcrnet_tpu_torch.utils.params import from_jax_params

NARROW = dict(num_points=64, emb_dims=128, ff_dims=128, n_heads=2, batch_size=4,
              test_batch_size=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _randomised_stats(batch_stats, rng):
    """Running statistics away from their init (mean 0, var 1), so that a
    fold or an eval pass that ignored them would show: means in +-0.1,
    variances in [0.75, 1.25] (small means keep the ReLUs alive)."""
    def leaf(path, a):
        r = rng.rand(*a.shape).astype(np.float32)
        is_var = jax.tree_util.keystr(path).endswith("['var']")
        return jnp.asarray(r * 0.5 + 0.75 if is_var else (r - 0.5) * 0.2)

    return jax.tree_util.tree_map_with_path(leaf, batch_stats)


def _randomised_affine(params, rng):
    """BatchNorm scales and shifts away from 1 and 0 (the leaves under a
    ``bn*`` module), everything else as it is."""
    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "['bn" not in key:
            return a
        r = rng.rand(*a.shape).astype(np.float32)
        return jnp.asarray(r * 0.5 + 0.75 if key.endswith("['scale']") else (r - 0.5) * 0.2)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _load(module, variables):
    module.load_state_dict(from_jax_params(jax.device_get(variables["params"]),
                                           jax.device_get(variables.get("batch_stats"))))
    return module


def _assert_stats_match(module, batch_stats, atol=1e-5):
    want = from_jax_params({}, jax.device_get(batch_stats))
    got = {k: v for k, v in module.state_dict().items() if "running_" in k}
    assert set(got) == set(want) and want
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# knn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [3, 64])
def test_fused_knn_ref_equals_pallas_kernel(c):
    x = np.random.RandomState(c).rand(2, 128, c).astype(np.float32)
    want = np.asarray(pallas_knn.fused_knn(jnp.asarray(x), 8, interpret=True,
                                           packed_select=False))
    got = knn.fused_knn_ref(_t(x), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper and graph.knn's kernel method run the plain version
    np.testing.assert_array_equal(knn.fused_knn(_t(x), 8).numpy(), want)
    np.testing.assert_array_equal(graph.knn(_t(x), 8, method="kernel").numpy(), want)


def test_fused_knn_ref_ties_go_to_smaller_column_and_self_is_skipped():
    # integer coordinates: exact scores, many ties, and two duplicate points
    x = np.random.RandomState(1).randint(-3, 4, size=(1, 64, 3)).astype(np.float32)
    x[0, 5] = x[0, 2]
    want = np.asarray(pallas_knn.fused_knn(jnp.asarray(x), 6, interpret=True,
                                           packed_select=False))
    got = knn.fused_knn_ref(_t(x), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert not (got == np.arange(64)[None, :, None]).any()  # never the point itself
    assert got[0, 5, 0] == 2 and got[0, 2, 0] == 5  # its duplicate comes first
    # the exact method drops the best column instead, whichever it is
    exact = graph.knn(_t(x), 6, method="exact").numpy()
    np.testing.assert_array_equal(
        exact, np.asarray(jops.knn(jnp.asarray(x), 6, method="exact")))


def test_knn_methods_and_zero_gradient():
    x = torch.rand(1, 32, 3, generator=torch.Generator().manual_seed(0), requires_grad=True)
    for method in ("auto", "exact", "kernel"):
        idx = graph.knn(x, 4, method=method)
        assert idx.dtype == torch.int32 and not idx.requires_grad
    np.testing.assert_array_equal(graph.knn(x, 4).numpy(), graph.knn(x, 4, method="exact").numpy())
    feats = graph.gather_max_neighbors(x, knn.fused_knn(x, 4))
    feats.sum().backward()  # the gradient flows through the gather, not the selection
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="unknown knn method"):
        graph.knn(x, 4, method="approx")
    # 'auto' on a CPU tensor is 'exact' at any shape (on a CUDA tensor it is 'kernel')
    ragged = torch.rand(1, 33, 5, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(graph.knn(ragged, 4).numpy(),
                                  graph.knn(ragged, 4, method="exact").numpy())


def test_graph_feature_matches_jax():
    x = np.random.RandomState(2).rand(2, 32, 5).astype(np.float32)
    want = np.asarray(jops.graph_feature(jnp.asarray(x), k=4))
    got = graph.graph_feature(_t(x), k=4)
    assert got.shape == (2, 32, 4, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    idx = graph.knn(_t(x), 4)
    np.testing.assert_array_equal(graph.graph_feature(_t(x), idx=idx).numpy(), want)


# ---------------------------------------------------------------------------
# dgcnn_eval
# ---------------------------------------------------------------------------

def _dgcnn_pair(emb_dims=128, k=5, seed=3, dtype=None, n=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, n, 3).astype(np.float32) - 0.5
    jmodel = jemb.DGCNN(emb_dims=emb_dims, k=k, dtype=dtype)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": _randomised_affine(variables["params"], rng),
                 "batch_stats": _randomised_stats(variables["batch_stats"], rng)}
    tdtype = torch.bfloat16 if dtype is not None else None
    model = _load(emb.DGCNN(emb_dims, k=k, dtype=tdtype), variables)
    return x, jmodel, variables, model


def test_fold_dgcnn_eval_params_matches_jax():
    _, _, variables, model = _dgcnn_pair()
    want = pallas_dgcnn.fold_dgcnn_eval_params(variables["params"], variables["batch_stats"])
    got = dgcnn.fold_dgcnn_eval_params(model)
    assert len(got) == 5
    for (gw, gb), (ww, wb) in zip(got, want):
        np.testing.assert_allclose(gw.detach().numpy(), np.asarray(ww), atol=1e-6)
        np.testing.assert_allclose(gb.detach().numpy(), np.asarray(wb), atol=1e-6)


def test_fused_dgcnn_eval_ref_matches_pallas_kernel_and_module():
    x, jmodel, variables, model = _dgcnn_pair()
    folded_j = pallas_dgcnn.fold_dgcnn_eval_params(variables["params"], variables["batch_stats"])
    idx = jops.knn(jnp.asarray(x), k=5)
    want = np.asarray(pallas_dgcnn.fused_dgcnn_eval(jnp.asarray(x), idx, folded_j, 128,
                                                    interpret=True))
    model.eval()
    with torch.no_grad():
        folded = dgcnn.fold_dgcnn_eval_params(model)
        tidx = _t(np.asarray(idx)).to(torch.int32)
        got = dgcnn.fused_dgcnn_eval_ref(_t(x), tidx, folded, 128)
        # the wrapper on CPU tensors is the plain version
        assert torch.equal(dgcnn.fused_dgcnn_eval(_t(x), tidx, folded, 128), got)
        module_out = model(_t(x))[0]
    scale = np.abs(want).max()
    assert scale > 0.1 and (want > 0).mean() > 0.2  # the ReLUs are alive
    assert got.shape == (2, 64, 128) and got.dtype == torch.float32
    # the same rounding points as the Pallas kernel: far inside JAX's own 2e-2
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=2e-3)
    # and the port's own f32 module in eval (the fold is right)
    np.testing.assert_allclose(got.numpy() / scale, module_out.numpy() / scale, atol=2e-2)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(module_out.numpy(), ref, atol=1e-4)


def test_fused_dgcnn_gates_and_refusals():
    assert dgcnn.fused_dgcnn_supported(1024, 20, 512) and dgcnn.fused_dgcnn_supported(768, 20, 512)
    assert dgcnn.fused_dgcnn_supported(64, 30, 128)
    assert dgcnn.fused_dgcnn_supported(1000, 20, 512)  # a ragged last tile (ROADMAP C1)
    assert not dgcnn.fused_dgcnn_supported(1024, 20, 500)  # the projection tiles 128 columns
    # the edge kernel streams the neighbour slots: k is bounded by N alone
    assert dgcnn.fused_dgcnn_supported(1024, 31, 512) and dgcnn.fused_dgcnn_supported(64, 63, 128)
    assert not dgcnn.fused_dgcnn_supported(64, 64, 128) and not dgcnn.fused_dgcnn_supported(64, 0, 128)
    assert dgcnn.dgcnn_eval_smem_bytes() == 216072 <= SMEM_LIMIT
    x, _, _, model = _dgcnn_pair()
    idx = graph.knn(_t(x), 5)
    with pytest.raises(RuntimeError, match="no backward"):
        dgcnn.fused_dgcnn_eval(_t(x), idx, dgcnn.fold_dgcnn_eval_params(model), 128)
    with torch.no_grad():
        folded = dgcnn.fold_dgcnn_eval_params(model)
    with pytest.raises(ValueError, match="emb_dims"):
        dgcnn.fused_dgcnn_eval_ref(_t(x), idx, folded, 256)


def test_dgcnn_kernel_route_on_cpu_is_the_plain_eval_chain_in_bf16():
    """fused=True in eval, bf16, no gradient: the module returns the fused
    chain (its plain version here), close to its own plain formulation in
    bf16; with a gradient recorded, or in training mode, it does not."""
    x, _, _, model = _dgcnn_pair(dtype=jnp.bfloat16)
    model.eval()
    tx = _t(x)
    with torch.no_grad():
        fused, idx, _ = model(tx, fused=True)
        plain = model(tx, fused=False)[0]
        want = dgcnn.fused_dgcnn_eval_ref(tx, idx, dgcnn.fold_dgcnn_eval_params(model), 128)
    assert torch.equal(fused, want)
    scale = float(plain.abs().max())
    assert scale > 0.1
    np.testing.assert_allclose(fused.numpy() / scale, plain.numpy() / scale, atol=3e-2)
    with_grad = model(tx, fused=True)[0]
    assert with_grad.requires_grad and torch.equal(with_grad.detach(), plain)
    model.train()
    assert model(tx, fused=True)[0].requires_grad


def test_dgcnn_kernel_route_does_not_give_way_on_a_shape_the_kernel_refuses():
    """An embedding of 96 is no whole number of the projection's 128-column
    passes: the module still calls the fused chain (on the card its wrapper
    raises there; a CPU tensor runs its plain version, which takes any
    shape), never the plain formulation. N = 60 is a ragged cloud, which the
    kernel takes."""
    x, _, _, model = _dgcnn_pair(emb_dims=96, dtype=jnp.bfloat16, n=60)
    assert not dgcnn.fused_dgcnn_supported(60, 5, 96)
    assert dgcnn.fused_dgcnn_supported(60, 5, 128)
    model.eval()
    tx = _t(x)
    with torch.no_grad():
        fused, idx, _ = model(tx, fused=True)
        want = dgcnn.fused_dgcnn_eval_ref(tx, idx, dgcnn.fold_dgcnn_eval_params(model), 96)
        plain = model(tx, fused=False)[0]
    assert torch.equal(fused, want) and not torch.equal(fused, plain)


# ---------------------------------------------------------------------------
# modules against JAX: eval, training mode, running statistics
# ---------------------------------------------------------------------------

def _check_train_and_eval(jmodel, variables, model, j_inputs, t_inputs, atol=1e-4):
    """Eval output, then two training calls (outputs and the running
    statistics after each), then eval on the updated statistics."""
    model.eval()
    with torch.no_grad():
        got = model(*t_inputs)
    want = jmodel.apply(variables, *j_inputs, train=False)
    _close_outputs(got, want, atol)
    model.train()
    for _ in range(2):
        want, mut = jmodel.apply(variables, *j_inputs, train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
        _close_outputs(model(*t_inputs), want, atol)
        _assert_stats_match(model, variables["batch_stats"])
    model.eval()
    with torch.no_grad():
        _close_outputs(model(*t_inputs), jmodel.apply(variables, *j_inputs, train=False), atol)


def _close_outputs(got, want, atol=1e-4):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    got = [g for g in got if g is not None and g.dtype.is_floating_point]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 1e-3  # nothing compared is dead
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol)


def test_dgcnn_matches_jax_in_eval_and_training_with_running_stats():
    x, jmodel, variables, model = _dgcnn_pair()
    _check_train_and_eval(jmodel, variables, model, (jnp.asarray(x),), (_t(x),))


def test_dgcnn_takes_and_returns_the_spatial_selection():
    x, jmodel, variables, model = _dgcnn_pair()
    model.eval()
    with torch.no_grad():
        out, idx, feat = model(_t(x))
        assert feat is None and idx.shape == (2, 64, 5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jops.knn(jnp.asarray(x), k=5)))
        other = torch.roll(idx, 1, dims=1)
        again, idx2, _ = model(_t(x), spatial_idx=other)
    assert idx2 is other and not torch.equal(again, out)
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        spatial_idx=jnp.asarray(other.numpy()))
    np.testing.assert_allclose(again.numpy(), np.asarray(want), atol=1e-4)
    with pytest.raises(ValueError, match="feature-space"):
        model(_t(x), feature_idx=idx)


def test_pointnet_matches_jax_in_eval_and_training_with_running_stats():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 32, 3).astype(np.float32) - 0.5
    jmodel = jemb.PointNet(emb_dims=64)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = {"params": _randomised_affine(variables["params"], rng),
                 "batch_stats": _randomised_stats(variables["batch_stats"], rng)}
    model = _load(emb.PointNet(64), variables)
    _check_train_and_eval(jmodel, variables, model, (jnp.asarray(x),), (_t(x),))


def test_mlp_head_matches_jax_in_eval_and_training_with_running_stats():
    """B = 3 rows per BatchNorm call: flax's biased variance and torch's
    unbiased one differ by a factor 1.5 here."""
    rng = np.random.RandomState(5)
    a = rng.randn(3, 16, 64).astype(np.float32)
    b = rng.randn(3, 16, 64).astype(np.float32)
    jmodel = jdcp.MLPHead(emb_dims=64)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(a), jnp.asarray(b))
    variables = {"params": _randomised_affine(variables["params"], rng),
                 "batch_stats": _randomised_stats(variables["batch_stats"], rng)}
    model = _load(MLPHead(64), variables)
    _check_train_and_eval(jmodel, variables, model, (jnp.asarray(a), jnp.asarray(b)),
                          (_t(a), _t(b)), atol=5e-4)


def test_flax_batch_norm_is_not_torch_batch_norm():
    """The update this module exists for: the running variance takes the
    biased batch variance, with flax's momentum."""
    x = torch.tensor([[1.0], [2.0], [6.0]])
    bn = FlaxBatchNorm(1)
    bn.train()
    bn(x)
    np.testing.assert_allclose(bn.running_mean.item(), 0.1 * 3.0, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.item(), 0.9 + 0.1 * (14.0 / 3.0), rtol=1e-6)
    ref = torch.nn.BatchNorm1d(1, momentum=0.1)
    ref.train()
    ref(x)
    assert abs(ref.running_var.item() - bn.running_var.item()) > 0.2  # 0.1 * (7 - 14/3)
    assert bn(x.to(torch.bfloat16)).dtype == torch.float32


def test_svd_head_corr_and_quat2mat_match_jax():
    rng = np.random.RandomState(6)
    a, b = rng.randn(2, 24, 32).astype(np.float32), rng.randn(2, 24, 32).astype(np.float32)
    src, tgt = rng.rand(2, 24, 3).astype(np.float32), rng.rand(2, 24, 3).astype(np.float32)
    want = jdcp.svd_head_corr(*(jnp.asarray(v) for v in (a, b, src, tgt)))
    got = svd_head_corr(_t(a), _t(b), _t(src), _t(tgt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)

    # tests/test_geometry.py's cases: identity, scipy, orthonormality
    from scipy.spatial.transform import Rotation

    eye = geometry.quat2mat(torch.tensor([[0.0, 0.0, 0.0, 1.0]]))
    np.testing.assert_allclose(eye[0].numpy(), np.eye(3), atol=1e-6)
    q = rng.randn(8, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = geometry.quat2mat(_t(q)).numpy()
    np.testing.assert_allclose(R, Rotation.from_quat(q).as_matrix(), atol=1e-5)
    np.testing.assert_allclose(R, np.asarray(jgeo.quat2mat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (8, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _clouds(seed, b=2, n=64):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n, 3).astype(np.float32) - 0.5,
            rng.rand(b, n, 3).astype(np.float32) - 0.5)


def _jax_model(cls, cfg, src, tgt, seed=0):
    jmodel = cls(cfg=cfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(src), jnp.asarray(tgt))
    rng = np.random.RandomState(seed + 100)
    stats = variables.get("batch_stats")
    if stats is not None:
        stats = _randomised_stats(stats, rng)
    return jmodel, {"params": _randomised_affine(variables["params"], rng), "batch_stats": stats}


DCP_VARIANTS = {
    "svd": dict(emb_nn="dgcnn"),
    "svd_cycle": dict(emb_nn="dgcnn", cycle=True),
    "mlp": dict(emb_nn="dgcnn", head="mlp"),
    "mlp_cycle_identity": dict(emb_nn="dgcnn", head="mlp", cycle=True, pointer="identity"),
    "pointnet_identity": dict(emb_nn="pointnet", pointer="identity"),
    "lpdnet": dict(emb_nn="lpdnet"),
}


@pytest.mark.parametrize("variant", sorted(DCP_VARIANTS))
def test_dcp_forward_matches_jax_in_eval_and_training(variant):
    kw = dict(NARROW, model="dcp", **DCP_VARIANTS[variant])
    # the MLP head's BatchNorms normalise over the batch: a few near-equal
    # rows make the batch deviation tiny and the comparison ill-conditioned
    src, tgt = _clouds(7, b=8 if "mlp" in variant else 3)
    jmodel, variables = _jax_model(jdcp.DCP, JConfig(**kw), src, tgt)
    model = DCP(Config(**kw), device="cpu")
    if variables["batch_stats"] is None:
        variables = {"params": variables["params"]}
        model.load_state_dict(from_jax_params(jax.device_get(variables["params"])))
        model.eval()
        with torch.no_grad():
            got = model(_t(src), _t(tgt))
        _close_outputs(got, jmodel.apply(variables, jnp.asarray(src), jnp.asarray(tgt)))
        return
    _load(model, variables)
    _check_train_and_eval(jmodel, variables, model, (jnp.asarray(src), jnp.asarray(tgt)),
                          (_t(src), _t(tgt)), atol=5e-4 if "mlp" in variant else 1e-4)


def test_dcp_refuses_unknown_parts():
    for kw, err in ((dict(pointer="rnn"), ValueError), (dict(head="quat"), ValueError),
                    (dict(int8_eval=True, compute_dtype="bfloat16"), NotImplementedError), (dict(emb_nn="cnn"), ValueError)):
        with pytest.raises(err):
            DCP(Config(**NARROW, model="dcp", **kw), device="cpu")


@pytest.mark.parametrize("emb_nn", ["dgcnn", "pointnet"])
def test_vcrnet_with_batchnorm_embedding_matches_jax(emb_nn):
    """Eval stacks the two clouds (exact on running statistics); training
    embeds them one after the other, two updates of the statistics."""
    kw = dict(NARROW, emb_nn=emb_nn)
    src, tgt = _clouds(8, b=3)
    jmodel, variables = _jax_model(JVCRNet, JConfig(**kw), src, tgt)
    model = _load(VCRNet(Config(**kw), device="cpu"), variables)
    _check_train_and_eval(jmodel, variables, model, (jnp.asarray(src), jnp.asarray(tgt)),
                          (_t(src), _t(tgt)))


@pytest.mark.parametrize("emb_nn", ["dgcnn", "pointnet"])
def test_vcrnet_iter_with_cached_spatial_idx_matches_jax(emb_nn):
    kw = dict(NARROW, emb_nn=emb_nn)
    src, tgt = _clouds(9)
    jmodel, variables = _jax_model(JVCRNet, JConfig(**kw), src, tgt)
    model = _load(VCRNet(Config(**kw), device="cpu"), variables).eval()
    want = j_vcrnet_iter(lambda v, s, t: jmodel.apply(v, s, t), variables, jnp.asarray(src),
                         jnp.asarray(tgt), 3, model=jmodel)
    calls = []
    hook = model.emb_nn.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append(kwargs.get("spatial_idx") is not None),
        with_kwargs=True)
    with torch.no_grad():
        got = vcrnet_iter(model, _t(src), _t(tgt), 3)
    hook.remove()
    _close_outputs(got, want)
    # target once, then the source three times: DGCNN's selection is passed
    # back from iteration 2 on, PointNet has none
    assert calls == ([False, False, True, True] if emb_nn == "dgcnn" else [False] * 4)


# ---------------------------------------------------------------------------
# the Trainer and the Registrar
# ---------------------------------------------------------------------------

def _batch(cfg, partition="train", n_items=4, seed=7):
    np.random.seed(seed)  # train items draw from the global generator
    loader = JLoader(JSyntheticDataset(cfg, partition, n_items=n_items, cloud_points=128,
                                       kind="shapes"), n_items)
    batch = next(iter(loader))
    batch.pop("label")
    return batch


def _trainers(**kw):
    jcfg = JConfig(**NARROW, **kw)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    batch = _batch(jcfg)
    state = jtr.init_state(jax.random.PRNGKey(0), batch)
    rng = np.random.RandomState(11)
    state = state.replace(params=_randomised_affine(state.params, rng),
                          batch_stats=_randomised_stats(state.batch_stats, rng))
    tr = Trainer(Config(**NARROW, **kw), device="cpu")
    tr.model.load_state_dict(from_jax_params(jax.device_get(state.params),
                                             jax.device_get(state.batch_stats)))
    return jtr, state, tr, batch


TRAIN_VARIANTS = {
    "dcp_svd_point": dict(model="dcp", emb_nn="dgcnn"),
    "dcp_svd_cycle_pose": dict(model="dcp", emb_nn="dgcnn", cycle=True, loss="pose"),
    "dcp_mlp_cycle_pose": dict(model="dcp", emb_nn="dgcnn", head="mlp", cycle=True, loss="pose"),
    "vcrnet_dgcnn": dict(model="vcrnet", emb_nn="dgcnn"),
}


@pytest.mark.parametrize("variant", sorted(TRAIN_VARIANTS))
def test_train_step_loss_sums_grads_and_batch_stats_match_jax(variant):
    kw = TRAIN_VARIANTS[variant]
    jtr, state, tr, batch = _trainers(**kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, mut = jtr._apply({"params": params, "batch_stats": state.batch_stats},
                              jb["src"], jb["tgt"], train=True)
        fn = jtr._dcp_loss_and_sums if kw["model"] == "dcp" else jtr._vcrnet_loss_and_sums
        loss, sums = fn(out, jb, jb["valid"])
        return loss, (sums, mut)

    (j_loss, (j_sums, mut)), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    got_loss, sums = tr.compute_grads(batch)
    np.testing.assert_allclose(float(got_loss), float(j_loss), rtol=1e-4)
    assert set(sums) == set(j_sums)
    for key in j_sums:
        np.testing.assert_allclose(float(sums[key]), float(j_sums[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    _assert_stats_match(tr.model, mut["batch_stats"])

    want = from_jax_params(jax.device_get(j_grads))
    params = dict(tr.model.named_parameters())
    assert set(params) == set(want)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, p in params.items():
        w = want[name].numpy()
        scale = max(np.abs(w).max(), floor)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * scale, rtol=0, err_msg=name)


def test_dcp_eval_step_matches_jax_and_freezes_running_stats():
    jtr, state, tr, _ = _trainers(model="dcp", emb_nn="dgcnn", cycle=True)
    batch = _batch(jtr.cfg, "test", n_items=3)
    batch["valid"][-1] = 0.0  # a padding row never counts
    want = jtr._eval_step_impl(state, {k: jnp.asarray(v) for k, v in batch.items()})
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    got = tr.eval_step(batch)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert all(torch.equal(v, before[k]) for k, v in tr.model.state_dict().items())


def test_dcp_train_step_updates_parameters_and_running_stats():
    _, _, tr, batch = _trainers(model="dcp", emb_nn="dgcnn")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    sums = tr.train_step(batch)
    assert np.isfinite(float(sums["loss"])) and tr.step == 1
    moved = [k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)  # parameters and buffers alike


def test_dcp_fit_uses_patience_5_and_the_plain_loss(monkeypatch):
    from vcrnet_tpu_torch.data.synthetic import Loader, SyntheticDataset
    from vcrnet_tpu_torch.train import engine

    seen = []
    real = engine.ReduceLROnPlateau
    monkeypatch.setattr(engine, "ReduceLROnPlateau",
                        lambda lr, patience: seen.append(patience) or real(lr, patience=patience))
    cfg = Config(**NARROW, model="dcp", emb_nn="dgcnn", epochs=2)
    tr = Trainer(cfg, device="cpu", seed=0)
    np.random.seed(0)
    train = Loader(SyntheticDataset(cfg, "train", n_items=8, cloud_points=128, kind="shapes"),
                   4, shuffle=True, drop_last=True)
    test = Loader(SyntheticDataset(cfg, "test", n_items=4, cloud_points=128, kind="shapes"), 4)
    history = tr.fit(train, test, log=lambda _: None)
    assert seen == [5] and len(history) == 2
    assert "loss_pose" not in history[-1]["test"] and np.isfinite(history[-1]["test"]["loss"])
    Trainer(Config(**NARROW), device="cpu").fit([], [], epochs=0)
    assert seen == [5, 10]


@pytest.mark.parametrize("kw", [dict(model="dcp", emb_nn="dgcnn", head="mlp"),
                                dict(model="dcp", emb_nn="pointnet"),
                                dict(model="vcrnet", emb_nn="dgcnn")])
def test_init_follows_jax_distributions_for_the_new_modules(kw):
    jcfg = JConfig(**NARROW, **kw)
    jtr = JTrainer(jcfg, mesh=make_mesh(1))
    state = jtr.init_state(jax.random.PRNGKey(0), _batch(jcfg))
    want = from_jax_params(jax.device_get(state.params), jax.device_get(state.batch_stats))
    fresh = Trainer(Config(**NARROW, **kw), device="cpu", seed=3).model
    got = fresh.state_dict()
    assert set(got) == set(want)
    for name, ref in want.items():
        val = got[name]
        if name.endswith(("bias", "b_2", "running_mean")):
            assert torch.equal(val, torch.zeros_like(val)), name
        elif name.endswith(("a_2", "running_var")) or ".bn" in name:
            assert torch.equal(val, torch.ones_like(val)), name
        elif ref.numel() >= 256:  # enough entries for a spread to mean something
            assert 0.8 < float(val.std() / ref.std()) < 1.25, name
            assert float(val.abs().max()) <= 1.3 * float(ref.abs().max()), name
    lpd = Trainer(Config(**NARROW, model="lpd"), device="cpu")  # ported, tests/test_torch_lpd.py
    assert isinstance(lpd.model, LPD) and lpd.model.emb_nn.slope == 0.2
    icp = Trainer(Config(**NARROW, model="icp"), device="cpu")  # tests/test_torch_icp.py
    assert icp.model is None and icp.optimizer is None


@pytest.mark.parametrize("n_iter", [1, 3])
def test_registrar_with_dgcnn_matches_the_jax_registrar(n_iter):
    kw = dict(NARROW, emb_nn="dgcnn", iter=n_iter)
    src, tgt = _clouds(12, b=3)
    jmodel, variables = _jax_model(JVCRNet, JConfig(**kw), src, tgt)
    jreg = JRegistrar(JConfig(**kw), variables, buckets=(1, 4))
    reg = Registrar(Config(**kw), from_jax_params(jax.device_get(variables["params"]),
                                                  jax.device_get(variables["batch_stats"])),
                    buckets=(1, 4), device="cpu")
    want = jreg.register(src, tgt)
    got = reg.register(src, tgt)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, err_msg=key)
    with pytest.raises(RuntimeError, match="Missing key"):
        Registrar(Config(**kw), from_jax_params(jax.device_get(variables["params"])),
                  device="cpu")
