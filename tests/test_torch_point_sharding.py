"""The port's point-axis sharding (vcrnet_tpu_torch/parallel/
point_sharding.py, sp_model.py, sp_flagship.py and make_mesh_2d) against
the JAX package's on the CPU, and against the port's single-device model.

The JAX side runs in this process on its virtual CPU devices
(``make_mesh(2)``, ``make_mesh(4)``, ``make_mesh_2d(2, 2)``), jitted as
tests/test_sp_flagship.py runs it. The port's ranks are subprocesses
(``tests/_torch_dp_worker.py``, which imports no JAX) in a Gloo process
group, one job a world (2, 4, and 4 as a 2 x 2 grid with the batch axis
sharded), one torch thread each; every rank is handed the global arrays
and keeps its shard. The weights are the JAX model's init, carried by
``from_jax_params``. Sizes and seeds are the JAX tests' (B 2, N 128,
E 64, ff 128; the partial clouds ``cfg.n_cropped`` = 96 points at overlap
0.575), and so are the tolerances: kNN indices equal, gathers 1e-6,
correspondences 1e-4, embeddings 1e-5, whole R/t 1e-5, the flagship in
whole mode 1e-3 and its partial pairs 1e-4, the pointer 2e-4, gradients
5e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parallel import Ranks
from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.parallel import make_mesh as j_make_mesh
from vcrnet_tpu.parallel.mesh import make_mesh_2d as j_make_mesh_2d
from vcrnet_tpu.parallel import point_sharding as j_ps
from vcrnet_tpu.parallel import sp_flagship as j_spf
from vcrnet_tpu.parallel import sp_model as j_spm
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.models.vcrnet import VCRNet
from vcrnet_tpu_torch.parallel import make_mesh
from vcrnet_tpu_torch.parallel.mesh import make_mesh_2d
from vcrnet_tpu_torch.parallel.sp_flagship import (
    pointer_sp, register_flagship_sp, sp_value_and_grad,
)
from vcrnet_tpu_torch.parallel.sp_model import lpdnet_embed_sp, register_whole_sp
from vcrnet_tpu_torch.utils.params import from_jax_params

B, N, E = 2, 128, 64
K_KNN = 8
CFG = dict(num_points=N, emb_dims=E, ff_dims=128)
PARTIAL = dict(CFG, partial=True, overlap=0.575)
N_PARTIAL = JConfig(**PARTIAL).n_cropped  # 96: a multiple of every point axis here
OVERLAP2 = JConfig(**PARTIAL).overlap2
WORLDS = {"world2": (2, None), "world4": (4, None), "mesh2x2": (4, (2, 2))}
SHARDED = ("src", "tgt", "emb_a", "emb_b", "idx", "psrc", "ptgt", "pemb_a", "pemb_b")


def _data() -> dict:
    """The JAX tests' inputs at B 2, N 128: the flagship's clouds (seed 0),
    the pointer's embeddings (seed 1), the re-mask's (seed 2, after its
    cloud), the partial clouds (seed 3), random neighbour indices (seed 1,
    as test_point_sharding.py's gather test)."""
    f32 = np.float32
    rng = np.random.RandomState(0)
    d = {"src": rng.rand(B, N, 3).astype(f32) - 0.5, "tgt": rng.rand(B, N, 3).astype(f32) - 0.5}
    rng = np.random.RandomState(1)
    d["emb_a"], d["emb_b"] = (rng.randn(B, N, E).astype(f32) for _ in range(2))
    d["idx"] = np.random.RandomState(1).randint(0, N, (B, N, 4)).astype(np.int32)
    rng = np.random.RandomState(2)
    rng.rand(B, N_PARTIAL, 3)
    d["pemb_a"], d["pemb_b"] = (rng.randn(B, N_PARTIAL, E).astype(f32) for _ in range(2))
    rng = np.random.RandomState(3)
    d["psrc"], d["ptgt"] = (rng.rand(B, N_PARTIAL, 3).astype(f32) - 0.5 for _ in range(2))
    d["R_gt"] = np.tile(np.eye(3, dtype=f32), (B, 1, 1))
    d["t_gt"] = np.zeros((B, 3), f32)
    return d


DATA = _data()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    """The JAX model's init (its test's key) and the port's state_dict of it."""
    variables = jax.jit(JVCRNet(cfg=JConfig(**CFG)).init)(
        jax.random.PRNGKey(0), DATA["src"][:1], DATA["tgt"][:1])
    params = jax.device_get(variables["params"])
    return params, from_jax_params(params)


def _model(cfg: dict, state_dict) -> VCRNet:
    model = VCRNet(Config(**cfg), device="cpu")
    model.load_state_dict(state_dict)
    return model


def _point_loss(out, d) -> torch.Tensor:
    R_gt, t_gt = torch.as_tensor(d["R_gt"]), torch.as_tensor(d["t_gt"])
    moved = torch.einsum("bij,bnj->bni", R_gt, out[0]) + t_gt[:, None, :]
    return ((moved - out[1]) ** 2).mean()


@pytest.fixture(scope="module")
def single(weights):
    """The port's single-device model on the whole clouds: the forward in
    whole and partial mode, the pointer with and without the re-mask, the
    point loss's gradients."""
    t = {k: torch.as_tensor(v) for k, v in DATA.items()}
    model, pmodel = _model(CFG, weights[1]), _model(PARTIAL, weights[1])
    with torch.no_grad():
        ref = {"flagship": model(t["src"], t["tgt"])[:4],
               "partial": pmodel(t["psrc"], t["ptgt"])[:4],
               "pointer": model.pointer(t["emb_a"], t["emb_b"]),
               "pointer_remask": pmodel.pointer(t["pemb_a"], t["pemb_b"])}
    loss = _point_loss(model(t["src"], t["tgt"]), DATA)
    loss.backward()
    ref["loss"] = float(loss.detach())
    ref["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
    return ref


def _jax_sp(params, mesh, batch_axis):
    """Every JAX SP function on ``mesh`` in one jitted forward, and
    ``jax.grad(sp_train_loss)`` in whole mode."""
    kw = {"batch_axis": batch_axis} if batch_axis else {}
    heads = dict(kw, n_heads=4, n_blocks=1)
    part = dict(heads, partial_mode=True, overlap2=OVERLAP2)
    d = {k: j_ps.shard_points(jnp.asarray(DATA[k]), mesh, **kw) for k in SHARDED}
    R_gt, t_gt = jnp.asarray(DATA["R_gt"]), jnp.asarray(DATA["t_gt"])

    def forward(p, d):
        return {
            "knn": j_ps.sharded_knn(d["src"], K_KNN, mesh, **kw),
            "gather": j_ps.sharded_gather_neighbors(d["emb_a"], d["idx"], mesh, **kw),
            "corr": j_ps.sharded_soft_correspondence(d["emb_a"], d["emb_b"], d["tgt"], mesh, **kw),
            "embed_0.0": j_spm.lpdnet_embed_sp(p["emb_nn"], d["src"], mesh, **kw),
            "embed_0.2": j_spm.lpdnet_embed_sp(p["emb_nn"], d["src"], mesh, negative_slope=0.2,
                                               **kw),
            "whole": j_spm.register_whole_sp(p, d["src"], d["tgt"], mesh, **kw),
            "flagship": j_spf.register_flagship_sp(p, d["src"], d["tgt"], mesh, **heads),
            "partial": j_spf.register_flagship_sp(p, d["psrc"], d["ptgt"], mesh, **part),
            "pointer": j_spf.pointer_sp(p["pointer"], d["emb_a"], d["emb_b"], mesh, **heads),
            "pointer_remask": j_spf.pointer_sp(p["pointer"], d["pemb_a"], d["pemb_b"], mesh,
                                               **part),
        }

    def loss(p, d):
        return j_spf.sp_train_loss(p, d["src"], d["tgt"], R_gt, t_gt, mesh, **heads)

    out = jax.device_get(jax.jit(forward)(params, d))
    grads = jax.device_get(jax.jit(jax.value_and_grad(loss))(params, d))
    return out, grads


def _sharded(outs, get, grid):
    """The global array of the ranks' shards: rank r holds batch row
    r // n_points and point slice r % n_points of the grid."""
    n_batch, n_points = grid or (1, len(outs))
    return torch.cat([torch.cat([get(outs[row * n_points + col]) for col in range(n_points)], 1)
                      for row in range(n_batch)], 0)


def _replicated(outs, get, grid):
    """A value replicated over the point axis, checked equal on every rank
    of a batch row, with the rows' values concatenated."""
    n_batch, n_points = grid or (1, len(outs))
    rows = []
    for row in range(n_batch):
        vals = [get(outs[row * n_points + col]) for col in range(n_points)]
        for v in vals[1:]:
            assert torch.equal(v, vals[0])
        rows.append(vals[0])
    return torch.cat(rows, 0)


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
def test_sp_functions_match_jax_and_the_single_device_model(world, tmp_path, weights, single):
    n, grid = WORLDS[world]
    params, state_dict = weights
    ranks = Ranks(tmp_path, n, [dict(kind="sp", grid=grid, cfg=CFG, pcfg=PARTIAL,
                                     state_dict=state_dict, data=DATA, k_knn=K_KNN)])
    jmesh = j_make_mesh(n) if grid is None else j_make_mesh_2d(*grid)
    assert jmesh.devices.size == n
    jout, (jloss, jgrads) = _jax_sp(params, jmesh, "batch" if grid else None)
    outs = ranks.task(0)
    assert [(o["batch_rank"], o["point_rank"]) for o in outs] == [
        divmod(r, grid[1]) if grid else (0, r) for r in range(n)]

    def sharded(get):
        return _sharded(outs, get, grid)

    def replicated(get):
        return _replicated(outs, get, grid)

    # the primitives and the embedding
    np.testing.assert_array_equal(sharded(lambda o: o["knn"]).numpy(), jout["knn"])
    _close(sharded(lambda o: o["gather"]), jout["gather"], 1e-6, what="gather")
    _close(sharded(lambda o: o["corr"]), jout["corr"], 1e-4, what="correspondence")
    for slope in ("0.0", "0.2"):
        _close(sharded(lambda o: o[f"embed_{slope}"]), jout[f"embed_{slope}"], 1e-5, 1e-5,
               what=f"embedding at slope {slope}")

    # whole registration with the identity pointer
    corr, R, t = jout["whole"]
    _close(sharded(lambda o: o["whole"][0]), corr, 1e-5, 1e-4, what="whole corr")
    _close(replicated(lambda o: o["whole"][1]), R, 1e-5, what="whole R")
    _close(replicated(lambda o: o["whole"][2]), t, 1e-5, what="whole t")

    # the flagship, whole and partial, against JAX and the single device
    for key, atol in (("flagship", 1e-3), ("partial", 1e-4)):
        got = [replicated(lambda o, i=i: o[key][i]) for i in range(4)]
        for i, what in enumerate(("src_k", "corr", "R", "t")):
            tol = max(atol, 1e-3) if i >= 2 else atol
            _close(got[i], jout[key][i], tol, what=f"{key} {what} against JAX")
            _close(got[i], single[key][i], tol, what=f"{key} {what} against the model")

    # the pointer with and without the re-mask
    for key in ("pointer", "pointer_remask"):
        for i in range(2):
            got = sharded(lambda o, i=i: o[key][i])
            _close(got, jout[key][i], 2e-4, what=f"{key} {i} against JAX")
            _close(got, single[key][i], 2e-4, what=f"{key} {i} against the model")

    # gradients: every rank holds the world's sum, JAX's and the single device's
    losses = [o["grads"][0] for o in outs]
    np.testing.assert_allclose(losses, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(losses, single["loss"], rtol=1e-5)
    grads = outs[0]["grads"][1]
    for o in outs[1:]:
        for k, g in o["grads"][1].items():
            assert torch.equal(g, grads[k]), k
    want_jax = from_jax_params(jgrads)
    assert set(grads) == set(want_jax) == set(single["grads"])
    for k, g in grads.items():
        _close(g, want_jax[k], 5e-4, what=f"grad {k} against JAX")
        _close(g, single["grads"][k], 5e-4, what=f"grad {k} against the model")
    assert sum(float(g.abs().sum()) for g in grads.values()) > 0
    # partial mode: a finite loss and no gradient path to the parameters
    ploss, pgrads = outs[0]["partial_grads"]
    assert np.isfinite(ploss) and all(torch.equal(g, torch.zeros_like(g)) for g in pgrads.values())


def test_world1_mesh_equals_the_model(weights, single):
    """A mesh of this process alone (``make_mesh()``, and ``make_mesh_2d(1)``
    with the batch axis named) runs every function as the single-device
    model: the same forward and gradients to rounding."""
    t = {k: torch.as_tensor(v) for k, v in DATA.items()}
    for mesh, ba in ((make_mesh(), None), (make_mesh_2d(1), "batch")):
        assert mesh.size == 1
        model, pmodel = _model(CFG, weights[1]), _model(PARTIAL, weights[1])
        with torch.no_grad():
            got = register_flagship_sp(model, t["src"], t["tgt"], mesh, ba)
            pgot = register_flagship_sp(pmodel, t["psrc"], t["ptgt"], mesh, ba)
            ptr = pointer_sp(pmodel.pointer, t["pemb_a"], t["pemb_b"], mesh, ba)
        for i in range(4):
            _close(got[i], single["flagship"][i], 1e-6)
            _close(pgot[i], single["partial"][i], 1e-6)
        for i in range(2):
            _close(ptr[i], single["pointer_remask"][i], 1e-6)
        loss, grads = sp_value_and_grad(model, t["src"], t["tgt"], t["R_gt"], t["t_gt"], mesh, ba)
        np.testing.assert_allclose(float(loss), single["loss"], rtol=1e-6)
        for k, g in grads.items():
            _close(g, single["grads"][k], 1e-6, what=k)


def test_whole_sp_equals_the_identity_pointer_model(weights):
    """register_whole_sp on a mesh of this process is the identity-pointer
    VCR-Net's forward (test_point_sharding.py's comparison)."""
    t = {k: torch.as_tensor(v) for k, v in DATA.items()}
    model = _model(dict(CFG, pointer="identity"),
                   {k: v for k, v in weights[1].items() if not k.startswith("pointer.")})
    with torch.no_grad():
        _, corr_ref, R_ref, t_ref, _, _ = model(t["src"], t["tgt"])
        corr, R, tr = register_whole_sp(model, t["src"], t["tgt"], make_mesh())
    _close(corr, corr_ref, 1e-5, 1e-4)
    _close(R, R_ref, 1e-5)
    _close(tr, t_ref, 1e-5)


def test_embed_sp_skips_the_t_nets():
    """Like the JAX function, lpdnet_embed_sp reads LPDNet's convolutions
    alone: on an LPDNet with both T-Nets it computes the embedding of the
    same LPDNet without them, not the model's (ROADMAP C)."""
    torch.manual_seed(0)
    model = VCRNet(Config(**CFG, t3d=True, tfea=True), device="cpu").eval()
    x = torch.as_tensor(DATA["src"])
    with torch.no_grad():
        got = lpdnet_embed_sp(model.emb_nn, x, make_mesh())
        with_t_nets = model.emb_nn(x)[0]
        del model.emb_nn.t_net3d, model.emb_nn.t_net_fea
        without = model.emb_nn(x)[0]
    _close(got, without, 1e-5, 1e-5)
    assert float((got - with_t_nets).abs().max()) > 1e-2


def test_meshes_point_sharding_refuses():
    """A mesh of devices in one process, a batch axis on a 1-D mesh, an
    unknown axis, and a grid other than the world raise ValueError."""
    model = _model(CFG, VCRNet(Config(**CFG), device="cpu").state_dict())
    x = torch.as_tensor(DATA["src"])
    with pytest.raises(ValueError, match="one process per device"):
        register_flagship_sp(model, x, x, make_mesh(devices=["cpu", "cpu"]))
    with pytest.raises(ValueError, match="on a 1-D mesh"):
        lpdnet_embed_sp(model.emb_nn, x, make_mesh(), batch_axis="batch")
    with pytest.raises(ValueError, match="axes are 'batch' and 'data'"):
        lpdnet_embed_sp(model.emb_nn, x, make_mesh_2d(1), batch_axis="data")
    with pytest.raises(ValueError, match="a 2 x 2 mesh in a world of 1"):
        make_mesh_2d(2, 2)
