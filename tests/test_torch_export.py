"""The rest of the serving API against the JAX package's (vcrnet_tpu/serve.py):
``Registrar.warmup`` and ``compiled_buckets``, ``export_bucket`` through
``torch.export``, ``load_exported`` and ``ExportedRegistrar``, and the op
library that lets an exported graph call the kernels (``ops/library.py``).

On the CPU the Registrar takes the kernel route (``use_kernels=True``), so
its forward goes through the ``vcrnet_torch`` ops, whose CPU implementation
is each kernel's plain version: the exported graph holds the same op nodes
as one exported on the card. One port export and one JAX export, in a
module fixture. Tolerance against the JAX artifact: 1e-4 in f32, that of
tests/test_torch_dgcnn_dcp.py::test_registrar_with_dgcnn_matches_the_jax_registrar;
the loaded artifact against the live Registrar: bit for bit."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from vcrnet_tpu.config import Config as JConfig
from vcrnet_tpu.models import VCRNet as JVCRNet
from vcrnet_tpu.serve import Registrar as JRegistrar
from vcrnet_tpu.serve import load_exported as j_load_exported
from vcrnet_tpu_torch import ops
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.ops import (
    attention, colmass, dgcnn, edgeconv, knn, library, pointer, vcp,
)
from vcrnet_tpu_torch.ops.int8_linear import int8_linear_ref
from vcrnet_tpu_torch.serve import ExportedRegistrar, Registrar, load_exported
from vcrnet_tpu_torch.utils.params import from_jax_params

N = 64
KW = dict(num_points=N, emb_dims=64, ff_dims=128, n_heads=2, iter=2)
# the ops of one bucket's forward at iter=2, whole mode (chip_smoke.py's
# LAUNCHES_ITER3 with one refinement pass fewer): the target embedded and
# encoded once, the source's kNN gather-max in pass 1 and its selection
# reused in pass 2, a fresh edge conv each pass, 5 attentions and 1 soft
# correspondence a pass
ITER2_OPS = {"knn_gather_max": 2, "edge_conv": 3, "gather_max_from_idx": 1,
             "flash_packed": 11, "vcp_stream": 2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: these small tensors gain nothing
    from more, and the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, b):
    data = shapes_eval_set(b, num_points=N, cloud_points=2 * N, seed=seed)
    return data["src"], data["tgt"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One JAX Registrar and one port Registrar on the same seeded flax
    weights, each with bucket 2 exported (the port's also to a file)."""
    torch.set_num_threads(1)
    jmodel = JVCRNet(cfg=JConfig(**KW))
    src, _ = _pair(0, 1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), src, src)
    jreg = JRegistrar(JConfig(**KW), variables, buckets=(2, 4))
    state_dict = from_jax_params(jax.device_get(variables["params"]))
    reg = Registrar(Config(**KW), state_dict, buckets=(2, 4), device="cpu", use_kernels=True)
    path = str(tmp_path_factory.mktemp("export") / "bucket2.pt2")
    blob = reg.export_bucket(2, path=path)
    return SimpleNamespace(jreg=jreg, j_blob=jreg.export_bucket(2), state_dict=state_dict,
                           reg=reg, path=path, blob=blob)


def test_warmup_runs_every_bucket(served):
    reg = Registrar(Config(**KW), served.state_dict, buckets=(2, 4), device="cpu",
                    use_kernels=True)
    assert reg.compiled_buckets == []
    reg.warmup()
    assert reg.compiled_buckets == [2, 4]
    with pytest.raises(ValueError, match="not one of"):
        reg.warmup([3])
    reg2 = Registrar(Config(**KW), served.state_dict, buckets=(2, 4), device="cpu")
    reg2.warmup([4])
    assert reg2.compiled_buckets == [4]


def test_buckets_run_once_and_split_large_batches(served):
    reg = Registrar(Config(**KW), served.state_dict, buckets=(2, 4), device="cpu",
                    use_kernels=True)
    src, tgt = _pair(3, 9)  # 9 > top bucket 4
    out = reg.register(src, tgt)
    assert out["R"].shape == (9, 3, 3)
    # chunks of 4, 4, 1 -> buckets {4, 2}; a second call adds none
    assert reg.compiled_buckets == [2, 4]
    reg.register(src[:3], tgt[:3])
    assert reg.compiled_buckets == [2, 4]


def test_export_round_trip_equals_the_live_registrar(served):
    exported = load_exported(served.path)
    assert isinstance(exported, ExportedRegistrar)
    assert (exported.batch, exported.n_points) == (2, N)
    assert exported.device == torch.device("cpu")
    assert len(served.blob) > 1000
    src, tgt = _pair(10, 2)
    live = served.reg.register(src, tgt)
    for loaded in (exported, load_exported(served.blob)):
        out = loaded.register(src, tgt)
        assert set(out) == set(live)
        for key in live:
            np.testing.assert_array_equal(out[key], live[key], err_msg=key)
    with pytest.raises(ValueError, match="takes exactly"):
        exported.register(src[:1], tgt[:1])
    with pytest.raises(ValueError, match="takes exactly"):
        exported.register(src[:, :N - 1], tgt[:, :N - 1])
    with pytest.raises(ValueError, match="not one of"):
        served.reg.export_bucket(3)


def test_exported_graph_calls_each_kernel_as_an_op(served):
    """The exported forward keeps every kernel call as a ``vcrnet_torch``
    node, one per launch of the live forward, none dropped or folded."""
    program = load_exported(served.blob).program
    assert library.op_counts(program.graph) == ITER2_OPS
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not any("vcrnet_torch" in t and not t.endswith(".default") for t in targets)


def test_exported_artifact_matches_the_jax_artifact(served):
    want_fn = j_load_exported(served.j_blob)
    got_fn = load_exported(served.blob)
    src, tgt = _pair(11, 2)
    want = want_fn.register(src, tgt)
    got = got_fn.register(src, tgt)
    assert (got_fn.batch, got_fn.n_points) == (want_fn.batch, want_fn.n_points)
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_net_and_icp_is_not_exportable(served):
    reg = Registrar(Config(**dict(KW, iter=0)), served.state_dict, buckets=(2,),
                    device="cpu", use_kernels=True)
    with pytest.raises(ValueError, match=r"ICP reads its stop on the host.*icp\.py"):
        reg.export_bucket(2)
    src, tgt = _pair(12, 2)
    assert np.isfinite(reg.register(src, tgt)["R"]).all()  # it still serves


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)


def _op_cases():
    """(op name, arguments of the op, the plain version's result on them)."""
    rng = np.random.RandomState(0)
    n, m, c, k = 16, 12, 8, 4
    x = _rand(rng, 1, n, 3)
    vals = _rand(rng, 1, n, c)
    idx = torch.from_numpy(rng.randint(0, n, (1, n, k)).astype(np.int32))
    a, h, w2, b2 = _rand(rng, 1, n, c), _rand(rng, 1, n, c), _rand(rng, c, c), _rand(rng, c)
    q, kv = _rand(rng, 1, n, c), _rand(rng, 1, m, c)
    tgt = _rand(rng, 1, m, 3)
    folded = [(_rand(rng, i, o), _rand(rng, o))
              for i, o in dgcnn.STAGE_WIDTHS + ((dgcnn.CAT_WIDTH, 128),)]
    flat = [t for pair in folded for t in pair]
    mha = [_rand(rng, c, c) if i % 2 == 0 else _rand(rng, c) for i in range(8)]
    ff = [_rand(rng, c, 2 * c), _rand(rng, 2 * c), _rand(rng, 2 * c, c), _rand(rng, c)]
    empty = torch.empty(0, dtype=torch.uint8)
    return [
        ("knn_gather_max", (x, vals, k, True),
         edgeconv.fused_knn_gather_max_ref(x, vals, k, winners=True)),
        ("knn_gather_max", (x, vals, k, False),
         (*edgeconv.fused_knn_gather_max_ref(x, vals, k), empty)),
        ("gather_max_from_idx", (idx, vals, True),
         edgeconv.fused_knn_gather_max_ref(None, vals, idx=idx, winners=True)[::2]),
        ("edge_conv", (x, a, h, w2, b2, k, 0.2, True),
         edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, k, 0.2, winners=True)),
        ("edge_conv", (x, a, h, w2, b2, k, 0.0, False),
         (*edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, k, 0.0), empty, empty)),
        ("edge_conv_from_idx", (idx, a, h, w2, b2, 0.2),
         edgeconv.edge_conv_from_idx_ref(idx, a, h, w2, b2, 0.2)),
        ("flash_packed", (q, kv, kv, 0.3, 2, True, None),
         attention.flash_mha_packed_ref(q, kv, kv, 0.3, 2, True)),
        ("flash_packed", (q, kv, kv, 0.3, 2, False, 10),
         (attention.flash_mha_packed_ref(q, kv, kv, 0.3, 2, nk_valid=10), torch.empty(0))),
        ("vcp_stream", (q, kv, tgt, True),
         vcp.streaming_soft_correspondence_ref(q, kv, tgt, True)),
        ("softmax_colmass", (q, kv, 0.3, 2), colmass.softmax_colmass_ref(q, kv, 0.3, 2)),
        ("knn", (x, k), knn.fused_knn_ref(x, k)),
        ("dgcnn_eval", (x, idx, flat, 128), dgcnn.fused_dgcnn_eval_ref(x, idx, folded, 128)),
        ("fused_mha", (q, kv, *mha, 2), pointer.fused_mha_ref(q, kv, *mha, 2)),
        ("fused_ff", (q, *ff), pointer.fused_ff_ref(q, *ff)),
        ("int8_linear", (q, [mha[0], mha[1]]), [int8_linear_ref(q, mha[0], mha[1])]),
        ("int8_linear", (q.bfloat16(), [ff[0].t().bfloat16(), ff[1].bfloat16()]),
         [int8_linear_ref(q.bfloat16(), ff[0].t().bfloat16(), ff[1].bfloat16())]),
        # q, k and v of one input: one call of three pairs
        ("int8_linear", (q.bfloat16(), [t.bfloat16() for t in mha[:6]]),
         [int8_linear_ref(q.bfloat16(), mha[i].bfloat16(), mha[i + 1].bfloat16())
          for i in (0, 2, 4)]),
    ]


OP_CASES = _op_cases()


def test_the_ops_cover_every_forward_kernel():
    """One op a forward kernel, named as in ops.KERNELS; the four backward
    kernels stay direct extension calls."""
    registered = {name for name, *_ in OP_CASES}
    assert registered == set(ops.KERNELS) - {"gather_max_bwd", "edge_conv_bwd", "flash_bwd",
                                             "vcp_bwd"}
    assert len(registered) == 12
    for name in registered:
        assert hasattr(torch.ops.vcrnet_torch, name)


@pytest.mark.parametrize("case", range(len(OP_CASES)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(OP_CASES)])
def test_each_op_passes_opcheck_and_equals_its_plain_version(case):
    name, args, want = OP_CASES[case]
    op = getattr(torch.ops.vcrnet_torch, name).default
    torch.library.opcheck(op, args)
    got = op(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
