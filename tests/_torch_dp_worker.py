"""One rank of the port's data-parallel and point-sharding tests
(tests/test_torch_parallel.py, tests/test_torch_point_sharding.py).

    python tests/_torch_dp_worker.py STORE RANK WORLD JOB OUT

joins a Gloo process group of WORLD ranks through the FileStore at STORE,
runs the tasks of the job file JOB (``torch.save`` of a list of dicts) on
the CPU, one torch thread, and writes one result per task to OUT. It
imports no JAX: a finder on ``sys.meta_path`` refuses it.
"""

import importlib.abc
import os
import sys
from datetime import timedelta


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "vcrnet_tpu"):
            raise ImportError(f"a data-parallel rank imports no {name}")
        return None


sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vcrnet_tpu_torch.config import Config  # noqa: E402
from vcrnet_tpu_torch.parallel import initialize, make_mesh  # noqa: E402
from vcrnet_tpu_torch.train import Trainer  # noqa: E402


def _trainer(task) -> Trainer:
    tr = Trainer(Config(**task["cfg"]), device="cpu")
    if task.get("state_dict") is not None:
        tr.model.load_state_dict(task["state_dict"])
    return tr


def _state(tr) -> dict:
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def _floats(sums: dict) -> dict:
    return {k: float(v) for k, v in sums.items()}


def sp(task) -> dict:
    """Every point-sharded function on this rank's shards of the global
    arrays in ``task["data"]``, over ``make_mesh()`` or, with
    ``task["grid"]``, ``make_mesh_2d(*grid)`` with the batch axis sharded:
    the outputs (this rank's shards, or the replicated values) and the
    gradients of ``sp_value_and_grad``, of the model of ``task["cfg"]`` and
    of its partial-mode twin of ``task["pcfg"]`` (the same weights); the
    embedding also through an LPDNet at the slope 0.2 with its weights."""
    from vcrnet_tpu_torch.models.embeddings import LPDNet
    from vcrnet_tpu_torch.models.vcrnet import VCRNet
    from vcrnet_tpu_torch.parallel.mesh import make_mesh_2d
    from vcrnet_tpu_torch.parallel.point_sharding import (
        batch_mesh, point_mesh, shard_points, sharded_gather_neighbors, sharded_knn,
        sharded_soft_correspondence,
    )
    from vcrnet_tpu_torch.parallel.sp_flagship import (
        pointer_sp, register_flagship_sp, sp_value_and_grad,
    )
    from vcrnet_tpu_torch.parallel.sp_model import lpdnet_embed_sp, register_whole_sp

    grid = task.get("grid")
    mesh = make_mesh_2d(*grid) if grid else make_mesh()
    ba = "batch" if grid else None
    pm, bm = point_mesh(mesh, ba), batch_mesh(mesh, ba)
    d = task["data"]

    def shard(name):
        return shard_points(d[name], mesh, ba, device="cpu")

    def rows(name):  # this rank's batch rows of a [B, ...] array
        x = torch.as_tensor(d[name])
        if bm is None:
            return x
        per = x.shape[0] // bm.size
        return x[bm.rank * per:(bm.rank + 1) * per]

    def model_of(cfg):
        model = VCRNet(Config(**cfg), device="cpu")
        model.load_state_dict(task["state_dict"])
        return model

    model, pmodel = model_of(task["cfg"]), model_of(task["pcfg"])
    emb_02 = LPDNet(model.cfg.emb_dims, model.emb_nn.k, negative_slope=0.2)
    emb_02.load_state_dict(model.emb_nn.state_dict())
    out = {"point_rank": pm.rank, "batch_rank": bm.rank if bm else 0}
    with torch.no_grad():
        src, tgt = shard("src"), shard("tgt")
        out["knn"] = sharded_knn(src, task["k_knn"], mesh, ba)
        out["gather"] = sharded_gather_neighbors(shard("emb_a"), shard("idx"), mesh, ba)
        out["corr"] = sharded_soft_correspondence(shard("emb_a"), shard("emb_b"), tgt, mesh, ba)
        for slope, emb in ((0.0, model.emb_nn), (0.2, emb_02)):
            out[f"embed_{slope}"] = lpdnet_embed_sp(emb, src, mesh, ba)
        out["whole"] = register_whole_sp(model, src, tgt, mesh, ba)
        out["flagship"] = register_flagship_sp(model, src, tgt, mesh, ba)
        out["partial"] = register_flagship_sp(pmodel, shard("psrc"), shard("ptgt"), mesh, ba)
        out["pointer"] = pointer_sp(model.pointer, shard("emb_a"), shard("emb_b"), mesh, ba)
        out["pointer_remask"] = pointer_sp(pmodel.pointer, shard("pemb_a"), shard("pemb_b"), mesh,
                                           ba)
    for name, m, s_, t_ in (("grads", model, "src", "tgt"), ("partial_grads", pmodel, "psrc", "ptgt")):
        loss, grads = sp_value_and_grad(m, shard(s_), shard(t_), rows("R_gt"), rows("t_gt"), mesh,
                                        ba)
        out[name] = (float(loss), {k: g.clone() for k, g in grads.items()})
    return out


def run(task) -> dict:
    kind = task["kind"]
    if kind == "sp":
        return sp(task)
    if kind == "step":  # gradients after the all-reduce, then an SGD step
        tr = _trainer(task)
        loss, sums = tr.compute_grads(task["batch"])
        grads = {k: p.grad.detach().clone() for k, p in tr.model.named_parameters()}
        tr.optimizer.step()
        return {"loss": float(loss), "sums": _floats(sums), "grads": grads,
                "state": _state(tr)}
    if kind == "raw":  # an epoch of raw-cloud batches through stage and prefetch
        tr = _trainer(task)
        summary = tr.train_epoch_raw(task["batches"])
        return {"summary": summary, "state": _state(tr)}
    if kind == "eval":
        tr = _trainer(task)
        summary = tr.eval_epoch(task["batches"])
        worst = tr.worst_cases(task["batches"], k=task["k"])
        return {"summary": summary, "worst": worst}
    if kind == "fit":
        tr = _trainer(task)
        logged = []
        history = tr.fit(task["train"], task["test"], epochs=task["epochs"],
                         log=logged.append, checkpoint_dir=task["dir"])
        return {"history": history, "logged": logged, "state": _state(tr),
                "files": sorted(os.listdir(task["dir"]))}
    if kind == "refusals":  # a mesh other than the world size
        out = []
        for make in (lambda: Trainer(Config(**task["cfg"]), device="cpu"),
                     lambda: make_mesh(task["cfg"]["mesh_shape"])):
            try:
                make()
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        return {"errors": out}
    raise ValueError(f"unknown task {kind}")


def main(store, rank, world, job, out) -> None:
    torch.set_num_threads(1)
    initialize(init_method=f"file://{store}", rank=int(rank), world_size=int(world),
               backend="gloo", timeout=timedelta(seconds=60))
    results = [run(task) for task in torch.load(job, weights_only=False)]
    mesh = make_mesh()
    results.append({"rank": mesh.rank, "size": mesh.size,
                    "jax_loaded": any(m.split(".")[0] == "jax" for m in sys.modules)})
    torch.save(results, out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
