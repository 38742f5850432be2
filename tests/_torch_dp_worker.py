"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

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


def run(task) -> dict:
    kind = task["kind"]
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
