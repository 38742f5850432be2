"""Point-axis (sequence-parallel) sharded primitives (counterpart of
vcrnet_tpu/parallel/point_sharding.py).

The JAX package splits the POINT axis of a cloud over a mesh with
``shard_map``, so that clouds far beyond one device's memory register: each
device owns N/D points, keys and values are all-gathered, and every
O(N^2/D) score block stays with the query shard that owns it. Here a mesh
member is a process of a ``torch.distributed`` group (``make_mesh()``, or
the point rows of ``make_mesh_2d``), and a function takes and returns the
rank's own shard: PyTorch has no global array (``shard_points`` cuts it).
Every collective is ``Mesh.all_gather`` or an all-reduce, which both
backends take on a CUDA tensor; ``parallel/mesh.py`` states how the
gradients cross the ranks.

The local bodies are plain PyTorch, as the JAX package's are XLA ops: no
Pallas kernel lies on this path, so no hand-written kernel does either.
kNN selects by the stable descending sort of ``ops/_common.select_topk``,
``lax.top_k``'s rule (ties to the smaller column).
"""

from __future__ import annotations

import torch

from vcrnet_tpu_torch.ops._common import select_topk
from vcrnet_tpu_torch.ops.graph import gather_neighbors, neg_pairwise_sqdist
from vcrnet_tpu_torch.parallel.mesh import Mesh, Mesh2D
from vcrnet_tpu_torch.utils.device import resolve_device


def point_mesh(mesh, batch_axis: str | None = None) -> Mesh:
    """The group the point axis is sharded over: a 1-D group mesh itself,
    or this rank's row of a :class:`Mesh2D`. ``batch_axis`` must be None on
    a 1-D mesh and None or "batch" on a 2-D one. A mesh of several devices
    in one process is refused: point sharding runs one process a device."""
    if isinstance(mesh, Mesh2D):
        if batch_axis not in (None, "batch"):
            raise ValueError(f"batch_axis={batch_axis!r}: a 2-D mesh's axes are 'batch' and 'data'")
        return mesh.points
    if batch_axis is not None:
        raise ValueError(f"batch_axis={batch_axis!r} on a 1-D mesh (make_mesh_2d makes one)")
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"a mesh of {mesh.size} devices in one process: point sharding runs one "
                         f"process per device (torchrun --nproc_per_node {mesh.size})")
    return mesh


def batch_mesh(mesh, batch_axis: str | None = None) -> Mesh | None:
    """The group the batch axis is sharded over, None where it is whole."""
    point_mesh(mesh, batch_axis)
    return mesh.batch if batch_axis is not None else None


def world_mesh(mesh) -> Mesh:
    """Every rank of ``mesh``."""
    return mesh.world if isinstance(mesh, Mesh2D) else mesh


def shard_points(x, mesh, batch_axis: str | None = None, device=None) -> torch.Tensor:
    """This rank's shard of a global [B, N, C] array or tensor: its N/D
    points (its batch rows' B/n_batch too, with ``batch_axis`` on a 2-D
    mesh), as a tensor on ``device`` (default the current CUDA device,
    raising where there is none). The axes it splits must divide."""
    pm = point_mesh(mesh, batch_axis)
    x = torch.as_tensor(x)
    b, n = x.shape[0], x.shape[1]
    if n % pm.size:
        raise ValueError(f"{n} points do not divide the {pm.size} shards of the point axis")
    per = n // pm.size
    x = x[:, pm.rank * per:(pm.rank + 1) * per]
    bm = batch_mesh(mesh, batch_axis)
    if bm is not None:
        if b % bm.size:
            raise ValueError(f"batch {b} does not divide the {bm.size} rows of the mesh")
        rows = b // bm.size
        x = x[bm.rank * rows:(bm.rank + 1) * rows]
    return x.to(resolve_device(device))


def local_knn(queries: torch.Tensor, keys_full: torch.Tensor, k: int, pm: Mesh) -> torch.Tensor:
    """The k nearest keys of a local query shard [B, n_local, C] among the
    gathered keys [B, N, C], self excluded (local row r is global row
    rank * n_local + r): GLOBAL indices [B, n_local, k], int32."""
    with torch.no_grad():
        scores = neg_pairwise_sqdist(queries, keys_full)  # [B, n_local, N]
        n_local = queries.shape[1]
        rows = torch.arange(n_local, device=scores.device) + pm.rank * n_local
        self_mask = rows[:, None] == torch.arange(scores.shape[2], device=scores.device)
        return select_topk(scores.masked_fill(self_mask, float("-inf")), k)


def sharded_knn(x: torch.Tensor, k: int, mesh, batch_axis: str | None = None) -> torch.Tensor:
    """kNN over a point-sharded cloud: this rank's x [B, N/D, C] -> the
    GLOBAL neighbour indices [B, N/D, k] of its points."""
    pm = point_mesh(mesh, batch_axis)
    return local_knn(x, pm.all_gather(x.detach(), 1), k, pm)


def sharded_gather_neighbors(feats: torch.Tensor, idx: torch.Tensor, mesh,
                             batch_axis: str | None = None) -> torch.Tensor:
    """Neighbour features across shards: this rank's feats [B, N/D, C] and
    GLOBAL idx [B, N/D, k] -> [B, N/D, k, C]."""
    pm = point_mesh(mesh, batch_axis)
    return gather_neighbors(pm.all_gather(feats, 1), idx)


def sharded_soft_correspondence(src_emb: torch.Tensor, tgt_emb: torch.Tensor, tgt: torch.Tensor,
                                mesh, batch_axis: str | None = None) -> torch.Tensor:
    """Whole-mode virtual correspondences of this rank's source points: the
    softmax over ALL target points of -|e_i - f_j|^2 against the gathered
    target embeddings, times the gathered target points -> [B, Ns/D, 3]."""
    pm = point_mesh(mesh, batch_axis)
    te_full = pm.all_gather(tgt_emb, 1)
    tg_full = pm.all_gather(tgt.float(), 1)
    scores = torch.softmax(neg_pairwise_sqdist(src_emb, te_full), dim=2)
    return torch.matmul(scores, tg_full)
