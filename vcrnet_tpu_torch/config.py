"""Experiment configuration (a copy of vcrnet_tpu/config.py, so the port
imports nothing of the JAX package).

Mirrors the reference CLI surface (reference util/initPara.py:129-199, 27 flags)
as a typed dataclass, including the derived quantities the reference computes at
bootstrap: the ``overlap -> reserve`` cubic solve (initPara.py:110-124) and the
static top-k sizes that the partial-overlap machinery needs at trace time.

The reference solves the reserve cubic with sympy; here it is a plain
``numpy.roots`` call on the expanded polynomial — no symbolic algebra needed,
and the result is bit-identical for the published configs (overlap=0.575 ->
reserve=0.75, overlap2~=0.7667).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def solve_reserve(overlap: float) -> float:
    """Solve the expected-overlap equation for the crop ``reserve`` ratio.

    The reference crops ``(1-reserve)`` of both clouds around random seed
    points; the expected overlap of the two crops (relative to the original
    cloud) is a cubic function of the cut fraction ``n = 1-reserve``. Given a
    target expected overlap, solve for ``n`` and return ``reserve = 1-n``
    (reference util/initPara.py:110-124).

    The equation, with n the cut fraction:
        a = (n - 3/2 n^2)(1 - 2n)
        b = 1/2 (n-1)^2 n - 1/6 (1-n)^3 + 1/6 (1-2n)^3
        ((a+b)*2 + (1-2n)^3) / (1-n)^2 = overlap
    """
    P = np.polynomial.Polynomial
    n = P([0.0, 1.0])
    a = (n - 1.5 * n**2) * (1.0 - 2.0 * n)
    b = (
        0.5 * (n - 1.0) ** 2 * n
        - (1.0 / 6.0) * (1.0 - n) ** 3
        + (1.0 / 6.0) * (1.0 - 2.0 * n) ** 3
    )
    f = (a + b) * 2.0 + (1.0 - 2.0 * n) ** 3 - overlap * (1.0 - n) ** 2
    for r in f.roots():
        if abs(r.imag) < 1e-9 and 0.0 <= r.real <= 0.5:
            return float(1.0 - r.real)
    raise ValueError(f"no valid reserve root for overlap={overlap}")


@dataclasses.dataclass(frozen=True)
class Config:
    """All experiment knobs. Field names match the reference CLI flags."""

    # model dispatch
    model: str = "vcrnet"  # vcrnet | dcp | lpd | icp
    eval: bool = False

    # architecture
    emb_nn: str = "lpdnet"  # pointnet | dgcnn | lpdnet
    pointer: str = "transformer"  # identity | transformer
    vcp_nn: str = "topK"  # topK | att | dist
    head: str = "svd"  # svd | mlp (dcp only)
    emb_dims: int = 512
    ff_dims: int = 1024
    n_blocks: int = 1
    n_heads: int = 4
    dropout: float = 0.0
    t3d: bool = False
    tfea: bool = False

    # task / data
    dataset: str = "modelnet40"  # modelnet40 | kitti
    num_points: int = 1024
    partial: bool = False
    overlap: float = 0.75
    gaussian_noise: bool = False
    unseen: bool = False
    factor: float = 4.0  # rotations drawn from [0, pi/factor]
    data_dir: Optional[str] = None

    # training
    batch_size: int = 8
    test_batch_size: int = 24
    lr: float = 1e-3
    use_sgd: bool = False
    momentum: float = 0.9
    weight_decay: float = 1e-4
    epochs: int = 200
    loss: str = "point"  # point | pose | mixed
    cycle: bool = False
    seed: int = 1234

    # eval-time refinement
    iter: int = 1  # >0: iterative net refinement; 0: net + ICP refinement
    max_iterations: int = 50  # ICP iterations

    # bookkeeping
    exp_name: str = "exp"
    model_path: str = ""

    # beyond the reference CLI (the JAX package's own knobs)
    compute_dtype: str = "float32"  # float32 | bfloat16 for matmul-heavy paths
    approx_knn: bool = False  # ignored: every kNN selection of the port is
    # exact (ROADMAP C, "Exact f32 selection")
    int8_eval: bool = False  # dynamic-int8 pointer projections at eval in the
    # JAX package; not ported yet (ROADMAP A10): the models refuse it with
    # compute_dtype="bfloat16", where the JAX package would act on it, and
    # accept it with float32, where it changes nothing there either
    int8_train_gathers: bool = True  # ignored: the edge-conv and gather-max
    # kernels gather the exact bf16 rows by index in training and eval alike
    # (ROADMAP C, "Exact gathers")
    reuse_feature_knn: bool = False  # eval refinement: reuse a previous
    # iteration's FEATURE-space kNN selection in later iterations
    # (vcrnet_iter). Unlike the always-on spatial-kNN reuse (exact: rigid
    # transforms preserve distances) this is an APPROXIMATION: pointwise
    # features are not rigid-invariant, so it stays opt-in.
    feature_knn_refresh: int = 1  # with reuse_feature_knn: how many leading
    # refinement iterations compute a FRESH feature graph; later iterations
    # reuse the last one. 1 = reuse iteration 1's graph everywhere; 2 =
    # recompute once more on the near-aligned iteration-2 cloud and reuse
    # only for iterations 3+.
    refine_subsample: int = 0  # eval refinement (whole mode only): run
    # iterations 2+ on the first `refine_subsample` points of each cloud.
    # Keep OFF: LPDNet is density-sensitive (its k=20 kNN neighbourhoods
    # widen when the cloud shrinks), so the subsampled iterations run the
    # embedding out of distribution. 0 = off; values >= num_points are
    # clamped to exact.
    streaming_vcp_train: bool = True  # training with the kernels: route the
    # soft correspondence through the streaming pair csrc/vcp_stream.cu
    # (forward, with the row logsumexp) and csrc/vcp_bwd.cu (backward)
    # instead of the plain formulation that writes the [B, Ns, Nt]
    # probabilities out; the same math, kept as the control arm
    remat: bool = False  # training: recompute the embedding and pointer
    # activations in the backward; not ported yet (the models refuse it)
    mesh_shape: Optional[int] = None  # data-parallel devices; ignored: the
    # port runs on one device (ROADMAP A9)

    # ---- derived (computed in __post_init__) ----
    reserve: float = dataclasses.field(init=False, default=1.0)
    overlap2: float = dataclasses.field(init=False, default=1.0)

    def __post_init__(self):
        reserve = solve_reserve(self.overlap) if self.partial else 1.0
        object.__setattr__(self, "reserve", reserve)
        object.__setattr__(self, "overlap2", self.overlap / reserve)

    # ---- static top-k sizes for the partial-overlap machinery ----
    # All are functions of static config only, so every select is a
    # fixed-shape top_k + gather under jit (reference materialised
    # variable-length subsets instead: model/vcrnet_model.py:208-209,284).

    @property
    def n_cropped(self) -> int:
        """Points per cloud after the partial crop (= model input N)."""
        n = int(self.num_points * self.reserve) if self.partial else self.num_points
        return n

    @property
    def select_k(self) -> int:
        """Overlap-candidate count kept by VcpTopK.selectCom.

        reference model/vcrnet_model.py:208-209: int(N * 0.84 * overlap2).
        """
        return int(self.n_cropped * 0.84 * self.overlap2)

    @property
    def pair_k(self) -> int:
        """Final correspondence count kept by VcpTopK.getCopair.

        reference model/vcrnet_model.py:284: int(num_src * 0.52 * overlap2)
        where num_src = select_k.
        """
        return int(self.select_k * 0.52 * self.overlap2)

    @property
    def attn_mask_k(self) -> int:
        """Keys kept by the partial-overlap attention re-mask.

        reference model/transformer.py:41: int(num_key * overlap2).
        """
        return int(self.n_cropped * self.overlap2)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
