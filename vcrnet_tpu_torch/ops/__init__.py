"""Graph ops, LayerNorm and the Hopper kernels with their plain versions.

Importing this package defines the twelve forward kernels as torch ops of
the ``vcrnet_torch`` library (``ops/library.py``), which an exported
serving artifact calls by name. ``ops/flop_meter.py`` collects the
algorithmic FLOPs the kernels report where they launch."""

from vcrnet_tpu_torch.ops.attention import flash_bwd, flash_mha_packed
from vcrnet_tpu_torch.ops.colmass import softmax_colmass
from vcrnet_tpu_torch.ops.dgcnn import fused_dgcnn_eval
from vcrnet_tpu_torch.ops.edgeconv import (
    edge_conv_bwd, edge_conv_from_idx, fused_edge_conv, fused_gather_max_from_idx,
    fused_knn_gather_max, gather_max_bwd,
)
from vcrnet_tpu_torch.ops.int8_linear import int8_linear
from vcrnet_tpu_torch.ops.knn import fused_knn
from vcrnet_tpu_torch.ops.pointer import fused_ff, fused_mha
from vcrnet_tpu_torch.ops.vcp import streaming_soft_correspondence, vcp_bwd

# every kernel wrapper of the port; each counts its launches in .launches
KERNELS = {
    "knn_gather_max": fused_knn_gather_max,
    "edge_conv": fused_edge_conv,
    "flash_packed": flash_mha_packed,
    "vcp_stream": streaming_soft_correspondence,
    "gather_max_bwd": gather_max_bwd,
    "edge_conv_bwd": edge_conv_bwd,
    "flash_bwd": flash_bwd,
    "vcp_bwd": vcp_bwd,
    "gather_max_from_idx": fused_gather_max_from_idx,
    "edge_conv_from_idx": edge_conv_from_idx,
    "softmax_colmass": softmax_colmass,
    "knn": fused_knn,
    "dgcnn_eval": fused_dgcnn_eval,
    "fused_mha": fused_mha,
    "fused_ff": fused_ff,
    "int8_linear": int8_linear,
}


def reset_launch_counts() -> None:
    """Zeroes every kernel's launches, the edge kernel's f32-instance count
    (``fused_edge_conv.launches_f32``, counted in ``.launches`` too) and the
    pairs of the int8 launches (``int8_linear.projections``)."""
    for fn in KERNELS.values():
        fn.launches = 0
    fused_edge_conv.launches_f32 = 0
    int8_linear.projections = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
