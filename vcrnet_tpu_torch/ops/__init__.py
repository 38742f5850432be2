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
    fused_knn_gather_max, gather_max_bwd, split_planes,
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


# the kernels with a dk = 64 instance, whose launches are also counted in
# ``.launches_dk64``
HEAD64_KERNELS = {"flash_packed": flash_mha_packed, "flash_bwd": flash_bwd,
                  "softmax_colmass": softmax_colmass}

# the instances that serve --emb_dims 1024 (the forward attention kernels at
# dk = 256, the soft correspondence's kernel for E > 512): their kernel's
# name in ``KERNELS`` and the attribute that also counts their launches
WIDE_KERNELS = {"flash_packed_dk256": ("flash_packed", "launches_dk256"),
                "softmax_colmass_dk256": ("softmax_colmass", "launches_dk256"),
                "vcp_stream_e1024": ("vcp_stream", "launches_e1024")}


def reset_launch_counts() -> None:
    """Zeroes every kernel's launches, the attention kernels' dk = 64
    counts (``.launches_dk64``, counted in ``.launches`` too), the wide
    instances' (``WIDE_KERNELS``, likewise), the edge
    kernel's f32-instance count (``fused_edge_conv.launches_f32``, likewise)
    and its split pass's (``split_planes.launches``, which ``launch_counts``
    leaves out: one a launch of that instance), and the pairs of the int8
    launches (``int8_linear.projections``)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in HEAD64_KERNELS.values():
        fn.launches_dk64 = 0
    for name, attr in WIDE_KERNELS.values():
        setattr(KERNELS[name], attr, 0)
    fused_edge_conv.launches_f32 = 0
    split_planes.launches = 0
    int8_linear.projections = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_counts_dk64() -> dict:
    """The dk = 64 instances' launches, as ``flash_packed_dk64`` etc."""
    return {f"{name}_dk64": fn.launches_dk64 for name, fn in HEAD64_KERNELS.items()}


def launch_counts_wide() -> dict:
    """The wide instances' launches, as ``flash_packed_dk256`` etc."""
    return {wide: getattr(KERNELS[name], attr) for wide, (name, attr) in WIDE_KERNELS.items()}
