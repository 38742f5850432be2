"""Graph ops, LayerNorm and the Hopper kernels with their plain versions."""

from vcrnet_tpu_torch.ops.attention import flash_mha_packed
from vcrnet_tpu_torch.ops.edgeconv import fused_edge_conv, fused_knn_gather_max
from vcrnet_tpu_torch.ops.vcp import streaming_soft_correspondence

# every kernel wrapper of the port; each counts its launches in .launches
KERNELS = {
    "knn_gather_max": fused_knn_gather_max,
    "edge_conv": fused_edge_conv,
    "flash_packed": flash_mha_packed,
    "vcp_stream": streaming_soft_correspondence,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
