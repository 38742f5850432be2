"""Build and load the CUDA extension that holds the port's Hopper kernels.

The sources live in ``vcrnet_tpu_torch/csrc/``. ``extension()`` compiles
them with ``torch.utils.cpp_extension.load`` at first use (one call, all
sources, ``sm_90a``) into ``build/torch_kernels/`` beside the package, and
caches the loaded module for the process. Only ``bindings.cpp`` includes
PyTorch's headers; the ``.cu`` files have a plain C++ interface so ``nvcc``
stays fast. A build failure raises: there is no fallback to the plain
PyTorch versions on a CUDA tensor.

Nothing here runs at import time, so the CPU test suite (no ``nvcc``, no
card) imports every module freely.
"""

from __future__ import annotations

import functools
import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SOURCES = (
    "bindings.cpp",
    "knn_gather_max.cu",
    "edge_conv.cu",
    "flash_packed.cu",
    "vcp_stream.cu",
    "gather_max_bwd.cu",
    "edge_conv_bwd.cu",
    "flash_bwd.cu",
    "vcp_bwd.cu",
    "gather_max_from_idx.cu",
    "edge_conv_from_idx.cu",
    "colmass.cu",
    "knn.cu",
    "dgcnn_eval.cu",
    "pointer_mha.cu",
    "pointer_ff.cu",
)
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")


@functools.lru_cache(maxsize=None)
def extension():
    """The loaded extension, compiled on first call."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)  # load() does not create it
    return load(
        name="vcrnet_tpu_torch_kernels",
        sources=[os.path.join(CSRC_DIR, s) for s in SOURCES],
        build_directory=BUILD_DIR,
        extra_cflags=["-O2"],
        extra_cuda_cflags=list(CUDA_FLAGS),
    )
