"""PyTorch/CUDA port of vcrnet_tpu for NVIDIA Hopper (H100)."""
