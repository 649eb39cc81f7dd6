"""Tensor ops of the port: torch-exact batch norm, the reference's initializers,
and the hand-written CUDA kernels with their plain PyTorch versions (``fused``)."""
