"""Tensor ops of the port: torch-exact batch norm, the reference's initializers,
the hand-written CUDA kernels with their plain PyTorch versions (``fused``), and
the float32 precision policy (:func:`ieee_float32`)."""

import contextlib

import torch


@contextlib.contextmanager
def ieee_float32():
    """cuDNN convolutions and cuBLAS matmuls in IEEE float32 for the duration,
    whatever the process-wide defaults (PyTorch's convolutions default to TF32,
    10 mantissa bits); restored after. Autograd runs a backward later, outside a
    forward's context, so a float32 train step holds this around its backward
    and double-backward calls too (``train.step``)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
