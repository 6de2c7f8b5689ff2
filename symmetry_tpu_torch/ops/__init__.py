"""Tensor ops in PyTorch: RoPE, RMSNorm, attention, sampling, the dense
weight matmul, and the two hand-written CUDA kernels of the serving path
(flash.py, decode_attention.py; sources in ../csrc, built by kernels.py).
Each kernel's plain PyTorch version sits in the same module and runs for
CPU tensors."""
