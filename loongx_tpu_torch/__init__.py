"""PyTorch/CUDA port of loongx_tpu for NVIDIA Hopper (H100).

The deployed neural edit (``sampling.generate.neural_edit``) runs here on a
CUDA device through hand-written kernels (``csrc/``): flash-attention forward
and the int8 quant-matmul forwards.  Every kernel wrapper runs its plain
PyTorch version on CPU tensors and launches its kernel on CUDA tensors.
This package imports neither JAX nor ``loongx_tpu``.
"""
