"""The float32 precision the port runs and is checked under.

PyTorch's defaults leave cuDNN free to run float32 convolutions in TF32
(``torch.backends.cudnn.allow_tf32`` is True; cuBLAS float32 matmuls are
already full float32).  The port's float32 convolutions (the depth
estimator's DINOv2 + DPT, Whisper's frontend, the VAE under a float32
training config) are held to the CPU within 1e-4 of their largest value,
which TF32's 10-bit mantissa does not meet (``scripts/precision_check.py``
measures both settings on the card).  Every entry point calls
`set_precision` before it builds or loads a model, and so does
``chip_smoke.py``, so that what runs and what is checked cannot drift
apart.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full float32 on the card: TF32 off for cuBLAS matmuls and for cuDNN
    convolutions (process-wide; no effect on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
