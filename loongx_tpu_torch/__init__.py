"""loongx_tpu_torch: the PyTorch/CUDA port of loongx_tpu for NVIDIA Hopper
(H100), a framework for neural-driven image editing.

It holds the JAX package's modules but the XLA compile cache: the FLUX.1
DiT conditioned on condition-image tokens and on EEG / fNIRS / PPG / motion
signals (CS3 encoders, DGF fusion), the VAE, T5 and CLIP text encoders,
`generate()` and the deployed ``neural_edit``, QLoRA training from a YAML
config, evaluation and the Depth-Anything estimator, the speech path
(Whisper ASR, Marian zh->en) and the demos, their checkpoints and CLIs,
multi-GPU serving over a data x tensor layout of processes
(``parallel/``) and the profiling utilities.
The hot path runs on a CUDA device through hand-written sm_90a kernels
(``csrc/``): the flash-attention forward (bf16 and int8 QK^T scores) and
backward, the int8 quant-matmuls (W8A8 and weight-only, stacked, fused-qkv,
flat and transposed, with their fused LN + adaLN prologue and gate +
residual epilogue forms) and the S4D recurrence scan.  Every kernel wrapper
runs its plain PyTorch version on CPU tensors and launches its kernel on
CUDA tensors.  This package imports neither JAX nor ``loongx_tpu``.
"""

__version__ = "0.1.0"

from loongx_tpu_torch.config import Config, load_config  # noqa: F401


def __getattr__(name):
    # lazy top-level API (keeps `import loongx_tpu_torch` light)
    if name == "LoongXPipeline":
        from loongx_tpu_torch.models.pipeline import LoongXPipeline

        return LoongXPipeline
    if name == "generate":
        from loongx_tpu_torch.sampling.generate import generate

        return generate
    if name == "Condition":
        from loongx_tpu_torch.sampling.condition import Condition

        return Condition
    raise AttributeError(f"module 'loongx_tpu_torch' has no attribute {name!r}")
