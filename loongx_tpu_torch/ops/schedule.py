"""Flow-match Euler schedule (counterpart of ``loongx_tpu/ops/schedule.py``):
FLUX.1-dev constants, dynamic exponential time shift, trailing sigma 0, the
static shift of HiDream-I1-Dev, and the training interpolant."""

from __future__ import annotations

import numpy as np
import torch


def calculate_shift(image_seq_len: int, base_seq_len: int = 256,
                    max_seq_len: int = 4096, base_shift: float = 0.5,
                    max_shift: float = 1.15) -> float:
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma: float, t: np.ndarray) -> np.ndarray:
    """Exponential dynamic shifting: t -> e^mu / (e^mu + (1/t - 1)^sigma)."""
    return np.exp(mu) / (np.exp(mu) + (1.0 / t - 1.0) ** sigma)


def flux_sigmas(num_steps: int, image_seq_len: int, base_seq_len: int = 256,
                max_seq_len: int = 4096, base_shift: float = 0.5,
                max_shift: float = 1.15,
                use_dynamic_shifting: bool = True) -> np.ndarray:
    """float32 numpy [num_steps + 1]: linspace(1, 1/n, n) shifted by
    mu(image_seq_len), with sigma_n = 0 appended (host-side precompute)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    if use_dynamic_shifting:
        mu = calculate_shift(image_seq_len, base_seq_len, max_seq_len,
                             base_shift, max_shift)
        sigmas = time_shift(mu, 1.0, sigmas)
    return np.append(sigmas, 0.0).astype(np.float32)


def static_shift_sigmas(num_steps: int, shift: float = 6.0) -> np.ndarray:
    """float32 numpy [num_steps + 1]: shift s / (1 + (shift - 1) s) over s
    = linspace(1, 0, num_steps + 1) (HiDream-I1-Dev's static shift 6 on a
    plain grid; its last sigma is 0)."""
    s = np.linspace(1.0, 0.0, num_steps + 1)
    return (shift * s / (1.0 + (shift - 1.0) * s)).astype(np.float32)


def euler_step(latents: torch.Tensor, model_output: torch.Tensor,
               sigma: float, sigma_next: float) -> torch.Tensor:
    """x <- x + (sigma_next - sigma) * v in float32, cast to the latent dtype.
    The sigmas are float32 scalars, their difference taken in float32."""
    dt = np.float32(sigma_next) - np.float32(sigma)
    out = latents.float() + float(dt) * model_output.float()
    return out.to(latents.dtype)


def flow_match_xt(x0: torch.Tensor, x1: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """Training-time interpolant x_t = (1 - t) x0 + t x1, t [B]."""
    t = t.reshape(t.shape[0], *([1] * (x0.ndim - 1)))
    return (1.0 - t) * x0 + t * x1
