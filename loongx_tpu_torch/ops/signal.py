"""Biosignal preprocessing on ``torch.fft`` (counterpart of
``loongx_tpu/ops/signal.py``): windowing, normalisation and spectral
filtering on the signals' device, ahead of the CS3 encoders.

Every op takes [..., C, L] tensors and computes in float32, as the JAX
package does: ``zscore`` divides by the population standard deviation
(``correction=0``, ``jnp.std``'s), ``detrend`` fits its slope against
``linspace(-1, 1, L)``, and ``band_powers`` builds its band masks on the
host from numpy's ``rfftfreq``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def zscore(x: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """Per-channel standardisation."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    std = xf.std(dim=dim, keepdim=True, correction=0)
    return ((xf - mean) / (std + eps)).to(x.dtype)


def detrend(x: torch.Tensor) -> torch.Tensor:
    """Remove the per-channel mean and linear trend (least squares against
    a ramp over [-1, 1])."""
    xf = x.float()
    t = torch.linspace(-1.0, 1.0, x.shape[-1], device=x.device)
    slope = (xf * t).sum(dim=-1, keepdim=True) / (t * t).sum()
    mean = xf.mean(dim=-1, keepdim=True)
    return (xf - mean - slope * t).to(x.dtype)


def _rfft_filter(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    length = x.shape[-1]
    spec = torch.fft.rfft(x.float(), dim=-1)
    return torch.fft.irfft(spec * keep, n=length, dim=-1).to(x.dtype)


def _rfftfreq(length: int, fs: float, device) -> torch.Tensor:
    return torch.fft.rfftfreq(length, 1.0 / fs, device=device)


def bandpass_fft(x: torch.Tensor, low_hz: float, high_hz: float,
                 fs: float) -> torch.Tensor:
    """Brick-wall FFT bandpass along the last axis."""
    freqs = _rfftfreq(x.shape[-1], fs, x.device)
    return _rfft_filter(x, (freqs >= low_hz) & (freqs <= high_hz))


def notch_fft(x: torch.Tensor, notch_hz: float, fs: float,
              width_hz: float = 1.0) -> torch.Tensor:
    """FFT notch (mains-hum removal, e.g. 50/60 Hz)."""
    freqs = _rfftfreq(x.shape[-1], fs, x.device)
    return _rfft_filter(x, (freqs - notch_hz).abs() > width_hz / 2)


def hann_window(length: int, device="cuda") -> torch.Tensor:
    """The periodic Hann window 0.5 - 0.5 cos(2 pi n / length), float32."""
    n = torch.arange(length, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / length)


def stft_power(x: torch.Tensor, frame: int = 256, hop: int = 128
               ) -> torch.Tensor:
    """Windowed short-time power spectrum: [..., C, L] -> [..., C, n_frames,
    frame // 2 + 1], float32."""
    n_frames = max(1, (x.shape[-1] - frame) // hop + 1)
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame, device=x.device)[None, :])
    frames = x.float()[..., idx] * hann_window(frame, x.device)
    return torch.fft.rfft(frames, dim=-1).abs() ** 2


def band_powers(x: torch.Tensor, fs: float,
                bands: Tuple[Tuple[float, float], ...] = (
                    (0.5, 4.0), (4.0, 8.0), (8.0, 13.0), (13.0, 30.0),
                    (30.0, 100.0)),
                ) -> torch.Tensor:
    """Mean per-band log-power (delta/theta/alpha/beta/gamma by default):
    [..., C, L] -> [..., C, n_bands]."""
    length = x.shape[-1]
    psd = torch.fft.rfft(x.float(), dim=-1).abs() ** 2 / length
    freqs = np.fft.rfftfreq(length, 1.0 / fs)
    outs = []
    for lo, hi in bands:
        mask = torch.as_tensor((freqs >= lo) & (freqs < hi), dtype=torch.float32,
                               device=x.device)
        denom = torch.clamp(mask.sum(), min=1.0)
        outs.append(torch.log1p((psd * mask).sum(dim=-1) / denom))
    return torch.stack(outs, dim=-1)


def preprocess_signal(x: torch.Tensor, fs: float,
                      bandpass: Optional[Tuple[float, float]] = None,
                      notch: Optional[float] = None, normalize: bool = True,
                      remove_trend: bool = False) -> torch.Tensor:
    """The cleanup chain: detrend, notch, bandpass, z-score, each optional."""
    if remove_trend:
        x = detrend(x)
    if notch is not None:
        x = notch_fft(x, notch, fs)
    if bandpass is not None:
        x = bandpass_fft(x, bandpass[0], bandpass[1], fs)
    if normalize:
        x = zscore(x)
    return x
