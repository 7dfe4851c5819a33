"""CS3 (Cross-Scale State Space) biosignal encoders (counterpart of
``loongx_tpu/models/encoders.py``): S4 stacks over the raw signal plus
multi-scale feature-pyramid pooling, projected to the text-embedding spaces:

  * EEG   [B, 4, 4096] -> [B, 512, 4096]  (T5 prompt-embed shape)
  * PPG   [B, 4, 256]  -> [B, 512, 4096]
  * fNIRS [B, 6, 512]  -> [B, 768]        (CLIP pooled shape)
  * Motion[B, 6, 128]  -> [B, 768]

SSM math is float32; projections run in the params' dtype.  Each
projection stack ends its Linear -> LN -> ReLU layers with dropout 0.3,
active only in training: pass ``dropout`` = a ``torch.Generator`` to draw
the keep masks, or the keep masks themselves (one boolean tensor per layer,
e.g. the JAX package's own ``jax.random.bernoulli`` draws), or a
`BatchRows` (a data rank's rows of the masks a generator draws for the
global batch); None (the default) is inference, dropout off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, linear,
)
from loongx_tpu_torch.ops.pooling import (
    adaptive_avg_pool1d, feature_pyramid_pooling, spatial_pyramid_pooling,
)
from loongx_tpu_torch.ops.s4 import init_s4_stack, s4_stack_apply

FIXED_LENGTHS = {"eeg": 4096, "fnirs": 512, "ppg": 256, "motion": 128}
CHANNELS = {"eeg": 4, "fnirs": 6, "ppg": 4, "motion": 6}


def canonicalise_signal(x: torch.Tensor, modality: str) -> torch.Tensor:
    """Accept [B, C, L], [C, L] or [B, C*L]; return [B, C, L_fixed].

    CAUTION (as in the JAX package): a 2-D input whose leading dim equals
    the modality's channel count is read as one [C, L] recording, so a
    flattened batch with B == C is misread.  Pass [B, C, L] for batches."""
    c = CHANNELS[modality]
    fixed = FIXED_LENGTHS[modality]
    if x.ndim == 2:
        if x.shape[0] == c:
            x = x[None]
        else:
            if x.shape[1] % c != 0:
                raise ValueError(
                    f"cannot interpret {modality} signal of shape "
                    f"{tuple(x.shape)}: neither [C={c}, L] nor [B, C*L]")
            x = x.reshape(x.shape[0], c, -1)
    return spatial_pyramid_pooling(x, fixed)


def _mlp_ln_relu(dims, kw) -> Params:
    p: Params = {}
    for i in range(len(dims) - 1):
        p[f"linear_{i}"] = init_linear(dims[i], dims[i + 1], **kw)
        p[f"ln_{i}"] = init_layer_norm(dims[i + 1], dtype=kw["dtype"],
                                       device=kw["device"])
    return p


DROPOUT_RATE = 0.3


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Dropout for rows [start, stop) of a global batch of ``batch`` rows:
    each mask is drawn from ``generator`` at the global batch's shape, as
    one process holding the whole batch draws it, and the rows are kept
    (a data rank's share of the one-process draws)."""
    generator: torch.Generator
    start: int
    stop: int
    batch: int


Dropout = Optional[Union[torch.Generator, BatchRows,
                         Sequence[torch.Tensor]]]


def _apply_mlp_ln_relu(p: Params, x: torch.Tensor, n: int,
                       dropout: Dropout = None) -> torch.Tensor:
    """Linear -> LN -> ReLU (-> dropout) x n.  Dropout keeps an element with
    probability 0.7 and scales it by 1 / 0.7 (a true division)."""
    for i in range(n):
        x = linear(p[f"linear_{i}"], x)
        x = layer_norm(x, p[f"ln_{i}"]["weight"], p[f"ln_{i}"]["bias"], eps=1e-5)
        x = torch.relu(x)
        if dropout is not None:
            if isinstance(dropout, torch.Generator):
                keep = torch.rand(x.shape, generator=dropout,
                                  device=x.device) < 1.0 - DROPOUT_RATE
            elif isinstance(dropout, BatchRows):
                keep = torch.rand(
                    (dropout.batch, *x.shape[1:]), generator=dropout.generator,
                    device=x.device)[dropout.start:dropout.stop] < (
                        1.0 - DROPOUT_RATE)
            else:
                keep = dropout[i].to(x.device)
            x = torch.where(keep, x / x.new_full((), 1.0 - DROPOUT_RATE),
                            torch.zeros_like(x))
    return x


def _kw(generator, dtype, device):
    return dict(generator=generator, dtype=dtype, device=device)


def init_eeg_encoder(*, generator=None, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    kw = _kw(generator, dtype, device)
    s4kw = dict(generator=generator, device=device)
    return {
        "s4_wide": init_s4_stack(4, 64, 64, n_blocks=2, n_state=64, **s4kw),
        "s4_narrow": init_s4_stack(4, 4, 4, n_blocks=2, n_state=4, **s4kw),
        "proj": _mlp_ln_relu([4 * 4096, 2048, 4096], kw),
        "token_proj": init_linear(8, 4096, **kw),
    }


def eeg_encode(params: Params, x: torch.Tensor, s4_mode: str = "conv",
               dropout: Dropout = None) -> torch.Tensor:
    """EEG (canonicalised to [B, 4, 4096]) -> [B, 512, 4096]."""
    x = canonicalise_signal(x, "eeg")
    b = x.shape[0]
    u = x.transpose(1, 2)
    z1 = s4_stack_apply(params["s4_wide"], u, s4_mode)         # [B, 4096, 64]
    z1 = adaptive_avg_pool1d(z1.transpose(1, 2), 4).transpose(1, 2)  # [B, 4, 64]
    z2 = s4_stack_apply(params["s4_narrow"], u, s4_mode)       # [B, 4096, 4]
    z2 = adaptive_avg_pool1d(z2.transpose(1, 2), 64)           # [B, 4, 64]
    fpp = feature_pyramid_pooling(x, (128, 256, 512, 1024, 2048))
    combined = torch.cat([z1, fpp, z2], dim=-1)                # [B, 4, 4096]
    h = _apply_mlp_ln_relu(params["proj"], combined.reshape(b, -1), 2,
                           dropout)
    return linear(params["token_proj"], h.reshape(b, 512, 8))


def init_ppg_encoder(*, generator=None, dtype=torch.bfloat16,
                     device="cuda") -> Params:
    kw = _kw(generator, dtype, device)
    return {
        "s4": init_s4_stack(4, 4, 4, n_blocks=2, n_state=4,
                            generator=generator, device=device),
        "proj": _mlp_ln_relu([4 * 16 + 448 * 4, 1024, 4096], kw),
        "token_proj": init_linear(8, 4096, **kw),
    }


def ppg_encode(params: Params, x: torch.Tensor, s4_mode: str = "conv",
               dropout: Dropout = None) -> torch.Tensor:
    x = canonicalise_signal(x, "ppg")
    b = x.shape[0]
    z = s4_stack_apply(params["s4"], x.transpose(1, 2), s4_mode)
    z = adaptive_avg_pool1d(z.transpose(1, 2), 16)
    fpp = feature_pyramid_pooling(x, (64, 128, 256))
    combined = torch.cat([z.reshape(b, -1), fpp.reshape(b, -1)], dim=-1)
    h = _apply_mlp_ln_relu(params["proj"], combined, 2, dropout)
    return linear(params["token_proj"], h.reshape(b, 512, 8))


def init_fnirs_encoder(*, generator=None, dtype=torch.bfloat16,
                       device="cuda") -> Params:
    return {
        "s4": init_s4_stack(6, 6, 6, n_blocks=2, n_state=6,
                            generator=generator, device=device),
        "proj": _mlp_ln_relu([6 * 32 + 832 * 6, 1024, 768],
                             _kw(generator, dtype, device)),
    }


def fnirs_encode(params: Params, x: torch.Tensor, s4_mode: str = "conv",
                 dropout: Dropout = None) -> torch.Tensor:
    x = canonicalise_signal(x, "fnirs")
    b = x.shape[0]
    z = s4_stack_apply(params["s4"], x.transpose(1, 2), s4_mode)
    z = adaptive_avg_pool1d(z.transpose(1, 2), 32)
    fpp = feature_pyramid_pooling(x, (128, 256, 448))
    combined = torch.cat([z.reshape(b, -1), fpp.reshape(b, -1)], dim=-1)
    return _apply_mlp_ln_relu(params["proj"], combined, 2, dropout)


def init_motion_encoder(*, generator=None, dtype=torch.bfloat16,
                        device="cuda") -> Params:
    return {
        "s4": init_s4_stack(6, 6, 6, n_blocks=2, n_state=6,
                            generator=generator, device=device),
        "proj": _mlp_ln_relu([6 * 6 + 220 * 6, 512, 768],
                             _kw(generator, dtype, device)),
    }


def motion_encode(params: Params, x: torch.Tensor, s4_mode: str = "conv",
                  dropout: Dropout = None) -> torch.Tensor:
    x = canonicalise_signal(x, "motion")
    b = x.shape[0]
    z = s4_stack_apply(params["s4"], x.transpose(1, 2), s4_mode)
    z = adaptive_avg_pool1d(z.transpose(1, 2), 6)
    fpp = feature_pyramid_pooling(x, (32, 64, 124))
    combined = torch.cat([z.reshape(b, -1), fpp.reshape(b, -1)], dim=-1)
    return _apply_mlp_ln_relu(params["proj"], combined, 2, dropout)
