"""DGF (Dynamic Gated Fusion): DUAN adaptive normalisation, the pairwise
fusion linears and the two text-fusion wirings (counterpart of
``loongx_tpu/models/fusion.py``).  Float32
statistics; the top-k channel mask keeps exactly k channels."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from loongx_tpu_torch.ops.nn import Params, init_linear, linear


def init_duan(channels: int, hidden_dim: int = 128, *, generator=None,
              dtype=torch.float32, device="cuda") -> Params:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "gate_in": init_linear(channels, hidden_dim, **kw),
        "gate_out": init_linear(hidden_dim, channels, **kw),
        "mlp_in": init_linear(channels, hidden_dim, **kw),
        "mlp_out": init_linear(hidden_dim, 2 * channels, **kw),
    }


def duan_apply(params: Params, x: torch.Tensor, c: torch.Tensor,
               keep_ratio: float = 0.7, eps: float = 1e-3) -> torch.Tensor:
    """x, c: [B, C, L] content / condition features -> [B, C, L]."""
    orig_dtype = x.dtype
    x, c = x.float(), c.float()
    ch = x.shape[1]
    mu_c = x.mean(2, keepdim=True)
    sigma_c = torch.sqrt(x.var(2, unbiased=False, keepdim=True) + eps)
    mu_l = x.mean((1, 2), keepdim=True)
    sigma_l = torch.sqrt(x.var((1, 2), unbiased=False, keepdim=True) + eps)

    g = torch.relu(linear(params["gate_in"], c.transpose(1, 2)))
    g = torch.sigmoid(linear(params["gate_out"], g))
    g_mix = g.mean(1)[:, :, None]
    mu = g_mix * mu_c + (1.0 - g_mix) * mu_l
    sigma = g_mix * sigma_c + (1.0 - g_mix) * sigma_l
    x_hat = (x - mu) / sigma

    gb = linear(params["mlp_out"], torch.relu(linear(params["mlp_in"],
                                                     c.mean(2))))
    gamma, beta = gb.chunk(2, dim=-1)
    y = (1.0 + gamma[:, :, None]) * x_hat + beta[:, :, None]

    imp = y.abs().mean(2)
    k = max(1, int(ch * keep_ratio))
    top_idx = torch.topk(imp, k, dim=-1).indices
    mask = torch.zeros_like(imp).scatter_(1, top_idx, 1.0)
    return (y * mask[:, :, None]).to(orig_dtype)


def init_dgf(*, generator=None, dtype=torch.bfloat16, device="cuda") -> Params:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "duan_signal": init_duan(512, **kw),
        "duan_pooled_sig": init_duan(1, **kw),
        "duan_prompt": init_duan(512, **kw),
        "duan_pooled": init_duan(1, **kw),
        "fusion_signal": init_linear(1024, 512, **kw),
        "fusion_pooled_sig": init_linear(1536, 768, **kw),
        "fusion_prompt": init_linear(1024, 512, **kw),
        "fusion_pooled": init_linear(1536, 768, **kw),
    }


def fuse_eeg_ppg(params: Params, eeg_feat: torch.Tensor,
                 ppg_feat: torch.Tensor) -> torch.Tensor:
    """EEG + PPG [B, 512, 4096] -> brain prompt embeds [B, 512, 4096]:
    DUAN(ppg, eeg), concat on the token axis, linear back to 512 tokens."""
    fused = duan_apply(params["duan_signal"], ppg_feat, eeg_feat)
    cat = torch.cat([eeg_feat, fused], dim=1)
    return linear(params["fusion_signal"], cat.transpose(1, 2)).transpose(1, 2)


def fuse_fnirs_motion(params: Params, fnirs_feat: torch.Tensor,
                      motion_feat: torch.Tensor) -> torch.Tensor:
    """fNIRS + Motion [B, 768] -> brain pooled embeds [B, 768]."""
    f, m = fnirs_feat[:, None, :], motion_feat[:, None, :]
    fused = duan_apply(params["duan_pooled_sig"], f, m)
    return linear(params["fusion_pooled_sig"], torch.cat([f, fused], -1))[:, 0]


def fuse_text_train(params: Params, prompt_embeds: torch.Tensor,
                    pooled_embeds: torch.Tensor, brain_prompt: torch.Tensor,
                    brain_pooled: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-path fusion: DUAN(brain, text) -> concat on the token axis
    -> fusion linear -> residual add onto the text embeds.  With
    ``brain_pooled`` None (no fNIRS in the sample) the pooled branch is
    skipped and ``pooled_embeds`` returned as is."""
    fused_p = duan_apply(params["duan_prompt"], brain_prompt, prompt_embeds)
    cat = torch.cat([prompt_embeds, fused_p], dim=1)          # [B, 1024, 4096]
    delta = linear(params["fusion_prompt"], cat.transpose(1, 2)).transpose(1, 2)
    prompt_out = prompt_embeds + delta
    if brain_pooled is None:
        return prompt_out, pooled_embeds
    p, bp = pooled_embeds[:, None, :], brain_pooled[:, None, :]
    fused_pool = duan_apply(params["duan_pooled"], bp, p)[:, 0]  # [B, 768]
    cat_pool = torch.cat([pooled_embeds, fused_pool], dim=-1)
    return prompt_out, pooled_embeds + linear(params["fusion_pooled"], cat_pool)


def fuse_text_infer(params: Params, prompt_embeds: torch.Tensor,
                    pooled_embeds: torch.Tensor, brain_prompt: torch.Tensor,
                    brain_pooled: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference-path fusion: DUAN applied directly with (text, brain)
    argument order, no concat or residual (the asymmetry with
    `fuse_text_train` is the reference's)."""
    prompt_out = duan_apply(params["duan_prompt"], prompt_embeds, brain_prompt)
    pooled_out = duan_apply(params["duan_pooled"], pooled_embeds[:, None, :],
                            brain_pooled[:, None, :])[:, 0]
    return prompt_out, pooled_out
