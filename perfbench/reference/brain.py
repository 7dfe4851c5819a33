"""Plain float32 CS3 encoders and DGF fusion (the brain encode of the
neural edit and of the training step), on the trees of
`layout.brain_layout`.  The S4D layers convolve by FFT with their
materialised kernel (the recurrence x_k = Abar x_{k-1} + Bbar u_k, y_k =
2 Re(C x_k) + D u_k under zero-order hold, A = -exp(log_A_real) + i A_imag).
Nothing here imports the measured package."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]
DROPOUT_KEEP = 0.7


def linear(p: Tree, x: torch.Tensor) -> torch.Tensor:
    y = x.float() @ p["kernel"].float()
    return y + p["bias"].float() if "bias" in p else y


def layer_norm(x, weight, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()


def pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """AdaptiveAvgPool1d over the last axis: bin i averages
    [floor(i L / out), ceil((i + 1) L / out))."""
    length = x.shape[-1]
    if length == out:
        return x
    return torch.stack([x[..., (i * length) // out:-(-((i + 1) * length)
                                                     // out)].mean(-1)
                        for i in range(out)], -1)


def pyramid(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    return torch.cat([pool(x, s) for s in sizes], -1)


def s4d(p: Tree, u: torch.Tensor) -> torch.Tensor:
    """u [B, L, H] -> [B, L, H]."""
    length = u.shape[1]
    dt = torch.exp(p["log_dt"].float())[:, None]
    a = torch.complex(-torch.exp(p["log_A_real"].float()), p["A_imag"].float())
    dta = a * dt
    bbar = (torch.exp(dta) - 1.0) / a
    c = torch.complex(p["C"][..., 0].float(), p["C"][..., 1].float())
    steps = torch.arange(length, dtype=torch.float32, device=u.device)
    vander = torch.exp(dta[:, :, None] * steps)                  # [H, N, L]
    kernel = 2.0 * torch.einsum("hn,hnl->hl", c * bbar, vander).real
    n_fft = 2 * length
    y = torch.fft.irfft(torch.fft.rfft(u.transpose(1, 2), n=n_fft)
                        * torch.fft.rfft(kernel, n=n_fft), n=n_fft)[..., :length]
    return y.transpose(1, 2) + u * p["D"].float()


def s4_stack(p: Tree, u: torch.Tensor) -> torch.Tensor:
    x = linear(p["encoder"], u)
    for blk in p["blocks"]:
        z = F.glu(linear(blk["out"], s4d(blk["s4"], x)), dim=-1)
        x = layer_norm(x + z, blk["norm"]["weight"], blk["norm"]["bias"], 1e-6)
    return linear(p["decoder"], x)


def proj(p: Tree, x: torch.Tensor, n: int,
         keep: Optional[List[torch.Tensor]]) -> torch.Tensor:
    """Linear -> LN (eps 1e-5) -> ReLU (-> dropout by the ``keep`` masks,
    kept values scaled by 1 / 0.7) x n."""
    for i in range(n):
        x = torch.relu(layer_norm(linear(p[f"linear_{i}"], x),
                                  p[f"ln_{i}"]["weight"], p[f"ln_{i}"]["bias"],
                                  1e-5))
        if keep is not None:
            x = torch.where(keep[i], x / DROPOUT_KEEP, torch.zeros_like(x))
    return x


def eeg(p: Tree, x: torch.Tensor, keep=None) -> torch.Tensor:
    """[B, 4, 4096] -> [B, 512, 4096]."""
    b, u = x.shape[0], x.float().transpose(1, 2)
    z1 = pool(s4_stack(p["s4_wide"], u).transpose(1, 2), 4).transpose(1, 2)
    z2 = pool(s4_stack(p["s4_narrow"], u).transpose(1, 2), 64)
    comb = torch.cat([z1, pyramid(x.float(), (128, 256, 512, 1024, 2048)), z2],
                     -1)
    h = proj(p["proj"], comb.reshape(b, -1), 2, keep)
    return linear(p["token_proj"], h.reshape(b, 512, 8))


def ppg(p: Tree, x: torch.Tensor, keep=None) -> torch.Tensor:
    """[B, 4, 256] -> [B, 512, 4096]."""
    b = x.shape[0]
    z = pool(s4_stack(p["s4"], x.float().transpose(1, 2)).transpose(1, 2), 16)
    comb = torch.cat([z.reshape(b, -1),
                      pyramid(x.float(), (64, 128, 256)).reshape(b, -1)], -1)
    h = proj(p["proj"], comb, 2, keep)
    return linear(p["token_proj"], h.reshape(b, 512, 8))


def _pooled(p, x, keep, z_bins, sizes):
    b = x.shape[0]
    z = pool(s4_stack(p["s4"], x.float().transpose(1, 2)).transpose(1, 2),
             z_bins)
    comb = torch.cat([z.reshape(b, -1),
                      pyramid(x.float(), sizes).reshape(b, -1)], -1)
    return proj(p["proj"], comb, 2, keep)


def fnirs(p: Tree, x: torch.Tensor, keep=None) -> torch.Tensor:
    """[B, 6, 512] -> [B, 768]."""
    return _pooled(p, x, keep, 32, (128, 256, 448))


def motion(p: Tree, x: torch.Tensor, keep=None) -> torch.Tensor:
    """[B, 6, 128] -> [B, 768]."""
    return _pooled(p, x, keep, 6, (32, 64, 124))


def duan(p: Tree, x: torch.Tensor, c: torch.Tensor,
         keep_ratio: float = 0.7, eps: float = 1e-3) -> torch.Tensor:
    """DUAN adaptive normalisation of content x [B, C, L] by condition c,
    with the top-k channel mask (k = int(C * 0.7), at least 1)."""
    ch = x.shape[1]
    mu_c = x.mean(2, keepdim=True)
    sd_c = torch.sqrt(x.var(2, unbiased=False, keepdim=True) + eps)
    mu_l = x.mean((1, 2), keepdim=True)
    sd_l = torch.sqrt(x.var((1, 2), unbiased=False, keepdim=True) + eps)
    g = torch.sigmoid(linear(p["gate_out"], torch.relu(
        linear(p["gate_in"], c.transpose(1, 2)))))
    g = g.mean(1)[:, :, None]
    x_hat = (x - (g * mu_c + (1 - g) * mu_l)) / (g * sd_c + (1 - g) * sd_l)
    gamma, beta = linear(p["mlp_out"], torch.relu(
        linear(p["mlp_in"], c.mean(2)))).chunk(2, -1)
    y = (1.0 + gamma[:, :, None]) * x_hat + beta[:, :, None]
    top = torch.topk(y.abs().mean(2), max(1, int(ch * keep_ratio)), -1).indices
    mask = torch.zeros(y.shape[:2], device=y.device).scatter_(1, top, 1.0)
    return y * mask[:, :, None]


def fuse_eeg_ppg(dgf: Tree, e: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    fused = duan(dgf["duan_signal"], q, e)
    return linear(dgf["fusion_signal"],
                  torch.cat([e, fused], 1).transpose(1, 2)).transpose(1, 2)


def fuse_fnirs_motion(dgf: Tree, f: torch.Tensor,
                      m: torch.Tensor) -> torch.Tensor:
    f, m = f[:, None, :], m[:, None, :]
    fused = duan(dgf["duan_pooled_sig"], f, m)
    return linear(dgf["fusion_pooled_sig"], torch.cat([f, fused], -1))[:, 0]


def brain_embeds(params: Tree, signals: Dict[str, torch.Tensor],
                 keep: Optional[Dict[str, List[torch.Tensor]]] = None):
    """(prompt [B, 512, 4096], pooled [B, 768]) from all four signals."""
    enc, dgf, keep = params["encoders"], params["dgf"], keep or {}
    prompt = fuse_eeg_ppg(dgf, eeg(enc["eeg"], signals["eeg"], keep.get("eeg")),
                          ppg(enc["ppg"], signals["ppg"], keep.get("ppg")))
    pooled = fuse_fnirs_motion(
        dgf, fnirs(enc["fnirs"], signals["fnirs"], keep.get("fnirs")),
        motion(enc["motion"], signals["motion"], keep.get("motion")))
    return prompt, pooled


def fuse_text_train(dgf: Tree, text: torch.Tensor, text_pooled: torch.Tensor,
                    brain: torch.Tensor, brain_pooled: torch.Tensor):
    """The training wiring: DUAN(brain, text), concat on the token axis,
    fusion linear, residual onto the text embeds; the pooled branch alike."""
    fused = duan(dgf["duan_prompt"], brain, text)
    delta = linear(dgf["fusion_prompt"],
                   torch.cat([text, fused], 1).transpose(1, 2)).transpose(1, 2)
    fp = duan(dgf["duan_pooled"], brain_pooled[:, None], text_pooled[:, None])
    pooled = text_pooled + linear(dgf["fusion_pooled"],
                                  torch.cat([text_pooled, fp[:, 0]], -1))
    return text + delta, pooled
