"""S4D diagonal state-space layer of the CS3 encoders (counterpart of
``loongx_tpu/ops/s4.py``).

    x_k = Abar x_{k-1} + Bbar u_k,   y_k = 2 Re(C x_k) + D u_k
    A = -exp(log_A_real) + i A_imag,  ZOH: Abar = exp(dt A), Bbar = (Abar-1)/A

``s4d_conv`` (the serving mode) materialises the length-L kernel and
convolves by FFT; ``s4d_scan`` runs the recurrence step by step as a plain
reference; ``ops/s4_scan.py`` runs it as a kernel (mode "pallas"), with
``s4d_scan`` as its plain version.  All SSM math is float32 in real/imag planes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, linear, normal,
)


def init_s4d_layer(d_model: int, n_state: int = 64, dt_min: float = 1e-3,
                   dt_max: float = 1e-1, *, generator=None,
                   device="cuda") -> Params:
    """S4D-Lin init, half-spectrum storage (n_state/2 complex states)."""
    n = n_state // 2
    a_imag = math.pi * torch.arange(n, dtype=torch.float32,
                                    device=device).expand(d_model, n)
    log_dt = torch.empty(d_model, dtype=torch.float32, device=device)
    if log_dt.device.type != "meta":
        log_dt.uniform_(generator=generator)
    log_dt = log_dt * (math.log(dt_max) - math.log(dt_min)) + math.log(dt_min)
    return {
        "log_A_real": torch.full((d_model, n), math.log(0.5),
                                 dtype=torch.float32, device=device),
        "A_imag": a_imag.contiguous(),
        "C": normal((d_model, n, 2), generator=generator, device=device),
        "log_dt": log_dt,
        "D": torch.ones(d_model, dtype=torch.float32, device=device),
    }


def discretise_real(p: Params):
    """ZOH discretisation in real arithmetic -> (abar_r, abar_i, bbar_r,
    bbar_i, c_r, c_i), each [H, N]."""
    a_re = -torch.exp(p["log_A_real"])
    a_im = p["A_imag"]
    dt = torch.exp(p["log_dt"])[:, None]
    dta_re, dta_im = a_re * dt, a_im * dt
    mag = torch.exp(dta_re)
    abar_r = mag * torch.cos(dta_im)
    abar_i = mag * torch.sin(dta_im)
    denom = a_re * a_re + a_im * a_im
    num_r, num_i = abar_r - 1.0, abar_i
    bbar_r = (num_r * a_re + num_i * a_im) / denom
    bbar_i = (num_i * a_re - num_r * a_im) / denom
    return abar_r, abar_i, bbar_r, bbar_i, p["C"][..., 0], p["C"][..., 1]


def s4d_kernel(p: Params, length: int) -> torch.Tensor:
    """[H, L] kernel K[h, l] = 2 Re(sum_n (C Bbar)[h, n] exp(dtA[h, n] l))."""
    _, _, bbar_r, bbar_i, c_r, c_i = discretise_real(p)
    ctb_r = c_r * bbar_r - c_i * bbar_i
    ctb_i = c_r * bbar_i + c_i * bbar_r
    dta_re = -torch.exp(p["log_A_real"]) * torch.exp(p["log_dt"])[:, None]
    dta_im = p["A_imag"] * torch.exp(p["log_dt"])[:, None]
    steps = torch.arange(length, dtype=torch.float32, device=dta_re.device)
    mag = torch.exp(dta_re[:, :, None] * steps)
    phase = dta_im[:, :, None] * steps
    vander_r = mag * torch.cos(phase)
    vander_i = mag * torch.sin(phase)
    return 2.0 * (torch.einsum("hn,hnl->hl", ctb_r, vander_r)
                  - torch.einsum("hn,hnl->hl", ctb_i, vander_i))


def s4d_conv(p: Params, u: torch.Tensor) -> torch.Tensor:
    """FFT convolution mode.  u: [B, L, H] -> [B, L, H]."""
    length = u.shape[1]
    uf = u.float()
    n_fft = 2 * length
    ku = torch.fft.rfft(s4d_kernel(p, length), n=n_fft, dim=-1)
    uu = torch.fft.rfft(uf.transpose(1, 2), n=n_fft, dim=-1)
    y = torch.fft.irfft(uu * ku[None], n=n_fft, dim=-1)[..., :length]
    y = y.transpose(1, 2) + uf * p["D"]
    return y.to(u.dtype)


def s4d_scan(p: Params, u: torch.Tensor) -> torch.Tensor:
    """Recurrent mode, one step per position, each product and sum rounded
    on its own in the order of the TPU kernel (``s4_pallas.py:49-61``): the
    plain reference, and the plain version of the recurrence kernel
    (``ops/s4_scan.py``).  The JAX package's associative scan computes the
    same recurrence.  Same contract as `s4d_conv`."""
    ar, ai, br, bi, cr, ci = discretise_real(p)
    uf = u.float()
    b, length, h = uf.shape
    xr = uf.new_zeros(b, h, ar.shape[1])
    xi = torch.zeros_like(xr)
    ys = []
    for t in range(length):
        u_t = uf[:, t, :]
        u_col = u_t[:, :, None]
        xr, xi = (ar * xr - ai * xi + br * u_col,
                  ai * xr + ar * xi + bi * u_col)
        ys.append(2.0 * (cr * xr - ci * xi).sum(-1) + p["D"].float() * u_t)
    return torch.stack(ys, dim=1).to(u.dtype)


def init_s4_stack(d_input: int, d_model: int, d_output: int,
                  n_blocks: int = 2, n_state: int = 64, *, generator=None,
                  dtype=torch.float32, device="cuda") -> Params:
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {
        "encoder": init_linear(d_input, d_model, **kw),
        "blocks": [
            {
                "s4": init_s4d_layer(d_model, n_state, generator=generator,
                                     device=device),
                "out": init_linear(d_model, 2 * d_model, **kw),
                "norm": init_layer_norm(d_model, dtype=dtype, device=device),
            }
            for _ in range(n_blocks)
        ],
        "decoder": init_linear(d_model, d_output, **kw),
    }


def s4_stack_apply(params: Params, u: torch.Tensor,
                   mode: str = "conv") -> torch.Tensor:
    """u: [B, L, d_input] -> [B, L, d_output]: encoder linear, then
    [S4D -> linear -> GLU -> residual -> LN] per block, then decoder.

    mode (the JAX package's names): "conv" (FFT convolution, the serving
    default), "scan" (the step-by-step plain reference) or "pallas" (the
    recurrence kernel of ``ops/s4_scan.py``: the CUDA kernel
    ``csrc/s4d_scan.cu`` on CUDA tensors, its plain version on CPU
    tensors)."""
    if mode == "pallas":
        from loongx_tpu_torch.ops.s4_scan import s4d_scan_recurrent

        core = s4d_scan_recurrent
    elif mode == "scan":
        core = s4d_scan
    elif mode == "conv":
        core = s4d_conv
    else:
        raise ValueError(f"unknown s4 mode {mode!r} (conv | scan | pallas)")
    x = linear(params["encoder"], u)
    for blk in params["blocks"]:
        z = linear(blk["out"], core(blk["s4"], x))
        z = F.glu(z, dim=-1)
        x = layer_norm(x + z, blk["norm"]["weight"], blk["norm"]["bias"])
    return linear(params["decoder"], x)
