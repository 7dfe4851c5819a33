"""The PyTorch port's backward contracts against the JAX package, on CPU.

  * the transposed int8 matmuls (plain versions) against the TPU kernels
    ``quant_matmul_t`` / ``quant_matmul_t_stacked`` in interpret mode, at
    ``test_quant_matmul.py``'s tolerance for its backward (atol 2e-4, rtol
    2e-2: both round dy * scale to bf16 and the output to bf16; only the
    order of the float32 sums differs);
  * the flash-attention backward (plain version) against the TPU kernels
    ``_flash_bwd_pallas`` in interpret mode, fed the same q/k/v/do and the
    JAX forward's own residuals converted to the port's base-2 convention,
    at ``test_flash_attention.py``'s backward tolerance (atol 1e-4, rtol
    1e-3, float32); the port's forward residuals against JAX's;
  * every autograd Function against autograd through its plain forward
    (float32; the two differ only in the order of float32 sums, so 1e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from loongx_tpu.ops import flash_attention as jfa
from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu.ops.rope import rope_embed as jrope_embed
from loongx_tpu_torch.ops import flash_attention as tfa
from loongx_tpu_torch.ops import quant_matmul as tqmm


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (a) transposed int8 matmuls
# ---------------------------------------------------------------------------


def _t_operands(seed, m, k, n, nb=None):
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    dy = np.asarray(jnp.asarray(rng.standard_normal((m, n)), jnp.bfloat16)
                    .astype(jnp.float32))
    w = rng.integers(-128, 128, lead + (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, lead + (1, n)).astype(np.float32)
    return dy, w, scale


@pytest.mark.parametrize("m,k,n", [(64, 128, 96), (200, 3072, 64)])
def test_quant_matmul_t_matches_jax(m, k, n):
    dy, w, scale = _t_operands(0, m, k, n)
    want = jqmm.quant_matmul_t(jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(scale), interpret=True)
    got = tqmm.quant_matmul_t(_bf16(dy), torch.from_numpy(w),
                              torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-4, rtol=2e-2)


@pytest.mark.parametrize("m,k,n,blk", [(64, 256, 384, 2), (96, 3072, 3072, 0)])
def test_quant_matmul_t_stacked_matches_jax(m, k, n, blk):
    dy, w, scale = _t_operands(1, m, k, n, nb=3)
    want = jqmm.quant_matmul_t_stacked(
        jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        jnp.int32(blk), interpret=True)
    got = tqmm.quant_matmul_t_stacked(_bf16(dy), torch.from_numpy(w),
                                      torch.from_numpy(scale), blk)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-4, rtol=2e-2)
    with pytest.raises(IndexError):
        tqmm.quant_matmul_t_stacked(_bf16(dy), torch.from_numpy(w),
                                    torch.from_numpy(scale), 3)


# ---------------------------------------------------------------------------
# (b) flash backward against the TPU kernels
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (S, cond_len, mode, layout, rope)
    (256, 64, "union", "bshd", True),
    (256, 64, "no_union", "bshd", True),
    (256, 64, "independent", "bshd", True),
    (256, 64, "union", "bhsd", False),
    (256, 64, "no_union", "bhsd", False),
    (256, 64, "independent", "bhsd", False),
    (200, 40, "independent", "bshd", True),   # padded to 256 by the TPU path
    (200, 72, "no_union", "bhsd", False),
]


@pytest.mark.parametrize("s,c,mode,layout,use_rope", FLASH_CASES)
def test_flash_backward_matches_tpu_kernels(s, c, mode, layout, use_rope):
    b, h, d = 1, 2, 32
    bshd = layout == "bshd"
    shape = (b, s, h, d) if bshd else (b, h, s, d)
    rng = np.random.default_rng(s + c)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    if use_rope:
        ids = np.stack([np.zeros(s), np.arange(s), (np.arange(s) * 7) % 23], 1)
        cos, sin = (np.asarray(x) for x in jrope_embed(
            jnp.asarray(ids, jnp.float32), axes_dim=(8, 12, 12)))
    else:
        cos = sin = np.zeros((8, d), np.float32)
    cond_start = s - c
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, m, l = jfa._flash_fwd(
        jq, jk, jv, jnp.zeros((1, 1), jnp.float32), jnp.asarray(cos),
        jnp.asarray(sin), cond_start, mode, 128, 128, use_rope, True,
        save_residuals=True, bshd=bshd)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin),
                                 o, m, l, jdo, cond_start, mode, 128, 128,
                                 use_rope, True, bshd=bshd)
    # the port's residual convention: base-2 max, the same sum, [B, H, S]
    m2 = torch.from_numpy(np.asarray(m)[..., 0] * np.float32(math.log2(math.e)))
    lt = torch.from_numpy(np.asarray(l)[..., 0].copy())
    t = {n: torch.from_numpy(x) for n, x in
         (("q", q), ("k", k), ("v", v), ("do", do))}
    rope = (torch.from_numpy(cos), torch.from_numpy(sin)) if use_rope else None
    kw = dict(cond_start=cond_start, mode=mode, rope=rope, layout=layout)
    di = tfa._row_dot(torch.from_numpy(np.asarray(o)), t["do"], layout)
    got = tfa.flash_attention_bwd(t["q"], t["k"], t["v"], t["do"], m2, lt, di,
                                  **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-3, err_msg=name)
    # the port's forward residuals equal JAX's, converted
    pm2, pl = tfa.flash_residuals_plain(t["q"], t["k"], **kw)
    np.testing.assert_allclose(pm2.numpy(), m2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pl.numpy(), lt.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) autograd Functions against autograd through the plain forwards
# ---------------------------------------------------------------------------


def _grad(fn, inputs, cot):
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, cot)


def _qmm_operands(seed, m=24, k=48, n=32, nb=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g, requires_grad=True)
    w = torch.randint(-128, 128, (nb, k, n), generator=g, dtype=torch.int8)
    scale = torch.rand(nb, 1, n, generator=g) * 1e-2 + 1e-3
    bias = torch.randn(nb, 1, n, generator=g)
    cot = torch.randn(m, n, generator=g)
    return x, w, scale, bias, cot


@pytest.mark.parametrize("kind", ["flat", "stacked", "gelu_stacked", "gelu_flat"])
def test_quant_autograd_functions_match_plain_autograd(kind):
    x, w, scale, bias, cot = _qmm_operands(3)
    blk = 1
    fn, plain = {
        "flat": (lambda x: tqmm.quant_matmul_vjp(x, w[blk], scale[blk]),
                 lambda x: tqmm.qmm_plain(x, w[blk], scale[blk])),
        "stacked": (lambda x: tqmm.quant_matmul_stacked_vjp(x, w, scale, blk),
                    lambda x: tqmm.qmm_plain(x, w[blk], scale[blk])),
        "gelu_stacked": (
            lambda x: tqmm.quant_linear_gelu_stacked(x, w, scale, bias, blk),
            lambda x: tqmm.qmm_plain(x, w[blk], scale[blk], bias[blk],
                                     "gelu_tanh")),
        "gelu_flat": (
            lambda x: tqmm.quant_linear_gelu(x, w[blk], scale[blk], bias[blk]),
            lambda x: tqmm.qmm_plain(x, w[blk], scale[blk], bias[blk],
                                     "gelu_tanh")),
    }[kind]
    y, (dx,) = _grad(fn, (x,), cot)
    y_ref, (dx_ref,) = _grad(plain, (x,), cot)
    np.testing.assert_allclose(y.detach().numpy(), y_ref.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), atol=1e-5, rtol=1e-5)


def test_quant_autograd_computes_no_dx_without_input_grad(monkeypatch):
    """A frozen input (silu(temb) into the modulation linears) launches no
    transposed product: the output carries no graph."""
    x, w, scale, _, _ = _qmm_operands(4)
    calls = []
    real = tqmm.quant_matmul_t_stacked
    monkeypatch.setattr(tqmm, "quant_matmul_t_stacked",
                        lambda *a: calls.append(a) or real(*a))
    y = tqmm.quant_matmul_stacked_vjp(x.detach(), w, scale, 0)
    assert not y.requires_grad
    x2 = x.detach().requires_grad_()
    (tqmm.quant_matmul_stacked_vjp(x2, w, scale, 0) ** 2).sum().backward()
    assert len(calls) == 1 and x2.grad is not None


def _attn_operands(seed, layout, s=40, h=2, d=16):
    g = torch.Generator().manual_seed(seed)
    shape = (1, s, h, d) if layout == "bshd" else (1, h, s, d)
    q, k, v, cot = (torch.randn(shape, generator=g) for _ in range(4))
    ids = torch.stack([torch.zeros(s), torch.arange(s) % 7,
                       (torch.arange(s) * 3) % 11], 1).float()
    from loongx_tpu_torch.ops.rope import rope_embed
    return q, k, v, cot, rope_embed(ids, (4, 6, 6))


@pytest.mark.parametrize("mode,layout,c_factor", [
    ("union", "bshd", None), ("no_union", "bhsd", None),
    ("independent", "bshd", None), ("union", "bshd", 0.5),
])
def test_flash_autograd_matches_plain_autograd(mode, layout, c_factor):
    q, k, v, cot, rope = _attn_operands(5, layout)
    kw = dict(cond_start=28, mode=mode, c_factor=c_factor, rope=rope,
              layout=layout)
    inputs = tuple(t.requires_grad_() for t in (q, k, v))
    o, grads = _grad(lambda *a: tfa.flash_attention(*a, **kw), inputs, cot)
    o_ref, grads_ref = _grad(lambda *a: tfa.flash_attention_plain(*a, **kw),
                             inputs, cot)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(),
                               atol=1e-6)
    for name, a, b in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_flash_autograd_partial_inputs_and_checkpoint(monkeypatch):
    """Only v needs grad: the dQ pass is skipped.  Under non-reentrant
    checkpointing (the training remat) the gradients are unchanged."""
    q, k, v, cot, rope = _attn_operands(6, "bshd")
    kw = dict(cond_start=30, mode="independent", rope=rope, layout="bshd")
    seen = []
    real = tfa.flash_attention_bwd
    monkeypatch.setattr(tfa, "flash_attention_bwd",
                        lambda *a, **k: seen.append(k) or real(*a, **k))
    v1 = v.clone().requires_grad_()
    (dv,) = torch.autograd.grad(tfa.flash_attention(q, k, v1, **kw), v1, cot)
    assert seen[-1]["need_dq"] is False and seen[-1]["need_dkv"] is True
    v2 = v.clone().requires_grad_()
    (dv_ref,) = torch.autograd.grad(tfa.flash_attention_plain(q, k, v2, **kw),
                                    v2, cot)
    np.testing.assert_allclose(dv.numpy(), dv_ref.numpy(), atol=1e-5, rtol=1e-5)
    v3 = v.clone().requires_grad_()
    out = checkpoint(lambda x: tfa.flash_attention(q, k, x, **kw), v3,
                     use_reentrant=False)
    (dv_ck,) = torch.autograd.grad(out, v3, cot)
    np.testing.assert_array_equal(dv_ck.numpy(), dv.numpy())


def test_no_grad_paths_save_nothing():
    """Without grad (serving) the wrappers return plain tensors."""
    q, k, v, _, rope = _attn_operands(7, "bshd")
    with torch.no_grad():
        out = tfa.flash_attention(q.requires_grad_(), k, v, cond_start=30,
                                  rope=rope, layout="bshd")
    assert out.grad_fn is None
