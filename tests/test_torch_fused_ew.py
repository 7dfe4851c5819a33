"""The fused-elementwise DiT path of the PyTorch port against the JAX
package, on CPU.

The TPU kernels' LN + adaLN prologue (``_ln_mod_prologue``) and gate +
residual epilogue (``_gate_res_epilogue``) run in the JAX package under
LOONGX_FUSE_LN=1 / LOONGX_FUSE_GATE=1, here through their Pallas kernels
in interpret mode (LOONGX_STACKED_QMM=1 gives the model its ``_blk``
stacks on CPU).  The port's wrappers take their plain versions on CPU
tensors.  Held against each other:

  * ``quant_matmul_stacked(ab=)`` with and without gelu,
    ``quant_matmul_stacked(resid=, gate=)``, ``quant_qkv_stacked(ab=)``,
    both MAC modes, boundaries on and off the 128-row tile, no-cond ab
    rows, K 6144 (two W8A8 groups) and a shape the stacked tiling cannot
    cover: within one bf16 rounding of the output, as tests/test_torch_quant
    holds the unfused kernels; the gate on out - resid, its bound scaled by
    max |g z| (a residual would hide an error in the product);
  * the two autograd Functions against ``jax.grad`` through the JAX
    ``custom_vjp``s, cotangent dtypes included;
  * ``flux_forward`` at ``FluxConfig.tiny()`` with both flags (W8A8 and
    weight-only), the routing at batch 1 and 2, the tiny ``neural_edit``
    and ``generate()`` and one tiny train step with ``fuse_ln``.

The kernel-form comparisons hand both sides the same row statistics (the
port's `ln_row_stats_plain` returns JAX's ``_ln_mean_rstd`` there): the
statistics are not part of any kernel, the port computes the JAX recipe
in PyTorch (`test_ln_row_stats_match_jax`), and the two frameworks sum in
other orders, which moves a mean or rstd by an ulp and now and then flips
an int8 activation or a bf16 rounding downstream.

Two numerical differences are not the port's, and the data avoids them:

  * XLA:CPU compiles the interpret-mode prologue's ``xn * a + b`` into one
    fma; the port and its CUDA kernel round the product and the sum
    separately, in the TPU kernel's order
    (`test_prologue_rounds_each_operation` pins both).  Where that changes
    the bf16 rounding of a prologue output the weight-only products differ
    by more than one output rounding, so the kernel comparisons use a_seg
    of powers of two, for which fma(xn, a, b) = (xn * a) + b exactly;
  * the W8A8 tie at +-absmax/2 of a group (tests/test_torch_quant.py),
    avoided by `_untie` where x is quantized as given (the gate form).
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu.train import lora as jlora
from loongx_tpu.train import step as jstep
from loongx_tpu_torch.models import encoders as tenc
from loongx_tpu_torch.models import fusion as tfus
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.models.flux import vae as tvae
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.ops import quant_matmul as tqmm
from loongx_tpu_torch.sampling import generate as tgen
from loongx_tpu_torch.train import lora as tlora
from loongx_tpu_torch.train import step as tstep
from loongx_tpu_torch.train.optim import build_optimizer
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

# the package re-exports generate(), which shadows the module attribute
jgen = importlib.import_module("loongx_tpu.sampling.generate")

BF16_ULP = 2.0 ** -7  # one bf16 rounding step, relative
ATOL = 2e-4
CFG = jmodel.FluxConfig.tiny()
TCFG = tmodel.FluxConfig.tiny()
FUSE_ENV = {"LOONGX_STACKED_QMM": "1", "LOONGX_FUSE_LN": "1",
            "LOONGX_FUSE_GATE": "1"}
# whole fused forwards: a few flipped roundings, most elements near ATOL
# (see test_flux_forward_fused_matches_jax)
FUSED_ATOL, FUSED_MEDIAN = 5e-3, 5e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a):
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _untie(x, group):
    """Move every activation equal to +-absmax/2 of its k group (the W8A8
    tie of tests/test_torch_quant.py) to the next bf16 value towards
    zero."""
    for g0 in range(0, x.shape[1], group):
        tile = x[:, g0:g0 + group]
        half = np.abs(tile).max(1, keepdims=True) / 2
        tie = (np.abs(tile) == half) & (half > 0)
        tile[tie] = _bf16_np(tile[tie] * (1 - 2.0 ** -8) - tile[tie] * 2.0 ** -12)
    return x


def _untie_prologue(x, ab, boundary, group, composed=False):
    """``ab`` with b nudged in the columns whose prologue output lies within
    1e-4 of a W8A8 rounding tie (x' / x_scale = n + 1/2): XLA:CPU's fused
    division rounds such quotients either way (29.499998 -> 30), the tie
    of tests/test_torch_quant.py.  ``composed``: the prologue as composed
    around the unfused product (from x as given, rounded to bf16)."""
    ab = ab.copy()
    mean, rstd = (np.asarray(t) for t in jqmm._ln_mean_rstd(jnp.asarray(x)))
    xb = x if composed else _bf16_np(x)
    cond = np.arange(x.shape[0])[:, None] >= boundary
    for _ in range(20):
        xn = (xb - mean) * rstd
        xp = xn * np.where(cond, ab[2], ab[0]) + np.where(cond, ab[3], ab[1])
        if composed:
            xp = _bf16_np(xp)
        near = np.zeros(x.shape, bool)
        for g0 in range(0, x.shape[1], group):
            t = np.abs(xp[:, g0:g0 + group])
            r = t / (t.max(1, keepdims=True) / np.float32(127))
            near[:, g0:g0 + group] = np.abs(r - np.floor(r) - 0.5) < 1e-4
        if not near.any():
            return ab
        rows, cols = np.nonzero(near)
        ab[np.where(rows >= boundary, 3, 1), cols] += 2.0 ** -9
    raise AssertionError("prologue ties left after 20 nudges")


def _assert_one_bf16_rounding(got, want, scale=None):
    """|got - want| within one bf16 rounding of want, plus 1e-5 of
    ``scale`` (default max |want|; max |g z| for the gate form)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    tol = BF16_ULP * np.abs(want) + 1e-5 * scale + 1e-30
    err = np.abs(got - want)
    assert (err <= tol).all(), (err.max(), np.unravel_index(
        np.argmax(err - tol), err.shape))


def _operands(seed, m, k, n, nb):
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal((m, k)) + 0.25).astype(np.float32)
    w = rng.integers(-128, 128, (nb, k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, (nb, 1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal((nb, 1, n))).astype(np.float32)
    return x, w, scale, bias


def _ab(seed, k, cond=True):
    """[8, K]: a rows +-2^{-1, 0, 1} (see the module docstring), b rows
    normal; rows 2/3 repeat rows 0/1 without a cond segment."""
    rng = np.random.default_rng(seed)
    a = (np.exp2(rng.integers(-1, 2, (2, k)))
         * rng.choice([-1.0, 1.0], (2, k))).astype(np.float32)
    b = (0.5 * rng.standard_normal((2, k))).astype(np.float32)
    if not cond:
        a[1], b[1] = a[0], b[0]
    ab = np.zeros((8, k), np.float32)
    ab[0], ab[1], ab[2], ab[3] = a[0], b[0], a[1], b[1]
    return ab


def _gate(seed, n):
    g = np.zeros((8, n), np.float32)
    g[:2] = np.random.default_rng(seed).standard_normal((2, n))
    return g


# ---------------------------------------------------------------------------
# Row statistics and the prologue's rounding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_row_stats_match_jax(dtype):
    x = _operands(0, 9, 3072, 16, 1)[0]
    jx = jnp.asarray(x).astype(dtype)
    mean, rstd = jqmm._ln_mean_rstd(jx)
    got = tqmm.ln_row_stats_plain(_t(np.asarray(jx.astype(jnp.float32)))
                                  .to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (9, 2)
    # float32 means over 3072 values summed in other orders
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(mean)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:, 1].numpy(), np.asarray(rstd)[:, 0],
                               rtol=1e-5)


def test_prologue_rounds_each_operation():
    """The port's prologue is ((x - mean) * rstd) * a + b with every
    operation rounded to float32 on its own; XLA:CPU's interpret-mode
    kernel computes fma(xn, a, b).  With a power of two for a the two
    agree exactly."""
    rng = np.random.default_rng(1)
    x = _bf16_np(rng.standard_normal((4, 512)).astype(np.float32))
    ab = np.zeros((8, 512), np.float32)
    ab[:4] = rng.standard_normal((4, 512))
    stats = tqmm.ln_row_stats_plain(_t(x))
    got = tqmm.ln_mod_plain(_t(x), _t(ab), stats, 2).numpy()
    mean, rstd = stats[:, :1].numpy(), stats[:, 1:].numpy()
    xn = ((x - mean) * rstd).astype(np.float32)
    a = np.where(np.arange(4)[:, None] >= 2, ab[2], ab[0])
    b = np.where(np.arange(4)[:, None] >= 2, ab[3], ab[1])
    np.testing.assert_array_equal(got, (xn * a).astype(np.float32) + b)
    fma = (xn.astype(np.float64) * a + b).astype(np.float32)
    xla = np.asarray(jax.jit(lambda xn, a, b: xn * a + b)(xn, a, b))
    np.testing.assert_array_equal(xla, fma)
    assert (got != fma).any()
    a2 = np.exp2(np.round(a)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda xn, a, b: xn * a + b)(xn, a2, b)),
        (xn * a2).astype(np.float32) + b)


# ---------------------------------------------------------------------------
# The fused kernel forms
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_stats(monkeypatch):
    """The port's row statistics replaced by JAX's (see the module
    docstring)."""
    def stats(x):
        mean, rstd = jqmm._ln_mean_rstd(jnp.asarray(x.float().numpy()))
        return torch.from_numpy(np.concatenate(
            [np.asarray(mean), np.asarray(rstd)], -1))

    monkeypatch.setattr(tqmm, "ln_row_stats_plain", stats)

LN_CASES = [
    # (m, k, n, nb, blk, w8a8, activation, boundary, cond)
    (12, 3072, 384, 2, 1, True, "gelu_tanh", 7, True),   # boundary off-tile
    (12, 3072, 384, 2, 1, False, "gelu_tanh", 7, True),
    (12, 6144, 256, 2, 0, True, None, 5, True),          # two W8A8 groups
    (12, 6144, 256, 2, 0, False, None, 5, True),
    (136, 3072, 256, 2, 1, True, "gelu_tanh", 128, True),  # on the tile
    (136, 3072, 256, 2, 1, False, None, 128, True),
    (10, 3072, 256, 3, 2, True, "gelu_tanh", 10, False),  # no-cond ab rows
    (10, 3072, 256, 3, 2, False, "gelu_tanh", 10, False),
]


@pytest.mark.parametrize("m, k, n, nb, blk, w8a8, act, boundary, cond",
                         LN_CASES)
def test_stacked_ln_prologue_matches_jax_kernel(jax_stats, m, k, n, nb, blk,
                                                w8a8, act, boundary, cond):
    x, w, scale, bias = _operands(2, m, k, n, nb)
    ab = _ab(3, k, cond)
    if w8a8:
        ab = _untie_prologue(x, ab, boundary, tqmm.stacked_w8a8_group(k, n)[0])
    if not cond:
        ab[2], ab[3] = ab[0], ab[1]
        # the model's operand: _mk_ab without a cond affine
        rows = [jnp.asarray(ab[i:i + 1]) for i in (0, 1)]
        jab = jmodel._mk_ab(*rows, None, None, k)
        tab = tmodel._mk_ab(*(_t(ab[i:i + 1]) for i in (0, 1)), None, None, k)
        np.testing.assert_array_equal(tab.numpy(), np.asarray(jab))
        np.testing.assert_array_equal(np.asarray(jab), ab)
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.int32(blk),
        bias3=jnp.asarray(bias), activation=act, interpret=True, w8a8=w8a8,
        ab=jnp.asarray(ab), seg_boundary=boundary)
    got = tqmm.quant_matmul_stacked(
        _t(x), _t(w), _t(scale), blk, bias3=_t(bias), activation=act,
        w8a8=w8a8, ab=_t(ab), seg_boundary=boundary)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _assert_one_bf16_rounding(got.float().numpy(), want)


@pytest.mark.parametrize("boundary", [4, 9])
def test_w8a8_prologue_codes_equal_jax(jax_stats, boundary):
    """The activation pass with the prologue quantizes the float32
    prologue output itself, not its bf16 rounding: codes and scales equal
    the TPU kernel's arithmetic run op by op (fma for the affine, as
    XLA:CPU compiles it, agrees with the port at power-of-two a); the
    unfused composition's codes differ."""
    m, k = 9, 6144
    x = _operands(4, m, k, 16, 1)[0]
    group, k_pad = tqmm.stacked_w8a8_group(k, 256)
    ab = _untie_prologue(x, _ab(5, k), boundary, group)
    q, xs = tqmm.act_quant(_t(x), group, k_pad, _t(ab), boundary)
    mean, rstd = jqmm._ln_mean_rstd(jnp.asarray(x))
    xn = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) - mean) * rstd
    cond = np.arange(m)[:, None] >= boundary
    xp = xn * jnp.where(cond, ab[2], ab[0]) + jnp.where(cond, ab[3], ab[1])
    qs, scales = [], []
    for g0 in range(0, k_pad, group):
        tile = xp[:, g0:g0 + group]
        absmax = jnp.max(jnp.abs(tile), axis=1, keepdims=True)
        x_scale = jnp.where(absmax == 0, 1.0, absmax / 127.0)
        qs.append(jnp.clip(jnp.round(tile / x_scale), -127, 127))
        scales.append(x_scale)
    assert q.dtype == torch.int8 and q.shape == (m, k_pad)
    np.testing.assert_array_equal(q.numpy(), np.concatenate(qs, 1))
    np.testing.assert_array_equal(xs.numpy(), np.concatenate(scales, 1))
    q_unfused, _ = tqmm.act_quant(
        tqmm.ln_mod_plain(_t(x), _t(ab), tqmm.ln_row_stats_plain(_t(x)),
                          boundary).to(torch.bfloat16), group, k_pad)
    assert (q_unfused != q).any()


GATE_CASES = [
    # (m, k, n, nb, blk, w8a8, activation, boundary)
    (12, 3072, 256, 2, 1, True, None, 7),
    (12, 3072, 256, 2, 1, False, None, 7),
    (12, 6144, 256, 2, 0, True, None, 5),
    (12, 6144, 256, 2, 0, False, None, 5),
    (136, 3072, 256, 2, 1, True, None, 128),
    (10, 3072, 384, 2, 1, False, "gelu_tanh", 3),
]


@pytest.mark.parametrize("m, k, n, nb, blk, w8a8, act, boundary", GATE_CASES)
def test_stacked_gate_epilogue_matches_jax_kernel(m, k, n, nb, blk, w8a8, act,
                                                  boundary):
    x, w, scale, bias = _operands(6, m, k, n, nb)
    x = _untie(_bf16_np(x), tqmm.stacked_w8a8_group(k, n)[0])
    gate = _gate(7, n)
    resid = _bf16_np(np.random.default_rng(8).standard_normal((m, n)))
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.int32(blk),
        bias3=jnp.asarray(bias), activation=act, interpret=True, w8a8=w8a8,
        resid=jnp.asarray(resid), gate=jnp.asarray(gate),
        seg_boundary=boundary)
    got = tqmm.quant_matmul_stacked(
        _t(x), _t(w), _t(scale), blk, bias3=_t(bias), activation=act,
        w8a8=w8a8, resid=_t(resid), gate=_t(gate), seg_boundary=boundary)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    gz = want - resid
    _assert_one_bf16_rounding(got.float().numpy() - resid, gz,
                              scale=np.abs(gz).max())
    _assert_one_bf16_rounding(got.float().numpy(), want, scale=np.abs(gz).max())


@pytest.mark.parametrize("w8a8", [True, False])
def test_fused_forms_compose_where_the_stacked_tiling_cannot(jax_stats, w8a8):
    """K 2000 has no stacked k tile: the prologue and epilogue compose
    around the unfused product (LN + affine rounded to bf16 first), as the
    JAX package routes it."""
    m, k, n, boundary = 6, 2000, 256, 4
    assert not tqmm.stacked_ok(k, n)
    x, w, scale, bias = _operands(9, m, k, n, 2)
    ab, gate = _ab(10, k), _gate(11, n)
    if w8a8:
        ab = _untie_prologue(x, ab, boundary, tqmm.flat_w8a8_group(k, n)[0],
                             composed=True)
    resid = _bf16_np(np.random.default_rng(12).standard_normal((m, n)))
    kw = dict(activation=None, w8a8=w8a8, seg_boundary=boundary)
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.int32(1),
        bias3=jnp.asarray(bias), interpret=True, ab=jnp.asarray(ab),
        resid=jnp.asarray(resid), gate=jnp.asarray(gate), **kw)
    got = tqmm.quant_matmul_stacked(
        _t(x), _t(w), _t(scale), 1, bias3=_t(bias), ab=_t(ab), resid=_t(resid),
        gate=_t(gate), **kw)
    want = np.asarray(want, np.float32)
    _assert_one_bf16_rounding(got.float().numpy(), want,
                              scale=np.abs(want - resid).max())


QKV_CASES = [
    # (m, w8a8, head_dim, k, boundary)
    (12, True, 64, 3072, 7),
    (12, False, 64, 3072, 7),
    (136, True, 32, 3072, 128),
    (4, True, 64, 2000, 2),   # no whole k tile: composed around the product
]


@pytest.mark.parametrize("m, w8a8, head_dim, k, boundary", QKV_CASES)
def test_qkv_ln_prologue_matches_jax_kernel(jax_stats, m, w8a8, head_dim, k,
                                           boundary):
    h, nb, blk = 128, 3, 1
    x, w, scale, bias = _operands(13, m, k, 3 * h, nb)
    ab = _ab(14, k)
    if w8a8:
        group = (tqmm.stacked_w8a8_group(k, 3 * h)[0] if tqmm.qkv_supported(
            k, 3 * h, head_dim) else tqmm.flat_w8a8_group(k, 3 * h)[0])
        ab = _untie_prologue(x, ab, boundary, group,
                             composed=not tqmm.qkv_supported(k, 3 * h,
                                                             head_dim))
    rng = np.random.default_rng(15)
    norm_w = np.stack([rng.uniform(0.5, 1.5, h), rng.uniform(0.5, 1.5, h),
                       np.ones(h)]).astype(np.float32)
    want = jqmm.quant_qkv_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(norm_w), jnp.int32(blk), head_dim, interpret=True,
        w8a8=w8a8, ab=jnp.asarray(ab), seg_boundary=boundary)
    got = tqmm.quant_qkv_stacked(
        _t(x), _t(w), _t(scale), _t(bias), _t(norm_w), blk, head_dim,
        w8a8=w8a8, ab=_t(ab), seg_boundary=boundary)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (m, h)
        _assert_one_bf16_rounding(g.float().numpy(), wnt)


def test_fused_forms_reject_bad_operands():
    x, w, scale, bias = _operands(16, 4, 3072, 256, 2)
    args = (_t(x), _t(w), _t(scale), 1)
    with pytest.raises(ValueError, match="resid and gate"):
        tqmm.quant_matmul_stacked(*args, resid=torch.zeros(4, 256))
    with pytest.raises(ValueError, match="ab must be"):
        tqmm.quant_matmul_stacked(*args, ab=torch.zeros(4, 3072))
    with pytest.raises(ValueError, match="gate must be"):
        tqmm.quant_matmul_stacked(*args, resid=torch.zeros(4, 256),
                                  gate=torch.zeros(2, 256))


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


def _grad_operands(x_dtype):
    m, k, n, nb, blk, boundary = 12, 3072, 256, 2, 1, 7
    x, w, scale, bias = _operands(17, m, k, n, nb)
    x = _bf16_np(x)
    rng = np.random.default_rng(18)
    dy = _bf16_np(rng.standard_normal((m, n)).astype(np.float32))
    return (x.astype(x_dtype), w, scale, bias, dy, m, k, n, blk, boundary)


@pytest.mark.parametrize("act", [None, "gelu_tanh"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_ln_mod_linear_grads_match_jax(jax_stats, act, x_dtype):
    """d/dx and d/dab of <y, dy> through the LN-prologue Function against
    jax.grad through quant_ln_mod_linear_stacked (weight-only, as the
    training step runs); cotangents come back in the primal dtypes."""
    x, w, scale, bias, dy, m, k, n, blk, boundary = _grad_operands(
        np.float32)
    ab = _ab(19, k)

    def jloss(x, ab):
        y = jqmm.quant_ln_mod_linear_stacked(
            boundary, act, x, jnp.asarray(w), jnp.asarray(scale),
            jnp.asarray(bias), ab, jnp.int32(blk))
        return jnp.sum(y.astype(jnp.float32) * dy)

    jx = jnp.asarray(x).astype(x_dtype)
    jdx, jdab = jax.grad(jloss, argnums=(0, 1))(jx, jnp.asarray(ab))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    tx.requires_grad_(True)
    tab = _t(ab).requires_grad_(True)
    y = tqmm.quant_ln_mod_linear_stacked(
        tx, _t(w), _t(scale), _t(bias), tab, blk, seg_boundary=boundary,
        activation=act)
    assert y.dtype == torch.bfloat16
    (y.float() * _t(dy)).sum().backward()
    assert tx.grad.dtype == getattr(torch, x_dtype) and str(jdx.dtype) == x_dtype
    assert tab.grad.dtype == torch.float32 and jdab.dtype == jnp.float32
    # dx: the LN backward of the transposed kernel's bf16 output, whose
    # roundings flip where the two gelu derivatives differ in an ulp
    _assert_one_bf16_rounding(tx.grad.float().numpy(),
                              np.asarray(jdx, np.float32))
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(jdab), rtol=1e-4,
                               atol=1e-5 * np.abs(jdab).max())
    assert not tab.grad[4:].any()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gate_res_linear_grads_match_jax(x_dtype):
    x, w, scale, bias, dy, m, k, n, blk, boundary = _grad_operands(
        np.float32)
    gate = _gate(20, n)
    resid = np.random.default_rng(21).standard_normal((m, n)).astype(
        np.float32)

    def jloss(x, resid, gate):
        y = jqmm.quant_gate_res_linear_stacked(
            boundary, x, jnp.asarray(w), jnp.asarray(scale),
            jnp.asarray(bias), resid, gate, jnp.int32(blk))
        return jnp.sum(y.astype(jnp.float32) * dy)

    jx = jnp.asarray(x).astype(x_dtype)
    jr = jnp.asarray(resid).astype(x_dtype)
    jdx, jdr, jdg = jax.grad(jloss, argnums=(0, 1, 2))(jx, jr,
                                                       jnp.asarray(gate))
    dt = getattr(torch, x_dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(dt).requires_grad_(True)
    tr = _t(np.asarray(jr.astype(jnp.float32))).to(dt).requires_grad_(True)
    tg = _t(gate).requires_grad_(True)
    y = tqmm.quant_gate_res_linear_stacked(
        tx, _t(w), _t(scale), _t(bias), tr, tg, blk, seg_boundary=boundary)
    (y.float() * _t(dy)).sum().backward()
    assert tx.grad.dtype == tr.grad.dtype == dt
    assert str(jdx.dtype) == str(jdr.dtype) == x_dtype
    assert tg.grad.dtype == torch.float32 and jdg.dtype == jnp.float32
    _assert_one_bf16_rounding(tx.grad.float().numpy(),
                              np.asarray(jdx, np.float32))
    np.testing.assert_array_equal(tr.grad.float().numpy(),
                                  np.asarray(jdr, np.float32))
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(jdg), rtol=1e-4,
                               atol=1e-5 * np.abs(jdg).max())
    assert not tg.grad[2:].any()


# ---------------------------------------------------------------------------
# The DiT with both flags
# ---------------------------------------------------------------------------

DOUBLE_FUSABLE = ("attn/to_q", "attn/to_k", "attn/to_v", "attn/to_out",
                  "ff/in", "ff/out")
SINGLE_FUSABLE = ("attn/to_q", "attn/to_k", "attn/to_v", "proj_mlp",
                  "proj_out")


def _fusable_only(path, leaf):
    """The linears the fused forms take: weight-only, the port's plain
    unfused product multiplies float32 activations in float32 (the XLA
    dequant path) while JAX's stacked kernel rounds them to bf16, so only
    these are quantized and every int8 product on both sides is a fused
    kernel form."""
    head, _, rest = path.partition("/")
    return ((head == "double_blocks" and rest in DOUBLE_FUSABLE)
            or (head == "single_blocks" and rest in SINGLE_FUSABLE))


def _stacks_only(path, leaf):
    return path.startswith(("double_blocks", "single_blocks"))


def _inputs(seed=0, b=1):
    rng = np.random.default_rng(seed)
    s_img, s_txt = 16, 4
    ids = np.array(j_ids(8, 8))
    cond_ids = ids.copy()
    cond_ids[:, 2] += 4.0
    return dict(
        img=rng.standard_normal((b, s_img, CFG.in_channels), np.float32),
        txt=rng.standard_normal((b, s_txt, CFG.joint_dim), np.float32),
        pooled=rng.standard_normal((b, CFG.pooled_dim), np.float32),
        timestep=np.full((b,), 0.5, np.float32),
        guidance=np.full((b,), 3.5, np.float32),
        img_ids=ids, txt_ids=np.zeros((s_txt, 3), np.float32),
        cond=rng.standard_normal((b, s_img, CFG.in_channels), np.float32),
        cond_ids=cond_ids)


def _serving_params(seed, predicate):
    g = torch.Generator().manual_seed(seed)
    tree = tmodel.init_flux_params(TCFG, generator=g, dtype=torch.float32,
                                   device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy_tree(tree))
    return jquant.split_single_proj_out(
        jquant.fuse_qkv_projections(jquant.quantize_tree(params, predicate)),
        CFG.hidden)


def _torch_forward(params, arrays, **kw):
    tparams = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
    with torch.inference_mode():
        return tmodel.flux_forward(
            tparams, TCFG, **{k: _t(v) for k, v in arrays.items()}, **kw
        ).numpy()


def _jax_forward(monkeypatch, params, arrays, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    # the knobs are read at trace time: no forward traced without them
    jax.clear_caches()
    try:
        return np.asarray(jmodel.flux_forward(
            params, CFG, **{k: jnp.asarray(v) for k, v in arrays.items()}))
    finally:
        for name in env:
            monkeypatch.delenv(name)
        jax.clear_caches()


class _Spy:
    """Counts the fused forms the model hands to the kernel wrappers."""

    def __init__(self, monkeypatch):
        self.ln = self.gate = 0
        stacked, qkv = tqmm.quant_matmul_stacked, tqmm.quant_qkv_stacked

        def spy_stacked(*a, ab=None, resid=None, **kw):
            self.ln += ab is not None
            self.gate += resid is not None
            return stacked(*a, ab=ab, resid=resid, **kw)

        def spy_qkv(*a, ab=None, **kw):
            self.ln += ab is not None
            return qkv(*a, ab=ab, **kw)

        monkeypatch.setattr(tqmm, "quant_matmul_stacked", spy_stacked)
        monkeypatch.setattr(tqmm, "quant_qkv_stacked", spy_qkv)


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
def test_flux_forward_fused_matches_jax(monkeypatch, w8a8):
    """fuse_ln + fuse_gate at B 1 with cond, int8 stacks, fused qkv and the
    split proj_out, against JAX's forward under LOONGX_FUSE_LN=1
    LOONGX_FUSE_GATE=1.  As in tests/test_torch_flux.py's W8A8 forward, the
    float32 differences of a whole forward (summation orders, XLA's fma in
    the prologue) now and then flip the bf16 rounding of a prologue output
    or an int8 activation, which moves that row by ~1e-3; the tiny
    config's W8A8 group is its whole K of 64, so one flip weighs more than
    at full width.  Seeds 0-7 read max 6e-5 to 3.8e-3, median 2e-7 to
    3.5e-4, and an error 0.000 to 0.27 times the distance of the port's
    unfused forward to JAX's fused one (both modes).  So: max FUSED_ATOL,
    median FUSED_MEDIAN, and under half that distance (the comparison sees
    the fusions)."""
    params = _serving_params(5, _stacks_only if w8a8 else _fusable_only)
    arrays = _inputs(5)
    env = dict(FUSE_ENV, LOONGX_W8A8="1" if w8a8 else "0")
    want = _jax_forward(monkeypatch, params, arrays, env)
    spy = _Spy(monkeypatch)
    got = _torch_forward(params, arrays, w8a8=w8a8, fuse_ln=True,
                         fuse_gate=True)
    # per forward: 2 prologues in each double block (qkv, ff.in) and in each
    # single block (proj_mlp, qkv); 2 gates in each (to_out / ff.out,
    # proj_out / proj_out_mlp)
    n_blocks = CFG.num_double_blocks + CFG.num_single_blocks
    assert (spy.ln, spy.gate) == (2 * n_blocks, 2 * n_blocks)
    unfused = _torch_forward(params, arrays, w8a8=w8a8)
    np.testing.assert_allclose(got, want, atol=FUSED_ATOL, rtol=0)
    assert np.median(np.abs(got - want)) < FUSED_MEDIAN
    err, noise = np.linalg.norm(got - want), np.linalg.norm(unfused - want)
    assert err < 0.5 * noise, (err, noise)


def test_flux_forward_fused_flags_unfused_at_batch_2(monkeypatch):
    """At B 2 (and for a linear with active LoRA) the flags change nothing:
    the same composition around the matmul as without them, bit for bit,
    as the JAX package's _elementwise_fusable / ln_in_kernel route."""
    params = _serving_params(6, _stacks_only)
    arrays = _inputs(6, b=2)
    plain = _torch_forward(params, arrays, w8a8=True)
    spy = _Spy(monkeypatch)
    fused = _torch_forward(params, arrays, w8a8=True, fuse_ln=True,
                           fuse_gate=True)
    assert spy.ln == spy.gate == 0
    np.testing.assert_array_equal(fused, plain)
    x = jnp.zeros((2, 4, CFG.hidden))
    p = {"kernel_q": jnp.zeros((2, CFG.hidden, 8), jnp.int8), "_blk": 0}
    monkeypatch.setenv("LOONGX_FUSE_LN", "1")
    assert not jmodel._elementwise_fusable(p, x, True)
    assert jmodel._elementwise_fusable(p, x[:1], True)
    assert not tmodel._elementwise_fusable(p, torch.zeros(2, 4, 1), True, True)
    assert tmodel._elementwise_fusable(p, torch.zeros(1, 4, 1), True, True)
    p["lora_a"] = None
    assert not tmodel._elementwise_fusable(p, torch.zeros(1, 4, 1), True, True)
    assert tmodel._elementwise_fusable(p, torch.zeros(1, 4, 1), False, True)


# ---------------------------------------------------------------------------
# The edit and the train step
# ---------------------------------------------------------------------------

SIZE, STEPS = 16, 2
ECFG = dataclasses.replace(CFG, joint_dim=4096, pooled_dim=768)
TECFG = dataclasses.replace(TCFG, joint_dim=4096, pooled_dim=768)
JVAE, TVAE = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()


def test_neural_edit_fused_matches_jax(monkeypatch):
    """The tiny W8A8 neural_edit (int8 stacks, fused qkv, split proj_out)
    with both flags against JAX's (its fused_edit_program) under the fuse
    knobs, fed the same latents and VAE-sample noise; the bound of the
    forward test above, the edit being two such forwards and a VAE."""
    kw = dict(generator=torch.Generator().manual_seed(0), dtype=torch.float32,
              device="cpu")
    flux = tmodel.init_flux_params(TECFG, **kw)
    tree = {"vae": tvae.init_vae_params(TVAE, **kw),
            "encoders": {n: getattr(tenc, f"init_{n}_encoder")(**kw)
                         for n in ("eeg", "ppg", "fnirs", "motion")},
            "dgf": tfus.init_dgf(**kw)}
    params = jax.tree.map(jnp.asarray, to_numpy_tree(tree))
    fparams = jax.tree.map(jnp.asarray, to_numpy_tree(flux))
    params["flux"] = jquant.split_single_proj_out(
        jquant.fuse_qkv_projections(
            jquant.quantize_tree(fparams, _stacks_only)), ECFG.hidden)
    jpipe = types.SimpleNamespace(flux_cfg=ECFG, vae_cfg=JVAE, params=params,
                                  dtype=jnp.float32, adapters=None)
    tpipe = LoongXPipeline(TECFG, TVAE, from_numpy_tree(
        jax.tree.map(np.asarray, params), "cpu"), torch.float32)
    rng = np.random.default_rng(3)
    sig = dict(eeg=rng.standard_normal((1, 4, 512), np.float32),
               ppg=rng.standard_normal((1, 4, 256), np.float32),
               fnirs=rng.standard_normal((1, 6, 512), np.float32),
               motion=rng.standard_normal((1, 6, 128), np.float32))
    cond_image = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
    ekw = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
               position_delta=(0, SIZE // JVAE.downscale // 2), **sig)
    for name, value in dict(FUSE_ENV, LOONGX_W8A8="1").items():
        monkeypatch.setenv(name, value)
    jax.clear_caches()
    try:
        want = jgen.neural_edit(jpipe, cond_image, seed=5, **ekw)
    finally:
        jax.clear_caches()
    k_lat, k_enc = jax.random.split(jax.random.key(5))
    lat_hw = SIZE // JVAE.downscale
    latents = np.asarray(jax.random.normal(
        k_lat, (1, lat_hw // 2, lat_hw // 2, ECFG.in_channels), jnp.float32)
    ).reshape(1, -1, ECFG.in_channels)
    noise = np.asarray(jax.random.normal(
        k_enc, (1, lat_hw, lat_hw, JVAE.latent_channels), jnp.float32))
    spy = _Spy(monkeypatch)
    got = tgen.neural_edit(tpipe, cond_image, latents=_t(latents),
                           cond_noise=_t(noise), w8a8=True, fuse_ln=True,
                           fuse_gate=True, **ekw)
    n_blocks = ECFG.num_double_blocks + ECFG.num_single_blocks
    assert (spy.ln, spy.gate) == (STEPS * 2 * n_blocks, STEPS * 2 * n_blocks)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, atol=FUSED_ATOL, rtol=0)
    assert np.median(np.abs(got - want)) < FUSED_MEDIAN


def test_generate_fused_matches_jax(monkeypatch):
    """generate() with both flags on the precomputed-embeds path (W8A8 int8
    stacks, a condition-token stream, latents out) against JAX's under the
    fuse knobs, fed the same latents; the forward test's bounds, and
    closer to JAX's than the port's unfused generate() is."""
    from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
    from loongx_tpu.models.text import clip as jclip
    from loongx_tpu.models.text import t5 as jt5

    params = {"flux": _serving_params(11, _stacks_only)}
    jp = JPipeline(CFG, JVAE, jt5.T5Config.tiny(),
                   jclip.CLIPTextConfig.tiny(), dict(params),
                   dtype=jnp.float32)
    tp = LoongXPipeline(TCFG, TVAE, from_numpy_tree(
        jax.tree.map(np.asarray, params), "cpu"), torch.float32)
    a = _inputs(11)
    kw = dict(prompt_embeds=a["txt"], pooled_prompt_embeds=a["pooled"],
              cond_tokens=a["cond"][0], cond_ids=a["cond_ids"], height=SIZE,
              width=SIZE, num_inference_steps=STEPS, output_type="latent")
    for name, value in dict(FUSE_ENV, LOONGX_W8A8="1").items():
        monkeypatch.setenv(name, value)
    jax.clear_caches()
    try:
        want = np.asarray(jgen.generate(
            jp, seed=7, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v for k, v in kw.items()}))
    finally:
        jax.clear_caches()
    lat = SIZE // JVAE.downscale
    latents = np.array(jax.random.normal(
        jax.random.split(jax.random.key(7))[0],
        (1, lat // 2, lat // 2, CFG.in_channels), jnp.float32))
    spy = _Spy(monkeypatch)
    got = tgen.generate(
        tp, latents=_t(latents.reshape(1, -1, CFG.in_channels)),
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, w8a8=True, fuse_ln=True,
        fuse_gate=True).numpy()
    n_blocks = CFG.num_double_blocks + CFG.num_single_blocks
    assert (spy.ln, spy.gate) == (STEPS * 2 * n_blocks, STEPS * 2 * n_blocks)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FUSED_ATOL, rtol=0)
    assert np.median(np.abs(got - want)) < FUSED_MEDIAN
    unfused = tgen.generate(
        tp, latents=_t(latents.reshape(1, -1, CFG.in_channels)),
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, w8a8=True).numpy()
    err, noise = np.linalg.norm(got - want), np.linalg.norm(unfused - want)
    assert err < 0.5 * noise, (err, noise)


def test_train_step_fused_ln_matches_jax(monkeypatch):
    """One step with fuse_ln: the tiny int8 tree with DEFAULT_TARGETS LoRA,
    where only the double blocks' ff.in is fusable (the other LoRA-free
    linears are not quantized, see `_fusable_only`), against JAX's
    make_train_step under LOONGX_FUSE_LN=1 fed the same draws (SGD, no
    clipping): the loss, every LoRA gradient and the updated LoRA leaves.
    The rest of the step is float32 on both sides; ff.in rounds its
    prologue output to bf16 in both, and a flip of one such rounding
    between the two moves a gradient by about 1e-3 of its norm."""
    g = torch.Generator().manual_seed(8)
    tree = tmodel.init_flux_params(TCFG, generator=g, dtype=torch.float32,
                                   device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy_tree(tree))
    params = jquant.quantize_tree(
        params, lambda path, leaf: path == "double_blocks/ff/in")
    params = jlora.add_lora(jax.random.key(1), params, r=2, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 * jnp.asarray(np.random.default_rng(
            x.size).standard_normal(x.shape), x.dtype)
        if path[-1].key == "lora_b" else x, params)
    assert "lora_a" not in params["double_blocks"]["ff"]["in"]
    assert "kernel_q" in params["double_blocks"]["ff"]["in"]
    arrays = _inputs(9)
    batch = {"x0": arrays["img"], "cond_tokens": arrays["cond"],
             "img_ids": arrays["img_ids"], "cond_ids": arrays["cond_ids"],
             "txt_ids": arrays["txt_ids"], "prompt_embeds": arrays["txt"],
             "pooled": arrays["pooled"]}
    flags = {"latent_lora": False, "union_cond_attn": True}
    key = jax.random.key(10)
    k_t, k_noise, _ = jax.random.split(key, 3)
    draws = {"t": _t(np.array(jax.nn.sigmoid(
                 jax.random.normal(k_t, (1,), jnp.float32)))),
             "noise": _t(np.array(jax.random.normal(
                 k_noise, batch["x0"].shape, jnp.float32)))}
    jparams = {"flux": params}
    jtr, jfr = jstep.partition(jparams, jstep.trainable_mask(jparams))
    recorder = optax.GradientTransformation(
        lambda p: p, lambda updates, state, params=None: (updates, updates))
    monkeypatch.setenv("LOONGX_STACKED_QMM", "1")
    monkeypatch.setenv("LOONGX_FUSE_LN", "1")
    jax.clear_caches()
    try:
        init_fn, step_fn = jstep.make_train_step(
            CFG, optax.chain(recorder, optax.sgd(0.1)), flags=flags,
            attn_backend="xla", remat=True, grad_clip=None, dtype=jnp.float32)
        jstate, jm = jax.jit(step_fn)(init_fn(jtr), jfr,
                                      {k: jnp.asarray(v) for k, v in
                                       batch.items()}, key)
    finally:
        jax.clear_caches()
    jgrads = jlora.lora_state_dict(jstate.opt_state[0]["flux"])
    jafter = jlora.lora_state_dict(jstate.trainable["flux"])

    tparams = {"flux": from_numpy_tree(jax.tree.map(np.asarray, params),
                                       "cpu")}
    ttr, tfr = tstep.partition(tparams, tstep.trainable_mask(tparams))
    leaves = tlora.lora_state_dict(ttr["flux"])
    spy = _Spy(monkeypatch)
    loss, _ = tstep.flow_match_loss(
        tstep.combine(ttr, tfr), TCFG, {k: _t(v) for k, v in batch.items()},
        draws, flags, remat=True, dtype=torch.float32, fuse_ln=True)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    # ff.in of each double block, in the forward and again in the remat
    assert (spy.ln, spy.gate) == (2 * CFG.num_double_blocks, 0)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-4)
    init_t, step_t = tstep.make_train_step(
        TCFG, build_optimizer({"type": "SGD", "params": {"lr": 0.1}}),
        flags=flags, remat=True, grad_clip=None, dtype=torch.float32,
        fuse_ln=True)
    state, m = step_t(init_t(ttr), tfr, {k: _t(v) for k, v in batch.items()},
                      draws)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    after = tlora.lora_state_dict(state.trainable["flux"])
    for key_, grad in zip(leaves, grads):
        want = np.asarray(jgrads[key_])
        if not np.abs(want).max() > 0:
            np.testing.assert_array_equal(grad.numpy(), want, key_)
            continue
        rel = np.linalg.norm(grad.numpy() - want) / np.linalg.norm(want)
        assert rel < 2e-3, (key_, rel)
        # SGD at lr 0.1: the gradient's bound, plus one float32 rounding
        # of the updated leaf
        jleaf = np.asarray(jafter[key_])
        np.testing.assert_allclose(
            after[key_].detach().numpy(), jleaf, rtol=0,
            atol=2e-3 * 0.1 * np.abs(want).max()
            + np.spacing(np.abs(jleaf).max()))
