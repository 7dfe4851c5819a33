"""The int8 linear's bf16 output route (`models/flux/model.py::linear`).

An int8 linear returns its kernel's output: the bias in the kernel's fp32
epilogue, an active LoRA as one rank-r update ((x A) * scale * mask) B of
that output, in training inside the kernel's autograd Function
(``ops/quant_matmul.py::_QuantLoraLinearFn``).  Held here, at tiny widths:

  * to the float32 composition the port ran before (the kernel's output
    widened, (xA)B * scale * mask and the bias added in float32, one cast
    back), forward and gradients, at bf16, stacked and flat leaves, with
    and without the row mask; and through `linear_gelu`'s LoRA fallback;
  * to the JAX package's `linear`: float32 at the flux tests' ATOL, bf16
    within the bound below;
  * to its mechanism: no aten op of a LoRA linear's forward or backward
    returns a float32 tensor of [M, N] or [M, K] elements (the kernels'
    plain versions, which widen on the CPU, are taken as the opaque
    kernels they are on the card), and the ``int8_linear:*`` counters.

Tolerances.  The old composition rounds x W s to bf16, then the float32 sum
of it, the delta and the bias; the new one rounds x W s + b in the
kernel's epilogue, the [M, r] factor once more when lora_scale * mask is no
power of two, then the sum.  With bf16's unit roundoff u = 2^-8 and S the
sum of the terms' magnitudes, two results differ by at most about 5 u S
(each rounding moves a value by at most u times a magnitude under S).  The
gradients: dx rounds the transposed kernel's output and the LoRA term on
both sides, once more on the old side; dA and dB each round their float32
sums once on both sides, and the [M, r] factor they read at most once: 4 u
S each, S the sum of the contraction's |terms|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import quant as tquant
from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops.nn import gelu_tanh
from loongx_tpu_torch.train import lora as tlora
from loongx_tpu_torch.train import step as tstep

CFG = tmodel.FluxConfig.tiny()
U = 2.0 ** -8  # bf16's unit roundoff
ATOL = 2e-4  # tests/test_torch_flux.py's
B, S = 2, 24  # M = 48 rows


def _tree(dtype=torch.bfloat16, alpha=2, seed=0):
    """A tiny int8 FLUX tree with LoRA r 4 on the default targets, B off
    zero (lora_scale alpha / 4)."""
    g = torch.Generator().manual_seed(seed)
    tree = tmodel.init_flux_params(CFG, generator=g, dtype=dtype,
                                   device="cpu")
    tree = tlora.add_lora(tquant.quantize_tree(tree), r=4, alpha=alpha,
                          dtype=dtype, generator=g)

    def nudge(t):
        for k, v in t.items():
            if k == "lora_b":
                t[k] = (0.05 * torch.randn(v.shape, generator=g)).to(dtype)
            elif isinstance(v, dict):
                nudge(v)

    nudge(tree)
    return tree


def _leaf(tree, kind):
    """stacked: block 1 of the single blocks' proj_mlp (K 64, N 256);
    flat: x_embedder (K 16, N 64); nobias: the stacked leaf without bias."""
    if kind == "flat":
        return tree["x_embedder"]
    leaf = tmodel._block_view(tree["single_blocks"], 1)["proj_mlp"]
    if kind == "nobias":
        leaf = {k: v for k, v in leaf.items() if k != "bias"}
    return leaf


def _mask(dtype):
    """The fused stream's row mask: LoRA on the last 8 rows of each row
    (condition tokens), as `_seg_lora` builds it."""
    return torch.cat([torch.zeros(S - 8, 1, dtype=dtype),
                      torch.ones(8, 1, dtype=dtype)])


def _x(leaf, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    k = leaf["kernel_q"].shape[-2]
    return torch.randn(B, S, k, generator=g).to(dtype)


def _old_linear(p, x, lora_mask=None):
    """The composition `linear` ran before: the kernel's output widened,
    the delta and the bias added in float32, one cast back."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2, n = x.reshape(-1, k), p["kernel_q"].shape[-1]
    if "_blk" in p:
        nb = p["kernel_q"].shape[0]
        y = qmm.quant_matmul_stacked_vjp(
            x2, p["kernel_q"], p["kernel_scale"].reshape(nb, 1, n), p["_blk"])
    else:
        y = qmm.quant_matmul_vjp(x2, p["kernel_q"],
                                 p["kernel_scale"].reshape(1, n))
    y = y.float().reshape(*lead, -1)
    xa = torch.matmul(x.float(), p["lora_a"].float()).to(x.dtype)
    delta = torch.matmul(xa.float(), p["lora_b"].float()) * p["lora_scale"]
    if lora_mask is not None:
        delta = delta * lora_mask
    y = y + delta
    if "bias" in p:
        b = p["bias"][p["_blk"]] if "_blk" in p else p["bias"]
        y = y + b.float()
    return y.to(x.dtype)


def _dense(p):
    """(W * scale, bias, A, B, lora_scale) of the leaf's block, float64."""
    blk = p.get("_blk")
    pick = (lambda t: t) if blk is None else (lambda t: t[blk])
    w = pick(p["kernel_q"]).double() * pick(p["kernel_scale"]).double()
    bias = (pick(p["bias"]).double() if "bias" in p
            else torch.zeros(w.shape[-1], dtype=torch.float64))
    return (w.reshape(w.shape[-2:]), bias.reshape(-1), p["lora_a"].double(),
            p["lora_b"].double(), float(p["lora_scale"]))


def _magnitude(p, x, lora_mask):
    """S: |x| |W s| + |b| + |(x A) B scale mask| elementwise, float64."""
    w, bias, a, b, scale = _dense(p)
    xd = x.double()
    s = xd.abs() @ w.abs() + bias.abs()
    delta = (xd.abs() @ a.abs()) @ b.abs() * abs(scale)
    if lora_mask is not None:
        delta = delta * lora_mask.double()
    return s + delta


@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("alpha", [2, 3], ids=["scale0.5", "scale0.75"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["stacked", "flat", "nobias"])
def test_linear_matches_float32_composition(kind, masked, alpha, grad):
    """`linear` on an int8 LoRA leaf equals the old float32 composition
    within 5 u S (module docstring), returning x's dtype."""
    tree = _tree(alpha=alpha)
    p = _leaf(tree, kind)
    x = _x(p, torch.bfloat16)
    mask = _mask(torch.bfloat16) if masked else None
    with torch.set_grad_enabled(grad):
        got = tmodel.linear(p, x, True, mask)
        want = _old_linear(p, x, mask)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.double() - want.double()).abs()
    assert bool((err <= 5 * U * _magnitude(p, x, mask) + 1e-12).all()), (
        float(err.max()))
    if mask is not None:  # rows without LoRA: the kernel's output alone
        no_lora = tmodel.linear(p, x, False)
        torch.testing.assert_close(got[:, :S - 8].float(),
                                   no_lora[:, :S - 8].float(), rtol=0, atol=0)


@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
def test_linear_gelu_lora_fallback(grad):
    """`linear_gelu` with an active LoRA: gelu_tanh over `linear`'s bf16
    output, within the forward's bound through gelu (slope under 1.13)
    and one more rounding of gelu's output on each side."""
    tree = _tree()
    p = _leaf(tree, "stacked")
    x, mask = _x(p, torch.bfloat16), _mask(torch.bfloat16)
    with torch.set_grad_enabled(grad):
        got = tmodel.linear_gelu(p, x, True, mask)
        want = gelu_tanh(_old_linear(p, x, mask))
    err = (got.double() - want.double()).abs()
    bound = 1.13 * 5 * U * _magnitude(p, x, mask) + 2 * U * want.double().abs()
    assert bool((err <= bound + 1e-12).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["stacked", "flat"])
def test_linear_matches_jax(kind, masked, dtype):
    """The port's `linear` (stacked view or flat leaf) against the JAX
    package's `linear` on the same block's flat leaf (its CPU route
    dequantizes in XLA): float32 at the flux tests' ATOL; bf16 within
    6 u S, the old composition's 5 u S and JAX's rounding of the
    dequantized weight to bf16."""
    tree = _tree(dtype=dtype, alpha=3)
    p = _leaf(tree, kind)
    x = _x(p, dtype)
    mask = _mask(dtype) if masked else None
    blk = p.get("_blk")  # the view indexes every leaf but the int8 stacks

    def j(t):
        return (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))

    jp = {k: j(p[k] if blk is None or k.startswith("lora") else p[k][blk])
          for k in ("kernel_q", "kernel_scale", "bias", "lora_a", "lora_b",
                    "lora_scale")}
    want = jmodel.linear(jp, j(x), True, None if mask is None else j(mask))
    got = tmodel.linear(p, x, True, mask)
    assert str(want.dtype) == str(got.dtype).split(".")[-1]
    want = np.asarray(want.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    else:
        err = np.abs(got.float().numpy() - want)
        bound = 6 * U * _magnitude(p, x, mask).numpy()
        assert bool((err <= bound + 1e-12).all()), float((err / bound).max())


def _grads(fn, p, x, mask, cot):
    """(dx, dA, dB) of sum(fn(p, x, mask) * cot), fresh leaves; cot in the
    output's dtype, so that dy is cot exactly and nothing is widened."""
    x = x.clone().requires_grad_(True)
    p = dict(p, lora_a=p["lora_a"].detach().clone().requires_grad_(True),
             lora_b=p["lora_b"].detach().clone().requires_grad_(True))
    (fn(p, x, mask) * cot).sum().backward()
    return x.grad, p["lora_a"].grad, p["lora_b"].grad


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("kind", ["stacked", "flat"])
def test_linear_grads_match_float32_composition(kind, masked):
    """dx, d lora_a and d lora_b through the LoRA Function equal the old
    composition's (autograd through its float32 casts) within 4 u S, S
    the sum of each contraction's |terms| (module docstring)."""
    tree = _tree(alpha=3)
    p = _leaf(tree, kind)
    x = _x(p, torch.bfloat16)
    mask = _mask(torch.bfloat16) if masked else None
    g = torch.Generator().manual_seed(2)
    cot = torch.randn(*x.shape[:-1], p["kernel_q"].shape[-1],
                      generator=g).to(torch.bfloat16)
    got = _grads(lambda q, xx, m: tmodel.linear(q, xx, True, m), p, x,
                 mask, cot)
    want = _grads(lambda q, xx, m: _old_linear(q, xx, m), p, x, mask, cot)
    for t in got:
        assert t.dtype == torch.bfloat16
    w, _, a, b, scale = _dense(p)
    dy = cot.double().reshape(-1, w.shape[-1]).abs()
    ms = abs(scale) * (torch.ones(B * S, 1, dtype=torch.float64)
                       if mask is None else mask.double().repeat(B, 1))
    xd = x.double().reshape(-1, w.shape[0]).abs()
    g_mag = (dy @ b.abs().t()) * ms
    bounds = (dy @ w.abs().t() + g_mag @ a.abs().t(),  # dx
              xd.t() @ g_mag,  # d lora_a
              ((xd @ a.abs()) * ms).t() @ dy)  # d lora_b
    for name, gt, wt, mag in zip(("dx", "da", "db"), got, want, bounds):
        err = (gt.double() - wt.double()).abs().reshape(mag.shape)
        assert bool((err <= 4 * U * mag + 1e-12).all()), (name,
                                                         float(err.max()))


class _Widened(TorchDispatchMode):
    """Records every aten op's float32 outputs of ``sizes`` elements; paused
    inside the kernel wrappers (their CPU plain versions widen; on the card
    they are single kernels writing bf16)."""

    def __init__(self, sizes):
        super().__init__()
        self.sizes, self.paused, self.hits = sizes, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.dtype == torch.float32
                        and t.numel() in self.sizes):
                    self.hits.append(str(func))
        return out


def _opaque_kernels(monkeypatch, mode):
    for name in ("quant_matmul", "quant_matmul_stacked", "quant_matmul_t",
                 "quant_matmul_t_stacked"):
        orig = getattr(qmm, name)

        def wrapped(*args, _orig=orig, **kw):
            mode.paused += 1
            try:
                return _orig(*args, **kw)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(qmm, name, wrapped)


@pytest.mark.parametrize("old", [False, True], ids=["linear", "old_control"])
def test_lora_linear_widens_no_mn_or_mk_tensor(monkeypatch, old):
    """No aten op of a LoRA linear's forward and backward returns a float32
    tensor of M N or M K elements; the old composition, run under the same
    recorder, does (the control shows the recorder sees them)."""
    tree = _tree(alpha=3)
    p = _leaf(tree, "stacked")
    x, mask = _x(p, torch.bfloat16), _mask(torch.bfloat16)
    m, k = B * S, x.shape[-1]
    n = p["kernel_q"].shape[-1]
    mode = _Widened({m * n, m * k})
    _opaque_kernels(monkeypatch, mode)
    cot = torch.ones(B, S, n, dtype=torch.bfloat16)
    fn = _old_linear if old else (
        lambda q, xx, m: tmodel.linear(q, xx, True, m))
    with mode:
        _grads(fn, p, x, mask, cot)
    assert bool(mode.hits) == old, mode.hits


def _tiny_inputs(dtype):
    g = torch.Generator().manual_seed(3)
    s_img, s_txt = 16, 8
    return dict(
        x0=torch.randn(B, s_img, CFG.in_channels, generator=g),
        cond_tokens=torch.randn(B, s_img, CFG.in_channels, generator=g),
        prompt_embeds=torch.randn(B, s_txt, CFG.joint_dim, generator=g),
        pooled=torch.randn(B, CFG.pooled_dim, generator=g),
        img_ids=torch.zeros(s_img, 3), cond_ids=torch.zeros(s_img, 3),
        txt_ids=torch.zeros(s_txt, 3))


# A forward of the tiny DiT (2 + 2 blocks, every linear int8, LoRA on the
# default targets, condition tokens, latent_lora off): x_embedder twice
# (img, cond), context_embedder, the time / guidance / pooled MLPs for temb
# and cond_temb (12), 14 linears a double block (norm1, norm1_context, q, k,
# v, add q/k/v, to_out, to_add_out, ff.in/out, ff_context.in/out), 6 a
# single block (norm, proj_mlp, q, k, v, proj_out), norm_out and proj_out.
# LoRA updates: x_embedder's cond call, 6 a double block (norm1, q, k, v,
# to_out, ff.out) and 6 a single block (norm, q, k, v, proj_mlp, proj_out).
BLOCK_CALLS, BLOCK_UPDATES = 14 * 2 + 6 * 2, 6 * 2 + 6 * 2
FORWARD_CALLS, FORWARD_UPDATES = 2 + 1 + 12 + BLOCK_CALLS + 2, 1 + BLOCK_UPDATES


def test_int8_linear_counters():
    """``int8_linear:*`` over a served forward and one remat train step:
    every int8 call returns the kernel's output (``bf16_out``), one update
    per active LoRA, none widened; remat's re-run repeats the blocks'."""
    tree = _tree()
    inp = _tiny_inputs(torch.bfloat16)
    cuda_build.LAUNCHES.clear()
    with torch.no_grad():
        tmodel.flux_forward(
            tree, CFG, img=inp["x0"].bfloat16(), txt=inp["prompt_embeds"]
            .bfloat16(), pooled=inp["pooled"].bfloat16(),
            timestep=torch.full((B,), 0.5), guidance=torch.ones(B),
            img_ids=inp["img_ids"], txt_ids=inp["txt_ids"],
            cond=inp["cond_tokens"].bfloat16(), cond_ids=inp["cond_ids"])
    counts = {k: v for k, v in cuda_build.LAUNCHES.items()
              if k.startswith("int8_linear:")}
    assert counts == {"int8_linear:bf16_out": FORWARD_CALLS,
                      "int8_linear:lora_update": FORWARD_UPDATES}, counts

    trainable, frozen = tstep.partition({"flux": tree},
                                        tstep.trainable_mask({"flux": tree}))
    init_fn, step_fn = tstep.make_train_step(
        CFG, lambda ps: torch.optim.SGD(ps, lr=1e-3), remat=True,
        grad_clip=None, dtype=torch.bfloat16)
    state = init_fn(trainable)
    cuda_build.LAUNCHES.clear()
    state, metrics = step_fn(state, frozen, inp, torch.Generator()
                             .manual_seed(4))
    assert bool(torch.isfinite(metrics["loss"]))
    counts = {k: v for k, v in cuda_build.LAUNCHES.items()
              if k.startswith("int8_linear:")}
    assert counts == {
        "int8_linear:bf16_out": FORWARD_CALLS + BLOCK_CALLS,
        "int8_linear:lora_update": FORWARD_UPDATES + BLOCK_UPDATES}, counts
    assert cuda_build.LAUNCHES["int8_linear:fp32_out"] == 0
