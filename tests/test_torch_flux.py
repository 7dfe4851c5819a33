"""The PyTorch port's FLUX DiT and weight bridge against the JAX package.

Tiny config, float32, the same numpy inputs through both; ATOL 2e-4 as in
tests/test_golden_torch.py.  The port's int8 linears always take the
quant-matmul wrappers, whose CPU path is the plain version: weight-only it
computes the JAX package's XLA dequant product, W8A8 it reproduces the TPU
kernel (run here in interpret mode through LOONGX_STACKED_QMM=1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

ATOL = 2e-4
CFG = jmodel.FluxConfig.tiny()
TCFG = tmodel.FluxConfig.tiny()


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _inputs(seed=0, cond=True):
    rng = np.random.default_rng(seed)
    b, s_img, s_txt = 1, 16, 4
    arrays = dict(
        img=rng.standard_normal((b, s_img, CFG.in_channels), np.float32),
        txt=rng.standard_normal((b, s_txt, CFG.joint_dim), np.float32),
        pooled=rng.standard_normal((b, CFG.pooled_dim), np.float32),
        timestep=np.full((b,), 0.5, np.float32),
        guidance=np.full((b,), 3.5, np.float32),
        img_ids=np.array(j_ids(8, 8)),
        txt_ids=np.zeros((s_txt, 3), np.float32),
    )
    if cond:
        arrays["cond"] = rng.standard_normal((b, s_img, CFG.in_channels),
                                             np.float32)
        ids = np.array(j_ids(8, 8))
        ids[:, 2] += 4.0
        arrays["cond_ids"] = ids
    return arrays


def _forward_both(params, arrays, **kw):
    jkw = dict(kw)
    jkw.pop("w8a8", None)  # JAX reads the serving mode from LOONGX_W8A8
    if jkw.get("c_factor") is not None:
        jkw["c_factor"] = jnp.float32(jkw["c_factor"])
    want = jmodel.flux_forward(
        params, CFG, **{k: jnp.asarray(v) for k, v in arrays.items()}, **jkw)
    tparams = from_numpy_tree(_np_tree(params), device="cpu")
    got = tmodel.flux_forward(
        tparams, TCFG, **{k: torch.from_numpy(v) for k, v in arrays.items()},
        **kw)
    return got.numpy(), np.asarray(want)


def _init(seed=0):
    return jmodel.init_flux_params(jax.random.key(seed), CFG, dtype=jnp.float32)


def _assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or isinstance(a, np.ndarray), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), path)


@pytest.mark.parametrize("form", ["float32", "bf16", "serving_int8"])
def test_bridge_round_trip(form):
    params = _init()
    if form == "bf16":
        params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    elif form == "serving_int8":
        params = jquant.split_single_proj_out(
            jquant.fuse_qkv_projections(jquant.quantize_tree(params)),
            CFG.hidden)
        assert "to_qkv" in params["double_blocks"]["attn"]
        assert "proj_out_mlp" in params["single_blocks"]
    src = _np_tree(params)
    tparams = from_numpy_tree(src, device="cpu")
    if form == "serving_int8":
        assert tparams["double_blocks"]["attn"]["to_qkv"]["kernel_q"].dtype == torch.int8
        assert tparams["double_blocks"]["attn"]["to_qkv"]["kernel_q"].shape == (
            CFG.num_double_blocks, CFG.hidden, 3 * CFG.hidden)
    _assert_trees_equal(src, to_numpy_tree(tparams))


def test_bridge_rejects_unknown_leaf():
    src = _np_tree(_init())
    src["x_embedder"]["kernel_typo"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="x_embedder/kernel_typo"):
        from_numpy_tree(src, device="cpu")


def test_bridge_keeps_lora_leaves():
    src = _np_tree(_init())
    lin = src["double_blocks"]["attn"]["to_q"]
    nb = CFG.num_double_blocks
    lin["lora_a"] = np.ones((nb, CFG.hidden, 2), np.float32)
    lin["lora_b"] = np.ones((nb, 2, CFG.hidden), np.float32)
    lin["lora_scale"] = np.full((nb,), 0.5, np.float32)
    got = from_numpy_tree(src, device="cpu")["double_blocks"]["attn"]["to_q"]
    assert set(got) == {"kernel", "bias", "lora_a", "lora_b", "lora_scale"}


@pytest.mark.parametrize("cond", [True, False])
def test_flux_forward_plain_weights(cond):
    got, want = _forward_both(_init(), _inputs(cond=cond))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("flags, c_factor", [
    ({"union_cond_attn": False}, None),
    ({"independent_condition": True}, None),
    ({}, 0.5),
])
def test_flux_forward_attention_modes(flags, c_factor):
    got, want = _forward_both(_init(1), _inputs(1), flags=flags,
                              c_factor=c_factor)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_flux_forward_lora_segment_gating():
    """LoRA leaves ride the plain path with the [img | cond] segment masks."""
    params = _init(2)
    rng = np.random.default_rng(2)
    for tree, name in ((params["double_blocks"]["attn"], "to_q"),
                       (params["single_blocks"], "proj_mlp")):
        nb, k, n = tree[name]["kernel"].shape
        tree[name] = dict(tree[name])
        tree[name]["lora_a"] = jnp.asarray(
            0.1 * rng.standard_normal((nb, k, 2)), jnp.float32)
        tree[name]["lora_b"] = jnp.asarray(
            0.1 * rng.standard_normal((nb, 2, n)), jnp.float32)
        tree[name]["lora_scale"] = jnp.full((nb,), 0.5, jnp.float32)
    got, want = _forward_both(params, _inputs(2))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_flux_forward_int8_weight_only():
    """Every linear int8, fused qkv + split proj_out; JAX's default CPU
    routing dequantizes in XLA."""
    params = jquant.split_single_proj_out(
        jquant.fuse_qkv_projections(jquant.quantize_tree(_init(3))),
        CFG.hidden)
    got, want = _forward_both(params, _inputs(3))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_flux_forward_w8a8_stacked(monkeypatch):
    """W8A8 on the block stacks (the TPU kernels in interpret mode); the flat
    linears stay float32 on both sides (JAX routes flat int8 linears through
    its kernels only on a TPU).

    The kernels agree exactly on equal inputs (test_torch_quant.py), but a
    whole forward carries float32 differences of ~3e-7 between torch and
    XLA (attention, layer norm), and now and then one of them flips the
    bf16 rounding of an activation just ahead of its int8 quantization,
    which moves that row's outputs by ~1e-3 (seeds 0-7: max 3e-4 to
    1.7e-3, relative L2 6e-5 to 4.3e-4).  So the bound is one such flip
    (2e-3 absolute), most elements within ATOL, and the port closer to
    JAX's W8A8 than W8A8 itself sits to the weight-only product."""
    params = _init(4)
    stacks_only = lambda path, leaf: path.startswith(
        ("double_blocks", "single_blocks"))
    params = jquant.split_single_proj_out(
        jquant.fuse_qkv_projections(
            jquant.quantize_tree(params, predicate=stacks_only)),
        CFG.hidden)
    assert "kernel" in params["x_embedder"]
    monkeypatch.setenv("LOONGX_STACKED_QMM", "1")
    monkeypatch.setenv("LOONGX_W8A8", "1")
    jax.clear_caches()
    arrays = _inputs(4)
    got, want = _forward_both(params, arrays, w8a8=True)
    jax.clear_caches()
    weight_only = tmodel.flux_forward(
        from_numpy_tree(_np_tree(params), device="cpu"), TCFG,
        **{k: torch.from_numpy(v) for k, v in arrays.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    assert np.median(np.abs(got - want)) < ATOL
    err, noise = (np.linalg.norm(got - want),
                  np.linalg.norm(weight_only - want))
    assert err < 0.5 * noise, (err, noise)


def test_controlnet_inputs_not_ported():
    """ControlNet residual inputs are ported (they raised before): zero
    residuals leave the velocity as it is, a nonzero one moves it.  Their
    values against JAX: tests/test_torch_controlnet_signal.py."""
    tparams = from_numpy_tree(_np_tree(_init()), device="cpu")
    arrays = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    shape = (1, 1, 16, CFG.hidden)
    base = tmodel.flux_forward(tparams, TCFG, **arrays)
    zero = tmodel.flux_forward(
        tparams, TCFG, **arrays, controlnet_block_samples=torch.zeros(shape),
        controlnet_single_block_samples=torch.zeros(shape))
    moved = tmodel.flux_forward(
        tparams, TCFG, **arrays,
        controlnet_block_samples=torch.randn(
            shape, generator=torch.Generator().manual_seed(0)))
    torch.testing.assert_close(zero, base, rtol=0, atol=0)
    assert (moved - base).abs().max() > 1e-2
