"""The PyTorch port's int8 quantization and quant-matmul contracts against
the JAX package, on CPU.

The weight transforms must match exactly.  The quant-matmul wrappers run
their plain versions on CPU tensors; they are held against the JAX TPU
kernels in interpret mode: the W8A8 activation quantization (int8 values
and per-(row, group) scales) must be equal, and the outputs agree within
one bf16 rounding.  The W8A8 group is the TPU kernel's k tile, so the
cases include the group policies that are easy to get wrong: a flat
K = 4096 (groups 1536 / 1536 / 1024 + zero padding) and a stacked
K = 2 x 3072 (two groups).

One exact tie separates the two: an activation equal to +-absmax/2 of its
group has x * 127 / absmax = 63.5 exactly.  The kernel source computes
x / x_scale, which in IEEE division lands just off the tie (the port, its
CUDA kernel and the JAX formula run op by op all give 63 for
1.625 / fl(3.25 / 127)), but XLA:CPU, compiling the interpret-mode kernel
as one fusion, rounds that element to 64.  The kernel comparisons below
therefore draw activations with no such tie (`_untie`), and
`test_w8a8_tie_uses_true_division` pins the port's behaviour at one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu_torch.ops import quant as tquant
from loongx_tpu_torch.ops import quant_matmul as tqmm
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

BF16_ULP = 2.0 ** -7  # one bf16 rounding step, relative


def _bf16_np(a):
    """float32 numpy values that are exactly representable in bf16."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _assert_one_bf16_rounding(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = BF16_ULP * np.abs(want) + 1e-5 * np.abs(want).max() + 1e-30
    err = np.abs(got - want)
    assert (err <= tol).all(), (err.max(), np.argmax(err - tol))


def _untie(x, group):
    """Move every activation equal to +-absmax/2 of its k group (the one
    exact W8A8 rounding tie, see the module docstring) to the next bf16
    value towards zero."""
    for g0 in range(0, x.shape[1], group):
        tile = x[:, g0:g0 + group]
        half = np.abs(tile).max(1, keepdims=True) / 2
        tie = (np.abs(tile) == half) & (half > 0)
        tile[tie] = _bf16_np(tile[tie] * (1 - 2.0 ** -8) - tile[tie] * 2.0 ** -12)
    return x


def _operands(seed, m, k, n, nb=None, group=None):
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    x = _bf16_np(rng.standard_normal((m, k), np.float32))
    x[0, : min(k, 96)] = 0.0  # an all-zero group start: x_scale 1 path
    if group is not None:
        x = _untie(x, group)
    w = rng.integers(-128, 128, lead + (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, lead + (1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal(lead + (1, n))).astype(np.float32)
    return x, w, scale, bias


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_act_quant(x, group, k_pad):
    """The TPU kernel's per-tile activation quantization
    (loongx_tpu/ops/quant_matmul.py `_accum_tile`, W8A8 branch) applied to
    each k tile of the bf16-cast, zero-padded x, op by op."""
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xb = jnp.pad(xb, ((0, 0), (0, k_pad - x.shape[1])))
    qs, scales = [], []
    for g0 in range(0, k_pad, group):
        tile = xb[:, g0:g0 + group].astype(jnp.float32)
        absmax = jnp.max(jnp.abs(tile), axis=1, keepdims=True)
        x_scale = jnp.where(absmax == 0, 1.0, absmax / 127.0)
        qs.append(jnp.clip(jnp.round(tile / x_scale), -127, 127)
                  .astype(jnp.int8))
        scales.append(x_scale)
    return (np.asarray(jnp.concatenate(qs, 1)),
            np.asarray(jnp.concatenate(scales, 1)))


# ---------------------------------------------------------------------------
# Group policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k, n, want", [
    (4096, 3072, (1536, 4608)),   # context_embedder: 1536/1536/1024 + pad
    (64, 3072, (128, 128)),       # x_embedder: N >= 4K, clamped to 128
    (256, 3072, (256, 256)),      # time in_layer
    (3072, 3072, (1536, 3072)),
    (3072, 64, (1536, 3072)),     # proj_out
    (768, 3072, (768, 768)),      # vector in_layer (N >= 4K, clamped)
])
def test_flat_group_policy(k, n, want):
    assert tqmm.flat_w8a8_group(k, n) == want


@pytest.mark.parametrize("k, n", [
    (3072, 3072), (3072, 12288), (3072, 18432), (12288, 3072),
    (3072, 9216), (6144, 256), (3072, 256),
])
def test_stacked_group_policy_matches_jax_tiles(k, n):
    """The stacked group is the JAX stacked kernel's k tile: 3072 at every
    FLUX shape, K = 12288 included."""
    block_n, block_k = jqmm._stacked_blocks(k, n)
    block_n, block_k = min(block_n, n), min(block_k, k)
    assert jqmm._stacked_ok(k, n, block_n, block_k)
    assert tqmm.stacked_w8a8_group(k, n) == (block_k, k)
    if k % 3072 == 0:
        assert block_k == 3072


@pytest.mark.parametrize("k, n, stacked", [
    (4096, 256, False), (200, 1024, False), (6144, 256, True),
    (3072, 384, True),
])
def test_w8a8_activation_quant_equals_jax(k, n, stacked):
    x, *_ = _operands(1, 9, k, n)
    x[4] = 0.0
    # raw float32 values: both sides cast to bf16 before quantizing
    x[5] = np.random.default_rng(9).standard_normal(k).astype(np.float32)
    group, k_pad = (tqmm.stacked_w8a8_group(k, n) if stacked
                    else tqmm.flat_w8a8_group(k, n))
    q_t, s_t = tqmm.act_quant(_t(x), group, k_pad)
    q_j, s_j = _jax_act_quant(x, group, k_pad)
    assert q_t.dtype == torch.int8 and q_t.shape == (9, k_pad)
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    assert np.abs(q_j).max() <= 127


def test_w8a8_tie_uses_true_division():
    """x = absmax / 2: q = rint(x / fl(absmax / 127)), IEEE division; and
    exact halves round to even (absmax 127 gives x_scale 1)."""
    x = np.zeros((2, 128), np.float32)
    x[0, :3] = (1.625, 3.25, -1.625)
    x[1, :4] = (127.0, 2.5, -3.5, 0.5)
    q_t, s_t = tqmm.act_quant(_t(x), 128, 128)
    q_j, s_j = _jax_act_quant(x, 128, 128)
    np.testing.assert_array_equal(q_t.numpy()[0, :3], [63, 127, -63])
    np.testing.assert_array_equal(q_t.numpy()[1, :4], [127, 2, -4, 0])
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)


# ---------------------------------------------------------------------------
# The three kernel contracts
# ---------------------------------------------------------------------------

FLAT_CASES = [
    # (m, k, n, w8a8, bias, activation)
    (24, 4096, 256, True, True, None),       # context_embedder groups
    (24, 4096, 256, False, True, None),
    (8, 64, 384, True, True, "gelu_tanh"),   # x_embedder-like, N >= 4K
    (8, 64, 384, False, False, None),
    (2, 256, 256, True, False, None),        # M far below a tile
    (5, 200, 128, True, True, "gelu_tanh"),  # K not a multiple of 128
]


@pytest.mark.parametrize("m, k, n, w8a8, bias, act", FLAT_CASES)
def test_flat_qmm_matches_jax_kernel(m, k, n, w8a8, bias, act):
    x, w, scale, b = _operands(2, m, k, n, group=tqmm.flat_w8a8_group(k, n)[0])
    b = b if bias else None
    jfn = jqmm.quant_matmul_w8a8 if w8a8 else jqmm.quant_matmul
    want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
               interpret=True, bias=None if b is None else jnp.asarray(b),
               activation=act)
    got = tqmm.quant_matmul(_t(x).to(torch.bfloat16), _t(w), _t(scale),
                            bias=None if b is None else _t(b),
                            activation=act, w8a8=w8a8)
    assert got.dtype == torch.bfloat16
    _assert_one_bf16_rounding(got.float().numpy(),
                              np.asarray(want, np.float32))


STACKED_CASES = [
    # (m, k, n, nb, blk, w8a8, activation)
    (16, 6144, 256, 3, 2, True, None),       # two W8A8 groups
    (16, 6144, 256, 3, 1, False, None),
    (10, 3072, 384, 2, 1, True, "gelu_tanh"),
    (10, 3072, 384, 2, 1, False, "gelu_tanh"),
    (2, 3072, 256, 4, 3, True, None),        # modulation matvec (M = 2)
]


@pytest.mark.parametrize("m, k, n, nb, blk, w8a8, act", STACKED_CASES)
def test_stacked_qmm_matches_jax_kernel(m, k, n, nb, blk, w8a8, act):
    x, w, scale, b = _operands(3, m, k, n, nb=nb,
                               group=tqmm.stacked_w8a8_group(k, n)[0])
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.int32(blk),
        bias3=jnp.asarray(b), activation=act, interpret=True, w8a8=w8a8)
    got = tqmm.quant_matmul_stacked(
        _t(x).to(torch.bfloat16), _t(w), _t(scale), blk, bias3=_t(b),
        activation=act, w8a8=w8a8)
    _assert_one_bf16_rounding(got.float().numpy(),
                              np.asarray(want, np.float32))


def test_stacked_qmm_rejects_block_out_of_range():
    x, w, scale, _ = _operands(4, 2, 3072, 128, nb=2)
    with pytest.raises(IndexError):
        tqmm.quant_matmul_stacked(_t(x), _t(w), _t(scale), 2)


@pytest.mark.parametrize("m, w8a8, head_dim, k", [
    (12, True, 64, 3072), (12, False, 64, 3072), (2, True, 32, 3072),
    (4, True, 64, 2000),  # no whole k tile: the flat-kernel fallback
])
def test_qkv_stacked_matches_jax_kernel(m, w8a8, head_dim, k):
    h, nb, blk = 128, 3, 1
    x, w, scale, b = _operands(5, m, k, 3 * h, nb=nb,
                               group=tqmm.stacked_w8a8_group(k, 3 * h)[0])
    rng = np.random.default_rng(6)
    norm_w = np.stack([rng.uniform(0.5, 1.5, h), rng.uniform(0.5, 1.5, h),
                       np.ones(h)]).astype(np.float32)
    want = jqmm.quant_qkv_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(b),
        jnp.asarray(norm_w), jnp.int32(blk), head_dim, interpret=True,
        w8a8=w8a8)
    got = tqmm.quant_qkv_stacked(
        _t(x).to(torch.bfloat16), _t(w), _t(scale), _t(b), _t(norm_w), blk,
        head_dim, w8a8=w8a8)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (m, h)
        _assert_one_bf16_rounding(g.float().numpy(),
                                  np.asarray(wnt, np.float32))


# ---------------------------------------------------------------------------
# Weight transforms
# ---------------------------------------------------------------------------


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, path)


def test_quantize_linear_exact():
    rng = np.random.default_rng(7)
    kernel = rng.standard_normal((3, 40, 24)).astype(np.float32)
    kernel[1, :, 5] = 0.0                   # a zero column: scale 1
    kernel[0, :, 2] = np.clip(kernel[0, :, 2], -1.0, 1.0)
    kernel[0, 0, 2], kernel[0, 3, 2] = 127.0, 2.5  # scale 1, a half-way 2.5
    p = {"kernel": kernel, "bias": rng.standard_normal((3, 24)).astype(
        np.float32)}
    want = jax.tree.map(np.asarray, jquant.quantize_linear(
        {k: jnp.asarray(v) for k, v in p.items()}))
    got = to_numpy_tree(tquant.quantize_linear({k: _t(v) for k, v in
                                                p.items()}))
    _assert_trees_equal(got, want)
    np.testing.assert_array_equal(
        tquant.dequant_kernel({k: _t(v) for k, v in want.items()},
                              torch.float32).numpy(),
        np.asarray(jquant.dequant_kernel(want, jnp.float32)))


def test_serving_transforms_exact():
    """quantize_tree (with the stacks-only predicate) -> fuse_qkv_projections
    -> split_single_proj_out on the tiny DiT equal the JAX transforms."""
    cfg = jmodel.FluxConfig.tiny()
    params = jmodel.init_flux_params(jax.random.key(0), cfg, dtype=jnp.float32)
    stacks_only = lambda path, leaf: path.startswith(
        ("double_blocks", "single_blocks"))
    for pred in (None, stacks_only):
        want = jquant.split_single_proj_out(
            jquant.fuse_qkv_projections(jquant.quantize_tree(params, pred)),
            cfg.hidden)
        tparams = from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")
        got = tquant.split_single_proj_out(
            tquant.fuse_qkv_projections(tquant.quantize_tree(tparams, pred)),
            cfg.hidden)
        assert "to_qkv" in got["double_blocks"]["attn"]
        assert "add_qkv_proj" in got["double_blocks"]["attn"]
        assert "proj_out_mlp" in got["single_blocks"]
        _assert_trees_equal(to_numpy_tree(got), jax.tree.map(np.asarray, want))


def test_fuse_qkv_skips_lora_projections():
    cfg = jmodel.FluxConfig.tiny()
    params = jax.tree.map(np.asarray, jmodel.init_flux_params(
        jax.random.key(1), cfg, dtype=jnp.float32))
    attn = params["double_blocks"]["attn"]
    nb = cfg.num_double_blocks
    attn["to_q"]["lora_a"] = np.zeros((nb, cfg.hidden, 2), np.float32)
    attn["to_q"]["lora_b"] = np.zeros((nb, 2, cfg.hidden), np.float32)
    attn["to_q"]["lora_scale"] = np.ones((nb,), np.float32)
    got = tquant.fuse_qkv_projections(from_numpy_tree(params, "cpu"))
    assert "to_qkv" not in got["double_blocks"]["attn"]
    assert "add_qkv_proj" in got["double_blocks"]["attn"]


def test_random_quantized_like_layout():
    cfg = jmodel.FluxConfig.tiny()
    from loongx_tpu_torch.models.flux.model import (
        FluxConfig, init_flux_params,
    )
    tcfg = FluxConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    got = tquant.random_quantized_like(
        init_flux_params(tcfg, device="meta"), generator=gen, device="cpu")
    want = jax.eval_shape(lambda: jquant.split_single_proj_out(
        jquant.fuse_qkv_projections(jquant.quantize_tree(
            jmodel.init_flux_params(jax.random.key(0), cfg))), cfg.hidden))
    got = tquant.split_single_proj_out(tquant.fuse_qkv_projections(got),
                                       cfg.hidden)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(got) == shapes(want)
    wq = got["single_blocks"]["attn"]["to_qkv"]["kernel_q"]
    assert wq.dtype == torch.int8
    assert int(wq.min()) == -128 and int(wq.max()) == 127
    assert got["double_blocks"]["ff"]["in"]["kernel_scale"].dtype == torch.float32
