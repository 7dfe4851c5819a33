"""The int8 QK^T forward on s8 wgmma and the W8A8 activation pass's warp
kernel: their host-side logic and plain contracts on the CPU.

* `flash_int8_route` over every int8 case ``chip_smoke.py`` checks
  (``flash_cases`` with the span `int8_key_span` gives each) and at its
  edges: head_dim 64 and spans that are not a multiple of 128 (explicit
  ``block_k``) stay on ``mma.sync``, as does every launch under
  ``cuda_build.mma_sync_only``.
* The int8 plain forward at head_dim 128 (the wgmma route's shape) against
  the JAX package's ``flash_attention`` with LOONGX_INT8_ATTN=1 in
  interpret mode: S 256 and a ragged 200, 2 heads, both layouts, with and
  without RoPE, every mode, the c_factor form and one ``block_k=128`` case
  whose k scale has three spans, relative L2 1e-3 (the bound of
  tests/test_torch_s4_int8.py).  The pre-pass's plain version (q codes per
  row, k codes per span) against the TPU kernel's ``_quant`` run op by op.
* `act_quant_plain` codes and scales against the TPU kernels' `_accum_tile`
  recipe run op by op (eager jnp: IEEE division, as the port's) at every
  (K, group) pair of the served forward, derived from `stacked_w8a8_group`
  / `flat_w8a8_group` over the FLUX.1-dev linears (built on the ``meta``
  device), at a ragged M; group 1024 (the flat policy's, at no FLUX site);
  a ragged K; and the LN + adaLN form fed JAX's row stats (power-of-two a,
  so that an fma in XLA could not change a product).
* ``chip_smoke.py``'s activation-pass cases cover every served pair, a
  ragged K, the block route and the LN form; `act_quant_route` sends every
  served pair to the warp kernel.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import flash_attention as jfa
from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu.ops.rope import rope_embed as jrope
from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
from loongx_tpu_torch.models.pipeline import (
    fuse_qkv_projections, split_single_proj_out,
)
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import flash_attention as tfa
from loongx_tpu_torch.ops import quant_matmul as tqmm
from loongx_tpu_torch.ops.attention import int8_key_span
from loongx_tpu_torch.ops.quant import random_quantized_like

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

INT8_REL_L2 = 1e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a) -> np.ndarray:
    """float32 values exactly representable in bf16."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# The int8 forward's route
# ---------------------------------------------------------------------------


def test_int8_route_takes_every_chip_smoke_case():
    for _, _, s, _, _, _, _ in chip_smoke.flash_cases():
        assert tfa.flash_int8_route(128, int8_key_span(s)) == "wgmma", s
    # the FLUX lengths: one span of the whole padded row
    for s in (2560, 8704):
        assert int8_key_span(s) % 128 == 0
        assert tfa.active_int8_route(128, int8_key_span(s)) == "wgmma"


@pytest.mark.parametrize("d, s, block_k, want", [
    (64, 2560, None, "mma_sync"),    # head_dim 64
    (128, 384, 192, "mma_sync"),     # a span of 192 splits a 128-key tile
    (128, 384, 64, "mma_sync"),
    (128, 384, 128, "wgmma"),        # three spans of 128
    (128, 200, None, "wgmma"),       # ragged S: span 256, the padded row
])
def test_int8_route_edges(d, s, block_k, want):
    assert tfa.flash_int8_route(d, int8_key_span(s, block_k)) == want


def test_mma_sync_only_forces_both_new_routes():
    assert tfa.active_int8_route(128, 2560) == "wgmma"
    assert tqmm.active_act_quant_route(3072, 3072) == "warp"
    with cuda_build.mma_sync_only():
        assert tfa.active_int8_route(128, 2560) == "mma_sync"
        assert tqmm.active_act_quant_route(3072, 3072) == "block"
    assert tfa.active_int8_route(128, 2560) == "wgmma"
    assert tqmm.active_act_quant_route(3072, 3072) == "warp"


# ---------------------------------------------------------------------------
# The int8 plain forward at head_dim 128 against the Pallas kernel
# ---------------------------------------------------------------------------

# (S, cond_start, mode, c_factor, layout, rope, block_k)
INT8_D128_CASES = [
    (256, 192, "union", None, "bhsd", True, None),
    (256, 192, "no_union", None, "bshd", True, None),
    (256, 160, "independent", None, "bhsd", False, None),
    (200, 150, "union", 0.5, "bshd", True, None),
    (200, 130, "independent", None, "bshd", False, None),
    (384, 256, "union", None, "bhsd", True, 128),
]


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rope(seed, s):
    ids = np.random.default_rng(seed).integers(0, 32, (s, 3)).astype(np.float32)
    cos, sin = jrope(jnp.asarray(ids), (16, 56, 56))
    return (cos, sin), (_t(np.array(cos)), _t(np.array(sin)))


@pytest.mark.parametrize("s, cond_start, mode, c_factor, layout, rope, block_k",
                         INT8_D128_CASES)
def test_int8_d128_plain_matches_jax(monkeypatch, s, cond_start, mode, c_factor,
                                     layout, rope, block_k):
    shape = (1, s, 2, 128) if layout == "bshd" else (1, 2, s, 128)
    q, k, v = _qkv(s + cond_start, shape)
    jrope_t, trope = _rope(s, s) if rope else (None, None)
    monkeypatch.setenv("LOONGX_INT8_ATTN", "1")
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cond_start=cond_start,
        mode=mode, c_factor=c_factor, rope=jrope_t, block_k=block_k,
        interpret=True, layout=layout))
    kw = dict(cond_start=cond_start, mode=mode, c_factor=c_factor, rope=trope,
              layout=layout, int8_attn=True, block_k=block_k)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert _rel_l2(got, want) <= INT8_REL_L2
    np.testing.assert_array_equal(
        got, tfa.flash_attention_plain(_t(q), _t(k), _t(v), **kw).numpy())
    # the mode really changes the scores: bf16-score attention is farther
    kw["int8_attn"] = False
    exact = tfa.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert _rel_l2(exact, want) > 10 * _rel_l2(got, want)


def _jax_quant(x, per_row: bool):
    """The TPU kernel's ``_quant`` (flash_attention.py:228), op by op."""
    xf = jnp.asarray(x, jnp.float32)
    a = (jnp.max(jnp.abs(xf), axis=-1, keepdims=True) if per_row
         else jnp.max(jnp.abs(xf)))
    sc = jnp.where(a == 0, 1.0, a / 127.0)
    return np.asarray(jnp.clip(jnp.round(xf / sc), -127, 127)), np.asarray(sc)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_int8_prepass_plain_matches_tpu_quant(layout):
    """q codes and scales per row, k codes and scales per span of 128 keys
    (the last span ragged), as the TPU kernel quantizes its tiles; an
    all-zero q row takes scale 1."""
    s = 300
    shape = (2, s, 2, 128) if layout == "bshd" else (2, 2, s, 128)
    q, k, _ = (_bf16_np(x) for x in _qkv(11, shape))
    if layout == "bshd":
        q[0, 5] = 0.0
    else:
        q[0, :, 5] = 0.0
    qc, qs, kc, ks = tfa.flash_int8_prepass(_t(q), _t(k), span=128,
                                            layout=layout)
    assert qc.dtype == kc.dtype == torch.int8
    assert qc.shape == kc.shape == (2, 2, s, 128)
    assert qs.shape == (2, 2, s) and ks.shape == (2, 2, 3)
    qh, kh = (np.swapaxes(x, 1, 2) if layout == "bshd" else x for x in (q, k))
    want_qc, want_qs = _jax_quant(qh, per_row=True)
    np.testing.assert_array_equal(qc.numpy(), want_qc)
    np.testing.assert_array_equal(qs.numpy(), want_qs[..., 0])
    assert (qs.numpy()[0, :, 5] == 1.0).all()
    for b in range(2):
        for h in range(2):
            for j in range(3):
                rows = kh[b, h, 128 * j:128 * (j + 1)]
                want_c, want_s = _jax_quant(rows, per_row=False)
                np.testing.assert_array_equal(kc[b, h, 128 * j:128 * (j + 1)], want_c)
                assert ks[b, h, j].item() == want_s


# ---------------------------------------------------------------------------
# The activation pass against _accum_tile's recipe at the served pairs
# ---------------------------------------------------------------------------


def served_act_quant_pairs():
    """{(K, group, k_pad)} of every int8 linear of the served FLUX.1-dev
    tree (fused qkv, split single proj_out), as the W8A8 forward quantizes
    its input: the stacked policy for a stack, the flat one else."""
    cfg = FluxConfig.flux_dev()
    tree = random_quantized_like(
        init_flux_params(cfg, dtype=torch.bfloat16, device="meta"),
        device="meta")
    tree = split_single_proj_out(fuse_qkv_projections(tree), cfg.hidden)
    pairs = set()

    def walk(t):
        if isinstance(t, dict):
            if "kernel_q" in t:
                w = t["kernel_q"]
                k, n = w.shape[-2:]
                policy = (tqmm.stacked_w8a8_group if w.ndim == 3
                          else tqmm.flat_w8a8_group)
                pairs.add((k, *policy(k, n)))
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(tree)
    return pairs


# (K, group, k_pad) of the served forward: x_embedder, the time / guidance
# in_layers, vector_in, the K 3072 flat linears, context_embedder, the K 3072
# and K 12288 stacks (`test_served_pairs` derives them from the tree)
SERVED_PAIRS = [(64, 128, 128), (256, 256, 256), (768, 768, 768),
                (3072, 1536, 3072), (3072, 3072, 3072), (4096, 1536, 4608),
                (12288, 3072, 12288)]


def test_served_pairs():
    """The served forward quantizes at groups 128, 256, 768, 1536 and 3072
    (the flat policy's 1024 needs N >= 4K with K >= 1024: no FLUX site),
    every pair on the warp kernel."""
    assert served_act_quant_pairs() == set(SERVED_PAIRS)
    for k, group, _ in SERVED_PAIRS:
        assert tqmm.act_quant_route(k, group) == "warp"


def _jax_act_quant(x, group, k_pad):
    """`_accum_tile`'s W8A8 quantization (loongx_tpu/ops/quant_matmul.py:47-50)
    of each k tile of the bf16-cast, zero-padded x, op by op."""
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    xb = jnp.pad(xb, ((0, 0), (0, k_pad - x.shape[1])))
    return _jax_tiles(xb, group, k_pad)


def _jax_tiles(xf, group, k_pad):
    qs, scales = [], []
    for g0 in range(0, k_pad, group):
        tile = xf[:, g0:g0 + group]
        absmax = jnp.max(jnp.abs(tile), axis=1, keepdims=True)
        x_scale = jnp.where(absmax == 0, 1.0, absmax / 127.0)
        qs.append(jnp.clip(jnp.round(tile / x_scale), -127, 127))
        scales.append(x_scale)
    return np.asarray(jnp.concatenate(qs, 1)), np.asarray(jnp.concatenate(scales, 1))


def _act_x(seed, m, k, group):
    """Activations with an all-zero row, a row at the +-absmax/2 tie and
    float32 values that both sides cast to bf16."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((m, k))).astype(np.float32)
    x[0] = 0.0
    x[1, :min(k, group)] = np.clip(x[1, :min(k, group)], -3.0, 3.0)
    x[1, :3] = (3.25, 1.625, -1.625)[:min(k, 3)]
    return x


@pytest.mark.parametrize("k, group, k_pad", SERVED_PAIRS + [
    (2048, 1024, 2048),   # the flat policy's group 1024
    (4000, 1536, 4608),   # a ragged K: the last group half padding
    (1001, 1024, 1024),   # K not a multiple of 8: the block route
])
def test_act_quant_plain_matches_accum_tile(k, group, k_pad):
    m = 7
    x = _act_x(k + group, m, k, group)
    q, xs = tqmm.act_quant(_t(x), group, k_pad)
    want_q, want_s = _jax_act_quant(x, group, k_pad)
    assert q.dtype == torch.int8 and q.shape == (m, k_pad)
    assert xs.shape == (m, k_pad // group)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(xs.numpy(), want_s)
    assert (q.numpy()[:, k:] == 0).all()
    assert (xs.numpy()[0] == 1.0).all()
    if group >= 3:
        assert q.numpy()[1, 1] == 63  # 1.625 / fl(3.25 / 127), IEEE division


@pytest.mark.parametrize("k, group, k_pad, boundary", [
    (3072, 3072, 3072, 4), (12288, 3072, 12288, 2), (4000, 1536, 4608, 5),
])
def test_act_quant_ln_plain_matches_accum_tile(k, group, k_pad, boundary):
    """The LN + adaLN form quantizes the float32 prologue value of each
    row's segment, fed JAX's row stats (_ln_mean_rstd), never rounded to
    bf16."""
    m = 7
    rng = np.random.default_rng(k)
    x = _bf16_np(rng.standard_normal((m, k)) * 3.0 + 0.5)
    ab = np.zeros((8, k), np.float32)
    ab[0] = 2.0 ** rng.integers(-1, 2, k)
    ab[2] = 2.0 ** rng.integers(-1, 2, k)
    ab[1] = 0.1 * rng.standard_normal(k)
    ab[3] = 0.1 * rng.standard_normal(k)
    mean, rstd = jqmm._ln_mean_rstd(jnp.asarray(x))
    stats = np.concatenate([np.asarray(mean), np.asarray(rstd)], 1)
    q, xs = tqmm.act_quant(_t(x), group, k_pad, _t(ab), boundary, _t(stats))
    xn = (jnp.asarray(x) - mean) * rstd
    cond = np.arange(m)[:, None] >= boundary
    xp = xn * jnp.where(cond, ab[2], ab[0]) + jnp.where(cond, ab[3], ab[1])
    want_q, want_s = _jax_tiles(jnp.pad(xp, ((0, 0), (0, k_pad - k))), group,
                                k_pad)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(xs.numpy(), want_s)


def test_chip_smoke_act_quant_cases_cover_the_served_pairs():
    cases = chip_smoke.act_quant_cases()
    plain = {(k, g, kp) for _, _, k, g, kp, ln in cases if not ln}
    assert set(SERVED_PAIRS) <= plain
    assert any(k % g for _, _, k, g, _, _ in cases)            # ragged K
    assert any(m % 8 for _, m, _, _, _, _ in cases)            # ragged M
    routes = {tqmm.act_quant_route(k, g) for _, _, k, g, _, _ in cases}
    assert routes == {"warp", "block"}
    assert any(ln and (k, g, kp) in SERVED_PAIRS for _, _, k, g, kp, ln in cases)
    main = [c for c in cases if c[0] in ("M2560 K3072 group 3072",
                                         "M2560 K12288 group 3072")]
    assert [c[1:5] for c in main] == [(2560, 3072, 3072, 3072),
                                      (2560, 12288, 3072, 12288)]
