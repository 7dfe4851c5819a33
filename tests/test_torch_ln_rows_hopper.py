"""The row stats' warp kernel and the weight-only LN + adaLN prologue pass:
their host-side logic and plain contracts on the CPU.

* `ln_stats_route` over every case ``chip_smoke.py`` checks
  (``ln_stats_cases``) and every FLUX fused site (``fused_cases``), and at
  its edges: bf16 rows whose K is a multiple of 8 and at most 3072 go to
  the warp kernel, the rest (float32 x, a longer or ragged K) to the
  block-per-row one.
* The weight-only prologue forms take the plain weight-only GEMM's rule
  (`qmm_route`); on the wgmma route `_prologue` runs the prologue as a
  pass (`ln_mod_pass`) and leaves the GEMM no ``ab``; W8A8 and the
  ``mma.sync`` form keep ``ab`` with the row stats.
* ``cuda_build.mma_sync_only`` sends both routes back (the block stats
  kernel, the ``mma.sync`` form) and restores them.
* The plain pass, ``bf16(ln_mod_plain(x, ab, ln_row_stats_plain(x)))``,
  against the bf16 cast of the TPU kernels' ``_ln_mod_prologue`` run in a
  Pallas kernel in interpret mode, fed JAX's ``_ln_row_stats``: equal, with
  a_seg powers of two (XLA:CPU fuses ``xn * a + b`` into an fma; see
  tests/test_torch_fused_ew.py), boundaries on and off a row tile.
* The composed plain route (the plain pass, then the unfused weight-only
  product) equals ``qmm_plain(..., ab=...)`` and ``quant_qkv_plain(...,
  ab=...)`` bit for bit, at a ragged M and boundaries on and off the
  128-row tile, bf16 and float32 x.
* On CPU tensors `ln_row_stats` and `ln_mod_pass` are their plain
  versions and launch nothing.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import quant_matmul as qmm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _ab(rng, k: int) -> np.ndarray:
    """ab rows with a_main / a_cond powers of two (an fma of xn * a + b
    then rounds as the product and the sum do) and random shifts."""
    ab = np.zeros((8, k), np.float32)
    ab[0] = np.exp2(np.round(rng.standard_normal(k)))
    ab[2] = np.exp2(np.round(rng.standard_normal(k)))
    ab[1] = rng.standard_normal(k) * 0.1
    ab[3] = rng.standard_normal(k) * 0.1
    return ab


def _x(rng, m: int, k: int, dtype=torch.bfloat16) -> torch.Tensor:
    """A residual-stream-like x in ``dtype``."""
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0 + 0.5
    return _t(x).to(dtype)


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


def test_ln_stats_route_over_chip_smoke_cases():
    routes = {label: qmm.ln_stats_route(k, getattr(torch, dtype))
              for label, _, k, dtype, _ in chip_smoke.ln_stats_cases()}
    assert routes == {"M2560 K3072": "warp", "M2048 K3072": "warp",
                      "ragged M300 K1000": "warp",
                      "fp32 M2048 K3072": "block", "M512 K4096": "block"}
    # every FLUX fused site's rows (K = hidden 3072, bf16) take the warp
    # kernel
    for entry, _, _, k, *_ in chip_smoke.fused_cases():
        if entry.endswith("_ln"):
            assert qmm.ln_stats_route(k, torch.bfloat16) == "warp"


@pytest.mark.parametrize("k,dtype,want", [
    (8, torch.bfloat16, "warp"),          # one chunk
    (3072, torch.bfloat16, "warp"),       # the register budget
    (3080, torch.bfloat16, "block"),      # past it
    (1001, torch.bfloat16, "block"),      # not whole 16-byte chunks
    (3072, torch.float32, "block"),
    (256, torch.float32, "block"),
])
def test_ln_stats_route_edges(k, dtype, want):
    assert qmm.ln_stats_route(k, dtype) == want


@pytest.mark.parametrize(
    "entry,label,m,k,n",
    [(e, lbl, m, k, n) for e, lbl, m, k, n, *_ in chip_smoke.fused_cases()
     if e.endswith("_ln")])
def test_prologue_forms_route(entry, label, m, k, n):
    """At the fused serving shapes the weight-only prologue form goes to
    the wgmma GEMM after its pass; W8A8 keeps the prologue in the
    activation pass."""
    group, k_pad = qmm.stacked_w8a8_group(k, n)
    rng = np.random.default_rng(0)
    x, ab = _x(rng, 4, k), _t(_ab(rng, k))
    for w8a8 in (False, True):
        route = qmm.qmm_route(k, n, group, k_pad, w8a8)
        assert route == "wgmma", (entry, label, w8a8)
        xp, ab_left, stats = qmm._prologue(x, ab, 2, route, w8a8)
        if w8a8:
            assert xp is x and ab_left is ab and stats.shape == (4, 2)
        else:
            assert ab_left is None and stats is None
            assert torch.equal(xp, qmm.ln_mod_pass_plain(x, ab, 2)[0])


def test_mma_sync_only_restores_both_routes():
    k, n = 3072, 12288
    wonly = qmm.qmm_route(k, n, 3072, 3072, False)
    assert qmm.active_route(wonly) == "wgmma"
    assert qmm.active_ln_stats_route(k, torch.bfloat16) == "warp"
    with pytest.raises(RuntimeError):
        with cuda_build.mma_sync_only():
            assert qmm.active_route(wonly) == "mma_sync"
            assert qmm.active_ln_stats_route(k, torch.bfloat16) == "block"
            raise RuntimeError("inside")
    assert qmm.active_route(wonly) == "wgmma"
    assert qmm.active_ln_stats_route(k, torch.bfloat16) == "warp"
    assert qmm.active_ln_stats_route(k, torch.float32) == "block"


# ---------------------------------------------------------------------------
# The plain pass against the TPU kernels' prologue
# ---------------------------------------------------------------------------


def _jax_prologue(x, ab, stats128, boundary: int, block_m: int):
    """bf16 of ``_ln_mod_prologue`` over row tiles of ``block_m`` in a
    Pallas kernel (interpret mode): the prologue the stacked and fused-qkv
    TPU kernels apply to their x tile before the weight-only MAC."""
    m, k = x.shape

    def kernel(x_ref, ab_ref, stats_ref, o_ref):
        o_ref[...] = jqmm._ln_mod_prologue(x_ref, ab_ref, stats_ref,
                                           boundary).astype(jnp.bfloat16)

    return pl.pallas_call(
        kernel, grid=(m // block_m,),
        in_specs=[pl.BlockSpec((block_m, k), lambda i: (i, 0)),
                  pl.BlockSpec((8, k), lambda i: (0, 0)),
                  pl.BlockSpec((block_m, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_m, k), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((m, k), jnp.bfloat16),
        interpret=True)(x, ab, stats128)


@pytest.mark.parametrize("m,k,boundary,block_m", [
    (32, 256, 13, 8),     # boundary inside a row tile
    (32, 256, 16, 8),     # on a tile edge
    (16, 3072, 16, 8),    # no cond rows, the FLUX width
    (24, 1000, 0, 8),     # every row cond, a K the warp kernel takes ragged
])
def test_plain_pass_matches_jax_prologue(monkeypatch, m, k, boundary,
                                         block_m):
    rng = np.random.default_rng(k + boundary)
    x = _x(rng, m, k)
    ab = _ab(rng, k)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    stats128 = jqmm._ln_row_stats(jx)
    want = _jax_prologue(jx, jnp.asarray(ab), stats128, boundary, block_m)
    stats = _t(np.asarray(stats128)[:, :2])
    # the port's pass fed JAX's statistics (their sums run in other orders)
    monkeypatch.setattr(qmm, "ln_row_stats_plain", lambda _: stats)
    got, got_stats = qmm.ln_mod_pass_plain(x, _t(ab), boundary)
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    assert torch.equal(got_stats, stats)
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# The composed plain route against the fused plain versions
# ---------------------------------------------------------------------------


COMPOSED_CASES = [
    # (m, boundary, x dtype, activation)
    (300, 128, torch.bfloat16, "gelu_tanh"),   # ragged M, on the tile
    (300, 100, torch.bfloat16, None),          # off the tile
    (130, 7, torch.float32, "gelu_tanh"),
    (130, 256, torch.float32, None),           # no cond rows
]


@pytest.mark.parametrize("m,boundary,dtype,act", COMPOSED_CASES)
def test_composed_route_equals_fused_plain_stacked(m, boundary, dtype, act):
    rng = np.random.default_rng(m + boundary)
    k, n = 256, 384
    x, ab = _x(rng, m, k, dtype), _t(_ab(rng, k))
    w = _t(rng.integers(-128, 128, (k, n), dtype=np.int8))
    scale = _t(rng.random((1, n), np.float32) * 2e-2 + 1e-2)
    bias = _t(rng.standard_normal((1, n)).astype(np.float32) * 0.02)
    fused = qmm.qmm_plain(x, w, scale, bias, act, False, ab=ab,
                          seg_boundary=boundary)
    xp, _ = qmm.ln_mod_pass_plain(x, ab, boundary)
    composed = qmm.qmm_plain(xp, w, scale, bias, act, False)
    assert fused.dtype == composed.dtype == torch.bfloat16
    assert torch.equal(fused, composed)
    # the CPU wrappers: the fused form and the unfused one on x'
    w3, s3, b3 = w[None], scale[None], bias[None]
    assert torch.equal(
        qmm.quant_matmul_stacked(x, w3, s3, 0, bias3=b3, activation=act,
                                 ab=ab, seg_boundary=boundary),
        qmm.quant_matmul_stacked(xp, w3, s3, 0, bias3=b3, activation=act))


@pytest.mark.parametrize("m,boundary,dtype,_", COMPOSED_CASES)
def test_composed_route_equals_fused_plain_qkv(m, boundary, dtype, _):
    rng = np.random.default_rng(2 * m + boundary)
    k, h, head_dim = 256, 256, 64
    x, ab = _x(rng, m, k, dtype), _t(_ab(rng, k))
    w = _t(rng.integers(-128, 128, (k, 3 * h), dtype=np.int8))
    scale = _t(rng.random((1, 3 * h), np.float32) * 2e-2 + 1e-2)
    bias = _t(rng.standard_normal((1, 3 * h)).astype(np.float32) * 0.02)
    norm_w = _t(rng.random((3, h), np.float32) + 0.5)
    fused = qmm.quant_qkv_plain(x, w, scale, bias, norm_w, head_dim, ab=ab,
                                seg_boundary=boundary)
    xp, _ = qmm.ln_mod_pass_plain(x, ab, boundary)
    composed = qmm.quant_qkv_plain(xp, w, scale, bias, norm_w, head_dim)
    for a, b in zip(fused, composed):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# CPU tensors
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(3)
    x, ab = _x(rng, 40, 3072), _t(_ab(rng, 3072))
    cuda_build.LAUNCHES.clear()
    for forced in (False, True):
        with cuda_build.mma_sync_only() if forced else contextlib.nullcontext():
            assert torch.equal(qmm.ln_row_stats(x), qmm.ln_row_stats_plain(x))
            got, stats = qmm.ln_mod_pass(x, ab, 20)
            want, want_stats = qmm.ln_mod_pass_plain(x, ab, 20)
            assert torch.equal(got, want) and torch.equal(stats, want_stats)
    assert not cuda_build.LAUNCHES
