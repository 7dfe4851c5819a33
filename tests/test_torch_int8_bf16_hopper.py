"""The weight-only GEMM and the transposed GEMM on bf16 wgmma: their
host-side logic on the CPU.

* The shape rules `qmm_route` (weight-only mode) and `qmm_t_route` over
  every training, T5 and serving shape that ``chip_smoke.py`` checks
  (``qmm_cases``, ``qmm_t_cases``, ``t5_cases``, ``fused_cases``) and at
  their edges: no shape is left on ``mma.sync``; K 64 of x_embedder takes
  the K 64 kernel; N 64 of proj_out takes the split-K forward and
  its backward the narrow transposed kernel; the weight-only LN + adaLN
  prologue forms take the plain weight-only rule, their prologue a pass of
  its own ahead of the wgmma GEMM.
* ``cuda_build.mma_sync_only`` sends both new routes back to ``mma.sync``
  and restores them.
* The plain versions the card holds the kernels to (`qmm_plain` with
  ``w8a8=False``, `quant_qkv_plain`, `qmm_t_plain`) against the Pallas
  kernels in interpret mode (``quant_matmul``, ``quant_matmul_stacked``,
  ``quant_qkv_stacked``, ``quant_matmul_t``, ``quant_matmul_t_stacked``)
  at small shapes with ragged M and N a multiple of 64, on seeded numpy
  inputs, within one bf16 rounding (2^-7 max|ref|).
* dy * scale on an exact bf16 rounding tie: the transposed product rounds
  it to bf16 before the product, as the TPU kernels do.
* On CPU tensors the wrappers run the plain versions whatever the route.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import quant_matmul as qmm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a) -> np.ndarray:
    """float32 values exactly representable in bf16."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _assert_within_one_rounding(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ---------------------------------------------------------------------------
# The shape rules over chip_smoke's cases
# ---------------------------------------------------------------------------


def _forward_cases():
    """(entry, label, K, N, prologue) of every weight-only GEMM case
    chip_smoke checks: serving and training layers, T5, the fused forms."""
    stacked, flat, qkv = chip_smoke.qmm_cases()
    out = [("qmm_stacked", lbl, k, n, False) for lbl, _, k, n, _, _ in stacked]
    out += [("qmm_flat", lbl, k, n, False) for lbl, _, k, n in flat]
    out += [("qmm_qkv_stacked", lbl, 3072, 9216, False) for lbl, _, _ in qkv]
    out += [("qmm_stacked", lbl, k, n, False)
            for lbl, k, n, _ in chip_smoke.t5_cases()]
    out += [(entry, lbl, k, n, entry.endswith("_ln"))
            for entry, lbl, _, k, n, *_ in chip_smoke.fused_cases()]
    return out


# the flat layers the 128 x 128 tiles cannot take: the one whose K is one
# 64-wide panel goes to the K 64 kernel, those whose N is below one tile
# (proj_out) to split-K
_WONLY_K64 = {("qmm_flat", "x_embedder")}
_WONLY_SPLITK = {("qmm_flat", "proj_out"), ("qmm_flat", "ragged M1000 proj_out")}


def _prologue_is_a_pass(k: int, route: str) -> bool:
    """Does the weight-only prologue form on ``route`` run its prologue as
    a pass of its own (`qmm._prologue` hands the GEMM x' and no ``ab``)?"""
    x, ab = torch.randn(3, k), torch.randn(8, k)
    xp, ab_left, stats = qmm._prologue(x, ab, 1, route, False)
    if ab_left is None:
        assert stats is None and xp.dtype == torch.bfloat16
    else:
        assert xp is x and stats.shape == (3, 2)
    return ab_left is None


@pytest.mark.parametrize(
    "entry,label,k,n,prologue", _forward_cases(),
    ids=[f"{e}-{lbl}" for e, lbl, *_ in _forward_cases()])
def test_qmm_route_weight_only_cases(entry, label, k, n, prologue):
    group, k_pad = (qmm.flat_w8a8_group(k, n) if entry == "qmm_flat"
                    else qmm.stacked_w8a8_group(k, n))
    route = qmm.qmm_route(k, n, group, k_pad, False)
    if (entry, label) in _WONLY_K64:
        assert route == "k64"
    elif (entry, label) in _WONLY_SPLITK:
        assert route == "splitk"
        assert qmm.splitk_plan(k, n, group, k_pad, False) is not None
    else:
        assert route == "wgmma"
        # wg::wo::launch's preconditions
        assert k % 128 == 0 and n >= 128 and n % 16 == 0
    if prologue:
        assert _prologue_is_a_pass(k, route)


def _t_cases():
    stacked, flat = chip_smoke.qmm_t_cases()
    return ([("qmm_t_stacked", lbl, k, n) for lbl, _, k, n, _ in stacked]
            + [("qmm_t", lbl, k, n) for lbl, _, k, n in flat])


@pytest.mark.parametrize("entry,label,k,n", _t_cases(),
                         ids=[f"{e}-{lbl}" for e, lbl, *_ in _t_cases()])
def test_qmm_t_route_cases(entry, label, k, n):
    route = qmm.qmm_t_route(k, n)
    if n == 64:  # proj_out's backward, at M 1024 and ragged M 1000
        assert route == "narrow"
    else:
        assert route == "wgmma"
        # qmm_t_gemm_wgmma's preconditions
        assert k % 128 == 0 and n % 128 == 0


@pytest.mark.parametrize("k,n,want", [
    (128, 128, "wgmma"),        # one tile each way
    (15360, 3072, "wgmma"),     # the single blocks' proj_out backward
    (3072, 64, "narrow"),       # N below a tile: the final proj_out
    (64, 3072, "mma_sync"),     # K below a tile
    (3072, 192, "mma_sync"),    # N not whole 128-deep stages
    (320, 3072, "mma_sync"),    # K not whole 128-row tiles
])
def test_qmm_t_route_edges(k, n, want):
    assert qmm.qmm_t_route(k, n) == want


@pytest.mark.parametrize("k,n,want", [
    (128, 128, "wgmma"),
    (64, 3072, "k64"),          # K below a tile (x_embedder)
    (3072, 64, "splitk"),       # N below a tile (proj_out)
    (384, 256, "wgmma"),        # K whole 128-deep stages
    (192, 256, "mma_sync"),     # K not whole stages
])
def test_qmm_route_weight_only_edges(k, n, want):
    group, k_pad = qmm.stacked_w8a8_group(k, n)
    assert qmm.qmm_route(k, n, group, k_pad, False) == want
    # the prologue form: a pass ahead of the wgmma, split-K and K 64 GEMMs, on the
    # A tile of the mma.sync kernel
    assert _prologue_is_a_pass(k, want) == (want != "mma_sync")


def test_mma_sync_only_forces_and_restores_the_new_routes():
    wonly = qmm.qmm_route(3072, 12288, 3072, 3072, False)
    trans = qmm.qmm_t_route(3072, 12288)
    assert qmm.active_route(wonly) == qmm.active_route(trans) == "wgmma"
    with pytest.raises(RuntimeError):
        with cuda_build.mma_sync_only():
            assert qmm.active_route(wonly) == "mma_sync"
            assert qmm.active_route(trans) == "mma_sync"
            raise RuntimeError("inside")
    assert qmm.active_route(wonly) == qmm.active_route(trans) == "wgmma"
    assert qmm.active_route("mma_sync") == "mma_sync"


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _operands(seed, m, k, n, nb=None):
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    x = _bf16_np(rng.standard_normal((m, k)))
    w = rng.integers(-128, 128, lead + (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, lead + (1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal(lead + (1, n))).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("m,k,n,bias,act", [
    (37, 256, 192, True, None),
    (5, 128, 64, False, "gelu_tanh"),
    (130, 384, 320, True, "gelu_tanh"),
])
def test_qmm_plain_weight_only_matches_pallas_flat(m, k, n, bias, act):
    x, w, scale, b = _operands(11, m, k, n)
    b = b if bias else None
    want = jqmm.quant_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                             bias=None if b is None else jnp.asarray(b),
                             activation=act, interpret=True)
    got = qmm.qmm_plain(_t(x).to(torch.bfloat16), _t(w), _t(scale),
                        None if b is None else _t(b), act, w8a8=False)
    assert got.dtype == torch.bfloat16
    _assert_within_one_rounding(got, want)


@pytest.mark.parametrize("m,k,n,nb,blk,act", [
    (37, 256, 192, 3, 2, None),
    (130, 384, 320, 2, 1, "gelu_tanh"),
    (2, 512, 128, 3, 0, None),  # a modulation matvec
])
def test_qmm_plain_weight_only_matches_pallas_stacked(m, k, n, nb, blk, act):
    x, w, scale, b = _operands(12, m, k, n, nb=nb)
    want = jqmm.quant_matmul_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.int32(blk),
        bias3=jnp.asarray(b), activation=act, interpret=True, w8a8=False)
    got = qmm.qmm_plain(_t(x).to(torch.bfloat16), _t(w[blk]), _t(scale[blk]),
                        _t(b[blk]), act, w8a8=False)
    _assert_within_one_rounding(got, want)


def test_qkv_plain_weight_only_matches_pallas():
    m, k, h, nb, blk, head_dim = 13, 256, 128, 2, 1, 64
    x, w, scale, b = _operands(13, m, k, 3 * h, nb=nb)
    rng = np.random.default_rng(14)
    norm_w = np.stack([rng.uniform(0.5, 1.5, h), rng.uniform(0.5, 1.5, h),
                       np.ones(h)]).astype(np.float32)
    want = jqmm.quant_qkv_stacked(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(b),
        jnp.asarray(norm_w), jnp.int32(blk), head_dim, interpret=True,
        w8a8=False)
    got = qmm.quant_qkv_plain(_t(x).to(torch.bfloat16), _t(w[blk]),
                              _t(scale[blk]), _t(b[blk]), _t(norm_w), head_dim)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (m, h)
        _assert_within_one_rounding(g, wnt)


def _t_operands(seed, m, k, n, nb=None):
    rng = np.random.default_rng(seed)
    lead = () if nb is None else (nb,)
    dy = _bf16_np(rng.standard_normal((m, n)))
    w = rng.integers(-128, 128, lead + (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, lead + (1, n)).astype(np.float32)
    return dy, w, scale


@pytest.mark.parametrize("m,k,n", [(37, 256, 192), (130, 128, 64)])
def test_qmm_t_plain_matches_pallas_flat(m, k, n):
    dy, w, scale = _t_operands(21, m, k, n)
    want = jqmm.quant_matmul_t(jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(scale), interpret=True)
    got = qmm.qmm_t_plain(_t(dy).to(torch.bfloat16), _t(w), _t(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    _assert_within_one_rounding(got, want)


@pytest.mark.parametrize("m,k,n,nb,blk", [(130, 384, 320, 3, 1),
                                          (5, 256, 128, 2, 0)])
def test_qmm_t_plain_matches_pallas_stacked(m, k, n, nb, blk):
    dy, w, scale = _t_operands(22, m, k, n, nb=nb)
    want = jqmm.quant_matmul_t_stacked(
        jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        jnp.int32(blk), interpret=True)
    got = qmm.qmm_t_plain(_t(dy).to(torch.bfloat16), _t(w[blk]), _t(scale[blk]))
    _assert_within_one_rounding(got, want)


def test_qmm_t_rounds_dy_scale_before_the_product():
    """dy = 1 + 2^-7 times scale 1.5 is 1.51171875, exactly halfway between
    the bf16 values 1.5078125 and 1.515625: rounded to nearest even first
    (the TPU kernels' order) it is 1.515625, and with weights in {-1, 0, 1}
    every fp32 sum is exact, so dx = bf16(1.515625 * S) with S the row's
    weight sum, bit for bit.  Folding the scale in after the sum gives
    bf16(1.51171875 * S), which differs where S = 3."""
    m, k, n = 5, 128, 64
    rng = np.random.default_rng(23)
    dy = np.full((m, n), 1.0 + 2.0 ** -7, np.float32)
    scale = np.full((1, n), 1.5, np.float32)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    w[0] = 0
    w[0, [3, 17, 40]] = 1  # S = 3 in row 0
    s = w.astype(np.float32).sum(1)
    want = _bf16_np(np.broadcast_to(1.515625 * s, (m, k)))
    other = _bf16_np(np.broadcast_to((1.0 + 2.0 ** -7) * s * 1.5, (m, k)))
    assert (want != other).any()
    jax_out = np.asarray(jqmm.quant_matmul_t(
        jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w), jnp.asarray(scale),
        interpret=True), np.float32)
    got = qmm.qmm_t_plain(_t(dy).to(torch.bfloat16), _t(w), _t(scale))
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# CPU tensors take the plain versions whatever the route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("forced", [False, True], ids=["rule", "mma_sync_only"])
def test_cpu_wrappers_run_the_plain_versions(forced):
    x, w, scale, b = _operands(31, 9, 256, 384, nb=2)
    dy, wt, st = _t_operands(32, 9, 256, 128, nb=2)
    xt, wq, sc, bi = (_t(x).to(torch.bfloat16), _t(w), _t(scale), _t(b))
    dyt = _t(dy).to(torch.bfloat16)
    norm_w = torch.ones(3, 128)
    before = dict(cuda_build.LAUNCHES)
    ctx = cuda_build.mma_sync_only() if forced else _nothing()
    with ctx:
        got = [qmm.quant_matmul_stacked(xt, wq, sc, 1, bias3=bi,
                                        activation="gelu_tanh"),
               qmm.quant_matmul(xt, wq[0], sc[0], bias=bi[0]),
               torch.stack(qmm.quant_qkv_stacked(xt, wq, sc, bi, norm_w, 1, 64)),
               qmm.quant_matmul_t_stacked(dyt, _t(wt), _t(st), 1),
               qmm.quant_matmul_t(dyt, _t(wt[0]), _t(st[0]))]
    want = [qmm.qmm_plain(xt, wq[1], sc[1], bi[1], "gelu_tanh"),
            qmm.qmm_plain(xt, wq[0], sc[0], bi[0]),
            torch.stack(qmm.quant_qkv_plain(xt, wq[1], sc[1], bi[1], norm_w, 64)),
            qmm.qmm_t_plain(dyt, _t(wt[1]), _t(st[1])),
            qmm.qmm_t_plain(dyt, _t(wt[0]), _t(st[0]))]
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert dict(cuda_build.LAUNCHES) == before  # nothing launched


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
