"""The int8 GEMMs at N below one 128 tile (the final proj_out, weight
[3072, 64]): the split-K forward and the narrow transposed kernel, their
host-side logic on the CPU.

* The shape rules `qmm_route` (``"splitk"``) and `qmm_t_route`
  (``"narrow"``) over ``chip_smoke.qmm_cases`` / ``qmm_t_cases``: proj_out
  (and its ragged M 1000 case) takes the new routes in both MAC modes,
  x_embedder (K 64) the K 64 kernel's (``"k64"``), and the edges of the new
  rules.
* The slice plan (`splitk_plan`): the cluster's slices cover K (k_pad in
  W8A8) exactly, each is whole 128-byte panels, no W8A8 slice straddles an
  activation group at any `flat_w8a8_group` the rule admits, the cluster
  is the portable size, the block's shared memory fits (two blocks an SM at
  proj_out weight-only), and the kernel's reduction order (s32 partials of a
  group summed, then folded in group order) gives the per-group sums of the
  ``mma.sync`` kernel.
* `qmm_plain` at proj_out (K 3072, N 64, ragged M, both modes, bias)
  against the Pallas kernels (`quant_matmul`, `quant_matmul_w8a8`) in
  interpret mode, and `qmm_t_plain` at N 64 against `quant_matmul_t`,
  within one bf16 rounding (2^-7 max|ref|), on seeded numpy inputs.
* ``cuda_build.mma_sync_only`` forces both new routes and restores them;
  CPU tensors take the plain versions on any route.
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

PROJ_OUT = (3072, 64)  # the final proj_out's weight [K, N]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a) -> np.ndarray:
    """float32 values exactly representable in bf16."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _assert_within_one_rounding(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ---------------------------------------------------------------------------
# The shape rules over chip_smoke's cases and at their edges
# ---------------------------------------------------------------------------


def _flat_cases():
    return [(label, m, k, n) for label, m, k, n in chip_smoke.qmm_cases()[1]]


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "wonly"])
@pytest.mark.parametrize("label,m,k,n", _flat_cases(),
                         ids=[c[0] for c in _flat_cases()])
def test_qmm_route_flat_cases(label, m, k, n, w8a8):
    group, k_pad = qmm.flat_w8a8_group(k, n)
    route = qmm.qmm_route(k, n, group, k_pad, w8a8)
    if (k, n) == PROJ_OUT:
        assert route == "splitk"
        assert qmm.splitk_plan(k, n, group, k_pad, w8a8) is not None
    elif k < qmm.WGMMA_TILE:  # x_embedder, K 64
        assert route == "k64"
        assert qmm.splitk_plan(k, n, group, k_pad, w8a8) is None
    else:
        assert route == "wgmma"


def test_proj_out_cases_are_in_chip_smoke():
    flat = {(k, n): [lbl for lbl, _, kk, nn in _flat_cases() if (kk, nn) == (k, n)]
            for k, n in [PROJ_OUT]}
    assert flat[PROJ_OUT] == ["proj_out", "ragged M1000 proj_out"]
    t_flat = [(lbl, m) for lbl, m, k, n in chip_smoke.qmm_t_cases()[1]
              if (k, n) == PROJ_OUT]
    assert t_flat == [("proj_out", 1024), ("ragged M1000 proj_out", 1000)]


def _t_cases():
    stacked, flat = chip_smoke.qmm_t_cases()
    return ([("qmm_t_stacked", lbl, k, n) for lbl, _, k, n, _ in stacked]
            + [("qmm_t", lbl, k, n) for lbl, _, k, n in flat])


@pytest.mark.parametrize("entry,label,k,n", _t_cases(),
                         ids=[f"{e}-{lbl}" for e, lbl, *_ in _t_cases()])
def test_qmm_t_route_cases_narrow(entry, label, k, n):
    route = qmm.qmm_t_route(k, n)
    if (k, n) == PROJ_OUT:
        assert route == "narrow"
    else:
        assert route == "wgmma"


@pytest.mark.parametrize("k,n,w8a8,want", [
    (3072, 64, True, "splitk"),      # proj_out
    (3072, 64, False, "splitk"),
    (3072, 16, True, "splitk"),      # the narrowest N
    (3072, 112, False, "splitk"),    # the widest N below a tile
    (3072, 128, True, "wgmma"),      # one tile: the wgmma kernels
    (3072, 56, False, "mma_sync"),   # N not a multiple of 16
    (64, 64, True, "mma_sync"),      # K below a tile
    (1024, 64, True, "splitk"),      # one W8A8 group over the whole cluster
    (512, 64, False, "splitk"),      # 8 slices of one 64-wide panel
    (512, 64, True, "mma_sync"),     # W8A8 k_pad 512: not 8 slices of 128 codes
    (1536, 64, True, "mma_sync"),    # 1536 / 8 is not whole 128-code panels
    (1536, 64, False, "splitk"),
    (2048, 48, True, "splitk"),      # K padded to k_pad 3072 (group 1536)
    (8192, 112, False, "mma_sync"),  # the slice's panels exceed shared memory
])
def test_qmm_route_splitk_edges(k, n, w8a8, want):
    group, k_pad = qmm.flat_w8a8_group(k, n)
    assert qmm.qmm_route(k, n, group, k_pad, w8a8) == want
    # the weight-only prologue form runs its pass ahead of split-K as of wgmma
    x, ab = torch.randn(3, k), torch.randn(8, k)
    _, ab_left, _ = qmm._prologue(x, ab, 1, want, w8a8)
    assert (ab_left is None) == (want != "mma_sync" and not w8a8)


@pytest.mark.parametrize("k,n,want", [
    (3072, 64, "narrow"),     # proj_out's backward
    (3072, 16, "narrow"),
    (128, 32, "narrow"),      # one weight tile
    (3072, 48, "narrow"),
    (3072, 80, "mma_sync"),   # above one 64-wide contraction, below a stage
    (3072, 24, "mma_sync"),   # N not a multiple of 16
    (64, 64, "mma_sync"),     # K below a tile
    (3136, 64, "mma_sync"),   # K not whole 128-row tiles
    (3072, 128, "wgmma"),
])
def test_qmm_t_route_narrow_edges(k, n, want):
    assert qmm.qmm_t_route(k, n) == want


def test_mma_sync_only_forces_and_restores_the_narrow_routes():
    group, k_pad = qmm.flat_w8a8_group(*PROJ_OUT)
    fwd = qmm.qmm_route(*PROJ_OUT, group, k_pad, True)
    bwd = qmm.qmm_t_route(*PROJ_OUT)
    assert (qmm.active_route(fwd), qmm.active_route(bwd)) == ("splitk", "narrow")
    with pytest.raises(RuntimeError):
        with cuda_build.mma_sync_only():
            assert qmm.active_route(fwd) == qmm.active_route(bwd) == "mma_sync"
            raise RuntimeError("inside")
    assert (qmm.active_route(fwd), qmm.active_route(bwd)) == ("splitk", "narrow")


# ---------------------------------------------------------------------------
# The slice plan
# ---------------------------------------------------------------------------


def _admitted():
    """(k, n, w8a8, group, k_pad, plan) of every flat shape with K a multiple
    of 128 up to 8192 and N 16..112 that the split-K rule takes."""
    out = []
    for k in range(128, 8193, 128):
        for n in range(16, qmm.WGMMA_TILE, 16):
            group, k_pad = qmm.flat_w8a8_group(k, n)
            for w8a8 in (True, False):
                plan = qmm.splitk_plan(k, n, group, k_pad, w8a8)
                if plan is not None:
                    out.append((k, n, w8a8, group, k_pad, plan))
    return out


def test_splitk_plan_slices():
    admitted = _admitted()
    assert len(admitted) > 100
    for k, n, w8a8, group, k_pad, plan in admitted:
        kloop = k_pad if w8a8 else k
        assert plan.cluster == qmm.SPLITK_CLUSTER <= 8  # the portable size
        assert plan.rows == 64                          # one m64 wgmma
        assert plan.cluster * plan.slice_k == kloop     # K covered exactly
        assert plan.panel_k == (128 if w8a8 else 64)    # 128-byte panels
        assert plan.slice_k % plan.panel_k == 0         # whole panels
        assert plan.slice_k // plan.panel_k <= qmm.SPLITK_MAX_PANELS
        assert plan.smem == qmm.splitk_smem(plan.slice_k, n, w8a8)
        assert plan.smem <= qmm.SMEM_PER_BLOCK
        if w8a8:
            # every slice lies inside one activation group
            for r in range(plan.cluster):
                lo, hi = r * plan.slice_k, (r + 1) * plan.slice_k - 1
                assert lo // group == hi // group, (k, n, r)


def test_splitk_plan_at_proj_out():
    for w8a8, panel in ((True, 128), (False, 64)):
        group, k_pad = qmm.flat_w8a8_group(*PROJ_OUT)
        plan = qmm.splitk_plan(*PROJ_OUT, group, k_pad, w8a8)
        assert (plan.cluster, plan.slice_k, plan.rows, plan.panel_k) == (8, 384, 64, panel)
        # M 1024: 16 row tiles x 8 = 128 blocks; two blocks fit an SM's 228 KB
        # (1 KB of each block's reserved), so every cluster is resident at once
        assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert qmm.flat_w8a8_group(*PROJ_OUT) == (1536, 3072)  # two groups, 4 slices each


@pytest.mark.parametrize("k,n", [PROJ_OUT, (1024, 16), (2048, 48)])
def test_splitk_reduction_order_equals_group_sums(k, n):
    """The kernel's W8A8 arithmetic on the plan: each block's s32 partial of
    its slice, the slices of a group summed (exact), then facc = fadd(facc,
    fmul(float(i32), x_scale)) in group order from 0: equal to the mma.sync
    kernel's per-group sums folded in the same order, bit for bit."""
    rng = np.random.default_rng(7)
    m = 9
    group, k_pad = qmm.flat_w8a8_group(k, n)
    plan = qmm.splitk_plan(k, n, group, k_pad, True)
    x = _bf16_np(rng.standard_normal((m, k)))
    xq, xs = qmm.act_quant_plain(_t(x), group, k_pad)
    q = xq.numpy().astype(np.int64)
    w = np.pad(rng.integers(-128, 128, (k, n)), ((0, k_pad - k), (0, 0)))
    xs = xs.numpy()

    def fold(sums):  # [groups, m, n] int64 -> float32, in group order
        acc = np.zeros((m, n), np.float32)
        for gi, s in enumerate(sums):
            acc = acc + s.astype(np.float32) * xs[:, gi:gi + 1]
        return acc

    per_group = [q[:, g0:g0 + group] @ w[g0:g0 + group]
                 for g0 in range(0, k_pad, group)]
    partials = [q[:, r * plan.slice_k:(r + 1) * plan.slice_k]
                @ w[r * plan.slice_k:(r + 1) * plan.slice_k]
                for r in range(plan.cluster)]
    groups = [sum(p for r, p in enumerate(partials)
                  if r * plan.slice_k // group == gi)
              for gi in range(k_pad // group)]
    np.testing.assert_array_equal(np.stack(groups), np.stack(per_group))
    np.testing.assert_array_equal(fold(groups), fold(per_group))


# ---------------------------------------------------------------------------
# The plain versions at proj_out against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _untie(x, group):
    """Move every activation equal to +-absmax/2 of its k group (the W8A8
    rounding tie where XLA:CPU's fused division and IEEE division part) to
    the next bf16 value towards zero."""
    for g0 in range(0, x.shape[1], group):
        tile = x[:, g0:g0 + group]
        half = np.abs(tile).max(1, keepdims=True) / 2
        tie = (np.abs(tile) == half) & (half > 0)
        tile[tie] = _bf16_np(tile[tie] * (1 - 2.0 ** -8) - tile[tie] * 2.0 ** -12)
    return x


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "wonly"])
def test_qmm_plain_at_proj_out_matches_pallas(w8a8):
    k, n = PROJ_OUT
    m = 37  # ragged: not a multiple of the 64-row block
    group, k_pad = qmm.flat_w8a8_group(k, n)
    rng = np.random.default_rng(41)
    x = _untie(_bf16_np(rng.standard_normal((m, k))), group)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, (1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal((1, n))).astype(np.float32)
    jfn = jqmm.quant_matmul_w8a8 if w8a8 else jqmm.quant_matmul
    want = jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
               bias=jnp.asarray(bias), interpret=True)
    got = qmm.qmm_plain(_t(x).to(torch.bfloat16), _t(w), _t(scale), _t(bias),
                        None, w8a8, group, k_pad)
    assert got.dtype == torch.bfloat16
    _assert_within_one_rounding(got, want)


@pytest.mark.parametrize("m", [37, 64])
def test_qmm_t_plain_at_proj_out_matches_pallas(m):
    k, n = PROJ_OUT
    rng = np.random.default_rng(42 + m)
    dy = _bf16_np(rng.standard_normal((m, n)))
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-4, 3e-4, (1, n)).astype(np.float32)
    want = jqmm.quant_matmul_t(jnp.asarray(dy, jnp.bfloat16), jnp.asarray(w),
                               jnp.asarray(scale), interpret=True)
    got = qmm.qmm_t_plain(_t(dy).to(torch.bfloat16), _t(w), _t(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, k)
    _assert_within_one_rounding(got, want)


@pytest.mark.parametrize("forced", [False, True], ids=["rule", "mma_sync_only"])
def test_cpu_wrappers_at_proj_out_run_the_plain_versions(forced):
    k, n = PROJ_OUT
    rng = np.random.default_rng(43)
    x = _t(_bf16_np(rng.standard_normal((5, k)))).to(torch.bfloat16)
    dy = _t(_bf16_np(rng.standard_normal((5, n)))).to(torch.bfloat16)
    w = _t(rng.integers(-128, 128, (k, n)).astype(np.int8))
    sc = _t(rng.uniform(1e-4, 3e-4, (1, n)).astype(np.float32))
    group, k_pad = qmm.flat_w8a8_group(k, n)
    before = dict(cuda_build.LAUNCHES)
    with (cuda_build.mma_sync_only() if forced else _nothing()):
        got = [qmm.quant_matmul(x, w, sc, w8a8=True), qmm.quant_matmul(x, w, sc),
               qmm.quant_matmul_t(dy, w, sc)]
    want = [qmm.qmm_plain(x, w, sc, None, None, True, group, k_pad),
            qmm.qmm_plain(x, w, sc), qmm.qmm_t_plain(dy, w, sc)]
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert dict(cuda_build.LAUNCHES) == before  # nothing launched


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
