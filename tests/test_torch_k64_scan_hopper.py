"""x_embedder's K 64 GEMM and the chunked S4D scan: their host-side logic
and their arithmetic on the CPU.

* The shape rule `qmm_route` (``"k64"``): x_embedder (K 64, N 3072, its
  case in ``chip_smoke.qmm_cases``) takes it in both MAC modes, ``cuda_build.mma_sync_only`` forces ``"mma_sync"`` and restores
  it, and the edges of the rule (K 16..64 a multiple of 16, N whole 128
  tiles, W8A8 with one activation group over the padded row and no
  prologue; the weight-only prologue runs as a pass ahead).
* The folded W8A8 quantization: a plain model of the kernel's (one scale a
  row over its K values, the codes by ``quant8::codes8``'s reciprocal test,
  zeros past K up to 128) equals `act_quant_plain(x, 128, 128)` bit for bit,
  zero rows and the 1.625 / 3.25 tie included.
* `qmm_plain` at K 64 N 3072 (both modes, bias, M 256 and a ragged M)
  against the Pallas kernels (`quant_matmul`, `quant_matmul_w8a8`) in
  interpret mode, within one bf16 rounding (2^-7 max|ref|).
* `s4d_chunk_plan`: the chunks cover L exactly (ragged L included), every
  block within its thread and shared-memory limits with a thread for each
  of its states (a short L included), the lanes hold every state.
* A PyTorch model of the chunked scan's arithmetic (chunks from a zero
  state, Abar^T by squaring in float64, the carry walk, the rerun in the
  z = x / Bbar form) within 1e-4 of `s4d_scan_plain`, of JAX's Pallas
  kernel in interpret mode and of its associative `s4d_scan`: at EEG narrow
  (L 4096, H 4, N 2) full length, and at EEG wide's width (H 64, N 32)
  with L cut from 4096 to 1000 (ragged: the last chunk shorter) to keep
  the file's run short, and a short layer (L 8, H 16, N 8).
* CPU tensors take the plain versions on every route; the ctypes
  signatures of the new C entries match their declarations.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from loongx_tpu.ops import quant_matmul as jqmm
from loongx_tpu.ops import s4 as js4
from loongx_tpu.ops import s4_pallas as jsp
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops import s4 as ts4
from loongx_tpu_torch.ops import s4_scan as tss
from loongx_tpu_torch.utils.bridge import from_numpy_tree

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

X_EMBEDDER = (64, 3072)  # x_embedder's weight [K, N]
S4_ATOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a) -> np.ndarray:
    """float32 values exactly representable in bf16."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# The K 64 rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "wonly"])
def test_x_embedder_takes_the_k64_route(w8a8):
    group, k_pad = qmm.flat_w8a8_group(*X_EMBEDDER)
    assert (group, k_pad) == (128, 128)  # one group over the padded row
    assert qmm.qmm_route(*X_EMBEDDER, group, k_pad, w8a8) == "k64"
    assert qmm.splitk_plan(*X_EMBEDDER, group, k_pad, w8a8) is None
    cases = [(lbl, m) for lbl, m, k, n in chip_smoke.qmm_cases()[1]
             if (k, n) == X_EMBEDDER]
    assert cases == [("x_embedder", 1024)]


def test_mma_sync_only_forces_and_restores_the_k64_route():
    group, k_pad = qmm.flat_w8a8_group(*X_EMBEDDER)
    rule = qmm.qmm_route(*X_EMBEDDER, group, k_pad, True)
    assert qmm.active_route(rule) == "k64"
    with pytest.raises(RuntimeError):
        with cuda_build.mma_sync_only():
            assert qmm.active_route(rule) == "mma_sync"
            raise RuntimeError("inside")
    assert qmm.active_route(rule) == "k64"


@pytest.mark.parametrize("k,n,w8a8,prologue,want", [
    (64, 3072, True, False, "k64"),
    (64, 3072, False, False, "k64"),
    (16, 128, True, False, "k64"),        # the smallest K and N
    (48, 256, False, False, "k64"),
    (8, 3072, False, False, "mma_sync"),  # K below one k16 step
    (56, 3072, True, False, "mma_sync"),  # K not a multiple of 16
    (80, 3072, False, False, "mma_sync"),  # K past one 64-wide panel
    (64, 192, True, False, "mma_sync"),   # N not whole 128 tiles
    (64, 64, False, False, "mma_sync"),   # N below one tile (and K below split-K's)
    (64, 3072, True, True, "mma_sync"),   # W8A8 prologue: the activation pass takes it
    (64, 3072, False, True, "k64"),       # weight-only prologue: a pass ahead
    (128, 3072, True, False, "wgmma"),    # one whole 128-deep stage
], ids=lambda v: str(v))
def test_qmm_route_k64_edges(k, n, w8a8, prologue, want):
    group, k_pad = qmm.flat_w8a8_group(k, n)
    assert qmm.qmm_route(k, n, group, k_pad, w8a8, prologue) == want


@pytest.mark.parametrize("group,k_pad,want", [
    (128, 128, "k64"),      # the flat policy's (K zero-padded to 128)
    (64, 64, "k64"),        # the stacked policy's at K 64: one group still
    (64, 128, "mma_sync"),  # two groups over the row: two scales a row
])
def test_k64_w8a8_needs_one_group_over_the_row(group, k_pad, want):
    assert qmm.qmm_route(64, 3072, group, k_pad, True) == want
    assert qmm.qmm_route(64, 3072, group, k_pad, False) == "k64"


def test_weight_only_prologue_on_k64_is_a_pass():
    x, ab = torch.randn(3, 64), torch.randn(8, 64)
    xp, ab_left, stats = qmm._prologue(x, ab, 1, "k64", False)
    assert ab_left is None and stats is None and xp.dtype == torch.bfloat16
    assert torch.equal(xp, qmm.ln_mod_pass_plain(x, ab, 1)[0])


def _c_params(source: str, name: str):
    """The parameter kinds ("p" pointer, "i" int) of ``extern "C" int
    name(...)`` in ``loongx_tpu_torch/csrc/<source>.cu``."""
    text = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    assert m, name
    return ["p" if "*" in arg else "i" for arg in m.group(1).split(",")]


@pytest.mark.parametrize("source,name,signature", [
    ("quant_matmul", "qmm_gemm_k64", qmm._K64_SIGNATURE),
    ("s4d_scan", "s4d_chunk_scan", tss._CHUNK_SIGNATURE),
    ("s4d_scan", "s4d_scan", tss._SIGNATURE),
], ids=["qmm_gemm_k64", "s4d_chunk_scan", "s4d_scan"])
def test_ctypes_signatures_match_the_c_entries(source, name, signature):
    # ctypes passes an int where the C entry takes a pointer (or the reverse)
    # without complaint on the CPU; the card's machine would see a cut pointer
    kinds = ["p" if t is ctypes.c_void_p else "i" for t in signature]
    assert kinds == _c_params(source, name)


# ---------------------------------------------------------------------------
# The folded W8A8 quantization
# ---------------------------------------------------------------------------


def _codes8_model(x_row: np.ndarray):
    """The K 64 kernel's quantization of one row of bf16 values (float32
    numpy): x_scale = absmax / 127 (1 when 0), then quant8::codes8: t = x *
    fl(1 / x_scale), rint by adding 1.5 * 2^23, IEEE division where t lies
    within 2^-14 of a half-integer."""
    f32 = np.float32
    absmax = np.abs(x_row).max()
    scale = f32(1.0) if absmax == 0 else f32(absmax) / f32(127.0)
    r = f32(1.0) / scale
    codes = np.empty(x_row.shape, np.float32)
    for i, v in enumerate(x_row.astype(np.float32)):
        t = f32(v * r)
        y = f32(t + f32(12582912.0))
        rt = f32(y - f32(12582912.0))
        if not abs(f32(t - rt)) <= f32(0.5 - 2.0 ** -14):
            rt = np.clip(np.rint(f32(v) / scale), -127, 127)
        codes[i] = rt
    return codes, scale


@pytest.mark.parametrize("k", [64, 48])
def test_folded_quantization_equals_the_activation_pass(k):
    rng = np.random.default_rng(61 + k)
    x = _bf16_np(2.0 * rng.standard_normal((24, k)))
    x[0] = 0.0                                   # a zero row: x_scale 1
    x[1, :3] = [3.25, 1.625, -1.625]             # the tie at absmax / 2
    x[1, 3:] = np.clip(x[1, 3:], -3.0, 3.0)
    x[2] = _bf16_np(np.linspace(-1.0, 1.0, k))   # many values near halves
    x[3, 5] = _bf16_np(1e-3)                     # a row of one tiny value
    x[3, np.arange(k) != 5] = 0.0
    q_ref, xs_ref = qmm.act_quant_plain(_t(x).to(torch.bfloat16), 128, 128)
    assert q_ref.shape == (24, 128) and xs_ref.shape == (24, 1)
    for row in range(x.shape[0]):
        codes, scale = _codes8_model(x[row])
        want = np.concatenate([codes, np.zeros(128 - k, np.float32)])
        np.testing.assert_array_equal(want, q_ref[row].numpy())
        assert np.float32(scale) == xs_ref[row, 0].item()
    assert q_ref[1, 1].item() == 63.0  # 1.625 / fl(3.25 / 127) = 63.499996


# ---------------------------------------------------------------------------
# The plain versions at x_embedder against the Pallas kernels
# ---------------------------------------------------------------------------


def _untie(x: np.ndarray) -> np.ndarray:
    """Move every activation equal to +-absmax/2 of its row (the W8A8
    rounding tie where XLA:CPU's fused division and IEEE division part) to
    the next bf16 value towards zero."""
    half = np.abs(x).max(1, keepdims=True) / 2
    tie = (np.abs(x) == half) & (half > 0)
    x[tie] = _bf16_np(x[tie] * (1 - 2.0 ** -8) - x[tie] * 2.0 ** -12)
    return x


@pytest.mark.parametrize("m", [256, 37], ids=["M256", "ragged_M37"])
@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "wonly"])
def test_qmm_plain_at_x_embedder_matches_pallas(w8a8, m):
    k, n = X_EMBEDDER
    group, k_pad = qmm.flat_w8a8_group(k, n)
    rng = np.random.default_rng(71 + m)
    x = _untie(_bf16_np(rng.standard_normal((m, k))))
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 3e-3, (1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal((1, n))).astype(np.float32)
    jfn = jqmm.quant_matmul_w8a8 if w8a8 else jqmm.quant_matmul
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                          bias=jnp.asarray(bias), interpret=True), np.float32)
    got = qmm.qmm_plain(_t(x).to(torch.bfloat16), _t(w), _t(scale), _t(bias),
                        None, w8a8, group, k_pad)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("forced", [False, True], ids=["rule", "mma_sync_only"])
def test_cpu_wrappers_at_x_embedder_run_the_plain_versions(forced):
    k, n = X_EMBEDDER
    rng = np.random.default_rng(73)
    x = _t(_bf16_np(rng.standard_normal((5, k)))).to(torch.bfloat16)
    w = _t(rng.integers(-128, 128, (k, n)).astype(np.int8))
    sc = _t(rng.uniform(1e-3, 3e-3, (1, n)).astype(np.float32))
    group, k_pad = qmm.flat_w8a8_group(k, n)
    p = ts4.init_s4d_layer(4, 4, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    u = torch.randn(1, 40, 4, generator=torch.Generator().manual_seed(1))
    before = dict(cuda_build.LAUNCHES)
    with (cuda_build.mma_sync_only() if forced else _nothing()):
        got = [qmm.quant_matmul(x, w, sc, w8a8=True), qmm.quant_matmul(x, w, sc)]
        y = tss.s4d_scan_recurrent(p, u)
    want = [qmm.qmm_plain(x, w, sc, None, None, True, group, k_pad),
            qmm.qmm_plain(x, w, sc)]
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    assert torch.equal(y, tss.s4d_scan_plain(p, u))
    assert dict(cuda_build.LAUNCHES) == before  # nothing launched


# ---------------------------------------------------------------------------
# The chunked S4D scan: the plan
# ---------------------------------------------------------------------------


def _plan_cases():
    return ([(label, length, h, n) for label, _, length, h, n in chip_smoke.s4d_cases()]
            + [("ragged L4001", 4001, 64, 32), ("L1", 1, 1, 1),
               ("N64", 1024, 8, 64), ("N128", 4096, 3, 128), ("N5 H20", 300, 20, 5),
               ("N12 L3", 3, 2, 12), ("N12 L1", 1, 2, 12),
               ("short L H16 N8", 8, 16, 8), ("short L N64", 8, 2, 64)])


@pytest.mark.parametrize("label,length,h,n", _plan_cases(),
                         ids=[c[0] for c in _plan_cases()])
def test_s4d_chunk_plan_covers_the_layer(label, length, h, n):
    plan = tss.s4d_chunk_plan(length, h, n)
    # the chunks cover L exactly: all but the last whole, the last 1..T steps
    assert (plan.C - 1) * plan.T < length <= plan.C * plan.T
    # the lanes of a (chunk, channel) hold every state, at most 8 a lane
    assert plan.nq & (plan.nq - 1) == 0 and plan.nq <= 32
    assert plan.q <= tss.S4D_MAX_Q and plan.q * plan.nq >= n
    assert plan.q * (plan.nq // 2) < n or plan.nq == 1  # no lane idle
    # a cluster of two splits a channel's chunks in halves: one channel a
    # block, an even count of chunks
    assert plan.cl in (1, 2)
    if plan.cl == 2:
        assert plan.hb == 1 and plan.nq > 1 and plan.C % 2 == 0
    # the block: whole warps within its limit (csrc/s4d_scan.cu CS_MAX_THREADS),
    # a thread a lane and one a state of its channels (the prologue, the walk)
    lanes = plan.C // plan.cl * plan.hb * plan.nq
    states = plan.hb * plan.q * plan.nq
    assert plan.threads >= states
    need = max(lanes, states)
    assert plan.threads % 32 == 0 and need <= plan.threads < need + 32
    assert plan.threads <= tss.S4D_MAX_THREADS == 512
    assert 1 <= plan.hb <= min(h, tss.S4D_MAX_HB)
    assert plan.hb == 1 or plan.hb * length <= tss.S4D_BLOCK_U
    np_, cc = plan.q * plan.nq, plan.C // plan.cl
    assert plan.smem == 4 * (cc * (plan.T + 1) * plan.hb + 2 * cc * plan.hb * np_
                             + 6 * plan.hb * np_)
    assert plan.smem <= tss.SMEM_PER_BLOCK
    # the dependent chain is far below L once L is long
    if length >= 1024:
        assert 2 * plan.T + plan.C <= length // 10


def test_s4d_chunk_plan_at_the_encoder_shapes():
    # (T, C, hb, nq, q, cl, threads)
    want = {"EEG wide": (64, 64, 1, 4, 8, 2, 128), "EEG narrow": (64, 64, 1, 1, 2, 1, 64),
            "PPG": (16, 16, 4, 1, 2, 1, 64), "fNIRS": (16, 32, 6, 1, 3, 1, 192),
            "motion": (8, 16, 6, 1, 3, 1, 96)}
    for label, _, length, h, n in chip_smoke.s4d_cases():
        plan = tss.s4d_chunk_plan(length, h, n)
        got = (plan.T, plan.C, plan.hb, plan.nq, plan.q, plan.cl, plan.threads)
        assert got == want[label]


def test_s4d_chunk_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="N 1..128"):
        tss.s4d_chunk_plan(4096, 4, 129)
    with pytest.raises(ValueError, match="shared memory"):
        tss.s4d_chunk_plan(100_000, 4, 2)


# ---------------------------------------------------------------------------
# The chunked S4D scan: its arithmetic, modelled in PyTorch
# ---------------------------------------------------------------------------


def _power(ar: torch.Tensor, ai: torch.Tensor, e: int):
    """Abar^e by squaring in float64, rounded once to float32 (the walk's
    power)."""
    pr, pi = torch.ones_like(ar, dtype=torch.float64), torch.zeros_like(ar, dtype=torch.float64)
    br, bi = ar.double(), ai.double()
    while e:
        if e & 1:
            pr, pi = pr * br - pi * bi, pr * bi + pi * br
        br, bi = br * br - bi * bi, 2.0 * br * bi
        e >>= 1
    return pr.float(), pi.float()


def chunked_scan_model(p, u: torch.Tensor) -> torch.Tensor:
    """s4d_chunk_scan_kernel's arithmetic in float32 PyTorch (its fma
    excepted): `s4d_chunk_plan`'s chunks run z_t = Abar z_{t-1} + u_t from
    zero (A), one walk carries X_c = Abar^T X_{c-1} + e_c (B), each chunk
    reruns from X_{c-1} and y_t = 2 sum_n Re(G z_t) + D u_t, G = C Bbar (C)."""
    ar, ai, br, bi, cr, ci = ts4.discretise_real(p)
    gr, gi = cr * br - ci * bi, cr * bi + ci * br
    uf = u.float()
    b, length, h = uf.shape
    plan = tss.s4d_chunk_plan(length, h, ar.shape[1])
    t, c = plan.T, plan.C
    up = F.pad(uf, (0, 0, 0, c * t - length)).view(b, c, t, h)
    zr = uf.new_zeros(b, c, h, ar.shape[1])
    zi = torch.zeros_like(zr)
    for k in range(t):
        uk = up[:, :, k, :, None]
        zr, zi = ar * zr - ai * zi + uk, ai * zr + ar * zi
    pr, pi = _power(ar, ai, t)
    xr, xi = [torch.zeros_like(zr[:, 0]), zr[:, 0]], [torch.zeros_like(zi[:, 0]), zi[:, 0]]
    for j in range(1, c - 1):
        xr.append(pr * xr[-1] - pi * xi[-1] + zr[:, j])
        xi.append(pi * xr[-2] + pr * xi[-1] + zi[:, j])
    zr, zi = torch.stack(xr[:c], 1), torch.stack(xi[:c], 1)
    ys = []
    for k in range(t):
        uk = up[:, :, k, :]
        zr, zi = ar * zr - ai * zi + uk[..., None], ai * zr + ar * zi
        ys.append(2.0 * (gr * zr - gi * zi).sum(-1) + p["D"] * uk)
    return torch.stack(ys, 2).reshape(b, c * t, h)[:, :length].to(u.dtype)


# (label, H, N state pairs, L): EEG narrow at its full length; EEG wide at
# its full width (H 64, N 32) with L cut from 4096 to 1000; a short layer
# of fewer chunks than a lane has states
_MODEL_CASES = [("EEG narrow", 4, 2, 4096), ("EEG wide, L cut to 1000", 64, 32, 1000),
                ("short L H16 N8", 16, 8, 8)]


@pytest.mark.parametrize("label,h,n,length", _MODEL_CASES,
                         ids=[c[0] for c in _MODEL_CASES])
def test_chunked_scan_model_matches_the_recurrences(label, h, n, length):
    p = js4.init_s4d_layer(jax.random.key(h), h, 2 * n)
    u = np.random.default_rng(h).standard_normal((1, length, h), np.float32)
    tp = from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")
    got = chunked_scan_model(tp, _t(u)).numpy()
    plain = tss.s4d_scan_plain(tp, _t(u)).numpy()
    pallas = np.asarray(jsp.s4d_scan_pallas(p, jnp.asarray(u), interpret=True))
    assoc = np.asarray(js4.s4d_scan(p, jnp.asarray(u)))
    assert got.shape == plain.shape == (1, length, h)
    for want in (plain, pallas, assoc):
        np.testing.assert_allclose(got, want, atol=S4_ATOL, rtol=0)
