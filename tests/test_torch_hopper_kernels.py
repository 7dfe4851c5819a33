"""Host-side logic of the port's wgmma kernels, on the CPU.

* The flash forward's RoPE pre-pass (``flash_rope``): its plain version
  rotates q and k exactly as the JAX package does (``ops/rope.py``
  ``apply_rope`` and the Pallas kernel's ``_rope_rotate``), bit for bit in
  bf16, in both layouts; on CPU tensors the wrapper is the plain version.
* The shape rules that pick between the hand-written forward kernels of a
  contract: ``qmm_route`` over every main-path shape of
  ``chip_smoke.qmm_cases`` (W8A8 and weight-only, both on wgmma wherever
  the 128 x 128 tiles fit, on split-K at proj_out's N 64, on the K 64
  kernel at x_embedder) and at its edges,
  ``flash_fwd_route`` by head_dim, and ``cuda_build.mma_sync_only``.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import rope as jrope
from loongx_tpu.ops.flash_attention import _pair_swap_matrix, _rope_rotate
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import flash_attention as fa
from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops.rope import rope_embed

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _bits(t) -> np.ndarray:
    """The bf16 bit patterns of a torch or JAX array, as int16."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _qk_rope(seed: int, b: int, h: int, s: int, d: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)) * 2.0
    k = rng.standard_normal((b, h, s, d)) * 2.0
    ids = np.floor(rng.random((s, 3)) * 64).astype(np.float32)
    cos, sin = rope_embed(torch.from_numpy(ids))
    return q, k, cos, sin


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flash_rope_plain_matches_jax_apply_rope(layout, seed):
    q, k, cos, sin = _qk_rope(seed, 2, 3, 37, 128)
    tq, tk = _bf16(q), _bf16(k)
    if layout == "bshd":
        tq, tk = tq.transpose(1, 2).contiguous(), tk.transpose(1, 2).contiguous()
    got = fa.flash_rope_plain(tq, tk, (cos, sin), layout)
    assert got.shape == (2, 2, 3, 37, 128) and got.dtype == torch.bfloat16
    jc, js = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    for i, x in enumerate((q, k)):
        want = jrope.apply_rope(jnp.asarray(x, jnp.bfloat16), jc, js)
        np.testing.assert_array_equal(_bits(got[i]), _bits(want))


def test_flash_rope_plain_matches_pallas_rope_rotate():
    q, k, cos, sin = _qk_rope(2, 1, 2, 64, 128)
    got = fa.flash_rope_plain(_bf16(q), _bf16(k), (cos, sin))
    r = _pair_swap_matrix(128)
    jc, js = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    for i, x in enumerate((q, k)):
        for head in range(2):
            want = _rope_rotate(jnp.asarray(x[0, head], jnp.bfloat16), jc, js, r)
            np.testing.assert_array_equal(_bits(got[i, 0, head]), _bits(want))


def test_flash_rope_on_cpu_is_the_plain_version():
    q, k, cos, sin = _qk_rope(3, 1, 2, 20, 128)
    tq, tk = _bf16(q), _bf16(k)
    before = dict(cuda_build.LAUNCHES)
    got = fa.flash_rope(tq, tk, (cos, sin))
    assert torch.equal(got, fa.flash_rope_plain(tq, tk, (cos, sin)))
    assert dict(cuda_build.LAUNCHES) == before  # nothing launched


def _main_path_shapes():
    """(entry, label, M, K, N) of every W8A8 GEMM case chip_smoke checks."""
    stacked, flat, qkv = chip_smoke.qmm_cases()
    out = [("qmm_stacked", label, m, k, n) for label, m, k, n, _, _ in stacked]
    out += [("qmm_flat", label, m, k, n) for label, m, k, n in flat]
    out += [("qmm_qkv_stacked", label, m, 3072, 9216) for label, m, _ in qkv]
    return out


# the flat layers the 128 x 128 tiles cannot take: K 64 on its own kernel,
# N 64 split over a cluster (both modes)
_K64 = {("qmm_flat", "x_embedder")}
_SPLITK = {("qmm_flat", "proj_out"), ("qmm_flat", "ragged M1000 proj_out")}


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "wonly"])
@pytest.mark.parametrize("entry,label,m,k,n", _main_path_shapes(),
                         ids=[f"{e}-{lbl}" for e, lbl, *_ in _main_path_shapes()])
def test_qmm_route_main_path(entry, label, m, k, n, w8a8):
    if entry == "qmm_flat":
        group, k_pad = qmm.flat_w8a8_group(k, n)
    else:
        group, k_pad = qmm.stacked_w8a8_group(k, n)
    route = qmm.qmm_route(k, n, group, k_pad, w8a8)
    if (entry, label) in _K64:
        assert route == "k64"
        # the K 64 kernel's preconditions (csrc/quant_matmul.cu k64::launch)
        assert 16 <= k <= 64 and k % 16 == 0 and n % 128 == 0
    elif (entry, label) in _SPLITK:
        assert route == "splitk"
        # the split-K kernel's preconditions (csrc/quant_matmul.cu sk::launch)
        assert k % 128 == 0 and 16 <= n < 128 and n % 16 == 0
    else:
        assert route == "wgmma"
        # the wgmma kernels' own preconditions (csrc/quant_matmul.cu wg::launch,
        # wg::wo::launch)
        assert k >= 128 and n >= 128 and n % 16 == 0
        if w8a8:
            assert k_pad % 128 == 0 and group % 128 == 0
        else:
            assert k % 128 == 0


@pytest.mark.parametrize("k,n,group,k_pad,want,want_wonly", [
    (128, 128, 128, 128, "wgmma", "wgmma"),         # one tile
    (64, 3072, 128, 128, "k64", "k64"),   # K below a tile: one 64-wide panel
    (3072, 64, 1536, 3072, "splitk", "splitk"),  # N below a tile: split K
    (3072, 3072, 1536, 3072, "wgmma", "wgmma"),
    (192, 3072, 192, 192, "mma_sync", "mma_sync"),  # not whole k tiles
    (256, 3072, 256, 320, "mma_sync", "wgmma"),  # k_pad is not whole k tiles
    (200, 3072, 256, 256, "wgmma", "mma_sync"),  # K not whole k tiles
])
def test_qmm_route_edges(k, n, group, k_pad, want, want_wonly):
    assert qmm.qmm_route(k, n, group, k_pad, True) == want
    assert qmm.qmm_route(k, n, group, k_pad, False) == want_wonly
    # the LN + adaLN prologue forms take the same rule: W8A8 applies the
    # prologue in its activation pass, weight-only in a pass of its own
    # ahead of the wgmma, split-K and K 64 GEMMs (`_prologue` leaves the GEMM no
    # ab), on the A tile of the mma.sync kernel
    x, ab = torch.randn(3, k), torch.randn(8, k)
    for w8a8, route in ((True, want), (False, want_wonly)):
        _, ab_left, stats = qmm._prologue(x, ab, 1, route, w8a8)
        assert (ab_left is None) == (route != "mma_sync" and not w8a8)
        assert (stats is None) == (ab_left is None)


@pytest.mark.parametrize("d,want", [(128, "wgmma"), (64, "mma_sync")])
def test_flash_fwd_route(d, want):
    assert fa.flash_fwd_route(d) == want


def test_mma_sync_only_restores_the_rule():
    assert cuda_build.FORCED_ROUTE is None
    with pytest.raises(RuntimeError):
        with cuda_build.mma_sync_only():
            assert cuda_build.FORCED_ROUTE == "mma_sync"
            raise RuntimeError("inside")
    assert cuda_build.FORCED_ROUTE is None


def test_cpu_entries_ignore_the_route():
    """On CPU tensors the forced route changes nothing: the plain versions
    run and nothing is launched."""
    rng = np.random.default_rng(5)
    x = _bf16(rng.standard_normal((9, 256)))
    w = torch.from_numpy(rng.integers(-128, 128, (2, 256, 128)).astype(np.int8))
    sc = torch.full((2, 1, 128), 1e-3)
    before = dict(cuda_build.LAUNCHES)
    ref = qmm.quant_matmul_stacked(x, w, sc, 1, w8a8=True)
    with cuda_build.mma_sync_only():
        got = qmm.quant_matmul_stacked(x, w, sc, 1, w8a8=True)
    assert torch.equal(got, ref)
    assert dict(cuda_build.LAUNCHES) == before
