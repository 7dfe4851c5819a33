"""The flash backward's wgmma route, its host side on the CPU.

* The rotated-input contract the wgmma dK/dV and dQ kernels take: q and k
  already rotated by the forward's RoPE pre-pass (`flash_rope_plain`'s
  output, or q and k head-major without RoPE), dq and dk rotated back.  Its
  plain version must equal the TPU kernels ``_flash_bwd_pallas`` in
  interpret mode on ``test_torch_grad.py``'s cases, at that file's
  tolerance (atol 1e-4, rtol 1e-3, float32), and the unrotated contract
  bit for bit where there is no RoPE.
* `_FlashAttentionFn` on CPU tensors against autograd through the plain
  forward, RoPE on and off, batch 2, both layouts.
* `flash_bwd_route` by head_dim, `active_route` under
  `cuda_build.mma_sync_only`, and the refusal of rotated inputs off the
  wgmma route.
* The tile rules both wgmma backward kernels skip and unmask by
  (``tile_visible`` / ``tile_plain`` in ``csrc/flash_attention.cu``,
  mirrored here) against the block mask, at the dQ kernel's 128 x 128
  tiles and the dK/dV kernel's 64-query x 128-key tiles.
* `chip_smoke`'s phase-2 cases cover batch 2, both layouts, every mode,
  a ragged S and RoPE off.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import flash_attention as jfa
from loongx_tpu.ops.rope import rope_embed as jrope_embed
from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops import flash_attention as tfa
from loongx_tpu_torch.ops.attention import _block_bias
from loongx_tpu_torch.ops.rope import rope_embed

_ROOT = Path(__file__).resolve().parents[1]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chip_smoke = _load("chip_smoke", _ROOT / "chip_smoke.py")
FLASH_CASES = _load("_torch_grad_cases", _ROOT / "tests" / "test_torch_grad.py").FLASH_CASES


def _jax_case(s, c, mode, layout, use_rope):
    """(inputs, JAX's gradients, the port's residuals) as test_torch_grad
    builds them: float32, batch 1, 2 heads of 32."""
    b, h, d = 1, 2, 32
    bshd = layout == "bshd"
    shape = (b, s, h, d) if bshd else (b, h, s, d)
    rng = np.random.default_rng(s + c)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    if use_rope:
        ids = np.stack([np.zeros(s), np.arange(s), (np.arange(s) * 7) % 23], 1)
        cos, sin = (np.array(x) for x in jrope_embed(
            jnp.asarray(ids, jnp.float32), axes_dim=(8, 12, 12)))
    else:
        cos = sin = np.zeros((8, d), np.float32)
    cond_start = s - c
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, m, l = jfa._flash_fwd(
        jq, jk, jv, jnp.zeros((1, 1), jnp.float32), jnp.asarray(cos),
        jnp.asarray(sin), cond_start, mode, 128, 128, use_rope, True,
        save_residuals=True, bshd=bshd)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin),
                                 o, m, l, jdo, cond_start, mode, 128, 128,
                                 use_rope, True, bshd=bshd)
    t = {n: torch.from_numpy(x) for n, x in (("q", q), ("k", k), ("v", v), ("do", do))}
    m2 = torch.from_numpy(np.asarray(m)[..., 0] * np.float32(math.log2(math.e)))
    lt = torch.from_numpy(np.array(l)[..., 0])
    di = tfa._row_dot(torch.from_numpy(np.array(o)), t["do"], layout)
    rope = (torch.from_numpy(cos), torch.from_numpy(sin)) if use_rope else None
    return t, want, (m2, lt, di), rope


def _qk_rot(q, k, rope, layout):
    """The wgmma route's q / k input: the pre-pass output, or q and k
    head-major as they lie when there is no RoPE."""
    if rope is not None:
        return tfa.flash_rope_plain(q, k, rope, layout)
    return torch.stack([x.transpose(1, 2) if layout == "bshd" else x for x in (q, k)])


@pytest.mark.parametrize("s,c,mode,layout,use_rope", FLASH_CASES)
def test_rotated_contract_matches_tpu_kernels(s, c, mode, layout, use_rope):
    t, want, (m2, lt, di), rope = _jax_case(s, c, mode, layout, use_rope)
    kw = dict(cond_start=s - c, mode=mode, rope=rope, layout=layout)
    qk_rot = _qk_rot(t["q"], t["k"], rope, layout)
    got = tfa.flash_attention_bwd_plain(None, None, t["v"], t["do"], m2, lt, di,
                                        qk_rot=qk_rot, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == t["v"].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    # the wrapper on CPU tensors is the plain version, q and k unread
    before = dict(cuda_build.LAUNCHES)
    got_w = tfa.flash_attention_bwd(None, None, t["v"], t["do"], m2, lt, di,
                                    qk_rot=qk_rot, **kw)
    assert dict(cuda_build.LAUNCHES) == before
    for g, w in zip(got_w, got):
        assert torch.equal(g, w)
    if rope is None:  # nothing to rotate: the two contracts are one
        ref = tfa.flash_attention_bwd_plain(t["q"], t["k"], t["v"], t["do"], m2, lt,
                                            di, **kw)
        for g, w in zip(got, ref):
            assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
@pytest.mark.parametrize("mode", ["union", "no_union", "independent"])
def test_autograd_batch2_matches_plain_autograd(mode, use_rope, layout):
    s, h, d, cond_start = 37, 2, 16, 25
    g = torch.Generator().manual_seed(11)
    shape = (2, s, h, d) if layout == "bshd" else (2, h, s, d)
    q, k, v, cot = (torch.randn(shape, generator=g) for _ in range(4))
    ids = torch.stack([torch.zeros(s), torch.arange(s) % 5,
                       (torch.arange(s) * 3) % 13], 1).float()
    rope = rope_embed(ids, (4, 6, 6)) if use_rope else None
    kw = dict(cond_start=cond_start, mode=mode, rope=rope, layout=layout)
    inputs = tuple(t.clone().requires_grad_() for t in (q, k, v))
    o = tfa.flash_attention(*inputs, **kw)
    assert o.grad_fn is not None
    grads = torch.autograd.grad(o, inputs, cot)
    ref_inputs = tuple(t.clone().requires_grad_() for t in (q, k, v))
    o_ref = tfa.flash_attention_plain(*ref_inputs, **kw)
    grads_ref = torch.autograd.grad(o_ref, ref_inputs, cot)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.detach().numpy(), atol=1e-6)
    for name, a, b in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d,want", [(128, "wgmma"), (64, "mma_sync"), (32, "mma_sync")])
def test_flash_bwd_route(d, want):
    assert tfa.flash_bwd_route(d) == want
    # one rule for both directions: a forward and its backward take one route
    assert tfa.flash_fwd_route(d) == want
    assert tfa.active_route(d) == want
    with cuda_build.mma_sync_only():
        assert tfa.active_route(d) == "mma_sync"
    assert tfa.active_route(d) == want


def test_rotated_inputs_need_the_wgmma_route():
    """Rotated q and k are only the wgmma kernels' input: off that route the
    call refuses them before it looks at the device or builds anything."""
    x = torch.empty(1, 4, 2, 128, device="meta")
    stats = [torch.empty(1, 2, 4, device="meta")] * 3
    qk_rot = torch.empty(2, 1, 2, 4, 128, device="meta")
    kw = dict(cond_start=4, layout="bshd", qk_rot=qk_rot)
    with cuda_build.mma_sync_only():
        with pytest.raises(ValueError, match="wgmma route"):
            tfa.flash_attention_bwd(None, None, x, x, *stats, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_bwd(None, None, x, x, *stats, **kw)


def _tile_visible(mode, cs, s, q0, nq, kv0, nk):
    rows_main, rows_cond = q0 < cs, q0 + nq > cs and cs < s
    cols_main, cols_cond = kv0 < cs, kv0 + nk > cs and cs < s
    if mode == "no_union":
        return (rows_main and cols_main) or (rows_cond and cols_cond)
    if mode == "independent":
        return rows_main or cols_cond
    return True


def _tile_plain(mode, cs, s, q0, nq, kv0, nk):
    if kv0 + nk > s:
        return False
    if mode == "union":
        return True
    rows_main, rows_cond = q0 + nq <= cs, q0 >= cs
    cols_main, cols_cond = kv0 + nk <= cs, kv0 >= cs
    if mode == "independent":
        return rows_main or cols_cond
    return (rows_main and cols_main) or (rows_cond and cols_cond)


@pytest.mark.parametrize("nq", [128, 64], ids=["dq_tiles", "dkv_tiles"])
@pytest.mark.parametrize("s,c", [(2560, 1024), (300, 77), (1000, 300), (1024, 256),
                                 (2000, 700), (256, 0)])
@pytest.mark.parametrize("mode", ["union", "no_union", "independent"])
def test_tile_rules_agree_with_the_block_mask(mode, s, c, nq):
    """A skipped tile holds no visible (query, key) pair; a plain tile holds
    no masked pair and no padded key; past S every query row is padding."""
    cs = s - c
    bias = _block_bias(s, cs, mode, None, "cpu") if cs < s else None
    seen = torch.ones(s, s, dtype=torch.bool) if bias is None else bias == 0
    for q0 in range(0, s, nq):
        for kv0 in range(0, s, 128):
            block = seen[q0:q0 + nq, kv0:kv0 + 128]
            if not _tile_visible(mode, cs, s, q0, nq, kv0, 128):
                assert not block.any(), (q0, kv0)
            if _tile_plain(mode, cs, s, q0, nq, kv0, 128):
                assert block.all() and kv0 + 128 <= s, (q0, kv0)


def test_chip_smoke_cases_cover_batch_layouts_modes():
    fwd = chip_smoke.flash_cases()
    bwd = chip_smoke.flash_bwd_cases()
    for cases, mode_at, layout_at in ((fwd, 4, 6), (bwd, 4, 5)):
        batch2 = [c for c in cases if c[1] == 2]
        assert {c[layout_at] for c in batch2} == {"bshd", "bhsd"}
        assert any(c[2] % 128 for c in batch2)  # ragged
        assert {c[mode_at] for c in cases} >= {"union", "no_union", "independent"}
        assert {c[layout_at] for c in cases} == {"bshd", "bhsd"}
    assert {c[6] for c in bwd} == {True, False}  # RoPE on and off
    # the main case the kernel table reads
    assert bwd[0][:5] == ("S2560 union", 1, 2560, 1024, "union")
    assert fwd[0][:5] == ("S2560 union", 1, 2560, 1024, "union")
