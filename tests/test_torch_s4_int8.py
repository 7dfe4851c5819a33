"""The port's last two TPU kernel contracts against the JAX package, on CPU:
the S4D recurrence (``s4_stack_apply(..., "pallas")`` and `s4d_scan_plain`
against the Pallas kernel ``s4d_scan_pallas`` in interpret mode, atol 1e-4
as tests/test_s4_pallas.py holds it against the scan) and the int8 QK^T
attention mode (the plain version against the Pallas forward in interpret
mode under LOONGX_INT8_ATTN=1, relative L2 1e-3, every mode, RoPE, padding;
the k-scale span policy; gradients unchanged by the mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import flash_attention as jfa
from loongx_tpu.ops import s4 as js4
from loongx_tpu.ops import s4_pallas as jsp
from loongx_tpu.ops.rope import rope_embed as jrope
from loongx_tpu_torch.ops import attention as tattn
from loongx_tpu_torch.ops import flash_attention as tfa
from loongx_tpu_torch.ops import s4 as ts4
from loongx_tpu_torch.ops import s4_scan as tss
from loongx_tpu_torch.utils.bridge import from_numpy_tree

S4_ATOL = 1e-4
INT8_REL_L2 = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("h, n_state, length", [(6, 6, 96), (4, 4, 64),
                                                (8, 64, 48)])
def test_s4d_scan_plain_matches_pallas(h, n_state, length):
    p = js4.init_s4d_layer(jax.random.key(h), h, n_state)
    u = np.random.default_rng(h).standard_normal((2, length, h), np.float32)
    want = np.asarray(jsp.s4d_scan_pallas(p, jnp.asarray(u), interpret=True))
    tp = from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")
    got = tss.s4d_scan_recurrent(tp, _t(u))
    np.testing.assert_allclose(got.numpy(), want, atol=S4_ATOL)
    np.testing.assert_array_equal(got.numpy(), tss.s4d_scan_plain(tp, _t(u)))


def test_s4_stack_pallas_mode_matches_jax():
    p = js4.init_s4_stack(jax.random.key(3), 4, 6, 5, n_blocks=2, n_state=6)
    u = np.random.default_rng(3).standard_normal((1, 80, 4), np.float32)
    want = np.asarray(js4.s4_stack_apply(p, jnp.asarray(u), mode="pallas"))
    tp = from_numpy_tree(jax.tree.map(np.asarray, p), "cpu")
    got = ts4.s4_stack_apply(tp, _t(u), mode="pallas").numpy()
    np.testing.assert_allclose(got, want, atol=S4_ATOL)
    conv = ts4.s4_stack_apply(tp, _t(u), mode="conv").numpy()
    np.testing.assert_allclose(got, conv, atol=1e-3)
    with pytest.raises(ValueError, match="conv | scan | pallas"):
        ts4.s4_stack_apply(tp, _t(u), mode="fft")


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _rope(seed, s):
    ids = np.random.default_rng(seed).integers(0, 32, (s, 3)).astype(np.float32)
    cos, sin = jrope(jnp.asarray(ids), (16, 24, 24))
    return (cos, sin), (_t(cos), _t(sin))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (S, cond_start, mode, c_factor, layout, rope, block_k): padding, every mode,
# the c_factor bias, both layouts, and explicit key tiles that split the
# k scale into spans
INT8_CASES = [
    (256, 192, "union", None, "bhsd", True, None),
    (256, 192, "no_union", None, "bhsd", True, None),
    (256, 192, "independent", None, "bshd", True, None),
    (200, 150, "union", 0.5, "bhsd", True, None),
    (200, 130, "no_union", None, "bshd", False, None),
    (384, 256, "union", None, "bhsd", True, 128),
]


@pytest.mark.parametrize("s, cond_start, mode, c_factor, layout, rope, block_k",
                         INT8_CASES)
def test_int8_attention_matches_jax(monkeypatch, s, cond_start, mode, c_factor,
                                    layout, rope, block_k):
    shape = (1, s, 2, 64) if layout == "bshd" else (1, 2, s, 64)
    q, k, v = _qkv(s, shape)
    jrope_t, trope = _rope(s, s) if rope else (None, None)
    monkeypatch.setenv("LOONGX_INT8_ATTN", "1")
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cond_start=cond_start,
        mode=mode, c_factor=c_factor, rope=jrope_t, block_k=block_k,
        interpret=True, layout=layout))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), cond_start=cond_start,
                              mode=mode, c_factor=c_factor, rope=trope,
                              layout=layout, int8_attn=True,
                              block_k=block_k).numpy()
    assert _rel_l2(got, want) <= INT8_REL_L2
    # the mode really changes the scores: bf16-score attention is farther
    exact = tfa.flash_attention(_t(q), _t(k), _t(v), cond_start=cond_start,
                                mode=mode, c_factor=c_factor, rope=trope,
                                layout=layout).numpy()
    assert _rel_l2(exact, want) > 10 * _rel_l2(got, want)


def test_int8_attention_pv_chunks_is_a_reordering(monkeypatch):
    """The TPU kernel's pv_chunks splits softmax * V over key chunks with
    the row max taken over the whole row first: the same numbers summed in
    another order.  The port's kernel tiles the keys itself; its plain
    version agrees with the chunked TPU kernel at the unchunked bound."""
    q, k, v = _qkv(7, (1, 2, 256, 64))
    jrope_t, trope = _rope(7, 256)
    kw = dict(cond_start=192, rope=jrope_t, block_k=256, interpret=True)
    for int8 in ("0", "1"):
        monkeypatch.setenv("LOONGX_INT8_ATTN", int8)
        monkeypatch.setenv("LOONGX_FLASH_PV_CHUNKS", "2")
        assert jfa._pv_chunk_policy(256, int8 == "1") == 2
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        got = tfa.flash_attention(_t(q), _t(k), _t(v), cond_start=192,
                                  rope=trope, int8_attn=int8 == "1").numpy()
        assert _rel_l2(got, want) <= INT8_REL_L2


def test_kquant_plain_codes_and_spans():
    """One k scale per span of block_k keys, absmax over the span (padded
    keys count as zeros), codes clip(round(x / scale))."""
    k = np.random.default_rng(5).standard_normal((1, 2, 300, 64)).astype(np.float32)
    k[0, 1, 200:] *= 4.0
    codes, scales = tfa.flash_kquant(_t(k), span=128)
    assert codes.dtype == torch.int8 and scales.shape == (1, 2, 3)
    for h in range(2):
        for j in range(3):
            rows = k[0, h, 128 * j:128 * (j + 1)]
            sc = np.float32(np.abs(rows).max()) / np.float32(127.0)
            assert scales[0, h, j].item() == pytest.approx(sc, rel=1e-7)
            want = np.clip(np.round(rows / sc), -127, 127)
            np.testing.assert_array_equal(codes[0, h, 128 * j:128 * (j + 1)], want)
    assert codes.abs().max().item() == 127


@pytest.mark.parametrize("s", [1, 77, 128, 300, 2560, 2561, 4352, 5120, 6656,
                               8704, 12289, 20000])
def test_auto_blocks_copy_matches_jax(s):
    assert tattn.auto_blocks(s) == jfa.auto_blocks(s)
    assert tattn.int8_key_span(s) == jfa.auto_blocks(s)[1]
    assert tattn.int8_key_span(s, 256) == min(256, -(-s // 128) * 128)


def test_int8_forced_off_under_grad():
    """With grad the forward keeps bf16 scores, as the JAX package forces
    int8 off (the backward rebuilds P from bf16 scores): gradients are
    identical with int8_attn on and off."""
    q, k, v = (_t(x) for x in _qkv(9, (1, 2, 128, 64)))
    cot = _t(np.random.default_rng(10).standard_normal((1, 2, 128, 64),
                                                       np.float32))

    def grads(int8):
        qq = q.clone().requires_grad_()
        out = tfa.flash_attention(qq, k, v, cond_start=96, int8_attn=int8)
        (g,) = torch.autograd.grad((out * cot).sum(), qq)
        return out.detach(), g

    o0, g0 = grads(False)
    o1, g1 = grads(True)
    torch.testing.assert_close(g1, g0, rtol=0, atol=0)
    torch.testing.assert_close(o1, o0, rtol=0, atol=0)
    with torch.no_grad():
        o2 = tfa.flash_attention(q, k, v, cond_start=96, int8_attn=True)
    assert not torch.equal(o2, o0)
