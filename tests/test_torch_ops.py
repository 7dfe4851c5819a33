"""The PyTorch port's core ops against the JAX package, float32 on CPU.

nn, rope, latents, schedule and unified_attention at atol 1e-5; the flash
attention wrapper (its CPU path is the plain version) against the JAX
kernel in interpret mode and against unified_attention's XLA path at the
float32 tolerance of tests/test_flash_attention.py (2e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.ops import attention as jattn
from loongx_tpu.ops import latents as jlat
from loongx_tpu.ops import nn as jnn
from loongx_tpu.ops import rope as jrope
from loongx_tpu.ops import schedule as jsched
from loongx_tpu.ops.flash_attention import flash_attention as j_flash
from loongx_tpu_torch.ops import attention as tattn
from loongx_tpu_torch.ops import latents as tlat
from loongx_tpu_torch.ops import nn as tnn
from loongx_tpu_torch.ops import rope as trope
from loongx_tpu_torch.ops import schedule as tsched
from loongx_tpu_torch.ops.flash_attention import flash_attention as t_flash

ATOL = 1e-5
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def test_linear_and_int8_qdot():
    rng = _rng(0)
    x = rng.standard_normal((3, 5, 16), np.float32)
    p = {"kernel": rng.standard_normal((16, 8), np.float32),
         "bias": rng.standard_normal((8,), np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tnn.linear(tp, torch.from_numpy(x)),
           jnn.linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    q = {"kernel_q": rng.integers(-127, 128, (16, 8)).astype(np.int8),
         "kernel_scale": rng.uniform(0.01, 0.02, (1, 8)).astype(np.float32)}
    _close(tnn.qdot({k: torch.from_numpy(v) for k, v in q.items()},
                    torch.from_numpy(x)),
           jnn.qdot({k: jnp.asarray(v) for k, v in q.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("affine", [False, True])
def test_norms_and_activations(affine):
    rng = _rng(1)
    x = 3 * rng.standard_normal((4, 7, 32), np.float32) + 1
    w = rng.standard_normal((32,), np.float32) if affine else None
    b = rng.standard_normal((32,), np.float32) if affine else None
    tw = None if w is None else torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    jw = None if w is None else jnp.asarray(w)
    jb = None if b is None else jnp.asarray(b)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tnn.layer_norm(tx, tw, tb), jnn.layer_norm(jx, jw, jb))
    _close(tnn.rms_norm(tx, tw), jnn.rms_norm(jx, jw))
    _close(tnn.gelu_tanh(tx), jnn.gelu_tanh(jx))
    _close(tnn.silu(tx), jnn.silu(jx))


def test_rope_tables_and_rotation():
    rng = _rng(2)
    ids = np.concatenate([
        np.zeros((4, 3), np.float32),
        np.asarray(jlat.latent_image_ids(8, 6)),
    ])
    ids[:, 0] += rng.integers(0, 3, len(ids))
    cos_t, sin_t = trope.rope_embed(torch.from_numpy(ids), (8, 12, 12))
    cos_j, sin_j = jrope.rope_embed(jnp.asarray(ids), (8, 12, 12))
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)
    x = rng.standard_normal((2, 3, len(ids), 32), np.float32)
    _close(trope.apply_rope(torch.from_numpy(x), cos_t, sin_t),
           jrope.apply_rope(jnp.asarray(x), cos_j, sin_j))


def test_latent_pack_ids_and_shift():
    rng = _rng(3)
    lat = rng.standard_normal((2, 8, 12, 4), np.float32)
    tok_t = tlat.pack_latents(torch.from_numpy(lat))
    tok_j = jlat.pack_latents(jnp.asarray(lat))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(tlat.unpack_latents(tok_t, 8, 12).numpy(), lat)
    ids_t = tlat.latent_image_ids(8, 12, device="cpu")
    np.testing.assert_array_equal(ids_t.numpy(),
                                  np.asarray(jlat.latent_image_ids(8, 12)))
    for delta, scale in (((0, 0), 1.0), ((2, -3), 1.0), ((1, 4), 2.0)):
        np.testing.assert_array_equal(
            tlat.shift_ids(ids_t, delta, scale).numpy(),
            np.asarray(jlat.shift_ids(jlat.latent_image_ids(8, 12), delta,
                                      scale)))


@pytest.mark.parametrize("steps, seq", [(28, 1024), (4, 64), (1, 4096)])
def test_schedule_and_euler(steps, seq):
    np.testing.assert_array_equal(tsched.flux_sigmas(steps, seq),
                                  jsched.flux_sigmas(steps, seq))
    rng = _rng(4)
    lat = rng.standard_normal((1, 16, 8), np.float32)
    v = rng.standard_normal((1, 16, 8), np.float32)
    sig = tsched.flux_sigmas(steps, seq)
    _close(tsched.euler_step(torch.from_numpy(lat), torch.from_numpy(v),
                             sig[0], sig[1]),
           jsched.euler_step(jnp.asarray(lat), jnp.asarray(v),
                             jnp.asarray(sig[0]), jnp.asarray(sig[1])))


def _qkv(seed, s, d, layout, h=2, b=1):
    rng = _rng(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    return [rng.standard_normal(shape, np.float32) for _ in range(3)]


def _rope_np(s, d, seed):
    axes = (d // 4, 3 * d // 8, 3 * d // 8)
    ids = np.floor(_rng(seed).uniform(0, 16, (s, 3))).astype(np.float32)
    cos, sin = jrope.rope_embed(jnp.asarray(ids), axes)
    return np.asarray(cos), np.asarray(sin)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("mode", ["union", "no_union", "independent"])
def test_unified_attention_matches_jax(mode, layout):
    q, k, v = _qkv(5, 96, 32, layout)
    cos, sin = _rope_np(96, 32, 5)
    got = tattn.unified_attention(
        *map(torch.from_numpy, (q, k, v)), cond_len=32, mode=mode,
        rope=(torch.from_numpy(cos), torch.from_numpy(sin)), layout=layout)
    want = jattn.unified_attention(
        *map(jnp.asarray, (q, k, v)), cond_len=32, mode=mode,
        rope=(jnp.asarray(cos), jnp.asarray(sin)), backend="xla", layout=layout)
    _close(got, want)


# (mode, c_factor, layout, rope, S, D): every mode, both layouts, RoPE on
# and off, and S values that are not multiples of 128
FLASH_CASES = [
    ("union", None, "bshd", True, 256, 64),
    ("no_union", None, "bshd", True, 256, 64),
    ("independent", None, "bhsd", True, 256, 32),
    ("union", 0.5, "bshd", True, 256, 32),
    ("independent", 2.0, "bhsd", False, 192, 64),
    ("no_union", None, "bhsd", False, 200, 32),
    ("union", None, "bhsd", False, 130, 64),
    ("independent", None, "bshd", True, 77, 32),
]


@pytest.mark.parametrize("mode, c_factor, layout, rope, s, d", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(mode, c_factor, layout, rope, s, d):
    q, k, v = _qkv(6, s, d, layout)
    cond_start = s - s // 4
    cs = _rope_np(s, d, 6) if rope else None
    got = t_flash(
        *map(torch.from_numpy, (q, k, v)), cond_start=cond_start, mode=mode,
        c_factor=c_factor,
        rope=None if cs is None else tuple(map(torch.from_numpy, cs)),
        layout=layout).numpy()
    jrope_tab = None if cs is None else tuple(map(jnp.asarray, cs))
    jcf = None if c_factor is None else jnp.float32(c_factor)
    kernel = j_flash(*map(jnp.asarray, (q, k, v)), cond_start=cond_start,
                     mode=mode, c_factor=jcf, rope=jrope_tab, layout=layout,
                     interpret=True)
    xla = jattn.unified_attention(
        *map(jnp.asarray, (q, k, v)), cond_len=s - cond_start, mode=mode,
        c_factor=jcf, rope=jrope_tab, backend="xla", layout=layout)
    assert got.shape == q.shape
    np.testing.assert_allclose(got, np.asarray(kernel), **FLASH_TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **FLASH_TOL)


def test_flash_rejects_unknown_mode_and_layout():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="mode"):
        t_flash(q, q, q, cond_start=8, mode="bogus")
    with pytest.raises(ValueError, match="layout"):
        t_flash(q, q, q, cond_start=8, layout="sbhd")
