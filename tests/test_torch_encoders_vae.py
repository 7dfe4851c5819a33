"""The PyTorch port's CS3 encoders, DGF fusion, S4, pooling and VAE against
the JAX package, float32 on CPU, the same numpy inputs and bridged weights.

Tolerances: the S4 kernels, pooling and DUAN at 1e-5; the encoders at
their real widths (16384-wide input projections) and the VAE at 1e-4,
which is float32 summation order over those widths, not a looser
algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models import encoders as jenc
from loongx_tpu.models import fusion as jfus
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.ops import pooling as jpool
from loongx_tpu.ops import s4 as js4
from loongx_tpu_torch.models import encoders as tenc
from loongx_tpu_torch.models import fusion as tfus
from loongx_tpu_torch.models.flux import vae as tvae
from loongx_tpu_torch.ops import pooling as tpool
from loongx_tpu_torch.ops import s4 as ts4
from loongx_tpu_torch.utils.bridge import from_numpy_tree

TIGHT = dict(atol=1e-5, rtol=1e-5)
WIDE = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(tree):
    return from_numpy_tree(_np(tree), device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# S4 and pooling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def s4_stack():
    return jax.jit(lambda k: js4.init_s4_stack(k, 3, 8, 5, n_blocks=2,
                                               n_state=16))(jax.random.key(0))


@pytest.mark.parametrize("core", ["conv", "scan"])
def test_s4d_core_matches_jax(s4_stack, core):
    layer = s4_stack["blocks"][0]["s4"]
    u = np.random.default_rng(0).standard_normal((2, 96, 8), np.float32)
    jfn, tfn = ((js4.s4d_conv, ts4.s4d_conv) if core == "conv"
                else (js4.s4d_scan, ts4.s4d_scan))
    _close(tfn(_bridge(layer), torch.from_numpy(u)),
           jax.jit(jfn)(layer, jnp.asarray(u)), TIGHT)


@pytest.mark.parametrize("mode", ["conv", "scan"])
def test_s4_stack_matches_jax(s4_stack, mode):
    u = np.random.default_rng(1).standard_normal((2, 64, 3), np.float32)
    _close(ts4.s4_stack_apply(_bridge(s4_stack), torch.from_numpy(u), mode),
           jax.jit(js4.s4_stack_apply, static_argnums=2)(
               s4_stack, jnp.asarray(u), mode), TIGHT)
    with pytest.raises(ValueError, match="s4 mode"):
        ts4.s4_stack_apply(_bridge(s4_stack), torch.from_numpy(u), "bogus")


def test_s4_init_layout_matches_jax(s4_stack):
    got = ts4.init_s4_stack(3, 8, 5, n_blocks=2, n_state=16, device="cpu")
    assert _shapes(got) == _shapes(s4_stack)


@pytest.mark.parametrize("length, out", [(4096, 4), (100, 16), (256, 64),
                                         (124, 124), (7, 3)])
def test_pooling_matches_jax(length, out):
    x = np.random.default_rng(2).standard_normal((2, 3, length), np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tpool.adaptive_avg_pool1d(tx, out),
           jpool.adaptive_avg_pool1d(jx, out), TIGHT)
    _close(tpool.feature_pyramid_pooling(tx, (out, 2 * out)),
           jpool.feature_pyramid_pooling(jx, (out, 2 * out)), TIGHT)
    for adaptive in (False, True):
        _close(tpool.spatial_pyramid_pooling(tx, 2 * out, adaptive),
               jpool.spatial_pyramid_pooling(jx, 2 * out, adaptive), TIGHT)


# ---------------------------------------------------------------------------
# Encoders (real widths, short signals)
# ---------------------------------------------------------------------------

ENCODERS = {
    "eeg": (jenc.init_eeg_encoder, jenc.eeg_encode, tenc.eeg_encode,
            tenc.init_eeg_encoder, (2, 4, 300)),
    "ppg": (jenc.init_ppg_encoder, jenc.ppg_encode, tenc.ppg_encode,
            tenc.init_ppg_encoder, (2, 4, 100)),
    "fnirs": (jenc.init_fnirs_encoder, jenc.fnirs_encode, tenc.fnirs_encode,
              tenc.init_fnirs_encoder, (2, 6, 600)),
    "motion": (jenc.init_motion_encoder, jenc.motion_encode,
               tenc.motion_encode, tenc.init_motion_encoder, (2, 6, 90)),
}


@pytest.fixture(scope="module")
def encoder_params():
    return {name: jax.jit(lambda k, f=jinit: f(k, jnp.float32))(
                jax.random.key(i))
            for i, (name, (jinit, *_)) in enumerate(ENCODERS.items())}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_matches_jax(encoder_params, name):
    _, jfn, tfn, tinit, shape = ENCODERS[name]
    params = encoder_params[name]
    x = np.random.default_rng(3).standard_normal(shape, np.float32)
    want = jax.jit(jfn)(params, jnp.asarray(x))
    got = tfn(_bridge(params), torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want, WIDE)
    assert _shapes(tinit(dtype=torch.float32, device="meta")) == _shapes(params)


def test_canonicalise_matches_jax_including_b_equals_c():
    rng = np.random.default_rng(4)
    cases = [
        ("eeg", rng.standard_normal((2, 4, 5000), np.float32)),  # truncate
        ("eeg", rng.standard_normal((4, 300), np.float32)),      # [C, L]
        # a flattened batch with B == C is read as ONE [C, L'] recording,
        # exactly as the JAX package reads it
        ("eeg", rng.standard_normal((4, 4 * 300), np.float32)),
        ("fnirs", rng.standard_normal((3, 6 * 50), np.float32)),  # [B, C*L]
    ]
    for modality, x in cases:
        want = jenc.canonicalise_signal(jnp.asarray(x), modality)
        got = tenc.canonicalise_signal(torch.from_numpy(x), modality)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tenc.canonicalise_signal(torch.zeros(4, 1200), "eeg").shape == (
        1, 4, 4096)
    with pytest.raises(ValueError, match="cannot interpret"):
        tenc.canonicalise_signal(torch.zeros(3, 7), "eeg")


# ---------------------------------------------------------------------------
# DGF
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels, length", [(16, 32), (1, 768)])
def test_duan_matches_jax(channels, length):
    params = jax.jit(lambda k: jfus.init_duan(k, channels))(jax.random.key(5))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, channels, length), np.float32)
    c = rng.standard_normal((2, channels, length), np.float32)
    want = jax.jit(jfus.duan_apply)(params, jnp.asarray(x), jnp.asarray(c))
    got = tfus.duan_apply(_bridge(params), torch.from_numpy(x),
                          torch.from_numpy(c))
    _close(got, want, TIGHT)
    kept = (np.abs(got.numpy()).sum(-1) > 0).sum(-1)
    np.testing.assert_array_equal(kept, max(1, int(channels * 0.7)))


@pytest.fixture(scope="module")
def dgf_params():
    return jax.jit(lambda k: jfus.init_dgf(k, jnp.float32))(jax.random.key(6))


def test_fusions_match_jax(dgf_params):
    rng = np.random.default_rng(6)
    eeg = rng.standard_normal((1, 512, 4096), np.float32)
    ppg = rng.standard_normal((1, 512, 4096), np.float32)
    fnirs = rng.standard_normal((2, 768), np.float32)
    motion = rng.standard_normal((2, 768), np.float32)
    tparams = _bridge(dgf_params)
    _close(tfus.fuse_eeg_ppg(tparams, torch.from_numpy(eeg),
                             torch.from_numpy(ppg)),
           jfus.fuse_eeg_ppg(dgf_params, jnp.asarray(eeg), jnp.asarray(ppg)),
           WIDE)
    _close(tfus.fuse_fnirs_motion(tparams, torch.from_numpy(fnirs),
                                  torch.from_numpy(motion)),
           jfus.fuse_fnirs_motion(dgf_params, jnp.asarray(fnirs),
                                  jnp.asarray(motion)), WIDE)
    assert _shapes(tfus.init_dgf(dtype=torch.float32, device="meta")) == \
        _shapes(dgf_params)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_vae():
    cfg = jvae.VAEConfig.tiny()
    return cfg, jax.jit(lambda k: jvae.init_vae_params(k, cfg))(
        jax.random.key(7))


def test_vae_encode_sample_decode_match_jax(tiny_vae):
    cfg, params = tiny_vae
    tcfg = tvae.VAEConfig.tiny()
    tparams = _bridge(params)
    img = np.random.default_rng(7).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    mean_j, logvar_j = jax.jit(jvae.vae_encode, static_argnums=1)(
        params, cfg, jnp.asarray(img))
    mean_t, logvar_t = tvae.vae_encode(tparams, tcfg, torch.from_numpy(img))
    assert mean_t.shape == mean_j.shape == (2, 8, 8, cfg.latent_channels)
    _close(mean_t, mean_j, WIDE)
    _close(logvar_t, logvar_j, WIDE)

    key = jax.random.key(8)
    noise = np.asarray(jax.random.normal(key, mean_j.shape, jnp.float32))
    sample_j = jvae.vae_sample(mean_j, logvar_j, key)
    sample_t = tvae.vae_sample(mean_t, logvar_t, torch.from_numpy(noise))
    _close(sample_t, sample_j, WIDE)

    lat = np.asarray(sample_j)
    _close(tvae.scale_latents(tcfg, torch.from_numpy(lat)),
           jvae.scale_latents(cfg, jnp.asarray(lat)), TIGHT)
    _close(tvae.unscale_latents(tcfg, torch.from_numpy(lat)),
           jvae.unscale_latents(cfg, jnp.asarray(lat)), TIGHT)
    want = jax.jit(jvae.vae_decode, static_argnums=1)(params, cfg,
                                                       jnp.asarray(lat))
    got = tvae.vae_decode(tparams, tcfg, torch.from_numpy(lat))
    assert got.shape == want.shape == (2, 16, 16, 3)
    _close(got, want, WIDE)
    assert _shapes(tvae.init_vae_params(tcfg, device="meta")) == \
        _shapes(params)
