"""The port's text encoders against the JAX package on CPU: T5 and CLIP at
``tiny()`` in float32 (ATOL 2e-4, as tests/test_golden_torch.py), the T5
relative-position bucket table at the full config integer for integer, the
int8 T5 through the port's stacked path (the kernel's plain version here)
against JAX's dequantising path and its stacked Pallas kernels in interpret
mode (the tests/test_quant_matmul.py tolerance), CLIP pooling with and
without an EOS token, and the bridge carrying both trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu.ops.quant import quantize_tree
from loongx_tpu_torch.models.text import clip as tclip
from loongx_tpu_torch.models.text import t5 as tt5
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

ATOL = 2e-4
INT8_ATOL = 2e-2


def _bridge(params):
    return from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def t5_params():
    return jt5.init_t5_params(jax.random.key(0), jt5.T5Config.tiny(),
                              jnp.float32)


@pytest.fixture(scope="module")
def clip_params():
    return jclip.init_clip_params(jax.random.key(1), jclip.CLIPTextConfig.tiny(),
                                  jnp.float32)


def test_configs_match():
    for j, t in ((jt5.T5Config, tt5.T5Config),
                 (jclip.CLIPTextConfig, tclip.CLIPTextConfig)):
        for name in ("tiny", "xxl" if j is jt5.T5Config else "large"):
            assert (jax.tree_util.tree_leaves(vars(getattr(j, name)()))
                    == jax.tree_util.tree_leaves(vars(getattr(t, name)())))


@pytest.mark.parametrize("seq_len", [512, 77])
def test_t5_bucket_table_matches_jax(seq_len):
    cfg = jt5.T5Config.xxl()
    rel = np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None]
    want = np.asarray(jt5._relative_position_bucket(
        jnp.asarray(rel), cfg.rel_pos_buckets, cfg.rel_pos_max_distance))
    got = tt5._relative_position_bucket(
        torch.from_numpy(rel), cfg.rel_pos_buckets, cfg.rel_pos_max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_t5_tiny_matches_jax(t5_params, masked):
    ids = np.random.default_rng(0).integers(0, 128, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    want = jt5.t5_encode(t5_params, jt5.T5Config.tiny(), jnp.asarray(ids),
                         jnp.asarray(mask) if masked else None)
    got = tt5.t5_encode(_bridge(t5_params), tt5.T5Config.tiny(),
                        torch.from_numpy(ids),
                        torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    bias = tt5.t5_rel_pos_bias(_bridge(t5_params), tt5.T5Config.tiny(), 12)
    np.testing.assert_allclose(
        bias.numpy(), np.asarray(jt5.t5_rel_pos_bias(
            t5_params, jt5.T5Config.tiny(), 12)), atol=0)


def test_t5_int8_stacked_matches_jax(t5_params):
    """The port's stacked path (the kernel's plain version on CPU) against
    JAX's dequantising path and its stacked Pallas kernels in interpret
    mode; the port's dequantising path equals JAX's at float32 tolerance."""
    cfg_j, cfg_t = jt5.T5Config.tiny(), tt5.T5Config.tiny()
    pq = quantize_tree(t5_params)
    tq = _bridge(pq)
    ids = np.random.default_rng(1).integers(0, 128, (1, 16))
    xla = np.asarray(jt5.t5_encode(pq, cfg_j, jnp.asarray(ids),
                                   stacked_kernels=False))
    pallas = np.asarray(jt5.t5_encode(pq, cfg_j, jnp.asarray(ids),
                                      stacked_kernels=True), np.float32)
    stacked = tt5.t5_encode(tq, cfg_t, torch.from_numpy(ids),
                            stacked_kernels=True).numpy()
    assert tt5.t5_encode(tq, cfg_t, torch.from_numpy(ids)).equal(
        tt5.t5_encode(tq, cfg_t, torch.from_numpy(ids), stacked_kernels=False))
    dequant = tt5.t5_encode(tq, cfg_t, torch.from_numpy(ids),
                            stacked_kernels=False).numpy()
    np.testing.assert_allclose(dequant, xla, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(stacked, xla, atol=INT8_ATOL, rtol=INT8_ATOL)
    np.testing.assert_allclose(stacked, pallas, atol=INT8_ATOL, rtol=INT8_ATOL)
    with pytest.raises(ValueError, match="fully int8-quantized"):
        tt5.t5_encode(_bridge(t5_params), cfg_t, torch.from_numpy(ids),
                      stacked_kernels=True)


@pytest.mark.parametrize("eos", ["first_of_two", "none", "at_end"])
def test_clip_tiny_matches_jax(clip_params, eos):
    cfg_j, cfg_t = jclip.CLIPTextConfig.tiny(), tclip.CLIPTextConfig.tiny()
    ids = np.random.default_rng(2).integers(0, cfg_j.eos_token_id, (2, 16))
    if eos == "first_of_two":
        ids[0, 5] = ids[0, 11] = ids[1, 3] = cfg_j.eos_token_id
    elif eos == "at_end":
        ids[:, -1] = cfg_j.eos_token_id
    want_h, want_p = jclip.clip_encode(clip_params, cfg_j, jnp.asarray(ids))
    got_h, got_p = tclip.clip_encode(_bridge(clip_params), cfg_t,
                                     torch.from_numpy(ids))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL,
                               rtol=ATOL)
    pos = {"first_of_two": [5, 3], "none": [15, 15], "at_end": [15, 15]}[eos]
    np.testing.assert_array_equal(got_p.numpy(),
                                  got_h.numpy()[np.arange(2), pos])


def test_clip_int8_and_text_features_match_jax(clip_params):
    cfg_j, cfg_t = jclip.CLIPTextConfig.tiny(), tclip.CLIPTextConfig.tiny()
    p = dict(clip_params)
    p["text_projection"] = {"kernel": jax.random.normal(
        jax.random.key(3), (cfg_j.hidden, 8), jnp.float32)}
    pq = quantize_tree(p)
    ids = np.random.default_rng(3).integers(0, 128, (2, 16))
    for tree in (p, pq):
        want = jclip.clip_text_features(tree, cfg_j, jnp.asarray(ids))
        got = tclip.clip_text_features(_bridge(tree), cfg_t,
                                       torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=ATOL)
    with pytest.raises(KeyError, match="text_projection"):
        tclip.clip_text_features(_bridge(clip_params), cfg_t,
                                 torch.from_numpy(ids))


def test_port_init_trees_match_jax_layout(t5_params, clip_params):
    """The port's inits build the JAX package's trees (names, shapes,
    dtypes), so one bridge serves both directions."""
    kw = dict(generator=torch.Generator().manual_seed(0), dtype=torch.float32,
              device="cpu")
    for jtree, ttree in (
            (t5_params, tt5.init_t5_params(tt5.T5Config.tiny(), **kw)),
            (clip_params, tclip.init_clip_params(tclip.CLIPTextConfig.tiny(),
                                                 **kw))):
        want = jax.tree.map(lambda x: (x.shape, str(x.dtype)), jtree)
        got = jax.tree.map(lambda x: (x.shape, str(x.dtype)),
                           to_numpy_tree(ttree))
        assert got == want
