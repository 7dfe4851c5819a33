"""The rest of the surface of the port's ported modules against the JAX
package, on the CPU: ControlNet residual inputs in ``flux_forward``,
``ops/signal.py``, and the helpers ``time_shift``, ``quantized_bytes``,
``init_mlp`` / ``count_params`` / ``tree_cast`` and ``attention_xla``.

``flux_forward`` runs float32 at ATOL 2e-4 (tests/test_golden_torch.py) on
a 3 + 5 block variant of the tiny config, so that 2 residual samples divide
neither block count (block i takes sample i // ceil(n_blocks / N)), on the
float tree and on the int8 block stacks (JAX's stacked-kernel scan,
LOONGX_STACKED_QMM=1, its Pallas kernels in interpret mode), with and
without ``remat``; under ``remat`` the gradients with respect to the
residuals are compared too.  The signal ops run on seeded random signals
at rtol 1e-5 of each output's scale (two FFT libraries round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.ops import attention as jattn
from loongx_tpu.ops import nn as jnn
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops import schedule as jschedule
from loongx_tpu.ops import signal as jsignal
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.ops import attention as tattn
from loongx_tpu_torch.ops import nn as tnn
from loongx_tpu_torch.ops import quant as tquant
from loongx_tpu_torch.ops import schedule as tschedule
from loongx_tpu_torch.ops import signal as tsignal
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

ATOL = 2e-4
CFG = dataclasses.replace(jmodel.FluxConfig.tiny(), num_double_blocks=3,
                          num_single_blocks=5)
TCFG = tmodel.FluxConfig(**dataclasses.asdict(CFG))
N_SAMPLES = 2


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flux_params():
    """{"float": float32 tree, "int8": every block-stack linear int8}."""
    g = torch.Generator().manual_seed(0)
    tree = tmodel.init_flux_params(TCFG, generator=g, dtype=torch.float32,
                                   device="cpu")
    params = jax.tree.map(jnp.asarray, to_numpy_tree(tree))
    stacks = lambda path, leaf: path.startswith(("double_blocks",
                                                  "single_blocks"))
    return {"float": params,
            "int8": jquant.quantize_tree(params, predicate=stacks)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    b, s_img, s_txt = 1, 16, 4
    ids = np.array(j_ids(8, 8))
    cond_ids = ids.copy()
    cond_ids[:, 2] += 4.0
    arrays = dict(
        img=rng.standard_normal((b, s_img, CFG.in_channels), np.float32),
        txt=rng.standard_normal((b, s_txt, CFG.joint_dim), np.float32),
        pooled=rng.standard_normal((b, CFG.pooled_dim), np.float32),
        timestep=np.full((b,), 0.5, np.float32),
        guidance=np.full((b,), 3.5, np.float32),
        img_ids=ids, txt_ids=np.zeros((s_txt, 3), np.float32),
        cond=rng.standard_normal((b, s_img, CFG.in_channels), np.float32),
        cond_ids=cond_ids)
    cn = dict(
        controlnet_block_samples=rng.standard_normal(
            (N_SAMPLES, b, s_img, CFG.hidden), np.float32),
        controlnet_single_block_samples=rng.standard_normal(
            (N_SAMPLES, b, s_img, CFG.hidden), np.float32))
    return arrays, cn


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("form", ["float", "int8"])
def test_flux_forward_controlnet_matches_jax(flux_params, monkeypatch, form,
                                             remat):
    params = flux_params[form]
    if form == "int8":
        monkeypatch.setenv("LOONGX_STACKED_QMM", "1")
    jax.clear_caches()
    arrays, cn = _inputs(1)
    probe = np.random.default_rng(2).standard_normal(
        (1, 16, CFG.in_channels)).astype(np.float32)

    def jax_out(cn_arrays):
        return jmodel.flux_forward(
            params, CFG, **{k: jnp.asarray(v) for k, v in arrays.items()},
            **cn_arrays, remat=remat)

    jcn = {k: jnp.asarray(v) for k, v in cn.items()}
    if remat:
        want, vjp = jax.vjp(jax_out, jcn)
        (jgrads,) = vjp(jnp.asarray(probe))
    else:
        want = jax_out(jcn)
    want = np.asarray(want)
    jax.clear_caches()

    tparams = from_numpy_tree(_np_tree(params), device="cpu")
    tarrays = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tcn = {k: torch.from_numpy(v).requires_grad_(remat) for k, v in cn.items()}
    with torch.set_grad_enabled(remat):
        got = tmodel.flux_forward(tparams, TCFG, **tarrays, **tcn, remat=remat)
    with torch.no_grad():
        no_cn = tmodel.flux_forward(tparams, TCFG, **tarrays).numpy()
    # the residuals move the output far beyond the tolerance
    assert np.abs(want - no_cn).max() > 100 * ATOL
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=ATOL)
    if remat:
        grads = torch.autograd.grad(
            torch.sum(got * torch.from_numpy(probe)), list(tcn.values()))
        for name, g in zip(tcn, grads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                       atol=ATOL, rtol=ATOL, err_msg=name)


def test_controlnet_sample_index_map():
    """Block i takes sample i // ceil(n_blocks / N) of the stack."""
    samples = torch.arange(3.0).reshape(3, 1)
    pick = tmodel._cn_residuals(samples, 7, torch.float32)
    assert [float(pick(i)) for i in range(7)] == [0, 0, 0, 1, 1, 1, 2]


# ---------------------------------------------------------------------------
# ops/signal.py
# ---------------------------------------------------------------------------

FS = 256.0


def _signal(seed, shape=(2, 3, 512)):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / FS
    ramp = 0.3 * t * rng.standard_normal(shape[:-1] + (1,))
    tones = (np.sin(2 * np.pi * 10.0 * t) + 0.5 * np.sin(2 * np.pi * 50.0 * t)
             + 0.2 * np.sin(2 * np.pi * 3.0 * t))
    return (rng.standard_normal(shape) + tones + ramp + 2.0).astype(np.float32)


SIGNAL_CASES = {
    "zscore": (lambda m, x: m.zscore(x)),
    "detrend": (lambda m, x: m.detrend(x)),
    "bandpass_fft": (lambda m, x: m.bandpass_fft(x, 8.0, 30.0, FS)),
    "notch_fft": (lambda m, x: m.notch_fft(x, 50.0, FS, width_hz=2.0)),
    "stft_power": (lambda m, x: m.stft_power(x, frame=128, hop=64)),
    "band_powers": (lambda m, x: m.band_powers(x, FS)),
    "preprocess_signal": (lambda m, x: m.preprocess_signal(
        x, FS, bandpass=(1.0, 40.0), notch=50.0, remove_trend=True)),
}


@pytest.mark.parametrize("name", sorted(SIGNAL_CASES))
def test_signal_op_matches_jax(name):
    x = _signal(len(name))
    fn = SIGNAL_CASES[name]
    want = np.asarray(fn(jsignal, jnp.asarray(x)))
    got = fn(tsignal, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_zscore_is_population_std_and_keeps_dtype():
    x = _signal(3).astype(np.float32)
    got = tsignal.zscore(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    z = tsignal.zscore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(z.std(axis=-1), 1.0, rtol=1e-5)


def test_hann_window_matches_jax():
    np.testing.assert_allclose(tsignal.hann_window(100, "cpu").numpy(),
                               np.asarray(jsignal.hann_window(100)),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def test_time_shift_and_sigmas_match_jax():
    t = np.linspace(1.0, 1.0 / 28, 28)
    for mu, sigma in ((1.15, 1.0), (0.5, 2.0)):
        np.testing.assert_array_equal(tschedule.time_shift(mu, sigma, t),
                                      jschedule.time_shift(mu, sigma, t))
    np.testing.assert_array_equal(tschedule.flux_sigmas(28, 1024),
                                  jschedule.flux_sigmas(28, 1024))


def test_quantized_bytes_matches_jax(flux_params):
    params = flux_params["int8"]
    tparams = from_numpy_tree(_np_tree(params), device="cpu")
    assert tquant.quantized_bytes(tparams) == jquant.quantized_bytes(params)


def test_init_mlp_count_params_tree_cast_match_jax():
    dims = (12, 24, 8)
    want = jax.eval_shape(lambda: jnn.init_mlp(jax.random.key(0), dims))
    got = tnn.init_mlp(dims, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert set(got) == set(want)
    for name, layer in got.items():
        assert set(layer) == set(want[name])
        for leaf, t in layer.items():
            assert tuple(t.shape) == want[name][leaf].shape
            assert t.dtype == torch.float32
    jtree = jax.tree.map(jnp.asarray, to_numpy_tree(got))
    assert tnn.count_params(got) == jnn.count_params(jtree)
    tree = dict(got, codes=torch.arange(6, dtype=torch.int8))
    jtree["codes"] = jnp.arange(6, dtype=jnp.int8)
    cast = tnn.tree_cast(tree, torch.bfloat16)
    jcast = jnn.tree_cast(jtree, jnp.bfloat16)
    assert cast["codes"].dtype == torch.int8
    for name in got:
        for leaf in got[name]:
            t = cast[name][leaf]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(jcast[name][leaf].astype(jnp.float32)))


@pytest.mark.parametrize("bias", [False, True])
def test_attention_xla_matches_jax(bias):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 10, 16)).astype(np.float32)
               for _ in range(3))
    b = rng.standard_normal((10, 10)).astype(np.float32) if bias else None
    want = np.asarray(jattn.attention_xla(
        *map(jnp.asarray, (q, k, v)), None if b is None else jnp.asarray(b)))
    got = tattn.attention_xla(*map(torch.from_numpy, (q, k, v)),
                              None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
