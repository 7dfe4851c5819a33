"""The whole slice: the PyTorch port's neural edit against the JAX package.

One configuration, float32 on CPU: a tiny DiT whose text widths are the
real ones (joint_dim 4096, pooled_dim 768) so the real CS3 encoders and DGF
feed it, a tiny VAE, a 16x16 condition image and 2 Euler steps.  Both sides
get the same weights (bridged), the same signals and latents, and the same
VAE-sample noise (drawn from the JAX key and handed to the port).  ATOL
2e-4 as in tests/test_golden_torch.py.

Also: neural_edit's argument errors equal the JAX package's, the adapter
policy, and importing every port module loads neither JAX nor any module
of the JAX package.
"""

import dataclasses
import importlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu.ops.schedule import flux_sigmas
from loongx_tpu_torch.models import encoders as tenc
from loongx_tpu_torch.models import fusion as tfus
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.models.flux import vae as tvae
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.sampling import generate as tgen
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

# the package re-exports generate(), which shadows the module attribute
jgen = importlib.import_module("loongx_tpu.sampling.generate")

ATOL = 2e-4
SIZE, STEPS = 16, 2
JCFG = dataclasses.replace(jmodel.FluxConfig.tiny(), joint_dim=4096,
                           pooled_dim=768)
TCFG = dataclasses.replace(tmodel.FluxConfig.tiny(), joint_dim=4096,
                           pooled_dim=768)
JVAE, TVAE = jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()


@pytest.fixture(scope="module")
def jax_params():
    """Random float32 weights in the JAX package's layout (made by the
    port's init, which builds the same trees, because it is much faster on
    CPU than tracing the JAX init), as numpy."""
    kw = dict(generator=torch.Generator().manual_seed(0), dtype=torch.float32,
              device="cpu")
    params = {
        "flux": tmodel.init_flux_params(TCFG, **kw),
        "vae": tvae.init_vae_params(TVAE, **kw),
        "encoders": {
            "eeg": tenc.init_eeg_encoder(**kw),
            "ppg": tenc.init_ppg_encoder(**kw),
            "fnirs": tenc.init_fnirs_encoder(**kw),
            "motion": tenc.init_motion_encoder(**kw),
        },
        "dgf": tfus.init_dgf(**kw),
    }
    return jax.tree.map(jnp.asarray, to_numpy_tree(params))


@pytest.fixture(scope="module")
def pipelines(jax_params):
    jpipe = types.SimpleNamespace(
        flux_cfg=JCFG, vae_cfg=JVAE, params=dict(jax_params),
        dtype=jnp.float32, adapters=None)
    tparams = from_numpy_tree(jax.tree.map(np.asarray, jax_params), "cpu")
    tpipe = LoongXPipeline(TCFG, TVAE, tparams, torch.float32)
    return jpipe, tpipe


def _signals(seed, b=1):
    rng = np.random.default_rng(seed)
    return dict(
        eeg=rng.standard_normal((b, 4, 512), np.float32),
        ppg=rng.standard_normal((b, 4, 256), np.float32),
        fnirs=rng.standard_normal((b, 6, 512), np.float32),
        motion=rng.standard_normal((b, 6, 128), np.float32),
    )


def test_fused_edit_program_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(1)
    cond_img = rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    sig = _signals(1)
    lat_h = lat_w = SIZE // JVAE.downscale
    s_img = (lat_h // 2) * (lat_w // 2)
    latents = rng.standard_normal((1, s_img, JCFG.in_channels), np.float32)
    ids = np.asarray(j_ids(lat_h, lat_w))
    cond_ids = ids.copy()
    cond_ids[:, 2] += lat_w // 2
    sigmas = flux_sigmas(STEPS, s_img)
    guidance = np.full((1,), 3.5, np.float32)
    cond_key = jax.random.key(2)
    noise = np.asarray(jax.random.normal(
        cond_key, (1, lat_h, lat_w, JVAE.latent_channels), jnp.float32))

    want = jgen.fused_edit_program(
        jpipe.params["flux"], jpipe.params["vae"], jpipe.params["encoders"],
        jpipe.params["dgf"], jnp.asarray(cond_img),
        *(jnp.asarray(sig[k]) for k in ("eeg", "ppg", "fnirs", "motion")),
        jnp.asarray(latents), jnp.asarray(ids), jnp.asarray(cond_ids),
        jnp.asarray(sigmas), jnp.asarray(guidance), None, cond_key,
        flux_cfg=JCFG, vae_cfg=JVAE, flags=(), s4_mode="conv",
        attn_backend="auto", lat_h=lat_h, lat_w=lat_w)
    t = torch.from_numpy
    with torch.inference_mode():
        got = tgen.fused_edit_program(
            tpipe.params["flux"], tpipe.params["vae"],
            tpipe.params["encoders"], tpipe.params["dgf"], t(cond_img),
            *(t(sig[k]) for k in ("eeg", "ppg", "fnirs", "motion")),
            t(latents), t(ids), t(cond_ids), sigmas, t(guidance), None,
            t(noise), flux_cfg=TCFG, vae_cfg=TVAE, flags={}, s4_mode="conv",
            lat_h=lat_h, lat_w=lat_w)
    assert got.shape == want.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_neural_edit_matches_jax(pipelines):
    """neural_edit end to end: the port is handed the latents and the
    VAE-sample noise the JAX path draws from the same seed."""
    jpipe, tpipe = pipelines
    rng = np.random.default_rng(3)
    cond_image = (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8)
    sig = _signals(3)
    kw = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS,
              position_delta=(0, SIZE // JVAE.downscale // 2), **sig)
    want = jgen.neural_edit(jpipe, cond_image, seed=5, **kw)

    k_lat, k_enc = jax.random.split(jax.random.key(5))
    lat_hw = SIZE // JVAE.downscale
    latents = np.asarray(jax.random.normal(
        k_lat, (1, lat_hw // 2, lat_hw // 2, JCFG.in_channels), jnp.float32)
    ).reshape(1, -1, JCFG.in_channels)
    noise = np.asarray(jax.random.normal(
        k_enc, (1, lat_hw, lat_hw, JVAE.latent_channels), jnp.float32))
    got = tgen.neural_edit(tpipe, cond_image, latents=torch.from_numpy(latents),
                           cond_noise=torch.from_numpy(noise), **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    got_u8 = tgen.neural_edit(tpipe, cond_image,
                              latents=torch.from_numpy(latents),
                              cond_noise=torch.from_numpy(noise),
                              output_type="uint8", **kw)
    assert got_u8.dtype == np.uint8
    assert np.abs(got_u8.astype(int) -
                  ((np.clip(want, -1, 1) + 1) * 127.5).round()).max() <= 1


def _error_cases():
    sig = _signals(4)
    no_eeg = {k: v for k, v in sig.items() if k != "eeg"}
    no_fnirs = {k: v for k, v in sig.items() if k != "fnirs"}
    return [
        ("no_eeg", {}, no_eeg),
        ("no_fnirs", {}, no_fnirs),
        ("condition_scale", {}, dict(sig, condition_scale=0.0)),
        ("output_type", {}, dict(sig, output_type="latent")),
        ("height", {}, dict(sig, height=SIZE + 2)),
        ("no_encoders", {"encoders": None}, sig),
        ("no_dgf", {"dgf": None}, sig),
    ]


@pytest.mark.parametrize("label, params_edit, kw", _error_cases(),
                         ids=[c[0] for c in _error_cases()])
def test_neural_edit_argument_errors_match_jax(pipelines, label, params_edit,
                                               kw):
    jpipe, tpipe = pipelines
    jp = types.SimpleNamespace(**vars(jpipe))
    jp.params = {k: v for k, v in jpipe.params.items()
                 if params_edit.get(k, v) is not None}
    tp = dataclasses.replace(tpipe, params={
        k: v for k, v in tpipe.params.items()
        if params_edit.get(k, v) is not None})
    img = np.zeros((SIZE, SIZE, 3), np.float32)
    kw = dict(dict(height=SIZE, width=SIZE, num_inference_steps=1), **kw)
    with pytest.raises(Exception) as jerr:
        jgen.neural_edit(jp, img, **kw)
    with pytest.raises(Exception) as terr:
        tgen.neural_edit(tp, img, **kw)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


class _Registry:
    """The adapter-registry interface the edit path uses."""

    def __init__(self, names):
        self._names, self.calls = list(names), []

    def __contains__(self, name):
        return name in self._names

    def names(self):
        return list(self._names)

    def activate(self, params, name):
        self.calls.append(("activate", name))
        return params

    def deactivate(self, params):
        self.calls.append(("deactivate",))
        return params


def test_adapter_policy():
    pipe = types.SimpleNamespace(adapters=None)
    tgen._apply_adapter_policy(pipe, "eeg+fnirs")  # no registry: no-op
    reg = _Registry(["eeg+fnirs"])
    pipe = LoongXPipeline(TCFG, TVAE, {"flux": {}}, torch.float32,
                          adapters=reg)
    tgen._apply_adapter_policy(pipe, "eeg+fnirs")
    assert pipe.active_adapter == "eeg+fnirs"
    tgen._apply_adapter_policy(pipe, "eeg+fnirs")  # already active
    tgen._apply_adapter_policy(pipe, "other")
    assert pipe.active_adapter is None
    tgen._apply_adapter_policy(pipe, "other")      # base weights already
    assert reg.calls == [("activate", "eeg+fnirs"), ("deactivate",)]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import loongx_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    loongx_tpu_torch.__path__, 'loongx_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'loongx_tpu' or\n"
        "             m.startswith('loongx_tpu.'))\n"
        "new = {'loongx_tpu_torch.ops.s4_scan',\n"
        "       'loongx_tpu_torch.models.text.t5',\n"
        "       'loongx_tpu_torch.models.text.clip',\n"
        "       'loongx_tpu_torch.sampling.condition',\n"
        "       'loongx_tpu_torch.train.adapters',\n"
        "       'loongx_tpu_torch.utils.checkpoint',\n"
        "       'loongx_tpu_torch.utils.convert',\n"
        "       'loongx_tpu_torch.cli.convert',\n"
        "       'loongx_tpu_torch.cli.infer'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "assert len(names) >= 20, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
