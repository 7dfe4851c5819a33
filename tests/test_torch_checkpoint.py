"""The port's checkpoints and conversion against the JAX package's, on the CPU:
tree files, pipeline directories, LoRA files, the Hugging Face converters,
``merge_lora``, the pipeline constructors, and the inference CLI's image
reader.

Synthetic state dicts are made with numpy from a seed; converted trees are
compared with JAX's (bridged) exactly, ``merge_lora`` within fp32 rounding
(1e-6), tree structures through ``jax.eval_shape`` of the JAX inits.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu.train import lora as jlora
from loongx_tpu.utils import checkpoint as jckpt
from loongx_tpu.utils import convert as jconvert
from loongx_tpu_torch.models.flux.model import FluxConfig
from loongx_tpu_torch.models.flux.vae import VAEConfig
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.models.text.clip import CLIPTextConfig
from loongx_tpu_torch.models.text.t5 import T5Config
from loongx_tpu_torch.ops import quant as tquant
from loongx_tpu_torch.train import lora as tlora
from loongx_tpu_torch.utils import checkpoint as tckpt
from loongx_tpu_torch.utils import convert as tconvert
from loongx_tpu_torch.utils.bridge import to_numpy_tree


def _flat(tree, prefix=""):
    """{path: numpy array} of a JAX or torch tree (lists by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if torch.is_tensor(tree):
            tree = to_numpy_tree({"x": tree})["x"]
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _structure(tree):
    """{path: (shape, dtype name)}."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat_leaves(tree).items()}


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# Tree files are plain safetensors files
# ---------------------------------------------------------------------------

DTYPES = ["float32", "bfloat16", "float16", "int8", "int32", "int64"]


def _tensors(dtype_name):
    """Tensors of one dtype: 2-D, 1-D, empty and 0-d, from a seed."""
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        make = lambda *s: torch.randn(*s, generator=gen).to(dtype)
    else:
        make = lambda *s: torch.randint(-100, 100, s, generator=gen,
                                        dtype=dtype)
    return {"a/weight": make(5, 7), "b/bias": make(3), "empty": make(0, 4),
            "scalar": make(1).reshape(()), "c": make(2, 1, 3)}


@pytest.mark.parametrize("direction", ["port_writes", "package_writes"])
@pytest.mark.parametrize("dtype_name", DTYPES)
def test_tree_files_are_safetensors(tmp_path, dtype_name, direction):
    """A tree written by save_tree reads with the safetensors package under
    its "/" paths, and a flat file the package writes loads as the tree."""
    from safetensors import safe_open
    from safetensors.torch import save_file as pkg_save

    flat = _tensors(dtype_name)
    tree = tckpt.unflatten_tree(flat, {})
    path = str(tmp_path / "t.safetensors")
    if direction == "port_writes":
        tckpt.save_tree(tree, path)
        with safe_open(path, framework="pt") as f:
            got = {k: f.get_tensor(k) for k in f.keys()}
    else:
        pkg_save(flat, path)
        got, _ = tckpt.flatten_tree(tckpt.load_tree(path, "cpu"))
    assert sorted(got) == sorted(flat)
    for k, t in flat.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k


def test_tree_of_views_round_trips(tmp_path):
    """Leaves that are views of one storage (as the proj_out split makes)
    are written as tensors of their own and read back equal."""
    base = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    tree = {"a": base[:2], "b": base[2:], "t": base.t()}
    path = str(tmp_path / "v.safetensors")
    tckpt.save_tree(tree, path)
    got = tckpt.load_tree(path, "cpu")
    for k, t in tree.items():
        assert torch.equal(got[k], t), k


# ---------------------------------------------------------------------------
# Pipeline directories, configs, LoRA files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny pipeline with small stand-in brain trees (lists and
    an empty dict included)."""
    gen = torch.Generator().manual_seed(0)
    pipe = LoongXPipeline.tiny(gen, device="cpu")
    pipe.params["encoders"] = {"eeg": {"blocks": [
        {"w": torch.randn(3, 2, generator=gen)},
        {"w": torch.randn(3, 2, generator=gen), "extra": {}}], "empty": []}}
    pipe.params["dgf"] = {"duan": {"scale": torch.tensor(0.5)}}
    return pipe


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("layout", ["float", "int8_serving"])
def test_pipeline_round_trip_is_exact(tiny, tmp_path, layout):
    pipe = dataclasses.replace(tiny, params=dict(tiny.params))
    if layout == "int8_serving":
        pipe.quantize()
        # bf16 leaves beside the decoder's float32 ones
        vae = pipe.params["vae"]
        pipe.params["vae"] = dict(vae, encoder=_cast(vae["encoder"],
                                                     torch.bfloat16))
    path = tckpt.save_pipeline(pipe, str(tmp_path / "ck"))
    back = tckpt.load_pipeline(path, device="cpu")
    assert back.dtype == pipe.dtype and back.flux_cfg == pipe.flux_cfg
    assert (back.vae_cfg, back.t5_cfg, back.clip_cfg) == (
        pipe.vae_cfg, pipe.t5_cfg, pipe.clip_cfg)
    _assert_trees_equal(back.params, pipe.params)
    eeg = back.params["encoders"]["eeg"]
    assert isinstance(eeg["blocks"], list) and eeg["empty"] == []
    assert eeg["blocks"][1]["extra"] == {}
    some = tckpt.load_pipeline(path, components=("flux", "encoders"),
                               device="cpu")
    assert sorted(some.params) == ["encoders", "flux"]
    _assert_trees_equal(some.params["flux"], pipe.params["flux"])
    assert some.device == torch.device("cpu")


def test_orbax_directory_names_the_converter(tmp_path):
    os.makedirs(tmp_path / "ck" / "params" / "flux")
    with pytest.raises(ValueError, match="loongx_tpu_torch.cli.convert"):
        tckpt.component_files(str(tmp_path / "ck"))


def test_config_json_matches_jax(tiny, tmp_path):
    """JAX's save_pipeline config.json parses into the port's configs equal
    to JAX's own (lists back to tuples), and the port writes the same
    file."""
    jcfgs = dict(flux_cfg=jmodel.FluxConfig.tiny(), vae_cfg=jvae.VAEConfig.tiny(),
                 t5_cfg=jt5.T5Config.tiny(), clip_cfg=jclip.CLIPTextConfig.tiny())
    jckpt.save_pipeline(JPipeline(params={}, dtype=jnp.float32, **jcfgs),
                        str(tmp_path / "jax"))
    *cfgs, dtype = tckpt.load_configs(str(tmp_path / "jax"))
    assert dtype == "float32"
    for cfg, jcfg in zip(cfgs, jcfgs.values()):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert isinstance(cfgs[0].axes_dims, tuple)
    port = LoongXPipeline(*cfgs[:2], {}, torch.float32, t5_cfg=cfgs[2],
                          clip_cfg=cfgs[3])
    tckpt.save_pipeline(port, str(tmp_path / "port"))
    with open(tmp_path / "jax" / "config.json") as a, \
            open(tmp_path / "port" / "config.json") as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lora_files_cross_load(tiny, tmp_path, writer):
    gen = torch.Generator().manual_seed(2)
    flux = tlora.add_lora(tiny.params["flux"], r=2, alpha=4,
                          dtype=torch.float32, generator=gen)
    for _, leaf in tlora._walk_linears(flux):
        if "lora_b" in leaf:
            leaf["lora_b"] = torch.randn(leaf["lora_b"].shape, generator=gen)
    jflux = jax.tree.map(jnp.asarray, to_numpy_tree(flux))
    base = jax.tree.map(jnp.asarray, to_numpy_tree(tiny.params["flux"]))
    if writer == "jax":
        path = jckpt.save_lora_safetensors(jflux, str(tmp_path / "l"))
    else:
        path = tckpt.save_lora_safetensors(flux, str(tmp_path / "l"))
    got = tckpt.load_lora_safetensors(tlora._copy_dicts(tiny.params["flux"]),
                                      path)
    want = jckpt.load_lora_safetensors(jax.tree.map(lambda x: x, base), path)
    _assert_trees_equal(got, want)
    _assert_trees_equal(tlora.lora_state_dict(got), tlora.lora_state_dict(flux))


# ---------------------------------------------------------------------------
# Converters on synthetic state dicts
# ---------------------------------------------------------------------------


def _state(manifest, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(dtype) for k, s in manifest}


def _flux_manifest(cfg):
    from benchmarks.convert_rehearsal import flux_key_manifest

    return flux_key_manifest(
        nd=cfg.num_double_blocks, ns=cfg.num_single_blocks, h=cfg.hidden,
        mlp=cfg.mlp_ratio * cfg.hidden, joint=cfg.joint_dim,
        pooled=cfg.pooled_dim, tc=cfg.time_embed_channels,
        in_ch=cfg.in_channels, hd=cfg.head_dim)


@pytest.mark.parametrize("case", ["tiny_f32", "tiny_bf16", "published_keys"])
def test_convert_flux_matches_jax(case):
    """convert_flux_state equals JAX's bit for bit; ``published_keys`` runs
    at the published FLUX.1-dev key manifest (19 + 38 blocks, tiny
    widths) of tests/test_diffusers_anchor.py."""
    jcfg = jmodel.FluxConfig.tiny()
    if case == "published_keys":
        from test_diffusers_anchor import _published_flux_dev_transformer_keys

        jcfg = dataclasses.replace(jcfg, num_double_blocks=19,
                                   num_single_blocks=38)
    cfg = FluxConfig(**dataclasses.asdict(jcfg))
    manifest = _flux_manifest(cfg)
    if case == "published_keys":
        assert {k for k, _ in manifest} == _published_flux_dev_transformer_keys()
    state = _state(manifest)
    tdtype, jdtype = torch.float32, jnp.float32
    if case == "tiny_bf16":
        tdtype, jdtype = torch.bfloat16, jnp.bfloat16
    got = tconvert.convert_flux_state(state, cfg, tdtype, device="cpu")
    want = jconvert.convert_flux_state(state, jcfg, jdtype)
    _assert_trees_equal(got, want)


def test_convert_vae_t5_clip_match_jax(tmp_path):
    """The VAE (float32), T5 and CLIP (bf16 from float32 sources: the same
    rounding) converters equal JAX's; the T5 and CLIP sources are read
    back through load_safetensors_dir from fp16 files."""
    from benchmarks import convert_rehearsal as synth

    vcfg, jvcfg = VAEConfig.tiny(), jvae.VAEConfig.tiny()
    synth.synth_vae(str(tmp_path / "vae"), vcfg.block_channels,
                    vcfg.layers_per_block, vcfg.latent_channels)
    t5, clip = T5Config.tiny(), CLIPTextConfig.tiny()
    synth.synth_t5(str(tmp_path / "t5"), t5.num_layers, d=t5.d_model,
                   inner=t5.num_heads * t5.d_kv, ff=t5.d_ff,
                   vocab=t5.vocab_size, heads=t5.num_heads)
    synth.synth_clip(str(tmp_path / "clip"), clip.num_layers, h=clip.hidden,
                     ff=clip.d_ff, vocab=clip.vocab_size,
                     pos=clip.max_positions)
    for name, t_fn, j_fn, cfg, jcfg, dt in (
            ("vae", tconvert.convert_vae_state, jconvert.convert_vae_state,
             vcfg, jvcfg, "float32"),
            ("t5", tconvert.convert_t5_state, jconvert.convert_t5_state, t5,
             jt5.T5Config.tiny(), "bfloat16"),
            ("clip", tconvert.convert_clip_state, jconvert.convert_clip_state,
             clip, jclip.CLIPTextConfig.tiny(), "bfloat16")):
        state = tconvert.load_safetensors_dir(str(tmp_path / name))
        jstate = jconvert.load_safetensors_dir(str(tmp_path / name))
        got = t_fn(state, cfg, getattr(torch, dt), device="cpu")
        want = j_fn(jstate, jcfg, getattr(jnp, dt))
        _assert_trees_equal(got, want)


def test_convert_reference_lora_matches_jax(tiny):
    """A peft-layout LoRA (to_q of double blocks 0 and 1, x_embedder,
    single-block proj_out) onto the whole and the serving-split proj_out."""
    cfg = tiny.flux_cfg
    h, r = cfg.hidden, 2
    rng = np.random.default_rng(4)
    state = {}
    for module, (n_in, n_out) in {
            "transformer_blocks.0.attn.to_q": (h, h),
            "transformer_blocks.1.attn.to_q": (h, h),
            "x_embedder": (cfg.in_channels, h),
            "single_transformer_blocks.1.proj_out": (h + 4 * h, h)}.items():
        state[f"transformer.{module}.lora_A.weight"] = rng.standard_normal(
            (r, n_in)).astype(np.float32)
        state[f"transformer.{module}.lora_B.weight"] = rng.standard_normal(
            (n_out, r)).astype(np.float32)
    jcfg = jmodel.FluxConfig(**dataclasses.asdict(cfg))
    for split in (False, True):
        flux = tiny.params["flux"]
        if split:
            flux = tquant.split_single_proj_out(flux, h)
        jflux = jax.tree.map(jnp.asarray, to_numpy_tree(flux))
        got = tconvert.convert_reference_lora(state, flux, cfg,
                                              dtype=torch.float32)
        want = jconvert.convert_reference_lora(state, jflux, jcfg,
                                               dtype=jnp.float32)
        _assert_trees_equal(got, want)
    bad = {"transformer.unknown.lora_A.weight": state[
        "transformer.x_embedder.lora_A.weight"]}
    with pytest.raises(ValueError, match="none map onto"):
        tconvert.convert_reference_lora(bad, flux, cfg)


def test_merge_lora_matches_jax(tiny):
    gen = torch.Generator().manual_seed(5)
    flux = tlora.add_lora(tiny.params["flux"], r=3, alpha=6,
                          dtype=torch.float32, generator=gen)
    for _, leaf in tlora._walk_linears(flux):
        if "lora_b" in leaf:
            leaf["lora_b"] = torch.randn(leaf["lora_b"].shape, generator=gen)
    got = _flat(tlora.merge_lora(flux))
    want = _flat(jlora.merge_lora(jax.tree.map(jnp.asarray,
                                               to_numpy_tree(flux))))
    assert sorted(got) == sorted(want)
    assert not any("lora" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    q = tquant.quantize_tree(flux)
    with pytest.raises(ValueError) as port_err:
        tlora.merge_lora(q)
    with pytest.raises(ValueError) as jax_err:
        jlora.merge_lora(jax.tree.map(jnp.asarray, to_numpy_tree(q)))
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# Pipeline constructors: the JAX package's trees
# ---------------------------------------------------------------------------


def _jax_structure(fn):
    shapes = jax.eval_shape(fn, jax.random.key(0))
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in _flat_leaves(shapes).items()}


@pytest.mark.parametrize("ctor", ["tiny", "tiny_biosignal", "init_random",
                                  "from_pretrained_quantize"])
def test_constructors_match_jax_trees(tiny, tmp_path, ctor):
    gen = torch.Generator().manual_seed(0)
    if ctor == "tiny":
        got = LoongXPipeline.tiny(gen, device="cpu").params
        want = _jax_structure(lambda k: JPipeline.tiny(k).params)
    elif ctor == "tiny_biosignal":
        got = LoongXPipeline.tiny(with_biosignal=True, device="meta").params
        want = _jax_structure(
            lambda k: JPipeline.tiny(k, with_biosignal=True).params)
    elif ctor == "init_random":  # full size: shapes only
        got = LoongXPipeline.init_random(device="meta").params
        want = _jax_structure(lambda k: JPipeline.init_random(k).params)
    else:
        pipe = dataclasses.replace(tiny, params={
            k: v for k, v in tiny.params.items()
            if k not in ("encoders", "dgf")})
        path = tckpt.save_pipeline(pipe, str(tmp_path / "ck"))
        got = LoongXPipeline.from_pretrained(
            path, dtype=torch.float32, quantize=True, device="cpu").params
        want = _jax_structure(lambda k: JPipeline.tiny(k).quantize().params)
    assert _structure(got) == want


# ---------------------------------------------------------------------------
# The CLI's image reader
# ---------------------------------------------------------------------------


def _image(mode, size=(40, 24)):
    """A structured test image (ramps, noise, flat areas) for ``mode``."""
    rng = np.random.default_rng(6)
    h, w = size[1], size[0]
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [(xx * 5 + yy) % 256, (yy * 9) % 256, rng.integers(0, 256, (h, w)),
             np.where(xx > w // 2, 200, 10)]
    n = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    arr = np.stack(chans[:n], -1).astype(np.uint8)
    return arr[..., 0] if n == 1 else arr


def test_cli_image_reader(tmp_path):
    """read_image gives what the JAX CLI reads: RGBA, palette and
    greyscale + alpha PNGs and JPEGs as RGB, resized where asked."""
    from PIL import Image

    from loongx_tpu_torch.cli.infer import read_image

    arr = _image("RGBA", (24, 24))
    Image.fromarray(arr, "RGBA").save(tmp_path / "a.png")
    Image.fromarray(arr[..., :3]).convert("P").save(tmp_path / "p.png")
    Image.fromarray(arr[..., :3]).convert("LA").save(tmp_path / "la.png")
    Image.fromarray(arr[..., :3]).save(tmp_path / "j.jpg")
    for name, size in (("a.png", 24), ("a.png", 16), ("p.png", 24),
                       ("la.png", 24), ("j.jpg", 24)):
        want = np.asarray(Image.open(tmp_path / name).convert("RGB").resize(
            (size, size)))
        got = np.asarray(read_image(str(tmp_path / name), size))
        np.testing.assert_array_equal(got, want)
