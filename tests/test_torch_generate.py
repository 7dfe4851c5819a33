"""The port's generate() against the JAX package's, on CPU in float32.

One tiny pipeline whose text widths are the real ones (joint_dim 4096,
pooled_dim 768, prompts of 512 tokens) so the real CS3 encoders and DGF
fuse into it: a one-layer T5 with d_model 4096, a one-layer CLIP text tower
of width 768, the tiny DiT and VAE, and a deterministic character
tokenizer.  Both sides get the same weights (bridged), the same signals and
the same random draws (the JAX keys' latents and VAE-sample noise handed to
the port), ATOL 2e-4 as tests/test_golden_torch.py.  Also: every argument
error as JAX raises it, the condition type ids, and the adapter registry.
"""

import dataclasses
import importlib

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
from loongx_tpu.sampling import condition as jcond
from loongx_tpu.train import adapters as jadapters
from loongx_tpu.train import lora as jlora
from loongx_tpu_torch.models import encoders as tenc
from loongx_tpu_torch.models import fusion as tfus
from loongx_tpu_torch.models.flux import model as tmodel
from loongx_tpu_torch.models.flux import vae as tvae
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.models.text import clip as tclip
from loongx_tpu_torch.models.text import t5 as tt5
from loongx_tpu_torch.sampling import condition as tcond
from loongx_tpu_torch.sampling import generate as tgen
from loongx_tpu_torch.train import adapters as tadapters
from loongx_tpu_torch.train import lora as tlora
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
_T5 = dict(d_model=4096, d_kv=8, num_heads=2, d_ff=32, num_layers=1)
_CLIP = dict(hidden=768, num_heads=4, d_ff=32, num_layers=1)
JT5 = dataclasses.replace(jt5.T5Config.tiny(), **_T5)
TT5 = dataclasses.replace(tt5.T5Config.tiny(), **_T5)
JCLIP = dataclasses.replace(jclip.CLIPTextConfig.tiny(), **_CLIP)
TCLIP = dataclasses.replace(tclip.CLIPTextConfig.tiny(), **_CLIP)
LAT = SIZE // JVAE.downscale
S_IMG = (LAT // 2) ** 2


class CharTokenizer:
    """Deterministic character tokenizer with the Hugging Face call
    interface (as tests/test_infer_cli.py)."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p[:max_length]):
                ids[i, j] = (ord(ch) + j) % self.vocab_size

        class Out:
            input_ids = ids

        return Out()


@pytest.fixture(scope="module")
def params():
    """(JAX tree, port tree): random float32 weights made by the port's
    inits (the JAX package's trees, much faster on CPU than tracing the JAX
    inits), LoRA leaves on the DiT (scale 0 until an adapter is active)."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(generator=gen, dtype=torch.float32, device="cpu")
    flux = tlora.add_lora(tmodel.init_flux_params(TCFG, **kw), r=2, alpha=2,
                          dtype=torch.float32, generator=gen)
    flux = tadapters.AdapterRegistry().deactivate(flux)
    tree = {
        "flux": flux,
        "vae": tvae.init_vae_params(TVAE, **kw),
        "t5": tt5.init_t5_params(TT5, **kw),
        "clip": tclip.init_clip_params(TCLIP, **kw),
        "encoders": {
            "eeg": tenc.init_eeg_encoder(**kw),
            "ppg": tenc.init_ppg_encoder(**kw),
            "fnirs": tenc.init_fnirs_encoder(**kw),
            "motion": tenc.init_motion_encoder(**kw),
        },
        "dgf": tfus.init_dgf(**kw),
    }
    numpy_tree = to_numpy_tree(tree)
    return (jax.tree.map(jnp.asarray, numpy_tree),
            from_numpy_tree(numpy_tree, "cpu"))


def _pipelines(params, tokenizers=True, drop=()):
    jtree, ttree = params
    tok = dict(t5_tokenizer=CharTokenizer(JT5.vocab_size),
               clip_tokenizer=CharTokenizer(JCLIP.vocab_size)) if tokenizers else {}
    jp = JPipeline(JCFG, JVAE, JT5, JCLIP,
                   {k: v for k, v in jtree.items() if k not in drop},
                   dtype=jnp.float32, max_sequence_length=512, **tok)
    tp = LoongXPipeline(TCFG, TVAE,
                        {k: v for k, v in ttree.items() if k not in drop},
                        torch.float32, t5_cfg=TT5, clip_cfg=TCLIP,
                        max_sequence_length=512, **tok)
    return jp, tp


def _signals(seed, b=1, names=("eeg", "ppg", "fnirs", "motion")):
    rng = np.random.default_rng(seed)
    shapes = dict(eeg=(b, 4, 512), ppg=(b, 4, 256), fnirs=(b, 6, 512),
                  motion=(b, 6, 128))
    return {n: rng.standard_normal(shapes[n], np.float32) for n in names}


def _draws(seed, batch, cond=False):
    """The latents and condition VAE-sample noise JAX's generate draws from
    ``seed``, as tensors for the port."""
    k_lat, k_enc = jax.random.split(jax.random.key(seed))
    lat = np.array(jax.random.normal(
        k_lat, (batch, LAT // 2, LAT // 2, JCFG.in_channels), jnp.float32))
    out = dict(latents=torch.from_numpy(lat.reshape(batch, S_IMG, -1)))
    if cond:
        out["cond_noise"] = torch.from_numpy(np.array(jax.random.normal(
            k_enc, (1, LAT, LAT, JVAE.latent_channels), jnp.float32)))
    return out


def _image(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)


def _case(name):
    """(kwargs for both sides, batch, whether a condition image is encoded,
    adapter name to register) of one generate() configuration."""
    sig = _signals(11)
    if name == "text":
        return dict(prompt="a red cat on a mat"), 1, False, None
    if name == "fuse_infer_condition":
        c = lambda mod: [mod.Condition("eeg+fnirs", condition=_image(1), **sig)]
        return (dict(prompt="make it blue", conditions=c,
                     use_brain_condition=True, fuse_flag=True,
                     fuse_mode="infer", output_type="np"), 1, True, None)
    if name == "fuse_train_partial":
        return (dict(prompt=["edit"], use_brain_condition=True, fuse_flag=True,
                     fuse_mode="train", **_signals(12, names=("eeg", "ppg"))),
                1, False, None)
    if name == "replace_partial_widened":
        return (dict(prompt="keep the pooled slot", use_brain_condition=True,
                     **_signals(13, b=2, names=("eeg",))), 2, False, None)
    if name == "cond_tokens_adapter":
        rng = np.random.default_rng(14)
        ids = np.zeros((S_IMG, 3), np.float32)
        ids[:, 1:] = rng.integers(0, LAT // 2, (S_IMG, 2))
        return (dict(prompt=["one", "two"], condition_type="canny",
                     cond_tokens=rng.standard_normal(
                         (S_IMG, JCFG.in_channels)).astype(np.float32),
                     cond_ids=ids, condition_scale=0.5), 2, False, "canny")
    if name == "subject_condition":
        c = lambda mod: [mod.Condition("subject", condition=_image(2))]
        return (dict(prompt="a dog", conditions=c, output_type="uint8"), 1,
                True, None)
    raise KeyError(name)


CASES = ["text", "fuse_infer_condition", "fuse_train_partial",
         "replace_partial_widened", "cond_tokens_adapter", "subject_condition"]


def _register(jp, tp, name):
    """The same random adapter ``name`` on both pipelines."""
    jreg, treg = jadapters.AdapterRegistry(), tadapters.AdapterRegistry()
    state = tlora.lora_state_dict(tp.params["flux"])
    gen = torch.Generator().manual_seed(3)
    state = {k: (torch.randn(v.shape, generator=gen) * 0.1
                 if not k.endswith("lora_scale") else v)
             for k, v in state.items() if not k.endswith("lora_scale")}
    treg.add(name, state, scale=0.5)
    jreg.add(name, {k: jnp.asarray(v.numpy()) for k, v in state.items()},
             scale=0.5)
    jp.adapters, tp.adapters = jreg, treg


@pytest.mark.parametrize("name", CASES)
def test_generate_matches_jax(params, name):
    jp, tp = _pipelines(params)
    kw, batch, cond, adapter = _case(name)
    if adapter:
        _register(jp, tp, adapter)
    jkw, tkw = dict(kw), dict(kw)
    if "conditions" in kw:
        jkw["conditions"] = kw["conditions"](jcond)
        tkw["conditions"] = kw["conditions"](tcond)
    common = dict(height=SIZE, width=SIZE, num_inference_steps=STEPS)
    common["output_type"] = kw.get("output_type", "latent")
    jkw.update(common)
    tkw.update(common)
    want = np.asarray(jgen.generate(jp, seed=7, **jkw))
    got = tgen.generate(tp, **_draws(7, batch, cond), **tkw)
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == np.uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert tp.active_adapter == jp.active_adapter == adapter


def test_generate_draws_from_generator(params):
    """Without explicit draws the port takes them from ``seed``'s
    generator: the same seed gives the same latents, another seed others."""
    _, tp = _pipelines(params)
    kw = dict(prompt="x", height=SIZE, width=SIZE, num_inference_steps=1,
              output_type="latent")
    a, b = tgen.generate(tp, seed=1, **kw), tgen.generate(tp, seed=1, **kw)
    c = tgen.generate(tp, seed=2, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _fake_brain(eeg=None, fnirs=None, ppg=None, motion=None, **_):
    prompt = None if eeg is None else np.full(
        (np.shape(eeg)[0], 512, 4096), 0.1, np.float32)
    pooled = None if fnirs is None else np.full(
        (np.shape(fnirs)[0], 768), 0.2, np.float32)
    return prompt, pooled


def _error_cases():
    sig = _signals(20)
    c = {"eeg": sig["eeg"], "fnirs": sig["fnirs"]}
    return [
        ("fuse_mode", {}, dict(fuse_mode="inference")),
        ("output_type", {}, dict(output_type="pil")),
        ("condition_scale", {}, dict(condition_scale=0.0)),
        ("conditions_and_tokens", {}, dict(
            conditions="subject", cond_tokens=np.zeros((S_IMG, 16), np.float32))),
        ("height", {}, dict(height=SIZE + 2)),
        ("no_signals", {}, dict(use_brain_condition=True)),
        ("signals_unused", {}, dict(conditions="eeg_only_condition")),
        ("neural_only_fuse", {}, dict(neural_only=True, use_brain_condition=True,
                                      fuse_flag=True, **c)),
        ("embeds_without_pooled", {}, dict(
            prompt_embeds=np.zeros((1, 512, 4096), np.float32))),
        ("fuse_pooled_only", {}, dict(use_brain_condition=True, fuse_flag=True,
                                      fnirs=sig["fnirs"])),
        ("fuse_infer_partial", {}, dict(use_brain_condition=True,
                                        fuse_flag=True, eeg=sig["eeg"])),
        ("fuse_token_count", {}, dict(
            use_brain_condition=True, fuse_flag=True,
            prompt_embeds=np.zeros((1, 8, 4096), np.float32),
            pooled_prompt_embeds=np.zeros((1, 768), np.float32), **c)),
        ("fuse_no_dgf", {"drop": ("dgf",)}, dict(
            use_brain_condition=True, fuse_flag=True, **c)),
        ("neural_only_missing_slot", {"tokenizers": False}, dict(
            neural_only=True, use_brain_condition=True, eeg=sig["eeg"])),
        ("brain_batch_mismatch", {}, dict(
            use_brain_condition=True, eeg=_signals(21, b=2)["eeg"],
            fnirs=_signals(21, b=3)["fnirs"])),
        ("latents_shape", {}, dict(latents="wrong")),
        ("two_conditions", {}, dict(conditions="two")),
        ("imageless_spatial", {}, dict(conditions="canny_no_image")),
        ("tokens_without_ids", {}, dict(
            cond_tokens=np.zeros((S_IMG, 16), np.float32))),
        ("no_tokenizers", {"tokenizers": False}, dict(prompt="text")),
        ("no_encoders", {"drop": ("encoders",)}, dict(
            use_brain_condition=True, **c)),
    ]


def _resolve(kw, mod, array):
    out = dict(kw)
    conds = {"subject": lambda: [mod.Condition("subject", condition=_image(3))],
             "eeg_only_condition": lambda: [mod.Condition(
                 "eeg+fnirs", eeg=_signals(22)["eeg"])],
             "two": lambda: [mod.Condition("subject", condition=_image(3))] * 2,
             "canny_no_image": lambda: [mod.Condition("canny")]}
    if "conditions" in out:
        out["conditions"] = conds[out["conditions"]]()
    if out.get("latents") == "wrong":
        out["latents"] = array(np.zeros((1, S_IMG + 1, 16), np.float32))
    for key in ("prompt_embeds", "pooled_prompt_embeds", "cond_tokens"):
        if key in out:
            out[key] = array(out[key])
    return out


@pytest.mark.parametrize("label, pipe_kw, kw", _error_cases(),
                         ids=[c[0] for c in _error_cases()])
def test_generate_argument_errors_match_jax(monkeypatch, params, label,
                                            pipe_kw, kw):
    """Each argument error with the JAX package's type and message; the
    brain encode is replaced by fixed embeds on both sides (its own errors
    are those of the no_encoders case, which keeps it)."""
    jp, tp = _pipelines(params, **pipe_kw)
    if label != "no_encoders":
        monkeypatch.setattr(jgen, "encode_brain_conditions",
                            lambda p, **k: tuple(
                                None if x is None else jnp.asarray(x)
                                for x in _fake_brain(**k)))
        monkeypatch.setattr(tgen, "encode_brain_conditions",
                            lambda p, **k: tuple(
                                None if x is None else torch.from_numpy(x)
                                for x in _fake_brain(**k)))
    common = dict(height=SIZE, width=SIZE, num_inference_steps=1,
                  output_type="latent")
    jkw = dict(common, **_resolve(kw, jcond, jnp.asarray))
    tkw = dict(common, **_resolve(kw, tcond, torch.from_numpy))
    with pytest.raises(Exception) as jerr:
        jgen.generate(jp, **jkw)
    with pytest.raises(Exception) as terr:
        tgen.generate(tp, **tkw)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def test_pipeline_quantize_and_text_encoders(params):
    """quantize() gives the JAX package's serving tree (int8, qkv fused,
    proj_out split); add_text_encoders() completes a bundle with int8 T5 and
    CLIP that encode_text runs (T5 through the stacked path's plain version
    here), and free_text_encoders() drops them."""
    jp, tp = _pipelines(params)
    jp.params["flux"] = jax.tree.map(lambda x: x, jp.params["flux"])
    jp.quantize(text=False)
    tp.quantize(text=False)
    want = jax.tree.map(np.asarray, jp.params["flux"])
    got = to_numpy_tree(tp.params["flux"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-7)

    _, tp = _pipelines(params, tokenizers=False, drop=("t5", "clip"))
    tp.add_text_encoders(TT5, TCLIP, seed=1,
                         t5_tokenizer=CharTokenizer(TT5.vocab_size),
                         clip_tokenizer=CharTokenizer(TCLIP.vocab_size))
    assert all("kernel_q" in tp.params["t5"]["blocks"][n]
               for n in ("q", "k", "v", "o", "wi_0", "wi_1", "wo"))
    assert "kernel_q" in tp.params["clip"]["blocks"]["fc1"]
    embeds, pooled, txt_ids = tp.encode_text(["a", "b c"])
    assert embeds.shape == (2, 512, 4096) and pooled.shape == (2, 768)
    assert txt_ids.shape == (512, 3) and torch.isfinite(embeds).all()
    tp.free_text_encoders()
    assert "t5" not in tp.params and tp.t5_tokenizer is None
    with pytest.raises(RuntimeError, match="no tokenizers"):
        tp.encode_text("a")


def test_condition_type_ids_and_encode_match_jax(params):
    assert tcond.CONDITION_TYPE_IDS == jcond.CONDITION_TYPE_IDS
    for name in jcond.CONDITION_TYPE_IDS:
        if name in ("depth", "depth_pred"):
            continue
        assert tcond.Condition(name).type_id == jcond.Condition(name).type_id
        assert tcond.Condition.get_type_id(name) == jcond.Condition.get_type_id(name)
    with pytest.raises(ValueError, match="unknown condition type"):
        tcond.Condition("sketch")
    jp, tp = _pipelines(params)
    img = _image(4)
    for ctype, delta in (("subject", None), ("canny", (1, 2))):
        jc = jcond.Condition(ctype, condition=img, position_delta=delta,
                             position_scale=1.5)
        tc = tcond.Condition(ctype, condition=img, position_delta=delta,
                             position_scale=1.5)
        jt, jids, jtype = jc.encode(jp)
        tt, tids, ttype = tc.encode(tp)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=ATOL,
                                   rtol=ATOL)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(ttype.numpy(), np.asarray(jtype))


def test_adapter_registry_matches_jax(params):
    """activate / deactivate on the bridged DiT tree: the same factors and
    scales as JAX's registry, other adapters' leaves zeroed, the caller's
    tree untouched, unknown names refused alike."""
    jtree, ttree = params
    paths = [k for k in tlora.lora_state_dict(ttree["flux"])
             if k.endswith("lora_a")]
    gen = torch.Generator().manual_seed(5)
    treg, jreg = tadapters.AdapterRegistry(), jadapters.AdapterRegistry()
    for name, chosen, scale in (("a", paths[:3], None), ("b", paths[2:5], 0.25)):
        state = {}
        for p in chosen:
            base = p[:-len("/lora_a")]
            a = ttree["flux"]
            for part in base.split("/"):
                a = a[part]
            state[f"{base}/lora_a"] = torch.randn(a["lora_a"].shape, generator=gen)
            state[f"{base}/lora_b"] = torch.randn(a["lora_b"].shape, generator=gen)
        treg.add(name, state, scale)
        jreg.add(name, {k: jnp.asarray(v.numpy()) for k, v in state.items()},
                 scale)
    assert treg.names() == jreg.names() == ["a", "b"] and "a" in treg
    before = {k: v.clone() for k, v in tlora.lora_state_dict(ttree["flux"]).items()}
    for name in ("a", "b"):
        got = tlora.lora_state_dict(treg.activate(ttree["flux"], name))
        want = jlora.lora_state_dict(jreg.activate(jtree["flux"], name))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    off = tlora.lora_state_dict(treg.deactivate(treg.activate(ttree["flux"], "a")))
    assert all(float(v.abs().sum()) == 0 for k, v in off.items()
               if k.endswith("lora_scale"))
    after = tlora.lora_state_dict(ttree["flux"])
    assert all(torch.equal(after[k], before[k]) for k in before)
    with pytest.raises(KeyError) as terr:
        treg.activate(ttree["flux"], "c")
    with pytest.raises(KeyError) as jerr:
        jreg.activate(jtree["flux"], "c")
    assert str(terr.value) == str(jerr.value)
