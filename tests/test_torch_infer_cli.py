"""The port's inference and convert CLIs (``loongx_tpu_torch/cli/``) against
the JAX package's, on the CPU.

The tiny pipeline of both packages (``LoongXPipeline.tiny``'s configs; the
float32 weights made by the port's ``tiny``, much faster on the CPU than
tracing the JAX inits, and bridged to JAX), a character tokenizer with 8-token prompts, 16x16 images written and read by
Pillow, 2 Euler steps.  Both sides get the same
random draws: the latents and VAE-sample noise JAX draws from ``seed``,
handed to the port's ``edit_one`` / ``batch_edit``.  Outputs are uint8
within 1, as tests/test_torch_generate.py holds ``generate()``.  The brain
encode is faked on both sides with the same function of the signals (the
full-size CS3 stacks do not fit the tiny DiT), as tests/test_infer_cli.py
does.
"""

import dataclasses
import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.cli import infer as jinfer
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu_torch.cli import infer as tinfer
from loongx_tpu_torch.models.flux.model import FluxConfig
from loongx_tpu_torch.models.flux.vae import VAEConfig
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.models.text.clip import CLIPTextConfig
from loongx_tpu_torch.models.text.t5 import T5Config
from loongx_tpu_torch.train.lora import _copy_dicts
from loongx_tpu_torch.utils.bridge import to_numpy_tree

jgen = importlib.import_module("loongx_tpu.sampling.generate")
tgen = importlib.import_module("loongx_tpu_torch.sampling.generate")

SIZE, STEPS = 16, 2
JCFGS = {"flux_cfg": (jmodel, "FluxConfig"), "vae_cfg": (jvae, "VAEConfig"),
         "t5_cfg": (jt5, "T5Config"), "clip_cfg": (jclip, "CLIPTextConfig")}


class FakeTokenizer:
    """The character tokenizer of tests/test_infer_cli.py."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p[:max_length]):
                ids[i, j] = (ord(ch) + j) % self.vocab_size

        class R:
            input_ids = ids

        return R()


def _jax_pipeline(tp, params=None):
    """The JAX pipeline of the port's ``tp``: the same configs, and its
    params (``params``: a port tree, default tp's) bridged."""
    c = {k: getattr(mod, cls)(**dataclasses.asdict(getattr(tp, k)))
         for k, (mod, cls) in JCFGS.items()}
    tree = jax.tree.map(jnp.asarray, to_numpy_tree(
        tp.params if params is None else params))
    return JPipeline(params=tree, dtype=jnp.float32, **c)


@pytest.fixture(scope="module")
def trees():
    """(JAX pipeline, port tree) with the same tiny weights."""
    tp = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    return _jax_pipeline(tp), tp.params


def _port_cfgs(jp):
    return dict(
        flux_cfg=FluxConfig(**dataclasses.asdict(jp.flux_cfg)),
        vae_cfg=VAEConfig(**dataclasses.asdict(jp.vae_cfg)),
        t5_cfg=T5Config(**dataclasses.asdict(jp.t5_cfg)),
        clip_cfg=CLIPTextConfig(**dataclasses.asdict(jp.clip_cfg)))


@pytest.fixture()
def pipes(trees):
    """(JAX pipeline, port pipeline) with the same weights and tokenizers,
    each with its own containers."""
    jp0, ttree = trees
    jp = dataclasses.replace(
        jp0, params=jax.tree.map(lambda x: x, jp0.params),
        t5_tokenizer=FakeTokenizer(jp0.t5_cfg.vocab_size),
        clip_tokenizer=FakeTokenizer(jp0.clip_cfg.vocab_size),
        max_sequence_length=8)
    c = _port_cfgs(jp0)
    tp = LoongXPipeline(
        c["flux_cfg"], c["vae_cfg"], _copy_dicts(ttree), torch.float32,
        t5_cfg=c["t5_cfg"], clip_cfg=c["clip_cfg"],
        t5_tokenizer=FakeTokenizer(jp0.t5_cfg.vocab_size),
        clip_tokenizer=FakeTokenizer(jp0.clip_cfg.vocab_size),
        max_sequence_length=8)
    return jp, tp


def _draws(jp, seed):
    """The latents and condition VAE-sample noise JAX draws from ``seed``
    (generate / neural_edit / batch_edit split key(seed) the same way)."""
    k_lat, k_enc = jax.random.split(jax.random.key(seed))
    lat, c = SIZE // jp.vae_cfg.downscale, jp.flux_cfg.in_channels
    latents = np.array(jax.random.normal(
        k_lat, (1, lat // 2, lat // 2, c), jnp.float32)).reshape(1, -1, c)
    noise = np.array(jax.random.normal(
        k_enc, (1, lat, lat, jp.vae_cfg.latent_channels), jnp.float32))
    return dict(latents=torch.from_numpy(latents),
                cond_noise=torch.from_numpy(noise))


def _images(tmp_path, n, name="in"):
    """``n`` random 16x16 PNGs written by Pillow (adaptive filters)."""
    from PIL import Image

    d = tmp_path / name
    d.mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(n):
        names.append(f"img{i}_0.png")
        Image.fromarray(rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8)).save(
            d / names[-1])
    return str(d), names


def _read(path):
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.int32)


def _fake_brain(jp, tp, monkeypatch):
    """The same brain encode on both sides: embeds from the signals'
    means; both pipelines get (empty) encoders and DGF."""
    jd, pd = jp.flux_cfg.joint_dim, jp.flux_cfg.pooled_dim

    def embeds(xp, zeros, mean, eeg, ppg, fnirs, motion):
        prompt = pooled = None
        if eeg is not None:
            prompt = mean(eeg)[:, None, None] + zeros((eeg.shape[0], 8, jd))
            if ppg is not None:
                prompt = prompt + 0.5 * mean(ppg)[:, None, None]
        if fnirs is not None:
            pooled = mean(fnirs)[:, None] + zeros((fnirs.shape[0], pd))
            if motion is not None:
                pooled = pooled - 0.5 * mean(motion)[:, None]
        return prompt, pooled

    def jfake(enc, dgf, eeg, ppg, fnirs, motion, s4_mode):
        return embeds(jnp, lambda s: jnp.zeros(s, jnp.float32),
                      lambda x: jnp.mean(x.astype(jnp.float32), axis=(1, 2)),
                      eeg, ppg, fnirs, motion)

    def tfake(enc, dgf, eeg, ppg, fnirs, motion, s4_mode="conv"):
        return embeds(torch, lambda s: torch.zeros(s),
                      lambda x: x.float().mean(dim=(1, 2)),
                      eeg, ppg, fnirs, motion)

    monkeypatch.setattr(jgen, "_brain_encode_jit", jfake)
    monkeypatch.setattr(tgen, "brain_encode", tfake)
    enc = ("eeg", "fnirs", "ppg", "motion")
    jp.params["encoders"] = {k: {} for k in enc}
    tp.params["encoders"] = {k: {} for k in enc}
    jp.params["dgf"], tp.params["dgf"] = {}, {}


def _signals(seed, names=("EEG", "FNIRS")):
    rng = np.random.default_rng(seed)
    shapes = {"EEG": (1, 4, 64), "FNIRS": (1, 6, 32), "PPG": (1, 4, 32),
              "Motion": (1, 6, 16)}
    return {n: rng.standard_normal(shapes[n]).astype(np.float32)
            for n in names}


class Args:
    """batch_edit's argparse namespace at the test size."""

    def __init__(self, in_dir, out_dir, **kw):
        self.input_dir, self.output_dir = str(in_dir), str(out_dir)
        self.condition_type, self.target_size = "subject", SIZE
        self.position_delta_x, self.position_delta_y = 0, -1
        self.seed, self.prompt, self.fuse, self.neural_only = 0, "edit", False, False
        self.steps, self.guidance, self.batch_size = STEPS, 3.5, None
        self.tensor, self.timing, self.decode_chunk = 1, False, None
        self.__dict__.update(kw)


# ---------------------------------------------------------------------------
# The port's CLI against JAX's, fed the same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["generate", "neural_edit"])
def test_edit_one_matches_jax(pipes, tmp_path, monkeypatch, path):
    """edit_one: the plain path (generate) and the brain fast path (the
    fused neural_edit, spied on) equal JAX's within 1."""
    jp, tp = pipes
    in_dir, names = _images(tmp_path, 1)
    image = os.path.join(in_dir, names[0])
    kw = dict(condition_type="subject", target_size=SIZE, num_steps=STEPS,
              seed=3)
    called = []
    if path == "neural_edit":
        _fake_brain(jp, tp, monkeypatch)
        kw["brain"] = _signals(5)
        real = tgen.neural_edit
        monkeypatch.setattr(tgen, "neural_edit",
                            lambda *a, **k: called.append(1) or real(*a, **k))
    want = np.asarray(jinfer.edit_one(jp, image, "make it blue", **kw))
    got = tinfer.edit_one(tp, image, "make it blue", **kw, **_draws(jp, 3))
    assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert bool(called) == (path == "neural_edit")


def test_batch_edit_matches_jax(pipes, tmp_path, monkeypatch, capsys):
    """Directory mode with per-image brain coverage: two images with EEG +
    fNIRS (+ PPG on one), one with a partnerless Motion, one with none.
    Every image within 1 of JAX's and the same warnings, in the same
    order."""
    jp, tp = pipes
    _fake_brain(jp, tp, monkeypatch)
    in_dir, names = _images(tmp_path, 4)
    brain = {names[0]: _signals(1), names[2]: _signals(2),
             names[1]: _signals(3, ("Motion",))}
    jinfer.batch_edit(jp, Args(in_dir, tmp_path / "jax", batch_size=2),
                      brain, {})
    jax_out = capsys.readouterr().out
    tinfer.batch_edit(tp, Args(in_dir, tmp_path / "port", batch_size=2),
                      brain, {}, **_draws(jp, 0))
    port_out = capsys.readouterr().out

    def warnings(text):
        return [line for line in text.splitlines() if "warning" in line]

    assert warnings(port_out) == warnings(jax_out)
    assert len(warnings(port_out)) == 3, port_out
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        diff = np.abs(_read(tmp_path / "port" / n) - _read(tmp_path / "jax" / n))
        assert diff.max() <= 1, (n, diff.max())


def test_batch_seed_parity(pipes, tmp_path):
    """Draws from the seed: the same image at --batch_size 1, 2 and 3, and
    equal to edit_one within 1."""
    _, tp = pipes
    in_dir, names = _images(tmp_path, 3)
    outs = {}
    for bs in (1, 2, 3):
        tinfer.batch_edit(tp, Args(in_dir, tmp_path / f"bs{bs}", batch_size=bs),
                          {}, {})
        outs[bs] = [_read(tmp_path / f"bs{bs}" / n) for n in names]
    for bs in (2, 3):
        for a, b in zip(outs[1], outs[bs]):
            np.testing.assert_array_equal(a, b)
    single = tinfer.edit_one(tp, os.path.join(in_dir, names[0]), "edit",
                             target_size=SIZE, position_delta=(0, -1), seed=0,
                             num_steps=STEPS)
    assert np.abs(single.astype(int) - outs[1][0]).max() <= 1


def test_neural_only_refused_before_compute(pipes, tmp_path, monkeypatch):
    jp, tp = pipes
    in_dir, names = _images(tmp_path, 3)
    brain = {names[0]: _signals(1)}
    monkeypatch.setattr(tgen, "generate", lambda *a, **k: pytest.fail("ran"))
    errors = []
    for mod, pipe in ((jinfer, jp), (tinfer, tp)):
        with pytest.raises(SystemExit) as exc:
            mod.batch_edit(pipe, Args(in_dir, tmp_path / "out",
                                      neural_only=True), brain, {})
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "EEG+FNIRS" in errors[1]


# ---------------------------------------------------------------------------
# main(): its refusals, worded as JAX's
# ---------------------------------------------------------------------------


def _baked(quant, flux, hidden):
    """A flux tree as ``convert --quantize --serving`` writes it."""
    return quant.split_single_proj_out(
        quant.fuse_qkv_projections(quant.quantize_tree(flux)), hidden)


@pytest.fixture(scope="module")
def checkpoints(trees, tmp_path_factory):
    """{kind: (JAX pipeline, port checkpoint dir)}: the tiny pipeline plain
    (no encoders) and baked (int8, fused qkv, split proj_out, stand-in
    encoders and DGF).  JAX's main gets its pipeline through a patched
    ``from_pretrained`` (no orbax round trip needed for its refusals), its
    baked tree bridged from the port's."""
    from loongx_tpu_torch.ops import quant as tquant
    from loongx_tpu_torch.utils.checkpoint import save_pipeline

    jp, ttree = trees
    root = tmp_path_factory.mktemp("ckpts")
    c = _port_cfgs(jp)
    out = {}
    for kind in ("plain", "baked"):
        jparams, tparams = dict(jp.params), dict(ttree)
        if kind == "baked":
            tparams["flux"] = _baked(tquant, tparams["flux"], jp.flux_cfg.hidden)
            jparams["flux"] = jax.tree.map(jnp.asarray,
                                           to_numpy_tree(tparams["flux"]))
            jparams["encoders"] = {"eeg": {"w": jnp.zeros((1,))}}
            jparams["dgf"] = {"w": jnp.zeros((1,))}
            tparams["encoders"] = {"eeg": {"w": torch.zeros(1)}}
            tparams["dgf"] = {"w": torch.zeros(1)}
        out[kind] = (dataclasses.replace(jp, params=jparams), save_pipeline(
            LoongXPipeline(c["flux_cfg"], c["vae_cfg"], tparams, torch.float32,
                           t5_cfg=c["t5_cfg"], clip_cfg=c["clip_cfg"]),
            str(root / kind)))
    return out


REFUSALS = {
    "brain_without_encoders": ("plain", ["--brain_data_path", "{pkl}"]),
    "lora_on_baked": ("baked", ["--int8", "--lora", "{tmp}/whatever"]),
    "tensor_on_baked": ("baked", ["--int8", "--neural_only", "--tensor", "2"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_main_refusals_match_jax(checkpoints, tmp_path, capsys, monkeypatch,
                                 case):
    kind, extra = REFUSALS[case]
    in_dir, names = _images(tmp_path, 1)
    pkl = tmp_path / "brain.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({names[0]: _signals(1)}, f)
    extra = [a.format(pkl=pkl, tmp=tmp_path) for a in extra]
    jpipe, ckpt = checkpoints[kind]
    monkeypatch.setattr(JPipeline, "from_pretrained",
                        staticmethod(lambda path, **kw: jpipe))
    errors = []
    for pkg, mod in (("jax", jinfer), ("port", tinfer)):
        argv = ["--checkpoint", ckpt, "--single_image",
                os.path.join(in_dir, names[0]), "--prompt", "",
                "--output_dir", str(tmp_path / pkg), "--steps", "1",
                "--target_size", str(SIZE)] + extra
        if pkg == "port":
            argv += ["--device", "cpu"]
        with pytest.raises(SystemExit) as exc:
            mod.main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1], errors


@pytest.mark.parametrize("argv, message", [
    # the id the case had while --tensor > 1 was refused outright
    pytest.param(["--tensor", "2"], "torchrun --nproc-per-node N",
                 id="argv0-ROADMAP.md Queue 1, Multi-GPU"),
    (["--device", "cuda"], "no CUDA device is available"),
])
def test_main_port_refusals(checkpoints, tmp_path, capsys, monkeypatch, argv,
                            message):
    """--tensor 2 in a process that is the only rank names the torchrun
    launch; a missing GPU is an error (``torch.cuda.is_available`` faked
    off where a card is present)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    in_dir, names = _images(tmp_path, 1)
    base = ["--checkpoint", checkpoints["plain"][1], "--single_image",
            os.path.join(in_dir, names[0]), "--prompt", ""]
    if "--device" not in argv:
        base += ["--device", "cpu"]
    with pytest.raises(SystemExit):
        tinfer.main(base + argv)
    assert message in capsys.readouterr().err


def test_main_serves_baked_checkpoint(checkpoints, tmp_path, monkeypatch):
    """--int8 on a checkpoint converted with --quantize --serving: the
    serving transforms leave the baked layout as it is, and the brain edit
    runs end to end, writing a PNG."""
    loaded = {}
    real = LoongXPipeline.from_pretrained

    def spy(path, **kw):
        loaded["pipe"] = pipe = real(path, **kw)
        jd, pd = pipe.flux_cfg.joint_dim, pipe.flux_cfg.pooled_dim
        monkeypatch.setattr(tgen, "brain_encode", lambda *a, **k: (
            torch.full((1, 8, jd), 0.1), torch.full((1, pd), 0.2)))
        return pipe

    monkeypatch.setattr(LoongXPipeline, "from_pretrained", staticmethod(spy))
    in_dir, names = _images(tmp_path, 1)
    pkl = tmp_path / "brain.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({names[0]: _signals(1)}, f)
    tinfer.main(["--checkpoint", checkpoints["baked"][1],
                 "--components", "flux,vae,encoders,dgf", "--int8",
                 "--single_image", os.path.join(in_dir, names[0]),
                 "--prompt", "", "--neural_only", "--brain_data_path",
                 str(pkl), "--output_dir", str(tmp_path / "out"), "--steps",
                 "1", "--target_size", str(SIZE), "--device", "cpu"])
    out = _read(tmp_path / "out" / names[0])
    assert out.shape == (SIZE, SIZE, 3)
    p = loaded["pipe"]
    assert "t5" not in p.params and "clip" not in p.params
    dbl = p.params["flux"]["double_blocks"]["attn"]
    assert "to_qkv" in dbl and "to_q" not in dbl
    assert "proj_out_mlp" in p.params["flux"]["single_blocks"]


# ---------------------------------------------------------------------------
# LoRA attachment, staged text, chunked decode
# ---------------------------------------------------------------------------


@pytest.fixture()
def lora_files(pipes, tmp_path):
    """A LoRA with nonzero B factors saved by the JAX package, and the same
    factors of the first double block's to_q in the reference (peft)
    layout."""
    from safetensors.numpy import save_file

    from loongx_tpu.utils.checkpoint import save_lora_safetensors
    from loongx_tpu_torch.train.lora import _walk_linears, add_lora

    _, tp = pipes
    gen = torch.Generator().manual_seed(1)
    tree = add_lora(tp.params["flux"], r=2, alpha=2, dtype=torch.float32,
                    generator=gen)
    for _, leaf in _walk_linears(tree):
        if "lora_b" in leaf:
            leaf["lora_b"] = 0.3 * torch.randn(leaf["lora_b"].shape,
                                               generator=gen)
    ours = save_lora_safetensors(
        jax.tree.map(jnp.asarray, to_numpy_tree(tree)), str(tmp_path / "lora"))
    to_q = tree["double_blocks"]["attn"]["to_q"]
    ref = str(tmp_path / "ref_lora.safetensors")
    save_file({"transformer.transformer_blocks.0.attn.to_q.lora_A.weight":
               to_q["lora_a"][0].T.contiguous().numpy(),
               "transformer.transformer_blocks.0.attn.to_q.lora_B.weight":
               to_q["lora_b"][0].T.contiguous().numpy()}, ref)
    return ours, ref


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree) if not torch.is_tensor(tree)
            else tree.numpy()}


@pytest.mark.parametrize("mode", ["merge", "int8_live", "named", "reference"])
def test_attach_lora_matches_jax(pipes, lora_files, mode):
    """--lora: a bare path merges into float weights (merge_lora, 1e-6),
    stays live deltas on an int8 base, name=path registers a deactivated
    adapter; a reference-layout file converts.  Leaf by leaf as JAX's."""
    jp, tp = pipes
    ours, ref = lora_files
    path, name = {"merge": (ours, None), "int8_live": (ours, None),
                  "named": (ours, "subject"), "reference": (ref, None)}[mode]
    if mode == "int8_live":  # the port's int8 tree on both sides
        tp.quantize(fuse_qkv=False)
        jp.params["flux"] = jax.tree.map(jnp.asarray,
                                         to_numpy_tree(tp.params["flux"]))
    jinfer._attach_lora(jp, path, name)
    tinfer._attach_lora(tp, path, name)
    want, got = _flat(jp.params["flux"]), _flat(tp.params["flux"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    has_lora = any(k.endswith("lora_a") for k in got)
    assert has_lora == (mode in ("int8_live", "named"))
    if mode == "named":
        assert tp.adapters.names() == jp.adapters.names() == ["subject"]
        assert tp.active_adapter is None
        assert all(not v.any() for k, v in got.items()
                   if k.endswith("lora_scale"))


def test_staged_text_equals_resident(pipes, tmp_path, monkeypatch):
    """--staged_text (prompts encoded up front by a text-only pipeline,
    chunk 2) gives the resident fuse run's images bit for bit (groups of
    3)."""
    from loongx_tpu_torch.models.fusion import init_duan

    jp, tp = pipes
    _fake_brain(jp, tp, monkeypatch)
    gen = torch.Generator().manual_seed(7)
    tp.params["dgf"] = {
        "duan_prompt": init_duan(8, generator=gen, device="cpu"),
        "duan_pooled": init_duan(1, generator=gen, device="cpu"),
    }
    in_dir, names = _images(tmp_path, 3)
    brain = {n: _signals(i) for i, n in enumerate(names)}
    captions = {n: f"edit {n}" for n in names}
    tinfer.batch_edit(tp, Args(in_dir, tmp_path / "resident", fuse=True,
                               batch_size=3), brain, captions)
    text_pipe = dataclasses.replace(
        tp, params={k: tp.params[k] for k in ("t5", "clip")})
    monkeypatch.setattr(LoongXPipeline, "from_pretrained",
                        staticmethod(lambda path, **kw: text_pipe))
    embeds = tinfer.staged_text_encode("unused", names, captions, None,
                                       chunk=2, device="cpu")
    assert set(embeds) == set(names)
    dit_pipe = dataclasses.replace(
        tp, params={k: v for k, v in tp.params.items()
                    if k not in ("t5", "clip")},
        t5_tokenizer=None, clip_tokenizer=None)
    tinfer.batch_edit(dit_pipe, Args(in_dir, tmp_path / "staged", fuse=True,
                                     batch_size=3), brain, captions,
                      text_embeds=embeds)
    for n in names:
        np.testing.assert_array_equal(_read(tmp_path / "staged" / n),
                                      _read(tmp_path / "resident" / n))


def test_decode_chunk_equals_unchunked(pipes, tmp_path):
    """--decode_chunk 1 equals the default decode of the whole group of 3."""
    _, tp = pipes
    in_dir, names = _images(tmp_path, 3)
    for tag, chunk in (("whole", None), ("chunked", 1)):
        tinfer.batch_edit(tp, Args(in_dir, tmp_path / tag, batch_size=3,
                                   decode_chunk=chunk), {}, {})
    for n in names:
        np.testing.assert_array_equal(_read(tmp_path / "chunked" / n),
                                      _read(tmp_path / "whole" / n))


def test_vae_decode_is_batch_invariant(pipes):
    """vae_decode of a batch of 3 equals each image decoded alone, bit for
    bit: it decodes one image a pass."""
    _, tp = pipes
    cfg = tp.vae_cfg
    gen = torch.Generator().manual_seed(4)
    lat = torch.randn(3, 2, 2, cfg.latent_channels, generator=gen)
    from loongx_tpu_torch.models.flux.vae import vae_decode

    whole = vae_decode(tp.params["vae"], cfg, lat)
    for i in range(3):
        assert torch.equal(whole[i:i + 1],
                           vae_decode(tp.params["vae"], cfg, lat[i:i + 1]))


# ---------------------------------------------------------------------------
# convert -> infer
# ---------------------------------------------------------------------------


def test_convert_then_infer(tmp_path, monkeypatch, capsys):
    """cli.convert.main on tiny synthetic diffusers / HF safetensors dirs
    (--quantize --serving --init-encoders), then cli.infer.main --int8 on
    its output: the baked layout is kept and the edit writes its PNGs."""
    from benchmarks import convert_rehearsal as synth
    from loongx_tpu_torch.cli import convert as tconvert
    from loongx_tpu_torch.models import pipeline as tpipeline

    flux, vae = FluxConfig.tiny(), VAEConfig.tiny()
    t5, clip = T5Config.tiny(), CLIPTextConfig.tiny()
    for cls, name, cfg in ((FluxConfig, "flux_dev", flux),
                           (VAEConfig, "flux", vae), (T5Config, "xxl", t5),
                           (CLIPTextConfig, "large", clip)):
        monkeypatch.setattr(cls, name, staticmethod(lambda cfg=cfg: cfg))
    src = {k: str(tmp_path / k) for k in ("flux", "vae", "t5", "clip")}
    synth.synth_flux(src["flux"], flux.num_double_blocks,
                     flux.num_single_blocks, h=flux.hidden,
                     mlp=flux.mlp_ratio * flux.hidden, joint=flux.joint_dim,
                     pooled=flux.pooled_dim, in_ch=flux.in_channels,
                     hd=flux.head_dim)
    synth.synth_vae(src["vae"], vae.block_channels, vae.layers_per_block,
                    vae.latent_channels)
    synth.synth_t5(src["t5"], t5.num_layers, d=t5.d_model,
                   inner=t5.num_heads * t5.d_kv, ff=t5.d_ff,
                   vocab=t5.vocab_size, heads=t5.num_heads)
    synth.synth_clip(src["clip"], clip.num_layers, h=clip.hidden,
                     ff=clip.d_ff, vocab=clip.vocab_size,
                     pos=clip.max_positions)
    # stand-ins for the full-size CS3 encoders and DGF (their encode is
    # faked below)
    monkeypatch.setattr(tpipeline, "_brain_params", lambda kw: {
        "encoders": {k: {"w": torch.zeros(1)} for k in ("eeg", "fnirs")},
        "dgf": {"w": torch.zeros(1)}})
    out = str(tmp_path / "converted")
    tconvert.main(["--flux", src["flux"], "--vae", src["vae"], "--t5",
                   src["t5"], "--clip", src["clip"], "--out", out,
                   "--quantize", "--serving", "--init-encoders", "--dtype",
                   "float32", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(out, "params"))) == [
        f"{c}.safetensors" for c in
        ("clip", "dgf", "encoders", "flux", "t5", "vae")]

    def fake(enc, dgf, eeg, ppg, fnirs, motion, s4_mode="conv"):
        return (torch.full((eeg.shape[0], 8, flux.joint_dim), 0.1),
                torch.full((fnirs.shape[0], flux.pooled_dim), 0.2))

    monkeypatch.setattr(tgen, "brain_encode", fake)
    in_dir, names = _images(tmp_path, 2)
    pkl = tmp_path / "brain.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({n: _signals(i) for i, n in enumerate(names)}, f)
    tinfer.main(["--checkpoint", out, "--components",
                 "flux,vae,encoders,dgf", "--int8", "--input_dir", in_dir,
                 "--output_dir", str(tmp_path / "edited"), "--neural_only",
                 "--brain_data_path", str(pkl), "--steps", "1",
                 "--target_size", str(SIZE), "--batch_size", "2", "--timing",
                 "--device", "cpu"])
    # --timing: the group's stages from the program's spans (the brain
    # encode is faked above, so it has none), then the run's p50
    printed = capsys.readouterr().out
    groups = [ln for ln in printed.splitlines()
              if ln.startswith("[infer] group of 2: ")]
    assert len(groups) == 1, printed
    assert "device ms: VAE encode " in groups[0]
    assert "denoise " in groups[0] and "/step x 1, VAE decode " in groups[0]
    assert "queue wait " in groups[0] and "brain encode" not in groups[0]
    assert "[infer] wall-clock per-image p50 " in printed
    for n in names:
        img = _read(tmp_path / "edited" / n)
        assert img.shape == (SIZE, SIZE, 3)
