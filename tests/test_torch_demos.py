"""The port's speech and web demos (``loongx_tpu_torch/cli/speech_demo.py``,
``web_demo.py``, ``gradio_app.py``) against the JAX package's, on the CPU.

The tiny pipeline of both packages (the port's ``LoongXPipeline.tiny``
weights bridged to JAX, as tests/test_torch_infer_cli.py builds them), a
character tokenizer, 16x16 images, 2 Euler steps; JAX's random draws handed
to the port where an image is compared (uint8 within 1).  Also: the audio
reader on every WAV width, the transcriber's dispatch (local checkouts to
the port's Whisper / Marian, other paths to the ``whisper`` package), the
serving knobs reaching ``generate``, the HTTP surface, the gradio
hand-over, and the package's lazy top-level names.  No test needs a card:
every entry point is called with ``--device cpu``.
"""

import base64
import dataclasses
import importlib
import io
import json
import os
import sys
import types
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from loongx_tpu.cli import gradio_app as jgradio
from loongx_tpu.cli import speech_demo as jspeech
from loongx_tpu.cli import web_demo as jweb
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import marian as jmarian
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu.models.text import whisper as jwhisper
from loongx_tpu_torch.cli import gradio_app as tgradio
from loongx_tpu_torch.cli import infer as tinfer
from loongx_tpu_torch.cli import speech_demo as tspeech
from loongx_tpu_torch.cli import web_demo as tweb
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.models.text import marian as tmarian
from loongx_tpu_torch.models.text import whisper as twhisper
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

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


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline): the same tiny weights and tokenizers."""
    tp = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    for p in ("t5", "clip"):
        setattr(tp, f"{p}_tokenizer",
                FakeTokenizer(getattr(tp, f"{p}_cfg").vocab_size))
    tp.max_sequence_length = 8
    c = {k: getattr(mod, cls)(**dataclasses.asdict(getattr(tp, k)))
         for k, (mod, cls) in JCFGS.items()}
    jp = JPipeline(params=jax.tree.map(jnp.asarray, to_numpy_tree(tp.params)),
                   dtype=jnp.float32, max_sequence_length=8,
                   t5_tokenizer=tp.t5_tokenizer,
                   clip_tokenizer=tp.clip_tokenizer, **c)
    return jp, tp


def _draws(jp, seed):
    """The latents and condition VAE-sample noise JAX's generate draws from
    ``seed`` for one subject-conditioned image."""
    k_lat, k_enc = jax.random.split(jax.random.key(seed))
    lat, c = SIZE // jp.vae_cfg.downscale, jp.flux_cfg.in_channels
    latents = np.array(jax.random.normal(
        k_lat, (1, lat // 2, lat // 2, c), jnp.float32)).reshape(1, -1, c)
    noise = np.array(jax.random.normal(
        k_enc, (1, lat, lat, jp.vae_cfg.latent_channels), jnp.float32))
    return dict(latents=torch.from_numpy(latents),
                cond_noise=torch.from_numpy(noise))


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8))


@pytest.fixture()
def png(tmp_path):
    path = str(tmp_path / "input.png")
    _image(0, SIZE, SIZE).save(path)
    return path


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


def _write_wav(path, width, channels=1, rate=16000, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, n * width * channels, dtype=np.uint8)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(frames.tobytes())


@pytest.mark.parametrize("width, channels, rate", [
    (1, 1, 16000), (2, 1, 16000), (3, 1, 16000), (4, 1, 16000),
    (2, 2, 16000), (2, 1, 8000)],
    ids=["u8", "s16", "s24", "s32", "stereo", "resampled"])
def test_read_audio_equals_jax(tmp_path, width, channels, rate):
    path = str(tmp_path / "a.wav")
    _write_wav(path, width, channels, rate)
    want = jspeech._read_audio(path)
    got = tspeech._read_audio(path)
    assert got.dtype == want.dtype == np.float32 and got.ndim == 1
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The speech demo
# ---------------------------------------------------------------------------


def test_speech_demo_main_headless(pipes, png, tmp_path):
    """main with an injected transcriber and pipeline: the transcript is
    the instruction, and the PNG written is the direct `edit_one`'s."""
    _, tp = pipes
    out = str(tmp_path / "edited.png")
    calls = []

    def transcriber(audio_path):
        calls.append(audio_path)
        return "turn the sky red"

    prompt = tspeech.main(
        ["--image", png, "--audio", "/nonexistent.wav", "--output", out,
         "--target_size", str(SIZE), "--steps", str(STEPS), "--device", "cpu"],
        pipeline=tp, transcriber=transcriber)
    assert calls == ["/nonexistent.wav"] and prompt == "turn the sky red"
    got = np.asarray(Image.open(out))
    want = tinfer.edit_one(tp, png, prompt, target_size=SIZE, num_steps=STEPS,
                           knobs=tinfer.serving_knobs())
    assert got.shape == (SIZE, SIZE, 3) and np.array_equal(got, want)


def test_speech_demo_fallback_prompt(pipes, png, tmp_path):
    _, tp = pipes
    out = str(tmp_path / "edited2.png")

    def broken(audio_path):
        raise RuntimeError("no ASR model")

    argv = ["--image", png, "--audio", "/nonexistent.wav", "--output", out,
            "--target_size", str(SIZE), "--steps", str(STEPS), "--device",
            "cpu"]
    prompt = tspeech.main(argv + ["--prompt", "use the fallback"],
                          pipeline=tp, transcriber=broken)
    assert prompt == "use the fallback" and os.path.exists(out)
    with pytest.raises(RuntimeError, match="no ASR"):
        tspeech.main(argv, pipeline=tp, transcriber=broken)


def test_speech_demo_knobs_reach_generate(pipes, png, tmp_path, monkeypatch):
    """LOONGX_W8A8=1 is read once in main and reaches generate() as
    ``w8a8=True`` (the port reads no environment inside the model)."""
    _, tp = pipes
    seen = []

    def fake_generate(pipeline, **kw):
        seen.append(kw)
        return np.zeros((1, SIZE, SIZE, 3), np.uint8)

    monkeypatch.setattr(tgen, "generate", fake_generate)
    monkeypatch.setenv("LOONGX_W8A8", "1")
    tspeech.main(["--image", png, "--audio", "a.wav", "--output",
                  str(tmp_path / "o.png"), "--target_size", str(SIZE),
                  "--device", "cpu"],
                 pipeline=tp, transcriber=lambda a: "make it blue")
    assert len(seen) == 1 and seen[0]["prompt"] == "make it blue"
    assert {k: seen[0][k] for k in tinfer.KNOBS} == {
        "w8a8": True, "int8_attn": False, "fuse_ln": False,
        "fuse_gate": False}
    assert seen[0]["num_inference_steps"] == 28


def test_speech_demo_refuses_cuda_without_card(png, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tspeech.main(["--image", png, "--checkpoint", "ck"])


def _whisper_dir(tmp_path):
    """A tiny Hugging Face Whisper checkout with a synthetic tokenizer."""
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    cfg = jwhisper.WhisperConfig.tiny()
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(HFWhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins,
        d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.num_heads,
        decoder_attention_heads=cfg.num_heads, encoder_ffn_dim=cfg.d_ff,
        decoder_ffn_dim=cfg.d_ff,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        decoder_start_token_id=cfg.decoder_start_token_id, pad_token_id=0,
        eos_token_id=cfg.eos_token_id)).eval()
    d = str(tmp_path / "whisper")
    model.save_pretrained(d, safe_serialization=True)
    vocab = {chr(97 + i): i for i in range(26)}
    for i, s in enumerate(["<|endoftext|>", "<|startoftranscript|>", "<|zh|>",
                           "<|en|>", "<|transcribe|>", "<|translate|>",
                           "<|notimestamps|>"]):
        vocab[s] = 26 + i
    with open(f"{d}/vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(f"{d}/merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    with open(f"{d}/tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "WhisperTokenizer"}, f)
    return d


class _MarianTok:
    def __init__(self, cfg):
        self.cfg = cfg

    def __call__(self, texts, return_tensors="np", padding=True,
                 pad_to_multiple_of=None):
        ids = [ord(c) % 90 + 1 for c in texts[0][:12]] + [self.cfg.eos_token_id]
        mask = [1] * len(ids)
        while pad_to_multiple_of and len(ids) % pad_to_multiple_of:
            ids.append(self.cfg.pad_token_id)
            mask.append(0)
        return {"input_ids": np.asarray([ids]),
                "attention_mask": np.asarray([mask])}

    def decode(self, ids, skip_special_tokens=True):
        skip = (self.cfg.pad_token_id, self.cfg.eos_token_id)
        return " ".join(f"w{int(i)}" for i in ids if int(i) not in skip)


def test_transcribe_local_dirs_equal_jax(tmp_path, monkeypatch):
    """Local checkouts go to the port's WhisperASR and MarianTranslator on
    the device asked for, and give JAX's text (float32 on both sides)."""
    wav = str(tmp_path / "said.wav")
    _write_wav(wav, 2, n=8000)
    wdir = _whisper_dir(tmp_path)
    mdir = tmp_path / "marian"
    mdir.mkdir()
    (mdir / "config.json").write_text("{}")
    # transcribe translates up to 64 tokens: positions for 1 + 64
    mcfg = dataclasses.replace(jmarian.MarianConfig.tiny(), max_positions=80)
    mjp = jmarian.init_marian_params(jax.random.key(3), mcfg, jnp.float32)
    mtp = from_numpy_tree(jax.tree.map(np.asarray, mjp), "cpu")
    loads = []

    def port_asr(path, dtype=None, device="cuda"):
        loads.append(("whisper", path, device))
        return real_asr(path, dtype=torch.float32, device=device)

    def port_mt(path, dtype=None, device="cuda"):
        loads.append(("marian", path, device))
        return tmarian.MarianTranslator(mtp, mcfg, _MarianTok(mcfg))

    real_asr = twhisper.WhisperASR.from_pretrained
    real_jasr = jwhisper.WhisperASR.from_pretrained
    monkeypatch.setattr(twhisper.WhisperASR, "from_pretrained",
                        staticmethod(port_asr))
    monkeypatch.setattr(tmarian.MarianTranslator, "from_pretrained",
                        staticmethod(port_mt))
    monkeypatch.setattr(jwhisper.WhisperASR, "from_pretrained", staticmethod(
        lambda path, dtype=None: real_jasr(path, dtype=jnp.float32)))
    monkeypatch.setattr(jmarian.MarianTranslator, "from_pretrained",
                        staticmethod(lambda path, dtype=None:
                                     jmarian.MarianTranslator(
                                         mjp, mcfg, _MarianTok(mcfg))))
    for translate in (None, str(mdir)):
        got = tspeech.transcribe(wav, wdir, translate, device="cpu")
        want = jspeech.transcribe(wav, wdir, translate)
        assert isinstance(got, str) and got == want
    assert loads == [("whisper", wdir, "cpu"), ("whisper", wdir, "cpu"),
                     ("marian", str(mdir), "cpu")]
    # English audio is not translated
    assert tspeech.transcribe(wav, wdir, str(mdir), language="en",
                              device="cpu") == tspeech.transcribe(
        wav, wdir, None, language="en", device="cpu")
    assert [k for k, _, _ in loads[3:]] == ["whisper", "whisper"]


def test_transcribe_other_paths_use_whisper_package(tmp_path, monkeypatch):
    """A path that is not a local checkout goes to the ``whisper`` package
    with its short model name, as in the JAX package."""
    names = []

    class Model:
        def transcribe(self, path, language):
            return {"text": f" heard {os.path.basename(path)} in {language} "}

    fake = types.ModuleType("whisper")
    fake.load_model = lambda name: names.append(name) or Model()
    monkeypatch.setitem(sys.modules, "whisper", fake)
    got = tspeech.transcribe("x.wav", "openai/whisper-large", None)
    assert got == jspeech.transcribe("x.wav", "openai/whisper-large", None)
    assert got == "heard x.wav in zh" and names == ["large", "large"]


# ---------------------------------------------------------------------------
# The web and gradio demos
# ---------------------------------------------------------------------------


def test_process_image_and_text_equals_jax(pipes):
    """A non-square image (the centre crop), the same draws: JAX's uint8
    image within 1."""
    jp, tp = pipes
    img = _image(1, 24, SIZE)
    want = np.asarray(jgradio.process_image_and_text(
        jp, img, " a chair ", num_steps=STEPS, size=SIZE, seed=7))
    got = tgradio.process_image_and_text(tp, img, " a chair ", num_steps=STEPS,
                                         size=SIZE, **_draws(jp, 7))
    assert isinstance(got, Image.Image) and got.size == (SIZE, SIZE)
    got = np.asarray(got)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _post(url, body: bytes):
    return urllib.request.Request(url, data=body,
                                  headers={"Content-Type": "application/json"})


def _png_b64(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture()
def serve():
    """Start a server on a free port in a thread; shut it down after."""
    servers = []

    def start(editor):
        server = tweb.build_server(editor, port=0, num_steps=STEPS)
        servers.append(server)
        thread = tweb.serve_forever_in_thread(server)
        return f"http://127.0.0.1:{server.server_address[1]}", thread

    yield start
    for server in servers:
        server.shutdown()
        server.server_close()


def test_web_demo_http_roundtrip(pipes, serve):
    """Health, the page, /edit through the real tiny pipeline (its PNG the
    direct call's, bit for bit), 400 on a malformed body."""
    _, tp = pipes
    kw = _draws(pipes[0], 3)

    def editor(image, text):
        return tgradio.process_image_and_text(tp, image, text,
                                              num_steps=STEPS, size=SIZE, **kw)

    base, thread = serve(editor)
    assert thread.is_alive()
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        assert json.load(r) == {"status": "ok"}
    with urllib.request.urlopen(base + "/", timeout=30) as r:
        page = r.read()
        assert b"LoongX" in page and f"({STEPS} steps)".encode() in page
    img = _image(2, 24, SIZE)
    body = json.dumps({"image_b64": _png_b64(img), "text": "a chair"}).encode()
    with urllib.request.urlopen(_post(base + "/edit", body), timeout=300) as r:
        resp = json.load(r)
    out = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        resp["image_b64"]))))
    assert out.shape == (SIZE, SIZE, 3) and resp["elapsed_s"] >= 0
    assert np.array_equal(out, np.asarray(editor(img, "a chair")))
    for bad in (b"{}", b"not json", json.dumps({"image_b64": "!!"}).encode()):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(_post(base + "/edit", bad), timeout=30)
        assert err.value.code == 400 and "error" in json.load(err.value)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(_post(base + "/nowhere", body), timeout=30)
    assert err.value.code == 404


def test_web_demo_editor_failure_is_500(serve):
    def editor(image, text):
        raise RuntimeError("out of memory")

    base, _ = serve(editor)
    body = json.dumps({"image_b64": _png_b64(_image(3, SIZE, SIZE)),
                       "text": "x"}).encode()
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(_post(base + "/edit", body), timeout=30)
    assert err.value.code == 500
    assert json.load(err.value) == {"error": "RuntimeError: out of memory"}


def test_web_demo_main_wires_knobs(monkeypatch):
    """main --tiny-random --device cpu: the tiny pipeline on zero embeds of
    its widths, the serving knobs from the environment, the editor handed
    to build_server."""
    built, seen = [], []

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

    monkeypatch.setattr(tweb, "build_server", lambda editor, port, num_steps:
                        built.append((editor, port, num_steps)) or Server())
    monkeypatch.setattr(tgradio, "process_image_and_text",
                        lambda pipeline, image, text, **kw: seen.append(
                            (pipeline, text, kw)))
    monkeypatch.setenv("LOONGX_FUSE_GATE", "1")
    tweb.main(["--tiny-random", "--device", "cpu", "--port", "0",
               "--steps", "3"])
    (editor, port, steps), = built
    assert (port, steps) == (0, 3)
    editor(_image(4, SIZE, SIZE), "ignored")
    (pipeline, text, kw), = seen
    assert text == "" and kw["size"] == 32 and kw["num_steps"] == 3
    assert kw["fuse_gate"] and not kw["w8a8"]
    assert kw["prompt_embeds"].shape == (1, 8, pipeline.flux_cfg.joint_dim)
    assert kw["pooled_prompt_embeds"].shape == (1, pipeline.flux_cfg.pooled_dim)
    assert kw["prompt_embeds"].device.type == "cpu"


def test_gradio_main_hands_over_without_gradio(monkeypatch):
    """Without gradio both packages' gradio_app.main serve the stdlib demo
    with their flags (the port's with --device)."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    argv = {}
    monkeypatch.setattr(tweb, "main", lambda a: argv.setdefault("port", a))
    monkeypatch.setattr(jweb, "main", lambda a: argv.setdefault("jax", a))
    tgradio.main(["--checkpoint", "ck", "--steps", "4", "--device", "cpu"])
    jgradio.main(["--checkpoint", "ck", "--steps", "4"])
    assert argv["port"] == argv["jax"] + ["--device", "cpu"]
    assert argv["jax"] == ["--checkpoint", "ck", "--steps", "4", "--port",
                           "7860"]


def test_lazy_top_level_names():
    """The JAX package's top-level surface: __version__, Config,
    load_config, and LoongXPipeline / generate / Condition resolved on first
    use."""
    import loongx_tpu
    import loongx_tpu_torch
    from loongx_tpu_torch.config import Config, load_config
    from loongx_tpu_torch.models.pipeline import LoongXPipeline as P
    from loongx_tpu_torch.sampling.condition import Condition
    from loongx_tpu_torch.sampling.generate import generate

    assert loongx_tpu_torch.__version__ == loongx_tpu.__version__
    assert (loongx_tpu_torch.Config, loongx_tpu_torch.load_config) == (
        Config, load_config)
    assert loongx_tpu_torch.LoongXPipeline is P
    assert loongx_tpu_torch.generate is generate
    assert loongx_tpu_torch.Condition is Condition
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        loongx_tpu_torch.nope
