"""The port's speech models against the JAX package on CPU: the Whisper
frontend (the mel filters bit for bit, the log-mel features and the audio
preparation within 1e-5 in float32 at the published geometry), the
Whisper encoder, decoder logits and cached decoder pass at ``tiny()`` in
float32 (ATOL 2e-4, as tests/test_speech_models.py), both greedy decoders'
buffers equal to JAX's token for token (with and without the suppress
lists), Marian's encoder, logits and greedy buffer, both converters leaf
for leaf on one tiny Hugging Face state, and the two wrappers
(``WhisperASR.from_pretrained`` on a synthesized local checkout,
``MarianTranslator.translate`` with an injected tokenizer) giving JAX's
text.  Weights cross by `from_numpy_tree`; inputs are numpy from a seed."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loongx_tpu.models.text import marian as jmarian
from loongx_tpu.models.text import whisper as jwhisper
from loongx_tpu.utils import convert as jconvert
from loongx_tpu_torch.models.text import marian as tmarian
from loongx_tpu_torch.models.text import whisper as twhisper
from loongx_tpu_torch.utils import convert as tconvert
from loongx_tpu_torch.utils.bridge import from_numpy_tree

ATOL = 2e-4
FRONTEND_ATOL = 1e-5


def _bridge(params):
    return from_numpy_tree(jax.tree.map(np.asarray, params), "cpu")


def _close(got, want, atol=ATOL, label=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err < atol, f"{label}: max abs err {err:.2e} >= {atol}"


def _feats(seed, cfg, b):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.num_mel_bins, cfg.n_frames)).astype(
        np.float32)


@pytest.fixture(scope="module")
def whisper():
    """(JAX params, port params, cfg) at tiny geometry in float32."""
    cfg = jwhisper.WhisperConfig.tiny()
    jp = jwhisper.init_whisper_params(jax.random.key(0), cfg, jnp.float32)
    return jp, _bridge(jp), cfg


@pytest.fixture(scope="module")
def marian():
    cfg = jmarian.MarianConfig.tiny()
    jp = jmarian.init_marian_params(jax.random.key(1), cfg, jnp.float32)
    # a non-zero logits bias exercises its float32 add
    jp["logits_bias"] = jax.random.normal(jax.random.key(2),
                                          (cfg.vocab_size,)) * 0.1
    return jp, _bridge(jp), cfg


def test_configs_match():
    for j, t in ((jwhisper.WhisperConfig, twhisper.WhisperConfig),
                 (jmarian.MarianConfig, tmarian.MarianConfig)):
        names = (("large", "tiny") if j is jwhisper.WhisperConfig
                 else ("opus_mt", "tiny"))
        for name in names:
            assert vars(getattr(j, name)()) == vars(getattr(t, name)())
    w = jwhisper.WhisperConfig.large()
    assert (w.n_frames, w.n_samples) == (
        twhisper.WhisperConfig.large().n_frames,
        twhisper.WhisperConfig.large().n_samples)


@pytest.mark.parametrize("geometry", ["large", "tiny"])
def test_mel_filter_bank_exact(geometry):
    cfg = getattr(jwhisper.WhisperConfig, geometry)()
    args = (cfg.n_fft // 2 + 1, cfg.num_mel_bins, cfg.sampling_rate,
            cfg.sampling_rate / 2.0)
    want = jwhisper.mel_filter_bank(*args)
    got = twhisper.mel_filter_bank(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seconds", [3.0, 31.0])
def test_log_mel_and_prepare_audio(seconds):
    """The published frontend: exactly n_frames frames (not torch.stft's
    one more), a periodic window, the max - 8 floor; audio longer than
    30 s is truncated."""
    cfg = jwhisper.WhisperConfig.large()
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(seconds * cfg.sampling_rate))
             * 0.1).astype(np.float32)
    jprep = jwhisper.prepare_audio(audio, cfg)
    tprep = twhisper.prepare_audio(audio, cfg)
    assert tprep.shape == (1, cfg.n_samples) and np.array_equal(tprep, jprep)
    filters = jwhisper.mel_filter_bank(cfg.n_fft // 2 + 1, cfg.num_mel_bins,
                                       cfg.sampling_rate, 8000.0)
    want = jwhisper.log_mel_spectrogram(jnp.asarray(jprep), cfg,
                                        jnp.asarray(filters))
    got = twhisper.log_mel_spectrogram(torch.from_numpy(tprep), cfg,
                                       torch.from_numpy(filters))
    assert got.shape == (1, cfg.num_mel_bins, cfg.n_frames)
    _close(got, want, FRONTEND_ATOL, "log-mel")


def test_whisper_encoder(whisper):
    jp, tp, cfg = whisper
    feats = _feats(1, cfg, 2)
    want = jwhisper.whisper_encode(jp, cfg, jnp.asarray(feats))
    got = twhisper.whisper_encode(tp, cfg, torch.from_numpy(feats))
    _close(got, want, label="whisper encoder")


def test_whisper_decoder_logits_and_cached_pass(whisper):
    """Teacher-forced logits, then the cached pass run as a prefill of 3
    tokens and two single-token steps: each pass's logits and the caches
    it wrote against JAX's."""
    jp, tp, cfg = whisper
    feats = _feats(2, cfg, 2)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    jenc = jwhisper.whisper_encode(jp, cfg, jnp.asarray(feats))
    tenc = twhisper.whisper_encode(tp, cfg, torch.from_numpy(feats))
    _close(twhisper.whisper_decode_logits(tp, cfg, tenc, torch.from_numpy(ids)),
           jwhisper.whisper_decode_logits(jp, cfg, jenc, jnp.asarray(ids)),
           label="whisper logits")

    jck, jcv = jwhisper.whisper_cross_kv(jp, cfg, jenc)
    tck, tcv = twhisper.whisper_cross_kv(tp, cfg, tenc)
    _close(tck, jck, label="cross k")
    _close(tcv, jcv, label="cross v")
    total, dh = 6, cfg.d_model // cfg.num_heads
    shape = (cfg.decoder_layers, 2, cfg.num_heads, total, dh)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    for offset, t in ((0, 3), (3, 1), (4, 1)):
        chunk = ids[:, offset:offset + t]
        jl, jk, jv = jwhisper._cached_decoder_pass(
            jp, cfg, jnp.asarray(chunk, jnp.int32), jnp.int32(offset), jk, jv,
            jck, jcv)
        tl, tk, tv = twhisper._cached_decoder_pass(
            tp, cfg, torch.from_numpy(chunk), offset, tk, tv, tck, tcv)
        _close(tl, jl, label=f"cached pass at {offset}")
        _close(tk, jk, label=f"self k at {offset}")
        _close(tv, jv, label=f"self v at {offset}")


def _suppress_cases(cfg):
    return {
        "plain": {},
        "suppress": dict(suppress_ids=np.asarray([3, 4], np.int32),
                         begin_suppress_ids=np.asarray([cfg.eos_token_id],
                                                       np.int32)),
    }


@pytest.mark.parametrize("case", ["plain", "suppress"])
def test_whisper_greedy_buffers_equal_jax(whisper, case):
    """Both decoders against JAX's, token for token, at batch 2 with a
    3-token prompt, and against each other."""
    jp, tp, cfg = whisper
    feats = _feats(7, cfg, 2)
    prompt = np.asarray([[cfg.decoder_start_token_id, 5, 9]] * 2, np.int32)
    kw = _suppress_cases(cfg)[case]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    want = np.asarray(jwhisper.whisper_greedy_decode(
        jp, cfg, jnp.asarray(feats), jnp.asarray(prompt), 8, **jkw))
    for fn in (twhisper.whisper_greedy_decode,
               twhisper.whisper_greedy_decode_cached):
        got = fn(tp, cfg, torch.from_numpy(feats), torch.from_numpy(prompt),
                 8, **tkw).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)
    if case == "suppress":
        assert not np.isin(want[:, 3:], [3, 4]).any()


def test_whisper_suppress_semantics(whisper):
    """The baseline's first generated token, suppressed everywhere, never
    appears; suppressed at the first position only, the first token
    changes; both equal JAX's buffers."""
    jp, tp, cfg = whisper
    feats = _feats(7, cfg, 1)
    prompt = np.asarray([[cfg.decoder_start_token_id]], np.int32)
    base = twhisper.whisper_greedy_decode_cached(
        tp, cfg, torch.from_numpy(feats), torch.from_numpy(prompt), 6)[0]
    t0 = int(base[1])
    assert t0 != cfg.eos_token_id
    ids = np.asarray([t0], np.int32)
    for key in ("suppress_ids", "begin_suppress_ids"):
        want = np.asarray(jwhisper.whisper_greedy_decode_cached(
            jp, cfg, jnp.asarray(feats), jnp.asarray(prompt), 6,
            **{key: jnp.asarray(ids)}))
        got = twhisper.whisper_greedy_decode_cached(
            tp, cfg, torch.from_numpy(feats), torch.from_numpy(prompt), 6,
            **{key: torch.from_numpy(ids)}).numpy()
        np.testing.assert_array_equal(got, want)
        assert int(got[0, 1]) != t0
        if key == "suppress_ids":
            assert t0 not in got[0, 1:].tolist()


def test_whisper_init_layout_matches_jax(whisper):
    """The port's init: the JAX tree's leaves, shapes and dtypes, the
    encoder sinusoids equal."""
    jp, _, cfg = whisper
    tp = twhisper.init_whisper_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [(jax.tree_util.keystr(p), np.shape(v)) for p, v in jflat] == [
        (jax.tree_util.keystr(p), v.shape) for p, v in tflat]
    np.testing.assert_array_equal(tp["enc_pos"].numpy(),
                                  np.asarray(jp["enc_pos"]))


def _marian_src(seed, cfg):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, cfg.vocab_size - 1, size=(2, 9))
    mask = np.ones_like(src)
    mask[1, 6:] = 0
    src[1, 6:] = cfg.pad_token_id
    return src, mask


def test_marian_encoder_and_logits(marian):
    jp, tp, cfg = marian
    src, mask = _marian_src(4, cfg)
    tgt = np.random.default_rng(5).integers(0, cfg.vocab_size - 1, (2, 5))
    jenc = jmarian.marian_encode(jp, cfg, jnp.asarray(src), jnp.asarray(mask))
    tenc = tmarian.marian_encode(tp, cfg, torch.from_numpy(src),
                                 torch.from_numpy(mask))
    _close(tenc, jenc, label="marian encoder")
    want = jmarian.marian_decode_logits(jp, cfg, jenc, jnp.asarray(tgt),
                                        jnp.asarray(mask))
    got = tmarian.marian_decode_logits(tp, cfg, tenc, torch.from_numpy(tgt),
                                       torch.from_numpy(mask))
    _close(got, want, label="marian logits")


@pytest.mark.parametrize("activation", ["swish", "gelu"])
def test_marian_greedy_equal_jax(marian, activation):
    jp, tp, cfg = marian
    cfg = dataclasses.replace(cfg, activation=activation)
    src, mask = _marian_src(6, cfg)
    want = np.asarray(jmarian.marian_greedy_decode(
        jp, cfg, jnp.asarray(src), jnp.asarray(mask), 8))
    got = tmarian.marian_greedy_decode(tp, cfg, torch.from_numpy(src),
                                       torch.from_numpy(mask), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_marian_pad_never_emitted(marian):
    """Relabelling the baseline's first generated token as pad removes it
    from the decode (pad only as fill after eos), as in JAX."""
    jp, tp, cfg = marian
    src = np.random.default_rng(8).integers(0, cfg.vocab_size - 1, (1, 8))
    mask = np.ones_like(src)
    base = tmarian.marian_greedy_decode(tp, cfg, torch.from_numpy(src),
                                        torch.from_numpy(mask), 6)[0]
    t0 = int(base[1])
    assert t0 != cfg.eos_token_id
    cfg2 = dataclasses.replace(cfg, pad_token_id=t0)
    got = tmarian.marian_greedy_decode(tp, cfg2, torch.from_numpy(src),
                                       torch.from_numpy(mask), 6).numpy()
    want = np.asarray(jmarian.marian_greedy_decode(
        jp, cfg2, jnp.asarray(src), jnp.asarray(mask), 6))
    np.testing.assert_array_equal(got, want)
    gen = got[0, 1:].tolist()
    if cfg2.eos_token_id in gen:
        gen = gen[: gen.index(cfg2.eos_token_id)]
    assert t0 not in gen


# ---------------------------------------------------------------------------
# Converters and the Hugging Face wrappers
# ---------------------------------------------------------------------------


def _hf_whisper(cfg, seed=0):
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    hf_cfg = HFWhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins,
        d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
        decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.num_heads,
        decoder_attention_heads=cfg.num_heads,
        encoder_ffn_dim=cfg.d_ff, decoder_ffn_dim=cfg.d_ff,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions,
        decoder_start_token_id=cfg.decoder_start_token_id,
        pad_token_id=0, eos_token_id=cfg.eos_token_id,
    )
    torch.manual_seed(seed)
    return WhisperForConditionalGeneration(hf_cfg).eval()


def _hf_marian(cfg, seed=0):
    from transformers import MarianConfig as HFMarianConfig
    from transformers import MarianMTModel

    hf_cfg = HFMarianConfig(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.num_heads,
        decoder_attention_heads=cfg.num_heads,
        encoder_ffn_dim=cfg.d_ff, decoder_ffn_dim=cfg.d_ff,
        max_position_embeddings=cfg.max_positions,
        decoder_start_token_id=cfg.decoder_start_token_id,
        pad_token_id=cfg.pad_token_id, eos_token_id=cfg.eos_token_id,
        activation_function="silu", scale_embedding=cfg.scale_embedding,
    )
    torch.manual_seed(seed)
    model = MarianMTModel(hf_cfg).eval()
    with torch.no_grad():  # a non-zero bias shows it is read from the full state
        model.final_logits_bias.normal_()
    return model


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert g.shape == w.shape, path
    assert str(got.dtype).split(".")[-1] == w.dtype.name, path
    np.testing.assert_array_equal(g, w.astype(np.float32) if
                                  w.dtype.name == "bfloat16" else w,
                                  err_msg=path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["whisper", "marian"])
def test_converters_equal_jax(model, dtype):
    """One tiny Hugging Face state through both packages' converters: the
    same leaves, shapes, dtypes and values (the conv kernels transposed to
    HIO, Marian's final_logits_bias from outside the "model." prefix)."""
    if model == "whisper":
        cfg = jwhisper.WhisperConfig.tiny()
        hf = _hf_whisper(cfg)
        jfn, tfn = jconvert.convert_whisper_state, tconvert.convert_whisper_state
    else:
        cfg = jmarian.MarianConfig.tiny()
        hf = _hf_marian(cfg)
        jfn, tfn = jconvert.convert_marian_state, tconvert.convert_marian_state
    state = hf.state_dict()
    want = jfn({k: v.numpy() for k, v in state.items()}, cfg,
               dtype=getattr(jnp, dtype))
    got = tfn(state, cfg, dtype=getattr(torch, dtype), device="cpu")
    _assert_trees_equal(got, want)
    if model == "marian":
        assert got["logits_bias"].abs().max() > 0


def _write_whisper_dir(tmp_path):
    """A tiny Hugging Face Whisper checkout: save_pretrained, a synthetic
    GPT2-style tokenizer and a generation config with suppress lists."""
    cfg = jwhisper.WhisperConfig.tiny()
    d = str(tmp_path / "whisper")
    _hf_whisper(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(97 + i): i for i in range(26)}
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|zh|>", "<|en|>",
                "<|transcribe|>", "<|translate|>", "<|notimestamps|>"]
    for i, s in enumerate(specials):
        vocab[s] = 26 + i
    with open(f"{d}/vocab.json", "w") as f:
        json.dump(vocab, f)
    with open(f"{d}/merges.txt", "w") as f:
        f.write("#version: 0.2\n")
    with open(f"{d}/tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "WhisperTokenizer"}, f)
    with open(f"{d}/generation_config.json", "w") as f:
        json.dump({"suppress_tokens": [4, 5],
                   "begin_suppress_tokens": [cfg.eos_token_id]}, f)
    return d, cfg


def test_whisper_asr_from_pretrained_equals_jax(tmp_path):
    d, cfg = _write_whisper_dir(tmp_path)
    jasr = jwhisper.WhisperASR.from_pretrained(d, dtype=jnp.float32)
    tasr = twhisper.WhisperASR.from_pretrained(d, dtype=torch.float32,
                                               device="cpu")
    assert tasr.suppress_tokens == [4, 5] and tasr.cfg == twhisper.WhisperConfig(
        **vars(jasr.cfg))
    np.testing.assert_array_equal(tasr._prompt_ids("zh", "transcribe"),
                                  jasr._prompt_ids("zh", "transcribe"))
    audio = (np.random.default_rng(7).standard_normal(cfg.n_samples // 2)
             ).astype(np.float32)
    for use_cache in (True, False):
        want = jasr.transcribe(audio, max_new_tokens=6, use_cache=use_cache)
        got = tasr.transcribe(audio, max_new_tokens=6, use_cache=use_cache)
        assert isinstance(got, str) and got == want


class _MarianTok:
    """MarianTokenizer's call and decode interface on ids from characters
    (MarianTokenizer itself needs sentencepiece model files)."""

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
        skip = (self.cfg.pad_token_id, self.cfg.eos_token_id,
                self.cfg.decoder_start_token_id)
        return " ".join(f"w{int(i)}" for i in ids if int(i) not in skip)


def test_marian_translator_equals_jax(marian):
    jp, tp, cfg = marian
    tok = _MarianTok(cfg)
    want = jmarian.MarianTranslator(jp, cfg, tok).translate(
        "把天空变成红色", max_new_tokens=8)
    got = tmarian.MarianTranslator(tp, cfg, tok).translate(
        "把天空变成红色", max_new_tokens=8)
    assert isinstance(got, str) and got == want and got


def test_bridge_carries_speech_trees(whisper, marian):
    """`from_numpy_tree` knows every leaf of both trees (enc_pos, dec_pos,
    pos, logits_bias among them)."""
    for jp, tp in (whisper[:2], marian[:2]):
        _assert_trees_equal(tp, jax.tree.map(np.asarray, jp))
