"""Whisper ASR, the speech-instruction path (counterpart of
``loongx_tpu/models/text/whisper.py``).

The log-mel frontend, the conv-downsampled audio encoder and two greedy
decoders, on parameter trees in the JAX package's layout (block params
stacked ``[L, ...]``, linears ``[in, out]``, the convolutions HIO
``[3, in, out]``).  Weights come from Hugging Face safetensors
(`utils.convert.convert_whisper_state`).

Every product is a plain PyTorch matmul in float32 over the stored values
(the JAX package's ``preferred_element_type=float32``): Whisper reaches no
TPU kernel there, so none is ported.  Attention keeps JAX's order (q
pre-scaled by head_dim^-0.5, float32 logits, the softmax's probabilities
cast to v's dtype before the PV product, the output cast to x's dtype), not
SDPA's, so that the two decoders stay token-for-token equal:

  * `whisper_greedy_decode`: KV-free, each step re-runs the decoder over the
    fixed-length token buffer;
  * `whisper_greedy_decode_cached` (the serving path): cross-attention K/V
    computed once per utterance, the self-attention K/V in a preallocated
    ``[L, B, H, total, Dh]`` cache written in place at each step's offset,
    so a step runs one token; the loop stops once every row has emitted
    eos (the buffer is eos-filled beyond).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, layer_norm, linear, normal, qdot,
    stack_trees,
)


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    d_ff: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258  # <|startoftranscript|>
    eos_token_id: int = 50257
    layer_norm_eps: float = 1e-5
    # frontend (HF WhisperFeatureExtractor defaults)
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160

    @staticmethod
    def large() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def tiny() -> "WhisperConfig":
        return WhisperConfig(
            vocab_size=100, num_mel_bins=8, d_model=32, encoder_layers=2,
            decoder_layers=2, num_heads=4, d_ff=64, max_source_positions=24,
            max_target_positions=16, decoder_start_token_id=1, eos_token_id=2,
        )

    @staticmethod
    def from_hf(cfg: dict) -> "WhisperConfig":
        return WhisperConfig(
            vocab_size=cfg["vocab_size"],
            num_mel_bins=cfg["num_mel_bins"],
            d_model=cfg["d_model"],
            encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            num_heads=cfg["encoder_attention_heads"],
            d_ff=cfg["encoder_ffn_dim"],
            max_source_positions=cfg["max_source_positions"],
            max_target_positions=cfg["max_target_positions"],
            decoder_start_token_id=cfg["decoder_start_token_id"],
            eos_token_id=cfg["eos_token_id"],
        )

    @property
    def n_frames(self) -> int:
        # the stride-2 conv halves frames onto the encoder positions
        # (2*1500 frames = 30 s at hop 160 for the published models)
        return 2 * self.max_source_positions

    @property
    def n_samples(self) -> int:
        return self.n_frames * self.hop_length


# ---------------------------------------------------------------------------
# Log-mel frontend (HF WhisperFeatureExtractor numerics)
# ---------------------------------------------------------------------------


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    mels = 3.0 * freq / 200.0
    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = 27.0 / np.log(6.4)
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) * logstep,
        mels,
    )


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    freq = 200.0 * mels / 3.0
    min_log_hz, min_log_mel = 1000.0, 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)),
        freq,
    )


def mel_filter_bank(
    n_freqs: int, n_mels: int, sampling_rate: int, max_frequency: float
) -> np.ndarray:
    """Slaney-scale, slaney-normalised triangular filters [n_freqs, n_mels]
    (what WhisperFeatureExtractor builds for its mel projection)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.asarray(0.0)),
        _hz_to_mel_slaney(np.asarray(max_frequency)),
        n_mels + 2,
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    slopes = hz_pts[None, :] - fft_freqs[:, None]  # [F, n_mels+2]
    diffs = hz_pts[1:] - hz_pts[:-1]
    down = -slopes[:, :-2] / diffs[:-1]
    up = slopes[:, 2:] / diffs[1:]
    weights = np.maximum(0.0, np.minimum(down, up))
    weights *= (2.0 / (hz_pts[2:] - hz_pts[:-2]))[None, :]  # slaney norm
    return weights.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, cfg: WhisperConfig,
                        mel_filters: torch.Tensor) -> torch.Tensor:
    """Padded/truncated mono audio [B, n_samples] -> log-mel features
    [B, num_mel_bins, n_frames] matching WhisperFeatureExtractor: a reflect
    pad of n_fft/2, exactly ``n_frames`` frames at the hop (``torch.stft``
    with ``center=True`` would give one more), a periodic Hann window, the
    power spectrum in float32, the slaney mel, log10, a floor at max - 8,
    then (x + 4) / 4."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    x = F.pad(audio.float()[:, None], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)[:, : cfg.n_frames]  # [B, F, n_fft]
    n = torch.arange(n_fft, dtype=torch.float32, device=x.device)
    window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)  # periodic
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    mel = torch.matmul(power, mel_filters.float()).transpose(1, 2)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def prepare_audio(audio: np.ndarray, cfg: WhisperConfig) -> np.ndarray:
    """Raw mono waveform -> fixed 30 s [1, n_samples] float32."""
    audio = np.asarray(audio, np.float32).reshape(-1)[: cfg.n_samples]
    out = np.zeros((1, cfg.n_samples), np.float32)
    out[0, : audio.shape[0]] = audio
    return out


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _init_attn(d: int, kw) -> Params:
    return {
        "q": init_linear(d, d, **kw),
        "k": init_linear(d, d, bias=False, **kw),
        "v": init_linear(d, d, **kw),
        "o": init_linear(d, d, **kw),
    }


def _init_enc_block(cfg: WhisperConfig, kw) -> Params:
    d, norm = cfg.d_model, dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "ln_attn": init_layer_norm(d, **norm),
        "attn": _init_attn(d, kw),
        "ln_ff": init_layer_norm(d, **norm),
        "fc1": init_linear(d, cfg.d_ff, **kw),
        "fc2": init_linear(cfg.d_ff, d, **kw),
    }


def _init_dec_block(cfg: WhisperConfig, kw) -> Params:
    d, norm = cfg.d_model, dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "ln_self": init_layer_norm(d, **norm),
        "self_attn": _init_attn(d, kw),
        "ln_cross": init_layer_norm(d, **norm),
        "cross_attn": _init_attn(d, kw),
        "ln_ff": init_layer_norm(d, **norm),
        "fc1": init_linear(d, cfg.d_ff, **kw),
        "fc2": init_linear(cfg.d_ff, d, **kw),
    }


def _sinusoid_positions(length: int, d: int) -> np.ndarray:
    """Whisper encoder sinusoids: [sin | cos] split halves."""
    log_timescale = np.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def init_whisper_params(cfg: WhisperConfig, *, generator=None,
                        dtype=torch.float32, device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions
    (nn.Linear-style uniform linears, N(0, 0.02^2) conv kernels and token
    embedding, N(0, 0.01^2) decoder positions, the encoder's sinusoids)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d = cfg.d_model
    enc = [_init_enc_block(cfg, kw) for _ in range(cfg.encoder_layers)]
    dec = [_init_dec_block(cfg, kw) for _ in range(cfg.decoder_layers)]

    def scaled_normal(shape, std):
        return (normal(shape, generator=generator, device=device) * std
                ).to(dtype)

    return {
        "conv1": {"kernel": scaled_normal((3, cfg.num_mel_bins, d), 0.02),
                  "bias": torch.zeros(d, dtype=dtype, device=device)},
        "conv2": {"kernel": scaled_normal((3, d, d), 0.02),
                  "bias": torch.zeros(d, dtype=dtype, device=device)},
        "enc_pos": torch.from_numpy(_sinusoid_positions(
            cfg.max_source_positions, d)).to(device=device, dtype=dtype),
        "enc_blocks": stack_trees(enc),
        "enc_ln": init_layer_norm(d, dtype=dtype, device=device),
        "embed": scaled_normal((cfg.vocab_size, d), 0.02),
        "dec_pos": scaled_normal((cfg.max_target_positions, d), 0.01),
        "dec_blocks": stack_trees(dec),
        "dec_ln": init_layer_norm(d, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(blocks: Params, i: int) -> Params:
    """Block ``i`` of a stacked block tree."""
    if isinstance(blocks, dict):
        return {k: _layer(v, i) for k, v in blocks.items()}
    return blocks[i]


def _heads(y: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = y.shape
    return y.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = o.shape
    return o.transpose(1, 2).reshape(b, s, h * dh)


def _attend(q, k, v, bias, out_dtype) -> torch.Tensor:
    """float32 logits (+ bias), softmax, probabilities in v's dtype, the PV
    product in float32 cast to ``out_dtype``; heads merged."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return _merge_heads(torch.matmul(probs.float(), v.float()).to(out_dtype))


def _attention(attn: Params, x_q: torch.Tensor, x_kv: torch.Tensor,
               num_heads: int, bias: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Pre-scaled-q attention (HF Whisper convention: q *= head_dim^-0.5)."""
    scale = (x_q.shape[-1] // num_heads) ** -0.5
    q = _heads(linear(attn["q"], x_q), num_heads) * scale
    k = _heads(linear(attn["k"], x_kv), num_heads)
    v = _heads(linear(attn["v"], x_kv), num_heads)
    return linear(attn["o"], _attend(q, k, v, bias, x_q.dtype))


def _mlp(blk: Params, h: torch.Tensor) -> torch.Tensor:
    y = F.gelu(qdot(blk["fc1"], h) + blk["fc1"]["bias"].float()).to(h.dtype)
    return linear(blk["fc2"], y)


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layer_norm(x, p["weight"], p["bias"], eps)


def _conv(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Conv1d of x [B, C, T] with an HIO kernel [3, in, out], explicit
    (1, 1) padding (torch ``padding=1``; "SAME" would split the stride-2
    conv's pad differently), float32 products cast back, then the bias."""
    w = p["kernel"].float().permute(2, 1, 0)  # [out, in, 3]
    y = F.conv1d(x.float(), w, stride=stride, padding=1).to(x.dtype)
    return y + p["bias"][:, None]


def whisper_encode(params: Params, cfg: WhisperConfig,
                   features: torch.Tensor) -> torch.Tensor:
    """Log-mel features [B, num_mel_bins, n_frames] -> encoder states
    [B, max_source_positions, d_model]."""
    x = features.to(params["conv1"]["kernel"].device,
                    params["conv1"]["kernel"].dtype)
    x = F.gelu(_conv(params["conv1"], x, 1))
    x = F.gelu(_conv(params["conv2"], x, 2)).to(params["enc_pos"].dtype)
    x = x.transpose(1, 2) + params["enc_pos"][None, : x.shape[2]]
    eps = cfg.layer_norm_eps
    for i in range(cfg.encoder_layers):
        blk = _layer(params["enc_blocks"], i)
        h = _ln(blk["ln_attn"], x, eps)
        x = x + _attention(blk["attn"], h, h, cfg.num_heads)
        x = x + _mlp(blk, _ln(blk["ln_ff"], x, eps))
    return _ln(params["enc_ln"], x, eps)


def _vocab_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final hidden states against the tied embedding, in float32."""
    return torch.matmul(x.float(), params["embed"].float().T)


def whisper_decode_logits(params: Params, cfg: WhisperConfig,
                          enc_out: torch.Tensor, token_ids: torch.Tensor
                          ) -> torch.Tensor:
    """Teacher-forced decoder: token_ids [B, T] -> logits [B, T, vocab]."""
    device = params["embed"].device
    token_ids = token_ids.to(device).long()
    t = token_ids.shape[1]
    x = params["embed"][token_ids] + params["dec_pos"][None, :t]
    eps = cfg.layer_norm_eps
    causal = torch.where(
        torch.tril(torch.ones(t, t, dtype=torch.bool, device=device)),
        0.0, -torch.inf)[None, None]
    for i in range(cfg.decoder_layers):
        blk = _layer(params["dec_blocks"], i)
        h = _ln(blk["ln_self"], x, eps)
        x = x + _attention(blk["self_attn"], h, h, cfg.num_heads, causal)
        x = x + _attention(blk["cross_attn"], _ln(blk["ln_cross"], x, eps),
                           enc_out, cfg.num_heads)
        x = x + _mlp(blk, _ln(blk["ln_ff"], x, eps))
    return _vocab_logits(params, _ln(params["dec_ln"], x, eps))


def _prompt_buffer(cfg: WhisperConfig, prompt_ids: torch.Tensor,
                   max_new_tokens: int, device) -> torch.Tensor:
    """The eos-filled token buffer [B, total] with the prompt in front."""
    b, p = prompt_ids.shape
    total = min(p + max_new_tokens, cfg.max_target_positions)
    buf = torch.full((b, total), cfg.eos_token_id, dtype=torch.long,
                     device=device)
    buf[:, :p] = prompt_ids.to(device).long()
    return buf


def _vocab_ids(cfg: WhisperConfig, ids, device):
    """Suppress ids as int64 on ``device``, those outside the vocabulary
    dropped, as JAX's ``.at[:, ids].set`` drops out-of-bounds indices (a
    Hugging Face default generation config lists ids past a small
    vocabulary)."""
    if ids is None:
        return None
    ids = torch.as_tensor(ids, device=device).long().reshape(-1)
    return ids[(ids >= 0) & (ids < cfg.vocab_size)]


def _pick(cfg: WhisperConfig, row: torch.Tensor, first: bool,
          done: torch.Tensor, suppress_ids, begin_suppress_ids):
    """The next token of each row: the suppress masks (``begin_suppress_ids``
    only at the first generated position), argmax, eos once a row is done.
    Returns (tokens, done)."""
    row = row.clone()
    if suppress_ids is not None:
        row[:, suppress_ids] = -torch.inf
    if first and begin_suppress_ids is not None:
        row[:, begin_suppress_ids] = -torch.inf
    nxt = row.argmax(-1)
    nxt = torch.where(done, cfg.eos_token_id, nxt)
    return nxt, done | (nxt == cfg.eos_token_id)


def whisper_greedy_decode(
    params: Params, cfg: WhisperConfig, features: torch.Tensor,
    prompt_ids: torch.Tensor, max_new_tokens: int = 64,
    suppress_ids: Optional[torch.Tensor] = None,
    begin_suppress_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Greedy transcription: features [B, mel, frames] + forced prompt
    [B, P] (<|startoftranscript|>, language, task, <|notimestamps|>) ->
    token buffer [B, P + max_new_tokens] (int64), eos-padded.

    ``suppress_ids``: token ids masked to -inf at EVERY generated position
    (HF generation_config.suppress_tokens); ``begin_suppress_ids``:
    additionally masked at the FIRST generated position only (HF
    begin_suppress_tokens).  Ids outside the vocabulary are ignored, as JAX's
    scatter drops them."""
    enc_out = whisper_encode(params, cfg, features)
    buf = _prompt_buffer(cfg, prompt_ids, max_new_tokens, enc_out.device)
    suppress_ids = _vocab_ids(cfg, suppress_ids, buf.device)
    begin_suppress_ids = _vocab_ids(cfg, begin_suppress_ids, buf.device)
    p = prompt_ids.shape[1]
    done = torch.zeros(buf.shape[0], dtype=torch.bool, device=buf.device)
    for pos in range(p, buf.shape[1]):
        row = whisper_decode_logits(params, cfg, enc_out, buf)[:, pos - 1]
        buf[:, pos], done = _pick(cfg, row, pos == p, done, suppress_ids,
                                  begin_suppress_ids)
        if bool(done.all()):  # the rest of the buffer is eos already
            break
    return buf


# ---------------------------------------------------------------------------
# KV-cached incremental greedy decoder (the serving path)
# ---------------------------------------------------------------------------


def whisper_cross_kv(params: Params, cfg: WhisperConfig,
                     enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V for every decoder layer, computed ONCE per
    utterance: enc_out [B, S_enc, d] -> (k, v) each [L, B, H, S_enc, Dh]."""
    ks, vs = [], []
    for i in range(cfg.decoder_layers):
        attn = _layer(params["dec_blocks"]["cross_attn"], i)
        ks.append(_heads(linear(attn["k"], enc_out), cfg.num_heads))
        vs.append(_heads(linear(attn["v"], enc_out), cfg.num_heads))
    return torch.stack(ks), torch.stack(vs)


def _cached_decoder_pass(
    params: Params, cfg: WhisperConfig,
    tok_ids: torch.Tensor,   # [B, T] at positions offset..offset+T-1
    offset: int,
    self_k: torch.Tensor,    # [L, B, H, total, Dh], written in place
    self_v: torch.Tensor,
    cross_k: torch.Tensor,   # [L, B, H, S_enc, Dh]
    cross_v: torch.Tensor,
):
    """Run T tokens through the decoder against the caches, writing their
    self-attention K/V at ``offset``.  Returns (logits [B, T, vocab],
    self_k, self_v).  The KV-free math: queries at global position q attend
    cache positions <= q (unwritten positions are > q, so the causal mask
    hides them too)."""
    device = params["embed"].device
    tok_ids = tok_ids.to(device).long()
    t = tok_ids.shape[1]
    nh, eps = cfg.num_heads, cfg.layer_norm_eps
    total = self_k.shape[3]
    x = params["embed"][tok_ids] + params["dec_pos"][None, offset:offset + t]
    qpos = offset + torch.arange(t, device=device)
    bias = torch.where(torch.arange(total, device=device)[None, :]
                       <= qpos[:, None], 0.0, -torch.inf)[None, None]
    scale = (cfg.d_model // nh) ** -0.5
    for i in range(cfg.decoder_layers):
        blk = _layer(params["dec_blocks"], i)
        sa = blk["self_attn"]
        h = _ln(blk["ln_self"], x, eps)
        q = _heads(linear(sa["q"], h), nh) * scale
        self_k[i, :, :, offset:offset + t] = _heads(linear(sa["k"], h), nh)
        self_v[i, :, :, offset:offset + t] = _heads(linear(sa["v"], h), nh)
        x = x + linear(sa["o"], _attend(q, self_k[i], self_v[i], bias,
                                        x.dtype))
        ca = blk["cross_attn"]
        hq = _ln(blk["ln_cross"], x, eps)
        q2 = _heads(linear(ca["q"], hq), nh) * scale
        x = x + linear(ca["o"], _attend(q2, cross_k[i], cross_v[i], None,
                                        x.dtype))
        x = x + _mlp(blk, _ln(blk["ln_ff"], x, eps))
    logits = _vocab_logits(params, _ln(params["dec_ln"], x, eps))
    return logits, self_k, self_v


def whisper_greedy_decode_cached(
    params: Params, cfg: WhisperConfig, features: torch.Tensor,
    prompt_ids: torch.Tensor, max_new_tokens: int = 64,
    suppress_ids: Optional[torch.Tensor] = None,
    begin_suppress_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`whisper_greedy_decode` semantics (the same buffer, token for token)
    with one token's work per generated token: cross K/V computed once per
    utterance, self K/V in a preallocated cache written in place."""
    enc_out = whisper_encode(params, cfg, features)
    cross_k, cross_v = whisper_cross_kv(params, cfg, enc_out)
    buf = _prompt_buffer(cfg, prompt_ids, max_new_tokens, enc_out.device)
    suppress_ids = _vocab_ids(cfg, suppress_ids, buf.device)
    begin_suppress_ids = _vocab_ids(cfg, begin_suppress_ids, buf.device)
    b, p = prompt_ids.shape
    nh, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    self_k = torch.zeros((cfg.decoder_layers, b, nh, buf.shape[1], dh),
                         dtype=params["embed"].dtype, device=buf.device)
    self_v = torch.zeros_like(self_k)
    # prefill the prompt; its last row predicts position p
    logits, _, _ = _cached_decoder_pass(params, cfg, buf[:, :p], 0, self_k,
                                        self_v, cross_k, cross_v)
    row = logits[:, -1]
    done = torch.zeros(b, dtype=torch.bool, device=buf.device)
    for pos in range(p, buf.shape[1]):
        nxt, done = _pick(cfg, row, pos == p, done, suppress_ids,
                          begin_suppress_ids)
        buf[:, pos] = nxt
        if pos + 1 == buf.shape[1] or bool(done.all()):
            break
        logits, _, _ = _cached_decoder_pass(params, cfg, nxt[:, None], pos,
                                            self_k, self_v, cross_k, cross_v)
        row = logits[:, 0]
    return buf


# ---------------------------------------------------------------------------
# Checkpoint-backed ASR wrapper (local directories only)
# ---------------------------------------------------------------------------


class WhisperASR:
    """Audio -> text against a local Hugging Face Whisper checkout
    (config.json + *.safetensors + tokenizer files), on the params'
    device."""

    def __init__(self, params: Params, cfg: WhisperConfig, tokenizer,
                 suppress_tokens=None, begin_suppress_tokens=None):
        self.params, self.cfg, self.tokenizer = params, cfg, tokenizer
        self.suppress_tokens = suppress_tokens
        self.begin_suppress_tokens = begin_suppress_tokens
        self.device = params["embed"].device
        self.mel_filters = torch.from_numpy(mel_filter_bank(
            cfg.n_fft // 2 + 1, cfg.num_mel_bins, cfg.sampling_rate,
            cfg.sampling_rate / 2.0,
        )).to(self.device)

    @staticmethod
    def from_pretrained(path: str, dtype=torch.bfloat16,
                        device="cuda") -> "WhisperASR":
        import json
        import os

        from transformers import WhisperTokenizer

        from loongx_tpu_torch.utils.convert import (
            convert_whisper_state, load_torch_or_safetensors_dir,
        )

        with open(os.path.join(path, "config.json")) as f:
            raw_cfg = json.load(f)
        cfg = WhisperConfig.from_hf(raw_cfg)
        params = convert_whisper_state(
            load_torch_or_safetensors_dir(path), cfg, dtype=dtype,
            device=device)
        # HF generate suppresses special/timestamp tokens; read the lists
        # from generation_config.json (newer checkouts) or config.json
        gen_cfg = {}
        gen_path = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                gen_cfg = json.load(f)
        suppress = gen_cfg.get("suppress_tokens",
                               raw_cfg.get("suppress_tokens"))
        begin = gen_cfg.get("begin_suppress_tokens",
                            raw_cfg.get("begin_suppress_tokens"))
        return WhisperASR(
            params, cfg, WhisperTokenizer.from_pretrained(path),
            suppress_tokens=suppress, begin_suppress_tokens=begin,
        )

    def _prompt_ids(self, language: str, task: str) -> np.ndarray:
        tok = self.tokenizer.convert_tokens_to_ids
        ids = [self.cfg.decoder_start_token_id,
               tok(f"<|{language}|>"), tok(f"<|{task}|>"),
               tok("<|notimestamps|>")]
        return np.asarray([ids], np.int32)

    def transcribe(self, audio: np.ndarray, language: str = "zh",
                   task: str = "transcribe", max_new_tokens: int = 64,
                   use_cache: bool = True) -> str:
        feats = log_mel_spectrogram(
            torch.from_numpy(prepare_audio(audio, self.cfg)).to(self.device),
            self.cfg, self.mel_filters)
        prompt = torch.from_numpy(self._prompt_ids(language, task))

        def ids(tokens):
            return torch.tensor(tokens, dtype=torch.long) if tokens else None

        decode_fn = (whisper_greedy_decode_cached if use_cache
                     else whisper_greedy_decode)
        out = decode_fn(self.params, self.cfg, feats, prompt, max_new_tokens,
                        ids(self.suppress_tokens),
                        ids(self.begin_suppress_tokens)).cpu().numpy()
        return self.tokenizer.decode(
            out[0, prompt.shape[1]:], skip_special_tokens=True).strip()
