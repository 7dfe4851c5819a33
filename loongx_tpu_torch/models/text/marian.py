"""MarianMT translation, zh -> en instructions (counterpart of
``loongx_tpu/models/text/marian.py``).

A post-LN encoder-decoder with static sinusoidal positions, tied embeddings
and the final-logits bias, plus a fixed-buffer greedy decoder that re-runs
the decoder over the buffer each step (translations are tens of tokens).
Weights come from Hugging Face safetensors
(`utils.convert.convert_marian_state`).  Products are plain PyTorch
matmuls in float32 over the stored values, with the attention in the JAX
package's order (as in `models.text.whisper`); Marian reaches no TPU
kernel there.

With ``scale_embedding`` the embeddings are multiplied by a float32
sqrt(d_model), which makes every activation after them float32 also for a
bf16 tree (NumPy scalars are strongly typed in JAX's promotion); the port
does the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from loongx_tpu_torch.ops.nn import (
    Params, init_layer_norm, init_linear, linear, normal, qdot, stack_trees,
)
from loongx_tpu_torch.models.text.whisper import _attention, _layer, _ln


@dataclasses.dataclass(frozen=True)
class MarianConfig:
    vocab_size: int = 65001
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    d_ff: int = 2048
    max_positions: int = 512
    decoder_start_token_id: int = 65000  # = pad for opus-mt
    pad_token_id: int = 65000
    eos_token_id: int = 0
    activation: str = "swish"  # opus-mt checkpoints; HF default is gelu
    scale_embedding: bool = True
    layer_norm_eps: float = 1e-5

    @staticmethod
    def opus_mt() -> "MarianConfig":
        return MarianConfig()

    @staticmethod
    def tiny() -> "MarianConfig":
        return MarianConfig(
            vocab_size=99, d_model=32, encoder_layers=2, decoder_layers=2,
            num_heads=4, d_ff=64, max_positions=64, decoder_start_token_id=98,
            pad_token_id=98, eos_token_id=0,
        )

    @staticmethod
    def from_hf(cfg: dict) -> "MarianConfig":
        return MarianConfig(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            num_heads=cfg["encoder_attention_heads"],
            d_ff=cfg["encoder_ffn_dim"],
            max_positions=cfg["max_position_embeddings"],
            decoder_start_token_id=cfg["decoder_start_token_id"],
            pad_token_id=cfg["pad_token_id"],
            eos_token_id=cfg["eos_token_id"],
            activation=cfg.get("activation_function", "swish"),
            scale_embedding=cfg.get("scale_embedding", True),
        )


def sinusoid_positions_marian(length: int, d: int) -> np.ndarray:
    """Marian/fairseq sinusoids: interleaved-by-half [sin(0..d/2) | cos]."""
    pos = np.arange(length)[:, None]
    inv = np.exp(np.arange(0, d, 2) * -(np.log(10000.0) / d))
    out = np.zeros((length, d), np.float32)
    out[:, 0 : d // 2] = np.sin(pos * inv)
    out[:, d // 2 :] = np.cos(pos * inv)
    return out


def _init_attn(d: int, kw) -> Params:
    return {n: init_linear(d, d, **kw) for n in ("q", "k", "v", "o")}


def _init_enc_block(cfg: MarianConfig, kw) -> Params:
    d, norm = cfg.d_model, dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "attn": _init_attn(d, kw),
        "ln_attn": init_layer_norm(d, **norm),
        "fc1": init_linear(d, cfg.d_ff, **kw),
        "fc2": init_linear(cfg.d_ff, d, **kw),
        "ln_ff": init_layer_norm(d, **norm),
    }


def _init_dec_block(cfg: MarianConfig, kw) -> Params:
    d, norm = cfg.d_model, dict(dtype=kw["dtype"], device=kw["device"])
    return {
        "self_attn": _init_attn(d, kw),
        "ln_self": init_layer_norm(d, **norm),
        "cross_attn": _init_attn(d, kw),
        "ln_cross": init_layer_norm(d, **norm),
        "fc1": init_linear(d, cfg.d_ff, **kw),
        "fc2": init_linear(cfg.d_ff, d, **kw),
        "ln_ff": init_layer_norm(d, **norm),
    }


def init_marian_params(cfg: MarianConfig, *, generator=None,
                       dtype=torch.float32, device="cuda") -> Params:
    """Random params in the JAX package's layout and distributions
    (N(0, 0.02^2) embedding, nn.Linear-style uniform linears, the static
    sinusoids, a zero float32 logits bias)."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    embed = normal((cfg.vocab_size, cfg.d_model), generator=generator,
                   device=device)
    return {
        "embed": (embed * 0.02).to(dtype),
        "pos": torch.from_numpy(sinusoid_positions_marian(
            cfg.max_positions, cfg.d_model)).to(device=device, dtype=dtype),
        "enc_blocks": stack_trees([_init_enc_block(cfg, kw)
                                   for _ in range(cfg.encoder_layers)]),
        "dec_blocks": stack_trees([_init_dec_block(cfg, kw)
                                   for _ in range(cfg.decoder_layers)]),
        "logits_bias": torch.zeros(cfg.vocab_size, dtype=torch.float32,
                                   device=device),
    }


def _act(cfg: MarianConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation in ("swish", "silu"):
        return F.silu(x)
    return F.gelu(x)


def _ffn(cfg: MarianConfig, blk: Params, x: torch.Tensor) -> torch.Tensor:
    h = _act(cfg, qdot(blk["fc1"], x) + blk["fc1"]["bias"].float()
             ).to(x.dtype)
    return linear(blk["fc2"], h)


def _embed(params: Params, cfg: MarianConfig, ids: torch.Tensor
           ) -> torch.Tensor:
    x = params["embed"][ids]
    if cfg.scale_embedding:
        x = x.float() * float(np.sqrt(cfg.d_model).astype(np.float32))
    return x + params["pos"][None, : ids.shape[1]]


def _mask_bias(mask, device):
    """A [B, S] attention mask -> additive bias [B, 1, 1, S] (0 or -inf)."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask, device=device)
    return torch.where(mask[:, None, None, :] > 0, 0.0, -torch.inf)


def marian_encode(params: Params, cfg: MarianConfig,
                  input_ids: torch.Tensor,
                  attention_mask: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """input_ids [B, S] -> encoder states [B, S, d_model] (post-LN)."""
    device = params["embed"].device
    x = _embed(params, cfg, torch.as_tensor(input_ids, device=device).long())
    eps = cfg.layer_norm_eps
    bias = _mask_bias(attention_mask, device)
    for i in range(cfg.encoder_layers):
        blk = _layer(params["enc_blocks"], i)
        x = _ln(blk["ln_attn"],
                x + _attention(blk["attn"], x, x, cfg.num_heads, bias), eps)
        x = _ln(blk["ln_ff"], x + _ffn(cfg, blk, x), eps)
    return x


def marian_decode_logits(params: Params, cfg: MarianConfig,
                         enc_out: torch.Tensor, token_ids: torch.Tensor,
                         enc_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Teacher-forced decoder: token_ids [B, T] -> logits [B, T, vocab]."""
    device = params["embed"].device
    token_ids = torch.as_tensor(token_ids, device=device).long()
    t = token_ids.shape[1]
    x = _embed(params, cfg, token_ids)
    eps = cfg.layer_norm_eps
    causal = torch.where(
        torch.tril(torch.ones(t, t, dtype=torch.bool, device=device)),
        0.0, -torch.inf)[None, None]
    cross_bias = _mask_bias(enc_mask, device)
    for i in range(cfg.decoder_layers):
        blk = _layer(params["dec_blocks"], i)
        x = _ln(blk["ln_self"], x + _attention(
            blk["self_attn"], x, x, cfg.num_heads, causal), eps)
        x = _ln(blk["ln_cross"], x + _attention(
            blk["cross_attn"], x, enc_out, cfg.num_heads, cross_bias), eps)
        x = _ln(blk["ln_ff"], x + _ffn(cfg, blk, x), eps)
    return (torch.matmul(x.float(), params["embed"].float().T)
            + params["logits_bias"].float())


def marian_greedy_decode(params: Params, cfg: MarianConfig,
                         input_ids: torch.Tensor,
                         attention_mask: torch.Tensor | None = None,
                         max_new_tokens: int = 64) -> torch.Tensor:
    """Greedy translation: source ids [B, S] -> target ids
    [B, 1 + max_new_tokens] (int64) starting with decoder_start,
    pad-filled.  Pad is masked at every step (opus-mt configs ship
    bad_words_ids=[[pad]]); a finished row emits pad, as HF generate's
    pad_token_id fill.  The loop stops once every row has emitted eos."""
    enc_out = marian_encode(params, cfg, input_ids, attention_mask)
    device = enc_out.device
    b = enc_out.shape[0]
    buf = torch.full((b, 1 + max_new_tokens), cfg.pad_token_id,
                     dtype=torch.long, device=device)
    buf[:, 0] = cfg.decoder_start_token_id
    done = torch.zeros(b, dtype=torch.bool, device=device)
    for pos in range(1, buf.shape[1]):
        row = marian_decode_logits(params, cfg, enc_out, buf,
                                   attention_mask)[:, pos - 1]
        row[:, cfg.pad_token_id] = -torch.inf
        nxt = torch.where(done, cfg.pad_token_id, row.argmax(-1))
        done = done | (nxt == cfg.eos_token_id)
        buf[:, pos] = nxt
        if bool(done.all()):  # the rest of the buffer is pad already
            break
    return buf


class MarianTranslator:
    """text -> text against a local Hugging Face opus-mt checkout, on the
    params' device."""

    def __init__(self, params: Params, cfg: MarianConfig, tokenizer):
        self.params, self.cfg, self.tokenizer = params, cfg, tokenizer
        self.device = params["embed"].device

    @staticmethod
    def from_pretrained(path: str, dtype=torch.bfloat16,
                        device="cuda") -> "MarianTranslator":
        import json
        import os

        from transformers import MarianTokenizer

        from loongx_tpu_torch.utils.convert import (
            convert_marian_state, load_torch_or_safetensors_dir,
        )

        with open(os.path.join(path, "config.json")) as f:
            cfg = MarianConfig.from_hf(json.load(f))
        params = convert_marian_state(
            load_torch_or_safetensors_dir(path), cfg, dtype=dtype,
            device=device)
        return MarianTranslator(
            params, cfg, MarianTokenizer.from_pretrained(path))

    def translate(self, text: str, max_new_tokens: int = 64) -> str:
        # the JAX package buckets the source length (one compiled shape per
        # 16 tokens); the same padding keeps the ids equal to its
        enc = self.tokenizer(
            [text], return_tensors="np", padding=True, pad_to_multiple_of=16)
        out = marian_greedy_decode(
            self.params, self.cfg,
            torch.as_tensor(np.asarray(enc["input_ids"]), device=self.device),
            torch.as_tensor(np.asarray(enc["attention_mask"]),
                            device=self.device),
            max_new_tokens).cpu().numpy()
        return self.tokenizer.decode(out[0], skip_special_tokens=True).strip()
