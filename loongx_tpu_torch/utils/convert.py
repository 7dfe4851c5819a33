"""Checkpoint conversion (counterpart of ``loongx_tpu/utils/convert.py``):
the published Hugging Face / diffusers safetensors -> this package's param
trees, for the models the port has: the FLUX transformer, reference-trained
LoRA files, the VAE (AutoencoderKL), T5, the CLIP text encoder, the
evaluation towers (CLIP vision, the DINO ViT), Depth-Anything and the
speech path's Whisper and Marian.

Torch linears are [out, in] -> transposed to [in, out]; convs [O, I, kh, kw]
-> HWIO; per-block tensors are stacked onto a leading block axis.  Every
function takes a flat {key: tensor or numpy array} state dict, so it works
with any loader (`load_safetensors_dir`, ``torch.load``, synthetic dicts in
tests), and builds its tree on ``device``, moving one source tensor at a
time there before it is transposed or cast.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


def load_safetensors_dir(path: str, pattern: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of the *.safetensors files under ``path`` (names
    containing ``pattern``) in one flat dict, on the CPU."""
    from safetensors import safe_open

    files = sorted(f for f in os.listdir(path)
                   if f.endswith(".safetensors") and pattern in f)
    if not files:
        raise FileNotFoundError(f"no safetensors files in {path}")
    state: Dict[str, torch.Tensor] = {}
    for fname in files:
        with safe_open(os.path.join(path, fname), framework="pt") as f:
            state.update((k, f.get_tensor(k)) for k in f.keys())
    return state


def _tensor(x) -> torch.Tensor:
    """A state-dict value (tensor, or numpy array, bf16 as ml_dtypes) as a
    tensor on its own device."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _put(x, dtype, device, transform=None) -> torch.Tensor:
    """``x`` moved to ``device`` first, then ``transform``ed (a transpose or
    permute) and cast to ``dtype``: a contiguous tensor of its own."""
    src = _tensor(x)
    t = src.to(device)
    if transform is not None:
        t = transform(t)
    if t.dtype != dtype or not t.is_contiguous():
        return t.to(dtype).contiguous()
    shared = (t.untyped_storage().data_ptr()
              == src.untyped_storage().data_ptr())
    return t.clone() if shared else t


def _lin(state, prefix, dtype, bias=True, device="cuda"):
    p = {"kernel": _put(state[f"{prefix}.weight"], dtype, device,
                        lambda t: t.T)}
    if bias and f"{prefix}.bias" in state:
        p["bias"] = _put(state[f"{prefix}.bias"], dtype, device)
    return p


def _stack(trees: Iterable[Dict[str, Any]],
           count: Optional[int] = None) -> Dict[str, Any]:
    """Same-structured trees stacked on a new leading axis.  Each tree is
    copied into the stack as it comes, so from a generator of ``count``
    trees only one is alive beside the stack."""
    if count is None:
        trees = list(trees)
        count = len(trees)
    if not count:  # a zero-depth family (e.g. a single-block model)
        return {}

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((count,) + tuple(t.shape))

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i] = src

    out = None
    for i, tree in enumerate(trees):
        out = alloc(tree) if out is None else out
        fill(out, tree, i)
    return out


# ---------------------------------------------------------------------------
# FLUX transformer
# ---------------------------------------------------------------------------


def convert_flux_state(state: Dict[str, Any], cfg, dtype=torch.bfloat16,
                       device="cuda"):
    """diffusers FluxTransformer2DModel state dict -> flux param tree."""
    def L(prefix):
        return _lin(state, prefix, dtype, device=device)

    def norm(key):
        return {"weight": _put(state[key], dtype, device)}

    def double_block(i):
        p = f"transformer_blocks.{i}"
        return {
            "norm1": {"linear": L(f"{p}.norm1.linear")},
            "norm1_context": {"linear": L(f"{p}.norm1_context.linear")},
            "attn": {
                "to_q": L(f"{p}.attn.to_q"),
                "to_k": L(f"{p}.attn.to_k"),
                "to_v": L(f"{p}.attn.to_v"),
                "norm_q": norm(f"{p}.attn.norm_q.weight"),
                "norm_k": norm(f"{p}.attn.norm_k.weight"),
                "add_q_proj": L(f"{p}.attn.add_q_proj"),
                "add_k_proj": L(f"{p}.attn.add_k_proj"),
                "add_v_proj": L(f"{p}.attn.add_v_proj"),
                "norm_added_q": norm(f"{p}.attn.norm_added_q.weight"),
                "norm_added_k": norm(f"{p}.attn.norm_added_k.weight"),
                "to_out": L(f"{p}.attn.to_out.0"),
                "to_add_out": L(f"{p}.attn.to_add_out"),
            },
            "ff": {"in": L(f"{p}.ff.net.0.proj"), "out": L(f"{p}.ff.net.2")},
            "ff_context": {"in": L(f"{p}.ff_context.net.0.proj"),
                           "out": L(f"{p}.ff_context.net.2")},
        }

    def single_block(i):
        p = f"single_transformer_blocks.{i}"
        return {
            "norm": {"linear": L(f"{p}.norm.linear")},
            "attn": {
                "to_q": L(f"{p}.attn.to_q"),
                "to_k": L(f"{p}.attn.to_k"),
                "to_v": L(f"{p}.attn.to_v"),
                "norm_q": norm(f"{p}.attn.norm_q.weight"),
                "norm_k": norm(f"{p}.attn.norm_k.weight"),
            },
            "proj_mlp": L(f"{p}.proj_mlp"),
            "proj_out": L(f"{p}.proj_out"),
        }

    nd, ns = cfg.num_double_blocks, cfg.num_single_blocks
    params = {
        "x_embedder": L("x_embedder"),
        "context_embedder": L("context_embedder"),
        "time_in": {
            "in_layer": L("time_text_embed.timestep_embedder.linear_1"),
            "out_layer": L("time_text_embed.timestep_embedder.linear_2"),
        },
        "vector_in": {
            "in_layer": L("time_text_embed.text_embedder.linear_1"),
            "out_layer": L("time_text_embed.text_embedder.linear_2"),
        },
        "double_blocks": _stack((double_block(i) for i in range(nd)), nd),
        "single_blocks": _stack((single_block(i) for i in range(ns)), ns),
        "norm_out": {"linear": L("norm_out.linear")},
        "proj_out": L("proj_out"),
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = {
            "in_layer": L("time_text_embed.guidance_embedder.linear_1"),
            "out_layer": L("time_text_embed.guidance_embedder.linear_2"),
        }
    return params


# ---------------------------------------------------------------------------
# Reference LoRA checkpoints (peft / FluxPipeline.save_lora_weights layout)
# ---------------------------------------------------------------------------

_LORA_MODULES = {
    "attn.to_q": "attn/to_q",
    "attn.to_k": "attn/to_k",
    "attn.to_v": "attn/to_v",
    "attn.to_out.0": "attn/to_out",
    "norm1.linear": "norm1/linear",
    "norm.linear": "norm/linear",
    "ff.net.2": "ff/out",
    "proj_mlp": "proj_mlp",
    "proj_out": "proj_out",
}


def _our_lora_path(module: str):
    """'transformer_blocks.3.attn.to_q' -> ('double_blocks/attn/to_q', 3)."""
    module = module.removeprefix("transformer.")
    if module == "x_embedder":
        return "x_embedder", None
    for hf_prefix, ours in (("single_transformer_blocks", "single_blocks"),
                            ("transformer_blocks", "double_blocks")):
        if module.startswith(hf_prefix + "."):
            idx_str, sub = module[len(hf_prefix) + 1:].split(".", 1)
            sub = _LORA_MODULES.get(sub)
            if sub is None:
                return None, None
            return f"{ours}/{sub}", int(idx_str)
    return None, None


def convert_reference_lora(state: Dict[str, Any], flux_params, cfg,
                           scale: float = 1.0, dtype=torch.bfloat16):
    """Load a reference-trained LoRA (peft safetensors, as
    FluxPipeline.save_lora_weights writes them) into a copy of
    ``flux_params``: per-block lora_A [r, in] / lora_B [out, r] are
    transposed and stacked onto the block axis; blocks the file lacks get
    zero factors.  Key layouts: 'transformer.<module>.lora_A.weight',
    'base_model.model.<module>.lora_A.weight' and the adapter-named
    'lora_A.<adapter>.weight'.  Returns the new tree with LoRA leaves on
    each kernel's device."""
    from loongx_tpu_torch.train.lora import _copy_dicts, load_lora_state_dict

    grouped: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    lora_like = 0
    for key, val in state.items():
        m = re.match(r"(.*)\.lora_([AB])(?:\.[^.]+)?\.weight$", key)
        if not m:
            continue
        lora_like += 1
        path, idx = _our_lora_path(m.group(1).removeprefix("base_model.model."))
        if path is None:
            continue
        grouped.setdefault(path, {}).setdefault(
            -1 if idx is None else idx, {})[m.group(2)] = _tensor(val)
    if lora_like and not grouped:
        sample = [k for k in state if ".lora_" in k][:3]
        raise ValueError(
            f"checkpoint contains {lora_like} LoRA tensors but none map onto "
            f"a known flux module layout (sample keys: {sample}) — returning "
            "the base weights silently would serve an un-adapted model")

    params = _copy_dicts(flux_params)

    def find(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    # stacked factors per path; load_lora_state_dict does the rest (the
    # serving proj_out split, the kernel-dim checks, the scale defaults)
    flat: Dict[str, torch.Tensor] = {}
    for path, by_idx in grouped.items():
        sample = next(iter(by_idx.values()))
        r, a_rows = sample["A"].shape
        b_cols = sample["B"].shape[0]
        kernel = find(params, path)
        kernel = kernel.get("kernel", kernel.get("kernel_q"))
        if kernel.ndim == 3:  # a stacked block family
            n_blocks = kernel.shape[0]
            a = torch.zeros(n_blocks, a_rows, r)
            b = torch.zeros(n_blocks, r, b_cols)
            for idx, ab in by_idx.items():
                a[idx] = ab["A"].T
                b[idx] = ab["B"].T
            flat[f"{path}/lora_scale"] = torch.full((n_blocks,), scale,
                                                    dtype=torch.float32)
        else:
            ab = by_idx.get(-1) or next(iter(by_idx.values()))
            a, b = ab["A"].T, ab["B"].T
            flat[f"{path}/lora_scale"] = torch.tensor(scale,
                                                      dtype=torch.float32)
        flat[f"{path}/lora_a"] = a.to(dtype).contiguous()
        flat[f"{path}/lora_b"] = b.to(dtype).contiguous()
    return load_lora_state_dict(params, flat, strict_shapes=False)


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL)
# ---------------------------------------------------------------------------


def _conv(state, prefix, dtype, device="cuda"):
    w = _tensor(state[f"{prefix}.weight"])
    if w.ndim == 2:  # attention projections stored as Linear in new diffusers
        w = w[:, :, None, None]
    return {"kernel": _put(w, dtype, device, lambda t: t.permute(2, 3, 1, 0)),
            "bias": _put(state[f"{prefix}.bias"], dtype, device)}


def _gn(state, prefix, dtype, device="cuda"):
    return {"weight": _put(state[f"{prefix}.weight"], dtype, device),
            "bias": _put(state[f"{prefix}.bias"], dtype, device)}


def _resnet(state, prefix, dtype, device="cuda"):
    p = {
        "norm1": _gn(state, f"{prefix}.norm1", dtype, device),
        "conv1": _conv(state, f"{prefix}.conv1", dtype, device),
        "norm2": _gn(state, f"{prefix}.norm2", dtype, device),
        "conv2": _conv(state, f"{prefix}.conv2", dtype, device),
    }
    if f"{prefix}.conv_shortcut.weight" in state:
        p["shortcut"] = _conv(state, f"{prefix}.conv_shortcut", dtype, device)
    return p


def _vae_attn(state, prefix, dtype, device="cuda"):
    return {
        "norm": _gn(state, f"{prefix}.group_norm", dtype, device),
        "to_q": _conv(state, f"{prefix}.to_q", dtype, device),
        "to_k": _conv(state, f"{prefix}.to_k", dtype, device),
        "to_v": _conv(state, f"{prefix}.to_v", dtype, device),
        "to_out": _conv(state, f"{prefix}.to_out.0", dtype, device),
    }


def convert_vae_state(state: Dict[str, Any], cfg, dtype=torch.float32,
                      device="cuda"):
    """diffusers AutoencoderKL state dict -> vae param tree."""
    n = len(cfg.block_channels)
    kw = dict(dtype=dtype, device=device)

    def mid(side):
        return {
            "resnet_0": _resnet(state, f"{side}.mid_block.resnets.0", **kw),
            "attn": _vae_attn(state, f"{side}.mid_block.attentions.0", **kw),
            "resnet_1": _resnet(state, f"{side}.mid_block.resnets.1", **kw),
        }

    enc: Dict[str, Any] = {"conv_in": _conv(state, "encoder.conv_in", **kw)}
    for i in range(n):
        block = {f"resnet_{j}": _resnet(
            state, f"encoder.down_blocks.{i}.resnets.{j}", **kw)
            for j in range(cfg.layers_per_block)}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in state:
            block["downsample"] = _conv(
                state, f"encoder.down_blocks.{i}.downsamplers.0.conv", **kw)
        enc[f"down_{i}"] = block
    enc["mid"] = mid("encoder")
    enc["norm_out"] = _gn(state, "encoder.conv_norm_out", **kw)
    enc["conv_out"] = _conv(state, "encoder.conv_out", **kw)

    dec: Dict[str, Any] = {"conv_in": _conv(state, "decoder.conv_in", **kw)}
    dec["mid"] = mid("decoder")
    for i in range(n):
        block = {f"resnet_{j}": _resnet(
            state, f"decoder.up_blocks.{i}.resnets.{j}", **kw)
            for j in range(cfg.layers_per_block + 1)}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in state:
            block["upsample"] = _conv(
                state, f"decoder.up_blocks.{i}.upsamplers.0.conv", **kw)
        dec[f"up_{i}"] = block
    dec["norm_out"] = _gn(state, "decoder.conv_norm_out", **kw)
    dec["conv_out"] = _conv(state, "decoder.conv_out", **kw)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# T5 encoder, CLIP text encoder
# ---------------------------------------------------------------------------


def convert_t5_state(state: Dict[str, Any], cfg, dtype=torch.bfloat16,
                     device="cuda"):
    """HF T5EncoderModel state dict -> t5 param tree."""
    def L(prefix):
        return _lin(state, prefix, dtype, bias=False, device=device)

    def norm(key):
        return {"weight": _put(state[key], dtype, device)}

    def block(i):
        p = f"encoder.block.{i}"
        return {
            "ln_attn": norm(f"{p}.layer.0.layer_norm.weight"),
            "q": L(f"{p}.layer.0.SelfAttention.q"),
            "k": L(f"{p}.layer.0.SelfAttention.k"),
            "v": L(f"{p}.layer.0.SelfAttention.v"),
            "o": L(f"{p}.layer.0.SelfAttention.o"),
            "ln_ff": norm(f"{p}.layer.1.layer_norm.weight"),
            "wi_0": L(f"{p}.layer.1.DenseReluDense.wi_0"),
            "wi_1": L(f"{p}.layer.1.DenseReluDense.wi_1"),
            "wo": L(f"{p}.layer.1.DenseReluDense.wo"),
        }

    n = cfg.num_layers
    return {
        "embed": _put(state["shared.weight"], dtype, device),
        "rel_pos_bias": _put(
            state["encoder.block.0.layer.0.SelfAttention"
                  ".relative_attention_bias.weight"], dtype, device),
        "blocks": _stack((block(i) for i in range(n)), n),
        "final_ln": norm("encoder.final_layer_norm.weight"),
    }


def convert_clip_state(state: Dict[str, Any], cfg, dtype=torch.bfloat16,
                       device="cuda"):
    """HF CLIPTextModel state dict -> clip param tree."""
    kw = dict(dtype=dtype, device=device)

    def block(i):
        p = f"text_model.encoder.layers.{i}"
        return {
            "ln1": _gn(state, f"{p}.layer_norm1", **kw),
            "q": _lin(state, f"{p}.self_attn.q_proj", **kw),
            "k": _lin(state, f"{p}.self_attn.k_proj", **kw),
            "v": _lin(state, f"{p}.self_attn.v_proj", **kw),
            "o": _lin(state, f"{p}.self_attn.out_proj", **kw),
            "ln2": _gn(state, f"{p}.layer_norm2", **kw),
            "fc1": _lin(state, f"{p}.mlp.fc1", **kw),
            "fc2": _lin(state, f"{p}.mlp.fc2", **kw),
        }

    n = cfg.num_layers
    return {
        "token_embed": _put(
            state["text_model.embeddings.token_embedding.weight"], **kw),
        "pos_embed": _put(
            state["text_model.embeddings.position_embedding.weight"], **kw),
        "blocks": _stack((block(i) for i in range(n)), n),
        "final_ln": _gn(state, "text_model.final_layer_norm", **kw),
    }


def convert_clip_vision_state(state: Dict[str, Any], cfg, dtype=torch.float32,
                              device="cuda"):
    """HF CLIPVisionModel (+ visual_projection) state dict -> clip_vision
    param tree.  The patch conv [out, 3, p, p] becomes a flattened-patch
    linear with (y, x, c)-major rows (see models/text/clip_vision._patches).
    """
    kw = dict(dtype=dtype, device=device)

    def block(i):
        p = f"vision_model.encoder.layers.{i}"
        return {
            "ln1": _gn(state, f"{p}.layer_norm1", **kw),
            "q": _lin(state, f"{p}.self_attn.q_proj", **kw),
            "k": _lin(state, f"{p}.self_attn.k_proj", **kw),
            "v": _lin(state, f"{p}.self_attn.v_proj", **kw),
            "o": _lin(state, f"{p}.self_attn.out_proj", **kw),
            "ln2": _gn(state, f"{p}.layer_norm2", **kw),
            "fc1": _lin(state, f"{p}.mlp.fc1", **kw),
            "fc2": _lin(state, f"{p}.mlp.fc2", **kw),
        }

    n = cfg.num_layers
    return {
        "patch_embed": {"kernel": _patch_kernel(
            state["vision_model.embeddings.patch_embedding.weight"], **kw)},
        "class_embed": _put(state["vision_model.embeddings.class_embedding"],
                            dtype, device, lambda t: t.reshape(-1)),
        "pos_embed": _put(
            state["vision_model.embeddings.position_embedding.weight"], **kw),
        "pre_ln": _gn(state, "vision_model.pre_layrnorm", **kw),
        "blocks": _stack((block(i) for i in range(n)), n),
        "post_ln": _gn(state, "vision_model.post_layernorm", **kw),
        "projection": _lin(state, "visual_projection", bias=False, **kw),
    }


def _patch_kernel(w, dtype, device):
    """A patch conv [out, C, p, p] as the linear [p*p*C, out] over
    (y, x, c)-ordered patches."""
    return _put(w, dtype, device,
                lambda t: t.permute(2, 3, 1, 0).reshape(-1, t.shape[0]))


# ---------------------------------------------------------------------------
# DINO / generic ViT (HF ViTModel layout, e.g. facebook/dino-vits16)
# ---------------------------------------------------------------------------


def convert_vit_state(state: Dict[str, Any], cfg, dtype=torch.float32,
                      device="cuda"):
    """HF ViTModel state dict (keys with or without the "vit." prefix) ->
    models/vision param tree, the DINO-I feature extractor."""
    kw = dict(dtype=dtype, device=device)
    state = {k.removeprefix("vit."): v for k, v in state.items()}

    def block(i):
        p = f"encoder.layer.{i}"
        return {
            "ln1": _gn(state, f"{p}.layernorm_before", **kw),
            "q": _lin(state, f"{p}.attention.attention.query", **kw),
            "k": _lin(state, f"{p}.attention.attention.key", **kw),
            "v": _lin(state, f"{p}.attention.attention.value", **kw),
            "o": _lin(state, f"{p}.attention.output.dense", **kw),
            "ln2": _gn(state, f"{p}.layernorm_after", **kw),
            "fc1": _lin(state, f"{p}.intermediate.dense", **kw),
            "fc2": _lin(state, f"{p}.output.dense", **kw),
        }

    patch = "embeddings.patch_embeddings.projection"
    hidden = _tensor(state[f"{patch}.weight"]).shape[0]
    n = cfg.num_layers
    return {
        "patch_embed": {
            "kernel": _patch_kernel(state[f"{patch}.weight"], **kw),
            "bias": _put(state[f"{patch}.bias"], **kw),
        },
        "cls_token": _put(state["embeddings.cls_token"], dtype, device,
                          lambda t: t.reshape(-1)),
        "pos_embed": _put(state["embeddings.position_embeddings"], dtype,
                          device, lambda t: t.reshape(-1, hidden)),
        "blocks": _stack((block(i) for i in range(n)), n),
        "final_ln": _gn(state, "layernorm", **kw),
    }


# ---------------------------------------------------------------------------
# Depth Anything (DINOv2 backbone + DPT neck and head)
# ---------------------------------------------------------------------------


def convert_depth_anything_state(state: Dict[str, Any], cfg,
                                 dtype=torch.float32, device="cuda"):
    """HF DepthAnythingForDepthEstimation state dict -> models/depth.py tree.

    Key layout per transformers' modeling_depth_anything / modeling_dinov2:
    ``backbone.embeddings.*``, ``backbone.encoder.layer.{i}.*`` (separate
    q/k/v linears, layer-scale lambdas), ``backbone.layernorm``,
    ``neck.reassemble_stage.layers.{i}.{projection,resize}``,
    ``neck.convs.{i}``, ``neck.fusion_stage.layers.{i}.*``,
    ``head.conv{1,2,3}``.  Convs go OIHW -> HWIO; the reassemble transposed
    convs go [in, out, kh, kw] -> [in, kh, kw, out]."""
    kw = dict(dtype=dtype, device=device)

    def conv(prefix, bias=True):
        p = {"kernel": _put(state[f"{prefix}.weight"], dtype, device,
                            lambda t: t.permute(2, 3, 1, 0))}
        if bias:
            p["bias"] = _put(state[f"{prefix}.bias"], **kw)
        return p

    def block(i):
        p = f"backbone.encoder.layer.{i}"
        a = f"{p}.attention"
        return {
            "ln1": _gn(state, f"{p}.norm1", **kw),
            "q": _lin(state, f"{a}.attention.query", **kw),
            "k": _lin(state, f"{a}.attention.key", **kw),
            "v": _lin(state, f"{a}.attention.value", **kw),
            "o": _lin(state, f"{a}.output.dense", **kw),
            "ls1": _put(state[f"{p}.layer_scale1.lambda1"], **kw),
            "ln2": _gn(state, f"{p}.norm2", **kw),
            "fc1": _lin(state, f"{p}.mlp.fc1", **kw),
            "fc2": _lin(state, f"{p}.mlp.fc2", **kw),
            "ls2": _put(state[f"{p}.layer_scale2.lambda1"], **kw),
        }

    def res_unit(prefix):
        return {"conv1": conv(f"{prefix}.convolution1"),
                "conv2": conv(f"{prefix}.convolution2")}

    reassemble, convs, fusion = [], [], []
    for i, factor in enumerate(cfg.reassemble_factors):
        rp = f"neck.reassemble_stage.layers.{i}"
        layer = {"proj": conv(f"{rp}.projection")}
        if factor > 1:
            layer["resize"] = {
                "kernel": _put(state[f"{rp}.resize.weight"], dtype, device,
                               lambda t: t.permute(0, 2, 3, 1)),
                "bias": _put(state[f"{rp}.resize.bias"], **kw),
            }
        elif factor < 1:
            layer["resize"] = conv(f"{rp}.resize")
        reassemble.append(layer)
        convs.append(conv(f"neck.convs.{i}", bias=False))
        fp = f"neck.fusion_stage.layers.{i}"
        fusion.append({"proj": conv(f"{fp}.projection"),
                       "res1": res_unit(f"{fp}.residual_layer1"),
                       "res2": res_unit(f"{fp}.residual_layer2")})

    return {
        "cls": _put(state["backbone.embeddings.cls_token"], **kw),
        "pos": _put(state["backbone.embeddings.position_embeddings"], **kw),
        "patch": conv("backbone.embeddings.patch_embeddings.projection"),
        "blocks": [block(i) for i in range(cfg.num_layers)],
        "ln": _gn(state, "backbone.layernorm", **kw),
        "reassemble": reassemble,
        "convs": convs,
        "fusion": fusion,
        "head": {"conv1": conv("head.conv1"), "conv2": conv("head.conv2"),
                 "conv3": conv("head.conv3")},
    }


# ---------------------------------------------------------------------------
# Whisper + Marian (the speech-instruction path)
# ---------------------------------------------------------------------------


def convert_whisper_state(state: Dict[str, Any], cfg, dtype=torch.bfloat16,
                          device="cuda"):
    """HF WhisperForConditionalGeneration (or WhisperModel) state dict ->
    whisper param tree; the Conv1d kernels [out, in, w] become HIO
    [w, in, out]."""
    state, _ = _strip_model_prefix(state)
    kw = dict(dtype=dtype, device=device)

    def attn(p):
        return {
            "q": _lin(state, f"{p}.q_proj", **kw),
            "k": _lin(state, f"{p}.k_proj", bias=False, **kw),
            "v": _lin(state, f"{p}.v_proj", **kw),
            "o": _lin(state, f"{p}.out_proj", **kw),
        }

    def enc_block(i):
        p = f"encoder.layers.{i}"
        return {
            "ln_attn": _gn(state, f"{p}.self_attn_layer_norm", **kw),
            "attn": attn(f"{p}.self_attn"),
            "ln_ff": _gn(state, f"{p}.final_layer_norm", **kw),
            "fc1": _lin(state, f"{p}.fc1", **kw),
            "fc2": _lin(state, f"{p}.fc2", **kw),
        }

    def dec_block(i):
        p = f"decoder.layers.{i}"
        return {
            "ln_self": _gn(state, f"{p}.self_attn_layer_norm", **kw),
            "self_attn": attn(f"{p}.self_attn"),
            "ln_cross": _gn(state, f"{p}.encoder_attn_layer_norm", **kw),
            "cross_attn": attn(f"{p}.encoder_attn"),
            "ln_ff": _gn(state, f"{p}.final_layer_norm", **kw),
            "fc1": _lin(state, f"{p}.fc1", **kw),
            "fc2": _lin(state, f"{p}.fc2", **kw),
        }

    def conv(p):
        return {"kernel": _put(state[f"{p}.weight"], dtype, device,
                               lambda t: t.permute(2, 1, 0)),
                "bias": _put(state[f"{p}.bias"], dtype, device)}

    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    return {
        "conv1": conv("encoder.conv1"),
        "conv2": conv("encoder.conv2"),
        "enc_pos": _put(state["encoder.embed_positions.weight"], **kw),
        "enc_blocks": _stack((enc_block(i) for i in range(n_enc)), n_enc),
        "enc_ln": _gn(state, "encoder.layer_norm", **kw),
        "embed": _put(state["decoder.embed_tokens.weight"], **kw),
        "dec_pos": _put(state["decoder.embed_positions.weight"], **kw),
        "dec_blocks": _stack((dec_block(i) for i in range(n_dec)), n_dec),
        "dec_ln": _gn(state, "decoder.layer_norm", **kw),
    }


def convert_marian_state(state: Dict[str, Any], cfg, dtype=torch.bfloat16,
                         device="cuda"):
    """HF MarianMTModel (or MarianModel) state dict -> marian param tree.
    ``final_logits_bias`` sits outside the "model." prefix, so it is read
    from the full state (zeros where there is none), in float32."""
    state, full = _strip_model_prefix(state)
    kw = dict(dtype=dtype, device=device)

    def attn(p):
        return {n: _lin(state, f"{p}.{src}", **kw) for n, src in
                (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                 ("o", "out_proj"))}

    def enc_block(i):
        p = f"encoder.layers.{i}"
        return {
            "attn": attn(f"{p}.self_attn"),
            "ln_attn": _gn(state, f"{p}.self_attn_layer_norm", **kw),
            "fc1": _lin(state, f"{p}.fc1", **kw),
            "fc2": _lin(state, f"{p}.fc2", **kw),
            "ln_ff": _gn(state, f"{p}.final_layer_norm", **kw),
        }

    def dec_block(i):
        p = f"decoder.layers.{i}"
        return {
            "self_attn": attn(f"{p}.self_attn"),
            "ln_self": _gn(state, f"{p}.self_attn_layer_norm", **kw),
            "cross_attn": attn(f"{p}.encoder_attn"),
            "ln_cross": _gn(state, f"{p}.encoder_attn_layer_norm", **kw),
            "fc1": _lin(state, f"{p}.fc1", **kw),
            "fc2": _lin(state, f"{p}.fc2", **kw),
            "ln_ff": _gn(state, f"{p}.final_layer_norm", **kw),
        }

    bias = full.get("final_logits_bias")
    if bias is None:
        bias = torch.zeros(cfg.vocab_size)
    n_enc, n_dec = cfg.encoder_layers, cfg.decoder_layers
    return {
        "embed": _put(state["shared.weight"], **kw),
        # enc/dec embed_positions are the same deterministic sinusoids
        "pos": _put(state["encoder.embed_positions.weight"], **kw),
        "enc_blocks": _stack((enc_block(i) for i in range(n_enc)), n_enc),
        "dec_blocks": _stack((dec_block(i) for i in range(n_dec)), n_dec),
        "logits_bias": _put(bias, torch.float32, device,
                            lambda t: t.reshape(-1)),
    }


# ---------------------------------------------------------------------------
# Loading a Hugging Face checkout
# ---------------------------------------------------------------------------


def _strip_model_prefix(state):
    """WhisperForConditionalGeneration/MarianMTModel checkpoints prefix the
    backbone with "model."; bare WhisperModel/MarianModel ones don't.
    Returns (backbone state, full state)."""
    if any(k.startswith("model.") for k in state):
        return {k[len("model."):]: v for k, v in state.items()
                if k.startswith("model.")}, state
    return state, state


def load_torch_or_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Flat state dict of a Hugging Face checkout: its *.safetensors files
    where there are any, else ``pytorch_model.bin`` (tensors only:
    ``weights_only=True``)."""
    if any(f.endswith(".safetensors") for f in os.listdir(path)):
        return load_safetensors_dir(path)
    bin_path = os.path.join(path, "pytorch_model.bin")
    if not os.path.exists(bin_path):
        raise FileNotFoundError(f"no safetensors or pytorch_model.bin in {path}")
    return dict(torch.load(bin_path, map_location="cpu", weights_only=True))
