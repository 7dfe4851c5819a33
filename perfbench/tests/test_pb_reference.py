"""The plain reference against the measured program on the CPU, at a tiny
DiT and VAE (the CS3 encoders and DGF keep their fixed widths, so the DiT's
joint and pooled widths are FLUX's), from the same seeded weights and
draws: the served edit end to end, and the QLoRA step's loss, gradients and
optimizer update."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench.core import traffic
from perfbench.drivers import serve_edit
from perfbench.reference import edit as ref_edit

TINY = {
    "transformer": {"in_channels": 16, "num_layers": 2,
                    "num_single_layers": 2, "attention_head_dim": 32,
                    "num_attention_heads": 2, "joint_attention_dim": 4096,
                    "pooled_projection_dim": 768, "guidance_embeds": True,
                    "axes_dims_rope": [8, 12, 12]},
    "vae": {"in_channels": 3, "latent_channels": 4, "block_out_channels": [8, 16],
            "layers_per_block": 1, "norm_num_groups": 4,
            "scaling_factor": 0.3611, "shift_factor": 0.1159},
    "quantization": {"activations": "int8"},
    "dtype": "bfloat16", "attention_scores": "bfloat16", "s4_mode": "conv",
    "checks": {"image_rel_l2": 1.0},
}

MIX = {
    "params": {"batch": 2, "height": 32, "width": 32, "steps": 2,
               "guidance": 3.5, "text_tokens": 512},
    "draws": {
        "image": {"dist": "uint8", "shape": ["batch", "height", "width", 3]},
        "eeg": {"dist": "normal", "shape": ["batch", 4, 4096]},
        "ppg": {"dist": "normal", "shape": ["batch", 4, 256]},
        "fnirs": {"dist": "normal", "shape": ["batch", 6, 512]},
        "motion": {"dist": "normal", "shape": ["batch", 6, 128]},
        "latents": {"dist": "normal",
                    "shape": ["batch", "tokens", "in_channels"]},
        "cond_noise": {"dist": "normal", "shape": ["batch", "lat_h", "lat_w",
                                                   "latent_channels"]},
    },
    "check": {"images": 2},
}


def _cfg(activations: str):
    cfg = copy.deepcopy(TINY)
    cfg["quantization"]["activations"] = activations
    return cfg


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("activations, dtype, tol", [
    # float32 program, weight-only products: the same function to rounding
    ("none", torch.float32, 1e-4),
    # the served form: bf16 activations quantized per group; a semantic
    # fault reads O(1), rounding a few 1e-2 at this size
    ("int8", torch.bfloat16, 8e-2),
])
def test_serve_edit_matches_reference(activations, dtype, tol):
    cfg = _cfg(activations)
    drv = serve_edit.Driver(cfg, MIX, seed=2 ** 31 + 7, device="cpu",
                            dtype=dtype)
    drv.run_unit(0)
    got = drv.outputs[0]
    w = serve_edit.reference_weights(cfg, drv.seed, "cpu")
    x = traffic.draw(MIX, drv.sizes, drv.seed, 0, "cpu")
    with torch.no_grad():
        ref = ref_edit.neural_edit(w, cfg, x, 2, 3.5,
                                   "int8" if activations == "int8"
                                   else "float32")
    assert got.shape == tuple(ref.shape) == (2, 32, 32, 3)
    assert _rel(got, ref) < tol


def test_serve_check_reads_and_fails_a_fault():
    """The driver's own check on the window's outputs: sound outputs read
    under the W8A8 rounding, an altered image reads far above it."""
    cfg = _cfg("int8")
    drv = serve_edit.Driver(cfg, MIX, seed=11, device="cpu")
    drv.run_unit(0)
    drv.run_unit(1)
    good = dict(drv.outputs)
    value, _ = drv.check([0, 1])["image_rel_l2"]
    assert value < 8e-2
    drv.outputs = {k: v.copy() for k, v in good.items()}
    for k in drv.outputs:
        drv.outputs[k][:, :16] = 0.0  # half of every image lost
    bad, _ = drv.check([0, 1])["image_rel_l2"]
    assert bad > 10 * value


TRAIN_MIX = {
    "params": {"batch": 2, "height": 64, "width": 64, "text_tokens": 512},
    "draws": {
        "x0": {"dist": "normal", "shape": ["batch", "tokens", "in_channels"]},
        "cond_tokens": {"dist": "normal",
                        "shape": ["batch", "tokens", "in_channels"]},
        "prompt_embeds": {"dist": "normal", "scale": 0.1,
                          "shape": ["batch", "text_tokens", "joint_dim"]},
        "pooled": {"dist": "normal", "scale": 0.1,
                   "shape": ["batch", "pooled_dim"]},
        "eeg": {"dist": "normal", "shape": ["batch", 4, 4096]},
        "ppg": {"dist": "normal", "shape": ["batch", 4, 256]},
        "fnirs": {"dist": "normal", "shape": ["batch", 6, 512]},
        "motion": {"dist": "normal", "shape": ["batch", 6, 128]},
        "t": {"dist": "sigmoid_normal", "shape": ["batch"]},
        "noise": {"dist": "normal", "shape": ["batch", "tokens", "in_channels"]},
        **{f"dropout.{m}.{i}": {"dist": "bernoulli", "p": 0.7,
                                "shape": ["batch", n]}
           for m, dims in (("eeg", (2048, 4096)), ("ppg", (1024, 4096)),
                           ("fnirs", (1024, 768)), ("motion", (512, 768)))
           for i, n in enumerate(dims)},
    },
    "check": {"steps": 3},
}


def train_cfg():
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).parents[1] / "configs" /
                      "flux1-dev-int8-qlora-seed512.json").read_text())
    cfg["transformer"] = dict(TINY["transformer"])
    return cfg


@pytest.mark.parametrize("dtype, tol", [
    # the float32 program: the same function to rounding
    (torch.float32, {"loss_gap": 1e-5, "grad_norm_gap": 1e-3,
                     "change_norm_gap": 1e-2}),
    # bf16, as trained
    (torch.bfloat16, {"loss_gap": 2e-2, "grad_norm_gap": 0.2,
                      "change_norm_gap": 0.2}),
])
def test_train_step_matches_reference(dtype, tol):
    from perfbench.drivers import train_qlora

    drv = train_qlora.Driver(train_cfg(), TRAIN_MIX, seed=5, device="cpu",
                             dtype=dtype)
    drv.warm()
    prog = drv.readings
    drv.free()
    ref = drv.reference()
    gaps = train_qlora.compare(prog, ref)
    print(gaps, prog["loss"], ref["loss"])
    for k, v in gaps.items():
        assert v < tol[k], (k, v)
    assert all(ref["change"][k] > 0 for k in ref["change"] if "lora_b" in k)
