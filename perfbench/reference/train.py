"""The plain QLoRA training step in float32: the reference the benchmark
holds the program's first steps against.

flow-matching loss: x_t = (1 - t) x0 + t x1, the brain condition fused
into the text embeds by the training wiring (CS3 encoders with their
dropout masks, DGF; all frozen), the weight-only int8 FLUX forward with
LoRA (r, alpha / r) on the condition tokens only, the condition tokens at
timestep 0, guidance 1, loss = mean((pred - (x1 - x0))^2).  The LoRA
gradients are clipped by their global norm (optax's rule: g * c / norm
where norm >= c) and handed to Prodigy (arXiv:2306.06101, the Adam-type
update with bias correction and the safeguarded warm-up).  Nothing here
imports the measured package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from perfbench.reference import brain, flux

Tree = Dict[str, Any]


class Prodigy:
    """Prodigy over a flat list of float32 leaves, one shared d."""

    def __init__(self, leaves: List[torch.Tensor], lr: float,
                 weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 d0: float = 1e-6, use_bias_correction: bool = True,
                 safeguard_warmup: bool = True):
        self.leaves, self.lr, self.wd = leaves, lr, weight_decay
        self.b1, self.b2 = betas
        self.b3, self.eps, self.d0 = math.sqrt(betas[1]), eps, d0
        self.bias_correction, self.safeguard = use_bias_correction, \
            safeguard_warmup
        self.d, self.num, self.k = d0, 0.0, 0
        self.x0 = [p.detach().clone() for p in leaves]
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.s = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.k += 1
        d = self.d
        dlr = d * self.lr
        if self.bias_correction:
            dlr *= math.sqrt(1 - self.b2 ** self.k) / (1 - self.b1 ** self.k)
        dot = sum(float(torch.sum(g * (x0 - p)))
                  for g, x0, p in zip(grads, self.x0, self.leaves))
        self.num = self.b3 * self.num + (d / self.d0) * dlr * dot
        s_coef = (d / self.d0) * (d * self.lr if self.safeguard else dlr)
        denom = 0.0
        for i, g in enumerate(grads):
            self.mu[i] = self.b1 * self.mu[i] + (1 - self.b1) * d * g
            self.nu[i] = self.b2 * self.nu[i] + (1 - self.b2) * (d * g) ** 2
            self.s[i] = self.b3 * self.s[i] + s_coef * g
            denom += float(self.s[i].abs().sum())
        d_hat = self.num / denom if denom > 0 else d
        self.d = max(d, d_hat)
        for i, p in enumerate(self.leaves):
            p -= dlr * (self.mu[i] / (torch.sqrt(self.nu[i]) + d * self.eps)
                        + self.wd * p)


def loss(frozen: Tree, cfg: Dict[str, Any], lin: flux.Linears,
         batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The flow-matching loss of one batch (its draws included)."""
    x0 = batch["x0"].float()
    t, x1 = batch["t"].float(), batch["noise"].float()
    tb = t.reshape(-1, 1, 1)
    x_t = (1.0 - tb) * x0 + tb * x1
    keep = {m: [batch[f"dropout.{m}.{i}"] for i in range(2)]
            for m in ("eeg", "ppg", "fnirs", "motion")}
    prompt, pooled = brain.brain_embeds(frozen["brain"], batch, keep)
    txt, txt_pooled = brain.fuse_text_train(
        frozen["brain"]["dgf"], batch["prompt_embeds"].float(),
        batch["pooled"].float(), prompt, pooled)
    b, dev = x0.shape[0], x0.device
    pred = flux.flux_forward(
        frozen["flux"], cfg["transformer"], lin, img=x_t, txt=txt,
        pooled=txt_pooled, timestep=t, guidance=torch.ones(b, device=dev),
        img_ids=batch["img_ids"], txt_ids=torch.zeros(txt.shape[1], 3,
                                                      device=dev),
        cond=batch["cond_tokens"], cond_ids=batch["img_ids"],
        checkpoint_blocks=True)
    return torch.mean((pred - (x1 - x0)) ** 2)


def follow(frozen: Tree, lora0: Dict[str, Tree], cfg: Dict[str, Any],
           batches: List[Dict[str, torch.Tensor]],
           acts: str = "float32") -> Dict[str, Any]:
    """Run the steps of ``batches`` from the LoRA factors ``lora0``:
    {"loss": [per step], "grad": {leaf: first gradient as the optimizer
    gets it}, "change": {leaf: the leaf's change after the last step}}.
    ``acts`` "int8" or "fp8" is a control (`flux.Linears`)."""
    opt_cfg, lora_cfg = cfg["optimizer"], cfg["lora"]
    targets = lora_cfg["targets"]
    names = [f"{p}/{f}" for p in targets for f in ("lora_a", "lora_b")]
    leaves = [lora0[n.rsplit("/", 1)[0]][n.rsplit("/", 1)[1]].detach()
              .float().clone().requires_grad_(True) for n in names]
    tree = {p: {"lora_a": leaves[2 * i], "lora_b": leaves[2 * i + 1]}
            for i, p in enumerate(targets)}
    lin = flux.Linears(acts, lora=tree,
                       lora_scale=lora_cfg["alpha"] / lora_cfg["r"])
    opt = Prodigy(leaves, lr=opt_cfg["lr"],
                  weight_decay=opt_cfg["weight_decay"],
                  use_bias_correction=opt_cfg["use_bias_correction"],
                  safeguard_warmup=opt_cfg["safeguard_warmup"])
    out: Dict[str, Any] = {"loss": [], "grad": {}}
    for step, batch in enumerate(batches):
        value = loss(frozen, cfg, lin, batch)
        grads = list(torch.autograd.grad(value, leaves))
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        clip = cfg["grad_clip"]
        if norm >= clip:
            grads = [g / norm * clip for g in grads]
        out["loss"].append(float(value.detach()))
        if step == 0:
            out["grad"] = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.step([g.detach() for g in grads])
        del value, grads
    out["change"] = {n: (p.detach() - p0) for n, p, p0 in
                     zip(names, leaves, opt.x0)}
    return out
