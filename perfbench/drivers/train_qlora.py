"""Driver of the QLoRA training step: ``loongx_tpu_torch.train.step.
make_train_step``'s ``step_fn`` on the int8 FLUX.1-dev training tree
(weight-only, q / k / v and proj_out unfused) with LoRA on the
configuration's targets, the brain condition fused into the text embeds,
Prodigy, the gradient clip and remat.  One optimizer step of a new batch a
unit (`perfbench.core.traffic`), ended by a synchronize.

Set-up makes the weights and the LoRA factors from the seed on the card,
builds one train state and drives it through the first ``check.steps``
steps (units 0, 1, ...), reading what the check compares: each step's
loss, the first gradient of each LoRA leaf as the optimizer got it (from
Prodigy's first moment after one step: mu = (1 - beta1) d0 g) and each
leaf's change after those steps.  The window continues the same state.
The check follows the same steps in the plain float32 reference
(`perfbench.reference.train`) after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Any, Dict, List, Tuple

import torch

from perfbench.core import flops, traffic, weights
from perfbench.reference import layout
from perfbench.reference import train as ref_train

MODALITIES = ("eeg", "ppg", "fnirs", "motion")


def sizes_of(cfg: Dict[str, Any], mix: Dict[str, Any]) -> Dict[str, int]:
    t, p = cfg["transformer"], dict(mix["params"])
    p.update(tokens=(p["height"] // 16) * (p["width"] // 16),
             in_channels=t["in_channels"],
             joint_dim=t["joint_attention_dim"],
             pooled_dim=t["pooled_projection_dim"])
    return p


def frozen_weights(cfg: Dict[str, Any], seed: int, device="cuda"):
    return {"flux": weights.make(layout.flux_layout(cfg["transformer"]),
                                 seed, "flux", device),
            "brain": weights.make(layout.brain_layout(), seed, "brain",
                                  device)}


def lora_weights(cfg: Dict[str, Any], seed: int, device="cuda"):
    shapes = layout.lora_layout(layout.flux_layout(cfg["transformer"]),
                                cfg["lora"]["r"], cfg["lora"]["targets"])
    return weights.make(shapes, seed, "lora", device)


def ids(sizes: Dict[str, int], device) -> torch.Tensor:
    h, w = sizes["height"] // 16, sizes["width"] // 16
    grid = torch.stack(torch.broadcast_tensors(
        torch.zeros(h, w, device=device),
        torch.arange(h, device=device, dtype=torch.float32)[:, None],
        torch.arange(w, device=device, dtype=torch.float32)[None, :]), -1)
    return grid.reshape(-1, 3)


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


class Driver:
    unit = "step"

    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: str = "cuda", dtype=None):
        from loongx_tpu_torch.models.flux.model import FluxConfig
        from loongx_tpu_torch.train.optim import build_optimizer
        from loongx_tpu_torch.train.step import (
            make_train_step, partition, trainable_mask,
        )

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        dtype = getattr(torch, cfg["dtype"]) if dtype is None else dtype
        self.sizes = sizes_of(cfg, mix)
        self.ids = ids(self.sizes, device)
        self.first_unit = mix["check"]["steps"]
        t, lc = cfg["transformer"], cfg["lora"]
        flux_cfg = FluxConfig(
            in_channels=t["in_channels"], num_heads=t["num_attention_heads"],
            head_dim=t["attention_head_dim"],
            num_double_blocks=t["num_layers"],
            num_single_blocks=t["num_single_layers"],
            joint_dim=t["joint_attention_dim"],
            pooled_dim=t["pooled_projection_dim"],
            guidance_embeds=t["guidance_embeds"],
            axes_dims=tuple(t["axes_dims_rope"]))
        frozen = frozen_weights(cfg, seed, device)
        flux, self.lora = frozen["flux"], lora_weights(cfg, seed, device)
        for path, factors in self.lora.items():
            leaf = layout.get_path(flux, path)
            leaf.update(factors)
            nb = leaf["kernel_q"].shape[:-2]
            leaf["lora_scale"] = torch.full(nb, lc["alpha"] / lc["r"],
                                            dtype=torch.float32, device=device)
        params = {"flux": flux, **frozen["brain"]}
        if dtype != torch.bfloat16:  # made in bf16: the same values wider
            from loongx_tpu_torch.ops.nn import tree_cast
            params = tree_cast(params, dtype)
            for path in self.lora:
                leaf = layout.get_path(params["flux"], path)
                self.lora[path] = {f: leaf[f] for f in ("lora_a", "lora_b")}
        trainable, self.frozen = partition(params, trainable_mask(params))
        opt = cfg["optimizer"]
        init_fn, self.step_fn = make_train_step(
            flux_cfg, build_optimizer({"type": opt["type"], "params": {
                k: opt[k] for k in ("lr", "use_bias_correction",
                                    "safeguard_warmup", "weight_decay")}}),
            flags=cfg["model"], use_brain_condition=True, fuse_flag=True,
            remat=cfg["remat"], grad_clip=cfg["grad_clip"], dtype=dtype)
        self.state = init_fn(trainable)
        self.readings: Dict[str, Any] = {"loss": []}
        del frozen, params, trainable

    # -- the timed path -----------------------------------------------------

    def batch(self, i: int):
        """(batch, draws) of step ``i``: every row new."""
        x = traffic.draw(self.mix, self.sizes, self.seed, i, self.device)
        batch = {k: x[k] for k in ("x0", "cond_tokens", "prompt_embeds",
                                   "pooled", *MODALITIES)}
        batch.update(img_ids=self.ids, cond_ids=self.ids,
                     txt_ids=torch.zeros(self.sizes["text_tokens"], 3,
                                         device=self.device))
        draws = {"t": x["t"], "noise": x["noise"],
                 "dropout": {m: [x[f"dropout.{m}.{j}"] for j in range(2)]
                             for m in MODALITIES}}
        return batch, draws

    def run_unit(self, i: int) -> int:
        """One optimizer step of batch ``i``, to its end."""
        batch, draws = self.batch(i)
        self.state, metrics = self.step_fn(self.state, self.frozen, batch,
                                           draws)
        if i < self.first_unit:
            self.readings["loss"].append(float(metrics["loss"]))
        elif self.device == "cuda":
            torch.cuda.synchronize()
        return batch["x0"].shape[0]

    def warm(self) -> None:
        """The first steps, which the check follows; the program's numbers
        read from its optimizer after the first and after the last."""
        opt = self.state.optimizer
        by_param = {id(leaf[f]): f"{path}/{f}" for path, leaf in
                    self.lora.items() for f in ("lora_a", "lora_b")}
        for i in range(self.first_unit):
            d0 = float(opt.d)
            self.run_unit(i)
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                self.readings["grad"] = {
                    by_param[id(p)]: float(opt.state[p]["mu"].double().norm())
                    / ((1 - beta1) * d0)
                    for p in opt.param_groups[0]["params"]}
        self.readings["change"] = {
            by_param[id(p)]: float((p.detach().double()
                                    - opt.state[p]["p0"].double())
                                   .norm())
            for p in opt.param_groups[0]["params"]}

    @contextlib.contextmanager
    def stage_spans(self):
        yield {}

    # -- the yardstick --------------------------------------------------------

    def steps_per_unit(self) -> int:
        return 1

    def ops_per_unit(self) -> List[flops.Op]:
        s = self.sizes
        return flops.train_step(self.cfg["transformer"], s["batch"],
                                s["text_tokens"], s["tokens"], s["tokens"],
                                self.cfg["lora"]["r"])

    # -- the check ------------------------------------------------------------

    def free(self) -> None:
        self.state = self.frozen = self.lora = self.step_fn = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference(self, acts: str = "float32") -> Dict[str, Any]:
        """The reference's numbers over the same first steps."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        frozen = frozen_weights(self.cfg, self.seed, self.device)
        batches = []
        for i in range(self.first_unit):
            x = traffic.draw(self.mix, self.sizes, self.seed, i, self.device)
            x["img_ids"] = self.ids
            batches.append(x)
        out = ref_train.follow(frozen, lora_weights(self.cfg, self.seed,
                                                    self.device),
                               self.cfg, batches, acts)
        return {"loss": out["loss"], "grad": norms(out["grad"]),
                "change": norms(out["change"])}

    def check(self, done: List[int], control: bool = False
              ) -> Dict[str, Tuple[float, float]]:
        """{number: (reading, limit)}: the widest relative gap of a step's
        loss, of a leaf's first-gradient norm and of a leaf's change norm
        (`compare`).  ``control`` also reads the control (the reference
        with its DiT linears' inputs and outputs in fp8 e4m3) into
        ``self.control``."""
        self.free()
        ref = self.reference()
        got = compare(self.readings, ref)
        if control:
            self.control = compare(self.reference("fp8"), ref)
        return {k: (v, self.cfg["checks"][k]) for k, v in got.items()}


def compare(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The worst relative gaps of ``got`` from ``ref``: each step's loss
    against the reference's; each leaf's norm (first gradient, change)
    against the larger of the reference leaf's norm and the median leaf's.
    Leaves whose first gradient in the reference is under a thousandth of
    the median leaf's (the LoRA A factors at the first step, where B is 0)
    are left out of both."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))
    g = ref["grad"]
    med = sorted(g.values())[len(g) // 2]
    live = [k for k in g if g[k] >= 1e-3 * med]
    out = {"loss_gap": loss}
    for what in ("grad", "change"):
        r = ref[what]
        floor = sorted(r[k] for k in live)[len(live) // 2]
        out[f"{what}_norm_gap"] = max(abs(got[what][k] - r[k])
                                      / max(r[k], floor) for k in live)
    return out
