"""Optimizers: Prodigy (D-adaptation) as a ``torch.optim.Optimizer``, the
AdamW / SGD factories and gradient accumulation (`MultiSteps`; counterpart
of ``loongx_tpu/train/optim.py`` and the optax chain of its training loop).

Prodigy (Mishchenko & Defazio, arXiv:2306.06101), Adam-type, the JAX
package's update exactly:

    dlr     = d lr (* sqrt(1 - b2^k) / (1 - b1^k) with bias correction)
    num     = b3 num + (d / d0) dlr <g, x0 - x>
    m       = b1 m + (1 - b1) d g;   v = b2 v + (1 - b2) (d g)^2
    s       = b3 s + (d / d0) (d lr if safeguard_warmup else dlr) g
    d_hat   = d_coef num / ||s||_1   (d when ||s||_1 == 0)
    d_next  = min(max(d, d_hat), growth_rate d)
    x      += cast(-dlr (m / (sqrt(v) + d eps) + wd x))

The moments and accumulators are float32 from the start, ``p0`` is a real
copy of the initial params (in their dtype), the scalars (d, numerator,
step) are float32 tensors on the params' device (no host sync), and each
update is cast to the param's dtype before it is added, as
``optax.apply_updates`` does.  The params are updated in place.  All params
share one d: one param group.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Optional

import torch


class Prodigy(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1.0,
                 betas=(0.9, 0.999), beta3: Optional[float] = None,
                 eps: float = 1e-8, weight_decay: float = 0.0, d0: float = 1e-6,
                 d_coef: float = 1.0, growth_rate: float = float("inf"),
                 use_bias_correction: bool = False,
                 safeguard_warmup: bool = False):
        defaults = dict(lr=lr, betas=tuple(betas),
                        beta3=betas[1] ** 0.5 if beta3 is None else beta3,
                        eps=eps, weight_decay=weight_decay, d0=d0, d_coef=d_coef,
                        growth_rate=growth_rate,
                        use_bias_correction=use_bias_correction,
                        safeguard_warmup=safeguard_warmup)
        super().__init__(params, defaults)
        if len(self.param_groups) != 1:
            raise ValueError("Prodigy shares one d over all params: pass one "
                             "param group")
        group = self.param_groups[0]
        dev = group["params"][0].device
        group["d"] = torch.tensor(d0, dtype=torch.float32, device=dev)
        group["numerator"] = torch.zeros((), dtype=torch.float32, device=dev)
        group["k"] = torch.zeros((), dtype=torch.float32, device=dev)
        for p in group["params"]:
            st = self.state[p]
            for name in ("mu", "nu", "s"):
                st[name] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            st["p0"] = p.detach().clone()

    @property
    def d(self) -> torch.Tensor:
        """Prodigy's current step-size estimate (float32 scalar tensor)."""
        return self.param_groups[0]["d"]

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        g_ = self.param_groups[0]
        beta1, beta2 = g_["betas"]
        b3, lr, d0 = g_["beta3"], g_["lr"], g_["d0"]
        params = [p for p in g_["params"] if p.grad is not None]
        k = g_["k"] + 1
        d = g_["d"]
        dlr = d * lr
        if g_["use_bias_correction"]:
            dlr = dlr * (torch.sqrt(1.0 - beta2 ** k) / (1.0 - beta1 ** k))
        dot = torch.zeros((), dtype=torch.float32, device=d.device)
        for p in params:
            x0 = self.state[p]["p0"]
            dot = dot + torch.sum(p.grad.float() * (x0.float() - p.float()))
        # a tensor divisor: a true quotient on every device
        d_ratio = d / torch.full_like(d, d0)
        numerator = b3 * g_["numerator"] + d_ratio * dlr * dot
        s_coef = d_ratio * (d * lr if g_["safeguard_warmup"] else dlr)
        denom = torch.zeros((), dtype=torch.float32, device=d.device)
        for p in params:
            st, g = self.state[p], p.grad.float()
            st["mu"] = beta1 * st["mu"] + (1 - beta1) * (d * g)
            st["nu"] = beta2 * st["nu"] + (1 - beta2) * (d * g) ** 2
            st["s"] = b3 * st["s"] + s_coef * g
            denom = denom + torch.sum(torch.abs(st["s"]))
        d_hat = torch.where(denom > 0,
                            g_["d_coef"] * numerator / torch.clamp(denom, min=1e-30), d)
        new_d = torch.minimum(torch.maximum(d, d_hat), d * g_["growth_rate"])
        for p in params:
            st = self.state[p]
            delta = -dlr * (st["mu"] / (torch.sqrt(st["nu"]) + d * g_["eps"]))
            if g_["weight_decay"] > 0:
                delta = delta - dlr * g_["weight_decay"] * p.float()
            p.add_(delta.to(p.dtype))
        g_["k"], g_["d"], g_["numerator"] = k, new_d, numerator
        return loss


OptimizerFactory = Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer]


class MultiSteps:
    """Gradient accumulation with the clip inside, as the JAX training loop
    builds it: ``optax.MultiSteps(optax.chain(clip_by_global_norm(c), tx),
    every_k)``.

    Each `step` folds the params' ``.grad`` into the accumulator as optax's
    running mean does, ``acc + (g - acc) / (n + 1)`` in the gradient's
    dtype; the k-th clips the accumulated mean once by its global norm
    (optax's formula, `train.step.clip_by_global_norm`; ``clip`` None or 0
    disables it), hands it to the inner optimizer as the gradient, steps
    it, and starts a new window.  The params move only on the k-th call.
    ``param_groups`` are the inner optimizer's, so `make_train_step` drives
    this wrapper as it drives any optimizer."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int,
                 clip: Optional[float] = None):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner, self.every_k, self.clip = inner, every_k, clip
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for g in inner.param_groups
                    for p in g["params"]]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self) -> bool:
        """Accumulate; returns True where the inner optimizer stepped."""
        from loongx_tpu_torch.train.step import clip_by_global_norm, global_norm

        n = self.mini_step
        params = self._params()
        for acc, p in zip(self.acc, params):
            if p.grad is not None:
                acc.add_((p.grad.to(acc.dtype) - acc) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return False
        grads = self.acc
        if self.clip:
            grads = clip_by_global_norm(grads, self.clip, global_norm(grads))
        for p, g in zip(params, grads):
            p.grad = g.clone()
        self.inner.step()
        self.inner.zero_grad(set_to_none=True)
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0
        return True

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        """{"inner": the inner optimizer's state_dict, "acc": [accumulator
        per param], "mini_step": micro-steps in the open window}."""
        return {"inner": self.inner.state_dict(), "acc": list(self.acc),
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict`'s values exactly (`load_optimizer_state`:
        every tensor keeps its saved dtype)."""
        load_optimizer_state(self.inner, state["inner"])
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)
        self.mini_step = int(state["mini_step"])


def load_optimizer_state(opt: torch.optim.Optimizer,
                         state: Dict[str, Any]) -> None:
    """Load an optimizer's ``state_dict`` without the dtype cast of
    ``Optimizer.load_state_dict`` (it casts each state tensor to its
    param's dtype: Prodigy's float32 moments of bf16 LoRA leaves would be
    rounded).  Tensors move to their param's device, "step" counts stay
    where they were saved, as PyTorch keeps them; the param groups take
    the saved hyperparameters and scalars (Prodigy's d on the params'
    device)."""
    groups = opt.param_groups
    saved_groups = state["param_groups"]
    if len(groups) != len(saved_groups) or any(
            len(g["params"]) != len(s["params"])
            for g, s in zip(groups, saved_groups)):
        raise ValueError("optimizer state does not match the params: "
                         f"{[len(s['params']) for s in saved_groups]} saved, "
                         f"{[len(g['params']) for g in groups]} here")
    index = {i: p for g, s in zip(groups, saved_groups)
             for i, p in zip(s["params"], g["params"])}
    opt.state.clear()
    for i, st in state["state"].items():
        p = index[int(i)]
        opt.state[p] = {k: v.to(p.device) if isinstance(v, torch.Tensor)
                        and k != "step" else v for k, v in st.items()}
    for g, s in zip(groups, saved_groups):
        dev = g["params"][0].device
        for k, v in s.items():
            if k != "params":
                g[k] = v.to(dev) if isinstance(v, torch.Tensor) else v


def build_optimizer(opt_config: Any) -> OptimizerFactory:
    """A factory ``params -> optimizer`` from an optimizer config (an object
    with ``type`` / ``params`` or a dict of them): Prodigy, AdamW or SGD,
    with the JAX package's defaults (AdamW weight_decay 0.0, not PyTorch's
    0.01)."""
    typ = opt_config.type if hasattr(opt_config, "type") else opt_config["type"]
    params = dict(opt_config.params if hasattr(opt_config, "params")
                  else opt_config.get("params", {}))
    if typ == "Prodigy":
        return functools.partial(
            Prodigy, lr=params.pop("lr", 1.0),
            weight_decay=params.pop("weight_decay", 0.0),
            use_bias_correction=params.pop("use_bias_correction", False),
            safeguard_warmup=params.pop("safeguard_warmup", False), **params)
    if typ == "AdamW":
        betas = (params.pop("b1", 0.9), params.pop("b2", 0.999))
        return functools.partial(
            torch.optim.AdamW, lr=params.pop("lr", 1e-4), betas=betas,
            weight_decay=params.pop("weight_decay", 0.0), **params)
    if typ == "SGD":
        return functools.partial(
            torch.optim.SGD, lr=params.pop("lr", 1e-3),
            momentum=params.pop("momentum", None) or 0.0, **params)
    raise NotImplementedError(f"optimizer type {typ!r}")


