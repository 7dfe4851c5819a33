"""The training step: flow-matching loss over the LoRA leaves (counterpart
of ``loongx_tpu/train/step.py``).

The param tree is a nested dict; the trainable set is a mask over it
(`trainable_mask`), and `partition` / `combine` split and join the tree as
the JAX package does, with the trainable leaves flagged
``requires_grad``.  The optimizer is PyTorch's: ``make_train_step`` takes a
factory ``params -> torch.optim.Optimizer`` (`train.optim.build_optimizer`)
and updates the trainable leaves in place.

Random draws are explicit: the step takes either a ``torch.Generator`` or a
dict of the draws themselves -- ``t`` [B] (after the sigmoid), ``noise``
(x1, x0's shape) and ``dropout`` {"eeg" | "ppg" | "fnirs" | "motion": [keep
mask per layer]} -- so a test can hand the port the JAX package's own
``jax.random`` draws.

Under a mesh (`parallel.mesh.mesh_context` around the step, each rank
holding its rows of the global batch and its shard of the frozen tree):
the draws are the global batch's, of which a data rank keeps its rows, so
the ranks of one data row draw alike and the step equals the one-process
step at the global batch; the LoRA gradients are summed in float32, over
the tensor group where a split leaves them partial
(`parallel.mesh.tensor_partial_grad`) and then over the data group, whose
mean they become; loss and t_mean are the data group's means.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from loongx_tpu_torch.models.encoders import (
    BatchRows, eeg_encode, fnirs_encode, motion_encode, ppg_encode,
)
from loongx_tpu_torch.models.flux.model import FluxConfig, flux_forward
from loongx_tpu_torch.models.fusion import (
    fuse_eeg_ppg, fuse_fnirs_motion, fuse_text_train,
)
from loongx_tpu_torch.ops.schedule import flow_match_xt
from loongx_tpu_torch.parallel.mesh import (
    current_dp, current_tp, tensor_partial_grad, tree_paths,
)
from loongx_tpu_torch.train.lora import lora_mask
from loongx_tpu_torch.train.optim import OptimizerFactory
from loongx_tpu_torch.utils.profiling import span

Draws = Union[torch.Generator, Dict[str, Any]]


# ---------------------------------------------------------------------------
# Trainable / frozen
# ---------------------------------------------------------------------------


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
    return fn(*trees)


def leaves(tree) -> List[Any]:
    """The leaves of a dict/list tree in a fixed order (None leaves kept)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def trainable_mask(params: Dict[str, Any], train_encoders: bool = False):
    """Mask over the pipeline tree: the LoRA factors of the flux tree, plus
    (optionally) every encoder and DGF leaf."""
    mask = {k: _map(lambda _: False, v) for k, v in params.items()}
    mask["flux"] = lora_mask(params["flux"])
    if train_encoders:
        for name in ("encoders", "dgf"):
            if name in params:
                mask[name] = _map(lambda _: True, params[name])
    return mask


def partition(params, mask) -> Tuple[Any, Any]:
    """(trainable, frozen) trees, None at the complementary positions.  The
    trainable leaves are flagged ``requires_grad``, the frozen ones not."""
    def flag(p, m):
        if p.is_floating_point():
            p.requires_grad_(bool(m))
        elif m:
            raise ValueError(f"a {p.dtype} leaf cannot be trainable")
        return p

    _map(flag, params, mask)
    return (_map(lambda p, m: p if m else None, params, mask),
            _map(lambda p, m: None if m else p, params, mask))


def combine(trainable, frozen):
    return _map(lambda a, b: b if a is None else a, trainable, frozen)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

_MODALITIES = ("eeg", "ppg", "fnirs", "motion")


def _draws(draws: Draws, x0: torch.Tensor):
    """(t, x1, {modality: dropout}) from a generator or explicit draws: t =
    sigmoid(N(0, 1)) [B], x1 = N(0, 1) like x0, float32.  Under a data axis
    (`current_dp`) both are the global batch's (B x the data extent rows,
    as one process at the global batch draws them) and this rank keeps its
    rows [d * B, (d + 1) * B), the dropout masks too (`BatchRows`)."""
    b = x0.shape[0]
    dp = current_dp()
    start, total = (0, b) if dp is None else (
        dp[0].index(dp[1]) * b, dp[0].shape[dp[1]] * b)
    rows = slice(start, start + b)
    if isinstance(draws, torch.Generator):
        t = torch.sigmoid(torch.randn(total, generator=draws,
                                      device=x0.device))
        x1 = torch.randn((total, *x0.shape[1:]), generator=draws,
                         device=x0.device)
        drop = draws if dp is None else BatchRows(draws, start, start + b,
                                                  total)
        return t[rows], x1[rows], {m: drop for m in _MODALITIES}
    dropout = draws.get("dropout") or {}
    masks = {m: dropout.get(m) for m in _MODALITIES}
    if dp is not None:
        masks = {m: None if v is None else [mask[rows] for mask in v]
                 for m, v in masks.items()}
    return (draws["t"][rows].to(x0.device, torch.float32),
            draws["noise"][rows].to(x0.device, torch.float32), masks)


def flow_match_loss(params: Dict[str, Any], flux_cfg: FluxConfig,
                    batch: Dict[str, torch.Tensor], draws: Draws,
                    flags: Optional[Dict[str, Any]] = None,
                    use_brain_condition: bool = False, fuse_flag: bool = True,
                    remat: bool = False, dtype=torch.bfloat16,
                    fuse_ln: bool = False, fuse_gate: bool = False):
    """One flow-matching MSE step -> (loss, mean t), float32 scalars, over
    this rank's rows under a data axis (the draws: `_draws`).

    batch: x0 [B, S, C] clean packed latents; img_ids / txt_ids;
    prompt_embeds / pooled; optional cond_tokens / cond_ids; optional
    eeg / ppg / fnirs / motion (the CS3 encoders' dropout is active);
    fuse_ln / fuse_gate: the DiT's fused elementwise forms (LOONGX_FUSE_LN /
    LOONGX_FUSE_GATE in the JAX package)."""
    x0 = batch["x0"].float()
    t, x1, dropout = _draws(draws, x0)
    x_t = flow_match_xt(x0, x1, t).to(dtype)
    prompt_embeds = batch["prompt_embeds"].to(dtype)
    pooled = batch["pooled"].to(dtype)

    if use_brain_condition and "eeg" in batch:
        enc, dgf = params["encoders"], params["dgf"]
        eeg_feat = eeg_encode(enc["eeg"], batch["eeg"].to(dtype),
                              dropout=dropout["eeg"])
        brain_prompt = eeg_feat
        if "ppg" in batch:
            brain_prompt = fuse_eeg_ppg(dgf, eeg_feat, ppg_encode(
                enc["ppg"], batch["ppg"].to(dtype), dropout=dropout["ppg"]))
        brain_pooled = None
        if "fnirs" in batch:
            brain_pooled = fnirs_encode(enc["fnirs"], batch["fnirs"].to(dtype),
                                        dropout=dropout["fnirs"])
            if "motion" in batch:
                brain_pooled = fuse_fnirs_motion(dgf, brain_pooled, motion_encode(
                    enc["motion"], batch["motion"].to(dtype),
                    dropout=dropout["motion"]))
        if fuse_flag:
            prompt_embeds, pooled = fuse_text_train(
                dgf, prompt_embeds, pooled, brain_prompt, brain_pooled)
        else:
            prompt_embeds = brain_prompt.to(dtype)
            if brain_pooled is not None:
                pooled = brain_pooled.to(dtype)

    b = x0.shape[0]
    guidance = (torch.ones(b, dtype=torch.float32, device=x0.device)
                if flux_cfg.guidance_embeds else None)
    cond = batch.get("cond_tokens")
    pred = flux_forward(
        params["flux"], flux_cfg, img=x_t, txt=prompt_embeds, pooled=pooled,
        timestep=t, guidance=guidance, img_ids=batch["img_ids"],
        txt_ids=batch["txt_ids"], cond=None if cond is None else cond.to(dtype),
        cond_ids=batch.get("cond_ids"), flags=flags, remat=remat,
        fuse_ln=fuse_ln, fuse_gate=fuse_gate)
    loss = torch.mean((pred.float() - (x1 - x0)) ** 2)
    return loss, torch.mean(t)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


class TrainState(NamedTuple):
    trainable: Any
    optimizer: torch.optim.Optimizer
    step: int


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, accumulated in float32."""
    sq = [torch.sum(g.float() ** 2) for g in grads]
    return torch.sqrt(torch.stack(sq).sum())


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum float32 ``tensors`` over ``group`` in place, as one flat
    buffer (one collective)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def mesh_grads(grads: List[torch.Tensor], paths: List[str]
               ) -> List[torch.Tensor]:
    """The one-process gradients from this rank's, under the active mesh:
    in float32, the leaves a tensor split leaves partial
    (`tensor_partial_grad`) summed over the tensor group, then every leaf
    summed over the data group and divided by its extent (the mean over
    the global batch); cast back to each leaf's dtype."""
    tp, dp = current_tp(), current_dp()
    if tp is None and dp is None:
        return grads
    g32 = [g.to(torch.float32, copy=True) for g in grads]
    if tp is not None:
        partial = [g for g, path in zip(g32, paths)
                   if tensor_partial_grad(path)]
        if partial:
            _all_reduce_flat(partial, tp[0].group(tp[1]))
    if dp is not None:
        _all_reduce_flat(g32, dp[0].group(dp[1]))
        for g in g32:
            g.div_(dp[0].shape[dp[1]])
    return [g.to(orig.dtype) for g, orig in zip(g32, grads)]


def data_mean(values: List[torch.Tensor]) -> List[torch.Tensor]:
    """Float32 scalars averaged over the active data group (as they are
    outside one)."""
    dp = current_dp()
    if dp is None:
        return values
    both = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(both, group=dp[0].group(dp[1]))
    return list(both / dp[0].shape[dp[1]])


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: g if norm < max_norm else (g / norm) *
    max_norm (no epsilon, unlike torch.nn.utils.clip_grad_norm_)."""
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


def make_train_step(flux_cfg: FluxConfig, optimizer: OptimizerFactory,
                    flags: Optional[Dict[str, Any]] = None,
                    use_brain_condition: bool = False, fuse_flag: bool = True,
                    remat: bool = True, grad_clip: Optional[float] = 0.5,
                    dtype=torch.bfloat16, fuse_ln: bool = False,
                    fuse_gate: bool = False) -> Tuple[Callable, Callable]:
    """(init_fn, step_fn) with the JAX package's contract:

      init_fn(trainable) -> TrainState
      step_fn(state, frozen, batch, draws) -> (state, metrics)

    ``metrics``: loss, grad_norm (before clipping), t_mean (float32 scalar
    tensors on the params' device).  The trainable leaves are updated in
    place; the returned state counts one more step.  ``grad_clip`` None or
    0 leaves clipping to the caller.  ``fuse_ln`` / ``fuse_gate`` as in
    `flow_match_loss`.

    Under `parallel.mesh.mesh_context` (which must be active around the
    call: the remat backward re-runs the forward's collectives) the frozen
    tree is the rank's shard (`shard_params`), the batch its rows
    (`shard_batch`), the trainable leaves whole and equal on every rank;
    the draws are the global batch's (see `flow_match_loss`), the
    gradients `mesh_grads`, the loss and t_mean the data means, so every
    rank takes the same optimizer step, the one-process step at the global
    batch.

    Spans (`utils.profiling`): ``train.step`` around ``train.forward``,
    ``train.backward`` (remat's re-runs inside it, ``train.recompute``),
    ``train.grad_sync``, ``train.clip`` and ``train.optimizer``."""
    flags = dict(flags or {})

    def init_fn(trainable) -> TrainState:
        params = [p for p in leaves(trainable) if p is not None]
        for p in params:
            p.requires_grad_(True)
        return TrainState(trainable, optimizer(params), 0)

    def step_fn(state: TrainState, frozen, batch, draws: Draws):
        with span("train.step"):
            params = combine(state.trainable, frozen)
            with span("train.forward"):
                loss, t_mean = flow_match_loss(
                    params, flux_cfg, batch, draws, flags,
                    use_brain_condition, fuse_flag, remat, dtype, fuse_ln,
                    fuse_gate)
            group = state.optimizer.param_groups[0]["params"]
            with span("train.backward"):
                grads = list(torch.autograd.grad(loss, group))
            paths = [path for path, p in tree_paths(state.trainable)
                     if p is not None]
            if len(paths) != len(group):
                raise RuntimeError(f"the optimizer holds {len(group)} "
                                   f"leaves, the trainable tree "
                                   f"{len(paths)}")
            with span("train.grad_sync"):
                grads = mesh_grads(grads, paths)
                loss, t_mean = data_mean([loss, t_mean])
            with span("train.clip"):
                norm = global_norm(grads)
                if grad_clip:
                    grads = clip_by_global_norm(grads, grad_clip, norm)
            for p, g in zip(group, grads):
                p.grad = g
            with span("train.optimizer"):
                state.optimizer.step()
                state.optimizer.zero_grad(set_to_none=True)
            metrics = {"loss": loss.detach(), "grad_norm": norm.detach(),
                       "t_mean": t_mean.detach()}
        return state._replace(step=state.step + 1), metrics

    return init_fn, step_fn
