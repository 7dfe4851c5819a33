"""The training loop (counterpart of ``loongx_tpu/train/loop.py``): config
-> dataset -> pipeline -> LoRA -> micro-steps with gradient accumulation
and the clip inside it -> callbacks (console, wandb, LoRA files, train
states, probe images) -> the final save, with resume from the newest train
state under ``save_path``.

One process a rank, as ``torchrun`` starts them (or one process alone, on
a GPU or, for tests, the CPU): the config's ``mesh: {tensor: t}`` splits
the DiT over t ranks (tensor parallelism) and the rest of the world
splits each global batch (data parallelism); ``mesh.data``, where given,
must equal world / t.  Each rank keeps its shard of the frozen tree
(`parallel.mesh.shard_params`), loads and prepares only its rows of each
global batch of ``batch_size`` x data rows (the ranks of one data index
the same rows), and runs the step under `parallel.mesh.mesh_context`:
the step draws for the global batch and averages the LoRA gradients over
the mesh, so every rank takes the optimizer step one process takes at
the global batch.  Only global rank 0 writes LoRA files and train states,
opens wandb and prints the step lines; the probe runs on the tensor ranks
of data index 0 (its ``generate()`` needs their collectives) and rank 0
writes its image; every rank resumes from the same train state.

Random draws.  The JAX package's ``jax.random`` stream cannot be
reproduced in PyTorch.  Each micro-step's (t, x1, dropout masks) come from
a ``torch.Generator`` on the pipeline's device seeded with ``train.seed``;
a resumed run at optimizer step s > 0 seeds it from (seed, s) instead,
which is what JAX's ``fold_in(key(seed), s)`` stands for: the resumed
steps do not replay the draws of steps 0..s.  The draws go through the
module-level `micro_step_draws`, and the LoRA leaves are added through
``lora.add_lora`` looked up on its module, so a test can substitute JAX's
draws and JAX's LoRA init.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from loongx_tpu_torch.config import Config
from loongx_tpu_torch.data.datasets import build_dataset
from loongx_tpu_torch.data.loader import background_iter, iterate_batches
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, mesh_context, shard_params,
)
from loongx_tpu_torch.train import lora
from loongx_tpu_torch.train.callbacks import TRAIN_STATE_DIR, TrainingCallback
from loongx_tpu_torch.train.optim import MultiSteps, build_optimizer
from loongx_tpu_torch.train.prepare import build_text_cache, prepare_batch
from loongx_tpu_torch.train.step import (
    combine, make_train_step, partition, trainable_mask,
)
from loongx_tpu_torch.utils import checkpoint as ckpt

# where a run of the JAX package keeps its (orbax) train states: found and
# refused on resume rather than silently passed over
JAX_TRAIN_STATE_DIR = "orbax"


def micro_step_draws(generator: torch.Generator, batch: Dict[str, Any]):
    """The draws of one micro-step, as `train.step` takes them: the
    generator itself (the step draws t, x1 and the encoders' dropout masks
    from it).  A test replaces this function to feed the JAX package's
    draws."""
    return generator


def draw_seed(seed: int, start_step: int) -> int:
    """The draw generator's seed: ``seed`` for a fresh run, a hash of
    (seed, start_step) for a run resumed at ``start_step``."""
    if not start_step:
        return seed
    return int(np.random.SeedSequence([seed, start_step]).generate_state(1)[0])


def train_mesh(config: Config, device) -> Mesh:
    """The run's mesh: ``tensor`` from ``config.mesh``, data the ranks
    that remain (`parallel.make_mesh`: the group torchrun describes, the one
    already initialised, or this process alone).  A ``mesh.data`` that
    disagrees with that is refused: the JAX package's picks a subset of a
    host's devices, the port's world is the processes that were started."""
    spec = config.mesh or {}
    tensor, data = int(spec.get("tensor", 1)), int(spec.get("data", 0))
    mesh = make_mesh(data=-1, tensor=tensor, device=device)
    world = mesh.shape["data"] * tensor
    if data > 0 and data != mesh.shape["data"]:
        raise ValueError(
            f"config mesh data={data} disagrees with the world: "
            f"{world} process(es) at tensor={tensor} make data "
            f"{mesh.shape['data']}.  Start data x tensor processes "
            "(torchrun --nproc-per-node ...) or leave mesh.data unset")
    return mesh


def _resume(save_path: str, fingerprint: Dict[str, Any], state, log=print):
    """Load the newest train state under ``save_path`` (the newest run that
    has one) into ``state``; returns the optimizer step it holds (0: none
    found).  A fingerprint that differs from the current config's, or a
    JAX package's run, is refused."""
    runs = sorted(os.listdir(save_path), reverse=True) if os.path.isdir(
        save_path) else []
    for prior in runs:
        for sub in (TRAIN_STATE_DIR, JAX_TRAIN_STATE_DIR):
            state_dir = os.path.join(save_path, prior, sub)
            ck = ckpt.latest_checkpoint(state_dir)
            if ck:
                break
        if not ck:
            continue
        prior_fp = ckpt.load_fingerprint(state_dir)
        if prior_fp is not None and prior_fp != fingerprint:
            diff = {k: (prior_fp.get(k), fingerprint.get(k))
                    for k in set(prior_fp) | set(fingerprint)
                    if prior_fp.get(k) != fingerprint.get(k)}
            raise RuntimeError(
                f"refusing to resume from {ck}: its config fingerprint "
                f"mismatches the current config (saved vs current): {diff}. "
                "Pass resume=False or use a fresh save_path for the new "
                "configuration.")
        if prior_fp is None:
            log(f"[train] warning: {state_dir} has no config fingerprint "
                "-- resuming without a compatibility check")
        start_step = ckpt.load_train_checkpoint(ck, state.trainable,
                                                state.optimizer)
        log(f"[train] resumed from {ck} @ step {start_step}")
        return start_step
    return 0


def train(config: Config, pipeline: Optional[LoongXPipeline] = None,
          dataset=None, max_steps: Optional[int] = None, resume: bool = True,
          use_wandb: Optional[bool] = None, device="cuda") -> Dict[str, Any]:
    """Run training per ``config``; returns {"steps", "wall_s",
    "final_loss"}.  ``pipeline`` / ``dataset`` may be injected (tests);
    by default both come from the config (the pipeline directory at
    ``config.flux_path``, loaded onto ``device``).  ``max_steps`` counts
    optimizer steps: the loop runs max_steps x accumulate_grad_batches
    micro-batches.  The final weights are left in ``pipeline.params``
    (under a tensor axis the frozen leaves are this rank's shard).
    ``device``: the pipeline's device ("cuda": cuda:LOCAL_RANK); with an
    injected pipeline its own."""
    tcfg = config.train
    mesh = train_mesh(config, pipeline.device if pipeline is not None
                      else device)
    device = mesh.device
    data = mesh.shape["data"]
    is_main = mesh.rank == 0
    log = print if is_main else (lambda *a, **k: None)
    np.random.seed(tcfg.seed)
    run_name = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")

    if dataset is None:
        dataset = build_dataset(tcfg, device=device)

    # staged text: encode every prompt the dataset can emit with only T5 /
    # CLIP resident, free them, then load the DiT (build_text_cache)
    text_cache = None
    if tcfg.staged_text:
        descs = (dataset.descriptions() if hasattr(dataset, "descriptions")
                 else [dataset[i].get("description", "")
                       for i in range(len(dataset))])
        if pipeline is None:
            text_pipe = LoongXPipeline.from_pretrained(
                config.flux_path, components=("t5", "clip"), device=device)
            text_cache = build_text_cache(text_pipe, descs)
            text_pipe.free_text_encoders()
            del text_pipe
            gc.collect()
            log(f"[train] staged_text: {len(text_cache[0])} prompts "
                "cached; text encoders freed")
            pipeline = LoongXPipeline.from_pretrained(
                config.flux_path, components=("flux", "vae", "encoders", "dgf"),
                device=device)
        else:
            text_cache = build_text_cache(pipeline, descs)
            pipeline.free_text_encoders()
    elif pipeline is None:
        pipeline = LoongXPipeline.from_pretrained(config.flux_path,
                                                  device=device)
    device = pipeline.device

    lcfg = tcfg.lora_config
    pipeline.params["flux"] = lora.add_lora(
        pipeline.params["flux"], r=lcfg.r, alpha=lcfg.lora_alpha,
        dtype=pipeline.dtype,
        generator=torch.Generator(device=device).manual_seed(tcfg.seed))
    trainable, frozen = partition(
        pipeline.params,
        trainable_mask(pipeline.params, train_encoders=tcfg.train_encoders))

    # the clip acts on the accumulated mean, once an optimizer step (as
    # Lightning's gradient_clip_val); None / 0 disables it
    accum = max(1, tcfg.accumulate_grad_batches)
    inner = build_optimizer(tcfg.optimizer)
    clip = tcfg.gradient_clip_val or None

    def optimizer(params):
        return MultiSteps(inner(params), accum, clip)

    use_brain = tcfg.dataset.type.lower() == "seed"
    if use_brain and "encoders" not in pipeline.params:
        raise RuntimeError(
            "dataset.type='seed' trains with biosignal conditioning, but "
            "the pipeline has no 'encoders' (CS3) params -- load a checkpoint "
            "converted with the biosignal components, or use a spatial "
            "dataset type")
    init_fn, step_fn = make_train_step(
        pipeline.flux_cfg, optimizer, flags=config.model.to_dict(),
        use_brain_condition=use_brain, fuse_flag=True,
        remat=tcfg.gradient_checkpointing, grad_clip=None,
        dtype=pipeline.dtype)
    state = init_fn(trainable)
    # the config facts a resume must match (a changed batch size or seed
    # would fast-forward a different data stream)
    fingerprint = {
        "lora_r": lcfg.r,
        "lora_alpha": lcfg.lora_alpha,
        "dataset_type": tcfg.dataset.type,
        "optimizer": tcfg.optimizer.type,
        "condition_type": tcfg.condition_type,
        "accumulate_grad_batches": tcfg.accumulate_grad_batches,
        # the global batch: the data stream a resumed run must continue
        "batch_size": tcfg.batch_size * data,
        "seed": tcfg.seed,
        "train_encoders": tcfg.train_encoders,
        "flux_blocks": [pipeline.flux_cfg.num_double_blocks,
                        pipeline.flux_cfg.num_single_blocks],
    }
    start_step = (_resume(tcfg.save_path, fingerprint, state, log) if resume
                  else 0)
    # the step counts micro-batches; the checkpoint holds optimizer steps
    state = state._replace(step=start_step * accum)
    # this rank's shard of the frozen tree (whole where no rule splits it)
    frozen = shard_params(frozen, mesh)
    pipeline.params = combine(trainable, frozen)

    # the periodic probe renders the first sample with the live LoRA leaves
    # (the step updates them in place)
    sample_fn = None
    if tcfg.sample_interval and len(dataset) > 0 and mesh.data_index == 0:
        try:
            from loongx_tpu_torch.train.sampling_probe import SampleProbe

            probe_sample = dataset[0]
            biosig = {key: probe_sample[k]
                      for k, key in (("eeg", "EEG"), ("fnirs", "FNIRS"),
                                     ("ppg", "PPG"), ("motion", "Motion"))
                      if probe_sample.get(k) is not None}
            if biosig and "encoders" not in pipeline.params:
                print("[train] probe: pipeline has no biosignal encoders -- "
                      "probing without the sample's signals")
                biosig = {}
            sample_fn = SampleProbe(
                pipeline, condition_type=tcfg.condition_type,
                probe_image=probe_sample.get("condition"),
                prompt=probe_sample.get("description", ""),
                biosignals=biosig or None,
                out_dir=os.path.join(tcfg.save_path, run_name, "samples"),
                size=tcfg.dataset.target_size,
                trainable_view=lambda: state.trainable, text_cache=text_cache,
                write=is_main)
        except Exception as exc:
            print(f"[train] sample probe unavailable: {exc}")

    callback = TrainingCallback(
        run_name=run_name, save_path=tcfg.save_path,
        save_interval=tcfg.save_interval, sample_interval=tcfg.sample_interval,
        use_wandb=(use_wandb if use_wandb is not None else bool(tcfg.wandb))
        and is_main,
        wandb_config=tcfg.wandb, sample_fn=sample_fn, frozen=frozen,
        fingerprint=fingerprint, print_interval=10 if is_main else 0,
        writer=is_main)

    total = tcfg.max_steps if max_steps is None else max_steps
    if total is None or total < 0:  # -1: unlimited
        total = float("inf")
    total_micro = total * accum
    start_micro = start_step * accum
    generator = torch.Generator(device=device).manual_seed(
        draw_seed(tcfg.seed, start_step))
    t0 = time.time()
    micro = start_micro
    metrics: Dict[str, Any] = {}
    window = []  # the metrics of the open accumulation window

    def device_batches():
        # resume: skip the batches the earlier run consumed
        for host_batch in iterate_batches(
                dataset, tcfg.batch_size * data, seed=tcfg.seed,
                num_workers=tcfg.dataloader_workers,
                skip_batches=start_micro, data_index=mesh.data_index,
                data_size=data):
            yield prepare_batch(pipeline, host_batch,
                                position_scale=tcfg.dataset.position_scale,
                                text_cache=text_cache)

    if total_micro > start_micro:
        # one-deep lookahead: the next batch's decode and frozen encoders
        # run while the current step does; the mesh context around the
        # steps and the probe
        with contextlib.closing(background_iter(
                device_batches(), depth=1)) as batches, mesh_context(mesh):
            for batch in batches:
                if micro >= total_micro:
                    break
                state, metrics = step_fn(state, frozen, batch,
                                         micro_step_draws(generator, batch))
                window.append(metrics)
                micro += 1
                if micro % accum == 0:
                    # callbacks fire per optimizer step; loss and grad norm
                    # are averaged over the window the optimizer saw
                    agg = dict(metrics)
                    for k in ("loss", "grad_norm"):
                        agg[k] = torch.stack([w[k] for w in window]).mean()
                    window.clear()
                    callback.on_step_end(micro // accum, agg, state)
    step = micro // accum
    wall = time.time() - t0
    log(f"[train] {step - start_step} optimizer steps "
        f"({micro - start_micro} micro-batches) in {wall:.1f}s "
        f"({(micro - start_micro) / max(wall, 1e-9):.2f} micro-steps/s)")
    callback.save_checkpoint(step, state)
    if data * mesh.shape["tensor"] > 1:
        dist.barrier()  # rank 0's files are written when any rank returns
    pipeline.params = combine(state.trainable, frozen)
    return {"steps": step, "wall_s": wall,
            "final_loss": float(metrics.get("loss", np.nan)) if metrics
            else None}
