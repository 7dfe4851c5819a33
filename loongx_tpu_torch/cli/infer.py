"""Inference CLI: single-image and directory batch neural-driven editing,
served from a pipeline directory (counterpart of ``loongx_tpu/cli/infer.py``).

    python -m loongx_tpu_torch.cli.infer --checkpoint <dir> \\
        --single_image in.png --prompt "" --brain_data_path brain.pkl --int8
    python -m loongx_tpu_torch.cli.infer --checkpoint <dir> \\
        --input_dir images/ --output_dir out/ --batch_size 2 [--timing] ...

The checkpoint is a directory written by ``python -m
loongx_tpu_torch.cli.convert`` (or `utils.checkpoint.save_pipeline`).  The
deployed mode is the reference's: ``fuse_flag=False`` (brain embeds
*replace* the text embeds), ``--fuse`` to fuse them.  Biosignals come from a
pickle {image file name: {"EEG", "FNIRS", "PPG", "Motion"}}.

One process serves on one device, the GPU unless ``--device cpu``; a
missing GPU is an error.  Several processes serve over a data x tensor
layout (`parallel.mesh`), one per rank, as ``torchrun`` starts them:

    torchrun --nproc-per-node 4 -m loongx_tpu_torch.cli.infer --tensor 2 \
        --checkpoint <dir> --input_dir images/ --int8 ...

``--tensor T`` splits the DiT's heads and MLP columns over T ranks (the
TP-layout int8 bundle: q/k/v unfused, then fused in the TP layout, proj_out
whole), each rank holding its shard on cuda:LOCAL_RANK; the remaining
ranks form the data axis, each data rank editing its rows of every group
(the tail group padded to divide the data axis).  Tensor index 0 of each
data rank writes its images; rank 0 writes the single image and prints
the log.

Serving knobs are the JAX package's environment variables, read once in
`main` (`serving_knobs`) and passed as the ``w8a8`` / ``int8_attn`` /
``fuse_ln`` / ``fuse_gate`` arguments of ``neural_edit`` and ``generate``:
LOONGX_W8A8=1, LOONGX_INT8_ATTN=1, LOONGX_FUSE_LN=1, LOONGX_FUSE_GATE=1.

Images are read and written with Pillow, as the JAX package does.

Random draws come from ``torch.Generator(device).manual_seed(seed)``: the
latents first, then the condition's VAE-sample noise, in both modes, so one
image gives the same edit at every ``--batch_size`` and in
``--single_image`` mode.  `edit_one` and `batch_edit` also take the draws
as arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

KNOBS = {"w8a8": "LOONGX_W8A8", "int8_attn": "LOONGX_INT8_ATTN",
         "fuse_ln": "LOONGX_FUSE_LN", "fuse_gate": "LOONGX_FUSE_GATE"}

def serving_knobs() -> Dict[str, bool]:
    """The JAX package's serving env knobs as `neural_edit` / `generate`
    arguments ("1" switches one on)."""
    return {arg: os.environ.get(name, "0") == "1"
            for arg, name in KNOBS.items()}


def require_device(parser, device: str) -> None:
    """Refuse (``parser.error``) a CUDA ``--device`` where no card is
    available: the entry points serve on the GPU unless asked for the CPU."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is available "
                     "(pass --device cpu to run on the CPU)")


def read_image(path: str, size: int):
    """The image file as the JAX package reads it: a PIL RGB image resized
    to ``size`` x ``size``."""
    from PIL import Image

    return Image.open(path).convert("RGB").resize((size, size))


def write_image(path: str, image: np.ndarray) -> None:
    """Write uint8 RGB [H, W, 3] in the format the extension names."""
    from PIL import Image

    Image.fromarray(image).save(path)


def load_brain_data(pkl_path: str) -> Dict:
    if not pkl_path or not os.path.exists(pkl_path):
        print(f"[infer] warning: brain data file {pkl_path!r} not found")
        return {}
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def load_captions(path: Optional[str]) -> Dict[str, str]:
    caps: Dict[str, str] = {}
    if not path or not os.path.exists(path):
        return caps
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            row = json.loads(line)
            name = row.get("source_image", "").split("/")[-1]
            caps[name] = row.get("speech2text") or row.get("instruction", "")
    return caps


def edit_one(pipeline, image_path: str, prompt: str,
             condition_type: str = "subject", target_size: int = 512,
             position_delta=(0, -32), brain: Optional[Dict] = None,
             seed: int = 42, fuse_flag: bool = False, num_steps: int = 28,
             guidance: float = 3.5, neural_only: bool = False, *,
             latents=None, cond_noise=None,
             knobs: Optional[Dict[str, bool]] = None) -> np.ndarray:
    """Edit one image -> uint8 [H, W, 3].  With EEG and fNIRS in replace
    mode the fused ``neural_edit`` serves it, else ``generate``.
    ``latents`` / ``cond_noise`` replace the draws from ``seed``;
    ``knobs`` are `serving_knobs`."""
    from loongx_tpu_torch.sampling import generate as sampling
    from loongx_tpu_torch.sampling.condition import Condition

    img = read_image(image_path, target_size)
    cond = Condition(condition_type=condition_type, raw_img=img,
                     position_delta=position_delta, device=pipeline.device)
    brain = brain or {}
    use_brain = any(brain.get(k) is not None
                    for k in ("EEG", "FNIRS", "PPG", "Motion"))
    kw = dict(latents=latents, cond_noise=cond_noise, **(knobs or {}))
    if (not fuse_flag and brain.get("EEG") is not None
            and brain.get("FNIRS") is not None):
        # the deployed replace mode with both embedding slots covered
        out = sampling.neural_edit(
            pipeline, cond.condition, eeg=brain.get("EEG"),
            ppg=brain.get("PPG"), fnirs=brain.get("FNIRS"),
            motion=brain.get("Motion"), condition_type=condition_type,
            height=target_size, width=target_size,
            num_inference_steps=num_steps, guidance_scale=guidance, seed=seed,
            position_delta=position_delta, output_type="uint8", **kw)
        return out[0]
    out = sampling.generate(
        pipeline, prompt=prompt, conditions=[cond], height=target_size,
        width=target_size, num_inference_steps=num_steps,
        guidance_scale=guidance, seed=seed, eeg=brain.get("EEG"),
        fnirs=brain.get("FNIRS"), ppg=brain.get("PPG"),
        motion=brain.get("Motion"), use_brain_condition=use_brain,
        fuse_flag=fuse_flag, neural_only=neural_only, output_type="uint8",
        **kw)
    return out[0]


def list_images(input_dir: str):
    return sorted(f for f in os.listdir(input_dir)
                  if f.lower().endswith((".png", ".jpg", ".jpeg")))


def _effective_brain(brain: Dict) -> Dict:
    """Per-image effective signal set, reference semantics: brain
    conditioning engages iff EEG or fNIRS is present; PPG fuses only
    alongside EEG and Motion only alongside fNIRS (pairwise DGF), so a
    PPG/Motion without its partner is dropped here."""
    eff = {}
    if brain.get("EEG") is not None:
        eff["EEG"] = brain["EEG"]
        if brain.get("PPG") is not None:
            eff["PPG"] = brain["PPG"]
    if brain.get("FNIRS") is not None:
        eff["FNIRS"] = brain["FNIRS"]
        if brain.get("Motion") is not None:
            eff["Motion"] = brain["Motion"]
    return eff


def staged_text_encode(checkpoint, files, captions, default_prompt,
                       int8=False, chunk=8, max_sequence_length=None,
                       device="cuda"):
    """Phase 1 of the staged fuse recipe: load only the text encoders and
    tokenizers, encode every file's prompt in batches of ``chunk``, return
    per-file float32 (prompt_embed, pooled) numpy arrays, and drop the
    encoders, so the DiT loads into the freed memory."""
    import gc

    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    tp = LoongXPipeline.from_pretrained(checkpoint, components=("t5", "clip"),
                                        device=device)
    if max_sequence_length is not None:
        tp.max_sequence_length = max_sequence_length
    if int8:
        tp.quantize(dit=False)
    prompts = [captions.get(f, default_prompt or "") for f in files]
    embeds: Dict[str, tuple] = {}
    for s in range(0, len(files), chunk):
        pe, pl, _ = tp.encode_text(prompts[s:s + chunk])
        pe, pl = pe.float().cpu().numpy(), pl.float().cpu().numpy()
        for i, f in enumerate(files[s:s + chunk]):
            embeds[f] = (pe[i], pl[i])
    print(f"[infer] staged text encode: {len(embeds)} prompts embedded; "
          "freeing text encoders")
    tp.free_text_encoders()
    del tp
    gc.collect()
    return embeds


def batch_edit(pipeline, args, brain_data, captions, text_embeds=None, *,
               latents=None, cond_noise=None,
               knobs: Optional[Dict[str, bool]] = None, mesh=None):
    """Directory batch mode: the images of ``args.input_dir`` edited in
    groups of ``args.batch_size`` (default: the data extent; rounded up to
    a multiple of it), one ``generate`` call a group on each data rank of
    ``mesh`` (`parallel.mesh.Mesh`; None: this process alone) over its rows
    of the group, the tail group padded by repeating its last image; each
    image written under its own name to ``args.output_dir`` by tensor index
    0 of the data rank that edited it.  The pipeline holds this rank's
    shard; the model runs under ``mesh_context(mesh)``.

    Reference-parity semantics (an image's result does not depend on the
    directory around it or on ``--batch_size``):

      * every image gets the same seed's initial noise and VAE-sample
        noise, drawn as the single-image path draws them;
      * biosignals are looked up per image: files are bucketed by their
        effective signal coverage and each bucket runs with exactly its
        signals; uncovered images are edited without brain conditioning,
        with a warning;
      * the named-adapter switch applies per generate call
        (``condition_type=args.condition_type``);
      * ``args.decode_chunk`` bounds the images a decode step takes (None:
        the whole group); the VAE decodes one image a call whatever the
        chunk (`vae_decode`), so the result does not depend on it.

    ``text_embeds``: optional {fname: (prompt_embed, pooled)} from
    `staged_text_encode`.  ``latents`` [1, S, C] / ``cond_noise`` replace
    the draws; ``knobs`` are `serving_knobs`."""
    import contextlib

    import torch

    from loongx_tpu_torch.models.encoders import canonicalise_signal
    from loongx_tpu_torch.ops.latents import latent_image_ids, shift_ids
    from loongx_tpu_torch.sampling import generate as sampling
    from loongx_tpu_torch.sampling.condition import (
        _to_numpy_image, synthesize_condition_image,
    )

    from loongx_tpu_torch.parallel.mesh import (
        make_mesh, mesh_context, shard_batch,
    )
    from loongx_tpu_torch.utils import profiling
    from loongx_tpu_torch.utils.profiling import span

    if mesh is None:
        mesh = make_mesh(device=pipeline.device)
    timing = bool(getattr(args, "timing", False))
    n_data, lead = mesh.shape["data"], mesh.rank == 0
    os.makedirs(args.output_dir, exist_ok=True)
    files = list_images(args.input_dir)
    device, dtype = pipeline.device, pipeline.dtype
    group = max(args.batch_size or n_data, 1)
    group = -(-group // n_data) * n_data  # a multiple of the data axis

    # ---- per-image brain lookup, bucketed by effective coverage ----
    buckets: Dict[tuple, list] = {}
    eff_of: Dict[str, Dict] = {}
    for fname in files:
        brain = brain_data.get(fname, {})
        eff = _effective_brain(brain)
        for k, partner in (("PPG", "EEG"), ("Motion", "FNIRS")):
            if brain.get(k) is not None and k not in eff:
                print(f"[infer] warning: {fname}: {k} present without "
                      f"{partner} — {k} only fuses alongside {partner}; "
                      "it is ignored")
        if brain_data and not eff:
            print(f"[infer] warning: {fname}: no EEG/fNIRS in brain data — "
                  "edited WITHOUT brain conditioning")
        eff_of[fname] = eff
        buckets.setdefault(tuple(sorted(eff)), []).append(fname)
    if getattr(args, "neural_only", False):
        # fail before any compute: under --neural_only no text embeds back a
        # missing slot, so every image needs EEG+FNIRS
        bad = [f for f in files if not {"EEG", "FNIRS"} <= set(eff_of[f])]
        if bad:
            raise SystemExit(
                f"[infer] --neural_only requires EEG+FNIRS brain coverage "
                f"for every image (brain embeds replace the text embeds; "
                f"there is nothing to back a missing slot), but "
                f"{len(bad)}/{len(files)} images lack it: {bad[:5]}"
                + ("..." if len(bad) > 5 else ""))
    order = sorted(buckets, key=lambda s: (len(s), s))
    if lead:
        print(f"[infer] {len(files)} images, groups of {group} on mesh "
              f"{dict(mesh.shape)}"
              + (f", {len(buckets)} brain-coverage buckets {order}"
                 if len(buckets) > 1 else ""))
    size = args.target_size
    lat_h = lat_w = size // pipeline.vae_cfg.downscale
    n_tok = (lat_h // 2) * (lat_w // 2)
    # one seed's draws shared by every image, in the single-image path's
    # order: the latents, then the condition's VAE-sample noise
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if latents is None:
        latents = torch.randn(1, n_tok, pipeline.flux_cfg.in_channels,
                              generator=gen, device=device)
    if cond_noise is None:
        cond_noise = torch.randn(1, lat_h, lat_w,
                                 pipeline.vae_cfg.latent_channels,
                                 generator=gen, device=device)
    latents = torch.as_tensor(latents).to(device)
    cond_noise = torch.as_tensor(cond_noise).to(device)

    def edit_group(sig, chunk, done):
        """Edit one group; this rank writes its images of it."""
        # pad the tail group to divide the data axis; this data rank's
        # rows of it (positions in the group)
        proc = chunk + [chunk[-1]] * ((-len(chunk)) % n_data)
        rows = shard_batch(torch.arange(len(proc)), mesh).tolist()
        mine = [proc[i] for i in rows]
        conds, prompts = [], []
        with torch.inference_mode():
            for fname in mine:
                img = read_image(os.path.join(args.input_dir, fname), size)
                cimg = synthesize_condition_image(args.condition_type,
                                                  img, device)
                arr = _to_numpy_image(cimg)[None]
                toks, h, w = pipeline.encode_image_tokens(
                    torch.as_tensor(arr, device=device), noise=cond_noise)
                conds.append(toks[0])
                prompts.append(captions.get(fname, args.prompt or ""))
        b = len(mine)
        cond_ids = shift_ids(latent_image_ids(h, w, device=device),
                             (args.position_delta_x,
                              args.position_delta_y))
        # biosignals: the bucket guarantees every image carries exactly
        # the signals in ``sig``
        kw = {}
        for key, name in (("EEG", "eeg"), ("FNIRS", "fnirs"),
                          ("PPG", "ppg"), ("Motion", "motion")):
            if key in sig:
                kw[name] = torch.stack([
                    canonicalise_signal(torch.as_tensor(
                        np.asarray(eff_of[f][key], np.float32),
                        device=device), name)[0]
                    for f in mine])
        if text_embeds is not None:
            tkw = {
                "prompt_embeds": torch.as_tensor(np.stack(
                    [text_embeds[f][0] for f in mine])).to(device, dtype),
                "pooled_prompt_embeds": torch.as_tensor(np.stack(
                    [text_embeds[f][1] for f in mine])).to(device, dtype),
            }
        else:
            tkw = {"prompt": prompts}
        with mesh_context(mesh):
            out = sampling.generate(
                pipeline, condition_type=args.condition_type,
                cond_tokens=torch.stack(conds), cond_ids=cond_ids,
                height=size, width=size, num_inference_steps=args.steps,
                guidance_scale=args.guidance, seed=args.seed,
                latents=latents.expand(b, -1, -1).to(dtype),
                use_brain_condition=bool(kw), fuse_flag=args.fuse,
                neural_only=args.neural_only, output_type="uint8",
                decode_chunk=getattr(args, "decode_chunk", None),
                **tkw, **kw, **(knobs or {}))
        for i, arr in zip(rows, out):
            if i >= len(chunk) or mesh.tensor_index:
                continue  # a padded row, or another rank writes it
            out_path = os.path.join(args.output_dir, chunk[i])
            write_image(out_path, arr)
            print(f"[infer] [{done + i + 1}/{len(files)}] {out_path}")

    done, times = 0, []
    with (profiling.spans_on() if timing else contextlib.nullcontext()):
        for sig in order:
            bucket = buckets[sig]
            for start in range(0, len(bucket), group):
                chunk = bucket[start:start + group]
                with span("infer.group"):
                    edit_group(sig, chunk, done)
                done += len(chunk)
                if not timing:
                    continue
                records = profiling.spans()
                profiling.clear_spans()
                dt = next(r for r in reversed(records)
                          if r.name == "infer.group").host_ms / 1e3
                times.extend([dt / len(chunk)] * len(chunk))
                if lead:
                    print(f"[infer] group of {len(chunk)}: {dt:.3f}s "
                          f"({dt / len(chunk):.3f}s/image end-to-end); "
                          + stage_report(records))
    if timing and times and lead:
        times.sort()
        p50 = times[len(times) // 2]
        print(f"[infer] wall-clock per-image p50 {p50:.3f}s over "
              f"{len(times)} images (host decode + condition synthesis + "
              f"denoise + PNG write)")


def stage_report(records) -> str:
    """One group's device ms per stage from its spans (`utils.profiling`):
    each stage that ran, the denoise per step, and the median over the
    steps of the queue wait (a step's device start less its host start:
    how long its first kernel waited behind queued work)."""
    def total(name):
        return sum(r.device_ms for r in records if r.name == name)

    names = {r.name for r in records}
    steps = [r for r in records if r.name == "edit.denoise.step"]
    parts = [f"{label} {total(name):.1f}" for label, name in (
        ("brain encode", "edit.brain_encode"),
        ("VAE encode", "edit.vae_encode")) if name in names]
    if steps:
        parts.append(f"denoise {total('edit.denoise.step') / len(steps):.1f}"
                     f"/step x {len(steps)}")
    if "edit.vae_decode" in names:
        parts.append(f"VAE decode {total('edit.vae_decode'):.1f}")
    line = "device ms: " + ", ".join(parts)
    if steps:
        waits = sorted((r.device_start_ns - r.host_start_ns) / 1e6
                       for r in steps)
        line += (f"; queue wait {waits[len(waits) // 2]:.1f} ms (median of "
                 f"{len(steps)} steps)")
    return line


def _tree_has_key(tree, key: str) -> bool:
    """True if ``key`` is a dict key anywhere in the nested param tree: the
    probe behind "is this tree int8" (kernel_q) and "does it carry the
    baked fused-qkv serving layout" (to_qkv)."""
    return isinstance(tree, dict) and (
        key in tree or any(_tree_has_key(v, key) for v in tree.values()))


def _load_lora_tree(pipeline, path: str):
    """Load a LoRA safetensors file (this package's and the JAX package's
    layout, or a reference-trained peft one) into the flux param tree."""
    from loongx_tpu_torch.utils.checkpoint import (
        _lora_file, load_lora_safetensors,
    )
    from safetensors import safe_open

    with safe_open(_lora_file(path), framework="pt") as f:
        keys = list(f.keys())
        if any(".lora_A." in k or ".lora_B." in k for k in keys):
            # reference-trained (peft / FluxPipeline.save_lora_weights)
            from loongx_tpu_torch.utils.convert import convert_reference_lora

            return convert_reference_lora({k: f.get_tensor(k) for k in keys},
                                          pipeline.params["flux"],
                                          pipeline.flux_cfg)
    return load_lora_safetensors(pipeline.params["flux"], path)


def _attach_lora(pipeline, path: str, name=None):
    """Bare path: merge into the base weights (kept as live deltas on an
    int8 base).  name=path: register a named adapter selected per condition
    type."""
    from loongx_tpu_torch.train.lora import lora_state_dict, merge_lora

    tree = _load_lora_tree(pipeline, path)
    if name is None:
        if _tree_has_key(tree, "kernel_q"):
            # merging would requantize the int8 weights (lossy) and
            # merge_lora refuses; linear() applies the deltas on top of the
            # int8 matmul exactly
            pipeline.params["flux"] = tree
            print(f"[infer] int8 base: serving LoRA {path} as live deltas")
            return
        pipeline.params["flux"] = merge_lora(tree)
        return
    from loongx_tpu_torch.train.adapters import AdapterRegistry

    if pipeline.adapters is None:
        pipeline.adapters = AdapterRegistry()
    pipeline.adapters.add(name, lora_state_dict(tree))
    # deactivated LoRA leaves in the live tree: switching is then a value
    # swap, and nothing applies until set_adapters selects one
    pipeline.params["flux"] = pipeline.adapters.deactivate(tree)
    pipeline.active_adapter = None
    print(f"[infer] registered adapter {name!r} from {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="LoongX inference on PyTorch (neural-driven image "
        "editing)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="pipeline directory written by "
                        "loongx_tpu_torch.cli.convert")
    parser.add_argument("--input_dir", type=str)
    parser.add_argument("--output_dir", type=str, default="outputs")
    parser.add_argument("--caption_path", type=str, default=None)
    parser.add_argument("--condition_type", type=str, default="subject")
    parser.add_argument("--target_size", type=int, default=512)
    parser.add_argument("--position_delta_x", type=int, default=0)
    parser.add_argument("--position_delta_y", type=int, default=-32)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--single_image", type=str)
    parser.add_argument("--prompt", type=str)
    parser.add_argument("--brain_data_path", type=str, default=None)
    parser.add_argument("--steps", type=int, default=28)
    parser.add_argument("--guidance", type=float, default=3.5)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="images per generate call (default 1)")
    parser.add_argument("--tensor", type=int, default=1,
                        help="tensor-parallel width: ranks (of a torchrun "
                        "launch) splitting the DiT; the others form the "
                        "data axis")
    parser.add_argument("--decode_chunk", type=int, default=None,
                        help="decode at most this many images per decode "
                        "step (default: the whole group)")
    parser.add_argument("--timing", action="store_true",
                        help="record the program's spans: report each "
                        "group's end-to-end wall-clock per image (host "
                        "decode + condition synthesis + denoise + PNG "
                        "write), its device ms per stage and queue wait, "
                        "and the p50 per image across the run")
    parser.add_argument("--fuse", action="store_true",
                        help="DUAN-fuse brain+text instead of replacing")
    parser.add_argument("--staged_text", action="store_true",
                        help="batch mode: encode ALL prompts up front with "
                        "only T5/CLIP loaded, free them, then load the DiT "
                        "and run the groups on precomputed embeds.  Combine "
                        "with --components flux,vae[,encoders,dgf] so the "
                        "second load leaves the encoders out")
    parser.add_argument("--neural_only", action="store_true",
                        help="allow running without text tokenizers (zero "
                        "text embeds; brain embeds replace them)")
    parser.add_argument("--int8", action="store_true",
                        help="int8-quantize DiT + text encoders at load (a "
                        "checkpoint converted with --quantize gets the "
                        "serving transforms instead); W8A8 via "
                        "LOONGX_W8A8=1")
    parser.add_argument(
        "--components", type=str, default=None,
        help="comma list of checkpoint components to load (e.g. "
        "'flux,vae,encoders,dgf': the deployed replace mode never runs the "
        "text encoders).  Default: everything in the checkpoint")
    parser.add_argument(
        "--lora", action="append", default=None,
        help="LoRA safetensors to load.  A bare path merges the adapter into "
        "the base weights.  Repeatable 'name=path' entries register named "
        "adapters selected per condition type at generate time (name them "
        "after condition types, e.g. --lora canny=./canny_lora)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.parallel.mesh import (
        make_mesh, mesh_context, rank_device, shard_params,
    )

    require_device(parser, args.device)
    device = rank_device(args.device)  # cuda:LOCAL_RANK under torchrun
    knobs = serving_knobs()
    components = (
        tuple(c.strip() for c in args.components.split(",") if c.strip())
        if args.components else None)
    captions = load_captions(args.caption_path)
    text_embeds = None
    if args.staged_text:
        # phase 1 before the DiT load: the text encoders get the whole card
        if not args.input_dir:
            parser.error("--staged_text applies to directory batch mode "
                         "(--input_dir)")
        text_embeds = staged_text_encode(
            args.checkpoint, list_images(args.input_dir), captions,
            args.prompt, int8=args.int8, device=device)
    pipeline = LoongXPipeline.from_pretrained(
        args.checkpoint, components=components, device=device)
    if args.staged_text and components is None:
        # prompts are already embedded; keep the encoders off the device
        pipeline.free_text_encoders()
    flux = pipeline.params.get("flux", {})
    if args.tensor > 1 and _tree_has_key(flux, "to_qkv"):
        parser.error(
            "--tensor > 1 on a checkpoint with baked serving transforms "
            "(fused qkv): the TP sharding rules address the unfused "
            "projection axes.  Re-convert without --serving for "
            "tensor-parallel serving.")
    if args.lora and _tree_has_key(flux, "to_qkv"):
        parser.error(
            "--lora on a checkpoint with baked serving transforms (fused "
            "qkv): LoRA adapters address the unfused q/k/v projections.  "
            "Re-convert without --serving to serve with LoRA.")
    try:
        mesh = make_mesh(data=-1, tensor=args.tensor, device=device)
    except ValueError as exc:
        parser.error(f"--tensor {args.tensor}: {exc}.  Tensor-parallel "
                     "serving runs one process per rank: torchrun "
                     "--nproc-per-node N -m loongx_tpu_torch.cli.infer "
                     f"--tensor {args.tensor} ... (README.md, Multi-GPU)")
    tp = args.tensor > 1
    if args.int8 and _tree_has_key(flux, "kernel_q"):
        # converted with --quantize: re-quantizing would be lossy; apply the
        # serving transforms (no-ops where the checkpoint baked them); under
        # tensor parallelism qkv fused in the TP layout, proj_out whole
        print("[infer] checkpoint already int8; applying serving transforms")
        from loongx_tpu_torch.ops.quant import (
            fuse_qkv_projections, split_single_proj_out,
        )

        if not args.lora:
            pipeline.params["flux"] = fuse_qkv_projections(
                pipeline.params["flux"], tp_layout=tp)
        if not tp:
            pipeline.params["flux"] = split_single_proj_out(
                pipeline.params["flux"], pipeline.flux_cfg.hidden)
    elif args.int8:
        # qkv fusion cannot carry LoRA (adapters address q/k/v
        # individually); the proj_out split routes its factor rows.  Under
        # tensor parallelism the TP serving bundle: qkv fused in the TP
        # layout (the flat fused axis cannot split), proj_out whole
        pipeline.quantize(fuse_qkv=not args.lora, tp_layout=tp)
    for spec in args.lora or []:
        name, path = spec.split("=", 1) if "=" in spec else (None, spec)
        _attach_lora(pipeline, path, name)
    if tp:  # this rank keeps its shard of the DiT
        pipeline.params = shard_params(pipeline.params, mesh)
    brain_data = load_brain_data(args.brain_data_path)
    if brain_data and not (
            "encoders" in pipeline.params and "dgf" in pipeline.params):
        parser.error(
            "--brain_data_path given but the checkpoint has no 'encoders'/"
            "'dgf' components (and --components did not include them). "
            "Convert with --init-encoders, or train CS3/DGF and save them "
            "into the pipeline directory.")

    if args.single_image and args.prompt is not None:
        brain = brain_data.get(os.path.basename(args.single_image), {})
        with mesh_context(mesh):
            img = edit_one(
                pipeline, args.single_image, args.prompt,
                condition_type=args.condition_type,
                target_size=args.target_size,
                position_delta=(args.position_delta_x, args.position_delta_y),
                brain=brain, seed=args.seed, fuse_flag=args.fuse,
                num_steps=args.steps, guidance=args.guidance,
                neural_only=args.neural_only, knobs=knobs)
        if mesh.rank == 0:
            os.makedirs(args.output_dir, exist_ok=True)
            out = os.path.join(args.output_dir,
                               os.path.basename(args.single_image))
            write_image(out, img)
            print(f"[infer] saved {out}")
    elif args.input_dir:
        batch_edit(pipeline, args, brain_data, captions,
                   text_embeds=text_embeds, knobs=knobs, mesh=mesh)
    else:
        parser.error("provide --single_image + --prompt, or --input_dir")


if __name__ == "__main__":
    main()
