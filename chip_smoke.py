#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (loongx_tpu_torch), one GPU.

    python3 chip_smoke.py

Phases (each prints one line with the card, its power limit and seconds):
  1. require CUDA, build every kernel from ``loongx_tpu_torch/csrc``;
  2. every kernel against its plain PyTorch version at the shapes the edit
     and training paths give it, with its error, tolerance and times
     (kernel, plain, bound, one library call as a yardstick); the wgmma
     kernels (the flash forward with its RoPE pre-pass, the flash dK/dV and
     dQ passes, the W8A8 GEMM, the weight-only GEMM, the transposed GEMM
     with its pre-scale pass) also with the mma.sync kernel they replace
     checked and timed beside them at the same call
     (`cuda_build.mma_sync_only`), a ragged M among the GEMM cases, at
     batch 1 and 2 in both layouts, the
     flash residuals, the backward pair's two bounds (the five products an
     ideal pass needs, the seven the two passes do), cuBLAS bf16 on the
     dequantised weight, the W8A8 GEMM's stage probe (`stage_probe`: the
     clock64 cycles of a stage's barrier wait and wgmma, a fold and an
     epilogue, from a build with -DW8A8_PROBE), and the count of GEMM outputs that differ
     from the plain version's (none in the W8A8 gelu cases); the fused
     forms of the int8 kernels (the LN + adaLN prologue, W8A8 and
     weight-only, stacked and fused-qkv; the gate + residual epilogue)
     also beside their unfused route, the W8A8 prologue's int8 codes
     exactly equal to the plain version's, and both fused autograd
     Functions' gradients at the training shape; the int8 QK^T forward on
     s8 wgmma (every `flash_cases` case, its pre-pass's q and k codes
     exactly, the outputs that differ from the mma.sync int8 kernel's,
     both timed at the same call) and the W8A8 activation pass's warp
     kernel at every (K, group) pair of the served forward, a ragged K and
     the LN form (codes and scales exactly, beside the block kernel it
     replaces); the row stats' warp kernel beside the block kernel it
     replaces and ``torch.var_mean`` (`check_ln_stats`), and the weight-only
     prologue pass (`check_ln_mod_pass`: x' exactly the plain version's fed
     the pass's own stats, beside ``F.layer_norm``); the weight-only
     prologue forms on that pass + the wgmma GEMM beside the ``mma.sync``
     form and their unfused route; the final proj_out's N 64 GEMMs at M
     1024 and a ragged M 1000: the split-K forward (both modes; its W8A8
     outputs equal to the mma.sync kernel's, every one, its device time
     beside its GEMM's alone, the mma.sync kernel's, the library call's and
     cuBLAS bf16's) and the narrow transposed kernel (device time beside
     the mma.sync kernel's and cuBLAS bf16 on the pre-scaled dy); x_embedder's
     K 64 kernel (both modes, W8A8 quantized in it: its outputs equal to
     the mma.sync route's, the activation pass and qmm_kernel, at M 1024 and
     on its first 1000 rows, its device time beside theirs, the library
     call's and cuBLAS bf16's); the chunked S4D scan at every encoder layer
     and EEG wide at batch 2, beside the sequential kernel by device time
     and by the whole call's; kernels
     under about 0.05 ms are timed by device time too (`device_ms`,
     torch.profiler), since their wrapper time is host cost; and the
     stacked W8A8 and weight-only GEMMs and the flash forward at the shard
     shapes a rank of tensor 2 runs (`tp2_cases`, 12 heads), each on its
     wgmma route, and its backward (`check_tp2_backward`: the transposed
     GEMMs at `tp2_t_cases`, the flash dK/dV and dQ pair at 12 heads), each
     beside its plain version, cuBLAS bf16 on the pre-scaled dy or SDPA's
     backward, and its bound; and HiDream-I1's expert path (`check_moe`,
     ops/moe.py's kernels at hidream_edit_b4_512's shapes: a single block's
     M 11264 routed over four experts with uneven loads and one empty, cap
     23040, the shared expert's F 3584 and a text stream's one-group F 6912
     SwiGLU): the router's top-2 and weights, the plan and every int8 code
     and scale bit for bit, both grouped GEMM epilogues' live rows within
     MOE_GEMM_REL_L2 of float32 products of the same codes, the combine,
     each timed beside its plain version and its bound;
  HiDream step: one full-width HiDream-I1 denoise step at batch 4, 512x512
     (random int8 weights built on the card, then freed): launches counted
     from zero (one route, plan and combine a MoE layer, one grouped GEMM
     launch a SwiGLU projection, routed, shared and the text stream's), no
     host synchronization (``torch.cuda.set_sync_debug_mode("error")``),
     equal to its warm-up bit for bit, its ms and device profile, and the
     full-width q/k RMS norm's device ms a step beside its byte bound;
  3. one full-width FLUX.1-dev forward (the serving int8 stacks at unit
     gain, see `unit_gain`; W8A8, S 2560) through the kernels and through
     the plain versions: relative L2 of the velocities after the first
     double and single block (weight-only and W8A8) and after all 57
     (W8A8), each beside its rounding floor, the launch count of each
     kernel (57 wgmma flash forwards after 57 RoPE pre-passes; every
     stacked and fused-qkv GEMM on wgmma, the split of all 397 GEMM
     launches by kernel, the flat ones by route: proj_out on split-K,
     x_embedder's two on the K 64 kernel, none on mma.sync; one activation
     pass a W8A8 GEMM launch but the K 64 kernel's), a device profile and a host
     profile; the same
     57 blocks with ``fuse_ln`` and
     ``fuse_gate`` (kernels vs plain beside the floor, 114 prologue and
     114 gate launches, all 114 row stats on the warp kernel, its device
     profile); the int8_attn forward's
     device profile (its flash group: the s8 wgmma kernel and its pre-pass;
     all 57 launches on wgmma) and the activation pass's group; then the
     gradients of every
     LoRA factor of the training tree's first double and single block
     (unit gain, LoRA on), kernels vs plain, beside their rounding floor;
  4. serve: ``neural_edit`` at 512x512 for two requests (28 steps, W8A8),
     stage times, ms/step, edits/s, finite outputs of the right shape
     within loose range limits (the random VAE weights decode a little
     past [-1, 1]; the share outside is printed), and the card's SM clock
     and power draw sampled while it serves; then the first request again
     with ``s4_mode="pallas"`` (the chunked S4D kernel: its 10 launches a
     brain encode and the brain embeds against the conv mode's, and the
     plain recurrence's)
     and with ``int8_attn=True`` (int8 QK^T: ms/step and the image against
     the bf16-score one; every int8 launch on the s8 wgmma kernel) and
     with ``fuse_ln`` + ``fuse_gate`` (ms/step
     beside the first request's, 3192 prologue and 3192 gate launches);
  generate: random int8 T5-XXL and CLIP-L join the serving bundle, and
     ``generate()`` serves two text-prompt edits in fuse mode (infer wiring,
     a Condition with the source image and all four signals, a character
     tokenizer): stage times, ms/step, edits/s, stacked-kernel launches per
     prompt, CLIP ms;
  speech and demos: on that bundle, random Whisper-large and opus-mt-zh-en
     written as Hugging Face checkouts to a directory in the checkout
     (removed at the end; a synthesized byte-level BPE vocabulary with
     whisper-large's specials at their ids, read by transformers'
     WhisperTokenizer; Marian through `MarianTokShim`), every tensor of
     both on the card; Whisper's encoder and cross K/V ms (CUDA events),
     prefill ms and ms per generated token of the KV-cached decoder (host
     clock), its logit rows against one teacher-forced pass over its own
     buffer (DECODER_REL_TOL), the float32 encoder at full width and 2 + 2
     layers against the CPU's (WHISPER_ENC_REL_TOL), peak memory; then
     ``cli.speech_demo.main`` with LOONGX_W8A8=1 on a 5 s WAV and a
     512x512 PNG (28 steps, no ``--prompt``, no brain data), its
     transcriber ``speech_demo.transcribe`` on the two local checkouts (the
     ``whisper`` package unimportable): the transcript printed with its
     transcribe and translate ms and Marian's tokens, the PNG equal bit for
     bit to ``edit_one`` called directly, every flash forward and GEMM on
     wgmma, split-K or K 64 and none on mma.sync, T5-XXL's stacked launches
     a prompt; then the web demo's server in a thread (/health, /, /edit
     with a 640x480 PNG equal
     bit for bit to ``process_image_and_text`` called directly at 8 steps,
     the same launch rules, 400 on a malformed body; elapsed_s and ms/step);
     then ``free_text_encoders()`` and the bytes it frees;
  infer CLI: the serving bundle is written with ``save_pipeline`` to a
     directory in the checkout (disk checked first; seconds and bytes
     printed, with the host's peak resident memory before and after) and
     freed; phase 4's first request becomes a PNG and a brain-data pickle, with two more 512x512 requests beside
     it; ``cli.infer.main`` runs in this process with LOONGX_W8A8=1, once
     with ``--single_image`` (its PNG must equal phase 4's first-request
     uint8 image bit for bit) and once over the directory at
     ``--batch_size 2`` (groups of 2 and 1; every decode finite, every
     output 512x512, the first request within 1 of the single edit):
     checkpoint load times, ``--timing``'s p50, the single edit's ms/step,
     and the launches of the single edit and of each group (every flash
     forward and GEMM on wgmma, split-K or K 64, none on mma.sync); the
     directory is removed at the end;
  evaluate and depth: in the same directory, before it is removed, a random
     Depth-Anything-Small (``DepthAnythingConfig()``) written as a Hugging
     Face checkout and ``cli.infer.main`` serving phase 4's first request
     with ``--condition_type depth`` (LOONGX_DEPTH_MODEL, W8A8, ``--int8``):
     the estimator must be the port's on the card, its 512x512 predicted
     depth within DEPTH_REL_TOL of the same estimator on the CPU (its uint8
     image within DEPTH_U8_SHARE), the edit finite and 512x512 with the
     single edit's launches; estimator ms per image and the edit's ms/step;
     then random CLIP ViT-B/32 and DINO ViT-S/16 checkouts, CLIP converted
     by ``cli.convert --eval_clip``, and ``cli.parity.main`` over a staged
     2-row split of 512x512 pairs (``--mode neural --int8 --batch_size
     2``): parity.json with finite CLIP-I and DINO-I and exit 1 exactly when
     its verdict is false; CLIP-I and DINO-I of identical pairs 1 within
     1e-5; CLIP image / text and DINO features on the card against the
     CPU's; ms per batch of 16;
  5. train: the seed_512 QLoRA configuration
     is built on the card (int8 FLUX.1-dev, LoRA r 4, CS3 + DGF frozen with
     dropout on, Prodigy, clip 0.5, remat, bf16, batch 1 at 512 px) and
     takes 4 steps: s/step, loss, grad norm and Prodigy's d per step, peak
     memory, launches per step (every flash backward, stacked weight-only
     GEMM and stacked transposed GEMM launch on the wgmma route, none on
     mma.sync; the flat GEMMs and the flat transposed one by route: the
     proj_out forward on split-K, its backward on the narrow kernel,
     x_embedder's forward on the K 64 kernel, no flat or transposed GEMM
     on mma.sync); every LoRA B factor must move, int8 and
     frozen leaves must
     not; then a fifth step under the profiler gives the step's device
     time by kernel group, its flash backward group and its two int8 GEMM
     groups (weight-only forward, transposed);
     then two steps with
     ``fuse_ln`` (38 prologue passes and 38 prologue GEMMs on wgmma a step:
     ff.in, forward and remat; 19 row stats in the backward): finite loss,
     LoRA B factors moved, frozen leaves untouched, s/step, and one more
     step under the profiler (its prologue group beside the unfused
     step's profile);
  train CLI: the training bundle a user converts (random int8 FLUX.1-dev
     in the training layout without LoRA, the VAE, CS3 + DGF, int8 T5-XXL
     and CLIP-L) is written with ``save_pipeline`` to a directory in the
     checkout (disk checked first; removed at the end) with character-level
     ``tokenizers`` vocabularies (both must load), beside a synthetic
     8-row L-Mind corpus (512x512 PNG pairs, instructions, the four
     signals) and configs/seed_512.yaml with only its paths,
     ``save_interval: 1``, ``sample_interval: 2``, ``staged_text: true``
     and 2 loader workers changed; ``cli.train.main`` then trains 2
     optimizer steps of 4 micro-batches (a summary of 2 steps with a
     finite loss; T5/CLIP loaded alone and freed before the DiT loads;
     LoRA files and train states at steps 1 and 2; the probe JPEG at step
     2, 512x512, and no probe failure printed; every LoRA B factor moved,
     no frozen byte changed; per micro-batch every flash backward, stacked
     weight-only and transposed GEMM on wgmma and nothing on mma.sync;
     s/micro-step, peak memory, save and load seconds, one micro-step's
     device profile with the loader's next batch beside it), resumes to
     step 3 (the train state loaded equal bit for bit to the one saved,
     4 more micro-batches), and is refused ("fingerprint") with
     ``lora_config.r: 8``.  The loop is watched from outside: module
     attributes (the pipeline loader, make_train_step, partition, the
     checkpoint functions, the probe) are wrapped for the phase;
  multi-GPU (one card): ``parallel/`` in child processes (spawn), each
     group within MULTI_TIMEOUTS, any rank's failure failing the run
     (`multi_gpu`): NCCL at world size 1 and ``cli.infer`` through it
     (its single edit equal to phase 4's bit for bit); tensor 2 over gloo,
     two ranks on the one card (a rank's shard of the TP-layout int8
     FLUX.1-dev, the forward's velocity against the unsharded one, every
     flash and GEMM launch of each rank on its Hopper route, peak memory a
     rank, a short TP edit against the single edit); data 2 over gloo
     (``cli.infer`` over two requests, each rank's image equal to its
     request's single edit bit for bit).  The checkpoint of phase "infer
     CLI" stays on disk for it;
  train under a mesh (one card): ``train/`` under ``mesh_context`` in
     child processes, both ranks on the one card over gloo (`mesh_train`):
     the seed_512 QLoRA tree at full width and depth on each rank, rank 0's
     one-process references (the step at batch 2, at batch 1, and at batch
     1 through the plain versions: the rounding floor); (a) one data-2
     micro-step, one row a rank, against the batch-2 step (loss, grad norm,
     every LoRA gradient within MESH_DATA_REL_L2); (b) one tensor-2
     micro-step at batch 1, each rank with its shard, against the batch-1
     step (every LoRA gradient within MESH_TP_REL_L2 beside the floor;
     seconds and peak memory a rank); (c) every flash forward and
     backward, stacked and transposed GEMM launch of each rank on wgmma;
     (d) ``cli.train.main`` with ``mesh: {data: 2}`` at 2 + 4 blocks: a
     step of 2 micro-batches a rank and a resume, rank 0 alone writing, and
     ``cli.infer`` serving the rank-0 LoRA file.

Before the last line come the kernel table as JSON ({"kernels": [...]},
launch counts from phase 4 for the forward kernels -- the S4D, int8
attention and fused-elementwise kernels from the phase-4 request that
selects them -- and from phase 5 for the backward ones; each kernel's
launches in the train CLI's first run, in the depth-conditioned CLI edit,
in the speech demo's edit and in the web demo's edit beside them, as
``launches_train_cli``, ``launches_depth_edit``, ``launches_speech_edit``
and ``launches_web_demo``, and by rank in the multi-GPU phase as
``launches_nccl_single``, ``launches_tp2_ranks`` and
``launches_data2_ranks``, and in phase "train under a mesh" as
``launches_mesh_train_ranks``; the expert path's kernels count the launches
of phase "HiDream step"; ``tp2_shard_shapes`` holds phase 2's times
at the tensor-2 shard shapes, forward and backward) and the card's name and
power limit.  The last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero with no result
line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

try:  # alone, without the repo beside it, main() says so and exits 2
    from loongx_tpu_torch.utils.device_bench import device_ms
    from loongx_tpu_torch.utils.device_bench import device_profile as _profile
    from loongx_tpu_torch.utils.profiling import card_line
except ImportError:
    device_ms = _profile = card_line = None

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


class Failure(Exception):
    pass


class Phase:
    def __init__(self, name, card):
        self.name, self.card = name, card

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch
        torch.cuda.synchronize()
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        print(f"[phase] {self.name}: {status} | {self.card} | {dt:.1f} s",
              flush=True)
        return False


@contextlib.contextmanager
def smi_samples(samples):
    """Append (SM clock MHz, power draw W) of the card every 200 ms while
    the block runs; a card below its power limit's draw runs at full clock."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        for line in out.splitlines():
            try:
                samples.append(tuple(float(f) for f in line.split(",")))
            except ValueError:  # "[N/A]" where the card does not report
                continue


def cuda_time_ms(fn, iters=None, budget_ms=300.0):
    """Mean ms of fn() by CUDA events after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    if iters is None:
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        once = max(start.elapsed_time(end), 1e-3)
        iters = int(min(50, max(2, budget_ms / once)))
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, kind: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[kind]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                       "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# relative L2 of flash against its plain version: a few times the rounding
# of a bf16 output (2^-9 relative at most per element)
FLASH_REL_L2 = 1e-2


def flash_cases():
    # (label, B, S, cond_len, mode, c_factor, layout)
    return [
        ("S2560 union", 1, 2560, 1024, "union", None, "bshd"),
        ("S2560 no_union", 1, 2560, 1024, "no_union", None, "bshd"),
        ("S2560 independent", 1, 2560, 1024, "independent", None, "bshd"),
        ("S2560 cfactor0.5", 1, 2560, 1024, "union", 0.5, "bshd"),
        ("S8704 union", 1, 8704, 4096, "union", None, "bshd"),
        ("S2000 independent", 1, 2000, 700, "independent", None, "bshd"),
        ("B2 S1000 union bhsd", 2, 1000, 300, "union", None, "bhsd"),
        ("B2 S2560 independent", 2, 2560, 1024, "independent", None, "bshd"),
    ]


def _qkv(torch, gen, b, s, h, d, layout, n=3):
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    return [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(n)]


# the residuals (m2, l) against the plain ones: m2 absolute, l relative
RESIDUAL_TOL = 1e-4


def check_flash(torch, gen, records):
    """The bf16-score forward (the wgmma kernel and its RoPE pre-pass, as
    `flash_fwd_route` sends head_dim 128) against its plain version in every
    mode, with and without residuals; timed beside the mma.sync kernel it
    replaces (`cuda_build.mma_sync_only`), SDPA and its bound."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.rope import apply_rope, rope_embed

    h, d = 24, 128
    for label, b, s, c, mode, cf, layout in flash_cases():
        q, k, v = _qkv(torch, gen, b, s, h, d, layout)
        ids = torch.rand(s, 3, generator=gen, device="cuda") * 64
        cos, sin = rope_embed(ids.floor())
        kw = dict(cond_start=s - c, mode=mode, c_factor=cf, rope=(cos, sin),
                  layout=layout)
        route = fa.flash_fwd_route(d)
        out = fa.flash_attention(q, k, v, **kw).float()
        ref = fa.flash_attention_plain(q, k, v, **kw).float()
        err = (out - ref).abs().max().item()
        rel = ((out - ref).norm() / ref.norm()).item()
        # a few bf16 steps (2^-8 relative each) at the output's largest value
        tol = 2.0 ** -5 * ref.abs().max().item()
        res = ""
        res_ok = True
        if cf is None:
            o2, m2, l2 = fa._forward(q, k, v, s - c, mode, None, (cos, sin),
                                     layout, save_residuals=True)
            pm2, pl = fa.flash_residuals_plain(q, k, cond_start=s - c,
                                               mode=mode, rope=(cos, sin),
                                               layout=layout)
            err2 = (o2.float() - ref).abs().max().item()
            res_err = max((m2 - pm2).abs().max().item(),
                          ((l2 - pl).abs() / pl).max().item())
            res_ok = err2 <= tol and res_err <= RESIDUAL_TOL
            err = max(err, err2)
            res = (f" with residuals: err {err2:.3e}, residuals err "
                   f"{res_err:.1e} (tol {RESIDUAL_TOL:.0e});")
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        with cuda_build.mma_sync_only():
            mma_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                                iters=2)
        # yardstick: SDPA on pre-rotated head-major tensors (rope and the
        # layout transposes not timed), the same mask or bias
        qr, kr = (apply_rope(t, cos, sin) for t in fa._head_major(layout, q, k))
        vr = fa._head_major(layout, v)[0].contiguous()
        row = torch.arange(s, device="cuda") >= s - c
        if cf is not None:
            mask = torch.where(row[:, None] != row[None, :],
                               math.log(cf), 0.0).to(torch.bfloat16)
        elif mode == "no_union":
            mask = row[:, None] == row[None, :]
        elif mode == "independent":
            mask = ~(row[:, None] & ~row[None, :])
        else:
            mask = None
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask))
        pairs = {"union": s * s, "no_union": (s - c) ** 2 + c * c,
                 "independent": s * s - c * (s - c)}[mode]
        ops = 4.0 * b * h * d * pairs
        nbytes = 4 * b * s * h * d * 2 + 2 * s * d * 4
        bms, by = bound_ms(nbytes, ops, "bf16")
        records.append(dict(kernel="flash_attention", case=label, err=err,
                            tol=tol, ms=ms, mma_sync_ms=mma_ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_by=by, route=route))
        print(f"  flash {label:22s} err {err:.3e} (tol {tol:.2e}) rel L2 "
              f"{rel:.3e} (bound {FLASH_REL_L2:.0e});{res} {route} {ms:.3f} ms"
              f" (RoPE pre-pass included), mma.sync {mma_ms:.3f}, plain "
              f"{plain_ms:.3f}, sdpa {lib_ms:.3f}, bound {bms:.3f} ({by})",
              flush=True)
        if not (err <= tol and rel <= FLASH_REL_L2 and res_ok):
            raise Failure(f"flash {label}: err {err} (tol {tol}), rel L2 "
                          f"{rel} (bound {FLASH_REL_L2}){res}")
        if label in ("S2560 union", "S8704 union"):
            check_flash_rope(torch, fa, records, label, q, k, (cos, sin))
        del q, k, v, qr, kr, vr, out, ref
        torch.cuda.empty_cache()


def check_flash_rope(torch, fa, records, label, q, k, rope):
    """The wgmma forward's RoPE pre-pass against its plain version: equal
    (the same separately rounded fp32 operations, one bf16 rounding)."""
    out = fa.flash_rope(q, k, rope, "bshd")
    ref = fa.flash_rope_plain(q, k, rope, "bshd")
    n_diff = int((out != ref).sum().item())
    ms = cuda_time_ms(lambda: fa.flash_rope(q, k, rope, "bshd"))
    dev = device_ms(lambda: fa.flash_rope(q, k, rope, "bshd"))
    plain_ms = cuda_time_ms(lambda: fa.flash_rope_plain(q, k, rope, "bshd"),
                            iters=2)
    _, s, h, d = q.shape
    # q, k and the two tables read, the rotated pair written; 3 fp32
    # operations per element
    bms, by = bound_ms(4 * s * h * d * 2 + 2 * s * d * 4, 3.0 * 2 * s * h * d,
                       "fp32")
    records.append(dict(kernel="flash_rope", case=label, err=float(n_diff),
                        tol=0.0, ms=ms, device_ms=dev, plain_ms=plain_ms,
                        library_ms=None, bound_ms=bms, bound_by=by))
    print(f"  flash_rope {label:17s} elements differing {n_diff} of "
          f"{out.numel()} (tol 0) kernel {ms:.4f} ms (device {dev:.4f}) plain "
          f"{plain_ms:.3f} bound {bms:.4f} ({by})", flush=True)
    if n_diff:
        raise Failure(f"flash_rope {label}: {n_diff} elements differ")


def _case_gen(torch, gen, label):
    """The generator of a case's inputs: the ragged-M cases (whose weights
    are the case before's) draw from one of their own, so phase 3's inputs,
    drawn from ``gen`` after phase 2, stay as they were."""
    if label.startswith("ragged"):
        return torch.Generator(device="cuda").manual_seed(5)
    return gen


def qmm_cases():
    # (kernel, label, M, K, N, NB, activation)
    stacked = [
        ("attn/ff-out", 2048, 3072, 3072, 19, None),
        ("ff-in gelu", 2048, 3072, 12288, 19, "gelu_tanh"),
        ("mod 6h", 2048, 3072, 18432, 19, None),
        ("ff-out K12288", 2048, 12288, 3072, 19, None),
        ("single mlp gelu", 2560, 3072, 12288, 38, "gelu_tanh"),
        ("single proj K12288", 2560, 12288, 3072, 38, None),
        ("mod matvec", 2, 3072, 18432, 19, None),
        ("ragged M1000 gelu", 1000, 3072, 12288, 38, "gelu_tanh"),
    ]
    flat = [
        ("x_embedder", 1024, 64, 3072),
        ("context_embedder", 512, 4096, 3072),
        ("time in_layer", 1, 256, 3072),
        ("time out_layer", 1, 3072, 3072),
        ("vector in_layer", 1, 768, 3072),
        ("norm_out", 1, 3072, 6144),
        ("proj_out", 1024, 3072, 64),
        ("ragged M1000 proj_out", 1000, 3072, 64),
    ]
    qkv = [("txt", 512, 19), ("img+cond", 2048, 19), ("single", 2560, 38)]
    return stacked, flat, qkv


def _qmm_record(records, kernel, label, w8a8, out, ref, ms, plain_ms, lib_ms,
                m, k, n, extra=None, exact=False):
    """Record and print one GEMM case: its error against one bf16 rounding
    and the count of outputs that differ from the plain version's at all,
    which must be 0 where ``exact`` (the W8A8 gelu epilogue: tanhf in the
    plain version's order)."""
    import torch
    if isinstance(out, tuple):
        out, ref = torch.stack(out), torch.stack(ref)
    err = (out.float() - ref.float()).abs().max().item()
    flips = int((out != ref).sum().item())
    # one bf16 rounding at the output's scale
    tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
    kind = "int8" if w8a8 else "bf16"
    bms, by = bound_ms(m * k * 2 + k * n + 2 * n * 4 + m * n * 2,
                       2.0 * m * k * n, kind)
    mode = "w8a8" if w8a8 else "wonly"
    extra = extra or {}
    records.append(dict(kernel=kernel, case=f"{label} {mode}", m=m, k=k, n=n,
                        err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        flips=flips, **extra))
    print(f"  {kernel:15s} {label:20s} {mode:5s} M{m} K{k} N{n} err {err:.3e} "
          f"(tol {tol:.2e}) differing {flips}" + (" (tol 0)" if exact else "")
          + f" kernel {ms:.3f} ms plain {plain_ms:.3f} lib "
          f"{lib_ms:.3f} bound {bms:.3f} ({by})"
          + "".join(f" {key} {v:.4f}" if isinstance(v, float) else f" {key} {v}"
                    for key, v in extra.items()), flush=True)
    if not err <= tol:
        raise Failure(f"{kernel} {label} {mode}: err {err} > {tol}")
    if not extra.get("mma_sync_err", 0.0) <= tol:
        raise Failure(f"{kernel} {label} {mode}: mma.sync err "
                      f"{extra['mma_sync_err']} > {tol}")
    if exact and flips:
        raise Failure(f"{kernel} {label} {mode}: {flips} outputs differ from "
                      "the plain version's")


def act_quant_cases():
    """(label, M, K, group, k_pad, ln): the W8A8 activation pass at every
    (K, group) pair of the served forward (`stacked_w8a8_group` /
    `flat_w8a8_group` over the FLUX.1-dev linears), at the M the edit gives
    each, and ragged M, a ragged K in its last group, a K the warp kernel
    cannot take (the block route), group 1024 (the flat policy's, at no
    FLUX site) and the LN + adaLN form.  The first two are the main shapes
    (a block's K 3072 sites and its K 12288 ones)."""
    return [
        ("M2560 K3072 group 3072", 2560, 3072, 3072, 3072, False),
        ("M2560 K12288 group 3072", 2560, 12288, 3072, 12288, False),
        ("ragged M1000 K3072", 1000, 3072, 3072, 3072, False),
        ("mod matvec M2", 2, 3072, 3072, 3072, False),
        ("context_embedder", 512, 4096, 1536, 4608, False),
        ("proj_out K3072 group 1536", 1024, 3072, 1536, 3072, False),
        ("time out_layer M1", 1, 3072, 1536, 3072, False),
        ("vector in_layer", 1, 768, 768, 768, False),
        ("time in_layer", 1, 256, 256, 256, False),
        ("x_embedder", 2048, 64, 128, 128, False),
        ("group 1024", 300, 2048, 1024, 2048, False),
        ("ragged K4000", 300, 4000, 1536, 4608, False),
        ("ragged K1001 (block route)", 64, 1001, 1024, 1024, False),
        ("LN M2560 K3072", 2560, 3072, 3072, 3072, True),
        ("LN ragged M300 K4000", 300, 4000, 1536, 4608, True),
    ]


def check_act_quant(torch, gen, records, cases):
    """The W8A8 activation pass against its plain version: int8 codes and
    scales equal (tolerance 0; a tie at +-absmax/2 planted in each group
    with room for one, and an all-zero group); timed through the wrapper
    and by device time, beside the block-per-group kernel it replaces
    (`cuda_build.mma_sync_only`, device time) and the byte bound."""
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import quant_matmul as qmm

    for label, m, k, group, k_pad, ln in cases:
        x = (torch.randn(m, k, generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
        x[0, :min(k, group)] = 0.0  # x_scale 1
        if m > 1 and k >= 3:
            # absmax 3.25 and 1.625 in row 1's first group: 1.625 / fl(3.25 / 127)
            # lands just off the tie in IEEE division and rounds to 63
            x[1, :3] = torch.tensor([3.25, 1.625, -1.625])
            x[1, 3:min(k, group)] = x[1, 3:min(k, group)].clamp(-3.0, 3.0)
        ab = stats = None
        boundary = m // 2
        if ln:
            ab = torch.zeros(8, k, device="cuda")
            ab[0] = 1.0 + torch.randn(k, generator=gen, device="cuda") * 0.1
            ab[2] = 1.0 + torch.randn(k, generator=gen, device="cuda") * 0.1
            ab[1] = torch.randn(k, generator=gen, device="cuda") * 0.1
            ab[3] = torch.randn(k, generator=gen, device="cuda") * 0.1
            stats = qmm.ln_row_stats(x)

        def run():
            return qmm.act_quant(x, group, k_pad, ab, boundary, stats)

        q, xs = run()
        q_ref, xs_ref = qmm.act_quant_plain(x, group, k_pad, ab, boundary, stats)
        n_diff = int((q.float() != q_ref).sum().item())
        scale_err = (xs - xs_ref).abs().max().item()
        with cuda_build.mma_sync_only():
            q_old, xs_old = run()
            old_dev = device_ms(run)
        old_diff = int((q_old != q).sum().item()) + int((xs_old != xs).sum().item())
        ms, dev = cuda_time_ms(run), device_ms(run)
        plain_ms = cuda_time_ms(lambda: qmm.act_quant_plain(
            x, group, k_pad, ab, boundary, stats), iters=2)
        # read bf16 x (and with LN its row stats and the ab rows), write int8
        # codes and fp32 scales; abs, max, divide, round (and the prologue's
        # 4 operations) per element
        nbytes = m * k * 2 + m * k_pad + m * (k_pad // group) * 4
        if ln:
            nbytes += m * 8 + 8 * k * 4
        bms, by = bound_ms(nbytes, (8.0 if ln else 4.0) * m * k, "fp32")
        route = qmm.act_quant_route(k, group)
        name = "qmm_act_quant_ln" if ln else "qmm_act_quant"
        records.append(dict(kernel=name, case=label, m=m, k=k,
                            err=float(n_diff) + scale_err, tol=0.0, ms=ms,
                            device_ms=dev, block_device_ms=old_dev,
                            plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                            bound_by=by, route=route))
        print(f"  {name:16s} {label:26s} M{m} K{k} group {group} k_pad {k_pad} "
              f"{route}: codes differing {n_diff} of {q.numel()}, scale err "
              f"{scale_err:.1e} (tol 0), block kernel's codes differing "
              f"{old_diff}; wrapper {ms:.4f} ms, device {dev:.4f} (block "
              f"kernel {old_dev:.4f}), plain {plain_ms:.3f}, bound {bms:.4f} "
              f"({by})", flush=True)
        if n_diff or scale_err or old_diff:
            raise Failure(f"{name} {label}: {n_diff} codes differ, scale err "
                          f"{scale_err}, block kernel differs in {old_diff}")


def _library_call(torch, x, wq, w8a8):
    """One PyTorch call on the same operands: torch._int_mm on int8
    activations (W8A8, M > 16) or a cuBLAS bf16 matmul on the dequantized
    weight.  Returns a no-argument callable."""
    if w8a8 and x.shape[0] > 16:
        xq = torch.randint(-127, 128, x.shape, dtype=torch.int8, device="cuda")
        return lambda: torch._int_mm(xq, wq)
    wb = wq.to(torch.bfloat16)
    return lambda: torch.matmul(x, wb)


def _route_extra(torch, qmm, run, x, wq, k, n, group, k_pad, w8a8, ref=None):
    """The route `qmm_route` takes, the mma.sync kernel's time at the same
    call (`cuda_build.mma_sync_only`; with ``ref``, its error against the
    plain version's output too), and in W8A8 cuBLAS bf16 on the
    dequantised weight, a second yardstick beside torch._int_mm (the
    weight-only library call is cuBLAS bf16 already)."""
    from loongx_tpu_torch.ops import cuda_build
    extra = {"route": qmm.qmm_route(k, n, group, k_pad, w8a8)}
    with cuda_build.mma_sync_only():
        extra["mma_sync_ms"] = cuda_time_ms(run)
        if ref is not None:
            old = run()
            if isinstance(old, tuple):
                old = torch.stack(old)
            extra["mma_sync_err"] = (old.float() - ref.float()).abs().max().item()
    if w8a8:
        wb = wq.to(torch.bfloat16)
        extra["cublas_bf16_ms"] = cuda_time_ms(lambda: torch.matmul(x, wb))
    return extra


# the W8A8 pipeline's stage probe (csrc/w8a8_pipeline.cuh, built with -DW8A8_PROBE): its sums
# in order, clock64 cycles of the consumer warpgroups' phases and the producer's waits, then
# the stages, activation-group folds and tiles a consumer warpgroup ran
W8A8_PROBE_FIELDS = ("full_wait", "mma", "fold", "epilogue", "consumer_loop", "empty_wait",
                     "stages", "folds", "tiles")


def probe_path(source, define):
    """Where ``source`` built with ``-D<define>`` goes: beside the package's
    build, keyed by its hash."""
    from loongx_tpu_torch.ops import cuda_build
    return cuda_build.BUILD_DIR / (cuda_build._lib_path(source).stem
                                  + f"-{define.replace('=', '')}-probe.so")


def probe_entries(source, name, signature, defines):
    """The C entry ``name`` of ``source`` built once for each of ``defines``
    (``-D<define>``: a probe build of its own), the missing builds'
    ``nvcc`` started together; a dict define -> the entry with its
    signature set."""
    import ctypes
    from loongx_tpu_torch.ops import cuda_build
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for define in defines:
        out = probe_path(source, define)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{define}", "-o", str(tmp),
               str(cuda_build.CSRC_DIR / f"{source}.cu")]
        procs[define] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    for define, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise Failure(f"nvcc {source}.cu -D{define} failed:\n{log}")
        os.replace(tmp, out)
    entries = {}
    for define in defines:
        fn = getattr(ctypes.CDLL(str(probe_path(source, define))), name)
        fn.argtypes, fn.restype = list(signature), ctypes.c_int
        entries[define] = fn
    return entries


def read_stage_probe(source, launch, iters=5):
    """The W8A8 pipeline's stage probe of ``source``'s -DW8A8_PROBE build
    over ``iters`` calls of ``launch()``, a call of that build (after one
    that is not counted): cycles a 128-deep stage
    of one consumer warpgroup (``probe_full_wait``, ``probe_mma``: its
    wgmma issued up to the previous stage's retirement;
    ``probe_loop``: its whole loop over its stages), a fold of one
    activation group (``probe_fold``, the last wgmma's wait included), an
    epilogue a tile (``probe_epilogue``) and the producer's empty-barrier
    wait a stage (``probe_empty_wait``)."""
    import ctypes
    from loongx_tpu_torch.ops import cuda_build
    read = ctypes.CDLL(str(probe_path(source, "W8A8_PROBE"))).w8a8_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    sums = (ctypes.c_ulonglong * len(W8A8_PROBE_FIELDS))()
    launch()
    cuda_build.check(read(ctypes.addressof(sums), 1), "w8a8_probe_read")
    for _ in range(iters):
        launch()
    cuda_build.check(read(ctypes.addressof(sums), 1), "w8a8_probe_read")
    got = dict(zip(W8A8_PROBE_FIELDS, sums))
    stages, folds, tiles = (max(got[k], 1) for k in ("stages", "folds", "tiles"))
    return {"probe_full_wait": got["full_wait"] / stages, "probe_mma": got["mma"] / stages,
            "probe_loop": got["consumer_loop"] / stages, "probe_fold": got["fold"] / folds,
            "probe_epilogue": got["epilogue"] / tiles,
            # one producer thread a block against two consumer warpgroups
            "probe_empty_wait": 2.0 * got["empty_wait"] / stages}


def stage_probe(torch, qmm, x, wq, sc, bi, blk, act, group, k_pad):
    """The stage probe (`read_stage_probe`) of the wgmma GEMM alone on one
    call's activation codes, block ``blk`` of the K-major stack ``wq``."""
    from loongx_tpu_torch.ops import w8a8_layout
    m, k = x.shape
    n = wq.shape[-1]
    if not w8a8_layout.to_kmajor(wq, 1):
        raise Failure(f"stage probe: the stack {tuple(wq.shape)} cannot become K-major")
    a, xs = qmm.act_quant(x, group, k_pad)
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    fn = probe_entries("quant_matmul", "qmm_gemm_wgmma", qmm._WGMMA_SIGNATURE,
                       ["W8A8_PROBE"])["W8A8_PROBE"]
    stream = torch.cuda.current_stream().cuda_stream

    def gemm():
        from loongx_tpu_torch.ops import cuda_build
        code = fn(qmm.EPI_GELU if act else qmm.EPI_BIAS, a.data_ptr(), xs.data_ptr(),
                  qmm._stack_ptr(wq, blk), qmm._stack_ptr(sc, blk), qmm._stack_ptr(bi, blk),
                  None, None, None, out.data_ptr(), m, k, k_pad, n, group, k_pad // group,
                  0, 0, 0, stream)
        cuda_build.check(code, "qmm_gemm_wgmma (stage probe)")

    return read_stage_probe("quant_matmul", gemm)


def check_qmm(torch, gen, records):
    from loongx_tpu_torch.ops import quant_matmul as qmm

    stacked, flat, qkv = qmm_cases()
    stacks = {}

    def stack(nb, k, n):
        if (nb, k, n) not in stacks:
            stacks[(nb, k, n)] = (
                torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                              device="cuda", generator=gen),
                torch.rand(nb, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5,
                torch.randn(nb, 1, n, generator=gen, device="cuda") * 0.02)
        return stacks[(nb, k, n)]

    for w8a8 in (True, False):
        for label, m, k, n, nb, act in stacked:
            wq, sc, bi = stack(nb, k, n)
            blk = nb - 2
            x = torch.randn(m, k, generator=_case_gen(torch, gen, label),
                            device="cuda").to(torch.bfloat16)
            kw = dict(bias3=bi, activation=act, w8a8=w8a8)
            run = lambda: qmm.quant_matmul_stacked(x, wq, sc, blk, **kw)
            group, k_pad = qmm.stacked_w8a8_group(k, n)
            plain = lambda: qmm.qmm_plain(x, wq[blk], sc[blk], bi[blk], act,
                                          w8a8, group, k_pad)
            out, ref = run(), plain()
            extra = _route_extra(torch, qmm, run, x, wq[blk], k, n, group,
                                 k_pad, w8a8, ref)
            if w8a8 and extra["route"] == "wgmma":
                extra.update(stage_probe(torch, qmm, x, wq, sc, bi, blk, act,
                                         group, k_pad))
            _qmm_record(records, "qmm_stacked", label, w8a8, out, ref,
                        cuda_time_ms(run), cuda_time_ms(plain, iters=2),
                        cuda_time_ms(_library_call(torch, x, wq[blk], w8a8)),
                        m, k, n, extra, exact=w8a8 and act == "gelu_tanh")
        for label, m, nb in qkv:
            k, n3 = 3072, 9216
            wq, sc, bi = stack(nb, k, n3)
            norm_w = torch.rand(3, n3 // 3, generator=gen, device="cuda") + 0.5
            norm_w[2] = 1.0
            blk = nb - 2
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            run = lambda: qmm.quant_qkv_stacked(x, wq, sc, bi, norm_w, blk, 128,
                                                w8a8=w8a8)
            group, k_pad = qmm.stacked_w8a8_group(k, n3)
            plain = lambda: qmm.quant_qkv_plain(x, wq[blk], sc[blk], bi[blk],
                                                norm_w, 128, w8a8, group, k_pad)
            out, ref = run(), plain()
            _qmm_record(records, "qmm_qkv_stacked", label, w8a8, out, ref,
                        cuda_time_ms(run), cuda_time_ms(plain, iters=2),
                        cuda_time_ms(_library_call(torch, x, wq[blk], w8a8)),
                        m, k, n3, _route_extra(torch, qmm, run, x, wq[blk], k,
                                               n3, group, k_pad, w8a8,
                                               torch.stack(ref)))
        for label, m, k, n in flat:
            g = _case_gen(torch, gen, label)
            wq = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                               device="cuda", generator=g)
            sc = torch.rand(1, n, generator=g, device="cuda") * 2e-5 + 1e-5
            bi = torch.randn(1, n, generator=g, device="cuda") * 0.02
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            run = lambda: qmm.quant_matmul(x, wq, sc, bias=bi, w8a8=w8a8)
            group, k_pad = qmm.flat_w8a8_group(k, n)
            plain = lambda: qmm.qmm_plain(x, wq, sc, bi, None, w8a8, group,
                                          k_pad)
            out, ref = run(), plain()
            extra = _route_extra(torch, qmm, run, x, wq, k, n, group, k_pad,
                                 w8a8, ref)
            library = _library_call(torch, x, wq, w8a8)
            if extra["route"] in ("k64", "splitk"):
                extra.update(_own_kernel_extra(torch, qmm, run, out, library, x,
                                               wq, sc, bi, w8a8, extra["route"]))
            _qmm_record(records, "qmm_flat", label, w8a8, out, ref,
                        cuda_time_ms(run), cuda_time_ms(plain, iters=2),
                        cuda_time_ms(library), m, k, n, extra)
    stacks.clear()
    print_slower(records, ("qmm_stacked", "qmm_qkv_stacked", "qmm_flat"))


def _own_kernel_extra(torch, qmm, run, out, library, x, wq, sc, bi, w8a8,
                      route):
    """Device times of a flat GEMM on a kernel of its own (``route``:
    split-K at proj_out, K 64 at x_embedder): the route with any W8A8
    activation pass, its GEMM alone, the mma.sync route it replaces, the
    library call, and in W8A8 cuBLAS bf16 too; the count of its outputs
    that differ from the mma.sync route's at M and on the first 1000 rows (a
    ragged last tile), which must be 0 in W8A8 (the same s32 group sums,
    folded in the same order); the ragged rows against the plain version
    within one bf16 rounding."""
    from loongx_tpu_torch.ops import cuda_build
    xr = x[:1000]
    group, k_pad = qmm.flat_w8a8_group(*wq.shape)

    def ragged():
        return qmm.quant_matmul(xr, wq, sc, bias=bi, w8a8=w8a8)

    extra = dict(device_ms=device_ms(run), gemm_device_ms=device_ms(run, match=route),
                 library_device_ms=device_ms(library))
    out_r = ragged()
    with cuda_build.mma_sync_only():
        extra["mma_sync_device_ms"] = device_ms(run)
        old, old_r = run(), ragged()
    ref_r = qmm.qmm_plain(xr, wq, sc, bi, None, w8a8, group, k_pad).float()
    extra["ragged_err"] = (out_r.float() - ref_r).abs().max().item()
    extra["mma_sync_flips"] = int((out != old).sum().item())
    extra["ragged_mma_sync_flips"] = int((out_r != old_r).sum().item())
    tol = 2.0 ** -7 * ref_r.abs().max().item() + 1e-6
    if not extra["ragged_err"] <= tol:
        raise Failure(f"{route} M 1000: err {extra['ragged_err']} > {tol}")
    if w8a8:
        wb = wq.to(torch.bfloat16)
        extra["cublas_bf16_device_ms"] = device_ms(lambda: torch.matmul(x, wb))
        flips = extra["mma_sync_flips"] + extra["ragged_mma_sync_flips"]
        if flips:
            raise Failure(f"{route} W8A8: {flips} outputs differ from the mma.sync "
                          "route's (M and its first 1000 rows)")
    return extra


def print_slower(records, kernels, prefix=""):
    """Print the cases of ``kernels`` (labels starting with ``prefix``) at
    M >= 512 on a route other than mma.sync that are not faster than the
    mma.sync kernel at the same call (by device time where the case has it:
    a short call's wrapper time is host cost)."""
    def slower_than_mma_sync(r):
        if "mma_sync_device_ms" in r:
            return not r["device_ms"] < r["mma_sync_device_ms"]
        return not r["ms"] < r["mma_sync_ms"]
    slower = [f"{r['kernel']} {r['case']}" for r in records
              if r.get("route", "mma_sync") != "mma_sync" and r["kernel"] in kernels
              and r["case"].startswith(prefix) and r["m"] >= 512
              and slower_than_mma_sync(r)]
    print(f"  new kernels slower than mma.sync at M >= 512 ({', '.join(kernels)}"
          f"{' ' + prefix if prefix else ''}): {slower or 'none'}", flush=True)


def qmm_t_cases():
    # (kernel, label, M, K, N, NB): dy [M, N] -> dx [M, K] through the
    # training path's int8 linears (weight [K, N])
    stacked = [
        ("dbl qkv/out", 2048, 3072, 3072, 19),
        ("dbl ff-in", 2048, 3072, 12288, 19),
        ("dbl ff-out", 2048, 12288, 3072, 19),
        ("txt qkv/out", 512, 3072, 3072, 19),
        ("txt ff-in", 512, 3072, 12288, 19),
        ("txt ff-out", 512, 12288, 3072, 19),
        ("sgl qkv", 2560, 3072, 3072, 38),
        ("sgl proj_out", 2560, 15360, 3072, 38),
        ("sgl proj_mlp", 2560, 3072, 12288, 38),
        ("ragged M1000 proj_mlp", 1000, 3072, 12288, 38),
    ]
    flat = [("proj_out", 1024, 3072, 64),
            ("ragged M1000 proj_out", 1000, 3072, 64),
            ("context_embedder", 512, 4096, 3072)]
    return stacked, flat


def prescale_ms(torch, dy, scale):
    """The transposed wgmma GEMM's pre-scale pass alone (``qmm_t_prescale``,
    a timing probe of its share)."""
    import ctypes
    from loongx_tpu_torch.ops import cuda_build
    fn = cuda_build.library("quant_matmul_t").qmm_t_prescale
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = torch.empty_like(dy)
    m, n = dy.shape
    return cuda_time_ms(lambda: cuda_build.check(
        fn(dy.data_ptr(), scale.data_ptr(), a.data_ptr(), m, n,
           torch.cuda.current_stream().cuda_stream), "qmm_t_prescale"))


def check_qmm_t(torch, gen, records):
    """Kernels 5 and 6 against their plain version, on the route
    `qmm_t_route` takes and on the mma.sync kernel at the same call; the
    yardstick is a cuBLAS bf16 matmul of the pre-scaled dy with the
    pre-widened weight."""
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import quant_matmul as qmm

    stacked, flat = qmm_t_cases()
    stacks = {}
    for kernel, cases in (("qmm_t_stacked", stacked),
                          ("qmm_t", [(*c, None) for c in flat])):
        for label, m, k, n, nb in cases:
            if nb is None:
                g = _case_gen(torch, gen, label)
                wq = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                                   device="cuda", generator=g)
                sc = torch.rand(1, n, generator=g, device="cuda") * 2e-5 + 1e-5
                w2, s2 = wq, sc
                run = lambda: qmm.quant_matmul_t(dy, wq, sc)
            else:
                if (nb, k, n) not in stacks:
                    stacks.clear()
                    stacks[(nb, k, n)] = (
                        torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                                      device="cuda", generator=gen),
                        torch.rand(nb, 1, n, generator=gen, device="cuda")
                        * 2e-5 + 1e-5)
                wq, sc = stacks[(nb, k, n)]
                blk = nb - 2
                w2, s2 = wq[blk], sc[blk]
                run = lambda: qmm.quant_matmul_t_stacked(dy, wq, sc, blk)
            dy = torch.randn(m, n, generator=_case_gen(torch, gen, label),
                             device="cuda").to(torch.bfloat16)
            plain = lambda: qmm.qmm_t_plain(dy, w2, s2)
            out, ref = run(), plain()
            a = (dy.float() * s2.reshape(-1)).to(torch.bfloat16)
            wb = w2.to(torch.bfloat16)
            lib_ms = cuda_time_ms(lambda: torch.matmul(a, wb.t()))
            err = (out.float() - ref.float()).abs().max().item()
            tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
            bms, by = bound_ms(m * n * 2 + k * n + n * 4 + m * k * 2,
                               2.0 * m * k * n, "bf16")
            ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain, iters=2)
            route = qmm.qmm_t_route(k, n)
            with cuda_build.mma_sync_only():
                old_err = (run().float() - ref.float()).abs().max().item()
                old_ms = cuda_time_ms(run)
            extra = dict(route=route, mma_sync_ms=old_ms, mma_sync_err=old_err)
            if route == "wgmma":
                extra["prescale_ms"] = prescale_ms(torch, dy, s2.reshape(-1))
            elif route == "narrow":
                # a short call (the proj_out backward), read by device time
                extra["device_ms"] = device_ms(run)
                extra["library_device_ms"] = device_ms(lambda: torch.matmul(a, wb.t()))
                with cuda_build.mma_sync_only():
                    extra["mma_sync_device_ms"] = device_ms(run)
            records.append(dict(kernel=kernel, case=label, m=m, k=k, n=n,
                                err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                                library_ms=lib_ms, bound_ms=bms, bound_by=by,
                                **extra))
            print(f"  {kernel:15s} {label:20s} dy [{m}, {n}] -> dx [{m}, {k}] "
                  f"err {err:.3e} (tol {tol:.2e}) kernel {ms:.3f} ms plain "
                  f"{plain_ms:.3f} cublas {lib_ms:.3f} bound {bms:.3f} ({by})"
                  + "".join(f" {key} {v:.4f}" if isinstance(v, float) else
                            f" {key} {v}" for key, v in extra.items()),
                  flush=True)
            if not (err <= tol and old_err <= tol):
                raise Failure(f"{kernel} {label}: err {err}, mma.sync err "
                              f"{old_err} (tol {tol})")
    stacks.clear()
    print_slower(records, ("qmm_t_stacked", "qmm_t"))


def flash_bwd_cases():
    # (label, B, S, cond_len, mode, layout, rope)
    return [
        ("S2560 union", 1, 2560, 1024, "union", "bshd", True),
        ("S2000 independent", 1, 2000, 700, "independent", "bshd", True),
        ("S300 no_union", 1, 300, 77, "no_union", "bshd", True),
        ("S300 independent bhsd", 1, 300, 77, "independent", "bhsd", True),
        ("B2 S1000 union bhsd", 2, 1000, 300, "union", "bhsd", True),
        ("B2 S1024 no_union no RoPE", 2, 1024, 256, "no_union", "bshd", False),
    ]


# the wgmma pair's target at S 2560 union (ms), recorded met or missed
FLASH_BWD_TARGET_MS = 0.80


def _bwd_errors(got, ref):
    """{name: (max abs err, tol, rel L2)} of (dq, dk, dv) against the plain
    backward; tol a few bf16 steps at the gradient's largest value."""
    return {name: ((a.float() - b.float()).abs().max().item(),
                   2.0 ** -5 * b.float().abs().max().item(), rel_l2(a, b))
            for name, a, b in zip(("dq", "dk", "dv"), got, ref)}


def check_flash_bwd(torch, gen, records):
    """The dK/dV and dQ kernels of `flash_bwd_route` (wgmma at head_dim 128,
    fed the forward's RoPE pre-pass output as the autograd Function feeds
    them) and, at the same call, the mma.sync pair they replace
    (`cuda_build.mma_sync_only`), both against the plain backward fed the
    forward kernel's own residuals; the yardstick is SDPA forward +
    backward minus its forward, at the same shape without RoPE (union
    cases)."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.rope import rope_embed

    h, d = 24, 128
    route = fa.flash_bwd_route(d)
    for label, b, s, c, mode, layout, use_rope in flash_bwd_cases():
        q, k, v, do = _qkv(torch, gen, b, s, h, d, layout, n=4)
        rope = None
        if use_rope:
            ids = torch.rand(s, 3, generator=gen, device="cuda") * 64
            rope = rope_embed(ids.floor())
        kw = dict(cond_start=s - c, mode=mode, rope=rope, layout=layout)
        o, m2, l = fa._forward(q, k, v, s - c, mode, None, rope, layout,
                               save_residuals=True)
        di = fa._row_dot(o, do, layout)
        args = (q, k, v, do, m2, l, di)
        qk_rot = None if rope is None else fa.flash_rope(q, k, rope, layout)
        ref = fa.flash_attention_bwd_plain(*args, **kw)
        errs = _bwd_errors(fa.flash_attention_bwd(*args, **kw, qk_rot=qk_rot),
                           ref)
        with cuda_build.mma_sync_only():
            errs_mma = _bwd_errors(fa.flash_attention_bwd(*args, **kw), ref)
        # the residuals the forward kernel wrote, against the plain ones
        pm2, pl = fa.flash_residuals_plain(q, k, cond_start=s - c, mode=mode,
                                           rope=rope, layout=layout)
        res_err = max((m2 - pm2).abs().max().item(),
                      ((l - pl).abs() / pl).max().item())
        for kernel, e in ((route, errs), ("mma_sync", errs_mma)):
            for name, (err, tol, rel) in e.items():
                if not (err <= tol and rel <= FLASH_REL_L2):
                    raise Failure(f"flash backward {label} {name} ({kernel}): err "
                                  f"{err} (tol {tol}), rel L2 {rel} (bound "
                                  f"{FLASH_REL_L2})")
        if not res_err <= RESIDUAL_TOL:
            raise Failure(f"flash residuals {label}: err {res_err} > {RESIDUAL_TOL}")
        t_dkv = cuda_time_ms(lambda: fa.flash_attention_bwd(
            *args, **kw, need_dq=False, qk_rot=qk_rot))
        t_dq = cuda_time_ms(lambda: fa.flash_attention_bwd(
            *args, **kw, need_dkv=False, qk_rot=qk_rot))
        with cuda_build.mma_sync_only():
            m_dkv = cuda_time_ms(lambda: fa.flash_attention_bwd(
                *args, **kw, need_dq=False))
            m_dq = cuda_time_ms(lambda: fa.flash_attention_bwd(
                *args, **kw, need_dkv=False))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(*args, **kw),
                                iters=2)
        lib_ms = None
        if mode == "union":
            qs, ks_, vs = (t.detach().clone().requires_grad_()
                           for t in fa._head_major(layout, q, k, v))
            (dos,) = fa._head_major(layout, do)

            def fwd_bwd():
                F.scaled_dot_product_attention(qs, ks_, vs).backward(dos)

            lib_ms = cuda_time_ms(fwd_bwd) - cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qs, ks_, vs))
        pairs = {"union": s * s, "no_union": (s - c) ** 2 + c * c,
                 "independent": s * s - c * (s - c)}[mode]
        # each product is 2*D flops per (query, key) pair and head: the
        # dK/dV pass does 4 (S, dP, dV, dK), the dQ pass 3 (S and dP again,
        # dQ); an ideal single pass would do 5
        product = 2.0 * b * h * d * pairs
        in_bytes = 4 * b * s * h * d * 2 + 3 * b * h * s * 4 + 2 * s * d * 4
        b_dkv = bound_ms(in_bytes + 2 * b * s * h * d * 2, 4 * product, "bf16")
        b_dq = bound_ms(in_bytes + b * s * h * d * 2, 3 * product, "bf16")
        b_five = bound_ms(in_bytes + 3 * b * s * h * d * 2, 5 * product, "bf16")
        for kernel, ms, mma_ms, (bms, by), names in (
                ("flash_bwd_dkv", t_dkv, m_dkv, b_dkv, ("dk", "dv")),
                ("flash_bwd_dq", t_dq, m_dq, b_dq, ("dq",))):
            records.append(dict(
                kernel=kernel, case=label,
                err=max(errs[n][0] for n in names),
                tol=min(errs[n][1] for n in names), ms=ms, mma_sync_ms=mma_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, route=route))
        verdict = ""
        if label == "S2560 union":
            verdict = (f"; {route} pair "
                       + ("faster" if t_dkv + t_dq < m_dkv + m_dq else "NOT faster")
                       + f" than mma.sync, target {FLASH_BWD_TARGET_MS:.2f} ms "
                       + ("met" if t_dkv + t_dq <= FLASH_BWD_TARGET_MS else "missed"))
        print(f"  flash bwd {label:26s} "
              + " ".join(f"{n} err {e:.3e} (tol {t:.2e}) rel L2 {r:.3e}"
                         for n, (e, t, r) in errs.items())
              + f" (bound {FLASH_REL_L2:.0e}); mma.sync rel L2 "
              + " ".join(f"{n} {r:.3e}" for n, (_, _, r) in errs_mma.items())
              + f"; residuals err {res_err:.1e}; {route} dK/dV {t_dkv:.3f} ms "
              f"(bound {b_dkv[0]:.3f}) dQ {t_dq:.3f} ms (bound {b_dq[0]:.3f}), "
              f"pair {t_dkv + t_dq:.3f} against the 7-product bound "
              f"{b_dkv[0] + b_dq[0]:.3f} and the 5-product bound {b_five[0]:.3f}; "
              f"mma.sync dK/dV {m_dkv:.3f} dQ {m_dq:.3f} pair {m_dkv + m_dq:.3f}; "
              f"plain {plain_ms:.3f}; sdpa backward "
              + ("not timed (masked mode)" if lib_ms is None else f"{lib_ms:.3f}")
              + verdict, flush=True)
        del q, k, v, do, o, qk_rot, args
        torch.cuda.empty_cache()


# the S4D kernel against its plain version (absolute, no looser than the
# JAX kernel's own 1e-4 against its scan: the state updates are the same
# separately rounded IEEE operations, only the sum over n is reordered) and
# against the FFT convolution (relative L2, the agreement recorded on the TPU)
S4D_ATOL, S4D_CONV_REL_L2 = 1e-4, 1.8e-3
# one dependent complex update of the recurrence: multiply, subtract, add
S4D_STEP_CYCLES = 12
S4D_CLOCK_HZ = 1.98e9  # the SM clock the card holds under load


def s4d_cases():
    # (label, B, L, H, N): every S4D layer of the CS3 encoders (two per stack)
    return [("EEG wide", 1, 4096, 64, 32), ("EEG narrow", 1, 4096, 4, 2),
            ("PPG", 1, 256, 4, 2), ("fNIRS", 1, 512, 6, 3),
            ("motion", 1, 128, 6, 3)]


def check_s4d(torch, gen, records):
    """The S4D recurrence at every encoder layer (and EEG wide at batch 2
    and two short layers of many states a block, fewer chunks than a lane
    has states: their inputs from generators of their own): the chunked
    kernel within 1e-4 of the plain recurrence and 1.8e-3 rel L2 of the FFT
    mode, the sequential kernel (its route under `cuda_build.mma_sync_only`:
    discretisation and casts in PyTorch, then the kernel) within 1e-4 of
    the plain recurrence; the chunked kernel's device time and the whole
    call's beside the sequential kernel's in the same call; the bounds:
    bytes, operations and the chunked chain (2 T + C dependent updates)."""
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import s4 as ts4
    from loongx_tpu_torch.ops import s4_scan

    cases = [(c, gen) for c in s4d_cases()]
    cases.append((("EEG wide B2", 2, 4096, 64, 32),
                  torch.Generator(device="cuda").manual_seed(7)))
    cases.append((("short L N8", 1, 8, 16, 8),
                  torch.Generator(device="cuda").manual_seed(8)))
    cases.append((("short L N64", 1, 8, 2, 64),
                  torch.Generator(device="cuda").manual_seed(9)))
    for (label, b, length, h, n), g in cases:
        p = ts4.init_s4d_layer(h, 2 * n, generator=g, device="cuda")
        u = torch.randn(b, length, h, generator=g, device="cuda")

        def run():
            return s4_scan.s4d_scan_recurrent(p, u)

        out = run()
        ref = s4_scan.s4d_scan_plain(p, u)
        conv = ts4.s4d_conv(p, u)
        err = (out - ref).abs().max().item()
        rel = rel_l2(out, conv)
        ms, dev = cuda_time_ms(run), device_ms(run)
        with cuda_build.mma_sync_only():
            seq_err = (run() - ref).abs().max().item()
            seq_ms = cuda_time_ms(run)
            seq_dev = device_ms(run, match="s4d_scan_kernel")
            seq_all = device_ms(run)
        plain_ms = cuda_time_ms(lambda: s4_scan.s4d_scan_plain(p, u), iters=2)
        conv_ms = cuda_time_ms(lambda: ts4.s4d_conv(p, u))
        # u read and y written in fp32, the layer's 4N + 2 parameters a
        # channel; about 14 flops per (b, t, h, n)
        bms, by = bound_ms(2 * b * length * h * 4 + (4 * n + 2) * h * 4,
                           14.0 * b * length * h * n, "fp32")
        plan = s4_scan.s4d_chunk_plan(length, h, n)
        chain_ms = 1e3 * (2 * plan.T + plan.C) * S4D_STEP_CYCLES / S4D_CLOCK_HZ
        latency_ms = 1e3 * length * S4D_STEP_CYCLES / S4D_CLOCK_HZ
        records.append(dict(kernel="s4d_chunk_scan", case=label, err=err,
                            tol=S4D_ATOL, ms=ms, device_ms=dev,
                            sequential_ms=seq_ms, sequential_device_ms=seq_dev,
                            sequential_call_device_ms=seq_all,
                            plain_ms=plain_ms, library_ms=None, conv_ms=conv_ms,
                            bound_ms=bms, bound_by=by, chain_bound_ms=chain_ms,
                            latency_bound_ms=latency_ms, route="chunked"))
        print(f"  s4d_scan {label:11s} B{b} L{length} H{h} N{n} T{plan.T} "
              f"C{plan.C}: err {err:.3e} (tol {S4D_ATOL:.0e}; sequential "
              f"kernel {seq_err:.3e}) rel L2 vs s4d_conv {rel:.3e} (bound "
              f"{S4D_CONV_REL_L2:.1e}); chunked kernel device {dev:.4f} ms, "
              f"call {ms:.4f}; sequential kernel device {seq_dev:.4f} (its "
              f"call's kernels {seq_all:.4f}), call {seq_ms:.4f}; plain "
              f"{plain_ms:.2f}, s4d_conv {conv_ms:.4f}; bound {bms:.5f} ({by}),"
              f" chunked chain {chain_ms:.4f}, sequential chain "
              f"{latency_ms:.4f}", flush=True)
        if not (err <= S4D_ATOL and rel <= S4D_CONV_REL_L2
                and seq_err <= S4D_ATOL):
            raise Failure(f"s4d_scan {label}: err {err} (tol {S4D_ATOL}), rel "
                          f"L2 vs conv {rel} (bound {S4D_CONV_REL_L2}), "
                          f"sequential kernel err {seq_err} (tol {S4D_ATOL})")


# the int8 QK^T forward against the bf16-score kernel: the JAX package's own
# bar for int8 scores (tests/test_flash_attention.py)
INT8_RMS, INT8_CORR = 0.03, 0.999


def check_flash_int8(torch, gen, records):
    """The int8 QK^T forward in every case of `flash_cases` (batch 1 and 2,
    both layouts, a ragged S, every mode, the c_factor form): the kernel of
    `flash_int8_route` (s8 wgmma at every FLUX shape) within kernel 1's
    bounds of its plain version and within JAX's int8 bar of the bf16-score
    kernel, its pre-pass (q and k codes and scales) equal to the plain
    version's, the outputs that differ from the mma.sync int8 kernel's
    (with its k pass, timed beside at the same call); times through the
    wrapper and by device time, the pre-pass's alone too."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.attention import int8_key_span
    from loongx_tpu_torch.ops.rope import apply_rope, rope_embed

    h, d = 24, 128
    for label, b, s, c, mode, cf, layout in flash_cases():
        q, k, v = _qkv(torch, gen, b, s, h, d, layout)
        ids = torch.rand(s, 3, generator=gen, device="cuda") * 64
        rope = rope_embed(ids.floor())
        span = int8_key_span(s)
        route = fa.flash_int8_route(d, span)
        pq = dict(span=span, rope=rope, layout=layout)
        pre = fa.flash_int8_prepass(q, k, **pq)
        pre_p = fa.flash_int8_prepass_plain(q, k, **pq)
        n_diff = sum(int((x != y).sum().item()) for x, y in zip(pre, pre_p))
        kq_diff = sum(int((x != y).sum().item()) for x, y in
                      zip(fa.flash_kquant(k, **pq), pre_p[2:]))
        kw = dict(cond_start=s - c, mode=mode, c_factor=cf, rope=rope, layout=layout)

        def run():
            return fa.flash_attention(q, k, v, int8_attn=True, **kw)

        out = run().float()
        with cuda_build.mma_sync_only():
            old = run().float()
            mma_ms, mma_dev = cuda_time_ms(run), device_ms(run)
            kq_dev = device_ms(lambda: fa.flash_kquant(k, **pq))
        ref = fa.flash_attention_plain(q, k, v, int8_attn=True, **kw).float()
        bf = fa.flash_attention(q, k, v, **kw).float()
        err = max((out - ref).abs().max().item(), (old - ref).abs().max().item())
        tol = 2.0 ** -5 * ref.abs().max().item()
        rel = max(rel_l2(out, ref), rel_l2(old, ref))
        rms = ((out - bf).pow(2).mean().sqrt() / bf.pow(2).mean().sqrt()).item()
        corr = torch.corrcoef(torch.stack([out.flatten(), bf.flatten()]))[0, 1].item()
        n_out = int((out != old).sum().item())
        ms, dev = cuda_time_ms(run), device_ms(run)
        pre_ms = cuda_time_ms(lambda: fa.flash_int8_prepass(q, k, **pq))
        pre_dev = device_ms(lambda: fa.flash_int8_prepass(q, k, **pq))
        bf_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, int8_attn=True, **kw), iters=2)
        pre_plain_ms = cuda_time_ms(lambda: fa.flash_int8_prepass_plain(q, k, **pq),
                                    iters=2)
        qr, kr = (apply_rope(t, *rope) for t in fa._head_major(layout, q, k))
        vr = fa._head_major(layout, v)[0].contiguous()
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr))
        pairs = {"union": s * s, "no_union": (s - c) ** 2 + c * c,
                 "independent": s * s - c * (s - c)}[mode]
        # the pre-pass and the forward together: q, k, v read, o written
        # (bf16), the rope tables; the visible pairs' D MACs of int8 scores
        # and of bf16 P.V per head
        t_ops = 2.0 * b * h * pairs * d * (1 / PEAK_OPS["int8"] + 1 / PEAK_OPS["bf16"])
        t_bytes = (4 * b * s * h * d * 2 + 2 * s * d * 4) / HBM_BYTES_PER_S
        bms, by = 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        # the pre-pass alone: q, k and the rope tables read, codes and
        # scales written; about 10 fp32 operations an element (rotate, abs,
        # max, divide, round)
        pre_bms, pre_by = bound_ms(2 * b * s * h * d * 2 + 2 * s * d * 4
                                   + 2 * b * s * h * d + b * h * (s + pre[3].shape[-1]) * 4,
                                   20.0 * b * s * h * d, "fp32")
        records.append(dict(kernel="flash_attention_int8", case=label, err=err,
                            tol=tol, ms=ms, device_ms=dev, mma_sync_ms=mma_ms,
                            mma_sync_device_ms=mma_dev, plain_ms=plain_ms,
                            library_ms=lib_ms, bf16_ms=bf_ms, bound_ms=bms,
                            bound_by=by, route=route, outputs_differing=n_out))
        records.append(dict(kernel="flash_kquant", case=label,
                            err=float(n_diff + kq_diff), tol=0.0, ms=pre_ms,
                            device_ms=pre_dev, mma_sync_device_ms=kq_dev,
                            plain_ms=pre_plain_ms, library_ms=None,
                            bound_ms=pre_bms, bound_by=pre_by))
        print(f"  flash int8 {label:22s} {route}: pre-pass values differing "
              f"{n_diff} (k pass alone {kq_diff}), wrapper {pre_ms:.4f} ms, device "
              f"{pre_dev:.4f} (the k pass alone {kq_dev:.4f}; plain {pre_plain_ms:.3f},"
              f" bound {pre_bms:.4f} {pre_by}); forward err {err:.3e} (tol {tol:.2e})"
              f" rel L2 {rel:.3e} (bound {FLASH_REL_L2:.0e}), both routes; vs bf16 "
              f"scores rms {rms:.4f} (bound {INT8_RMS}) corr {corr:.6f} (bound "
              f"{INT8_CORR}); outputs differing from mma.sync {n_out} of "
              f"{out.numel()}; int8 {ms:.3f} ms (passes included; device {dev:.4f}),"
              f" mma.sync {mma_ms:.3f} (device {mma_dev:.4f}), bf16 scores {bf_ms:.3f}"
              f", plain {plain_ms:.3f}, sdpa {lib_ms:.3f}, bound {bms:.3f} ({by})",
              flush=True)
        if n_diff or kq_diff:
            raise Failure(f"flash int8 pre-pass {label}: {n_diff} values differ "
                          f"({kq_diff} in the k pass alone)")
        if not (err <= tol and rel <= FLASH_REL_L2 and rms < INT8_RMS
                and corr > INT8_CORR):
            raise Failure(f"flash int8 {label}: err {err} (tol {tol}), rel L2 "
                          f"{rel}, rms {rms}, corr {corr}")
        del q, k, v, out, old, ref, bf, qr, kr, vr, pre, pre_p
        torch.cuda.empty_cache()


def t5_cases():
    # (label, K, N, activation): the T5-XXL block linears at M 512 tokens,
    # weight-only, a stack of 24 layers
    return [("t5 q/k/v/o", 4096, 4096, None),
            ("t5 wi_0 gelu", 4096, 10240, "gelu_tanh"),
            ("t5 wi_1", 4096, 10240, None),
            ("t5 wo", 10240, 4096, None)]


def check_t5_gemms(torch, gen, records):
    """The stacked kernel at the three T5-XXL shapes (M 512 tokens,
    weight-only, 24 layers), held to one bf16 rounding like every GEMM."""
    from loongx_tpu_torch.ops import quant_matmul as qmm

    for label, k, n, act in t5_cases():
        m, nb = 512, 24
        wq = torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        sc = torch.rand(nb, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        blk = nb - 2
        run = lambda: qmm.quant_matmul_stacked(x, wq, sc, blk, activation=act)
        plain = lambda: qmm.qmm_plain(x, wq[blk], sc[blk], None, act)
        ref = plain()
        _qmm_record(records, "qmm_stacked", label, False, run(), ref,
                    cuda_time_ms(run), cuda_time_ms(plain, iters=2),
                    cuda_time_ms(_library_call(torch, x, wq[blk], False)),
                    m, k, n, _route_extra(torch, qmm, run, x, wq[blk], k, n,
                                          k, k, False, ref))
    print_slower(records, ("qmm_stacked",), "t5")


def fused_cases():
    # (kernel, label, M, K, N, NB, boundary, activation): the fused forms at
    # the serving shapes; each form runs in both MAC modes
    return [
        ("qmm_stacked_ln", "single mlp gelu", 2560, 3072, 12288, 38, 1536,
         "gelu_tanh"),
        ("qmm_qkv_stacked_ln", "img+cond", 2048, 3072, 9216, 19, 1024, None),
        ("qmm_stacked_gate", "attn/ff-out", 2048, 3072, 3072, 19, 1024, None),
        ("qmm_stacked_gate", "single proj K12288", 2560, 12288, 3072, 38,
         1536, None),
    ]


# relative L2 of the fused Functions' gradients, kernels vs plain: a few
# bf16 roundings of the transposed kernel's output (2^-9 relative each)
FUSED_GRAD_REL_L2 = 1e-2


def _fused_operands(torch, gen, m, k, n, boundary):
    """Stream-like operands of one fused call: x and resid with the scale
    and offset of a residual stream, ab rows near (1 + scale, shift), gate
    rows of the adaLN-zero gate's size, each segment its own."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = (randn(m, k) * 3.0 + 0.5).to(torch.bfloat16)
    ab = torch.zeros(8, k, device="cuda")
    ab[0], ab[2] = 1.0 + randn(k, scale=0.1), 1.0 + randn(k, scale=0.1)
    ab[1], ab[3] = randn(k, scale=0.1), randn(k, scale=0.1)
    gate = torch.zeros(8, n, device="cuda")
    gate[:2] = randn(2, n, scale=0.5)
    resid = randn(m, n).to(torch.bfloat16)
    return x, ab, gate, resid


def check_fused(torch, gen, records):
    """The LN + adaLN prologue (W8A8: in the activation pass, whose codes
    must equal the plain version's exactly; weight-only: in its pass ahead
    of the wgmma GEMM, beside the mma.sync form that applies it on the A
    tile) and the gate + residual epilogue against their plain versions at
    the FLUX shapes, beside the unfused route (PyTorch LN + affine, then
    the same kernel; the kernel, then PyTorch gate + residual) and the
    bound; then both autograd Functions' gradients at the training
    shape."""
    from loongx_tpu_torch.models.flux.model import _ln_mod, _seg_affine
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import quant_matmul as qmm

    for kernel, label, m, k, n, nb, boundary, act in fused_cases():
        wq = torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        sc = torch.rand(nb, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = torch.randn(nb, 1, n, generator=gen, device="cuda") * 0.02
        blk = nb - 2
        x, ab, gate, resid = _fused_operands(torch, gen, m, k, n, boundary)
        # the model's ln_mod tuple (bf16 modulation rows) for the unfused
        # route
        ln_mod = (*(ab[i:i + 1].to(torch.bfloat16) for i in range(4)),
                  boundary)
        qkv = kernel == "qmm_qkv_stacked_ln"
        if qkv:
            norm_w = torch.rand(3, n // 3, generator=gen, device="cuda") + 0.5
            norm_w[2] = 1.0
        for w8a8 in (True, False):
            group, k_pad = qmm.stacked_w8a8_group(k, n)
            if qkv:
                def run():
                    return qmm.quant_qkv_stacked(x, wq, sc, bi, norm_w, blk,
                                                 128, w8a8=w8a8, ab=ab,
                                                 seg_boundary=boundary)

                def plain():
                    return qmm.quant_qkv_plain(x, wq[blk], sc[blk], bi[blk],
                                               norm_w, 128, w8a8, group, k_pad,
                                               ab, boundary)

                def unfused():
                    xm = _ln_mod(x[None], ln_mod)[0]
                    return qmm.quant_qkv_stacked(xm, wq, sc, bi, norm_w, blk,
                                                 128, w8a8=w8a8)
            elif kernel == "qmm_stacked_ln":
                kw = dict(bias3=bi, activation=act, w8a8=w8a8)

                def run():
                    return qmm.quant_matmul_stacked(x, wq, sc, blk, ab=ab,
                                                    seg_boundary=boundary, **kw)

                def plain():
                    return qmm.qmm_plain(x, wq[blk], sc[blk], bi[blk], act,
                                         w8a8, group, k_pad, ab,
                                         seg_boundary=boundary)

                def unfused():
                    xm = _ln_mod(x[None], ln_mod)[0]
                    return qmm.quant_matmul_stacked(xm, wq, sc, blk, **kw)
            else:
                def run():
                    return qmm.quant_matmul_stacked(
                        x, wq, sc, blk, bias3=bi, w8a8=w8a8, resid=resid,
                        gate=gate, seg_boundary=boundary)

                def plain():
                    return qmm.qmm_plain(x, wq[blk], sc[blk], bi[blk], None,
                                         w8a8, group, k_pad, resid=resid,
                                         gate=gate, seg_boundary=boundary)

                def unfused():
                    # the model's unfused gate_res_linear around the kernel
                    h = qmm.quant_matmul_stacked(x, wq, sc, blk, bias3=bi,
                                                 w8a8=w8a8)[None]
                    zero = torch.zeros_like(gate[0:1])
                    return resid[None] + _seg_affine(
                        h, boundary, gate[0:1].to(h.dtype), zero,
                        gate[1:2].to(h.dtype), zero)
            resid0 = resid.clone()
            out, ref = run(), plain()
            if not torch.equal(resid, resid0):
                raise Failure(f"{kernel} {label}: resid written in place")
            if qkv:
                out, ref = torch.stack(out), torch.stack(ref)
            err = (out.float() - ref.float()).abs().max().item()
            if kernel == "qmm_stacked_gate":
                # on out - resid: one bf16 rounding of each output, plus a
                # bound scaled by max |g z|, not by max |out|
                gz = (ref.float() - resid.float()).abs().max().item()
                excess = ((out.float() - ref.float()).abs()
                          - 2.0 ** -7 * ref.float().abs()).max().item()
                tol = 1e-4 * gz
                ok = excess <= tol
            else:
                tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
                ok = err <= tol
            ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain, iters=2)
            unfused_ms = cuda_time_ms(unfused)
            extra = {}
            if kernel.endswith("_ln") and not w8a8:
                # the mma.sync form (the prologue on its A tile), same call
                with cuda_build.mma_sync_only():
                    old = run()
                    extra["mma_sync_ms"] = cuda_time_ms(run)
                old = torch.stack(old) if qkv else old
                extra["mma_sync_err"] = (old.float()
                                         - ref.float()).abs().max().item()
                ok = ok and extra["mma_sync_err"] <= tol
            # x, the weight, scale and bias, ab and the row stats read once,
            # out written once (plus resid and gate for the gate form);
            # the GEMM's 2MKN operations at the MAC mode's rate and about
            # 4 fp32 operations per element of x or of the output
            nbytes = (m * k * 2 + k * n + 2 * n * 4 + m * n * 2
                      + (8 * k * 4 + m * 8 if kernel != "qmm_stacked_gate"
                         else m * n * 2 + 8 * n * 4))
            t_ops = (2.0 * m * k * n / PEAK_OPS["int8" if w8a8 else "bf16"]
                     + 4.0 * m * (k if kernel != "qmm_stacked_gate" else n)
                     / PEAK_OPS["fp32"])
            t_bytes = nbytes / HBM_BYTES_PER_S
            bms = 1e3 * max(t_ops, t_bytes)
            by = "operations" if t_ops >= t_bytes else "bytes"
            mode = "w8a8" if w8a8 else "wonly"
            route = qmm.qmm_route(k, n, group, k_pad, w8a8)
            records.append(dict(kernel=kernel, case=f"{label} {mode}", m=m,
                                k=k, n=n, err=err, tol=tol, ms=ms,
                                plain_ms=plain_ms, unfused_ms=unfused_ms,
                                library_ms=None, bound_ms=bms, bound_by=by,
                                route=route, **extra))
            print(f"  {kernel:18s} {label:18s} {mode:5s} M{m} K{k} N{n} "
                  f"boundary {boundary} err {err:.3e} "
                  + (f"(over one rounding {excess:.3e}, tol {tol:.2e} = 1e-4 "
                     f"max|g z|) " if kernel == "qmm_stacked_gate" else
                     f"(tol {tol:.2e}) ")
                  + f"kernel {ms:.3f} ms ({route}) unfused route "
                  f"{unfused_ms:.3f} plain {plain_ms:.3f} bound {bms:.3f} "
                  f"({by})" + "".join(f" {key} {v:.3f}"
                                      for key, v in extra.items())
                  + ("" if ms < unfused_ms else
                     " (not faster than the unfused route)"), flush=True)
            if not ok:
                raise Failure(f"{kernel} {label} {mode}: err {err}, tol {tol}")
            if w8a8 and kernel == "qmm_stacked_ln":
                _check_act_quant_ln(qmm, records, label, x, ab, boundary,
                                    group, k_pad)
        del wq, sc, bi
        torch.cuda.empty_cache()
    check_fused_grads(torch, gen)


# the row stats kernel against the JAX recipe in PyTorch: float32 sums of
# K terms in another order, as a share of the row's scale (|d mean| * rstd,
# |d rstd| / rstd)
LN_STATS_TOL = 1e-5


def _check_act_quant_ln(qmm, records, label, x, ab, boundary, group, k_pad):
    """The row stats kernel against its plain version, then the W8A8 pass
    with the prologue against its plain version fed the same stats: int8
    codes and scales equal (tolerance 0)."""
    stats, stats_ref = qmm.ln_row_stats(x), qmm.ln_row_stats_plain(x)
    rstd = stats_ref[:, 1]
    stats_err = max(((stats[:, 0] - stats_ref[:, 0]).abs() * rstd).max().item(),
                    ((stats[:, 1] - rstd).abs() / rstd).max().item())
    s_ms, s_dev = cuda_time_ms(lambda: qmm.ln_row_stats(x)), device_ms(
        lambda: qmm.ln_row_stats(x))
    s_plain_ms = cuda_time_ms(lambda: qmm.ln_row_stats_plain(x), iters=2)
    m, k = x.shape
    # read bf16 x (twice: the second time from L2), write the stats; a sum,
    # a subtract, a multiply and a sum per element
    s_bms, s_by = bound_ms(m * k * 2 + m * 8, 4.0 * m * k, "fp32")
    records.append(dict(kernel="qmm_ln_stats", case=label, m=m, k=k,
                        err=stats_err, tol=LN_STATS_TOL, ms=s_ms,
                        device_ms=s_dev, plain_ms=s_plain_ms, library_ms=None,
                        bound_ms=s_bms, bound_by=s_by))
    print(f"  {'qmm_ln_stats':18s} {label:18s} M{m} K{k} err {stats_err:.2e} "
          f"(tol {LN_STATS_TOL:.0e}, of the row's scale) kernel {s_ms:.4f} ms "
          f"(device {s_dev:.4f}) plain {s_plain_ms:.3f} bound {s_bms:.4f} "
          f"({s_by})", flush=True)
    if not stats_err <= LN_STATS_TOL:
        raise Failure(f"qmm_ln_stats {label}: err {stats_err}")
    q, xs = qmm.act_quant(x, group, k_pad, ab, boundary, stats)
    q_ref, xs_ref = qmm.act_quant_plain(x, group, k_pad, ab, boundary, stats)
    n_diff = int((q.float() != q_ref).sum().item())
    scale_err = (xs - xs_ref).abs().max().item()
    ms = cuda_time_ms(lambda: qmm.act_quant(x, group, k_pad, ab, boundary,
                                            stats))
    dev = device_ms(lambda: qmm.act_quant(x, group, k_pad, ab, boundary, stats))
    plain_ms = cuda_time_ms(lambda: qmm.act_quant_plain(
        x, group, k_pad, ab, boundary, stats), iters=2)
    # read bf16 x, the row stats and the ab rows, write int8 codes and fp32
    # scales; the prologue's 4 operations and abs, max, divide, round
    bms, by = bound_ms(m * k * 2 + m * 8 + 8 * k * 4 + m * k_pad
                       + m * (k_pad // group) * 4, 8.0 * m * k, "fp32")
    records.append(dict(kernel="qmm_act_quant_ln", case=label, m=m, k=k,
                        err=float(n_diff) + scale_err, tol=0.0, ms=ms,
                        device_ms=dev, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bms, bound_by=by,
                        route=qmm.act_quant_route(k, group)))
    print(f"  {'qmm_act_quant_ln':18s} {label:18s} M{m} K{k} group {group} "
          f"codes differing {n_diff} of {q.numel()}, scale err {scale_err:.1e} "
          f"(tol 0) kernel {ms:.3f} ms (device {dev:.4f}) plain {plain_ms:.3f} "
          f"bound {bms:.4f} ({by})", flush=True)
    if n_diff or scale_err:
        raise Failure(f"qmm_act_quant_ln {label}: {n_diff} codes differ, "
                      f"scale err {scale_err}")


def ln_stats_cases():
    """(label, M, K, dtype, boundary): the row stats and the weight-only
    prologue pass at the fused sites' rows (the single blocks' M 2560 and
    the double blocks' img+cond M 2048, K 3072, bf16: the warp route), a
    ragged M and K the warp kernels take with part of a lane's chunks
    empty, and two rows on the block route (float32 x; K 4096, longer
    than the warp kernels' registers)."""
    return [("M2560 K3072", 2560, 3072, "bfloat16", 1536),
            ("M2048 K3072", 2048, 3072, "bfloat16", 1024),
            ("ragged M300 K1000", 300, 1000, "bfloat16", 7),
            ("fp32 M2048 K3072", 2048, 3072, "float32", 1024),
            ("M512 K4096", 512, 4096, "bfloat16", 128)]


def _ln_rows_input(torch, gen, m, k, dtype):
    """A residual-stream-like x and ab near (1 + scale, shift), as
    `_fused_operands` makes them."""
    x = (torch.randn(m, k, generator=gen, device="cuda") * 3.0 + 0.5).to(
        getattr(torch, dtype))
    ab = torch.zeros(8, k, device="cuda")
    for row, base in ((0, 1.0), (1, 0.0), (2, 1.0), (3, 0.0)):
        ab[row] = base + torch.randn(k, generator=gen, device="cuda") * 0.1
    return x, ab


def _stats_err(stats, ref):
    """The stats' error as a share of the row's scale: |d mean| * rstd and
    |d rstd| / rstd."""
    rstd = ref[:, 1]
    return max(((stats[:, 0] - ref[:, 0]).abs() * rstd).max().item(),
               ((stats[:, 1] - rstd).abs() / rstd).max().item())


def check_ln_stats(torch, gen, records):
    """The row stats (`ln_row_stats`, the kernel of `ln_stats_route`)
    against their plain version within `LN_STATS_TOL`, timed by device time
    beside the block-per-row kernel (`cuda_build.mma_sync_only`), the byte
    bound and ``torch.var_mean`` as a one-call yardstick."""
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops import quant_matmul as qmm

    for label, m, k, dtype, _ in ln_stats_cases():
        x, _ = _ln_rows_input(torch, gen, m, k, dtype)

        def run():
            return qmm.ln_row_stats(x)

        err = _stats_err(run(), qmm.ln_row_stats_plain(x))
        with cuda_build.mma_sync_only():
            block_err = _stats_err(run(), qmm.ln_row_stats_plain(x))
            block_dev = device_ms(run)
        ms, dev = cuda_time_ms(run), device_ms(run)
        plain_ms = cuda_time_ms(lambda: qmm.ln_row_stats_plain(x), iters=2)

        def library():
            return torch.var_mean(x.float(), -1, correction=0)

        lib_ms, lib_dev = cuda_time_ms(library), device_ms(library)
        # x read once, the stats written; a sum, a subtract, a multiply
        # and a sum an element
        bms, by = bound_ms(m * k * x.element_size() + m * 8, 4.0 * m * k,
                           "fp32")
        route = qmm.ln_stats_route(k, x.dtype)
        records.append(dict(kernel="qmm_ln_stats", case=label, m=m, k=k,
                            err=max(err, block_err), tol=LN_STATS_TOL, ms=ms,
                            device_ms=dev, block_device_ms=block_dev,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            library_device_ms=lib_dev, bound_ms=bms,
                            bound_by=by, route=route))
        print(f"  {'qmm_ln_stats':16s} {label:18s} M{m} K{k} {dtype} {route}: "
              f"err {err:.2e} (block kernel {block_err:.2e}; tol "
              f"{LN_STATS_TOL:.0e} of the row's scale); wrapper {ms:.4f} ms, "
              f"device {dev:.4f} (block kernel {block_dev:.4f}), plain "
              f"{plain_ms:.3f}, var_mean {lib_ms:.4f} (device {lib_dev:.4f}), "
              f"bound {bms:.4f} ({by})", flush=True)
        if not max(err, block_err) <= LN_STATS_TOL:
            raise Failure(f"qmm_ln_stats {label}: err {err}, block kernel "
                          f"{block_err}")


def check_ln_mod_pass(torch, gen, records):
    """The weight-only prologue pass (`ln_mod_pass`): x' equal to the
    plain prologue fed the pass's own stats (tolerance 0), those stats
    within `LN_STATS_TOL` of the plain ones; device time beside its byte
    bound and ``F.layer_norm`` at the same shape as a yardstick."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import quant_matmul as qmm

    for label, m, k, dtype, boundary in ln_stats_cases():
        x, ab = _ln_rows_input(torch, gen, m, k, dtype)

        def run():
            return qmm.ln_mod_pass(x, ab, boundary)

        xp, stats = run()
        want = qmm.ln_mod_plain(x, ab, stats, boundary).to(torch.bfloat16)
        n_diff = int((xp != want).sum().item())
        err = _stats_err(stats, qmm.ln_row_stats_plain(x))
        ms, dev = cuda_time_ms(run), device_ms(run)
        plain_ms = cuda_time_ms(lambda: qmm.ln_mod_pass_plain(x, ab, boundary),
                                iters=2)

        def library():
            return F.layer_norm(x, (k,))

        lib_ms, lib_dev = cuda_time_ms(library), device_ms(library)
        # x read once, the four ab rows and x' and its stats written once;
        # the stats' 4 and the prologue's 4 fp32 operations an element
        bms, by = bound_ms(m * k * (x.element_size() + 2) + 4 * k * 4 + m * 8,
                           8.0 * m * k, "fp32")
        route = qmm.ln_stats_route(k, x.dtype)
        records.append(dict(kernel="qmm_ln_mod_pass", case=label, m=m, k=k,
                            err=float(n_diff) + err, tol=LN_STATS_TOL, ms=ms,
                            device_ms=dev, plain_ms=plain_ms,
                            library_ms=lib_ms, library_device_ms=lib_dev,
                            bound_ms=bms, bound_by=by, route=route))
        print(f"  {'qmm_ln_mod_pass':16s} {label:18s} M{m} K{k} {dtype} "
              f"boundary {boundary} {route}: x' differing {n_diff} of "
              f"{xp.numel()} (tol 0), stats err {err:.2e} (tol "
              f"{LN_STATS_TOL:.0e}); wrapper {ms:.4f} ms, device {dev:.4f}, "
              f"plain {plain_ms:.3f}, layer_norm {lib_ms:.4f} (device "
              f"{lib_dev:.4f}), bound {bms:.4f} ({by})", flush=True)
        if n_diff or not err <= LN_STATS_TOL:
            raise Failure(f"qmm_ln_mod_pass {label}: {n_diff} of x' differ, "
                          f"stats err {err}")


def check_fused_grads(torch, gen):
    """Both fused autograd Functions at the training shape (the double
    block's img+cond stream, M 2048, boundary 1024; weight-only): ff.in's
    prologue with gelu, K 3072 -> N 12288, and a gated K 3072 -> N 3072
    linear; the gradients of x, ab / x, resid, gate through the kernels
    against the same Functions on the plain versions."""
    from loongx_tpu_torch.ops import quant_matmul as qmm

    m, boundary, k = 2048, 1024, 3072
    for label, n, gated in (("ff-in gelu", 12288, False),
                            ("attn/ff-out", 3072, True)):
        wq = torch.randint(-128, 128, (19, k, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        sc = torch.rand(19, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = torch.randn(19, 1, n, generator=gen, device="cuda") * 0.02
        x, ab, gate, resid = _fused_operands(torch, gen, m, k, n, boundary)
        dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)

        def grads():
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in ((x, resid, gate) if gated else (x, ab))]
            if gated:
                y = qmm.quant_gate_res_linear_stacked(
                    leaves[0], wq, sc, bi, leaves[1], leaves[2], 17,
                    seg_boundary=boundary)
            else:
                y = qmm.quant_ln_mod_linear_stacked(
                    leaves[0], wq, sc, bi, leaves[1], 17,
                    seg_boundary=boundary, activation="gelu_tanh")
            return torch.autograd.grad(y, leaves, dy)

        g_k = grads()
        with plain_versions():
            g_p = grads()
        names = ("x", "resid", "gate") if gated else ("x", "ab")
        rels = {nm: rel_l2(a, b) for nm, a, b in zip(names, g_k, g_p)}
        finite = all(bool(torch.isfinite(g).all()) for g in g_k)
        print(f"  fused autograd {label:12s} M{m} K{k} N{n} boundary "
              f"{boundary}: gradients rel L2 kernels vs plain "
              + ", ".join(f"{nm} {r:.3e}" for nm, r in rels.items())
              + f" (bound {FUSED_GRAD_REL_L2:.0e}), finite {finite}",
              flush=True)
        if not finite or not max(rels.values()) <= FUSED_GRAD_REL_L2:
            raise Failure(f"fused autograd {label}: {rels}, finite {finite}")
        del wq, sc, bi


# ---------------------------------------------------------------------------
# Phases 3, 4 and 5
# ---------------------------------------------------------------------------


def tp2_cases():
    """(kernel, label, M, K, N, NB, activation): the stacked GEMMs a rank of
    tensor 2 launches in the served forward (the double blocks' latent
    stream M 2048, the single blocks' M 2560); the row splits (to_out,
    ff.out, proj_out over the local [attention | MLP] concat) without bias,
    their partial products summed after."""
    return [
        ("qmm_qkv_stacked", "tp2 single qkv", 2560, 3072, 3 * 1536, 38, None),
        ("qmm_stacked", "tp2 single mlp gelu", 2560, 3072, 6144, 38,
         "gelu_tanh"),
        ("qmm_stacked", "tp2 single proj_out", 2560, 7680, 3072, 38, None),
        ("qmm_stacked", "tp2 attn to_out", 2048, 1536, 3072, 19, None),
        ("qmm_stacked", "tp2 ff-out", 2048, 6144, 3072, 19, None),
    ]


def check_tp2_shapes(torch, gen, records):
    """The W8A8 and weight-only stacked GEMMs and the flash forward at the
    shard shapes of tensor 2 (12 heads, N and K halved, proj_out's K 7680):
    each against its plain version (the phase's tolerances), on its wgmma
    route, timed beside its plain version, one library call and its
    bound."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops import quant_matmul as qmm
    from loongx_tpu_torch.ops.rope import apply_rope, rope_embed

    for kernel, label, m, k, n, nb, act in tp2_cases():
        wq = torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        sc = torch.rand(nb, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = (torch.randn(nb, 1, n, generator=gen, device="cuda") * 0.02
              if act is not None or kernel == "qmm_qkv_stacked" else None)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        blk = nb - 2
        group, k_pad = qmm.stacked_w8a8_group(k, n)
        norm_w = torch.rand(3, n // 3, generator=gen, device="cuda") + 0.5
        for w8a8 in (True, False):
            if kernel == "qmm_qkv_stacked":
                run = lambda: qmm.quant_qkv_stacked(x, wq, sc, bi, norm_w, blk,
                                                    128, w8a8=w8a8)
                plain = lambda: qmm.quant_qkv_plain(
                    x, wq[blk], sc[blk], bi[blk], norm_w, 128, w8a8, group,
                    k_pad)
            else:
                run = lambda: qmm.quant_matmul_stacked(
                    x, wq, sc, blk, bias3=bi, activation=act, w8a8=w8a8)
                plain = lambda: qmm.qmm_plain(
                    x, wq[blk], sc[blk], None if bi is None else bi[blk], act,
                    w8a8, group, k_pad)
            out, ref = run(), plain()
            route = qmm.qmm_route(k, n, group, k_pad, w8a8)
            if route != "wgmma":
                raise Failure(f"{label}: route {route}, not wgmma")
            _qmm_record(records, kernel, label, w8a8, out, ref,
                        cuda_time_ms(run), cuda_time_ms(plain, iters=2),
                        cuda_time_ms(_library_call(torch, x, wq[blk], w8a8)),
                        m, k, n, {"route": route},
                        exact=w8a8 and act == "gelu_tanh")
        del wq, sc, bi, x
        torch.cuda.empty_cache()

    label, b, s, c, h, d = "tp2 S2560 union 12 heads", 1, 2560, 1024, 12, 128
    q, k, v = _qkv(torch, gen, b, s, h, d, "bshd")
    ids = torch.rand(s, 3, generator=gen, device="cuda") * 64
    cos, sin = rope_embed(ids.floor())
    kw = dict(cond_start=s - c, rope=(cos, sin), layout="bshd")
    route = fa.flash_fwd_route(d)
    out = fa.flash_attention(q, k, v, **kw).float()
    ref = fa.flash_attention_plain(q, k, v, **kw).float()
    err = (out - ref).abs().max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    tol = 2.0 ** -5 * ref.abs().max().item()
    ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            iters=2)
    qr, kr = (apply_rope(t, cos, sin) for t in fa._head_major("bshd", q, k))
    vr = fa._head_major("bshd", v)[0].contiguous()
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vr))
    bms, by = bound_ms(4 * b * s * h * d * 2 + 2 * s * d * 4,
                       4.0 * b * h * d * s * s, "bf16")
    records.append(dict(kernel="flash_attention", case=label, err=err, tol=tol,
                        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=bms, bound_by=by, route=route))
    print(f"  flash {label}: err {err:.3e} (tol {tol:.2e}) rel L2 {rel:.3e} "
          f"(bound {FLASH_REL_L2:.0e}); {route} {ms:.3f} ms (RoPE pre-pass "
          f"included), plain {plain_ms:.3f}, sdpa {lib_ms:.3f}, bound "
          f"{bms:.3f} ({by})", flush=True)
    if route != "wgmma" or not (err <= tol and rel <= FLASH_REL_L2):
        raise Failure(f"flash {label}: route {route}, err {err} (tol {tol}), "
                      f"rel L2 {rel}")


def tp2_t_cases():
    """(label, M, K, N, NB): the transposed GEMMs a rank of tensor 2
    launches in the train step's backward, dy [M, N] -> dx [M, K] on its
    shard: the column splits' dx [M, 3072] from their dy slice (q/k/v N
    1536; ff.in, proj_mlp N 6144), partial, summed over the tensor group
    after; the row splits' dx [M, K / 2] from the whole dy (to_out K 1536,
    ff.out K 6144, the single blocks' proj_out K 7680), local."""
    return [
        ("tp2 dbl qkv dx", 2048, 3072, 1536, 19),
        ("tp2 dbl ff-in dx", 2048, 3072, 6144, 19),
        ("tp2 dbl to_out dx", 2048, 1536, 3072, 19),
        ("tp2 dbl ff-out dx", 2048, 6144, 3072, 19),
        ("tp2 sgl proj_mlp dx", 2560, 3072, 6144, 38),
        ("tp2 sgl proj_out dx", 2560, 7680, 3072, 38),
    ]


def check_tp2_backward(torch, gen, records):
    """The backward a rank of tensor 2 runs: the transposed GEMMs at
    `tp2_t_cases` and the flash dK/dV and dQ kernels at 12 heads, S 2560
    union (bshd, RoPE), each against its plain version (phase 2's
    tolerances), on its wgmma route, timed beside its plain version, its
    yardstick (cuBLAS bf16 on the pre-scaled dy; SDPA's backward) and its
    bound."""
    import torch.nn.functional as F
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops import quant_matmul as qmm
    from loongx_tpu_torch.ops.rope import rope_embed

    for label, m, k, n, nb in tp2_t_cases():
        wq = torch.randint(-128, 128, (nb, k, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        sc = torch.rand(nb, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        blk = nb - 2
        run = lambda: qmm.quant_matmul_t_stacked(dy, wq, sc, blk)
        plain = lambda: qmm.qmm_t_plain(dy, wq[blk], sc[blk])
        out, ref = run(), plain()
        a = (dy.float() * sc[blk].reshape(-1)).to(torch.bfloat16)
        wb = wq[blk].to(torch.bfloat16)
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
        bms, by = bound_ms(m * n * 2 + k * n + n * 4 + m * k * 2,
                           2.0 * m * k * n, "bf16")
        ms, plain_ms = cuda_time_ms(run), cuda_time_ms(plain, iters=2)
        lib_ms = cuda_time_ms(lambda: torch.matmul(a, wb.t()))
        route = qmm.qmm_t_route(k, n)
        records.append(dict(kernel="qmm_t_stacked", case=label, m=m, k=k, n=n,
                            err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bms, bound_by=by,
                            route=route))
        print(f"  qmm_t_stacked   {label:20s} dy [{m}, {n}] -> dx [{m}, {k}] err "
              f"{err:.3e} (tol {tol:.2e}); {route} {ms:.3f} ms, plain "
              f"{plain_ms:.3f}, cublas {lib_ms:.3f}, bound {bms:.3f} ({by})",
              flush=True)
        if route != "wgmma" or not err <= tol:
            raise Failure(f"qmm_t_stacked {label}: route {route}, err {err} "
                          f"(tol {tol})")
        del wq, sc, dy, out, ref, a, wb
        torch.cuda.empty_cache()

    label, b, s, c, h, d = "tp2 S2560 union 12 heads", 1, 2560, 1024, 12, 128
    q, k, v, do = _qkv(torch, gen, b, s, h, d, "bshd", n=4)
    ids = torch.rand(s, 3, generator=gen, device="cuda") * 64
    rope = rope_embed(ids.floor())
    kw = dict(cond_start=s - c, mode="union", rope=rope, layout="bshd")
    o, m2, l = fa._forward(q, k, v, s - c, "union", None, rope, "bshd",
                           save_residuals=True)
    args = (q, k, v, do, m2, l, fa._row_dot(o, do, "bshd"))
    qk_rot = fa.flash_rope(q, k, rope, "bshd")
    route = fa.flash_bwd_route(d)
    errs = _bwd_errors(fa.flash_attention_bwd(*args, **kw, qk_rot=qk_rot),
                       fa.flash_attention_bwd_plain(*args, **kw))
    t_dkv = cuda_time_ms(lambda: fa.flash_attention_bwd(
        *args, **kw, need_dq=False, qk_rot=qk_rot))
    t_dq = cuda_time_ms(lambda: fa.flash_attention_bwd(
        *args, **kw, need_dkv=False, qk_rot=qk_rot))
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(*args, **kw),
                            iters=2)
    qs, ks_, vs = (t.detach().clone().requires_grad_()
                   for t in fa._head_major("bshd", q, k, v))
    (dos,) = fa._head_major("bshd", do)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks_, vs).backward(dos)) - cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qs, ks_, vs))
    product = 2.0 * b * h * d * s * s
    in_bytes = 4 * b * s * h * d * 2 + 3 * b * h * s * 4 + 2 * s * d * 4
    for kernel, ms, (bms, by), names in (
            ("flash_bwd_dkv", t_dkv, bound_ms(in_bytes + 2 * b * s * h * d * 2,
                                              4 * product, "bf16"), ("dk", "dv")),
            ("flash_bwd_dq", t_dq, bound_ms(in_bytes + b * s * h * d * 2,
                                            3 * product, "bf16"), ("dq",))):
        records.append(dict(kernel=kernel, case=label,
                            err=max(errs[x][0] for x in names),
                            tol=min(errs[x][1] for x in names), ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                            bound_by=by, route=route))
        print(f"  {kernel} {label}: {route} {ms:.3f} ms, plain (the whole "
              f"backward) {plain_ms:.3f}, sdpa backward (the pair) {lib_ms:.3f}, "
              f"bound {bms:.3f} ({by})", flush=True)
    print(f"  flash bwd {label}: " + " ".join(
        f"{x} err {e:.3e} (tol {t:.2e}) rel L2 {r:.3e}"
        for x, (e, t, r) in errs.items()) + f" (bound {FLASH_REL_L2:.0e})",
        flush=True)
    if route != "wgmma" or not all(e <= t and r <= FLASH_REL_L2
                                   for e, t, r in errs.values()):
        raise Failure(f"flash backward {label}: route {route}, {errs}")


# ---------------------------------------------------------------------------
# Phase 2 (expert path) and phase "HiDream step": HiDream-I1's kernels
# (ops/moe.py, csrc/moe_gemm.cu) at hidream_edit_b4_512's shapes
# ---------------------------------------------------------------------------

# relative L2 of a grouped GEMM's live rows against its plain version (the
# same codes' products in float32): a few bf16 roundings of the output; a
# wrong group, gate/up pairing or row weight is off by order 1
MOE_GEMM_REL_L2 = 4e-3
# the combine against its plain version (the same sums in the same order,
# one bf16 rounding)
MOE_COMBINE_REL_L2 = 1e-3
# the router's top-2 against float32 logits summed in another order: the
# same experts but on near-ties, and the same weights where the experts agree
MOE_ROUTE_AGREE = 0.995
MOE_ROUTE_WEIGHT_TOL = 2e-6
MOE_NAMES = ("moe_route", "moe_plan", "moe_quant", "moe_gemm", "moe_combine")


def hidream_rows(batch=4, size=512, text_tokens=512, llama_tokens=128):
    """Rows of each expert-path product in one HiDream-I1 step at
    hidream_edit_b4_512's traffic (4 x 512x512, a 512-token T5 slot, 128
    Llama tokens a block): (single block [L_i ; T5 ; L_47 ; img ; cond],
    double block image stream [img ; cond], double block text stream
    [T5 ; L_47 ; L_i]), each summed over the batch."""
    img = (size // 16) ** 2  # VAE / 8, then 2 x 2 patches
    txt = text_tokens + llama_tokens
    return (batch * (llama_tokens + txt + 2 * img), batch * 2 * img,
            batch * (txt + llama_tokens))


def hidream_moe_cases():
    """(label, M, D, F, shared F, experts, top_k, cond rows a batch row): the
    routed layer of a single block (M 11264: uneven loads, one expert empty)
    with the shared expert beside it, and a double block's text-stream
    SwiGLU (one group, no cond segment), at batch 4."""
    single, _, text = hidream_rows()
    return [("single block", single, 2560, 6912, 3584, 4, 2, 1024),
            ("text stream", text, 2560, 6912, None, 1, 0, 0)]


def _uneven_routing(torch, m, gen):
    """Slot 0 on experts 0 / 1 (70 / 30 %), slot 1 on 1 / 2, expert 3
    empty; weights below 0.5, as a softmax over four gives them."""
    u = torch.rand(m, generator=gen)
    first = torch.where(u < 0.7, 0, 1)
    second = torch.where(first == 0, 1, 2)
    second = torch.where(torch.rand(m, generator=gen) < 0.5, second, 2)
    second = torch.where(second == first, 2, second)
    idx = torch.stack([first, second], 1).to(torch.int32)
    return idx, torch.rand(m, 2, generator=gen) * 0.5


def _moe_stack(torch, g, k, n, gen, device):
    """A random int8 [g, k, n] weight stack and its scales (products of
    order 1 from unit inputs)."""
    w = torch.randint(-127, 128, (g, k, n), dtype=torch.int8, device=device,
                      generator=gen)
    s = (1.0 + 0.25 * torch.rand(g, 1, n, device=device, generator=gen)) / (
        k ** 0.5 * 73.6)
    return w, s


def _moe_record(records, kernel, label, err, tol, run, plain, nbytes, ops,
                kind, **extra):
    """Time one expert-path kernel (the wrapper's call by CUDA events, its
    kernel by device time, its plain version on the card), record it
    beside its bound and fail past ``tol``."""
    ms, dev = cuda_time_ms(run), device_ms(run)
    plain_ms = cuda_time_ms(plain, iters=2)
    bms, by = bound_ms(nbytes, ops, kind)
    records.append(dict(kernel=kernel, case=label, err=err, tol=tol, ms=ms,
                        device_ms=dev, plain_ms=plain_ms, library_ms=None,
                        bound_ms=bms, bound_by=by, **extra))
    print(f"  {kernel:16s} {label:28s} err {err:.3e} (tol {tol:.1e}) wrapper "
          f"{ms:.4f} ms device {dev:.4f} plain {plain_ms:.3f} bound {bms:.4f} "
          f"({by})" + "".join(f" {k} {v}" for k, v in extra.items()),
          flush=True)
    if not err <= tol:
        raise Failure(f"{kernel} {label}: err {err} > {tol}")


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_moe(torch, gen, records, cases=None, device="cuda"):
    """The expert path's kernels against their plain versions
    (`hidream_moe_cases`): the router (the same top-2 but on near-ties,
    MOE_ROUTE_AGREE), the plan and every int8 code and scale bit for bit,
    the grouped GEMMs' live rows within MOE_GEMM_REL_L2 (both epilogues,
    the routed stack of four with an empty expert, the shared expert and
    the text stream's SwiGLU as one group), the combine within
    MOE_COMBINE_REL_L2; each timed beside its plain version and its bound.
    The exact references run on the CPU, the GEMMs' on the card (float32,
    TF32 off).  (On CPU tensors the wrappers run the plain versions: the
    tests drive this at tiny ``cases``.)"""
    from loongx_tpu_torch.ops import moe

    cpu_gen = torch.Generator().manual_seed(11)
    for label, m, d, f, f_shared, e, top_k, cond_rows in (
            cases or hidream_moe_cases()):
        x = torch.randn(m, d, device=device, generator=gen).to(torch.bfloat16)
        x_cpu = x.cpu()
        group = moe.expert_group(d)
        if e > 1:
            gate_w = torch.randn(e, d, device=device, generator=gen) / d ** 0.5
            idx_r, wts_r = moe.route(x, gate_w, top_k)
            idx_p, wts_p = moe.route_plain(x_cpu, gate_w.cpu(), top_k)
            agree = (idx_r.cpu() == idx_p).all(-1)
            share = float(agree.float().mean())
            w_err = float((wts_r.cpu()[agree] - wts_p[agree]).abs().max())
            if share < MOE_ROUTE_AGREE:
                raise Failure(f"moe_route {label}: top-{top_k} agrees on "
                              f"{share:.4f} of rows < {MOE_ROUTE_AGREE}")
            _moe_record(records, "moe_route", f"{label} M{m}", w_err,
                        MOE_ROUTE_WEIGHT_TOL,
                        lambda: moe.route(x, gate_w, top_k),
                        lambda: moe.route_plain(x, gate_w, top_k),
                        m * d * 2 + e * d * 4 + m * top_k * 8,
                        2.0 * m * d * e, "fp32", agree=round(share, 6))

            idx, wts = _uneven_routing(torch, m, cpu_gen)
            cap = moe.capacity(idx.numel(), e)
            idx_c, wts_c = idx.to(device), wts.to(device)
            got = moe.plan(idx_c, wts_c, e, cap)
            want = moe.plan_plain(idx, wts, e, cap)
            n_diff = sum(int((a.cpu() != b).sum()) for a, b in zip(got, want))
            counts, offsets, dest, src, row_w = want
            if int(counts.min()) != 0 or int(counts.sum()) != top_k * m:
                raise Failure(f"moe {label}: routing counts {counts.tolist()}")
            _moe_record(records, "moe_plan", f"{label} M{m} cap {cap}",
                        float(n_diff), 0.0,
                        lambda: moe.plan(idx_c, wts_c, e, cap),
                        lambda: moe.plan_plain(idx_c, wts_c, e, cap),
                        m * top_k * 12 + cap * 8 + (2 * e + 1) * 4,
                        float(m * top_k * e), "fp32",
                        counts=counts.tolist())
            counts_c, offsets_c, dest_c, src_c, row_w_c = got
            live = src >= 0
            rows = int(offsets[e])  # rows of the groups' tiles
            limit = offsets_c[e:]
        else:
            cap, rows, counts_c = m, m, None
            offsets_c = dest_c = src_c = row_w_c = limit = None
            live = torch.ones(m, dtype=torch.bool)
        ng = d // group

        # the codes of x: gathered into the groups (routed) or in order
        def quant_x():
            return moe.quant_rows(x, group, src=src_c)

        xq = quant_x()
        xq_p = moe.quant_rows_plain(x_cpu, group,
                                    None if src_c is None else src_c.cpu())
        n_diff = (int((xq[0].cpu() != xq_p[0]).sum())
                  + int((xq[1].cpu() != xq_p[1]).sum()))
        what = "gathered" if src_c is not None else "in order"
        _moe_record(records, "moe_quant", f"{label} x {what} K{d}",
                    float(n_diff), 0.0, quant_x,
                    lambda: moe.quant_rows_plain(x, group, src_c),
                    int(live.sum()) * d * 2 + cap * d + cap * ng * 4,
                    4.0 * cap * d, "fp32")

        stacks = [("routed" if e > 1 else "text", e, f, counts_c, offsets_c,
                   row_w_c, limit, xq)]
        if e > 1:  # the shared expert: one group of every token
            x_in = moe.quant_rows(x, group)
            stacks.append(("shared", 1, f_shared, None, None, None, None, x_in))
        for name, g, width, cnt, off, rw, lim, (codes, scales) in stacks:
            w13, s13 = _moe_stack(torch, g, d, 2 * width, gen, device)
            w2, s2 = _moe_stack(torch, g, width, d, gen, device)
            r = codes.shape[0]
            keep = live if name != "shared" else torch.ones(r, dtype=torch.bool)
            n_rows = int(keep.sum())
            a_rows = rows if name != "shared" else r
            groups_used = g if cnt is None else int((cnt > 0).sum())

            def up():
                return moe.grouped_gemm(codes, scales, w13, s13,
                                        moe.EPI_SWIGLU, off, cnt)

            h = up()
            h_p = moe.grouped_gemm_plain(codes, scales, w13, s13,
                                         moe.EPI_SWIGLU, off, cnt)
            _moe_record(
                records, "moe_gemm_swiglu", f"{name} gate-up M{n_rows} K{d} "
                f"N{2 * width}", _rel_l2(h.cpu()[keep], h_p.cpu()[keep]),
                MOE_GEMM_REL_L2, up,
                lambda: moe.grouped_gemm_plain(codes, scales, w13, s13,
                                               moe.EPI_SWIGLU, off, cnt),
                a_rows * d + groups_used * d * 2 * width + a_rows * ng * 4
                + g * 2 * width * 4 + a_rows * width * 2,
                2.0 * n_rows * d * 2 * width, "int8", groups=g)
            hgroup = moe.expert_group(width)

            def quant_h():
                return moe.quant_rows(h, hgroup, limit=lim)

            hq = quant_h()
            hq_p = moe.quant_rows_plain(h.cpu(), hgroup)
            n_diff = (int((hq[0].cpu()[keep] != hq_p[0][keep]).sum())
                      + int((hq[1].cpu()[keep] != hq_p[1][keep]).sum()))
            _moe_record(records, "moe_quant", f"{name} h K{width}",
                        float(n_diff), 0.0, quant_h,
                        lambda: moe.quant_rows_plain(h, hgroup),
                        a_rows * width * 3 + a_rows * (width // hgroup) * 4,
                        4.0 * a_rows * width, "fp32")

            def down():
                return moe.grouped_gemm(hq[0], hq[1], w2, s2, moe.EPI_ROWS,
                                        off, cnt, rw)

            y = down()
            y_p = moe.grouped_gemm_plain(hq[0], hq[1], w2, s2, moe.EPI_ROWS,
                                         off, cnt, rw)
            _moe_record(
                records, "moe_gemm_rows", f"{name} down M{n_rows} K{width} "
                f"N{d}", _rel_l2(y.cpu()[keep], y_p.cpu()[keep]),
                MOE_GEMM_REL_L2, down,
                lambda: moe.grouped_gemm_plain(hq[0], hq[1], w2, s2,
                                               moe.EPI_ROWS, off, cnt, rw),
                a_rows * width + groups_used * width * d
                + a_rows * (width // hgroup) * 4 + g * d * 4 + a_rows * d * 2,
                2.0 * n_rows * width * d, "int8", groups=g)
            if name == "shared":
                y_shared = y
            else:
                y_main = y

        # the combine: resid + gate_seg * (routed rows + shared row)
        rows_per_batch = m // 4
        boundary = rows_per_batch - cond_rows  # the cond segment: the last
        gate = torch.randn(4, 2, d, device=device, generator=gen)
        resid = torch.randn(m, d, device=device, generator=gen).to(torch.bfloat16)
        if e > 1:
            args = (y_main, dest_c, y_shared)
        else:
            args = (None, None, y_main)

        def comb():
            return moe.combine(resid, gate, args[0], args[1], args[2],
                               rows_per_batch, boundary)

        out = comb()
        out_p = moe.combine_plain(
            resid.cpu(), gate.cpu(), *(None if a is None else a.cpu()
                                       for a in args),
            rows_per_batch, boundary)
        flips = int((out.cpu() != out_p).sum())
        k = top_k if e > 1 else 0
        _moe_record(records, "moe_combine", f"{label} M{m} top {k}",
                    _rel_l2(out.cpu(), out_p), MOE_COMBINE_REL_L2, comb,
                    lambda: moe.combine_plain(resid, gate, *args,
                                              rows_per_batch, boundary),
                    m * d * 2 * (k + 3) + 8 * d * 4 + m * k * 4,
                    (k + 2.0) * m * d, "fp32", differing=flips)


def hidream_step(torch):
    """One full-width HiDream-I1 denoise step at hidream_edit_b4_512's shapes
    (random int8 weights on the card, seeded draws): warmed once, then run
    again with `cuda_build.LAUNCHES` zeroed just before it and every
    synchronizing CUDA call an error (no host synchronization inside a
    step), equal to the first run bit for bit, its launches by kernel (one
    route, plan and combine a MoE layer, one grouped GEMM launch a SwiGLU
    projection: routed, shared and the text stream's), its ms and device
    profile, and the full-width q/k RMS norm's device ms a step beside its
    byte bound.  The bundle is freed after it."""
    import numpy as np
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.hidream.model import HiDreamConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops.latents import latent_image_ids
    from loongx_tpu_torch.ops.nn import rms_norm
    from loongx_tpu_torch.sampling import generate

    cfg = HiDreamConfig.hidream_i1()
    t0 = time.perf_counter()
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.flux(), seed=1)
    torch.cuda.synchronize()
    print(f"  HiDream-I1 bundle (int8, serving layout) built on the card in "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} "
          "GiB allocated", flush=True)
    b, dev, dt = 4, torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    lat = torch.randn(b, 1024, 64, device=dev, generator=gen).to(dt)
    cond = torch.randn(b, 1024, 64, device=dev, generator=gen).to(dt)
    txt = torch.randn(b, 512, 4096, device=dev, generator=gen).to(dt)
    llama = torch.randn(b, 48, 128, 4096, device=dev, generator=gen).to(dt)
    pooled = torch.randn(b, 2048, device=dev, generator=gen).to(dt)
    ids = latent_image_ids(64, 64, device=dev)
    txt_ids = torch.zeros(512, 3, device=dev)
    sig = np.array([1.0, 0.9643], np.float32)

    def step():
        with torch.inference_mode():
            return generate.denoise(pipe.params["flux"], cfg, {}, lat, txt,
                                    pooled, ids, txt_ids, cond, ids, sig,
                                    None, None, w8a8=True, text_streams=llama)

    cuda_build.LAUNCHES.clear()
    first = step()
    torch.cuda.synchronize()
    # the first step makes every W8A8 wgmma weight K-major (each expert stack
    # and dense wgmma leaf once), the second none
    converted = cuda_build.LAUNCHES["w8a8_layout:kmajor"]
    cuda_build.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = dict(cuda_build.LAUNCHES)
    layers, text_ffn = cfg.llama_streams, cfg.num_double_blocks
    want = {"moe_route": layers, "moe_plan": layers,
            "moe_quant": 4 * layers + 2 * text_ffn,
            "moe_gemm": 4 * layers + 2 * text_ffn,
            "moe_combine": layers + text_ffn}
    got = {k: counts.get(k, 0) for k in want}
    print(f"  launches in one step (with the caption projections): "
          f"{json.dumps(counts, sort_keys=True)}", flush=True)
    if got != want:
        raise Failure(f"HiDream step launches {got} != {want}")
    print(f"  weights made K-major: {converted} leaves in the first step, "
          f"{counts.get('w8a8_layout:kmajor', 0)} in the second", flush=True)
    if not converted or counts.get("w8a8_layout:kmajor") or counts.get("w8a8_layout:kn"):
        raise Failure("HiDream step: the first step must make the W8A8 weights K-major "
                      "and the second convert none")
    if not (torch.isfinite(second.float()).all() and torch.equal(first, second)):
        raise Failure("HiDream step: not finite, or not equal to the warm-up "
                      "step bit for bit")
    ms = cuda_time_ms(step, iters=3)
    prof = _profile(step, (*MOE_NAMES, "flash_fwd_wgmma_kernel",
                           "rope_prepass_kernel", "qmm_wgmma_kernel",
                           "act_quant_"))
    print(f"  one step {ms:.1f} ms (CUDA events, the 49 caption projections "
          f"included); device profile {json.dumps(prof)}", flush=True)

    # the q/k RMS norm over all 2560 columns (PyTorch ops, float32): device ms
    # a step against the bytes an ideal pass moves (read and write bf16 q, k)
    single, img_stream, text_stream = hidream_rows()
    d = cfg.hidden
    norm_ms = bound = 0.0
    w = torch.ones(d, device=dev, dtype=dt)
    for m, blocks in ((single, cfg.num_single_blocks),
                      (img_stream, text_ffn), (text_stream, text_ffn)):
        qkv = torch.randn(m, 3 * d, device=dev, generator=gen).to(dt)
        q = qkv.chunk(3, dim=-1)[0]
        norm_ms += 2 * blocks * device_ms(lambda: rms_norm(q, w, cfg.qk_eps))
        bound += 2 * blocks * bound_ms(2 * m * d * 2, 0.0, "fp32")[0]
    print(f"  q/k RMS norm (ops.nn.rms_norm over D {d}): {norm_ms:.2f} device ms "
          f"a step, byte bound {bound:.2f} ms", flush=True)
    del pipe, first, second
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(step_ms=ms, norm_ms=norm_ms, norm_bound_ms=bound)


def attention_fp32_probs(q, k, v, *, cond_start, mode="union", c_factor=None,
                         rope=None, layout="bhsd", int8_attn=False):
    """The plain attention with float32 probabilities in the PV product (the
    plain version rounds them to bf16 first): an equally valid rounding,
    used to measure how far such a choice moves a whole forward (bf16
    scores only)."""
    import torch
    if int8_attn:
        raise Failure("attention_fp32_probs has no int8 score mode")
    from loongx_tpu_torch.ops.attention import _block_bias
    from loongx_tpu_torch.ops.rope import apply_rope

    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if rope is not None:
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    s = q.shape[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(q.shape[-1])
    if cond_start < s:
        bias = _block_bias(s, cond_start, mode, c_factor, q.device)
        if bias is not None:
            logits = logits + bias
    out = torch.matmul(torch.softmax(logits, -1), v.float()).to(q.dtype)
    return out.transpose(1, 2) if layout == "bshd" else out


@contextlib.contextmanager
def plain_versions(attention=None):
    """Swap the kernel wrappers for their plain versions (the model calls
    them through their modules), for the reference forward and, under
    autograd, the reference backward; ``attention`` replaces the plain
    attention."""
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops import quant_matmul as qmm

    def flat(x, w_q, scale, *, bias=None, activation=None, w8a8=False):
        group, k_pad = qmm.flat_w8a8_group(*w_q.shape)
        return qmm.qmm_plain(x, w_q, scale, bias, activation, w8a8, group,
                             k_pad)

    def stacked(x, w_q3, scale3, blk, *, bias3=None, activation=None,
                w8a8=False, ab=None, resid=None, gate=None, seg_boundary=0):
        if not qmm.stacked_ok(*w_q3.shape[1:]):
            raise Failure(f"plain_versions: no stacked tiling for "
                          f"{tuple(w_q3.shape)}")
        group, k_pad = qmm.stacked_w8a8_group(*w_q3.shape[1:])
        return qmm.qmm_plain(x, w_q3[blk], scale3[blk],
                             None if bias3 is None else bias3[blk], activation,
                             w8a8, group, k_pad, ab, resid, gate, seg_boundary)

    def qkv(x, w_q3, scale3, bias3, norm_w, blk, head_dim, *, w8a8=False,
            ab=None, seg_boundary=0):
        group, k_pad = qmm.stacked_w8a8_group(*w_q3.shape[1:])
        return qmm.quant_qkv_plain(x, w_q3[blk], scale3[blk], bias3[blk],
                                   norm_w, head_dim, w8a8, group, k_pad, ab,
                                   seg_boundary)

    def t_stacked(dy, w_q3, scale3, blk):
        return qmm.qmm_t_plain(dy, w_q3[blk], scale3[blk])

    def lora_plain(y, x, lora):
        """The rank-r update (A, B, ms) of the LoRA linear's Function as a
        float32 composition: bf16(x A), times ms, rounded, times B."""
        if lora is None:
            return y
        a, b, ms = lora
        xa = (x.float() @ a.float()).to(x.dtype)
        xa = (xa.float() * ms).to(x.dtype)
        return (y.float() + xa.float() @ b.float()).to(x.dtype)

    def flat_vjp(x, w_q, scale, *, bias=None, lora=None, w8a8=False):
        return lora_plain(flat(x, w_q, scale, bias=bias, w8a8=w8a8), x, lora)

    def stacked_vjp(x, w_q3, scale3, blk, *, bias3=None, lora=None,
                    w8a8=False):
        return lora_plain(stacked(x, w_q3, scale3, blk, bias3=bias3,
                                  w8a8=w8a8), x, lora)

    def gelu_stacked(x, w_q3, scale3, bias3, blk, *, w8a8=False):
        return stacked(x, w_q3, scale3, blk, bias3=bias3,
                       activation="gelu_tanh", w8a8=w8a8)

    def gelu_flat(x, w_q, scale, bias, *, w8a8=False):
        return flat(x, w_q, scale, bias=bias, activation="gelu_tanh", w8a8=w8a8)

    # the differentiable wrappers become autograd through the plain versions
    swaps = [(fa, "flash_attention", attention or fa.flash_attention_plain),
             (qmm, "quant_matmul", flat), (qmm, "quant_matmul_stacked", stacked),
             (qmm, "quant_qkv_stacked", qkv), (qmm, "quant_matmul_vjp", flat_vjp),
             (qmm, "quant_matmul_stacked_vjp", stacked_vjp),
             (qmm, "quant_linear_gelu_stacked", gelu_stacked),
             (qmm, "quant_linear_gelu", gelu_flat),
             (qmm, "quant_matmul_t_stacked", t_stacked)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


KERNELS = ("flash_attention", "flash_attention:wgmma", "flash_rope",
           "qmm_stacked", "qmm_stacked:wgmma", "qmm_qkv_stacked",
           "qmm_qkv_stacked:wgmma", "qmm_flat", "qmm_flat:wgmma",
           "qmm_flat:k64", "qmm_flat:splitk", "qmm_act_quant",
           "qmm_act_quant:warp")
TRAIN_KERNELS = ("flash_attention", "flash_attention:wgmma", "flash_rope",
                 "qmm_stacked", "qmm_stacked:wgmma", "qmm_flat",
                 "qmm_flat:splitk", "qmm_flat:k64", "qmm_t", "qmm_t:narrow",
                 "qmm_t_stacked",
                 "qmm_t_stacked:wgmma", "flash_bwd_dkv", "flash_bwd_dkv:wgmma",
                 "flash_bwd_dq", "flash_bwd_dq:wgmma")
# the routes a launch of the int8 GEMM entries can take
GEMM_ROUTES = ("wgmma", "splitk", "k64", "narrow", "mma_sync")
FLASH_BWD_GROUPS = ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                    "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# the training step's int8 GEMM groups: the weight-only forward (forward,
# remat and gelu recompute) and the transposed backward, each by kernel
WONLY_GROUPS = ("qmm_bf16_wgmma_kernel", "qmm_splitk_kernel", "qmm_k64_kernel",
                "qmm_kernel")
TRANSPOSED_GROUPS = ("qmm_t_wgmma_kernel", "qmm_t_prescale_kernel",
                     "qmm_t_narrow_kernel", "qmm_t_kernel")
GEMM_ENTRIES = ("qmm_stacked", "qmm_qkv_stacked", "qmm_flat")
# the int8 QK^T forward's kernels and its pre-pass (kquant_max_kernel,
# kquant_codes_kernel), then the activation pass (act_quant_warp_kernel,
# act_quant_block_kernel)
INT8_ATTN_GROUPS = ("flash_fwd_int8_wgmma_kernel", "flash_fwd_kernel", "kquant_")
# the row stats and the weight-only prologue pass (the warp kernels, then
# the block route's)
LN_GROUPS = ("ln_mod_pass_kernel", "ln_stats_warp_kernel",
             "ln_mod_apply_kernel", "ln_stats_kernel")
PROFILE_GROUPS = ("flash_fwd_wgmma_kernel", "rope_prepass_kernel",
                  "qmm_wgmma_kernel", *INT8_ATTN_GROUPS, *FLASH_BWD_GROUPS,
                  *WONLY_GROUPS, *TRANSPOSED_GROUPS, "act_quant_", *LN_GROUPS)


def device_profile(run):
    """`device_bench.device_profile` of one ``run()`` by PROFILE_GROUPS."""
    return _profile(run, PROFILE_GROUPS)


def gemm_split(counts):
    """{entry: (launches, wgmma, mma_sync, splitk, k64)} of the int8 GEMM
    entries; each launch goes to exactly one of the kernels."""
    out = {e: (counts.get(e, 0), counts.get(f"{e}:wgmma", 0),
               counts.get(f"{e}:mma_sync", 0), counts.get(f"{e}:splitk", 0),
               counts.get(f"{e}:k64", 0))
           for e in GEMM_ENTRIES}
    for e, (total, wg, ms, sk, k64) in out.items():
        if total != wg + ms + sk + k64:
            raise Failure(f"{e}: {total} launches, {wg} wgmma + {ms} mma.sync "
                          f"+ {sk} split-K + {k64} K 64")
    return out


def routes(counts, entry):
    """{route: launches} of one GEMM entry (`GEMM_ROUTES`, those taken)."""
    return {r: counts[f"{entry}:{r}"] for r in GEMM_ROUTES
            if counts.get(f"{entry}:{r}")}


def host_profile(torch, run, top=8):
    """Host seconds of one ``run()`` under cProfile: the total and the
    functions with the most time of their own."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    total = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"total_ms": round(total * 1e3, 1), "by_own_time_ms": {
        f"{fn.rsplit('/', 1)[-1]}:{line}({name})": (round(v[2] * 1e3, 1), v[1])
        for (fn, line, name), v in rows}}


INT8_STD = math.sqrt((256 ** 2 - 1) / 12.0)  # uniform int8 bits -128..127


def unit_gain(torch, tree):
    """The same int8 stacks with kernel_scale = 1 / (sqrt(K) * INT8_STD), so
    that every linear keeps its input's variance.  With the serving scales
    (0.02 / sqrt(K) / 127) each branch of a block is far below the bf16
    resolution of the residual stream, the blocks leave it unchanged, and a
    comparison of whole forwards could not see the kernels at all."""
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            out = dict(tree)
            out["kernel_scale"] = torch.full_like(
                tree["kernel_scale"],
                1.0 / (math.sqrt(tree["kernel_q"].shape[-2]) * INT8_STD))
            return out
        return {k: unit_gain(torch, v) for k, v in tree.items()}
    return tree


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def full_forward(torch, pipe, gen):
    from loongx_tpu_torch.models.flux.model import flux_forward
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops.latents import latent_image_ids

    cfg = pipe.flux_cfg
    shallow = dataclasses.replace(cfg, num_double_blocks=1,
                                  num_single_blocks=1)
    no_blocks = dataclasses.replace(cfg, num_double_blocks=0,
                                    num_single_blocks=0)
    # (depth, w8a8, bound on the rel L2 of the velocity kernels vs plain,
    # largest share of the bound the rounding floor may take).  Any valid
    # change of bf16 rounding moves a unit-gain velocity by the floor
    # printed beside each comparison.  After the first double and single
    # block in weight-only mode the floor is small and the bound stands
    # well above it.  W8A8 turns every such change into flips of int8
    # activations and 57 blocks carry them on, so the W8A8 comparisons
    # read several times their weight-only floor and catch only gross
    # faults; the W8A8 GEMMs equal their plain versions exactly (phase 2).
    comparisons = [(shallow, False, 1e-2, 0.5), (shallow, True, 5e-2, None),
                   (cfg, True, 5e-2, None)]
    params = unit_gain(torch, pipe.params["flux"])
    s_txt, s_img = 512, 1024
    bf = torch.bfloat16
    kw = dict(
        img=torch.randn(1, s_img, cfg.in_channels, generator=gen,
                        device="cuda").to(bf),
        txt=torch.randn(1, s_txt, cfg.joint_dim, generator=gen,
                        device="cuda").to(bf),
        pooled=torch.randn(1, cfg.pooled_dim, generator=gen,
                           device="cuda").to(bf),
        cond=torch.randn(1, s_img, cfg.in_channels, generator=gen,
                         device="cuda").to(bf),
        timestep=torch.full((1,), 0.7, device="cuda"),
        guidance=torch.full((1,), 3.5, device="cuda"),
        img_ids=latent_image_ids(64, 64), cond_ids=latent_image_ids(64, 64),
        txt_ids=torch.zeros(s_txt, 3, device="cuda"))
    with torch.inference_mode():
        flux_forward(params, cfg, w8a8=True, **kw)  # warm
        torch.cuda.synchronize()
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        flux_forward(params, cfg, w8a8=True, **kw)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        counts = {name: cuda_build.LAUNCHES[name] for name in KERNELS}
        split = gemm_split(cuda_build.LAUNCHES)
        flat_routes = routes(cuda_build.LAUNCHES, "qmm_flat")
        prof = device_profile(lambda: flux_forward(
            params, cfg, w8a8=True, **kw))
        host = host_profile(torch, lambda: flux_forward(
            params, cfg, w8a8=True, **kw))
        with plain_versions():
            t0 = time.perf_counter()
            flux_forward(params, cfg, w8a8=True, **kw)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
        print(f"  forward S{s_txt + 2 * s_img}: kernels {t_kernel * 1e3:.1f} "
              f"ms, plain {t_plain * 1e3:.1f} ms, launches {counts}; GEMM "
              f"launches (total, wgmma, mma.sync, split-K, K 64) {split}; qmm_flat "
              f"by route {flat_routes}", flush=True)
        # the final proj_out (N 64) on the split-K kernel, x_embedder's K 64
        # (img and cond) on the K 64 kernel: no flat launch on mma.sync
        if (not split["qmm_flat"][3] or split["qmm_flat"][2]
                or split["qmm_flat"][4] != 2):
            raise Failure(f"W8A8 forward: qmm_flat launches {split['qmm_flat']} "
                          "(total, wgmma, mma.sync, split-K, K 64): proj_out not "
                          "on split-K, x_embedder's two not on the K 64 kernel "
                          "or a launch on mma.sync")
        for depth, w8a8, bound, floor_share in comparisons:
            def run(depth=depth, w8a8=w8a8):
                return flux_forward(params, depth, w8a8=w8a8, **kw)
            cuda_build.LAUNCHES.clear()
            v_k = run()
            run_split = gemm_split(cuda_build.LAUNCHES)
            if not w8a8 and (run_split["qmm_stacked"][2]
                             or run_split["qmm_qkv_stacked"][2]
                             or not run_split["qmm_stacked"][1]):
                raise Failure(f"weight-only forward: stacked / qkv launches "
                              f"not all on wgmma: {run_split}")
            with plain_versions():
                v_p = run()
            with plain_versions(attention_fp32_probs):
                v_floor = run()
            rel = rel_l2(v_k, v_p)
            # the same comparison between two plain forwards that differ
            # only in the rounding of the attention probabilities
            floor = rel_l2(v_floor, v_p)
            # the comparison sees the blocks only if they move the velocity
            blocks = rel_l2(run(no_blocks), v_k)
            finite = bool(torch.isfinite(v_k).all())
            label = (f"{depth.num_double_blocks}+{depth.num_single_blocks} "
                     f"blocks {'W8A8' if w8a8 else 'weight-only'}")
            print(f"  forward {label}: rel L2 {rel:.3e} (bound {bound:.0e}; "
                  f"plain with float32 probabilities vs plain: {floor:.3e}), "
                  f"the blocks move the velocity by {blocks:.3f} (rel L2), "
                  f"finite {finite}; GEMM launches (total, wgmma, mma.sync, "
                  f"split-K, K 64) {run_split}", flush=True)
            if not finite or not rel <= bound:
                raise Failure(f"forward {label}: rel L2 {rel} (bound {bound}),"
                              f" finite {finite}")
            if not blocks >= 0.1:
                raise Failure(f"forward {label}: the blocks move the velocity "
                              f"by only {blocks} (rel L2), so the comparison "
                              f"cannot see them")
            if floor_share is not None and not floor <= floor_share * bound:
                raise Failure(f"forward {label}: the rounding floor {floor} "
                              f"is not small against the bound {bound}")
        # the int8 QK^T mode through all 57 blocks (W8A8): kernels against
        # their plain versions (gross faults only, as for W8A8 above) and,
        # printed, against bf16 scores
        v_bf16 = flux_forward(params, cfg, w8a8=True, **kw)
        v_int8 = flux_forward(params, cfg, w8a8=True, int8_attn=True, **kw)
        with plain_versions():
            v_int8_plain = flux_forward(params, cfg, w8a8=True, int8_attn=True,
                                        **kw)
        rel, rel_bf16 = rel_l2(v_int8, v_int8_plain), rel_l2(v_int8, v_bf16)
        finite = bool(torch.isfinite(v_int8).all())
        print(f"  forward 19+38 blocks W8A8 int8_attn: rel L2 {rel:.3e} (bound "
              f"5e-02), against bf16 scores {rel_bf16:.3e}, finite {finite}",
              flush=True)
        if not finite or not rel <= 5e-2:
            raise Failure(f"forward int8_attn: rel L2 {rel}, finite {finite}")
        cuda_build.LAUNCHES.clear()
        prof_int8 = device_profile(lambda: flux_forward(
            params, cfg, w8a8=True, int8_attn=True, **kw))
        int8_counts = {n: cuda_build.LAUNCHES[n] for n in (
            "flash_attention_int8", "flash_attention_int8:wgmma", "flash_kquant")}
        fused = fused_forward(torch, params, cfg, kw, v_bf16, t_kernel)
    print(f"  forward host profile (cProfile, its own overhead included): "
          f"{host}", flush=True)
    if prof is None:
        print("  forward device profile: not measured (no device activity "
              "in the profiler)", flush=True)
    else:
        print("  forward device profile: busy {busy_ms:.1f} ms over a span of "
              "{span_ms:.1f} ms, idle share {idle_share:.3f}; by group "
              "{by_group_ms}; largest other {top_other_ms}".format(**prof),
              flush=True)
    if prof_int8 is None:
        print("  int8_attn forward device profile: not measured (no device "
              "activity in the profiler)", flush=True)
    else:
        groups = prof_int8["by_group_ms"]
        print("  int8_attn forward device profile: busy {busy_ms:.1f} ms over a "
              "span of {span_ms:.1f} ms, idle share {idle_share:.3f}; by group "
              "{by_group_ms}; largest other {top_other_ms}".format(**prof_int8),
              flush=True)
        print(f"  int8_attn forward: its flash group (forward kernels and "
              f"pre-pass) {sum(groups.get(g, 0.0) for g in INT8_ATTN_GROUPS):.2f} "
              f"ms (" + ", ".join(f"{g} {groups[g]:.2f}" for g in INT8_ATTN_GROUPS
                                  if g in groups)
              + f"); launches {int8_counts}", flush=True)
    if prof is not None:
        print(f"  forward activation pass group (act_quant_warp_kernel / "
              f"act_quant_block_kernel): "
              f"{prof['by_group_ms'].get('act_quant_', 0.0):.2f} ms", flush=True)
    blocks = cfg.num_double_blocks + cfg.num_single_blocks
    if not (int8_counts["flash_attention_int8"]
            == int8_counts["flash_attention_int8:wgmma"]
            == int8_counts["flash_kquant"] == blocks):
        raise Failure(f"int8_attn forward launches {int8_counts}: want {blocks} "
                      f"on wgmma, each after its pre-pass")
    if not (counts["flash_attention"] == counts["flash_attention:wgmma"]
            == counts["flash_rope"] == blocks):
        raise Failure(f"flash launches {counts}: want {blocks} on wgmma, each "
                      f"after its RoPE pre-pass")
    # every stacked and fused-qkv launch (M 2 to 2560) on the wgmma GEMM;
    # the flat ones that the tiling cannot take (K 64, N 64) on their own
    if split["qmm_stacked"][2] or split["qmm_qkv_stacked"][2]:
        raise Failure(f"stacked / qkv launches on mma.sync: {split}")
    # every activation pass of the forward on the warp kernel, one ahead of
    # each W8A8 GEMM launch but the K 64 kernel's, which quantizes x itself
    passes = sum(split[e][0] for e in GEMM_ENTRIES) - split["qmm_flat"][4]
    print(f"  forward activation passes: {counts['qmm_act_quant']} (one a W8A8 "
          f"GEMM launch but the K 64 kernel's {split['qmm_flat'][4]}: "
          f"{passes})", flush=True)
    if counts["qmm_act_quant"] != counts["qmm_act_quant:warp"]:
        raise Failure(f"activation passes not all on the warp kernel: {counts}")
    if counts["qmm_act_quant"] != passes:
        raise Failure(f"activation passes {counts['qmm_act_quant']}, want "
                      f"{passes} (GEMM launches {split})")
    if not all(counts.values()):
        raise Failure(f"a kernel was not launched: {counts}")
    fused_launch_check(cfg, fused, 1, "forward")
    return kw


FUSED_KERNELS = ("qmm_stacked_ln", "qmm_stacked_ln:wgmma",
                 "qmm_qkv_stacked_ln", "qmm_stacked_gate", "qmm_act_quant_ln",
                 "qmm_ln_stats", "qmm_ln_stats:warp", "qmm_ln_mod_pass",
                 "qmm_ln_mod_pass:warp")


def fused_launch_check(cfg, counts, forwards, what):
    """Per forward at B 1: one prologue in each block's qkv and MLP-in
    projection (2 x 57 = 114; W8A8: as many activation passes with the
    prologue and row stats launches, every stats launch on the warp
    kernel, no weight-only prologue pass), one gate epilogue in each
    block's two gated projections (114); the unfused qkv kernel only for
    the double blocks' text stream."""
    blocks = cfg.num_double_blocks + cfg.num_single_blocks
    ln = counts.get("qmm_stacked_ln", 0) + counts.get("qmm_qkv_stacked_ln", 0)
    want = 2 * blocks * forwards
    if not (ln == counts.get("qmm_stacked_gate", 0)
            == counts.get("qmm_act_quant_ln", 0)
            == counts.get("qmm_ln_stats", 0)
            == counts.get("qmm_ln_stats:warp", 0) == want
            and not counts.get("qmm_ln_mod_pass")
            and counts.get("qmm_qkv_stacked", 0)
            == cfg.num_double_blocks * forwards):
        raise Failure(f"{what}: fused launches {counts}, want {want} prologues"
                      f" and {want} gates")


def fused_forward(torch, params, cfg, kw, v_unfused, t_unfused):
    """The 57-block unit-gain W8A8 forward with fuse_ln and fuse_gate:
    kernels against plain beside the rounding floor, against the unfused
    forward, its time, launches and device profile.  Returns the launch
    counts of one forward."""
    from loongx_tpu_torch.models.flux.model import flux_forward
    from loongx_tpu_torch.ops import cuda_build

    fkw = dict(kw, w8a8=True, fuse_ln=True, fuse_gate=True)
    flux_forward(params, cfg, **fkw)  # warm
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    v_k = flux_forward(params, cfg, **fkw)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    counts = dict(cuda_build.LAUNCHES)
    prof = device_profile(lambda: flux_forward(params, cfg, **fkw))
    with plain_versions():
        v_p = flux_forward(params, cfg, **fkw)
    with plain_versions(attention_fp32_probs):
        v_floor = flux_forward(params, cfg, **fkw)
    rel, floor = rel_l2(v_k, v_p), rel_l2(v_floor, v_p)
    finite = bool(torch.isfinite(v_k).all())
    print(f"  forward 19+38 blocks W8A8 fuse_ln+fuse_gate: rel L2 {rel:.3e} "
          f"(bound 5e-02; plain with float32 probabilities vs plain: "
          f"{floor:.3e}), against the unfused forward {rel_l2(v_k, v_unfused):.3e},"
          f" finite {finite}; {t_fused * 1e3:.1f} ms (unfused "
          f"{t_unfused * 1e3:.1f} ms); launches " + ", ".join(
              f"{n} {counts.get(n, 0)}" for n in FUSED_KERNELS + (
                  "qmm_stacked", "qmm_qkv_stacked", "qmm_act_quant")),
          flush=True)
    if prof is None:
        print("  fused forward device profile: not measured (no device "
              "activity in the profiler)", flush=True)
    else:
        print("  fused forward device profile: busy {busy_ms:.1f} ms over a "
              "span of {span_ms:.1f} ms, idle share {idle_share:.3f}; by group "
              "{by_group_ms}; largest other {top_other_ms}".format(**prof),
              flush=True)
    if not finite or not rel <= 5e-2:
        raise Failure(f"fused forward: rel L2 {rel}, finite {finite}")
    return counts


# bound on the relative L2 of a LoRA factor's gradient, kernels vs plain
# (full width, first double and single block, unit gain): about 6x the
# rounding floor, which must stay under half of it
GRAD_REL_L2 = 5e-2


def _unit_gain_lora(torch, tree, gen):
    """LoRA factors at unit gain (A ~ N(0, 1/in), B ~ N(0, 1/r)), so that
    both factors have gradients and each delta keeps its input's variance."""
    if isinstance(tree, dict):
        if "lora_a" in tree:
            out = dict(tree)
            for name in ("lora_a", "lora_b"):
                t = tree[name]
                out[name] = (torch.randn(t.shape, generator=gen, device="cuda")
                             / math.sqrt(t.shape[-2])).to(t.dtype)
            return out
        return {k: _unit_gain_lora(torch, v, gen) for k, v in tree.items()}
    return tree


def lora_grads(torch, gen, kw):
    """Gradients of every LoRA leaf of the training tree's first double and
    single block (full width, the int8 stacks and LoRA at unit gain, remat
    on, weight-only) through the kernels and through the plain versions,
    beside the floor: the same comparison between two plain runs that
    differ only in the rounding of the attention probabilities."""
    from loongx_tpu_torch.models.flux.model import FluxConfig, flux_forward
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.train.lora import lora_state_dict

    shallow = dataclasses.replace(FluxConfig.flux_dev(), num_double_blocks=1,
                                  num_single_blocks=1)
    pipe = LoongXPipeline.init_training(shallow, seed=1)
    params = _unit_gain_lora(torch, unit_gain(torch, pipe.params["flux"]), gen)
    # the trainable factors (lora_scale is frozen in the step)
    leaves = {k: v for k, v in lora_state_dict(params).items()
              if not k.endswith("lora_scale")}
    for t in leaves.values():
        t.requires_grad_(True)
    cot = torch.randn(kw["img"].shape, generator=gen, device="cuda")

    def grads(remat):
        v = flux_forward(params, shallow, remat=remat, **kw)
        return torch.autograd.grad((v.float() * cot).sum(), list(leaves.values()))

    cuda_build.LAUNCHES.clear()
    g_k = grads(True)
    counts = {n: cuda_build.LAUNCHES[n] for n in TRAIN_KERNELS}
    with plain_versions():
        g_p = grads(False)
    with plain_versions(attention_fp32_probs):
        g_f = grads(False)
    worst, worst_floor, zero = (0.0, ""), (0.0, ""), []
    for name, a, b, f in zip(leaves, g_k, g_p, g_f):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise Failure(f"LoRA gradient {name}: not finite")
        if b.float().norm() == 0:
            # the last single block's to_q / proj_mlp / proj_out LoRA acts
            # on condition rows only, which the velocity never reads
            zero.append(name)
            if a.float().norm() != 0:
                raise Failure(f"LoRA gradient {name}: plain is zero, kernels not")
            continue
        rel, floor = rel_l2(a, b), rel_l2(f, b)
        worst, worst_floor = max(worst, (rel, name)), max(worst_floor, (floor, name))
        if not rel <= GRAD_REL_L2:
            raise Failure(f"LoRA gradient {name}: rel L2 {rel} (bound "
                          f"{GRAD_REL_L2}, floor {floor})")
    if not worst_floor[0] <= 0.5 * GRAD_REL_L2:
        raise Failure(f"LoRA gradients: the rounding floor {worst_floor} is not "
                      f"small against the bound {GRAD_REL_L2}")
    print(f"  LoRA gradients, 1+1 blocks at full width ({len(leaves)} factors, "
          f"{len(zero)} zero in both: {zero}): rel L2 kernels vs plain at most "
          f"{worst[0]:.3e} ({worst[1]}; bound {GRAD_REL_L2:.0e}); plain with "
          f"float32 probabilities vs plain at most {worst_floor[0]:.3e} "
          f"({worst_floor[1]}); launches {counts}; by route qmm_flat "
          f"{routes(cuda_build.LAUNCHES, 'qmm_flat')}, qmm_t "
          f"{routes(cuda_build.LAUNCHES, 'qmm_t')}", flush=True)
    if not all(counts[n] for n in ("flash_bwd_dkv", "flash_bwd_dq",
                                   "qmm_t_stacked", "qmm_t")):
        raise Failure(f"a backward kernel was not launched: {counts}")
    for n in ("qmm_stacked", "qmm_t_stacked"):
        if counts[f"{n}:wgmma"] != counts[n]:
            raise Failure(f"{n}: {counts[n]} launches, {counts[n + ':wgmma']} "
                          f"on wgmma")


STEPS = 28
# the random VAE weights decode a little past [-1, 1] and the decoder does
# not clamp; a decoder that blows up leaves these loose limits
MAX_SHARE_OUTSIDE_UNIT, MAX_ABS_OUT = 0.05, 10.0


def serve(torch, pipe):
    import numpy as np
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate

    stage_names = {"brain_encode": "brain_encode_s", "vae_encode":
                   "cond_vae_encode_s", "denoise": "denoise_s",
                   "vae_decode": "decode_s"}
    times = {}

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    requests = []
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        requests.append(dict(
            cond_image=(rng.random((512, 512, 3)) * 255).astype(np.uint8),
            eeg=rng.standard_normal((1, 4, 4096)).astype(np.float32),
            ppg=rng.standard_normal((1, 4, 256)).astype(np.float32),
            fnirs=rng.standard_normal((1, 6, 512)).astype(np.float32),
            motion=rng.standard_normal((1, 6, 128)).astype(np.float32),
            seed=seed))
    saved = {name: getattr(generate, name) for name in stage_names}
    served, card_samples, images, ms_steps = 0, [], [], []
    try:
        for name, key in stage_names.items():
            setattr(generate, name, timed(saved[name], key))
        with smi_samples(card_samples):
            cuda_build.LAUNCHES.clear()
            for req in requests:
                times.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = generate.neural_edit(
                    pipe, **req, num_inference_steps=STEPS, w8a8=True)
                dt = time.perf_counter() - t0
                images.append(img)
                ms_steps.append(times["denoise_s"] / STEPS * 1e3)
                finite = bool(np.isfinite(img).all())
                outside = float(np.mean(np.abs(img) > 1.0))
                peak = float(np.abs(img).max())
                print(f"  request seed {req['seed']}: edit {dt:.2f} s "
                      f"({1.0 / dt:.4f} edits/s), "
                      f"{times['denoise_s'] / STEPS * 1e3:.1f} ms/step x "
                      f"{STEPS}, stages " + ", ".join(
                          f"{k} {v:.3f}" for k, v in times.items())
                      + f", output [{img.min():.3f}, {img.max():.3f}] "
                      f"({outside:.2e} outside [-1, 1]) finite {finite} (PERF.md's"
                      f" reading on the mma.sync kernels: 244.8 ms/step on "
                      f"H100 80GB HBM3, 700 W)",
                      flush=True)
                if not (finite and img.shape == (1, 512, 512, 3)
                        and outside <= MAX_SHARE_OUTSIDE_UNIT
                        and peak <= MAX_ABS_OUT):
                    raise Failure(
                        f"request {req['seed']}: output of shape {img.shape},"
                        f" finite {finite}, {outside} outside [-1, 1] (limit "
                        f"{MAX_SHARE_OUTSIDE_UNIT}), max |x| {peak} (limit "
                        f"{MAX_ABS_OUT})")
                served += 1
        counts = dict(cuda_build.LAUNCHES)
        options = serve_options(torch, pipe, requests[0], images[0], times,
                                ms_steps[0])
    finally:
        for name, fn in saved.items():
            setattr(generate, name, fn)
    print(f"  launches over {served} requests: "
          f"{ {n: counts.get(n, 0) for n in KERNELS} }; GEMM launches (total, "
          f"wgmma, mma.sync, split-K, K 64) {gemm_split(counts)}; qmm_flat by route "
          f"{routes(counts, 'qmm_flat')}", flush=True)
    missing = [n for n in KERNELS if not counts.get(n)]
    if missing:
        raise Failure(f"kernels not launched while serving: {missing}")
    if card_samples:
        clocks = sorted(s[0] for s in card_samples)
        watts = sorted(s[1] for s in card_samples)
        print(f"  card while serving ({len(card_samples)} samples): SM clock "
              f"min {clocks[0]:.0f} MHz, median {clocks[len(clocks) // 2]:.0f}"
              f" MHz; power draw median {watts[len(watts) // 2]:.1f} W, max "
              f"{watts[-1]:.1f} W", flush=True)
    else:
        print("  card while serving: clocks and power not measured (no "
              "nvidia-smi samples)", flush=True)
    return counts, options, requests[0], images[0]


# brain embeds through the S4D recurrence kernel against the plain
# recurrence on the card: gross faults only, since the bf16 rounding of each
# S4D output and the DGF's top-k channel mask turn any reordering of a sum
# into flipped roundings and, near the threshold, swapped channels (the
# readings against the conv mode are printed beside it)
S4_EMBED_REL_L2 = 5e-2


def serve_options(torch, pipe, req, img_ref, times, ms_unfused):
    """The first request again through each serving option, fed the same
    signals, latents and noise (the same seed): ``s4_mode="pallas"``
    (launches of the S4D kernel, the brain embeds against the conv mode's
    and the plain recurrence's on the card), ``int8_attn=True`` (ms/step,
    the image against the bf16-score image) and ``fuse_ln`` + ``fuse_gate``
    (ms/step beside the first request's, ``ms_unfused``; launches of the
    fused forms).  Returns the launch counts of each option's request."""
    import numpy as np
    from loongx_tpu_torch.ops import cuda_build, s4_scan
    from loongx_tpu_torch.sampling import generate

    sig = {k: req[k] for k in ("eeg", "ppg", "fnirs", "motion")}
    embeds = {}
    cuda_build.LAUNCHES.clear()
    for mode in ("conv", "pallas"):
        embeds[mode] = generate.encode_brain_conditions(pipe, s4_mode=mode, **sig)
    encode_launches = cuda_build.LAUNCHES["s4d_scan"]
    chunked_launches = cuda_build.LAUNCHES["s4d_scan:chunked"]
    kernel = s4_scan.s4d_scan_recurrent
    s4_scan.s4d_scan_recurrent = s4_scan.s4d_scan_plain
    try:
        embeds["plain"] = generate.encode_brain_conditions(
            pipe, s4_mode="pallas", **sig)
    finally:
        s4_scan.s4d_scan_recurrent = kernel
    rels = {f"{a} vs {b}": [rel_l2(x, y) for x, y in zip(embeds[a], embeds[b])]
            for a, b in (("pallas", "conv"), ("plain", "conv"),
                         ("pallas", "plain"))}
    out, ms_step = {}, {}
    for label, option in (("s4_mode=pallas", dict(s4_mode="pallas")),
                          ("int8_attn", dict(int8_attn=True)),
                          ("fuse_ln+fuse_gate",
                           dict(fuse_ln=True, fuse_gate=True))):
        times.clear()
        cuda_build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = generate.neural_edit(pipe, **req, num_inference_steps=STEPS,
                                   w8a8=True, **option)
        dt = time.perf_counter() - t0
        out[label] = dict(cuda_build.LAUNCHES)
        ms_step[label] = times["denoise_s"] / STEPS * 1e3
        rel = float(np.linalg.norm(img - img_ref) / np.linalg.norm(img_ref))
        beside = {"int8_attn": f" (bf16 scores, the request before: "
                               f"{ms_step['s4_mode=pallas']:.1f})",
                  "fuse_ln+fuse_gate": f" (unfused, the first request: "
                                       f"{ms_unfused:.1f})"}.get(label, "")
        print(f"  request seed {req['seed']} {label}: edit {dt:.2f} s, "
              f"{ms_step[label]:.1f} ms/step x {STEPS}{beside}, "
              f"image rel L2 vs the first request {rel:.3e}, finite "
              f"{bool(np.isfinite(img).all())}, launches "
              + ", ".join(f"{k} {out[label].get(k, 0)}" for k in
                          ("s4d_scan", "flash_attention", "flash_attention_int8",
                           "flash_attention_int8:wgmma",
                           "flash_attention_int8:mma_sync", "flash_kquant")
                          + FUSED_KERNELS), flush=True)
        if not (np.isfinite(img).all() and img.shape == img_ref.shape):
            raise Failure(f"request {label}: output {img.shape} not finite")
    print(f"  brain embeds (prompt, pooled) rel L2: "
          + "; ".join(f"{k} {v[0]:.3e}, {v[1]:.3e}" for k, v in rels.items())
          + f" (bound {S4_EMBED_REL_L2:.0e} for pallas vs plain); S4D "
          f"launches per brain encode {encode_launches} ({chunked_launches} "
          f"on the chunked kernel)", flush=True)
    n_layers = 2 * len(s4d_cases())
    if not (encode_launches == chunked_launches == n_layers
            == out["s4_mode=pallas"]["s4d_scan"]
            == out["s4_mode=pallas"].get("s4d_scan:chunked")):
        raise Failure(f"S4D launches {encode_launches} per encode "
                      f"({chunked_launches} chunked), "
                      f"{out['s4_mode=pallas'].get('s4d_scan')} per request, "
                      f"not {n_layers} on the chunked kernel")
    if not max(rels["pallas vs plain"]) <= S4_EMBED_REL_L2:
        raise Failure(f"brain embeds through the S4D recurrence: {rels}")
    blocks = pipe.flux_cfg.num_double_blocks + pipe.flux_cfg.num_single_blocks
    int8 = out["int8_attn"]
    # every int8 forward on the s8 wgmma kernel, each after its pre-pass
    if not (int8.get("flash_attention_int8") == int8.get("flash_kquant")
            == int8.get("flash_attention_int8:wgmma") == STEPS * blocks
            and not int8.get("flash_attention")
            and not int8.get("flash_attention_int8:mma_sync")):
        raise Failure(f"int8_attn request launches {int8}")
    fused_launch_check(pipe.flux_cfg, out["fuse_ln+fuse_gate"], STEPS,
                       "fuse_ln+fuse_gate request")
    return out


class CharTokenizer:
    """A deterministic character tokenizer with the Hugging Face call
    interface the pipeline uses (no vocabulary files in the repository)."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        import numpy as np
        ids = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p[:max_length]):
                ids[i, j] = (ord(ch) * 31 + j) % self.vocab_size

        class Out:
            input_ids = ids

        return Out()


def serve_text(torch, pipe):
    """generate() with text prompts in fuse mode: random int8 T5-XXL and
    CLIP-L join the serving bundle, two requests at 512x512 and 28 steps
    (W8A8).  The encoders stay for phase "speech and demos"; returns their
    bytes."""
    import numpy as np
    from loongx_tpu_torch.models import pipeline as pipeline_mod
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate
    from loongx_tpu_torch.sampling.condition import Condition

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipe.add_text_encoders(seed=3, t5_tokenizer=CharTokenizer(32128),
                           clip_tokenizer=CharTokenizer(49408))
    torch.cuda.synchronize()
    text_bytes = torch.cuda.memory_allocated() - mem0
    print(f"  random int8 T5-XXL and CLIP-L made in "
          f"{time.perf_counter() - t0:.1f} s: {text_bytes / 1e9:.3f} GB",
          flush=True)

    times, stacked, on_wgmma = {}, [], []

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            before = (cuda_build.LAUNCHES["qmm_stacked"],
                      cuda_build.LAUNCHES["qmm_stacked:wgmma"])
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t
            if key == "text_encode_s":
                stacked.append(cuda_build.LAUNCHES["qmm_stacked"] - before[0])
                on_wgmma.append(cuda_build.LAUNCHES["qmm_stacked:wgmma"]
                                - before[1])
            return out
        return wrapper

    module_stages = [(generate, "encode_brain_conditions", "brain_encode_s"),
                     (generate, "denoise", "denoise_s"),
                     (generate, "vae_decode", "decode_s"),
                     (pipeline_mod, "clip_encode", "clip_s"),
                     (pipeline_mod, "t5_encode", "t5_s")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in module_stages]
    pipe.encode_text = timed(pipe.encode_text, "text_encode_s")
    pipe.encode_image_tokens = timed(pipe.encode_image_tokens, "vae_encode_s")
    try:
        for (mod, name, key), (_, _, fn) in zip(module_stages, saved):
            setattr(mod, name, timed(fn, key))
        for seed in (1, 2):
            rng = np.random.default_rng(10 + seed)
            img = (rng.random((512, 512, 3)) * 255).astype(np.uint8)
            cond = Condition(
                "eeg+fnirs", condition=img,
                eeg=rng.standard_normal((1, 4, 4096)).astype(np.float32),
                ppg=rng.standard_normal((1, 4, 256)).astype(np.float32),
                fnirs=rng.standard_normal((1, 6, 512)).astype(np.float32),
                motion=rng.standard_normal((1, 6, 128)).astype(np.float32))
            times.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = generate.generate(
                pipe, prompt="make the sky a deep evening blue",
                conditions=[cond], use_brain_condition=True, fuse_flag=True,
                fuse_mode="infer", height=512, width=512,
                num_inference_steps=STEPS, seed=seed, w8a8=True)
            dt = time.perf_counter() - t0
            finite = bool(np.isfinite(out).all())
            outside = float(np.mean(np.abs(out) > 1.0))
            peak = float(np.abs(out).max())
            print(f"  generate seed {seed}: {dt:.2f} s ({1.0 / dt:.4f} edits/s),"
                  f" {times['denoise_s'] / STEPS * 1e3:.1f} ms/step x {STEPS}, "
                  f"stages " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + f"; T5-XXL {times['t5_s'] * 1e3:.1f} ms; stacked-kernel "
                  f"launches in the text encode {stacked[-1]} ({on_wgmma[-1]} on "
                  f"wgmma); output {out.shape} [{out.min():.3f}, "
                  f"{out.max():.3f}] ({outside:.2e} outside [-1, 1]) finite "
                  f"{finite}", flush=True)
            if not (finite and out.shape == (1, 512, 512, 3)
                    and outside <= MAX_SHARE_OUTSIDE_UNIT and peak <= MAX_ABS_OUT):
                raise Failure(f"generate seed {seed}: output {out.shape}, finite "
                              f"{finite}, {outside} outside [-1, 1], max |x| {peak}")
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del pipe.encode_text, pipe.encode_image_tokens
    expected = 7 * pipe.t5_cfg.num_layers
    if stacked != [expected] * 2 or on_wgmma != stacked:
        raise Failure(f"stacked-kernel launches per prompt {stacked} ({on_wgmma} "
                      f"on wgmma), not {expected}")
    return text_bytes


def free_text_encoders(torch, pipe, text_bytes):
    """``free_text_encoders()`` after the text-prompt phases: the bytes it
    frees, at least 0.9 of what the encoders took."""
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    pipe.free_text_encoders()
    gc.collect()
    torch.cuda.synchronize()
    freed = mem1 - torch.cuda.memory_allocated()
    print(f"  free_text_encoders(): {freed / 1e9:.3f} GB freed (the encoders "
          f"took {text_bytes / 1e9:.3f} GB)", flush=True)
    if "t5" in pipe.params or freed < 0.9 * text_bytes:
        raise Failure(f"free_text_encoders freed {freed} of {text_bytes} bytes")


# ---------------------------------------------------------------------------
# Phase "speech and demos": audio -> Whisper -> Marian -> the edit, and the
# web demo, on the generate phase's bundle
# ---------------------------------------------------------------------------

# whisper-large's special tokens at their ids (50259-50357 are the
# languages, 50364 on the 1501 timestamps <|0.00|> .. <|30.00|>)
WHISPER_SPECIALS = {"<|endoftext|>": 50257, "<|startoftranscript|>": 50258,
                    "<|en|>": 50259, "<|zh|>": 50260, "<|translate|>": 50358,
                    "<|transcribe|>": 50359, "<|startoflm|>": 50360,
                    "<|startofprev|>": 50361, "<|nocaptions|>": 50362,
                    "<|notimestamps|>": 50363}
WHISPER_TIMESTAMPS = 50364
# generation_config.json's lists in the published layout: the task and
# prompt specials and a few punctuation ids everywhere, " " and eos at the
# first generated position
WHISPER_SUPPRESS = [1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59,
                    60, 61, 62, 63, 90, 91, 92, 93, 50258, 50358, 50359,
                    50360, 50361, 50362]
WHISPER_BEGIN_SUPPRESS = [220, 50257]
SPEECH_SECONDS, SPEECH_RATE = 5.0, 16000
# the cached decoder's logit rows against one teacher-forced pass over its
# own buffer, relative to the largest |logit|: bf16 activations, products
# of other shapes (one row against the whole buffer) summed in another
# order, so a bf16 rounding may flip and carry through the 32 layers; a
# wrong cache position or mask moves them by the logits' own size
DECODER_REL_TOL = 5e-2
# the encoder on the card against the CPU, float32 both with TF32 off
WHISPER_ENC_REL_TOL = 1e-4
WEB_STEPS = 8  # the web demo's default
# the two checkouts (3.1 GB + 0.15 GB) and the demo's files, with room
SPEECH_DISK = 6 << 30


def write_whisper_tokenizer(d):
    """A byte-level BPE vocabulary covering every id below 51865 (the 256
    bytes, then two-byte pieces up to 50256, then whisper-large's specials
    and timestamps at their ids) with no merges, as ``vocab.json`` +
    ``merges.txt``, the ``tokenizers`` package's ``tokenizer.json`` and a
    ``tokenizer_config.json``: loadable by transformers' WhisperTokenizer
    (the repository holds no real vocabulary)."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers

    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    n_plain = WHISPER_SPECIALS["<|endoftext|>"]
    for i in range(len(chars), n_plain):
        k = i - len(chars)
        vocab[chars[k // len(chars)] + chars[k % len(chars)]] = i
    specials = dict(WHISPER_SPECIALS)
    for i in range(50261, 50358):
        specials[f"<|lang{i}|>"] = i
    for k in range(51865 - WHISPER_TIMESTAMPS):
        specials[f"<|{k * 0.02:.2f}|>"] = WHISPER_TIMESTAMPS + k
    vocab.update(specials)
    if sorted(vocab.values()) != list(range(51865)):
        raise Failure("the synthesized Whisper vocabulary does not cover "
                      "ids 0-51864 once each")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = Tokenizer(models.BPE(vocab, []))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.add_special_tokens([AddedToken(s, special=True)
                            for s in sorted(specials, key=specials.get)])
    tok.save(os.path.join(d, "tokenizer.json"))
    eos = "<|endoftext|>"
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "WhisperTokenizer", "bos_token": eos,
                   "eos_token": eos, "unk_token": eos, "pad_token": eos,
                   "errors": "replace", "model_max_length": 1024}, f)


def _hf_attn(state, prefix, a):
    """q / k / v / o linears as BART-style ``{q,k,v,out}_proj``."""
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("o", "out_proj")):
        _hf_linear(state, f"{prefix}.{theirs}", a[ours])


def write_hf_whisper(torch, d, cfg, gen, device):
    """A random Whisper (the port's init on ``device``, bf16) as a Hugging
    Face WhisperForConditionalGeneration checkout: ``model.safetensors``
    under its names (the inverse of ``convert_whisper_state``: conv kernels
    HIO -> [out, in, w]), ``config.json``, ``generation_config.json`` with
    the suppress lists, and the tokenizer of `write_whisper_tokenizer`.
    Returns the weights' bytes."""
    from loongx_tpu_torch.models.text import whisper

    p = whisper.init_whisper_params(cfg, generator=gen, dtype=torch.bfloat16,
                                    device=device)
    state = {}
    for name in ("conv1", "conv2"):
        state[f"model.encoder.{name}.weight"] = p[name]["kernel"].permute(2, 1, 0)
        state[f"model.encoder.{name}.bias"] = p[name]["bias"]
    state["model.encoder.embed_positions.weight"] = p["enc_pos"]
    state["model.decoder.embed_tokens.weight"] = p["embed"]
    state["model.decoder.embed_positions.weight"] = p["dec_pos"]
    _hf_norm(state, "model.encoder.layer_norm", p["enc_ln"])
    _hf_norm(state, "model.decoder.layer_norm", p["dec_ln"])

    for side, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.decoder_layers)):
        blocks = p["enc_blocks" if side == "encoder" else "dec_blocks"]
        for i in range(n):
            blk = whisper._layer(blocks, i)
            pre = f"model.{side}.layers.{i}"
            if side == "encoder":
                _hf_norm(state, f"{pre}.self_attn_layer_norm", blk["ln_attn"])
                _hf_attn(state, f"{pre}.self_attn", blk["attn"])
            else:
                _hf_norm(state, f"{pre}.self_attn_layer_norm", blk["ln_self"])
                _hf_attn(state, f"{pre}.self_attn", blk["self_attn"])
                _hf_norm(state, f"{pre}.encoder_attn_layer_norm",
                         blk["ln_cross"])
                _hf_attn(state, f"{pre}.encoder_attn", blk["cross_attn"])
            _hf_norm(state, f"{pre}.final_layer_norm", blk["ln_ff"])
            _hf_linear(state, f"{pre}.fc1", blk["fc1"])
            _hf_linear(state, f"{pre}.fc2", blk["fc2"])
    eos = WHISPER_SPECIALS["<|endoftext|>"]
    config = {
        "model_type": "whisper",
        "architectures": ["WhisperForConditionalGeneration"],
        "vocab_size": cfg.vocab_size, "num_mel_bins": cfg.num_mel_bins,
        "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.d_ff, "decoder_ffn_dim": cfg.d_ff,
        "max_source_positions": cfg.max_source_positions,
        "max_target_positions": cfg.max_target_positions,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "bos_token_id": eos, "eos_token_id": cfg.eos_token_id,
        "pad_token_id": eos, "torch_dtype": "bfloat16"}
    written = _save_hf(d, state, config, generation_config={
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "eos_token_id": cfg.eos_token_id, "pad_token_id": eos,
        "suppress_tokens": WHISPER_SUPPRESS,
        "begin_suppress_tokens": WHISPER_BEGIN_SUPPRESS})
    write_whisper_tokenizer(d)
    return written


def write_hf_marian(torch, d, cfg, gen, device):
    """A random MarianMT (the port's init on ``device``, bf16, a random
    final-logits bias) as a Hugging Face MarianMTModel checkout
    (``model.safetensors`` + ``config.json``).  Returns the weights'
    bytes."""
    from loongx_tpu_torch.models.text import marian, whisper

    p = marian.init_marian_params(cfg, generator=gen, dtype=torch.bfloat16,
                                  device=device)
    state = {"model.shared.weight": p["embed"],
             "model.encoder.embed_positions.weight": p["pos"],
             "model.decoder.embed_positions.weight": p["pos"].clone(),
             "final_logits_bias": torch.randn(
                 1, cfg.vocab_size, generator=gen, device=device) * 0.1}

    for side, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.decoder_layers)):
        blocks = p["enc_blocks" if side == "encoder" else "dec_blocks"]
        for i in range(n):
            blk = whisper._layer(blocks, i)
            pre = f"model.{side}.layers.{i}"
            if side == "encoder":
                _hf_attn(state, f"{pre}.self_attn", blk["attn"])
                _hf_norm(state, f"{pre}.self_attn_layer_norm", blk["ln_attn"])
            else:
                _hf_attn(state, f"{pre}.self_attn", blk["self_attn"])
                _hf_norm(state, f"{pre}.self_attn_layer_norm", blk["ln_self"])
                _hf_attn(state, f"{pre}.encoder_attn", blk["cross_attn"])
                _hf_norm(state, f"{pre}.encoder_attn_layer_norm",
                         blk["ln_cross"])
            _hf_linear(state, f"{pre}.fc1", blk["fc1"])
            _hf_linear(state, f"{pre}.fc2", blk["fc2"])
            _hf_norm(state, f"{pre}.final_layer_norm", blk["ln_ff"])
    config = {
        "model_type": "marian", "architectures": ["MarianMTModel"],
        "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
        "encoder_layers": cfg.encoder_layers,
        "decoder_layers": cfg.decoder_layers,
        "encoder_attention_heads": cfg.num_heads,
        "decoder_attention_heads": cfg.num_heads,
        "encoder_ffn_dim": cfg.d_ff, "decoder_ffn_dim": cfg.d_ff,
        "max_position_embeddings": cfg.max_positions,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "pad_token_id": cfg.pad_token_id, "eos_token_id": cfg.eos_token_id,
        "activation_function": cfg.activation,
        "scale_embedding": cfg.scale_embedding}
    return _save_hf(d, state, config)


_WORDS = ("make", "the", "sky", "bluer", "turn", "cat", "into", "a", "dog",
          "remove", "person", "add", "hat", "brighten", "image", "change",
          "car", "to", "red")


class MarianTokShim:
    """MarianTokenizer's call and decode interface (MarianTokenizer itself
    needs sentencepiece model files): words hashed onto ids between eos and
    pad, eos appended, padding to a multiple; ids decoded onto a word
    list."""

    def __init__(self, cfg):
        self.pad, self.eos, self.vocab = (cfg.pad_token_id, cfg.eos_token_id,
                                          cfg.vocab_size)

    def __call__(self, texts, return_tensors="np", padding=True,
                 pad_to_multiple_of=16):
        import numpy as np
        lo, hi = self.eos + 1, min(self.pad, self.vocab)

        def word_id(w):
            h = 0
            for ch in w:
                h = (h * 31 + ord(ch)) % (hi - lo)
            return lo + h

        rows = [[word_id(w) for w in t.split()] + [self.eos] for t in texts]
        width = max(len(r) for r in rows)
        if pad_to_multiple_of:
            width = -(-width // pad_to_multiple_of) * pad_to_multiple_of
        ids = np.full((len(rows), width), self.pad, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)], mask[i, : len(r)] = r, 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(_WORDS[int(i) % len(_WORDS)] for i in ids
                        if int(i) not in (self.pad, self.eos))


def write_speech_inputs(root):
    """A 5 s, 16 kHz, 16-bit mono WAV (a tone and noise from seed 1) and a
    512x512 PNG (seed 31).  Returns (wav, png)."""
    import wave

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(1)
    t = np.arange(int(SPEECH_SECONDS * SPEECH_RATE)) / SPEECH_RATE
    x = 0.1 * np.sin(2 * np.pi * 220.0 * t) + 0.01 * rng.standard_normal(t.size)
    wav = os.path.join(root, "said.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SPEECH_RATE)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    png = os.path.join(root, "source.png")
    Image.fromarray((np.random.default_rng(31).random((512, 512, 3)) * 255)
                    .astype(np.uint8)).save(png)
    return wav, png


def _tree_devices(tree):
    from loongx_tpu_torch.ops.nn import tree_leaves
    return {t.device.type for t in tree_leaves(tree)}


def whisper_numbers(torch, asr, audio, device="cuda"):
    """Whisper-large on the card: the encoder's and the cross K/V's device
    ms (CUDA events), then one cached greedy decode run step by step through
    the port's own pieces (prefill ms, ms per generated token, host clock
    around synchronized work), its buffer against
    ``whisper_greedy_decode_cached``'s, and its logit rows against one
    teacher-forced ``whisper_decode_logits`` pass over that buffer (within
    DECODER_REL_TOL of the largest |logit|).  Returns the numbers."""
    from loongx_tpu_torch.models.text import whisper

    cfg, params = asr.cfg, asr.params
    feats = whisper.log_mel_spectrogram(
        torch.from_numpy(whisper.prepare_audio(audio, cfg)).to(device), cfg,
        asr.mel_filters)
    enc_ms = cuda_time_ms(lambda: whisper.whisper_encode(params, cfg, feats))
    enc = whisper.whisper_encode(params, cfg, feats)
    kv_ms = cuda_time_ms(lambda: whisper.whisper_cross_kv(params, cfg, enc))
    cross_k, cross_v = whisper.whisper_cross_kv(params, cfg, enc)
    prompt = torch.from_numpy(asr._prompt_ids("zh", "transcribe"))
    sup = whisper._vocab_ids(cfg, asr.suppress_tokens, device)
    begin = whisper._vocab_ids(cfg, asr.begin_suppress_tokens, device)
    buf = whisper._prompt_buffer(cfg, prompt, 64, device)
    p = prompt.shape[1]
    dh = cfg.d_model // cfg.num_heads
    self_k = torch.zeros((cfg.decoder_layers, 1, cfg.num_heads, buf.shape[1],
                          dh), dtype=params["embed"].dtype, device=device)
    self_v = torch.zeros_like(self_k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _, _ = whisper._cached_decoder_pass(params, cfg, buf[:, :p], 0,
                                                self_k, self_v, cross_k, cross_v)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    rows = [logits[:, -1]]
    done = torch.zeros(1, dtype=torch.bool, device=device)
    t0 = time.perf_counter()
    for pos in range(p, buf.shape[1]):
        nxt, done = whisper._pick(cfg, rows[-1], pos == p, done, sup, begin)
        buf[:, pos] = nxt
        if pos + 1 == buf.shape[1] or bool(done.all()):
            break
        logits, _, _ = whisper._cached_decoder_pass(
            params, cfg, nxt[:, None], pos, self_k, self_v, cross_k, cross_v)
        rows.append(logits[:, 0])
    torch.cuda.synchronize()
    steps = len(rows) - 1  # decoder passes after the prefill
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    served = whisper.whisper_greedy_decode_cached(
        params, cfg, feats, prompt, 64, asr.suppress_tokens,
        asr.begin_suppress_tokens)
    n = p + len(rows)  # positions the rows predict: p .. n-1
    # the last one-token pass again (it rewrites the same cache entries)
    profiles = {"encoder": device_profile(
        lambda: whisper.whisper_encode(params, cfg, feats)),
        "decoder pass": device_profile(lambda: whisper._cached_decoder_pass(
            params, cfg, buf[:, n - 2:n - 1], n - 2, self_k, self_v, cross_k,
            cross_v))}
    forced = whisper.whisper_decode_logits(params, cfg, enc, buf[:, : n - 1])
    got = torch.cat(rows).float()
    want = forced[0, p - 1:].float()
    err = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    new_tokens = int((buf[0, p:] != cfg.eos_token_id).sum())
    print(f"  Whisper-large (bf16): encoder {enc_ms:.2f} ms, cross K/V "
          f"{kv_ms:.2f} ms (CUDA events); cached decode: prefill of {p} tokens "
          f"{prefill_ms:.2f} ms, {steps} one-token passes at {step_ms:.2f} "
          f"ms each, {new_tokens} tokens before eos; its {len(rows)} logit "
          f"rows vs one teacher-forced pass over its buffer: max rel err "
          f"{err:.3g} (tol {DECODER_REL_TOL}), argmax agreement {agree:.3f}; "
          f"buffer equal to whisper_greedy_decode_cached's "
          f"{bool(torch.equal(served, buf))}", flush=True)
    for name, prof in profiles.items():
        print(f"  Whisper {name} device profile: " + (
            "not measured (no device activity seen)" if prof is None else
            f"{prof['kernels']} kernels, busy {prof['busy_ms']:.2f} ms of "
            f"{prof['span_ms']:.2f} (idle {prof['idle_share']:.3f}); largest "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        list(prof["top_other_ms"].items())[:3])), flush=True)
    if not torch.equal(served, buf):
        raise Failure("the step-by-step cached decode's buffer differs from "
                      "whisper_greedy_decode_cached's")
    if not err <= DECODER_REL_TOL:
        raise Failure(f"cached decoder logits vs teacher-forced: rel err {err}")
    return {"encoder_ms": enc_ms, "cross_kv_ms": kv_ms,
            "prefill_ms": prefill_ms, "ms_per_token": step_ms,
            "profiles": profiles,
            "decoder_rel_err": err, "argmax_agreement": agree,
            "new_tokens": new_tokens}


def whisper_encoder_cpu(torch, cfg, audio, device="cuda"):
    """The encoder at full width with 2 + 2 layers, float32, on the card
    against the CPU (the same random params and features): max |diff| over
    max |CPU|, within WHISPER_ENC_REL_TOL."""
    from loongx_tpu_torch.models.text import whisper
    from loongx_tpu_torch.utils.bridge import from_numpy_tree

    cfg2 = dataclasses.replace(cfg, encoder_layers=2, decoder_layers=2)
    cpu = whisper.init_whisper_params(
        cfg2, generator=torch.Generator().manual_seed(5), device="cpu")
    gpu = from_numpy_tree(cpu, device)
    filters = torch.from_numpy(whisper.mel_filter_bank(
        cfg.n_fft // 2 + 1, cfg.num_mel_bins, cfg.sampling_rate,
        cfg.sampling_rate / 2.0))
    feats = whisper.log_mel_spectrogram(
        torch.from_numpy(whisper.prepare_audio(audio, cfg)), cfg2, filters)
    want = whisper.whisper_encode(cpu, cfg2, feats)
    got = whisper.whisper_encode(gpu, cfg2, feats.to(device)).cpu()
    err = float((got - want).abs().max() / want.abs().max())
    print(f"  Whisper encoder (d {cfg.d_model}, 1500 positions, 2 layers, "
          f"float32) on the card vs the CPU: max rel err {err:.3g} (tol "
          f"{WHISPER_ENC_REL_TOL})", flush=True)
    if got.shape != want.shape or not err <= WHISPER_ENC_REL_TOL:
        raise Failure(f"the Whisper encoder on the card differs from the "
                      f"CPU's: {tuple(got.shape)}, rel err {err}")
    return err



def _timed(torch, fn, seconds):
    """``fn`` wrapped to append its seconds (host clock around synchronized
    work) to ``seconds``."""
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out
    return wrapper


def speech_and_demos(torch, pipe, device="cuda"):
    """The speech demo and the web demo on the generate phase's bundle
    (int8 FLUX.1-dev, int8 T5-XXL, CLIP-L, the character tokenizers), in a
    directory in the checkout that is removed at the end (`_speech_and_demos`
    says what runs).  Returns the launches of the speech edit and of the
    web demo's edit."""
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    free = shutil.disk_usage(here).free
    print(f"  disk at {here}: {free / 1e9:.1f} GB free, the speech checkouts "
          f"need about {SPEECH_DISK / 1e9:.1f} GB", flush=True)
    if free < SPEECH_DISK:
        raise Failure(f"{free} bytes free at {here}, {SPEECH_DISK} needed for "
                      "the speech checkouts")
    root = tempfile.mkdtemp(prefix=".chip_smoke_speech_", dir=here)
    try:
        return _speech_and_demos(torch, pipe, root, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _speech_and_demos(torch, pipe, root, device="cuda"):
    """Random Whisper-large and opus-mt-zh-en checkouts written to ``root``;
    ``WhisperASR.from_pretrained`` loads the first (transformers'
    WhisperTokenizer on the synthesized files), ``load_torch_or_safetensors_dir``
    + ``convert_marian_state`` the second into a ``MarianTranslator`` with
    `MarianTokShim`; every tensor of both on the card; `whisper_numbers`,
    `whisper_encoder_cpu`, peak memory.  Then ``cli.speech_demo.main``
    with LOONGX_W8A8=1 on a 5 s WAV
    and a 512x512 PNG (28 steps, no ``--prompt``, no brain data) through a
    transcriber that calls ``speech_demo.transcribe`` on the two local
    checkouts (the ``whisper`` package unimportable, the loaders handing
    over the models loaded here): the transcript a str, the ASR and the
    translator each called once, the PNG 512x512 and equal bit for bit to
    ``edit_one`` called directly, every flash forward and GEMM on its Hopper
    route, T5-XXL's stacked launches a prompt printed, its transcription
    and translation timed (host clock) and Marian's tokens counted.  Then
    the web demo:
    ``build_server`` in a thread around ``process_image_and_text(pipe, img,
    text, num_steps=8, size=512, w8a8=True)``; /health and / answer 200;
    /edit with a 640x480 PNG and the transcript gives a 512x512 PNG equal
    bit for bit to the direct call, with the same launch rules; a malformed
    body gets 400."""
    import numpy as np
    from PIL import Image
    from loongx_tpu_torch.cli import infer, speech_demo
    from loongx_tpu_torch.models.text import marian, whisper
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate
    from loongx_tpu_torch.utils import convert
    import transformers

    gen = torch.Generator(device=device).manual_seed(41)
    wcfg, mcfg = whisper.WhisperConfig.large(), marian.MarianConfig.opus_mt()
    wdir = os.path.join(root, "whisper-large")
    mdir = os.path.join(root, "opus-mt-zh-en")
    t0 = time.perf_counter()
    wbytes = write_hf_whisper(torch, wdir, wcfg, gen, device)
    mbytes = write_hf_marian(torch, mdir, mcfg, gen, device)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  random Whisper-large ({wbytes / 1e9:.3f} GB) and opus-mt-zh-en "
          f"({mbytes / 1e9:.3f} GB) written as Hugging Face checkouts in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    wav, png = write_speech_inputs(root)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    asr = whisper.WhisperASR.from_pretrained(wdir, device=device)
    torch.cuda.synchronize()
    t_asr = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.path.join(mdir, "config.json")) as f:
        mcfg_read = marian.MarianConfig.from_hf(json.load(f))
    translator = marian.MarianTranslator(
        convert.convert_marian_state(convert.load_torch_or_safetensors_dir(mdir),
                                     mcfg_read, device=device),
        mcfg_read, MarianTokShim(mcfg_read))
    torch.cuda.synchronize()
    t_mt = time.perf_counter() - t0
    prompt_ids = asr._prompt_ids("zh", "transcribe").tolist()
    want_prompt = [[WHISPER_SPECIALS[t] for t in (
        "<|startoftranscript|>", "<|zh|>", "<|transcribe|>", "<|notimestamps|>")]]
    devices = (_tree_devices(asr.params) | _tree_devices(translator.params)
               | {asr.mel_filters.device.type})
    speech_bytes = torch.cuda.memory_allocated() - mem0
    print(f"  WhisperASR.from_pretrained {t_asr:.2f} s (tokenizer "
          f"{type(asr.tokenizer).__name__}, transformers "
          f"{transformers.__version__}; prompt ids {prompt_ids}; "
          f"{len(asr.suppress_tokens)} suppress ids, begin "
          f"{asr.begin_suppress_tokens}); Marian loaded in {t_mt:.2f} s "
          f"(tokenizer {type(translator.tokenizer).__name__}); on the card "
          f"{speech_bytes / 1e9:.3f} GB; tensors on {sorted(devices)}",
          flush=True)
    if (asr.cfg != wcfg or mcfg_read != mcfg or prompt_ids != want_prompt
            or asr.suppress_tokens != WHISPER_SUPPRESS
            or asr.begin_suppress_tokens != WHISPER_BEGIN_SUPPRESS):
        raise Failure(f"the checkouts read back as {asr.cfg}, {mcfg_read}, "
                      f"prompt ids {prompt_ids}")
    if devices != {torch.device(device).type}:
        raise Failure(f"speech model tensors on {sorted(devices)}, not only "
                      "the card")

    audio = speech_demo._read_audio(wav)
    numbers = whisper_numbers(torch, asr, audio, device)
    whisper_encoder_cpu(torch, wcfg, audio, device)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak memory with both speech models loaded and decoding: "
          f"{peak / 1e9:.3f} GB ({mem0 / 1e9:.3f} GB before they were "
          "loaded)", flush=True)

    blocks = pipe.flux_cfg.num_double_blocks + pipe.flux_cfg.num_single_blocks
    calls = {"asr": 0, "mt": 0}
    took, texts, decoded = {}, {}, []
    asr_transcribe, mt_translate = asr.transcribe, translator.translate
    greedy = marian.marian_greedy_decode

    def counted(key, fn):
        def wrapper(*a, **k):  # host clock around synchronized work
            calls[key] += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            texts[key] = fn(*a, **k)
            torch.cuda.synchronize()
            took[key] = (time.perf_counter() - t) * 1e3
            return texts[key]
        return wrapper

    def kept_greedy(*a, **k):
        decoded.append(greedy(*a, **k))
        return decoded[-1]

    def transcriber(path):
        return speech_demo.transcribe(path, wdir, mdir, "zh", device=device)

    denoise_s, stacked = [], []
    loaders = (whisper.WhisperASR.from_pretrained,
               marian.MarianTranslator.from_pretrained)
    denoise, encode_text = generate.denoise, pipe.encode_text

    def counted_encode(*a, **k):
        before = cuda_build.LAUNCHES["qmm_stacked:wgmma"]
        out = encode_text(*a, **k)
        stacked.append(cuda_build.LAUNCHES["qmm_stacked:wgmma"] - before)
        return out

    out = os.path.join(root, "edited.png")
    knobs = {"w8a8": True, "int8_attn": False, "fuse_ln": False,
             "fuse_gate": False}
    saved_whisper = sys.modules.get("whisper")
    try:
        asr.transcribe = counted("asr", asr_transcribe)
        translator.translate = counted("mt", mt_translate)
        whisper.WhisperASR.from_pretrained = staticmethod(lambda path, **k: asr)
        marian.MarianTranslator.from_pretrained = staticmethod(
            lambda path, **k: translator)
        sys.modules["whisper"] = None  # the package is unimportable
        marian.marian_greedy_decode = kept_greedy
        generate.denoise = _timed(torch, denoise, denoise_s)
        pipe.encode_text = counted_encode
        with _env(LOONGX_W8A8="1"):
            cuda_build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            transcript = speech_demo.main(
                ["--audio", wav, "--image", png, "--output", out, "--steps",
                 str(STEPS), "--target_size", "512", "--whisper_path", wdir,
                 "--translate_path", mdir, "--device", device], pipeline=pipe,
                transcriber=transcriber)
            edit_s = time.perf_counter() - t0
            speech_counts = dict(cuda_build.LAUNCHES)
        direct = infer.edit_one(pipe, png, transcript, target_size=512,
                                num_steps=STEPS, knobs=knobs)
    finally:
        del asr.transcribe, translator.translate, pipe.encode_text
        (whisper.WhisperASR.from_pretrained,
         marian.MarianTranslator.from_pretrained) = loaders
        generate.denoise = denoise
        marian.marian_greedy_decode = greedy
        if saved_whisper is None:
            sys.modules.pop("whisper", None)
        else:
            sys.modules["whisper"] = saved_whisper
    out_ids = decoded[0][0, 1:].tolist()
    n_mt = (out_ids.index(mcfg.eos_token_id) + 1
            if mcfg.eos_token_id in out_ids else len(out_ids))
    print(f"  transcribe {took['asr']:.1f} ms for {SPEECH_SECONDS:.0f} s of "
          f"audio ({numbers['new_tokens']} tokens); Marian translate "
          f"{took['mt']:.1f} ms, {n_mt} tokens ({took['mt'] / max(n_mt, 1):.2f}"
          f" ms a token, the KV-free decoder), in the speech demo's call; "
          f"transcript {texts['asr']!r} -> {texts['mt']!r}", flush=True)
    got = np.asarray(Image.open(out))
    diff = (np.abs(got.astype(np.int32) - direct.astype(np.int32))
            if got.shape == direct.shape else None)
    print(f"  speech edit: cli.speech_demo.main {edit_s:.2f} s end to end "
          f"(transcription included), {denoise_s[0] / STEPS * 1e3:.1f} ms/step x "
          f"{STEPS}; instruction {transcript!r}; ASR / translator calls "
          f"{calls}; T5-XXL stacked launches a prompt {stacked} (all on "
          f"wgmma); output {got.shape}, vs edit_one called directly: "
          + (f"{int((diff > 0).sum())} values differ" if diff is not None
             else "other shape"), flush=True)
    if (not isinstance(transcript, str) or calls != {"asr": 1, "mt": 1}
            or transcript != texts["mt"]):
        raise Failure(f"the speech demo's instruction {transcript!r} did not "
                      f"come from the port's ASR and translator ({calls})")
    if got.shape != (512, 512, 3) or diff is None or diff.any():
        raise Failure(f"the speech edit ({got.shape}) differs from edit_one's")
    if stacked != [7 * pipe.t5_cfg.num_layers] * 2:
        raise Failure(f"T5-XXL stacked launches on wgmma a prompt {stacked}, "
                      f"not {7 * pipe.t5_cfg.num_layers}")
    _cli_launch_check(speech_counts, blocks, "speech edit")

    web_counts, web = _web_demo(torch, pipe, transcript, blocks, knobs)
    numbers.update(transcribe_ms=took["asr"], translate_ms=took["mt"],
                   marian_tokens=n_mt, peak_bytes=peak)
    return {"speech edit": speech_counts, "web demo": web_counts,
            "whisper": numbers, "web": web}


def _web_demo(torch, pipe, text, blocks, knobs):
    """The web demo's server in a thread, its requests over HTTP (see
    `_speech_and_demos`).  Returns its edit's launches and timings."""
    import base64
    import io
    import urllib.error
    import urllib.request

    import numpy as np
    from PIL import Image
    from loongx_tpu_torch.cli import gradio_app, web_demo
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate

    def editor(image, prompt):
        return gradio_app.process_image_and_text(
            pipe, image, prompt, num_steps=WEB_STEPS, size=512, **knobs)

    img = Image.fromarray((np.random.default_rng(32).random((480, 640, 3))
                           * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    body = json.dumps({"image_b64": base64.b64encode(buf.getvalue()).decode(),
                       "text": text}).encode()

    def post(url, data):
        return urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"})

    denoise, denoise_s = generate.denoise, []
    server = web_demo.build_server(editor, port=0, num_steps=WEB_STEPS)
    thread = web_demo.serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        generate.denoise = _timed(torch, denoise, denoise_s)
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = (r.status, json.load(r))
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = (r.status, len(r.read()))
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with urllib.request.urlopen(post(base + "/edit", body),
                                    timeout=600) as r:
            status, resp = r.status, json.load(r)
        request_s = time.perf_counter() - t0
        counts = dict(cuda_build.LAUNCHES)
        try:
            urllib.request.urlopen(post(base + "/edit", b"{}"), timeout=60)
            bad = 200
        except urllib.error.HTTPError as exc:
            bad = exc.code
        direct = np.asarray(editor(img, text))
    finally:
        generate.denoise = denoise
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    got = np.asarray(Image.open(io.BytesIO(base64.b64decode(
        resp["image_b64"]))))
    same = got.shape == direct.shape and bool((got == direct).all())
    ms_step = denoise_s[0] / WEB_STEPS * 1e3
    print(f"  web demo: GET /health {health}, GET / {page[0]} ({page[1]} "
          f"bytes); POST /edit (640x480 PNG) {status} in {request_s:.2f} s, "
          f"elapsed_s {resp['elapsed_s']:.3f}, {ms_step:.1f} ms/step x "
          f"{WEB_STEPS}; output {got.shape}, equal to process_image_and_text "
          f"called directly {same}; malformed body {bad}", flush=True)
    if (health != (200, {"status": "ok"}) or page[0] != 200 or status != 200
            or bad != 400):
        raise Failure(f"web demo: health {health}, page {page[0]}, edit "
                      f"{status}, malformed body {bad}")
    if got.shape != (512, 512, 3) or not same:
        raise Failure(f"the web demo's edit ({got.shape}) differs from the "
                      "direct call's")
    _cli_launch_check(counts, blocks, "web demo edit", steps=WEB_STEPS)
    return counts, {"elapsed_s": resp["elapsed_s"], "ms_per_step": ms_step}


# ---------------------------------------------------------------------------
# Phase "infer CLI": the served edit from a checkpoint on disk
# ---------------------------------------------------------------------------

# disk the checkpoint may take beyond the bundle's own bytes (config, the
# PNGs and their edits)
# beside the checkpoint: the CLI's images, and the random Depth-Anything-
# Small, CLIP ViT-B/32 (twice: the checkout and its bundle) and DINO
# ViT-S/16 of phase "evaluate and depth" (about 1.4 GB)
CLI_DISK_MARGIN = 3 << 30


@contextlib.contextmanager
def _env(**values):
    """Environment variables set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def cli_workdir(pipe):
    """A fresh directory in the checkout for the checkpoint, after checking
    that its disk holds the serving bundle."""
    import tempfile
    from loongx_tpu_torch.ops.quant import quantized_bytes

    here = os.path.dirname(os.path.abspath(__file__))
    need = quantized_bytes(pipe.params) + CLI_DISK_MARGIN
    free = shutil.disk_usage(here).free
    print(f"  disk at {here}: {free / 1e9:.1f} GB free, the checkpoint needs "
          f"{need / 1e9:.1f} GB", flush=True)
    if free < need:
        raise Failure(f"{free} bytes free at {here}, {need} needed for the "
                      "serving checkpoint")
    return tempfile.mkdtemp(prefix=".chip_smoke_cli_", dir=here)


def write_cli_inputs(torch, pipe, req, root):
    """Phase 4's serving bundle saved with the port's ``save_pipeline``
    (full-width FLUX.1-dev, int8 serving layout, VAE, CS3, DGF), phase 4's
    first request image as a PNG with its four signals in a pickle under
    the file's name, and two more 512x512 requests beside it for the
    directory mode.  Returns the paths."""
    import pickle
    import resource

    import numpy as np
    from PIL import Image
    from loongx_tpu_torch.utils import checkpoint

    ckpt = os.path.join(root, "ckpt")
    torch.cuda.synchronize()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    checkpoint.save_pipeline(pipe, ckpt)
    dt = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    files = checkpoint.component_files(ckpt)
    written = sum(os.path.getsize(f) for f in files.values())
    print(f"  save_pipeline: {written} bytes ({written / 1e9:.3f} GB; "
          + ", ".join(f"{k} {os.path.getsize(f) / 1e9:.3f}"
                      for k, f in sorted(files.items()))
          + f") in {dt:.1f} s ({written / dt / 1e9:.2f} GB/s); host peak "
          f"resident memory {rss0 / 1e9:.2f} GB before, {rss1 / 1e9:.2f} GB "
          "after", flush=True)
    in_dir = os.path.join(root, "in")
    os.makedirs(in_dir)
    signals = {"EEG": "eeg", "PPG": "ppg", "FNIRS": "fnirs", "Motion": "motion"}
    brain = {"req1.png": {k: req[v] for k, v in signals.items()}}
    Image.fromarray(req["cond_image"]).save(os.path.join(in_dir, "req1.png"))
    for seed in (3, 4):  # sorted after req1: the groups are [req1, req2], [req3]
        rng = np.random.default_rng(seed)
        name = f"req{seed - 1}.png"
        Image.fromarray((rng.random(req["cond_image"].shape) * 255).astype(
            np.uint8)).save(os.path.join(in_dir, name))
        brain[name] = {k: rng.standard_normal(req[v].shape).astype(np.float32)
                       for k, v in signals.items()}
    pkl = os.path.join(root, "brain.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(brain, f)
    return {"ckpt": ckpt, "in_dir": in_dir, "image": os.path.join(
        in_dir, "req1.png"), "pkl": pkl, "root": root, "bytes": written}


def _cli_launch_check(counts, blocks, what, steps=STEPS):
    """Every flash forward on wgmma (one a block a step, each after its
    RoPE pre-pass), every GEMM on wgmma, split-K or K 64, none on
    mma.sync, every serving kernel launched."""
    split = gemm_split(counts)
    flash = steps * blocks
    print(f"  {what} launches: { {n: counts.get(n, 0) for n in KERNELS} }; "
          f"GEMM launches (total, wgmma, mma.sync, split-K, K 64) {split}; "
          f"qmm_flat by route {routes(counts, 'qmm_flat')}", flush=True)
    missing = [n for n in KERNELS if not counts.get(n)]
    on_mma_sync = {e: v[2] for e, v in split.items() if v[2]}
    if (missing or on_mma_sync or counts.get("flash_attention:mma_sync")
            or not counts.get("flash_attention") == counts.get(
                "flash_attention:wgmma") == counts.get("flash_rope") == flash):
        raise Failure(f"{what}: kernels not launched {missing}, GEMMs on "
                      f"mma.sync {on_mma_sync}, flash {counts.get('flash_attention')}"
                      f" ({counts.get('flash_attention:wgmma')} wgmma, "
                      f"{counts.get('flash_rope')} pre-passes; {flash} expected)")


def cli_args(paths, size, device="cuda"):
    """The infer CLI's arguments for phase 4's requests: the checkpoint,
    the brain data, seed 1, int8, the replace mode's condition, STEPS."""
    return ["--checkpoint", paths["ckpt"], "--brain_data_path", paths["pkl"],
            "--seed", "1", "--int8", "--condition_type", "eeg+fnirs",
            "--position_delta_y", "0", "--steps", str(STEPS),
            "--target_size", str(size), "--device", device]


def infer_cli(torch, paths, img_ref, device="cuda"):
    """``cli.infer.main`` in this process with LOONGX_W8A8=1: one
    ``--single_image`` edit of phase 4's first request (its PNG must equal
    phase 4's uint8 image bit for bit), then the directory mode over the
    three requests at ``--batch_size 2`` (groups of 2 and 1; each output
    finite and of the request's size, the first within 1 of the single
    edit).  Prints the
    load times, ``--timing``'s p50, the single edit's ms/step and the
    launches of the single edit and of each group."""
    import io

    import numpy as np
    from PIL import Image
    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate

    def read_png(path):
        return np.asarray(Image.open(path))

    loads, denoise_s, finite, groups, pipes = [], [], [], [], []
    load = LoongXPipeline.from_pretrained
    denoise, decode, gen_fn = generate.denoise, generate.vae_decode, generate.generate

    def timed_load(path, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = load(path, **kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        pipes.append(pipe)
        return pipe

    def timed_denoise(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise(*a, **k)
        torch.cuda.synchronize()
        denoise_s.append(time.perf_counter() - t0)
        return out

    def checked_decode(*a, **k):
        out = decode(*a, **k)
        finite.append(bool(torch.isfinite(out).all()))
        return out

    def counted_generate(*a, **k):
        cuda_build.LAUNCHES.clear()
        out = gen_fn(*a, **k)
        groups.append((len(out), dict(cuda_build.LAUNCHES)))
        return out

    size = img_ref.shape[1]
    common = cli_args(paths, size, device)
    single_dir = os.path.join(paths["root"], "out_single")
    batch_dir = os.path.join(paths["root"], "out_batch")
    log = io.StringIO()
    try:
        LoongXPipeline.from_pretrained = staticmethod(timed_load)
        generate.denoise, generate.vae_decode = timed_denoise, checked_decode
        with _env(LOONGX_W8A8="1"):
            cuda_build.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer.main(common + ["--single_image", paths["image"], "--prompt",
                                 "", "--output_dir", single_dir])
            single_s = time.perf_counter() - t0
            single_counts = dict(cuda_build.LAUNCHES)
            blocks = pipes[-1].flux_cfg.num_double_blocks + (
                pipes[-1].flux_cfg.num_single_blocks)
            pipes.clear()
            generate.generate = counted_generate
            with contextlib.redirect_stdout(log):
                infer.main(common + ["--input_dir", paths["in_dir"],
                                     "--output_dir", batch_dir, "--batch_size",
                                     "2", "--timing"])
    finally:
        LoongXPipeline.from_pretrained = load
        generate.denoise, generate.vae_decode = denoise, decode
        generate.generate = gen_fn
        pipes.clear()
        gc.collect()
        torch.cuda.empty_cache()
    print("\n".join(f"  | {line}" for line in log.getvalue().splitlines()),
          flush=True)
    p50 = [line for line in log.getvalue().splitlines() if "p50" in line]
    print(f"  checkpoint loads {', '.join(f'{t:.2f}' for t in loads)} s "
          f"({paths['bytes'] / loads[0] / 1e9:.2f} GB/s the first); single "
          f"edit {single_s:.2f} s end to end, {denoise_s[0] / STEPS * 1e3:.1f} "
          f"ms/step x {STEPS}; directory mode {p50[0] if p50 else 'no p50'}",
          flush=True)

    ref = ((np.clip(img_ref[0], -1, 1) + 1) * 127.5).round().astype(np.uint8)
    single = read_png(os.path.join(single_dir, "req1.png"))
    diff = np.abs(single.astype(np.int32) - ref.astype(np.int32))
    print(f"  single edit vs phase 4's first request: {int((diff > 0).sum())} "
          f"of {diff.size} values differ, max {int(diff.max())}", flush=True)
    if single.shape != ref.shape or diff.any():
        raise Failure(f"the CLI's single edit differs from phase 4's first "
                      f"request in {int((diff > 0).sum())} values (max "
                      f"{int(diff.max())})")
    _cli_launch_check(single_counts, blocks, "single edit")
    names = sorted(os.listdir(batch_dir))
    if [n for n, _ in groups] != [2, 1] or names != sorted(
            os.listdir(paths["in_dir"])):
        raise Failure(f"directory mode: groups {[n for n, _ in groups]}, "
                      f"outputs {names}")
    for i, (n, counts) in enumerate(groups):
        _cli_launch_check(counts, blocks, f"group {i + 1} ({n} images)")
    for name in names:
        out = read_png(os.path.join(batch_dir, name))
        if out.shape != (size, size, 3):
            raise Failure(f"directory mode: {name} of shape {out.shape}")
    if not all(finite):
        raise Failure(f"non-finite decodes: {finite}")
    first = read_png(os.path.join(batch_dir, "req1.png")).astype(np.int32)
    bdiff = np.abs(first - single.astype(np.int32))
    print(f"  directory mode (batch 2) vs the single edit: max {int(bdiff.max())}"
          f", {int((bdiff > 0).sum())} values differ; decodes finite "
          f"{finite}", flush=True)
    if bdiff.max() > 1:
        raise Failure(f"directory mode's req1 differs from the single edit by "
                      f"{int(bdiff.max())} (limit 1)")


# ---------------------------------------------------------------------------
# Phase "evaluate and depth": Depth-Anything behind the depth condition, the
# evaluation towers and the parity runbook
# ---------------------------------------------------------------------------

# predicted_depth on the card against the CPU, relative to max|CPU|: float32
# on both with TF32 off, so only the order of the sums differs
DEPTH_REL_TOL = 1e-4
# the min-max uint8 depth image against the CPU's: share of values that may
# differ (a value at a rounding boundary flips)
DEPTH_U8_SHARE = 0.01
# CLIP image / text and DINO CLS features on the card against the CPU,
# relative to max|CPU| (float32, TF32 off)
FEATURE_REL_TOL = 1e-4
# CLIP-I and DINO-I of identical pairs
IDENTITY_TOL = 1e-5
# Hugging Face module names of a pre-LN block's (ln1, q, k, v, o, ln2, fc1,
# fc2), the order of `_hf_block`
CLIP_BLOCK = ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj",
              "self_attn.v_proj", "self_attn.out_proj", "layer_norm2",
              "mlp.fc1", "mlp.fc2")
VIT_BLOCK = ("layernorm_before", "attention.attention.query",
             "attention.attention.key", "attention.attention.value",
             "attention.output.dense", "layernorm_after",
             "intermediate.dense", "output.dense")
DINOV2_BLOCK = ("norm1", "attention.attention.query", "attention.attention.key",
                "attention.attention.value", "attention.output.dense", "norm2",
                "mlp.fc1", "mlp.fc2")


def _hf_linear(state, prefix, p):
    state[f"{prefix}.weight"] = p["kernel"].T
    if "bias" in p:
        state[f"{prefix}.bias"] = p["bias"]


def _hf_norm(state, prefix, p):
    state[f"{prefix}.weight"], state[f"{prefix}.bias"] = p["weight"], p["bias"]


def _hf_conv(state, prefix, p):
    """An HWIO kernel as torch's OIHW."""
    state[f"{prefix}.weight"] = p["kernel"].permute(3, 2, 0, 1)
    if "bias" in p:
        state[f"{prefix}.bias"] = p["bias"]


def _hf_block(state, prefix, blk, names):
    for ours, theirs in zip(("ln1", "q", "k", "v", "o", "ln2", "fc1", "fc2"),
                            names):
        put = _hf_norm if ours.startswith("ln") else _hf_linear
        put(state, f"{prefix}.{theirs}", blk[ours])


def _hf_stacked_blocks(state, prefix, blocks, names):
    for i in range(blocks["ln1"]["weight"].shape[0]):
        _hf_block(state, f"{prefix}.{i}", {
            n: {k: v[i] for k, v in leaf.items()}
            for n, leaf in blocks.items()}, names)


def _hf_patch_conv(kernel, patch):
    """The flattened (y, x, c)-patch linear [p*p*3, H] as the conv
    [H, 3, p, p]."""
    return kernel.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1)


def _save_hf(d, state, config, **extra):
    """``model.safetensors`` + ``config.json`` (+ one JSON file per keyword,
    its name with ``.json``) in ``d``; returns the weights' bytes."""
    from safetensors.torch import save_file

    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "model.safetensors")
    save_file({k: v.detach().to("cpu").contiguous() for k, v in state.items()},
              path, metadata={"format": "pt"})
    for name, obj in (("config", config), *extra.items()):
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(obj, f, indent=1)
    return os.path.getsize(path)


def write_hf_clip(torch, d, text_cfg, vision_cfg, gen, device):
    """A random CLIP checkpoint (the port's inits on ``device``) in
    transformers' CLIPModel layout, with the byte-level vocabulary of
    `write_clip_tokenizer` (the config's end token is its own).  Returns the
    port's (text tree with its text_projection, vision tree)."""
    from loongx_tpu_torch.models.text.clip import init_clip_params
    from loongx_tpu_torch.models.text.clip_vision import init_clip_vision_params
    from loongx_tpu_torch.ops.nn import init_linear

    eos = write_clip_tokenizer(d)
    kw = dict(generator=gen, dtype=torch.float32, device=device)
    text = init_clip_params(text_cfg, **kw)
    text["text_projection"] = init_linear(
        text_cfg.hidden, vision_cfg.projection_dim, bias=False, **kw)
    vision = init_clip_vision_params(vision_cfg, **kw)
    state = {
        "text_model.embeddings.token_embedding.weight": text["token_embed"],
        "text_model.embeddings.position_embedding.weight": text["pos_embed"],
        "vision_model.embeddings.class_embedding": vision["class_embed"],
        "vision_model.embeddings.patch_embedding.weight": _hf_patch_conv(
            vision["patch_embed"]["kernel"], vision_cfg.patch_size),
        "vision_model.embeddings.position_embedding.weight":
            vision["pos_embed"],
        "logit_scale": torch.tensor(2.6592),
    }
    _hf_stacked_blocks(state, "text_model.encoder.layers", text["blocks"],
                       CLIP_BLOCK)
    _hf_norm(state, "text_model.final_layer_norm", text["final_ln"])
    _hf_linear(state, "text_projection", text["text_projection"])
    _hf_norm(state, "vision_model.pre_layrnorm", vision["pre_ln"])
    _hf_stacked_blocks(state, "vision_model.encoder.layers", vision["blocks"],
                       CLIP_BLOCK)
    _hf_norm(state, "vision_model.post_layernorm", vision["post_ln"])
    _hf_linear(state, "visual_projection", vision["projection"])
    config = {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": vision_cfg.projection_dim,
        "logit_scale_init_value": 2.6592,
        "text_config": {
            "model_type": "clip_text_model",
            "vocab_size": text_cfg.vocab_size, "hidden_size": text_cfg.hidden,
            "intermediate_size": text_cfg.d_ff,
            "num_hidden_layers": text_cfg.num_layers,
            "num_attention_heads": text_cfg.num_heads,
            "max_position_embeddings": text_cfg.max_positions,
            "hidden_act": "quick_gelu",
            "layer_norm_eps": text_cfg.layer_norm_eps,
            "bos_token_id": eos - 1, "eos_token_id": eos, "pad_token_id": eos,
            "projection_dim": vision_cfg.projection_dim},
        "vision_config": {
            "model_type": "clip_vision_model",
            "hidden_size": vision_cfg.hidden,
            "intermediate_size": vision_cfg.d_ff,
            "num_hidden_layers": vision_cfg.num_layers,
            "num_attention_heads": vision_cfg.num_heads,
            "image_size": vision_cfg.image_size,
            "patch_size": vision_cfg.patch_size, "num_channels": 3,
            "hidden_act": "quick_gelu",
            "layer_norm_eps": vision_cfg.layer_norm_eps,
            "projection_dim": vision_cfg.projection_dim},
    }
    _save_hf(d, state, config)
    return text, vision


def write_hf_vit(torch, d, cfg, gen, device):
    """A random DINO ViT (the port's init on ``device``) in transformers'
    ViTModel layout with a ViTImageProcessor config.  Returns the tree."""
    from loongx_tpu_torch.models.vision import (
        IMAGENET_MEAN, IMAGENET_STD, init_vit_params,
    )

    params = init_vit_params(cfg, generator=gen, dtype=torch.float32,
                             device=device)
    patch = "embeddings.patch_embeddings.projection"
    state = {
        "embeddings.cls_token": params["cls_token"].reshape(1, 1, -1),
        "embeddings.position_embeddings": params["pos_embed"][None],
        f"{patch}.weight": _hf_patch_conv(params["patch_embed"]["kernel"],
                                          cfg.patch_size),
        f"{patch}.bias": params["patch_embed"]["bias"],
    }
    _hf_stacked_blocks(state, "encoder.layer", params["blocks"], VIT_BLOCK)
    _hf_norm(state, "layernorm", params["final_ln"])
    config = {
        "architectures": ["ViTModel"], "model_type": "vit",
        "hidden_size": cfg.hidden, "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads, "intermediate_size": cfg.d_ff,
        "hidden_act": "gelu", "image_size": cfg.image_size,
        "patch_size": cfg.patch_size, "num_channels": 3,
        "layer_norm_eps": cfg.layer_norm_eps, "qkv_bias": True,
    }
    _save_hf(d, state, config, preprocessor_config={
        "image_processor_type": "ViTImageProcessor", "do_resize": True,
        "size": {"height": cfg.image_size, "width": cfg.image_size},
        "resample": 2, "do_rescale": True, "rescale_factor": 1 / 255,
        "do_normalize": True, "image_mean": list(IMAGENET_MEAN),
        "image_std": list(IMAGENET_STD)})
    return params


def write_hf_depth(torch, d, cfg, gen, device):
    """A random Depth-Anything (the port's init on ``device``) in
    transformers' DepthAnythingForDepthEstimation layout, with the DPT
    processor config of the published depth-anything-small-hf.  Returns
    (tree, the weights' bytes)."""
    from loongx_tpu_torch.models.depth import init_depth_anything_params
    from loongx_tpu_torch.models.vision import IMAGENET_MEAN, IMAGENET_STD

    params = init_depth_anything_params(cfg, generator=gen,
                                        dtype=torch.float32, device=device)
    emb = "backbone.embeddings"
    state = {f"{emb}.cls_token": params["cls"],
             f"{emb}.mask_token": torch.zeros(1, cfg.hidden_size,
                                              device=device),
             f"{emb}.position_embeddings": params["pos"]}
    _hf_conv(state, f"{emb}.patch_embeddings.projection", params["patch"])
    for i, blk in enumerate(params["blocks"]):
        prefix = f"backbone.encoder.layer.{i}"
        _hf_block(state, prefix, blk, DINOV2_BLOCK)
        state[f"{prefix}.layer_scale1.lambda1"] = blk["ls1"]
        state[f"{prefix}.layer_scale2.lambda1"] = blk["ls2"]
    _hf_norm(state, "backbone.layernorm", params["ln"])
    for i, (layer, factor) in enumerate(zip(params["reassemble"],
                                            cfg.reassemble_factors)):
        rp = f"neck.reassemble_stage.layers.{i}"
        _hf_conv(state, f"{rp}.projection", layer["proj"])
        if factor > 1:  # ConvTranspose2d: [in, out, kh, kw]
            state[f"{rp}.resize.weight"] = layer["resize"]["kernel"].permute(
                0, 3, 1, 2)
            state[f"{rp}.resize.bias"] = layer["resize"]["bias"]
        elif factor < 1:
            _hf_conv(state, f"{rp}.resize", layer["resize"])
        _hf_conv(state, f"neck.convs.{i}", params["convs"][i])
        fp = f"neck.fusion_stage.layers.{i}"
        fusion = params["fusion"][i]
        _hf_conv(state, f"{fp}.projection", fusion["proj"])
        for r in (1, 2):
            for c in (1, 2):
                _hf_conv(state, f"{fp}.residual_layer{r}.convolution{c}",
                         fusion[f"res{r}"][f"conv{c}"])
    for c in (1, 2, 3):
        _hf_conv(state, f"head.conv{c}", params["head"][f"conv{c}"])
    config = {
        "architectures": ["DepthAnythingForDepthEstimation"],
        "model_type": "depth_anything",
        "backbone_config": {
            "model_type": "dinov2", "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads, "mlp_ratio": cfg.mlp_ratio,
            "patch_size": cfg.patch_size, "image_size": cfg.image_size,
            "layer_norm_eps": cfg.layer_norm_eps, "layerscale_value": 1.0,
            "hidden_act": "gelu", "qkv_bias": True, "use_swiglu_ffn": False,
            "out_indices": list(cfg.out_indices),
            "out_features": [f"stage{i}" for i in cfg.out_indices],
            "apply_layernorm": True, "reshape_hidden_states": False},
        "patch_size": cfg.patch_size,
        "reassemble_hidden_size": cfg.hidden_size,
        # integral factors as ints: transformers sizes the transposed convs
        # with them
        "reassemble_factors": [int(f) if f == int(f) else f
                               for f in cfg.reassemble_factors],
        "neck_hidden_sizes": list(cfg.neck_hidden_sizes),
        "fusion_hidden_size": cfg.fusion_hidden_size,
        "head_in_index": cfg.head_in_index,
        "head_hidden_size": cfg.head_hidden_size,
        "depth_estimation_type": cfg.depth_estimation_type,
        "max_depth": cfg.max_depth,
    }
    size = cfg.image_size
    written = _save_hf(d, state, config, preprocessor_config={
        "image_processor_type": "DPTImageProcessor", "do_resize": True,
        "size": {"height": size, "width": size}, "keep_aspect_ratio": True,
        "ensure_multiple_of": cfg.patch_size, "resample": 3,
        "do_rescale": True, "rescale_factor": 1 / 255, "do_normalize": True,
        "image_mean": list(IMAGENET_MEAN), "image_std": list(IMAGENET_STD),
        "do_pad": False})
    return params, written


def _rel_err(np, got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def depth_edit(torch, paths, device="cuda"):
    """Random Depth-Anything-Small (``DepthAnythingConfig()``, the JAX
    default ``LiheYoung/depth-anything-small-hf``) written as a Hugging Face
    checkout, then ``cli.infer.main`` with ``--condition_type depth`` on
    phase 4's first request (LOONGX_DEPTH_MODEL at the checkout,
    LOONGX_W8A8=1, ``--int8``): the estimator must be the port's on the
    card, its predicted depth within DEPTH_REL_TOL of the same estimator on
    the CPU (the uint8 image within DEPTH_U8_SHARE), the edit finite and
    512x512, every flash forward and GEMM on its Hopper route.  Prints the
    estimator's ms per image and the edit's ms/step; returns the edit's
    launches."""
    import numpy as np
    from PIL import Image
    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.models import depth
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.sampling import generate

    cfg = depth.DepthAnythingConfig()
    ddir = os.path.join(paths["root"], "depth-anything-small")
    t0 = time.perf_counter()
    _, written = write_hf_depth(
        torch, ddir, cfg, torch.Generator(device=device).manual_seed(21), device)
    print(f"  Depth-Anything-Small (random, seed 21): {written} bytes written "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    with open(os.path.join(ddir, "config.json")) as f:
        if depth.DepthAnythingConfig.from_hf_config(json.load(f)) != cfg:
            raise Failure("the Depth-Anything config.json does not read back "
                          "as DepthAnythingConfig()")

    calls, denoise_s, finite, pipes = [], [], [], []
    predict, load = depth.DepthAnythingEstimator.predict_depth, (
        LoongXPipeline.from_pretrained)
    denoise, decode = generate.denoise, generate.vae_decode

    def timed_predict(self, image):
        t0 = time.perf_counter()
        out = predict(self, image)  # ends in a copy to the host
        calls.append((self, image.copy(), out, time.perf_counter() - t0))
        return out

    def kept_load(path, **kw):
        pipes.append(load(path, **kw))
        return pipes[-1]

    def timed_denoise(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise(*a, **k)
        torch.cuda.synchronize()
        denoise_s.append(time.perf_counter() - t0)
        return out

    def checked_decode(*a, **k):
        out = decode(*a, **k)
        finite.append(bool(torch.isfinite(out).all()))
        return out

    out_dir = os.path.join(paths["root"], "out_depth")
    depth._ESTIMATOR_CACHE.clear()
    try:
        depth.DepthAnythingEstimator.predict_depth = timed_predict
        LoongXPipeline.from_pretrained = staticmethod(kept_load)
        generate.denoise, generate.vae_decode = timed_denoise, checked_decode
        with _env(LOONGX_DEPTH_MODEL=ddir, LOONGX_W8A8="1"):
            cuda_build.LAUNCHES.clear()
            t0 = time.perf_counter()
            infer.main(["--checkpoint", paths["ckpt"], "--single_image",
                        paths["image"], "--prompt", "", "--brain_data_path",
                        paths["pkl"], "--seed", "1", "--int8",
                        "--condition_type", "depth", "--steps", str(STEPS),
                        "--target_size", "512", "--device", device,
                        "--output_dir", out_dir])
            edit_s = time.perf_counter() - t0
            counts = dict(cuda_build.LAUNCHES)
    finally:
        depth.DepthAnythingEstimator.predict_depth = predict
        LoongXPipeline.from_pretrained = load
        generate.denoise, generate.vae_decode = denoise, decode
    blocks = pipes[0].flux_cfg.num_double_blocks + (
        pipes[0].flux_cfg.num_single_blocks)
    pipes.clear()
    gc.collect()
    torch.cuda.empty_cache()

    ests = [v for k, v in depth._ESTIMATOR_CACHE.items() if k[0] == ddir]
    if (len(ests) != 1 or type(ests[0]) is not depth.DepthAnythingEstimator
            or ests[0].device.type != torch.device(device).type
            or ests[0].params["patch"]["kernel"].device != ests[0].device
            or len(calls) != 1 or calls[0][0] is not ests[0]):
        raise Failure(f"the depth edit's estimator is not the port's on the "
                      f"card: cached {[type(e).__name__ for e in ests]}, "
                      f"{len(calls)} predict calls")
    est, image, got, first_s = calls[0]
    cpu = depth.DepthAnythingEstimator.from_pretrained(ddir, device="cpu")
    want = cpu.predict_depth(image)
    err = _rel_err(np, got, want)
    t_est = []
    for _ in range(3):
        t0 = time.perf_counter()
        gpu_out = est(image)
        t_est.append(time.perf_counter() - t0)
    u8 = np.asarray(gpu_out["depth"]).astype(np.int32)
    u8_cpu = np.asarray(cpu(image)["depth"]).astype(np.int32)
    share = float((u8 != u8_cpu).mean())
    print(f"  estimator: DepthAnythingEstimator on {est.device}, input "
          f"{image.size[0]}x{image.size[1]}; predicted_depth {got.shape} "
          f"(max {float(np.abs(want).max()):.4g}) vs the CPU: max rel err "
          f"{err:.3g} (tol {DEPTH_REL_TOL}); uint8 image: {share:.5f} of "
          f"values differ (max {int(np.abs(u8 - u8_cpu).max())}; limit "
          f"{DEPTH_U8_SHARE}); {first_s * 1e3:.1f} ms the first image, "
          f"{min(t_est) * 1e3:.1f}-{max(t_est) * 1e3:.1f} ms an image after",
          flush=True)
    if got.shape != (512, 512) or not np.isfinite(got).all():
        raise Failure(f"predicted_depth of shape {got.shape}, finite "
                      f"{bool(np.isfinite(got).all())}")
    if not err <= DEPTH_REL_TOL or not share <= DEPTH_U8_SHARE:
        raise Failure(f"the depth on the card differs from the CPU's: rel err "
                      f"{err:.3g}, uint8 share {share:.5f}")

    edit = np.asarray(Image.open(os.path.join(out_dir,
                                              os.path.basename(paths["image"]))))
    print(f"  depth edit: {edit_s:.2f} s end to end, "
          f"{denoise_s[0] / STEPS * 1e3:.1f} ms/step x {STEPS}; output "
          f"{edit.shape}, decodes finite {finite}", flush=True)
    if edit.shape != (512, 512, 3) or not (finite and all(finite)):
        raise Failure(f"depth edit: output {edit.shape}, finite {finite}")
    _cli_launch_check(counts, blocks, "depth edit")
    return counts


def _stage_split(paths, root):
    """A 2-row L-Mind test split (512x512 ``s<i>_0`` sources: phase 4's first
    two CLI requests; random ``s<i>_1`` targets) with their signals; returns
    (jsonl, image dir, brain pickle)."""
    import pickle

    import numpy as np
    from PIL import Image

    data = os.path.join(root, "lmind")
    os.makedirs(os.path.join(data, "imgs"))
    with open(paths["pkl"], "rb") as f:
        brain = pickle.load(f)
    rows, split_brain = [], {}
    for i, src in enumerate(("req1.png", "req2.png")):
        shutil.copy(os.path.join(paths["in_dir"], src),
                    os.path.join(data, "imgs", f"s{i}_0.png"))
        rng = np.random.default_rng(30 + i)
        Image.fromarray((rng.random((512, 512, 3)) * 255).astype(np.uint8)
                        ).save(os.path.join(data, "imgs", f"s{i}_1.png"))
        split_brain[f"s{i}_0.png"] = brain[src]
        rows.append({"source_image": f"imgs/s{i}_0.png",
                     "target_image": f"imgs/s{i}_1.png",
                     "instruction": f"make the sky a deep blue, take {i}"})
    jsonl = os.path.join(data, "test.jsonl")
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    pkl = os.path.join(data, "brain.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(split_brain, f)
    return jsonl, data, pkl


def eval_parity(torch, paths, device="cuda"):
    """Random CLIP ViT-B/32 (transformers' CLIPConfig() widths) and DINO
    ViT-S/16 (``ViTConfig.dino_s16()``) written as Hugging Face checkouts,
    CLIP converted by ``cli.convert --eval_clip``, then ``cli.parity.main``
    over a staged 2-row split of 512x512 pairs (``--mode neural --int8
    --batch_size 2``, LOONGX_W8A8=1; ``--jax_clip_path`` and
    ``--jax_dino_path``): parity.json with finite CLIP-I and DINO-I, exit 1
    exactly when the verdict is false; CLIP-I and DINO-I of identical pairs
    1 within IDENTITY_TOL; CLIP image / text and DINO features on the card
    within FEATURE_REL_TOL of the CPU's; the ms per batch of 16."""
    import numpy as np
    from loongx_tpu_torch.cli import convert, evaluate, parity
    from loongx_tpu_torch.models.text.clip import CLIPTextConfig
    from loongx_tpu_torch.models.text.clip_vision import (
        CLIPVisionConfig, clip_preprocess, clip_vision_encode,
    )
    from loongx_tpu_torch.models.vision import ViTConfig, vit_encode, vit_preprocess

    root = paths["root"]
    gen = torch.Generator(device=device).manual_seed(22)
    clip_dir, dino_dir = (os.path.join(root, n) for n in ("clip-vit-b32",
                                                          "dino-vits16"))
    text_cfg = CLIPTextConfig(hidden=512, num_layers=12, num_heads=8, d_ff=2048)
    t0 = time.perf_counter()
    _, vision = write_hf_clip(torch, clip_dir, text_cfg, CLIPVisionConfig.b32(),
                              gen, device)
    vit = write_hf_vit(torch, dino_dir, ViTConfig.dino_s16(), gen, device)
    bundle = os.path.join(root, "eval_clip")
    convert.main(["--eval_clip", clip_dir, "--out", bundle])
    print(f"  CLIP ViT-B/32 and DINO ViT-S/16 (random, seed 22) written and "
          f"CLIP converted in {time.perf_counter() - t0:.2f} s", flush=True)

    jsonl, data, pkl = _stage_split(paths, root)
    out = os.path.join(root, "parity")
    argv = ["--checkpoint", paths["ckpt"], "--test_jsonl", jsonl,
            "--image_dir", data, "--brain_data", pkl, "--jax_clip_path", bundle,
            "--jax_dino_path", dino_dir, "--out", out, "--mode", "neural",
            "--int8", "--batch_size", "2", "--steps", str(STEPS),
            "--device", device]
    t0 = time.perf_counter()
    with _env(LOONGX_W8A8="1"):
        try:
            parity.main(argv)
            code = 0
        except SystemExit as exc:
            code = exc.code
    parity_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    with open(os.path.join(out, "parity.json")) as f:
        written = json.load(f)
    results, verdict = written["results"], written["verdict"]
    print(f"  parity: exit {code} in {parity_s:.1f} s; results {results}; "
          f"verdict {verdict}", flush=True)
    if code not in (0, 1) or (code == 1) != (verdict["parity"] is False):
        raise Failure(f"parity exited {code!r} with the verdict {verdict}")
    if not all(np.isfinite(results.get(k, np.nan)) for k in ("clip_i",
                                                             "dino_i")):
        raise Failure(f"parity.json lacks finite clip_i / dino_i: {results}")

    outputs = os.path.join(out, "outputs")
    ident = os.path.join(root, "identical")
    os.makedirs(ident)
    gens = sorted(os.listdir(outputs))
    for name in gens:
        shutil.copy(os.path.join(outputs, name),
                    os.path.join(ident, name.replace("_0.", "_1.")))
    same = evaluate.main(["--gen_dir", outputs, "--gt_dir", ident,
                          "--jax_clip_path", bundle, "--jax_dino_path",
                          dino_dir, "--image_size", "512", "--device", device])
    off = max(abs(same["clip_i"] - 1), abs(same["dino_i"] - 1))
    print(f"  identical pairs: CLIP-I {same['clip_i']:.7f}, DINO-I "
          f"{same['dino_i']:.7f} (tol {IDENTITY_TOL})", flush=True)
    if not off <= IDENTITY_TOL:
        raise Failure(f"identical pairs score {same['clip_i']}, "
                      f"{same['dino_i']}")

    images = [os.path.join(outputs, n) for n in gens] + [
        os.path.join(data, "imgs", f"s{i}_1.png") for i in range(2)]
    texts = ["make the sky a deep blue, take 0", "b"]
    feats = {}
    for dev in (device, "cpu"):
        img_fn, txt_fn = evaluate.load_clip_backend(bundle, dev)
        dino_fn = evaluate.load_dino_backend(dino_dir, dev)
        feats[dev] = {"CLIP image": img_fn(images), "CLIP text": txt_fn(texts),
                      "DINO CLS": dino_fn(images)}
    errs = {k: _rel_err(np, feats[device][k], feats["cpu"][k])
            for k in feats["cpu"]}
    print(f"  features on the card vs the CPU, max rel err: "
          f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (tol "
          f"{FEATURE_REL_TOL})", flush=True)
    if not all(e <= FEATURE_REL_TOL for e in errs.values()):
        raise Failure(f"features on the card differ from the CPU's: {errs}")

    img_fn, txt_fn = evaluate.load_clip_backend(bundle, device)
    dino_fn = evaluate.load_dino_backend(dino_dir, device)
    batch = (images * 4)[:16]
    host = {}
    for name, fn, arg in (("CLIP image", img_fn, batch),
                          ("CLIP text", txt_fn, texts * 8),
                          ("DINO", dino_fn, batch)):
        fn(arg)
        t0 = time.perf_counter()
        for _ in range(3):
            fn(arg)
        host[name] = (time.perf_counter() - t0) / 3 * 1e3
    x = torch.rand(16, 512, 512, 3, device=device,
                   generator=torch.Generator(device=device).manual_seed(23))
    with torch.inference_mode():
        dev = {"CLIP image": cuda_time_ms(lambda: clip_vision_encode(
                   vision, CLIPVisionConfig.b32(), clip_preprocess(x, 224))),
               "DINO": cuda_time_ms(lambda: vit_encode(
                   vit, ViTConfig.dino_s16(), vit_preprocess(x, 224)))}
    print(f"  ms per batch of 16: the backends (Pillow read and resize "
          f"included) { {k: round(v, 2) for k, v in host.items()} }; the "
          f"towers on the card from 512x512 (resize included, CUDA events) "
          f"{ {k: round(v, 3) for k, v in dev.items()} }", flush=True)


TRAIN_STEPS = 4
# configs/seed_512.yaml's optimizer and model flags
SEED_512_OPTIMIZER = {"type": "Prodigy", "params": dict(
    lr=0.1, use_bias_correction=True, safeguard_warmup=True, weight_decay=0.01)}
SEED_512_FLAGS = {"union_cond_attn": True, "add_cond_attn": False,
                  "latent_lora": False}


def _byte_sums(torch, tree):
    """{path: sum of the leaf's bytes} (int64, one block at a time): a
    checksum of every leaf of a frozen tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif t is not None:
            b = t.detach().contiguous().reshape(-1, t.shape[-1] if t.ndim else 1)
            b = b.view(torch.uint8)
            out[path] = int(sum(torch.sum(b[i:i + 4096], dtype=torch.int64)
                                for i in range(0, b.shape[0], 4096)))

    walk(tree, "")
    return out


def train(torch):
    """The seed_512 QLoRA step at full FLUX.1-dev width and depth."""
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops.latents import latent_image_ids
    from loongx_tpu_torch.train.lora import lora_state_dict
    from loongx_tpu_torch.train.optim import build_optimizer
    from loongx_tpu_torch.train.step import (
        make_train_step, partition, trainable_mask,
    )

    t0 = time.perf_counter()
    pipe = LoongXPipeline.init_training(seed=0)
    cfg = pipe.flux_cfg
    trainable, frozen = partition(pipe.params, trainable_mask(pipe.params))
    init_fn, step_fn = make_train_step(
        cfg, build_optimizer(SEED_512_OPTIMIZER), flags=SEED_512_FLAGS,
        use_brain_condition=True, fuse_flag=True, remat=True, grad_clip=0.5,
        dtype=torch.bfloat16)
    state = init_fn(trainable)
    # the trainable tree holds the LoRA factors only (lora_scale is frozen)
    lora_sd = lora_state_dict(trainable["flux"])
    lora_names, lora = list(lora_sd), list(lora_sd.values())
    lora0 = [p.detach().clone() for p in lora]
    sums0 = _byte_sums(torch, frozen)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    ids = latent_image_ids(64, 64)
    batch = dict(x0=rand(1, 1024, 64), cond_tokens=rand(1, 1024, 64),
                 prompt_embeds=rand(1, 512, 4096, scale=0.1),
                 pooled=rand(1, 768, scale=0.1), img_ids=ids, cond_ids=ids,
                 txt_ids=torch.zeros(512, 3, device="cuda"),
                 eeg=rand(1, 4, 4096), ppg=rand(1, 4, 256), fnirs=rand(1, 6, 512),
                 motion=rand(1, 6, 128))
    n_lora = sum(p.numel() for p in lora)
    print(f"  training tree built in {time.perf_counter() - t0:.1f} s: "
          f"{len(lora)} LoRA leaves ({n_lora / 1e6:.2f} M params), "
          f"{len(sums0)} frozen leaves", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    times, per_step = [], []
    for i in range(TRAIN_STEPS):
        before = dict(cuda_build.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, frozen, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({n: cuda_build.LAUNCHES[n] - before.get(n, 0)
                         for n in TRAIN_KERNELS})
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        d = float(state.optimizer.d)
        print(f"  step {i + 1}: {times[-1]:.3f} s, loss {loss:.6f}, grad norm "
              f"{norm:.6e}, t {float(m['t_mean']):.4f}, Prodigy d {d:.6e}"
              + (" (warm-up)" if i == 0 else ""), flush=True)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise Failure(f"train step {i + 1}: loss {loss}, grad norm {norm}")
    launches = {n: cuda_build.LAUNCHES[n] for n in TRAIN_KERNELS}
    for n in ("flash_bwd_dkv", "flash_bwd_dq", "qmm_stacked", "qmm_flat",
              "qmm_t_stacked", "qmm_t"):
        for route in GEMM_ROUTES:
            launches[f"{n}:{route}"] = cuda_build.LAUNCHES[f"{n}:{route}"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = times[1:]
    print(f"  {sum(steady) / len(steady):.3f} s/step over steps 2-{TRAIN_STEPS} "
          f"({min(steady):.3f}-{max(steady):.3f}); peak memory {peak:.2f} GiB",
          flush=True)
    print(f"  launches per step {per_step[-1]} (remat: every block's forward "
          f"kernels run twice, once in the forward and once recomputed in the "
          f"backward); over {TRAIN_STEPS} steps {launches}; by route qmm_flat "
          f"{routes(launches, 'qmm_flat')}, qmm_t {routes(launches, 'qmm_t')}",
          flush=True)
    moved = {name: not torch.equal(a, b)
             for name, a, b in zip(lora_names, lora, lora0)}
    delta = sum(float((a.detach().float() - b.float()).abs().sum())
                for a, b in zip(lora, lora0))
    changed = [k for k, v in _byte_sums(torch, frozen).items() if v != sums0[k]]
    print(f"  LoRA leaves moved: {sum(moved.values())} of {len(lora)} (sum "
          f"|delta| {delta:.6e}); frozen leaves changed: {len(changed)} of "
          f"{len(sums0)}", flush=True)
    # B starts at 0, so any update shows in bf16; A ~ N(0, 1) / r moves by
    # about lr * d = 1e-7 per step while Prodigy's d is at d0, far below its
    # bf16 resolution, so A stays put in the first steps (in JAX as well)
    still = [n for n, did in moved.items() if n.endswith("lora_b") and not did]
    if still:
        raise Failure(f"LoRA B factors left unchanged: {still}")
    if changed:
        raise Failure(f"frozen leaves changed: {changed[:5]}")
    missing = [n for n in TRAIN_KERNELS if launches[n] == 0]
    if missing:
        raise Failure(f"kernels not launched while training: {missing}")
    # head_dim 128: every flash backward launch on the wgmma route, none on
    # mma.sync; every stacked weight-only GEMM (M 1 to 2560) and stacked
    # transposed GEMM likewise (the flat ones with K or N 64 stay on mma.sync)
    for n in ("flash_bwd_dkv", "flash_bwd_dq", "qmm_stacked", "qmm_t_stacked"):
        if launches[f"{n}:wgmma"] != launches[n] or launches[f"{n}:mma_sync"]:
            raise Failure(f"{n}: {launches[n]} launches, {launches[n + ':wgmma']} "
                          f"wgmma, {launches[n + ':mma_sync']} mma.sync")
    # the proj_out backward (N 64) on the narrow kernel: no transposed GEMM
    # on mma.sync; its forward on split-K, x_embedder's on the K 64 kernel: no
    # flat GEMM on mma.sync
    if launches["qmm_t:mma_sync"] or launches["qmm_t:narrow"] != launches["qmm_t"]:
        raise Failure(f"qmm_t: {launches['qmm_t']} launches, by route "
                      f"{routes(launches, 'qmm_t')}")
    if launches["qmm_flat:mma_sync"]:
        raise Failure(f"qmm_flat: {launches['qmm_flat']} launches, by route "
                      f"{routes(launches, 'qmm_flat')}")
    # one more step under the profiler, outside the timings and the counts
    prof = device_profile(lambda: step_fn(state, frozen, batch, gen))
    if prof is None:
        print("  step device profile: not measured (no device activity in the "
              "profiler)", flush=True)
    else:
        print("  step device profile: busy {busy_ms:.1f} ms over a span of "
              "{span_ms:.1f} ms, idle share {idle_share:.3f}; by group "
              "{by_group_ms}; largest other {top_other_ms}".format(**prof),
              flush=True)
        groups = prof["by_group_ms"]
        for what, names in (("flash backward", FLASH_BWD_GROUPS),
                            ("weight-only int8 GEMM", WONLY_GROUPS),
                            ("transposed int8 GEMM", TRANSPOSED_GROUPS)):
            print(f"  step {what} group: "
                  f"{sum(groups.get(g, 0.0) for g in names):.1f} ms ("
                  + ", ".join(f"{g} {groups[g]:.1f}" for g in names
                              if g in groups) + ")", flush=True)
    fused = train_fused_ln(torch, cfg, state, frozen, batch, gen, lora_names,
                           lora, sums0, sum(steady) / len(steady), prof)
    del state, trainable, frozen, pipe
    return launches, fused


FUSED_TRAIN_STEPS = 2


def train_fused_ln(torch, cfg, state, frozen, batch, gen, lora_names, lora,
                   sums0, s_unfused, prof_unfused):
    """Two more steps with ``fuse_ln`` (the same state and optimizer): with
    DEFAULT_TARGETS LoRA only the double blocks' ff.in is fusable, so its
    prologue runs 19 times in the forward and 19 in the remat; finite loss,
    every LoRA B factor moves, frozen leaves untouched, s/step beside the
    unfused steps', then one more step under the profiler beside the
    unfused step's profile ``prof_unfused``.  Returns the launch counts of
    the last timed step."""
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.train.optim import build_optimizer
    from loongx_tpu_torch.train.step import make_train_step

    _, step_fn = make_train_step(
        cfg, build_optimizer(SEED_512_OPTIMIZER), flags=SEED_512_FLAGS,
        use_brain_condition=True, fuse_flag=True, remat=True, grad_clip=0.5,
        dtype=torch.bfloat16, fuse_ln=True)
    before = [p.detach().clone() for p in lora]
    times = []
    for i in range(FUSED_TRAIN_STEPS):
        cuda_build.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, frozen, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        loss = float(m["loss"])
        launches = {n: cuda_build.LAUNCHES[n] for n in FUSED_KERNELS}
        print(f"  fuse_ln step {i + 1}: {times[-1]:.3f} s, loss {loss:.6f}, "
              f"grad norm {float(m['grad_norm']):.6e}, launches {launches}",
              flush=True)
        if not math.isfinite(loss):
            raise Failure(f"fuse_ln train step {i + 1}: loss {loss}")
        # the forward's and the remat's prologues (19 + 19): each a pass
        # that computes its row stats in registers (the warp route), then
        # the weight-only GEMM on wgmma; the backward's layer norm takes
        # the row stats once a block (19, the warp route)
        nd = cfg.num_double_blocks
        if (launches["qmm_stacked_ln"] != 2 * nd
                or launches["qmm_stacked_ln:wgmma"] != 2 * nd
                or launches["qmm_ln_mod_pass"] != 2 * nd
                or launches["qmm_ln_mod_pass:warp"] != 2 * nd
                or launches["qmm_ln_stats"] != nd
                or launches["qmm_ln_stats:warp"] != nd
                or launches["qmm_stacked_gate"] or launches["qmm_act_quant_ln"]
                or launches["qmm_qkv_stacked_ln"]):
            raise Failure(f"fuse_ln train step: launches {launches}")
    still = [n for n, a, b in zip(lora_names, lora, before)
             if n.endswith("lora_b") and torch.equal(a, b)]
    changed = [k for k, v in _byte_sums(torch, frozen).items() if v != sums0[k]]
    print(f"  fuse_ln: {times[-1]:.3f} s/step (step 2; unfused steps 2-"
          f"{TRAIN_STEPS}: {s_unfused:.3f}); LoRA B factors unmoved: "
          f"{len(still)}; frozen leaves changed: {len(changed)}", flush=True)
    if still or changed:
        raise Failure(f"fuse_ln steps: LoRA B unmoved {still}, frozen changed "
                      f"{changed[:5]}")
    prof = device_profile(lambda: step_fn(state, frozen, batch, gen))
    if prof is None or prof_unfused is None:
        print("  fuse_ln step device profile: not measured (no device "
              "activity in the profiler)", flush=True)
        return launches
    print("  fuse_ln step device profile: busy {busy_ms:.1f} ms over a span "
          "of {span_ms:.1f} ms, idle share {idle_share:.3f}; by group "
          "{by_group_ms}; largest other {top_other_ms}".format(**prof),
          flush=True)
    for what, names in (("prologue pass and row stats", LN_GROUPS),
                        ("weight-only int8 GEMM", WONLY_GROUPS)):
        fused_g, unfused_g = (sum(p["by_group_ms"].get(g, 0.0) for g in names)
                              for p in (prof, prof_unfused))
        print(f"  fuse_ln step {what} group: {fused_g:.1f} ms ("
              + ", ".join(f"{g} {prof['by_group_ms'][g]:.1f}" for g in names
                          if g in prof["by_group_ms"])
              + f"); unfused step {unfused_g:.1f}", flush=True)
    print(f"  fuse_ln step busy {prof['busy_ms']:.1f} ms, unfused step "
          f"{prof_unfused['busy_ms']:.1f}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase "train CLI": python -m loongx_tpu_torch.cli.train from a YAML config
# ---------------------------------------------------------------------------

TRAIN_CLI_ROWS = 8
TRAIN_CLI_SIZE = 512  # the corpus' images and configs/seed_512.yaml's sizes
TRAIN_CLI_MAX_STEPS = (2, 3)  # the first run, then the resumed one
# phase 5's signal shapes (the CS3 encoders' fixed lengths)
TRAIN_CLI_SIGNALS = {"EEG": (4, 4096), "PPG": (4, 256), "FNIRS": (6, 512),
                     "Motion": (6, 128)}
TRAIN_CLI_FREED_BYTES = 1 << 30  # allocated when the DiT loads, at most
TRAIN_CLI_PROFILED = 6  # the micro-step of run 1 taken under the profiler


def _bytes_to_unicode():
    """GPT-2's byte -> printable character table (the CLIP tokenizer's)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def write_char_tokenizers(root):
    """``t5_tokenizer/`` and ``clip_tokenizer/`` in the pipeline directory:
    character-level vocabularies built with the ``tokenizers`` package (a
    unigram model for T5, byte-level BPE without merges for CLIP), loadable
    by ``transformers``' T5TokenizerFast and CLIPTokenizer (the repository
    holds no real vocabulary)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    # T5: a unigram model over single characters after the metaspace split,
    # T5's own structure
    pieces = ["<pad>", "</s>", "<unk>"] + [chr(c) for c in range(33, 127)]
    tok = Tokenizer(models.Unigram([(p, -1.0) for p in pieces + ["▁"]],
                                   unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    t5_dir = os.path.join(root, "t5_tokenizer")
    os.makedirs(t5_dir)
    tok.save(os.path.join(t5_dir, "tokenizer.json"))
    with open(os.path.join(t5_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>",
                   "unk_token": "<unk>", "pad_token": "<pad>", "extra_ids": 0,
                   "model_max_length": 512}, f)

    write_clip_tokenizer(os.path.join(root, "clip_tokenizer"))


def write_clip_tokenizer(clip_dir):
    """A byte-level BPE vocabulary without merges (every byte alone and with
    "</w>", then the start and end tokens) in ``clip_dir``, as
    ``vocab.json`` + ``merges.txt`` and the ``tokenizers`` package's
    ``tokenizer.json``: loadable by transformers' CLIPTokenizer.  Returns
    the end token's id."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    chars = list(_bytes_to_unicode().values())
    clip_vocab = {c: i for i, c in enumerate(chars)}
    clip_vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    bos, eos = "<|startoftext|>", "<|endoftext|>"
    clip_vocab[bos], clip_vocab[eos] = len(clip_vocab), len(clip_vocab) + 1
    os.makedirs(clip_dir, exist_ok=True)
    with open(os.path.join(clip_dir, "vocab.json"), "w") as f:
        json.dump(clip_vocab, f)
    with open(os.path.join(clip_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = Tokenizer(models.BPE(clip_vocab, [], unk_token=eos,
                               end_of_word_suffix="</w>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.TemplateProcessing(
        single=f"{bos} $A {eos}",
        special_tokens=[(bos, clip_vocab[bos]), (eos, clip_vocab[eos])])
    tok.save(os.path.join(clip_dir, "tokenizer.json"))
    with open(os.path.join(clip_dir, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer", "bos_token": bos,
                   "eos_token": eos, "unk_token": eos, "pad_token": eos,
                   "model_max_length": 77}, f)
    return clip_vocab[eos]


def train_cli_bundle(torch):
    """The pipeline a user converts for training, random on the card: int8
    FLUX.1-dev in the training layout without LoRA (the loop adds it), the
    FLUX VAE, CS3 + DGF, int8 T5-XXL and CLIP-L."""
    from loongx_tpu_torch.models import pipeline as pipeline_mod
    from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
    from loongx_tpu_torch.models.flux.vae import VAEConfig, init_vae_params
    from loongx_tpu_torch.ops.quant import random_quantized_like

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg, vae_cfg = FluxConfig.flux_dev(), VAEConfig.flux()
    flux = random_quantized_like(
        init_flux_params(cfg, dtype=torch.bfloat16, device="meta"),
        generator=gen, device="cuda")
    kw = dict(generator=gen, dtype=torch.bfloat16, device="cuda")
    params = {"flux": flux, "vae": init_vae_params(vae_cfg, **kw),
              **pipeline_mod._brain_params(kw)}
    pipe = pipeline_mod.LoongXPipeline(cfg, vae_cfg, params, torch.bfloat16)
    return pipe.add_text_encoders(seed=3)


def write_train_corpus(root):
    """A synthetic L-Mind corpus: 512x512 source/target PNG pairs, one
    instruction each (train.jsonl) and the four signals in data_final.pkl,
    keyed by the source image's name."""
    import pickle

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(root, "imgs"))
    rows, bio = [], {}
    for i in range(TRAIN_CLI_ROWS):
        for tag in ("src", "tgt"):
            Image.fromarray(rng.integers(
                0, 256, (TRAIN_CLI_SIZE, TRAIN_CLI_SIZE, 3), np.uint8)).save(
                os.path.join(root, "imgs", f"{i}_{tag}.png"))
        rows.append({"source_image": f"imgs/{i}_src.png",
                     "target_image": f"imgs/{i}_tgt.png",
                     "instruction": f"make the sky {('red', 'green', 'blue')[i % 3]}"
                                    f" and the light softer, edit {i}"})
        bio[f"{i}_src.png"] = {k: rng.standard_normal(s).astype(np.float32)
                               for k, s in TRAIN_CLI_SIGNALS.items()}
    jsonl = os.path.join(root, "train.jsonl")
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    with open(os.path.join(root, "data_final.pkl"), "wb") as f:
        pickle.dump(bio, f)
    return jsonl


def write_train_config(root, ckpt, jsonl, runs, **lora):
    """configs/seed_512.yaml with only its paths changed, plus save_interval
    1, sample_interval 2, staged_text and 2 loader workers (``lora``:
    lora_config keys to change)."""
    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "seed_512.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["flux_path"] = ckpt
    t = raw["train"]
    t.update(save_path=runs, save_interval=1, sample_interval=2,
             staged_text=True, dataloader_workers=2)
    t["dataset"].update(jsonl_path=jsonl, image_dir=os.path.dirname(jsonl))
    t["lora_config"].update(lora)
    path = os.path.join(root, f"train_r{t['lora_config']['r']}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def _cpu_clone(x):
    """A host copy of a (nested) state: tensors cloned, containers copied."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu_clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_clone(v) for v in x)
    return x


def _state_diff(got, want, path=""):
    """Paths where two nested states differ (tensors by dtype and bytes)."""
    import torch
    if isinstance(want, torch.Tensor):
        got = got.detach().cpu()
        if got.dtype != want.dtype or got.shape != want.shape:
            return [path]
        bits = [t.contiguous().reshape(-1).view(torch.uint8) for t in (got, want)]
        return [] if torch.equal(*bits) else [path]
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{path} keys"]
        return [d for k in want for d in _state_diff(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{path} length"]
        return [d for i, (g, w) in enumerate(zip(got, want))
                for d in _state_diff(g, w, f"{path}/{i}")]
    return [] if got == want or (got != got and want != want) else [path]


@contextlib.contextmanager
def _patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` for the block (a static
    method comes back as one)."""
    import inspect
    raw = inspect.getattr_static(obj, name)
    setattr(obj, name, wrap(getattr(obj, name)))
    try:
        yield
    finally:
        setattr(obj, name, raw)


def train_cli(torch):
    """``cli.train.main`` at full FLUX.1-dev width and depth from a pipeline
    directory, a synthetic L-Mind corpus and configs/seed_512.yaml: 2
    optimizer steps (8 micro-batches, staged text, LoRA files and train
    states at steps 1 and 2, the probe image at step 2), a resumed run to
    step 3, and a refused resume with another LoRA rank.  The loop, the
    loader, the checkpoints and the probe are watched from outside (their
    module attributes wrapped for the phase).  Returns the launch counts
    of the first run."""
    import tempfile
    from loongx_tpu_torch.ops.quant import quantized_bytes
    from loongx_tpu_torch.utils import checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    pipe = train_cli_bundle(torch)
    need = quantized_bytes(pipe.params) + CLI_DISK_MARGIN
    free = shutil.disk_usage(here).free
    print(f"  training bundle made in {time.perf_counter() - t0:.1f} s; disk at "
          f"{here}: {free / 1e9:.1f} GB free, the checkpoint needs "
          f"{need / 1e9:.1f} GB", flush=True)
    if free < need:
        raise Failure(f"{free} bytes free at {here}, {need} needed for the "
                      "training checkpoint")
    root = tempfile.mkdtemp(prefix=".chip_smoke_train_", dir=here)
    try:
        ckpt = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        checkpoint.save_pipeline(pipe, ckpt)
        dt = time.perf_counter() - t0
        files = checkpoint.component_files(ckpt)
        written = sum(os.path.getsize(f) for f in files.values())
        print(f"  save_pipeline: {written} bytes ({written / 1e9:.3f} GB; "
              + ", ".join(f"{k} {os.path.getsize(f) / 1e9:.3f}"
                          for k, f in sorted(files.items()))
              + f") in {dt:.1f} s", flush=True)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        write_char_tokenizers(ckpt)
        # the loader (`_tok`) prints and returns None where transformers
        # cannot read a tokenizer: hold both to loading here
        for cls, sub, vocab in (("T5TokenizerFast", "t5_tokenizer", 32128),
                                ("CLIPTokenizer", "clip_tokenizer", 49408)):
            tok = checkpoint._tok(ckpt, cls, sub)
            if tok is None:
                raise Failure(f"train CLI: {sub} did not load as {cls}")
            ids = tok(["make the sky red"], padding="max_length",
                      max_length=16, truncation=True,
                      return_tensors="np").input_ids
            print(f"  {sub}: {type(tok).__name__}, ids {ids[0].tolist()}",
                  flush=True)
            if not 0 <= ids.min() <= ids.max() < vocab:
                raise Failure(f"train CLI: {sub} ids outside [0, {vocab})")
        jsonl = write_train_corpus(os.path.join(root, "data"))
        runs = os.path.join(root, "runs")
        yml = write_train_config(root, ckpt, jsonl, runs)
        return _train_cli_runs(torch, yml, runs, root, ckpt, jsonl)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _train_cli_run(torch, argv, saved):
    """One ``cli.train.main(argv)`` with its loads, micro-steps, saves,
    probe images and output recorded; ``saved`` collects host copies of
    each saved train state by step and is read by a resume."""
    from loongx_tpu_torch.cli import train as cli_train
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.train import loop
    from loongx_tpu_torch.train.sampling_probe import SampleProbe
    from loongx_tpu_torch.utils import checkpoint

    rec = {"loads": [], "micro": [], "saves": [], "lora_saves": [],
           "probes": [], "resumed": []}

    def sync_time():
        torch.cuda.synchronize()
        return time.perf_counter()

    def from_pretrained(orig):
        def load(path, *a, components=None, **kw):
            mem, t0 = torch.cuda.memory_allocated(), sync_time()
            out = orig(path, *a, components=components, **kw)
            rec["loads"].append((tuple(components or ()), mem,
                                 sync_time() - t0))
            return out
        return staticmethod(load)

    def make_train_step(orig):
        def make(*a, **kw):
            init_fn, step_fn = orig(*a, **kw)

            def step(state, frozen, batch, draws):
                if len(rec["micro"]) + 1 == TRAIN_CLI_PROFILED and not (
                        "profile" in rec):
                    # one micro-step under the profiler, with the loader's
                    # next batch being prepared beside it: its idle share
                    # (outside the timings and the launch counts)
                    out = []
                    rec["profile"] = device_profile(lambda: out.append(
                        step_fn(state, frozen, batch, draws)))
                    return out[0]
                before, t0 = dict(cuda_build.LAUNCHES), sync_time()
                out = step_fn(state, frozen, batch, draws)
                dt = sync_time() - t0
                rec["micro"].append((dt, {
                    n: v - before.get(n, 0) for n, v in cuda_build.LAUNCHES.items()
                    if v != before.get(n, 0)}))
                return out
            return init_fn, step
        return make

    def partition(orig):
        def split(params, mask):
            trainable, frozen = orig(params, mask)
            rec["trainable"], rec["frozen"] = trainable, frozen
            rec["sums0"] = _byte_sums(torch, frozen)
            return trainable, frozen
        return split

    def save_state(orig):
        def save(path, step, trainable, optimizer, fingerprint=None):
            t0 = sync_time()
            out = orig(path, step, trainable, optimizer, fingerprint=fingerprint)
            rec["saves"].append((step, sync_time() - t0))
            saved.clear()
            saved[step] = _cpu_clone((checkpoint.flatten_tree(
                checkpoint._prune(trainable))[0], optimizer.state_dict()))
            return out
        return save

    def save_lora(orig):
        def save(tree, path):
            t0 = sync_time()
            out = orig(tree, path)
            rec["lora_saves"].append((out, sync_time() - t0))
            return out
        return save

    def load_state(orig):
        def load(path, trainable, optimizer):
            t0 = sync_time()
            step = orig(path, trainable, optimizer)
            dt = sync_time() - t0
            live = _cpu_clone((checkpoint.flatten_tree(
                checkpoint._prune(trainable))[0], optimizer.state_dict()))
            rec["resumed"].append((step, dt, _state_diff(live, saved[step])
                                   if step in saved else ["nothing saved"]))
            return step
        return load

    def probe(orig):
        def call(self, step):
            t0 = sync_time()
            out = orig(self, step)
            rec["probes"].append((step, out, sync_time() - t0))
            return out
        return call

    tee = _Tee(sys.stdout)
    with contextlib.ExitStack() as stack:
        for obj, name, wrap in (
                (LoongXPipeline, "from_pretrained", from_pretrained),
                (loop, "make_train_step", make_train_step),
                (loop, "partition", partition),
                (checkpoint, "save_train_checkpoint", save_state),
                (checkpoint, "save_lora_safetensors", save_lora),
                (checkpoint, "load_train_checkpoint", load_state),
                (SampleProbe, "__call__", probe)):
            stack.enter_context(_patched(obj, name, wrap))
        stack.enter_context(contextlib.redirect_stdout(tee))
        try:
            rec["summary"] = cli_train.main(argv)
        except RuntimeError as exc:
            rec["error"] = exc
    rec["output"] = tee.text()
    for bad in ("sample generation failed", "sample probe unavailable",
                "lora export failed"):
        if bad in rec["output"]:
            raise Failure(f"train CLI: the run printed '{bad}'")
    return rec


def _micro_check(counts, what):
    """Every train-step kernel launched; every flash backward, stacked
    weight-only GEMM and stacked transposed GEMM on wgmma; nothing on
    mma.sync."""
    missing = [n for n in TRAIN_KERNELS if not counts.get(n)]
    off = [n for n in ("flash_bwd_dkv", "flash_bwd_dq", "qmm_stacked",
                       "qmm_t_stacked")
           if counts.get(f"{n}:wgmma", 0) != counts.get(n, 0)]
    on_mma_sync = {n: v for n, v in counts.items() if n.endswith(":mma_sync")
                   and v}
    if missing or off or on_mma_sync:
        raise Failure(f"{what}: kernels not launched {missing}, not all on "
                      f"wgmma {off}, on mma.sync {on_mma_sync}")


def _train_cli_runs(torch, yml, runs, root, ckpt, jsonl):
    """The three runs of the phase and their checks; returns the launch
    counts of the first."""
    from PIL import Image
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.train.lora import lora_state_dict

    saved = {}
    base = ["--config", yml, "--no_wandb"]

    def run(argv):
        return _train_cli_run(torch, base + argv, saved)

    # first run: 2 optimizer steps of 4 micro-batches from scratch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    rec = run(["--max_steps", str(TRAIN_CLI_MAX_STEPS[0]), "--no_resume"])
    counts = dict(cuda_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if "error" in rec:
        raise Failure(f"train CLI run 1: {rec['error']}")
    summary = rec["summary"]
    print(f"  run 1: {summary}", flush=True)
    if summary["steps"] != TRAIN_CLI_MAX_STEPS[0] or not math.isfinite(
            summary["final_loss"]):
        raise Failure(f"train CLI run 1 summary {summary}")
    loads = rec["loads"]
    print("  loads (components, bytes allocated at the call, s): "
          + "; ".join(f"{c} {m} {dt:.2f}" for c, m, dt in loads), flush=True)
    if [c for c, _, _ in loads] != [("t5", "clip"),
                                   ("flux", "vae", "encoders", "dgf")] or (
            loads[1][1] > TRAIN_CLI_FREED_BYTES):
        raise Failure("train CLI: the text encoders were not loaded alone and "
                      f"freed before the DiT: {loads}")
    (run_dir,) = [os.path.join(runs, d) for d in os.listdir(runs)]
    for step in (1, 2):
        need = [os.path.join(run_dir, "ckpt", str(step), "lora.safetensors"),
                os.path.join(run_dir, "train_state", f"step_{step}",
                             "trainable.safetensors"),
                os.path.join(run_dir, "train_state", f"step_{step}",
                             "train_state.pt")]
        if not all(os.path.isfile(p) for p in need):
            raise Failure(f"train CLI: step {step} files missing: "
                          f"{[p for p in need if not os.path.isfile(p)]}")
    probes = rec["probes"]
    if [s for s, _, _ in probes] != [2]:
        raise Failure(f"train CLI: probes at steps {probes}, expected [2]")
    size = Image.open(probes[0][1]).size
    print(f"  probe at step 2: {probes[0][1]} {size}, {probes[0][2]:.2f} s",
          flush=True)
    if size != (TRAIN_CLI_SIZE, TRAIN_CLI_SIZE):
        raise Failure(f"train CLI: probe image {size}")
    micro = rec["micro"]
    n_micro = TRAIN_CLI_MAX_STEPS[0] * 4
    if len(micro) != n_micro - 1:  # one more ran under the profiler
        raise Failure(f"train CLI: {len(micro) + 1} micro-batches, {n_micro} "
                      "expected")
    for i, (_, c) in enumerate(micro):
        _micro_check(c, f"train CLI micro-batch {i + 1}")
    _micro_check(counts, "train CLI run 1")
    times = [dt for dt, _ in micro]
    steady = times[1:]
    print(f"  micro-batch launches {micro[-1][1]}", flush=True)
    print(f"  {sum(steady) / len(steady):.3f} s/micro-step over micro-steps "
          f"2-{n_micro} but the profiled {TRAIN_CLI_PROFILED} "
          f"({min(steady):.3f}-{max(steady):.3f}; the first {times[0]:.3f}); "
          f"run wall {summary['wall_s']:.1f} s; peak memory {peak:.2f} GiB",
          flush=True)
    prof = rec.get("profile")
    if prof is None:
        print("  micro-step device profile: not measured (no device "
              "activity in the profiler)", flush=True)
    else:
        print("  micro-step {} device profile (the loader's next batch "
              "beside it): busy {busy_ms:.1f} ms over a span of {span_ms:.1f}"
              " ms, idle share {idle_share:.3f}; by group {by_group_ms}".format(
                  TRAIN_CLI_PROFILED, **prof), flush=True)
    print("  saves: train state " + ", ".join(
        f"step {s} {dt:.2f} s" for s, dt in rec["saves"]) + "; LoRA file "
        + ", ".join(f"{dt:.2f} s" for _, dt in rec["lora_saves"]), flush=True)
    lora = lora_state_dict(rec["trainable"]["flux"])
    still = [n for n, v in lora.items() if n.endswith("lora_b")
             and not bool(v.detach().abs().max() > 0)]
    changed = [k for k, v in _byte_sums(torch, rec["frozen"]).items()
               if v != rec["sums0"][k]]
    print(f"  LoRA B factors moved: {sum(n.endswith('lora_b') for n in lora) - len(still)}"
          f" of {sum(n.endswith('lora_b') for n in lora)}; frozen leaves "
          f"changed: {len(changed)} of {len(rec['sums0'])}", flush=True)
    if still or changed:
        raise Failure(f"train CLI: LoRA B unmoved {still}, frozen changed "
                      f"{changed[:5]}")
    rec = None
    gc.collect()
    torch.cuda.empty_cache()

    # second run: resume at step 2, run to step 3
    rec = run(["--max_steps", str(TRAIN_CLI_MAX_STEPS[1])])
    if "error" in rec:
        raise Failure(f"train CLI run 2: {rec['error']}")
    print(f"  run 2: {rec['summary']}", flush=True)
    resumed = rec["resumed"]
    print("  resume: " + "; ".join(f"step {s}, loaded in {dt:.2f} s, "
                                   f"{len(d)} tensors differ from the save"
                                   for s, dt, d in resumed), flush=True)
    if ([s for s, _, _ in resumed] != [TRAIN_CLI_MAX_STEPS[0]]
            or resumed[0][2]
            or rec["summary"]["steps"] != TRAIN_CLI_MAX_STEPS[1]
            or len(rec["micro"]) + ("profile" in rec) != 4):
        raise Failure(f"train CLI run 2: resumed {resumed}, summary "
                      f"{rec['summary']}, {len(rec['micro'])} micro-batches")
    rec = None
    gc.collect()
    torch.cuda.empty_cache()

    # third run: another LoRA rank under the same save_path is refused
    yml8 = write_train_config(root, ckpt, jsonl, runs, r=8, lora_alpha=8)
    rec = _train_cli_run(torch, ["--config", yml8, "--no_wandb",
                                 "--max_steps", "3"], saved)
    err = str(rec.get("error", ""))
    print(f"  run 3 (lora r 8): {err[:160]}", flush=True)
    if "fingerprint" not in err:
        raise Failure(f"train CLI run 3 not refused: {rec.get('summary')}")
    return counts


# ---------------------------------------------------------------------------
# Phase "multi-GPU (one card)": parallel/ in child processes on the one card
# ---------------------------------------------------------------------------

# the TP 2 forward's velocity against the unsharded one's (relative L2):
# phase 3's bounds, 1e-2 after the first double and single block
# weight-only, 5e-2 through all 57 blocks W8A8 (gross faults only: any
# change of bf16 rounding moves that velocity by about 3.4e-2, the rounding
# floor printed beside)
TP_SHALLOW_REL_L2, TP_FULL_REL_L2 = 1e-2, 5e-2
TP_EDIT_STEPS = 3
TP_EDIT_TOL = 2  # uint8: the TP 2 edit against the single edit at its steps
# the profiler's name for device copies: gloo's all_reduce of a CUDA tensor
# copies it to the host and back
TP_COPY_GROUP = "Memcpy"
# seconds a group of ranks may take before it is stopped and the run fails
MULTI_TIMEOUTS = {"nccl": 240.0, "tp2": 360.0, "data2": 240.0}


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output kept: (result, lines)."""
    import io
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = fn(*args)
    return out, log.getvalue().splitlines()


def _rank_nccl(rank, job):
    """(a) World 1 over NCCL, as ``torchrun --nproc-per-node 1`` starts it:
    `make_mesh` from the environment, an all_reduce on the card, then
    ``cli.infer.main`` in that process group: phase 4's first request and
    the second CLI request, each as a single image."""
    import torch
    import torch.distributed as dist
    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    t = torch.full((4,), 3.0, device=mesh.device)
    dist.all_reduce(t)
    out = {"backend": dist.get_backend(), "mesh": dict(mesh.shape),
           "device": str(mesh.device), "all_reduce": t.tolist()}
    with _env(LOONGX_W8A8="1"):
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        _, out["single_log"] = _quiet(infer.main, job["single"][0])
        out["single_s"] = time.perf_counter() - t0
        out["single_counts"] = dict(cuda_build.LAUNCHES)
        _, out["second_log"] = _quiet(infer.main, job["single"][1])
    dist.destroy_process_group()
    return out


def _tp_inputs(torch, cfg, device):
    """Phase 3's forward inputs at S 2560 (512 text, 1024 image and 1024
    condition tokens), from seed 7."""
    from loongx_tpu_torch.ops.latents import latent_image_ids

    gen = torch.Generator(device=device).manual_seed(7)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(bf)

    return dict(img=randn(1, 1024, cfg.in_channels),
                txt=randn(1, 512, cfg.joint_dim), pooled=randn(1, cfg.pooled_dim),
                cond=randn(1, 1024, cfg.in_channels),
                timestep=torch.full((1,), 0.7, device=device),
                guidance=torch.full((1,), 3.5, device=device),
                img_ids=latent_image_ids(64, 64, device=device),
                cond_ids=latent_image_ids(64, 64, device=device),
                txt_ids=torch.zeros(512, 3, device=device))


def _rank_tp2(rank, job):
    """(b) Tensor 2 over gloo, both ranks on cuda:0.  Each rank makes the
    full-width TP-layout int8 bundle from phase 3's seed and keeps its
    shard; rank 0 first takes the unsharded references on the whole tree
    (the unit-gain velocity after 1 + 1 blocks weight-only and after 57
    blocks W8A8, each with its rounding floor, and a TP_EDIT_STEPS-step
    edit of phase 4's first request).  Then the TP forward (its launches,
    seconds, peak memory), a second TP forward under the profiler (this
    rank's device time: kernels, and the copies gloo makes of each
    all_reduce's operand), and the TP edit."""
    import numpy as np
    import torch
    from loongx_tpu_torch.models.flux.model import flux_forward
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.ops.quant import quantized_bytes
    from loongx_tpu_torch.parallel import make_mesh, shard_params
    from loongx_tpu_torch.parallel.mesh import mesh_context, tp_context
    from loongx_tpu_torch.precision import set_precision
    from loongx_tpu_torch.sampling import generate

    set_precision()
    mesh = make_mesh(data=1, tensor=2, backend="gloo", device="cuda:0")
    dev = mesh.device
    t0 = time.perf_counter()
    pipe = LoongXPipeline.init_serving(seed=0, device=dev, tp_layout=True)
    cfg = pipe.flux_cfg
    shallow = dataclasses.replace(cfg, num_double_blocks=1, num_single_blocks=1)
    kw = _tp_inputs(torch, cfg, dev)
    ug = unit_gain(torch, pipe.params["flux"])
    out = {"mesh": (dict(mesh.shape), mesh.tensor_index),
           "bundle_bytes": quantized_bytes(pipe.params["flux"])}

    def host(v):
        return v.float().cpu().numpy()

    with torch.inference_mode():
        if rank == 0:
            for name, depth, w8a8 in (("full", cfg, True),
                                      ("shallow", shallow, False)):
                out[f"v_{name}"] = host(flux_forward(ug, depth, w8a8=w8a8,
                                                     **kw))
                with plain_versions():
                    v_p = flux_forward(ug, depth, w8a8=w8a8, **kw)
                with plain_versions(attention_fp32_probs):
                    v_f = flux_forward(ug, depth, w8a8=w8a8, **kw)
                out[f"floor_{name}"] = rel_l2(v_f, v_p)
                del v_p, v_f
            out["img_single"] = generate.neural_edit(
                pipe, **job["req"], num_inference_steps=TP_EDIT_STEPS,
                w8a8=True)
    ug = shard_params(ug, mesh)
    pipe.params = shard_params(pipe.params, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["shard_bytes"] = quantized_bytes(pipe.params["flux"])
    out["build_s"] = time.perf_counter() - t0
    with torch.inference_mode(), tp_context(mesh):
        flux_forward(ug, shallow, **kw)  # warm: the group's first exchanges
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        v = flux_forward(ug, cfg, w8a8=True, **kw)
        torch.cuda.synchronize()
        out["forward_s"] = time.perf_counter() - t0
        out["forward_counts"] = dict(cuda_build.LAUNCHES)
        out["forward_peak"] = torch.cuda.max_memory_allocated(dev)
        out["v_tp_full"] = host(v)
        out["v_tp_shallow"] = host(flux_forward(ug, shallow, **kw))
        out["forward_profile"] = _profile(
            lambda: flux_forward(ug, cfg, w8a8=True, **kw),
            (*PROFILE_GROUPS, TP_COPY_GROUP))
    del ug, v
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_build.LAUNCHES.clear()
    t0 = time.perf_counter()
    with mesh_context(mesh):
        out["img_tp"] = generate.neural_edit(
            pipe, **job["req"], num_inference_steps=TP_EDIT_STEPS, w8a8=True)
    out["edit_s"] = time.perf_counter() - t0
    out["edit_counts"] = dict(cuda_build.LAUNCHES)
    out["edit_peak"] = torch.cuda.max_memory_allocated(dev)
    out["finite"] = bool(np.isfinite(out["img_tp"]).all())
    return out


def _rank_data2(rank, job):
    """(c) Data 2 over gloo, both ranks on cuda:0: ``cli.infer.main`` over
    a directory of two requests, one row a rank."""
    import torch
    import torch.distributed as dist
    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.parallel import make_mesh

    mesh = make_mesh(backend="gloo", device="cuda:0")
    out = {"mesh": (dict(mesh.shape), mesh.data_index)}
    with _env(LOONGX_W8A8="1"):
        torch.cuda.reset_peak_memory_stats(mesh.device)
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        _, out["log"] = _quiet(infer.main, job["dir"])
        out["seconds"] = time.perf_counter() - t0
        out["counts"] = dict(cuda_build.LAUNCHES)
        out["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    dist.destroy_process_group()
    return out


def _ranks(fn, world, job, what, timeouts=MULTI_TIMEOUTS):
    """`spawn_ranks` with the phase's timeout for ``what``; any rank's
    failure, a hang past the timeout or a non-zero exit fails the run."""
    from loongx_tpu_torch.parallel.launch import spawn_ranks

    t0 = time.perf_counter()
    try:
        out = spawn_ranks(fn, world, (job,), timeout=timeouts[what])
    except RuntimeError as exc:
        raise Failure(f"multi-GPU {what}: {exc}") from exc
    print(f"  {what}: {world} rank(s) done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _png(path):
    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.int32)


def _written(log):
    return [os.path.basename(line.split("] ")[-1]) for line in log
            if line.startswith("[infer] [")]


def multi_gpu(torch, paths, img_ref, req):
    """Phase "multi-GPU (one card)": ``parallel/`` through child processes
    started with the spawn method (`parallel.launch.spawn_ranks`), each
    group within MULTI_TIMEOUTS:

      (a) NCCL at world size 1 (`make_mesh` from torchrun's environment):
          an all_reduce on the card, a 1 x 1 mesh, and ``cli.infer.main``
          in that group, whose single edit must equal phase 4's first
          request bit for bit (and the second request's single edit, the
          reference of (c));
      (b) tensor 2 over gloo, two ranks on the one card (NCCL refuses
          that): each rank's shard of the full-width FLUX.1-dev TP-layout
          int8 bundle, one W8A8 forward at S 2560 whose velocity (the same
          on both ranks) must be within TP_FULL_REL_L2 of the unsharded
          forward (TP_SHALLOW_REL_L2 after 1 + 1 blocks weight-only), every
          flash and GEMM launch of each rank on its Hopper route, peak
          memory a rank; then a TP_EDIT_STEPS-step TP edit of phase 4's
          first request within TP_EDIT_TOL of the single edit;
      (c) data 2 over gloo on the one card: ``cli.infer.main`` over two
          requests, one a rank, each image equal bit for bit to that
          request's single edit from (a).

    Two ranks share one card here: the seconds are not a multi-card
    speed.  Returns the launches by run and rank."""
    import numpy as np

    t_phase = time.perf_counter()
    root, size = paths["root"], img_ref.shape[1]
    blocks = 57  # FLUX.1-dev: 19 double + 38 single
    two = os.path.join(root, "in_two")
    os.makedirs(two)
    for name in ("req1.png", "req2.png"):
        shutil.copy(os.path.join(paths["in_dir"], name), two)
    single = os.path.join(root, "mg_single")
    data2 = os.path.join(root, "mg_data2")
    ref = ((np.clip(img_ref[0], -1, 1) + 1) * 127.5).round().astype(np.int32)

    # (a)
    common = cli_args(paths, size, "cuda")
    a = _ranks(_rank_nccl, 1, {"single": [
        common + ["--single_image", os.path.join(two, name), "--prompt", "",
                  "--output_dir", single] for name in ("req1.png", "req2.png")]},
        "nccl")[0]
    got = _png(os.path.join(single, "req1.png"))
    diff = np.abs(got - ref)
    print(f"  (a) NCCL world 1: backend {a['backend']}, mesh {a['mesh']} on "
          f"{a['device']}, all_reduce {a['all_reduce']}; cli.infer single edit "
          f"{a['single_s']:.2f} s, against phase 4's first request: "
          f"{int((diff > 0).sum())} values differ (max {int(diff.max())})",
          flush=True)
    if (a["backend"] != "nccl" or a["mesh"] != {"data": 1, "tensor": 1}
            or a["all_reduce"] != [3.0] * 4):
        raise Failure(f"NCCL world 1: {a['backend']}, {a['mesh']}, "
                      f"{a['all_reduce']}")
    if got.shape != ref.shape or diff.any():
        raise Failure(f"the single edit through NCCL differs from phase 4's "
                      f"in {int((diff > 0).sum())} values")
    _cli_launch_check(a["single_counts"], blocks, "(a) NCCL single edit")

    # (b)
    b = _ranks(_rank_tp2, 2, {"req": req}, "tp2")
    r0 = b[0]
    for r in (1,):
        if not (np.array_equal(b[r]["v_tp_full"], r0["v_tp_full"])
                and np.array_equal(b[r]["img_tp"], r0["img_tp"])):
            raise Failure(f"TP 2: rank {r}'s velocity or image differs from "
                          "rank 0's")
    tv = {n: torch.from_numpy(r0[f"v_tp_{n}"]) for n in ("full", "shallow")}
    rels = {n: rel_l2(tv[n], torch.from_numpy(r0[f"v_{n}"])) for n in tv}
    finite_v = all(bool(torch.isfinite(t).all()) for t in tv.values())
    print(f"  (b) TP 2 over gloo on one card (mesh {r0['mesh'][0]}): bundle "
          f"{r0['bundle_bytes'] / 1e9:.2f} GB, a rank's shard "
          f"{r0['shard_bytes'] / 1e9:.2f} GB, made and sharded in "
          f"{r0['build_s']:.1f} s; velocity against the unsharded forward: "
          f"rel L2 {rels['full']:.3e} through 19+38 blocks W8A8 (bound "
          f"{TP_FULL_REL_L2:.0e}; rounding floor {r0['floor_full']:.3e}), "
          f"{rels['shallow']:.3e} after 1+1 blocks weight-only (bound "
          f"{TP_SHALLOW_REL_L2:.0e}; floor {r0['floor_shallow']:.3e}); finite "
          f"{finite_v}", flush=True)
    for r, res in enumerate(b):
        print(f"  (b) rank {r}: TP forward {res['forward_s'] * 1e3:.1f} ms "
              f"(two ranks on one card, gloo through the host), peak "
              f"{res['forward_peak'] / 1e9:.2f} GB; TP edit "
              f"{res['edit_s']:.2f} s for {TP_EDIT_STEPS} steps, peak "
              f"{res['edit_peak'] / 1e9:.2f} GB", flush=True)
        prof = res["forward_profile"]
        if prof is None:
            print(f"  (b) rank {r}: the profiled TP forward: no device activity "
                  "recorded (device time not measured)", flush=True)
        else:
            copies = prof["by_group_ms"].get(TP_COPY_GROUP, 0.0)
            print(f"  (b) rank {r}: profiled TP forward: busy "
                  f"{prof['busy_ms']:.3f} ms (kernels "
                  f"{prof['busy_ms'] - copies:.3f}, copies {copies:.3f}) of a "
                  f"{prof['span_ms']:.3f} ms span, idle share "
                  f"{prof['idle_share']:.4f}, {prof['kernels']} device events "
                  "(the other rank's work fills this rank's gaps)", flush=True)
            print("  (b) rank %d: TP forward by group (ms): %s" % (r, json.dumps(
                {k: round(v, 4) for k, v in prof["by_group_ms"].items()})),
                flush=True)
        _cli_launch_check(res["forward_counts"], blocks,
                          f"(b) rank {r} TP forward", steps=1)
        _cli_launch_check(res["edit_counts"], blocks, f"(b) rank {r} TP edit",
                          steps=TP_EDIT_STEPS)
    if not (finite_v and rels["full"] <= TP_FULL_REL_L2
            and rels["shallow"] <= TP_SHALLOW_REL_L2):
        raise Failure(f"TP 2 velocity: rel L2 {rels}, finite {finite_v}")
    u8 = [((np.clip(x[0], -1, 1) + 1) * 127.5).round().astype(np.int32)
          for x in (r0["img_tp"], r0["img_single"])]
    ediff = np.abs(u8[0] - u8[1])
    print(f"  (b) TP edit ({TP_EDIT_STEPS} steps, 512x512) against the single "
          f"edit: max {int(ediff.max())} (limit {TP_EDIT_TOL}), "
          f"{int((ediff > 0).sum())} values differ; finite {r0['finite']}",
          flush=True)
    if not r0["finite"] or r0["img_tp"].shape != (1, 512, 512, 3) or (
            ediff.max() > TP_EDIT_TOL):
        raise Failure(f"TP edit: max diff {int(ediff.max())}, finite "
                      f"{r0['finite']}")

    # (c)
    c = _ranks(_rank_data2, 2, {
        "dir": cli_args(paths, size, "cuda:0") + ["--input_dir", two,
                                                  "--output_dir", data2]},
        "data2")
    for r, res in enumerate(c):
        name = f"req{r + 1}.png"
        d = np.abs(_png(os.path.join(data2, name))
                   - _png(os.path.join(single, name)))
        print(f"  (c) data rank {r} (mesh {res['mesh'][0]}): wrote "
              f"{_written(res['log'])} in {res['seconds']:.2f} s, peak "
              f"{res['peak'] / 1e9:.2f} GB; {name} against its single edit: "
              f"{int((d > 0).sum())} values differ", flush=True)
        if _written(res["log"]) != [name] or d.any():
            raise Failure(f"data rank {r}: wrote {_written(res['log'])}, "
                          f"{int((d > 0).sum())} values differ from the "
                          "single edit")
        _cli_launch_check(res["counts"], blocks, f"(c) data rank {r}")
    print(f"  multi-GPU phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"nccl single": a["single_counts"],
            **{f"tp2 rank{r}": res["edit_counts"] for r, res in enumerate(b)},
            **{f"data2 rank{r}": res["counts"] for r, res in enumerate(c)}}


# ---------------------------------------------------------------------------
# Phase "train under a mesh (one card)": the seed_512 step over data 2 and
# over tensor 2, and cli.train.main over data 2, two ranks on the one card
# ---------------------------------------------------------------------------

# every LoRA leaf's gradient against the one-process step's (relative L2):
# data 2 sums the ranks' bf16 gradients in float32 where one process sums
# its rows inside one product (a few bf16 roundings, well under 1e-2);
# tensor 2 moves the bf16 rounding of every split's partial sums through
# 57 blocks, the kernels-vs-plain floor printed beside (5e-2: the limit)
MESH_DATA_REL_L2, MESH_TP_REL_L2 = 1e-2, 5e-2
MESH_LOSS_RTOL = 1e-3  # data 2: the mean of two row means against one mean
MESH_TIMEOUTS = {"step": 600.0, "cli": 420.0}
MESH_CLI_BLOCKS = (2, 4)  # the CLI run's DiT depth (double, single) at full width
MESH_CLI_T5_LAYERS = 2  # and T5-XXL's (its width whole)
MESH_CLI_STEPS = (1, 2)  # optimizer steps of 2 micro-batches: the run, the resume
MESH_INFER_STEPS = 4
MESH_LORA_B_STD = 0.01  # the step's B factors, moved off zero


def _mesh_train_batch(torch, dev):
    """Phase 5's seed_512 batch at a global batch of 2 (512 px: S 1024 +
    1024 condition + 512 text tokens), from seed 7."""
    from loongx_tpu_torch.ops.latents import latent_image_ids

    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    ids = latent_image_ids(64, 64, device=dev)
    return dict(x0=rand(2, 1024, 64), cond_tokens=rand(2, 1024, 64),
                prompt_embeds=rand(2, 512, 4096, scale=0.1),
                pooled=rand(2, 768, scale=0.1), img_ids=ids, cond_ids=ids,
                txt_ids=torch.zeros(512, 3, device=dev),
                eeg=rand(2, 4, 4096), ppg=rand(2, 4, 256), fnirs=rand(2, 6, 512),
                motion=rand(2, 6, 128))


def _rank_mesh_step(rank, job):
    """(a)-(c): both ranks on cuda:0 over gloo, each with the seed_512 QLoRA
    tree made from seed 0 (full FLUX.1-dev int8, LoRA r 4, CS3 + DGF,
    Prodigy, clip 0.5, remat, bf16).  Every micro-step starts from the same
    LoRA leaves (B moved off zero, so that A has gradients too) with a
    fresh optimizer and the draw generator seeded 11, and records the
    gradients its optimizer is handed.  Rank 0 first takes
    the one-process references on the whole tree: the step at batch 2, at
    batch 1, and at batch 1 through the plain versions (the rounding
    floor).  Then (a) data 2, one row a rank; (b) tensor 2 at batch 1, the
    frozen tree sharded, twice (the second timed); (c) each micro-step's
    launches."""
    import torch
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.parallel import make_mesh, shard_batch, shard_params
    from loongx_tpu_torch.parallel.mesh import mesh_context, tree_paths
    from loongx_tpu_torch.precision import set_precision
    from loongx_tpu_torch.train.optim import build_optimizer
    from loongx_tpu_torch.train.step import (
        make_train_step, partition, trainable_mask,
    )

    set_precision()
    data2 = make_mesh(data=2, tensor=1, backend="gloo", device="cuda:0")
    tensor2 = make_mesh(data=1, tensor=2, backend="gloo", device="cuda:0")
    dev = data2.device
    t0 = time.perf_counter()
    pipe = LoongXPipeline.init_training(seed=0, device=dev)
    cfg = pipe.flux_cfg
    trainable, frozen = partition(pipe.params, trainable_mask(pipe.params))
    pipe = None
    paths = [p for p, leaf in tree_paths(trainable) if leaf is not None]
    # B off zero (peft's init), alike on both ranks: A gets gradients too,
    # and every leaf's tensor sum is held to the one process's
    gen_b = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        for p, leaf in tree_paths(trainable):
            if p.endswith("lora_b"):
                leaf.copy_(torch.randn(leaf.shape, generator=gen_b,
                                       device=dev) * MESH_LORA_B_STD)
    leaves0 = [leaf.detach().clone() for p, leaf in tree_paths(trainable)
               if leaf is not None]
    batch = _mesh_train_batch(torch, dev)
    ids = ("img_ids", "txt_ids", "cond_ids")
    row0 = {k: v if k in ids else v[:1] for k, v in batch.items()}
    out = {"build_s": time.perf_counter() - t0}

    def step(frozen_, batch_, mesh=None):
        seen = []

        def optimizer(params):
            opt = build_optimizer(SEED_512_OPTIMIZER)(params)
            take = opt.step

            def recorded(*a, **kw):
                seen.extend(p.grad.detach().float().clone() for p in params)
                return take(*a, **kw)

            opt.step = recorded
            return opt

        init_fn, step_fn = make_train_step(
            cfg, optimizer, flags=SEED_512_FLAGS, use_brain_condition=True,
            fuse_flag=True, remat=True, grad_clip=0.5, dtype=torch.bfloat16)
        state = init_fn(trainable)
        for p, p0 in zip(state.optimizer.param_groups[0]["params"], leaves0):
            p.data.copy_(p0)
        gen = torch.Generator(device=dev).manual_seed(11)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with (mesh_context(mesh) if mesh else contextlib.nullcontext()):
            _, m = step_fn(state, frozen_, batch_, gen)
        torch.cuda.synchronize()
        return {"s": time.perf_counter() - t0, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "counts": dict(cuda_build.LAUNCHES),
                "peak": torch.cuda.max_memory_allocated(dev),
                "grads": dict(zip(paths, seen))}

    def compare(got, want):
        return {p: rel_l2(got["grads"][p], g) for p, g in want["grads"].items()
                if bool(g.abs().max() > 0)}

    ref2 = ref1 = None
    if rank == 0:
        ref2 = step(frozen, batch)
        ref1 = step(frozen, row0)
        with plain_versions():
            plain1 = step(frozen, row0)
        out["floor"] = compare(plain1, ref1)
        out["ref"] = {k: (r["loss"], r["grad_norm"], r["s"])
                      for k, r in (("batch2", ref2), ("batch1", ref1),
                                   ("plain batch1", plain1))}
        del plain1
    # (a) data 2, one row a rank, both ranks starting together
    torch.distributed.barrier()
    d2 = step(frozen, shard_batch({k: v for k, v in batch.items()
                                   if k not in ids}, data2) | {
        k: batch[k] for k in ids}, data2)
    out["data2"] = {k: d2[k] for k in ("s", "loss", "grad_norm", "counts",
                                       "peak")}
    if rank == 0:
        out["data2"]["rel"] = compare(d2, ref2)
        out["data2"]["ref"] = (ref2["loss"], ref2["grad_norm"])
    del d2, ref2
    # (b) tensor 2 at batch 1: the rank keeps its shard of the frozen tree
    frozen = shard_params(frozen, tensor2)
    gc.collect()
    torch.cuda.empty_cache()
    out["shard_bytes"] = torch.cuda.memory_allocated(dev)
    step(frozen, row0, tensor2)  # warm: the group's first exchanges
    t2 = step(frozen, row0, tensor2)
    out["tensor2"] = {k: t2[k] for k in ("s", "loss", "grad_norm", "counts",
                                         "peak")}
    if rank == 0:
        out["tensor2"]["rel"] = compare(t2, ref1)
        out["tensor2"]["ref"] = (ref1["loss"], ref1["grad_norm"])
    return out


def mesh_cli_bundle(torch):
    """The training bundle of phase "train CLI" at the CLI run's depth
    (MESH_CLI_BLOCKS, T5-XXL's width at MESH_CLI_T5_LAYERS layers)."""
    from loongx_tpu_torch.models import pipeline as pipeline_mod
    from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
    from loongx_tpu_torch.models.flux.vae import VAEConfig, init_vae_params
    from loongx_tpu_torch.models.text.t5 import T5Config
    from loongx_tpu_torch.ops.quant import random_quantized_like

    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = dataclasses.replace(FluxConfig.flux_dev(),
                              num_double_blocks=MESH_CLI_BLOCKS[0],
                              num_single_blocks=MESH_CLI_BLOCKS[1])
    vae_cfg = VAEConfig.flux()
    flux = random_quantized_like(
        init_flux_params(cfg, dtype=torch.bfloat16, device="meta"),
        generator=gen, device="cuda")
    kw = dict(generator=gen, dtype=torch.bfloat16, device="cuda")
    params = {"flux": flux, "vae": init_vae_params(vae_cfg, **kw),
              **pipeline_mod._brain_params(kw)}
    pipe = pipeline_mod.LoongXPipeline(cfg, vae_cfg, params, torch.bfloat16)
    return pipe.add_text_encoders(
        T5Config(num_layers=MESH_CLI_T5_LAYERS), seed=3)


def _rank_mesh_cli(rank, job):
    """(d) ``cli.train.main`` in a data-2 group over gloo (both ranks on
    cuda:0, the group joined first as torchrun's environment describes it):
    MESH_CLI_STEPS[0] optimizer steps from scratch, then a resume to
    MESH_CLI_STEPS[1].  The rank's file writes, train-state loads, probes
    and launches are recorded."""
    import torch
    from loongx_tpu_torch.cli import train as cli_train
    from loongx_tpu_torch.ops import cuda_build
    from loongx_tpu_torch.parallel import make_mesh
    from loongx_tpu_torch.train.sampling_probe import SampleProbe
    from loongx_tpu_torch.utils import checkpoint

    mesh = make_mesh(backend="gloo", device="cuda:0")
    out = {"mesh": (dict(mesh.shape), mesh.data_index)}
    rec = {"saves": [], "lora_saves": [], "loads": [], "probes": []}

    def note(key):
        def wrap(orig):
            def call(*a, **kw):
                res = orig(*a, **kw)
                rec[key].append(res)
                return res
            return call
        return wrap

    with contextlib.ExitStack() as stack:
        for obj, name, key in (
                (checkpoint, "save_train_checkpoint", "saves"),
                (checkpoint, "save_lora_safetensors", "lora_saves"),
                (checkpoint, "load_train_checkpoint", "loads"),
                (SampleProbe, "__call__", "probes")):
            stack.enter_context(_patched(obj, name, note(key)))
        for i, (steps, extra) in enumerate(zip(MESH_CLI_STEPS,
                                               (["--no_resume"], []))):
            torch.cuda.reset_peak_memory_stats(mesh.device)
            cuda_build.LAUNCHES.clear()
            t0 = time.perf_counter()
            summary, log = _quiet(cli_train.main, job["argv"] + [
                "--max_steps", str(steps)] + extra)
            out[f"run{i + 1}"] = {
                "summary": summary, "s": time.perf_counter() - t0,
                "counts": dict(cuda_build.LAUNCHES),
                "peak": torch.cuda.max_memory_allocated(mesh.device),
                "log": log}
    out.update(rec)
    return out


def mesh_train(torch, paths):
    """Phase "train under a mesh (one card)": ``train/`` under
    `parallel.mesh_context` through child processes started with the spawn
    method (`parallel.launch.spawn_ranks`), two ranks on the one card over
    gloo (NCCL refuses two ranks on one card), each group within
    MESH_TIMEOUTS:

      (a) data 2: one seed_512 micro-step at full FLUX.1-dev width and
          depth, one row a rank, against the one-process step at batch 2:
          loss, grad norm, and every LoRA leaf's gradient within
          MESH_DATA_REL_L2;
      (b) tensor 2: one micro-step at batch 1, each rank with its shard of
          the frozen tree, against the one-process batch-1 step: every LoRA
          leaf's gradient within MESH_TP_REL_L2 beside the kernels-vs-plain
          floor; seconds a micro-step and peak memory a rank;
      (c) each rank's launches of both micro-steps: every flash forward and
          backward, stacked weight-only and transposed GEMM on wgmma, none
          on mma.sync;
      (d) ``cli.train.main`` from configs/seed_512.yaml with ``mesh: {data:
          2}`` at MESH_CLI_BLOCKS' depth: one optimizer step of 2
          micro-batches a rank, then a resume to step 2 (every rank loading
          the step-1 train state); only rank 0 writes (LoRA files, train
          states, the probe image at step 1, rendered by rank 0 alone: data
          row 0); then ``cli.infer`` serves the rank-0 LoRA file of step 2.

    Two ranks share one card: the seconds are not a multi-card speed.
    Returns the launches by micro-step and rank."""
    import tempfile
    import yaml
    from PIL import Image
    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.ops.quant import quantized_bytes
    from loongx_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    res = _ranks(_rank_mesh_step, 2, {}, "step", MESH_TIMEOUTS)
    r0 = res[0]
    ref2, ref1, plain1 = (r0["ref"][k] for k in ("batch2", "batch1",
                                                  "plain batch1"))
    print(f"  trees made in {r0['build_s']:.1f} s a rank; one process: batch 2 "
          f"loss {ref2[0]:.6f} grad norm {ref2[1]:.6e} ({ref2[2]:.3f} s); "
          f"batch 1 loss {ref1[0]:.6f} grad norm {ref1[1]:.6e} ({ref1[2]:.3f} "
          f"s); plain versions at batch 1 loss {plain1[0]:.6f} grad norm "
          f"{plain1[1]:.6e} ({plain1[2]:.3f} s)", flush=True)
    floor = max(r0["floor"].values())
    for what, bound in (("data2", MESH_DATA_REL_L2), ("tensor2", MESH_TP_REL_L2)):
        rels = r0[what]["rel"]
        worst = max(rels, key=rels.get)
        print(f"  ({'a' if what == 'data2' else 'b'}) {what}: loss "
              f"{[r[what]['loss'] for r in res]} (one process "
              f"{r0[what]['ref'][0]:.6f}), grad norm "
              f"{[r[what]['grad_norm'] for r in res]} (one process "
              f"{r0[what]['ref'][1]:.6e}); LoRA gradients rel L2 max "
              f"{rels[worst]:.3e} ({worst}), median "
              f"{sorted(rels.values())[len(rels) // 2]:.3e} over {len(rels)} "
              f"leaves (bound {bound:.0e}; kernels-vs-plain floor at batch 1: "
              f"max {floor:.3e}, median "
              f"{sorted(r0['floor'].values())[len(rels) // 2]:.3e})", flush=True)
        for r, x in enumerate(res):
            print(f"  ({'a' if what == 'data2' else 'b'}) rank {r}: "
                  f"{x[what]['s']:.3f} s a micro-step, peak "
                  f"{x[what]['peak'] / 2 ** 30:.2f} GiB (two ranks on one card, "
                  "gloo through the host)", flush=True)
            _micro_check(x[what]["counts"], f"(c) {what} rank {r}")
        print(f"  (c) {what} launches a rank: "
              f"{[{n: x[what]['counts'].get(n, 0) for n in TRAIN_KERNELS} for x in res]}",
              flush=True)
        same = all(x[what]["loss"] == r0[what]["loss"]
                   and x[what]["grad_norm"] == r0[what]["grad_norm"] for x in res)
        lossdiff = abs(r0[what]["loss"] - r0[what]["ref"][0]) / abs(
            r0[what]["ref"][0])
        if not (same and rels[worst] <= bound and math.isfinite(r0[what]["loss"])
                and (what != "data2" or lossdiff <= MESH_LOSS_RTOL)):
            raise Failure(f"train under a mesh, {what}: ranks agree {same}, "
                          f"worst rel L2 {rels[worst]} ({worst}; bound {bound}),"
                          f" loss {r0[what]['loss']} against {r0[what]['ref']}")
    print(f"  (b) a rank's shard of the tree {r0['shard_bytes'] / 1e9:.2f} GB "
          "allocated after sharding", flush=True)
    launches = {f"mesh {what} rank{r}": x[what]["counts"]
                for what in ("data2", "tensor2") for r, x in enumerate(res)}
    res = r0 = None

    # (d)
    t0 = time.perf_counter()
    pipe = mesh_cli_bundle(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    need = quantized_bytes(pipe.params) + CLI_DISK_MARGIN
    if shutil.disk_usage(here).free < need:
        raise Failure(f"{shutil.disk_usage(here).free} bytes free at {here}, "
                      f"{need} needed for the training checkpoint")
    root = tempfile.mkdtemp(prefix=".chip_smoke_mesh_", dir=here)
    try:
        ckpt = os.path.join(root, "ckpt")
        checkpoint.save_pipeline(pipe, ckpt)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        write_char_tokenizers(ckpt)
        jsonl = write_train_corpus(os.path.join(root, "data"))
        runs = os.path.join(root, "runs")
        with open(write_train_config(root, ckpt, jsonl, runs)) as f:
            raw = yaml.safe_load(f)
        raw["mesh"] = {"data": 2}
        raw["train"].update(accumulate_grad_batches=2, sample_interval=1)
        yml = os.path.join(root, "train_mesh.yaml")
        with open(yml, "w") as f:
            yaml.safe_dump(raw, f)
        print(f"  (d) bundle ({MESH_CLI_BLOCKS[0]}+{MESH_CLI_BLOCKS[1]} blocks, "
              f"T5-XXL {MESH_CLI_T5_LAYERS} layers) written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cli = _ranks(_rank_mesh_cli, 2, {"argv": [
            "--config", yml, "--no_wandb", "--device", "cuda:0"]}, "cli",
            MESH_TIMEOUTS)
        for r, x in enumerate(cli):
            for i, steps in enumerate(MESH_CLI_STEPS):
                run = x[f"run{i + 1}"]
                print(f"  (d) rank {r} (mesh {x['mesh'][0]}) run {i + 1}: "
                      f"{run['summary']}, {run['s']:.1f} s, peak "
                      f"{run['peak'] / 2 ** 30:.2f} GiB", flush=True)
                if run["summary"]["steps"] != steps or not math.isfinite(
                        run["summary"]["final_loss"]):
                    raise Failure(f"train CLI under data 2, rank {r} run "
                                  f"{i + 1}: {run['summary']}")
                _micro_check(run["counts"], f"(d) rank {r} run {i + 1}")
            loaded = x["loads"]
            writes = (len(x["saves"]), len(x["lora_saves"]), len(x["probes"]))
            print(f"  (d) rank {r}: train states {len(x['saves'])}, LoRA files "
                  f"{len(x['lora_saves'])}, probes {len(x['probes'])} "
                  f"({x['probes']}), resumed at step {loaded}", flush=True)
            want = (2, 2, 2) if r == 0 else (0, 0, 0)
            if writes != want or loaded != [MESH_CLI_STEPS[0]]:
                raise Failure(f"train CLI under data 2, rank {r}: writes "
                              f"{writes} (want {want}), resumed at {loaded}")
            launches[f"mesh cli rank{r}"] = x["run1"]["counts"]
        lora = [p for p in cli[0]["lora_saves"]
                if os.path.basename(os.path.dirname(p)) == str(MESH_CLI_STEPS[1])]
        probe = cli[0]["probes"][0]
        if not (len(lora) == 1 and Image.open(probe).size == (
                TRAIN_CLI_SIZE, TRAIN_CLI_SIZE)):
            raise Failure(f"train CLI under data 2: LoRA files {lora}, probe "
                          f"{probe}")
        served = os.path.join(root, "served")
        t0 = time.perf_counter()
        _, log = _quiet(infer.main, cli_args(
            dict(paths, ckpt=ckpt), TRAIN_CLI_SIZE, "cuda") + [
            "--single_image", paths["image"], "--prompt", "", "--lora", lora[0],
            "--steps", str(MESH_INFER_STEPS), "--output_dir", served])
        img = _png(os.path.join(served, os.path.basename(paths["image"])))
        print(f"  (d) cli.infer served the rank-0 LoRA file of step "
              f"{MESH_CLI_STEPS[1]} ({MESH_INFER_STEPS} steps, "
              f"{time.perf_counter() - t0:.1f} s): {img.shape}; "
              + "; ".join(line for line in log if "LoRA" in line), flush=True)
        if img.shape != (TRAIN_CLI_SIZE, TRAIN_CLI_SIZE, 3) or not any(
                "live deltas" in line for line in log):
            raise Failure(f"cli.infer on the mesh-trained LoRA: {img.shape}, "
                          f"{log[-3:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  train under a mesh phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def kernel_table(records, launches):
    """One entry per kernel: the worst error over its cases and the times
    at its main shape; launches from the run of its path.  The weight-only
    GEMM on wgmma has an entry of its own beside its contracts' (its
    cases: every weight-only case the route sends to it; its launches: the
    training step's stacked ones)."""
    csrc = "loongx_tpu_torch/csrc/"
    fa_py = "loongx_tpu/ops/flash_attention.py"
    qmm_py = "loongx_tpu/ops/quant_matmul.py"
    # name: (source, replaces, main case, path whose launches count)
    meta = {
        "flash_attention": ("flash_attention.cu", f"{fa_py}:193", "S2560 union",
                            "serve"),
        # the rotation of q and k inside _fwd_kernel (_rope_rotate :178), a
        # pre-pass of the wgmma forward
        "flash_rope": ("flash_attention.cu", f"{fa_py}:178", "S2560 union",
                       "serve"),
        "qmm_stacked": ("quant_matmul.cu", f"{qmm_py}:422",
                        "single mlp gelu w8a8", "serve"),
        "qmm_qkv_stacked": ("quant_matmul.cu", f"{qmm_py}:1067", "single w8a8",
                            "serve"),
        "qmm_flat": ("quant_matmul.cu", f"{qmm_py}:75", "context_embedder w8a8",
                     "serve"),
        # the activation quantization inside the TPU kernels' W8A8 MAC
        "qmm_act_quant": ("quant_matmul.cu", f"{qmm_py}:39",
                          "M2560 K3072 group 3072", "serve"),
        # the weight-only MAC (_accum_tile :53-57) of _qmm_stacked_kernel
        # (and of :1067 and :75), on bf16 wgmma
        "qmm_wonly": ("quant_matmul.cu", f"{qmm_py}:422",
                      "single mlp gelu wonly", "train"),
        # the flat GEMM at N below one tile (proj_out), split K over a
        # thread-block cluster: its cases are qmm_flat's on that route
        "qmm_splitk": ("quant_matmul.cu", f"{qmm_py}:75", "proj_out w8a8",
                       "serve"),
        "qmm_t": ("quant_matmul_t.cu", f"{qmm_py}:192", "proj_out", "train"),
        "qmm_t_stacked": ("quant_matmul_t.cu", f"{qmm_py}:711", "sgl proj_mlp",
                          "train"),
        "flash_bwd_dkv": ("flash_attention.cu", f"{fa_py}:593", "S2560 union",
                          "train"),
        "flash_bwd_dq": ("flash_attention.cu", f"{fa_py}:656", "S2560 union",
                         "train"),
        # the flat GEMM at K of one 64-wide panel (x_embedder), both modes,
        # W8A8 quantized in the kernel: its cases are qmm_flat's on that route
        "qmm_k64": ("quant_matmul.cu", f"{qmm_py}:75", "x_embedder w8a8",
                    "serve"),
        # the S4D recurrence as a chunked scan; its launches are the
        # s4d_scan entry's on the chunked route
        "s4d_chunk_scan": ("s4d_scan.cu", "loongx_tpu/ops/s4_pallas.py:30",
                           "EEG wide", "serve s4_mode=pallas"),
        # the int8 QK^T mode of _fwd_kernel (:228-291) and its pre-pass (the
        # q and k quantization of _quant :228)
        "flash_attention_int8": ("flash_attention.cu", f"{fa_py}:193",
                                 "S2560 union", "serve int8_attn"),
        "flash_kquant": ("flash_attention.cu", f"{fa_py}:228", "S2560 union",
                         "serve int8_attn"),
        # the fused-elementwise forms of kernels 2 and 3: the LN + adaLN
        # prologue (_ln_mod_prologue, run at :447 and :1086), its W8A8
        # quantization (the prologue's output into _accum_tile :39) and the
        # gate + residual epilogue (_gate_res_epilogue, run at :461)
        "qmm_stacked_ln": ("quant_matmul.cu", f"{qmm_py}:392",
                           "single mlp gelu w8a8", "serve fuse_ln+fuse_gate"),
        "qmm_qkv_stacked_ln": ("quant_matmul.cu", f"{qmm_py}:1086",
                               "img+cond w8a8", "serve fuse_ln+fuse_gate"),
        "qmm_act_quant_ln": ("quant_matmul.cu", f"{qmm_py}:447",
                             "LN M2560 K3072", "serve fuse_ln+fuse_gate"),
        "qmm_stacked_gate": ("quant_matmul.cu", f"{qmm_py}:413",
                             "single proj K12288 w8a8",
                             "serve fuse_ln+fuse_gate"),
        # the prologue's row stats (_ln_mean_rstd, in XLA beside the kernel),
        # both routes (launches_by_route), the block kernel's device time
        # beside
        "qmm_ln_stats": ("quant_matmul.cu", f"{qmm_py}:566", "M2560 K3072",
                         "serve fuse_ln+fuse_gate"),
        # the weight-only prologue (_ln_mod_prologue :392, run at :447 and
        # :1086) as a pass ahead of the weight-only GEMM on wgmma
        "qmm_ln_mod_pass": ("quant_matmul.cu", f"{qmm_py}:392", "M2560 K3072",
                            "train fuse_ln"),
        # HiDream-I1's expert path (no TPU kernel: the JAX package runs no
        # HiDream), its launches those of one step in phase "HiDream step";
        # both grouped GEMM epilogues count under moe_gemm; the main case is
        # each kernel's first (the single block's routed layer)
        **{name: ("moe_gemm.cu", None, None, "hidream step")
           for name in ("moe_route", "moe_plan", "moe_quant", "moe_gemm_swiglu",
                        "moe_gemm_rows", "moe_combine")},
    }
    table = []
    for name, (src, replaces, main_case, path) in meta.items():
        if name == "qmm_wonly":
            counter = "qmm_stacked"
            cases = [r for r in records if r["case"].endswith(" wonly")
                     and r.get("route") == "wgmma" and r["kernel"] in (
                         "qmm_stacked", "qmm_qkv_stacked", "qmm_flat",
                         "qmm_stacked_gate", "qmm_stacked_ln",
                         "qmm_qkv_stacked_ln")]
        elif name in ("qmm_splitk", "qmm_k64"):
            counter = "qmm_flat"
            cases = [r for r in records if r["kernel"] == "qmm_flat"
                     and r.get("route") == name[4:]]
        elif name.startswith("moe_gemm_"):
            counter = "moe_gemm"
            cases = [r for r in records if r["kernel"] == name]
        elif name == "s4d_chunk_scan":
            counter = "s4d_scan"
            cases = [r for r in records if r["kernel"] == name]
        else:
            counter = name
            cases = [r for r in records if r["kernel"] == name]
        main = next(r for r in cases if main_case in (None, r["case"]))
        by_route = {r: launches[path].get(f"{counter}:{r}", 0)
                    for r in (*GEMM_ROUTES, "warp", "block", "chunked",
                              "sequential")
                    if f"{counter}:{r}" in launches[path]}
        own_route = {"qmm_splitk": "splitk", "qmm_k64": "k64",
                     "s4d_chunk_scan": "chunked"}.get(name)

        def count(counts):
            return (counts.get(f"{counter}:{own_route}", 0) if own_route
                    else counts.get(counter, 0))

        table.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": count(launches[path]),
            "launches_path": path,
            # the same kernel's launches in the train CLI's first run and in
            # the depth-conditioned CLI edit
            "launches_train_cli": count(launches["train CLI"]),
            "launches_depth_edit": count(launches["depth edit"]),
            # and in phase "speech and demos": the speech demo's edit and
            # the web demo's
            "launches_speech_edit": count(launches["speech edit"]),
            "launches_web_demo": count(launches["web demo"]),
            # phase "multi-GPU (one card)": the NCCL world-1 single edit,
            # the TP 2 edit and the data 2 CLI run, by rank
            "launches_nccl_single": count(launches["nccl single"]),
            "launches_tp2_ranks": [count(launches[f"tp2 rank{r}"])
                                   for r in range(2)],
            "launches_data2_ranks": [count(launches[f"data2 rank{r}"])
                                     for r in range(2)],
            # phase "train under a mesh (one card)": one micro-step over
            # data 2 and over tensor 2, the CLI's first run over data 2
            "launches_mesh_train_ranks": {
                what: [count(launches[f"mesh {what} rank{r}"])
                       for r in range(2)]
                for what in ("data2", "tensor2", "cli")},
            "max_abs_err": max(r["err"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main_case,
            **{key: main[key] for key in ("device_ms", "gemm_device_ms", "unfused_ms",
                                          "mma_sync_ms", "mma_sync_device_ms",
                                          "mma_sync_flips", "block_device_ms",
                                          "library_device_ms", "cublas_bf16_ms",
                                          "cublas_bf16_device_ms", "probe_mma",
                                          "probe_loop", "probe_epilogue",
                                          "prescale_ms", "sequential_ms",
                                          "sequential_device_ms", "chain_bound_ms")
               if key in main},
            **({"kernel": main["route"]} if "route" in main else {}),
            **({"launches_by_route": by_route} if any(by_route.values()) else {}),
            # phase 2 at the shard shapes a rank of tensor 2 runs
            **({"tp2_shard_shapes": {
                r["case"]: {k: r[k] for k in ("m", "k", "n", "ms", "plain_ms",
                                              "library_ms", "bound_ms",
                                              "bound_by") if k in r}
                for r in cases if r["case"].startswith("tp2 ")}}
               if any(r["case"].startswith("tp2 ") for r in cases) else {}),
        })
    return table


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from loongx_tpu_torch.ops import cuda_build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})",
              file=sys.stderr)
        return 2
    from loongx_tpu_torch.precision import set_precision
    set_precision()

    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    records = []
    try:
        with Phase("1 build", card):
            t0 = time.perf_counter()
            cuda_build.build()
            print(f"  built {', '.join(cuda_build.SOURCES)} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        with Phase("2 kernels vs plain", card):
            check_flash(torch, gen, records)
            check_qmm(torch, gen, records)
            # a generator of its own keeps phase 3's inputs as they were
            check_act_quant(torch, torch.Generator(device="cuda").manual_seed(4),
                            records, act_quant_cases())
            check_qmm_t(torch, gen, records)
            check_flash_bwd(torch, gen, records)
            # a generator of their own keeps phase 3's inputs as they were
            gen_new = torch.Generator(device="cuda").manual_seed(3)
            check_s4d(torch, gen_new, records)
            check_flash_int8(torch, gen_new, records)
            check_t5_gemms(torch, gen_new, records)
            check_fused(torch, gen_new, records)
            gen_ln = torch.Generator(device="cuda").manual_seed(6)
            check_ln_stats(torch, gen_ln, records)
            check_ln_mod_pass(torch, gen_ln, records)
            check_tp2_shapes(torch, torch.Generator(device="cuda").manual_seed(8),
                             records)
            check_tp2_backward(torch, torch.Generator(device="cuda").manual_seed(9),
                               records)
            check_moe(torch, torch.Generator(device="cuda").manual_seed(10), records)
        with Phase("HiDream step", card):
            hidream_counts, _ = hidream_step(torch)
        from loongx_tpu_torch.models.pipeline import LoongXPipeline
        with Phase("weights", card):
            pipe = LoongXPipeline.init_serving(seed=0)
        with Phase("3 full-width forward and LoRA gradients", card):
            kw = full_forward(torch, pipe, gen)
            lora_grads(torch, gen, kw)
        with Phase("4 serve", card):
            counts, options, req0, img0 = serve(torch, pipe)
            launches = {"serve": counts,
                        "serve s4_mode=pallas": options["s4_mode=pallas"],
                        "serve int8_attn": options["int8_attn"],
                        "serve fuse_ln+fuse_gate": options["fuse_ln+fuse_gate"],
                        "hidream step": hidream_counts}
        with Phase("generate (text prompts, fuse mode)", card):
            text_bytes = serve_text(torch, pipe)
        with Phase("speech and demos", card):
            speech = speech_and_demos(torch, pipe)
            launches["speech edit"] = speech["speech edit"]
            launches["web demo"] = speech["web demo"]
            free_text_encoders(torch, pipe, text_bytes)
        root = None
        try:
            with Phase("infer CLI", card):
                root = cli_workdir(pipe)
                cli_inputs = write_cli_inputs(torch, pipe, req0, root)
                pipe = kw = None  # free the serving bundle: the CLI loads it
                gc.collect()
                torch.cuda.empty_cache()
                infer_cli(torch, cli_inputs, img0)
            with Phase("evaluate and depth", card):
                launches["depth edit"] = depth_edit(torch, cli_inputs)
                eval_parity(torch, cli_inputs)
            with Phase("5 train", card):
                launches["train"], launches["train fuse_ln"] = train(torch)
            with Phase("train CLI", card):
                launches["train CLI"] = train_cli(torch)
            with Phase("multi-GPU (one card)", card):
                gc.collect()
                torch.cuda.empty_cache()  # the ranks share the card
                launches.update(multi_gpu(torch, cli_inputs, img0, req0))
            with Phase("train under a mesh (one card)", card):
                gc.collect()
                torch.cuda.empty_cache()
                launches.update(mesh_train(torch, cli_inputs))
        finally:
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": kernel_table(records, launches)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
