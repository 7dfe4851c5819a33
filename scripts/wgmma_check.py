#!/usr/bin/env python3
"""Quick card check of the port's wgmma kernels, much shorter than
``chip_smoke.py``: each against its plain version at a few small shapes
and one serving or training shape, and timed beside the ``mma.sync``
kernel it replaces at one or two of those shapes.  Needs one CUDA card and
nvcc.

    python3 scripts/wgmma_check.py build [source ...]  # nvcc -Xptxas -v: registers, spills
    python3 scripts/wgmma_check.py qmm     # the W8A8 GEMM
    python3 scripts/wgmma_check.py probe   # the W8A8 pipeline's stage probe and ring depths
    python3 scripts/wgmma_check.py image DIR  # a served edit's image equal to checkout DIR's
    python3 scripts/wgmma_check.py wo      # the weight-only GEMM on bf16 wgmma
    python3 scripts/wgmma_check.py qmm_t   # the transposed GEMM on bf16 wgmma
    python3 scripts/wgmma_check.py flash   # the flash forward (+ RoPE pre-pass)
    python3 scripts/wgmma_check.py bwd     # the flash backward (dK/dV and dQ)
    python3 scripts/wgmma_check.py int8    # the int8 QK^T forward on s8 wgmma (+ its pre-pass)
    python3 scripts/wgmma_check.py actq    # the W8A8 activation pass (warp per group)
    python3 scripts/wgmma_check.py ln      # the row stats, the prologue pass, the fused forms
    python3 scripts/wgmma_check.py narrow  # the N 64 GEMMs: split-K forward, narrow backward
    python3 scripts/wgmma_check.py k64     # the K 64 GEMM (x_embedder), W8A8 quantized in it
    python3 scripts/wgmma_check.py s4d     # the chunked S4D scan beside the sequential kernel

k64 and s4d also time probes: the kernel built apart with a -D flag that cuts
it short (``K64_PROBE_PREP``, ``S4D_PROBE_STOP``; wrong results), so that the
time of the part cut away shows.  probe builds the W8A8 pipeline with
``-DW8A8_PROBE`` (clock64 cycles of each phase, the results unchanged) and
with shallower rings (``-DW8A8_STAGES=``), for the dense and the grouped
GEMM.
"""

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (  # noqa: E402
    act_quant_cases, check_act_quant, check_fused, check_ln_mod_pass, check_ln_stats,
    cuda_time_ms, device_ms, prescale_ms, probe_entries, read_stage_probe, stage_probe,
)
from loongx_tpu_torch.ops import cuda_build  # noqa: E402


def build(names=cuda_build.SOURCES):
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        out = cuda_build.BUILD_DIR / f"{name}-ptxas-check.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas=-v", "-o", str(out),
               str(cuda_build.CSRC_DIR / f"{name}.cu")]
        t0 = time.time()
        r = subprocess.run(cmd, capture_output=True, text=True)
        print(f"{name}: rc {r.returncode}, {time.time() - t0:.1f} s", flush=True)
        lines = (r.stdout + r.stderr).splitlines()
        for i, line in enumerate(lines):
            if "error" in line.lower() or "warning" in line.lower():
                print("  ", line)
            if "Compiling entry function" in line and any(
                    w in line for w in ("wgmma", "rope", "prescale", "kquant", "act_quant", "ln_",
                                        "splitk", "narrow", "k64", "chunk")):
                print("  ", line.split("'")[1])
                print("\n".join("     " + x for x in lines[i + 1:i + 4]))


def check_qmm(gen):
    from loongx_tpu_torch.ops import quant_matmul as qmm
    for m, k, n, act in [(256, 512, 256, None), (300, 3072, 384, "gelu_tanh"),
                         (2, 3072, 1024, None), (512, 12288, 256, None),
                         (2560, 3072, 12288, "gelu_tanh")]:
        wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda",
                           generator=gen)
        sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = torch.randn(2, 1, n, generator=gen, device="cuda") * 0.02
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        group, k_pad = qmm.stacked_w8a8_group(k, n)

        def run():
            return qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act,
                                            w8a8=True)
        ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, True, group, k_pad)
        out = run()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2.0 ** -7 * ref.float().abs().max().item()
        if not err <= tol or (act and not torch.equal(out, ref)):
            FAILED.append(f"qmm M{m} K{k} N{n} {act}")
        print(f"qmm M{m} K{k} N{n} {act}: route "
              f"{qmm.qmm_route(k, n, group, k_pad, True)}, err {err:.3e} (tol {tol:.3e}), "
              f"outputs differing {int((out != ref).sum().item())}", flush=True)
    t_new = cuda_time_ms(run)
    with cuda_build.mma_sync_only():
        t_old = cuda_time_ms(run)
    print(f"M{m} K{k} N{n} {act}: wgmma {t_new:.3f} ms, mma.sync {t_old:.3f} ms", flush=True)


FAILED = []


def tile_waves(run_at, label):
    """Device ms at M 512 (96 output tiles of 128 x 128 at N 3072: under one
    wave on 132 SMs) and at M 2048 (384 tiles), each per tile."""
    for m in (512, 2048):
        t = device_ms(run_at(m))
        tiles = (m // 128) * 24
        print(f"   {label} M{m} K3072 N3072: {t:.4f} ms device time, {tiles} tiles, "
              f"{t / tiles * 1e3:.3f} us per tile", flush=True)


def _report(what, out, ref):
    """Print the error against one bf16 rounding of the plain version's output."""
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
    if not err <= tol:
        FAILED.append(what)
    print(f"{what}: err {err:.3e} (tol {tol:.3e}){'' if err <= tol else '  FAILED'}",
          flush=True)


def check_wo(gen):
    from loongx_tpu_torch.ops import quant_matmul as qmm
    cases = [(256, 512, 256, None, "bias"), (300, 3072, 384, "gelu_tanh", "bias"),
             (1000, 3072, 1024, "gelu_tanh", "gate"), (2, 3072, 1024, None, "bias"),
             (200, 256, 3072, None, "flat"), (300, 3072, 3 * 256, None, "qkv"),
             (2560, 3072, 12288, "gelu_tanh", "bias"), (512, 4096, 10240, "gelu_tanh", "bias")]
    for m, k, n, act, form in cases:
        wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda",
                           generator=gen)
        sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = torch.randn(2, 1, n, generator=gen, device="cuda") * 0.02
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        if form == "qkv":
            norm_w = torch.rand(3, n // 3, generator=gen, device="cuda") + 0.5

            def run():
                return torch.stack(qmm.quant_qkv_stacked(x, wq, sc, bi, norm_w, 1, 128))
            ref = torch.stack(qmm.quant_qkv_plain(x, wq[1], sc[1], bi[1], norm_w, 128))
        elif form == "gate":
            resid = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
            gate = torch.randn(8, n, generator=gen, device="cuda") * 0.5

            def run():
                return qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act,
                                                resid=resid, gate=gate, seg_boundary=m // 3)
            ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, resid=resid, gate=gate,
                                seg_boundary=m // 3)
        elif form == "flat":
            def run():
                return qmm.quant_matmul(x, wq[0], sc[0], bias=bi[0])
            ref = qmm.qmm_plain(x, wq[0], sc[0], bi[0])
        else:
            def run():
                return qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act)
            ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act)
        out = run()
        with cuda_build.mma_sync_only():
            old = run()
        torch.cuda.synchronize()
        _report(f"wo M{m} K{k} N{n} {act} {form} route {qmm.qmm_route(k, n, k, k, False)}",
                out, ref)
        _report("   mma.sync", old, ref)
        if m >= 512 or m == 2:
            t_new = cuda_time_ms(run)
            with cuda_build.mma_sync_only():
                t_old = cuda_time_ms(run)
            wb = wq[1].to(torch.bfloat16)
            t_lib = cuda_time_ms(lambda: torch.matmul(x, wb))
            print(f"   wgmma {t_new:.3f} ms, mma.sync {t_old:.3f} ms, cuBLAS bf16 "
                  f"{t_lib:.3f} ms", flush=True)
    # the widening's share at the main shape: the same GEMM with the weight fragments left
    # unwidened (qmm_gemm_bf16_wgmma's widen = 0; its output is wrong and not read)
    import ctypes
    fn = cuda_build.library("quant_matmul").qmm_gemm_bf16_wgmma
    fn.argtypes, fn.restype = qmm._BF16_WGMMA_SIGNATURE, ctypes.c_int

    def gemm(x, wq, sc, out, widen, epi=qmm.EPI_BIAS):
        m, k = x.shape
        cuda_build.check(fn(epi, x.data_ptr(), wq.data_ptr(), sc.data_ptr(), None, None, None,
                            None, out.data_ptr(), m, k, wq.shape[1], 0, 0, 0, widen,
                            torch.cuda.current_stream().cuda_stream), "qmm_gemm_bf16_wgmma")
    m, k, n = 2560, 3072, 12288
    wq = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(n, generator=gen, device="cuda")
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    t1, t0 = (device_ms(lambda: gemm(x, wq, sc, out, w)) for w in (1, 0))
    print(f"   M{m} K{k} N{n} device time {t1:.3f} ms, unwidened {t0:.3f} ms: widening share "
          f"{1 - t0 / t1:.2f}", flush=True)

    def at(m):
        xm = torch.randn(m, 3072, generator=gen, device="cuda").to(torch.bfloat16)
        w3 = torch.randint(-128, 128, (3072, 3072), dtype=torch.int8, device="cuda",
                           generator=gen)
        om = torch.empty(m, 3072, dtype=torch.bfloat16, device="cuda")
        return lambda: gemm(xm, w3, sc, om, 1)
    tile_waves(at, "wo")


def check_qmm_t(gen):
    from loongx_tpu_torch.ops import quant_matmul as qmm
    for m, k, n in [(256, 256, 384), (300, 512, 1024), (1000, 3072, 12288),
                    (2560, 3072, 12288), (2560, 15360, 3072), (1024, 3072, 64)]:
        wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda",
                           generator=gen)
        sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)

        def run():
            return qmm.quant_matmul_t_stacked(dy, wq, sc, 1)
        ref = qmm.qmm_t_plain(dy, wq[1], sc[1])
        out = run()
        with cuda_build.mma_sync_only():
            old = run()
        torch.cuda.synchronize()
        _report(f"qmm_t dy [{m}, {n}] -> dx [{m}, {k}] route {qmm.qmm_t_route(k, n)}",
                out, ref)
        _report("   mma.sync", old, ref)
        if m >= 1000:
            t_new = cuda_time_ms(run)
            with cuda_build.mma_sync_only():
                t_old = cuda_time_ms(run)
            a = (dy.float() * sc[1].reshape(-1)).to(torch.bfloat16)
            wb = wq[1].to(torch.bfloat16)
            t_lib = cuda_time_ms(lambda: torch.matmul(a, wb.t()))
            t_pre = prescale_ms(torch, dy, sc[1]) if n % 64 == 0 else float("nan")
            print(f"   wgmma {t_new:.3f} ms (its pre-scale pass {t_pre:.4f}), mma.sync "
                  f"{t_old:.3f} ms, cuBLAS bf16 {t_lib:.3f} ms", flush=True)
    # the widening's share at proj_mlp: the same call with the weight fragments left unwidened
    # (qmm_t_gemm_wgmma's widen = 0; its output is wrong and not read)
    import ctypes
    fn = cuda_build.library("quant_matmul_t").qmm_t_gemm_wgmma
    fn.argtypes, fn.restype = qmm._T_WGMMA_SIGNATURE, ctypes.c_int

    def gemm(dy, wq, sc, widen):
        m, n = dy.shape
        k = wq.shape[0]
        a = torch.empty_like(dy)
        dx = torch.empty(m, k, dtype=torch.bfloat16, device="cuda")
        return lambda: cuda_build.check(fn(
            dy.data_ptr(), wq.data_ptr(), sc.data_ptr(), a.data_ptr(), dx.data_ptr(), m, k, n,
            widen, torch.cuda.current_stream().cuda_stream), "qmm_t_gemm_wgmma")
    m, k, n = 2560, 3072, 12288
    wq = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(n, generator=gen, device="cuda")
    dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    t1, t0 = (device_ms(gemm(dy, wq, sc, w)) for w in (1, 0))
    print(f"   dy [{m}, {n}] -> dx [{m}, {k}] device time (pre-scale pass included) {t1:.3f} "
          f"ms, unwidened {t0:.3f} ms: widening share {1 - t0 / t1:.2f}", flush=True)

    def at(m):
        d = torch.randn(m, 3072, generator=gen, device="cuda").to(torch.bfloat16)
        w3 = torch.randint(-128, 128, (3072, 3072), dtype=torch.int8, device="cuda",
                           generator=gen)
        return gemm(d, w3, sc[:3072], 1)
    tile_waves(at, "qmm_t (pre-scale pass included)")



def check_flash(gen):
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.rope import rope_embed
    h, d = 4, 128
    for s, c, mode, cf, layout in [(256, 0, "union", None, "bhsd"),
                                   (300, 77, "no_union", None, "bshd"),
                                   (2000, 700, "independent", None, "bshd"),
                                   (640, 256, "union", 0.5, "bshd")]:
        shape = (1, s, h, d) if layout == "bshd" else (1, h, s, d)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        rope = rope_embed((torch.rand(s, 3, generator=gen, device="cuda") * 64).floor())
        for rp in (None, rope):
            kw = dict(cond_start=s - c, mode=mode, c_factor=cf, rope=rp, layout=layout)
            out = fa.flash_attention(q, k, v, **kw).float()
            ref = fa.flash_attention_plain(q, k, v, **kw).float()
            print(f"flash S{s} {mode} c_factor {cf} {layout} rope {rp is not None}: err "
                  f"{(out - ref).abs().max().item():.3e} (tol "
                  f"{2.0 ** -5 * ref.abs().max().item():.3e})", flush=True)
    s, h = 2560, 24
    q, k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    kw = dict(cond_start=1536, rope=rope_embed(torch.zeros(s, 3, device="cuda")),
              layout="bshd")
    t_new = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    with cuda_build.mma_sync_only():
        t_old = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
    print(f"flash S{s} H{h} union: wgmma {t_new:.3f} ms (RoPE pre-pass included), "
          f"mma.sync {t_old:.3f} ms", flush=True)


def check_bwd(gen):
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.rope import rope_embed
    h, d = 4, 128
    for b, s, c, mode, layout, use_rope in [(1, 256, 0, "union", "bhsd", False),
                                            (2, 300, 77, "no_union", "bshd", True),
                                            (1, 2000, 700, "independent", "bshd", True),
                                            (2, 1000, 300, "union", "bhsd", True),
                                            (1, 640, 256, "independent", "bhsd", False)]:
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        rope = None
        if use_rope:
            rope = rope_embed((torch.rand(s, 3, generator=gen, device="cuda") * 64).floor())
        o, m2, l = fa._forward(q, k, v, s - c, mode, None, rope, layout, save_residuals=True)
        args = (q, k, v, do, m2, l, fa._row_dot(o, do, layout))
        kw = dict(cond_start=s - c, mode=mode, rope=rope, layout=layout)
        ref = fa.flash_attention_bwd_plain(*args, **kw)
        got = fa.flash_attention_bwd(*args, **kw)
        with cuda_build.mma_sync_only():
            old = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        for route, res in (("wgmma", got), ("mma_sync", old)):
            print(f"bwd B{b} S{s} {mode} {layout} rope {use_rope} {route}: " + ", ".join(
                f"{n} err {(x.float() - r.float()).abs().max().item():.3e} (tol "
                f"{2.0 ** -5 * r.float().abs().max().item():.3e})"
                for n, x, r in zip(("dq", "dk", "dv"), res, ref)), flush=True)
    s, h = 2560, 24
    q, k, v, do = (torch.randn(1, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    rope = rope_embed((torch.rand(s, 3, generator=gen, device="cuda") * 64).floor())
    o, m2, l = fa._forward(q, k, v, 1536, "union", None, rope, "bshd", save_residuals=True)
    args = (q, k, v, do, m2, l, fa._row_dot(o, do, "bshd"))
    kw = dict(cond_start=1536, rope=rope, layout="bshd")
    qk_rot = fa.flash_rope(q, k, rope, "bshd")
    t_dkv = cuda_time_ms(lambda: fa.flash_attention_bwd(*args, **kw, need_dq=False,
                                                        qk_rot=qk_rot))
    t_dq = cuda_time_ms(lambda: fa.flash_attention_bwd(*args, **kw, need_dkv=False,
                                                       qk_rot=qk_rot))
    with cuda_build.mma_sync_only():
        o_dkv = cuda_time_ms(lambda: fa.flash_attention_bwd(*args, **kw, need_dq=False))
        o_dq = cuda_time_ms(lambda: fa.flash_attention_bwd(*args, **kw, need_dkv=False))
    print(f"bwd S{s} H{h} union bshd rope: wgmma dK/dV {t_dkv:.3f} ms, dQ {t_dq:.3f} ms; "
          f"mma.sync dK/dV {o_dkv:.3f}, dQ {o_dq:.3f}", flush=True)


def check_int8(gen):
    """The int8 QK^T forward: each route against the plain version (flash bound 2^-5 max|ref|,
    rel L2 1e-2) and the outputs that differ between the two routes, at small shapes in every
    mode (the last two with explicit key tiles: spans of 128, the wgmma route, and of 192, the
    mma.sync route); the pre-pass's codes and scales exactly; then the times at S 2560 and
    8704, 24 heads: each route through the wrapper and by device time, split into its
    pre-pass and its forward kernel."""
    from loongx_tpu_torch.ops import flash_attention as fa
    from loongx_tpu_torch.ops.attention import int8_key_span
    from loongx_tpu_torch.ops.rope import rope_embed
    h, d = 4, 128
    for b, s, c, mode, cf, layout, bk in [(1, 256, 0, "union", None, "bhsd", None),
                                          (1, 300, 77, "no_union", None, "bshd", None),
                                          (2, 1000, 300, "independent", None, "bhsd", None),
                                          (2, 640, 256, "union", 0.5, "bshd", None),
                                          (1, 384, 128, "union", None, "bhsd", 128),
                                          (1, 384, 128, "no_union", None, "bshd", 192)]:
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        rope = rope_embed((torch.rand(s, 3, generator=gen, device="cuda") * 64).floor())
        span = int8_key_span(s, bk)
        pre = fa.flash_int8_prepass(q, k, span=span, rope=rope, layout=layout)
        pre_ref = fa.flash_int8_prepass_plain(q, k, span=span, rope=rope, layout=layout)
        n_diff = sum(int((a != r).sum().item()) for a, r in zip(pre, pre_ref))
        kw = dict(cond_start=s - c, mode=mode, c_factor=cf, rope=rope, layout=layout,
                  int8_attn=True, block_k=bk)
        out = fa.flash_attention(q, k, v, **kw).float()
        with cuda_build.mma_sync_only():
            old = fa.flash_attention(q, k, v, **kw).float()
        ref = fa.flash_attention_plain(q, k, v, **kw).float()
        tol = 2.0 ** -5 * ref.abs().max().item()
        errs = [(x - ref).abs().max().item() for x in (out, old)]
        rels = [((x - ref).norm() / ref.norm()).item() for x in (out, old)]
        ok = n_diff == 0 and max(errs) <= tol and max(rels) <= 1e-2
        if not ok:
            FAILED.append(f"int8 B{b} S{s} {mode}")
        print(f"int8 B{b} S{s} {mode} c_factor {cf} {layout} span {span} route "
              f"{fa.flash_int8_route(d, span)}: pre-pass values differing {n_diff}; err "
              f"{errs[0]:.3e} (mma.sync {errs[1]:.3e}, tol {tol:.3e}), rel L2 {rels[0]:.2e} "
              f"({rels[1]:.2e}); outputs differing from mma.sync "
              f"{int((out != old).sum().item())} of {out.numel()}{'' if ok else '  FAILED'}",
              flush=True)
    h = 24
    for s, c in ((2560, 1024), (8704, 4096)):
        q, k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        rope = rope_embed((torch.rand(s, 3, generator=gen, device="cuda") * 64).floor())
        kw = dict(cond_start=s - c, rope=rope, layout="bshd")

        def run():
            return fa.flash_attention(q, k, v, int8_attn=True, **kw)
        t = cuda_time_ms(run)
        dev, dev_pre = device_ms(run), device_ms(run, match="kquant")
        with cuda_build.mma_sync_only():
            t_old = cuda_time_ms(run)
            old, old_pre = device_ms(run), device_ms(run, match="kquant")
        t_bf16 = cuda_time_ms(lambda: fa.flash_attention(q, k, v, **kw))
        print(f"int8 S{s} H{h} union bshd rope: wgmma {t:.3f} ms (passes included; device "
              f"{dev:.4f}, of which the pre-pass {dev_pre:.4f}), mma.sync {t_old:.3f} (device "
              f"{old:.4f}, k pass {old_pre:.4f}), bf16 scores on wgmma {t_bf16:.3f}", flush=True)


def check_actq(gen):
    """The W8A8 activation pass at every (K, group) pair of the served forward, ragged M and K
    and the LN form, exactly (chip_smoke's phase-2 check), with device times of both kernels."""
    records = []
    check_act_quant(torch, gen, records, act_quant_cases())


def check_ln(gen):
    """The row stats' warp kernel, the weight-only prologue pass and every fused form with its
    gradients (chip_smoke's phase-2 checks): the weight-only prologue forms on the pass + the
    wgmma GEMM beside the mma.sync form and the unfused route."""
    records = []
    check_ln_stats(torch, gen, records)
    check_ln_mod_pass(torch, gen, records)
    check_fused(torch, gen, records)


def check_narrow(gen):
    """The N below one tile GEMMs: the split-K forward (both modes; the flat contract, the
    stacked one and its gate form; N 16 to 112, one and two activation groups, a padded K,
    ragged M) against its plain version, its W8A8 outputs against the mma.sync kernel's
    exactly; the narrow transposed GEMM (N 16 to 64, ragged M); then device times at proj_out
    (M 1024 K 3072 N 64) beside the mma.sync kernels and the library calls."""
    from loongx_tpu_torch.ops import quant_matmul as qmm
    cases = [(1024, 3072, 64, None, "flat"), (1000, 3072, 64, "gelu_tanh", "flat"),
             (1, 3072, 64, None, "flat"), (300, 3072, 64, "gelu_tanh", "gate"),
             (257, 1024, 16, "gelu_tanh", "stacked"), (130, 2048, 48, None, "flat"),
             (200, 3072, 112, None, "gate"), (64, 4096, 80, None, "stacked")]
    for w8a8 in (True, False):
        for m, k, n, act, form in cases:
            wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda", generator=gen)
            sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
            bi = torch.randn(2, 1, n, generator=gen, device="cuda") * 0.02
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            fused = {}
            if form == "gate":
                fused = dict(resid=torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16),
                             gate=torch.randn(8, n, generator=gen, device="cuda") * 0.5,
                             seg_boundary=m // 3)
            if form == "flat":
                group, k_pad = qmm.flat_w8a8_group(k, n)

                def run():
                    return qmm.quant_matmul(x, wq[1], sc[1], bias=bi[1], activation=act, w8a8=w8a8)
            else:
                group, k_pad = qmm.stacked_w8a8_group(k, n)

                def run():
                    return qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act,
                                                    w8a8=w8a8, **fused)
            ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, w8a8, group, k_pad, **fused)
            out = run()
            with cuda_build.mma_sync_only():
                old = run()
            torch.cuda.synchronize()
            route = qmm.qmm_route(k, n, group, k_pad, w8a8)
            what = (f"{'w8a8' if w8a8 else 'wonly'} M{m} K{k} N{n} {act} {form} group {group} "
                    f"route {route} plan {qmm.splitk_plan(k, n, group, k_pad, w8a8)}")
            _report(what, out, ref)
            flips = int((out != old).sum().item())
            if w8a8 and flips:
                FAILED.append(f"{what}: {flips} outputs differ from mma.sync")
            print(f"   outputs differing from mma.sync {flips}{' (tol 0)' if w8a8 else ''}",
                  flush=True)
    m, k, n = 1024, 3072, 64
    wq = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
    bi = torch.randn(1, n, generator=gen, device="cuda") * 0.02
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    wb = wq.to(torch.bfloat16)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
    lib = device_ms(lambda: torch.matmul(x, wb))
    int_mm = device_ms(lambda: torch._int_mm(xq, wq))
    for w8a8 in (True, False):
        def run():
            return qmm.quant_matmul(x, wq, sc, bias=bi, w8a8=w8a8)
        new, gemm = device_ms(run), device_ms(run, match="splitk")
        with cuda_build.mma_sync_only():
            old = device_ms(run)
        print(f"proj_out M{m} K{k} N{n} {'w8a8' if w8a8 else 'wonly'}: split-K device {new:.4f} ms "
              f"(its GEMM {gemm:.4f}), mma.sync {old:.4f}, cuBLAS bf16 {lib:.4f}"
              + (f", torch._int_mm {int_mm:.4f}" if w8a8 else ""), flush=True)
    for m, k, n in [(1024, 3072, 64), (1000, 3072, 64), (300, 512, 32), (5, 256, 16)]:
        wq = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
        sc = torch.rand(1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)

        def run():
            return qmm.quant_matmul_t(dy, wq, sc)
        ref = qmm.qmm_t_plain(dy, wq, sc)
        out = run()
        with cuda_build.mma_sync_only():
            old = run()
        torch.cuda.synchronize()
        _report(f"qmm_t dy [{m}, {n}] -> dx [{m}, {k}] route {qmm.qmm_t_route(k, n)}", out, ref)
        _report("   mma.sync", old, ref)
        if m >= 1000:
            a = (dy.float() * sc.reshape(-1)).to(torch.bfloat16)
            wb = wq.to(torch.bfloat16)
            new = device_ms(run)
            with cuda_build.mma_sync_only():
                old_t = device_ms(run)
            lib_t = device_ms(lambda: torch.matmul(a, wb.t()))
            print(f"   device: narrow {new:.4f} ms, mma.sync {old_t:.4f}, cuBLAS bf16 on the "
                  f"pre-scaled dy {lib_t:.4f}", flush=True)


def check_k64(gen):
    """The K 64 GEMM in both modes (the flat contract at x_embedder and a ragged M, K 16-48,
    the stacked contract with gelu, the gate form and the prologue form, the fused-qkv
    planes) against its plain version, its W8A8 outputs against the mma.sync route's
    (activation pass + qmm_kernel) exactly; then device times at x_embedder (M 1024 K 64
    N 3072) beside the mma.sync route, cuBLAS bf16 and torch._int_mm."""
    from loongx_tpu_torch.ops import quant_matmul as qmm
    cases = [(1024, 64, 3072, None, "flat"), (1000, 64, 3072, None, "flat"),
             (300, 48, 256, "gelu_tanh", "flat"), (257, 16, 384, None, "flat"),
             (257, 64, 384, "gelu_tanh", "stacked"), (130, 64, 128, None, "gate"),
             (200, 64, 640, None, "ln"), (100, 64, 768, None, "qkv")]
    for w8a8 in (True, False):
        for m, k, n, act, form in cases:
            wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda", generator=gen)
            sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
            bi = torch.randn(2, 1, n, generator=gen, device="cuda") * 0.02
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            x[1] = 0.0  # x_scale 1
            x[2, :3] = torch.tensor([3.25, 1.625, -1.625])  # the W8A8 tie at absmax / 2
            x[2, 3:] = x[2, 3:].clamp(-3.0, 3.0)
            fused = {}
            if form == "gate":
                fused = dict(resid=torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16),
                             gate=torch.randn(8, n, generator=gen, device="cuda") * 0.5,
                             seg_boundary=m // 3)
            if form == "ln":
                ab = torch.randn(8, k, generator=gen, device="cuda") * 0.1
                ab[0] += 1.0
                ab[2] += 1.0
                fused = dict(ab=ab, seg_boundary=m // 2)
            group, k_pad = (qmm.flat_w8a8_group(k, n) if form == "flat"
                            else qmm.stacked_w8a8_group(k, n))
            if form == "flat":
                def run():
                    return qmm.quant_matmul(x, wq[1], sc[1], bias=bi[1], activation=act, w8a8=w8a8)
                ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, w8a8, group, k_pad)
            elif form == "qkv":
                norm_w = torch.rand(3, n // 3, generator=gen, device="cuda") + 0.5

                def run():
                    return torch.stack(qmm.quant_qkv_stacked(x, wq, sc, bi, norm_w, 1, 128,
                                                             w8a8=w8a8))
                ref = torch.stack(qmm.quant_qkv_plain(x, wq[1], sc[1], bi[1], norm_w, 128, w8a8,
                                                      group, k_pad))
            else:
                def run():
                    return qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act,
                                                    w8a8=w8a8, **fused)
                ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, w8a8, group, k_pad, **fused)
            out = run()
            with cuda_build.mma_sync_only():
                old = run()
            torch.cuda.synchronize()
            route = qmm.qmm_route(k, n, group, k_pad, w8a8, form == "ln")
            what = (f"{'w8a8' if w8a8 else 'wonly'} M{m} K{k} N{n} {act} {form} group {group} "
                    f"k_pad {k_pad} route {route}")
            _report(what, out, ref)
            flips = int((out != old).sum().item())
            exact = w8a8 and route == "k64"
            if exact and flips:
                FAILED.append(f"{what}: {flips} outputs differ from mma.sync")
            print(f"   outputs differing from the mma.sync route {flips}"
                  f"{' (tol 0)' if exact else ''}", flush=True)
    m, k, n = 1024, 64, 3072
    wq = torch.randint(-128, 128, (k, n), dtype=torch.int8, device="cuda", generator=gen)
    sc = torch.rand(1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
    bi = torch.randn(1, n, generator=gen, device="cuda") * 0.02
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    wb = wq.to(torch.bfloat16)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
    lib = device_ms(lambda: torch.matmul(x, wb))
    int_mm = device_ms(lambda: torch._int_mm(xq, wq))
    preps = probe_entries("quant_matmul", "qmm_gemm_k64", qmm._K64_SIGNATURE,
                          [f"K64_PROBE_PREP={prep}" for prep in (2, 1, 0)])
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for w8a8 in (True, False):
        def run():
            return qmm.quant_matmul(x, wq, sc, bias=bi, w8a8=w8a8)

        def probe(prep):
            fn = preps[f"K64_PROBE_PREP={prep}"]
            return lambda: cuda_build.check(fn(
                int(w8a8), qmm.EPI_BIAS, x.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                bi.data_ptr(), None, None, None, out.data_ptr(), m, k, n, 0, 0, 0,
                stream), "qmm_gemm_k64 probe")
        new = device_ms(run)
        with cuda_build.mma_sync_only():
            old = device_ms(run)
        probes = {prep: device_ms(probe(prep)) for prep in ((2, 1, 0) if w8a8 else (0,))}
        print(f"x_embedder M{m} K{k} N{n} {'w8a8' if w8a8 else 'wonly'}: k64 device {new:.4f} ms, "
              f"mma.sync route {old:.4f}, cuBLAS bf16 {lib:.4f}"
              + (f", torch._int_mm {int_mm:.4f}" if w8a8 else "")
              + f"; wrapper {cuda_time_ms(run):.4f}; probes (bit 0 transpose, bit 1 "
              f"quantize) {probes}", flush=True)
    for mm in (128, 256, 512, 2048):
        xm = torch.randn(mm, k, generator=gen, device="cuda").to(torch.bfloat16)
        for w8a8 in (True, False):
            t = device_ms(lambda: qmm.quant_matmul(xm, wq, sc, bias=bi, w8a8=w8a8))
            print(f"   M{mm}: k64 {'w8a8' if w8a8 else 'wonly'} device {t:.4f} ms", flush=True)


def check_s4d(gen):
    """The chunked S4D scan at every encoder layer (chip_smoke.s4d_cases), batch 2, a ragged L,
    bf16 u and N 64, against the plain recurrence (1e-4) and the FFT mode (1.8e-3 rel L2);
    device time and the whole call's beside the sequential kernel's."""
    from chip_smoke import S4D_ATOL, S4D_CONV_REL_L2, rel_l2, s4d_cases
    from loongx_tpu_torch.ops import s4 as ts4
    from loongx_tpu_torch.ops import s4_scan
    cases = s4d_cases() + [("EEG wide B2", 2, 4096, 64, 32), ("ragged L4001", 1, 4001, 64, 32),
                           ("N64", 1, 1024, 8, 64), ("fNIRS B3", 3, 512, 6, 3),
                           ("short L H16 N8", 1, 8, 16, 8), ("short L N64", 1, 8, 2, 64)]
    stops = probe_entries("s4d_scan", "s4d_chunk_scan", s4_scan._CHUNK_SIGNATURE,
                          [f"S4D_PROBE_STOP={stop}" for stop in (1, 2, 3)])

    def probe(stop, p, u, n):
        # s4_scan._chunked's call on the probe build
        b, length, h = u.shape
        plan = s4_scan.s4d_chunk_plan(length, h, n)
        y = torch.empty_like(u)
        planes = [p[k].float().contiguous() for k in ("log_A_real", "A_imag", "log_dt", "C", "D")]
        fn = stops[f"S4D_PROBE_STOP={stop}"]
        return lambda: cuda_build.check(fn(
            u.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in planes), b, length, h, n,
            plan.T, plan.C, plan.hb, plan.nq, plan.q, plan.cl, plan.threads,
            torch.cuda.current_stream().cuda_stream), "s4d_chunk_scan probe")

    for dtype in (torch.float32, torch.bfloat16):
        for label, b, length, h, n in cases:
            if dtype == torch.bfloat16 and label not in ("EEG wide", "motion"):
                continue
            p = ts4.init_s4d_layer(h, 2 * n, generator=gen, device="cuda")
            u = torch.randn(b, length, h, generator=gen, device="cuda").to(dtype)
            out = s4_scan.s4d_scan_recurrent(p, u)
            ref = s4_scan.s4d_scan_plain(p, u)
            with cuda_build.mma_sync_only():
                old = s4_scan.s4d_scan_recurrent(p, u)
            conv = ts4.s4d_conv(p, u)
            err = (out.float() - ref.float()).abs().max().item()
            old_err = (old.float() - ref.float()).abs().max().item()
            rel = rel_l2(out, conv)
            # bf16 y: one rounding of the output, and no bar against the FFT mode
            fp32 = dtype == torch.float32
            tol = S4D_ATOL if fp32 else 2.0 ** -7 * ref.float().abs().max().item()
            ok = err <= tol and old_err <= tol and (rel <= S4D_CONV_REL_L2 or not fp32)
            if not ok:
                FAILED.append(f"s4d {label} {dtype}")
            run = lambda: s4_scan.s4d_scan_recurrent(p, u)
            dev, ms = device_ms(run), cuda_time_ms(run)
            with cuda_build.mma_sync_only():
                old_dev, old_ms = device_ms(run, match="s4d_scan"), cuda_time_ms(run)
            # the kernel ended after staging, A and B (timing probes)
            cut = {stop: device_ms(probe(stop, p, u, n)) for stop in (1, 2, 3)} if fp32 else {}
            print(f"s4d {label} B{b} L{length} H{h} N{n} {str(dtype)[6:]}: probes {cut}; plan "
                  f"{s4_scan.s4d_chunk_plan(length, h, n)}, err {err:.3e} (tol {tol:.1e}; "
                  f"sequential {old_err:.3e}), rel L2 vs conv {rel:.3e}; device {dev:.4f} ms "
                  f"(sequential kernel {old_dev:.4f}), call {ms:.4f} (sequential {old_ms:.4f})"
                  f"{'' if ok else '  FAILED'}", flush=True)


# builds the probe mode times beside the package's (six stages): shallower rings
PIPELINE_VARIANTS = ("W8A8_STAGES=4", "W8A8_STAGES=5")


def _print_probe(label, probe):
    print(f"   {label} stage probe, cycles: a stage (one consumer warpgroup) full-barrier "
          f"wait {probe['probe_full_wait']:.0f}, wgmma {probe['probe_mma']:.0f}, loop "
          f"{probe['probe_loop']:.0f}; a fold {probe['probe_fold']:.0f}; an epilogue "
          f"{probe['probe_epilogue']:.0f}; the producer's empty wait a stage "
          f"{probe['probe_empty_wait']:.0f}", flush=True)


def check_probe(gen):
    """The W8A8 pipeline at the serving shapes: each output against its plain
    version (every one equal in the dense gelu cases), the stage probe, and the
    GEMM alone built at each ring depth (its outputs equal to the package
    build's), dense and grouped."""
    from loongx_tpu_torch.ops import moe, w8a8_layout
    from loongx_tpu_torch.ops import quant_matmul as qmm
    defines = list(PIPELINE_VARIANTS)
    dense = probe_entries("quant_matmul", "qmm_gemm_wgmma", qmm._WGMMA_SIGNATURE, defines)
    grouped = probe_entries("moe_gemm", "moe_gemm", moe._GEMM_SIGNATURE, defines)
    stream = torch.cuda.current_stream().cuda_stream
    for label, m, k, n, act in [("ff-in gelu", 2560, 3072, 12288, "gelu_tanh"),
                                ("attn-out", 2560, 3072, 3072, None),
                                ("ff-out K12288", 2560, 12288, 3072, None)]:
        wq = torch.randint(-128, 128, (2, k, n), dtype=torch.int8, device="cuda",
                           generator=gen)
        sc = torch.rand(2, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        bi = torch.randn(2, 1, n, generator=gen, device="cuda") * 0.02
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        group, k_pad = qmm.stacked_w8a8_group(k, n)
        out = qmm.quant_matmul_stacked(x, wq, sc, 1, bias3=bi, activation=act, w8a8=True)
        ref = qmm.qmm_plain(x, wq[1], sc[1], bi[1], act, True, group, k_pad)
        flips = int((out != ref).sum().item())
        if not w8a8_layout.is_kmajor(wq, 1) or (act and flips):
            FAILED.append(f"probe {label}")
        a, xs = qmm.act_quant(x, group, k_pad)
        y = torch.empty_like(out)
        epi = qmm.EPI_GELU if act else qmm.EPI_BIAS

        def at(fn):
            return lambda: cuda_build.check(fn(
                epi, a.data_ptr(), xs.data_ptr(), qmm._stack_ptr(wq, 1),
                qmm._stack_ptr(sc, 1), qmm._stack_ptr(bi, 1), None, None, None, y.data_ptr(),
                m, k, k_pad, n, group, k_pad // group, 0, 0, 0, stream), "qmm_gemm_wgmma")
        package = cuda_build.entry("quant_matmul", "qmm_gemm_wgmma", qmm._WGMMA_SIGNATURE)
        times = {"package": round(cuda_time_ms(at(package)), 4)}
        for d in defines:
            run = at(dense[d])
            run()
            if not torch.equal(y, out):
                FAILED.append(f"probe {label} {d}: output differs")
            times[d] = round(cuda_time_ms(run), 4)
        print(f"qmm M{m} K{k} N{n} {act} (K-major weight): outputs differing from the plain "
              f"version {flips}; GEMM ms by build {times}", flush=True)
        _print_probe(label, stage_probe(torch, qmm, x, wq, sc, bi, 1, act, group, k_pad))

    # HiDream's routed experts: four groups of 2816 rows, gate-up then down
    g_count, rows = 4, 2816
    m = g_count * rows
    offsets = torch.arange(0, m + 1, rows, dtype=torch.int32, device="cuda")
    counts = torch.full((g_count,), rows, dtype=torch.int32, device="cuda")
    for label, k, n, epi in [("gate-up swiglu", 2560, 13824, moe.EPI_SWIGLU),
                             ("down rows", 6912, 2560, moe.EPI_ROWS)]:
        group = moe.expert_group(k)
        codes = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                              generator=gen)
        xs = torch.rand(m, k // group, generator=gen, device="cuda") * 1e-2 + 1e-3
        w = torch.randint(-128, 128, (g_count, k, n), dtype=torch.int8, device="cuda",
                          generator=gen)
        sc = torch.rand(g_count, 1, n, generator=gen, device="cuda") * 2e-5 + 1e-5
        out = moe.grouped_gemm(codes, xs, w, sc, epi, offsets, counts)
        ref = moe.grouped_gemm_plain(codes, xs, w, sc, epi, offsets, counts)
        rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
        y = torch.empty_like(out)

        def at(fn):
            return lambda: cuda_build.check(fn(
                epi, codes.data_ptr(), xs.data_ptr(), w.data_ptr(), sc.data_ptr(), None,
                offsets.data_ptr(), counts.data_ptr(), y.data_ptr(), m, k, n, g_count, group,
                stream), "moe_gemm")
        package = cuda_build.entry("moe_gemm", "moe_gemm", moe._GEMM_SIGNATURE)
        times = {"package": round(cuda_time_ms(at(package)), 4)}
        for d in defines:
            run = at(grouped[d])
            run()
            if not torch.equal(y, out):
                FAILED.append(f"probe {label} {d}: output differs")
            times[d] = round(cuda_time_ms(run), 4)
        if not rel < 1e-2:
            FAILED.append(f"probe grouped {label}: rel L2 {rel}")
        print(f"moe_gemm {label} G{g_count} M{m} K{k} N{n}: rel L2 to the plain version "
              f"{rel:.2e}; ms by build {times}", flush=True)
        fn = probe_entries("moe_gemm", "moe_gemm", moe._GEMM_SIGNATURE,
                           ["W8A8_PROBE"])["W8A8_PROBE"]
        _print_probe(label, read_stage_probe("moe_gemm", at(fn)))


def check_image(other):
    """One served W8A8 edit (FLUX.1-dev, then HiDream-I1; scripts/serve_image.py)
    from this checkout and from checkout ``other`` (say, the parent commit's
    `git archive`), each in a process of its own: the images equal bit for
    bit."""
    import numpy as np
    out = cuda_build.BUILD_DIR / "serve_image"  # beside the builds, ignored by git
    out.mkdir(parents=True, exist_ok=True)
    script = str(Path(__file__).resolve().parent / "serve_image.py")
    for model in ("flux", "hidream"):
        paths = {}
        for label, package in (("other", other), ("this", None)):
            paths[label] = out / f"serve_image_{model}_{label}.npy"
            cmd = [sys.executable, script, str(paths[label])]
            cmd += ["--hidream"] if model == "hidream" else []
            cmd += ["--package", package] if package else []
            if subprocess.run(cmd).returncode != 0:
                FAILED.append(f"image {model} {label}")
        if all(p.exists() for p in paths.values()):
            a, b = np.load(paths["this"]), np.load(paths["other"])
            same = a.shape == b.shape and np.array_equal(a, b)
            print(f"image {model}: this checkout's equal to {other}'s bit for bit: {same}; "
                  f"max |diff| {float(np.abs(a - b).max()) if a.shape == b.shape else None}",
                  flush=True)
            if not same:
                FAILED.append(f"image {model}: differs from {other}'s")


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "build":
        build(sys.argv[2:] or cuda_build.SOURCES)
    elif what == "image" and len(sys.argv) == 3:
        check_image(sys.argv[2])
        if FAILED:
            sys.exit(f"wgmma_check: {FAILED}")
    elif what in ("qmm", "probe", "wo", "qmm_t", "flash", "bwd", "int8", "actq", "ln", "narrow",
                  "k64", "s4d"):
        if not torch.cuda.is_available():
            sys.exit("wgmma_check: no CUDA device")
        gen = torch.Generator(device="cuda").manual_seed(0)
        {"qmm": check_qmm, "probe": check_probe, "wo": check_wo, "qmm_t": check_qmm_t, "flash": check_flash,
         "bwd": check_bwd, "int8": check_int8, "actq": check_actq, "ln": check_ln,
         "narrow": check_narrow, "k64": check_k64, "s4d": check_s4d}[what](gen)
        if FAILED:
            sys.exit(f"wgmma_check: {len(FAILED)} checks failed")
    else:
        sys.exit(__doc__)
