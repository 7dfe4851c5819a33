#!/usr/bin/env python3
"""Quick card check of the port's two wgmma kernels, much shorter than
``chip_smoke.py``: each against its plain version at a few small shapes
and one serving shape, and timed beside the ``mma.sync`` kernel it
replaces at one serving shape.  Needs one CUDA card and nvcc.

    python3 scripts/wgmma_check.py build   # nvcc -Xptxas -v: registers, spills
    python3 scripts/wgmma_check.py qmm     # the W8A8 GEMM
    python3 scripts/wgmma_check.py flash   # the flash forward (+ RoPE pre-pass)
    python3 scripts/wgmma_check.py bwd     # the flash backward (dK/dV and dQ)
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import cuda_time_ms  # noqa: E402
from loongx_tpu_torch.ops import cuda_build  # noqa: E402


def build():
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in ("quant_matmul", "flash_attention"):
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
            if "Compiling entry function" in line and ("wgmma" in line or "rope" in line):
                print("  ", line.split("'")[1])
                print("\n".join("     " + x for x in lines[i + 1:i + 3]))


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
        print(f"qmm M{m} K{k} N{n} {act}: route "
              f"{qmm.qmm_route(k, n, group, k_pad, True)}, err {err:.3e} (tol {tol:.3e}), "
              f"outputs differing {int((out != ref).sum().item())}", flush=True)
    t_new = cuda_time_ms(run)
    with cuda_build.mma_sync_only():
        t_old = cuda_time_ms(run)
    print(f"M{m} K{k} N{n} {act}: wgmma {t_new:.3f} ms, mma.sync {t_old:.3f} ms", flush=True)


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


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "build":
        build()
    elif what in ("qmm", "flash", "bwd"):
        if not torch.cuda.is_available():
            sys.exit("wgmma_check: no CUDA device")
        gen = torch.Generator(device="cuda").manual_seed(0)
        {"qmm": check_qmm, "flash": check_flash, "bwd": check_bwd}[what](gen)
    else:
        sys.exit(__doc__)
