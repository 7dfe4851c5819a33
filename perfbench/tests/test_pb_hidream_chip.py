"""The expert path's kernels on the card (marked ``chip``): each against its
plain version at HiDream-I1's widths with uneven expert loads (an empty
expert among them), the expert layer against its plain composition, and
one full-width HiDream denoise step under
``torch.cuda.set_sync_debug_mode("error")``: no host synchronization.

    python -m pytest -m chip perfbench/tests/test_pb_hidream_chip.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.chip

D, F, FS, E, TOP_K = 2560, 6912, 3584, 4, 2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def _uneven_routing(m: int, gen: torch.Generator):
    """Slot 0 on experts 0 / 1 (70 / 30 %), slot 1 on 1 / 2, expert 3
    empty; weights as a softmax would give them."""
    u = torch.rand(m, generator=gen)
    first = torch.where(u < 0.7, 0, 1)
    second = torch.where(first == 0, 1, 2)
    second = torch.where(torch.rand(m, generator=gen) < 0.5, second, 2)
    second = torch.where(second == first, 2, second)
    idx = torch.stack([first, second], 1).to(torch.int32)
    w = torch.rand(m, 2, generator=gen) * 0.5
    return idx, w


def _stack(g: int, k: int, n: int, gen: torch.Generator):
    w = torch.randint(-127, 128, (g, k, n), dtype=torch.int8, generator=gen)
    s = (1.0 + 0.25 * torch.rand(g, 1, n, generator=gen)) / (k ** 0.5 * 73.6)
    return w, s


def test_expert_kernels_match_their_plain_versions():
    _card()
    from loongx_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(3)
    m = 3000
    x = torch.randn(m, D, generator=gen).to(torch.bfloat16)
    gate_w = torch.randn(E, D, generator=gen) / D ** 0.5
    cuda = torch.device("cuda")

    # the router: probabilities equal, the choice equal but on near-ties
    idx_c, wts_c = moe.route(x.to(cuda), gate_w.to(cuda), TOP_K)
    idx_p, wts_p = moe.route_plain(x, gate_w, TOP_K)
    same = (idx_c.cpu() == idx_p).all(-1).float().mean()
    assert same > 0.995, float(same)
    agree = (idx_c.cpu() == idx_p).all(-1)
    assert torch.allclose(wts_c.cpu()[agree], wts_p[agree], atol=2e-6)

    # the plan of uneven loads, bit for bit
    idx, wts = _uneven_routing(m, gen)
    cap = moe.capacity(idx.numel(), E)
    got = moe.plan(idx.to(cuda), wts.to(cuda), E, cap)
    want = moe.plan_plain(idx, wts, E, cap)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    counts, offsets, dest, src, row_w = want
    assert int(counts[3]) == 0 and int(counts.sum()) == 2 * m

    # the codes, gathered and in order, bit for bit
    group = moe.expert_group(D)
    gq = moe.quant_rows(x.to(cuda), group, src=src.to(cuda))
    gq_p = moe.quant_rows_plain(x, group, src)
    assert torch.equal(gq[0].cpu(), gq_p[0]) and torch.equal(gq[1].cpu(), gq_p[1])

    # the grouped GEMMs at full width: gate-up (SwiGLU), down (rows, weighted)
    w13, s13 = _stack(E, D, 2 * F, gen)
    h = moe.grouped_gemm(gq[0], gq[1], w13.to(cuda), s13.to(cuda),
                         moe.EPI_SWIGLU, offsets.to(cuda), counts.to(cuda))
    h_p = moe.grouped_gemm_plain(gq_p[0], gq_p[1], w13, s13, moe.EPI_SWIGLU,
                                 offsets, counts)
    live = src >= 0
    assert _rel(h.cpu()[live], h_p[live]) < 4e-3
    hq_p = moe.quant_rows_plain(h.cpu(), moe.expert_group(F))
    hq = moe.quant_rows(h, moe.expert_group(F), limit=offsets[E:].to(cuda))
    assert torch.equal(hq[0].cpu()[live], hq_p[0][live])
    w2, s2 = _stack(E, F, D, gen)
    y = moe.grouped_gemm(hq[0], hq[1], w2.to(cuda), s2.to(cuda), moe.EPI_ROWS,
                         offsets.to(cuda), counts.to(cuda), row_w.to(cuda))
    y_p = moe.grouped_gemm_plain(hq_p[0], hq_p[1], w2, s2, moe.EPI_ROWS,
                                 offsets, counts, row_w)
    assert _rel(y.cpu()[live], y_p[live]) < 4e-3

    # one group of every row (the shared expert), then the combine
    ws13, ss13 = _stack(1, D, 2 * FS, gen)
    xq = moe.quant_rows(x.to(cuda), group)
    hs = moe.grouped_gemm(xq[0], xq[1], ws13.to(cuda), ss13.to(cuda),
                          moe.EPI_SWIGLU)
    hs_p = moe.grouped_gemm_plain(xq[0].cpu(), xq[1].cpu(), ws13, ss13,
                                  moe.EPI_SWIGLU)
    assert _rel(hs, hs_p) < 4e-3
    gate = torch.randn(2, 2, D, generator=gen)
    resid = torch.randn(m, D, generator=gen).to(torch.bfloat16)
    ys = torch.randn(m, D, generator=gen).to(torch.bfloat16)
    out = moe.combine(resid.to(cuda), gate.to(cuda), y, dest.to(cuda),
                      ys.to(cuda), m // 2, m // 2 - 100)
    out_p = moe.combine_plain(resid, gate, y.cpu(), dest, ys, m // 2,
                              m // 2 - 100)
    assert _rel(out, out_p) < 1e-3


def test_expert_layer_matches_its_plain_composition():
    """The whole layer (router, plan, gathers, four GEMMs, combine) on the
    card against the plain versions on the CPU, from the same routing."""
    _card()
    from loongx_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(5)
    m = 2048
    x = torch.randn(m, D, generator=gen).to(torch.bfloat16)
    w13, s13 = _stack(E, D, 2 * F, gen)
    w2, s2 = _stack(E, F, D, gen)
    ws13, ss13 = _stack(1, D, 2 * FS, gen)
    ws2, ss2 = _stack(1, FS, D, gen)
    p = {"gate_w": torch.randn(E, D, generator=gen) / D ** 0.5,
         "experts": {"w13_q": w13, "w13_scale": s13, "w2_q": w2,
                     "w2_scale": s2},
         "shared": {"w13_q": ws13, "w13_scale": ss13, "w2_q": ws2,
                    "w2_scale": ss2}}
    gate = torch.rand(1, 2, D, generator=gen)
    resid = torch.randn(m, D, generator=gen).to(torch.bfloat16)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    got = moe.expert_layer(x.cuda(), to(p, "cuda"), resid.cuda(), gate.cuda(),
                           m, m, TOP_K)
    want = moe.expert_layer(x, p, resid, gate, m, m, TOP_K)
    assert _rel(got, want) < 1e-2


def test_a_hidream_denoise_step_makes_no_host_synchronization():
    """Full width, batch 1 at 512 px, one step: warmed once, then run
    again with every synchronizing CUDA call an error."""
    _card()
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.hidream.model import HiDreamConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.ops.latents import latent_image_ids
    from loongx_tpu_torch.sampling import generate

    cfg = HiDreamConfig.hidream_i1()
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.flux(), seed=1)
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    lat = torch.randn(1, 1024, 64, device=dev, generator=gen).to(dt)
    cond = torch.randn(1, 1024, 64, device=dev, generator=gen).to(dt)
    txt = torch.randn(1, 512, 4096, device=dev, generator=gen).to(dt)
    llama = torch.randn(1, 48, 128, 4096, device=dev, generator=gen).to(dt)
    pooled = torch.randn(1, 2048, device=dev, generator=gen).to(dt)
    ids = latent_image_ids(64, 64, device=dev)
    txt_ids = torch.zeros(512, 3, device=dev)
    sig = np.array([1.0, 0.9], np.float32)

    def step():
        with torch.inference_mode():
            return generate.denoise(pipe.params["flux"], cfg, {}, lat, txt,
                                    pooled, ids, txt_ids, cond, ids, sig,
                                    None, None, w8a8=True, text_streams=llama)

    first = step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(second.float()).all()
    assert torch.equal(first, second)
