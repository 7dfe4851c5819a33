"""HiDream-I1 on the port, on the CPU at tiny widths (``HiDreamConfig.tiny``:
2 double + 2 single blocks, 4 routed experts top-2 and a shared expert):
the forward against the plain float32 reference (`perfbench.reference.
hidream`, which imports nothing of the port) on the same seeded weights,
the expert layer against its plain form under forced uneven routing, the
published layout's parameter count, the patch order, the serve path's
dispatch, and the FLUX forward's launches untouched by it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from loongx_tpu_torch.models.hidream import model as hd
from loongx_tpu_torch.ops import cuda_build, moe

from perfbench.reference import hidream as ref
from perfbench.reference.edit import image_ids

T = {"patch_size": 2, "in_channels": 4, "num_layers": 2,
     "num_single_layers": 2, "attention_head_dim": 32,
     "num_attention_heads": 2, "caption_channels": [32, 32],
     "text_emb_dim": 48, "num_routed_experts": 4,
     "num_activated_experts": 2, "axes_dims_rope": [8, 12, 12],
     "ffn_multiple_of": 64}
CFG = hd.HiDreamConfig.tiny(caption_dim=32, pooled_dim=48, latent_channels=4)


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _inputs(seed: int):
    g = torch.Generator().manual_seed(seed)
    b, h, w = 2, 8, 8
    s = (h // 2) * (w // 2)
    return dict(img=torch.randn(b, s, 16, generator=g),
                cond=torch.randn(b, s, 16, generator=g),
                t5=torch.randn(b, 6, 32, generator=g),
                llama=torch.randn(b, 4, 3, 32, generator=g),
                pooled=torch.randn(b, 48, generator=g),
                ts=torch.rand(b, generator=g), ids=image_ids(h, w, "cpu"))


def _both(acts: str, seed: int = 5):
    x = _inputs(seed)
    rw = ref.make_weights(T, seed, "cpu")
    lin = ref.Linears(acts)
    want = ref.hidream_forward(
        rw, T, lin, img=x["img"], cond=x["cond"],
        text=ref.project_text(rw, lin, x["t5"], x["llama"]),
        pooled=x["pooled"], timestep=x["ts"], img_ids=x["ids"],
        cond_ids=x["ids"])
    params = hd.serving_layout(ref.make_weights(T, seed, "cpu"))
    got = hd.hidream_forward(
        params, CFG, img=x["img"], txt=x["t5"], pooled=x["pooled"],
        timestep=x["ts"], img_ids=x["ids"], text_streams=x["llama"],
        cond=x["cond"], cond_ids=x["ids"], w8a8=acts == "int8")
    return got, want


def test_float32_forward_matches_the_reference_in_published_order():
    """The port orders a sequence [txt ; L_i ; img ; cond] (single blocks
    [L_i ; txt ; img ; cond]), the reference the published [img ; cond ;
    txt ; L_i]: both float32 on the same weights, so they differ only by
    summation order (attention is permutation-equivariant with each
    token's RoPE ids): 1e-5."""
    got, want = _both("float32")
    assert got.shape == (2, 16, 16)
    assert _rel(got, want) < 1e-5


def test_w8a8_forward_matches_the_reference_emulation():
    """W8A8 on both sides with the same activation groups: the port rounds
    every kernel output to bf16 and quantizes bf16 activations, the
    reference stays float32 between products (and a routing near-tie may
    fall the other way): 6e-2, the tiny cell's own sound readings being
    2.5-3.5e-2 end to end."""
    got, want = _both("int8")
    assert _rel(got, want) < 6e-2


def _layer(seed: int, m: int = 40, d: int = 64, f: int = 192,
           fs: int = 128, e: int = 4):
    g = torch.Generator().manual_seed(seed)

    def stack(n, k, out):
        return (torch.randint(-127, 128, (n, k, out), dtype=torch.int8,
                              generator=g),
                (1 + 0.25 * torch.rand(n, 1, out, generator=g)) / (k ** 0.5
                                                                   * 73.6))

    w1, s1 = stack(e, d, f)
    w3, s3 = stack(e, d, f)
    w2, s2 = stack(e, f, d)
    v1, t1 = stack(1, d, fs)
    v3, t3 = stack(1, d, fs)
    v2, t2 = stack(1, fs, d)
    p = {"gate_w": torch.randn(e, d, generator=g) / d ** 0.5,
         "experts": {"w13_q": moe.interleave_swiglu(w1, w3),
                     "w13_scale": moe.interleave_swiglu(s1, s3),
                     "w2_q": w2, "w2_scale": s2},
         "shared": {"w13_q": moe.interleave_swiglu(v1, v3),
                    "w13_scale": moe.interleave_swiglu(t1, t3),
                    "w2_q": v2, "w2_scale": t2}}
    raw = {"experts": (w1, s1, w3, s3, w2, s2), "shared": (v1, t1, v3, t3, v2,
                                                           t2)}
    x = torch.randn(m, d, generator=g)
    resid = torch.randn(m, d, generator=g)
    gate = torch.rand(2, 2, d, generator=g)
    return p, raw, x, resid, gate


def _swiglu(x, w, i):
    w1, s1, w3, s3, w2, s2 = w
    h = torch.nn.functional.silu(x @ (w1[i].float() * s1[i])) * (
        x @ (w3[i].float() * s3[i]))
    return h @ (w2[i].float() * s2[i])


ROUTINGS = {
    "experts_0_and_1": lambda m: torch.tensor([[0, 1]] * m),
    "one_expert_empty": lambda m: torch.tensor([[0, 1], [2, 0], [1, 2]]
                                               * (m // 3) + [[0, 2]] * (m % 3)),
    "all_on_one_expert": lambda m: torch.tensor([[3, 3]] * m),
}


@pytest.mark.parametrize("case", sorted(ROUTINGS))
def test_expert_layer_matches_its_plain_form(monkeypatch, case):
    """Forced uneven routing through the whole layer (plan, gathers, the
    grouped products, combine): resid + gate_seg (w1 E_e1(x) + w2 E_e2(x)
    + S(x)) with the router's weights as they are, the shared expert once,
    rows of the second batch element's cond segment on its own gate."""
    p, raw, x, resid, gate = _layer(7)
    m = x.shape[0]
    idx = ROUTINGS[case](m).to(torch.int32)
    wts = torch.rand(m, 2, generator=torch.Generator().manual_seed(1)) * 0.5
    monkeypatch.setattr(moe, "route", lambda *a: (idx, wts))
    got = moe.expert_layer(x, p, resid, gate, m // 2, m // 2 - 5, 2,
                           w8a8=False)
    routed = torch.stack([
        wts[t, 0] * _swiglu(x[t:t + 1], raw["experts"], idx[t, 0])[0]
        + wts[t, 1] * _swiglu(x[t:t + 1], raw["experts"], idx[t, 1])[0]
        for t in range(m)])
    inner = routed + _swiglu(x, raw["shared"], 0)
    rows = torch.arange(m)
    sel = 2 * (rows // (m // 2)) + ((rows % (m // 2)) >= m // 2 - 5).long()
    want = resid + gate.reshape(-1, x.shape[1])[sel] * inner
    assert _rel(got, want) < 1e-5
    renormalised = resid + gate.reshape(-1, x.shape[1])[sel] * (
        routed / wts.sum(-1, keepdim=True) + _swiglu(x, raw["shared"], 0))
    assert _rel(got, renormalised) > 1e-2
    if case == "one_expert_empty":
        counts = moe.plan_plain(idx, wts, 4, moe.capacity(2 * m, 4))[0]
        assert counts[3] == 0


def test_w8a8_expert_layer_tracks_the_float_one():
    """The W8A8 plain route (codes per (row, group), bf16 h and outputs)
    against the float32 one on the same routing."""
    p, _, x, resid, gate = _layer(9, m=64)
    a = moe.expert_layer(x, p, resid, gate, 64, 64, 2, w8a8=True)
    b = moe.expert_layer(x, p, resid, gate, 64, 64, 2, w8a8=False)
    assert _rel(a, b) < 2e-2


def test_plan_pads_each_expert_to_whole_tiles():
    idx = torch.tensor([[0, 1], [2, 0], [0, 2], [1, 0]], dtype=torch.int32)
    wts = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    cap = moe.capacity(8, 4)
    counts, offsets, dest, src, row_w = moe.plan_plain(idx, wts, 4, cap)
    assert counts.tolist() == [4, 2, 2, 0]
    assert offsets.tolist() == [0, 128, 256, 384, 384]
    assert src[dest.reshape(-1).long()].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert torch.equal(row_w[dest.reshape(-1).long()], wts.reshape(-1))
    assert int((src >= 0).sum()) == 8 and cap % 128 == 0
    # the tokens of one expert keep their order
    assert dest[0, 0] < dest[1, 1] < dest[2, 0] < dest[3, 1]


def test_swiglu_interleave_round_trips():
    w1, w3 = torch.randn(3, 8, 192), torch.randn(3, 8, 192)
    w13 = moe.interleave_swiglu(w1, w3)
    assert torch.equal(w13[..., :64], w1[..., :64])
    assert torch.equal(w13[..., 64:128], w3[..., :64])
    a, b = moe.split_swiglu(w13)
    assert torch.equal(a, w1) and torch.equal(b, w3)


def test_groups_divide_k_without_padding():
    assert [moe.expert_group(k) for k in (2560, 6912, 3584, 192)] == \
        [2560, 2304, 1792, 192]


def test_patches_are_laid_out_p1_p2_c():
    lat = torch.arange(2 * 4 * 6 * 3, dtype=torch.float32).reshape(2, 4, 6, 3)
    tok = hd.pack_patches(lat)
    assert tok.shape == (2, 6, 12)
    assert torch.equal(tok[0, 0], torch.cat([lat[0, 0, 0], lat[0, 0, 1],
                                             lat[0, 1, 0], lat[0, 1, 1]]))
    assert torch.equal(hd.unpack_patches(tok, 4, 6), lat)
    assert torch.equal(tok, ref.pack_patches(lat))


def test_the_published_layout_counts_17_b_parameters():
    from loongx_tpu_torch.ops.nn import count_params

    params = hd.init_hidream_params(hd.HiDreamConfig.hidream_i1(),
                                    device="meta")
    assert 16.9e9 < count_params(params) < 17.3e9
    cfg = hd.HiDreamConfig.hidream_i1()
    assert (cfg.hidden, cfg.ffn_dim, cfg.shared_dim, cfg.in_channels) == \
        (2560, 6912, 3584, 64)


def test_sigmas_take_the_static_shift():
    from loongx_tpu_torch.ops.schedule import static_shift_sigmas

    s = static_shift_sigmas(28)
    assert s.shape == (29,) and s[0] == 1.0 and s[-1] == 0.0
    np.testing.assert_array_equal(s, ref.sigmas(28))


def test_neural_edit_serves_a_hidream_pipeline():
    """The tiny HiDream bundle through `neural_edit` (the brain encoders at
    their fixed widths fill the T5 slot and the CLIP-L pooled part); a
    request without the Llama streams is refused."""
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.sampling import generate

    cfg = hd.HiDreamConfig.tiny(caption_dim=4096, pooled_dim=784)
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.tiny(), seed=0,
                                       device="cpu")
    g = torch.Generator().manual_seed(0)
    sig = dict(eeg=torch.randn(1, 4, 4096, generator=g),
               ppg=torch.randn(1, 4, 256, generator=g),
               fnirs=torch.randn(1, 6, 512, generator=g),
               motion=torch.randn(1, 6, 128, generator=g))
    image = np.zeros((1, 32, 32, 3), np.uint8)
    vae_scale = pipe.vae_cfg.downscale
    lat = torch.randn(1, (32 // vae_scale // 2) ** 2, cfg.in_channels,
                      generator=g)
    with pytest.raises(ValueError, match="text_streams"):
        generate.neural_edit(pipe, image, **sig, height=32, width=32)
    out = generate.neural_edit(
        pipe, image, **sig, height=32, width=32, num_inference_steps=2,
        latents=lat, text_streams=torch.randn(1, 4, 3, 4096, generator=g),
        pooled_extra=torch.randn(1, 16, generator=g), w8a8=True)
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()


def test_the_flux_denoise_launches_what_its_forwards_do():
    """The dispatch in `denoise` adds nothing to the FLUX path: its route
    counts are those of the forwards it runs, and no expert kernel."""
    from loongx_tpu_torch.models.flux.model import (
        FluxConfig, flux_forward, init_flux_params,
    )
    from loongx_tpu_torch.ops.quant import random_quantized_like
    from loongx_tpu_torch.sampling import generate

    cfg = FluxConfig.tiny()
    params = random_quantized_like(init_flux_params(cfg, device="meta"),
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 4, cfg.in_channels, generator=g)
    txt = torch.randn(1, 3, cfg.joint_dim, generator=g)
    pooled = torch.randn(1, cfg.pooled_dim, generator=g)
    ids = torch.zeros(4, 3)
    tids = torch.zeros(3, 3)
    guid = torch.full((1,), 3.5)
    sig = np.array([1.0, 0.6, 0.0], np.float32)
    cuda_build.LAUNCHES.clear()
    with torch.no_grad():
        generate.denoise(params, cfg, {}, lat, txt, pooled, ids, tids, lat,
                         ids, sig, guid, None, w8a8=True)
    via_denoise = dict(cuda_build.LAUNCHES)
    cuda_build.LAUNCHES.clear()
    with torch.no_grad():
        for s in sig[:-1]:
            flux_forward(params, cfg, img=lat, txt=txt, pooled=pooled,
                         timestep=torch.full((1,), float(s)), img_ids=ids,
                         txt_ids=tids, guidance=guid, cond=lat, cond_ids=ids,
                         w8a8=True)
    assert via_denoise == dict(cuda_build.LAUNCHES) and via_denoise
    assert not any(k.startswith("moe_") for k in via_denoise)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_expert_cases_are_the_cells_shapes():
    """`chip_smoke.py` checks the expert kernels at hidream_edit_b4_512's
    rows (from its traffic file) and the published widths."""
    import json
    from pathlib import Path
    cs = _chip_smoke()
    root = Path(__file__).resolve().parents[1]
    p = json.loads((root / "perfbench/traffic/edit_closed_hidream_b4_512.json"
                    ).read_text())["params"]
    rows = cs.hidream_rows(batch=p["batch"], size=p["height"],
                           text_tokens=p["text_tokens"],
                           llama_tokens=p["llama_tokens"])
    assert rows == cs.hidream_rows() == (11264, 8192, 3072)
    cfg = hd.HiDreamConfig.hidream_i1()
    (_, m, d, f, fs, e, k, cond), (_, mt, dt, ft, no_shared, one, zero, _) = (
        cs.hidream_moe_cases())
    assert (m, d, f, fs, e, k) == (rows[0], cfg.hidden, cfg.ffn_dim,
                                   cfg.shared_dim, cfg.num_experts, cfg.top_k)
    assert cond == (p["height"] // 16) ** 2
    assert (mt, dt, ft, no_shared, one, zero) == (rows[2], cfg.hidden,
                                                 cfg.ffn_dim, None, 1, 0)
    assert moe.capacity(k * m, e) == 23040


def test_chip_smoke_expert_checks_run_on_cpu(monkeypatch):
    """`chip_smoke.check_moe` at tiny widths on CPU tensors (the wrappers
    run their plain versions, so every error is 0): a record of each
    expert kernel, the routed stack with an empty expert, the shared
    expert, the text stream as one group."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "cuda_time_ms", lambda fn, iters=None: (fn(), 0.0)[1])
    monkeypatch.setattr(cs, "device_ms", lambda fn: (fn(), 0.0)[1])
    records = []
    cs.check_moe(torch, torch.Generator().manual_seed(1), records,
                 [("single block", 160, 256, 256, 128, 4, 2, 16),
                  ("text stream", 64, 256, 256, None, 1, 0, 0)], device="cpu")
    kernels = [r["kernel"] for r in records]
    assert set(kernels) == {"moe_route", "moe_plan", "moe_quant",
                            "moe_gemm_swiglu", "moe_gemm_rows", "moe_combine"}
    assert kernels.count("moe_gemm_swiglu") == kernels.count("moe_gemm_rows") == 3
    assert all(r["err"] == 0 and r["bound_ms"] > 0 for r in records)
    plan = next(r for r in records if r["kernel"] == "moe_plan")
    assert plan["counts"][3] == 0 and sum(plan["counts"]) == 2 * 160
