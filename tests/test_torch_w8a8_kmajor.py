"""The W8A8 GEMMs' K-major weights (``ops/w8a8_layout.py``) on the CPU.

The W8A8 GEMM on wgmma and the grouped expert GEMM read each int8 weight
K-major ([N, K] in memory).  The layout changes in place, its strides the
marker: the conversion is exact for every leaf form the serving trees hold
(a block stack, a fused qkv, HiDream's interleaved gate-up experts, a
grouped stack), the plain versions read either layout bit for bit, K = N is
told apart by the strides, a served edit converts each wgmma leaf once and
a second request none, the routes that read [K, N] convert back to the
original leaf, and the tree holds one tensor a leaf throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from loongx_tpu_torch.ops import cuda_build, moe
from loongx_tpu_torch.ops import quant_matmul as qmm
from loongx_tpu_torch.ops import w8a8_layout as wl
from loongx_tpu_torch.ops.nn import tree_leaves

KMAJOR, KN = wl.KMAJOR, wl.KN


@pytest.fixture(autouse=True)
def cpu_weights_move(monkeypatch):
    """Let CPU tensors change layout as CUDA tensors do (by default only
    the kernels' device moves its weights), so that the routes' layout
    rules run here."""
    monkeypatch.setattr(wl, "DEVICES", ("cuda", "cpu"))


def test_cpu_weights_keep_their_layout_by_default(monkeypatch):
    monkeypatch.setattr(wl, "DEVICES", ("cuda",))
    x, w, sc, bi = _stack_case()
    cuda_build.LAUNCHES.clear()
    qmm.quant_matmul_stacked(x, w, sc, 1, w8a8=True)
    assert not wl.to_kmajor(w, 1) and w.is_contiguous()
    assert not cuda_build.LAUNCHES


def _codes(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-128, 128, shape, dtype=torch.int8, generator=g)


def _memory(w: torch.Tensor, kdim: int) -> torch.Tensor:
    """The bytes of ``w`` in memory order, as [blocks, rows, row bytes]."""
    k = w.shape[kdim]
    n = w.numel() // (k * int(np.prod(w.shape[:kdim], dtype=np.int64)))
    b = w.numel() // (k * n)
    rows = n if wl.is_kmajor(w, kdim) else k
    return w.as_strided((b, rows, w.numel() // (b * rows)),
                        (k * n, w.numel() // (b * rows), 1))


def _fused_qkv(nb, k, h, seed):
    return torch.cat([_codes(nb, k, h, seed=seed + i) for i in range(3)], -1)


def _gate_up(nb, e, d, f, seed):
    return moe.interleave_swiglu(_codes(nb, e, d, f, seed=seed),
                                 _codes(nb, e, d, f, seed=seed + 1))


@pytest.mark.parametrize("label, make, kdim", [
    ("stack", lambda: _codes(3, 256, 384, seed=1), 1),
    ("fused qkv", lambda: _fused_qkv(2, 256, 128, 2), 1),
    ("gate-up experts", lambda: _gate_up(2, 4, 128, 192, 3), 2),
    ("grouped", lambda: _codes(4, 384, 128, seed=4), 1),
    ("flat", lambda: _codes(256, 640, seed=5), 0),
])
def test_conversion_is_exact_matrix_by_matrix(label, make, kdim):
    w = make()
    orig = w.clone()
    ptr = w.untyped_storage().data_ptr()
    cuda_build.LAUNCHES.clear()
    assert wl.to_kmajor(w, kdim)
    assert cuda_build.LAUNCHES[KMAJOR] == 1
    assert wl.is_kmajor(w, kdim) and not w.is_contiguous()
    # the same logical tensor, in the same memory
    assert torch.equal(w, orig) and w.untyped_storage().data_ptr() == ptr
    # each [K, N] matrix stored as its transpose
    k = orig.shape[kdim]
    mats = orig.reshape(-1, k, orig[(0,) * kdim].numel() // k)
    assert torch.equal(_memory(w, kdim), mats.transpose(1, 2))
    assert wl.to_kn(w, kdim) and w.is_contiguous() and torch.equal(w, orig)
    assert torch.equal(_memory(w, kdim), mats)
    assert cuda_build.LAUNCHES[KN] == 1


def test_square_weights_are_told_apart_by_the_strides():
    """At K = N the shape cannot tell [K, N] from [N, K]: the strides do."""
    for w, kdim in ((_codes(256, 256, seed=6), 0), (_codes(2, 256, 256, seed=7), 1)):
        transposed = w.transpose(-1, -2).contiguous()  # [N, K] data, row-major
        assert wl.layout(w, kdim) == wl.layout(transposed, kdim) == "kn"
        orig = w.clone()
        wl.to_kmajor(w, kdim)
        assert w.shape == orig.shape and wl.layout(w, kdim) == "kmajor"
        assert torch.equal(w, orig)
        # a block of a K-major stack is K-major too
        if kdim == 1:
            assert wl.is_kmajor(w[1], 0) and torch.equal(w[1], orig[1])


def test_views_move_with_their_base_or_not_at_all():
    base = _codes(256, 384, seed=8)
    orig = base.clone()
    leaf = base[None]  # a stack of one, as HiDream's serving layout builds
    assert wl.to_kmajor(leaf, 1)
    assert wl.is_kmajor(base, 0) and torch.equal(base, orig)
    assert torch.equal(leaf[0], orig)
    stack = _codes(2, 256, 384, seed=9)
    before = stack.clone()
    assert not wl.to_kmajor(stack[1], 0)  # one block cannot move alone
    assert stack.is_contiguous() and torch.equal(stack, before)
    # the tensor-parallel fused qkv: its 3-D view moves the 4-D leaf
    w4 = _codes(2, 256, 3, 128, seed=10)
    orig4 = w4.clone()
    assert wl.to_kmajor(w4.reshape(2, 256, 384), 1)
    assert wl.is_kmajor(w4, 1) and torch.equal(w4, orig4)
    assert wl.is_kmajor(w4.reshape(2, 256, 384), 1)


def _stack_case(k=256, n=384, m=5, seed=11):
    g = torch.Generator().manual_seed(seed)
    w = _codes(3, k, n, seed=seed)
    sc = torch.rand(3, 1, n, generator=g) * 1e-3 + 1e-4
    bi = torch.randn(3, 1, n, generator=g) * 0.02
    x = torch.randn(m, k, generator=g)
    return x, w, sc, bi


def test_plain_versions_read_either_layout_bit_for_bit():
    x, w, sc, bi = _stack_case()
    group, k_pad = qmm.stacked_w8a8_group(256, 384)
    kn = w.clone()
    wl.to_kmajor(w, 1)
    for act in (None, "gelu_tanh"):
        for w8a8 in (True, False):
            assert torch.equal(
                qmm.qmm_plain(x, w[1], sc[1], bi[1], act, w8a8, group, k_pad),
                qmm.qmm_plain(x, kn[1], sc[1], bi[1], act, w8a8, group, k_pad))
    norm_w = torch.rand(3, 128) + 0.5
    for a, b in zip(qmm.quant_qkv_plain(x, w[1], sc[1], bi[1], norm_w, 64, True,
                                        group, k_pad),
                    qmm.quant_qkv_plain(x, kn[1], sc[1], bi[1], norm_w, 64, True,
                                        group, k_pad)):
        assert torch.equal(a, b)
    dy = torch.randn(5, 384)
    assert torch.equal(qmm.qmm_t_plain(dy, w[1], sc[1]), qmm.qmm_t_plain(dy, kn[1], sc[1]))
    # the grouped GEMM's plain version, both epilogues
    g = torch.Generator().manual_seed(12)
    codes = torch.randint(-127, 128, (256, 128), dtype=torch.int8, generator=g)
    xs = torch.rand(256, 1, generator=g) * 1e-2
    offsets = torch.tensor([0, 128, 256], dtype=torch.int32)
    counts = torch.tensor([100, 128], dtype=torch.int32)
    for epi, n in ((moe.EPI_SWIGLU, 256), (moe.EPI_ROWS, 128)):
        wg = _codes(2, 128, n, seed=13)
        scg = torch.rand(2, 1, n, generator=g) * 1e-3
        ref = moe.grouped_gemm_plain(codes, xs, wg.clone(), scg, epi, offsets, counts)
        assert torch.equal(moe.grouped_gemm(codes, xs, wg, scg, epi, offsets, counts), ref)
        assert wl.is_kmajor(wg, 1)


def test_the_route_decides_the_layout():
    """quant_matmul_stacked makes the leaf K-major on the W8A8 wgmma route
    (once), [K, N] again on a weight-only call (once), and its outputs are
    the plain version's on the original leaf in either mode."""
    x, w, sc, bi = _stack_case()
    kn = w.clone()
    group, k_pad = qmm.stacked_w8a8_group(256, 384)
    assert qmm.launch_route(256, 384, group, k_pad, True) == "wgmma"
    cuda_build.LAUNCHES.clear()
    for _ in range(2):
        y = qmm.quant_matmul_stacked(x, w, sc, 1, bias3=bi, w8a8=True)
        assert torch.equal(y, qmm.qmm_plain(x, kn[1], sc[1], bi[1], None, True,
                                            group, k_pad))
    assert wl.is_kmajor(w, 1) and cuda_build.LAUNCHES[KMAJOR] == 1
    for _ in range(2):
        y = qmm.quant_matmul_stacked(x, w, sc, 1, bias3=bi, w8a8=False)
        assert torch.equal(y, qmm.qmm_plain(x, kn[1], sc[1], bi[1]))
    assert w.is_contiguous() and torch.equal(w, kn)
    assert cuda_build.LAUNCHES[KN] == 1 and cuda_build.LAUNCHES[KMAJOR] == 1
    # a shape the W8A8 wgmma kernel does not take keeps [K, N]
    small = _codes(2, 64, 384, seed=14)
    qmm.quant_matmul_stacked(torch.randn(3, 64), small,
                             torch.rand(2, 1, 384) * 1e-3, 0, w8a8=True)
    assert small.is_contiguous()


@pytest.mark.parametrize("k, want", [(3072, "wgmma"), (200, "mma_sync")])
def test_a_k_that_tma_cannot_stride_leaves_wgmma(k, want):
    """K-major rows lie K bytes apart and TMA takes whole 16 bytes: K 200
    (`qmm_route` says "wgmma") launches on mma.sync."""
    group, k_pad = qmm.flat_w8a8_group(k, 3072)
    assert qmm.qmm_route(k, 3072, group, k_pad, True) == "wgmma"
    assert qmm.launch_route(k, 3072, group, k_pad, True) == want


def test_adapter_and_training_routes_read_the_original_leaf():
    """A QLoRA step over a K-major leaf (weight-only forward, transposed
    backward) converts it back once and gives the gradients of the leaf
    never converted."""
    x, w, sc, bi = _stack_case(seed=15)
    kn = w.clone()
    g = torch.Generator().manual_seed(16)
    a0 = torch.randn(256, 4, generator=g) * 0.1
    b0 = torch.randn(4, 384, generator=g) * 0.1
    ms = torch.full((1, 1), 0.5)

    def grads(weight):
        a, b = a0.clone().requires_grad_(), b0.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        y = qmm.quant_matmul_stacked_vjp(xx, weight, sc, 2, lora=(a, b, ms))
        y.float().square().sum().backward()
        return y.detach(), xx.grad, a.grad, b.grad

    want = grads(kn)
    wl.to_kmajor(w, 1)
    cuda_build.LAUNCHES.clear()
    got = grads(w)
    for u, v in zip(got, want):
        assert torch.equal(u, v)
    assert w.is_contiguous() and torch.equal(w, kn)
    assert cuda_build.LAUNCHES[KN] == 1 and cuda_build.LAUNCHES[KMAJOR] == 0


def test_tensor_parallel_shards_of_a_kmajor_tree_are_the_original_shards():
    from loongx_tpu_torch.parallel import mesh as pmesh

    tree = {"double_blocks": {"ff": {"in": {
        "kernel_q": _codes(2, 256, 512, seed=17),
        "kernel_scale": torch.rand(2, 1, 512), "bias": torch.zeros(2, 512)}}}}
    orig = tree["double_blocks"]["ff"]["in"]["kernel_q"].clone()
    wl.to_kmajor(tree["double_blocks"]["ff"]["in"]["kernel_q"], 1)
    for index in range(2):
        m = pmesh.Mesh({"data": 1, "tensor": 2}, 0, index, torch.device("cpu"))
        rank = pmesh.shard_params(tree, m)["double_blocks"]["ff"]["in"]["kernel_q"]
        assert rank.is_contiguous()
        assert torch.equal(rank, orig[..., index * 256:(index + 1) * 256])


def _serve_flux(w8a8, pipe, requests=2):
    from loongx_tpu_torch.sampling import generate

    g = torch.Generator().manual_seed(0)
    sig = dict(eeg=torch.randn(1, 4, 4096, generator=g),
               ppg=torch.randn(1, 4, 256, generator=g),
               fnirs=torch.randn(1, 6, 512, generator=g),
               motion=torch.randn(1, 6, 128, generator=g))
    image = np.zeros((1, 32, 32, 3), np.uint8)
    counts, outs = [], []
    for _ in range(requests):
        cuda_build.LAUNCHES.clear()
        outs.append(generate.neural_edit(pipe, image, **sig, height=32, width=32,
                                         num_inference_steps=2, seed=1, w8a8=w8a8))
        counts.append((cuda_build.LAUNCHES[KMAJOR], cuda_build.LAUNCHES[KN]))
    return counts, outs


def _int8_leaves(tree, path=""):
    """(path, linear dict) of every int8 linear of a tree."""
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            yield path, tree
        for key, v in tree.items():
            yield from _int8_leaves(v, f"{path}/{key}")


def _wgmma_leaf(p) -> bool:
    w = p["kernel_q"]
    k, n = w.shape[-2], w.shape[-1]
    group, k_pad = (qmm.flat_w8a8_group(k, n) if w.ndim == 2
                    else qmm.stacked_w8a8_group(k, n))
    return qmm.launch_route(k, n, group, k_pad, True) == "wgmma"


def test_a_served_edit_converts_each_wgmma_leaf_once():
    """A FLUX bundle at hidden 128 (every block linear on the W8A8 wgmma
    route) served twice: the first request converts each wgmma leaf once
    (in place: one tensor a leaf, the same memory), the second none, the
    images equal; a weight-only request then converts each back once, to
    the original leaves, and gives the image of a bundle never converted."""
    from loongx_tpu_torch.models.flux.model import FluxConfig
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    cfg = FluxConfig(in_channels=16, num_heads=2, head_dim=64, num_double_blocks=2,
                     num_single_blocks=2, joint_dim=4096, pooled_dim=768,
                     axes_dims=(16, 24, 24))
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.tiny(), seed=0, device="cpu")
    twin = LoongXPipeline.init_serving(cfg, VAEConfig.tiny(), seed=0, device="cpu")
    leaves = dict(_int8_leaves(pipe.params["flux"]))
    wgmma = {path for path, p in leaves.items() if _wgmma_leaf(p)}
    assert len(wgmma) >= 12 and len(wgmma) < len(leaves)
    orig = {path: p["kernel_q"].clone() for path, p in leaves.items()}
    ptrs = {path: p["kernel_q"].untyped_storage().data_ptr()
            for path, p in leaves.items()}
    n_leaves, n_bytes = (len(tree_leaves(pipe.params["flux"])),
                         sum(t.untyped_storage().nbytes()
                             for t in tree_leaves(pipe.params["flux"])))

    counts, outs = _serve_flux(True, pipe)
    assert counts == [(len(wgmma), 0), (0, 0)]
    np.testing.assert_array_equal(outs[0], outs[1])
    for path, p in leaves.items():
        w = p["kernel_q"]
        assert wl.is_kmajor(w, w.ndim - 2) == (path in wgmma), path
        assert torch.equal(w, orig[path])
        assert w.untyped_storage().data_ptr() == ptrs[path]
    assert len(tree_leaves(pipe.params["flux"])) == n_leaves
    assert sum(t.untyped_storage().nbytes()
               for t in tree_leaves(pipe.params["flux"])) == n_bytes
    _, twin_outs = _serve_flux(True, twin, requests=1)
    np.testing.assert_array_equal(outs[0], twin_outs[0])

    counts, wonly = _serve_flux(False, pipe, requests=1)
    assert counts == [(0, len(wgmma))]
    for path, p in leaves.items():
        assert p["kernel_q"].is_contiguous() and torch.equal(p["kernel_q"], orig[path])
    _, twin_wonly = _serve_flux(False, twin, requests=1)
    np.testing.assert_array_equal(wonly[0], twin_wonly[0])


def test_a_served_hidream_edit_converts_its_expert_stacks_once():
    """HiDream at D 128 (experts F 384, shared 256): the first W8A8 request
    makes every expert stack and every wgmma dense leaf K-major, the second
    converts nothing, and the images are equal."""
    from loongx_tpu_torch.models.flux.vae import VAEConfig
    from loongx_tpu_torch.models.hidream import model as hd
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.sampling import generate

    cfg = hd.HiDreamConfig(latent_channels=4, num_heads=2, head_dim=64,
                           num_double_blocks=1, num_single_blocks=1,
                           caption_dim=4096, pooled_dim=784, axes_dims=(16, 24, 24),
                           ffn_multiple_of=128)
    pipe = LoongXPipeline.init_serving(cfg, VAEConfig.tiny(), seed=0, device="cpu")
    flux = pipe.params["flux"]
    stacks = [(blk, key, part) for blk in ("double_blocks", "single_blocks")
              for key in (("moe", "experts"), ("moe", "shared"))
              for part in ("w13_q", "w2_q")]
    stacks += [("double_blocks", ("ff_t",), part) for part in ("w13_q", "w2_q")]

    def stack(blk, key, part):
        node = flux[blk]
        for k in key:
            node = node[k]
        return node[part]

    orig = {s: stack(*s).clone() for s in stacks}
    dense = sum(_wgmma_leaf(p) for _, p in _int8_leaves(flux))
    g = torch.Generator().manual_seed(0)
    sig = dict(eeg=torch.randn(1, 4, 4096, generator=g),
               ppg=torch.randn(1, 4, 256, generator=g),
               fnirs=torch.randn(1, 6, 512, generator=g),
               motion=torch.randn(1, 6, 128, generator=g))
    extra = dict(text_streams=torch.randn(1, 2, 3, 4096, generator=g),
                 pooled_extra=torch.randn(1, 16, generator=g))
    image = np.zeros((1, 32, 32, 3), np.uint8)
    counts, outs = [], []
    for _ in range(2):
        cuda_build.LAUNCHES.clear()
        outs.append(generate.neural_edit(pipe, image, **sig, **extra, height=32,
                                         width=32, num_inference_steps=2, seed=1,
                                         w8a8=True))
        counts.append((cuda_build.LAUNCHES[KMAJOR], cuda_build.LAUNCHES[KN]))
    assert counts == [(len(stacks) + dense, 0), (0, 0)]
    np.testing.assert_array_equal(outs[0], outs[1])
    for s in stacks:
        w = stack(*s)
        assert wl.is_kmajor(w, w.ndim - 2) and torch.equal(w, orig[s]), s
