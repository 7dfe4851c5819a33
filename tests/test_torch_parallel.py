"""Multi-GPU serving of the PyTorch port (``loongx_tpu_torch/parallel/``)
against the JAX package's ``loongx_tpu/parallel/``, on the CPU.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py
(its shard_map wrappers, the Pallas kernels in interpret mode); the port's
side runs in spawned gloo process groups, one process a rank
(`parallel.launch.spawn_ranks`), each holding only its shard: world 2
(tensor 2) and world 4 (data 2 x tensor 2), one spawn each with many
checks (tests/torch_parallel_ranks.py; the ranks import no JAX).  The JAX
references are computed here, in the test process.

Held against each other:

  * the sharding rules leaf by leaf (unfused, TP-layout and float trees),
    the flat-fused refusal's message, the TP-layout qkv fusion, and every
    shard put back by the row map equal to its leaf;
  * `tp_flash_attention` against JAX's on its 8-device mesh, within
    tests/test_tp_attention.py's 2e-5 / 3e-5;
  * `tp_quant_matmul_stacked` col / row / repl, with the LN + adaLN
    prologue (col) and the gate epilogue (row), weight-only at M 12 K 256
    N 256: against JAX's wrapper within two bf16 roundings of each output,
    against the port's unsharded kernel within two of the largest (the row
    split rounds its partial products to bf16, as the kernel's output,
    before their sum);
  * the whole int8 forward at ``LoongXPipeline.tiny``'s DiT widths (TP
    layout, proj_out whole): against JAX's TP forward (``tp_context``, the
    stacked kernels) and its unsharded forward, within
    tests/test_parallel.py's 5e-2; with ``fuse_ln`` + ``fuse_gate`` at
    batch 1 and at batch 2 over data 2 x tensor 2 (one row a data rank:
    the segments stay at the global boundary, the JAX test
    ``test_2d_mesh_fused_elementwise_keeps_global_segments``); and the
    unfused int8 tree with active LoRA adapters on every target (col, row
    and the single blocks' proj_out rows: the dequantised products), the
    same bounds;
  * batch-sharded ``generate()`` over data 2 x tensor 2 against JAX's
    ``generate()`` under its data 2 x tensor 2 mesh, and against the port's
    single-process ``generate()`` (1e-4, tests/test_parallel.py:154);
  * ``cli.infer --tensor 2`` (worlds 2 and 4: groups of 2 and 1, and a
    padded tail group) against ``--tensor 1``: the same files, the images
    within 2 of 255 (the int8 bf16 DiT's partial sums are rounded and
    summed in another order).
"""

import dataclasses
import importlib.util
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu.ops.rope import rope_embed as j_rope_embed
from loongx_tpu.parallel import make_mesh as j_make_mesh
from loongx_tpu.parallel import param_sharding_rules as j_rules
from loongx_tpu.parallel import shard_params as j_shard_params
from loongx_tpu.parallel.mesh import mesh_context as j_mesh_context
from loongx_tpu.parallel.mesh import tp_context as j_tp_context
from loongx_tpu.parallel.tp_attention import tp_flash_attention as j_tp_flash
from loongx_tpu.parallel.tp_quant import tp_quant_matmul_stacked as j_tp_qmm
from loongx_tpu.sampling.generate import generate as j_generate
from loongx_tpu_torch.cli import infer as tinfer
from loongx_tpu_torch.models.flux.model import FluxConfig, init_flux_params
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.ops import flash_attention as fa
from loongx_tpu_torch.ops import quant as tquant
from loongx_tpu_torch.ops import quant_matmul as tqmm
from loongx_tpu_torch.ops.latents import latent_image_ids
from loongx_tpu_torch.parallel import (
    make_mesh, param_sharding_rules, shard_batch, shard_params,
)
from loongx_tpu_torch.parallel import mesh as tmesh
from loongx_tpu_torch.parallel.launch import spawn_ranks
from loongx_tpu_torch.parallel.tp_quant import copy_to_tensor
from loongx_tpu_torch.sampling import generate as tgen
from loongx_tpu_torch.ops.quant import random_quantized_like
from loongx_tpu_torch.train.lora import add_lora
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

BF16_ULP = 2.0 ** -7
FORWARD_TOL = 5e-2  # tests/test_parallel.py:360,416
SPAWN_TIMEOUT = 300.0
SIZE, STEPS = 16, 2
CLI_TOL = 2  # uint8
LORA_B_STD = 0.5  # the LoRA delta moves the velocity by several FORWARD_TOL
# the LoRA forward weight-only in float32 activations: the port and JAX
# differ by about 2e-4 there, while an adapter mis-sliced on one rank (the
# single blocks' proj_out rows taken as a contiguous half) moves the
# velocity by about 4.5e-2, inside FORWARD_TOL; this bound catches it
LORA_TOL = 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(data, tensor, ti=0, di=0):
    """A rank's mesh without a process group: what the rules and shards
    need."""
    return tmesh.Mesh({"data": data, "tensor": tensor}, di, ti,
                      torch.device("cpu"))


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """The tiny pipeline's float DiT (the port's init, as
    tests/test_torch_infer_cli.py makes it), its JAX config, and JAX's
    int8 trees: unfused, TP layout, and unfused with active LoRA adapters
    on `DEFAULT_TARGETS` (rank 2, B random, scale 1) (numpy)."""
    tp = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    cfg = tp.flux_cfg
    jcfg = jmodel.FluxConfig(**dataclasses.asdict(cfg))
    jflux = jax.tree.map(jnp.asarray, to_numpy_tree(tp.params["flux"]))
    q = jquant.quantize_tree(jflux)
    fused = dict(q)
    for name in ("double_blocks", "single_blocks"):
        fused[name] = jquant.fuse_qkv_projections(q[name], tp_layout=True)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    gen = torch.Generator().manual_seed(4)
    lora = add_lora(from_numpy_tree(as_np(q), "cpu"), r=2, alpha=2,
                    dtype=torch.float32, generator=gen)
    for path, b in _walk(lora):
        if path.endswith("lora_b"):
            b.normal_(generator=gen).mul_(LORA_B_STD)
    return dict(cfg=cfg, jcfg=jcfg, float=as_np(jflux), int8=as_np(q),
                tp=as_np(fused), lora=to_numpy_tree(lora))


@pytest.mark.parametrize("tree", ["int8", "tp", "float", "lora"])
def test_param_sharding_rules_match_jax(tiny, tree):
    jtree = jax.tree.map(jnp.asarray, tiny[tree])
    want = {p: tuple(s.spec) for p, s in _walk(
        j_rules(jtree, j_make_mesh(data=4, tensor=2)))}
    got = dict(_walk(param_sharding_rules(from_numpy_tree(tiny[tree], "cpu"),
                                          _cpu_mesh(4, 2))))
    assert got == want
    assert any("tensor" in s for s in got.values())
    whole = param_sharding_rules(from_numpy_tree(tiny[tree], "cpu"),
                                 _cpu_mesh(8, 1))
    assert all(s == () for _, s in _walk(whole))


def test_flat_fused_refusal_matches_jax(tiny):
    flat = jquant.fuse_qkv_projections(jax.tree.map(jnp.asarray, tiny["int8"]))
    with pytest.raises(ValueError) as jerr:
        j_rules(flat, j_make_mesh(data=4, tensor=2))
    with pytest.raises(ValueError) as terr:
        param_sharding_rules(from_numpy_tree(jax.tree.map(np.asarray, flat),
                                             "cpu"), _cpu_mesh(4, 2))
    assert str(terr.value) == str(jerr.value)


def test_fuse_qkv_tp_layout_matches_jax(tiny):
    got = tquant.fuse_qkv_projections(from_numpy_tree(tiny["int8"], "cpu"),
                                      tp_layout=True)
    want = dict(_walk(tiny["tp"]))
    got = {p: v.numpy() for p, v in _walk(got)}
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)
    qkv = got["double_blocks/attn/to_qkv/kernel_q"]
    assert qkv.ndim == 4 and qkv.shape[-2] == 3


@pytest.mark.parametrize("t", [2, 4])
def test_shards_put_back_equal_the_leaf(tiny, t):
    """Every leaf's shards over t ranks, put back (concatenated along the
    split dim; proj_out's rows by `proj_out_rows`), equal the leaf."""
    tree = from_numpy_tree(tiny["tp"], "cpu")
    specs = dict(_walk(param_sharding_rules(tree, _cpu_mesh(1, t))))
    shards = [dict(_walk(shard_params(tree, _cpu_mesh(1, t, ti))))
              for ti in range(t)]
    split = 0
    for path, leaf in _walk(tree):
        parts = [s[path] for s in shards]
        if "tensor" not in specs[path]:
            assert all(p is leaf for p in parts), path
            continue
        split += 1
        dim = specs[path].index("tensor")
        assert all(p.is_contiguous() for p in parts)
        if "single_blocks/proj_out/" in path:
            back = torch.empty_like(leaf)
            hidden = leaf.shape[-1]
            for ti, p in enumerate(parts):
                rows = tmesh.proj_out_rows(leaf.shape[dim], hidden, t, ti)
                back.index_copy_(dim, rows, p)
        else:
            back = torch.cat(parts, dim)
        torch.testing.assert_close(back, leaf, rtol=0, atol=0, msg=path)
    assert split >= 10


@pytest.mark.parametrize("t", [2, 4])
def test_shard_shapes_stay_on_their_hopper_routes(t):
    """Every stacked GEMM a rank of tensor t launches (the shapes of its
    shard of the FLUX.1-dev TP bundle, built on the meta device) takes the
    wgmma route in both MAC modes, the fused qkv within its kernel's rules,
    a rank's heads the wgmma flash forward; chip_smoke's phase-2 shard
    cases are among them."""
    cfg = FluxConfig.flux_dev()
    tree = tquant.fuse_qkv_projections(random_quantized_like(
        init_flux_params(cfg, dtype=torch.bfloat16, device="meta"),
        device="meta"), tp_layout=True)
    shapes = set()
    for path, leaf in _walk(shard_params(tree, _cpu_mesh(1, t))):
        if not path.endswith("/kernel_q") or "blocks/" not in path:
            continue
        if leaf.ndim == 4:
            k, n = leaf.shape[1], 3 * leaf.shape[-1]
            assert tqmm.qkv_supported(k, n, cfg.head_dim), path
            shapes.add(("qmm_qkv_stacked", k, n))
        else:
            k, n = leaf.shape[1:]
            shapes.add(("qmm_stacked", k, n))
        for w8a8 in (True, False):
            group, k_pad = tqmm.stacked_w8a8_group(k, n)
            assert tqmm.qmm_route(k, n, group, k_pad, w8a8) == "wgmma", (
                path, k, n, w8a8)
    assert cfg.num_heads % t == 0 and fa.flash_fwd_route(cfg.head_dim) == (
        "wgmma")
    if t == 2:
        for kernel, _, _, k, n, _, _ in chip_smoke.tp2_cases():
            assert (kernel, k, n) in shapes


def test_proj_out_rows_follow_the_local_concat():
    """Rank r's proj_out rows: its attention heads, then its MLP columns."""
    rows = tmesh.proj_out_rows(10, 2, 2, 1)
    assert rows.tolist() == [1, 6, 7, 8, 9]
    with pytest.raises(ValueError):
        tmesh.proj_out_rows(11, 2, 2, 0)


def test_shard_params_refuses_split_proj_out(tiny):
    tree = tquant.split_single_proj_out(from_numpy_tree(tiny["int8"], "cpu"),
                                        tiny["cfg"].hidden)
    with pytest.raises(ValueError, match="split_proj_out=False"):
        shard_params(tree, _cpu_mesh(1, 2))
    assert shard_params(tree, _cpu_mesh(2, 1)) is not None


def test_shard_batch_takes_the_data_ranks_rows():
    batch = {"x": torch.arange(12.0).reshape(4, 3), "ids": torch.zeros(3, 3),
             "s": torch.tensor(1.0), "nested": [torch.arange(4)]}
    got = shard_batch(batch, _cpu_mesh(2, 2, ti=1, di=1))
    assert got["x"].tolist() == [[6.0, 7.0, 8.0], [9.0, 10.0, 11.0]]
    assert got["ids"] is batch["ids"] and got["s"] is batch["s"]
    assert got["nested"][0].tolist() == [2, 3]
    assert shard_batch(batch, _cpu_mesh(1, 2))["x"] is batch["x"]


def test_make_mesh_one_process():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "tensor": 1}
    assert (mesh.rank, mesh.tensor_group, mesh.data_group) == (0, None, None)
    with pytest.raises(ValueError, match="tensor=2"):
        make_mesh(tensor=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="refuses two ranks on one device"):
        tmesh.rank_device("cuda:0", "nccl")
    assert tmesh.rank_device("cuda:0", "gloo") == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="does not exist"):
        tmesh.rank_device("cuda:1", "gloo")


def test_contexts_and_the_local_row_call():
    mesh = _cpu_mesh(2, 2)
    assert tmesh.current_tp() is None and tmesh.current_dp() is None
    with tmesh.mesh_context(mesh):
        assert tmesh.current_tp() == (mesh, "tensor")
        assert tmesh.current_dp() == (mesh, "data")
        assert tmesh.tensor_extent() == 2
        with tmesh.tp_context(_cpu_mesh(2, 1)):
            assert tmesh.current_tp() is None and tmesh.current_dp() is None
        assert tmesh.current_dp() == (mesh, "data")
    assert tmesh.current_tp() is None and tmesh.tensor_extent() == 1
    # a rank's call runs on its own rows as they are: serving (grad off)
    # and outside a tensor context the column split's copy is x itself
    x = torch.arange(6.0, requires_grad=True).reshape(3, 2)
    with torch.no_grad(), tmesh.mesh_context(mesh):
        assert copy_to_tensor(x) is x
    assert copy_to_tensor(x) is x


# ---------------------------------------------------------------------------
# Spawned ranks: the jobs and the JAX references
# ---------------------------------------------------------------------------


def _attention_cases():
    """tests/test_tp_attention.py's cases at S 128: 8 heads."""
    b, h, s, d = 1, 8, 128, 64
    ks = jax.random.split(jax.random.key(0), 4)
    q, k, v = (np.asarray(jax.random.normal(kk, (b, h, s, d), jnp.float32))
               for kk in ks[:3])
    ids = jax.random.uniform(ks[3], (s, 3)) * 16
    rope = tuple(np.asarray(r) for r in j_rope_embed(ids, (d // 2, d // 4,
                                                          d // 4)))
    return {"no_union": (q, k, v, dict(cond_start=96, mode="no_union"), None),
            "rope_cfactor": (q, k, v, dict(cond_start=96, c_factor=0.5),
                             rope)}


def _jax_attention(q, k, v, kw, rope):
    mesh = j_make_mesh(data=1, tensor=8)
    shard = NamedSharding(mesh, P(None, "tensor", None, None))
    cf = kw.get("c_factor")
    return np.asarray(j_tp_flash(
        mesh, *(jax.device_put(jnp.asarray(a), shard) for a in (q, k, v)),
        cond_start=kw["cond_start"], mode=kw.get("mode", "union"),
        c_factor=None if cf is None else jnp.float32(cf),
        rope=None if rope is None else tuple(jnp.asarray(r) for r in rope),
        interpret=True))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _tp_quant_cases():
    """Weight-only operands at M 12, K 256, N 256, a stack of 2 (block 1);
    x bf16-valued, the ab rows' a powers of two (tests/test_torch_fused_ew.
    py's data)."""
    rng = np.random.default_rng(11)
    m, k, n, nb = 12, 256, 256, 2
    x = _bf16(1.5 * rng.standard_normal((m, k)) + 0.25)
    w = rng.integers(-128, 128, (nb, k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 3e-3, (nb, 1, n)).astype(np.float32)
    bias = (0.05 * rng.standard_normal((nb, n))).astype(np.float32)
    ab = np.zeros((8, k), np.float32)
    ab[0], ab[2] = (np.exp2(rng.integers(-1, 2, (2, k)))
                    * rng.choice([-1.0, 1.0], (2, k)))
    ab[1], ab[3] = 0.5 * rng.standard_normal((2, k))
    gate = np.zeros((8, n), np.float32)
    gate[:2] = rng.standard_normal((2, n))
    resid = _bf16(rng.standard_normal((m, n)))
    base = dict(x=x, w=w, scale=scale, bias=bias, blk=1)
    return {
        "col": ("col", base),
        "col_gelu": ("col", dict(base, activation="gelu_tanh")),
        "col_prologue": ("col", dict(base, activation="gelu_tanh", ab=ab,
                                     boundary=7)),
        "row": ("row", base),
        "row_gate": ("row", dict(base, resid=resid, gate=gate, boundary=5)),
        "repl": ("repl", base),
    }


def _jax_tp_quant(kind, op):
    mesh = j_make_mesh(data=4, tensor=2)
    arrays = {k: (None if op.get(k) is None else jnp.asarray(op[k]))
              for k in ("x", "w", "scale", "bias", "ab", "resid", "gate")}

    def run(a):
        return j_tp_qmm(kind, a["x"], a["w"], a["scale"], jnp.int32(op["blk"]),
                        bias2=a["bias"], activation=op.get("activation"),
                        ab=a["ab"], seg_boundary=op.get("boundary", 0),
                        resid=a["resid"], gate=a["gate"])

    with j_tp_context(mesh):
        return np.asarray(jax.jit(run)(arrays), np.float32)


def _port_unsharded(op):
    bias3 = _t(op["bias"]).reshape(2, 1, -1)
    return tqmm.quant_matmul_stacked(
        _t(op["x"]), _t(op["w"]), _t(op["scale"]), op["blk"], bias3=bias3,
        activation=op.get("activation"),
        ab=None if op.get("ab") is None else _t(op["ab"]),
        resid=None if op.get("resid") is None else _t(op["resid"]),
        gate=None if op.get("gate") is None else _t(op["gate"]),
        seg_boundary=op.get("boundary", 0)).float().numpy()


def _batch(cfg, b, seed=1):
    keys = jax.random.split(jax.random.key(seed), 4)
    return {
        "img": np.asarray(jax.random.normal(keys[0], (b, 16, cfg.in_channels))),
        "txt": np.asarray(jax.random.normal(keys[1], (b, 4, cfg.joint_dim))),
        "pooled": np.asarray(jax.random.normal(keys[2], (b, cfg.pooled_dim))),
        "timestep": np.asarray([0.5, 0.3][:b], np.float32),
        "guidance": np.full((b,), 3.5, np.float32),
        "img_ids": np.asarray(j_ids(8, 8)),
        "txt_ids": np.zeros((4, 3), np.float32),
        "cond": np.asarray(jax.random.normal(keys[3], (b, 16, cfg.in_channels))),
        "cond_ids": np.asarray(j_ids(8, 8)),
    }


def _jax_forward(params, jcfg, batch, stacked, mesh=None):
    """JAX's flux_forward (XLA attention): unsharded with its XLA dequant
    products, or with its stacked kernels per shard under ``tp_context``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(jnp.asarray, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LOONGX_STACKED_QMM", "1" if stacked else "0")
        jax.clear_caches()  # the knob is read at trace time
        fwd = jax.jit(lambda p, b: jmodel.flux_forward(
            p, jcfg, **b, attn_backend="xla"))
        if mesh is None:
            out = fwd(params, jb)
        else:
            with j_tp_context(mesh):
                out = fwd(j_shard_params(params, mesh), jb)
        out = np.asarray(out, np.float32)
    jax.clear_caches()
    return out


def _cli_inputs(root, cfg):
    """A checkpoint of the tiny pipeline (stand-in encoders and DGF: the
    brain encode is faked in every process), three 16x16 PNGs with their
    signals."""
    from PIL import Image
    from loongx_tpu_torch.utils.checkpoint import save_pipeline

    pipe = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    pipe.params["encoders"] = {"eeg": {"w": torch.zeros(1)},
                               "fnirs": {"w": torch.zeros(1)}}
    pipe.params["dgf"] = {"w": torch.zeros(1)}
    ckpt = save_pipeline(pipe, str(root / "ckpt"))
    in_dir = root / "in"
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    brain = {}
    for i in range(3):
        name = f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), np.uint8)).save(
            in_dir / name)
        brain[name] = {"EEG": rng.standard_normal((1, 4, 64)).astype(np.float32),
                       "FNIRS": rng.standard_normal((1, 6, 32)).astype(np.float32)}
    pkl = root / "brain.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(brain, f)
    return ["--checkpoint", ckpt, "--components", "flux,vae,encoders,dgf",
            "--int8", "--neural_only", "--input_dir", str(in_dir),
            "--brain_data_path", str(pkl), "--steps", str(STEPS),
            "--target_size", str(SIZE), "--seed", "1", "--device", "cpu"]


def _read_dir(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def cli(tmp_path_factory, tiny):
    """The CLI's arguments and its --tensor 1 directory run here."""
    root = tmp_path_factory.mktemp("cli")
    argv = _cli_inputs(root, tiny["cfg"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: one thread's sum order
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tgen, "brain_encode", ranks._fake_brain_encode)
            tinfer.main(argv + ["--batch_size", "2", "--output_dir",
                                str(root / "tensor1")])
    finally:
        torch.set_num_threads(threads)
    return argv, root, _read_dir(root / "tensor1")


@pytest.fixture(scope="module")
def world2(tiny, cli):
    argv, root, _ = cli
    job = {"attention": list(_attention_cases().values()),
           "tp_quant": list(_tp_quant_cases().values()),
           "flux": tiny["tp"], "flux_lora": tiny["lora"], "cfg": tiny["cfg"],
           "batch": _batch(tiny["cfg"], 1),
           "cli_argv": argv + ["--tensor", "2", "--batch_size", "2"],
           "cli_out": str(root / "world2")}
    return spawn_ranks(ranks.tensor2, 2, (job,), timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world4(tiny, cli):
    argv, root, _ = cli
    pipe = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    c = pipe.flux_cfg
    gen = {"latents": rng.standard_normal((2, 16, c.in_channels)),
           "prompt_embeds": rng.standard_normal((2, 8, c.joint_dim)),
           "pooled_prompt_embeds": rng.standard_normal((2, c.pooled_dim)),
           "cond_tokens": rng.standard_normal((2, 16, c.in_channels)),
           "cond_ids": latent_image_ids(8, 8, device="cpu").numpy()}
    gen = {k: np.asarray(v, np.float32) for k, v in gen.items()}
    job = {"flux": tiny["tp"], "cfg": tiny["cfg"],
           "batch": _batch(tiny["cfg"], 2), "generate": gen,
           "cli_argv": argv + ["--tensor", "2"],
           "cli_out": str(root / "world4")}
    out = spawn_ranks(ranks.data2_tensor2, 4, (job,), timeout=SPAWN_TIMEOUT)
    want = tgen.generate(pipe, cond_ids=_t(gen["cond_ids"]), height=SIZE,
                         width=SIZE, num_inference_steps=STEPS,
                         output_type="latent",
                         **{k: _t(v) for k, v in gen.items()
                            if k != "cond_ids"}).numpy()
    return out, job, {"port": want, "jax": _jax_generate_sharded(pipe, gen)}


def _jax_generate_sharded(tp, gen):
    """JAX's generate of the port pipeline ``tp``'s weights under its data 2
    x tensor 2 mesh (4 of the 8 virtual devices): the DiT sharded by its
    rules, each batch input by rows over the data axis, as its CLI's
    batch_edit places them."""
    cfgs = {"flux_cfg": jmodel.FluxConfig, "vae_cfg": jvae.VAEConfig,
            "t5_cfg": jt5.T5Config, "clip_cfg": jclip.CLIPTextConfig}
    c = {k: cls(**dataclasses.asdict(getattr(tp, k))) for k, cls in cfgs.items()}
    tree = jax.tree.map(jnp.asarray, to_numpy_tree(tp.params))
    mesh = j_make_mesh(data=2, tensor=2, devices=jax.devices()[:4])
    tree["flux"] = j_shard_params(tree["flux"], mesh)
    jp = JPipeline(params=tree, dtype=jnp.float32, **c)
    rows = NamedSharding(mesh, P("data"))
    put = {k: jax.device_put(jnp.asarray(gen[k]), rows)
           for k in ("latents", "prompt_embeds", "pooled_prompt_embeds",
                     "cond_tokens")}
    with j_mesh_context(mesh):
        out = j_generate(jp, cond_ids=jnp.asarray(gen["cond_ids"]),
                         height=SIZE, width=SIZE, num_inference_steps=STEPS,
                         output_type="latent", **put)
    return np.asarray(out)


def test_ranks_hold_their_mesh_places(world2, world4):
    assert [r["mesh"] for r in world2] == [
        ({"data": 1, "tensor": 2}, 0, t, "gloo") for t in range(2)]
    assert [r["mesh"] for r in world4[0]] == [
        ({"data": 2, "tensor": 2}, d, t, "gloo") for d in range(2)
        for t in range(2)]


@pytest.mark.parametrize("case", list(_attention_cases()))
def test_tp_flash_attention_matches_jax(world2, case):
    i = list(_attention_cases()).index(case)
    want = _jax_attention(*_attention_cases()[case])
    got = np.concatenate([r["attention"][i] for r in world2], axis=1)
    tol = 2e-5 if case == "no_union" else 3e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("case", list(_tp_quant_cases()))
def test_tp_quant_matmul_stacked_matches_jax(world2, case):
    i = list(_tp_quant_cases()).index(case)
    kind, op = _tp_quant_cases()[case]
    outs = [r["tp_quant"][i] for r in world2]
    if kind == "col":
        got = np.concatenate(outs, axis=-1)
    else:  # the sum (or the whole product) on every rank
        np.testing.assert_array_equal(outs[0], outs[1])
        got = outs[0]
    want = _jax_tp_quant(kind, op)
    tol = 2 * BF16_ULP * np.abs(want) + 1e-4 * np.abs(want).max()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # the unsharded product rounds once, the row split each partial first:
    # two roundings of the largest output
    ref = _port_unsharded(op)
    assert np.abs(got - ref).max() <= 2 * BF16_ULP * np.abs(ref).max()


def test_tp_forward_matches_jax_tp_and_unsharded(world2, tiny):
    batch = _batch(tiny["cfg"], 1)
    got = world2[0]["forward"]
    np.testing.assert_array_equal(got, world2[1]["forward"])
    want_tp = _jax_forward(tiny["tp"], tiny["jcfg"], batch, True,
                           j_make_mesh(data=4, tensor=2))
    want = _jax_forward(tiny["int8"], tiny["jcfg"], batch, False)
    np.testing.assert_allclose(got, want_tp, atol=FORWARD_TOL,
                               rtol=FORWARD_TOL)
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=FORWARD_TOL)


def test_tp_forward_with_lora_matches_jax_tp_and_unsharded(world2, tiny):
    """Active LoRA adapters on every target: the col (q/k/v, proj_mlp), row
    (to_out, ff.out) and row_cat (single blocks' proj_out) deltas and the
    dequantised products, held against JAX's TP and unsharded forwards
    within FORWARD_TOL and the tighter LORA_TOL."""
    batch = _batch(tiny["cfg"], 1)
    got = world2[0]["forward_lora"]
    np.testing.assert_array_equal(got, world2[1]["forward_lora"])
    want_tp = _jax_forward(tiny["lora"], tiny["jcfg"], batch, True,
                           j_make_mesh(data=4, tensor=2))
    want = _jax_forward(tiny["lora"], tiny["jcfg"], batch, False)
    for tol in (FORWARD_TOL, LORA_TOL):
        np.testing.assert_allclose(got, want_tp, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    # the adapters move the velocity well past the bound
    base = _jax_forward(tiny["int8"], tiny["jcfg"], batch, False)
    assert np.abs(want - base).max() > 4 * FORWARD_TOL


def test_tp_forward_fused_elementwise_matches_jax(world2, tiny):
    got = world2[0]["forward_fused"]
    np.testing.assert_array_equal(got, world2[1]["forward_fused"])
    want = _jax_forward(tiny["int8"], tiny["jcfg"], _batch(tiny["cfg"], 1),
                        False)
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=FORWARD_TOL)


def test_2d_mesh_fused_elementwise_keeps_global_segments(world4, tiny):
    """Batch 2 over data 2 x tensor 2: each data rank's one row through the
    fused prologue and gate epilogue, segments at the global boundary."""
    out, job, _ = world4
    rows = [r["forward_fused"] for r in out]
    np.testing.assert_array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(rows[2], rows[3])
    got = np.concatenate([rows[0], rows[2]])
    want = _jax_forward(tiny["int8"], tiny["jcfg"], job["batch"], False)
    np.testing.assert_allclose(got, want, atol=FORWARD_TOL, rtol=FORWARD_TOL)


def test_batch_sharded_generate_matches_single_process(world4):
    """The data ranks' rows, gathered, against JAX's generate under its data
    2 x tensor 2 mesh, and against the port's single-process generate."""
    out, _, want = world4
    got = np.concatenate([out[0]["generate"], out[2]["generate"]])
    np.testing.assert_array_equal(out[0]["generate"], out[1]["generate"])
    assert got.shape == want["jax"].shape
    np.testing.assert_allclose(got, want["jax"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, want["port"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_cli_tensor2_writes_the_files_of_tensor1(cli, world, request):
    """--tensor 2 (world 2: groups of 2 and 1; world 4: data 2, the tail
    group padded) writes the files of --tensor 1, each from the rank that
    edited it (tensor index 0), the images within CLI_TOL."""
    _, root, want = cli
    res = request.getfixturevalue(world)
    res = res[0] if world == "world4" else res
    assert sorted(os.listdir(root / world)) == sorted(want)
    assert len(want) == 3
    # by rank: tensor index 0 of each data rank writes the rows it edited
    assert [r["cli"] for r in res] == (
        [sorted(want), []] if world == "world2"
        else [["img0.png", "img2.png"], [], ["img1.png"], []])
    for name, img in _read_dir(root / world).items():
        assert img.shape == (SIZE, SIZE, 3)
        diff = np.abs(img.astype(np.int32) - want[name].astype(np.int32))
        assert diff.max() <= CLI_TOL, (name, diff.max())
