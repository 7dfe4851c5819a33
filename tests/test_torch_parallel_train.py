"""Training under a data x tensor mesh (``train/step.py``, ``train/loop.py``,
``parallel/``) against the JAX package's one-device step and the port's
one-process step, on the CPU.

The port's ranks run in spawned gloo process groups
(`parallel.launch.spawn_ranks`): world 2 (the step over data 2 and over
tensor 2, then the loop) and world 4 (data 2 x tensor 2), one spawn each,
started together (tests/torch_parallel_train_ranks.py; the ranks import no
JAX).  The references are computed here while they run: JAX's
``make_train_step`` with its Pallas attention in interpret mode (forward
and backward kernels) and its dequantised int8 products, and the port's
one-process step, loop and CLI.  (JAX's stacked int8 kernels,
``LOONGX_STACKED_QMM=1``, round float32 activations to bf16: at this
geometry their step differs from JAX's own dequantised step by 2.2e-5 in
the loss and 6.7e-3 rel L2 in the LoRA gradients, so the float32 bounds
below are held against the dequantised step; the port's plain versions
match it within 2.4e-7 and 2.6e-6.)

The step: ``LoongXPipeline.tiny``'s DiT widths (2 + 2 blocks, 2 heads),
int8 weight-only in the training layout (q/k/v unfused, proj_out whole),
LoRA r 2 on every default target (B moved off zero), a condition stream,
configs/seed_512.yaml's flags, remat, float32, a global batch of 2, the
draws of one JAX step key, SGD.  Held to:

  * data 2 against JAX: loss within rtol 1e-5, every LoRA gradient within
    rel L2 1e-4 (tests/test_torch_train.py's port-vs-JAX bounds);
  * data 2 against the port's one process at batch 2: loss and grad norm
    within rtol 1e-5, every LoRA leaf after the step within 1e-5
    (tests/test_parallel.py's bounds);
  * tensor 2 and data 2 x tensor 2 against both, leaf by leaf: every LoRA
    gradient within rel L2 ``TP_GRAD_REL_L2`` of JAX's and of the one
    process's (float32: the splits only reorder sums; the port's
    one-process floor against JAX is printed beside), the leaves after the
    step as the data bounds;
  * the routes: with grad enabled no stacked int8 product reaches a
    forward-only call, every rank runs the kernels' autograd Functions once
    per stacked linear and pass (forward and remat); d loss / d
    (prompt_embeds, cond_tokens) of each rank's rows within rel L2 1e-5
    of the one process's (a dropped or doubled dx anywhere moves it).

The loop: `train.loop.train` from ``mesh: {data: 2}`` (float32 tiny
pipeline, the synthetic corpus, 2 optimizer steps of 2 micro-batches, SGD)
against the one-process run at the global batch: the same steps, the LoRA
leaves and the LoRA file / train state of each step within 1e-5, only rank
0 writing; a resume at world 2 to step 3, equal to the one process's
resume; ``mesh: {data: 3}`` at world 2 refused by name.  ``cli.train.main``
under ``mesh: {tensor: 2}`` and ``{data: 2, tensor: 2}`` (the directory
loaded in bf16, the probe at step 2 on the tensor ranks of data row 0,
rank 0 writing its image) against the one-process CLI at the global
batch: LoRA files within ``CLI_REL_L2`` (bf16 sums in another order).

The launchers: every ``scripts/*_torch.sh`` parses and calls a CLI of
the port that exists, with options it takes.
"""

import concurrent.futures
import dataclasses
import json
import os
import pickle
import re
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from safetensors.numpy import load_file

import torch_parallel_train_ranks as ranks
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.ops import quant as jquant
from loongx_tpu.ops.latents import latent_image_ids as j_ids
from loongx_tpu.train import lora as jlora
from loongx_tpu.train import step as jstep
from loongx_tpu_torch.models.encoders import BatchRows, _apply_mlp_ln_relu
from loongx_tpu_torch.ops.nn import init_layer_norm, init_linear
from loongx_tpu_torch.parallel import mesh as tmesh
from loongx_tpu_torch.parallel.launch import spawn_ranks
from loongx_tpu_torch.train import step as tstep
from loongx_tpu_torch.utils import checkpoint as tckpt
from loongx_tpu_torch.utils.bridge import to_numpy_tree

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

SPAWN_TIMEOUT = 300.0
FLAGS = {"union_cond_attn": True, "add_cond_attn": False,
         "latent_lora": False}  # configs/seed_512.yaml
LR = 0.1
B, SIZE = 2, 16
JAX_GRAD_REL_L2 = 1e-4  # tests/test_torch_train.py:427
TP_GRAD_REL_L2 = 1e-4  # float32: the splits reorder sums (5e-2 the limit)
DX_REL_L2 = 1e-5
CLI_REL_L2 = 3e-2  # bf16 activations summed in another order
MESHES = ("data2", "tensor2", "data2_tensor2")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# The step's inputs and the JAX reference
# ---------------------------------------------------------------------------


def _step_job():
    """The JAX int8 training tree of the tiny pipeline's DiT, the global
    batch, one JAX step key's draws (loongx_tpu/train/step.py's split)."""
    tp = ranks.tiny_pipeline()
    cfg = tp.flux_cfg
    jflux = jax.tree.map(jnp.asarray, to_numpy_tree(tp.params["flux"]))
    flux = jlora.add_lora(jax.random.key(1), jquant.quantize_tree(jflux), r=2,
                          dtype=jnp.float32)

    def nudge(path, x):  # B off zero: both factors have gradients
        if path[-1].key == "lora_b":
            r = np.random.default_rng(x.size)
            return x + jnp.asarray(0.05 * r.standard_normal(x.shape), x.dtype)
        return x

    flux = jax.tree_util.tree_map_with_path(nudge, flux)
    keys = jax.random.split(jax.random.key(5), 4)
    batch = {
        "x0": jax.random.normal(keys[0], (B, 16, cfg.in_channels)),
        "cond_tokens": jax.random.normal(keys[1], (B, 16, cfg.in_channels)),
        "prompt_embeds": jax.random.normal(keys[2], (B, 4, cfg.joint_dim)),
        "pooled": jax.random.normal(keys[3], (B, cfg.pooled_dim)),
        "img_ids": j_ids(8, 8), "cond_ids": j_ids(8, 8),
        "txt_ids": jnp.zeros((4, 3)),
    }
    key = jax.random.key(9)
    k_t, k_noise, _ = jax.random.split(key, 3)
    draws = {"t": jax.nn.sigmoid(jax.random.normal(k_t, (B,), jnp.float32)),
             "noise": jax.random.normal(k_noise, (B, 16, cfg.in_channels),
                                        jnp.float32)}
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(params={"flux": as_np(flux)}, batch=as_np(batch),
                draws=as_np(draws), cfg=cfg, flags=FLAGS, lr=LR), key


def _jax_step(job, key):
    """JAX's one-device step at the global batch: Pallas attention in
    interpret mode, the dequantised int8 products, remat; the raw gradients
    kept by a pass-through first in the chain."""
    def recorder():
        return optax.GradientTransformation(
            lambda params: params,
            lambda updates, state, params=None: (updates, updates))

    params = jax.tree.map(jnp.asarray, job["params"])
    trainable, frozen = jstep.partition(params, jstep.trainable_mask(params))
    init_fn, step_fn = jstep.make_train_step(
        jmodel.FluxConfig(**dataclasses.asdict(job["cfg"])),
        optax.chain(recorder(), optax.sgd(LR)), flags=FLAGS,
        attn_backend="pallas", remat=True, grad_clip=None, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LOONGX_STACKED_QMM", "0")
        jax.clear_caches()  # the knob is read at trace time
        state, m = jax.jit(step_fn)(
            init_fn(trainable), frozen,
            {k: jnp.asarray(v) for k, v in job["batch"].items()}, key)
        out = {k: float(v) for k, v in m.items()}
        out["grads"] = {k: np.asarray(v) for k, v in jlora.lora_state_dict(
            state.opt_state[0]["flux"]).items()}
    jax.clear_caches()
    return out


# ---------------------------------------------------------------------------
# The loop's inputs
# ---------------------------------------------------------------------------


def _corpus(root):
    """tests/test_torch_train_loop.py's synthetic L-Mind corpus: 4 rows of
    16x16 PNG pairs, instructions and four biosignals."""
    from PIL import Image

    img_dir = root / "imgs"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows, bio = [], {}
    for i in range(4):
        for tag in (0, 1):
            Image.fromarray(rng.randint(0, 255, (SIZE, SIZE, 3), np.uint8)
                            ).save(img_dir / f"s{i}_{tag}.png")
        rows.append({"source_image": f"imgs/s{i}_0.png",
                     "target_image": f"imgs/s{i}_1.png",
                     "instruction": f"edit {i}"})
        bio[f"s{i}_0.png"] = {
            "EEG": rng.randn(4, 64).astype(np.float32),
            "FNIRS": rng.randn(6, 32).astype(np.float32),
            "PPG": rng.randn(4, 32).astype(np.float32),
            "Motion": rng.randn(6, 16).astype(np.float32),
        }
    jsonl = root / "train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    with open(root / "data_final.pkl", "wb") as f:
        pickle.dump(bio, f)
    return str(jsonl), str(root), SIZE


def _raw(save, mesh, batch_size, corpus, **train):
    """A run's config as YAML-shaped data: 2 optimizer steps of 2
    micro-batches, SGD, remat, a LoRA file and train state each step."""
    jsonl, root, size = corpus
    t = dict(batch_size=batch_size, accumulate_grad_batches=2, max_steps=2,
             save_interval=1, sample_interval=0, save_path=str(save),
             gradient_checkpointing=True,
             dataset={"type": "img", "jsonl_path": jsonl, "image_dir": root,
                      "image_size": size, "target_size": size,
                      "condition_size": size},
             optimizer={"type": "SGD", "params": {"lr": LR}},
             dataloader_workers=1)
    t.update(train)
    return {"dtype": "float32", "mesh": mesh, "train": t}


def _yaml(path, raw):
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def _cli_argv(path, raw, ckpt):
    return ["--config", _yaml(path, dict(raw, flux_path=ckpt)), "--no_wandb",
            "--device", "cpu", "--no_resume"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, started together, and every reference computed here
    while they run."""
    root = tmp_path_factory.mktemp("mesh_train")
    step_job, key = _step_job()
    corpus = _corpus(root / "corpus")
    pipe = ranks.tiny_pipeline()
    ckpt = tckpt.save_pipeline(pipe, str(root / "ckpt"))
    vocab = {"t5": pipe.t5_cfg.vocab_size, "clip": pipe.clip_cfg.vocab_size}
    sample = dict(sample_interval=2)
    loop = {"corpus": corpus,
            "data2": _yaml(root / "d2.yaml", _raw(
                root / "loop_d2", {"data": 2}, 1, corpus)),
            "data2_resume": _yaml(root / "d2_resume.yaml", _raw(
                root / "loop_d2", {"data": 2}, 1, corpus, max_steps=3)),
            "data3": _yaml(root / "d3.yaml", _raw(
                root / "loop_d3", {"data": 3}, 1, corpus))}
    cli = {"vocab": vocab,
           "tensor2": _cli_argv(root / "t2.yaml", _raw(
               root / "cli_t2", {"tensor": 2}, 2, corpus, **sample), ckpt),
           "data2_tensor2": _cli_argv(root / "d2t2.yaml", _raw(
               root / "cli_d2t2", {"data": 2, "tensor": 2}, 1, corpus,
               **sample), ckpt)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w2 = pool.submit(spawn_ranks, ranks.world2, 2, (dict(
            step=step_job, loop=loop, cli=cli),), timeout=SPAWN_TIMEOUT)
        w4 = pool.submit(spawn_ranks, ranks.world4, 4, (dict(
            step=step_job, cli=cli),), timeout=SPAWN_TIMEOUT)
        one = ranks.train_step(None, step_job)
        jax_ref = _jax_step(step_job, key)
        loop_one = ranks.loop_train(_yaml(root / "one.yaml", _raw(
            root / "loop_1", {}, 2, corpus)), corpus)
        loop_one_resumed = ranks.loop_train(
            _yaml(root / "one_resume.yaml", _raw(
                root / "loop_1", {}, 2, corpus, max_steps=3)),
            corpus, resume=True)
        cli_one = ranks.cli_train(_cli_argv(root / "cli_one.yaml", _raw(
            root / "cli_1", {}, 2, corpus, **sample), ckpt), vocab)
        world2, world4 = w2.result(), w4.result()
    return dict(root=root, one=one, jax=jax_ref, world2=world2,
                world4=world4, loop_one=loop_one,
                loop_one_resumed=loop_one_resumed, cli_one=cli_one)


def _rank_steps(runs, name):
    world = runs["world4"] if name == "data2_tensor2" else runs["world2"]
    return [r[name] for r in world]


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def test_ranks_hold_their_mesh_places(runs):
    assert [r["mesh"] for r in runs["world2"]] == [
        (2, 0, "gloo"), (2, 1, "gloo")]
    assert [r["mesh"] for r in runs["world4"]] == [
        ({"data": 2, "tensor": 2}, d, t) for d in (0, 1) for t in (0, 1)]


@pytest.mark.parametrize("name", MESHES)
def test_every_rank_takes_the_same_step(runs, name):
    """Every rank of a mesh ends the step with the same LoRA leaves and
    metrics, bit for bit."""
    steps = _rank_steps(runs, name)
    for r in steps[1:]:
        for k in ("loss", "grad_norm", "t_mean"):
            assert r[k] == steps[0][k], (name, k)
        for path, leaf in r["after"].items():
            np.testing.assert_array_equal(leaf, steps[0]["after"][path], path)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_step_matches_jax(runs, name):
    """Loss and every LoRA gradient against JAX's one-device step at the
    global batch, beside the port's one-process floor."""
    step, jref, one = _rank_steps(runs, name)[0], runs["jax"], runs["one"]
    np.testing.assert_allclose(step["loss"], jref["loss"], rtol=1e-5)
    bound = JAX_GRAD_REL_L2 if name == "data2" else TP_GRAD_REL_L2
    assert set(step["grads"]) == {f"flux/{k}" for k in jref["grads"]}
    for key, want in jref["grads"].items():
        got = step["grads"][f"flux/{key}"]
        if not np.abs(want).max() > 0:
            # a structural zero: the last single block's q/k LoRA acts only
            # on condition rows, which the velocity never reads
            np.testing.assert_array_equal(got, want, key)
            continue
        floor = _rel_l2(one["grads"][f"flux/{key}"], want)
        assert _rel_l2(got, want) < bound, (key, _rel_l2(got, want), floor)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_step_matches_one_process(runs, name):
    """Loss, grad norm and t_mean, every LoRA gradient and every LoRA leaf
    after the SGD step against the port's one-process step."""
    step, one = _rank_steps(runs, name)[0], runs["one"]
    for k in ("loss", "grad_norm", "t_mean"):
        np.testing.assert_allclose(step[k], one[k], rtol=1e-5, err_msg=k)
    bound = JAX_GRAD_REL_L2 if name == "data2" else TP_GRAD_REL_L2
    assert step["grads"].keys() == one["grads"].keys()
    for path, want in one["grads"].items():
        got = step["grads"][path]
        if not np.abs(want).max() > 0:
            np.testing.assert_array_equal(got, want, path)
            continue
        assert _rel_l2(got, want) < bound, (path, _rel_l2(got, want))
    for path, want in one["after"].items():
        np.testing.assert_allclose(step["after"][path], want, rtol=1e-5,
                                   atol=1e-5, err_msg=path)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_step_routes_and_input_gradients(runs, name):
    """No forward-only int8 product with grad enabled; the kernels'
    autograd Functions on the rank's shard for every stacked linear, in the
    forward and in its remat re-run; d loss / d inputs of each rank's rows
    equal to the one process's (each rank's loss is the mean of its rows:
    scaled by the data extent)."""
    steps, one = _rank_steps(runs, name), runs["one"]
    data = 1 if name == "tensor2" else 2
    nd, ns = 2, 2  # the tiny DiT's blocks
    # a double block: q, k, v, add q/k/v, to_out, to_add_out, ff.in/out,
    # ff_context.in/out and its two modulation linears (whole on every
    # rank); a single block: q, k, v, proj_mlp, proj_out, its modulation
    stacked = 14 * nd + 6 * ns
    for rank, step in enumerate(steps):
        assert step["counts"].get("forward_only", 0) == 0, (
            rank, step["counts"])
        assert step["counts"].get("stacked_fn", 0) == 2 * stacked, (
            rank, step["counts"])
        d = rank // (len(steps) // data)
        rows = slice(d * B // data, (d + 1) * B // data)
        for k, g in step["dx"].items():
            ref = one["dx"][k][rows]
            assert _rel_l2(g / data, ref) < DX_REL_L2, (rank, k,
                                                        _rel_l2(g / data, ref))


def test_batch_rows_dropout_are_the_global_draws_rows():
    """A data rank's dropout masks (`BatchRows`) are its rows of the masks
    one process draws for the global batch from the same generator, layer
    after layer."""
    g = torch.Generator().manual_seed(0)
    p = {"linear_0": init_linear(6, 5, generator=g, dtype=torch.float32,
                                 device="cpu"),
         "ln_0": init_layer_norm(5, dtype=torch.float32, device="cpu"),
         "linear_1": init_linear(5, 4, generator=g, dtype=torch.float32,
                                 device="cpu"),
         "ln_1": init_layer_norm(4, dtype=torch.float32, device="cpu")}
    x = torch.randn(4, 6, generator=g)
    whole = _apply_mlp_ln_relu(p, x, 2, torch.Generator().manual_seed(3))
    for start in (0, 2):
        part = _apply_mlp_ln_relu(p, x[start:start + 2], 2, BatchRows(
            torch.Generator().manual_seed(3), start, start + 2, 4))
        torch.testing.assert_close(part, whole[start:start + 2], rtol=0,
                                   atol=0)
    assert not torch.equal(whole, _apply_mlp_ln_relu(p, x, 2, None))


def test_draws_take_the_data_ranks_rows():
    """Under a data axis `_draws` takes the rank's rows of the global
    batch's t, x1 and dropout masks, from a generator and from explicit
    draws alike."""
    x0 = torch.zeros(1, 3, 2)
    ref_t, ref_x1, _ = tstep._draws(torch.Generator().manual_seed(4),
                                    torch.zeros(2, 3, 2))
    masks = [torch.arange(8).reshape(2, 4) > 3]
    explicit = {"t": ref_t, "noise": ref_x1, "dropout": {"eeg": masks}}
    for d in (0, 1):
        with tmesh.mesh_context(tmesh.Mesh({"data": 2, "tensor": 1}, d, 0,
                                           torch.device("cpu"))):
            t, x1, drop = tstep._draws(torch.Generator().manual_seed(4), x0)
            assert drop["eeg"] == BatchRows(drop["eeg"].generator, d, d + 1, 2)
            t2, x12, drop2 = tstep._draws(explicit, x0)
        for got in ((t, x1), (t2, x12)):
            torch.testing.assert_close(got[0], ref_t[d:d + 1], rtol=0, atol=0)
            torch.testing.assert_close(got[1], ref_x1[d:d + 1], rtol=0,
                                       atol=0)
        assert torch.equal(drop2["eeg"][0], masks[0][d:d + 1])


@pytest.mark.parametrize("path,partial", [
    ("flux/double_blocks/attn/to_q/lora_a", True),
    ("flux/double_blocks/attn/to_q/lora_b", True),
    ("flux/double_blocks/attn/to_out/lora_a", True),
    ("flux/double_blocks/attn/to_out/lora_b", False),
    ("flux/single_blocks/proj_out/lora_a", True),
    ("flux/single_blocks/proj_out/lora_b", False),
    ("flux/single_blocks/proj_mlp/lora_b", True),
    ("flux/double_blocks/norm1/linear/lora_a", False),
    ("flux/x_embedder/lora_b", False),
    ("flux/double_blocks/attn/to_q/lora_scale", False),
])
def test_tensor_partial_grad_follows_the_split(path, partial):
    assert tmesh.tensor_partial_grad(path) is partial


# ---------------------------------------------------------------------------
# The loop and the CLI
# ---------------------------------------------------------------------------


def _run_dir(save, step):
    """The run directory under ``save`` that holds ``step``'s files (a
    resumed run writes a run directory of its own)."""
    (run,) = [r for r in os.listdir(save) if os.path.isdir(
        os.path.join(save, r, "ckpt", str(step)))]
    return os.path.join(save, run)


def _train_state(run_dir, step):
    d = os.path.join(run_dir, "train_state", f"step_{step}")
    tree = load_file(os.path.join(d, "trainable.safetensors"))
    return tree, torch.load(os.path.join(d, "train_state.pt"),
                            weights_only=False)


def _assert_close_tree(got, want, rtol, atol, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_close_tree(got[k], want[k], rtol, atol, f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, rtol, atol, f"{what}/{i}")
    elif isinstance(want, (torch.Tensor, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol, err_msg=what)
    else:
        assert got == want, what


def test_loop_data2_matches_one_process(runs):
    """`train.loop.train` over data 2 at batch 1 a rank: the one-process
    run at batch 2 -- its summary, its LoRA leaves on every rank, and rank
    0's LoRA file and train state of each step (fingerprint equal) -- with
    only rank 0 writing; the resume at world 2 continues to step 3 as the
    one process's does."""
    root = runs["root"]
    for key, one_key, steps in (("loop_data2", "loop_one", (1, 2)),
                                ("loop_data2_resumed", "loop_one_resumed",
                                 (3,))):
        one = runs[one_key]
        for rank, r in enumerate(runs["world2"]):
            summary, lora, counts = r[key]
            assert summary["steps"] == one[0]["steps"], key
            np.testing.assert_allclose(summary["final_loss"],
                                       one[0]["final_loss"], rtol=1e-5)
            _assert_close_tree(lora, one[1], 1e-5, 1e-5, key)
            want = len(steps) if rank == 0 else 0
            assert counts.get("lora_files", 0) == want, (key, rank, counts)
            assert counts.get("train_states", 0) == want, (key, rank, counts)
        for s in steps:
            got_dir, want_dir = (_run_dir(root / "loop_d2", s),
                                 _run_dir(root / "loop_1", s))
            got = load_file(os.path.join(got_dir, "ckpt", str(s),
                                         "lora.safetensors"))
            want = load_file(os.path.join(want_dir, "ckpt", str(s),
                                          "lora.safetensors"))
            _assert_close_tree(got, want, 1e-5, 1e-5, f"lora step {s}")
            _assert_close_tree(_train_state(got_dir, s),
                               _train_state(want_dir, s), 1e-5, 1e-5,
                               f"train state step {s}")
            with open(os.path.join(got_dir, "train_state",
                                   "fingerprint.json")) as f, open(
                    os.path.join(want_dir, "train_state",
                                 "fingerprint.json")) as g:
                assert json.load(f) == json.load(g)


def test_loop_refuses_a_data_extent_the_world_does_not_give(runs):
    for r in runs["world2"]:
        assert r["loop_refused"] is not None
        assert "config mesh data=3" in r["loop_refused"]
        assert "2 process(es) at tensor=1 make data 2" in r["loop_refused"]
    assert not os.path.exists(runs["root"] / "loop_d3")


@pytest.mark.parametrize("name,world,save", [
    ("cli_tensor2", "world2", "cli_t2"),
    ("cli_data2_tensor2", "world4", "cli_d2t2")])
def test_cli_train_under_a_tensor_axis(runs, name, world, save):
    """``cli.train.main`` under ``{tensor: 2}`` and ``{data: 2, tensor:
    2}``: 2 steps as the one-process CLI at the global batch, LoRA files
    within CLI_REL_L2, written by rank 0 alone; the probe rendered by the
    tensor ranks of data row 0 and its image written once."""
    res = runs[world]
    one_summary = runs["cli_one"][0]
    tensor = 2
    for rank, r in enumerate(res):
        summary, counts, _ = r[name]
        assert summary["steps"] == one_summary["steps"] == 2
        np.testing.assert_allclose(summary["final_loss"],
                                   one_summary["final_loss"], rtol=CLI_REL_L2)
        assert counts.get("lora_files", 0) == (2 if rank == 0 else 0)
        assert counts.get("probes", 0) == (1 if rank < tensor else 0), (
            rank, counts)
    run_dir, one_dir = (_run_dir(runs["root"] / save, 2),
                        _run_dir(runs["root"] / "cli_1", 2))
    assert os.listdir(runs["root"] / save) == [os.path.basename(run_dir)]
    assert os.listdir(os.path.join(run_dir, "samples")) == ["step_2.jpg"]
    for s in (1, 2):
        got = load_file(os.path.join(run_dir, "ckpt", str(s),
                                     "lora.safetensors"))
        want = load_file(os.path.join(one_dir, "ckpt", str(s),
                                      "lora.safetensors"))
        assert got.keys() == want.keys()
        for k in want:
            if not np.abs(want[k]).max() > 0:
                continue
            assert _rel_l2(got[k], want[k]) < CLI_REL_L2, (
                k, _rel_l2(got[k], want[k]))


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.mark.parametrize("name", ["convert_weights", "train_seed",
                                  "train_spatial", "parity_run", "test",
                                  "inference"])
def test_launcher_calls_the_ports_cli(name):
    """The script parses (``bash -n``), calls ``python -m
    loongx_tpu_torch.cli.<module>`` (torchrun for training and serving)
    and names only options that module's parser has."""
    import importlib

    path = SCRIPTS / f"{name}_torch.sh"
    subprocess.run(["bash", "-n", str(path)], check=True)
    text = path.read_text()
    modules = re.findall(r"-m (loongx_tpu_torch\.cli\.\w+)", text)
    assert modules and "loongx_tpu." not in text.replace("loongx_tpu_torch", "")
    if name in ("train_seed", "train_spatial", "inference"):
        assert "torchrun --standalone --nproc-per-node" in text
    lines = text.splitlines()
    for i, line in enumerate(lines):
        found = re.search(r"-m (loongx_tpu_torch\.cli\.\w+)", line)
        if not found:
            continue
        call = [line]  # the command with its continuation lines
        while call[-1].rstrip().endswith("\\"):
            i += 1
            call.append(lines[i])
        source = Path(importlib.import_module(
            found.group(1)).__file__).read_text()
        for opt in re.findall(r"(?<![\w-])(--[a-z][\w-]*)", "\n".join(call)):
            assert f'"{opt}"' in source, (name, found.group(1), opt)
