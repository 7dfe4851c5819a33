"""The port's training loop (``loongx_tpu_torch/train/loop.py``, the
accumulation wrapper, train-state checkpoints, ``cli/train.py``) against
the JAX package's, on the CPU at the tiny pipeline.

  * JAX's three loop tests, on the port: smoke, staged text equal to
    resident text, the fingerprint refusal on resume;
  * the port's ``train()`` against JAX's ``train()`` over 3 optimizer steps
    (accumulation 2, clip 0.5) under AdamW and Prodigy, both fed the same
    weights, data and tokenizer, JAX's draws (``jax.random.split`` of
    key(seed) a micro-step, then ``step.py``'s split into t and noise) and
    JAX's ``add_lora`` tree, substituted through ``monkeypatch``: each
    optimizer step's loss within 2e-4 (float32, as
    tests/test_golden_torch.py), the final LoRA factors within relative
    L2 1e-3 (the bound tests/test_torch_train.py holds Prodigy to);
  * `MultiSteps` against ``optax.MultiSteps(optax.chain(
    clip_by_global_norm, tx))`` on fixed gradients (float32 on both sides,
    only the order of sums differs: rtol 1e-5);
  * an exact train-state round trip, the refusal of the JAX package's
    orbax train state, and ``cli.train.main`` end to end on a YAML file
    (training under a mesh: tests/test_torch_parallel_train.py).
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from loongx_tpu import config as jconfig
from loongx_tpu.data import datasets as jdatasets
from loongx_tpu.models.flux import model as jmodel
from loongx_tpu.models.flux import vae as jvae
from loongx_tpu.models.pipeline import LoongXPipeline as JPipeline
from loongx_tpu.models.text import clip as jclip
from loongx_tpu.models.text import t5 as jt5
from loongx_tpu.train import callbacks as jcallbacks
from loongx_tpu.train import lora as jlora
from loongx_tpu.train import loop as jloop
from loongx_tpu.train.optim import build_optimizer as jbuild_optimizer
from loongx_tpu.utils import checkpoint as jckpt
from loongx_tpu_torch import config as tconfig
from loongx_tpu_torch.cli import train as tcli
from loongx_tpu_torch.data import datasets as tdatasets
from loongx_tpu_torch.models.pipeline import LoongXPipeline
from loongx_tpu_torch.train import callbacks as tcallbacks
from loongx_tpu_torch.train import loop as tloop
from loongx_tpu_torch.train import lora as tlora
from loongx_tpu_torch.train.optim import MultiSteps, build_optimizer
from loongx_tpu_torch.train.step import leaves
from loongx_tpu_torch.utils import checkpoint as tckpt
from loongx_tpu_torch.utils.bridge import from_numpy_tree, to_numpy_tree

SIZE = 16
JCFGS = {"flux_cfg": (jmodel, "FluxConfig"), "vae_cfg": (jvae, "VAEConfig"),
         "t5_cfg": (jt5, "T5Config"), "clip_cfg": (jclip, "CLIPTextConfig")}


class FakeTokenizer:
    """The character tokenizer of tests/test_train_loop.py."""

    def __init__(self, vocab_size, max_len=8):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        max_length = max_length or self.max_len
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            for j, ch in enumerate(p[:max_length]):
                ids[i, j] = (ord(ch) + 7 * j) % self.vocab_size

        class R:
            input_ids = ids

        return R()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_train_loop.py's synthetic L-Mind corpus: 4 rows of 16x16
    PNG pairs, instructions and four biosignals."""
    from PIL import Image

    root = tmp_path_factory.mktemp("corpus")
    img_dir = root / "imgs"
    img_dir.mkdir()
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
    return str(jsonl), str(root)


@pytest.fixture(scope="module")
def tiny_tree():
    """The tiny pipeline's float32 weights (the port's init)."""
    return LoongXPipeline.tiny(torch.Generator().manual_seed(0),
                               device="cpu").params


def _port_pipe(tree):
    pipe = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    pipe.params = from_numpy_tree(to_numpy_tree(tree), "cpu")
    pipe.t5_tokenizer = FakeTokenizer(pipe.t5_cfg.vocab_size)
    pipe.clip_tokenizer = FakeTokenizer(pipe.clip_cfg.vocab_size)
    pipe.max_sequence_length = 8
    return pipe


def _jax_pipe(tp):
    c = {k: getattr(mod, cls)(**dataclasses.asdict(getattr(tp, k)))
         for k, (mod, cls) in JCFGS.items()}
    return JPipeline(params=jax.tree.map(jnp.asarray, to_numpy_tree(tp.params)),
                     dtype=jnp.float32,
                     t5_tokenizer=FakeTokenizer(tp.t5_cfg.vocab_size),
                     clip_tokenizer=FakeTokenizer(tp.clip_cfg.vocab_size),
                     max_sequence_length=8, **c)


def _raw(tmp_path, **train):
    """The tiny run's config as YAML-shaped data (JAX's _tiny_cfg)."""
    t = dict(batch_size=2, accumulate_grad_batches=1, max_steps=2,
             save_interval=0, sample_interval=0,
             save_path=str(tmp_path / "runs"), gradient_checkpointing=False,
             dataset={"type": "img"},
             optimizer={"type": "AdamW", "params": {"lr": 1e-3}},
             dataloader_workers=1)
    t.update(train)
    return {"dtype": "float32", "mesh": {"data": 1}, "train": t}


def _cfg(tmp_path, module=tconfig, **train):
    return module._build(module.Config, _raw(tmp_path, **train))


def _dataset(corpus, module=tdatasets):
    jsonl, root = corpus
    return module.SeedDataset(jsonl, image_dir=root, image_size=SIZE)


def _run(tmp_path, tree, corpus, resume=False, **train):
    pipe = _port_pipe(tree)
    return tloop.train(_cfg(tmp_path, **train), pipeline=pipe,
                       dataset=_dataset(corpus), resume=resume,
                       use_wandb=False), pipe


# ---------------------------------------------------------------------------
# JAX's loop tests, on the port
# ---------------------------------------------------------------------------


def test_train_loop_smoke(corpus, tiny_tree, tmp_path):
    summary, _ = _run(tmp_path, tiny_tree, corpus, accumulate_grad_batches=2,
                      max_steps=3)
    assert summary["steps"] == 3
    assert np.isfinite(summary["final_loss"])
    runs = os.listdir(tmp_path / "runs")
    assert len(runs) == 1
    state_dir = tmp_path / "runs" / runs[0] / tcallbacks.TRAIN_STATE_DIR
    assert sorted(os.listdir(state_dir)) == ["fingerprint.json", "step_3"]
    assert os.path.isfile(tmp_path / "runs" / runs[0] / "ckpt" / "3" /
                          "lora.safetensors")


def test_staged_text_matches_resident(corpus, tiny_tree, tmp_path):
    s_res, _ = _run(tmp_path, tiny_tree, corpus,
                    save_path=str(tmp_path / "runs_res"))
    s_staged, pipe = _run(tmp_path, tiny_tree, corpus, staged_text=True,
                          save_path=str(tmp_path / "runs_staged"))
    assert "t5" not in pipe.params and "clip" not in pipe.params
    assert s_staged["final_loss"] == s_res["final_loss"]


def test_resume_fingerprint_mismatch_refused(corpus, tiny_tree, tmp_path):
    _run(tmp_path, tiny_tree, corpus)
    summary, _ = _run(tmp_path, tiny_tree, corpus, resume=True, max_steps=3)
    assert summary["steps"] == 3  # resumed at 2, ran to 3
    with pytest.raises(RuntimeError, match="fingerprint"):
        _run(tmp_path, tiny_tree, corpus, resume=True,
             lora_config={"r": 8, "lora_alpha": 8})


# ---------------------------------------------------------------------------
# train() against JAX's
# ---------------------------------------------------------------------------

PRODIGY = {"lr": 1.0, "use_bias_correction": True, "safeguard_warmup": True,
           "weight_decay": 0.01}


def _record_steps(monkeypatch, module):
    """Record each optimizer step's (step, averaged loss) from the loop's
    callback."""
    seen = []
    orig = module.TrainingCallback.on_step_end

    def on_step_end(self, step, metrics, state=None, epoch=0):
        seen.append((step, float(metrics["loss"])))
        return orig(self, step, metrics, state, epoch)

    monkeypatch.setattr(module.TrainingCallback, "on_step_end", on_step_end)
    return seen


def _jax_draws(seed):
    """The port's micro_step_draws fed JAX's train() stream: key(seed)
    split once a micro-step, the subkey split into t and noise as
    loongx_tpu/train/step.py does."""
    key = [jax.random.key(seed)]

    def draws(generator, batch):
        key[0], sub = jax.random.split(key[0])
        k_t, k_noise, _ = jax.random.split(sub, 3)
        shape = tuple(batch["x0"].shape)
        t = jax.nn.sigmoid(jax.random.normal(k_t, (shape[0],), jnp.float32))
        x1 = jax.random.normal(k_noise, shape, jnp.float32)
        return {"t": torch.from_numpy(np.array(t)),
                "noise": torch.from_numpy(np.array(x1))}

    return draws


def _jax_add_lora(seed):
    """The port's add_lora replaced by JAX's (key(seed), as JAX's loop)."""
    def add_lora(params, r=4, alpha=4, dtype=torch.float32, generator=None,
                 **_):
        tree = jax.tree.map(jnp.asarray, to_numpy_tree(params))
        out = jlora.add_lora(jax.random.key(seed), tree, r=r, alpha=alpha,
                             dtype=jnp.float32)
        return from_numpy_tree(jax.tree.map(np.asarray, out), "cpu")

    return add_lora


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("opt", ["AdamW", "Prodigy"])
def test_train_matches_jax(corpus, tiny_tree, tmp_path, monkeypatch, opt):
    optimizer = ({"type": "AdamW", "params": {"lr": 1e-3}} if opt == "AdamW"
                 else {"type": "Prodigy", "params": PRODIGY})
    kw = dict(accumulate_grad_batches=2, max_steps=3, gradient_clip_val=0.5,
              optimizer=optimizer)
    tp = _port_pipe(tiny_tree)
    jp = _jax_pipe(tp)

    jsteps = _record_steps(monkeypatch, jcallbacks)
    jloop.train(_cfg(tmp_path / "jax", jconfig, **kw), pipeline=jp,
                dataset=_dataset(corpus, jdatasets), resume=False,
                use_wandb=False)
    tsteps = _record_steps(monkeypatch, tcallbacks)
    monkeypatch.setattr(tloop, "micro_step_draws", _jax_draws(42))
    monkeypatch.setattr(tloop.lora, "add_lora", _jax_add_lora(42))
    tloop.train(_cfg(tmp_path / "port", **kw), pipeline=tp,
                dataset=_dataset(corpus), resume=False, use_wandb=False)

    assert [s for s, _ in tsteps] == [s for s, _ in jsteps] == [1, 2, 3]
    np.testing.assert_allclose([x for _, x in tsteps],
                               [x for _, x in jsteps], atol=2e-4, rtol=0)
    want = jlora.lora_state_dict(jp.params["flux"])
    got = tlora.lora_state_dict(tp.params["flux"])
    assert set(got) == set(want)
    init = tlora.lora_state_dict(from_numpy_tree(jax.tree.map(
        np.asarray, jlora.add_lora(jax.random.key(42), jax.tree.map(
            jnp.asarray, to_numpy_tree(tiny_tree["flux"])), r=4, alpha=4,
            dtype=jnp.float32)), "cpu"))
    factors = [n for n in got if n.endswith(("lora_a", "lora_b"))]
    n_moved = 0
    for name in factors:
        moved = got[name].detach().numpy() - init[name].numpy()
        want_moved = np.asarray(want[name]) - init[name].numpy()
        if not np.abs(want_moved).max() > 0:
            # a structural zero (the last single block's q/k LoRA acts only
            # on condition rows, which the velocity never reads)
            np.testing.assert_array_equal(moved, want_moved, name)
            continue
        n_moved += 1
        assert _rel_l2(got[name].detach().numpy(),
                       np.asarray(want[name])) < 1e-3, name
        if np.abs(want_moved).max() > 1e-4 * np.abs(init[name].numpy()).max():
            # the update itself, where float32 resolves it in the factor
            # (Prodigy moves A by ~d0 = 1e-6 in its first steps: the
            # rounding of A + delta, not the update, would be compared)
            assert _rel_l2(moved, want_moved) < 1e-3, (
                name, _rel_l2(moved, want_moved))
    assert n_moved >= len(factors) - 2, (n_moved, len(factors))


# ---------------------------------------------------------------------------
# The accumulation wrapper, train states
# ---------------------------------------------------------------------------

SHAPES = ((6, 4), (4, 3), (5,))


def _grads(n):
    rng = np.random.default_rng(11)
    return [[rng.standard_normal(s).astype(np.float32) * (1 + 3 * (i % 2))
             for s in SHAPES] for i in range(n)]


def _torch_opt(opt):
    return build_optimizer({"type": opt, "params": PRODIGY} if opt == "Prodigy"
                           else {"type": "AdamW", "params": {"lr": 1e-2}})


def _optax_opt(opt):
    cfg = jconfig.OptimizerConfig(
        type=opt, params=PRODIGY if opt == "Prodigy" else {"lr": 1e-2})
    return jbuild_optimizer(cfg)


@pytest.mark.parametrize("opt", ["AdamW", "Prodigy"])
def test_multisteps_matches_optax(opt):
    k, clip = 3, 0.5
    grads = _grads(2 * k + 1)
    p0 = [np.random.default_rng(i).standard_normal(s).astype(np.float32)
          for i, s in enumerate(SHAPES)]

    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(clip),
                                      _optax_opt(opt)), every_k_schedule=k)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    params = [torch.from_numpy(p.copy()) for p in p0]
    ms = MultiSteps(_torch_opt(opt)(params), k, clip)
    for i, g in enumerate(grads):
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        stepped = ms.step()
        assert stepped == ((i + 1) % k == 0) and ms.mini_step == (i + 1) % k
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-7, err_msg=f"micro-step {i}")
        for acc, want in zip(ms.acc, st.acc_grads):
            np.testing.assert_allclose(acc.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


def _state_tensors(ms):
    sd = ms.state_dict()
    out = {f"acc/{i}": a for i, a in enumerate(sd["acc"])}
    for i, st in sd["inner"]["state"].items():
        out.update({f"state/{i}/{k}": v for k, v in st.items()})
    out.update({f"group/{k}": v for k, v in sd["inner"]["param_groups"][0].items()
                if isinstance(v, torch.Tensor)})
    return out


@pytest.mark.parametrize("opt", ["AdamW", "Prodigy"])
def test_train_state_round_trip_is_exact(tmp_path, opt):
    """bf16 leaves, an open accumulation window: the loaded leaves and
    optimizer state equal the saved ones bit for bit (no dtype cast), and
    the next steps equal those of the run that never stopped."""
    gen = torch.Generator().manual_seed(0)

    def tree():
        g = torch.Generator().manual_seed(1)
        return {"a": {"lora_a": torch.randn(6, 4, generator=g).bfloat16(),
                      "kernel_q": None},
                "b": [{"lora_b": torch.randn(4, 3, generator=g).bfloat16()}]}

    def make(t):
        return MultiSteps(_torch_opt(opt)([p for p in leaves(t)
                                           if p is not None]), 2, 0.5)

    def step(t, ms):
        for p in ms.param_groups[0]["params"]:
            p.grad = torch.randn(p.shape, generator=gen).bfloat16()
        ms.step()

    live = tree()
    ms = make(live)
    for _ in range(3):  # one optimizer step, then half a window
        step(live, ms)
    assert ms.mini_step == 1
    path = tckpt.save_train_checkpoint(str(tmp_path), 7, live, ms,
                                       fingerprint={"lora_r": 4})
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    assert tckpt.load_fingerprint(str(tmp_path)) == {"lora_r": 4}

    other = tree()
    ms2 = make(other)
    assert tckpt.load_train_checkpoint(path, other, ms2) == 7
    for a, b in zip(leaves(live), leaves(other)):
        if a is not None:
            assert torch.equal(a, b) and a.dtype == b.dtype
    want, got = _state_tensors(ms), _state_tensors(ms2)
    assert set(want) == set(got) and ms2.mini_step == 1
    for name in want:
        assert want[name].dtype == got[name].dtype, name
        assert torch.equal(want[name], got[name]), name
    state = gen.get_state()
    for t, m in ((live, ms), (other, ms2)):
        gen.set_state(state)
        for _ in range(3):
            step(t, m)
    for a, b in zip(leaves(live), leaves(other)):
        if a is not None:
            assert torch.equal(a, b)


def test_orbax_train_state_refused(corpus, tiny_tree, tmp_path):
    """A JAX package's run under save_path: its orbax train state is
    refused on resume, naming the format, not passed over."""
    orbax_dir = tmp_path / "runs" / "20200101-000000" / "orbax"
    trainable = {"w": jnp.ones((2, 2), jnp.float32)}
    ck = jckpt.save_train_checkpoint(str(orbax_dir), 1, trainable,
                                     optax.sgd(0.1).init(trainable))
    p = torch.ones(2, 2, requires_grad=True)
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_train_checkpoint(ck, {"w": p},
                                    torch.optim.SGD([p], lr=0.1))
    with pytest.raises(ValueError, match="orbax"):
        _run(tmp_path, tiny_tree, corpus, resume=True)


def test_cli_train_end_to_end(corpus, tiny_tree, tmp_path, monkeypatch):
    """``cli.train.main`` on a YAML file: the pipeline directory loaded from
    flux_path, staged text, the refusal of a seed dataset without CS3
    encoders, 2 optimizer steps with a LoRA file and a train state each and
    a probe image, then a resumed run to step 3.  The directory holds no
    tokenizer files, so the tokenizer loader hands back the character
    tokenizer."""
    jsonl, root = corpus
    pipe = _port_pipe(tiny_tree)
    ck = str(tmp_path / "ckpt")
    tckpt.save_pipeline(pipe, ck)
    monkeypatch.setattr(tckpt, "_tok", lambda path, cls, sub: FakeTokenizer(
        pipe.t5_cfg.vocab_size if sub.startswith("t5") else
        pipe.clip_cfg.vocab_size))
    raw = _raw(tmp_path, accumulate_grad_batches=2, save_interval=1,
               sample_interval=2, staged_text=True,
               dataset={"type": "seed", "jsonl_path": jsonl,
                        "image_dir": root, "image_size": SIZE,
                        "target_size": SIZE, "condition_size": SIZE})
    raw["flux_path"] = ck
    yml = tmp_path / "train.yaml"
    yml.write_text(yaml.safe_dump(raw))
    argv = ["--config", str(yml), "--no_wandb", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="'encoders'"):
        # a seed dataset trains with the CS3 encoders, which the tiny
        # pipeline does not carry
        tcli.main(argv + ["--max_steps", "2", "--no_resume"])
    # "img" trains without the encoders; its Hugging Face corpus is replaced
    # by the same local L-Mind rows (build_dataset's seed branch)
    raw["train"]["dataset"]["type"] = "img"
    yml.write_text(yaml.safe_dump(raw))
    build = tloop.build_dataset
    monkeypatch.setattr(tloop, "build_dataset", lambda tcfg, **kw: build(
        dataclasses.replace(tcfg, dataset=dataclasses.replace(
            tcfg.dataset, type="seed")), **kw))
    summary = tcli.main(argv + ["--max_steps", "2", "--no_resume"])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    (run,) = os.listdir(tmp_path / "runs")
    run_dir = tmp_path / "runs" / run
    for step in ("1", "2"):
        assert os.path.isfile(run_dir / "ckpt" / step / "lora.safetensors")
    assert sorted(os.listdir(run_dir / "train_state")) == [
        "fingerprint.json", "step_1", "step_2"]
    from PIL import Image

    assert Image.open(run_dir / "samples" / "step_2.jpg").size == (SIZE, SIZE)
    summary = tcli.main(argv + ["--max_steps", "3"])
    assert summary["steps"] == 3
