"""What each rank of tests/test_torch_parallel_train.py's spawned gloo
groups runs (no JAX here: the ranks import only the port; the JAX
references are computed in the test process).

`world2` runs the train step over data 2 and over tensor 2 (two meshes of
one process group), then `train.loop.train` under ``mesh: {data: 2}`` (a
run, a resume, a refused ``data: 3``) and ``cli.train.main`` under
``mesh: {tensor: 2}``; `world4` the step and ``cli.train.main`` over data
2 x tensor 2.  Each returns its results as numpy arrays and plain values,
keyed by check.  `train_step`, `loop_train` and `cli_train` also give the
test process its one-process references.
"""

import contextlib
import dataclasses
import io

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _mesh(data, tensor):
    """The rank joins (or reuses) the group spawn_ranks describes."""
    from loongx_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(data=data, tensor=tensor, device="cpu")


class RecordingSGD(torch.optim.SGD):
    """SGD that keeps the gradients it was handed at its last step (the
    step's reduced ones)."""

    def step(self, closure=None):
        self.seen = [p.grad.detach().clone()
                     for p in self.param_groups[0]["params"]]
        return super().step(closure)


@contextlib.contextmanager
def _routes(counts):
    """Count, while the step runs, the calls that reach a forward-only
    int8 product with grad enabled (none may: its dx would be dropped) and
    those of the stacked kernels' autograd Functions."""
    from loongx_tpu_torch.models.flux import model
    from loongx_tpu_torch.ops import quant_matmul as qmm

    def spy(mod, name, key):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            if torch.is_grad_enabled():
                counts[key] = counts.get(key, 0) + 1
            return orig(*args, **kw)

        setattr(mod, name, wrapped)
        return mod, name, orig

    saved = [spy(qmm, "quant_matmul_stacked", "forward_only"),
             spy(qmm, "quant_qkv_stacked", "forward_only"),
             spy(model, "tp_quant_matmul_stacked", "forward_only"),
             spy(model, "tp_quant_qkv_stacked", "forward_only"),
             spy(qmm, "quant_matmul_stacked_vjp", "stacked_fn"),
             spy(qmm, "quant_linear_gelu_stacked", "stacked_fn")]
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def train_step(mesh, job):
    """One train step of the job's int8 tree (LoRA on every default
    target) under ``mesh`` (None: one process): the rank's shard of the
    frozen tree and its rows of the global batch, the global batch's
    draws, SGD, remat.  Returns loss, grad norm, t_mean, the gradients the
    optimizer saw and the LoRA leaves after the step (by path), d loss / d
    (prompt_embeds, cond_tokens) of this rank's rows before the step, and
    the route counts."""
    from loongx_tpu_torch.parallel.mesh import (
        mesh_context, shard_batch, shard_params, tree_paths,
    )
    from loongx_tpu_torch.train.step import (
        combine, flow_match_loss, make_train_step, partition, trainable_mask,
    )
    from loongx_tpu_torch.utils.bridge import from_numpy_tree

    ctx = (lambda: mesh_context(mesh)) if mesh else contextlib.nullcontext
    tree = from_numpy_tree(job["params"], "cpu")
    trainable, frozen = partition(tree, trainable_mask(tree))
    if mesh:
        frozen = shard_params(frozen, mesh)
    ids = ("img_ids", "txt_ids", "cond_ids")
    batch = {k: _t(v) for k, v in job["batch"].items()}
    rows = {k: v for k, v in batch.items() if k not in ids}
    if mesh:
        rows = shard_batch(rows, mesh)
    batch = {**rows, **{k: batch[k] for k in ids}}
    draws = {k: _t(v) for k, v in job["draws"].items()}
    kw = dict(flags=job["flags"], remat=True, dtype=torch.float32)
    out = {"counts": {}}

    inputs = {k: batch[k].clone().requires_grad_(True)
              for k in ("prompt_embeds", "cond_tokens")}
    with ctx():
        loss, _ = flow_match_loss(combine(trainable, frozen), job["cfg"],
                                  {**batch, **inputs}, draws, **kw)
        dx = torch.autograd.grad(loss, list(inputs.values()))
    out["dx"] = {k: g.numpy() for k, g in zip(inputs, dx)}

    init_fn, step_fn = make_train_step(
        job["cfg"], lambda ps: RecordingSGD(ps, lr=job["lr"]),
        grad_clip=None, **kw)
    state = init_fn(trainable)
    with ctx(), _routes(out["counts"]):
        state, m = step_fn(state, frozen, batch, draws)
    paths = [p for p, leaf in tree_paths(state.trainable) if leaf is not None]
    out.update({k: float(v) for k, v in m.items()})
    out["grads"] = {p: g.numpy() for p, g in zip(paths,
                                                 state.optimizer.seen)}
    out["after"] = {p: leaf.detach().numpy() for p, leaf in
                    tree_paths(state.trainable) if leaf is not None}
    return out


class FakeTokenizer:
    """The character tokenizer of tests/test_torch_train_loop.py."""

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


@contextlib.contextmanager
def cli_patches(vocab, counts=None):
    """What ``cli.train.main`` needs on the tiny pipeline directory, as
    tests/test_torch_train_loop.py's end-to-end test patches it: the
    character tokenizer for the directory's (absent) tokenizer files, the
    local L-Mind rows for the "img" corpus; and, with ``counts``, the
    files this process writes and the probes it renders, counted."""
    from loongx_tpu_torch.train import loop, sampling_probe
    from loongx_tpu_torch.utils import checkpoint as ckpt

    saved = [(ckpt, "_tok"), (loop, "build_dataset")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    build = loop.build_dataset
    ckpt._tok = lambda path, cls, sub: FakeTokenizer(
        vocab["t5"] if sub.startswith("t5") else vocab["clip"])
    loop.build_dataset = lambda tcfg, **kw: build(dataclasses.replace(
        tcfg, dataset=dataclasses.replace(tcfg.dataset, type="seed")), **kw)
    if counts is not None:
        for mod, name, key in (
                (ckpt, "save_train_checkpoint", "train_states"),
                (ckpt, "save_lora_safetensors", "lora_files"),
                (sampling_probe.SampleProbe, "__call__", "probes")):
            orig = getattr(mod, name)
            saved.append((mod, name, orig))

            def wrapped(*args, _orig=orig, _key=key, **kw):
                counts[_key] = counts.get(_key, 0) + 1
                return _orig(*args, **kw)

            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def cli_train(argv, vocab):
    """``cli.train.main(argv)`` in this rank: (summary, the rank's writes
    and probes, its standard output)."""
    from loongx_tpu_torch.cli import train as tcli

    counts = {}
    log = io.StringIO()
    with cli_patches(vocab, counts), contextlib.redirect_stdout(log):
        summary = tcli.main(argv)
    return summary, counts, log.getvalue()


def tiny_pipeline():
    """The tiny float32 pipeline every process makes alike (torch seed 0),
    with the character tokenizer (tests/test_torch_train_loop.py's)."""
    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    pipe = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    pipe.t5_tokenizer = FakeTokenizer(pipe.t5_cfg.vocab_size)
    pipe.clip_tokenizer = FakeTokenizer(pipe.clip_cfg.vocab_size)
    pipe.max_sequence_length = 8
    return pipe


def loop_train(yml, corpus, resume=False):
    """`train.loop.train` from the YAML file ``yml`` on the tiny float32
    pipeline and the corpus' rows: (summary, the LoRA leaves, the
    process's writes)."""
    from loongx_tpu_torch import config
    from loongx_tpu_torch.data.datasets import SeedDataset
    from loongx_tpu_torch.train import loop
    from loongx_tpu_torch.train.lora import lora_state_dict

    counts = {}
    pipe = tiny_pipeline()
    jsonl, root, size = corpus
    with cli_patches({}, counts), contextlib.redirect_stdout(io.StringIO()):
        summary = loop.train(config.load_config(yml), pipeline=pipe,
                             dataset=SeedDataset(jsonl, image_dir=root,
                                                 image_size=size),
                             resume=resume, use_wandb=False)
    lora = {k: v.detach().numpy()
            for k, v in lora_state_dict(pipe.params["flux"]).items()}
    return summary, lora, counts


def _refused(yml, corpus):
    """The message `train.loop.train` refuses ``yml`` with."""
    try:
        loop_train(yml, corpus)
    except ValueError as exc:
        return str(exc)
    return None


def world2(rank, job):
    """World 2: the step over data 2 and over tensor 2, then the loop."""
    res = {"data2": train_step(_mesh(2, 1), job["step"]),
           "tensor2": train_step(_mesh(1, 2), job["step"])}
    loop, cli = job["loop"], job["cli"]
    res["loop_data2"] = loop_train(loop["data2"], loop["corpus"])
    res["loop_data2_resumed"] = loop_train(loop["data2_resume"],
                                           loop["corpus"], resume=True)
    res["loop_refused"] = _refused(loop["data3"], loop["corpus"])
    res["cli_tensor2"] = cli_train(cli["tensor2"], cli["vocab"])
    res["mesh"] = (torch.distributed.get_world_size(), rank,
                   torch.distributed.get_backend())
    return res


def world4(rank, job):
    """World 4: the step and the loop over data 2 x tensor 2."""
    mesh = _mesh(2, 2)
    return {"data2_tensor2": train_step(mesh, job["step"]),
            "cli_data2_tensor2": cli_train(job["cli"]["data2_tensor2"],
                                           job["cli"]["vocab"]),
            "mesh": (dict(mesh.shape), mesh.data_index, mesh.tensor_index)}
