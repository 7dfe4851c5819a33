"""What each rank of tests/test_torch_parallel.py's spawned gloo groups
runs (no JAX here: the ranks import only the port; the JAX references are
computed in the test process).

`tensor2` runs on a 1 x 2 mesh (data 1, tensor 2), `data2_tensor2` on a
2 x 2 mesh; each does every check of its world in one process group and
returns its local results as numpy arrays, keyed by check.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _fake_brain_encode(enc, dgf, eeg, ppg, fnirs, motion, s4_mode="conv"):
    """The brain encode the infer CLI tests fake (the full-size CS3 stacks
    do not fit the tiny DiT): a fixed function of the signals."""
    b = eeg.shape[0]
    jd, pd = 32, 32  # the tiny pipeline's joint and pooled widths
    s = eeg.float().mean((1, 2))[:, None, None]
    return (0.1 + 0.01 * s.expand(b, 8, jd), 0.2 + 0.01 * s[:, 0].expand(b, pd))


def _mesh(data, tensor, **kw):
    """The rank joins the group spawn_ranks describes in its environment."""
    from loongx_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    return make_mesh(data=data, tensor=tensor, device="cpu", **kw)


def _local_heads(mesh, x):
    """This rank's heads of a [B, H, S, D] tensor every rank holds whole."""
    n = x.shape[1] // mesh.shape["tensor"]
    return x.narrow(1, mesh.tensor_index * n, n)


def _attention(mesh, cases):
    from loongx_tpu_torch.parallel.tp_attention import tp_flash_attention

    out = []
    for q, k, v, kw, rope in cases:
        q, k, v = (_local_heads(mesh, _t(a)) for a in (q, k, v))
        rope = None if rope is None else (_t(rope[0]), _t(rope[1]))
        out.append(tp_flash_attention(mesh, q, k, v, rope=rope, **kw).numpy())
    return out


def _tp_quant(mesh, cases):
    """Each case's operands split as its kind splits them, through
    `tp_quant_matmul_stacked` under the tensor context."""
    from loongx_tpu_torch.parallel.mesh import tp_context
    from loongx_tpu_torch.parallel.tp_quant import tp_quant_matmul_stacked

    t, ti = mesh.shape["tensor"], mesh.tensor_index
    out = []
    for kind, op in cases:
        x, w, scale, bias = op["x"], op["w"], op["scale"], op["bias"]
        if kind == "col":
            n = w.shape[-1] // t
            cols = slice(ti * n, (ti + 1) * n)
            w, scale, bias = w[..., cols], scale[..., cols], bias[..., cols]
        elif kind == "row":
            k = w.shape[1] // t
            rows = slice(ti * k, (ti + 1) * k)
            w, x = w[:, rows], x[:, rows]
        kw = {name: (None if op.get(name) is None else _t(op[name]))
              for name in ("ab", "resid", "gate")}
        with tp_context(mesh):
            y = tp_quant_matmul_stacked(
                kind, _t(x), _t(w), _t(scale), op["blk"], bias2=_t(bias),
                activation=op.get("activation"),
                seg_boundary=op.get("boundary", 0), **kw)
        out.append(y.float().numpy())
    return out


def _forward(mesh, flux, cfg, batch, **kw):
    """The rank's shard of the int8 tree (bridged, then `shard_params`), its
    rows of the batch, one flux_forward under the mesh context."""
    from loongx_tpu_torch.models.flux.model import flux_forward
    from loongx_tpu_torch.parallel.mesh import (
        mesh_context, shard_batch, shard_params,
    )
    from loongx_tpu_torch.utils.bridge import from_numpy_tree

    local = shard_params(from_numpy_tree(flux, "cpu"), mesh)
    ids = ("img_ids", "txt_ids", "cond_ids")
    inputs = {k: _t(v) for k, v in batch.items()}
    rows = shard_batch({k: v for k, v in inputs.items() if k not in ids}, mesh)
    with torch.no_grad(), mesh_context(mesh):
        out = flux_forward(local, cfg, **rows,
                           **{k: inputs[k] for k in ids if k in inputs}, **kw)
    return out.float().numpy()


def _cli(argv):
    """cli.infer.main in this rank (the brain encode faked); returns the
    names of the images this rank wrote, from its log."""
    import contextlib
    import io
    import os

    from loongx_tpu_torch.cli import infer
    from loongx_tpu_torch.sampling import generate

    generate.brain_encode = _fake_brain_encode
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        infer.main(argv)
    return sorted(os.path.basename(line.split("] ")[-1])
                  for line in log.getvalue().splitlines()
                  if line.startswith("[infer] ["))


def tensor2(rank, job):
    """World 2, tensor 2: TP attention, the TP GEMM kinds, the whole int8
    forward (unfused, with fuse_ln + fuse_gate at batch 1, and the unfused
    int8 tree carrying active LoRA adapters), and cli.infer --tensor 2 over
    a directory."""
    mesh = _mesh(1, 2, backend="gloo")
    res = {"attention": _attention(mesh, job["attention"]),
           "tp_quant": _tp_quant(mesh, job["tp_quant"]),
           "forward": _forward(mesh, job["flux"], job["cfg"], job["batch"]),
           "forward_lora": _forward(mesh, job["flux_lora"], job["cfg"],
                                    job["batch"]),
           "forward_fused": _forward(mesh, job["flux"], job["cfg"],
                                     job["batch"], fuse_ln=True,
                                     fuse_gate=True),
           "mesh": (dict(mesh.shape), mesh.data_index, mesh.tensor_index,
                    torch.distributed.get_backend())}
    res["cli"] = _cli(job["cli_argv"] + ["--output_dir", job["cli_out"]])
    return res


def data2_tensor2(rank, job):
    """World 4, data 2 x tensor 2: the int8 forward at batch 2 with fuse_ln
    + fuse_gate (one row a data rank, segments at the global boundary),
    batch-sharded generate of the float tiny pipeline, and cli.infer
    --tensor 2 over a directory (the tail group padded)."""
    from loongx_tpu_torch.models.pipeline import LoongXPipeline
    from loongx_tpu_torch.parallel.mesh import (
        mesh_context, shard_batch, shard_params,
    )
    from loongx_tpu_torch.sampling.generate import generate

    mesh = _mesh(2, 2)  # the backend a CPU device takes: gloo
    res = {"forward_fused": _forward(mesh, job["flux"], job["cfg"],
                                     job["batch"], fuse_ln=True,
                                     fuse_gate=True),
           "mesh": (dict(mesh.shape), mesh.data_index, mesh.tensor_index,
                    torch.distributed.get_backend())}
    pipe = LoongXPipeline.tiny(torch.Generator().manual_seed(0), device="cpu")
    pipe.params = shard_params(pipe.params, mesh)
    gen = {k: _t(v) for k, v in job["generate"].items()}
    rows = shard_batch({k: gen[k] for k in ("latents", "prompt_embeds",
                                            "pooled_prompt_embeds",
                                            "cond_tokens")}, mesh)
    with mesh_context(mesh):
        res["generate"] = generate(
            pipe, cond_ids=gen["cond_ids"], height=16, width=16,
            num_inference_steps=2, output_type="latent", **rows).numpy()
    res["cli"] = _cli(job["cli_argv"] + ["--output_dir", job["cli_out"]])
    return res
