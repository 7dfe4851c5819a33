"""A data x tensor layout of processes, and the tensor-parallel rules over
the DiT's parameters (counterpart of ``loongx_tpu/parallel/mesh.py``), for
serving and for training.

The JAX package builds a ``jax.sharding.Mesh`` over devices and lets GSPMD
partition global arrays.  Here each process (rank) holds only its shard,
as plain local tensors on its own device, and the code says where ranks
talk: one ``torch.distributed.all_reduce`` over the tensor group after
each row-split GEMM (``parallel/tp_quant.py``; in training the autograd
forms, with the sums of dx and of the LoRA gradients that the splits leave
partial: `tensor_partial_grad`, ``train/step.py``).  Ranks are laid out
row-major over ``[data, tensor]``, as the JAX package reshapes its device
list: rank ``d * tensor + t`` is data index d, tensor index t.

Axes:
  * ``data``   -- batch rows: each data rank serves its own requests;
  * ``tensor`` -- Megatron tensor parallelism over the DiT's heads and MLP
    columns: column-split projections leave their output split, row-split
    ones sum their partial products over the tensor group.

`make_mesh` joins the process group that ``torchrun`` describes in the
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or
the one the caller already initialised; with neither it is the 1 x 1 mesh
of one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``{"data": d, "tensor": t}`` layout: its
    indices, its device and the process groups of its tensor row and data
    column (None where that axis has extent 1)."""
    shape: Dict[str, int]
    data_index: int
    tensor_index: int
    device: torch.device
    tensor_group: Any = None
    data_group: Any = None

    @property
    def rank(self) -> int:
        return self.data_index * self.shape["tensor"] + self.tensor_index

    def index(self, axis: str) -> int:
        return {"data": self.data_index, "tensor": self.tensor_index}[axis]

    def group(self, axis: str):
        return {"data": self.data_group, "tensor": self.tensor_group}[axis]


# ---------------------------------------------------------------------------
# The active mesh: the model routes its linears and attention through the
# tensor-parallel wrappers while a tensor axis is active; the train step
# takes its rows of the global batch's draws and averages its gradients
# over the data axis.  Module state, not thread-local: a remat backward
# re-runs a block's forward on autograd's device thread, and that re-run
# must take the same routes.
# ---------------------------------------------------------------------------

_TP_STATE = {"mesh": None, "axis": "tensor", "data_axis": None}


@contextlib.contextmanager
def tp_context(mesh: Mesh, axis: str = "tensor"):
    """Activate tensor parallelism over ``axis`` for the model's linears
    and attention (no effect when its extent is 1)."""
    prev = dict(_TP_STATE)
    _TP_STATE.update(mesh=mesh, axis=axis, data_axis=None)
    try:
        yield
    finally:
        _TP_STATE.update(prev)


@contextlib.contextmanager
def mesh_context(mesh: Mesh, data_axis: str = "data",
                 tensor_axis: str = "tensor"):
    """Activate both axes: batch rows over ``data_axis`` (each data rank
    holds its own rows: serving runs them as they are, the train step
    draws for the global batch and averages its gradients over the axis)
    and heads / MLP columns over ``tensor_axis``.  Either may be trivial
    (extent 1)."""
    prev = dict(_TP_STATE)
    _TP_STATE.update(mesh=mesh, axis=tensor_axis, data_axis=data_axis)
    try:
        yield
    finally:
        _TP_STATE.update(prev)


def current_tp():
    """(mesh, axis) if a context with a non-trivial tensor axis is active,
    else None."""
    mesh, axis = _TP_STATE["mesh"], _TP_STATE["axis"]
    if mesh is not None and mesh.shape.get(axis, 1) > 1:
        return mesh, axis
    return None


def current_dp():
    """(mesh, data_axis) if a `mesh_context` with a non-trivial data axis
    is active, else None."""
    mesh, axis = _TP_STATE["mesh"], _TP_STATE["data_axis"]
    if mesh is not None and axis is not None and mesh.shape.get(axis, 1) > 1:
        return mesh, axis
    return None


def tensor_extent() -> int:
    """The active tensor axis's extent (1 outside a tensor context)."""
    tp = current_tp()
    return tp[0].shape[tp[1]] if tp else 1


# ---------------------------------------------------------------------------
# make_mesh
# ---------------------------------------------------------------------------


def rank_device(device=None, backend: Optional[str] = None) -> torch.device:
    """This rank's device: ``device`` as given, a bare "cuda" (the
    default) being cuda:LOCAL_RANK.  Refuses a CUDA device that does not
    exist and NCCL with more ranks on this host than cards (NCCL refuses
    two ranks on one device: name one device and take gloo to share it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend 'nccl' needs a CUDA device, not {dev}")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA device is available (pass "
                           "device='cpu' to run on the CPU)")
    count = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if backend == "nccl" and local_world > count:
        raise ValueError(
            f"NCCL cannot run {local_world} ranks on {count} CUDA device(s) "
            "of this host: it refuses two ranks on one device.  Use "
            "backend='gloo' with an explicit device (e.g. 'cuda:0') to share "
            "a card")
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.index >= count:
        raise ValueError(f"device {dev} does not exist ({count} CUDA "
                         "device(s)); name the device this rank runs on")
    return dev


def make_mesh(data: int = -1, tensor: int = 1, *,
              backend: Optional[str] = None, device=None) -> Mesh:
    """Build the ("data", "tensor") mesh this process belongs to; data=-1
    takes the ranks that remain.

    The process group is the one already initialised, else the one the
    environment describes (``torchrun``'s RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT: joined here with ``backend``, NCCL on a CUDA device and
    gloo on the CPU unless the caller names one); with neither the mesh is
    1 x 1.  ``device`` defaults to cuda:LOCAL_RANK.  The backend is never
    switched: a group that cannot start raises."""
    env = os.environ
    join = (not dist.is_initialized() and "MASTER_ADDR" in env
            and "WORLD_SIZE" in env)
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"the process group runs {have!r}, not the "
                             f"{backend!r} asked for")
        backend = have
    elif join and backend is None:
        cuda = torch.device("cuda" if device is None else device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    dev = rank_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if join:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]))
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tensor < 1 or world % tensor:
        raise ValueError(f"{world} ranks not divisible by tensor={tensor}")
    if data == -1:
        data = world // tensor
    if data * tensor != world:
        raise ValueError(f"mesh {data}x{tensor} != {world} ranks")
    tgroup = dgroup = None
    # every rank creates every group, in one order (new_group's contract)
    if tensor > 1:
        for d in range(data):
            g = dist.new_group(list(range(d * tensor, (d + 1) * tensor)))
            if d == rank // tensor:
                tgroup = g
    if data > 1:
        for t in range(tensor):
            g = dist.new_group(list(range(t, world, tensor)))
            if t == rank % tensor:
                dgroup = g
    return Mesh({"data": data, "tensor": tensor}, rank // tensor,
                rank % tensor, dev, tgroup, dgroup)


# ---------------------------------------------------------------------------
# Parameter sharding rules (tensor parallelism over the DiT)
# ---------------------------------------------------------------------------

# The JAX package's rules: path regex -> spec of the last dims of each leaf.
# Column-parallel (output dim split) for QKV / MLP-in, with their biases
# and per-output-channel scales; row-parallel (input dim split) for the
# output projections, their scales and biases whole; everything else
# whole on every rank.
_COL, _ROW = (None, None, "tensor"), (None, "tensor", None)
_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r"double_blocks/attn/to_(q|k|v)/kernel(_q)?$", _COL),
    (r"double_blocks/attn/to_(q|k|v)/kernel_scale", _COL),
    (r"double_blocks/attn/add_(q|k|v)_proj/kernel(_q)?$", _COL),
    (r"double_blocks/attn/add_(q|k|v)_proj/kernel_scale", _COL),
    (r"double_blocks/attn/to_(q|k|v)/bias", (None, "tensor")),
    (r"double_blocks/attn/add_(q|k|v)_proj/bias", (None, "tensor")),
    (r"double_blocks/attn/to_out/kernel(_q)?$", _ROW),
    (r"double_blocks/attn/to_add_out/kernel(_q)?$", _ROW),
    (r"double_blocks/ff(_context)?/in/kernel(_q)?$", _COL),
    (r"double_blocks/ff(_context)?/in/kernel_scale", _COL),
    (r"double_blocks/ff(_context)?/in/bias", (None, "tensor")),
    (r"double_blocks/ff(_context)?/out/kernel(_q)?$", _ROW),
    (r"single_blocks/attn/to_(q|k|v)/kernel(_q)?$", _COL),
    (r"single_blocks/attn/to_(q|k|v)/kernel_scale", _COL),
    (r"single_blocks/attn/to_(q|k|v)/bias", (None, "tensor")),
    (r"single_blocks/proj_mlp/kernel(_q)?$", _COL),
    (r"single_blocks/proj_mlp/kernel_scale", _COL),
    (r"single_blocks/proj_mlp/bias", (None, "tensor")),
    (r"single_blocks/proj_out/kernel(_q)?$", _ROW),
    # the TP-layout fused qkv (ops.quant.fuse_qkv_projections(tp_layout=
    # True)): q/k/v stacked on their own axis, the head axis (last) split
    (r"(to_qkv|add_qkv_proj)/kernel(_q)?$", (None, None, None, "tensor")),
    (r"(to_qkv|add_qkv_proj)/kernel_scale", (None, None, None, "tensor")),
    (r"(to_qkv|add_qkv_proj)/bias", (None, None, "tensor")),
)

# the single blocks' proj_out: its input rows are the concat [attention
# (hidden) | MLP (mlp)], split by rank as `proj_out_rows` says
_PROJ_OUT = re.compile(r"single_blocks/proj_out/kernel(_q)?$")


def tree_paths(tree, path=""):
    """(path, leaf) of every leaf (None leaves too), in the order of
    `train.step.leaves`, paths "/"-joined as the JAX package's `_path_str`
    joins them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _use_tp(params, mesh: Mesh, tensor_parallel: bool) -> bool:
    """Does tensor parallelism apply?  Refuses a flat serving-fused qkv
    ([*, K, 3H]) under it: a column split of the fused axis would cut
    heads across the q/k/v boundaries."""
    use_tp = tensor_parallel and mesh.shape.get("tensor", 1) > 1
    if use_tp:
        flat_fused = [
            p for p, leaf in tree_paths(params)
            if ("to_qkv" in p or "add_qkv_proj" in p)
            and p.split("/")[-1] in ("kernel", "kernel_q")
            and getattr(leaf, "ndim", 0) in (2, 3)
        ]
        if flat_fused:
            raise ValueError(
                "tensor parallelism requires unfused or TP-layout fused "
                f"qkv projections (found flat-fused {flat_fused[0]}...): "
                "quantize with fuse_qkv=False, or re-fuse with "
                "fuse_qkv_projections(tp_layout=True)")
    return use_tp


_LORA_FACTOR = re.compile(r"^(.*)/lora_(a|b)$")


def tensor_partial_grad(path: str) -> bool:
    """Does a tensor rank hold only a part of this LoRA factor's gradient
    (to be summed over the tensor group)?  The factors stay whole on every
    rank and are sliced at use (`models.flux.model._lora_delta`): a column
    split's A (the rank's output columns contribute to it) and B (its
    columns only), a row split's A (its rows only).  A row split's B and
    the factors of a linear every rank holds whole get the whole gradient
    on every rank.  By the kernel's rule in `param_sharding_rules`."""
    m = _LORA_FACTOR.match(path)
    if m is None:
        return False
    kernel = m.group(1) + "/kernel"
    for pattern, spec in _TP_RULES:
        if re.search(pattern, kernel):
            return spec[-1] == "tensor" or m.group(2) == "a"
    return False


def _leaf_spec(path: str, leaf, use_tp: bool) -> Spec:
    """The first rule matching ``path``, trimmed or padded to the leaf's
    rank as the JAX package trims it; () (whole) when none does."""
    if use_tp:
        for pattern, spec in _TP_RULES:
            if re.search(pattern, path):
                spec = spec[-leaf.ndim:]
                return (None,) * (leaf.ndim - len(spec)) + spec
    return ()


def param_sharding_rules(params: Dict[str, Any], mesh: Mesh,
                         tensor_parallel: bool = True) -> Dict[str, Any]:
    """The spec tree of a FLUX param tree: each leaf's tuple of axis names
    (None: whole) over its dims, () for a leaf every rank holds whole --
    the tuples of the JAX package's PartitionSpecs.  Everything is whole
    when ``tensor_parallel`` is False or the tensor axis is trivial; a flat
    serving-fused qkv is refused under tensor parallelism."""
    use_tp = _use_tp(params, mesh, tensor_parallel)
    return _map(lambda path, leaf: _leaf_spec(path, leaf, use_tp), params)


def proj_out_rows(k: int, hidden: int, parts: int, index: int) -> torch.Tensor:
    """Rows of the single blocks' proj_out ([hidden | mlp] = ``k`` input
    rows) that rank ``index`` of ``parts`` holds: the rows of its attention
    heads, then those of its MLP columns -- the order of its local input
    concat [attention of its heads | MLP of its columns].  (A contiguous
    split of the ``k`` rows would pair its input with other ranks' rows;
    the JAX package's GSPMD reshards the input to match instead.)"""
    mlp = k - hidden
    if hidden % parts or mlp % parts:
        raise ValueError(f"proj_out rows [{hidden} | {mlp}] do not split "
                         f"over {parts} ranks")
    h, m = hidden // parts, mlp // parts
    return torch.cat([torch.arange(index * h, (index + 1) * h),
                      hidden + torch.arange(index * m, (index + 1) * m)])


def shard_params(params, mesh: Mesh, tensor_parallel: bool = True):
    """This rank's local slice of every leaf under `param_sharding_rules`
    (a contiguous tensor; a whole leaf is returned as it is).  The single
    blocks' proj_out takes the rows `proj_out_rows` names; a split proj_out
    (``proj_out_mlp``) is refused under tensor parallelism."""
    use_tp = _use_tp(params, mesh, tensor_parallel)
    t, ti = mesh.shape["tensor"], mesh.tensor_index
    if use_tp and any("single_blocks/proj_out_mlp/" in p
                      for p, _ in tree_paths(params)):
        raise ValueError(
            "tensor parallelism needs the single blocks' proj_out whole: "
            "quantize with split_proj_out=False (its row split follows the "
            "local [attention | MLP] concat)")

    def shard(path, leaf):
        spec = _leaf_spec(path, leaf, use_tp)
        if "tensor" not in spec:
            return leaf
        dim = spec.index("tensor")
        size = leaf.shape[dim]
        if size % t:
            raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} does "
                             f"not split over tensor={t}")
        if _PROJ_OUT.search(path):
            rows = proj_out_rows(size, leaf.shape[-1], t, ti)
            return leaf.index_select(dim, rows.to(leaf.device)).contiguous()
        n = size // t
        return leaf.narrow(dim, ti * n, n).contiguous()

    return _map(shard, params)


def shard_batch(batch, mesh: Mesh):
    """This data rank's rows of a batch that every rank holds: the leading
    axis of each tensor leaf split over the data axis.  A leaf whose
    leading dim does not divide the data extent (per-token ids, scalars) is
    returned whole."""
    n, di = mesh.shape["data"], mesh.data_index

    def rows(_, x):
        if (not isinstance(x, torch.Tensor) or x.ndim < 1 or n == 1
                or x.shape[0] % n):
            return x
        b = x.shape[0] // n
        return x[di * b:(di + 1) * b]

    return _map(rows, batch)
