"""Multi-GPU serving: the data x tensor layout of processes, the
tensor-parallel rules over the DiT's parameters, and the per-shard forms of
the int8 GEMMs and the flash attention (counterpart of
``loongx_tpu/parallel/``)."""

from loongx_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    param_sharding_rules,
    shard_params,
    shard_batch,
)
