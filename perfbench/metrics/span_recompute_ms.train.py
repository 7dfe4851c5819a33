"""Device ms per profiled QLoRA step of the ``train.recompute`` spans
(remat's re-run of each DiT block in the backward, in
``models/flux/model.py``), each timed by the program's pair of CUDA
events, over the ``train.step`` spans.  None where the program records no
such span."""

PHASES = ("train.recompute",)


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    records = profiling.spans()
    steps = sum(1 for s in records if s.name == "train.step")
    phases = [s for s in records if s.name in PHASES]
    if not steps or not phases:
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in phases) \
        / steps / 1e6
