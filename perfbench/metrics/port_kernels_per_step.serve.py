"""The port's own kernel launches per denoise step: the mean over the
profiled requests' ``edit.denoise.step`` spans of the launches the program
counts (``ops/cuda_build.py``'s ``LAUNCHES``, by kernel name).
``kernels_per_step.serve`` less this is PyTorch's share.  None where the
program records no such span."""


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    steps = [s for s in profiling.spans() if s.name == "edit.denoise.step"]
    if not steps:
        return None
    return sum(s.launches for s in steps) / len(steps)
