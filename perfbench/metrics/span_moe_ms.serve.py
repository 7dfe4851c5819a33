"""Device ms per denoise step inside the expert layers: the ``dit.moe``
spans of the profiled requests (``ops/moe.py``'s ``expert_layer``, the
router through the combine), each timed by the program's pair of CUDA
events, over the ``edit.denoise.step`` spans.  None where the program
records no such span."""


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    records = profiling.spans()
    steps = sum(1 for s in records if s.name == "edit.denoise.step")
    layers = [s for s in records if s.name == "dit.moe"]
    if not steps or not layers:
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in layers) \
        / steps / 1e6
