"""Device ms per request of the edit's stages around the denoise: the
``edit.brain_encode``, ``edit.vae_encode`` and ``edit.vae_decode`` spans of
the profiled requests (CS3 + DGF, the condition VAE encode, the VAE
decode), each timed by the program's pair of CUDA events, over the
``edit.request`` spans.  None where the program records no such span."""

STAGES = ("edit.brain_encode", "edit.vae_encode", "edit.vae_decode")


def read(ctx):
    try:
        from loongx_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    records = profiling.spans()
    requests = sum(1 for s in records if s.name == "edit.request")
    stages = [s for s in records if s.name in STAGES]
    if not requests or not stages:
        return None
    return sum(s.device_end_ns - s.device_start_ns for s in stages) \
        / requests / 1e6
