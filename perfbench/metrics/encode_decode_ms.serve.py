"""Host-clock ms per request of the edit's stages around the denoise: the
brain encode (CS3 + DGF), the condition VAE encode and the VAE decode
(``sampling/generate.py``'s ``brain_encode``, ``vae_encode``,
``vae_decode``), each ended by a synchronize, in the traced run's requests
after the profiled ones."""

from perfbench.core import readers

STAGES = ("brain_encode", "vae_encode", "vae_decode")


def read(ctx):
    return readers.span_ms(ctx, STAGES, "units")
