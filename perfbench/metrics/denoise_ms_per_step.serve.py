"""Host-clock ms per denoise step: ``sampling/generate.py``'s ``denoise``
(28 steps of ``flux_forward`` and the Euler update) over its steps, in the
traced run's requests after the profiled ones."""

from perfbench.core import readers

STAGES = ("denoise",)


def read(ctx):
    return readers.span_ms(ctx, STAGES, "steps")
