"""Arithmetic the per-layer metric files share.  Each metric file
(``perfbench/metrics/<name>.py``) names the kernel families it reads and
calls one of these with the run's context, a dict of:

  trace      -- `perfbench.core.trace.summarize` of the profiled units, or
                None where the profiler saw no device operation
  profiled   -- {"units", "work", "steps"} of the profiled units
  rest       -- {"units", "work", "steps", "seconds", "spans"} of the traced
                window's units after them (host clock, no profiler; the
                stage spans in seconds)
  ops        -- the `perfbench.core.flops.Op` list of one unit
  window     -- {"units", "work", "seconds", "unit_seconds"} of the whole
                window (host clock; "unit_seconds" the sum of the units'
                own seconds): what the rates and `mfu` read
  peak_bytes, setup_s -- what the other end-to-end metrics read

Each returns None where it finds nothing to read, never 0 for a share.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from perfbench.core import flops
from perfbench.core.trace import family_seconds

GEMM = ("qmm_", "act_quant", "ln_stats", "ln_mod")
ATTENTION = ("flash_", "rope_prepass", "kquant")


def roofline(ctx: Dict, kinds: Sequence[str],
             families: Sequence[str]) -> Optional[float]:
    """% of the profiled units' bound time of the ``kinds`` operations over
    the device seconds of the ``families`` kernels."""
    trace, units = ctx["trace"], ctx["profiled"]["units"]
    if trace is None or not units:
        return None
    seconds = family_seconds(trace, families)
    bound = flops.bound_seconds(ctx["ops"], kinds) * units
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds


def mfu(ctx: Dict) -> Optional[float]:
    """% of the at-peak seconds of every unit of the window over the units'
    own wall-clock seconds, each from its start to its end: in the traced
    run the profiled units and the stage spans' synchronizes are inside,
    and the harness's reading of the trace between units is not."""
    w = ctx["window"]
    if not w["units"] or w["unit_seconds"] <= 0:
        return None
    return (100.0 * flops.peak_seconds(ctx["ops"]) * w["units"]
            / w["unit_seconds"])


def idle_share(ctx: Dict) -> Optional[float]:
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def device_events_per_step(ctx: Dict) -> Optional[float]:
    trace, steps = ctx["trace"], ctx["profiled"]["steps"]
    if trace is None or not steps:
        return None
    return trace["device_events"] / steps


def other_ms_per_step(ctx: Dict, families: Sequence[str]) -> Optional[float]:
    """Device ms per step of the operations outside ``families``."""
    trace, steps = ctx["trace"], ctx["profiled"]["steps"]
    if trace is None or not steps:
        return None
    named = family_seconds(trace, families)
    return 1e3 * (sum(trace["device_ops"].values()) - named) / steps


def span_ms(ctx: Dict, stages: Sequence[str], per: str) -> Optional[float]:
    """ms of the ``stages`` spans of the units after the profiled ones, per
    unit (``per`` "units") or per step ("steps")."""
    rest = ctx["rest"]
    spans, n = rest["spans"], rest[per]
    if not n or not all(s in spans for s in stages):
        return None
    return 1e3 * sum(spans[s] for s in stages) / n
