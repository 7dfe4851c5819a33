"""Device-side timing from profiler traces (counterpart of
``loongx_tpu/utils/device_bench.py``).

A wrapper's host clock around a short kernel measures the launch, not the
kernel.  These run a function under torch.profiler and read the kernels'
own device time.  Only device kernel events count: the host's launch
records of the same kernels are CPU events and are left out, as the JAX
package keeps only its device track so that host mirrors do not count
twice.  On the CPU (``device="cpu"``, when the caller asks for it) the
device is the host: the top-level operator events count, each once
(their children are inside them).
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, Optional

import torch

# a profiler session now and then records no device activity: retried
_SESSIONS = 3


def _events(fn: Callable, n: int, cuda: bool):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    for _ in range(_SESSIONS if cuda else 1):
        with profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            if cuda:
                torch.cuda.synchronize()
        if cuda:
            events = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
        else:
            events = [e for e in prof.events() if e.cpu_parent is None]
        if events:
            return events
    return []


def _check_device(device: str) -> bool:
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available "
                           "(pass device='cpu' to time on the host)")
    return cuda


def device_op_times(fn: Callable, n: int = 5, warmup: int = 1,
                    device: str = "cuda") -> Dict[str, float]:
    """Run ``fn`` ``warmup`` times, then ``n`` times under the profiler;
    return {kernel name: total ms over the n calls} (empty when the
    profiler saw no activity)."""
    cuda = _check_device(device)
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    agg: Dict[str, float] = collections.defaultdict(float)
    for e in _events(fn, n, cuda):
        agg[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    return dict(agg)


def device_time_ms(fn: Callable, match: str, n: int = 5, warmup: int = 1,
                   device: str = "cuda") -> float:
    """Mean device ms per call of the kernels whose name contains
    ``match`` ("" for all); NaN when the profiler saw no activity."""
    ops = device_op_times(fn, n=n, warmup=warmup, device=device)
    if not ops:
        return float("nan")
    return sum(v for k, v in ops.items() if match in k) / n


def device_ms(fn: Callable, reps: int = 20,
              match: Optional[str] = None) -> float:
    """Mean device ms per ``fn()`` on the card over ``reps`` calls after a
    warm-up call, of the kernels whose name contains ``match`` (all when
    None): `device_time_ms` under the name ``chip_smoke.py`` gives it.  It
    reads kernels too short for a CUDA-event timing of the call, whose
    time under about 0.05 ms is the wrapper's."""
    return device_time_ms(fn, match or "", n=reps)


def device_profile(run: Callable, groups: Iterable[str] = ()
                   ) -> Optional[dict]:
    """Device time of one ``run()`` on the card: kernel ms by group (the
    first of ``groups`` a kernel's name contains, else "other"), the five
    largest other kernels, and the device's idle share over the span from
    the first kernel start to the last kernel end.  None when the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _check_device("cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernels and copies only: a record_function range (the program's spans
    # while a profiler records) shows on the device's timeline too
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        return None
    by_group: Dict[str, float] = {}
    other: Dict[str, float] = {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        group = next((g for g in groups if g in e.name), None)
        if group is None:
            group = "other"
            other[e.name] = other.get(e.name, 0.0) + us
        by_group[group] = by_group.get(group, 0.0) + us
    busy = sum(by_group.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    return dict(busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=1.0 - busy / span, kernels=len(events),
                by_group_ms={k: v / 1e3 for k, v in by_group.items()},
                top_other_ms={k[:80]: v / 1e3 for k, v in top})
