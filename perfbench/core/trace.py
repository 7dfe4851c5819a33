"""Reading a torch.profiler trace of the traced window.

`record` profiles a block of work on the card (CUDA activity).
`summarize` reduces the trace to
what the per-layer metrics and the result line read: the window's length,
the seconds in which some device operation ran (the union of their
intervals, clipped to the window), the device operations by name, their
count, and the idle gaps labelled by the innermost host operation that spans
each gap's middle.  Only device events count as device time; the host's
launch records of the same kernels are host events.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "perfbench.traced_window"
# idle gaps labelled by host operation: the longest ones, enough to rank
LABELLED_GAPS = 2000
TOP = 10
# the label of an idle gap in which the host made no recorded call: it ran
# Python (or waited) between two CUDA calls
HOST_ONLY = "host, outside any CUDA call"


@contextlib.contextmanager
def record():
    """Profile the block's device work (CUDA activity: the kernels, copies
    and fills, and the host's CUDA API calls); yields a dict that holds the
    trace's summary (`summarize`) once the block has ended.  One fill
    before the block and one after it, each behind a synchronize, mark the
    window's ends on the device's clock.  Host operator events are not
    recorded: at some 40 a device operation they made the trace too slow
    to read within a run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: Dict = {}
    mark = torch.zeros(1, device="cuda")
    prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        torch.cuda.synchronize()
        mark.fill_(1.0)
        yield out
        torch.cuda.synchronize()
        mark.fill_(2.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    events = _events(prof)
    t2 = time.perf_counter()
    out.update(summarize(events))
    print(f"perfbench: trace of {len(events)} events: profiler stop "
          f"{t1 - t0:.1f} s, read {t2 - t1:.1f} s, reduced "
          f"{time.perf_counter() - t2:.1f} s", file=sys.stderr)


def _events(prof) -> List[Tuple[object, bool, int, int]]:
    """(name, on the device, start ns, end ns) of every event.  A host
    event's name is read when it is needed (`_name`): most are never
    labels, and reading a name costs."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:  # an older profiler: its FunctionEvents (us)
        return [(e.name, e.device_type == cuda,
                 int(e.time_range.start * 1e3), int(e.time_range.end * 1e3))
                for e in prof.events()]
    ns = not raw or hasattr(raw[0], "start_ns")
    out = []
    for e in raw:
        if ns:
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = int(e.start_us() * 1e3), int(e.duration_us() * 1e3)
        out.append((e.name(), True, s, s + d) if e.device_type() == cuda
                   else (e, False, s, s + d))
    return out


def _name(x) -> str:
    return x if isinstance(x, str) else x.name()


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, non-overlapping union of [start, end) intervals."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events: List[Tuple[str, bool, int, int]]) -> Dict:
    """The window's summary: window_s, busy_s, device_ops {name: s},
    device_events, idle_gaps [(label, s)] (the labelled gaps' seconds
    summed by label, largest first).  The window is a host span named
    `WINDOW_SPAN` where the trace holds one, else the device's first to
    last operation (`record`'s two marks)."""
    spans = [(s, e) for n, dev, s, e in events
             if not dev and isinstance(n, str) and n == WINDOW_SPAN]
    if spans:
        w0, w1 = spans[0]
    else:
        dev_times = [(s, e) for _, dev, s, e in events if dev]
        if not dev_times:
            return dict(window_s=0.0, busy_s=0.0, device_ops={},
                        device_events=0, idle_gaps=[])
        w0 = min(s for s, _ in dev_times)
        w1 = max(e for _, e in dev_times)
    device, host = [], []
    for name, dev, s, e in events:
        if dev:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((name, s, e))
        elif e > w0 and s < w1 and (s, e) != (w0, w1):
            host.append((s, e, name))
    busy = merge([(s, e) for _, s, e in device])
    ops: Dict[str, float] = {}
    for name, s, e in device:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if w1 > prev:
        gaps.append((prev, w1))
    return dict(window_s=(w1 - w0) / 1e9,
                busy_s=sum(e - s for s, e in busy) / 1e9,
                device_ops=ops, device_events=len(device),
                idle_gaps=_label_gaps(gaps, host))


def _label_gaps(gaps, host) -> List[Tuple[str, float]]:
    """Seconds of the longest gaps summed by the innermost host event that
    holds each gap's middle (`HOST_ONLY` where none does): one sweep over
    the host events in order of start with a stack of the open ones."""
    host.sort(key=lambda h: (h[0], h[1]))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]
    by_label: Dict[str, float] = {}
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in sorted(longest):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = _name(stack[-1][2]) if stack else HOST_ONLY
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) / 1e9
    return sorted(by_label.items(), key=lambda kv: -kv[1])


def family_seconds(summary: Optional[Dict], families) -> float:
    """Device seconds of the operations whose name holds one of
    ``families`` (substrings)."""
    return sum(s for name, s in summary["device_ops"].items()
               if any(f in name for f in families))


def breakdown(summary: Dict) -> Dict[str, list]:
    ops = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n[:160], s] for n, s in summary["idle_gaps"][:TOP]]}
