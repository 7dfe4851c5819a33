"""Profiling (counterpart of ``loongx_tpu/utils/profiling.py``): a barrier
that waits for the device, a torch.profiler trace around a block of work,
the card's name and power limit that every measurement is reported beside,
and the program's spans.

Spans.  ``with span("edit.denoise.step"):`` names a stage of the program.
A span records only while recording is on: inside ``spans_on()``, or while
a torch profiler session records.  Otherwise ``span`` hands back one
shared do-nothing context manager: no CUDA event, no ``record_function``,
no allocation.  A finished record (`Span`) holds

  * its name, id, the id of its parent and of its root (the request or the
    train step: the spans of one unit share it);
  * its host interval in ns on ``HOST_CLOCK``, the clock torch.profiler
    stamps host events with;
  * its device interval on the same clock, from a pair of pooled CUDA
    events recorded on the current stream at enter and exit, mapped onto
    the host clock through one reference event synchronized when recording
    turns on (where CUDA is not initialised the device interval is the host
    interval);
  * the port's own kernel launches over it (`cuda_build.LAUNCHES`, the keys
    without ``:``: every launch adds both ``name`` and ``name:route``).

Counters.  ``count_into(name, index, rows, values)`` adds a device tensor
of counts into row ``index`` of the counter ``name`` (int64 [rows, N], made
at its first use), only while spans record; nothing is read to the host
until `counters` is called.  The expert layer (`ops.moe`) counts each
routed expert's rows in ``moe.expert_rows`` this way.

Nothing synchronizes inside a span: device intervals are resolved when
`spans` is read, which synchronizes once.  Each thread keeps its own stack
of open spans; a span opened on a thread with none open (the autograd
engine's thread in a backward) takes as parent the innermost open span of
the other threads, the newest first: the span waiting in the backward.
While a profiler records, each span also enters
``torch.profiler.record_function(name)``, so a trace shows the program's
stages on its own timeline.  The last `MAX_SPANS` records are kept.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from loongx_tpu_torch.ops import cuda_build
from loongx_tpu_torch.ops.nn import tree_leaves

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def force(x) -> None:
    """Barrier that really waits: synchronize every CUDA device that holds
    a tensor leaf of ``x`` (CPU tensors are ready when returned)."""
    devices = {t.device for t in tree_leaves(x)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device: str = "cuda"):
    """torch.profiler around a block of work (CPU activity, and the card's
    kernels where ``device`` is CUDA); yields the profiler, and writes a
    Chrome / Perfetto trace to ``log_dir``/trace.json when one is given."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- spans -----------------------------------------------------------------

# torch.profiler's trace stamps host events on the wall clock (torch 2.11 with
# CUDA 12.8 on an H100, torch 2.13 on the CPU); a span's intervals are on it
HOST_CLOCK = time.time_ns
MAX_SPANS = 100_000
# reference readings taken when recording turns on; the narrowest is kept
_REFERENCE_TRIES = 3
# a root span older than this after the reference takes a new one (the two
# clocks drift apart by some microseconds a minute)
REFERENCE_MAX_AGE_NS = 60 * 10**9

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, torch.Tensor] = {}
_stacks: Dict[int, List["Span"]] = {}
_ids = itertools.count(1)
_pool: List[torch.cuda.Event] = []
_on = 0
# (reference event, its time on HOST_CLOCK) since recording turned on
_ref: Optional[Tuple[torch.cuda.Event, int]] = None


class Span:
    """One span: the context manager while it is open, its record once
    finished.  Times are ns on `HOST_CLOCK`; ``self_ns`` (device) is set
    when `spans` is read."""

    __slots__ = ("name", "id", "parent", "root", "thread", "host_start_ns",
                 "host_end_ns", "device_start_ns", "device_end_ns",
                 "launches", "self_ns", "_events", "_ref", "_rf", "_stack")

    def __init__(self, name: str):
        self.name = name
        self.device_start_ns = self.device_end_ns = None
        self.self_ns = None
        self._events = self._ref = self._rf = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        return (self.device_end_ns - self.device_start_ns) / 1e6

    def __enter__(self) -> "Span":
        tid = threading.get_ident()
        stack = _stacks.setdefault(tid, [])
        parent = stack[-1] if stack else _waiting_span(tid)
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread, self._stack = tid, stack
        if torch.cuda.is_initialized():
            self._ref = _reference(root=parent is None)
            self._events = (_event(), _event())
        self.launches = _port_launches()
        stack.append(self)
        self.host_start_ns = HOST_CLOCK()
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self._events is not None:
            self._events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.host_end_ns = HOST_CLOCK()
        self.launches = _port_launches() - self.launches
        stack, self._stack = self._stack, None
        if stack[-1] is self:
            stack.pop()
        else:  # left out of order
            stack.remove(self)
        if self._events is None:
            self.device_start_ns = self.host_start_ns
            self.device_end_ns = self.host_end_ns
        _records.append(self)
        return False


def recording() -> bool:
    """Whether `span` records: inside `spans_on`, or a profiler records."""
    return _on > 0 or _profiler_enabled()


def span(name: str):
    """The program's span ``name`` around a ``with`` block: a `Span` while
    recording is on, else a shared do-nothing context manager."""
    return Span(name) if recording() else _OFF


@contextlib.contextmanager
def spans_on():
    """Record spans inside the block, whether or not a profiler runs."""
    global _on, _ref
    _on += 1
    try:
        yield
    finally:
        _on -= 1
        if not _on:
            _ref = None


def spans() -> List[Span]:
    """The finished records, oldest first, their device intervals resolved
    (one synchronize where some are pending) and their self time set."""
    recs = list(_records)
    pending = [r for r in recs if r._events is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            ev, ref_ns = r._ref
            r.device_start_ns = ref_ns + round(
                ev.elapsed_time(r._events[0]) * 1e6)
            r.device_end_ns = ref_ns + round(
                ev.elapsed_time(r._events[1]) * 1e6)
            _pool.extend(r._events)
            r._events = r._ref = None
    _self_times(recs)
    return recs


def clear_spans() -> None:
    """Forget every finished record and every counter."""
    global _ref
    _ref = None
    _counters.clear()
    for r in list(_records):
        if r._events is not None:
            _pool.extend(r._events)
            r._events = r._ref = None
    _records.clear()


def count_into(name: str, index: int, rows: int,
               values: torch.Tensor) -> None:
    """counter[name][index] += values (a device-side add, no host read);
    the counter is int64 [rows, len(values)] on values' device."""
    buf = _counters.get(name)
    if buf is None:
        buf = torch.zeros(rows, values.numel(), dtype=torch.int64,
                          device=values.device)
        _counters[name] = buf
    buf[index] += values.reshape(-1).to(torch.int64)


def counters() -> Dict[str, torch.Tensor]:
    """Every counter, as host int64 tensors (one synchronize)."""
    return {name: buf.cpu() for name, buf in _counters.items()}


def _self_times(recs: List[Span]) -> None:
    """Each record's device duration less the part its children cover."""
    children: Dict[int, List[Tuple[int, int]]] = {}
    for r in recs:
        if r.parent is not None:
            children.setdefault(r.parent, []).append(
                (r.device_start_ns, r.device_end_ns))
    for r in recs:
        s0, s1 = r.device_start_ns, r.device_end_ns
        covered, end = 0, s0
        for c0, c1 in sorted(children.get(r.id, ())):
            c0, c1 = max(c0, end), min(c1, s1)
            if c1 > c0:
                covered += c1 - c0
                end = c1
        r.self_ns = (s1 - s0) - covered


def _waiting_span(tid: int) -> Optional[Span]:
    """The newest innermost open span of the threads other than ``tid``."""
    tops = [s[-1] for t, s in list(_stacks.items()) if s and t != tid]
    return max(tops, key=lambda s: s.id) if tops else None


def _port_launches() -> int:
    return sum(n for k, n in cuda_build.LAUNCHES.items() if ":" not in k)


def _event() -> torch.cuda.Event:
    try:
        return _pool.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _reference(root: bool) -> Tuple[torch.cuda.Event, int]:
    """The device clock's anchor on `HOST_CLOCK`: an event recorded on an
    idle device, synchronized, and placed midway between the host times
    around it (the narrowest of a few).  Taken when recording turns on, and
    again before a root span once it is `REFERENCE_MAX_AGE_NS` old, so no
    synchronize falls inside a span."""
    global _ref
    if _ref is None or (root and HOST_CLOCK() - _ref[1]
                        > REFERENCE_MAX_AGE_NS):
        torch.cuda.synchronize()
        best = None
        for _ in range(_REFERENCE_TRIES):
            ev = torch.cuda.Event(enable_timing=True)
            h0 = HOST_CLOCK()
            ev.record()
            ev.synchronize()
            h1 = HOST_CLOCK()
            if best is None or h1 - h0 < best[1] - best[0]:
                best = (h0, h1, ev)
        h0, h1, ev = best
        _ref = (ev, (h0 + h1) // 2)
    return _ref
