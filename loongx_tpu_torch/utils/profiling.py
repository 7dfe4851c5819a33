"""Profiling and step timing (counterpart of
``loongx_tpu/utils/profiling.py``): a barrier that waits for the device,
a torch.profiler trace around a block of work, a step timer with
percentile summaries, and the card's name and power limit that every
measurement is reported beside."""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

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


class StepTimer:
    """Accumulates per-step wall times; prints percentile summaries."""

    def __init__(self, name: str = "step", sync_every: int = 1):
        self.name = name
        self.sync_every = sync_every
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def tick(self, result=None):
        """Call once per step; forces ``result`` every sync_every steps so
        queue depth can't hide real latency."""
        self._count += 1
        if result is not None and self._count % self.sync_every == 0:
            force(result)
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
        self._t0 = now

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "count": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "total_s": float(arr.sum()),
        }

    def report(self) -> str:
        s = self.summary()
        if not s:
            return f"{self.name}: no samples"
        return (
            f"{self.name}: n={s['count']} mean={s['mean_s']*1e3:.1f}ms "
            f"p50={s['p50_s']*1e3:.1f}ms p90={s['p90_s']*1e3:.1f}ms "
            f"p99={s['p99_s']*1e3:.1f}ms"
        )
