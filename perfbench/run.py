"""Run one cell of the benchmark of ``loongx_tpu_torch`` on the card.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process a run: set-up (weights made on
the card from the seed, the program's layout transforms, its kernels loaded
or built, one warm-up of the cell's shapes), then a closed-loop window of
at least ``--seconds``, then the check of what the window produced against
the plain reference, then one JSON line on standard output (the last).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced window (the profiler over the first units,
host-clock stage spans over all of them).

The cell, its configuration, traffic mix, driver and metrics are found by
name (`perfbench.core.registry`).  Exits non-zero, printing no result,
where no CUDA card (or fewer than the cell asks for) is present, and where
``jax``, ``jaxlib``, ``flax`` or ``loongx_tpu`` is imported by the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches of the program and its libraries, fixed inside
# the checkout: only a checkout's first run builds
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "loongx_tpu")
PROFILED_UNITS = 2


def _environment() -> None:
    os.environ["USE_FLAX"] = "0"  # transformers: never load JAX
    os.environ["USE_TF"] = "0"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not hold, compared
    whole (``loongx_tpu_torch`` is not ``loongx_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class NoCard(RuntimeError):
    pass


class Cards:
    """The CUDA cards a cell runs on: found or refused, synchronized, their
    peak memory.  Tests of the harness put a host stand-in in its place."""

    device = "cuda"

    def __init__(self, count: int):
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < count:
            raise NoCard(f"the cell needs {count} CUDA card(s); this machine "
                         f"has {have}")
        self.count = count

    def sync(self) -> None:
        import torch

        torch.cuda.synchronize()

    def reset_peak(self) -> None:
        import torch

        torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated()

    def kind(self) -> str:
        import torch

        return torch.cuda.get_device_name(0)


def window(drv, cards: Cards, seconds: float,
           traced: bool) -> Dict[str, Any]:
    """Closed loop over new units from ``drv.first_unit`` until one
    completes ``seconds`` or more after the start.  Traced: the profiler
    over the first `PROFILED_UNITS` units, the driver's stage spans over
    all, and at least one unit after the profiled ones."""
    from perfbench.core import trace

    unit, units = drv.first_unit, []
    t0 = time.perf_counter()

    def run(profiled: bool) -> float:
        nonlocal unit
        s = time.perf_counter()
        work = drv.run_unit(unit)
        e = time.perf_counter()
        units.append(dict(index=unit, start=s, end=e, work=work,
                          profiled=profiled))
        unit += 1
        return e

    out: Dict[str, Any] = {"trace": None}
    if not traced:
        while run(False) - t0 < seconds:
            pass
    else:
        with drv.stage_spans() as spans:
            with trace.record() as summary:
                for _ in range(PROFILED_UNITS):
                    run(True)
            spans.clear()
            while run(False) - t0 < seconds:
                pass
            out["spans"] = dict(spans)
        out["trace"] = summary if summary["device_events"] else None
    cards.sync()
    out["units"], out["seconds"] = units, units[-1]["end"] - t0
    return out


def _counts(units, steps_per_unit: int) -> Dict[str, Any]:
    n = len(units)
    return {"units": n, "work": sum(u["work"] for u in units),
            "steps": n * steps_per_unit,
            "seconds": sum(u["end"] - u["start"] for u in units)}


def main(argv=None, cards=Cards) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    from perfbench.core import registry, trace

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    try:
        cards = cards(cell["chips"])
    except NoCard as e:
        print(f"perfbench: {args.workload}: {e}", file=sys.stderr)
        return 3
    cfg = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    drv = registry.driver(cfg["driver"]).Driver(cfg, mix, args.seed,
                                                device=cards.device)
    drv.warm()
    cards.sync()
    cards.reset_peak()
    setup_s = time.perf_counter() - T_START

    w = window(drv, cards, args.seconds, bool(args.trace))
    peak = cards.peak()
    units = w["units"]
    steps = drv.steps_per_unit()
    ctx = {"window": {"units": len(units), "seconds": w["seconds"],
                      "work": sum(u["work"] for u in units),
                      "unit_seconds": sum(u["end"] - u["start"]
                                          for u in units)},
           "peak_bytes": peak, "setup_s": setup_s, "trace": w["trace"],
           "profiled": _counts([u for u in units if u["profiled"]], steps),
           "rest": dict(_counts([u for u in units if not u["profiled"]],
                                steps), spans=w.get("spans", {})),
           "ops": drv.ops_per_unit()}
    wanted = (registry.per_layer(bench, args.workload) if args.trace
              else registry.end_to_end(bench, args.workload))
    metrics = {}
    for m in wanted:
        value = registry.metric(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = drv.check([u["index"] for u in units])
    correct = all(value <= limit for value, limit in checks.values())
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run imported {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": cards.kind(),
              "count": cell["chips"], "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": correct, "attempted": len(units),
                              "failed": 0, "metrics": metrics,
                              "device": device}
    if args.trace and w["trace"] is not None:
        device.update(busy_s=w["trace"]["busy_s"],
                      window_s=w["trace"]["window_s"])
        result["breakdown"] = trace.breakdown(w["trace"])
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    print(f"perfbench: {args.workload} seed {args.seed} on {card_line()}; "
          f"{len(units)} {drv.unit}s in {w['seconds']:.3f} s, set-up "
          f"{setup_s:.3f} s; {drv.unit} seconds "
          + " ".join(f"{u['end'] - u['start']:.3f}" for u in units),
          file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
