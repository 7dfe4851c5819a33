#!/usr/bin/env python3
"""What the program's spans cost when they record, and where the card's
idle gaps fall among them, for one cell of the benchmark on one CUDA card.

    python3 scripts/tracing_cost.py --workload edit_b4_512 --seed 7 \\
        [--seconds 36] [--rounds 2] [--out result.json]

Builds the cell as ``perfbench.run`` does (its configuration, traffic and
driver; weights from the seed), warms it, then times closed-loop windows of
at least ``--seconds`` with recording off and with ``spans_on()`` around
the window, in the order off, on, on, off per round: the cell's rate
(images or samples a second) each way, the records read after each window.
Then one unit under the harness's stage wrappers with the spans on and no
profiler (each stage's host-clock time beside its spans' device time, in
the same unit), and two units under the harness's traced set-up (its stage wrappers, a
CUDA-activity profile between two marks on the device's clock, which turns
the spans on too) and the join of the trace's idle gaps with the spans:
each gap's seconds under the innermost span whose host interval holds the
gap's middle, beside the harness's own label (the innermost host CUDA call
there, or ``host, outside any CUDA call``).  Prints a JSON line last, and
writes it to ``--out`` where one is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from loongx_tpu_torch.utils import profiling  # noqa: E402
from perfbench.core import registry, trace  # noqa: E402

OUTSIDE = "outside any span"


def build(workload: str, seed: int):
    bench = registry.benchmark()
    cell = registry.cell(bench, workload)
    cfg = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    drv = registry.driver(cfg["driver"]).Driver(cfg, mix, seed)
    drv.warm()
    torch.cuda.synchronize()
    return drv


def window(drv, start: int, seconds: float) -> Tuple[float, int]:
    """(work a second over the units' own seconds, next unit)."""
    unit, work, t0 = start, 0, time.perf_counter()
    while True:
        work += drv.run_unit(unit)
        unit += 1
        if time.perf_counter() - t0 >= seconds:
            break
    torch.cuda.synchronize()
    return work / (time.perf_counter() - t0), unit


def cost(drv, seconds: float, rounds: int) -> Tuple[Dict, int]:
    unit, rates = drv.first_unit, {"off": [], "on": []}
    for _ in range(rounds):
        for mode in ("off", "on", "on", "off"):
            profiling.clear_spans()
            if mode == "on":
                with profiling.spans_on():
                    rate, unit = window(drv, unit, seconds)
                spans = len(profiling.spans())
            else:
                rate, unit = window(drv, unit, seconds)
                spans = len(profiling.spans())
            rates[mode].append(rate)
            print(f"tracing_cost: spans {mode}: {rate:.6f} a second, "
                  f"{spans} records", file=sys.stderr)
    off, on = statistics.median(rates["off"]), statistics.median(rates["on"])
    profiling.clear_spans()
    return {"rates": rates, "off": off, "on": on,
            "on_vs_off_pct": 100.0 * (on / off - 1.0)}, unit


def same_units(drv, start: int) -> Dict:
    """One unit under the harness's stage wrappers (each stage ended by a
    synchronize, timed on the host clock) with the spans on and no
    profiler: each stage's host-clock seconds beside its spans' device ms,
    in the same unit."""
    profiling.clear_spans()
    with drv.stage_spans() as outside:
        outside.clear()
        with profiling.spans_on():
            drv.run_unit(start)
        outside = dict(outside)
    device_ms: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for r in profiling.spans():
        device_ms[r.name] = device_ms.get(r.name, 0.0) + r.device_ms
        count[r.name] = count.get(r.name, 0) + 1
    profiling.clear_spans()
    return {"outside_ms": {k: 1e3 * v for k, v in outside.items()},
            "span_device_ms": device_ms, "span_count": count}


def _labels(points: List[int], intervals: List[Tuple[int, int, str]],
            default: str) -> List[str]:
    """For each of the sorted ``points``, the name of the innermost of the
    nested ``intervals`` (start, end, name) that holds it: one sweep with a
    stack of the open ones, as the harness labels its gaps."""
    intervals = sorted(intervals, key=lambda h: (h[0], -h[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(intervals) and intervals[i][0] <= t:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else default)
    return out


def join(drv, start: int, units: int = 2) -> Dict:
    """The harness's traced set-up over ``units`` units, its gaps joined
    with the spans."""
    from torch.profiler import ProfilerActivity, profile

    profiling.clear_spans()
    mark = torch.zeros(1, device="cuda")
    with drv.stage_spans():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            mark.fill_(1.0)
            for i in range(units):
                drv.run_unit(start + i)
            torch.cuda.synchronize()
            mark.fill_(2.0)
            torch.cuda.synchronize()
    events = trace._events(prof)
    summary = trace.summarize(events)
    records = profiling.spans()
    dev = [(s, e) for _, d, s, e in events if d]
    w0, w1 = min(s for s, _ in dev), max(e for _, e in dev)
    busy = trace.merge([(max(s, w0), min(e, w1)) for s, e in dev])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    host = [(s, e, n) for n, d, s, e in events
            if not d and e > w0 and s < w1]
    spans = [(r.host_start_ns, r.host_end_ns, r.name) for r in records]
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    stages = _labels(mids, spans, OUTSIDE)
    # the harness's label: the innermost host call at the gap's middle
    labels = _labels(mids, host, trace.HOST_ONLY)
    # the harness labels its longest gaps only
    longest = set(sorted(range(len(gaps)), key=lambda k: gaps[k][0]
                         - gaps[k][1])[:trace.LABELLED_GAPS])
    by_stage: Dict[str, float] = {}
    host_only: Dict[str, float] = {}
    host_only_longest: Dict[str, float] = {}
    for k, ((g0, g1), stage, label) in enumerate(zip(gaps, stages, labels)):
        seconds = (g1 - g0) / 1e9
        by_stage[stage] = by_stage.get(stage, 0.0) + seconds
        if label is trace.HOST_ONLY:
            host_only[stage] = host_only.get(stage, 0.0) + seconds
            if k in longest:
                host_only_longest[stage] = (host_only_longest.get(stage, 0.0)
                                            + seconds)

    def ranked(d):
        return sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])

    device_ms = {}
    for r in records:
        device_ms[r.name] = device_ms.get(r.name, 0.0) + r.device_ms
    profiling.clear_spans()
    return {"window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "gaps": len(gaps), "idle_s": sum(v for v in by_stage.values()),
            "idle_by_stage": ranked(by_stage),
            "host_only_by_stage": ranked(host_only),
            "host_only_longest_by_stage": ranked(host_only_longest),
            "harness_labels": summary["idle_gaps"][:10],
            "span_device_ms": device_ms}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=36.0)
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of off, on, on, off windows (0: none)")
    parser.add_argument("--out", default=None,
                        help="also write the JSON line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tracing_cost: no CUDA device")
    drv = build(args.workload, args.seed)
    out = {"workload": args.workload, "seed": args.seed,
           "card": profiling.card_line()}
    unit = drv.first_unit
    if args.rounds:
        out["cost"], unit = cost(drv, args.seconds, args.rounds)
    out["same_units"] = same_units(drv, unit)
    out["join"] = join(drv, unit + 1)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
