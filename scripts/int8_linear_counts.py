#!/usr/bin/env python3
"""The int8 linears' routes per step in one cell of the benchmark, on one
CUDA card.

    python3 scripts/int8_linear_counts.py --workload qlora_b4_512 --seed 7

Builds and warms the cell as ``perfbench.run`` does (its configuration,
traffic and driver; weights from the seed), clears
``cuda_build.LAUNCHES``, runs one unit (a request or a train step) and
prints, per step of the unit (`steps_per_unit`), the ``int8_linear:*``
counters of ``models/flux/model.py`` (``bf16_out``: an int8 call of
`linear` / `linear_gelu` that returned the kernel's output, ``fp32_out``:
one that widened it, ``lora_update``: a rank-r update) beside the port's
kernel launches by name.  Prints a JSON line last.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from loongx_tpu_torch.ops import cuda_build  # noqa: E402
from perfbench.core import registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    drv = registry.driver(cfg["driver"]).Driver(cfg, mix, args.seed)
    drv.warm()
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    drv.run_unit(drv.first_unit)
    torch.cuda.synchronize()
    steps = drv.steps_per_unit()
    per_step = {k: v / steps for k, v in sorted(cuda_build.LAUNCHES.items())}
    out = {"workload": args.workload, "seed": args.seed,
           "steps_per_unit": steps,
           "int8_linear": {k: v for k, v in per_step.items()
                           if k.startswith("int8_linear:")},
           "launches": {k: v for k, v in per_step.items() if ":" not in k}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
