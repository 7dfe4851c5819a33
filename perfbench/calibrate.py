"""Readings that the limits of a cell's check are set from, on the card at
the cell's own size.  For each seed: the numbers the check compares for a
sound run of the program (its first units, as a run's window starts), for
the control (the reference in the precision below the configuration's, in
the program's place: 4-bit activations for the served W8A8 DiT, the DiT's
linear inputs and outputs in fp8 e4m3 for the bf16 training step;
``--controls int8`` reads W8A8 activations beside it), and, with
``--faults``, for the
program with each named fault of `perfbench.faults` planted.

    python -m perfbench.calibrate --workload <cell> --seeds 1 2 3 \\
        [--units 1] [--faults half_batch ...]

Prints one JSON line per seed."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from perfbench import faults as fault_lib
from perfbench.core import registry


def serve_seed(module, cfg, mix, seed, units, names):
    out = {}
    for name in ["sound", *names]:
        with (fault_lib.SERVE[name]() if name != "sound"
              else contextlib.nullcontext()):
            drv = module.Driver(cfg, mix, seed)
            done = [drv.first_unit + i for i in range(units)]
            for i in done:
                drv.run_unit(i)
        checks = drv.check(done, control=name == "sound")
        out[name] = {k: v for k, (v, _) in checks.items()}
        if name == "sound":
            out["control"] = dict(drv.control)
        del drv
    return out


def train_seed(module, cfg, mix, seed, names, controls=()):
    readings = {}
    for name in ["sound", *names]:
        with (fault_lib.TRAIN[name]() if name != "sound"
              else contextlib.nullcontext()):
            drv = module.Driver(cfg, mix, seed)
            drv.warm()
        readings[name] = drv.readings
        drv.free()
    ref = drv.reference()
    out = {name: module.compare(r, ref) for name, r in readings.items()}
    out["control"] = module.compare(drv.reference("fp8"), ref)
    for acts in controls:
        out[f"control_{acts}"] = module.compare(drv.reference(acts), ref)
    out["loss"] = {"program": readings["sound"]["loss"], "reference":
                   ref["loss"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--units", type=int, default=1)
    parser.add_argument("--faults", nargs="*", default=[])
    parser.add_argument("--controls", nargs="*", default=[],
                        help="training: further precisions to read (int8)")
    args = parser.parse_args(argv)
    cell = registry.cell(registry.benchmark(), args.workload)
    cfg = registry.config(cell["config_entry"])
    mix = registry.traffic(cell["traffic"])
    module = registry.driver(cfg["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        if module.Driver.unit == "step":
            row = train_seed(module, cfg, mix, seed, args.faults,
                             args.controls)
        else:
            row = serve_seed(module, cfg, mix, seed, args.units, args.faults)
        row.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
