"""`perfbench.calibrate` with the expert layer's faults
(`perfbench.faults_hidream`) among the serving faults it can plant:

    python -m perfbench.calibrate_hidream --workload hidream_edit_b4_512 \\
        --seeds 1 2 3 [--units 1] [--faults moe_top1 moe_shared_out ...]

Prints one JSON line per seed, as `perfbench.calibrate` does."""

from __future__ import annotations

import sys

from perfbench import calibrate, faults, faults_hidream


def main(argv=None) -> int:
    faults.SERVE.update(faults_hidream.MOE)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
