"""Start the ranks of one host as child processes, as ``torchrun`` would,
and collect what each returns (the CPU tests' gloo groups and the one-card
phase of ``chip_smoke.py``).

    results = spawn_ranks(fn, 2, (arg,), timeout=120.0)

Rank r runs ``fn(r, *args)`` in a process started with the ``spawn``
method, its environment holding RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR (localhost) and MASTER_PORT (a free port), so
that `parallel.mesh.make_mesh` joins their group.  ``fn`` and its
arguments and result must pickle (``fn`` a module-level function).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, env: Dict[str, str], args,
               results) -> None:
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *,
                timeout: float, env: Optional[Dict[str, str]] = None
                ) -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own
    process.  Raises RuntimeError when a rank raises, exits without a
    result or with a non-zero code, or the ranks are not all done within
    ``timeout`` seconds (the other ranks are killed at the first failure);
    every process it started has ended when it returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    base = {"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
            **(env or {})}
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, base, tuple(args), results))
             for r in range(world)]
    got: Dict[int, Any] = {}
    failed: List[str] = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a child blocks on exit until its
        # queued result is read
        while len(got) + len(failed) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    failed.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                    break
                if time.monotonic() > deadline:
                    failed.append(f"ranks still running after {timeout} s: "
                                  f"{[r for r in range(world) if r not in got]}")
                    break
                continue
            if ok:
                got[rank] = value
            else:  # the others may wait on it in a collective: stop them
                failed.append(f"rank {rank} raised:\n{value}")
                break
        if not failed:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    codes = [p.exitcode for p in procs]
    if failed or any(c != 0 for c in codes):
        raise RuntimeError(f"{world} ranks: exit codes {codes}; "
                           + "; ".join(failed))
    return [got[r] for r in range(world)]
