"""Build and load the hand-written CUDA kernels in ``loongx_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled on first use by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``loongx_tpu_torch/_build/<name>-<hash>.so`` (the hash covers the source,
every shared header ``csrc/*.cuh`` such as ``hopper.cuh``, and the flags, so
an edited source or header is rebuilt), then loaded with ``ctypes``.
Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise on a non-zero code.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one exactly
where it launches its kernel.  Callers that want the count of one run reset
it with ``LAUNCHES.clear()``.

Where hand-written kernels share a contract (the flash forward and
backward, the W8A8 and weight-only GEMMs on wgmma, split over a cluster or
on ``mma.sync``, the transposed GEMM on wgmma, its narrow kernel or on
``mma.sync``), the wrapper picks one by shape with a named rule;
``mma_sync_only()`` sends every such launch to the ``mma.sync`` kernel,
which takes every shape, to time it beside the other; the W8A8
activation pass and the LN row stats, whose warp kernels replaced
block-per-group and block-per-row ones, go to those older kernels under it
too (and the weight-only LN prologue form back to ``mma.sync``).  `entry` gives a C entry
point with its ctypes signature set once.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention", "moe_gemm", "quant_matmul", "quant_matmul_t",
           "s4d_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

LAUNCHES: collections.Counter = collections.Counter()
FORCED_ROUTE: Optional[str] = None

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Any] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _lib_path(name: str, csrc: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> Sequence[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC_DIR / f"{name}.cu")]


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together.  Raises with the compiler's output on a
    failed build.  Returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    try:
        for n, out in paths.items():
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                _nvcc_cmd(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            else:
                os.replace(tmp, paths[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built at first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def entry(lib: str, name: str, argtypes: Sequence[Any]):
    """The C entry point ``name`` of library ``lib`` with its signature
    (``argtypes``, an int return) set once, at first use, not on every
    launch."""
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _entries[(lib, name)] = fn
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")


@contextlib.contextmanager
def mma_sync_only():
    """Route every launch that has a choice to its ``mma.sync`` kernel (the
    activation pass to its block-per-group kernel, the row stats to their
    block-per-row one) while the block runs."""
    global FORCED_ROUTE
    saved, FORCED_ROUTE = FORCED_ROUTE, "mma_sync"
    try:
        yield
    finally:
        FORCED_ROUTE = saved
