"""ctypes bindings for the host-ops library ``csrc/host_ops.cc`` (the
counterpart of ``loongx_tpu/native.py``).

The library is built with ``g++ -O3 -shared -fPIC`` at first use into
``loongx_tpu_torch/_build/host_ops-<hash>.so`` (the hash covers the source
and the flags), written under a temporary name and renamed, so processes
that build at once do not race.  There is no fallback: a resize through
PIL gives other pixels than this library's, so where the library cannot
be built every entry point raises, naming the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "host_ops.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"host_ops-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(
            f"cannot build the host-ops library {SOURCE} with g++: {exc}. "
            "The data loader needs it (no PIL fallback: its resize gives "
            "other pixels)") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                ctypes.c_float, ctypes.c_void_p]
            lib.resize_bilinear_u8_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float]
            lib.rgb_to_gray3_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            for fn in (lib.u8_to_f32, lib.resize_bilinear_u8_f32,
                       lib.rgb_to_gray3_u8):
                fn.restype = None
            _lib = lib
        return _lib


def u8_to_f32(img: np.ndarray, scale: float = 1.0 / 255.0,
              offset: float = 0.0) -> np.ndarray:
    """uint8 array -> float32 (y = x * scale + offset)."""
    img = np.ascontiguousarray(img, np.uint8)
    lib = get_lib()
    out = np.empty(img.shape, np.float32)
    lib.u8_to_f32(img.ctypes.data, img.size, ctypes.c_float(scale),
                  ctypes.c_float(offset), out.ctypes.data)
    return out


def resize_bilinear(img: np.ndarray, dh: int, dw: int,
                    scale: float = 1.0 / 255.0,
                    offset: float = 0.0) -> np.ndarray:
    """uint8 [H, W, C] -> float32 [dh, dw, C], bilinear, then the affine."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or dh <= 0 or dw <= 0:
        raise ValueError(f"resize_bilinear takes [H, W, C] uint8 to a "
                         f"positive size, got {img.shape} -> ({dh}, {dw})")
    sh, sw, c = img.shape
    lib = get_lib()
    out = np.empty((dh, dw, c), np.float32)
    lib.resize_bilinear_u8_f32(img.ctypes.data, sh, sw, c, out.ctypes.data,
                               dh, dw, ctypes.c_float(scale),
                               ctypes.c_float(offset))
    return out


def rgb_to_gray3(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W, 3], ITU-R 601 gray replicated."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"rgb_to_gray3 takes [H, W, 3] uint8, got {img.shape}")
    lib = get_lib()
    out = np.empty_like(img)
    lib.rgb_to_gray3_u8(img.ctypes.data, img.shape[0] * img.shape[1],
                        out.ctypes.data)
    return out
