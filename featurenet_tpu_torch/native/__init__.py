"""The native (C++) voxelizer, bound through ctypes (port of
``featurenet_tpu/native/``).

``voxelize.cpp`` (the port's own copy) does exact SAT surface
rasterization and the parity solid fill, OpenMP-parallel over triangles.
It is compiled at first use with

    g++ -O3 -shared -fPIC -fopenmp -o build/native/libfnvox-<hash>.so voxelize.cpp

into ``build/native/`` at the root of the checkout, never beside the
source; the name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Each build writes a
per-process temporary name and renames it into place, so processes that
build at once (``build_cache``'s spawned workers, parallel tests) each
load a complete library.

Public API: ``available()``, ``build()``, ``omp_threads()`` and
``voxelize_native(tris, resolution, fill)``. ``data/voxelize.py``
dispatches here under ``backend="auto"`` when the library builds, and
falls back to numpy when it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "voxelize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the shared library lives, keyed by source and flags."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libfnvox-{digest}.so"


def build() -> dict:
    """Compile the library unless it is built already. Returns
    ``{"seconds": wall, "cached": bool, "path": str}``; raises with the
    compiler's output when the build fails."""
    out = library_path()
    if out.is_file():
        return {"seconds": 0.0, "cached": True, "path": str(out)}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}) for "
                               f"{SRC}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return {"seconds": time.perf_counter() - t0, "cached": False,
            "path": str(out)}


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(library_path()))
        for fn in (lib.fn_voxelize_surface, lib.fn_voxelize_fill):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
        lib.fn_omp_max_threads.restype = ctypes.c_int
        lib.fn_omp_max_threads.argtypes = []
        _lib = lib
        return lib


def available() -> bool:
    """True if the library is built, or builds, and loads here."""
    try:
        _load()
        return True
    except Exception:
        return False


def omp_threads() -> int:
    """The OpenMP threads the rasterizer runs on in this process."""
    return int(_load().fn_omp_max_threads())


def voxelize_native(
    triangles: np.ndarray, resolution: int, fill: bool = True
) -> np.ndarray:
    """Voxelize triangles already normalized into ``[0, 1]³`` to a ``bool
    [R, R, R]`` grid. ``fill=True`` is bitwise the numpy parity fill on
    watertight meshes; ``fill=False`` is the exact surface shell (a
    superset of the numpy sampling rasterizer's)."""
    lib = _load()
    tris = np.ascontiguousarray(triangles, dtype=np.float32)
    if tris.ndim != 3 or tris.shape[1:] != (3, 3):
        raise ValueError(f"expected [n,3,3] triangles, got {tris.shape}")
    R = int(resolution)
    out = np.zeros(R * R * R, dtype=np.uint8)
    fn = lib.fn_voxelize_fill if fill else lib.fn_voxelize_surface
    rc = fn(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(tris.shape[0]),
        ctypes.c_int(R),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"native voxelizer failed with code {rc}")
    return out.reshape(R, R, R).astype(bool)
