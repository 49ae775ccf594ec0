"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each source under ``ops/csrc/`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <src>

The output goes to ``build/kernels/`` at the root of the checkout and is
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. Nothing is built when a module is
imported: ``load`` builds at first use, ``build_all`` builds every source
at once (one ``nvcc`` each, started together) and is what a caller that
wants the build time on its own calls first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Kernel name -> source file under csrc/.
SOURCES = {
    "conv3d_fwd": "conv3d_fwd.cu",
    "conv3d_dw": "conv3d_dw.cu",
    "conv_dw_folded": "conv_dw_folded.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``'s,
    or the first on ``PATH``. Raises when there is none."""
    roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for root in roots:
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from featurenet_tpu_torch/ops/csrc at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s shared library lives, keyed by source and flags."""
    src = SRC_DIR / SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(SRC_DIR / SOURCES[name])]


def build_all(names=None) -> dict[str, dict]:
    """Compile every named kernel (all of ``SOURCES`` by default) that is
    not built yet, one ``nvcc`` process each, all started together.
    Returns ``{name: {"seconds": wall, "log": ptxas output or "cached"}}``
    and raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    report = {n: {"seconds": 0.0, "log": "cached"} for n in names}
    if not todo:
        return report
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, n, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report[n] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{n} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
