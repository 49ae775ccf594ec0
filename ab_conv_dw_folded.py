#!/usr/bin/env python3
"""Time variants of the conv_dw_folded CUDA source's bf16 path against each
other on one NVIDIA GPU, in turns, at sprint64's three batch-256
weight-gradient shapes.

    python3 ab_conv_dw_folded.py [VARIANT.cu ...]

Each variant is a copy of ``featurenet_tpu_torch/ops/csrc/conv_dw_folded.cu``
with the same C entry, edited; the checkout's own source is always timed as
``repo``. Every source is built with the flags of ``ops/build.py`` (one nvcc
each, in parallel) into ``build/ab/``; ptxas's register and spill lines are
printed per source. Each variant runs with the wrapper's plan
(``conv_dw.folded_plan``) on the same bf16 inputs, is held against
``conv_dw_plain`` (its max error over the largest |output| is printed, not
judged), and is timed as ``chip_smoke.py`` times a kernel (median of 20
calls) in the order A, B, ..., repo, repo, ..., B, A per shape. Prints one
JSON line per (shape, source) and a last line with each source's
per-shape times summed, averaged over its turns. Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SHAPES = [(32, 32), (32, 64), (64, 64)]  # cin, cout of sprint64's 3³ blocks
BATCH, GRID, K = 256, 16, 3


def _build(names_sources: dict[str, Path]) -> dict:
    from featurenet_tpu_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{n}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, src in names_sources.items()}
    fns = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        print(f"build {n}: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln),
            flush=True)
        fn = ctypes.CDLL(str(out_dir / f"{n}.so")).conv_dw_folded
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def _call(torch, fn, x, g):
    from featurenet_tpu_torch.ops import conv_dw

    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    bn, slabs, slab_len = conv_dw.folded_plan(x, g, K)
    part = torch.empty((slabs, K ** 3 * cin * cout), device=x.device)
    out = torch.empty((K, K, K, cin, cout), device=x.device)
    rc = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), 1,
            b, d, h, w, cin, cout, K, bn, slabs, slab_len,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_conv_dw_folded: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import time_ms
    from featurenet_tpu_torch.ops import build, conv_dw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    sources = {p.stem: p for p in args.variants}
    sources["repo"] = build.SRC_DIR / build.SOURCES["conv_dw_folded"]
    fns = _build(sources)
    others = [n for n in fns if n != "repo"]
    order = others + ["repo", "repo"] + others[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    times: dict[str, list[float]] = {n: [] for n in fns}
    for cin, cout in SHAPES:
        x = torch.randn((BATCH, GRID, GRID, GRID, cin), device="cuda",
                        generator=gen).bfloat16()
        g = torch.randn((BATCH, GRID, GRID, GRID, cout), device="cuda",
                        generator=gen).bfloat16()
        want = conv_dw.conv_dw_plain(x, g, K)
        scale = float(want.abs().max())
        flops = 2.0 * BATCH * GRID ** 3 * K ** 3 * cin * cout
        for n in order:
            got = _call(torch, fns[n], x, g)
            err = float((got - want).abs().max()) / scale
            ms = time_ms(torch, lambda: _call(torch, fns[n], x, g))
            times[n].append(ms)
            print(json.dumps({"source": n, "cin": cin, "cout": cout,
                              "ms": ms, "tflops": flops / ms / 1e9,
                              "max_rel_err": err}), flush=True)
        del x, g, want
    turns = {n: order.count(n) for n in fns}
    print(json.dumps({"summed_ms": {n: sum(v) / turns[n] for n, v in times.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
