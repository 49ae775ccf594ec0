#!/usr/bin/env python3
"""Time variants of a conv CUDA source against each other on one NVIDIA
GPU, in turns, at sprint64's shapes.

    python3 ab_conv_dw_folded.py [--kernel conv_dw_folded|conv3d_dw|conv3d_fwd] [VARIANT.cu ...]

``--kernel conv_dw_folded`` (the default) times copies of
``featurenet_tpu_torch/ops/csrc/conv_dw_folded.cu`` on its bf16 path,
planned by ``conv_dw.folded_plan``, at the three batch-256 weight-gradient
shapes; ``--kernel conv3d_dw`` times copies of ``csrc/conv3d_dw.cu`` in
fp32 at the same shapes, planned by ``conv3d.dw_plan``; ``--kernel
conv3d_fwd`` times copies of ``csrc/conv3d_fwd.cu`` in fp32, planned by
``conv3d.fwd_plan``, at the six shapes of a batch-256 train step (3
forward, 3 dx), the three serving shapes at batch 64 and, apart, at
batch 1. Each variant keeps the source's C entry; the checkout's own
source is always timed as ``repo``. A conv3d_dw or conv3d_fwd variant
whose tiles or occupancy differ may carry one line
``// ab-plan: {"tile_area": 16384, "chunk": 32, "blocks_per_sm": 1}``
(any of ``dw_plan``'s or ``fwd_plan``'s keywords), and is then planned
with them.

Every source is built with the flags of ``ops/build.py`` (one nvcc each,
in parallel) into ``build/ab/``; ptxas's register and spill lines are
printed per source. Each variant runs on the same inputs, is held against
the plain version (``conv_dw_plain`` or ``conv3d_plain``; its max error
over the largest |output| is printed, not judged), and is timed as
``chip_smoke.py`` times a kernel (median of 20 calls) in the order A, B,
..., repo, repo, ..., B, A per shape. Prints one JSON line per (shape,
source) and a last line with each source's per-shape times summed per
group of shapes, averaged over its turns. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

BATCH, GRID, K = 256, 16, 3
SPRINT_BLOCKS = [(32, 32), (32, 64), (64, 64)]  # cin, cout of sprint64's 3³ blocks
# (what, batch, cin, cout)
DW_SHAPES = [("train dW", BATCH, ci, co) for ci, co in SPRINT_BLOCKS]
FWD_SHAPES = ([("train fwd", BATCH, ci, co) for ci, co in SPRINT_BLOCKS]
              + [("train dx", BATCH, co, ci) for ci, co in SPRINT_BLOCKS]
              + [("serve", 64, ci, co) for ci, co in SPRINT_BLOCKS]
              + [("serve b1", 1, ci, co) for ci, co in SPRINT_BLOCKS])

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel -> (C entry, its argument types)
ENTRIES = {"conv_dw_folded": ("conv_dw_folded", [_P] * 4 + [_I] * 10 + [_L, _P]),
           "conv3d_dw": ("conv3d_dw_f32", [_P] * 4 + [_I] * 11 + [_L, _P]),
           "conv3d_fwd": ("conv3d_fwd_f32", [_P] * 3 + [_I] * 10 + [_P])}


def _build(kernel: str, names_sources: dict[str, Path]) -> dict:
    from featurenet_tpu_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {n: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{kernel}-{n}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, src in names_sources.items()}
    symbol, argtypes = ENTRIES[kernel]
    fns = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}:\n{log}")
        print(f"build {n}: " + " | ".join(
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln),
            flush=True)
        fn = getattr(ctypes.CDLL(str(out_dir / f"{kernel}-{n}.so")), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[n] = fn
    return fns


def _ab_plan(src: Path) -> dict:
    for line in src.read_text().splitlines():
        if line.startswith("// ab-plan:"):
            return json.loads(line.split(":", 1)[1])
    return {}


def _plan(kernel: str, x, g, overrides: dict) -> tuple:
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    if kernel == "conv_dw_folded":
        return (1, *x.shape, g.shape[-1], K, *conv_dw.folded_plan(x, g, K))
    if kernel == "conv3d_fwd":
        return (*x.shape, g.shape[-1], K,
                *conv3d.fwd_plan(x.shape, g.shape[-1], x.data_ptr(), g.data_ptr(),
                                 **overrides))
    return (*x.shape, g.shape[-1], K,
            *conv3d.dw_plan(x.shape, g.shape[-1], K, x.data_ptr(), g.data_ptr(),
                            **overrides))


def _call(torch, kernel: str, fn, x, g, args: tuple):
    """One launch with the C entry's integer arguments ``args``: ``g`` is
    the cotangent of a weight gradient (the slab count second to last in
    ``args``) or the weights of the forward."""
    cin, cout = x.shape[-1], g.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "conv3d_fwd":
        out = torch.empty((*x.shape[:-1], cout), device=x.device)
        rc = fn(x.data_ptr(), g.data_ptr(), out.data_ptr(), *args, stream)
    else:
        part = torch.empty((args[-2], K ** 3 * cin * cout), device=x.device)
        out = torch.empty((K, K, K, cin, cout), device=x.device)
        rc = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), *args,
                stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def _inputs(torch, kernel: str, gen, b: int, cin: int, cout: int):
    """Inputs of one shape and the plain version's output on them."""
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    dtype = torch.bfloat16 if kernel == "conv_dw_folded" else torch.float32
    x = torch.randn((b, GRID, GRID, GRID, cin), device="cuda", generator=gen).to(dtype)
    if kernel == "conv3d_fwd":
        w = torch.randn((K, K, K, cin, cout), device="cuda", generator=gen)
        w /= (K ** 3 * cin) ** 0.5
        return x, w, conv3d.conv3d_plain(x, w)
    g = torch.randn((b, GRID, GRID, GRID, cout), device="cuda", generator=gen).to(dtype)
    return x, g, conv_dw.conv_dw_plain(x, g, K)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(ENTRIES), default="conv_dw_folded")
    ap.add_argument("variants", nargs="*", type=Path)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_conv_dw_folded: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import time_ms
    from featurenet_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    sources = {p.stem: p for p in args.variants}
    sources["repo"] = build.SRC_DIR / build.SOURCES[args.kernel]
    overrides = {n: _ab_plan(p) if args.kernel != "conv_dw_folded" else {}
                 for n, p in sources.items()}
    fns = _build(args.kernel, sources)
    others = [n for n in fns if n != "repo"]
    order = others + ["repo", "repo"] + others[::-1]
    shapes = FWD_SHAPES if args.kernel == "conv3d_fwd" else DW_SHAPES
    gen = torch.Generator(device="cuda").manual_seed(0)
    times: dict[str, dict[str, list[float]]] = {}
    for what, b, cin, cout in shapes:
        x, g, want = _inputs(torch, args.kernel, gen, b, cin, cout)
        scale = float(want.abs().max())
        flops = 2.0 * b * GRID ** 3 * K ** 3 * cin * cout
        group = "train" if what.startswith("train") else what
        for n in order:
            plan = _plan(args.kernel, x, g, overrides[n])
            got = _call(torch, args.kernel, fns[n], x, g, plan)
            err = float((got - want).abs().max()) / scale
            ms = time_ms(torch, lambda: _call(torch, args.kernel, fns[n], x, g, plan))
            times.setdefault(group, {m: [] for m in fns})[n].append(ms)
            print(json.dumps({"kernel": args.kernel, "what": what, "source": n,
                              "batch": b, "cin": cin, "cout": cout,
                              "launch": plan, "ms": ms,
                              "tflops": flops / ms / 1e9, "max_rel_err": err}),
                  flush=True)
        del x, g, want
    turns = {n: order.count(n) for n in fns}
    print(json.dumps({"kernel": args.kernel,
                      "summed_ms": {grp: {n: sum(v) / turns[n] for n, v in t.items()}
                                    for grp, t in times.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
