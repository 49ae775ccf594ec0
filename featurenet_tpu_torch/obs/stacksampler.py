"""Host thread-stack sampler: seconds of folded stacks (port of
``featurenet_tpu/obs/stacksampler.py``).

The perf plane (``obs/perf.py``) attributes the card's time; this module
attributes the host's Python time (the batcher's dispatch thread, the HTTP
threads, a capture thread) by polling ``sys._current_frames()``: no signal
handler, no native extension, nothing asked of the sampled threads.

``sample_stacks`` polls every thread's frame at ``hz`` for ``duration_s``
and folds each observation into the flamegraph form::

    <thread name>;file.py:outermost;...;file.py:innermost <count>

Thread names are resolved each tick, so a thread born mid-profile is named
too. The sampler runs inside an incident capture, so it has a hard
wall-clock deadline (``max_wall_s``, by default twice the duration): on a
host too loaded to keep the cadence the loop stops there and keeps the
partial profile, marked ``truncated``. A thread that holds the GIL for a
long stretch delays ticks; ``ticks`` against ``duration_s * hz`` shows
it.

Folding only (file name, function name) pairs keeps every tick valid when
a frame is caught mid-return. Standard library only.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

DEFAULT_HZ = 50.0
DEFAULT_DURATION_S = 2.0


def _thread_names() -> dict[int, str]:
    """ident → name of every live thread."""
    return {t.ident: t.name for t in threading.enumerate()
            if t.ident is not None}


def _fold_frame(frame) -> str:
    """One thread's stack as ``file:func;...``, outermost first (base names
    and identifiers hold no ``;`` or space)."""
    parts: list[str] = []
    f = frame
    while f is not None:
        code = f.f_code
        parts.append(
            f"{os.path.basename(code.co_filename)}:{code.co_name}"
        )
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def sample_stacks(duration_s: float = DEFAULT_DURATION_S,
                  hz: float = DEFAULT_HZ,
                  max_wall_s: Optional[float] = None) -> dict:
    """Sample every thread but the caller for ``duration_s`` at ``hz``.
    Returns ``{"folded": {stack: count}, "samples": n, "ticks": t,
    "duration_s": wall, "truncated": bool}``; ``max_wall_s`` (default
    ``2 * duration_s``) is the hard deadline."""
    duration_s = max(0.0, float(duration_s))
    interval = 1.0 / max(1.0, float(hz))
    if max_wall_s is None:
        max_wall_s = 2.0 * duration_s
    self_ident = threading.get_ident()
    folded: dict[str, int] = {}
    ticks = samples = 0
    truncated = False
    t0 = time.monotonic()
    deadline = t0 + max(float(max_wall_s), interval)
    end = t0 + duration_s
    while True:
        now = time.monotonic()
        if now >= end:
            break
        if now >= deadline:
            truncated = True  # the host cannot keep the cadence
            break
        names = _thread_names()
        frames = sys._current_frames()  # one consistent snapshot
        ticks += 1
        for ident, frame in frames.items():
            if ident == self_ident:
                continue
            name = names.get(ident, f"thread-{ident}")
            stack = f"{name};{_fold_frame(frame)}"
            folded[stack] = folded.get(stack, 0) + 1
            samples += 1
        del frames  # drop the frame references before sleeping
        time.sleep(interval)
    return {
        "folded": folded,
        "samples": samples,
        "ticks": ticks,
        "duration_s": round(time.monotonic() - t0, 3),
        "truncated": truncated,
    }


def render_folded(profile: dict) -> str:
    """A profile's ``folded`` as folded-stack text, one ``stack count``
    line each, the largest count first (what a bundle stores)."""
    folded = profile.get("folded") or {}
    lines = [f"{stack} {count}" for stack, count in
             sorted(folded.items(), key=lambda kv: (-kv[1], kv[0]))]
    return "\n".join(lines) + ("\n" if lines else "")


def parse_folded(text: str) -> dict[str, int]:
    """The inverse of ``render_folded``; a malformed line is skipped."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def thread_totals(folded: dict[str, int]) -> dict[str, int]:
    """Samples per thread (each stack's first segment is its thread)."""
    out: dict[str, int] = {}
    for stack, count in folded.items():
        name = stack.split(";", 1)[0]
        out[name] = out.get(name, 0) + count
    return out
