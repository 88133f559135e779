"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a short
stretch of the cell's own work, read back from its Chrome trace.

The window runs from just after the profiler starts to just after the
last ``torch.cuda.synchronize()`` of the traced work, on the host clock,
so host time before the first launch counts as idle. Busy time is the
union of the device's kernel, copy and set spans. Each idle stretch is
named by the innermost host operation that spans its middle.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict

from benchmark import spec

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function")
WINDOW_MARK = "benchmark.traced_window"
TOP = 10


def profile(work: Callable[[], None]) -> Dict:
    """Run ``work`` (which ends with the device synchronized) under the
    profiler; returns the trace's reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    prof = torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    start = time.perf_counter()
    with torch.profiler.record_function(WINDOW_MARK):
        work()
        torch.cuda.synchronize()
    window_s = time.perf_counter() - start
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read(events, window_s)


def _union(spans):
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events, window_s: float) -> Dict:
    """Busy seconds, device seconds by kernel family and by convolution,
    and idle seconds by host operation, from Chrome trace events."""
    table = spec.families()
    device, host, mark = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            device.append((*span, e["cat"], e.get("name", "")))
        elif e.get("name") == WINDOW_MARK:
            mark = span
        elif e.get("cat") in HOST_CATS:
            host.append((*span, e.get("name", "")))
    busy = _union([(s, e) for s, e, _, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_family: Dict[str, float] = defaultdict(float)
    conv_s = 0.0
    for s, e, cat, name in device:
        fam = (spec.family_of(name, table) if cat == "kernel"
               else cat.replace("gpu_", ""))
        if fam == "other":
            fam = "other: " + name[:60]
        by_family[fam] += (e - s) / 1e6
        if table.get(fam, {}).get("conv"):
            conv_s += (e - s) / 1e6
    idle: Dict[str, float] = defaultdict(float)
    if mark is not None:
        edges = [mark[0]] + [x for span in busy for x in span] + [mark[1]]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                idle[_doing((s + e) / 2, host)] += (e - s) / 1e6
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": sum(1 for d in device if d[2] == "kernel"),
        "conv_s": conv_s,
        "families": dict(by_family),
        "device_ops": sorted(by_family.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }


def _doing(t: float, host) -> str:
    """The innermost host operation running at ``t``."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return "host: " + (best[2][:60] if best else "no operation")
