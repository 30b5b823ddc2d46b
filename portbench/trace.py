"""The profiled sub-window of a traced run: torch.profiler around a steady
stretch of the window, reduced to device intervals, kernel launches,
kernels by name, idle gaps and the host layer that each gap fell in.

The harness names the layers itself: `annotate` wraps a call into the
port in a profiler range named "portbench:<layer>", and only while a
sub-window is traced.  The profiler's raw events (kineto's) are read
directly; its summary tables are not built.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench:window"
PREFIX = "portbench:"
COPY_PREFIXES = ("Memcpy", "Memset")


def annotate(fn, layer: str, tracer: "Tracer"):
    """`fn` within a profiler range "portbench:<layer>" while `tracer`
    records; otherwise `fn` as it is."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not tracer.recording:
            return fn(*args, **kwargs)
        with torch.profiler.record_function(PREFIX + layer):
            return fn(*args, **kwargs)
    return call


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Starts and stops one profiled sub-window and keeps its reduction."""

    def __init__(self, device: torch.device):
        self.device = device
        self.recording = False
        self.prof = None
        self.reduced: Optional[dict] = None
        self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.recording = True
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.recording = False
        self.prof.stop()
        self.reduced = reduce(self.prof.profiler.kineto_results.events())
        self.prof = None


def reduce(events) -> dict:
    """Device intervals, launches, kernels by name and idle gaps of the
    events of one profiled sub-window."""
    kernels: Dict[str, List[float]] = {}
    device: List[Tuple[int, int]] = []
    layers: List[Tuple[int, int, str]] = []
    window = None
    launches = 0
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX):      # a range's projection on the device
                continue
            device.append((start, end))
            if not name.startswith(COPY_PREFIXES):
                launches += 1
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += e.duration_ns() / 1e9
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith(PREFIX):
            layers.append((start, end, name[len(PREFIX):]))
    if window is None:
        raise RuntimeError("the profiled sub-window left no window range")
    w0, w1 = window
    merged = _merge([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            gaps.append((s, e))
    gaps.sort(key=lambda g: g[0] - g[1])
    layers.sort(key=lambda x: x[0])

    def host_layer(t: int) -> str:
        inner = None
        for s, e, name in layers:          # the innermost range holding t
            if s > t:
                break
            if e >= t:
                inner = name
        return inner or "host (no layer)"

    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy, launches=launches, kernels=kernels,
                idle_gaps=[[host_layer(s), (e - s) / 1e9] for s, e in gaps[:10]],
                device_ops=[[short(n), v[1]] for n, v in
                            sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]])


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without `void ` and anonymous namespaces, cut to
    `limit` characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= limit else name[:limit - 3] + "..."


def kernel_seconds(reduced: dict, names) -> float:
    """Device seconds of the kernels named one of `names` (the function's
    own name, whatever its namespace, template arguments or signature)."""
    pattern = re.compile(r"(?:^|[\s:])(?:%s)[<(]" % "|".join(map(re.escape, names)))
    return sum(secs for name, (_, secs) in reduced["kernels"].items()
               if pattern.search(name))
