"""Profiling utilities.

Counterpart of carla_driving_rl_agent_tpu/utils/profiling.py: the
reference's wall-clock `@profile` decorator
(rl/environments/carla/tools/utils.py:135-148), a device trace around a
block of code (torch.profiler with CPU and, where present, CUDA activities,
exported as a Chrome trace), named regions in it, and a synchronising
timer.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch


def profile(fn):
    """Wall-clock decorator (reference tools/utils.py:135-148)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[profile] {fn.__name__} took {time.perf_counter() - t0:.3f}s")
        return out

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str = "logs/profile", name: Optional[str] = None):
    """Profile a block of code and write its Chrome trace (viewable in
    Perfetto or chrome://tracing) to <log_dir>/<name>-<timestamp>.json:

        with device_trace("logs/profile") as prof:
            agent.learn(1)
        prof.trace_path, prof.key_averages()

    CUDA kernels are traced when CUDA is available."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name or 'trace'}-{time.strftime('%Y%m%d-%H%M%S')}.json")
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
        prof.trace_path = path


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the device trace (record_function), and an NVTX
    range when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def block_and_time(tree) -> float:
    """Synchronise the device of the first tensor of `tree` (a tensor, or
    dicts, lists and tuples of them), read one value of it back, and
    return the seconds that took."""
    t0 = time.perf_counter()
    leaf = _first_tensor(tree)
    if leaf is not None:
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        float(leaf.detach().reshape(-1)[:1].to(torch.float32).sum())
    return time.perf_counter() - t0
