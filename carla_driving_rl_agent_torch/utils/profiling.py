"""Profiling: the program's own spans, and a device trace around a block of
code.

Spans name what the host does at the layer boundaries of training and
evaluation: `update` and its phases `update.rollout`, `update.targets`,
`update.policy`, `update.value` (or `update.fused`), each minibatch's
`minibatch.gather` and `minibatch.policy_step` with its `step.forward`,
`step.backward`, `step.apply` and `step.old_policy`; the evaluation's
`eval.step` (`eval.block` in blocks) with its `predict` and `env.step`,
whose `world.step` holds `npc.tick` and `world.reset` holds `npc.spawn`.

    with span("env.step"):
        ...

Recording is process-wide and off by default.  Off, `span` costs one flag
test and returns a shared no-op context: it allocates, synchronises and
emits nothing.  On (`start()` ... `stop()`, or inside `device_trace`), a
span stamps time.perf_counter_ns() at enter and exit and keeps one record:
its id, name, parent's id, start and end.  It never synchronises the
device, never reads a device value, and puts nothing into the profiler's
trace (no record_function, no NVTX range), so the device's busy time and
launch counts read as they would without it.  The records stay in memory
until `drain()` returns them, stamped on the clock of torch.profiler's
events (Unix ns, as a kineto event's start_ns() gives them): spans and the
profiler's events lie on one time axis.  `start()` takes the anchor of
that conversion.

`timed(name)` is a span that times itself whether or not recording is on
(`.seconds` after its block); CARLAgent.last_timings reads the update's
phases from it.

The operator's use: a Chrome trace of a block of code, with the program's
spans on their own track above the CUDA streams (open it in Perfetto,
ui.perfetto.dev, or chrome://tracing):

    from carla_driving_rl_agent_torch.utils import profiling
    with profiling.device_trace("logs/profile", name="s1") as prof:
        agent.learn(1)
    prof.trace_path      # logs/profile/s1-<timestamp>.json
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import List, NamedTuple, Optional

import torch

TRACK = "Program spans"         # the Chrome trace's process that holds the spans


class Span(NamedTuple):
    """One drained span; `parent` is -1 at the top, times in Unix ns."""
    id: int
    name: str
    parent: int
    start_ns: int
    end_ns: int


class _State:
    """The process's recording switch, its open spans and kept records."""

    def __init__(self):
        self.on = False
        self.offset_ns = 0      # Unix ns minus perf_counter ns, taken by start()
        self.next_id = 0
        self.stack: List[int] = []
        self.records: List[tuple] = []


_STATE = _State()
_OFF = contextlib.nullcontext()


class _Open:
    """A span's context: stamps its start and end; records itself when
    recording was on at its enter and still is at its exit."""
    __slots__ = ("name", "id", "parent", "start", "end")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        if st.on:
            self.id = st.next_id
            st.next_id += 1
            self.parent = st.stack[-1] if st.stack else -1
            st.stack.append(self.id)
        else:
            self.id = None
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        st = _STATE
        if self.id is not None:
            st.stack.pop()
            if st.on:
                st.records.append((self.id, self.name, self.parent, self.start, self.end))
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


def span(name: str):
    """A span around a block (`with span(name):`): recorded while
    recording is on, a shared no-op context while it is off."""
    return _Open(name) if _STATE.on else _OFF


def timed(name: str) -> _Open:
    """A span that stamps its start and end even while recording is off;
    `.seconds` after its block."""
    return _Open(name)


def start() -> None:
    """Turn recording on and take the anchor that puts the spans on the
    profiler's clock."""
    t0 = time.perf_counter_ns()
    unix = time.time_ns()
    t1 = time.perf_counter_ns()
    _STATE.offset_ns = unix - (t0 + t1) // 2
    _STATE.on = True


def stop() -> None:
    """Turn recording off; spans still open record nothing."""
    _STATE.on = False


def _converted(records) -> List[Span]:
    off = _STATE.offset_ns
    return [Span(i, name, parent, s + off, e + off) for i, name, parent, s, e in records]


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they ended;
    they are no longer kept."""
    records, _STATE.records = _STATE.records, []
    return _converted(records)


def _chrome_events(spans: List[Span], base_ns: int) -> List[dict]:
    """`spans` as Chrome trace events on their own track, `ts` in µs after
    `base_ns` (a kineto trace's baseTimeNanoseconds)."""
    names = {s.id: s.name for s in spans}
    meta = [dict(ph="M", name="process_name", pid=TRACK, tid=0, args=dict(name=TRACK)),
            dict(ph="M", name="process_sort_index", pid=TRACK, tid=0, args=dict(sort_index=0))]
    return meta + [dict(ph="X", cat="program_span", name=s.name, pid=TRACK, tid="host",
                        ts=(s.start_ns - base_ns) / 1e3, dur=(s.end_ns - s.start_ns) / 1e3,
                        args=dict(parent=names.get(s.parent, "")))
                   for s in spans]


@contextlib.contextmanager
def device_trace(log_dir: str = "logs/profile", name: Optional[str] = None):
    """Profile a block of code and write its Chrome trace (viewable in
    Perfetto or chrome://tracing) to <log_dir>/<name>-<timestamp>.json:

        with device_trace("logs/profile") as prof:
            agent.learn(1)
        prof.trace_path, prof.key_averages()

    CUDA kernels are traced when CUDA is available.  Spans are recorded for
    the block (recording is left as it was found afterwards); the spans
    that began in it are written into the trace on their own track and are
    no longer kept."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{name or 'trace'}-{time.strftime('%Y%m%d-%H%M%S')}.json")
    was_on = _STATE.on
    start()
    began = time.perf_counter_ns()
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        _STATE.on = was_on
        mine = [r for r in _STATE.records if r[3] >= began]
        _STATE.records = [r for r in _STATE.records if r[3] < began]
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(_chrome_events(_converted(mine),
                                                   trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)
        prof.trace_path = path
