"""The program's own spans beside the profiled sub-window (portbench/trace.py):
which span each kernel was launched from and which span the host was in
while the card sat idle, from the port's spans
(carla_driving_rl_agent_torch/utils/profiling.py, drained on the
profiler's clock), and the per-layer numbers they give.

    python -m portbench.spans --workload <cell> --seeds <n> [<n> ...]
        --seconds <s> [--mode trace|cost] [--windows 6]

`trace` runs the cell's window as a --trace 1 run does, with the program's
spans recorded through it, drained after each iteration or evaluation, and
the profiler's events kept; per seed it prints one JSON line: the cell's
per-layer metrics as BENCHMARK.json reads them, the span metrics below,
`idle_by_span` and the attribution's sums.  `cost` prints the host ns of one
span, off and on (span_ns), sets the cell up once and runs `--windows`
untraced windows of `--seconds` on the same seed, spans off and on in turns
(off, on, on, off, ...), and prints each window's end-to-end rate.  The
drivers run as they are; this module wraps their calls from outside.

Attribution: each kernel that reduce() counts as a launch belongs, through
its correlation id, to the host runtime call that launched it, and that
call, by its host start, to the innermost span holding it.  Each idle gap of
the window is split among the innermost spans holding its parts.  Launches
whose runtime call no span holds (or the profiler did not keep) and idle
time no span holds are counted under NONE, so that the launches add up to
reduce()'s `launches` and the idle seconds to window_s - busy_s.

The span metrics: `launches_per_minibatch.train`, the launches under
minibatch.policy_step / minibatch.value_step spans of the profiled
iteration per such span; `npc_launches_per_step.eval`, the launches under
npc.tick / npc.spawn in the profiled steps per step; `npc_ms.eval`, the host
ms per evaluation step inside npc.tick and npc.spawn, and
`eval_step_p95_ms`, the 95th percentile (nearest rank) of eval.step's host
duration, both over the evaluations that were not profiled.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import math
import os
import sys
import time
from collections import Counter
from typing import Dict, List, Optional

import torch

from portbench import run, trace

NONE = "(no span)"
# the host runtime and driver calls that kineto keeps (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...); an operator's own event is "aten::..."
RUNTIME_PREFIX = "cu"
MINIBATCH_STEPS = ("minibatch.policy_step", "minibatch.value_step")
NPC = ("npc.tick", "npc.spawn")


def paths(spans) -> Dict[int, str]:
    """Each span's path of names from its outermost drained ancestor
    ("update/update.policy/minibatch.policy_step/step.backward"), by id."""
    by_id = {s.id: s for s in spans}
    out: Dict[int, str] = {}

    def path(s) -> str:
        if s.id not in out:
            parent = by_id.get(s.parent)
            out[s.id] = (path(parent) + "/" if parent is not None else "") + s.name
        return out[s.id]
    for s in spans:
        path(s)
    return out


def segments(spans) -> List[tuple]:
    """The spans' union as disjoint (start, end, path) in time order, each
    labelled with the innermost span holding it (spans nest, as one thread's
    do)."""
    p = paths(spans)
    segs: List[tuple] = []
    stack: List[tuple] = []             # (end, path) of the spans open at `now`
    now = None

    def emit(upto: int) -> None:
        if stack and upto > now:
            segs.append((now, upto, stack[-1][1]))

    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            emit(stack[-1][0])
            now = stack.pop()[0]
        if stack:
            emit(s.start_ns)
        now = s.start_ns
        stack.append((s.end_ns, p[s.id]))
    while stack:
        emit(stack[-1][0])
        now = stack.pop()[0]
    return segs


def attribute(events, spans) -> dict:
    """Launches and idle seconds of one profiled sub-window by the path of
    the innermost span holding them (NONE where none does)."""
    segs = segments(spans)
    starts = [s for s, _, _ in segs]

    def holder(t: Optional[int]) -> str:
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return segs[i][2] if i >= 0 and t < segs[i][1] else NONE

    events = list(events)
    host = {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() != torch.autograd.DeviceType.CUDA
            and e.name().startswith(RUNTIME_PREFIX)}
    launches: Counter = Counter()
    device, window = [], None
    for e in events:           # as trace.reduce reads them
        name = e.name()
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(trace.PREFIX):
                continue
            device.append((start, end))
            if not name.startswith(trace.COPY_PREFIXES):
                launches[holder(host.get(e.correlation_id()))] += 1
        elif name == trace.WINDOW:
            window = (start, end)
    if window is None:
        raise RuntimeError("the profiled sub-window left no window range")
    w0, w1 = window
    merged = trace._merge([(max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle: Counter = Counter()
    i = 0
    for g0, g1 in gaps:
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        held, j = 0, i
        while j < len(segs) and segs[j][0] < g1:
            part = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if part > 0:
                idle[segs[j][2]] += part / 1e9
                held += part
            j += 1
        if g1 - g0 > held:
            idle[NONE] += (g1 - g0 - held) / 1e9
    return dict(launches=dict(launches), idle_s=dict(idle))


def idle_by_span(att: dict, top: int = 10) -> dict:
    """The breakdown's `idle_by_span`: the `top` span paths by idle seconds
    of the profiled sub-window, and the idle seconds no span holds."""
    held = sorted(((k, v) for k, v in att["idle_s"].items() if k != NONE),
                  key=lambda kv: -kv[1])
    return dict(spans=[[k, v] for k, v in held[:top]],
                unattributed_s=att["idle_s"].get(NONE, 0.0))


def _under(path: str, names) -> bool:
    return any(part in names for part in path.split("/"))


def launches_per_minibatch(att: dict, spans) -> Optional[float]:
    steps = sum(s.name in MINIBATCH_STEPS for s in spans)
    n = sum(c for k, c in att["launches"].items() if _under(k, MINIBATCH_STEPS))
    return n / steps if steps else None


def npc_launches_per_step(att: dict, steps: int) -> Optional[float]:
    n = sum(c for k, c in att["launches"].items() if _under(k, NPC))
    return n / steps if n else None


def npc_ms(units: List[list]) -> Optional[float]:
    """Host ms per evaluation step inside npc.tick and npc.spawn, over the
    evaluations `units` (each its drained spans)."""
    steps = ms = 0.0
    for spans in units:
        p = paths(spans)
        steps += sum(s.name == "eval.step" for s in spans)
        ms += sum((s.end_ns - s.start_ns) / 1e6 for s in spans
                  if s.name in NPC and p[s.id].startswith("eval.step/"))
    return ms / steps if steps and ms else None


def eval_step_p95_ms(units: List[list]) -> Optional[float]:
    """The 95th percentile, by nearest rank, of eval.step's host duration
    over the evaluations `units`."""
    ms = sorted((s.end_ns - s.start_ns) / 1e6 for spans in units for s in spans
                if s.name == "eval.step")
    return ms[math.ceil(0.95 * len(ms)) - 1] if ms else None


def span_ns(n: int = 200_000) -> dict:
    """Host ns of one empty span, recording off and on, and of the bare loop
    around it, each over `n` spans in a tight loop."""
    from carla_driving_rl_agent_torch.utils import profiling
    out = {}
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    out["loop"] = (time.perf_counter_ns() - t0) / n
    for key in ("off", "on"):
        if key == "on":
            profiling.start()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("x"):
                pass
        out[key] = (time.perf_counter_ns() - t0) / n
        profiling.stop()
        profiling.drain()
    return out


# ----------------------------------------------------------------------
# runs of a cell's driver with the program's spans recorded
# ----------------------------------------------------------------------
class Recorded:
    """A cell's driver whose window records the program's spans: drained
    after each iteration or evaluation into `units`, and the profiler's
    events of a traced sub-window kept in `events`."""

    def __init__(self, workload: str, seed: int, device: torch.device, root: str,
                 overrides: Optional[dict] = None):
        """`overrides` shrink the traffic mix for a test on the CPU."""
        from carla_driving_rl_agent_torch.utils import profiling
        self.profiling = profiling
        self.bench = run.load_json(root, "BENCHMARK.json")
        _, config, self.mix = run.cell(self.bench, workload)
        self.mix.update(overrides or {})
        self.driver = importlib.import_module(f"portbench.drivers.{self.mix['driver']}").Driver(
            config, self.mix, seed, device, root)
        self.driver.setup()
        self.units: List[list] = []
        self.events: list = []
        unit = "_learn" if self.mix["driver"] == "train" else "_evaluate"
        inner = getattr(self.driver, unit)

        def drained(*args, **kwargs):
            out = inner(*args, **kwargs)
            self.units.append(profiling.drain())
            return out
        setattr(self.driver, unit, drained)
        tracer = self.driver.tracer
        stop = tracer.stop

        def stop_keeping():
            prof = tracer.prof
            stop()
            self.events = list(prof.profiler.kineto_results.events())
        tracer.stop = stop_keeping

    def reseed(self, seed: int) -> None:
        if self.mix["driver"] == "train":
            self.driver.fresh_agent(seed)
        else:
            self.driver.reseed(seed)
            self.driver.units.calls.clear()

    def window(self, seconds: float, traced: bool, spans: bool) -> dict:
        self.units, self.events = [], []
        self.profiling.drain()
        if spans:
            self.profiling.start()
        try:
            return self.driver.window(seconds, trace=traced)
        finally:
            self.profiling.stop()


def traced_line(rec: Recorded, workload: str, seconds: float) -> dict:
    """One traced window with spans on: the cell's per-layer metrics, the
    span metrics, idle_by_span and the attribution's sums."""
    res = rec.window(seconds, traced=True, spans=True)
    e2e_names = {m["name"] for m in rec.bench["end_to_end"]
                 if "workloads" not in m or workload in m["workloads"]}
    metrics = {m["name"]: run.read_metric(m["name"], res["ctx"]) for m in rec.bench["per_layer"]
               if run.applies(m, workload, e2e_names)}
    train = rec.mix["driver"] == "train"
    # the train driver profiles its second update, the evaluate driver its
    # first evaluation
    profiled = 1 if train else 0
    spans = rec.units[profiled]
    rest = rec.units[:profiled] + rec.units[profiled + 1:]
    att = attribute(rec.events, spans)
    red = res["ctx"]["reduced"]
    if train:
        metrics["launches_per_minibatch.train"] = launches_per_minibatch(att, spans)
    else:
        if rec.driver.env.params.has_npcs:
            metrics["npc_launches_per_step.eval"] = npc_launches_per_step(
                att, rec.mix["trace_steps"])
            metrics["npc_ms.eval"] = npc_ms(rest)
        metrics["eval_step_p95_ms"] = eval_step_p95_ms(rest)
    counts = Counter(s.name for s in spans)
    return dict(
        workload=workload, mode="trace", e2e=res["e2e"], metrics=metrics,
        idle_by_span=idle_by_span(att),
        sums=dict(launches=red["launches"], launches_attributed=sum(
            v for k, v in att["launches"].items() if k != NONE),
            launches_unattributed=att["launches"].get(NONE, 0),
            idle_s=red["window_s"] - red["busy_s"], idle_held_s=sum(
                v for k, v in att["idle_s"].items() if k != NONE),
            idle_unheld_s=att["idle_s"].get(NONE, 0.0)),
        launches_by_span=sorted(att["launches"].items(), key=lambda kv: -kv[1])[:25],
        span_counts=dict(counts), eval_steps_timed=sum(
            s.name == "eval.step" for u in rest for s in u),
        breakdown=res.get("breakdown"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("trace", "cost"), default="trace")
    ap.add_argument("--windows", type=int, default=6)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    rec = Recorded(args.workload, args.seeds[0], dev, os.getcwd())
    info = dict(device=torch.cuda.get_device_name(dev))
    if args.mode == "cost":
        print(json.dumps(dict(mode="cost", span_ns=span_ns(), **info)), flush=True)
    for k, seed in enumerate(args.seeds):
        if k:
            rec.reseed(seed)
        if args.mode == "trace":
            line = traced_line(rec, args.workload, args.seconds)
            print(json.dumps(dict(line, seed=seed, **info)), flush=True)
            continue
        for w in range(args.windows):
            on = w % 4 in (1, 2)
            if rec.mix["driver"] == "train":
                rec.driver.fresh_agent(seed)
            res = rec.window(args.seconds, traced=False, spans=on)
            print(json.dumps(dict(workload=args.workload, mode="cost", seed=seed, window=w,
                                  spans=on, e2e=res["e2e"], attempted=res["attempted"],
                                  spans_kept=sum(len(u) for u in rec.units), **info)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
