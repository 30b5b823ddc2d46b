"""One run of one cell: set-up, the measured window, the metrics and the
check that decides `correct`.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 breakdown, and last `checks`: each
number that `correct` compared, with its limit.  The same numbers close
standard error.  The run exits non-zero without a result when no CUDA
device is present, when the port is missing, or when JAX or the JAX
package is loaded in this process.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "carla_driving_rl_agent_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules() -> list:
    """The forbidden top-level names (compared whole) that this process has
    loaded."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> tuple:
    """(the workload entry, its configuration, its traffic mix)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{entry['config']}.json")
    mix = load_json(HERE, "workloads", f"{entry['traffic']}.json")
    return entry, config, mix


def applies(metric: dict, cell_name: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def read_metric(name: str, ctx: dict) -> Optional[float]:
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each compared number beside its limit; correct
    when the cell's every limit has its number and none is exceeded."""
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items() if k in limits}
    correct = set(numbers) == set(limits) and all(v <= limits[k] for k, v in numbers.items())
    return correct, checks


def main(argv=None, started: Optional[float] = None, device: Optional[str] = None,
         overrides: Optional[dict] = None) -> int:
    """`device` None looks for the cell's chips and runs on CUDA; a test
    names another device, which skips the look, and may shrink the traffic
    mix by `overrides`."""
    started = time.perf_counter() if started is None else started
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = load_json(root, "BENCHMARK.json")
    entry, config, mix = cell(bench, args.workload)
    mix.update(overrides or {})

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"portbench: the cell needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}").Driver(
        config, mix, args.seed, dev, root)
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - started
    res = driver.window(args.seconds, trace=bool(args.trace))

    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or args.workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    values = dict(res["e2e"], setup_s=setup_s)
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            if applies(m, args.workload, e2e_names):
                v = read_metric(m["name"], res["ctx"])
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in e2e:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                count=entry["chips"],
                memory_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                   if dev.type == "cuda" else 0))
    info.update(res.get("device", {}))

    driver.release()
    correct, checks = judge(driver.check(), mix["limits"])

    found = forbidden_modules()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    out = dict(correct=correct, attempted=res["attempted"], failed=res["failed"],
               metrics=metrics, device=info)
    if args.trace and "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
