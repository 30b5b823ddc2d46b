"""The readings that a cell's limits are set from, in one process per cell:
for each seed, a short window at the cell's own size (one evaluation, or
one training update after the set-up update), then the numbers that
`correct` compares, once for the program and once for each candidate put
in its place: "tf32", the reference computed with TF32 (the control), and
for training "half_batch" and "lr_off", the reference with half of each
minibatch left out or with the learning rate 10 % high (faults), for the
evaluation "one_frame", "unchanged_tick" and "moved_spawn" (faults planted
in the frames, the NPC tick and the NPC spawn).  Each is
judged against the cell's limits as a run judges the program (run.judge),
and its verdict printed as `correct`.  The benchmark's own runs never run
this.

    python -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--candidates program tf32 half_batch lr_off] [--seconds <s>]

Prints one JSON line per seed and candidate.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from typing import Iterator

import torch

from portbench import run


def readings(workload: str, seeds, candidates, device: torch.device, root: str,
             seconds: float = 0.0, overrides=None) -> Iterator[dict]:
    """For each seed a window of `seconds` (0: one evaluation or one update)
    on one driver, then each candidate's numbers and verdict."""
    entry, config, mix = run.cell(run.load_json(root, "BENCHMARK.json"), workload)
    mix.update(overrides or {})
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}").Driver(
        config, mix, seeds[0], device, root)
    t0 = time.perf_counter()
    driver.setup()
    yield dict(setup_s=time.perf_counter() - t0)
    for i, seed in enumerate(seeds):
        if i:
            if mix["driver"] == "train":
                driver.fresh_agent(seed)
            else:
                driver.reseed(seed)
        t = time.perf_counter()
        res = driver.window(seconds, trace=False)
        for cand in candidates:
            numbers = driver.check(cand)
            yield dict(workload=workload, seed=seed, candidate=cand,
                       correct=run.judge(numbers, mix["limits"])[0],
                       window_s=time.perf_counter() - t, numbers=numbers,
                       look=driver.diag, e2e=res["e2e"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--candidates", nargs="+", default=["program", "tf32"])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    for line in readings(args.workload, args.seeds, args.candidates, torch.device("cuda"),
                         os.getcwd(), args.seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
