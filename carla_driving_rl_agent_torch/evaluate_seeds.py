"""Evaluate a checkpoint on one scenario at several seeds and
hold each seed's six means against the reference's recorded evaluation of
that scenario at seed 42 (test mode, 512 steps, 50 trials, the record
shape under weights/<weights>/evaluation/): z = (port - record) / SE, with
SE the record's standard deviation over the square root of its trials.
chip_smoke.py's slice phases read their z-scores with `z_score` too.

    python -m carla_driving_rl_agent_torch.evaluate_seeds \
        [--weights safe-s5] [--town Town03] [--traffic no|regular|dense] \
        [--seeds 42 43 44 45 46] [--records DIR]

Runs on the card.  The records go to a temporary directory, or to DIR with
--records (never under weights/).  The last line is a JSON object with the
means, standard deviations and z-scores of every seed.

    python -m carla_driving_rl_agent_torch.evaluate_seeds --compare A.json B.json

holds two records of one scenario against each other, on any machine:
for each metric, z = (A's mean - B's mean) / the pooled standard error
sqrt(sd_A^2 / n_A + sd_B^2 / n_B) (for example the port's record of a seed
against the JAX package's record of the same seed).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile

import torch

from carla_driving_rl_agent_torch import REPO_ROOT
from carla_driving_rl_agent_torch.curriculum import stages

METRICS = ("collision_rate", "similarity", "waypoint_distance", "speed", "total_reward",
           "timesteps")
# the means held against a record, and the bar in standard errors; collision
# rate and total reward are printed, not held
HELD_METRICS, Z_BAR = ("similarity", "speed", "timesteps"), 4.0
# the recorded evaluations' shape
MODE, STEPS, TRIALS, RECORD_SEED = "test", 512, 50, 42


def z_score(record: dict, ref: dict, metric: str) -> float:
    """(record's mean - ref's mean) / SE of `metric`, with SE ref's standard
    deviation over the square root of its trials; when that is 0, 0 for
    equal means and an infinity of the difference's sign otherwise."""
    se = ref[f"{metric}_std"] / math.sqrt(len(ref[metric]))
    diff = record[f"{metric}_mean"] - ref[f"{metric}_mean"]
    return diff / se if se > 0 else math.copysign(math.inf, diff) if diff else 0.0


def z_pooled(a: dict, b: dict, metric: str) -> float:
    """(a's mean - b's mean) / sqrt(sd_a^2 / n_a + sd_b^2 / n_b) of `metric`
    (nan when both standard deviations are 0)."""
    se = math.sqrt(sum(r[f"{metric}_std"] ** 2 / len(r[metric]) for r in (a, b)))
    return (a[f"{metric}_mean"] - b[f"{metric}_mean"]) / se if se > 0 else float("nan")


def compare(path_a: str, path_b: str) -> dict:
    """Print and return the two records' means, standard deviations and
    pooled z-score of every metric."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    out = {m: dict(a=a[f"{m}_mean"], a_std=a[f"{m}_std"], b=b[f"{m}_mean"],
                   b_std=b[f"{m}_std"], z=z_pooled(a, b, m)) for m in METRICS}
    for m, v in out.items():
        print(f"{m:18s} A {v['a']:.6f} +- {v['a_std']:.6f}   B {v['b']:.6f} +- "
              f"{v['b_std']:.6f}   pooled z {v['z']:+.3f}", flush=True)
    print(json.dumps(dict(a=path_a, b=path_b, metrics=out)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", default="safe-s5")
    ap.add_argument("--town", default="Town03")
    ap.add_argument("--traffic", default="no", choices=tuple(stages.TRAFFIC_SPECS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44, 45, 46])
    ap.add_argument("--records", help="keep the records in this directory")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="hold record A against record B and exit (no card needed)")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        raise SystemExit("evaluate_seeds: no CUDA device is available")
    name = f"{args.weights}-{MODE}-{STEPS}-{TRIALS}-{args.town}-{args.traffic}"
    with open(os.path.join(REPO_ROOT, "weights", args.weights, "evaluation",
                           f"{name}-{RECORD_SEED}.json")) as f:
        ref = json.load(f)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    agent = stages.build_eval_agent(MODE, args.town, STEPS, args.weights, device="cuda",
                                    traffic=args.traffic)
    out = dict(weights=args.weights, scenario=name, record_seed=RECORD_SEED, card=card, seeds={})
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            rec = agent.evaluate(name=f"{name}-{seed}", timesteps=STEPS, trials=TRIALS,
                                 initial_seed=seed, evaluation_dir=args.records or tmp)
            row = {m: dict(mean=rec[f"{m}_mean"], std=rec[f"{m}_std"], z=z_score(rec, ref, m))
                   for m in METRICS}
            out["seeds"][seed] = row
            print(f"seed {seed}: " + ", ".join(
                f"{m} {v['mean']:.6f} (z {v['z']:+.3f})" for m, v in row.items()), flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
