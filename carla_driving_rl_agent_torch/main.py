"""Command line of the PyTorch port: curriculum stage s1, and the
evaluation sweep, on one GPU.

    python -m carla_driving_rl_agent_torch.main --stage s1 --epochs 1 --block --fused-step \
        [--fused-units]
    python -m carla_driving_rl_agent_torch.main --evaluate [--weights safe-s5] \
        [--steps 512] [--trials 50]

Mirrors `main.py --stage s1 --epochs N [--block]` of the JAX package with the
shipped sequential float32 trainer (main.FAST_TRAIN = dict()): 5 updates per
epoch of 32 worlds x 128 steps (512-step episodes), batch 64, Town03 with no
traffic.  `--fused-step` runs the physics on the CUDA kernel
(CARLAEnvConfig.fused_step); `--fused-units` runs the backbone's stride-1
ShuffleNet units on the fused unit kernels (CARLAgentConfig.fused_units,
the counterpart of the JAX package's main.FAST_TRAIN = dict(fused_units=True)).
Checkpoints go to weights-torch/stage-s1 (and a
per-epoch copy stage-s1-<epoch>) of the checkout, never into the tracked
weights/.

`--evaluate` is the counterpart of the JAX package's `main.py
--evaluate` (run_evaluation, main.py:229-240): the 48 scenarios, 2 weather
modes x 8 towns x 3 traffic levels, at seed 42, of the checkpoint
weights/<weights>; one record per scenario under
weights-torch/<weights>/evaluation/.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from carla_driving_rl_agent_torch.curriculum import stages

EPISODES = 5
TIMESTEPS = 512
BATCH = 64
NUM_ENVS = 32


def make_stage(which: str, num_envs: int = NUM_ENVS, block: bool = False,
               fused_step: bool = False, fused_units: bool = False,
               weights_dir: str = stages.DEFAULT_WEIGHTS_DIR, device=None) -> stages.Stage:
    if which != "s1":
        raise NotImplementedError(f"stage {which!r}: the port trains stage s1 only so far")
    return stages.stage_s1(episodes=EPISODES, timesteps=TIMESTEPS, batch_size=BATCH,
                           num_envs=num_envs, save_every="end", rollout_block=block,
                           fused_units=fused_units, weights_dir=weights_dir,
                           env_overrides=dict(fused_step=fused_step, device=device))


def run_evaluation(weights: str = "stage-s5", steps: int = 512, trials: int = 50,
                   device=None) -> None:
    """The full sweep (reference main.py:94-101): 8 towns x 3 traffic
    levels x 2 weather modes, seed 42."""
    for mode in ("train", "test"):
        for town in stages.EVAL_TOWNS:
            for traffic in stages.TRAFFIC_SPECS:
                t0 = time.perf_counter()
                rec = stages.evaluate(mode=mode, town=town, seeds=[42], traffic=traffic,
                                      steps=steps, trials=trials, weights=weights,
                                      device=device)[0]
                print(json.dumps(dict(mode=mode, town=town, traffic=traffic,
                                      seconds=round(time.perf_counter() - t0, 3),
                                      **{k: v for k, v in rec.items() if k.endswith("_mean")})),
                      flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--stage", choices=["s1"])
    what.add_argument("--evaluate", action="store_true",
                      help="the 48-scenario evaluation of --weights, seed 42")
    ap.add_argument("--weights", default="stage-s5",
                    help="--evaluate: the checkpoint under weights/")
    ap.add_argument("--steps", type=int, default=512, help="--evaluate: steps per episode")
    ap.add_argument("--trials", type=int, default=50, help="--evaluate: trials per scenario")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num-envs", type=int, default=NUM_ENVS)
    ap.add_argument("--block", action="store_true",
                    help="block rollout (one forward pass and one frame per 4 steps)")
    ap.add_argument("--fused-step", action="store_true",
                    help="physics on the CUDA kernel (ops/physics.py)")
    ap.add_argument("--fused-units", action="store_true",
                    help="stride-1 ShuffleNet units on the fused unit kernels "
                         "(ops/shuffle_unit.py)")
    ap.add_argument("--weights-dir", default=stages.DEFAULT_WEIGHTS_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    if args.evaluate:
        t0 = time.perf_counter()
        run_evaluation(args.weights, args.steps, args.trials, device=args.device)
        print(f"evaluation of {args.weights}: 48 scenarios in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0

    stage = make_stage(args.stage, args.num_envs, block=args.block,
                       fused_step=args.fused_step, fused_units=args.fused_units,
                       weights_dir=args.weights_dir,
                       device=args.device)
    t0 = time.perf_counter()

    def log(step, metrics):
        print(json.dumps(dict(update=step, **{k: round(v, 6) for k, v in metrics.items()})),
              flush=True)

    stage.run2(epochs=args.epochs, callback=log)
    print(f"stage-{args.stage}: {args.epochs} epochs in {time.perf_counter() - t0:.1f} s; "
          f"weights in {stage.agent.base_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
