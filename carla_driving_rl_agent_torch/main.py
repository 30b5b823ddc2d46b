"""Command line of the PyTorch port: the five curriculum stages with the
hand-off between them, the whole curriculum, the no-curriculum "standard"
agent, and the evaluation sweep, on one GPU.

    python -m carla_driving_rl_agent_torch.main --stage s1|s2|s3|s4|s5 --epochs 1 --block \
        [--fused-step] [--fused-units] [--safe] [--sharp] [--aug-intensity A]
    python -m carla_driving_rl_agent_torch.main --hand-off s1 s2
    python -m carla_driving_rl_agent_torch.main --curriculum --epochs 30,16,12,10,10 --block
    python -m carla_driving_rl_agent_torch.main --standard --epochs 78 --block
    python -m carla_driving_rl_agent_torch.main --evaluate [--weights safe-s5] \
        [--steps 512] [--trials 50]
    python -m carla_driving_rl_agent_torch.main --record [--weights stage-s5] \
        [--steps 512] [--trials 3] [--record-dir record]

Mirrors `main.py --stage sN --epochs N [--block]` of the JAX package with the
shipped sequential float32 trainer (main.FAST_TRAIN = dict()): 5 updates per
epoch of 32 worlds x 128 steps (512-step episodes), batch 64, Town03; s1
without traffic, s2 with 50 walkers, s3 with 50 vehicles, 50 walkers and the
training weathers, s4 as s3 with the training augmentation (aug_intensity
1.0), s5 with dense traffic (100 vehicles, 200 walkers) and the
augmentation.  s2-s5 load the weights their stage directory holds
(`--hand-off s1 s2` copies stage-s1's there, as the JAX package's hand_off);
`--curriculum` runs s1 -> s5, handing each stage the previous one's
weights; `--standard` trains stage s5's setting from scratch as
stage-standard (stage-standard-sharp with `--sharp`), the reference's
no-curriculum control agent.
`--fused-step` runs the physics on the CUDA kernel
(CARLAEnvConfig.fused_step), which computes worlds without NPCs only, so it
raises with s2-s5, `--curriculum` and `--standard`; `--fused-units` runs the
backbone's stride-1 ShuffleNet units on the fused unit kernels
(CARLAgentConfig.fused_units, the counterpart of the JAX package's
main.FAST_TRAIN = dict(fused_units=True)); `--safe` prices the env as
SAFE_ENV; `--sharp` trains with sharp_recipe, and the stages (not
`--standard`, as in the JAX package) without augmentation;
`--aug-intensity` overrides every stage's.
Checkpoints go to weights-torch/stage-sN (and a per-epoch copy
stage-sN-<epoch>) of the checkout, never into the tracked weights/.

`--evaluate` is the counterpart of the JAX package's `main.py
--evaluate` (run_evaluation, main.py:229-240): the 48 scenarios, 2 weather
modes x 8 towns x 3 traffic levels, at seed 42, of the checkpoint
weights/<weights>; one record per scenario under
weights-torch/<weights>/evaluation/.

`--record` is the counterpart of `main.py --record` (run_record,
main.py:265-269): stage s5's env on Town03 with regular traffic, the agent
of weights/<weights>, and `--trials` episodes of up to `--steps` steps
recorded as frames.npz and info.json under
<record-dir>/Town03/demo/<trial>/ (default record/ of the checkout, never
under weights/).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import warnings

from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs.wrappers import record_episodes
from carla_driving_rl_agent_torch.utils.checkpoint import refuse_tracked
from carla_driving_rl_agent_torch.utils.schedules import ExponentialDecay

EPISODES = 5
TIMESTEPS = 512
BATCH = 64
NUM_ENVS = 32

STAGE_ORDER = ["s1", "s2", "s3", "s4", "s5"]    # curriculum.stages.stage_<name>

# safety-shaped env pricing (JAX main.py:145): an off-road exit costs 200,
# and the reward credits at most 15 km/h
SAFE_ENV = dict(off_road_penalty_divisor=5.0, reward_speed_cap=15.0)


def sharp_recipe() -> dict:
    """The JAX package's opt-in 'sharp' recipe (main.py:55): an entropy
    bonus decaying from 0.02 (halved every 30 updates, floor 1e-4), the Beta
    head's pre-activation floor, and gamma 0.999 / lambda 0.95."""
    return dict(
        entropy_regularization=ExponentialDecay(
            initial_value=0.02, decay_steps=30, decay_rate=0.5, min_value=1e-4),
        gamma=0.999, lambda_=0.95,
        network={"control_policy": {"preact_floor": -3.0}})


def acquire_run_lock(weights_dir: str) -> str:
    """A pid file in `weights_dir` (JAX main.py:25): refuse to start a
    second trainer against the same checkpoints; a lock whose process is
    gone is taken over.  Returns the lock's path, which the caller
    removes."""
    lock_path = os.path.join(weights_dir, ".train.lock")
    refuse_tracked(lock_path)
    os.makedirs(weights_dir, exist_ok=True)
    if os.path.exists(lock_path):
        try:
            with open(lock_path) as f:
                old_pid = int(f.read().strip())
            os.kill(old_pid, 0)
            sys.exit(f"ERROR: {lock_path} is held by the live process {old_pid}; "
                     f"end it or remove the lock file")
        except (ValueError, ProcessLookupError, PermissionError):
            pass
    with open(lock_path, "w") as f:
        f.write(str(os.getpid()))
    return lock_path


def _common(num_envs: int, block: bool, fused_step: bool, fused_units: bool,
            weights_dir: str, device, safe: bool) -> dict:
    """The stage factories' kwargs at the shipped geometry."""
    return dict(episodes=EPISODES, timesteps=TIMESTEPS, batch_size=BATCH,
                num_envs=num_envs, save_every="end", rollout_block=block,
                fused_units=fused_units, weights_dir=weights_dir,
                env_overrides=dict(fused_step=fused_step, device=device,
                                   **(SAFE_ENV if safe else {})))


def make_stage(which: str, num_envs: int = NUM_ENVS, block: bool = False,
               fused_step: bool = False, fused_units: bool = False,
               weights_dir: str = stages.DEFAULT_WEIGHTS_DIR, device=None,
               sharp: bool = False, safe: bool = False,
               aug_intensity=None) -> stages.Stage:
    """Stage `which` at the shipped geometry (JAX main.py make_stage); s5
    on Town03 with dense traffic."""
    if which not in STAGE_ORDER:
        raise ValueError(f"stage {which!r}: one of {', '.join(STAGE_ORDER)}")
    common = _common(num_envs, block, fused_step, fused_units, weights_dir, device, safe)
    if sharp:
        common.update(sharp_recipe())
        # augmenting the minibatches while the rollout's log-probs come from
        # clean frames collapses a sharpened policy (JAX main.py:167-176)
        common.setdefault("aug_intensity", 0.0)
    if aug_intensity is not None:
        common["aug_intensity"] = aug_intensity
    if which == "s5":
        return stages.stage_s5(town="Town03", traffic="dense", **common)
    return getattr(stages, f"stage_{which}")(**common)


def hand_off(src_stage: str, dst_stage: str,
             weights_dir: str = stages.DEFAULT_WEIGHTS_DIR) -> None:
    """Copy `<weights_dir>/stage-<src_stage>` to `stage-<dst_stage>`, which
    the next stage loads (JAX main.py:192); nothing is copied when the
    source does not exist, and the next stage starts fresh.  Refuses a
    destination under the tracked weights/."""
    src = os.path.join(weights_dir, f"stage-{src_stage}")
    dst = os.path.join(weights_dir, f"stage-{dst_stage}")
    refuse_tracked(dst)
    if not os.path.exists(src):
        warnings.warn(f"hand_off: no {src}; stage-{dst_stage} starts from what its "
                      f"directory holds")
        return
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)


def _refuse_fused_step(what: str, fused_step: bool) -> None:
    if fused_step:
        raise NotImplementedError(f"{what} trains NPC worlds, which the physics kernel "
                                  f"(--fused-step) does not compute")


def run_curriculum(epochs, num_envs: int = NUM_ENVS, block: bool = False,
                   weights_dir: str = stages.DEFAULT_WEIGHTS_DIR, log=print,
                   fused_step: bool = False, **stage_kwargs) -> None:
    """Stages s1 -> s5 in order, each handed the previous one's weights
    (JAX main.py:203).  `epochs`: an int for every stage, or the per-stage
    list "e1,e2,e3,e4,e5".  A wrong list and `fused_step` (s2-s5 are NPC
    worlds) raise before any stage trains."""
    if isinstance(epochs, str) and "," in epochs:
        per_stage = [int(e) for e in epochs.split(",")]
        if len(per_stage) != len(STAGE_ORDER):
            raise ValueError(f"--epochs {epochs}: one count per stage of {STAGE_ORDER}")
    else:
        per_stage = [int(epochs)] * len(STAGE_ORDER)
    _refuse_fused_step("the curriculum", fused_step)
    for i, which in enumerate(STAGE_ORDER):
        if i > 0:
            hand_off(STAGE_ORDER[i - 1], which, weights_dir)
        log(f"=== stage-{which} ({per_stage[i]} epochs) ===")
        t0 = time.perf_counter()
        make_stage(which, num_envs, block=block, weights_dir=weights_dir,
                   **stage_kwargs).run2(epochs=per_stage[i], copy_weights=False)
        log(f"=== stage-{which} done in {time.perf_counter() - t0:.1f} s ===")


def run_standard(epochs: int, num_envs: int = NUM_ENVS, block: bool = False,
                 fused_step: bool = False, fused_units: bool = False,
                 weights_dir: str = stages.DEFAULT_WEIGHTS_DIR, device=None,
                 sharp: bool = False, safe: bool = False, aug_intensity=None,
                 callback=None) -> stages.Stage:
    """The no-curriculum control agent (JAX main.py:243-262, reference
    README.md:130's "standard" column): stage s5's setting (Town03, dense
    traffic) trained from scratch (load=False) as stage-standard, or
    stage-standard-sharp with `sharp`, which adds sharp_recipe and, as in
    the JAX package, keeps the augmentation on.  Returns the stage."""
    _refuse_fused_step("--standard", fused_step)
    common = _common(num_envs, block, fused_step, fused_units, weights_dir, device, safe)
    if sharp:
        common.update(sharp_recipe())
    if aug_intensity is not None:
        common["aug_intensity"] = aug_intensity
    stage = stages.stage_s5(town="Town03", traffic="dense", load=False,
                            stage_name="stage-standard-sharp" if sharp else "stage-standard",
                            **common)
    return stage.run2(epochs=epochs, copy_weights=False, callback=callback)


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


def run_record(weights: str = "stage-s5", timesteps: int = 512, trials: int = 3,
               record_dir: str = os.path.join(stages.REPO_ROOT, "record"),
               weights_dir: str = None, device=None) -> list:
    """Record `trials` episodes of the agent of `weights_dir`/`weights`
    (default the tracked weights/, only read) on stage s5's Town03 with
    regular traffic (JAX main.py:265-269; its 4 worlds and batch 1 are the
    stage's, the recording drives one world), the network built with the
    checkpoint's spec (config.json; the JAX package builds the default
    one).  Returns the trials' directories under `record_dir`."""
    weights_dir = weights_dir or os.path.join(stages.REPO_ROOT, "weights")
    stage = stages.stage_s5(episodes=1, timesteps=timesteps, batch_size=1, town="Town03",
                            stage_name=weights, traffic="regular", aug_intensity=0.0,
                            num_envs=4, weights_dir=weights_dir,
                            network=stages.network_spec(weights, weights_dir),
                            env_overrides=dict(device=device))
    stage.init()
    return record_episodes(stage.agent, name="demo", timesteps=timesteps, trials=trials,
                           record_dir=record_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--stage", choices=STAGE_ORDER)
    what.add_argument("--curriculum", action="store_true",
                      help="stages s1 -> s5, each handed the previous one's checkpoint")
    what.add_argument("--standard", action="store_true",
                      help="the no-curriculum control agent: stage s5's setting from scratch")
    what.add_argument("--hand-off", nargs=2, metavar=("SRC", "DST"),
                      help="copy stage-SRC's checkpoint to stage-DST under --weights-dir")
    what.add_argument("--evaluate", action="store_true",
                      help="the 48-scenario evaluation of --weights, seed 42")
    what.add_argument("--record", action="store_true",
                      help="record --trials episodes of --weights on Town03 with regular "
                           "traffic under --record-dir")
    ap.add_argument("--weights", default="stage-s5",
                    help="--evaluate, --record: the checkpoint under weights/")
    ap.add_argument("--steps", type=int, default=512,
                    help="--evaluate, --record: steps per episode")
    ap.add_argument("--trials", type=int, default=None,
                    help="--evaluate: trials per scenario (default 50); --record: "
                         "episodes (default 3)")
    ap.add_argument("--record-dir", default=os.path.join(stages.REPO_ROOT, "record"),
                    help="--record: the root of the records")
    ap.add_argument("--epochs", default="10",
                    help="an int, or with --curriculum the per-stage list 'e1,...,e5'")
    ap.add_argument("--num-envs", type=int, default=NUM_ENVS)
    ap.add_argument("--block", action="store_true",
                    help="block rollout (one forward pass and one frame per 4 steps)")
    ap.add_argument("--fused-step", action="store_true",
                    help="physics on the CUDA kernel (ops/physics.py; worlds without NPCs)")
    ap.add_argument("--fused-units", action="store_true",
                    help="stride-1 ShuffleNet units on the fused unit kernels "
                         "(ops/shuffle_unit.py)")
    ap.add_argument("--safe", action="store_true",
                    help="safety-shaped env pricing (off-road x20, 15 km/h reward cap: SAFE_ENV)")
    ap.add_argument("--sharp", action="store_true",
                    help="sharp recipe: decaying entropy, Beta-head pre-activation floor, "
                         "gamma 0.999 / lambda 0.95 (sharp_recipe)")
    ap.add_argument("--aug-intensity", type=float, default=None,
                    help="the training augmentation's intensity for every stage "
                         "(default: 0 for s1-s3, 1 for s4, s5 and --standard, 0 with --sharp)")
    ap.add_argument("--weights-dir", default=stages.DEFAULT_WEIGHTS_DIR)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' only when asked)")
    args = ap.parse_args(argv)
    if args.record:
        paths = run_record(args.weights, args.steps, args.trials or 3, args.record_dir,
                           device=args.device)
        print("\n".join(f"recorded {p}" for p in paths), flush=True)
        return 0
    if args.evaluate:
        t0 = time.perf_counter()
        run_evaluation(args.weights, args.steps, args.trials or 50, device=args.device)
        print(f"evaluation of {args.weights}: 48 scenarios in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0
    if args.hand_off:
        hand_off(*args.hand_off, weights_dir=args.weights_dir)
        return 0

    def log(step, metrics):
        print(json.dumps(dict(update=step, **{k: round(v, 6) for k, v in metrics.items()})),
              flush=True)

    stage_kwargs = dict(fused_step=args.fused_step, fused_units=args.fused_units,
                        device=args.device, sharp=args.sharp, safe=args.safe,
                        aug_intensity=args.aug_intensity)
    lock = acquire_run_lock(args.weights_dir)
    try:
        t0 = time.perf_counter()
        if args.curriculum:
            run_curriculum(args.epochs, args.num_envs, block=args.block,
                           weights_dir=args.weights_dir,
                           log=lambda m: print(m, flush=True), **stage_kwargs)
            print(f"curriculum in {time.perf_counter() - t0:.1f} s", flush=True)
            return 0
        epochs = int(args.epochs)
        if args.standard:
            stage = run_standard(epochs, args.num_envs, block=args.block,
                                 weights_dir=args.weights_dir, callback=log, **stage_kwargs)
            print(f"{stage.name}: {epochs} epochs in {time.perf_counter() - t0:.1f} s; "
                  f"weights in {stage.agent.base_path}", flush=True)
            return 0
        stage = make_stage(args.stage, args.num_envs, block=args.block,
                           weights_dir=args.weights_dir, **stage_kwargs)
        stage.run2(epochs=epochs, callback=log)
        print(f"stage-{args.stage}: {epochs} epochs in {time.perf_counter() - t0:.1f} s; "
              f"weights in {stage.agent.base_path}", flush=True)
        return 0
    finally:
        os.remove(lock)


if __name__ == "__main__":
    sys.exit(main())
