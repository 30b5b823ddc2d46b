"""The five curriculum stages, the Stage orchestrator, and the evaluation
protocol for one town at a time.

Counterpart of carla_driving_rl_agent_tpu/curriculum/stages.py (reference
core/learning.py): `sample_origins` (:19-33), `define_agent`/`define_env`
(:53-61), `Stage` (:68-189), `stage_s1` (:311-339), `stage_s2` (:342-369),
`stage_s3` (:372-409), `stage_s4` (:412-450), `stage_s5` (:453-498) and
`evaluate` (:505-530) with its traffic levels (`TRAFFIC_SPECS`, :485-487).
The imitation helpers are in curriculum/imitation.py.

Parallelism mapping (as in the JAX package): an epoch runs `episodes`
updates, each consuming a `timesteps`-step rollout (at most 128 steps)
from `num_envs` lock-step worlds.

The JAX package's evaluation builds all eight evaluation towns into one bank
so that XLA compiles one program; PyTorch compiles nothing ahead, so this
module builds only the town it is asked for.

Checkpoints and evaluation records go under weights-torch/ of the checkout
by default; the evaluation reads the weights from the tracked weights/ by
default, and the port never writes there (utils/checkpoint.refuse_tracked).
"""

from __future__ import annotations

import json
import os
import random as py_random
import warnings
from typing import List, Optional, Union

from carla_driving_rl_agent_torch import REPO_ROOT
from carla_driving_rl_agent_torch.agents.carla_agent import (
    DEFAULT_WEIGHTS_DIR, CARLAgent, CARLAgentConfig)
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.envs.town import get_town
from carla_driving_rl_agent_torch.envs.weather import (
    TEST_WEATHERS, TRAIN_WEATHERS, weather_ids)
from carla_driving_rl_agent_torch.envs.world import WorldParams
from carla_driving_rl_agent_torch.utils.checkpoint import copy_folder

DEFAULT_TOWN = "Town03"   # the reference trains on Town03 only (README.md:112)
# the evaluation's traffic levels (reference core/learning.py:485-487)
TRAFFIC_SPECS = dict(no=None,
                     regular=dict(vehicles=50, pedestrians=50),
                     dense=dict(vehicles=100, pedestrians=200))
EVAL_TOWNS = ("Town01", "Town02", "Town03", "Town04", "Town05", "Town06",
              "Town07", "Town10")


def sample_origins(town: str = DEFAULT_TOWN, amount: int = 1, seed=None) -> List[int]:
    """Seed-fixed spawn-point indices (reference core/learning.py:19-33)."""
    if amount <= 0:
        raise ValueError(f"amount must be positive, got {amount}")
    rng = py_random.Random(seed)
    points = list(range(len(get_town(town).spawn_wp)))
    rng.shuffle(points)
    return points[:amount]


def define_agent(batch_size: int = 128, num_envs: int = 32, rollout_steps: int = 128,
                 **kwargs) -> dict:
    """Agent kwargs defaults (reference core/learning.py:53-55)."""
    return dict(batch_size=batch_size, num_envs=num_envs,
                rollout_steps=rollout_steps, **kwargs)


def define_env(image_shape=(90, 120, 3), town: Union[None, str] = DEFAULT_TOWN,
               **kwargs) -> dict:
    """Env kwargs defaults (reference core/learning.py:58-61)."""
    return dict(town=town or DEFAULT_TOWN, image_shape=image_shape, **kwargs)


def build_env(town: str = DEFAULT_TOWN, image_shape=(90, 120, 3),
              random_weathers: Optional[List[str]] = None,
              random_towns: Optional[List[str]] = None,
              spawn: Optional[dict] = None,
              origins: Optional[List[int]] = None,
              throttle_as_desired_speed: bool = True,
              disable_reverse: bool = True,
              time_horizon: int = 4, past_obs_freq: int = 4,
              max_timesteps: int = 512, num_routes: int = 128,
              render_mode: str = "pallas", stack_depth: bool = False,
              off_road_penalty_divisor: float = 100.0,
              reward_speed_cap: float = 150.0,
              speed_over_cap_penalty: float = 0.0,
              lateral_obs: bool = False,
              fused_step: bool = False,
              seed: int = 42, device=None, **_ignored) -> CARLAEnv:
    """A CARLAEnv from stage-style kwargs.  `render_mode` "pallas" (the
    JAX package's kernel renderer) is the port's CUDA renderer, the only one
    it has; `fused_step` turns on the physics kernel (bench.py's
    CDRL_FUSED_STEP; the JAX build_env ignores the keyword)."""
    if render_mode != "pallas":
        raise NotImplementedError(f"render_mode={render_mode!r}: the port renders "
                                  f"with its CUDA kernel only")
    if lateral_obs:
        raise NotImplementedError("lateral_obs is not ported yet")
    spawn = spawn or {}
    nv = int(spawn.get("vehicles", 0) or 0)
    np_ = int(spawn.get("pedestrians", 0) or 0)
    towns = tuple(random_towns) if random_towns else (town,)
    params = WorldParams(
        town_names=towns, random_towns=bool(random_towns),
        num_vehicles=nv, num_pedestrians=np_, v_max=max(nv, 1), p_max=max(np_, 1),
        weather_ids=tuple(int(i) for i in weather_ids(random_weathers or ["ClearNoon"])),
        throttle_as_desired_speed=throttle_as_desired_speed,
        disable_reverse=disable_reverse,
        max_timesteps=max_timesteps, num_routes=num_routes,
        origin_spawns=tuple(origins) if origins else None,
        off_road_penalty_divisor=off_road_penalty_divisor,
        reward_speed_cap=reward_speed_cap,
        speed_over_cap_penalty=speed_over_cap_penalty,
        seed=seed)
    return CARLAEnv(CARLAEnvConfig(
        world=params, image_height=image_shape[0], image_width=image_shape[1],
        stack_depth=stack_depth, time_horizon=time_horizon,
        past_obs_freq=past_obs_freq, fused_step=fused_step), device=device)


class Stage:
    """A curriculum learning stage (reference core/learning.py:68-189): RL
    epochs with a checkpoint and a per-epoch snapshot after each (`run2`),
    or the expert's collection then RL per epoch (`run`); with `imitation`
    kwargs, `run2` imitates before each epoch's RL."""

    def __init__(self, agent: dict, environment: dict, learning: dict,
                 representation: Optional[dict] = None, collect: Optional[dict] = None,
                 imitation: Optional[dict] = None, name: str = "Stage"):
        if not isinstance(learning.get("agent"), dict):
            raise ValueError("learning must hold an 'agent' dict")
        self.agent_args = dict(agent)
        self.env_args = dict(environment)
        self.learn_args = dict(learning)
        self.repr_args = representation
        self.collect_args = collect
        self.imitation_args = imitation
        self.should_imitate = isinstance(imitation, dict)
        self.should_collect = isinstance(collect, dict)
        self.name = name
        self.agent: Optional[CARLAgent] = None
        self.env: Optional[CARLAEnv] = None
        self._env_states = None

    def init(self) -> None:
        if self.env is not None:
            return
        self.env = build_env(**self.env_args)
        args = dict(self.agent_args)
        name = args.pop("name", self.name)
        weights_dir = args.pop("weights_dir", DEFAULT_WEIGHTS_DIR)
        load = args.pop("load", False)
        load_full = args.pop("load_full", True)
        cfg = CARLAgentConfig(**{k: v for k, v in args.items()
                                 if k in CARLAgentConfig.__dataclass_fields__})
        self.agent = CARLAgent(self.env, cfg, name=name, weights_dir=weights_dir)
        if load and any(os.path.exists(os.path.join(self.agent.base_path, f))
                        for f in ("network.pt", "params.msgpack")):
            self.agent.load(full=load_full)

    def run2(self, epochs: int, copy_weights: bool = True,
             epoch_offset: int = 0, callback=None) -> "Stage":
        """(imitation ->) RL per epoch + per-epoch weight snapshot
        (reference core/learning.py:144-161)."""
        if epochs <= 0:
            raise ValueError(f"epochs must be positive, got {epochs}")
        self.init()
        learn = self.learn_args["agent"]
        updates = int(learn.get("episodes", 5))
        for epoch in range(epochs):
            if self.should_imitate:
                self.imitation_learning()
            self._env_states, _ = self.agent.learn(
                num_updates=updates, env_states=self._env_states, callback=callback)
            if learn.get("save_every") or copy_weights:
                self.agent.save()
            if copy_weights:
                copy_folder(self.agent.base_path,
                            f"{self.agent.base_path}-{epoch + epoch_offset}")
        return self

    def run(self, epochs: int, collect: Union[bool, int] = True,
            representation: bool = True) -> "Stage":
        """The expert's collection, then RL, per epoch (reference
        core/learning.py:119-142): with `collect` kwargs given to the stage,
        collect=True collects in every epoch (its count is epochs + 1, as
        in the reference), an int in that many first epochs, False never.
        Representation learning is a hook the reference declares but never
        implemented (representation_learning raises)."""
        if epochs <= 0:
            raise ValueError(f"epochs must be positive, got {epochs}")
        self.init()
        if (collect is False) or (not self.should_collect):
            collect_left = 0
        elif collect is True:
            collect_left = epochs + 1
        else:
            collect_left = int(collect)
        for _ in range(epochs):
            if collect_left > 0:
                self.collect()
                collect_left -= 1
            if self.repr_args and representation:
                self.representation_learning()
            self.reinforcement_learning()
        return self

    def representation_learning(self):
        raise NotImplementedError(
            "representation learning is a hook in the reference as well "
            "(Stage.run calls agent.learn_representation, which CARLAgent "
            "never defines); use imitation_learning instead")

    def evaluate(self, **kwargs) -> "Stage":
        self.init()
        self.agent.evaluate(**kwargs)
        return self

    def record(self, **kwargs) -> "Stage":
        """envs/wrappers.record_episodes of the stage's agent."""
        from carla_driving_rl_agent_torch.envs.wrappers import record_episodes
        self.init()
        record_episodes(self.agent, **kwargs)
        return self

    def collect(self, **kwargs) -> int:
        """The expert's traces (envs/wrappers.CARLACollectWrapper with the
        stage's `collect` kwargs); the collection's own kwargs are
        learning["collect"], else `kwargs`.  Returns the number written."""
        from carla_driving_rl_agent_torch.envs.wrappers import CARLACollectWrapper
        self.init()
        wrapper = CARLACollectWrapper(self.env, **(self.collect_args or {}))
        return wrapper.collect(**self.learn_args.get("collect", kwargs))

    def imitation_learning(self):
        self.init()
        return self.agent.imitation_learning(**(self.imitation_args or {}))

    def reinforcement_learning(self):
        self.init()
        learn = self.learn_args["agent"]
        self._env_states, _ = self.agent.learn(num_updates=int(learn.get("episodes", 5)),
                                               env_states=self._env_states)

    def cleanup(self, close: bool = True):
        if close:
            self.env = None
            self.agent = None
            self._env_states = None


def _stage_common(kwargs: dict) -> dict:
    return dict(
        policy_lr=kwargs.pop("policy_lr", 3e-4),
        value_lr=kwargs.pop("value_lr", 3e-4),
        dynamics_lr=kwargs.pop("dynamics_lr", 3e-4),
        clip_ratio=kwargs.pop("clip_ratio", 0.2),
        entropy_regularization=kwargs.pop("entropy_regularization", 0.1),
        advantage_scale=2.0, clip_norm=(1.0, 1.0, 1.0), update_dynamics=True)


def _stage(stage_name: str, episodes: int, timesteps: int, batch_size: int, save_every,
           seed: int, num_envs: int, env_overrides: Optional[dict], kwargs: dict,
           agent_extra: dict, **env_kwargs) -> Stage:
    """A stage factory's common part: `_stage_common`'s hyper-parameters,
    the agent kwargs (`kwargs` and `agent_extra`) and the env kwargs
    (`env_kwargs`, then `env_overrides`)."""
    hp = _stage_common(kwargs)
    agent = define_agent(batch_size=batch_size, num_envs=num_envs,
                         rollout_steps=kwargs.pop("rollout_steps", min(timesteps, 128)),
                         name=stage_name, seed=seed, **agent_extra,
                         aug_intensity=kwargs.pop("aug_intensity", 0.0), **hp, **kwargs)
    env = define_env(throttle_as_desired_speed=True, disable_reverse=True,
                     max_timesteps=timesteps, seed=seed, **env_kwargs,
                     **(env_overrides or {}))
    return Stage(agent=agent, environment=env, name=stage_name,
                 learning=dict(agent=dict(episodes=episodes, timesteps=timesteps,
                                          save_every=save_every)))


def stage_s1(episodes: int, timesteps: int, batch_size: int, save_every=None,
             seed: int = 42, stage_name: str = "stage-s1", num_envs: int = 32,
             town: str = DEFAULT_TOWN, env_overrides: Optional[dict] = None,
             **kwargs) -> Stage:
    """Stage-1: 10 seed-fixed origins, no dynamic objects
    (reference core/learning.py:311-339).  `env_overrides` are extra
    define_env kwargs (e.g. fused_step, device); the other kwargs reach the
    agent's config (e.g. fused_units=True, the JAX FAST_TRAIN knob)."""
    return _stage(stage_name, episodes, timesteps, batch_size, save_every, seed, num_envs,
                  env_overrides, kwargs, {}, town=town,
                  origins=sample_origins(town, amount=10, seed=seed))


def stage_s2(episodes: int, timesteps: int, batch_size: int, save_every=None,
             seed: int = 42, stage_name: str = "stage-s2", num_envs: int = 32,
             town: str = DEFAULT_TOWN, env_overrides: Optional[dict] = None,
             **kwargs) -> Stage:
    """Stage-2: 50 seed-fixed origins and 50 pedestrians, the weights of the
    stage's directory loaded in full when it holds any (reference
    core/learning.py:342-369; main.hand_off copies stage s1's there)."""
    return _stage(stage_name, episodes, timesteps, batch_size, save_every, seed, num_envs,
                  env_overrides, kwargs, dict(load=True, load_full=True), town=town,
                  origins=sample_origins(town, amount=50, seed=seed),
                  spawn=dict(vehicles=0, pedestrians=50))


def stage_s3(episodes: int, timesteps: int, batch_size: int, save_every=None,
             seed: int = 42, stage_name: str = "stage-s3", num_envs: int = 32,
             town: str = DEFAULT_TOWN, env_overrides: Optional[dict] = None,
             **kwargs) -> Stage:
    """Stage-3: 50 vehicles, 50 pedestrians and the seven training
    weathers drawn per episode, no fixed origins, the stage's weights
    loaded as in stage_s2 (reference core/learning.py:372-409)."""
    return _stage(stage_name, episodes, timesteps, batch_size, save_every, seed, num_envs,
                  env_overrides, kwargs, dict(load=True, load_full=True), town=town,
                  random_weathers=list(TRAIN_WEATHERS),
                  spawn=dict(vehicles=50, pedestrians=50))


def stage_s4(episodes: int, timesteps: int, batch_size: int, towns=None,
             save_every=None, seed: int = 42, stage_name: str = "stage-s4",
             num_envs: int = 32, town: str = DEFAULT_TOWN,
             env_overrides: Optional[dict] = None, **kwargs) -> Stage:
    """Stage-4: stage s3's traffic and weathers, the towns `towns` drawn per
    episode when given (else `town`), and the training augmentation at
    aug_intensity 1.0 by default (reference core/learning.py:412-450)."""
    kwargs.setdefault("aug_intensity", 1.0)
    return _stage(stage_name, episodes, timesteps, batch_size, save_every, seed, num_envs,
                  env_overrides, kwargs, dict(load=True, load_full=True), town=town,
                  random_towns=towns, random_weathers=list(TRAIN_WEATHERS),
                  spawn=dict(vehicles=50, pedestrians=50))


def stage_s5(episodes: int, timesteps: int, batch_size: int, town: str,
             save_every=None, seed: int = 42, stage_name: str = "stage-s5",
             weather=None, traffic: str = "dense", num_envs: int = 32,
             env_overrides: Optional[dict] = None, **kwargs) -> Stage:
    """Stage-5: the named town with the `traffic` level of TRAFFIC_SPECS,
    the weathers `weather` (default the training weathers), the
    augmentation at 1.0 by default, and the stage's weights loaded unless
    load=False (reference core/learning.py:453-498)."""
    if traffic not in TRAFFIC_SPECS:
        raise ValueError(f"traffic must be one of {tuple(TRAFFIC_SPECS)}, got {traffic!r}")
    kwargs.setdefault("aug_intensity", 1.0)
    return _stage(stage_name, episodes, timesteps, batch_size, save_every, seed, num_envs,
                  env_overrides, kwargs, dict(load=kwargs.pop("load", True), load_full=True),
                  town=town, random_weathers=weather or list(TRAIN_WEATHERS),
                  spawn=TRAFFIC_SPECS[traffic])


def network_spec(weights: str, weights_dir: str) -> dict:
    """The network spec a checkpoint was trained with, from its config.json
    (e.g. safe-s5's control_policy.preact_floor = -3)."""
    path = os.path.join(weights_dir, weights, "config.json")
    if not os.path.exists(path):
        warnings.warn(f"no config.json under {weights_dir}/{weights}; "
                      f"evaluating with the default network spec")
        return {}
    with open(path) as f:
        return json.load(f).get("network", {}) or {}


def build_eval_agent(mode: str, town: str, steps: int, weights: str,
                     weights_dir: Optional[str] = None, device=None,
                     fused_units: bool = False, traffic: str = "no") -> CARLAgent:
    """A one-town evaluation env with the `traffic` level of TRAFFIC_SPECS
    and the agent loaded with `weights`, as the JAX package's _eval_stage
    configures them: the seven training weathers in train mode, the seven
    held-out ones in test mode.  `fused_units` runs the backbone's stride-1
    units as fused ops.  The weights are read from `weights_dir`/`weights`
    (default weights/); the agent's records go to weights-torch/`weights`."""
    if mode not in ("train", "test"):
        raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
    if traffic not in TRAFFIC_SPECS:
        raise ValueError(f"traffic must be one of {tuple(TRAFFIC_SPECS)}, got {traffic!r}")
    weights_dir = weights_dir or os.path.join(REPO_ROOT, "weights")
    weather = TRAIN_WEATHERS if mode == "train" else TEST_WEATHERS
    env = build_env(town=town, random_weathers=list(weather), spawn=TRAFFIC_SPECS[traffic],
                    throttle_as_desired_speed=True, disable_reverse=True,
                    max_timesteps=steps, seed=42, device=device)
    agent = CARLAgent(env, CARLAgentConfig(network=network_spec(weights, weights_dir),
                                           fused_units=fused_units), name=weights)
    agent.load(os.path.join(weights_dir, weights))
    return agent


def evaluate(mode: str, town: str, seeds: list, traffic: str, steps: int = 512,
             trials: int = 50, weights: str = "stage-s5",
             weights_dir: Optional[str] = None,
             evaluation_dir: Optional[str] = None, device=None) -> List[dict]:
    """Evaluate `weights` on one scenario (a town, a traffic level of
    TRAFFIC_SPECS) for each seed, writing one JSON per seed named
    `{weights}-{mode}-{steps}-{trials}-{town}-{traffic}-{seed}` (into
    `evaluation_dir`, default weights-torch/<weights>/evaluation; the
    weights are read from `weights_dir`, default weights/).  Returns the
    records.  Equivalent to build_eval_agent() then CARLAgent.evaluate()
    per seed."""
    agent = build_eval_agent(mode, town, steps, weights, weights_dir, device, traffic=traffic)
    return [agent.evaluate(
        name=f"{weights}-{mode}-{steps}-{trials}-{town}-{traffic}-{seed}",
        timesteps=steps, trials=trials, initial_seed=seed,
        evaluation_dir=evaluation_dir) for seed in seeds]
