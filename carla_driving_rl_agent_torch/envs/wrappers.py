"""Environment wrappers: the expert's trace collection, interactive play,
the NoCrash benchmark and the recording of episodes.

Counterpart of carla_driving_rl_agent_tpu/envs/wrappers.py (reference
rl/environments/carla/environment.py):
  * CARLACollectWrapper (:667-825): the privileged expert drives and its
    episodes are written as npz traces (utils/traces.py);
  * CARLAPlayWrapper (:568-664): one world driven by a controller, or by
    the keyboard through pygame;
  * CARLABenchmark (:1309-1451): the CoRL2017/NoCrash success rate, with a
    time budget from each route's length;
  * record_episodes (core/carla_agent.py:147-203): frames and info.json of
    episodes of the agent.

The random draws come from the env's generator, seeded by the caller's
seed and restored afterwards (the JAX package's explicit keys leave no
trace either), and the network's samples from a generator of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from carla_driving_rl_agent_torch.envs import expert as expert_mod
from carla_driving_rl_agent_torch.envs.carla_env import (
    CARLAEnv, convert_action, newest_frame, planes_to_image)
from carla_driving_rl_agent_torch.envs.dynamics import DT, tgather
from carla_driving_rl_agent_torch.utils import traces as trace_io
from carla_driving_rl_agent_torch.utils.checkpoint import refuse_tracked


@contextlib.contextmanager
def seeded(env: CARLAEnv, seed: int):
    """The env's generator seeded with `seed` inside the block, and put
    back as it was afterwards."""
    saved = env.generator.get_state()
    env.seed(seed)
    try:
        yield
    finally:
        env.generator.set_state(saved)


class CARLACollectWrapper:
    """Imitation traces of the privileged expert (reference
    environment.py:710-806): `num_envs` worlds in lock-step, each
    contributing its first episode per round."""

    def __init__(self, env: CARLAEnv, ignore_traffic_light: bool = True,
                 traces_dir: str = "traces", name: str = "collect",
                 behaviour: str = "normal", num_envs: int = 8):
        if behaviour not in expert_mod.BEHAVIORS:
            raise ValueError(f"behaviour must be one of {tuple(expert_mod.BEHAVIORS)}, "
                             f"got {behaviour!r}")
        self.env = env
        self.ignore_traffic_light = ignore_traffic_light
        self.behaviour = behaviour
        self.num_envs = num_envs
        self.traces_dir = os.path.join(traces_dir, name)
        refuse_tracked(self.traces_dir)
        os.makedirs(self.traces_dir, exist_ok=True)

    def collect(self, episodes: int, timesteps: int, episode_reward_threshold: float = 0.0,
                seed: int = 42) -> int:
        """Write at least `episodes` traces (at most max(4, episodes) rounds
        of `timesteps` steps from fresh worlds); an episode is kept when its
        total reward is at least timesteps * episode_reward_threshold
        (reference environment.py:744-752).  Each trace holds the
        observations before each step, the expert's env actions in
        [-1, 1], rewards, dones, speed and similarity, cut after the first
        done.  Returns the number written."""
        env = self.env

        @torch.no_grad()
        def act(states, net_in):
            a = expert_mod.expert_action(states.world, env.params, env.town, env.routes,
                                         behaviour=self.behaviour,
                                         ignore_traffic_light=self.ignore_traffic_light)
            return dict(env_action=a, action=a)

        written, rounds = 0, 0
        with seeded(env, seed):
            while written < episodes and rounds < max(4, episodes):
                states, _ = env.reset_batch(self.num_envs)
                recs = trace_io.record_steps(env, states, act, timesteps)
                rounds += 1
                written = trace_io.save_episodes(
                    recs, self.traces_dir, written, episodes,
                    lambda total: total >= timesteps * episode_reward_threshold)
        return written


def _frame(env: CARLAEnv, state) -> np.ndarray:
    """(H, 3W, C) uint8: world 0's newest frame at the observation's size."""
    return planes_to_image(newest_frame(state.image_stack, state.stack_slot),
                           *env.config.upsample)[0].cpu().numpy()


class CARLAPlayWrapper:
    """Manual control of one world (reference environment.py:568-664):
    `play` drives it with a controller callable, `keyboard` with pygame."""

    def __init__(self, env: CARLAEnv):
        self.env = env

    @torch.no_grad()
    def play(self, controller: Optional[Callable] = None, timesteps: int = 512,
             seed: int = 0, render: Optional[Callable] = None) -> dict:
        """One episode of at most `timesteps` steps: controller(obs, t)
        returns the env action (2,) from the observation (numpy arrays of
        one world); render(frame, info), when given, sees each step's
        frame and info and stops the episode by returning True."""
        env = self.env
        if controller is None:
            controller = lambda obs, t: np.asarray([0.3, 0.0], np.float32)  # noqa: E731
        total, t = 0.0, 0
        with seeded(env, seed):
            state, obs = env.reset_batch(1)
            for t in range(timesteps):
                action = controller({k: v[0].cpu().numpy() for k, v in obs.items()}, t)
                action = torch.as_tensor(np.asarray(action, np.float32), device=env.device)
                state, obs, reward, term, trunc, info = env.step(state, action[None])
                total += float(reward[0])
                if render is not None and render(
                        _frame(env, state), {k: v[0].cpu().numpy() for k, v in info.items()}):
                    break
                if bool(term[0]) or bool(trunc[0]):
                    break
        return dict(total_reward=total, timesteps=t + 1)

    def keyboard(self, timesteps: int = 4096, seed: int = 0, scale: int = 3) -> dict:
        """Keyboard teleop with a pygame window (reference
        CARLAPlayWrapper._parse_events, environment.py:568-664): W/UP
        throttle, S/DOWN brake, A/D steer, SPACE centres the steering,
        ESC or closing the window quits.  Needs pygame; its ImportError
        rises where pygame is missing."""
        import pygame

        pygame.init()
        h, w, _ = self.env.config.image_shape
        screen = pygame.display.set_mode((w * scale, h * scale))
        pygame.display.set_caption("CARLA teleop")
        clock = pygame.time.Clock()
        control = dict(steer=0.0, quit=False)

        def controller(obs, t):
            for event in pygame.event.get():
                if event.type == pygame.QUIT or (
                        event.type == pygame.KEYDOWN and event.key == pygame.K_ESCAPE):
                    control["quit"] = True
            keys = pygame.key.get_pressed()
            thr = (1.0 if keys[pygame.K_w] or keys[pygame.K_UP] else
                   -1.0 if keys[pygame.K_s] or keys[pygame.K_DOWN] else 0.0)
            steer = control["steer"]
            if keys[pygame.K_a] or keys[pygame.K_LEFT]:
                steer = max(steer - 0.08, -1.0)
            elif keys[pygame.K_d] or keys[pygame.K_RIGHT]:
                steer = min(steer + 0.08, 1.0)
            else:
                steer *= 0.7                 # self-centring
            if keys[pygame.K_SPACE]:
                steer = 0.0
            control["steer"] = steer
            return np.asarray([thr, steer], np.float32)

        def render(frame, info):
            rgb = np.repeat(np.repeat(frame[..., :3], scale, 0), scale, 1)
            screen.blit(pygame.surfarray.make_surface(np.transpose(rgb, (1, 0, 2))), (0, 0))
            pygame.display.flip()
            clock.tick(30)
            return control["quit"]

        try:
            return self.play(controller=controller, timesteps=timesteps, seed=seed,
                             render=render)
        finally:
            pygame.quit()


def nocrash_success(steps, collided, arrived, route_length_m, avg_speed_kmh: float = 10.0):
    """The NoCrash success predicate (reference environment.py:1397-1435):
    each episode's budget is route_length / avg_speed * 3.6 seconds
    (:1402), in env steps of DT; success is arrival within the budget
    without a vehicle or pedestrian collision.  Returns (success, in_time,
    budget_steps) as numpy arrays."""
    steps = np.asarray(steps)
    budget_steps = np.asarray(route_length_m) / avg_speed_kmh * 3.6 / DT
    in_time = steps <= budget_steps
    success = np.asarray(arrived) & ~np.asarray(collided) & in_time
    return success, in_time, budget_steps


def route_length_m(world, routes) -> torch.Tensor:
    """(B,) metres of each world's route from its waypoint to the
    destination: the polyline's segments from wp_idx to its last point
    (reference route.distance_to_destination, environment.py:1401)."""
    xy = tgather(routes.xyy, world.town_id, world.route_id)[..., :2]     # (B, L, 2)
    r_len = tgather(routes.length, world.town_id, world.route_id)
    d = xy[:, 1:] - xy[:, :-1]
    seg = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    i = torch.arange(seg.shape[1], device=seg.device)[None]
    keep = (i >= world.wp_idx[:, None]) & (i < (r_len - 1)[:, None])
    return torch.sum(seg * keep, dim=1)


class CARLABenchmark:
    """CoRL2017/NoCrash-style benchmark (reference environment.py:1309-1451):
    success is reaching the destination within a time budget from the
    route's length at `avg_speed` km/h, without colliding, under a task's
    traffic for the preset's town.

    As in the reference: Town01 is the training town and Town02 the test
    town (:1332-1333), the tasks give per-town actor counts (:1352-1362),
    `weather=None` means the TEST weathers for either preset (:1391-1392),
    and only vehicle and pedestrian hits count as collisions (:1404-1408;
    an off-road exit ends the episode without arrival)."""

    TRAIN_TOWN = "Town01"
    TEST_TOWN = "Town02"
    # reference :1334-1343, names of envs/weather
    TRAIN_WEATHERS = ["ClearNoon", "ClearSunset", "SoftRainNoon", "SoftRainSunset"]
    TEST_WEATHERS = ["CloudyNoon", "SoftRainSunset", "WetCloudyNoon", "MidRainyNoon",
                     "CloudySunset", "HardRainSunset"]
    # reference TASKS_SPEC :1352-1362
    TASKS_SPEC = {
        "empty": {TRAIN_TOWN: dict(vehicles=0, pedestrians=0),
                  TEST_TOWN: dict(vehicles=0, pedestrians=0)},
        "regular": {TRAIN_TOWN: dict(vehicles=20, pedestrians=50),
                    TEST_TOWN: dict(vehicles=15, pedestrians=50)},
        "dense": {TRAIN_TOWN: dict(vehicles=100, pedestrians=250),
                  TEST_TOWN: dict(vehicles=70, pedestrians=150)},
    }

    def __init__(self, agent, task: str = "empty", preset: str = "test",
                 weather: Optional[list] = None, avg_speed: float = 10.0,
                 render_mode: Optional[str] = None):
        if task not in self.TASKS_SPEC:
            raise ValueError(f"task must be one of {tuple(self.TASKS_SPEC)}, got {task!r}")
        if preset not in ("test", "train"):
            raise ValueError(f"preset must be 'test' or 'train', got {preset!r}")
        self.agent = agent
        self.task = task
        self.avg_speed = avg_speed
        self.town = self.TEST_TOWN if preset == "test" else self.TRAIN_TOWN
        self.task_spec = self.TASKS_SPEC[task][self.town]
        self.weathers = list(weather) if weather is not None else list(self.TEST_WEATHERS)
        self._render_mode = render_mode
        self.last_env: Optional[CARLAEnv] = None

    def _build_env(self, timesteps: int) -> CARLAEnv:
        """A new env of the benchmark's town, weathers and traffic (JAX
        wrappers.py:273-282), with the agent's stacking."""
        from carla_driving_rl_agent_torch.curriculum.stages import build_env
        cfg = self.agent.env.config
        return build_env(town=self.town, random_weathers=self.weathers,
                         spawn=dict(self.task_spec), max_timesteps=timesteps,
                         render_mode=self._render_mode or "pallas",
                         time_horizon=cfg.time_horizon, past_obs_freq=cfg.past_obs_freq,
                         stack_depth=cfg.stack_depth, device=self.agent.env.device)

    @torch.no_grad()
    def run(self, timesteps: int = 1024, trials: int = 25, initial_seed: int = 42) -> dict:
        """The success rate over `trials` worlds of a new benchmark env: each
        world's route length from its spawn waypoint, then the agent's
        policy for `timesteps` steps, each world scored on its FIRST
        episode: arrival (distance to the destination <= 2 m, :1413-1415)
        within the step budget without a vehicle or pedestrian collision.
        The worlds come from the env's generator seeded with
        `initial_seed`, the actions from a generator of that seed."""
        agent = self.agent
        env = self.last_env = self._build_env(timesteps)
        net = agent.network
        gen = torch.Generator(device=env.device).manual_seed(initial_seed)
        env.seed(initial_seed)
        states, obs = env.reset_batch(trials)
        route_m = route_length_m(states.world, env.routes)
        zeros = torch.zeros(trials, device=env.device)
        steps, collided, arrived = zeros, zeros.bool(), zeros.bool()
        for _ in range(timesteps):
            net_in = {f"state_{k}": v for k, v in obs.items()}
            net_in["action"] = states.last_action
            pred = net.predict(net_in, gen)
            alive = states.world.episode == 0          # the world's first episode
            states, obs, reward, term, trunc, info = env.step(
                states, convert_action(pred["action"]))
            done = (term | trunc) & alive
            steps = steps + alive.to(torch.float32)
            collided = collided | ((info["hit_vehicle"] | info["hit_pedestrian"]) & alive)
            arrived = arrived | (done & (info["distance_to_destination"] <= 2.0))
        steps, collided, arrived, route_m = (t.cpu().numpy() for t in
                                             (steps, collided, arrived, route_m))
        success, in_time, budget_steps = nocrash_success(steps, collided, arrived, route_m,
                                                         self.avg_speed)
        return dict(
            success_rate=float(np.mean(success)),
            success_rate_pct=float(np.mean(success)) * 100.0,
            collision_rate=float(np.mean(collided)),
            timeout_rate=float(np.mean(~in_time)),
            avg_timesteps=float(np.mean(steps)),
            avg_route_length_m=float(np.mean(route_m)),
            avg_budget_steps=float(np.mean(budget_steps)),
            town=self.town, task=self.task, trials=trials,
            route_length_m=route_m.tolist(), budget_steps=budget_steps.tolist())


@torch.no_grad()
def record_episodes(agent, name: str, timesteps: int, trials: int,
                    seed: Optional[int] = None, record_dir: str = "record") -> list:
    """Drive `trials` episodes of one world with the agent's policy and save
    each one's frames (frames.npz, (t, H, 3W, C) uint8) and info.json
    (total reward, timesteps) under record_dir/<town>/<name>/<trial>
    (reference CARLAgent.record, core/carla_agent.py:147-203; npz frames in
    place of pygame jpegs).  An episode stops at its end only after its
    32nd step (:193).  The worlds come from the env's generator seeded with
    `seed` (default 0) and restored afterwards, the actions from a
    generator of that seed.  Returns the trials' directories."""
    env = agent.env
    refuse_tracked(record_dir)
    seed = 0 if seed is None else seed
    gen = torch.Generator(device=env.device).manual_seed(seed)
    paths = []
    with seeded(env, seed):
        for trial in range(1, trials + 1):
            state, obs = env.reset_batch(1)
            frames, total, t = [], 0.0, 0
            for t in range(1, timesteps + 1):
                net_in = {f"state_{k}": v for k, v in obs.items()}
                net_in["action"] = state.last_action
                pred = agent.network.predict(net_in, gen)
                state, obs, reward, term, trunc, _ = env.step(state,
                                                              convert_action(pred["action"]))
                frames.append(_frame(env, state))
                total += float(reward[0])
                if (bool(term[0]) or bool(trunc[0])) and t > 32:
                    break
            town = env.params.town_names[int(state.world.town_id[0])]
            path = os.path.join(record_dir, town, name, str(trial))
            os.makedirs(path, exist_ok=True)
            np.savez_compressed(os.path.join(path, "frames.npz"), frames=np.stack(frames))
            with open(os.path.join(path, "info.json"), "w") as f:
                json.dump(dict(reward=total, timestep=t), f, indent=3)
            paths.append(path)
    return paths
