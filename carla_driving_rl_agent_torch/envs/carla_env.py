"""CARLAEnv: the batched driving environment.

Counterpart of carla_driving_rl_agent_tpu/envs/carla_env.py: the world
core, a renderer and the time-horizon frame stacks, with auto-reset, over
a batch of worlds on one device.  `render_mode` picks the renderer: "pallas"
(the port's default, and every stage's) is the CUDA kernel of
ops/render.py, the JAX package's Pallas kernel; "rasterizer" is the
analytic renderer of ops/rasterizer.py in plain PyTorch (the JAX env's
default), which also draws the one-camera variant (`cameras=1`, with
depth as a 4th channel or as a modulation of the colour); "zeros" renders
nothing (vector-only configurations).  Two paths step it: the per-step
`step` (evaluation) and the block path of training rollouts
(`step_physics_block` for a block of past_obs_freq ticks,
`push_block_frame_batch` once per block), whose physics runs the CUDA
kernel of ops/physics.py, once per block, when `fused_step` is on.  Worlds
with NPC traffic take the plain block (the kernel computes worlds without
NPCs), their NPC tick draws and spawns drawn for the whole block at once;
the render kernel draws the nearest of their NPCs as billboards.

Observation contract (reference core/carla_env.py:128-131): dict(image
(B, T, 90, 360, C) in [0, 1], road (B, T, 9), vehicle (B, T, 4), navigation
(B, T, N)) where T = time_horizon = 4 frames pushed every past_obs_freq = 4
steps (core/carla_env.py:76-81,290-325); action Box(-1, 1, (2,)).

Frames are stored as uint8 planes, (C, 45, 180) per frame at the render
kernel's half resolution, or at the full resolution with the other
renderers; `observe` upsamples and interleaves the channels.  The
one-camera observation also holds `past_control` and `command`.
`CARLAEnvDiscrete` quantises the actions into bins.
"""

from __future__ import annotations

import contextlib

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from carla_driving_rl_agent_torch import resolve_device
from carla_driving_rl_agent_torch.envs import spaces, traffic, world as world_mod
from carla_driving_rl_agent_torch.envs.weather import WEATHER_PARAMS
from carla_driving_rl_agent_torch.envs.world import ResetDraws, WorldParams, WorldState
from carla_driving_rl_agent_torch.ops import physics as physics_ops
from carla_driving_rl_agent_torch.ops import rasterizer
from carla_driving_rl_agent_torch.ops import render as render_ops
from carla_driving_rl_agent_torch.utils.profiling import span

RENDER_MODES = ("pallas", "rasterizer", "zeros")


def planes_to_image(planar: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """(..., C, SH, SW) uint8 planar storage -> (..., SH*ry, SW*rx, C) image
    (nearest upsample + channel-last interleave), any leading dims."""
    x = torch.movedim(planar, -3, -1)                     # (..., SH, SW, C)
    if ry > 1:
        x = torch.repeat_interleave(x, ry, dim=-3)
    if rx > 1:
        x = torch.repeat_interleave(x, rx, dim=-2)
    return x


def ordered_image_stack(stack: torch.Tensor, stack_ids: torch.Tensor,
                        stack_slot: torch.Tensor) -> torch.Tensor:
    """Oldest->newest view of a circular image stack (..., T, C, SH, SW),
    zero-masking slots whose id is the zero-frame sentinel (< -T)."""
    T = stack.shape[-4]
    order = (stack_slot[..., None] + 1
             + torch.arange(T, device=stack.device)) % T           # (..., T)
    idx = order.reshape(order.shape + (1, 1, 1)).expand(stack.shape)
    ordered = torch.gather(stack, stack.dim() - 4, idx)
    valid = (stack_ids >= -T).to(stack.dtype)
    return ordered * valid[..., None, None, None]


def newest_frame(stack: torch.Tensor, stack_slot: torch.Tensor) -> torch.Tensor:
    """(B, T, C, SH, SW) circular stack -> (B, C, SH, SW) newest frame
    (always a valid frame; no masking needed)."""
    idx = stack_slot.reshape(-1, 1, 1, 1, 1).expand(
        (stack.shape[0], 1) + tuple(stack.shape[2:]))
    return torch.gather(stack, 1, idx)[:, 0]


class EnvState(NamedTuple):
    world: WorldState
    image_stack: torch.Tensor   # (B, T, C, SH, SW) uint8 planar, circular
    road_stack: torch.Tensor    # (B, T, 9) ordered oldest..newest
    vehicle_stack: torch.Tensor  # (B, T, 4)
    nav_stack: torch.Tensor     # (B, T, N)
    stack_ids: torch.Tensor     # (B, T) int64 rollout-local frame ids
    stack_slot: torch.Tensor    # (B,) int64 physical slot of the newest frame
    last_action: torch.Tensor   # (B, num_actions) most recent raw action in [0, 1]


@dataclass(frozen=True)
class CARLAEnvConfig:
    world: WorldParams = field(default_factory=WorldParams)
    image_height: int = 90
    image_width: int = 120          # per camera; the full image is `cameras`x this
    stack_depth: bool = False       # +1 log-depth channel (core/carla_env.py:49-54,271-288)
    # the one-camera image times (1 - depth / 255), the reference's fusion
    # of an attached depth sensor (environment.py:1038-1049); exclusive
    # with stack_depth
    depth_modulate: bool = False
    # 'pallas': the CUDA render kernel (ops/render.py); 'rasterizer': the
    # analytic renderer (ops/rasterizer.py); 'zeros': no image
    render_mode: str = "pallas"
    render_quality: str = "fast"    # the rasterizer's 'full' | 'fast'
    cameras: int = 3                # 3: the ThreeCamera concat; 1: the front camera
    time_horizon: int = 4
    past_obs_freq: int = 4
    num_actions: int = 2
    # the physics tick of the block path through the CUDA kernel
    # (ops/physics.py), which computes worlds without NPCs: CARLAEnv
    # refuses it for a world with NPCs (the JAX package quietly takes its
    # XLA step there; the port has no such fallback)
    fused_step: bool = False

    def __post_init__(self):
        if self.render_mode not in RENDER_MODES:
            raise ValueError(f"render_mode must be one of {RENDER_MODES}, "
                             f"got {self.render_mode!r}")
        if self.render_quality not in rasterizer.QUALITY:
            raise ValueError(f"render_quality must be one of {tuple(rasterizer.QUALITY)}, "
                             f"got {self.render_quality!r}")
        if self.cameras not in (1, 3):
            raise ValueError(f"cameras must be 1 or 3, got {self.cameras}")
        if self.render_mode == "pallas" and self.cameras != 3:
            raise ValueError("the render kernel (render_mode='pallas') renders the "
                             "three-camera rig; cameras=1 needs render_mode='rasterizer'")
        if self.depth_modulate and self.stack_depth:
            raise ValueError("stack_depth and depth_modulate are exclusive")
        if self.depth_modulate and self.cameras != 1:
            raise ValueError("depth_modulate modulates the one-camera image (cameras=1)")

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_height, self.image_width * self.cameras,
                3 + (1 if self.stack_depth else 0))

    @property
    def storage_shape(self) -> Tuple[int, int, int]:
        """(C, SH, SW) planar uint8 frame storage: the render kernel's
        native half-res views side by side, (C, 45, 180); the other
        renderers upsample themselves and store full-resolution planes."""
        h, w, c = self.image_shape
        if self.render_mode != "pallas":
            return (c, h, w)
        if h % render_ops.VIEW_H or w % (3 * render_ops.VIEW_W):
            raise ValueError(f"image {h}x{w} is not a multiple of the "
                             f"renderer's {render_ops.VIEW_H}x"
                             f"{3 * render_ops.VIEW_W} storage")
        return (c, render_ops.VIEW_H, 3 * render_ops.VIEW_W)

    @property
    def upsample(self) -> Tuple[int, int]:
        h, w, _ = self.image_shape
        _, sh, sw = self.storage_shape
        return (h // sh, w // sw)


class CARLAEnv:
    """Batched environment on one device.  Holds the static configuration,
    the device-resident town and route banks, and the torch.Generator of
    its reset draws."""

    def __init__(self, config: CARLAEnvConfig, device=None, seed: int = 0):
        if config.fused_step:
            physics_ops.refuse_unsupported(config.world, "fused_step: the physics kernel")
        self.config = config
        self.params = config.world
        self.n_actors = self._static_n_actors()
        self.device = resolve_device(device)
        self.town, self.routes = world_mod.build_world_data(config.world, self.device)
        self.weather_params = torch.as_tensor(WEATHER_PARAMS, device=self.device)
        self.weather_table = torch.as_tensor(self.params.weather_ids, dtype=torch.int64,
                                             device=self.device)
        self._physics_consts = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.shard = None       # (mesh, worlds in all) in a sharded run

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

    @contextlib.contextmanager
    def sharded(self, mesh, total: int):
        """Within the block, this process steps its rows of `total` worlds
        laid out over `mesh` (parallel/mesh.WorldMesh), and every draw of
        the env's generator is drawn for all `total` worlds and cut to this
        rank's rows, so that each world draws as it would in one process.
        A None mesh leaves the env unsharded."""
        prev, self.shard = self.shard, (None if mesh is None else (mesh, total))
        try:
            yield
        finally:
            self.shard = prev

    def _rows(self, n: int, draw, dim: int = 0):
        """draw(m) for m = n worlds, or in a sharded run for all worlds,
        each tensor cut to this rank's rows along `dim`."""
        if self.shard is None:
            return draw(n)
        mesh, total = self.shard
        lo, hi = mesh.shard(total)
        if n != hi - lo:
            raise ValueError(f"{n} worlds drawn where this rank holds {hi - lo} of {total}")
        return world_mod.map_tensors(lambda t: t.narrow(dim, lo, hi - lo).contiguous(),
                                     draw(total))

    # ---- spaces (reference core/carla_env.py:18-24,128-131), of one world ----
    @property
    def action_space(self) -> spaces.Box:
        return spaces.Box(low=-1.0, high=1.0, shape=(self.config.num_actions,))

    @property
    def observation_space(self) -> spaces.Dict:
        n = world_mod.nav_feature_dim(self.params)
        nav_low = -3.0 if self.params.lateral_obs else 0.0
        extra = {}
        if self.config.cameras == 1:
            # the OneCamera env's keys (reference environment.py:840-859)
            extra = dict(past_control=spaces.Box(low=-1.0, high=1.0, shape=(4,)),
                         command=spaces.Box(low=0.0, high=1.0, shape=(7,)))
        return spaces.Dict(
            road=spaces.Box(low=0.0, high=1.0, shape=(9,)),
            vehicle=spaces.Box(low=0.0, high=1.0, shape=(4,)),
            image=spaces.Box(low=0.0, high=1.0, shape=self.config.image_shape),
            navigation=spaces.Box(low=nav_low, high=25.0, shape=(n,)),
            **extra)

    @property
    def time_horizon(self) -> int:
        return self.config.time_horizon

    # ---- frames ----
    def _static_n_actors(self) -> int:
        """The actor rows of the render pack that this configuration can
        fill: its nearest min(4, v_max) vehicles, then its nearest
        min(4, p_max) walkers; none without NPCs, so that the kernel skips
        its actor loop."""
        if not self.params.has_npcs:
            return 0
        half = render_ops.K_ACTORS // 2
        return min(half, self.params.v_max) + min(half, self.params.p_max)

    def render_frame(self, world: WorldState) -> torch.Tensor:
        """(B,) + storage_shape uint8 planar frames of every world."""
        with span("render"):
            cfg = self.config
            if cfg.render_mode == "zeros":
                return torch.zeros((world.x.shape[0],) + cfg.storage_shape, dtype=torch.uint8,
                                   device=self.device)
            if cfg.render_mode == "pallas":
                geom = render_ops.pack_geometry_banked(
                    self.town, world, self.weather_params[world.weather_id],
                    n_actors=self.n_actors)
                return render_ops.render_planes(geom, with_depth=cfg.stack_depth,
                                                n_actors=self.n_actors)
            inputs = self.render_inputs(world)
            if cfg.cameras == 1:
                img = rasterizer.render_one_camera(
                    inputs, cfg.image_height, cfg.image_width, cfg.render_quality,
                    stack_depth=cfg.stack_depth, depth_modulate=cfg.depth_modulate)
            else:
                img = rasterizer.render_cameras(inputs, cfg.image_height, cfg.image_width,
                                                cfg.render_quality, return_depth=cfg.stack_depth)
            return img.permute(0, 3, 1, 2).contiguous()          # full-resolution planes

    def render_inputs(self, world: WorldState) -> rasterizer.RenderInputs:
        """The analytic renderer's inputs of every world: its town's
        geometry, its pose, its NPCs and its weather."""
        t, tid = self.town, world.town_id
        return rasterizer.RenderInputs(
            edges_xy=t.edges_xy[tid], num_edges=t.num_edges[tid],
            buildings=t.buildings[tid], junctions=t.junction_xy[tid],
            num_junctions=t.num_junctions[tid],
            ego_xy=torch.stack([world.x, world.y], dim=-1), ego_yaw=world.yaw,
            weather=self.weather_params[world.weather_id], road_half=t.road_half[tid],
            **rasterizer.actor_fields(world.npc, world.x.shape[0], self.device))

    def frame_obs(self, world: WorldState) -> dict:
        vec = world_mod.vector_observation(world, self.params, self.town, self.routes)
        return dict(image=self.render_frame(world), **vec)

    def _fresh_state(self, world: WorldState, frame: dict, frame_id) -> EnvState:
        """Episode start: stacks of zero observations with the first frame
        last (reference core/carla_env.py:79-81,323-325)."""
        cfg = self.config
        T = cfg.time_horizon
        B = world.x.shape[0]

        def stack(item):
            s = torch.zeros((B, T) + tuple(item.shape[1:]), dtype=item.dtype,
                            device=item.device)
            s[:, -1] = item
            return s

        # zero-frame sentinel -(T+1); ids in [-T, -1] are reserved for the
        # trainer's pre-rollout relabelling
        ids = torch.full((B, T), -(T + 1), dtype=torch.int64, device=self.device)
        ids[:, -1] = frame_id
        return EnvState(
            world=world, image_stack=stack(frame["image"]),
            road_stack=stack(frame["road"]), vehicle_stack=stack(frame["vehicle"]),
            nav_stack=stack(frame["navigation"]), stack_ids=ids,
            stack_slot=torch.full((B,), T - 1, dtype=torch.int64, device=self.device),
            last_action=torch.full((B, cfg.num_actions), 0.5, device=self.device))

    # ---- reset / step ----
    def reset(self, draws: ResetDraws, episode=0, frame_id=-1):
        """Fresh episodes from `draws` (see world.reset_draws).  Returns
        (state, obs)."""
        world = world_mod.reset_world(draws, self.routes, episode=episode, town=self.town,
                                      params=self.params)
        state = self._fresh_state(world, self.frame_obs(world), frame_id)
        return state, self.observe(state)

    def reset_batch(self, num_envs: int):
        """`num_envs` fresh episodes drawn from the env's generator."""
        return self.reset(self.reset_draws(num_envs))

    def reset_draws(self, n: int) -> ResetDraws:
        """`n` episode resets drawn from the env's generator."""
        return self._rows(n, lambda m: world_mod.reset_draws(self.generator, m, self.params,
                                                             self.routes, self.town))

    def npc_step_draws(self, world: WorldState) -> Optional[traffic.NPCStepDraws]:
        """The NPC tick's draws for `world` from the env's generator; None
        (and nothing drawn) without NPCs."""
        if not self.params.has_npcs:
            return None
        v, p = self.params.v_max, self.params.p_max
        # one row of uniforms per world, scaled by its town
        u = self._rows(world.town_id.shape[0], lambda m: torch.rand(
            (m, v + 3 * p), generator=self.generator, device=self.device))
        return traffic.step_draws_from_uniforms(u, self.town, world.town_id, v, p)

    def observe(self, state: EnvState) -> dict:
        """Stacked observation dict, image scaled to [0, 1]
        (reference core/carla_env.py:301-321)."""
        with span("env.observe"):
            ry, rx = self.config.upsample
            ordered = ordered_image_stack(state.image_stack, state.stack_ids,
                                          state.stack_slot)
            img = planes_to_image(ordered, ry, rx)             # (B, T, H, 3W, C)
            obs = dict(image=img.to(torch.float32) / 255.0,
                       road=state.road_stack, vehicle=state.vehicle_stack,
                       navigation=state.nav_stack)
            if self.config.cameras == 1:
                # the OneCamera env's current-frame keys: the control (throttle,
                # brake, steer, reverse; reference environment.py:1103-1104) and
                # the route's RoadOption one-hot (:1092-1093)
                w = state.world
                obs["past_control"] = torch.stack(
                    [w.throttle, w.brake, w.steer, torch.zeros_like(w.steer)], dim=-1)
                opt = self.routes.option[w.town_id, w.route_id, w.wp_idx]
                obs["command"] = (opt[:, None] == torch.arange(7, device=self.device)).to(
                    torch.float32)
            return obs

    def step(self, state: EnvState, action: torch.Tensor, frame_id=-1,
             draws: Optional[ResetDraws] = None,
             npc_draws: Optional[traffic.NPCStepDraws] = None):
        """One step of every world with auto-reset: physics (and the NPC
        tick from `npc_draws`), then the worlds that ended restart from
        `draws` (each drawn from the env's generator when not given, the
        NPC tick's first), then one frame is rendered for all worlds and
        pushed every past_obs_freq steps (reference
        core/carla_env.py:290-299).  `action` is the env action in [-1, 1]^2.
        Returns (state', obs, reward, terminated, truncated, info)."""
        with span("env.step"):
            cfg = self.config
            B = action.shape[0]
            with span("env.draws"):
                if npc_draws is None:
                    npc_draws = self.npc_step_draws(state.world)
            with span("world.step"):
                world, reward, term, trunc, info = world_mod.step_world(
                    state.world, action, self.params, self.town, self.routes, npc_draws)
            done = term | trunc
            with span("env.draws"):
                if draws is None:
                    draws = self.reset_draws(B)
            with span("world.reset"):
                fresh_world = world_mod.reset_world(draws, self.routes,
                                                    episode=world.episode + 1,
                                                    town=self.town, params=self.params)
            merged = world_mod.where_state(done, fresh_world, world)
            frame = self.frame_obs(merged)

            push = (state.world.timestep % cfg.past_obs_freq) == 0      # (B,)

            def push_stack(stack, item):
                rolled = torch.cat([stack[:, 1:], item[:, None]], dim=1)
                p = push.reshape((B,) + (1,) * (stack.dim() - 1))
                return torch.where(p, rolled, stack)

            img_ordered = ordered_image_stack(state.image_stack, state.stack_ids,
                                              state.stack_slot)
            fid = torch.full((B,), frame_id, dtype=torch.int64, device=self.device)
            stepped = EnvState(
                world=merged,
                image_stack=push_stack(img_ordered, frame["image"]),
                road_stack=push_stack(state.road_stack, frame["road"]),
                vehicle_stack=push_stack(state.vehicle_stack, frame["vehicle"]),
                nav_stack=push_stack(state.nav_stack, frame["navigation"]),
                stack_ids=push_stack(state.stack_ids, fid),
                stack_slot=torch.full((B,), cfg.time_horizon - 1, dtype=torch.int64,
                                      device=self.device),
                last_action=state.last_action)
            fresh_state = self._fresh_state(merged, frame, frame_id)
            new_state = world_mod.where_state(done, fresh_state, stepped)
            return new_state, self.observe(new_state), reward, term, trunc, info

    # ---- block path (training rollouts) ----
    # The policy's input, the past-observation stack, changes only every
    # past_obs_freq steps (reference core/carla_env.py:290-299), so the block
    # path advances the physics past_obs_freq ticks without touching the
    # stacks, then renders once and pushes the frame for all worlds.  As in
    # the JAX package: the push phase is block-aligned, and a world that
    # auto-resets mid-block gets its first frame at the block boundary, with
    # all-zero stacks until then (reference core/carla_env.py:323-325).

    def step_physics(self, state: EnvState, action: torch.Tensor,
                     draws: Optional[ResetDraws] = None,
                     npc_draws: Optional[traffic.NPCStepDraws] = None):
        """World-only tick of every world with auto-reset, by the plain
        PyTorch path; the stacks pass through untouched.  The NPC tick's
        and the reset draws come from the env's generator unless given.
        Returns (state', reward, terminated, truncated, info, was_reset)."""
        if npc_draws is None:
            npc_draws = self.npc_step_draws(state.world)
        if draws is None:
            draws = self.reset_draws(action.shape[0])
        world, reward, term, trunc, info, done = physics_ops.step_physics_batch_plain(
            state.world, action, self.params, self.town, self.routes, draws, npc_draws)
        return state._replace(world=world), reward, term, trunc, info, done

    def step_physics_batch(self, states: EnvState, actions: torch.Tensor,
                           draws: Optional[ResetDraws] = None):
        """step_physics, through the physics kernel when `fused_step` is on
        (ops/physics.step_physics_batch: the kernel for CUDA tensors, the
        plain version for CPU tensors)."""
        if not self.config.fused_step:
            return self.step_physics(states, actions, draws)
        if draws is None:
            draws = self.reset_draws(actions.shape[0])
        world, reward, term, trunc, info, done = physics_ops.step_physics_batch(
            states.world, actions, self.params, self.town, self.routes, draws,
            self.physics_consts())
        return states._replace(world=world), reward, term, trunc, info, done

    def physics_consts(self) -> physics_ops.PhysicsConsts:
        """The physics kernel's banks and constants, packed once."""
        if self._physics_consts is None:
            self._physics_consts = physics_ops.PhysicsConsts(self.params, self.town,
                                                             self.routes)
        return self._physics_consts

    def step_physics_block(self, states: EnvState, actions: torch.Tensor,
                           draws: Optional[ResetDraws] = None,
                           npc_draws: Optional[traffic.NPCStepDraws] = None):
        """K world-only ticks of every world with auto-reset, tick k with
        actions[k] (actions (K, B, A) in [-1, 1]): one kernel launch when
        `fused_step` is on (ops/physics.step_physics_block; the plain version
        for CPU tensors), else K plain ticks, which also tick the NPCs of a
        world with traffic (fused_step is refused there, in __init__).  The
        block's NPC tick uniforms (K, B, V + 3P; tick k's row scaled by the
        towns the worlds hold at tick k, so that a world restarting
        mid-block in another town draws on its new town) and then its (K, B)
        reset draws, with their NPC spawns, come from the env's generator,
        one call each (two for the resets with NPCs), unless given
        (`npc_draws`: the uniforms or NPCStepDraws (K, B, ...)); without NPCs
        nothing is drawn for them.  Returns (state' after the last tick, reward,
        terminated, truncated, info {speed, similarity}, was_reset), each
        row (K, B)."""
        with span("env.physics_block"):
            k, n = actions.shape[0], actions.shape[1]
            if npc_draws is None and self.params.has_npcs:
                npc_draws = self._rows(n, lambda m: traffic.block_npc_step_uniforms(
                    self.generator, k, m, self.params.v_max, self.params.p_max, self.device),
                    dim=1)
            if draws is None:
                draws = self._rows(n, lambda m: world_mod.block_reset_draws(
                    self.generator, k, m, self.params, self.routes, self.weather_table,
                    self.town), dim=1)
            if self.config.fused_step:
                out = physics_ops.step_physics_block(states.world, actions, self.params, self.town,
                                                     self.routes, draws, self.physics_consts())
            else:
                out = physics_ops.step_physics_block_plain(states.world, actions, self.params,
                                                           self.town, self.routes, draws,
                                                           npc_draws)
            return (states._replace(world=out[0]),) + out[1:]

    def _push_block_vectors(self, state: EnvState, was_reset: torch.Tensor,
                            frame_ids: torch.Tensor, road, vehicle, navigation):
        """The vector stacks and ids part of the block push: they stay in
        ordered form; a world flagged `was_reset` restarts as
        [0, ..., 0, frame]."""
        T = self.config.time_horizon
        keep = (~was_reset).to(torch.float32)

        def push(stack, item):
            # fresh == [0, ..., 0, item] and rolled == [s1, ..., s_{T-1}, item]
            # share the last slot, so the reset select is a mask on the rest
            shifted = stack[:, 1:] * keep[:, None, None]
            return torch.cat([shifted, item[:, None]], dim=1)

        ids_rolled = torch.cat([state.stack_ids[:, 1:], frame_ids[:, None]], dim=1)
        ids_fresh = torch.full_like(state.stack_ids, -(T + 1))
        ids_fresh[:, -1] = frame_ids
        return state._replace(
            road_stack=push(state.road_stack, road),
            vehicle_stack=push(state.vehicle_stack, vehicle),
            nav_stack=push(state.nav_stack, navigation),
            stack_ids=torch.where(was_reset[:, None], ids_fresh, ids_rolled))

    def push_block_frame_batch(self, states: EnvState, was_reset: torch.Tensor,
                               frame_ids=-1, slot: Optional[int] = None):
        """Render every world once (one render_planes launch), push the
        vector stacks and ids, and write the new frames into the circular
        image buffer.

        With `slot`, the physical slot that every world's newest frame holds
        (the block rollout keeps all worlds on one slot and tracks it on the
        host), all frames go into slot (slot + 1) % T: the JAX package's
        uniform write (envs/carla_env.py:630).  Without it, each world's
        frame goes into its own next slot: the general write (:640) for
        states assembled elsewhere.  Neither needs a host synchronisation.
        The frames are written into `states.image_stack` in place (a rollout
        owns its buffer: run_rollout_blocks starts from a fresh ordered
        copy); reset worlds keep stale bytes behind sentinel ids, which
        every reader masks."""
        with span("env.push_block"):
            B = was_reset.shape[0]
            T = self.config.time_horizon
            if isinstance(frame_ids, int):
                frame_ids = torch.full((B,), frame_ids, dtype=torch.int64, device=self.device)
            frame = self.frame_obs(states.world)
            states = self._push_block_vectors(states, was_reset, frame_ids,
                                              frame["road"], frame["vehicle"],
                                              frame["navigation"])
            stack = states.image_stack
            if slot is not None:
                k = (slot + 1) % T
                stack[:, k] = frame["image"]
                slot_new = torch.full((B,), k, dtype=torch.int64, device=self.device)
            else:
                slot_new = (states.stack_slot + 1) % T
                stack[torch.arange(B, device=self.device), slot_new] = frame["image"]
            return states._replace(image_stack=stack, stack_slot=slot_new)


def convert_action(action01: torch.Tensor, low: float = -1.0,
                   high: float = 1.0) -> torch.Tensor:
    """Beta samples in [0, 1] -> env action range
    (reference rl/agents/ppo.py:158-163), in the world's float32 (a
    float64 network's samples included)."""
    return (action01 * (high - low) + low).to(torch.float32)


class CARLAEnvDiscrete:
    """Discrete-action wrapper (reference ThreeCameraCARLAEnvironmentDiscrete,
    environment.py:1267-1301): each action dimension quantised into `bins`
    bins of the Box; `to_continuous` / `to_discrete` map between the two.
    Every step of the env is batched, so `step` and `step_batch` are one."""

    def __init__(self, env: CARLAEnv, bins: int = 4):
        if bins < 2 or bins % 2:
            raise ValueError(f"bins must be even and >= 2, got {bins}")
        self.env = env
        self.bins = bins
        box = env.action_space
        self._low = torch.tensor(box.low, device=env.device)
        self._delta = torch.tensor((box.high - box.low) / bins, device=env.device)

    @property
    def action_space(self) -> spaces.MultiDiscrete:
        return spaces.MultiDiscrete(nvec=[self.bins] * self.env.config.num_actions)

    @property
    def observation_space(self) -> spaces.Dict:
        return self.env.observation_space

    @property
    def time_horizon(self) -> int:
        return self.env.time_horizon

    def to_continuous(self, discrete_actions: torch.Tensor) -> torch.Tensor:
        return self._delta * discrete_actions.to(torch.float32) + self._low

    def to_discrete(self, continuous_actions: torch.Tensor) -> torch.Tensor:
        return ((continuous_actions - self._low) / self._delta).to(torch.int32)

    def reset(self, draws: ResetDraws, **kwargs):
        return self.env.reset(draws, **kwargs)

    def reset_batch(self, num_envs: int):
        return self.env.reset_batch(num_envs)

    def observe(self, state: EnvState) -> dict:
        return self.env.observe(state)

    def step(self, state: EnvState, action: torch.Tensor, frame_id=-1, **kwargs):
        return self.env.step(state, self.to_continuous(action), frame_id, **kwargs)

    step_batch = step
