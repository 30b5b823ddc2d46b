"""CARLAEnv: the batched driving environment.

Counterpart of carla_driving_rl_agent_tpu/envs/carla_env.py: the world
core, the CUDA renderer and the time-horizon frame stacks, with auto-reset,
over a batch of worlds on one device.  Two paths step it: the per-step
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

Frames are stored as uint8 planes at the renderer's half resolution, (C, 45,
180) per frame; `observe` upsamples 2x and interleaves the channels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from carla_driving_rl_agent_torch import resolve_device
from carla_driving_rl_agent_torch.envs import traffic, world as world_mod
from carla_driving_rl_agent_torch.envs.weather import WEATHER_PARAMS
from carla_driving_rl_agent_torch.envs.world import ResetDraws, WorldParams, WorldState
from carla_driving_rl_agent_torch.ops import physics as physics_ops
from carla_driving_rl_agent_torch.ops import render as render_ops


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
    image_width: int = 120          # per camera; the full image is 3x this
    stack_depth: bool = False       # +1 log-depth channel (core/carla_env.py:49-54,271-288)
    time_horizon: int = 4
    past_obs_freq: int = 4
    num_actions: int = 2
    # the physics tick of the block path through the CUDA kernel
    # (ops/physics.py), which computes worlds without NPCs: CARLAEnv
    # refuses it for a world with NPCs (the JAX package quietly takes its
    # XLA step there; the port has no such fallback)
    fused_step: bool = False

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.image_height, 3 * self.image_width,
                3 + (1 if self.stack_depth else 0))

    @property
    def storage_shape(self) -> Tuple[int, int, int]:
        """(C, 45, 180) planar uint8 frame storage: the renderer's native
        half-res views side by side."""
        h, w, c = self.image_shape
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
        if config.fused_step and config.world.has_npcs:
            raise NotImplementedError(
                f"fused_step: the physics kernel steps worlds without NPCs, and this world has "
                f"{config.world.num_vehicles} vehicles and {config.world.num_pedestrians} "
                f"pedestrians")
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

    def seed(self, seed: int) -> None:
        self.generator.manual_seed(seed)

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
        """(B, C, 45, 180) uint8 planar frames of every world."""
        geom = render_ops.pack_geometry_banked(
            self.town, world, self.weather_params[world.weather_id], n_actors=self.n_actors)
        return render_ops.render_planes(geom, with_depth=self.config.stack_depth,
                                        n_actors=self.n_actors)

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
        return world_mod.reset_draws(self.generator, n, self.params, self.routes, self.town)

    def npc_step_draws(self, world: WorldState) -> Optional[traffic.NPCStepDraws]:
        """The NPC tick's draws for `world` from the env's generator; None
        (and nothing drawn) without NPCs."""
        if not self.params.has_npcs:
            return None
        return traffic.npc_step_draws(self.generator, self.town, world.town_id,
                                      self.params.v_max, self.params.p_max)

    def observe(self, state: EnvState) -> dict:
        """Stacked observation dict, image scaled to [0, 1]
        (reference core/carla_env.py:301-321)."""
        ry, rx = self.config.upsample
        ordered = ordered_image_stack(state.image_stack, state.stack_ids,
                                      state.stack_slot)
        img = planes_to_image(ordered, ry, rx)             # (B, T, H, 3W, C)
        return dict(image=img.to(torch.float32) / 255.0,
                    road=state.road_stack, vehicle=state.vehicle_stack,
                    navigation=state.nav_stack)

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
        cfg = self.config
        B = action.shape[0]
        if npc_draws is None:
            npc_draws = self.npc_step_draws(state.world)
        world, reward, term, trunc, info = world_mod.step_world(
            state.world, action, self.params, self.town, self.routes, npc_draws)
        done = term | trunc
        if draws is None:
            draws = self.reset_draws(B)
        fresh_world = world_mod.reset_world(draws, self.routes, episode=world.episode + 1,
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
        k, n = actions.shape[0], actions.shape[1]
        if npc_draws is None and self.params.has_npcs:
            npc_draws = traffic.block_npc_step_uniforms(self.generator, k, n, self.params.v_max,
                                                        self.params.p_max, self.device)
        if draws is None:
            draws = world_mod.block_reset_draws(self.generator, k, n, self.params, self.routes,
                                                self.weather_table, self.town)
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
    (reference rl/agents/ppo.py:158-163)."""
    return action01 * (high - low) + low
