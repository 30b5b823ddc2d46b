"""The fused physics step: the CUDA kernel's wrappers and their plain
PyTorch versions.

Counterpart of carla_driving_rl_agent_tpu/ops/physics_pallas.py.  One call
advances every world of a configuration without NPCs by one tick and restarts
the worlds whose episode ended from pre-drawn reset values: it computes what
envs/world.step_world followed by the auto-reset merge of
CARLAEnv.step_physics computes, and returns the same
(world', reward, terminated, truncated, info, was_reset).

Two entry points launch the kernel of csrc/physics.cu (built with nvcc at
first use, loaded with ctypes) on CUDA tensors and run their plain version
on CPU tensors:
  * `step_physics_batch`: one tick, the JAX counterpart's interface;
  * `step_physics_block`: K ticks in one launch, each world's state in the
    kernel's registers from the first tick to the last; the rollout's block
    of past_obs_freq ticks, whose actions the policy drew before the block
    (the JAX package runs them as one `lax.scan`).  It returns the rows a
    rollout records for each tick and the state after the last.
Both take the banks and params packed once (`PhysicsConsts`, which the env
keeps) and allocate their outputs once per call.  The kernel's per-world
arithmetic lives in csrc/physics.cuh, which csrc/physics_host.cpp also
builds with g++ (`step_physics_host`, `step_physics_block_host`) so that
the CPU tests hold the kernel's own math against the plain version and the
JAX package.

The reset draws are inputs (ResetDraws for every world and tick, used where
the episode ended), drawn beforehand from the env's generator, so that the
kernel and the plain version take identical inputs.

The kernel computes worlds without NPCs and the default reward:
`step_physics_batch` and `step_physics_block` raise on a configuration
with NPCs or with the shaped reward, on every device (the JAX package
quietly takes its XLA step there, physics_pallas.fused_step_supported).
The plain versions step NPC worlds too: the single tick from the tick's
NPC draws, the block from a block's NPC draws (K rows,
traffic.block_npc_step_draws), tick k from row k, or from its NPC
uniforms (traffic.block_npc_step_uniforms), tick k's row scaled by the
towns the worlds hold at tick k, and the NPC spawn of each tick's fresh
state from the reset draws' `npc` rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from carla_driving_rl_agent_torch.envs import town as town_mod, traffic
from carla_driving_rl_agent_torch.envs import world as world_mod
from carla_driving_rl_agent_torch.envs.dynamics import DT
from carla_driving_rl_agent_torch.envs.world import (
    ResetDraws, RoutesDev, TownDev, WorldParams, WorldState)

# output rows, in the order of csrc/physics.cuh's StateFloat / IntOut /
# StateBool (the state after the last tick) and TickFloat / TickBool (each
# tick's returns and info; a block call writes the first BLOCK_TICK_* rows)
STATE_F = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
           "sim_time", "total_reward", "collision_penalty")
INT_OUT = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode")
STATE_B = ("should_terminate",)
TICK_F = ("reward", "speed", "similarity", "distance_to_next_waypoint",
          "distance_to_destination", "off_road_distance", "total_reward")
TICK_B = ("terminated", "truncated", "done", "hit_other")
# a block call writes what a rollout and an evaluation accumulate per tick
BLOCK_TICK_F, BLOCK_TICK_B = 4, 4

_F32_STATE = ("x", "y", "yaw", "v", "sim_time", "total_reward")
_I64_STATE = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode")


def step_physics_batch_plain(world: WorldState, action: torch.Tensor,
                             params: WorldParams, town: TownDev,
                             routes: RoutesDev, draws: ResetDraws,
                             npc_draws: Optional[traffic.NPCStepDraws] = None):
    """The plain PyTorch version: step_world (with the NPC tick's draws in
    a configuration with NPCs), then the worlds that ended restart from
    `draws`.  Returns (world', reward, terminated, truncated, info,
    was_reset)."""
    w, reward, term, trunc, info = world_mod.step_world(world, action, params,
                                                        town, routes, npc_draws)
    done = term | trunc
    fresh = world_mod.reset_world(draws, routes, episode=w.episode + 1, town=town,
                                  params=params)
    return world_mod.where_state(done, fresh, w), reward, term, trunc, info, done


def refuse_unsupported(params: WorldParams, what: str) -> None:
    """Raise unless the kernel computes this configuration: worlds without
    NPCs, with the default reward."""
    if params.has_npcs:
        raise NotImplementedError(
            f"{what} steps worlds without NPCs; this configuration has "
            f"{params.num_vehicles} vehicles and {params.num_pedestrians} pedestrians "
            f"(the plain versions step them: CARLAEnv without fused_step)")
    if params.reward_mode != "default":
        raise NotImplementedError(
            f"{what} computes the default reward, not reward_mode="
            f"{params.reward_mode!r} (the plain versions do: CARLAEnv without fused_step)")


def step_physics_block_plain(world: WorldState, actions: torch.Tensor,
                             params: WorldParams, town: TownDev,
                             routes: RoutesDev, draws: ResetDraws,
                             npc_draws=None):
    """The plain version of `step_physics_block`: K calls of
    step_physics_batch_plain, tick k with actions[k], the k-th row of each
    reset draw and, in a configuration with NPCs, the k-th row of
    `npc_draws`: NPCStepDraws (K, B, ...), or the block's (K, B, V + 3P)
    NPC uniforms, tick k's row scaled by the towns the worlds hold at tick
    k.  Returns (world', reward, terminated, truncated, info, was_reset),
    each row (K, B); info holds speed, similarity,
    distance_to_next_waypoint, collision and the collision's kind
    (hit_vehicle, hit_pedestrian, hit_other)."""
    rows = []
    keys = ("speed", "similarity", "distance_to_next_waypoint", "collision", "hit_vehicle",
            "hit_pedestrian", "hit_other")
    for k in range(actions.shape[0]):
        row = lambda d: d[k]  # noqa: E731
        if isinstance(npc_draws, torch.Tensor):
            npc_k = traffic.step_draws_from_uniforms(npc_draws[k], town, world.town_id,
                                                     params.v_max, params.p_max)
        else:
            npc_k = world_mod.map_tensors(row, npc_draws)
        world, reward, term, trunc, info, done = step_physics_batch_plain(
            world, actions[k], params, town, routes, world_mod.map_tensors(row, draws), npc_k)
        rows.append((reward, term, trunc, done) + tuple(info[n] for n in keys))
    reward, term, trunc, done, *per_tick = (torch.stack(r) for r in zip(*rows))
    return world, reward, term, trunc, dict(zip(keys, per_tick)), done


class _Args(ctypes.Structure):
    """ctypes mirror of cdrl::PhysicsArgs (csrc/physics.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "y", "yaw", "v", "route_id", "wp_idx", "town_id", "weather_id",
        "timestep", "episode", "sim_time", "total_reward", "action",
        "d_town", "d_weather", "d_route", "d_sim_time",
        "route_len", "route_xyy", "route_start", "route_end", "cell_segs",
        "road_half", "out_f", "out_i", "out_b", "tick_f", "tick_b")]
        + [(n, ctypes.c_float) for n in (
            "range_throttle_lo", "range_throttle_hi", "range_brake_lo",
            "range_brake_hi", "range_steer_lo", "range_steer_hi",
            "off_road_threshold", "lane_pad", "penalty", "speed_cap",
            "over_cap", "dt", "cell_res")]
        + [(n, ctypes.c_int) for n in (
            "n_worlds", "n_ticks", "n_tick_f", "n_tick_b", "max_timesteps",
            "n_actions", "throttle_as_desired_speed", "reverse", "n_routes",
            "route_max_len", "grid_h", "grid_w", "k_segs")])


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the worlds on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


class PhysicsConsts:
    """The kernel's arguments that stay fixed for an env: the banks'
    addresses and the params' constants, checked and packed once (the env
    keeps one; the tensors stay referenced here while it lives).  It also
    remembers the state the last call wrote and its fields' addresses: the
    next call of a rollout starts from it, and its fields, rows of the
    call's own outputs, need no checks."""

    def __init__(self, params: WorldParams, town: TownDev, routes: RoutesDev):
        self.device = routes.length.device
        self.disable_reverse = params.disable_reverse
        self._keep = (town, routes)
        self.last: Optional[Tuple[WorldState, dict]] = None
        a = self.args = _Args()
        dev = self.device
        a.route_len = _check(routes.length, "routes.length", torch.int64, dev)
        a.route_xyy = _check(routes.xyy, "routes.xyy", torch.float32, dev)
        a.route_start = _check(routes.start, "routes.start", torch.float32, dev)
        a.route_end = _check(routes.end_xy, "routes.end_xy", torch.float32, dev)
        a.cell_segs = _check(town.cell_segs, "town.cell_segs", torch.float32, dev)
        a.road_half = _check(town.road_half, "town.road_half", torch.float32, dev)
        rc = params.range_controls
        (a.range_throttle_lo, a.range_throttle_hi), (a.range_brake_lo, a.range_brake_hi), \
            (a.range_steer_lo, a.range_steer_hi) = rc[0], rc[1], rc[2]
        a.off_road_threshold = params.off_road_threshold
        a.lane_pad = town_mod.LANE_WIDTH + 0.3
        a.penalty = params.collision_penalty / params.off_road_penalty_divisor
        a.speed_cap = params.reward_speed_cap
        a.over_cap = params.speed_over_cap_penalty
        a.dt = DT
        a.cell_res = town_mod.CELL_RES
        a.max_timesteps = params.max_timesteps
        a.throttle_as_desired_speed = int(params.throttle_as_desired_speed)
        a.n_routes, a.route_max_len = routes.xyy.shape[1], routes.xyy.shape[2]
        a.grid_h, a.grid_w = town.cell_segs.shape[1], town.cell_segs.shape[2]
        a.k_segs = town.cell_segs.shape[3] // 4


def _pack(world: WorldState, actions: torch.Tensor, consts: PhysicsConsts,
          draws: ResetDraws, n_tick_f: int, n_tick_b: int):
    """Check the state, the (K, B, A) actions and the (K, B) draws, lay out
    the kernel's arguments over `consts` and allocate its outputs: the
    state's float, int and flag rows, and n_tick_f float and n_tick_b flag
    rows of (K, B) for the ticks."""
    dev = world.x.device
    n = world.x.shape[0]
    if dev != consts.device:
        raise ValueError(f"the worlds are on {dev}, the banks on {consts.device}")
    if actions.dim() != 3 or actions.shape[1] != n or actions.shape[2] < 2:
        raise ValueError(f"action must be ({n}, >=2) per tick, got {tuple(actions.shape)}")
    k = actions.shape[0]
    a = _Args.from_buffer_copy(consts.args)
    if consts.last is not None and consts.last[0] is world:
        ptrs = consts.last[1]
    else:
        ptrs = {}
        for name in _F32_STATE + _I64_STATE:
            t = getattr(world, name)
            if t.shape != (n,):
                raise ValueError(f"world.{name} must be ({n},), got {tuple(t.shape)}")
            dtype = torch.float32 if name in _F32_STATE else torch.int64
            ptrs[name] = _check(t, f"world.{name}", dtype, dev)
    for name, ptr in ptrs.items():
        setattr(a, name, ptr)
    a.action = _check(actions, "action", torch.float32, dev)
    for name, field, dtype in (("d_town", "town_id", torch.int64),
                               ("d_weather", "weather_id", torch.int64),
                               ("d_route", "route_id", torch.int64),
                               ("d_sim_time", "sim_time", torch.float32)):
        t = getattr(draws, field)
        if t.shape != (k, n):
            raise ValueError(f"draws.{field} must be ({k}, {n}), got {tuple(t.shape)}")
        setattr(a, name, _check(t, f"draws.{field}", dtype, dev))
    state = (torch.empty((len(STATE_F), n), dtype=torch.float32, device=dev),
             torch.empty((len(INT_OUT), n), dtype=torch.int64, device=dev),
             torch.empty((len(STATE_B), n), dtype=torch.bool, device=dev))
    ticks = (torch.empty((n_tick_f, k, n), dtype=torch.float32, device=dev),
             torch.empty((n_tick_b, k, n), dtype=torch.bool, device=dev))
    a.out_f, a.out_i, a.out_b = (t.data_ptr() for t in state)
    a.tick_f, a.tick_b = (t.data_ptr() for t in ticks)
    a.n_worlds, a.n_ticks, a.n_tick_f, a.n_tick_b = n, k, n_tick_f, n_tick_b
    a.n_actions = actions.shape[2]
    a.reverse = int(actions.shape[2] >= 3 and not consts.disable_reverse)
    return a, state, ticks


def _unpack_state(state, consts: Optional[PhysicsConsts] = None) -> WorldState:
    """The state rows as a WorldState (whose `npc` is None: the kernel
    steps worlds without NPCs); `consts` remembers it and its fields'
    addresses for the next call."""
    f, i, b = (dict(zip(names, t.unbind(0))) for names, t in zip(
        (STATE_F, INT_OUT, STATE_B), state))
    world = WorldState(
        x=f["x"], y=f["y"], yaw=f["yaw"], v=f["v"], throttle=f["throttle"],
        brake=f["brake"], steer=f["steer"], route_id=i["route_id"],
        wp_idx=i["wp_idx"], similarity=f["similarity"], town_id=i["town_id"],
        weather_id=i["weather_id"], timestep=i["timestep"],
        sim_time=f["sim_time"], episode=i["episode"],
        total_reward=f["total_reward"],
        collision_penalty=f["collision_penalty"],
        should_terminate=b["should_terminate"])
    if consts is not None:
        n = state[0].shape[1]
        rows = [(name, state[0], STATE_F.index(name)) for name in _F32_STATE]
        rows += [(name, state[1], INT_OUT.index(name)) for name in _I64_STATE]
        consts.last = (world, {name: t.data_ptr() + r * n * t.element_size()
                               for name, t, r in rows})
    return world


def _unpack_tick(state, ticks, consts: Optional[PhysicsConsts] = None):
    """step_physics_batch's returns from a one-tick launch."""
    f = dict(zip(TICK_F, ticks[0][:, 0].unbind(0)))
    b = dict(zip(TICK_B, ticks[1][:, 0].unbind(0)))
    no_npc = torch.zeros_like(b["hit_other"])      # the kernel's worlds have no NPCs
    info = dict(
        speed=f["speed"], similarity=f["similarity"],
        distance_to_next_waypoint=f["distance_to_next_waypoint"],
        distance_to_destination=f["distance_to_destination"],
        reward=f["reward"], total_reward=f["total_reward"],
        collision=b["hit_other"], hit_vehicle=no_npc, hit_pedestrian=no_npc,
        hit_other=b["hit_other"], off_road_distance=f["off_road_distance"])
    return (_unpack_state(state, consts), f["reward"], b["terminated"], b["truncated"], info,
            b["done"])


def _unpack_block(state, ticks, consts: Optional[PhysicsConsts] = None):
    """step_physics_block's returns: the state and (K, B) rows."""
    reward, speed, similarity, d_next = ticks[0].unbind(0)
    term, trunc, done, hit_other = ticks[1].unbind(0)
    # the kernel's worlds have no NPCs: the collision is the off-road exit,
    # and no NPC collision rows are made (each would cost a launch)
    info = dict(speed=speed, similarity=similarity, distance_to_next_waypoint=d_next,
                collision=hit_other, hit_other=hit_other)
    return _unpack_state(state, consts), reward, term, trunc, info, done


# ------------------------------------------------------------------
# the CUDA kernel and its host build
# ------------------------------------------------------------------

_NVCC_FLAGS = ["--fmad=false"]
_GXX_FLAGS = ["-ffp-contract=off"]


def _kernel_lib() -> ctypes.CDLL:
    from carla_driving_rl_agent_torch.utils.build import csrc, load_library
    vp = ctypes.c_void_p
    return load_library(
        "physics", [csrc("physics.cu")], "nvcc",
        {"cdrl_physics_step": (ctypes.c_int, [ctypes.POINTER(_Args), vp])},
        extra_deps=[csrc("physics.cuh")], extra_flags=_NVCC_FLAGS)


def _host_lib() -> ctypes.CDLL:
    from carla_driving_rl_agent_torch.utils.build import csrc, load_library
    return load_library(
        "physics_host", [csrc("physics_host.cpp")], "g++",
        {"cdrl_physics_step_host": (None, [ctypes.POINTER(_Args)])},
        extra_deps=[csrc("physics.cuh")], extra_flags=_GXX_FLAGS)


def build_kernel() -> None:
    """Compile (if needed) and load the CUDA physics kernel."""
    _kernel_lib()


def _run(lib_fn, args: _Args, dev: torch.device) -> None:
    """Launch the kernel on `dev`'s current stream; raises on a CUDA error."""
    if args.n_worlds == 0:
        return
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _run(lib_fn, args, dev)
    err = lib_fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"physics kernel launch failed: CUDA error {err}")


def _device(world: WorldState) -> torch.device:
    dev = world.x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the physics step runs on cuda or cpu, not {dev}")
    return dev


def step_physics_batch(world: WorldState, action: torch.Tensor,
                       params: WorldParams, town: TownDev, routes: RoutesDev,
                       draws: ResetDraws, consts: Optional[PhysicsConsts] = None):
    """One tick of every world with auto-reset from `draws`; returns
    (world', reward, terminated, truncated, info, was_reset).

    CUDA tensors launch the kernel of csrc/physics.cu with K = 1 on the
    current stream (and count the launch in `step_physics_batch.launches`);
    CPU tensors run `step_physics_batch_plain`.  Anything else raises.
    `consts` is the env's PhysicsConsts of (params, town, routes), packed
    here when not given.  Raises on a configuration with NPCs or the
    shaped reward, on every device."""
    refuse_unsupported(params, "the physics kernel")
    dev = _device(world)
    if dev.type == "cpu":
        return step_physics_batch_plain(world, action, params, town, routes, draws)
    consts = consts or PhysicsConsts(params, town, routes)
    args, state, ticks = _pack(world, action[None], consts,
                               world_mod.map_tensors(lambda d: d[None], draws),
                               len(TICK_F), len(TICK_B))
    _run(_kernel_lib().cdrl_physics_step, args, dev)
    step_physics_batch.launches += int(args.n_worlds > 0)
    return _unpack_tick(state, ticks, consts)


step_physics_batch.launches = 0


def step_physics_block(world: WorldState, actions: torch.Tensor,
                       params: WorldParams, town: TownDev, routes: RoutesDev,
                       draws: ResetDraws, consts: Optional[PhysicsConsts] = None):
    """K ticks of every world with auto-reset, tick k with actions[k]
    (actions (K, B, A)) and the k-th rows of `draws` ((K, B) each); returns
    (world' after the last tick, reward, terminated, truncated, info,
    was_reset), each row (K, B), info as step_physics_block_plain's
    without the NPC collision rows (hit_vehicle, hit_pedestrian).

    CUDA tensors launch the kernel of csrc/physics.cu once for all K ticks
    (counted in `step_physics_block.launches`); CPU tensors run
    `step_physics_block_plain`.  Anything else raises, and so does a
    configuration with NPCs or the shaped reward."""
    refuse_unsupported(params, "the physics kernel")
    dev = _device(world)
    if dev.type == "cpu":
        return step_physics_block_plain(world, actions, params, town, routes, draws)
    consts = consts or PhysicsConsts(params, town, routes)
    args, state, ticks = _pack(world, actions, consts, draws, BLOCK_TICK_F, BLOCK_TICK_B)
    _run(_kernel_lib().cdrl_physics_step, args, dev)
    step_physics_block.launches += int(args.n_worlds > 0)
    return _unpack_block(state, ticks, consts)


step_physics_block.launches = 0


def _host(world: WorldState, actions: torch.Tensor, params: WorldParams, town: TownDev,
          routes: RoutesDev, draws: ResetDraws, n_tick_f: int, n_tick_b: int):
    if world.x.device.type != "cpu":
        raise ValueError("the host build takes CPU tensors")
    args, state, ticks = _pack(world, actions, PhysicsConsts(params, town, routes), draws,
                               n_tick_f, n_tick_b)
    _host_lib().cdrl_physics_step_host(ctypes.byref(args))
    return state, ticks


def step_physics_host(world: WorldState, action: torch.Tensor,
                      params: WorldParams, town: TownDev, routes: RoutesDev,
                      draws: ResetDraws):
    """The kernel's arithmetic (csrc/physics.cuh) for one tick on the CPU
    through its g++ build, for the tests; same returns as
    step_physics_batch."""
    return _unpack_tick(*_host(world, action[None], params, town, routes,
                               world_mod.map_tensors(lambda d: d[None], draws),
                               len(TICK_F), len(TICK_B)))


def step_physics_block_host(world: WorldState, actions: torch.Tensor,
                            params: WorldParams, town: TownDev, routes: RoutesDev,
                            draws: ResetDraws):
    """The kernel's K-tick loop (csrc/physics.cuh step_world_ticks) on the
    CPU through its g++ build, for the tests; same returns as
    step_physics_block."""
    return _unpack_block(*_host(world, actions, params, town, routes, draws, BLOCK_TICK_F,
                                BLOCK_TICK_B))
