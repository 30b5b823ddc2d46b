"""The fused physics step: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of carla_driving_rl_agent_tpu/ops/physics_pallas.py.  One call
advances every world of a zero-NPC configuration by one tick and restarts
the worlds whose episode ended from pre-drawn reset values: it computes what
envs/world.step_world followed by the auto-reset merge of
CARLAEnv.step_physics computes, and returns the same
(world', reward, terminated, truncated, info, was_reset).

`step_physics_batch` is the entry point: on CUDA tensors it launches the
kernel of csrc/physics.cu (built with nvcc at first use, loaded with
ctypes), on CPU tensors it runs `step_physics_batch_plain`.  The kernel's
per-world arithmetic lives in csrc/physics.cuh, which csrc/physics_host.cpp
also builds with g++ (`step_physics_host`) so that the CPU tests hold the
kernel's own math against the plain version and the JAX package.

The reset draws are inputs (ResetDraws for every world, used where the
episode ended), drawn beforehand from the env's generator exactly as the
plain path draws them, so that the kernel and the plain version take
identical inputs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from carla_driving_rl_agent_torch.envs import town as town_mod
from carla_driving_rl_agent_torch.envs import world as world_mod
from carla_driving_rl_agent_torch.envs.dynamics import DT
from carla_driving_rl_agent_torch.envs.world import (
    ResetDraws, RoutesDev, TownDev, WorldParams, WorldState)

# output rows, in the order of csrc/physics.cuh's FloatOut / IntOut / BoolOut
FLOAT_OUT = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
             "sim_time", "total_reward", "collision_penalty",
             "reward", "speed", "similarity_pre", "distance_to_next_waypoint",
             "distance_to_destination", "off_road_distance", "total_reward_pre")
INT_OUT = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode")
BOOL_OUT = ("should_terminate", "terminated", "truncated", "done", "hit_other")

_F32_STATE = ("x", "y", "yaw", "v", "sim_time", "total_reward")
_I64_STATE = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode")


def step_physics_batch_plain(world: WorldState, action: torch.Tensor,
                             params: WorldParams, town: TownDev,
                             routes: RoutesDev, draws: ResetDraws):
    """The plain PyTorch version: step_world, then the worlds that ended
    restart from `draws`.  Returns (world', reward, terminated, truncated,
    info, was_reset)."""
    w, reward, term, trunc, info = world_mod.step_world(world, action, params,
                                                        town, routes)
    done = term | trunc
    fresh = world_mod.reset_world(draws, routes, episode=w.episode + 1)
    return world_mod.where_state(done, fresh, w), reward, term, trunc, info, done


class _Args(ctypes.Structure):
    """ctypes mirror of cdrl::PhysicsArgs (csrc/physics.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "y", "yaw", "v", "route_id", "wp_idx", "town_id", "weather_id",
        "timestep", "episode", "sim_time", "total_reward", "action",
        "d_town", "d_weather", "d_route", "d_sim_time",
        "route_len", "route_xyy", "route_start", "route_end", "cell_segs",
        "road_half", "out_f", "out_i", "out_b")]
        + [(n, ctypes.c_float) for n in (
            "range_throttle_lo", "range_throttle_hi", "range_brake_lo",
            "range_brake_hi", "range_steer_lo", "range_steer_hi",
            "off_road_threshold", "lane_pad", "penalty", "speed_cap",
            "over_cap", "dt", "cell_res")]
        + [(n, ctypes.c_int) for n in (
            "n_worlds", "max_timesteps", "n_actions",
            "throttle_as_desired_speed", "reverse", "n_routes",
            "route_max_len", "grid_h", "grid_w", "k_segs")])


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the worlds on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _pack(world: WorldState, action: torch.Tensor, params: WorldParams,
          town: TownDev, routes: RoutesDev, draws: ResetDraws):
    """Check every operand and lay out the kernel's arguments and outputs."""
    dev = world.x.device
    n = world.x.shape[0]
    if action.dim() != 2 or action.shape[0] != n or action.shape[1] < 2:
        raise ValueError(f"action must be ({n}, >=2), got {tuple(action.shape)}")
    a = _Args()
    for name in _F32_STATE:
        t = getattr(world, name)
        if t.shape != (n,):
            raise ValueError(f"world.{name} must be ({n},), got {tuple(t.shape)}")
        setattr(a, name, _check(t, f"world.{name}", torch.float32, dev))
    for name in _I64_STATE:
        t = getattr(world, name)
        if t.shape != (n,):
            raise ValueError(f"world.{name} must be ({n},), got {tuple(t.shape)}")
        setattr(a, name, _check(t, f"world.{name}", torch.int64, dev))
    a.action = _check(action, "action", torch.float32, dev)
    for name, field, dtype in (("d_town", "town_id", torch.int64),
                               ("d_weather", "weather_id", torch.int64),
                               ("d_route", "route_id", torch.int64),
                               ("d_sim_time", "sim_time", torch.float32)):
        t = getattr(draws, field)
        if t.shape != (n,):
            raise ValueError(f"draws.{field} must be ({n},), got {tuple(t.shape)}")
        setattr(a, name, _check(t, f"draws.{field}", dtype, dev))
    a.route_len = _check(routes.length, "routes.length", torch.int64, dev)
    a.route_xyy = _check(routes.xyy, "routes.xyy", torch.float32, dev)
    a.route_start = _check(routes.start, "routes.start", torch.float32, dev)
    a.route_end = _check(routes.end_xy, "routes.end_xy", torch.float32, dev)
    a.cell_segs = _check(town.cell_segs, "town.cell_segs", torch.float32, dev)
    a.road_half = _check(town.road_half, "town.road_half", torch.float32, dev)

    out_f = torch.empty((len(FLOAT_OUT), n), dtype=torch.float32, device=dev)
    out_i = torch.empty((len(INT_OUT), n), dtype=torch.int64, device=dev)
    out_b = torch.empty((len(BOOL_OUT), n), dtype=torch.bool, device=dev)
    a.out_f, a.out_i, a.out_b = out_f.data_ptr(), out_i.data_ptr(), out_b.data_ptr()

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
    a.n_worlds = n
    a.max_timesteps = params.max_timesteps
    a.n_actions = action.shape[1]
    a.throttle_as_desired_speed = int(params.throttle_as_desired_speed)
    a.reverse = int(action.shape[1] >= 3 and not params.disable_reverse)
    a.n_routes, a.route_max_len = routes.xyy.shape[1], routes.xyy.shape[2]
    a.grid_h, a.grid_w = town.cell_segs.shape[1], town.cell_segs.shape[2]
    a.k_segs = town.cell_segs.shape[3] // 4
    return a, (out_f, out_i, out_b)


def _unpack(outs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    out_f, out_i, out_b = outs
    f = dict(zip(FLOAT_OUT, out_f.unbind(0)))
    i = dict(zip(INT_OUT, out_i.unbind(0)))
    b = dict(zip(BOOL_OUT, out_b.unbind(0)))
    world = WorldState(
        x=f["x"], y=f["y"], yaw=f["yaw"], v=f["v"], throttle=f["throttle"],
        brake=f["brake"], steer=f["steer"], route_id=i["route_id"],
        wp_idx=i["wp_idx"], similarity=f["similarity"], town_id=i["town_id"],
        weather_id=i["weather_id"], timestep=i["timestep"],
        sim_time=f["sim_time"], episode=i["episode"],
        total_reward=f["total_reward"],
        collision_penalty=f["collision_penalty"],
        should_terminate=b["should_terminate"])
    info = dict(
        speed=f["speed"], similarity=f["similarity_pre"],
        distance_to_next_waypoint=f["distance_to_next_waypoint"],
        distance_to_destination=f["distance_to_destination"],
        reward=f["reward"], total_reward=f["total_reward_pre"],
        collision=b["hit_other"], hit_other=b["hit_other"],
        off_road_distance=f["off_road_distance"])
    return world, f["reward"], b["terminated"], b["truncated"], info, b["done"]


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


def step_physics_batch(world: WorldState, action: torch.Tensor,
                       params: WorldParams, town: TownDev, routes: RoutesDev,
                       draws: ResetDraws):
    """One tick of every world with auto-reset from `draws`; returns
    (world', reward, terminated, truncated, info, was_reset).

    CUDA tensors launch the kernel of csrc/physics.cu on the current stream
    (and count the launch in `step_physics_batch.launches`); CPU tensors run
    `step_physics_batch_plain`.  Anything else raises."""
    dev = world.x.device
    if dev.type == "cpu":
        return step_physics_batch_plain(world, action, params, town, routes, draws)
    if dev.type != "cuda":
        raise ValueError(f"step_physics_batch runs on cuda or cpu, not {dev}")
    args, outs = _pack(world, action, params, town, routes, draws)
    lib = _kernel_lib()
    if args.n_worlds > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cdrl_physics_step(ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"physics kernel launch failed: CUDA error {err}")
        step_physics_batch.launches += 1
    return _unpack(outs)


step_physics_batch.launches = 0


def step_physics_host(world: WorldState, action: torch.Tensor,
                      params: WorldParams, town: TownDev, routes: RoutesDev,
                      draws: ResetDraws):
    """The kernel's arithmetic (csrc/physics.cuh) run on the CPU through its
    g++ build, for the tests; same returns as step_physics_batch."""
    if world.x.device.type != "cpu":
        raise ValueError("step_physics_host takes CPU tensors")
    args, outs = _pack(world, action, params, town, routes, draws)
    _host_lib().cdrl_physics_step_host(ctypes.byref(args))
    return _unpack(outs)
