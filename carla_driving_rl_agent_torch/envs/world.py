"""The world core, batched over worlds: reset, physics step, observations.

Counterpart of carla_driving_rl_agent_tpu/envs/world.py.  Every function
takes (B,) tensors, one entry per world, instead of being vmapped; the NPC
fleet (envs/traffic.py) is (B, V, ...) and (B, P, ...).  A configuration
without NPCs carries none: its state's `npc` is None, and its reset and
tick skip the spawn and the NPC tick, as the JAX package skips them
statically, drawing nothing for them.

Random draws come from an explicit torch.Generator and are kept apart from
the deterministic reset and tick (`reset_draws` / `reset_world`, and the
NPC tick's `traffic.npc_step_draws` / `step_world`), so a test can hand the
JAX package's draws to the port and compare the rest exactly.

Behaviour contracts (reference file:line):
  * action space Box(-1,1,(2,)) = [throttle/brake, steer]  — core/carla_env.py:18
  * reward: -penalty on collision, else speed * similarity
    damped by max(1, (d_waypoint/2)^2)                      — core/carla_env.py:182-202
    (reward_mode "shaped": the OneCamera time-cost / waypoint /
    direction / speed-limit shaping                          — environment.py:905-923)
  * collision penalties: pedestrian penalty, vehicle penalty / 2,
    off-road penalty / off_road_penalty_divisor, all terminal — core/carla_env.py:254-269
  * terminal when destination within 2 m                    — environment.py:946-950
  * vector features (road 9 / vehicle 4 / navigation N)     — core/carla_env.py:335-382
    (with lateral_obs, N + 1: the signed lateral offset from the route)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from carla_driving_rl_agent_torch.envs import dynamics, route as route_mod, traffic
from carla_driving_rl_agent_torch.envs import town as town_mod
from carla_driving_rl_agent_torch.envs.dynamics import DT, tgather


class TownDev(NamedTuple):
    """Device-resident stacked town arrays (see town.TownBank); indices and
    counts are int64."""
    wp_xy: torch.Tensor            # (T, N, 2) lane-graph waypoints
    wp_yaw: torch.Tensor           # (T, N)
    wp_speed_limit: torch.Tensor   # (T, N)
    wp_next: torch.Tensor          # (T, N, 3) successors, -1 for none
    wp_num_next: torch.Tensor      # (T, N)
    wp_junction_id: torch.Tensor   # (T, N) junction ahead, -1 for none
    wp_dist_to_junction: torch.Tensor  # (T, N)
    wp_left: torch.Tensor          # (T, N) adjacent lanes, -1 for none
    wp_right: torch.Tensor         # (T, N)
    num_wp: torch.Tensor           # (T,)
    junction_xy: torch.Tensor      # (T, J, 2)
    junction_phase: torch.Tensor   # (T, J)
    num_junctions: torch.Tensor    # (T,)
    road_half: torch.Tensor        # (T,)
    cell_segs: torch.Tensor        # (T, GH, GW, K*4) per-cell segment endpoints
    cell_geom: torch.Tensor        # (T, GH, GW, 96) per-cell render-pack prefix
    spawn_xy: torch.Tensor         # (T, S, 2) vehicle spawn points
    spawn_yaw: torch.Tensor        # (T, S)
    spawn_wp: torch.Tensor         # (T, S) the waypoint each spawn point faces
    num_spawn: torch.Tensor        # (T,)
    # the analytic renderer's and the lidar's geometry (ops/rasterizer.py)
    edges_xy: torch.Tensor         # (T, E, 4) road centre-line segments
    num_edges: torch.Tensor        # (T,)
    buildings: torch.Tensor        # (T, NB, 5) cx, cy, half_w, half_h, height
    num_buildings: torch.Tensor    # (T,)


class RoutesDev(NamedTuple):
    """Device-resident stacked route banks (T, R, L, ...)."""
    length: torch.Tensor   # (T, R)
    xyy: torch.Tensor      # (T, R, L, 4) [x, y, yaw, 0]
    start: torch.Tensor    # (T, R, 4)    [x0, y0, yaw0, 0]
    end_xy: torch.Tensor   # (T, R, 2)    destination point
    option: torch.Tensor   # (T, R, L)    int64 RoadOption per waypoint


class WorldState(NamedTuple):
    """Per-world simulation state; every field but `npc` is a (B,) tensor.
    `npc` is the NPC fleet, None in a configuration without NPCs."""
    x: torch.Tensor
    y: torch.Tensor
    yaw: torch.Tensor
    v: torch.Tensor
    throttle: torch.Tensor
    brake: torch.Tensor
    steer: torch.Tensor
    route_id: torch.Tensor
    wp_idx: torch.Tensor
    similarity: torch.Tensor
    town_id: torch.Tensor
    weather_id: torch.Tensor
    timestep: torch.Tensor
    sim_time: torch.Tensor
    episode: torch.Tensor
    total_reward: torch.Tensor
    collision_penalty: torch.Tensor
    should_terminate: torch.Tensor
    npc: Optional[traffic.NPCState] = None


class ResetDraws(NamedTuple):
    """The random part of an episode reset, one entry per world."""
    town_id: torch.Tensor     # (B,) int64
    weather_id: torch.Tensor  # (B,) int64 index into WEATHER_PARAMS
    route_id: torch.Tensor    # (B,) int64
    sim_time: torch.Tensor    # (B,) float32 traffic-light clock offset
    npc: Optional[traffic.NPCResetDraws] = None   # the NPC spawn, None without NPCs


def map_tensors(fn: Callable, tree):
    """`fn` applied to every tensor of a (nested) NamedTuple such as
    ResetDraws or WorldState; None fields stay None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(map_tensors(fn, t) for t in tree))
    return fn(tree)


def tensors(tree) -> list:
    """The tensors of a (nested) NamedTuple in field order, None fields
    left out."""
    out = []
    map_tensors(out.append, tree)
    return out


@dataclass(frozen=True)
class WorldParams:
    """Static configuration of a world (the fields of the JAX package's
    WorldParams that the port reads)."""
    town_names: Tuple[str, ...] = ("Town03",)
    random_towns: bool = False
    num_vehicles: int = 0
    num_pedestrians: int = 0
    v_max: int = 1                      # NPC slots (static shapes)
    p_max: int = 1
    # walker crossing / running fractions (reference spawn_pedestrians,
    # env_utils.py:233-241; every reference stage leaves both at 0)
    ped_crossing: float = 0.0
    ped_running: float = 0.0
    weather_ids: Tuple[int, ...] = (0,)  # indices into weather.WEATHER_NAMES
    collision_penalty: float = 1000.0
    off_road_penalty_divisor: float = 100.0
    reward_speed_cap: float = 150.0      # km/h the reward credits at most
    speed_over_cap_penalty: float = 0.0  # reward penalty per km/h above the cap
    throttle_as_desired_speed: bool = True
    disable_reverse: bool = True
    max_timesteps: int = 512
    num_waypoints_for_feature: int = 5
    # append the signed lateral offset from the route segment to the
    # navigation feature (the JAX package's opt-in deviation: the
    # reference's observation has no lateral cue).  It widens the network's
    # navigation input, so checkpoints do not carry across this flag.
    lateral_obs: bool = False
    num_routes: int = 128
    max_route_len: int = 512
    origin_spawns: Optional[Tuple[int, ...]] = None
    range_controls: Tuple[Tuple[float, float], ...] = ((0.0, 1.0), (0.0, 1.0), (-1.0, 1.0))
    off_road_threshold: float = 5.5
    force_green_lights: bool = True
    # 'default': CARLAEnv's speed * similarity / d^2 (core/carla_env.py:182-202);
    # 'shaped': the OneCamera shaping (environment.py:905-923)
    reward_mode: str = "default"
    seed: int = 42

    def __post_init__(self):
        if self.reward_mode not in ("default", "shaped"):
            raise ValueError(f"reward_mode must be 'default' or 'shaped', "
                             f"got {self.reward_mode!r}")

    @property
    def has_npcs(self) -> bool:
        """Whether any NPC slot can be active; without, no NPC state exists."""
        return self.num_vehicles > 0 or self.num_pedestrians > 0


# Forward route window gathered per physics step: update_index's look-ahead.
UPDATE_WINDOW = 10


def build_world_data(params: WorldParams, device) -> Tuple[TownDev, RoutesDev]:
    """Host side: build the town and route banks and move them to `device`."""
    bank = town_mod.build_town_bank(list(params.town_names))

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    town = town_dev(bank, device)
    banks = [route_mod.build_route_bank(
        town_mod.get_town(name), num_routes=params.num_routes,
        max_len=params.max_route_len,
        origin_spawns=list(params.origin_spawns) if params.origin_spawns else None,
        seed=params.seed) for name in params.town_names]
    xy_s = np.stack([b.xy for b in banks])            # (T, R, L, 2)
    yaw_s = np.stack([b.yaw for b in banks])          # (T, R, L)
    len_s = np.stack([b.length for b in banks])       # (T, R)
    opt_s = np.stack([b.option for b in banks])       # (T, R, L)
    xyy = np.concatenate(
        [xy_s, yaw_s[..., None], np.zeros_like(yaw_s[..., None])],
        axis=-1).astype(np.float32)                   # (T, R, L, 4)
    end_idx = np.maximum(len_s.astype(np.int64) - 1, 0)
    end_xy = np.take_along_axis(
        xy_s, end_idx[..., None, None].repeat(2, -1), axis=2)[:, :, 0]
    routes = RoutesDev(
        length=dev(len_s.astype(np.int64)),
        xyy=dev(xyy),
        start=dev(np.ascontiguousarray(xyy[:, :, 0])),
        end_xy=dev(end_xy.astype(np.float32)),
        option=dev(opt_s.astype(np.int64)),
    )
    return town, routes


def town_dev(bank: town_mod.TownBank, device) -> TownDev:
    """The bank's tables that the world reads, on `device`."""
    def dev(a, dtype=None):
        a = np.asarray(a)
        return torch.as_tensor(a.astype(dtype) if dtype else a, device=device)

    i64 = np.int64
    return TownDev(
        wp_xy=dev(bank.wp_xy), wp_yaw=dev(bank.wp_yaw),
        wp_speed_limit=dev(bank.wp_speed_limit),
        wp_next=dev(bank.wp_next, i64), wp_num_next=dev(bank.wp_num_next, i64),
        wp_junction_id=dev(bank.wp_junction_id, i64),
        wp_dist_to_junction=dev(bank.wp_dist_to_junction),
        wp_left=dev(bank.wp_left, i64), wp_right=dev(bank.wp_right, i64),
        num_wp=dev(bank.num_wp, i64),
        junction_xy=dev(bank.junction_xy),
        junction_phase=dev(bank.junction_phase),
        num_junctions=dev(bank.num_junctions, i64),
        road_half=dev(bank.road_half),
        cell_segs=dev(bank.cell_segs),
        cell_geom=dev(bank.cell_geom),
        spawn_xy=dev(bank.spawn_xy), spawn_yaw=dev(bank.spawn_yaw),
        spawn_wp=dev(bank.spawn_wp, i64), num_spawn=dev(bank.num_spawn, i64),
        edges_xy=dev(bank.edges_xy), num_edges=dev(bank.num_edges, i64),
        buildings=dev(bank.buildings), num_buildings=dev(bank.num_buildings, i64),
    )


def reset_draws(gen: torch.Generator, n: int, params: WorldParams,
                routes: RoutesDev, town: Optional[TownDev] = None) -> ResetDraws:
    """Draw town, weather, route and light-clock offset for `n` fresh
    episodes from `gen` (which lives on the device of `routes`), then, in a
    configuration with NPCs, their spawn from the `town` tables."""
    device = routes.length.device
    n_towns = len(params.town_names)
    if params.random_towns and n_towns > 1:
        town_id = torch.randint(0, n_towns, (n,), generator=gen, device=device)
    else:
        town_id = torch.zeros(n, dtype=torch.int64, device=device)
    w_ids = torch.as_tensor(params.weather_ids, dtype=torch.int64, device=device)
    w_pick = torch.randint(0, len(params.weather_ids), (n,), generator=gen,
                           device=device)
    route_id = torch.randint(0, routes.length.shape[1], (n,), generator=gen,
                             device=device)
    sim_time = torch.rand(n, generator=gen, device=device) * traffic.LIGHT_CYCLE
    npc = (traffic.npc_reset_draws(gen, _npc_town(params, town), town_id, params.v_max,
                                   params.p_max) if params.has_npcs else None)
    return ResetDraws(town_id=town_id, weather_id=w_ids[w_pick],
                      route_id=route_id, sim_time=sim_time, npc=npc)


def _npc_town(params: WorldParams, town: Optional[TownDev]) -> TownDev:
    if town is None:
        raise ValueError(f"{params.num_vehicles} vehicles and {params.num_pedestrians} "
                         f"pedestrians: the NPC draws and spawn need the town tables")
    return town


def block_reset_draws(gen: torch.Generator, k: int, n: int, params: WorldParams,
                      routes: RoutesDev, weather_table: torch.Tensor,
                      town: Optional[TownDev] = None) -> ResetDraws:
    """The reset draws of k ticks of n worlds, (k, n) each, from one call of
    `gen` (4 x k x n uniforms in [0, 1), which pick the town, the weather,
    the route and scale the light-clock offset): the rollout block's draws,
    taken once per block on the CPU and on the card alike.  In a
    configuration with NPCs, their spawn (k, n, ...) follows from one
    further call, each (tick, world) scaled by the `town` tables of that
    row's town; without, nothing more is drawn.  `weather_table` is
    params.weather_ids as an int64 tensor on the device of `routes`, built
    once by the env."""
    u = torch.rand((4, k, n), generator=gen, device=routes.length.device)

    def pick(row: int, m: int) -> torch.Tensor:
        return torch.clamp((u[row] * m).to(torch.int64), max=m - 1)

    n_towns = len(params.town_names)
    if params.random_towns and n_towns > 1:
        town_id = pick(0, n_towns)
    else:
        town_id = torch.zeros((k, n), dtype=torch.int64, device=u.device)
    npc = None
    if params.has_npcs:
        flat = traffic.npc_reset_draws(gen, _npc_town(params, town), town_id.reshape(-1),
                                       params.v_max, params.p_max)
        npc = map_tensors(lambda t: t.reshape((k, n) + tuple(t.shape[1:])), flat)
    return ResetDraws(town_id=town_id, weather_id=weather_table[pick(1, len(weather_table))],
                      route_id=pick(2, routes.length.shape[1]),
                      sim_time=u[3] * traffic.LIGHT_CYCLE, npc=npc)


def trial_draws(seed: int, n: int, params: WorldParams, routes: RoutesDev,
                town: Optional[TownDev] = None) -> ResetDraws:
    """The reset draws of evaluation trials 0 .. n-1, trial i from its own
    stream keyed by (seed, i) (numpy's SeedSequence), as the JAX package
    folds the trial index into its reset key: trial i's town, weather,
    route, light-clock offset and, with NPCs, its NPC spawn (uniforms drawn
    after the other four, scaled by the `town` tables) do not depend on n."""
    n_towns, n_routes = len(params.town_names), routes.length.shape[1]
    rows, u_spawn, u_ped = [], [], []
    for i in range(n):
        rng = np.random.default_rng((seed, i))
        town_i = int(rng.integers(n_towns)) if params.random_towns and n_towns > 1 else 0
        weather = params.weather_ids[int(rng.integers(len(params.weather_ids)))]
        rows.append((town_i, weather, int(rng.integers(n_routes)),
                     float(rng.random()) * traffic.LIGHT_CYCLE))
        if params.has_npcs:
            u_spawn.append(rng.random(params.v_max))
            u_ped.append(rng.random((9, params.p_max)))
    town_id, weather, route, sim_time = zip(*rows)
    device = routes.length.device
    col = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    town_id = col(town_id, torch.int64)
    npc = None
    if params.has_npcs:
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        npc = traffic.npc_reset_draws_from_uniforms(
            f32(u_spawn), f32(u_ped).transpose(0, 1), _npc_town(params, town), town_id)
    return ResetDraws(town_id=town_id, weather_id=col(weather, torch.int64),
                      route_id=col(route, torch.int64), sim_time=col(sim_time, torch.float32),
                      npc=npc)


def reset_world(draws: ResetDraws, routes: RoutesDev,
                episode: torch.Tensor | int = 0, town: Optional[TownDev] = None,
                params: Optional[WorldParams] = None) -> WorldState:
    """Fresh episodes from `draws`: the ego stands at rest at the start of
    its route, and the NPCs of `draws.npc` spawn around it (reference
    environment.py:226-242,487-529); NPC draws need the `town` tables and
    the `params`, whose NPC counts they must match."""
    s_row = tgather(routes.start, draws.town_id, draws.route_id)   # (B, 4)
    n = s_row.shape[0]
    npc = None
    if params is not None and params.has_npcs != (draws.npc is not None):
        raise ValueError(f"{params.num_vehicles} vehicles and {params.num_pedestrians} "
                         f"pedestrians, but the draws hold "
                         f"{'no' if draws.npc is None else 'an'} NPC spawn")
    if draws.npc is not None:
        if params is None:
            raise ValueError("an NPC spawn needs the params")
        npc = traffic.init_npcs(draws.npc, _npc_town(params, town), draws.town_id,
                                s_row[:, :2], params.num_vehicles, params.num_pedestrians,
                                crossing=params.ped_crossing, running=params.ped_running)
    zeros = torch.zeros(n, dtype=torch.float32, device=s_row.device)
    izeros = torch.zeros(n, dtype=torch.int64, device=s_row.device)
    s_cols = s_row[:, :3].t().contiguous()                          # (3, B)
    return WorldState(
        x=s_cols[0], y=s_cols[1], yaw=s_cols[2], v=zeros,
        throttle=zeros, brake=zeros, steer=zeros,
        route_id=draws.route_id, wp_idx=izeros + 1,
        similarity=zeros + 1.0,
        town_id=draws.town_id, weather_id=draws.weather_id,
        timestep=izeros, sim_time=draws.sim_time,
        episode=izeros + torch.as_tensor(episode, device=s_row.device),
        total_reward=zeros, collision_penalty=zeros,
        should_terminate=torch.zeros(n, dtype=torch.bool, device=s_row.device),
        npc=npc,
    )


def where_state(cond: torch.Tensor, a, b):
    """Field-wise `where(cond, a, b)` over two states of one NamedTuple type
    (nested NamedTuples included), `cond` (B,) broadcast against each
    field's trailing axes."""
    out = []
    for fa, fb in zip(a, b):
        if fa is None:
            out.append(None)
        elif isinstance(fa, tuple):
            out.append(where_state(cond, fa, fb))
        else:
            c = cond.reshape(cond.shape + (1,) * (fa.dim() - 1))
            out.append(torch.where(c, fa, fb))
    return type(a)(*out)


def off_road_distance(town: TownDev, town_id, x, y) -> torch.Tensor:
    """Distance from the ego to the nearest road centerline, over the
    town's packed per-cell candidate segments."""
    gh, gw = town.cell_segs.shape[1], town.cell_segs.shape[2]
    cx = torch.clamp(dynamics.true_div(x, town_mod.CELL_RES).to(torch.int64), 0, gw - 1)
    cy = torch.clamp(dynamics.true_div(y, town_mod.CELL_RES).to(torch.int64), 0, gh - 1)
    segs = tgather(town.cell_segs, town_id, cy, cx).reshape(x.shape[0], -1, 4)
    ex = segs[..., 2] - segs[..., 0]
    ey = segs[..., 3] - segs[..., 1]
    L2 = torch.clamp(ex * ex + ey * ey, min=1e-9)
    rx = x[:, None] - segs[..., 0]
    ry = y[:, None] - segs[..., 1]
    t = torch.clamp((rx * ex + ry * ey) / L2, 0.0, 1.0)
    dx = rx - t * ex
    dy = ry - t * ey
    return torch.sqrt(torch.amin(dx * dx + dy * dy, dim=1))


def _route_window(routes: RoutesDev, town_id, route_id, wp_idx, n: int):
    """Rows [wp_idx, wp_idx + n) of each world's route, clamped at the route
    end (rows past it repeat the last waypoint), and the remaining length
    (>= 1)."""
    rem = tgather(routes.length, town_id, route_id) - wp_idx
    offs = torch.arange(n, device=wp_idx.device)
    w_ids = wp_idx[:, None] + torch.minimum(offs[None], rem[:, None] - 1)
    return routes.xyy[town_id[:, None], route_id[:, None], w_ids], rem  # (B, n, 4)


def step_world(state: WorldState, action: torch.Tensor, params: WorldParams,
               town: TownDev, routes: RoutesDev,
               npc_draws: Optional[traffic.NPCStepDraws] = None):
    """One tick of every world: the ego's bicycle step, then, with NPCs,
    the NPC tick from `npc_draws` against the ego's new pose and speed.
    Returns (state', reward, terminated, truncated, info)."""
    rc = params.range_controls
    control = dynamics.actions_to_control(
        action, state.v,
        throttle_as_desired_speed=params.throttle_as_desired_speed,
        disable_reverse=params.disable_reverse,
        range_throttle=rc[0], range_brake=rc[1], range_steer=rc[2])
    x, y, yaw, v = dynamics.step_bicycle(state.x, state.y, state.yaw, state.v,
                                         control)
    npc = state.npc
    if params.has_npcs:
        # the NPCs tick in lock-step (replaces the TrafficManager fleet)
        if npc is None or npc_draws is None:
            raise ValueError("a world with NPCs steps from its NPC state and NPC draws")
        npc = traffic.step_npcs(npc_draws, npc, town, state.town_id, state.sim_time,
                                torch.stack([x, y], dim=-1), v)

    # route following over a forward window (navigation/route.py:33-53)
    w_row, rem = _route_window(routes, state.town_id, state.route_id,
                               state.wp_idx, UPDATE_WINDOW)
    w_xy = w_row[..., :2]
    pos = torch.stack([x, y], dim=-1)
    local_idx = route_mod.update_index(w_xy, rem, pos)
    wp_idx = state.wp_idx + local_idx
    nxt = w_row[torch.arange(x.shape[0], device=x.device), local_idx]   # (B, 4)
    similarity = torch.cos(yaw - nxt[:, 2])
    d_next = route_mod.distance(nxt[:, :2], pos)
    end_xy = tgather(routes.end_xy, state.town_id, state.route_id)
    d_dest = route_mod.distance(end_xy, pos)

    # collisions (core/carla_env.py:254-269): NPC vehicles and pedestrians,
    # and static obstacles past the off-road threshold, which widens with
    # the road band
    off_road = off_road_distance(town, state.town_id, x, y)
    off_road_thr = (params.off_road_threshold
                    + (tgather(town.road_half, state.town_id)
                       - (town_mod.LANE_WIDTH + 0.3)))
    hit_other = off_road > off_road_thr
    pen = params.collision_penalty
    zero = torch.zeros_like(x)
    if npc is None:
        collision_penalty = torch.where(
            hit_other, zero + pen / params.off_road_penalty_divisor, zero)
        should_terminate = hit_other
        hit_veh = hit_ped = torch.zeros_like(hit_other)
    else:
        hit_veh, hit_ped = traffic.collision_check(pos, yaw, npc)
        collision_penalty = (torch.where(hit_ped, pen, 0.0)
                             + torch.where(hit_veh, pen / 2.0, 0.0)
                             + torch.where(hit_other, pen / params.off_road_penalty_divisor,
                                           0.0))
        should_terminate = hit_veh | hit_ped | hit_other

    spd_kmh = dynamics.speed_kmh(v)
    if params.reward_mode == "shaped":
        # the OneCamera shaping (reference environment.py:905-923): a time
        # cost, the collision, a waypoint term, a direction term and the
        # speed limit
        speed_c = torch.clamp(spd_kmh, max=params.reward_speed_cap)
        direction = torch.where((similarity >= 0.75) & (similarity <= 1.0),
                                speed_c * similarity,
                                (speed_c + 1.0) * torch.abs(similarity) * -2.0)
        wp_term = torch.clamp(d_next, max=100.0)
        wp_term = torch.where(wp_term <= 5.0, -wp_term, wp_term * -3.0)
        limit = _speed_limit(town, state.town_id)
        speed_pen = torch.where(spd_kmh > limit, 2.0 * (limit - spd_kmh), 0.0)
        reward = -1.0 - collision_penalty + wp_term + direction + speed_pen
    else:
        # default CARLAEnv reward (core/carla_env.py:182-202)
        r_drive = torch.clamp(spd_kmh, max=params.reward_speed_cap) * similarity
        damp = torch.clamp((d_next / 2.0) ** 2, min=1.0)
        r_drive = torch.where(r_drive != 0.0, r_drive / damp, r_drive)
        reward = torch.where(collision_penalty > 0.0, -collision_penalty, r_drive)
    if params.speed_over_cap_penalty:
        reward = reward - params.speed_over_cap_penalty * torch.clamp(
            spd_kmh - params.reward_speed_cap, min=0.0)

    arrived = d_dest <= 2.0
    terminated = should_terminate | arrived
    timestep = state.timestep + 1
    truncated = (timestep >= params.max_timesteps) & ~terminated

    new_state = WorldState(
        x=x, y=y, yaw=yaw, v=v,
        throttle=control.throttle, brake=control.brake, steer=control.steer,
        route_id=state.route_id, wp_idx=wp_idx, similarity=similarity,
        town_id=state.town_id, weather_id=state.weather_id,
        timestep=timestep, sim_time=state.sim_time + DT,
        episode=state.episode,
        total_reward=state.total_reward + reward,
        collision_penalty=collision_penalty, should_terminate=should_terminate,
        npc=npc,
    )
    info = dict(
        speed=spd_kmh, similarity=similarity, distance_to_next_waypoint=d_next,
        distance_to_destination=d_dest, reward=reward,
        total_reward=new_state.total_reward, collision=should_terminate,
        hit_vehicle=hit_veh, hit_pedestrian=hit_ped, hit_other=hit_other,
        off_road_distance=off_road,
    )
    return new_state, reward, terminated, truncated, info


def _speed_limit(town: TownDev, town_id) -> torch.Tensor:
    return tgather(town.wp_speed_limit, town_id, torch.zeros_like(town_id))


# ------------------------------------------------------------------
# Vector observation features (core/carla_env.py:335-382)
# ------------------------------------------------------------------

def road_features(state: WorldState, params: WorldParams, town: TownDev) -> torch.Tensor:
    """(B, 9): [is_intersection, is_junction, is_at_traffic_light,
    speed_limit/100, one-hot light state (5)]."""
    pos = torch.stack([state.x, state.y], dim=-1)
    j_xy = tgather(town.junction_xy, state.town_id)               # (B, J, 2)
    n_j = tgather(town.num_junctions, state.town_id)
    d_j = route_mod.distance(j_xy, pos[:, None])
    ar = torch.arange(j_xy.shape[1], device=pos.device)
    d_j = torch.where(ar[None] < n_j[:, None], d_j, torch.full_like(d_j, 1e9))
    jid = torch.argmin(d_j, dim=1)
    d_min = torch.gather(d_j, 1, jid[:, None])[:, 0]
    is_junction = (d_min < town_mod.JUNCTION_RADIUS).to(torch.float32)

    if params.force_green_lights:
        # training hack: the ego's light is forced green (reference environment.py:420-424)
        light_state = torch.full_like(jid, traffic.LIGHT_GREEN)
    else:
        light_state = traffic.light_phase_state(
            state.sim_time, tgather(town.junction_phase, state.town_id, jid),
            state.yaw)
    approaching = (d_min < 14.0) & (d_min > town_mod.JUNCTION_RADIUS * 0.5)
    is_at_light = (approaching & (light_state == traffic.LIGHT_RED)).to(torch.float32)
    light_for_onehot = torch.where(approaching, light_state,
                                   torch.full_like(light_state, traffic.LIGHT_UNKNOWN))
    light_onehot = torch.nn.functional.one_hot(light_for_onehot, 5).to(torch.float32)
    speed_limit = _speed_limit(town, state.town_id) / 100.0
    return torch.cat([torch.stack([is_junction, is_junction, is_at_light,
                                   speed_limit], dim=-1), light_onehot], dim=-1)


def vehicle_features(state: WorldState) -> torch.Tensor:
    """(B, 4): [similarity, speed/100, throttle, brake]."""
    return torch.stack([state.similarity, dynamics.speed_kmh(state.v) / 100.0,
                        state.throttle, state.brake], dim=-1)


def navigation_features(state: WorldState, params: WorldParams,
                        routes: RoutesDev) -> torch.Tensor:
    """(B, N): distances to the next N route waypoints / N; with
    lateral_obs (B, N + 1), the last the signed lateral offset from the
    current route segment (w0 -> w1), positive to the LEFT of the direction
    of travel, over a 3 m half-road scale and clipped to [-3, 3]."""
    amount = params.num_waypoints_for_feature
    w_row, rem = _route_window(routes, state.town_id, state.route_id,
                               state.wp_idx, amount)
    pos = torch.stack([state.x, state.y], dim=-1)
    w_xy = w_row[..., :2]
    dists = route_mod.next_waypoint_distances(w_xy, pos)
    if not params.lateral_obs:
        return dists
    d = w_xy[:, 1] - w_xy[:, 0]
    rel = pos - w_xy[:, 0]
    cross = d[:, 0] * rel[:, 1] - d[:, 1] * rel[:, 0]
    lat = cross / torch.clamp(torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]), min=1e-6)
    lat = torch.clamp(dynamics.true_div(lat, 3.0), -3.0, 3.0)
    return torch.cat([dists, lat[:, None]], dim=-1)


def nav_feature_dim(params: WorldParams) -> int:
    """The length of the navigation feature."""
    return params.num_waypoints_for_feature + (1 if params.lateral_obs else 0)


def vector_observation(state: WorldState, params: WorldParams, town: TownDev,
                       routes: RoutesDev) -> dict:
    obs = dict(road=road_features(state, params, town),
               vehicle=vehicle_features(state),
               navigation=navigation_features(state, params, routes))
    # NaN scrubbing (reference env_utils.py:433-439)
    return {k: torch.nan_to_num(v) for k, v in obs.items()}
