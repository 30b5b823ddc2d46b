"""NPC traffic, batched over worlds: waypoint-following vehicles and
goal-walking pedestrians, and the traffic-light phases.

Counterpart of carla_driving_rl_agent_tpu/envs/traffic.py.  Every field is
(B, V, ...) for vehicles or (B, P, ...) for pedestrians, one row per world,
instead of being vmapped.  The vehicle controller (reference
navigation/behavior_agent.py:331-432): pure-pursuit steering toward the
next waypoint, speed tracking of the lane's limit, time-to-collision
car-following behind the nearest actor in a forward cone, lane changes to
overtake or to yield to a tailgater, and red-light stops.  Pedestrians walk
straight to a sidewalk goal and draw a new one when they reach it.

The random part is kept apart from the computation, as for resets
(envs/world.py): `NPCResetDraws` for a spawn and `NPCStepDraws` for a
tick, drawn by `npc_reset_draws` / `npc_step_draws` from a torch.Generator,
or handed over by a test from the JAX package's own draws.  Integer draws
are held as indices (what JAX's randint returns), sides as signs.

CARLA's TrafficLightState encoding is kept: Red=0, Yellow=1, Green=2,
Off=3, Unknown=4 (reference tools/utils.py:90-132).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from carla_driving_rl_agent_torch.envs.dynamics import DT, MS_TO_KMH, true_div
from carla_driving_rl_agent_torch.utils.profiling import span

LIGHT_CYCLE = 24.0
GREEN_TIME = 10.0
YELLOW_TIME = 2.0

LIGHT_RED, LIGHT_YELLOW, LIGHT_GREEN, LIGHT_OFF, LIGHT_UNKNOWN = range(5)

VEHICLE_RADIUS = 1.1      # collision disc radius (two discs per vehicle)
VEHICLE_HALF_LEN = 1.4    # disc centres at +-half_len along the heading
PED_RADIUS = 0.35
PED_SPEED_MIN, PED_SPEED_MAX = 0.8, 1.8
# CARLA walker blueprint run speeds (reference env_utils.py:270-276)
PED_RUN_MIN, PED_RUN_MAX = 2.5, 3.5

# car following, reference navigation/types_behavior.py:19-28 ('Normal')
SAFETY_TIME = 3.0          # s
SPEED_DECREASE = 10.0      # km/h below the lead when too close
MIN_FOLLOW_SPEED = 5.0     # km/h floor when matching the lead
BRAKING_DISTANCE = 5.0     # m, emergency stop band (behavior_agent.py:392-404)
MIN_EGO_DISTANCE = 20.0    # m, no vehicle spawns closer to the ego
BRANCHES = 3               # successor branches a vehicle draws from at a lane end


class NPCState(NamedTuple):
    veh_xy: torch.Tensor      # (B, V, 2)
    veh_yaw: torch.Tensor     # (B, V)
    veh_v: torch.Tensor       # (B, V)
    veh_wp: torch.Tensor      # (B, V) int64 target waypoint in the town graph
    veh_active: torch.Tensor  # (B, V) float mask
    ped_xy: torch.Tensor      # (B, P, 2)
    ped_goal: torch.Tensor    # (B, P, 2)
    ped_speed: torch.Tensor   # (B, P)
    ped_active: torch.Tensor  # (B, P)
    # 1.0 where the walker may take goals on the opposite sidewalk
    # (reference set_pedestrians_cross_factor, env_utils.py:326)
    ped_cross: torch.Tensor   # (B, P)


class GoalDraws(NamedTuple):
    """The random part of a sidewalk goal per walker, (B, P) each."""
    wp: torch.Tensor       # int64 waypoint index, < the world's town's num_wp
    side: torch.Tensor     # float32 sign (+-1) of the sidewalk side
    offset: torch.Tensor   # float32 uniform in [0, 1): 4 + 3u metres off the lane


class NPCResetDraws(NamedTuple):
    """The random part of an NPC spawn (JAX init_npcs' keys k1..k7)."""
    spawn: torch.Tensor    # (B, V) int64 spawn-point index, < the town's num_spawn
    ped_wp: torch.Tensor   # (B, P) int64 waypoint each walker starts beside
    ped_side: torch.Tensor  # (B, P) float32 sign of its sidewalk side
    ped_offset: torch.Tensor  # (B, P) uniform: 4.5 + 1.5u metres off the lane
    cross: torch.Tensor    # (B, P) uniform, < crossing: may cross the road
    goal: GoalDraws        # the first goal
    walk: torch.Tensor     # (B, P) uniform of the walk speed
    run: torch.Tensor      # (B, P) uniform, < running: runs; also its run speed


class NPCStepDraws(NamedTuple):
    """The random part of one NPC tick (JAX step_npcs' two keys)."""
    branch: torch.Tensor   # (B, V) int64 successor branch in [0, 3)
    goal: GoalDraws        # a new goal for each walker that reaches its own


def light_phase_state(sim_time: torch.Tensor, phase_offset: torch.Tensor,
                      approach_yaw: torch.Tensor) -> torch.Tensor:
    """Traffic-light state for a junction approach direction: each junction
    runs a fixed 24 s two-phase cycle, EW first, NS half a cycle later."""
    t = torch.remainder(sim_time + phase_offset, LIGHT_CYCLE)
    is_ew = torch.abs(torch.cos(approach_yaw)) >= torch.abs(torch.sin(approach_yaw))
    t_local = torch.where(is_ew, t,
                          torch.remainder(t + LIGHT_CYCLE / 2.0, LIGHT_CYCLE))
    state = torch.where(t_local < GREEN_TIME, LIGHT_GREEN,
                        torch.where(t_local < GREEN_TIME + YELLOW_TIME,
                                    LIGHT_YELLOW, LIGHT_RED))
    return state.to(torch.int64)


def ttc_target_speed(own_v_ms, lead_v_ms, lead_d, cruise_kmh,
                     speed_decrease_kmh: float = SPEED_DECREASE,
                     safety_time: float = SAFETY_TIME,
                     braking_distance: float = BRAKING_DISTANCE):
    """Time-to-collision banded car-following target speed in km/h
    (reference behavior_agent.py:331-361): under `safety_time` slow below
    the lead, within twice that follow the lead, else cruise; stop inside
    `braking_distance`.  Speeds in m/s; the closing speed is floored at
    1 m/s so that the TTC stays finite."""
    lead_kmh = lead_v_ms * MS_TO_KMH
    delta_v = torch.clamp(own_v_ms - lead_v_ms, min=1.0)
    ttc = lead_d / delta_v
    slow = torch.clamp(lead_kmh - speed_decrease_kmh, min=0.0)
    follow = torch.clamp(lead_kmh, min=MIN_FOLLOW_SPEED)
    target = torch.where(ttc < safety_time, torch.minimum(slow, cruise_kmh),
                         torch.where(ttc < 2.0 * safety_time,
                                     torch.minimum(follow, cruise_kmh), cruise_kmh))
    return torch.where(lead_d < braking_distance, torch.zeros_like(target), target)


def _norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of 2, as sqrt(dx^2 + dy^2)."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _unit(yaw: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(yaw), torch.sin(yaw)], dim=-1)


def _rows(arr: torch.Tensor, town_id: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """arr[town_id, idx...] for (B, K) indices: each world's rows of a
    (towns, N, ...) bank table."""
    return arr[(town_id[:, None],) + idx]


def _uniform_index(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) -> indices in [0, n) per row, n (B,) >= 1."""
    n = n[:, None]
    return torch.minimum((u * n).to(torch.int64), n - 1)


def _sign(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u < 0.5, -1.0, 1.0)


def _goal_draws(u: torch.Tensor, n_wp: torch.Tensor) -> GoalDraws:
    return GoalDraws(wp=_uniform_index(u[0], n_wp), side=_sign(u[1]), offset=u[2])


def _counts(town, town_id: torch.Tensor, name: str) -> torch.Tensor:
    return torch.clamp(getattr(town, name)[town_id], min=1)


def npc_reset_draws(gen: torch.Generator, town, town_id: torch.Tensor,
                    v_max: int, p_max: int) -> NPCResetDraws:
    """The spawn draws of len(town_id) worlds from one call of `gen` (on
    the device of the town's tables): uniforms scaled by each world's
    num_spawn / num_wp."""
    n = town_id.shape[0]
    u_v = torch.rand((n, v_max + 9 * p_max), generator=gen, device=town_id.device)
    return npc_reset_draws_from_uniforms(u_v[:, :v_max],
                                         u_v[:, v_max:].reshape(n, 9, p_max).transpose(0, 1),
                                         town, town_id)


def npc_reset_draws_from_uniforms(u_spawn: torch.Tensor, u_ped: torch.Tensor, town,
                                  town_id: torch.Tensor) -> NPCResetDraws:
    """NPCResetDraws from (B, V) and (9, B, P) uniforms in [0, 1): spawn;
    then per walker its waypoint, side, offset, cross, goal waypoint, goal
    side, goal offset, walk and run."""
    n_wp = _counts(town, town_id, "num_wp")
    return NPCResetDraws(
        spawn=_uniform_index(u_spawn, _counts(town, town_id, "num_spawn")),
        ped_wp=_uniform_index(u_ped[0], n_wp), ped_side=_sign(u_ped[1]),
        ped_offset=u_ped[2], cross=u_ped[3], goal=_goal_draws(u_ped[4:7], n_wp),
        walk=u_ped[7], run=u_ped[8])


def npc_step_draws(gen: torch.Generator, town, town_id: torch.Tensor,
                   v_max: int, p_max: int) -> NPCStepDraws:
    """One tick's draws of len(town_id) worlds from one call of `gen`."""
    n = town_id.shape[0]
    u = torch.rand((n, v_max + 3 * p_max), generator=gen, device=town_id.device)
    return step_draws_from_uniforms(u, town, town_id, v_max, p_max)


def block_npc_step_uniforms(gen: torch.Generator, k: int, n: int, v_max: int, p_max: int,
                            device) -> torch.Tensor:
    """The uniforms of k NPC ticks of n worlds from one call of `gen`,
    (k, n, V + 3P): a rollout block's NPC ticks before they are scaled.
    Tick i's row becomes that tick's draws by step_draws_from_uniforms with
    the towns the worlds hold at tick i (a world that restarts mid-block in
    another town draws its goals on its new town's waypoints, as JAX's
    per-tick keys do)."""
    return torch.rand((k, n, v_max + 3 * p_max), generator=gen, device=device)


def block_npc_step_draws(gen: torch.Generator, town, town_id: torch.Tensor, k: int,
                         v_max: int, p_max: int) -> NPCStepDraws:
    """The draws of k ticks of len(town_id) worlds from one call of `gen`,
    (k, B, V) and (k, B, P): block_npc_step_uniforms, each world's goal
    waypoints scaled by the num_wp of its town `town_id` (B,) for every
    tick, as npc_step_draws scales one tick.  Tick i's draws are
    world.map_tensors(lambda d: d[i], draws)."""
    n = town_id.shape[0]
    u = block_npc_step_uniforms(gen, k, n, v_max, p_max, town_id.device)
    draws = step_draws_from_uniforms(u.reshape(k * n, -1), town, town_id.repeat(k),
                                     v_max, p_max)
    rows = lambda t: t.reshape((k, n) + tuple(t.shape[1:]))  # noqa: E731
    return NPCStepDraws(branch=rows(draws.branch), goal=GoalDraws(*map(rows, draws.goal)))


def step_draws_from_uniforms(u: torch.Tensor, town, town_id: torch.Tensor, v_max: int,
                              p_max: int) -> NPCStepDraws:
    """NPCStepDraws of B worlds from (B, V + 3P) uniforms in [0, 1): each
    vehicle's branch, then each walker's goal waypoint, side and offset."""
    n = town_id.shape[0]
    branch = torch.clamp((u[:, :v_max] * BRANCHES).to(torch.int64), max=BRANCHES - 1)
    goal = _goal_draws(u[:, v_max:].reshape(n, 3, p_max).transpose(0, 1),
                       _counts(town, town_id, "num_wp"))
    return NPCStepDraws(branch=branch, goal=goal)


def sample_ped_goals(draws: GoalDraws, town, town_id: torch.Tensor,
                     ped_xy: torch.Tensor, can_cross: torch.Tensor) -> torch.Tensor:
    """(B, P, 2) sidewalk goals: beside the drawn waypoint, on the drawn
    side for walkers that may cross, else on the side of that waypoint they
    stand on now (reference WalkerAIController with
    set_pedestrians_cross_factor, env_utils.py:326)."""
    wxy = _rows(town.wp_xy, town_id, draws.wp)
    normal = _unit(_rows(town.wp_yaw, town_id, draws.wp))
    normal = torch.stack([-normal[..., 1], normal[..., 0]], dim=-1)
    cur_side = torch.sign(_dot(ped_xy - wxy, normal))
    cur_side = torch.where(cur_side == 0.0, draws.side, cur_side)
    side = torch.where(can_cross > 0, draws.side, cur_side)
    offset = 4.0 + draws.offset * 3.0
    return wxy + side[..., None] * offset[..., None] * normal


def init_npcs(draws: NPCResetDraws, town, town_id: torch.Tensor, ego_xy: torch.Tensor,
              num_vehicles: int, num_pedestrians: int,
              crossing: float = 0.0, running: float = 0.0) -> NPCState:
    """Spawn the NPCs of B worlds (reference env_utils.py:195-336): vehicles
    at the drawn spawn points, the first `num_vehicles` slots only, none
    within MIN_EGO_DISTANCE of the ego (B, 2) and none on a spawn point an
    earlier slot took; walkers beside the drawn waypoints, the first
    `num_pedestrians` slots active.  A `crossing` fraction of walkers may
    take goals across the road, a `running` fraction runs at 2.5-3.5 m/s
    instead of walking at 0.8-1.8 m/s (the run speed reuses the draw that
    decides running, as the JAX package does)."""
    with span("npc.spawn"):
        s_idx = draws.spawn
        v_max = s_idx.shape[1]
        sxy = _rows(town.spawn_xy, town_id, s_idx)
        far = _norm(sxy - ego_xy[:, None]) > MIN_EGO_DISTANCE
        slot = torch.arange(v_max, device=s_idx.device)
        same = ((s_idx[:, :, None] == s_idx[:, None, :])
                & (slot[:, None] > slot[None, :])[None])
        slot_on = (slot < num_vehicles)[None] & far & ~torch.any(same, dim=2)

        wxy = _rows(town.wp_xy, town_id, draws.ped_wp)
        normal = _unit(_rows(town.wp_yaw, town_id, draws.ped_wp))
        normal = torch.stack([-normal[..., 1], normal[..., 0]], dim=-1)
        offset = 4.5 + draws.ped_offset * 1.5
        pxy = wxy + draws.ped_side[..., None] * offset[..., None] * normal
        p_max = pxy.shape[1]
        ped_on = (torch.arange(p_max, device=pxy.device) < num_pedestrians)[None]
        can_cross = (draws.cross < crossing).to(torch.float32)
        walk = PED_SPEED_MIN + draws.walk * (PED_SPEED_MAX - PED_SPEED_MIN)
        run = PED_RUN_MIN + draws.run * (PED_RUN_MAX - PED_RUN_MIN)
        zeros_v = torch.zeros(s_idx.shape, dtype=torch.float32, device=s_idx.device)
        return NPCState(
            veh_xy=sxy, veh_yaw=_rows(town.spawn_yaw, town_id, s_idx), veh_v=zeros_v,
            veh_wp=_rows(town.spawn_wp, town_id, s_idx),
            veh_active=slot_on.to(torch.float32),
            ped_xy=pxy, ped_goal=sample_ped_goals(draws.goal, town, town_id, pxy, can_cross),
            ped_speed=torch.where(draws.run < running, run, walk),
            ped_active=ped_on.expand(pxy.shape[:2]).to(torch.float32),
            ped_cross=can_cross)


def _nearest_in_cone(d_all: torch.Tensor, proj: torch.Tensor, active: torch.Tensor,
                     all_v: torch.Tensor):
    """Distance to and speed of the nearest active actor in a 0.85 cone
    (cos) along `proj` (B, V, A), or 1e6 and 0 where there is none; the
    first actor on a tie, as argmin takes it."""
    cos_ang = proj / torch.clamp(d_all, min=1e-3)
    in_cone = (proj > 0.0) & (cos_ang > 0.85) & (d_all > 0.1)
    masked = torch.where(in_cone & (active[:, None, :] > 0), d_all,
                         torch.full_like(d_all, 1e6))
    idx = torch.argmin(masked, dim=2)
    d = torch.gather(masked, 2, idx[..., None])[..., 0]
    v = torch.gather(all_v, 1, idx)
    return d, torch.where(d < 1e5, v, torch.zeros_like(v))


def step_npcs(draws: NPCStepDraws, npc: NPCState, town, town_id: torch.Tensor,
              sim_time: torch.Tensor, ego_xy: torch.Tensor, ego_v: torch.Tensor,
              speed_factor: float = 0.8) -> NPCState:
    """Advance the NPCs of B worlds one tick; the ego's pose (B, 2) and
    speed (B,) are those after its own step."""
    with span("npc.tick"):
        n_veh = npc.veh_xy.shape[1]
        # ---- vehicles: advance the target waypoint when close, taking the
        # drawn successor branch at a lane end
        target = _rows(town.wp_xy, town_id, npc.veh_wp)
        dist_t = _norm(target - npc.veh_xy)
        n_next = _rows(town.wp_num_next, town_id, npc.veh_wp)
        branch = torch.minimum(draws.branch, torch.clamp(n_next - 1, min=0))
        nxt = _rows(town.wp_next, town_id, npc.veh_wp, branch)
        nxt = torch.where(nxt < 0, _rows(town.wp_next, town_id, npc.veh_wp,
                                         torch.zeros_like(branch)), nxt)
        nxt = torch.where(nxt < 0, npc.veh_wp, nxt)
        new_wp = torch.where(dist_t < 2.5, nxt, npc.veh_wp)

        # the nearest actor (vehicles, the ego, walkers) in the forward and the
        # backward cone, with its speed
        fwd = _unit(npc.veh_yaw)
        all_xy = torch.cat([npc.veh_xy, ego_xy[:, None], npc.ped_xy], dim=1)
        ones = torch.ones_like(ego_v)[:, None]
        all_active = torch.cat([npc.veh_active, ones, npc.ped_active], dim=1)
        all_v = torch.cat([npc.veh_v, ego_v[:, None], torch.zeros_like(npc.ped_active)], dim=1)
        rel = all_xy[:, None] - npc.veh_xy[:, :, None]              # (B, V, A, 2)
        d_all = _norm(rel)
        proj = _dot(rel, fwd[:, :, None])
        d_hazard, lead_v = _nearest_in_cone(d_all, proj, all_active, all_v)
        d_back, back_v = _nearest_in_cone(d_all, -proj, all_active, all_v)

        # lane changes (TrafficManager-style; reference behavior_agent.py:189-256):
        # a blocked vehicle hops to the left lane if it is clear, else to the
        # right; a vehicle with a faster one close behind yields to the right
        limit_kmh = _rows(town.wp_speed_limit, town_id, new_wp) * speed_factor
        blocked = (d_hazard < 18.0) & (lead_v < 0.5 * npc.veh_v + 1.0)
        tailgated = (d_back < 12.0) & (back_v > npc.veh_v + 1.0)
        a_idx = torch.arange(all_xy.shape[1], device=all_xy.device)
        others = ((all_active[:, None, :] > 0)
                  & (a_idx[None, :] != torch.arange(n_veh, device=all_xy.device)[:, None])[None])

        def clear(cand_wp):
            cand_xy = _rows(town.wp_xy, town_id, torch.clamp(cand_wp, min=0))
            d_cand = _norm(all_xy[:, None] - cand_xy[:, :, None])
            d_cand = torch.where(others, d_cand, torch.full_like(d_cand, 1e6))
            return torch.amin(d_cand, dim=2) > 8.0

        wp_l = _rows(town.wp_left, town_id, new_wp)
        wp_r = _rows(town.wp_right, town_id, new_wp)
        go_left = blocked & (wp_l >= 0) & clear(wp_l)
        go_right = (blocked | tailgated) & ~go_left & (wp_r >= 0) & clear(wp_r)
        new_wp = torch.where(go_left, wp_l, torch.where(go_right, wp_r, new_wp))

        to_t = _rows(town.wp_xy, town_id, new_wp) - npc.veh_xy
        desired_yaw = torch.atan2(to_t[..., 1], to_t[..., 0])
        yaw_err = torch.atan2(torch.sin(desired_yaw - npc.veh_yaw),
                              torch.cos(desired_yaw - npc.veh_yaw))

        # red lights: stop 3-14 m before a junction whose light is not green
        my_jid = _rows(town.wp_junction_id, town_id, new_wp)
        my_dj = _rows(town.wp_dist_to_junction, town_id, new_wp)
        phase = _rows(town.junction_phase, town_id, torch.clamp(my_jid, min=0))
        light = light_phase_state(sim_time[:, None], phase, npc.veh_yaw)
        at_red = (my_jid >= 0) & (my_dj < 14.0) & (my_dj > 3.0) & (light != LIGHT_GREEN)

        target_kmh = ttc_target_speed(npc.veh_v, lead_v, d_hazard, limit_kmh)
        target_speed = true_div(target_kmh, MS_TO_KMH)
        target_speed = torch.where(at_red, torch.zeros_like(target_speed),
                                   torch.clamp(target_speed, min=0.0))
        accel = torch.clamp(true_div(target_speed - npc.veh_v, DT), -8.0, 3.0)
        v_new = torch.clamp(npc.veh_v + accel * DT, min=0.0)
        yaw_rate = (torch.clamp(2.2 * yaw_err, -1.6, 1.6)
                    * torch.clamp(true_div(v_new, 3.0), max=1.0))
        yaw_new = npc.veh_yaw + yaw_rate * DT
        yaw_new = torch.atan2(torch.sin(yaw_new), torch.cos(yaw_new))
        xy_new = npc.veh_xy + v_new[..., None] * _unit(yaw_new) * DT

        act = npc.veh_active > 0
        # ---- pedestrians: walk toward the goal; a new goal once within 1 m
        to_goal = npc.ped_goal - npc.ped_xy
        d_goal = _norm(to_goal)
        dir_goal = to_goal / torch.clamp(d_goal[..., None], min=1e-3)
        ped_xy_new = npc.ped_xy + dir_goal * npc.ped_speed[..., None] * DT
        new_goals = sample_ped_goals(draws.goal, town, town_id, npc.ped_xy, npc.ped_cross)
        return npc._replace(
            veh_xy=torch.where(act[..., None], xy_new, npc.veh_xy),
            veh_yaw=torch.where(act, yaw_new, npc.veh_yaw),
            veh_v=torch.where(act, v_new, npc.veh_v), veh_wp=new_wp,
            ped_xy=torch.where(npc.ped_active[..., None] > 0, ped_xy_new, npc.ped_xy),
            ped_goal=torch.where((d_goal < 1.0)[..., None], new_goals, npc.ped_goal))


def collision_check(ego_xy: torch.Tensor, ego_yaw: torch.Tensor, npc: NPCState):
    """(hit_vehicle, hit_pedestrian) (B,) flags of the ego (two discs along
    its heading) against the active NPC vehicles (two discs each) and
    walkers (reference collision typing, core/carla_env.py:254-269; the
    third type, hitting a static obstacle, is the world's off-road test)."""
    fwd = _unit(ego_yaw)
    ego_discs = torch.stack([ego_xy + VEHICLE_HALF_LEN * fwd,
                             ego_xy - VEHICLE_HALF_LEN * fwd], dim=1)       # (B, 2, 2)
    vfwd = _unit(npc.veh_yaw)
    veh_discs = torch.stack([npc.veh_xy + VEHICLE_HALF_LEN * vfwd,
                             npc.veh_xy - VEHICLE_HALF_LEN * vfwd], dim=2)  # (B, V, 2, 2)
    d_veh = _norm(ego_discs[:, None, :, None] - veh_discs[:, :, None])     # (B, V, 2, 2)
    hit_vehicle = torch.any(((d_veh < 2 * VEHICLE_RADIUS)
                             & (npc.veh_active[..., None, None] > 0)).flatten(1), dim=1)
    d_ped = _norm(ego_discs[:, None] - npc.ped_xy[:, :, None])              # (B, P, 2)
    hit_ped = torch.any(((d_ped < VEHICLE_RADIUS + PED_RADIUS)
                         & (npc.ped_active[..., None] > 0)).flatten(1), dim=1)
    return hit_vehicle, hit_ped
