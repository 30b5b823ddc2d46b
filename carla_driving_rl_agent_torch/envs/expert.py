"""The privileged expert autopilot, batched over worlds.

Counterpart of carla_driving_rl_agent_tpu/envs/expert.py (the reference's
BehaviorAgent, navigation/behavior_agent.py:363-432, with its LocalPlanner
and VehiclePIDController, navigation/controller.py:15-214): pure-pursuit
steering toward a route waypoint LOOKAHEAD ahead, slewed against the
previous steering and capped; a desired speed from the town's limit times
the behaviour's speed factor, lowered by the nearest actor in a forward
cone (a proportional ramp and the TTC car-following band of
traffic.ttc_target_speed), by a red light unless ignored, near junctions
and in sharp turns; the commanded speed change capped at the PID's throttle
and brake limits.  The action is in the env's [-1, 1]^2 space with the
throttle-as-desired-speed encoding (a0 = 2 * desired_kmh / 100 - 1).

The JAX package vmaps one world; here every field is (B,) and a behaviour
profile is four (B,) tensors, so that worlds may drive with different
behaviours (behaviour_profiles).  The JAX package's quirks are kept: the
speed limit is read at waypoint 0 of the town, the hazard is the first of
equal masked distances (argmin), and the junction slow-down reads every
junction row of the town table, padding included.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from carla_driving_rl_agent_torch.envs import traffic
from carla_driving_rl_agent_torch.envs.dynamics import tgather, true_div
from carla_driving_rl_agent_torch.envs.world import RoutesDev, TownDev, WorldParams, WorldState

# the reference profiles (navigation/types_behavior.py:7-40); speed_decrease
# is km/h under the lead in the TTC band
BEHAVIORS = dict(
    cautious=dict(speed_factor=0.6, hazard_distance=24.0, brake_gain=1.4,
                  speed_decrease=12.0),
    normal=dict(speed_factor=0.8, hazard_distance=18.0, brake_gain=1.0,
                speed_decrease=10.0),
    aggressive=dict(speed_factor=1.0, hazard_distance=12.0, brake_gain=0.8,
                    speed_decrease=8.0),
)
BEHAVIOR_ORDER = ("cautious", "normal", "aggressive")

STEER_GAIN = 1.8
STEER_CAP = 0.8          # reference controller.py:22 max_steering
STEER_SLEW = 0.1         # reference controller.py:72-75, per step
MAX_THROTTLE = 0.75      # reference controller.py:22
MAX_BRAKE = 0.3          # reference controller.py:22
LOOKAHEAD = 3            # route waypoints ahead of the steering target

_PROFILE_KEYS = ("speed_factor", "hazard_distance", "brake_gain", "speed_decrease")


def behaviour_profiles(behaviour_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-world profiles: each field of BEHAVIORS gathered from the
    (cautious, normal, aggressive) table by id, (B,) float32 each, on the
    ids' device."""
    return {k: torch.tensor([BEHAVIORS[b][k] for b in BEHAVIOR_ORDER], dtype=torch.float32,
                            device=behaviour_ids.device)[behaviour_ids]
            for k in _PROFILE_KEYS}


def mixed_behaviour_ids(mix, n: int, device) -> torch.Tensor:
    """(n,) ids cycling through the behaviour names `mix` over the worlds
    (JAX carla_agent.py:383-385)."""
    ids = torch.tensor([BEHAVIOR_ORDER.index(b) for b in mix], device=device)
    return ids[torch.arange(n, device=device) % len(mix)]


def expert_action(state: WorldState, params: WorldParams, town: TownDev, routes: RoutesDev,
                  behaviour: str = "normal", ignore_traffic_light: bool = True,
                  profile: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """(B, 2) expert actions in [-1, 1].  `profile` (per-world tensors, see
    behaviour_profiles) overrides the `behaviour` row of BEHAVIORS."""
    B = state.x.shape[0]
    dev = state.x.device
    if profile is None:
        profile = behaviour_profiles(torch.full((B,), BEHAVIOR_ORDER.index(behaviour),
                                                dtype=torch.int64, device=dev))
    pos = torch.stack([state.x, state.y], dim=-1)                   # (B, 2)

    # steering: pure pursuit of a look-ahead route waypoint
    r_len = tgather(routes.length, state.town_id, state.route_id)
    target_idx = torch.minimum(state.wp_idx + LOOKAHEAD, r_len - 1)
    to_t = tgather(routes.xyy, state.town_id, state.route_id, target_idx)[:, :2] - pos
    desired_yaw = torch.atan2(to_t[:, 1], to_t[:, 0])
    yaw_err = torch.atan2(torch.sin(desired_yaw - state.yaw), torch.cos(desired_yaw - state.yaw))
    # the PID's regulation: within STEER_SLEW of the previous steering, then
    # the cap
    steer = torch.clamp(STEER_GAIN * yaw_err, state.steer - STEER_SLEW, state.steer + STEER_SLEW)
    steer = torch.clamp(steer, -STEER_CAP, STEER_CAP)

    # desired speed: the limit at the town's waypoint 0 times the factor
    limit = tgather(town.wp_speed_limit, state.town_id, torch.zeros_like(state.town_id))
    desired = limit * profile["speed_factor"]

    # hazard: the nearest active actor in a forward cone
    # (behavior_agent.py:258-361)
    fwd = torch.stack([torch.cos(state.yaw), torch.sin(state.yaw)], dim=-1)
    npc = state.npc
    if npc is None:
        d_hazard = torch.full((B,), 1e6, device=dev)
        lead_v = torch.zeros((B,), device=dev)
    else:
        all_xy = torch.cat([npc.veh_xy, npc.ped_xy], dim=1)         # (B, A, 2)
        all_on = torch.cat([npc.veh_active, npc.ped_active], dim=1)
        all_v = torch.cat([npc.veh_v, torch.zeros_like(npc.ped_active)], dim=1)
        rel = all_xy - pos[:, None]
        d = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
        cos_a = (rel[..., 0] * fwd[:, None, 0] + rel[..., 1] * fwd[:, None, 1]) \
            / torch.clamp(d, min=1e-3)
        in_cone = (cos_a > 0.8) & (d > 0.1) & (all_on > 0)
        d_masked = torch.where(in_cone, d, torch.full_like(d, 1e6))
        lead = torch.argmin(d_masked, dim=1, keepdim=True)          # the first of equals
        d_hazard = torch.gather(d_masked, 1, lead)[:, 0]
        lead_v = torch.where(d_hazard < 1e5, torch.gather(all_v, 1, lead)[:, 0],
                             torch.zeros_like(d_hazard))
    # the TTC band and the proportional ramp, the more cautious of the two
    ttc_kmh = traffic.ttc_target_speed(state.v, lead_v, d_hazard, desired,
                                       speed_decrease_kmh=profile["speed_decrease"])
    slow = torch.clamp((d_hazard - 5.0) / profile["hazard_distance"], 0.0, 1.0)
    desired = torch.minimum(desired * slow, ttc_kmh)

    j_xy = tgather(town.junction_xy, state.town_id)                 # (B, J, 2)
    rel_j = j_xy - pos[:, None]
    d_j = torch.sqrt(rel_j[..., 0] * rel_j[..., 0] + rel_j[..., 1] * rel_j[..., 1])
    # red-light stop (agent.py:74-110), unless ignored (the collection's
    # default, reference core/learning.py:196-212)
    if not ignore_traffic_light:
        n_j = tgather(town.num_junctions, state.town_id)
        valid = torch.arange(d_j.shape[1], device=dev)[None] < n_j[:, None]
        d_valid = torch.where(valid, d_j, torch.full_like(d_j, 1e9))
        jid = torch.argmin(d_valid, dim=1, keepdim=True)
        d_near = torch.gather(d_valid, 1, jid)[:, 0]
        light = traffic.light_phase_state(
            state.sim_time, tgather(town.junction_phase, state.town_id, jid[:, 0]), state.yaw)
        at_red = (d_near < 14.0) & (d_near > 4.0) & (light != traffic.LIGHT_GREEN)
        desired = torch.where(at_red, torch.zeros_like(desired), desired)

    # slow down near junctions (behavior_agent.py:363-432): every row
    near_j = d_j.min(dim=1).values < 12.0
    desired = torch.where(near_j, torch.minimum(desired, limit * 0.5), desired)
    # and in sharp turns
    desired = desired * (1.0 - 0.7 * torch.clamp(true_div(torch.abs(yaw_err), 0.8), 0.0, 1.0))

    # the PID's throttle and brake caps through the throttle-as-desired-speed
    # encoding: cap the commanded speed change
    cur_kmh = state.v * 3.6
    desired = torch.clamp(desired, cur_kmh - 100.0 * MAX_BRAKE, cur_kmh + 100.0 * MAX_THROTTLE)
    a0 = torch.clamp(true_div(2.0 * desired, 100.0) - 1.0, -1.0, 1.0)
    return torch.stack([a0, steer], dim=-1)
