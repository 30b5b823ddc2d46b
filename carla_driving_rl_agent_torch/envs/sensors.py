"""The analytic sensor suite: every sensor the reference can spawn, as
batched functions of the simulated worlds.

Counterpart of carla_driving_rl_agent_tpu/envs/sensors.py (reference
rl/environments/carla/sensors.py:42-74, `Sensor.create`: collision, lane
invasion, GNSS, IMU, RGB / semantic / depth cameras, obstacle, lidar,
radar).  A sensor is a frozen spec whose `read` is a function of the port's
WorldState, (B,) worlds at once (and of the town bank where it needs
geometry); detectors return a `triggered` mask instead of firing
callbacks.  Shapes are fixed: the radar has one slot per NPC with a
`valid` mask, the lidar a fixed fan of rays.  A world without NPCs (its
state's `npc` is None) has no actor slots: the radar returns (B, 0) slots,
the obstacle detector and the lidar see no actors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from carla_driving_rl_agent_torch.envs.dynamics import DT, true_div
from carla_driving_rl_agent_torch.envs.world import TownDev, WorldState, off_road_distance

EARTH_RADIUS = 6371000.0        # CARLA's geodesic conversion radius (m)
GRAVITY = 9.81


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), c, dtype=torch.float32, device=like.device)


def _mod(a: torch.Tensor, m: float) -> torch.Tensor:
    """a mod m with the sign of m, as jnp.mod computes it (fmod, then m
    added where the remainder's sign differs from m's)."""
    mm = _f32(m, a)
    r = torch.fmod(a, mm)
    return torch.where((r != 0) & ((r < 0) != (mm < 0)), r + mm, r)


def _wrap_pi(a: torch.Tensor) -> torch.Tensor:
    return _mod(a + math.pi, 2.0 * math.pi) - math.pi


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _half_fov(fov_deg: float, like: torch.Tensor) -> torch.Tensor:
    return torch.deg2rad(_f32(fov_deg, like)) / 2.0


# ---------------------------------------------------------------------------
# position / inertial
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GnssSensor:
    """`sensor.other.gnss` (reference sensors.py:50-51): the position as
    geodetic coordinates around the map's geo-reference (equirectangular,
    CARLA's convention: +y drives the latitude negative)."""
    lat_ref: float = 0.0
    lon_ref: float = 0.0

    def read(self, world: WorldState) -> Dict[str, torch.Tensor]:
        scale = 180.0 / (math.pi * EARTH_RADIUS)
        cos_ref = torch.cos(torch.deg2rad(_f32(self.lat_ref, world.x)))
        return dict(latitude=self.lat_ref - world.y * scale,
                    longitude=self.lon_ref + world.x * scale / cos_ref,
                    altitude=torch.zeros_like(world.x))


@dataclass(frozen=True)
class IMUSensor:
    """`sensor.other.imu` (reference sensors.py:53-54): accelerometer,
    gyroscope (B, 3) and compass (B,) from two consecutive world states (the
    bicycle integrates at a fixed DT, so finite differences are the body
    rates)."""

    def read(self, world: WorldState,
             prev: Optional[WorldState] = None) -> Dict[str, torch.Tensor]:
        if prev is None:
            prev = world
        dv = true_div(world.v - prev.v, DT)
        dyaw = true_div(_wrap_pi(world.yaw - prev.yaw), DT)
        zeros = torch.zeros_like(dyaw)
        accel = torch.stack([dv, world.v * dyaw, torch.full_like(dv, GRAVITY)], dim=-1)
        gyro = torch.stack([zeros, zeros, dyaw], dim=-1)
        # CARLA's compass: 0 = geographic north (+y is south in the UE frame)
        compass = _mod(math.pi / 2.0 + world.yaw, 2.0 * math.pi)
        return dict(accelerometer=accel, gyroscope=gyro, compass=compass)


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CollisionDetector:
    """`sensor.other.collision` (reference sensors.py:44-45): fires when the
    world detected a contact this step, with the penalty as its intensity."""

    def read(self, world: WorldState) -> Dict[str, torch.Tensor]:
        pen = world.collision_penalty
        return dict(triggered=pen > 0.0, intensity=pen)


@dataclass(frozen=True)
class LaneInvasionSensor:
    """`sensor.other.lane_invasion` (reference sensors.py:47-48): fires when
    the ego leaves the road band of the nearest road segment."""

    def read(self, world: WorldState, town: TownDev) -> Dict[str, torch.Tensor]:
        d = off_road_distance(town, world.town_id, world.x, world.y)
        half = town.road_half[world.town_id]
        return dict(triggered=d > half, distance=d)


def _actor_polar(world: WorldState):
    """(range, bearing from the heading, relative radial velocity, active),
    (B, V + P) each, of every NPC slot (vehicles, then walkers)."""
    npc = world.npc
    vdir = torch.stack([torch.cos(npc.veh_yaw), torch.sin(npc.veh_yaw)], dim=-1)
    veh_vel = vdir * npc.veh_v[..., None]
    pdir = npc.ped_goal - npc.ped_xy
    pdir = pdir / torch.clamp(_norm(pdir), min=1e-6)[..., None]
    ped_vel = pdir * npc.ped_speed[..., None]

    xy = torch.cat([npc.veh_xy, npc.ped_xy], dim=1)
    vel = torch.cat([veh_vel, ped_vel], dim=1)
    active = torch.cat([npc.veh_active, npc.ped_active], dim=1) > 0.5

    rel = xy - torch.stack([world.x, world.y], dim=-1)[:, None]
    rng = torch.clamp(_norm(rel), min=1e-6)
    brg = _wrap_pi(torch.atan2(rel[..., 1], rel[..., 0]) - world.yaw[:, None])
    ego_vel = world.v[:, None] * torch.stack([torch.cos(world.yaw), torch.sin(world.yaw)],
                                             dim=-1)
    # the radial part of the relative velocity, positive when approaching
    # (CARLA's RadarDetection.velocity sign): d(range)/dt = -rvel
    rel_v = (vel - ego_vel[:, None]) * rel
    rvel = -(rel_v[..., 0] + rel_v[..., 1]) / rng
    return rng, brg, rvel, active


@dataclass(frozen=True)
class ObstacleDetector:
    """`sensor.other.obstacle` (reference sensors.py:66-67): the nearest
    actor inside a forward cone, CARLA's (distance, other_actor) event as a
    (distance, triggered) pair."""
    distance: float = 5.0           # CARLA's blueprint default
    hit_radius: float = 0.5
    fov_deg: float = 40.0

    def read(self, world: WorldState) -> Dict[str, torch.Tensor]:
        if world.npc is None:
            dmin = torch.full_like(world.x, math.inf)
        else:
            rng, brg, _, valid = _actor_polar(world)
            in_cone = (torch.abs(brg) < _half_fov(self.fov_deg, rng)) & valid
            d = torch.where(in_cone, rng - self.hit_radius, math.inf)
            dmin = torch.amin(d, dim=1)
        return dict(triggered=dmin <= self.distance,
                    distance=torch.clamp(dmin, 0.0, self.distance))


@dataclass(frozen=True)
class RadarSensor:
    """`sensor.other.radar` (reference sensors.py:69-70): per-NPC detection
    slots (depth, azimuth, relative radial velocity) with a `valid` mask,
    the fixed-shape form of CARLA's variable detection list."""
    range: float = 100.0
    fov_deg: float = 30.0

    def read(self, world: WorldState) -> Dict[str, torch.Tensor]:
        if world.npc is None:
            empty = world.x[:, None][:, :0]
            return dict(depth=empty, azimuth=empty, velocity=empty,
                        valid=empty.to(torch.bool))
        rng, brg, rvel, valid = _actor_polar(world)
        ok = valid & (rng <= self.range) & (torch.abs(brg) < _half_fov(self.fov_deg, rng))
        return dict(depth=torch.where(ok, rng, self.range),
                    azimuth=torch.where(ok, brg, 0.0),
                    velocity=torch.where(ok, rvel, 0.0),
                    valid=ok)


# ---------------------------------------------------------------------------
# lidar
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LidarSensor:
    """`sensor.lidar.ray_cast` (reference sensors.py:68): one planar fan of
    rays cast against the town's road-boundary segments, building boxes and
    actor discs.  Returns per-ray `ranges` (max_range where nothing is hit)
    (B, R), a `hit` mask and ego-frame `points` (B, R, 2)."""
    num_rays: int = 180
    max_range: float = 50.0
    actor_radius: float = 1.0

    def read(self, world: WorldState, town: TownDev) -> Dict[str, torch.Tensor]:
        dev = world.x.device
        p = torch.stack([world.x, world.y], dim=-1)                    # (B, 2)
        # jnp.linspace(0, 2 pi, R, endpoint=False): 2 pi times i / R
        fan = _f32(2.0 * math.pi, world.x) * true_div(
            torch.arange(self.num_rays, dtype=torch.float32, device=dev), self.num_rays)
        ang = world.yaw[:, None] + fan                                  # (B, R)
        d = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)      # (B, R, 2)
        dx, dy = d[..., 0, None], d[..., 1, None]                       # (B, R, 1)

        # road-boundary segments (B, S, 4): p + t d == a + s (b - a)
        tid = world.town_id
        segs = town.edges_xy[tid]
        a, b = segs[..., :2], segs[..., 2:]
        e = b - a
        ap = a - p[:, None]
        ex, ey = e[:, None, :, 0], e[:, None, :, 1]                    # (B, 1, S)
        apx, apy = ap[:, None, :, 0], ap[:, None, :, 1]
        denom = dx * (-ey) - dy * (-ex)
        denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
        t = (apx * (-ey) - apy * (-ex)) / denom                         # (B, R, S)
        s = (dx * apy - dy * apx) / denom
        n_seg = town.num_edges[tid][:, None, None]
        seg_ok = ((t > 0.0) & (s >= 0.0) & (s <= 1.0)
                  & (torch.arange(segs.shape[1], device=dev) < n_seg))
        t_seg = torch.amin(torch.where(seg_ok, t, math.inf), dim=2)

        # building boxes (B, NB, 5): slab test on (cx, cy, half_w, half_h)
        bld = town.buildings[tid]
        lo = bld[..., :2] - bld[..., 2:4]
        hi = bld[..., :2] + bld[..., 2:4]
        inv = 1.0 / torch.where(torch.abs(d) < 1e-9, 1e-9, d)          # (B, R, 2)
        t1 = (lo[:, None] - p[:, None, None]) * inv[:, :, None]         # (B, R, NB, 2)
        t2 = (hi[:, None] - p[:, None, None]) * inv[:, :, None]
        tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
        tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
        n_bld = town.num_buildings[tid][:, None, None]
        bld_ok = ((tmax >= tmin) & (tmax > 0.0)
                  & (torch.arange(bld.shape[1], device=dev) < n_bld))
        t_bld = torch.amin(torch.where(bld_ok, torch.clamp(tmin, min=0.0), math.inf), dim=2)

        ranges = torch.minimum(t_seg, t_bld)
        npc = world.npc
        if npc is not None:
            # actor discs: |p + t d - c|^2 = r^2, the nearest positive root
            c = torch.cat([npc.veh_xy, npc.ped_xy], dim=1)
            act = torch.cat([npc.veh_active, npc.ped_active], dim=1) > 0.5
            pc = c - p[:, None]                                          # (B, A, 2)
            proj = dx * pc[:, None, :, 0] + dy * pc[:, None, :, 1]       # (B, R, A)
            perp2 = (pc[..., 0] * pc[..., 0] + pc[..., 1] * pc[..., 1])[:, None] - proj ** 2
            disc = self.actor_radius ** 2 - perp2
            root = torch.sqrt(torch.clamp(disc, min=0.0))
            t_hit = proj - root
            act_ok = (disc > 0.0) & (t_hit > 0.0) & act[:, None]
            ranges = torch.minimum(ranges, torch.amin(torch.where(act_ok, t_hit, math.inf),
                                                      dim=2))
        hit = torch.isfinite(ranges) & (ranges <= self.max_range)
        ranges = torch.where(hit, ranges, self.max_range)
        return dict(ranges=ranges, hit=hit, points=d * ranges[..., None])


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CameraSensor:
    """`sensor.camera.{rgb,semantic_segmentation,depth}` (reference
    sensors.py:56-64) on the analytic renderer (ops/rasterizer.py) at full
    quality: (B, H, W, 3) float32 colours in [0, 255], or (B, H, W) uint8
    log-depth.  `semantic` renders under the neutral weather row (weather
    0): the renderer computes each pixel's class from the road geometry,
    so its unshaded colours are the segmentation palette.  `env` is a
    CARLAEnv (its town bank and weather table)."""
    env: object
    kind: str = "rgb"               # 'rgb' | 'semantic' | 'depth'
    cam_yaw_offset: float = 0.0
    height: int = 90
    width: int = 120

    def read(self, world: WorldState) -> torch.Tensor:
        from carla_driving_rl_agent_torch.ops import rasterizer
        inputs = self.env.render_inputs(world)
        if self.kind == "semantic":
            neutral = self.env.weather_params[0].expand_as(inputs.weather)
            inputs = inputs._replace(weather=neutral)
        out = rasterizer.render_view(inputs, self.cam_yaw_offset, height=self.height,
                                     width=self.width, return_depth=self.kind == "depth")
        if self.kind == "depth":
            return rasterizer.depth_to_u8(out[1]).to(torch.uint8)
        return out


# ---------------------------------------------------------------------------
# the factory (reference Sensor.create, sensors.py:42-74)
# ---------------------------------------------------------------------------

_TYPES = {
    "sensor.other.collision": CollisionDetector,
    "sensor.other.lane_invasion": LaneInvasionSensor,
    "sensor.other.gnss": GnssSensor,
    "sensor.other.imu": IMUSensor,
    "sensor.other.obstacle": ObstacleDetector,
    "sensor.lidar.ray_cast": LidarSensor,
    "sensor.other.radar": RadarSensor,
}


def create(sensor_type: str, **kwargs):
    """The reference's `Sensor.create` type registry; camera types need the
    env that owns the geometry banks (`env=`)."""
    if sensor_type == "sensor.camera.rgb":
        return CameraSensor(kind="rgb", **kwargs)
    if sensor_type == "sensor.camera.semantic_segmentation":
        return CameraSensor(kind="semantic", **kwargs)
    if sensor_type == "sensor.camera.depth":
        return CameraSensor(kind="depth", **kwargs)
    if sensor_type in _TYPES:
        return _TYPES[sensor_type](**kwargs)
    raise ValueError(f"String `{sensor_type}` does not denote a valid sensor!")
