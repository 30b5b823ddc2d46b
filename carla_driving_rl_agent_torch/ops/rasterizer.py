"""The analytic camera renderer in plain PyTorch, batched over worlds.

Counterpart of carla_driving_rl_agent_tpu/ops/rasterizer.py, the JAX
package's XLA renderer (`render_mode="rasterizer"`, its env's default):
three cameras at z = 2.2 m with yaw offsets +90 / 0 / -90 degrees and a
90-degree field of view, side by side into (H, 3W, 3) (reference
environment.py:1248-1264), or the front camera alone (OneCamera).  Every
pixel's class is computed from the road geometry of its world:

  * ground: the ray meets the ground plane; its distance to the K nearest
    road centre-line segments picks road, marking, sidewalk, crossing or
    terrain;
  * buildings: exact 2D slab test against the K nearest building boxes,
    with their heights;
  * actors: depth-tested billboards of the nearest vehicles and walkers;
  * weather: sky colour, light, fog and the wet-road tint.

The JAX package renders one world under vmap; here every function takes
(B, ...) inputs, one row per world, and keeps (B, H, W) maps.  Its
`fori_loop`s over the K nearest entities stay Python loops over K, so only
(B, H, W) accumulators exist at a time.  The arithmetic follows the JAX
code operation for operation: divisions by constants are IEEE divisions
(`dynamics.true_div`), not multiplications by a reciprocal, and the
nearest-K selections break ties by the lower index as `lax.top_k` does
(`render.nearest_k`).

This renderer is not one of the JAX package's Pallas kernels (that one is
ops/render.py's); it runs as plain PyTorch on every device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from carla_driving_rl_agent_torch.envs.dynamics import true_div
from carla_driving_rl_agent_torch.ops.render import nearest_k

CAMERA_HEIGHT = 2.2
CAMERA_YAWS = (math.pi / 2.0, 0.0, -math.pi / 2.0)   # left, front, right
FOV_DEG = 90.0

LANE_W = 3.5                   # envs/town.py LANE_WIDTH
ROAD_HALF = LANE_W + 0.3       # single-lane road band half-width (default)
JUNCTION_RADIUS = 9.0

K_EDGES = 24
K_BUILDINGS = 16
K_ACTORS = 12
MAX_DEPTH = 400.0

# quality presets: (k_edges, k_buildings, k_actors, supersample divisor);
# 'fast' renders at half resolution with smaller K budgets and upsamples 2x
QUALITY = dict(full=(24, 16, 12, 1), fast=(12, 8, 6, 2))

COLOR_TERRAIN = (96.0, 128.0, 72.0)
COLOR_ROAD = (88.0, 88.0, 94.0)
COLOR_MARKING = (228.0, 228.0, 218.0)
COLOR_SIDEWALK = (158.0, 152.0, 148.0)
COLOR_BUILDING = (122.0, 102.0, 96.0)
COLOR_CROSSING = (200.0, 200.0, 200.0)
VEHICLE_COLORS = ((180, 30, 30), (30, 60, 180), (220, 220, 220), (40, 40, 40),
                  (200, 170, 40), (90, 140, 190))
WALKER_COLOR = (190.0, 120.0, 90.0)

# log1p(MAX_DEPTH) scaled into [0, 255], the constant as float32 rounds it
DEPTH_SCALE = float(torch.tensor(255.0 / math.log1p(MAX_DEPTH), dtype=torch.float32))


class RenderInputs(NamedTuple):
    """One row per world; `veh_*` and `ped_*` may have 0 slots (a world
    without NPCs)."""
    edges_xy: torch.Tensor       # (B, E, 4) road centre-line segments of the town
    num_edges: torch.Tensor      # (B,)
    buildings: torch.Tensor      # (B, NB, 5) cx, cy, hw, hh, height
    junctions: torch.Tensor      # (B, J, 2)
    num_junctions: torch.Tensor  # (B,)
    ego_xy: torch.Tensor         # (B, 2)
    ego_yaw: torch.Tensor        # (B,)
    veh_xy: torch.Tensor         # (B, V, 2)
    veh_yaw: torch.Tensor        # (B, V)
    veh_active: torch.Tensor     # (B, V)
    ped_xy: torch.Tensor         # (B, P, 2)
    ped_active: torch.Tensor     # (B, P)
    weather: torch.Tensor        # (B, 5) sun, clouds, rain, wetness, fog
    road_half: torch.Tensor      # (B,) road band half-width of the world's town


def _const(c, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32, device=like.device)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one IEEE division (PyTorch's `c / x` multiplies c by the
    reciprocal of x, two roundings)."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def _col(t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1), to broadcast against (B, H, W) maps."""
    return t[:, None, None]


def _pixel_rays(height: int, width: int, device):
    """Unit view rays in the camera frame (x forward, y left, z up), (H, W)
    each."""
    fx = _focal(width, device)
    u = torch.arange(width, dtype=torch.float32, device=device) - (width - 1) / 2.0
    v = torch.arange(height, dtype=torch.float32, device=device) - (height - 1) / 2.0
    dy = (-u / fx)[None, :].expand(height, width)
    dz = (-v / fx)[:, None].expand(height, width)
    dx = torch.ones((height, width), dtype=torch.float32, device=device)
    norm = torch.sqrt(dx * dx + dy * dy + dz * dz)
    return dx / norm, dy / norm, dz / norm


def _focal(width: int, device) -> torch.Tensor:
    deg = torch.tensor(FOV_DEG, dtype=torch.float32, device=device)
    return _rdiv(width / 2.0, torch.tan(torch.deg2rad(deg) / 2.0))


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) rows at (B, k) indices -> (B, k, D)."""
    return torch.gather(table, 1, idx[..., None].expand(idx.shape + table.shape[2:]))


def _min_seg_distance(px, py, segs):
    """(B, H, W) distance from the ground points to the nearest of the K
    segments (B, K, 4), and the arclength along that segment; the first of
    equal distances wins."""
    d_min = torch.full_like(px, 1e12)
    t_min = torch.zeros_like(px)
    for k in range(segs.shape[1]):
        x0, y0, x1, y1 = (_col(segs[:, k, i]) for i in range(4))
        ex = x1 - x0
        ey = y1 - y0
        L2 = torch.clamp(ex * ex + ey * ey, min=1e-9)
        rx = px - x0
        ry = py - y0
        t = torch.clamp((rx * ex + ry * ey) / L2, 0.0, 1.0)
        dx = rx - t * ex
        dy = ry - t * ey
        d = dx * dx + dy * dy
        closer = d < d_min
        d_min = torch.where(closer, d, d_min)
        t_min = torch.where(closer, t * torch.sqrt(L2), t_min)
    return torch.sqrt(d_min), t_min


def _sky_color(weather: torch.Tensor) -> torch.Tensor:
    """(B, 3)."""
    sun, clouds, rain = weather[:, 0:1], weather[:, 1:2], weather[:, 2:3]
    clear = _const((135.0, 190.0, 235.0), weather)
    sunset = _const((240.0, 160.0, 110.0), weather)
    overcast = _const((150.0, 152.0, 158.0), weather)
    sky = clear * (1 - sun) + sunset * sun
    sky = sky * (1 - clouds) + overcast * clouds
    return sky * (1.0 - 0.25 * rain)


def _shade_weather(rgb, depth, sky_rgb, weather, is_road):
    """rgb (B, H, W, 3), depth (B, H, W), sky (B, 3), weather (B, 5)."""
    w = weather[:, None, None, :]                               # (B, 1, 1, 5)
    sun, clouds, rain, wet, fog = (w[..., i] for i in range(5))  # (B, 1, 1)
    sky = sky_rgb[:, None, None, :]
    light = 1.0 - 0.35 * clouds - 0.15 * rain
    warm = torch.stack([1.0 + 0.25 * sun, torch.ones_like(sun), 1.0 - 0.2 * sun], dim=-1)
    rgb = rgb * light[..., None] * warm
    wet = wet[..., None]
    rgb = torch.where(is_road[..., None], rgb * (1.0 - 0.35 * wet) + sky * 0.12 * wet, rgb)
    fog_f = 1.0 - torch.exp(-depth * (0.002 + 0.05 * fog))
    return rgb * (1 - fog_f[..., None]) + sky * fog_f[..., None]


def depth_to_u8(depth: torch.Tensor) -> torch.Tensor:
    """Log-depth as a float channel in [0, 255] (the JAX package's
    encoding: log1p(metres) scaled by log1p(MAX_DEPTH))."""
    d = torch.clamp(depth, 0.0, MAX_DEPTH)
    return torch.log1p(d) * DEPTH_SCALE


def _color_where(mask: torch.Tensor, color, other: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], _const(color, other), other)


def render_view(inputs: RenderInputs, cam_yaw_offset: float, height: int = 90,
                width: int = 120, k_edges: int = K_EDGES, k_buildings: int = K_BUILDINGS,
                k_actors: int = K_ACTORS, return_depth: bool = False):
    """One camera view of every world -> (B, height, width, 3) float32 in
    [0, 255]; with return_depth also the per-pixel ray depth in metres
    (B, height, width), MAX_DEPTH at the sky."""
    dev = inputs.ego_xy.device
    dx_c, dy_c, dz = _pixel_rays(height, width, dev)
    yaw = inputs.ego_yaw + cam_yaw_offset
    cos_y, sin_y = _col(torch.cos(yaw)), _col(torch.sin(yaw))
    dx = dx_c * cos_y - dy_c * sin_y                                 # (B, H, W)
    dy = dx_c * sin_y + dy_c * cos_y
    ex, ey = _col(inputs.ego_xy[:, 0]), _col(inputs.ego_xy[:, 1])
    sky_rgb = _sky_color(inputs.weather)

    # ---- ground intersection ----
    below = dz < -1e-4
    t_ground = torch.where(below, _rdiv(-CAMERA_HEIGHT, torch.where(below, dz, -1.0)),
                           _const(1e6, dz))
    t_ground = torch.clamp(t_ground, max=MAX_DEPTH)
    gx = ex + t_ground * dx
    gy = ey + t_ground * dy

    # ---- the K nearest road segments: distance bands -> classes ----
    edges = inputs.edges_xy
    n_e = edges.shape[1]
    ar = torch.arange(n_e, device=dev)
    e_idx = nearest_k(0.5 * (edges[..., :2] + edges[..., 2:]), inputs.ego_xy,
                      ar[None] < inputs.num_edges[:, None], k_edges)
    d_road, t_at = _min_seg_distance(gx, gy, _gather_rows(edges, e_idx))

    rh = _col(inputs.road_half)
    dashed = torch.floor(true_div(t_at, 2.0)) % 2 == 0
    is_center_marking = (d_road < 0.15) & dashed
    # lane-divider dashes between the lanes of one direction (multi-lane towns)
    is_lane_div = (rh > LANE_W + 1.0) & (torch.abs(d_road - LANE_W) < 0.12) & dashed
    is_edge_marking = (torch.abs(d_road - (rh - 0.2)) < 0.12) | is_lane_div
    is_road = d_road < rh
    is_sidewalk = (d_road >= rh) & (d_road < rh + 2.0)

    # crossings near junctions (striped bands)
    n_j = inputs.junctions.shape[1]
    j_idx = nearest_k(inputs.junctions, inputs.ego_xy,
                      torch.arange(n_j, device=dev)[None] < inputs.num_junctions[:, None], 4)
    jx = _gather_rows(inputs.junctions, j_idx)
    d_jmin = torch.full_like(gx, 1e12)
    for k in range(jx.shape[1]):
        d = torch.square(gx - _col(jx[:, k, 0])) + torch.square(gy - _col(jx[:, k, 1]))
        d_jmin = torch.minimum(d_jmin, d)
    d_jmin = torch.sqrt(d_jmin)
    band = (d_jmin > JUNCTION_RADIUS * 0.85) & (d_jmin < JUNCTION_RADIUS * 0.85 + 2.0)
    stripes = torch.floor(true_div(gx + gy, 0.6)) % 2 == 0
    is_crossing = band & stripes & is_road

    terrain = _const(COLOR_TERRAIN, gx).expand(gx.shape + (3,))
    ground_rgb = _color_where(is_crossing, COLOR_CROSSING, _color_where(
        is_center_marking | is_edge_marking, COLOR_MARKING, _color_where(
            is_road, COLOR_ROAD, _color_where(is_sidewalk, COLOR_SIDEWALK, terrain))))

    # ---- buildings: exact ray/box intersection (2D slabs + height) ----
    blds = inputs.buildings
    b_idx = nearest_k(blds[..., :2], inputs.ego_xy, blds[..., 4] > 0.5, k_buildings)
    bb = _gather_rows(blds, b_idx)                                   # (B, K, 5)
    inv_dx = 1.0 / torch.where(torch.abs(dx) < 1e-6, 1e-6, dx)
    inv_dy = 1.0 / torch.where(torch.abs(dy) < 1e-6, 1e-6, dy)
    t_build = torch.full_like(dx, 1e6)
    for k in range(bb.shape[1]):
        cx, cy, hw, hh, bh = (_col(bb[:, k, i]) for i in range(5))
        tx0 = (cx - hw - ex) * inv_dx
        tx1 = (cx + hw - ex) * inv_dx
        ty0 = (cy - hh - ey) * inv_dy
        ty1 = (cy + hh - ey) * inv_dy
        t_near = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1))
        t_far = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1))
        z_near = CAMERA_HEIGHT + t_near * dz
        hit = (t_near > 0.5) & (t_near <= t_far) & (z_near > 0.0) & (z_near < bh)
        t_build = torch.minimum(t_build, torch.where(hit, t_near, 1e6))
    shade = 1.0 - 0.5 * torch.clamp(true_div(t_build, 150.0), 0.0, 1.0)
    build_rgb = _const(COLOR_BUILDING, shade) * shade[..., None]

    # ---- compose ground / building / sky ----
    t_g = torch.where(below & (t_ground < MAX_DEPTH), t_ground, 1e6)
    use_build = t_build < t_g
    depth = torch.minimum(t_g, t_build)
    rgb = torch.where(use_build[..., None], build_rgb,
                      torch.where((t_g < 1e6)[..., None], ground_rgb,
                                  sky_rgb[:, None, None, :]))
    road_px = (t_g < 1e6) & is_road & ~use_build

    # ---- actor billboards ----
    rgb, depth = _composite_actors(rgb, depth, inputs, yaw, height, width, k_actors)

    rgb = _shade_weather(rgb, depth, sky_rgb, inputs.weather, road_px)
    rgb = torch.clamp(rgb, 0.0, 255.0)
    if return_depth:
        return rgb, torch.clamp(depth, max=MAX_DEPTH)
    return rgb


def _composite_actors(rgb, depth, inputs: RenderInputs, yaw, height: int, width: int,
                      k_actors: int = K_ACTORS):
    """The k_actors nearest active vehicles, then walkers, as depth-tested
    billboards over (B, H, W, 3) rgb and (B, H, W) depth."""
    n_v, n_p = inputs.veh_xy.shape[1], inputs.ped_xy.shape[1]
    if n_v + n_p == 0:
        return rgb, depth
    dev = rgb.device
    fx = _focal(width, dev)
    cos_y, sin_y = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]   # (B, 1)
    ego = inputs.ego_xy
    v_idx = nearest_k(inputs.veh_xy, ego, inputs.veh_active > 0, min(k_actors, n_v))
    p_idx = nearest_k(inputs.ped_xy, ego, inputs.ped_active > 0, min(k_actors, n_p))
    a_xy = torch.cat([_gather_rows(inputs.veh_xy, v_idx), _gather_rows(inputs.ped_xy, p_idx)],
                     dim=1)                                            # (B, A, 2)
    a_ok = torch.cat([torch.gather(inputs.veh_active, 1, v_idx) > 0,
                      torch.gather(inputs.ped_active, 1, p_idx) > 0], dim=1)
    kv, kp = v_idx.shape[1], p_idx.shape[1]
    a_hw = (1.0,) * kv + (0.3,) * kp
    # the camera height above each billboard's top, in float32
    above = (_const(CAMERA_HEIGHT, rgb) - _const((1.6,) * kv + (1.8,) * kp, rgb))
    palette = _const(VEHICLE_COLORS, rgb)
    a_col = torch.cat([palette[v_idx % len(VEHICLE_COLORS)],
                       _const(WALKER_COLOR, rgb).expand(p_idx.shape + (3,))], dim=1)

    uu = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    vv = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    ex, ey = ego[:, 0:1], ego[:, 1:2]
    for k in range(a_xy.shape[1]):
        rx = a_xy[:, k, 0:1] - ex
        ry = a_xy[:, k, 1:2] - ey
        cx = rx * cos_y + ry * sin_y                                   # (B, 1)
        cy = -rx * sin_y + ry * cos_y
        denom = torch.clamp(cx, min=0.1)
        u = (-cy / denom) * fx + (width - 1) / 2.0
        half_u = _rdiv(a_hw[k], denom) * fx
        v_bottom = _rdiv(CAMERA_HEIGHT, denom) * fx + (height - 1) / 2.0
        v_top = (above[k] / denom) * fx + (height - 1) / 2.0
        live = ((cx > 0.8) & a_ok[:, k:k + 1])[..., None]             # (B, 1, 1)
        cover = ((torch.abs(uu - u[..., None]) < half_u[..., None])
                 & (vv >= v_top[..., None]) & (vv <= v_bottom[..., None]) & live)
        visible = cover & (cx[..., None] < depth)
        rgb = torch.where(visible[..., None], a_col[:, k, None, None, :], rgb)
        depth = torch.where(visible, cx[..., None].expand_as(depth), depth)
    return rgb, depth


def upsample(img: torch.Tensor, div: int) -> torch.Tensor:
    """(B, h, w, C) -> (B, h*div, w*div, C) nearest (jax.image.resize's
    'nearest' at an integer factor repeats each pixel)."""
    if div == 1:
        return img
    return torch.repeat_interleave(torch.repeat_interleave(img, div, dim=1), div, dim=2)


def render_cameras(inputs: RenderInputs, height: int = 90, width: int = 120,
                   quality: str = "full", return_depth: bool = False) -> torch.Tensor:
    """The three-camera image of every world -> (B, H, 3W, C) uint8 (left |
    front | right, reference environment.py:1259).  'fast' renders each
    view at half resolution with smaller K budgets and upsamples.  With
    return_depth a 4th channel holds the front view's log-depth in the
    middle third, zeros left and right (reference core/carla_env.py:285-287)."""
    ke, kb, ka, div = QUALITY[quality]
    h, w = height // div, width // div
    views, depth_front = [], None
    for i, yaw in enumerate(CAMERA_YAWS):
        out = render_view(inputs, yaw, height=h, width=w, k_edges=ke, k_buildings=kb,
                          k_actors=ka, return_depth=return_depth and i == 1)
        if return_depth and i == 1:
            out, depth_front = out
        views.append(out)
    img = torch.cat(views, dim=2)
    if return_depth:
        zeros = torch.zeros_like(depth_front)
        dchan = torch.cat([zeros, depth_to_u8(depth_front), zeros], dim=2)
        img = torch.cat([img, dchan[..., None]], dim=-1)
    return upsample(img, div).to(torch.uint8)


def render_one_camera(inputs: RenderInputs, height: int = 90, width: int = 120,
                      quality: str = "full", stack_depth: bool = False,
                      depth_modulate: bool = False) -> torch.Tensor:
    """The front camera alone (the OneCamera env, reference
    environment.py:837) -> (B, H, W, C) uint8: with stack_depth its
    log-depth as a 4th channel (core/carla_env.py:271-288); with
    depth_modulate the colour times (1 - log-depth / 255), so that the far
    field fades to black (environment.py:1038-1049)."""
    if stack_depth and depth_modulate:
        raise ValueError("stack_depth and depth_modulate are exclusive")
    ke, kb, ka, div = QUALITY[quality]
    out = render_view(inputs, 0.0, height=height // div, width=width // div, k_edges=ke,
                      k_buildings=kb, k_actors=ka, return_depth=stack_depth or depth_modulate)
    if stack_depth:
        view, depth = out
        img = torch.cat([view, depth_to_u8(depth)[..., None]], dim=-1)
    elif depth_modulate:
        view, depth = out
        img = view * (1.0 - true_div(depth_to_u8(depth), 255.0)[..., None])
    else:
        img = out
    return upsample(img, div).to(torch.uint8)


def no_actors(n: int, device) -> dict:
    """The actor fields of RenderInputs for worlds without NPCs (no slots)."""
    z2 = torch.zeros((n, 0, 2), dtype=torch.float32, device=device)
    z1 = torch.zeros((n, 0), dtype=torch.float32, device=device)
    return dict(veh_xy=z2, veh_yaw=z1, veh_active=z1, ped_xy=z2, ped_active=z1)


def actor_fields(npc: Optional[object], n: int, device) -> dict:
    """The actor fields of RenderInputs from an NPC fleet (envs/traffic
    NPCState), or empty ones for worlds without NPCs."""
    if npc is None:
        return no_actors(n, device)
    return dict(veh_xy=npc.veh_xy, veh_yaw=npc.veh_yaw, veh_active=npc.veh_active,
                ped_xy=npc.ped_xy, ped_active=npc.ped_active)
