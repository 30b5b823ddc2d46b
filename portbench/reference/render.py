"""A frozen copy of the port's plain PyTorch renderer (the arithmetic of
the JAX package's `_render_world`): the reference that the CUDA render
kernel's frames are held against, bit for bit.  It takes the kernel's own
input, the per-world geometry pack that the port assembles from the world
state, and imports nothing of the port.

Per world, a 176-float geometry pack (12 road segments, 8 buildings, 4
junctions, up to 8 actor billboards, the ego pose, 5 weather scalars and
the road half-width) is ray-cast through the 8100 pixels of three 45x60
views through a constant per-pixel ray LUT, into (B, C, 45, 180) uint8.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def tgather(arr: torch.Tensor, town_id: torch.Tensor, *idx: torch.Tensor):
    return arr[(town_id,) + idx]


# camera rig and scene constants (the JAX package's ops/rasterizer.py)
CAMERA_HEIGHT = 2.2
CAMERA_YAWS = (math.pi / 2.0, 0.0, -math.pi / 2.0)   # left, front, right
FOV_DEG = 90.0
LANE_W = 3.5
JUNCTION_RADIUS = 9.0
MAX_DEPTH = 400.0

# fast-quality geometry budgets
K_EDGES = 12
K_BUILDINGS = 8
K_ACTORS = 8          # vehicles + pedestrians combined
VIEW_H, VIEW_W = 45, 60
N_PIX = 3 * VIEW_H * VIEW_W            # 8100
N_QUADS = N_PIX // 4                   # the CUDA kernel's 4-pixel work items
TILE = (64, 128)                        # the TPU kernel's 8192-slot tile
FX = (VIEW_W / 2.0) / np.tan(np.deg2rad(FOV_DEG) / 2.0)

# geometry pack offsets (per world, float32); csrc/render.cuh repeats them
_O_SEGS = 0
_O_BLD = _O_SEGS + K_EDGES * 4          # 48
_O_JUNC = _O_BLD + K_BUILDINGS * 5      # 88
_O_ACT = _O_JUNC + 4 * 2                # 96
_O_EGO = _O_ACT + K_ACTORS * 8          # 160: ex, ey, cos_yaw, sin_yaw
_O_WEATHER = _O_EGO + 4                 # 164
_O_ROADHALF = _O_WEATHER + 5            # 169
GEOM_SIZE = _O_ROADHALF + 1             # 170
GEOM_PAD = 176

DEPTH_SCALE = np.float32(255.0 / np.log1p(MAX_DEPTH))


def _build_lut() -> dict:
    """Constant per-pixel tables: view-offset-rotated camera rays, pixel
    (u, v) coordinates and view id, flattened (view, row, column) and padded
    to the TPU tile, exactly as the JAX package builds them."""
    u = np.arange(VIEW_W, dtype=np.float32) - (VIEW_W - 1) / 2.0
    v = np.arange(VIEW_H, dtype=np.float32) - (VIEW_H - 1) / 2.0
    dy = -u / FX                     # left positive
    dz = -v / FX                     # up positive
    dy = np.broadcast_to(dy[None, :], (VIEW_H, VIEW_W))
    dz = np.broadcast_to(dz[:, None], (VIEW_H, VIEW_W))
    dx = np.ones((VIEW_H, VIEW_W), np.float32)
    norm = np.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / norm, dy / norm, dz / norm

    luts = dict(dx=[], dy=[], dz=[], u=[], v=[], vid=[])
    for vid, off in enumerate(np.asarray(CAMERA_YAWS, np.float32)):
        c, s = np.cos(off), np.sin(off)
        luts["dx"].append(dx * c - dy * s)
        luts["dy"].append(dx * s + dy * c)
        luts["dz"].append(dz + 0.0)
        luts["u"].append(np.broadcast_to(
            np.arange(VIEW_W, dtype=np.float32)[None, :], (VIEW_H, VIEW_W)))
        luts["v"].append(np.broadcast_to(
            np.arange(VIEW_H, dtype=np.float32)[:, None], (VIEW_H, VIEW_W)))
        luts["vid"].append(np.full((VIEW_H, VIEW_W), vid, np.float32))

    out = {}
    for k, planes in luts.items():
        flat = np.concatenate([p.ravel() for p in planes])
        flat = np.pad(flat, (0, TILE[0] * TILE[1] - flat.size),
                      constant_values=(-1.0 if k == "vid" else 0.0))
        out[k] = flat.reshape(TILE)
    return out


_LUT_CACHE: Dict[str, Dict[str, torch.Tensor]] = {}


def ground_distance(dz: np.ndarray) -> np.ndarray:
    """Per-ray distance to the ground, as the JAX kernel computes it in
    every pixel: -CAMERA_HEIGHT / dz (an IEEE float32 division) for rays
    below the horizon (dz < -1e-4), else 1e6, then capped at MAX_DEPTH.
    It is below MAX_DEPTH exactly when the ray meets the ground nearer."""
    dz = np.asarray(dz, np.float32)
    below = dz < np.float32(-1e-4)
    t_g = np.where(below, np.float32(-CAMERA_HEIGHT) / np.where(below, dz, np.float32(-1.0)),
                   np.float32(1e6))
    return np.minimum(t_g, np.float32(MAX_DEPTH)).astype(np.float32)


def lut_tensors(device) -> Dict[str, torch.Tensor]:
    """The LUT on `device`, unpadded: `rays` (3, 8100) = dx, dy, dz rows,
    and u, v, vid (8100,) each; and the CUDA kernel's `kernel_lut` (4, 8100)
    = dx, dy, dz and the ground distance of each ray."""
    key = str(torch.device(device))
    if key not in _LUT_CACHE:
        # float32, as the JAX package hands the (float64-built) LUT to Pallas
        lut = {k: v.reshape(-1)[:N_PIX].astype(np.float32)
               for k, v in _build_lut().items()}
        rays = np.stack([lut["dx"], lut["dy"], lut["dz"]])
        _LUT_CACHE[key] = dict(
            rays=torch.as_tensor(rays, device=device).contiguous(),
            kernel_lut=torch.as_tensor(np.concatenate([rays, ground_distance(lut["dz"])[None]]),
                                       device=device).contiguous(),
            u=torch.as_tensor(lut["u"].copy(), device=device),
            v=torch.as_tensor(lut["v"].copy(), device=device),
            vid=torch.as_tensor(lut["vid"].copy(), device=device))
    return _LUT_CACHE[key]


def _flat_to_planes(flat: torch.Tensor, with_depth: bool) -> torch.Tensor:
    """(B, C, 8100) per-pixel values in (view, row, column) order ->
    (B, C, 45, 180) planar storage, the log-depth plane kept for the front
    view only (the reference's single depth camera, core/carla_env.py:285-287)."""
    b, c = flat.shape[0], flat.shape[1]
    img = flat.reshape(b, c, 3, VIEW_H, VIEW_W)
    if with_depth:
        keep = torch.tensor([0, 1, 0], dtype=img.dtype, device=img.device)
        img = torch.cat([img[:, :3], img[:, 3:] * keep[:, None, None]], dim=1)
    return img.permute(0, 1, 3, 2, 4).reshape(b, c, VIEW_H, 3 * VIEW_W)


def tile_to_planes(planes: torch.Tensor, with_depth: bool = False) -> torch.Tensor:
    """(B, C, 64, 128) TPU-tile planes -> (B, C', 45, 180) uint8 planar
    storage (C' = 4 with depth, else 3): the epilogue the CUDA kernel folds
    in."""
    c = 4 if with_depth else 3
    flat = planes[:, :c].reshape(planes.shape[0], c, -1)[..., :N_PIX]
    return _flat_to_planes(flat, with_depth).to(torch.uint8)


# ------------------------------------------------------------------
# plain PyTorch version (the CPU path and the kernel's yardstick)
# ------------------------------------------------------------------

def world_rays(geom: torch.Tensor):
    """(dx, dy, dz): each world's LUT rays rotated by its ego yaw, (B, 8100)
    each (dz is the LUT's, (1, 8100))."""
    lut = lut_tensors(geom.device)
    cos_y, sin_y = geom[:, _O_EGO + 2:_O_EGO + 3], geom[:, _O_EGO + 3:_O_EGO + 4]
    dxc, dyc, dz = lut["rays"][0][None], lut["rays"][1][None], lut["rays"][2][None]
    return dxc * cos_y - dyc * sin_y, dxc * sin_y + dyc * cos_y, dz


def building_depth(geom: torch.Tensor, dx, dy, dz) -> torch.Tensor:
    """(B, 8100) distance along each ray to the nearest building it hits
    (exact ray/box with height), 1e6 where it hits none."""
    def g(i):
        return geom[:, i:i + 1]

    ex, ey = g(_O_EGO), g(_O_EGO + 1)
    inv_dx = 1.0 / torch.where(torch.abs(dx) < 1e-6, 1e-6, dx)
    inv_dy = 1.0 / torch.where(torch.abs(dy) < 1e-6, 1e-6, dy)
    t_b = torch.full((geom.shape[0], N_PIX), 1e6, dtype=torch.float32, device=geom.device)
    for k in range(K_BUILDINGS):
        cx, cy = g(_O_BLD + 5 * k), g(_O_BLD + 5 * k + 1)
        hw, hh, bh = g(_O_BLD + 5 * k + 2), g(_O_BLD + 5 * k + 3), g(_O_BLD + 5 * k + 4)
        tx0 = (cx - hw - ex) * inv_dx
        tx1 = (cx + hw - ex) * inv_dx
        ty0 = (cy - hh - ey) * inv_dy
        ty1 = (cy + hh - ey) * inv_dy
        t_near = torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1))
        t_far = torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1))
        z = CAMERA_HEIGHT + t_near * dz
        hit = (t_near > 0.5) & (t_near <= t_far) & (z > 0.0) & (z < bh)
        t_b = torch.minimum(t_b, torch.where(hit, t_near, 1e6))
    return t_b


def billboards(geom: torch.Tensor, k: int) -> list:
    """Actor k of each pack projected into the left, front and right views:
    per view (cx, u_c, half_u, v_top, v_bot, live), (B, 1) each: its depth
    along the view axis, the centre and half width of its column span, its
    row span, and whether it shows at all (active and ahead of the camera)."""
    def g(i):
        return geom[:, i:i + 1]

    base = _O_ACT + 8 * k
    ex, ey = g(_O_EGO), g(_O_EGO + 1)
    cos_y, sin_y = g(_O_EGO + 2), g(_O_EGO + 3)
    ax, ay, ok = g(base), g(base + 1), g(base + 2)
    hwid, htop = g(base + 3), g(base + 4)
    rx, ry = ax - ex, ay - ey
    fx0 = rx * cos_y + ry * sin_y
    fy0 = -rx * sin_y + ry * cos_y
    views = []
    for co, so in ((np.cos(o), np.sin(o)) for o in np.asarray(CAMERA_YAWS, np.float32)):
        cx = fx0 * float(co) + fy0 * float(so)
        cy = -fx0 * float(so) + fy0 * float(co)
        denom = torch.clamp(cx, min=0.1)
        u_c = (-cy / denom) * FX + (VIEW_W - 1) / 2.0
        half_u = (hwid / denom) * FX
        v_bot = (CAMERA_HEIGHT / denom) * FX + (VIEW_H - 1) / 2.0
        v_top = ((CAMERA_HEIGHT - htop) / denom) * FX + (VIEW_H - 1) / 2.0
        views.append((cx, u_c, half_u, v_top, v_bot, (cx > 0.8) & (ok > 0.5)))
    return views


def render_planes_plain(geom: torch.Tensor, with_depth: bool = False,
                        n_actors: int = 0) -> torch.Tensor:
    """(B, GEOM_PAD) packs -> (B, C, 45, 180) uint8, in plain PyTorch ops:
    the per-pixel arithmetic of the JAX package's `_render_world`, batched
    over worlds (rows) and pixels (columns)."""
    lut = lut_tensors(geom.device)

    def g(i):
        return geom[:, i:i + 1]                                  # (B, 1)

    def full(val):
        return torch.full((geom.shape[0], N_PIX), val, dtype=torch.float32,
                          device=geom.device)

    def where(c, a, b):
        return torch.where(c, torch.as_tensor(a, dtype=torch.float32,
                                              device=geom.device), b)

    ex, ey = g(_O_EGO), g(_O_EGO + 1)
    cos_y, sin_y = g(_O_EGO + 2), g(_O_EGO + 3)
    w_sun, w_cld = g(_O_WEATHER), g(_O_WEATHER + 1)
    w_rain, w_wet, w_fog = g(_O_WEATHER + 2), g(_O_WEATHER + 3), g(_O_WEATHER + 4)
    rh = g(_O_ROADHALF)

    dx, dy, dz = world_rays(geom)

    # ground intersection
    below = dz < -1e-4
    t_g = torch.where(below, -CAMERA_HEIGHT / torch.where(below, dz, -1.0), 1e6)
    t_g = torch.clamp(t_g, max=MAX_DEPTH)
    gx = ex + t_g * dx
    gy = ey + t_g * dy

    # min distance to the road segments
    d2 = full(1e12)
    t_at = full(0.0)
    for k in range(K_EDGES):
        x0, y0 = g(_O_SEGS + 4 * k), g(_O_SEGS + 4 * k + 1)
        x1, y1 = g(_O_SEGS + 4 * k + 2), g(_O_SEGS + 4 * k + 3)
        sx, sy = x1 - x0, y1 - y0
        L2 = torch.clamp(sx * sx + sy * sy, min=1e-9)
        rx, ry = gx - x0, gy - y0
        t = torch.clamp((rx * sx + ry * sy) / L2, 0.0, 1.0)
        ddx, ddy = rx - t * sx, ry - t * sy
        d = ddx * ddx + ddy * ddy
        closer = d < d2
        t_at = torch.where(closer, t * torch.sqrt(L2), t_at)
        d2 = torch.where(closer, d, d2)
    d_road = torch.sqrt(d2)

    dashed = torch.remainder(torch.floor(t_at / 2.0), 2) == 0
    lane_div = (rh > LANE_W + 1.0) & (torch.abs(d_road - LANE_W) < 0.12) & dashed
    marking = (((d_road < 0.15) & dashed)
               | (torch.abs(d_road - (rh - 0.2)) < 0.12) | lane_div)
    on_road = d_road < rh
    sidewalk = (d_road >= rh) & (d_road < rh + 2.0)

    # crossings near junctions
    dj2 = full(1e12)
    for k in range(4):
        jx, jy = g(_O_JUNC + 2 * k), g(_O_JUNC + 2 * k + 1)
        dj2 = torch.minimum(dj2, (gx - jx) ** 2 + (gy - jy) ** 2)
    d_j = torch.sqrt(dj2)
    band = (d_j > JUNCTION_RADIUS * 0.85) & (d_j < JUNCTION_RADIUS * 0.85 + 2.0)
    stripes = torch.remainder(torch.floor((gx + gy) / 0.6), 2) == 0
    crossing = band & stripes & on_road

    r_, g_, b_ = full(96.0), full(128.0), full(72.0)
    for col, m in (((158.0, 152.0, 148.0), sidewalk),
                   ((88.0, 88.0, 94.0), on_road),
                   ((228.0, 228.0, 218.0), marking),
                   ((200.0, 200.0, 200.0), crossing)):
        r_, g_, b_ = where(m, col[0], r_), where(m, col[1], g_), where(m, col[2], b_)

    # buildings: exact ray/box with height
    t_b = building_depth(geom, dx, dy, dz)

    # compose ground / building / sky
    sky_r = (135.0 * (1 - w_sun) + 240.0 * w_sun) * (1 - w_cld) + 150.0 * w_cld
    sky_g = (190.0 * (1 - w_sun) + 160.0 * w_sun) * (1 - w_cld) + 152.0 * w_cld
    sky_b = (235.0 * (1 - w_sun) + 110.0 * w_sun) * (1 - w_cld) + 158.0 * w_cld
    rain = 1 - 0.25 * w_rain
    sky_r, sky_g, sky_b = sky_r * rain, sky_g * rain, sky_b * rain

    tg_ok = below & (t_g < MAX_DEPTH)
    t_gm = torch.where(tg_ok, t_g, 1e6)
    use_b = t_b < t_gm
    depth = torch.minimum(t_gm, t_b)
    shade = 1.0 - 0.5 * torch.clamp(t_b / 150.0, 0.0, 1.0)
    r_ = torch.where(use_b, 122.0 * shade, torch.where(tg_ok, r_, sky_r))
    g_ = torch.where(use_b, 102.0 * shade, torch.where(tg_ok, g_, sky_g))
    b_ = torch.where(use_b, 96.0 * shade, torch.where(tg_ok, b_, sky_b))
    road_px = tg_ok & (on_road | marking | crossing) & ~use_b

    # actors: billboards with a depth test, projected per view
    uu, vv, vid = lut["u"][None], lut["v"][None], lut["vid"][None]
    for k in range(n_actors):
        views = billboards(geom, k)
        cx, u_c, half_u, v_top, v_bot, live = (
            torch.where(vid == 0.0, views[0][i], torch.where(vid == 1.0, views[1][i], views[2][i]))
            for i in range(6))
        cover = ((torch.abs(uu - u_c) < half_u) & (vv >= v_top) & (vv <= v_bot)
                 & live & (vid >= 0.0))
        visible = cover & (cx < depth)
        base = _O_ACT + 8 * k
        r_ = torch.where(visible, g(base + 5), r_)
        g_ = torch.where(visible, g(base + 6), g_)
        b_ = torch.where(visible, g(base + 7), b_)
        depth = torch.where(visible, cx, depth)

    # weather shading
    light = 1.0 - 0.35 * w_cld - 0.15 * w_rain
    r_ = r_ * light * (1.0 + 0.25 * w_sun)
    g_ = g_ * light
    b_ = b_ * light * (1.0 - 0.2 * w_sun)
    wet_keep = 1.0 - 0.35 * w_wet
    wet_mix = 0.12 * w_wet
    r_ = torch.where(road_px, r_ * wet_keep + sky_r * wet_mix, r_)
    g_ = torch.where(road_px, g_ * wet_keep + sky_g * wet_mix, g_)
    b_ = torch.where(road_px, b_ * wet_keep + sky_b * wet_mix, b_)
    fog_f = 1.0 - torch.exp(-depth * (0.002 + 0.05 * w_fog))
    r_ = r_ * (1 - fog_f) + sky_r * fog_f
    g_ = g_ * (1 - fog_f) + sky_g * fog_f
    b_ = b_ * (1 - fog_f) + sky_b * fog_f

    # quantize by truncation, as the TPU kernel does
    planes = [torch.clamp(c, 0.0, 255.0) for c in (r_, g_, b_)]
    if with_depth:
        d_m = torch.clamp(depth, max=MAX_DEPTH)
        planes.append(torch.log1p(d_m) * float(DEPTH_SCALE))
    flat = torch.stack(planes, dim=1).to(torch.int32).to(torch.uint8)
    return _flat_to_planes(flat, with_depth)
