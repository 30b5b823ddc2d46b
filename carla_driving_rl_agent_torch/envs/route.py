"""Route banks (host) and route following (device, batched over worlds).

Counterpart of carla_driving_rl_agent_tpu/envs/route.py.  Planning happens
on the host once per configuration: routes between spawn points are planned
into fixed-length padded arrays, a RouteBank, by the native A* planner
(native/route_planner.cpp), or with use_native=False by the Python planner
here, a copy of the JAX package's (numpy host code: A* over the lane graph
with an L2 heuristic and zero-cost lane changes, reference
navigation/route_planner.py:174-247; the turn decision from the heading
change, :274-348; the RoadOption annotations, navigation/road_option.py).
At episode reset the world samples a route index.

The route-following functions take the per-world route WINDOW that
world.step_world gathers (the waypoints from the current index on) and
return per-world results; they mirror `make_route_functions` of the JAX
package (reference navigation/route.py:33-93).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

# RoadOption enum — reference navigation/road_option.py:7-33
ROAD_OPTIONS = ("VOID", "LEFT", "RIGHT", "STRAIGHT", "LANE_FOLLOW",
                "CHANGELANELEFT", "CHANGELANERIGHT")
RO_VOID, RO_LEFT, RO_RIGHT, RO_STRAIGHT, RO_LANE_FOLLOW, RO_CL_LEFT, RO_CL_RIGHT = range(7)


def road_option_one_hot(opt: np.ndarray) -> np.ndarray:
    out = np.zeros(opt.shape + (len(ROAD_OPTIONS),), np.float32)
    np.put_along_axis(out, opt[..., None].astype(np.int64), 1.0, axis=-1)
    return out


@dataclass
class RouteBank:
    """Padded fixed-shape routes for one town: (R, L) with `length` marking
    the valid prefix."""
    xy: np.ndarray            # (R, L, 2)
    yaw: np.ndarray           # (R, L)
    option: np.ndarray        # (R, L) int32 RoadOption per waypoint
    length: np.ndarray        # (R,) int32 valid waypoints
    origin_spawn: np.ndarray  # (R,) spawn index used as origin
    max_len: int

    @property
    def num_routes(self) -> int:
        return self.xy.shape[0]


def _lateral_neighbors(town, lane: int) -> List[int]:
    """Adjacent same-direction lanes reachable by a lane change (multi-lane
    towns; empty on single-lane towns)."""
    out = []
    if getattr(town, "lane_left", None) is not None:
        for arr in (town.lane_left, town.lane_right):
            lj = int(arr[lane])
            if lj >= 0:
                out.append(lj)
    return out


def _astar_lanes(town, src_lane: int, dst_lane: int) -> Optional[List[int]]:
    """A* over lane graph; nodes are lane ids, cost = lane length, heuristic =
    L2 between lane endpoints (reference `navigation/route_planner.py:221-247`).

    Lateral (lane-change) edges between parallel lanes carry zero cost,
    mirroring the reference's `_lane_change_link`
    (`navigation/route_planner.py:174-219`)."""
    if src_lane == dst_lane:
        return [src_lane]
    goal_xy = town.wp_xy[town.lane_first_wp[dst_lane]]

    def h(lane):
        return float(np.linalg.norm(town.wp_xy[town.lane_last_wp[lane]] - goal_xy))

    open_heap = [(h(src_lane), 0.0, src_lane)]
    came = {src_lane: None}
    gscore = {src_lane: 0.0}
    while open_heap:
        _, g, lane = heapq.heappop(open_heap)
        if lane == dst_lane:
            path = [lane]
            while came[path[-1]] is not None:
                path.append(came[path[-1]])
            return path[::-1]
        if g > gscore.get(lane, np.inf):
            continue
        succs = [(nxt, float(town.lane_length[nxt]))
                 for nxt in town.lane_successors[lane]]
        succs += [(nxt, 0.0) for nxt in _lateral_neighbors(town, lane)]
        for nxt, cost in succs:
            ng = g + cost
            if ng < gscore.get(nxt, np.inf):
                gscore[nxt] = ng
                came[nxt] = lane
                heapq.heappush(open_heap, (ng + h(nxt), ng, nxt))
    return None


def _turn_option(yaw_in: float, yaw_out: float, threshold_deg: float = 35.0) -> int:
    """Turn decision from heading change (reference uses cross/dot products
    with a threshold — `navigation/route_planner.py:274-348`)."""
    d = np.arctan2(np.sin(yaw_out - yaw_in), np.cos(yaw_out - yaw_in))
    deg = np.degrees(d)
    if abs(deg) < threshold_deg:
        return RO_STRAIGHT
    return RO_LEFT if deg > 0 else RO_RIGHT


def trace_route(town, origin_wp: int, dest_wp: int) -> Optional[dict]:
    """Plan a dense route origin->destination, returning waypoint arrays with
    RoadOption annotations (reference `navigation/route_planner.py:384-436`).

    Lateral hops in the lane path become a short diagonal blend annotated
    CHANGELANELEFT/RIGHT (reference `route_planner.py:449-478` emits the
    change option and continues on the target lane)."""
    src_lane = int(town.wp_lane[origin_wp])
    dst_lane = int(town.wp_lane[dest_wp])
    lane_path = _astar_lanes(town, src_lane, dst_lane)
    if lane_path is None:
        return None

    xs, yaws, opts = [], [], []
    start = None   # wp index to enter the current lane at (None = lane start)
    for i, lane in enumerate(lane_path):
        f, l = int(town.lane_first_wp[lane]), int(town.lane_last_wp[lane])
        if i == 0:
            f = max(f, origin_wp)
        s = f if start is None else max(f, min(start, l))
        start = None
        end = l
        if lane == dst_lane and i == len(lane_path) - 1:
            end = min(l, dest_wp)
        nxt = lane_path[i + 1] if i + 1 < len(lane_path) else None
        if nxt is not None and nxt in _lateral_neighbors(town, lane):
            # lane change: follow briefly, then blend diagonally onto `nxt`
            change_at = min(s + 2, end)
            if change_at > s:
                xs.append(town.wp_xy[s:change_at])
                yaws.append(town.wp_yaw[s:change_at])
                opts.append(np.full(change_at - s, RO_LANE_FOLLOW, np.int32))
            is_left = int(town.lane_left[lane]) == nxt
            mapper = town.wp_left if is_left else town.wp_right
            tgt = int(mapper[change_at])
            if tgt < 0:
                return None   # inconsistent lateral adjacency
            tgt_ahead = min(tgt + 8, int(town.lane_last_wp[nxt]))  # ~15 m
            p0, p1 = town.wp_xy[change_at], town.wp_xy[tgt_ahead]
            n = max(3, int(round(float(np.linalg.norm(p1 - p0)) / 2.0)) + 1)
            t = np.linspace(0.0, 1.0, n)[:-1, None]  # arrival point joins nxt
            blend = (p0[None] * (1 - t) + p1[None] * t).astype(np.float32)
            d = p1 - p0
            byaw = np.full(len(blend), float(np.arctan2(d[1], d[0])), np.float32)
            xs.append(blend)
            yaws.append(byaw)
            opts.append(np.full(len(blend),
                                RO_CL_LEFT if is_left else RO_CL_RIGHT, np.int32))
            start = tgt_ahead
            continue
        if end < s:
            continue
        seg_xy = town.wp_xy[s:end + 1]
        seg_yaw = town.wp_yaw[s:end + 1]
        is_connector = bool(town.lane_src[lane] == town.lane_dst[lane])
        if is_connector and len(seg_yaw) > 0:
            opt = _turn_option(float(seg_yaw[0]), float(seg_yaw[-1]))
        else:
            opt = RO_LANE_FOLLOW
        xs.append(seg_xy)
        yaws.append(seg_yaw)
        opts.append(np.full(len(seg_xy), opt, np.int32))
    if not xs:
        return None
    xy = np.concatenate(xs)
    yaw = np.concatenate(yaws)
    option = np.concatenate(opts)
    return dict(xy=xy.astype(np.float32), yaw=yaw.astype(np.float32), option=option)


def build_route_bank(town, num_routes: int, max_len: int = 512,
                     origin_spawns: Optional[Sequence[int]] = None,
                     min_waypoints: int = 40, seed: int = 42,
                     use_native: bool = True) -> RouteBank:
    """Pre-plan `num_routes` routes between spawn points: origins from
    `origin_spawns` (stage s1's 10 seeded origins, reference
    core/learning.py:311-339) or any spawn point, random destinations
    (reference rl/environments/carla/environment.py:487-529).  With the
    native planner (the JAX package's default, so both build the same
    bank; it raises where it cannot build), or with use_native=False the
    Python planner, drawing from numpy's default_rng(seed) as the JAX
    package's Python planner does."""
    if use_native:
        from carla_driving_rl_agent_torch import native
        return native.build_route_bank_native(
            town, num_routes=num_routes, max_len=max_len,
            origin_spawns=list(origin_spawns) if origin_spawns else None,
            min_waypoints=min_waypoints, seed=seed)

    rng = np.random.default_rng(seed)
    n_spawn = len(town.spawn_wp)
    if origin_spawns is None:
        origin_spawns = list(range(n_spawn))
    origin_spawns = list(origin_spawns)

    xys = np.zeros((num_routes, max_len, 2), np.float32)
    yaws = np.zeros((num_routes, max_len), np.float32)
    opts = np.zeros((num_routes, max_len), np.int32)
    lens = np.zeros((num_routes,), np.int32)
    origins = np.zeros((num_routes,), np.int32)

    built = 0
    attempts = 0
    while built < num_routes and attempts < num_routes * 40:
        attempts += 1
        o = int(origin_spawns[int(rng.integers(0, len(origin_spawns)))])
        d = int(rng.integers(0, n_spawn))
        if o == d:
            continue
        r = trace_route(town, int(town.spawn_wp[o]), int(town.spawn_wp[d]))
        if r is None or len(r["xy"]) < min_waypoints:
            continue
        L = min(len(r["xy"]), max_len)
        xys[built, :L] = r["xy"][:L]
        yaws[built, :L] = r["yaw"][:L]
        opts[built, :L] = r["option"][:L]
        # pad tail with the last waypoint so distance queries stay sane
        xys[built, L:] = r["xy"][L - 1]
        yaws[built, L:] = r["yaw"][L - 1]
        opts[built, L:] = r["option"][L - 1]
        lens[built] = L
        origins[built] = o
        built += 1
    if built == 0:
        raise RuntimeError(f"could not build any route for town {town.name}")
    if built < num_routes:
        # recycle built routes to fill the bank (keeps shapes static)
        reps = np.resize(np.arange(built), num_routes)
        xys, yaws, opts = xys[reps], yaws[reps], opts[reps]
        lens, origins = lens[reps], origins[reps]
    return RouteBank(xy=xys, yaw=yaws, option=opts, length=lens,
                     origin_spawn=origins, max_len=max_len)


def distance(xy: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis, as sqrt(dx^2 + dy^2)."""
    d = xy - pos
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def update_index(w_xy: torch.Tensor, rem: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Local route-index advance over the forward window (B, W, 2) that
    starts at the current waypoint and repeats the last waypoint past the
    route end (world._route_window): advance while the next waypoint is
    closer (the monotone-descent rule of navigation/route.py:33-53), never
    past the route end.  `rem` (B,) is the number of waypoints left, >= 1."""
    d = distance(w_xy, pos[:, None])
    closer = d[:, 1:] < d[:, :-1]
    steps = torch.cumprod(closer.to(torch.int64), dim=1).sum(dim=1)
    return torch.minimum(steps, rem - 1)


def next_waypoint_distances(w_xy: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """`navigation` feature (reference core/carla_env.py:366-382): distances
    to the next N waypoints / N over the forward window (B, N, 2), which
    repeats the last waypoint past the route end."""
    return distance(w_xy, pos[:, None]) / w_xy.shape[1]
