"""Shared parts of the multi-lane town tests (tests/test_torch_towns_town04.py
and test_torch_towns_town06.py), which hold the port against the JAX package
on the CPU on the two towns with two lanes per direction.  pytest does not
collect this module (its name does not start with test_).

Only Town04 and Town06 fill the lateral links `wp_left` / `wp_right`
(envs/town.py) and widen the road's half-width to two lanes; so only there
do NPC vehicles change lanes (traffic.step_npcs), do planned routes carry
CHANGELANELEFT / CHANGELANERIGHT options (envs/route.py,
native/route_planner.cpp), and do the physics step's off-road test and the
renderer read the wider road.  Each check below builds on the Town02 tests
that hold the same functions (their helpers are imported from those
modules), on the town's own banks:

  * the town data and bank, the lateral links included, and the route
    banks of both planners, lane-change routes asserted;
  * reset and step of the world, each step from JAX's state and a 10-step
    free run (tests/test_torch_world.py);
  * the physics step: JAX's fused Pallas step in interpret mode and its
    XLA step against the port's plain version and the kernel's g++ build
    (tests/test_torch_physics.py);
  * init_npcs and step_npcs with 50/50 and 100/200 NPCs, lane changes
    asserted (tests/test_torch_traffic.py);
  * the render pack's actor rows of a multi-lane traffic state, its plain
    render against the Pallas kernel in interpret mode, and the render
    kernel's g++ build against the plain version
    (tests/test_torch_render.py).

Tolerances are those of the modules named above.  Each side builds its own
town once per test module, in the `sides` fixture (a multi-lane town takes
~40-75 s per build on one CPU core).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
import test_torch_physics as PT
import test_torch_render as RT
import test_torch_traffic as TT
import test_torch_world as WT
from carla_driving_rl_agent_tpu.envs import route as jroute
from carla_driving_rl_agent_tpu.envs import town as jtown
from carla_driving_rl_agent_tpu.envs import traffic as jtraffic
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.ops import rasterizer_pallas as RP

from carla_driving_rl_agent_torch.envs import route as troute
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.ops import render as R

# the NPC fleets of the traffic checks: the evaluation's regular and dense
FLEETS = {"50/50": (50, 50), "100/200": (100, 200)}


@dataclasses.dataclass
class Sides:
    """One town as each side builds it: its data, its one-town bank and the
    bank's device tables."""
    name: str
    jdata: object
    tdata: object
    jbank: object
    tbank: object
    jdev: object
    tdev: object


def build_sides(name: str) -> Sides:
    """Both sides' builds run at once: most of a build is numpy over
    millions of texels, which releases the interpreter lock."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(side.build_town_bank, [name]) for side in (jtown, ttown)]
        jbank, tbank = (b.result() for b in builds)
    jdev = jworld.TownDev(**{f: jnp.asarray(getattr(jbank, f)) for f in jworld.TownDev._fields})
    return Sides(name, jtown.get_town(name), ttown.get_town(name), jbank, tbank, jdev,
                 tworld.town_dev(tbank, "cpu"))


def _assert_equal(a, b, what):
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, what)
    else:
        assert a == b, what


def town_vs_jax(s: Sides) -> None:
    """Every field of the town's data and of its bank equal to JAX's, the
    lanes' lateral links included; the town has two lanes per direction:
    the road half-width of two lanes, left and right links, and each link
    on the lane registered as the neighbour, within two lane widths."""
    for obj, ref in ((s.tdata, s.jdata), (s.tbank, s.jbank)):
        for f in dataclasses.fields(ref):
            _assert_equal(getattr(obj, f.name), getattr(ref, f.name), f"{s.name} {f.name}")
    t = s.tdata
    assert t.road_half == 2 * ttown.LANE_WIDTH + 0.3
    for side, lane in (("wp_left", "lane_left"), ("wp_right", "lane_right")):
        src = np.flatnonzero(getattr(t, side) >= 0)
        assert len(src) > len(t.wp_xy) // 5, f"{side}: {len(src)} waypoints linked"
        dst = getattr(t, side)[src]
        np.testing.assert_array_equal(t.wp_lane[dst], getattr(t, lane)[t.wp_lane[src]])
        assert np.linalg.norm(t.wp_xy[src] - t.wp_xy[dst], axis=1).max() < 2 * ttown.LANE_WIDTH


def route_banks_vs_jax(s: Sides, num_routes: int = 8, seed: int = 42) -> None:
    """The route banks of the native planner and of the Python one equal
    JAX's, and each holds routes with lane changes of both directions."""
    for native in (True, False):
        kw = dict(num_routes=num_routes, max_len=512, seed=seed, use_native=native)
        tb = troute.build_route_bank(s.tdata, **kw)
        jb = jroute.build_route_bank(s.jdata, **kw)
        for f in ("xy", "yaw", "option", "length", "origin_spawn"):
            _assert_equal(getattr(tb, f), getattr(jb, f), f"native={native} {f}")
        valid = np.arange(tb.xy.shape[1])[None] < tb.length[:, None]
        for opt in (troute.RO_CL_LEFT, troute.RO_CL_RIGHT):
            assert ((tb.option == opt) & valid).any(), f"native={native}: no option {opt}"


def world_vs_jax(s: Sides, rng) -> None:
    """The device banks, then reset and 10 steps (tests/test_torch_world.py)."""
    data = WT.world_data(dict(WT.COMMON, town_names=(s.name,)))
    WT.device_banks_equal(data)
    np.testing.assert_array_equal(data[4].road_half.numpy(), s.tbank.road_half)
    WT.reset_and_step_vs_jax(data, rng)


def physics_vs_jax(s: Sides, batch: int = 32) -> None:
    """The physics step of the kernel's arithmetic with the town's road
    half-width (tests/test_torch_physics.py)."""
    envs = PT.physics_envs(dict(PT.COMMON, town_names=(s.name,)))
    np.testing.assert_array_equal(envs[3].road_half.numpy(), s.tbank.road_half)
    PT.physics_step_vs_jax(envs, batch)


def init_npcs_vs_jax(s: Sides, fleet: str) -> None:
    TT.init_npcs_vs_jax(s.jdev, s.tdev, 1, *FLEETS[fleet], seed=4)


def step_npcs_vs_jax(s: Sides, fleet: str) -> tuple:
    """24 NPC ticks (tests/test_torch_traffic.py); the vehicles change lanes
    both ways.  Returns the lane changes, (left, right)."""
    changes = TT.step_npcs_vs_jax(s.jdev, s.tdev, 1, *FLEETS[fleet], seed=4)
    assert min(changes) > 0, f"lane changes (left, right) {changes}"
    return changes


def render_vs_jax(s: Sides, seed: int = 6) -> None:
    """Four egos on spawn points, two on each lane, JAX's dense fleet
    spawned around them, and vehicle 0 of each world on the neighbouring
    lane 4 m ahead:
    the pack's actor rows equal JAX's exactly and its road half-width is
    the town's; the plain render draws the pack as the Pallas kernel does
    in interpret mode, and the kernel's g++ build as the plain version
    (tests/test_torch_render.py's bars); the NPCs show."""
    bank = s.tbank
    spawn = bank.spawn_wp[0, :bank.num_spawn[0]]
    rng = np.random.default_rng(seed)
    pick = np.concatenate([rng.choice(np.flatnonzero(bank.wp_left[0, spawn] >= 0), 2, False),
                           rng.choice(np.flatnonzero(bank.wp_right[0, spawn] >= 0), 2, False)])
    f32 = np.float32
    x, y = bank.spawn_xy[0, pick].T.astype(f32)
    yaw = bank.spawn_yaw[0, pick].astype(f32)
    worlds = (x, y, yaw, rng.uniform(0.0, 1.0, (len(pick), 5)).astype(f32))
    nv, npd = FLEETS["100/200"]
    fleet = jax.vmap(lambda k, e: jtraffic.init_npcs(k, s.jdev, jnp.int32(0), nv, npd, e,
                                                     v_max=nv, p_max=npd))(
        jax.random.split(jax.random.PRNGKey(seed), len(pick)), jnp.asarray(np.stack([x, y], -1)))
    fleet = jax.tree_util.tree_map(np.array, fleet)
    ahead = spawn[pick] + 2
    beside = np.where(bank.wp_left[0, ahead] >= 0, bank.wp_left[0, ahead],
                      bank.wp_right[0, ahead])
    fleet.veh_xy[:, 0], fleet.veh_yaw[:, 0] = bank.wp_xy[0, beside], bank.wp_yaw[0, beside]
    fleet.veh_active[:, 0] = 1.0
    n_actors = RT._static_n_actors(nv, npd)[1]
    jp, tp = RT._traffic_packs(bank, worlds, fleet, n_actors)
    act = slice(R._O_ACT, R._O_EGO)
    np.testing.assert_array_equal(tp[:, act].numpy(), jp[:, act])
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tp[:, R._O_ROADHALF].numpy(), s.tbank.road_half[0])
    tiles = RP.render_tiles_grid(jnp.asarray(jp), g_block=len(pick), interpret=True,
                                 n_actors=n_actors)
    ref = np.asarray(jax.vmap(RP.tile_to_planes)(tiles))
    out = R.render_planes_plain(tp, n_actors=n_actors).numpy()
    ok, share = RT._within(out, ref)
    assert ok, f"plain vs Pallas: only {share:.4f} of pixels within 2"
    geom = np.ascontiguousarray(tp.numpy())
    lut = R.lut_tensors("cpu")["kernel_lut"].numpy()
    host = np.zeros_like(out)
    RT._host_lib().cdrl_render_planes_host(geom.ctypes.data, lut.ctypes.data, host.ctypes.data,
                                           len(pick), 0, n_actors)
    assert RT._exact_share(host, out) >= 0.9999 and RT._within(host, out)[0]
    bare = R.render_planes_plain(tp, n_actors=0).numpy()
    assert ((out != bare).any(1).sum((1, 2)) > 100).all(), "the NPCs do not show in every world"


def marking_ties(geom: torch.Tensor, rel: float = 1e-6) -> np.ndarray:
    """(B, 45, 180) the pixels of the packs `geom` whose ground point lies in
    a dashed marking's band (the centre line, or the lane divider of a
    multi-lane road) and whose two nearest road segments lie at squared
    distances equal to within `rel` (relative, float64): there the segment
    that wins the nearest-segment test, and with it the dash parity,
    depends on float32 rounding.  At a junction node two segments end on
    the same point, so the lane divider's band crosses a ring of such
    ties, which XLA (contracting the distance's sum into a fused
    multiply-add) and PyTorch (as the CUDA kernel, built without
    contraction) break differently (ROADMAP.md, tolerance 3.11)."""
    geom = geom.to(torch.float64)
    dx, dy, dz = (t.to(torch.float64) for t in R.world_rays(geom))
    t_g = torch.clamp(-R.CAMERA_HEIGHT / torch.clamp(dz, max=-1e-4), max=R.MAX_DEPTH)
    gx = geom[:, R._O_EGO:R._O_EGO + 1] + t_g * dx
    gy = geom[:, R._O_EGO + 1:R._O_EGO + 2] + t_g * dy
    d = []
    for k in range(R.K_EDGES):
        x0, y0, x1, y1 = (geom[:, R._O_SEGS + 4 * k + j][:, None] for j in range(4))
        sx, sy = x1 - x0, y1 - y0
        t = torch.clamp(((gx - x0) * sx + (gy - y0) * sy) / torch.clamp(sx * sx + sy * sy,
                                                                         min=1e-9), 0.0, 1.0)
        d.append((gx - x0 - t * sx) ** 2 + (gy - y0 - t * sy) ** 2)
    two = torch.stack(d).sort(dim=0).values[:2]
    d_road = torch.sqrt(two[0])
    band = (d_road < 0.15 + 1e-3) | (torch.abs(d_road - R.LANE_W) < 0.12 + 1e-3)
    tie = (two[1] - two[0] <= rel * two[0]) & band & (dz < -1e-4)
    return R._flat_to_planes(tie[:, None].to(torch.uint8), False)[:, 0].numpy().astype(bool)
