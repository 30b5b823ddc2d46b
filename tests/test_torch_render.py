"""The PyTorch port's renderer against the JAX package on the CPU: the ray
LUT, geometry packs, the plain PyTorch render against the Pallas kernel in
interpret mode, the planar layout, and the CUDA kernel's per-pixel math
(csrc/render.cuh, built for the host with g++) against the plain version.

Tolerances: LUT and layouts exact; packs to 1e-5 (cos/sin of the two
frameworks); rendered uint8 planes |diff| <= 2 on > 99 % of pixels, the bar
of tests/test_rasterizer.py (a pixel on a threshold may flip class under a
one-ulp difference).  The kernel's host build is held to the same bar
and, beside it, to an exact share >= 0.9999: it does the plain version's
float32 operations in the same order, so only exp/log1p implementations
may move a pixel.  Its helpers (the parity test, the division through a
hoisted reciprocal) are held to their plain forms bit for bit.  The CUDA
kernel itself, and its helpers as built for the card, are held against the
plain version and the IEEE operations by the two `cuda`-marked tests,
which skip here.  Actors are placed by chip_smoke.with_actors (ahead,
behind, beside, inactive), the set its kernel phase runs on the card, and
pixel_kinds (the render bound's count of what the inputs need) is checked
against what the plain version draws.  With NPC traffic, the packs' actor
rows (the nearest 4 vehicles, then the nearest 4 walkers) equal JAX's
exactly, ties included, and the plain version draws a traffic state as the
Pallas kernel does.
"""

import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from carla_driving_rl_agent_tpu.envs import carla_env as jenv
from carla_driving_rl_agent_tpu.envs import traffic as jtraffic
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.ops import rasterizer_pallas as RP

from carla_driving_rl_agent_torch.envs import carla_env as tenv
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import traffic as ttraffic
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.ops import render as R
from carla_driving_rl_agent_torch.utils.build import csrc, load_library
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

N_WORLDS = 4


def _within(a, b, tol=2, share=0.99):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return (d <= tol).mean() > share, (d <= tol).mean()


@pytest.fixture(scope="module")
def bank():
    return ttown.build_town_bank(["Town02"])


@pytest.fixture(scope="module")
def worlds(bank):
    """World states at random positions inside the town, with weathers."""
    rng = np.random.default_rng(1)
    ext = bank.extent[0]
    n = N_WORLDS
    f32 = np.float32
    x = rng.uniform(0.1, 0.9, n).astype(f32) * ext[0]
    y = rng.uniform(0.1, 0.9, n).astype(f32) * ext[1]
    yaw = rng.uniform(-np.pi, np.pi, n).astype(f32)
    weather = rng.uniform(0.0, 1.0, (n, 5)).astype(f32)
    return x, y, yaw, weather


@pytest.fixture(scope="module")
def packs(bank, worlds):
    """(JAX pack, port pack) of the same worlds; the JAX pack is built from
    the port's bank arrays (the banks are equal, tests/test_torch_world.py)."""
    x, y, yaw, weather = worlds
    jt = types.SimpleNamespace(cell_geom=jnp.asarray(bank.cell_geom),
                               road_half=jnp.asarray(bank.road_half))
    jw = types.SimpleNamespace(x=jnp.asarray(x), y=jnp.asarray(y), yaw=jnp.asarray(yaw),
                               town_id=jnp.zeros(len(x), jnp.int32), npc=None)
    jp = jax.vmap(lambda xx, yy, ww, w5: RP.pack_geometry_banked(
        jt, types.SimpleNamespace(x=xx, y=yy, yaw=ww, town_id=jnp.int32(0), npc=None),
        w5, n_actors=0))(jw.x, jw.y, jw.yaw, jnp.asarray(weather))
    tt = types.SimpleNamespace(cell_geom=torch.from_numpy(bank.cell_geom),
                               road_half=torch.from_numpy(bank.road_half))
    tw = types.SimpleNamespace(x=torch.from_numpy(x), y=torch.from_numpy(y),
                               yaw=torch.from_numpy(yaw),
                               town_id=torch.zeros(len(x), dtype=torch.int64))
    tp = R.pack_geometry_banked(tt, tw, torch.from_numpy(weather))
    return np.asarray(jp), tp


def _with_actors(geom: np.ndarray, n: int) -> np.ndarray:
    """Packs with the first `n` billboards of chip_smoke.ACTOR_PLACES around
    each ego: ahead, behind, beside and inactive (the kernel phase's set)."""
    return chip_smoke.with_actors(torch.from_numpy(np.array(geom)), n).numpy()


def _host_lib():
    vp, i = ctypes.c_void_p, ctypes.c_int
    return load_library("render_host", [csrc("render_host.cpp")], "g++",
                        {"cdrl_render_planes_host": (None, [vp, vp, vp, i, i, i]),
                         "cdrl_render_helpers_host": (None, [vp] * 7 + [i])},
                        extra_deps=[csrc("render.cuh")])


def _exact_share(a, b):
    return float((a == b).mean())


def test_lut_equal():
    jl, tl = RP._build_lut(), R._build_lut()
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], k)
    rays = R.lut_tensors("cpu")["rays"].numpy()
    np.testing.assert_array_equal(
        rays, np.stack([jl[k].reshape(-1)[:R.N_PIX].astype(np.float32)
                        for k in ("dx", "dy", "dz")]))


def test_layout_constants_equal():
    for name in ("GEOM_PAD", "GEOM_SIZE", "_O_ACT", "_O_EGO", "_O_WEATHER",
                 "_O_ROADHALF", "VIEW_H", "VIEW_W", "N_PIX", "K_EDGES",
                 "K_BUILDINGS", "K_ACTORS"):
        assert getattr(R, name) == getattr(RP, name), name


def test_packs_allclose(packs):
    jp, tp = packs
    assert tp.shape == (N_WORLDS, R.GEOM_PAD) and tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_depth,n_actors",
                         [(False, 0), (True, 0), (True, 2), (False, 8), (True, 8)])
def test_plain_render_matches_pallas(packs, with_depth, n_actors):
    """The plain version against the Pallas kernel in interpret mode, with
    billboards ahead, behind, beside and inactive (all K_ACTORS of them)."""
    geom = _with_actors(packs[0], n_actors)
    tiles = RP.render_tiles_grid(jnp.asarray(geom), g_block=N_WORLDS, interpret=True,
                                 n_actors=n_actors, with_depth=with_depth)
    ref = np.asarray(jax.vmap(lambda p: RP.tile_to_planes(p, with_depth=with_depth))(tiles))
    out = R.render_planes_plain(torch.from_numpy(geom), with_depth=with_depth,
                                n_actors=n_actors).numpy()
    assert out.shape == ref.shape == (N_WORLDS, 4 if with_depth else 3, 45, 180)
    assert out.dtype == np.uint8
    ok, share = _within(out, ref)
    assert ok, f"only {share:.4f} of pixels within 2"
    assert out.std() > 10, "render has no structure"
    if n_actors:
        # the billboards show: the same packs without them render otherwise
        bare = R.render_planes_plain(torch.from_numpy(np.array(packs[0])),
                                     with_depth=with_depth).numpy()
        assert (out != bare).any()


@pytest.mark.parametrize("with_depth", [False, True])
def test_tile_to_planes_matches_jax(with_depth, rng):
    tiles = rng.integers(0, 256, (3, 4, 64, 128)).astype(np.uint8)
    ref = np.asarray(jax.vmap(lambda p: RP.tile_to_planes(p, with_depth=with_depth))(
        jnp.asarray(tiles)))
    np.testing.assert_array_equal(
        R.tile_to_planes(torch.from_numpy(tiles), with_depth=with_depth).numpy(), ref)


def test_planes_to_image_and_ordered_stack_match_jax(rng):
    planes = rng.integers(0, 256, (2, 4, 3, 45, 180)).astype(np.uint8)
    ref = np.asarray(jenv.planes_to_image(jnp.asarray(planes), 2, 2))
    np.testing.assert_array_equal(
        tenv.planes_to_image(torch.from_numpy(planes), 2, 2).numpy(), ref)
    ids = np.asarray([[-5, 3, -5, 7], [1, 2, 3, 4]], np.int32)
    slot = np.asarray([1, 2], np.int32)
    ref = np.asarray(jenv.ordered_image_stack(jnp.asarray(planes), jnp.asarray(ids),
                                              jnp.asarray(slot)))
    got = tenv.ordered_image_stack(torch.from_numpy(planes), torch.from_numpy(ids).long(),
                                   torch.from_numpy(slot).long())
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kernel_lut_matches_jax_ground_distance():
    """The kernel LUT: the plain version's three ray rows, and a fourth row
    with each ray's ground distance as the JAX kernel computes it per pixel
    (`_render_world`: where(dz < -1e-4, -2.2 / dz, 1e6), capped at 400)."""
    lut = R.lut_tensors("cpu")
    k = lut["kernel_lut"].numpy()
    assert k.shape == (4, R.N_PIX) and k.dtype == np.float32
    np.testing.assert_array_equal(k[:3], lut["rays"].numpy())
    dz = jnp.asarray(k[2])
    below = dz < -1e-4
    ref = jnp.minimum(jnp.where(below, -RP.CAMERA_HEIGHT / jnp.where(below, dz, -1.0), 1e6),
                      RP.R.MAX_DEPTH)
    np.testing.assert_array_equal(k[3], np.asarray(ref))
    # below MAX_DEPTH exactly where the kernel's ground test (below the
    # horizon and nearer than MAX_DEPTH) holds
    np.testing.assert_array_equal(k[3] < R.MAX_DEPTH,
                                  (k[2] < np.float32(-1e-4)) & (np.asarray(ref) < R.MAX_DEPTH))


@pytest.mark.parametrize("with_depth,n_actors", [(False, 0), (True, 2), (True, 8)])
def test_kernel_math_host_build_matches_plain(packs, with_depth, n_actors):
    """render.cuh's two stages, built for the host and run in the kernel's
    order, against the plain PyTorch version (the CUDA build runs the same
    source), with billboards ahead, behind, beside and inactive."""
    lib = _host_lib()
    geom = np.ascontiguousarray(_with_actors(packs[1].numpy(), n_actors))
    lut = R.lut_tensors("cpu")["kernel_lut"].numpy()
    c = 4 if with_depth else 3
    out = np.zeros((N_WORLDS, c, 45, 180), np.uint8)
    lib.cdrl_render_planes_host(geom.ctypes.data, lut.ctypes.data, out.ctypes.data,
                                N_WORLDS, int(with_depth), n_actors)
    ref = R.render_planes_plain(torch.from_numpy(geom), with_depth=with_depth,
                                n_actors=n_actors).numpy()
    ok, share = _within(out, ref)
    assert ok, f"only {share:.4f} of pixels within 2"
    exact = _exact_share(out, ref)
    assert exact >= 0.9999, f"only {exact:.6f} of values exact"
    if n_actors:
        # the billboards show: the same packs without them render otherwise
        bare = R.render_planes_plain(torch.from_numpy(geom), with_depth=with_depth).numpy()
        assert (out != bare).any()


def _sweep_floats(rng) -> np.ndarray:
    """float32 values for the parity test: uniform in +-5000, +-0, every
    float32 between 2^23 - 64 and 2^25 + 64 (the last binades with odd
    integers and halves) and their negatives, +-1e30, integers and values
    just beside them, and random finite bit patterns."""
    f32 = np.float32
    ints = np.arange(-300, 301, dtype=f32)
    around = [np.nextafter(ints, f32(np.inf)), np.nextafter(ints, f32(-np.inf))]
    lo, hi = np.float32(2.0 ** 23 - 64), np.float32(2.0 ** 25 + 64)
    dense = np.arange(lo.view(np.int32), hi.view(np.int32) + 1, 97, dtype=np.int32).view(f32)
    bits = rng.integers(0, 2 ** 32, 400_000, dtype=np.uint64).astype(np.uint32).view(f32)
    bits = bits[np.isfinite(bits)]
    return np.concatenate([
        rng.uniform(-5000, 5000, 400_000).astype(f32), f32([0.0, -0.0, 1e30, -1e30]),
        dense, -dense, ints, *around, (ints + f32(0.5)), bits]).astype(f32)


def _sweep_quotients(rng):
    """(a, b) float32 pairs for div_rn: the kernel's operands (segment
    projections over L2 from 1e-9 up, sums over 0.6, depths over 150) and
    random pairs over 2^-100..2^100 with normal quotients, both signs."""
    f32 = np.float32
    n = 300_000
    a = np.concatenate([
        rng.uniform(-2e4, 2e4, n), rng.uniform(-1, 1, n) * 10.0 ** rng.uniform(-20, 6, n),
        np.zeros(4), rng.uniform(-1e3, 1e3, n), rng.uniform(0.5, 1e6, n),
        np.sign(rng.uniform(-1, 1, n)) * 2.0 ** rng.uniform(-100, 100, n)]).astype(f32)
    b = np.concatenate([
        rng.uniform(1e-9, 1e5, n), 10.0 ** rng.uniform(-9, 6, n),
        f32([1e-9, 1.0, 150.0, 0.6]), np.full(n, 0.6), np.full(n, 150.0),
        np.sign(rng.uniform(-1, 1, n)) * 2.0 ** rng.uniform(-100, 100, n)]).astype(f32)
    q = a.astype(np.float64) / b.astype(np.float64)
    keep = (a == 0) | (np.abs(q) >= 2.0 ** -125) & (np.abs(q) < 2.0 ** 126)
    return a[keep], b[keep]


def test_kernel_helpers_host_build_match_their_plain_forms(rng):
    """The kernel's parity test against fmodf(floorf(x), 2) == 0, and its
    division through a hoisted reciprocal against a / b, bit for bit; the
    constant reciprocals are float32(1 / x) correctly rounded."""
    lib = _host_lib()
    x = np.ascontiguousarray(_sweep_floats(rng))
    a, b = _sweep_quotients(rng)
    n = max(len(x), len(a))
    x = np.ascontiguousarray(np.resize(x, n))
    a, b = np.ascontiguousarray(np.resize(a, n)), np.ascontiguousarray(np.resize(b, n))
    even, even_ref = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    q, q_ref = np.zeros(n, np.float32), np.zeros(n, np.float32)
    lib.cdrl_render_helpers_host(x.ctypes.data, even.ctypes.data, even_ref.ctypes.data,
                                 a.ctypes.data, b.ctypes.data, q.ctypes.data,
                                 q_ref.ctypes.data, n)
    np.testing.assert_array_equal(even, even_ref)
    np.testing.assert_array_equal(even_ref.astype(bool), np.fmod(np.floor(x), 2) == 0)
    assert 0.2 < even.mean() < 0.8
    np.testing.assert_array_equal(q.view(np.uint32), q_ref.view(np.uint32))
    np.testing.assert_array_equal(q_ref, a / b)
    with open(csrc("render.cuh")) as f:
        src = f.read()
    for name, x_ in (("RCP_0_6", 0.6), ("RCP_150", 150.0)):
        lit = re.search(rf"{name} = (0x[0-9a-fp.+-]+)f;", src).group(1)
        assert np.float32(float.fromhex(lit)) == np.float32(1.0) / np.float32(x_), name


def test_pixel_kinds_partition_the_frames(packs):
    """pixel_kinds (the render bound's count of ground work): every pixel is
    one kind, only rays that meet the ground nearer than MAX_DEPTH show it,
    and every other ray shows the sky unless a building is in the way."""
    geom = packs[1]
    kinds = chip_smoke.pixel_kinds(geom)
    assert kinds["building"] + kinds["ground"] + kinds["sky"] == N_WORLDS * R.N_PIX
    assert kinds["actor"] == kinds["live"] == kinds["row_pixels"] == kinds["covered"] == 0
    ground_rays = int((R.lut_tensors("cpu")["kernel_lut"][3] < R.MAX_DEPTH).sum())
    assert 0 < kinds["ground"] <= N_WORLDS * ground_rays
    assert kinds["sky"] >= N_WORLDS * (R.N_PIX - ground_rays) - kinds["building"]


def test_pixel_kinds_count_the_billboards(packs):
    """pixel_kinds with actors: the pixels it says show an actor are exactly
    those on which the plain version's frame follows the billboards' colour
    (all black, then all white), inside the billboards it counts, inside the
    rows it counts; only active actors count, each live in at most two
    views (it lies ahead of at most one side camera and the front one)."""
    n_actors = R.K_ACTORS
    frames = []
    for colour in (0.0, 255.0):
        geom = torch.from_numpy(_with_actors(packs[1].numpy(), n_actors))
        geom[:, R._O_ACT + 5:R._O_ACT + 8 * n_actors:8] = colour
        geom[:, R._O_ACT + 6:R._O_ACT + 8 * n_actors:8] = colour
        geom[:, R._O_ACT + 7:R._O_ACT + 8 * n_actors:8] = colour
        frames.append(R.render_planes_plain(geom, n_actors=n_actors))
    kinds = chip_smoke.pixel_kinds(geom, n_actors)
    assert sum(kinds[k] for k in ("actor", "building", "ground", "sky")) == N_WORLDS * R.N_PIX
    drawn = int((frames[0] != frames[1]).any(1).sum())
    assert 0 < drawn == kinds["actor"] <= kinds["covered"] <= kinds["row_pixels"]
    places = chip_smoke.ACTOR_PLACES[:n_actors]
    assert kinds["active"] == N_WORLDS * sum(p[2] > 0.5 for p in places)
    assert 0 < kinds["live"] <= 2 * kinds["active"]
    assert kinds["row_pixels"] % R.VIEW_W == 0


def test_wrapper_on_cpu_runs_the_plain_version(packs):
    geom = packs[1]
    before = R.render_planes.launches
    out = R.render_planes(geom)
    assert R.render_planes.launches == before, "a CPU tensor must not count a launch"
    np.testing.assert_array_equal(out.numpy(), R.render_planes_plain(geom).numpy())
    with pytest.raises(ValueError):
        R.render_planes(geom[:, :100])
    with pytest.raises(TypeError):
        R.render_planes(geom.double())


def test_env_renders_through_the_wrapper():
    params = tworld.WorldParams(town_names=("Town02",), num_routes=4)
    env = tenv.CARLAEnv(tenv.CARLAEnvConfig(world=params), device="cpu")
    state, obs = env.reset_batch(3)
    assert state.image_stack.shape == (3, 4, 3, 45, 180)
    assert obs["image"].shape == (3, 4, 90, 360, 3)
    frame = env.render_frame(state.world)
    np.testing.assert_array_equal(state.image_stack[:, -1].numpy(), frame.numpy())


def _fleet(worlds, v, p, active_share, seed):
    """An NPC fleet (numpy, per world) around each ego: positions 3-40 m
    away in every direction, some slots inactive, and exact distance ties
    among active ones (slot 1 on slot 0, walker 2 on walker 1)."""
    x, y, yaw, _ = worlds
    rng = np.random.default_rng(seed)
    n = len(x)
    ego = np.stack([x, y], -1)

    def around(k):
        ang = rng.uniform(-np.pi, np.pi, (n, k))
        r = rng.uniform(3.0, 40.0, (n, k))
        return (ego[:, None] + r[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)
                ).astype(np.float32)

    veh, ped = around(v), around(p)
    if v > 1:
        veh[:, 1] = veh[:, 0]
    if p > 2:
        ped[:, 2] = ped[:, 1]
    f32 = np.float32
    return jtraffic.NPCState(
        veh_xy=veh, veh_yaw=rng.uniform(-np.pi, np.pi, (n, v)).astype(f32),
        veh_v=np.zeros((n, v), f32), veh_wp=np.zeros((n, v), np.int32),
        veh_active=(rng.random((n, v)) < active_share).astype(f32),
        ped_xy=ped, ped_goal=np.zeros((n, p, 2), f32), ped_speed=np.ones((n, p), f32),
        ped_active=(rng.random((n, p)) < active_share).astype(f32),
        ped_cross=np.zeros((n, p), f32))


def _traffic_packs(bank, worlds, fleet, n_actors):
    """(JAX pack, port pack) of the worlds with their NPC fleet."""
    x, y, yaw, weather = worlds
    jt = types.SimpleNamespace(cell_geom=jnp.asarray(bank.cell_geom),
                               road_half=jnp.asarray(bank.road_half))
    jp = jax.vmap(lambda xx, yy, ww, w5, npc: RP.pack_geometry_banked(
        jt, types.SimpleNamespace(x=xx, y=yy, yaw=ww, town_id=jnp.int32(0), npc=npc),
        w5, n_actors=n_actors))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(yaw),
                                jnp.asarray(weather),
                                jax.tree_util.tree_map(jnp.asarray, fleet))
    tt = types.SimpleNamespace(cell_geom=torch.from_numpy(bank.cell_geom),
                               road_half=torch.from_numpy(bank.road_half))
    npc = ttraffic.NPCState(*(torch.from_numpy(np.array(a)) for a in fleet))
    tw = types.SimpleNamespace(x=torch.from_numpy(x), y=torch.from_numpy(y),
                               yaw=torch.from_numpy(yaw),
                               town_id=torch.zeros(len(x), dtype=torch.int64), npc=npc)
    return np.asarray(jp), R.pack_geometry_banked(tt, tw, torch.from_numpy(weather),
                                                  n_actors=n_actors)


def _static_n_actors(v, p):
    """(JAX, port) static actor counts of an env with v vehicles and p
    pedestrians (build_env's slots: max(n, 1))."""
    kw = dict(num_vehicles=v, num_pedestrians=p, v_max=max(v, 1), p_max=max(p, 1))
    return (jenv.CARLAEnv._static_n_actors(types.SimpleNamespace(
                params=jworld.WorldParams(**kw))),
            tenv.CARLAEnv._static_n_actors(types.SimpleNamespace(
                params=tworld.WorldParams(**kw))))


@pytest.mark.parametrize("v,p,active_share", [(50, 50, 0.6), (100, 200, 0.01), (3, 2, 1.0),
                                              (0, 50, 0.5)])
def test_pack_actor_rows_match_jax(bank, worlds, v, p, active_share):
    """The actor block of the pack equals JAX's exactly: the nearest active
    vehicles then walkers, ties (equal distances, inactive slots at 1e9)
    broken toward the lower slot, colours by slot, zero padding; the env's
    static actor count equals JAX's.  With 1 % active slots most rows are
    inactive ties; with 3 vehicles and 2 walkers 3 rows are padding."""
    jn, tn = _static_n_actors(v, p)
    assert jn == tn and tn > 0
    fleet = _fleet(worlds, max(v, 1), max(p, 1), active_share if v else 0.0, seed=v + p)
    if not v:
        fleet = fleet._replace(ped_active=(np.random.default_rng(1).random(
            fleet.ped_active.shape) < active_share).astype(np.float32))
    jp, tp = _traffic_packs(bank, worlds, fleet, tn)
    act = slice(R._O_ACT, R._O_EGO)
    np.testing.assert_array_equal(tp[:, act].numpy(), jp[:, act])
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-5)
    rows = tp[:, act].reshape(N_WORLDS, R.K_ACTORS, 8)
    assert (rows[:, :, 2] == 1).any()
    if active_share < 0.1:
        assert (rows[:, :, 2] == 0).sum() >= 2 * N_WORLDS, "too few inactive ties"
    if v == 3:
        assert bool((rows[:, 5:] == 0).all()) and bool((rows[:, :5, 3] > 0).all())


def test_s2_pack_actor_rows_match_jax(bank, worlds):
    """Stage s2's pack (no vehicles, 50 walkers: 5 actor rows, the vehicle
    row always inactive) from a real spawn, JAX's init_npcs around the egos:
    the actor block equals JAX's exactly, and the kernel's math (its g++
    build) draws those 5 rows as the plain version does."""
    x, y, _, _ = worlds
    jt = jworld.TownDev(**{f: jnp.asarray(getattr(bank, f)) for f in jworld.TownDev._fields})
    ego = jnp.asarray(np.stack([x, y], -1))
    fleet = jax.vmap(lambda k, e: jtraffic.init_npcs(k, jt, jnp.int32(0), 0, 50, e, v_max=1,
                                                     p_max=50))(
        jax.random.split(jax.random.PRNGKey(9), N_WORLDS), ego)
    # walkers 0-2 of each world stand in front of its ego, so that they show
    fwd = np.stack([np.cos(worlds[2]), np.sin(worlds[2])], -1)
    ped = np.array(fleet.ped_xy)
    ped[:, :3] = np.stack([x, y], -1)[:, None] + (np.array([6.0, 9.0, 12.0])[None, :, None]
                                                  * fwd[:, None])
    fleet = jax.tree_util.tree_map(np.asarray, fleet._replace(ped_xy=ped))
    n_actors = _static_n_actors(0, 50)[1]
    assert n_actors == 5
    jp, tp = _traffic_packs(bank, worlds, fleet, n_actors)
    act = slice(R._O_ACT, R._O_EGO)
    np.testing.assert_array_equal(tp[:, act].numpy(), jp[:, act])
    rows = tp[:, act].reshape(N_WORLDS, R.K_ACTORS, 8)
    assert not bool(rows[:, 0, 2].any()), "the vehicle row is active"
    assert bool((rows[:, 1:5, 2] == 1).all()) and not bool(rows[:, 5:].any())
    geom = np.ascontiguousarray(tp.numpy())
    lut = R.lut_tensors("cpu")["kernel_lut"].numpy()
    out = np.zeros((N_WORLDS, 3, 45, 180), np.uint8)
    _host_lib().cdrl_render_planes_host(geom.ctypes.data, lut.ctypes.data, out.ctypes.data,
                                        N_WORLDS, 0, n_actors)
    ref = R.render_planes_plain(tp, n_actors=n_actors).numpy()
    assert _exact_share(out, ref) >= 0.9999 and _within(out, ref)[0]
    bare = R.render_planes_plain(tp, n_actors=0).numpy()
    assert (ref != bare).any(1).sum() > 100, "the walkers do not show"


def test_static_n_actors_without_npcs():
    assert _static_n_actors(0, 0) == (0, 0)


def test_plain_render_of_traffic_matches_pallas(bank, worlds):
    """One traffic state (50/50 NPCs around the egos, the env's static 8
    actor rows): the plain version against the Pallas kernel in interpret
    mode, and the NPCs show."""
    n_actors = _static_n_actors(50, 50)[1]
    jp, tp = _traffic_packs(bank, worlds, _fleet(worlds, 50, 50, 0.8, seed=3), n_actors)
    tiles = RP.render_tiles_grid(jnp.asarray(jp), g_block=N_WORLDS, interpret=True,
                                 n_actors=n_actors)
    ref = np.asarray(jax.vmap(RP.tile_to_planes)(tiles))
    out = R.render_planes_plain(tp, n_actors=n_actors).numpy()
    ok, share = _within(out, ref)
    assert ok, f"only {share:.4f} of pixels within 2"
    bare = R.render_planes_plain(tp, n_actors=0).numpy()
    assert (out != bare).any(1).sum() > 100, "the NPCs do not show"


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(packs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the render kernel runs only on the card")
    for with_depth, n_actors in ((False, 0), (True, 2), (True, 8)):
        geom = torch.from_numpy(_with_actors(packs[1].numpy(), n_actors)).cuda()
        before = R.render_planes.launches
        out = R.render_planes(geom, with_depth=with_depth, n_actors=n_actors)
        torch.cuda.synchronize()
        assert R.render_planes.launches == before + 1
        ref = R.render_planes_plain(geom, with_depth=with_depth, n_actors=n_actors)
        ok, share = _within(out.cpu().numpy(), ref.cpu().numpy())
        assert ok, f"only {share:.4f} of pixels within 2"
        exact = _exact_share(out.cpu().numpy(), ref.cpu().numpy())
        assert exact >= 0.9999, f"only {exact:.6f} of values exact"


@pytest.mark.cuda
def test_cuda_kernel_helpers_match_ieee():
    """The kernel's parity, reciprocal and division helpers as nvcc builds
    them for the card, against the IEEE operations they replace, bit for
    bit (csrc/render_check.cu; on the CPU rcp_rn is a plain division)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the helpers' card build runs only on the card")
    assert chip_smoke.render_helper_mismatches(pair_rounds=1) == [0, 0, 0, 0]
