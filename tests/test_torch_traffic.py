"""The PyTorch port's NPC traffic (envs/traffic.py) against the JAX package
on the CPU: the spawn (`init_npcs`), the tick (`step_npcs`), the collision
test and the car-following speed, with 50/50 and 100/200 NPCs on Town02 and
with 50/50 on a two-town bank (Town01 + Town02), and one case where half
the walkers may cross and half run.

The JAX functions run vmapped over 8 worlds from JAX keys; the port takes
the same random draws, rebuilt from those keys by replicating JAX's splits
(traffic.py:131,183,212,310 and the per-tick split of world.py:341).  The
banks are built once with the port's town module and handed to both sides
(they are equal, tests/test_torch_world.py).

The world with traffic (`reset_world` + `step_world` with auto-resets,
the typed collisions and their penalties) is held against JAX's on Town02
with 50/50 NPCs, an NPC vehicle or walker placed in front of some egos.

Tolerances, from tests/test_torch_world.py: ints, bools, masks and ids
exact; floats 1e-5 + 2.5e-7 relative for one tick from the JAX state; 1e-4
over a free run of 10 ticks.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from carla_driving_rl_agent_tpu.envs import traffic as jtraffic
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.dynamics import tgather

from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import traffic as ttraffic
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.ops import physics as P
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

B = 8
ULP2 = 2.5e-7
EXACT = ("veh_wp", "veh_active", "ped_active", "ped_cross")
# (towns, vehicles, pedestrians, crossing, running)
CASES = {
    "town02-regular": (("Town02",), 50, 50, 0.0, 0.0),
    "town02-dense": (("Town02",), 100, 200, 0.0, 0.0),
    "two-towns-regular-cross-run": (("Town01", "Town02"), 50, 50, 0.5, 0.5),
    # stage s2's fleet: no vehicles, so the one vehicle slot is never active
    "town02-s2": (("Town02",), 0, 50, 0.0, 0.0),
}


@pytest.fixture(scope="module")
def banks():
    """{towns: (JAX TownDev, port TownDev)}; the two-town bank first, so
    that the single-town one reuses its built Town02."""
    out = {}
    for towns in (("Town01", "Town02"), ("Town02",)):
        bank = ttown.build_town_bank(list(towns))
        jt = jworld.TownDev(**{f: jnp.asarray(getattr(bank, f)) for f in jworld.TownDev._fields})
        out[towns] = (jt, tworld.town_dev(bank, "cpu"))
    return out


def _t(a, dtype=None):
    a = np.array(a)
    if dtype is None:
        dtype = torch.int64 if a.dtype == np.int32 else None
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype is not None else t


def _goal_draws(key, n_wp, p_max):
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.randint(k1, (p_max,), 0, jnp.maximum(n_wp, 1)),
            jnp.sign(jax.random.normal(k2, (p_max,))), jax.random.uniform(k3, (p_max,)))


def _to_goal(g):
    return ttraffic.GoalDraws(wp=_t(g[0]), side=_t(g[1]), offset=_t(g[2]))


def jax_reset_draws(keys, jt, tid, v_max, p_max):
    """The draws of jtraffic.init_npcs(key, ...) per world, as NPCResetDraws."""
    def one(key, t):
        k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
        n_wp = tgather(jt.num_wp, t)
        return (jax.random.randint(k1, (v_max,), 0, jnp.maximum(tgather(jt.num_spawn, t), 1)),
                jax.random.randint(k2, (p_max,), 0, jnp.maximum(n_wp, 1)),
                jnp.sign(jax.random.normal(k3, (p_max,))), jax.random.uniform(k4, (p_max,)),
                jax.random.uniform(k6, (p_max,)), _goal_draws(k5, n_wp, p_max),
                jax.random.uniform(k5, (p_max,)), jax.random.uniform(k7, (p_max,)))
    d = jax.vmap(one)(keys, tid)
    return ttraffic.NPCResetDraws(spawn=_t(d[0]), ped_wp=_t(d[1]), ped_side=_t(d[2]),
                                  ped_offset=_t(d[3]), cross=_t(d[4]), goal=_to_goal(d[5]),
                                  walk=_t(d[6]), run=_t(d[7]))


def jax_step_draws(keys, jt, tid, v_max, p_max):
    """The draws of jtraffic.step_npcs(key, ...) per world, as NPCStepDraws."""
    def one(key, t):
        k_branch, key = jax.random.split(key)
        k_goal, _ = jax.random.split(key)
        return (jax.random.randint(k_branch, (v_max,), 0, 3),
                _goal_draws(k_goal, tgather(jt.num_wp, t), p_max))
    d = jax.vmap(one)(keys, tid)
    return ttraffic.NPCStepDraws(branch=_t(d[0]), goal=_to_goal(d[1]))


def to_torch_npc(jn):
    return ttraffic.NPCState(*(_t(getattr(jn, f)) for f in ttraffic.NPCState._fields))


def assert_npc(tn, jn, atol, where):
    for f in ttraffic.NPCState._fields:
        got, want = getattr(tn, f).numpy(), np.asarray(getattr(jn, f))
        if f in EXACT:
            np.testing.assert_array_equal(got, want, f"{where} {f}")
        else:
            np.testing.assert_allclose(got, want, rtol=ULP2, atol=atol, err_msg=f"{where} {f}")


def _setup(jt, n_towns, seed):
    """Each world's town, its ego on a spawn point (so that the 20 m
    keep-out deactivates some vehicles), and the generator after them."""
    rng = np.random.default_rng(seed)
    tid = rng.integers(0, n_towns, B).astype(np.int32)
    spawn = np.array([rng.integers(0, int(jt.num_spawn[t])) for t in tid])
    ego = np.asarray(jt.spawn_xy)[tid, spawn].astype(np.float32)
    return tid, ego, rng


def _jax_init(jt, tid, ego, nv, npd, crossing, running, key):
    v_max, p_max = max(nv, 1), max(npd, 1)
    keys = jax.random.split(key, B)
    jn = jax.vmap(lambda k, t, e: jtraffic.init_npcs(
        k, jt, t, nv, npd, e, v_max=v_max, p_max=p_max, crossing=crossing,
        running=running))(keys, jnp.asarray(tid), jnp.asarray(ego))
    return jn, jax_reset_draws(keys, jt, jnp.asarray(tid), v_max, p_max)


@pytest.mark.parametrize("case", list(CASES))
def test_init_npcs_matches_jax(banks, case):
    towns, nv, npd, crossing, running = CASES[case]
    init_npcs_vs_jax(*banks[towns], len(towns), nv, npd, crossing, running, seed=len(case))


def init_npcs_vs_jax(jt, tt, n_towns, nv, npd, crossing=0.0, running=0.0, seed=0):
    """The spawn of `nv` vehicles and `npd` walkers in B worlds over the
    bank's `n_towns` towns from JAX's keys, held to the one-tick bar."""
    tid, ego, _ = _setup(jt, n_towns, seed)
    jn, draws = _jax_init(jt, tid, ego, nv, npd, crossing, running, jax.random.PRNGKey(1))
    tn = ttraffic.init_npcs(draws, tt, _t(tid), torch.from_numpy(ego), nv, npd,
                            crossing=crossing, running=running)
    assert_npc(tn, jn, 1e-5, "init")
    on = tn.veh_active.sum(1)
    if nv:
        assert (on > 0).all() and (on < nv).any(), "the keep-out and duplicates deactivate none"
    else:
        assert tn.veh_active.shape == (B, 1) and not bool(on.any())
    assert int(tn.ped_active.sum()) == B * npd
    if crossing:
        assert 0 < float(tn.ped_cross.mean()) < 1
        assert float(tn.ped_speed.max()) > ttraffic.PED_RUN_MIN
        assert float(tn.ped_speed.min()) < ttraffic.PED_SPEED_MAX


@pytest.mark.parametrize("case", list(CASES))
def test_step_npcs_matches_jax(banks, case):
    """24 ticks of JAX, each tick of the port from the JAX state held to
    the one-tick bar, and the port free-running the first 10 ticks held to
    1e-4.  Half the walkers start near their goal, so that they reach it
    and draw new ones; the egos drive through the traffic.  On these
    one-lane towns no vehicle changes lanes."""
    towns, nv, npd, crossing, running = CASES[case]
    changes = step_npcs_vs_jax(*banks[towns], len(towns), nv, npd, crossing, running,
                               seed=len(case))
    assert changes == (0, 0), changes


def step_npcs_vs_jax(jt, tt, n_towns, nv, npd, crossing=0.0, running=0.0, seed=0):
    """24 ticks of JAX's step_npcs against the port's, as
    test_step_npcs_matches_jax describes; returns JAX's lane changes over
    them, (left, right), as chip_smoke.npc_lane_changes counts them."""
    tid, ego, rng = _setup(jt, n_towns, seed)
    v_max, p_max = max(nv, 1), max(npd, 1)
    jn, _ = _jax_init(jt, tid, ego, nv, npd, crossing, running, jax.random.PRNGKey(2))
    near = rng.uniform(-1.5, 1.5, (B, p_max, 2)).astype(np.float32)
    half = (np.arange(p_max) % 2 == 0)[None, :, None]
    jn = jn._replace(ped_goal=jnp.where(half, jn.ped_xy + near, jn.ped_goal))
    sim_time = rng.uniform(0.0, 24.0, B).astype(np.float32)
    ego_yaw = rng.uniform(-np.pi, np.pi, B).astype(np.float32)
    ego_v = rng.uniform(0.0, 8.0, B).astype(np.float32)
    jtid = jnp.asarray(tid)

    @jax.jit
    def jtick(keys, n, t, exy, ev, eyaw):
        return jax.vmap(lambda k, s, ti, tm, e, v, y: jtraffic.step_npcs(
            k, s, jt, ti, tm, e, v, y))(keys, n, jtid, t, exy, ev, eyaw)

    key = jax.random.PRNGKey(3)
    free = to_torch_npc(jn)
    moved = reached = 0
    changes = np.zeros(2, np.int64)
    tables = {f: np.asarray(getattr(jt, f)) for f in chip_smoke.LANE_TABLES}
    for i in range(24):
        key, k = jax.random.split(key)
        keys = jax.random.split(k, B)
        t = sim_time + i / 30.0
        exy = ego + (i / 30.0) * ego_v[:, None] * np.stack([np.cos(ego_yaw), np.sin(ego_yaw)], -1)
        exy = exy.astype(np.float32)
        jnext = jtick(keys, jn, jnp.asarray(t), jnp.asarray(exy), jnp.asarray(ego_v),
                      jnp.asarray(ego_yaw))
        draws = jax_step_draws(keys, jt, jtid, v_max, p_max)
        args = (tt, _t(tid), torch.from_numpy(t), torch.from_numpy(exy),
                torch.from_numpy(ego_v))
        one = ttraffic.step_npcs(draws, to_torch_npc(jn), *args)
        assert_npc(one, jnext, 1e-5, f"tick {i}")
        if i < 10:
            free = ttraffic.step_npcs(draws, free, *args)
            assert_npc(free, jnext, 1e-4, f"free tick {i}")
        moved += int((np.asarray(jnext.veh_wp) != np.asarray(jn.veh_wp)).sum())
        reached += int((np.asarray(jnext.ped_goal) != np.asarray(jn.ped_goal)).any(-1).sum())
        changes += chip_smoke.npc_lane_changes(tables, tid, np.asarray(jn.veh_wp),
                                               np.asarray(jnext.veh_wp),
                                               np.asarray(jn.veh_active) > 0)
        jn = jnext
    v = np.asarray(jn.veh_v)[np.asarray(jn.veh_active) > 0]
    assert reached > 0, reached
    if nv:
        assert moved > 0, moved
        assert v.max() > 0.5 and (v < 0.05).any(), "no vehicle drove, or none was held"
    else:
        assert v.size == 0 and not np.asarray(jn.veh_v).any(), "an inactive vehicle moved"
    return tuple(int(c) for c in changes)


WORLD = dict(town_names=("Town02",), num_routes=8, max_timesteps=6, weather_ids=(1, 5, 9),
             num_vehicles=50, num_pedestrians=50, v_max=50, p_max=50)
# (vehicles, pedestrians) of the world tests, and what stands just ahead of
# egos 0-2 at the first step: (an NPC vehicle, a walker)
WORLD_FLEETS = {"50/50": (50, 50, ((True, False), (False, True), (True, True))),
                "s2-0/50": (0, 50, ((False, True),) * 3)}
WORLD_INT = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode",
             "should_terminate")
WORLD_FLOAT = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
               "sim_time", "total_reward", "collision_penalty")


@pytest.fixture(scope="module")
def world_data(banks):
    """(JAX params, town, routes), (port params, town, routes) of a 50/50
    Town02 world; the JAX route banks are the port's arrays (equal,
    tests/test_torch_world.py).  The routes do not depend on the fleet."""
    tp = tworld.WorldParams(**WORLD)
    tt, tr = tworld.build_world_data(tp, "cpu")
    xyy = tr.xyy.numpy()
    jr = jworld.RoutesDev(xy=jnp.asarray(xyy[..., :2]), yaw=jnp.asarray(xyy[..., 2]),
                          option=jnp.zeros(xyy.shape[:3], jnp.int32),
                          length=jnp.asarray(tr.length.numpy().astype(np.int32)),
                          xyy=jnp.asarray(xyy), start=jnp.asarray(tr.start.numpy()),
                          end_xy=jnp.asarray(tr.end_xy.numpy()))
    return (jworld.WorldParams(**WORLD), banks[("Town02",)][0], jr), (tp, tt, tr)


def _world_draws(d, jt, tid, v_max=50, p_max=50):
    """Port ResetDraws from a vmapped jworld._reset_draws (k_npc included)."""
    tid_, wid, rid, _, _, st, k_npc, _ = d
    return tworld.ResetDraws(_t(tid_), _t(wid), _t(rid), _t(st),
                             npc=jax_reset_draws(k_npc, jt, tid_, v_max, p_max))


def _torch_world(js):
    return tworld.WorldState(**{f: _t(getattr(js, f)) for f in tworld.WorldState._fields
                                if f != "npc"}, npc=to_torch_npc(js.npc))


def _assert_world(ts, js, atol, where):
    for f in WORLD_INT:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      f"{where} {f}")
    for f in WORLD_FLOAT:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=ULP2, atol=atol, err_msg=f"{where} {f}")
    assert_npc(ts.npc, js.npc, atol, where)


def test_world_with_traffic_matches_jax(world_data, rng):
    """reset_world and step_world with NPCs and auto-resets against JAX's;
    in world 0 an NPC vehicle, in world 1 a walker and in world 2 both stand
    just ahead of the ego at the first step, so that the step hits them:
    terminated, with penalty 500, 1000 and 1500."""
    _world_with_traffic(world_data, rng, "50/50")


def test_world_with_s2_fleet_matches_jax(world_data, rng):
    """The same with stage s2's fleet (no vehicles: one never-active
    vehicle slot; 50 walkers), a walker just ahead of egos 0-2 at the
    first step (penalty 1000 each)."""
    _world_with_traffic(world_data, rng, "s2-0/50")


def _world_with_traffic(world_data, rng, fleet):
    nv, npd, ahead_of = WORLD_FLEETS[fleet]
    (jp, jt, jr), (tp, tt, tr) = world_data
    fleet_kw = dict(num_vehicles=nv, num_pedestrians=npd, v_max=max(nv, 1), p_max=npd)
    jp, tp = dataclasses.replace(jp, **fleet_kw), dataclasses.replace(tp, **fleet_kw)
    v_max, p_max = tp.v_max, tp.p_max
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js = jax.vmap(lambda k: jworld.reset_world(k, jp, jt, jr))(keys)
    d = jax.vmap(lambda k: jworld._reset_draws(k, jp, jt, jr))(keys)
    ts = tworld.reset_world(_world_draws(d, jt, d[0], v_max, p_max), tr, town=tt, params=tp)
    _assert_world(ts, js, 1e-5, "reset")
    # place the NPCs in front of egos 0-2, and the egos in the free run too
    fwd = np.stack([np.cos(np.asarray(js.yaw)), np.sin(np.asarray(js.yaw))], -1)
    ahead = np.stack([np.asarray(js.x), np.asarray(js.y)], -1) + 2.0 * fwd
    npc = jax.tree_util.tree_map(np.array, js.npc)
    for w, (veh, ped) in enumerate(ahead_of):
        if veh:
            npc.veh_xy[w, 0], npc.veh_yaw[w, 0], npc.veh_active[w, 0] = ahead[w], js.yaw[w], 1.0
        if ped:
            npc.ped_xy[w, 0], npc.ped_active[w, 0] = ahead[w] - 0.5 * fwd[w], 1.0
    js = js._replace(npc=jax.tree_util.tree_map(jnp.asarray, npc))
    ts = ts._replace(npc=to_torch_npc(npc))

    @jax.jit
    def jstep(js, act):
        w, r, term, trunc, info = jax.vmap(
            lambda s, a: jworld.step_world(s, a, jp, jt, jr))(js, act)
        done = term | trunc
        reset_keys = jax.vmap(lambda k: jax.random.split(k)[0])(w.key)
        fresh = jax.vmap(lambda k, e: jworld.reset_world(k, jp, jt, jr, episode=e))(
            reset_keys, w.episode + 1)
        d = jax.vmap(lambda k: jworld._reset_draws(k, jp, jt, jr))(reset_keys)
        merged = jax.tree_util.tree_map(
            lambda a, b: jnp.where(done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b),
            fresh, w)
        return merged, r, term, trunc, info, d

    def tstep(ts, act, npc_draws, draws):
        w, r, term, trunc, info = tworld.step_world(ts, act, tp, tt, tr, npc_draws)
        fresh = tworld.reset_world(draws, tr, episode=w.episode + 1, town=tt, params=tp)
        return tworld.where_state(term | trunc, fresh, w), r, term, trunc, info

    n_done = 0
    for i in range(10):
        act = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        act[:, 0] = np.abs(act[:, 0])
        k_npc = jax.vmap(lambda k: jax.random.split(k)[1])(js.key)
        npc_draws = jax_step_draws(k_npc, jt, js.town_id, v_max, p_max)
        js_next, jrew, jterm, jtrunc, jinfo, jd = jstep(js, jnp.asarray(act))
        draws = _world_draws(jd, jt, jd[0], v_max, p_max)
        one, r1, te1, tr1, info1 = tstep(_torch_world(js), torch.from_numpy(act), npc_draws,
                                         draws)
        for k in ("hit_vehicle", "hit_pedestrian", "hit_other", "collision"):
            np.testing.assert_array_equal(info1[k].numpy(), np.asarray(jinfo[k]), f"{i} {k}")
        np.testing.assert_array_equal(te1.numpy(), np.asarray(jterm), f"step {i} term")
        np.testing.assert_array_equal(tr1.numpy(), np.asarray(jtrunc), f"step {i} trunc")
        np.testing.assert_allclose(r1.numpy(), np.asarray(jrew), rtol=ULP2, atol=1e-5)
        _assert_world(one, js_next, 1e-5, f"one step {i}")
        ts, rr, tte, _, _ = tstep(ts, torch.from_numpy(act), npc_draws, draws)
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jterm), f"free step {i}")
        np.testing.assert_allclose(rr.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
        _assert_world(ts, js_next, 1e-4, f"free step {i}")
        if i == 0:
            veh, ped = (list(c) for c in zip(*ahead_of))
            np.testing.assert_array_equal(np.asarray(jinfo["hit_vehicle"])[:3], veh)
            np.testing.assert_array_equal(np.asarray(jinfo["hit_pedestrian"])[:3], ped)
            np.testing.assert_array_equal(rr.numpy()[:3],
                                          [-500.0 * v - 1000.0 * p for v, p in ahead_of])
        n_done += int(np.sum(np.asarray(jterm | jtrunc)))
        js = js_next
    assert n_done >= B, "the rollout exercised too few auto-resets"


def test_collision_check_matches_jax(rng):
    """Egos among NPCs placed around them, some inside the collision
    discs, inactive ones among them."""
    n, V, Pn = 64, 6, 5
    ego = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    npc = jtraffic.NPCState(
        veh_xy=(ego[:, None] + rng.uniform(-4.5, 4.5, (n, V, 2))).astype(np.float32),
        veh_yaw=rng.uniform(-np.pi, np.pi, (n, V)).astype(np.float32),
        veh_v=np.zeros((n, V), np.float32), veh_wp=np.zeros((n, V), np.int32),
        veh_active=(rng.random((n, V)) < 0.7).astype(np.float32),
        ped_xy=(ego[:, None] + rng.uniform(-3.0, 3.0, (n, Pn, 2))).astype(np.float32),
        ped_goal=np.zeros((n, Pn, 2), np.float32), ped_speed=np.ones((n, Pn), np.float32),
        ped_active=(rng.random((n, Pn)) < 0.7).astype(np.float32),
        ped_cross=np.zeros((n, Pn), np.float32))
    jv, jp, _ = jax.vmap(lambda e, y, s: jtraffic.collision_check(e, y, s, jnp.float32(0.0)))(
        jnp.asarray(ego), jnp.asarray(yaw), jax.tree_util.tree_map(jnp.asarray, npc))
    tv, tp = ttraffic.collision_check(torch.from_numpy(ego), torch.from_numpy(yaw),
                                      to_torch_npc(npc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < tv.sum() < n and 0 < tp.sum() < n


def test_ttc_target_speed_matches_jax(rng):
    own, lead = (rng.uniform(0, 15, 4096).astype(np.float32) for _ in range(2))
    d = rng.uniform(0, 60, 4096).astype(np.float32)
    cruise = rng.uniform(20, 60, 4096).astype(np.float32)
    ref = jtraffic.ttc_target_speed(*(jnp.asarray(a) for a in (own, lead, d, cruise)))
    got = ttraffic.ttc_target_speed(*(torch.from_numpy(a) for a in (own, lead, d, cruise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=ULP2, atol=1e-5)


def test_port_draws_lie_in_range(banks):
    """The port's own draws: indices below each world's table sizes, signs
    +-1, uniforms in [0, 1); the same generator state gives the same draws."""
    jt, tt = banks[("Town01", "Town02")]
    tid = torch.tensor([0, 1] * 32)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a = ttraffic.npc_reset_draws(g1, tt, tid, 100, 200)
    b = ttraffic.npc_reset_draws(g2, tt, tid, 100, 200)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)
    for idx, n in ((a.spawn, tt.num_spawn), (a.ped_wp, tt.num_wp), (a.goal.wp, tt.num_wp)):
        assert int(idx.min()) >= 0 and (idx < n[tid][:, None]).all()
        assert int(idx.max()) >= int(n.min()) // 2, "indices do not spread over the table"
    assert set(a.ped_side.unique().tolist()) == {-1.0, 1.0}
    s = ttraffic.npc_step_draws(g1, tt, tid, 100, 200)
    assert set(s.branch.unique().tolist()) == {0, 1, 2}
    assert float(s.goal.offset.min()) >= 0 and float(s.goal.offset.max()) < 1


def test_physics_kernel_entries_refuse_npc_worlds():
    """No fallback from the physics kernel on worlds with NPCs: its entry
    points raise on every device (the plain block steps NPC worlds,
    tests/test_torch_curriculum.py)."""
    params = tworld.WorldParams(town_names=("Town02",), num_vehicles=50, num_pedestrians=50,
                                v_max=50, p_max=50)
    for fn in (P.step_physics_batch, P.step_physics_block):
        with pytest.raises(NotImplementedError, match="without NPCs"):
            fn(None, None, params, None, None, None)


def test_zero_npc_draws_draw_nothing_new():
    """Without NPCs, reset_draws and trial_draws hold no NPC draws and take
    from their streams exactly what they took before traffic was ported:
    the values below are the parent tree's for these seeds."""
    params = tworld.WorldParams(town_names=("Town02",), weather_ids=(1, 5, 9))
    routes = types.SimpleNamespace(length=torch.zeros((1, 128), dtype=torch.int64))
    g = torch.Generator().manual_seed(3)
    d = tworld.reset_draws(g, 4, params, routes)
    assert d.npc is None
    assert d.weather_id.tolist() == ZERO_NPC_RESET["weather_id"]
    assert d.route_id.tolist() == ZERO_NPC_RESET["route_id"]
    np.testing.assert_array_equal(d.sim_time.numpy(), np.float32(ZERO_NPC_RESET["sim_time"]))
    assert float(torch.rand((), generator=g)) == np.float32(ZERO_NPC_RESET["next"])
    t = tworld.trial_draws(42, 4, params, routes)
    assert t.npc is None
    assert t.weather_id.tolist() == ZERO_NPC_TRIALS["weather_id"]
    assert t.route_id.tolist() == ZERO_NPC_TRIALS["route_id"]
    np.testing.assert_array_equal(t.sim_time.numpy(), np.float32(ZERO_NPC_TRIALS["sim_time"]))


def test_trial_npc_spawns_do_not_depend_on_the_trial_count(banks):
    """Trial i's NPC spawn is drawn from trial i's own stream, after its
    town, weather, route and light offset: the first 6 trials of 6 and of
    20 spawn alike, and those four draws are the zero-NPC ones."""
    tt = banks[("Town02",)][1]
    params = tworld.WorldParams(town_names=("Town02",), weather_ids=(1, 5, 9),
                                num_vehicles=50, num_pedestrians=50, v_max=50, p_max=50)
    routes = types.SimpleNamespace(length=torch.zeros((1, 128), dtype=torch.int64))
    a = tworld.trial_draws(42, 6, params, routes, tt)
    b = tworld.trial_draws(42, 20, params, routes, tt)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        torch.testing.assert_close(x, y[:6], rtol=0, atol=0)
    bare = tworld.trial_draws(42, 6, tworld.WorldParams(town_names=("Town02",),
                                                        weather_ids=(1, 5, 9)), routes)
    for f in ("town_id", "weather_id", "route_id", "sim_time"):
        assert torch.equal(getattr(a, f), getattr(bare, f)), f
    assert len(set(b.npc.spawn[:, 0].tolist())) > 5


# reset_draws(Generator().manual_seed(3), 4, ...) and trial_draws(42, 4, ...)
# of WorldParams(town_names=("Town02",), weather_ids=(1, 5, 9)) with 128
# routes, computed on the tree before the traffic slice
ZERO_NPC_RESET = dict(weather_id=[5, 9, 5, 1], route_id=[56, 72, 0, 21],
                      sim_time=[14.266109466552734, 21.30855941772461, 10.824751853942871,
                                19.187774658203125], next=0.14984089136123657)
ZERO_NPC_TRIALS = dict(weather_id=[1, 5, 1, 9], route_id=[99, 101, 37, 28],
                       sim_time=[10.533082962036133, 5.903007984161377, 22.84792137145996,
                                 13.362553596496582])
