"""The PyTorch port's world core against the JAX package on the CPU:
town and route banks, dynamics, reset and step, on Town02 with 8 routes
and no traffic.

The port takes the JAX package's reset draws (`_reset_draws`) so that the
rest can be compared exactly.  Tolerances, from
tests/test_physics_fused.py:108-127: ints, bools and ids exact; floats to
1e-5 for one step from the same state, plus a relative 2.5e-7 (two
float32 ulps: positions and distances reach ~300 m, where one ulp is 3e-5,
and the two frameworks' sin, cos and atan differ in the last ulp); floats to
1e-4 on a free-running rollout of 10 steps that includes auto-resets.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.envs import dynamics as jdyn
from carla_driving_rl_agent_tpu.envs import route as jroute
from carla_driving_rl_agent_tpu.envs import town as jtown
from carla_driving_rl_agent_tpu.envs import weather as jweather
from carla_driving_rl_agent_tpu.envs import world as jworld

from carla_driving_rl_agent_torch.envs import dynamics as tdyn
from carla_driving_rl_agent_torch.envs import route as troute
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import weather as tweather
from carla_driving_rl_agent_torch.envs import world as tworld

TOWN = "Town02"
B = 16
COMMON = dict(town_names=(TOWN,), num_routes=8, max_timesteps=6,
              weather_ids=tuple(int(i) for i in jweather.weather_ids(jweather.TEST_WEATHERS)))
INT_FIELDS = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode",
              "should_terminate")
FLOAT_FIELDS = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
                "sim_time", "total_reward", "collision_penalty")


def world_data(common: dict) -> tuple:
    """(JAX params, port params, JAX town, JAX routes, port town, port
    routes) of the world configuration `common`, each side's own build."""
    jp = jworld.WorldParams(**common)
    tp = tworld.WorldParams(**common)
    jtown_dev, jroutes = jworld.build_world_data(jp)
    ttown_dev, troutes = tworld.build_world_data(tp, "cpu")
    return jp, tp, jtown_dev, jroutes, ttown_dev, troutes


@pytest.fixture(scope="module")
def data():
    return world_data(COMMON)


def test_weather_tables_equal():
    np.testing.assert_array_equal(tweather.WEATHER_PARAMS, jweather.WEATHER_PARAMS)
    assert tweather.WEATHER_NAMES == jweather.WEATHER_NAMES
    assert tweather.TEST_WEATHERS == jweather.TEST_WEATHERS
    assert tweather.TRAIN_WEATHERS == jweather.TRAIN_WEATHERS


def test_town_bank_equal(data):
    tb = ttown.build_town_bank([TOWN])
    jb = jtown.build_town_bank([TOWN])
    for f in dataclasses.fields(jb):
        a, b = getattr(tb, f.name), getattr(jb, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name


def test_route_bank_equal(data):
    jp = data[0]
    tb = troute.build_route_bank(ttown.get_town(TOWN), num_routes=jp.num_routes,
                                 max_len=jp.max_route_len, seed=jp.seed)
    jb = jroute.build_route_bank(jtown.get_town(TOWN), num_routes=jp.num_routes,
                                 max_len=jp.max_route_len, seed=jp.seed)
    for name in ("xy", "yaw", "option", "length", "origin_spawn"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), name)


def test_device_banks_equal(data):
    device_banks_equal(data)


def device_banks_equal(data):
    _, _, jt, jr, tt, tr = data
    for name, a in tt._asdict().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jt, name)), name)
    for name, a in tr._asdict().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jr, name)), name)


def test_dynamics(rng):
    act = rng.uniform(-1.2, 1.2, (256, 2)).astype(np.float32)
    v = rng.uniform(0.0, 30.0, 256).astype(np.float32)
    xyy = rng.uniform(-50.0, 50.0, (3, 256)).astype(np.float32)
    xyy[2] = rng.uniform(-np.pi, np.pi, 256)
    for tds in (True, False):
        jc = jdyn.actions_to_control(jnp.asarray(act), jnp.asarray(v),
                                     throttle_as_desired_speed=tds)
        tc = tdyn.actions_to_control(torch.from_numpy(act), torch.from_numpy(v),
                                     throttle_as_desired_speed=tds)
        for a, b in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
        jout = jdyn.step_bicycle(*(jnp.asarray(z) for z in xyy), jnp.asarray(v), jc)
        tout = tdyn.step_bicycle(*(torch.from_numpy(z) for z in xyy), torch.from_numpy(v), tc)
        for a, b in zip(tout, jout):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _to_draws(d):
    tid, wid, rid, _, _, st, _, _ = d
    return tworld.ResetDraws(*(torch.as_tensor(np.array(a)).to(t) for a, t in (
        (tid, torch.int64), (wid, torch.int64), (rid, torch.int64), (st, torch.float32))))


def _to_torch_state(js):
    fields = {}
    for name in tworld.WorldState._fields:
        if name == "npc":        # the JAX state's constant zero fleet; the port's is None
            continue
        a = np.array(getattr(js, name))
        fields[name] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
    return tworld.WorldState(**fields)


ULP2 = 2.5e-7


def _assert_state(ts, js, atol, where):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), f"{where} {name}")
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=ULP2, atol=atol, err_msg=f"{where} {name}")


_OBS_FNS = {}


def _assert_obs(tp, jp, ts, js, tt, jt, tr, jr, atol, where):
    # JAX's observation compiled once per configuration (eagerly it compiles
    # one program per operation)
    key = (jp, id(jt), id(jr))
    if key not in _OBS_FNS:
        _OBS_FNS[key] = (jt, jr, jax.jit(jax.vmap(
            lambda w: jworld.vector_observation(w, jp, jt, jr))))
    jobs = _OBS_FNS[key][2](js)
    tobs = tworld.vector_observation(ts, tp, tt, tr)
    for k in ("road", "vehicle", "navigation"):
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), rtol=ULP2,
                                   atol=atol, err_msg=f"{where} {k}")


def test_reset_and_step_match_jax(data, rng):
    reset_and_step_vs_jax(data, rng)


def reset_and_step_vs_jax(data, rng):
    """Reset, then 10 steps of random forward actions with auto-resets:
    each step of the port from the JAX state at the one-step bar, the
    port's free run at 1e-4, the vector observation beside each."""
    jp, tp, jt, jr, tt, tr = data
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    js = jax.jit(jax.vmap(lambda k: jworld.reset_world(k, jp, jt, jr)))(keys)
    draws = jax.jit(jax.vmap(lambda k: jworld._reset_draws(k, jp, jt, jr)))(keys)
    ts = tworld.reset_world(_to_draws(draws), tr)
    _assert_state(ts, js, 1e-6, "reset")
    _assert_obs(tp, jp, ts, js, tt, jt, tr, jr, 1e-6, "reset")

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

    def tstep(ts, act, draws):
        w, r, term, trunc, info = tworld.step_world(ts, act, tp, tt, tr)
        fresh = tworld.reset_world(draws, tr, episode=w.episode + 1)
        return tworld.where_state(term | trunc, fresh, w), r, term, trunc, info

    n_done = 0
    for i in range(10):
        act = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
        act[:, 0] = np.abs(act[:, 0])   # drive forward, so that off-road exits happen
        js_next, jrew, jterm, jtrunc, jinfo, jd = jstep(js, jnp.asarray(act))
        draws = _to_draws(jd)
        # one step from the JAX state: 1e-5
        one, r1, te1, tr1, info1 = tstep(_to_torch_state(js), torch.from_numpy(act), draws)
        np.testing.assert_array_equal(te1.numpy(), np.asarray(jterm), f"step {i} term")
        np.testing.assert_array_equal(tr1.numpy(), np.asarray(jtrunc), f"step {i} trunc")
        np.testing.assert_allclose(r1.numpy(), np.asarray(jrew), rtol=ULP2, atol=1e-5)
        for k in ("speed", "similarity", "distance_to_next_waypoint",
                  "distance_to_destination", "off_road_distance"):
            np.testing.assert_allclose(info1[k].numpy(), np.asarray(jinfo[k]), rtol=ULP2,
                                       atol=1e-5, err_msg=f"step {i} {k}")
        _assert_state(one, js_next, 1e-5, f"one step {i}")
        # free-running port state: 1e-4
        ts, rr, tte, ttr, _ = tstep(ts, torch.from_numpy(act), draws)
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jterm), f"free step {i}")
        np.testing.assert_allclose(rr.numpy(), np.asarray(jrew), rtol=0, atol=1e-4)
        js = js_next
        _assert_state(ts, js, 1e-4, f"free step {i}")
        _assert_obs(tp, jp, ts, js, tt, jt, tr, jr, 1e-4, f"free step {i}")
        n_done += int(np.sum(np.asarray(jterm | jtrunc)))
    assert n_done >= B, "the rollout exercised too few auto-resets"
    assert int(np.asarray(js.episode).max()) >= 1


def test_route_functions_match_jax(rng):
    """The port's window functions (the window repeats the last waypoint
    past the route end) against JAX's functions on the unclamped route."""
    fns = jroute.make_route_functions(window=10)
    xy = np.cumsum(rng.uniform(0.5, 2.5, (B, 16, 2)), axis=1).astype(np.float32)
    pos = (xy[:, 0] + rng.uniform(-1.0, 6.0, (B, 2))).astype(np.float32)
    rem = rng.integers(1, 16, B).astype(np.int32)
    window = np.take_along_axis(
        xy, np.minimum(np.arange(16)[None], rem[:, None] - 1)[..., None], axis=1)
    jidx = jax.vmap(lambda w, r, p: fns["update_index"](w, r, jnp.int32(0), p))(
        jnp.asarray(xy), jnp.asarray(rem), jnp.asarray(pos))
    tidx = troute.update_index(torch.from_numpy(window[:, :10]),
                               torch.from_numpy(rem).long(), torch.from_numpy(pos))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    jd = jax.vmap(lambda w, r, p: fns["next_waypoint_distances"](
        w, r, jnp.int32(0), p, 5))(jnp.asarray(xy), jnp.asarray(rem), jnp.asarray(pos))
    td = troute.next_waypoint_distances(torch.from_numpy(window[:, :5]),
                                        torch.from_numpy(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_light_phase_matches_jax(rng):
    from carla_driving_rl_agent_tpu.envs import traffic as jtraffic
    from carla_driving_rl_agent_torch.envs import traffic as ttraffic
    t, ph, yaw = (rng.uniform(0.0, 100.0, 256).astype(np.float32),
                  rng.uniform(0.0, 24.0, 256).astype(np.float32),
                  rng.uniform(-np.pi, np.pi, 256).astype(np.float32))
    j = jtraffic.light_phase_state(jnp.asarray(t), jnp.asarray(ph), jnp.asarray(yaw))
    tt = ttraffic.light_phase_state(*(torch.from_numpy(z) for z in (t, ph, yaw)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(j))
    assert ttraffic.LIGHT_CYCLE == jtraffic.LIGHT_CYCLE


def test_reset_draws_use_the_generator(data):
    tp, tr = data[1], data[5]
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a = tworld.reset_draws(g1, 64, tp, tr)
    b = tworld.reset_draws(g2, 64, tp, tr)
    assert a.npc is None
    for x, y in zip(tworld.tensors(a), tworld.tensors(b)):
        assert torch.equal(x, y)
    assert set(a.weather_id.tolist()) <= set(tp.weather_ids)
    assert int(a.route_id.max()) < tp.num_routes and int(a.route_id.min()) >= 0
    assert float(a.sim_time.min()) >= 0.0 and float(a.sim_time.max()) < 24.0
