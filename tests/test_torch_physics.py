"""The port's physics step against the JAX package on the CPU: JAX's fused
Pallas step (`step_physics_batch_fused`, in interpret mode, as
tests/test_physics_fused.py runs it) and its vmapped XLA `step_physics`,
against the port's plain version (`step_physics_batch_plain`) and the CUDA
kernel's own arithmetic (csrc/physics.cuh built with g++,
`step_physics_host`), on Town02 at 32 and 128 worlds without traffic.  The
port takes JAX's reset draws (`_reset_draws` of each world's reset key).

Tolerances, from tests/test_physics_fused.py: ints, bools and ids exact;
floats, one step from the same state, 1e-5 absolute plus 2.5e-7 relative
(two float32 ulps: positions reach ~300 m, and the frameworks' CPU sin, cos,
atan and atan2 differ in the last ulp); the port's free-running state after
30 steps with auto-resets 1e-4.  The `cuda`-marked test holds the kernel
against the plain version on the card and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig

from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.ops import physics as P

COMMON = dict(town_names=("Town02",), num_routes=8, max_route_len=128, max_timesteps=24)
INT_FIELDS = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode",
              "should_terminate")
FLOAT_FIELDS = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
                "sim_time", "total_reward", "collision_penalty")
INFO_FLOATS = ("speed", "similarity", "distance_to_next_waypoint",
               "distance_to_destination", "off_road_distance", "total_reward")
ULP2 = 2.5e-7


def _jenv(fused):
    return JEnv(JEnvConfig(world=jworld.WorldParams(**COMMON), render_mode="zeros",
                           fused_step=fused))


@pytest.fixture(scope="module")
def envs():
    tp = tworld.WorldParams(**COMMON)
    town, routes = tworld.build_world_data(tp, "cpu")
    return _jenv(True), _jenv(False), tp, town, routes


def _jstep_fn(env):
    @jax.jit
    def step(states, a, consts):
        with env.bind(consts):
            out = env.step_physics_batch(states, a)
            key1 = jax.vmap(lambda k: jax.random.split(k)[0])(states.world.key)
            reset_key = jax.vmap(lambda k: jax.random.split(k)[0])(key1)
            d = jax.vmap(lambda k: jworld._reset_draws(k, env.params, env.town,
                                                       env.routes))(reset_key)
        return out, d
    return lambda states, a: step(states, a, env.consts)


def _draws(d):
    tid, wid, rid, _, _, st, _, _ = d
    return tworld.ResetDraws(*(torch.as_tensor(np.array(a)).to(t) for a, t in (
        (tid, torch.int64), (wid, torch.int64), (rid, torch.int64), (st, torch.float32))))


def _world(jw):
    fields = {}
    for name in tworld.WorldState._fields:
        a = np.array(getattr(jw, name))
        fields[name] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
    return tworld.WorldState(**fields)


def _assert_world(tw, jw, atol, where):
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tw, name).numpy(),
                                      np.asarray(getattr(jw, name)), f"{where} {name}")
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tw, name).numpy(), np.asarray(getattr(jw, name)),
                                   rtol=ULP2, atol=atol, err_msg=f"{where} {name}")


def _assert_step(out, jout, where):
    tw, tr, tterm, ttrunc, tinfo, tdone = out
    (js, jr, jterm, jtrunc, jinfo, jdone) = jout
    for t, j, k in ((tterm, jterm, "term"), (ttrunc, jtrunc, "trunc"),
                    (tdone, jdone, "was_reset"), (tinfo["collision"], jinfo["collision"],
                                                  "collision")):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), f"{where} {k}")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=ULP2, atol=1e-5,
                               err_msg=f"{where} reward")
    for k in INFO_FLOATS:
        np.testing.assert_allclose(tinfo[k].numpy(), np.asarray(jinfo[k]), rtol=ULP2,
                                   atol=1e-5, err_msg=f"{where} info {k}")
    _assert_world(tw, js.world, 1e-5, where)


@pytest.mark.parametrize("batch", [32, 128])
def test_physics_step_matches_jax(envs, batch):
    jfused, jxla, tp, town, routes = envs
    fused_step, xla_step = _jstep_fn(jfused), _jstep_fn(jxla)
    states, _ = jax.jit(lambda k, c: _bind_reset(jfused, k, c, batch))(
        jax.random.PRNGKey(batch), jfused.consts)
    rng = np.random.default_rng(batch)
    free = {"plain": _world(states.world), "kernel": _world(states.world)}
    fns = {"plain": P.step_physics_batch_plain, "kernel": P.step_physics_host}
    n_done = 0
    for i in range(30):
        a = rng.uniform([0.1, -0.6], [0.9, 0.6], (batch, 2)).astype(np.float32)
        ja = jnp.asarray(a)
        jout, jd = fused_step(states, ja)
        xout, _ = xla_step(states, ja)
        draws = _draws(jd)
        # JAX's two paths agree with each other (tests/test_physics_fused.py)
        np.testing.assert_array_equal(np.asarray(jout[5]), np.asarray(xout[5]))
        for name, fn in fns.items():
            one = fn(_world(states.world), torch.from_numpy(a), tp, town, routes, draws)
            _assert_step(one, jout, f"step {i} {name} vs fused")
            _assert_step(one, xout, f"step {i} {name} vs xla")
            free[name] = fn(free[name], torch.from_numpy(a), tp, town, routes, draws)[0]
            _assert_world(free[name], jout[0].world, 1e-4, f"free step {i} {name}")
        n_done += int(np.asarray(jout[5]).sum())
        states = jout[0]
    assert n_done >= batch, f"only {n_done} auto-resets in 30 steps"


def _bind_reset(env, key, consts, batch):
    with env.bind(consts):
        return env.reset_batch(key, batch)


def test_fused_step_unsupported_raises():
    """NPC traffic raises, with fused_step on or off: the JAX package steps
    such worlds on its XLA path, and the port has no NPC world to fall back
    to.  (The shaped reward cannot be asked for: the port's WorldParams has
    no reward_mode.)"""
    for spawn in (dict(vehicles=2), dict(pedestrians=3)):
        for fused in (True, False):
            with pytest.raises(NotImplementedError, match="NPC"):
                stages.build_env(town="Town02", num_routes=8, spawn=spawn,
                                 fused_step=fused, device="cpu")
    assert not hasattr(tworld.WorldParams(), "reward_mode")


def test_cpu_tensors_take_the_plain_version(envs):
    _, _, tp, town, routes = envs
    g = torch.Generator().manual_seed(1)
    world = tworld.reset_world(tworld.reset_draws(g, 8, tp, routes), routes)
    draws = tworld.reset_draws(g, 8, tp, routes)
    a = torch.full((8, 2), 0.5)
    before = P.step_physics_batch.launches
    out = P.step_physics_batch(world, a, tp, town, routes, draws)
    ref = P.step_physics_batch_plain(world, a, tp, town, routes, draws)
    assert P.step_physics_batch.launches == before
    for x, y in zip(out[0], ref[0]):
        assert torch.equal(x, y)


def test_wrapper_rejects_bad_operands(envs):
    _, _, tp, town, routes = envs
    g = torch.Generator().manual_seed(2)
    world = tworld.reset_world(tworld.reset_draws(g, 8, tp, routes), routes)
    draws = tworld.reset_draws(g, 8, tp, routes)
    with pytest.raises(TypeError, match="float32"):
        P.step_physics_host(world, torch.zeros(8, 2, dtype=torch.float64), tp, town,
                            routes, draws)
    with pytest.raises(ValueError, match="contiguous"):
        P.step_physics_host(world, torch.zeros(2, 8).t(), tp, town, routes, draws)
    with pytest.raises(ValueError, match="action"):
        P.step_physics_host(world, torch.zeros(7, 2), tp, town, routes, draws)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(envs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the physics kernel runs only on the card")
    _, _, tp, town, routes = envs
    dev = torch.device("cuda")
    town_d = tworld.TownDev(*(t.to(dev) for t in town))
    routes_d = tworld.RoutesDev(*(t.to(dev) for t in routes))
    g = torch.Generator(device=dev).manual_seed(3)
    world = tworld.reset_world(tworld.reset_draws(g, 256, tp, routes_d), routes_d)
    rng = np.random.default_rng(3)
    for _ in range(30):
        a = torch.from_numpy(rng.uniform([0.1, -0.6], [0.9, 0.6], (256, 2))
                             .astype(np.float32)).to(dev)
        draws = tworld.reset_draws(g, 256, tp, routes_d)
        before = P.step_physics_batch.launches
        out = P.step_physics_batch(world, a, tp, town_d, routes_d, draws)
        torch.cuda.synchronize()
        assert P.step_physics_batch.launches == before + 1
        ref = P.step_physics_batch_plain(world, a, tp, town_d, routes_d, draws)
        for name, x, y in zip(tworld.WorldState._fields, out[0], ref[0]):
            if x.dtype.is_floating_point:
                torch.testing.assert_close(x, y, rtol=ULP2, atol=1e-5, msg=name)
            else:
                assert torch.equal(x, y), name
        world = out[0]
