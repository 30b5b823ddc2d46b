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
30 steps with auto-resets 1e-4.  The `cuda`-marked tests hold the kernel
against the plain version on the card and skip here.

The block entry point (`step_physics_block`, K ticks in one launch) is
held, through the g++ build of its K-tick loop (`step_physics_block_host`),
bit for bit against K single ticks of the same build, and against JAX's
per-tick XLA step with JAX's draws injected as (K, B) rows and against K
ticks of the plain version, both at the free-running bar of 1e-4: on the
CPU PyTorch's vectorised sin, cos and atan2 differ from the C library's in
the last ulp (on the card both call CUDA's, and the kernel is bit-exact
against the plain version, as chip_smoke.py's physics phase checks).
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
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

COMMON = dict(town_names=("Town02",), num_routes=8, max_route_len=128, max_timesteps=24)
INT_FIELDS = ("route_id", "wp_idx", "town_id", "weather_id", "timestep", "episode",
              "should_terminate")
FLOAT_FIELDS = ("x", "y", "yaw", "v", "throttle", "brake", "steer", "similarity",
                "sim_time", "total_reward", "collision_penalty")
INFO_FLOATS = ("speed", "similarity", "distance_to_next_waypoint",
               "distance_to_destination", "off_road_distance", "total_reward")
ULP2 = 2.5e-7


def _jenv(fused, common):
    return JEnv(JEnvConfig(world=jworld.WorldParams(**common), render_mode="zeros",
                           fused_step=fused))


def physics_envs(common: dict) -> tuple:
    """JAX's fused and XLA envs, the port's params, town and routes of the
    world configuration `common`."""
    tp = tworld.WorldParams(**common)
    town, routes = tworld.build_world_data(tp, "cpu")
    return _jenv(True, common), _jenv(False, common), tp, town, routes


@pytest.fixture(scope="module")
def envs():
    return physics_envs(COMMON)


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
        if name == "npc":        # the JAX state's constant zero fleet; the port's is None
            continue
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
    physics_step_vs_jax(envs, batch)


def physics_step_vs_jax(envs, batch):
    """30 steps of `batch` worlds (24-step episodes, so every world
    restarts): JAX's fused Pallas step (interpret mode) and XLA step
    against the port's plain version and the kernel's g++ build, each from
    the JAX state at the one-step bar, and free-running at 1e-4."""
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


def _stack_draws(ticks):
    return tworld.ResetDraws(*(torch.stack(f) for f in zip(*map(tworld.tensors, ticks))))


K = 4     # ticks per block: the rollout's past_obs_freq


@pytest.mark.parametrize("batch", [32, 128])
def test_block_host_matches_ticks_and_jax(envs, batch):
    """Ten blocks of K ticks (40 ticks, 24-step episodes): the g++ build of
    the kernel's K-tick loop from JAX's state at each block's start, with
    JAX's draws of the block's ticks, against K host single ticks (bits),
    JAX's per-tick step and K plain ticks."""
    _, jxla, tp, town, routes = envs
    step = _jstep_fn(jxla)
    states, _ = jax.jit(lambda k, c: _bind_reset(jxla, k, c, batch))(
        jax.random.PRNGKey(batch + 1), jxla.consts)
    rng = np.random.default_rng(batch + 1)
    n_done = 0
    for blk in range(10):
        start = _world(states.world)
        acts = rng.uniform([0.1, -0.6], [0.9, 0.6], (K, batch, 2)).astype(np.float32)
        jouts, draws = [], []
        for k in range(K):
            jout, jd = step(states, jnp.asarray(acts[k]))
            jouts.append(jout)
            draws.append(_draws(jd))
            states = jout[0]
        a, d = torch.from_numpy(acts), _stack_draws(draws)
        got = P.step_physics_block_host(start, a, tp, town, routes, d)
        # the same K ticks one launch at a time: the same bits
        w = start
        for k in range(K):
            w, r, term, trunc, info, done = P.step_physics_host(w, a[k], tp, town, routes,
                                                               draws[k])
            for x, y in ((got[1][k], r), (got[2][k], term), (got[3][k], trunc),
                         (got[4]["speed"][k], info["speed"]),
                         (got[4]["similarity"][k], info["similarity"]), (got[5][k], done)):
                assert torch.equal(x, y), f"block {blk} tick {k}"
        for name, x, y in zip(tworld.WorldState._fields, tworld.tensors(got[0]),
                              tworld.tensors(w)):
            assert torch.equal(x, y), f"block {blk} {name}"
        plain = P.step_physics_block_plain(start, a, tp, town, routes, d)
        for ref, what in ((plain, "plain"), (None, "jax")):
            for k in range(K):
                if ref is None:
                    _, jr, jterm, jtrunc, jinfo, jdone = jouts[k]
                    rows = (jr, jterm, jtrunc, jinfo["speed"], jinfo["similarity"], jdone)
                    rows = [torch.from_numpy(np.array(t)) for t in rows]
                else:
                    rows = (ref[1][k], ref[2][k], ref[3][k], ref[4]["speed"][k],
                            ref[4]["similarity"][k], ref[5][k])
                mine = (got[1][k], got[2][k], got[3][k], got[4]["speed"][k],
                        got[4]["similarity"][k], got[5][k])
                for i, (x, y) in enumerate(zip(mine, rows)):
                    if x.dtype.is_floating_point:
                        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-4,
                                                   err_msg=f"{what} block {blk} tick {k} {i}")
                    else:
                        np.testing.assert_array_equal(x.numpy(), y.numpy().astype(bool),
                                                      f"{what} block {blk} tick {k} {i}")
        _assert_world(got[0], states.world, 1e-4, f"block {blk} vs jax")
        _assert_world(got[0], plain[0], 1e-4, f"block {blk} vs plain")
        n_done += int(got[5].sum())
    assert n_done >= batch, f"only {n_done} auto-resets in 40 ticks"


def test_block_reset_draws(envs):
    """The block's (K, B) reset draws: one generator call, in range, the
    weather from the env's table, the same for the same seed."""
    _, _, tp, _, routes = envs
    tp = tworld.WorldParams(**dict(COMMON, weather_ids=(3, 5, 9)))
    table = torch.tensor(tp.weather_ids)
    draws = [tworld.block_reset_draws(torch.Generator().manual_seed(7), K, 64, tp, routes,
                                      table) for _ in range(2)]
    for a, b in zip(*map(tworld.tensors, draws)):
        assert a.shape == (K, 64) and torch.equal(a, b)
    d = draws[0]
    assert d.town_id.dtype == torch.int64 and bool((d.town_id == 0).all())
    assert set(d.weather_id.unique().tolist()) == {3, 5, 9}
    assert int(d.route_id.min()) >= 0 and int(d.route_id.max()) < routes.length.shape[1]
    assert len(d.route_id.unique()) > 1
    assert d.sim_time.dtype == torch.float32 and bool((d.sim_time >= 0).all())
    other = tworld.block_reset_draws(torch.Generator().manual_seed(8), K, 64, tp, routes, table)
    assert not torch.equal(other.route_id, d.route_id)


def test_cpu_block_takes_the_plain_version(envs):
    _, _, tp, town, routes = envs
    g = torch.Generator().manual_seed(4)
    world = tworld.reset_world(tworld.reset_draws(g, 8, tp, routes), routes)
    draws = tworld.block_reset_draws(g, K, 8, tp, routes, torch.tensor(tp.weather_ids))
    a = torch.full((K, 8, 2), 0.5)
    before = P.step_physics_block.launches
    out = P.step_physics_block(world, a, tp, town, routes, draws)
    ref = P.step_physics_block_plain(world, a, tp, town, routes, draws)
    assert P.step_physics_block.launches == before
    for x, y in zip(tworld.tensors(out[0]), tworld.tensors(ref[0])):
        assert torch.equal(x, y)
    for x, y in zip(out[1:4] + out[5:], ref[1:4] + ref[5:]):
        assert torch.equal(x, y) and x.shape == (K, 8)
    with pytest.raises(ValueError, match="draws"):
        P.step_physics_block_host(world, a, tp, town, routes,
                                  tworld.map_tensors(lambda t: t[:2], draws))


def _bind_reset(env, key, consts, batch):
    with env.bind(consts):
        return env.reset_batch(key, batch)


def test_fused_step_unsupported_raises():
    """NPC traffic or the shaped reward with fused_step raises: the JAX
    package steps such worlds on its XLA path (physics_pallas.
    fused_step_supported), and the port has no fallback from the kernel;
    without fused_step the env builds them, and the kernel's entry points
    refuse the shaped reward on every device."""
    for spawn in (dict(vehicles=2), dict(pedestrians=3)):
        with pytest.raises(NotImplementedError, match="NPC"):
            stages.build_env(town="Town02", num_routes=8, spawn=spawn,
                             fused_step=True, device="cpu")
        env = stages.build_env(town="Town02", num_routes=8, spawn=spawn, device="cpu")
        assert env.params.has_npcs and not env.config.fused_step
    with pytest.raises(NotImplementedError, match="default reward"):
        stages.build_env(town="Town02", num_routes=8, reward_mode="shaped", fused_step=True,
                         device="cpu")
    env = stages.build_env(town="Town02", num_routes=8, reward_mode="shaped", device="cpu")
    assert env.params.reward_mode == "shaped" and not env.config.fused_step
    world = tworld.reset_world(env.reset_draws(2), env.routes)
    draws = tworld.block_reset_draws(env.generator, K, 2, env.params, env.routes,
                                     env.weather_table)
    with pytest.raises(NotImplementedError, match="default reward"):
        P.step_physics_block(world, torch.zeros(K, 2, 2), env.params, env.town, env.routes,
                             draws)


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
    for x, y in zip(tworld.tensors(out[0]), tworld.tensors(ref[0])):
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
        for name, x, y in zip(tworld.WorldState._fields, tworld.tensors(out[0]),
                              tworld.tensors(ref[0])):
            if x.dtype.is_floating_point:
                torch.testing.assert_close(x, y, rtol=ULP2, atol=1e-5, msg=name)
            else:
                assert torch.equal(x, y), name
        world = out[0]


@pytest.mark.cuda
def test_cuda_block_kernel_matches_plain(envs):
    """On the card: the block kernel against K ticks of the plain version,
    bit for bit, over 10 blocks of 24-step episodes at 256 worlds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the physics kernel runs only on the card")
    _, _, tp, town, routes = envs
    dev = torch.device("cuda")
    town_d = tworld.TownDev(*(t.to(dev) for t in town))
    routes_d = tworld.RoutesDev(*(t.to(dev) for t in routes))
    table = torch.tensor(tp.weather_ids, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    world = tworld.reset_world(tworld.reset_draws(g, 256, tp, routes_d), routes_d)
    resets = 0
    for _ in range(10):
        a = 0.1 + 0.8 * torch.rand((K, 256, 2), generator=g, device=dev)
        draws = tworld.block_reset_draws(g, K, 256, tp, routes_d, table)
        before = P.step_physics_block.launches
        out = P.step_physics_block(world, a, tp, town_d, routes_d, draws)
        torch.cuda.synchronize()
        assert P.step_physics_block.launches == before + 1
        ref = P.step_physics_block_plain(world, a, tp, town_d, routes_d, draws)
        for x, y in zip(tuple(tworld.tensors(out[0])) + out[1:4] + out[5:],
                        tuple(tworld.tensors(ref[0])) + ref[1:4] + ref[5:]):
            assert torch.equal(x, y)
        for key in out[4]:
            assert torch.equal(out[4][key], ref[4][key]), key
        # the plain block's NPC collision rows, all false here, are not the kernel's
        assert set(ref[4]) - set(out[4]) == {"hit_vehicle", "hit_pedestrian"}
        assert not bool(ref[4]["hit_vehicle"].any() | ref[4]["hit_pedestrian"].any())
        resets += int(out[5].sum())
        world = out[0]
    assert resets > 0
