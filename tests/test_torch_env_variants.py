"""The port's environment variants against the JAX package on the CPU, on
Town02 with at most 8 worlds:

  * the block evaluation (`CARLAgent.rollout` with `rollout_block`)
    against JAX's `CARLAgent._build_eval_fn` block path, 8 worlds x 8
    steps, both driven by the same injected predict (the actions drawn from
    JAX's keys as its eval draws them) and the same reset draws (JAX's,
    replayed along its done flags through its own physics); with traffic,
    by structure (the typed collision outcomes);
  * the analytic renderer (`ops/rasterizer.py`): `render_view` and
    `render_cameras` at 'full' and 'fast', with 0 and with NPC actors, on
    the same `RenderInputs` (made with numpy, so that no world is stepped
    apart on the two sides: tolerance 3.5 of ROADMAP.md);
  * the shaped reward per step from JAX's state, and the lateral feature
    with its sign;
  * the one-camera env (its observation keys and shapes, depth_modulate),
    `zeros`, `CARLAEnvDiscrete`'s round trip, `spaces` and each sensor's
    `read` on one world state;
  * `build_env`, `--lateral` through the CLI parser, the JAX weights with
    the wider navigation layer, and a load refusing a checkpoint of another
    navigation width before it copies anything.

Tolerances: the block evaluation's counts, flags and collision outcomes
exact, its accumulated floats 1e-4 (tests/test_torch_block.py's bar for
free-running world floats); rendered bytes equal on at least 99.9 % of
pixels (the share found is printed), depth bytes within 1 level and float
depth within 1e-4 relative (an ulp of the frameworks' trigonometry can move
a pixel across a class band); rewards and features 1e-5 + 2.5e-7 relative
per step (the world bar); the sensors 1e-5 + 2.5e-7 relative, the lidar's
ranges 1e-3 on rays both sides hit and its hit masks on 99 % of rays (the
two linspace of its ray fan differ by an ulp of angle).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgent as JAgent
from carla_driving_rl_agent_tpu.envs import sensors as jsensors
from carla_driving_rl_agent_tpu.envs import spaces as jspaces
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvDiscrete as JDiscrete
from carla_driving_rl_agent_tpu.envs.carla_env import convert_action as jconvert
from carla_driving_rl_agent_tpu.envs.weather import WEATHER_PARAMS
from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
from carla_driving_rl_agent_tpu.ops import rasterizer as jrast

from carla_driving_rl_agent_torch import main as cli
from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import sensors as tsensors
from carla_driving_rl_agent_torch.envs import spaces as tspaces
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import (
    CARLAEnv, CARLAEnvConfig, CARLAEnvDiscrete)
from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.ops import rasterizer as trast
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax

from test_torch_block import _InjectedEnv, _to_draws
from test_torch_imitation import _torch_world, share_towns
from test_torch_learner import TINY_NET

B, STEPS, BLOCK = 8, 8, 4
COMMON = dict(town_names=("Town02",), num_routes=8, max_timesteps=7, weather_ids=(1, 5, 9))
ULP2 = 2.5e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small PyTorch operations: one intra-op thread beside the
    suite's other workers (tests/test_torch_curriculum.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=ULP2, atol=atol,
                               err_msg=what)


def _jax_reset(jenv, keys):
    """JAX's reset states of `keys`, and their reset draws for the port."""
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((keys.shape[0],), jnp.int32))
    d = jax.jit(jax.vmap(lambda k: jworld._reset_draws(k, jenv.params, jenv.town,
                                                       jenv.routes)))(keys)
    return js, _to_draws(d)


# ------------------------------------------------------- the block evaluation

def test_block_evaluation_matches_jax():
    """CARLAgent.rollout with rollout_block against JAX's _build_eval_fn
    block path: one predict of 4 samples per block, the block's ticks in one
    physics call (fused_step: the plain version on the CPU), one push."""
    share_towns("Town02")
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**COMMON), render_mode="zeros"))
    tenv = _InjectedEnv(CARLAEnvConfig(world=tworld.WorldParams(**COMMON), render_mode="zeros",
                                       fused_step=True), device="cpu")

    def jpredict(params, stats, net_in, k, num_samples=None):
        return dict(action=jax.random.uniform(k, (num_samples, B, 2), minval=0.05,
                                              maxval=0.95))

    fake = types.SimpleNamespace(env=jenv, network=types.SimpleNamespace(predict=jpredict),
                                 config=types.SimpleNamespace(rollout_block=True))
    key0 = jax.random.PRNGKey(7)
    jacc = jax.device_get(JAgent._build_eval_fn(fake, B, STEPS)(None, None, key0, jenv.consts))

    # the eval's keys, split as it splits them
    k_reset, key = jax.random.split(key0)
    keys = jax.jit(jax.vmap(lambda i: jax.random.fold_in(k_reset, i)))(jnp.arange(B))
    actions = []
    for _ in range(STEPS // BLOCK):
        key, k = jax.random.split(key)
        actions.append(np.asarray(jpredict(None, None, None, k, BLOCK)["action"]))
    js, tdraws = _jax_reset(jenv, keys)

    @jax.jit
    def tick(s, a):
        key1 = jax.vmap(lambda k: jax.random.split(k)[0])(s.world.key)
        rk = jax.vmap(lambda k: jax.random.split(k)[0])(key1)
        d = jax.vmap(lambda k: jworld._reset_draws(k, jenv.params, jenv.town, jenv.routes))(rk)
        return jenv.step_physics_batch(s, a)[0], d

    s, draws = js, []
    for a in actions:
        for i in range(BLOCK):
            s, d = tick(s, jconvert(jnp.asarray(a[i])))
            draws.append(_to_draws(d))
    tenv.draws = draws

    agent = CARLAgent(tenv, CARLAgentConfig(network=TINY_NET, rollout_block=True))
    blocks = iter(actions)
    agent.network.predict = lambda net_in, gen, num_samples=None: dict(
        action=torch.from_numpy(next(blocks).copy()))
    tacc = agent.rollout(B, STEPS, tdraws)
    assert tenv.calls == STEPS // BLOCK and not tenv.draws, "one physics call per block"
    assert set(tacc) == set(jacc)
    assert float(np.sum(jacc["active"] == 0)) >= B // 2, "too few episodes ended"
    for k in ("active", "timesteps", "collision"):
        np.testing.assert_array_equal(tacc[k].numpy(), jacc[k], k)
    for k in ("total_reward", "similarity", "speed", "waypoint_distance"):
        np.testing.assert_allclose(tacc[k].numpy(), jacc[k], rtol=0, atol=1e-4, err_msg=k)


def test_block_evaluation_with_traffic_records_typed_outcomes():
    """With NPCs the block evaluation takes the plain block and records how
    each first episode ended, as the per-step evaluation does; the physics
    kernel is refused for such a world."""
    params = tworld.WorldParams(**dict(COMMON, num_vehicles=5, num_pedestrians=10, v_max=5,
                                       p_max=10))
    env = CARLAEnv(CARLAEnvConfig(world=params, render_mode="zeros"), device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, rollout_block=True))
    acc = agent.rollout(4, 8)
    for k in ("hit_vehicle", "hit_pedestrian", "hit_other", "vehicles", "walkers"):
        assert acc[k].shape == (4,), k
    assert bool((acc["walkers"] == 10).all()) and bool((acc["timesteps"] == 7).all())
    typed = acc["hit_vehicle"] + acc["hit_pedestrian"] + acc["hit_other"]
    assert bool((typed >= acc["collision"]).all())
    with pytest.raises(NotImplementedError, match="without NPCs"):
        CARLAEnv(CARLAEnvConfig(world=params, render_mode="zeros", fused_step=True),
                 device="cpu")


# ------------------------------------------------------------- the rasterizer

def _render_inputs(n_actors: bool):
    """4 worlds of Town02 at waypoints a seeded draw picks, as numpy
    arrays, with 6 vehicle and 5 walker slots around each ego: most of
    them active, or none (JAX's input; the port's then has no slots, as a
    world without NPCs)."""
    bank = ttown.build_town_bank(["Town02"])
    rng = np.random.default_rng(3)
    n = 4
    idx = rng.integers(0, int(bank.num_wp[0]), n)
    ego = (bank.wp_xy[0][idx] + rng.normal(0, 1.0, (n, 2))).astype(np.float32)
    v, p = 6, 5
    inp = dict(
        edges_xy=np.repeat(bank.edges_xy[:1], n, 0), num_edges=np.repeat(bank.num_edges[:1], n),
        buildings=np.repeat(bank.buildings[:1], n, 0),
        junctions=np.repeat(bank.junction_xy[:1], n, 0),
        num_junctions=np.repeat(bank.num_junctions[:1], n), ego_xy=ego,
        ego_yaw=bank.wp_yaw[0][idx].astype(np.float32),
        veh_xy=(ego[:, None] + rng.normal(0, 10, (n, v, 2))).astype(np.float32),
        veh_yaw=np.zeros((n, v), np.float32),
        veh_active=(rng.random((n, v)) < 0.8).astype(np.float32) * n_actors,
        ped_xy=(ego[:, None] + rng.normal(0, 6, (n, p, 2))).astype(np.float32),
        ped_active=(rng.random((n, p)) < 0.8).astype(np.float32) * n_actors,
        weather=np.asarray(WEATHER_PARAMS, np.float32)[rng.integers(0, len(WEATHER_PARAMS), n)],
        road_half=np.repeat(bank.road_half[:1], n).astype(np.float32))
    jin = jrast.RenderInputs(**{k: jnp.asarray(a) for k, a in inp.items()})
    tin = trast.RenderInputs(**{k: torch.from_numpy(np.ascontiguousarray(a))
                                for k, a in inp.items()})
    if not n_actors:
        tin = tin._replace(**trast.no_actors(n, "cpu"))
    return jin, tin


def _share_equal(a, b) -> float:
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.fixture(scope="module")
def renders():
    """JAX's and the port's frames of both input sets: render_cameras at
    'full' and 'fast' with the depth channel, render_view's front view
    with its float depth."""
    jcams = {q: jax.jit(jax.vmap(lambda i, q=q: jrast.render_cameras(i, quality=q,
                                                                     return_depth=True)))
             for q in trast.QUALITY}
    jview = jax.jit(jax.vmap(lambda i: jrast.render_view(i, jnp.asarray(0.0),
                                                         return_depth=True)))
    out = {}
    for actors in (False, True):
        jin, tin = _render_inputs(actors)
        for q in trast.QUALITY:
            out[actors, q] = (np.asarray(jcams[q](jin)),
                              trast.render_cameras(tin, quality=q, return_depth=True).numpy())
        jv, jd = jview(jin)
        tv, td = trast.render_view(tin, 0.0, return_depth=True)
        out[actors, "view"] = (np.asarray(jv), np.asarray(jd), tv.numpy(), td.numpy())
    return out


@pytest.mark.parametrize("actors", [False, True])
@pytest.mark.parametrize("quality", ["full", "fast"])
def test_render_cameras_matches_jax(renders, quality, actors):
    j, t = renders[actors, quality]
    assert t.shape == j.shape == (4, 90, 360, 4) and t.dtype == np.uint8
    share = _share_equal(t[..., :3], j[..., :3])
    print(f"render_cameras {quality}, actors {actors}: {share:.6f} of the bytes equal")
    assert share >= 0.999
    assert np.abs(t[..., 3].astype(int) - j[..., 3].astype(int)).max() <= 1
    if actors:
        # the billboards show: the frames differ from the same worlds' without
        assert _share_equal(t[..., :3], renders[False, quality][1][..., :3]) < 0.999


@pytest.mark.parametrize("actors", [False, True])
def test_render_view_matches_jax(renders, actors):
    jv, jd, tv, td = renders[actors, "view"]
    assert tv.shape == jv.shape == (4, 90, 120, 3) and td.shape == jd.shape == (4, 90, 120)
    share = _share_equal(tv.astype(np.uint8), jv.astype(np.uint8))
    print(f"render_view, actors {actors}: {share:.6f} of the bytes equal")
    assert share >= 0.999
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=0)


# ------------------------------------------- the shaped reward, lateral feature

@pytest.fixture(scope="module")
def shaped_worlds():
    """(JAX env, port env) of the shaped reward with the lateral feature."""
    share_towns("Town02")
    kw = dict(COMMON, reward_mode="shaped", lateral_obs=True, max_timesteps=512)
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**kw), render_mode="zeros"))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**kw), render_mode="zeros"),
                    device="cpu")
    return jenv, tenv


def _perturbed(js, rng):
    """JAX's reset states moved off their routes, turned and sped up, so
    that every term of the shaped reward and both signs of the lateral
    offset occur."""
    w = js.world
    n = w.x.shape[0]
    return js._replace(world=w._replace(
        x=w.x + jnp.asarray(rng.normal(0, 2.5, n), jnp.float32),
        y=w.y + jnp.asarray(rng.normal(0, 2.5, n), jnp.float32),
        yaw=w.yaw + jnp.asarray(rng.normal(0, 1.0, n), jnp.float32),
        v=jnp.asarray(rng.uniform(0, 22, n), jnp.float32)))


def test_shaped_reward_and_lateral_feature_match_jax(shaped_worlds):
    jenv, tenv = shaped_worlds
    js, _ = _jax_reset(jenv, jax.random.split(jax.random.PRNGKey(4), B))
    rng = np.random.default_rng(2)
    step = jax.jit(jax.vmap(lambda w, a: jworld.step_world(w, a, jenv.params, jenv.town,
                                                           jenv.routes)))
    vec = jax.jit(jax.vmap(lambda w: jworld.vector_observation(w, jenv.params, jenv.town,
                                                               jenv.routes)))
    seen = dict(speed_pen=0, negative_direction=0, left=0, right=0)
    for i in range(4):
        js = _perturbed(js, rng)
        a = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
        jw, jr, jterm, _, jinfo = step(js.world, jnp.asarray(a))
        tw, tr, tterm, _, tinfo = tworld.step_world(
            _torch_world(js.world)._replace(npc=None), torch.from_numpy(a), tenv.params,
            tenv.town, tenv.routes)
        _close(tr.numpy(), jr, f"step {i} reward")
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        nav = tworld.navigation_features(_torch_world(jw)._replace(npc=None), tenv.params,
                                         tenv.routes)
        jnav = np.asarray(vec(jw)["navigation"])
        assert nav.shape == (B, 6) == jnav.shape
        _close(nav.numpy(), jnav, f"step {i} navigation")
        spd, lim = np.asarray(jinfo["speed"]), np.asarray(jinfo["speed_limit"])
        seen["speed_pen"] += int(np.sum(spd > lim))
        seen["negative_direction"] += int(np.sum(np.asarray(jinfo["similarity"]) < 0.75))
        seen["left"] += int(np.sum(jnav[:, 5] > 0))
        seen["right"] += int(np.sum(jnav[:, 5] < 0))
        js = js._replace(world=jw)
    assert all(seen.values()), seen

    # the sign: an ego 1.5 m to the LEFT of its route segment reads +0.5
    w = _torch_world(js.world)._replace(npc=None)
    w_row, _ = tworld._route_window(tenv.routes, w.town_id, w.route_id, w.wp_idx, 2)
    p0, p1 = w_row[:, 0, :2], w_row[:, 1, :2]
    d = (p1 - p0) / torch.linalg.norm(p1 - p0, dim=-1, keepdim=True)
    left = p0 + 1.5 * torch.stack([-d[:, 1], d[:, 0]], dim=-1)
    w = w._replace(x=left[:, 0].contiguous(), y=left[:, 1].contiguous())
    lat = tworld.navigation_features(w, tenv.params, tenv.routes)[:, 5]
    torch.testing.assert_close(lat, torch.full_like(lat, 0.5), rtol=0, atol=1e-5)


# ------------------------------------------ one camera, zeros, discrete, spaces

def test_one_camera_env_matches_jax():
    """The one-camera env with depth_modulate: its reset observation against
    JAX's (the image's bytes, past_control, command and the vectors)."""
    share_towns("Town02")
    kw = dict(render_mode="rasterizer", cameras=1, depth_modulate=True)
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**COMMON), **kw))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**COMMON), **kw), device="cpu")
    assert tenv.config.storage_shape == jenv.config.storage_shape == (3, 90, 120)
    assert tenv.config.upsample == (1, 1)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    js, draws = _jax_reset(jenv, keys)
    jobs = jax.jit(jax.vmap(jenv.observe))(js)
    ts, tobs = tenv.reset(draws)
    assert set(tobs) == set(jobs) == {"image", "road", "vehicle", "navigation",
                                      "past_control", "command"}
    for k in jobs:
        assert tuple(tobs[k].shape) == tuple(np.shape(jobs[k])), k
    share = _share_equal(ts.image_stack.numpy(), js.image_stack)
    print(f"one camera, depth_modulate: {share:.6f} of the bytes equal")
    assert share >= 0.999
    for k in ("past_control", "command", "road", "vehicle", "navigation"):
        _close(tobs[k].numpy(), jobs[k], k)
    assert float(tobs["command"].sum()) == 4.0
    # depth_modulate darkens the far field against the plain one-camera frame
    plain = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**COMMON),
                                    render_mode="rasterizer", cameras=1), device="cpu")
    bright = plain.render_frame(ts.world)
    assert bool((tenv.render_frame(ts.world) <= bright).all())
    assert bool((tenv.render_frame(ts.world) < bright).any())


def test_zeros_discrete_and_refusals():
    share_towns("Town02")
    params = tworld.WorldParams(**COMMON)
    env = CARLAEnv(CARLAEnvConfig(world=params, render_mode="zeros", stack_depth=True),
                   device="cpu")
    jcfg = JEnvConfig(world=jworld.WorldParams(**COMMON), render_mode="zeros", stack_depth=True)
    assert env.config.storage_shape == jcfg.storage_shape == (4, 90, 360)
    s, obs = env.reset_batch(3)
    assert obs["image"].shape == (3, 4, 90, 360, 4) and not bool(obs["image"].any())
    s, obs, *_ = env.step(s, torch.zeros(3, 2))
    assert not bool(obs["image"].any())

    disc = CARLAEnvDiscrete(env, bins=4)
    jdisc = JDiscrete(types.SimpleNamespace(
        action_space=jspaces.Box(low=-1.0, high=1.0, shape=(2,)),
        config=types.SimpleNamespace(num_actions=2)), bins=4)
    grid = torch.stack(torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij"),
                       dim=-1).reshape(-1, 2)
    cont = disc.to_continuous(grid)
    np.testing.assert_array_equal(cont.numpy(), np.asarray(jdisc.to_continuous(
        jnp.asarray(grid.numpy()))))
    assert torch.equal(disc.to_discrete(cont), grid.to(torch.int32))
    assert disc.action_space.nvec.tolist() == [4, 4] and disc.time_horizon == 4
    s, obs, *_ = disc.step_batch(s, torch.tensor([[3, 0], [2, 1], [0, 3]]))
    assert obs["image"].shape[0] == 3

    with pytest.raises(ValueError, match="three-camera"):
        CARLAEnvConfig(world=params, render_mode="pallas", cameras=1)
    with pytest.raises(ValueError, match="exclusive"):
        CARLAEnvConfig(world=params, render_mode="rasterizer", cameras=1, stack_depth=True,
                       depth_modulate=True)
    with pytest.raises(NotImplementedError, match="default reward"):
        CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**dict(COMMON, reward_mode="shaped")),
                                fused_step=True), device="cpu")


def test_spaces_match_jax(shaped_worlds):
    rng_j, rng_t = np.random.default_rng(5), np.random.default_rng(5)
    cases = [
        (jspaces.Box(low=-1.0, high=2.0, shape=(3, 2)), tspaces.Box(low=-1.0, high=2.0,
                                                                    shape=(3, 2))),
        (jspaces.Box(low=np.array([0.0, -np.inf]), high=np.array([1.0, np.inf])),
         tspaces.Box(low=np.array([0.0, -np.inf]), high=np.array([1.0, np.inf]))),
        (jspaces.Discrete(7), tspaces.Discrete(7)),
        (jspaces.MultiDiscrete(nvec=[3, 5]), tspaces.MultiDiscrete(nvec=[3, 5])),
    ]
    for js_, ts_ in cases:
        a, b = js_.sample(rng_j), ts_.sample(rng_t)
        np.testing.assert_array_equal(a, b)
        assert ts_.contains(b) and js_.contains(b)
        assert tspaces.space_to_flat_spec(ts_) == jspaces.space_to_flat_spec(js_)
    assert not tspaces.Box(low=0.0, high=1.0, shape=(2,)).contains(np.array([0.5, 1.1]))
    assert tspaces.Box(low=0.0, high=1.0, shape=(2,)).is_bounded()

    jenv, tenv = shaped_worlds
    for t_sp, j_sp in ((tenv.observation_space, jenv.observation_space),
                       (tenv.action_space, jenv.action_space)):
        assert tspaces.space_to_flat_spec(t_sp) == jspaces.space_to_flat_spec(j_sp)
    for k, sub in tenv.observation_space.items():
        np.testing.assert_array_equal(sub.low, jenv.observation_space[k].low, k)
        np.testing.assert_array_equal(sub.high, jenv.observation_space[k].high, k)
    assert tenv.observation_space["navigation"].low[0] == -3.0 and tenv.time_horizon == 4
    one = CARLAEnvConfig(world=tworld.WorldParams(**COMMON), render_mode="rasterizer",
                         cameras=1)
    spec = tspaces.space_to_flat_spec(
        CARLAEnv.observation_space.fget(types.SimpleNamespace(config=one, params=one.world)))
    jone = JEnvConfig(world=jworld.WorldParams(**COMMON), cameras=1)
    assert spec == jspaces.space_to_flat_spec(
        JEnv.observation_space.fget(types.SimpleNamespace(config=jone, params=jone.world)))
    assert spec["state_past_control"] == (4,) and spec["state_image"] == (90, 120, 3)


# -------------------------------------------------------------------- sensors

def test_sensors_match_jax():
    """Each sensor's read on one world state with 5 vehicles and 10 walkers
    (and the IMU against a second state), JAX's vmapped over the worlds."""
    share_towns("Town02")
    kw = dict(COMMON, num_vehicles=5, num_pedestrians=10, v_max=5, p_max=10)
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**kw), render_mode="zeros"))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**kw), render_mode="zeros"),
                    device="cpu")
    js, _ = _jax_reset(jenv, jax.random.split(jax.random.PRNGKey(6), 4))
    rng = np.random.default_rng(1)
    jw = js.world
    n = jw.x.shape[0]
    jw = jw._replace(v=jnp.asarray(rng.uniform(0, 10, n), jnp.float32),
                     collision_penalty=jnp.asarray([0.0, 10.0, 0.0, 500.0], jnp.float32),
                     npc=jw.npc._replace(veh_v=jnp.asarray(rng.uniform(0, 8, (n, 5)),
                                                           jnp.float32)))
    jprev = jw._replace(v=jw.v - 0.3, yaw=jw.yaw - 0.05)
    camera = dict(env=jenv, height=45, width=60)
    jread = jax.jit(lambda w, p: dict(
        gnss=jax.vmap(jsensors.GnssSensor(lat_ref=12.0, lon_ref=3.0).read)(w),
        imu=jax.vmap(jsensors.IMUSensor().read)(w, p),
        collision=jax.vmap(jsensors.CollisionDetector().read)(w),
        lane=jax.vmap(lambda x: jsensors.LaneInvasionSensor().read(x, jenv.town))(w),
        obstacle=jax.vmap(jsensors.ObstacleDetector(distance=80.0, fov_deg=300.0).read)(w),
        radar=jax.vmap(jsensors.RadarSensor().read)(w),
        lidar=jax.vmap(lambda x: jsensors.LidarSensor().read(x, jenv.town))(w),
        rgb=jax.vmap(jsensors.create("sensor.camera.rgb", **camera).read)(w),
        semantic=jax.vmap(jsensors.create("sensor.camera.semantic_segmentation",
                                          **camera).read)(w),
        depth=jax.vmap(jsensors.create("sensor.camera.depth", **camera).read)(w)))
    j = jax.device_get(jread(jw, jprev))
    tw, tprev = _torch_world(jw), _torch_world(jprev)
    camera = dict(env=tenv, height=45, width=60)
    t = dict(
        gnss=tsensors.create("sensor.other.gnss", lat_ref=12.0, lon_ref=3.0).read(tw),
        imu=tsensors.create("sensor.other.imu").read(tw, tprev),
        collision=tsensors.create("sensor.other.collision").read(tw),
        lane=tsensors.create("sensor.other.lane_invasion").read(tw, tenv.town),
        obstacle=tsensors.ObstacleDetector(distance=80.0, fov_deg=300.0).read(tw),
        radar=tsensors.create("sensor.other.radar").read(tw),
        lidar=tsensors.create("sensor.lidar.ray_cast").read(tw, tenv.town),
        rgb=tsensors.create("sensor.camera.rgb", **camera).read(tw),
        semantic=tsensors.create("sensor.camera.semantic_segmentation", **camera).read(tw),
        depth=tsensors.create("sensor.camera.depth", **camera).read(tw))
    for name in ("gnss", "imu", "collision", "lane", "obstacle", "radar"):
        assert set(t[name]) == set(j[name]), name
        for k, v in t[name].items():
            if v.dtype == torch.bool:
                np.testing.assert_array_equal(v.numpy(), j[name][k], f"{name} {k}")
            else:
                _close(v.numpy(), j[name][k], f"{name} {k}")
    assert j["collision"]["triggered"].tolist() == [False, True, False, True]
    assert j["radar"]["valid"].any() and j["obstacle"]["triggered"].any()
    hit_t, hit_j = t["lidar"]["hit"].numpy(), j["lidar"]["hit"]
    assert (hit_t == hit_j).mean() >= 0.99 and hit_j.mean() > 0.1
    both = hit_t & hit_j
    np.testing.assert_allclose(t["lidar"]["ranges"].numpy()[both], j["lidar"]["ranges"][both],
                               rtol=1e-3, atol=1e-3)
    for name in ("rgb", "semantic"):
        assert _share_equal(t[name].numpy().astype(np.uint8),
                            j[name].astype(np.uint8)) >= 0.999, name
    assert np.abs(t["depth"].numpy().astype(int) - j["depth"].astype(int)).max() <= 1
    with pytest.raises(ValueError, match="valid sensor"):
        tsensors.create("sensor.other.sonar")


# --------------------------------------------- build_env, CLI, the hand-off

def test_build_env_and_the_lateral_cli(monkeypatch, tmp_path):
    share_towns("Town02")
    env = stages.build_env(town="Town02", num_routes=8, lateral_obs=True,
                           render_mode="rasterizer", reward_mode="shaped", device="cpu")
    assert env.config.render_mode == "rasterizer" and env.params.lateral_obs
    assert env.params.reward_mode == "shaped" and env.config.storage_shape == (3, 90, 360)
    s, obs = env.reset_batch(2)
    assert obs["navigation"].shape == (2, 4, 6) and obs["image"].shape == (2, 4, 90, 360, 3)

    made, evaluated = [], []

    class Fake:
        name = "stage-s1"
        agent = types.SimpleNamespace(base_path=str(tmp_path / "stage-s1"))

        def run2(self, **kw):
            return self

    def fake_s1(**kw):
        made.append(kw)
        return Fake()

    monkeypatch.setattr(cli.stages, "stage_s1", fake_s1)
    monkeypatch.setattr(cli.stages, "evaluate",
                        lambda **kw: evaluated.append(kw) or [dict(similarity_mean=1.0)])
    root = ["--weights-dir", str(tmp_path), "--device", "cpu", "--epochs", "1"]
    assert cli.main(["--stage", "s1", "--lateral"] + root) == 0
    assert cli.main(["--stage", "s1"] + root) == 0
    assert made[0]["env_overrides"]["lateral_obs"] is True
    assert "lateral_obs" not in made[1]["env_overrides"]
    assert cli.main(["--evaluate", "--lateral", "--steps", "4", "--trials", "1"]) == 0
    assert len(evaluated) == 48
    assert all(kw["env_overrides"] == dict(lateral_obs=True) for kw in evaluated)


def test_jax_weights_with_the_wider_navigation_layer():
    """params_from_jax carries a JAX network laid out for a 6-wide
    navigation input (lateral_obs) into the port's, strictly."""
    jnet = JNet(**TINY_NET)
    sample = dict(state_image=jnp.zeros((1, 4, 45, 180, 3)), state_road=jnp.zeros((1, 4, 9)),
                  state_vehicle=jnp.zeros((1, 4, 4)), state_navigation=jnp.zeros((1, 4, 6)),
                  action=jnp.zeros((1, 2)))
    params, stats = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), sample)
    rng = np.random.default_rng(0)
    fill = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda s: rng.normal(0, 0.1, s.shape).astype(np.float32), tree)
    sd = params_from_jax(fill(params), fill(stats))
    net = CARLANetwork(nav_dim=6, **TINY_NET)
    net.load_state_dict(sd, strict=True)
    w = net.dynamics.FeatureNet_2.state_dict()
    first = [v for k, v in w.items() if k.endswith("weight")][0]
    assert first.shape[1] == 6


def test_load_refuses_another_navigation_width(tmp_path):
    """A checkpoint of the 5-wide navigation input does not load into a
    lateral_obs agent (and back): the load raises before it copies any
    tensor, in full and backbone-only."""
    share_towns("Town02")
    make = lambda lateral: CARLAgent(  # noqa: E731
        CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**dict(COMMON, lateral_obs=lateral)),
                                render_mode="zeros"), device="cpu"),
        CARLAgentConfig(network=TINY_NET, seed=1 + lateral), name="stage-s1",
        weights_dir=str(tmp_path / ("wide" if lateral else "narrow")))
    narrow, wide = make(False), make(True)
    narrow.save()
    wide.save()
    for agent, other in ((wide, narrow), (narrow, wide)):
        before = {k: v.clone() for k, v in agent.network.state_dict().items()}
        for full in (True, False):
            with pytest.raises(ValueError, match="navigation width"):
                agent.load(other.base_path, full=full)
            for k, v in agent.network.state_dict().items():
                assert torch.equal(v, before[k]), k
    wide.load(wide.base_path)
    narrow_net = torch.load(tmp_path / "narrow" / "stage-s1" / "network.pt")
    assert narrow_net["dynamics.FeatureNet_2.Dense_0.weight"].shape[1] == 5
    assert wide.network.state_dict()["dynamics.FeatureNet_2.Dense_0.weight"].shape[1] == 6
