"""Curriculum stages s2-s5 of the PyTorch port on the CPU, on Town02 (and
Town01 + Town02 for stage s4's random towns): the NPC block path, the
stage factories, the hand-off and the command line.

  * `traffic.block_npc_step_draws` and `world.block_reset_draws` with NPCs:
    one generator call each (two for the resets), rows scaled by each
    row's town; without NPCs the streams are the parent tree's, values
    below;
  * the plain block with NPCs (0/50 and 5/10) equals K per-step ticks from
    the same draws exactly, mid-block resets included, and a world that
    ends restarts its NPCs from its tick's spawn draws while the others
    keep theirs;
  * `run_rollout_blocks` on 8 worlds with 5 vehicles and 10 walkers for 16
    steps against JAX's `run_rollout_blocks`, driven by the same injected
    predict_fn and the same draws, JAX's per-world keys replayed into the
    port's NPC tick, reset and spawn draws (tests/test_torch_traffic.py's
    `jax_reset_draws` / `jax_step_draws`); the JAX renderer in Pallas
    interpret mode;
  * stage s4's random towns: a block on a Town01 + Town02 bank
    whose worlds restart mid-block into the other town equals its K
    per-step ticks, each tick's NPC draws the block's uniforms scaled by
    the towns the worlds hold at that tick; and the two-town block rollout
    with 5/10 NPCs against JAX's (its renderer off: the frames are held by
    the one-town rollout), JAX's NPC tick draws replayed by the town each
    world holds at each tick;
  * `stage_s2` / `stage_s3` against the JAX factories, `sharp_recipe`
    against JAX main.py's, `hand_off` (the tracked JAX checkpoint of stage
    s1 and the port's own of s2, nothing written under weights/),
    `run_curriculum` and `--fused-step` raising before any training,
    `CARLAgent.learn` on a world with NPCs, and the CLI's `--stage s2`
    loading a hand-off checkpoint.

Tolerances.  The block rollout free-runs 16 steps, so it is held on that
short horizon to tests/test_torch_block.py's bars: ids, flags, post_reset,
stack ids and slots exact, and the NPC state's indices and masks (veh_wp,
veh_active, ped_active, ped_cross) exact; rewards, vector stacks, the
recorded actions and the NPC and world floats 1e-4 (the two frameworks'
float32 trig differ by an ulp, tests/test_torch_traffic.py); rendered u8
|diff| <= 2 on > 99 % of pixels.  The plain block against its own ticks,
the draws, the factories and the loaded checkpoints are exact.
"""

import copy
import dataclasses
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jmain
from carla_driving_rl_agent_tpu.agents import rollout as jrollout
from carla_driving_rl_agent_tpu.curriculum import stages as jstages
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig
from carla_driving_rl_agent_tpu.envs.weather import TEST_WEATHERS, weather_ids

from carla_driving_rl_agent_torch import REPO_ROOT
from carla_driving_rl_agent_torch import main as cli
from carla_driving_rl_agent_torch.agents import rollout as trollout
from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import traffic as ttraffic
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.envs.weather import TRAIN_WEATHERS
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax, read_flax_msgpack

from test_torch_block import _to_draws, _to_state, _within2
from test_torch_imitation import share_towns
from test_torch_learner import TINY_NET
from test_torch_traffic import assert_npc, jax_reset_draws, jax_step_draws

B, STEPS, K = 8, 16, 4
SMALL_ENV = dict(num_routes=8, image_shape=(45, 60, 3))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tests run many small PyTorch operations; beside the suite's
    other workers, several intra-op threads per operation spend most of
    their time waiting for each other, so the module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(trees):
    """The (K, ...) stack of K draws of one NamedTuple type, nested ones
    included."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_stack(list(f)) for f in zip(*trees)))
    return None if trees[0] is None else torch.stack(trees)


def _row(tree, k):
    return tworld.map_tensors(lambda t: t[k], tree)


def _equal(a, b) -> bool:
    xs, ys = tworld.tensors(a), tworld.tensors(b)
    return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))


# ---------------------------------------------------------------- draws

def test_block_npc_step_draws_are_k_ticks_of_one_call():
    """(K, B, V) and (K, B, P) draws from one generator call, tick k's row
    what npc_step_draws gives tick k (on the CPU generator K calls of B
    rows consume the stream as one call of K x B), scaled by each world's
    town."""
    town = types.SimpleNamespace(num_wp=torch.tensor([40, 900]))
    tid = torch.tensor([0, 1, 1, 0])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    d = ttraffic.block_npc_step_draws(g1, town, tid, 3, 2, 6)
    assert d.branch.shape == (3, 4, 2) and d.goal.wp.shape == (3, 4, 6)
    for k in range(3):
        assert _equal(_row(d, k), ttraffic.npc_step_draws(g2, town, tid, 2, 6))
    assert torch.equal(g1.get_state(), g2.get_state())
    assert bool((d.goal.wp < town.num_wp[tid][None, :, None]).all())
    assert int(d.goal.wp[:, 1:3].max()) >= 40, "town 1's rows are not scaled by its count"


def test_block_reset_draws_with_npcs():
    """With NPCs the four (K, B) reset draws are the zero-NPC ones, and the
    spawn follows from one further call, each (tick, world) scaled by its
    row's town (random towns pick a town per tick)."""
    params = tworld.WorldParams(town_names=("A", "B"), random_towns=True, num_vehicles=3,
                                num_pedestrians=4, v_max=3, p_max=4, weather_ids=(1, 5, 9))
    bare = dataclasses.replace(params, num_vehicles=0, num_pedestrians=0)
    routes = types.SimpleNamespace(length=torch.zeros((2, 128), dtype=torch.int64))
    town = types.SimpleNamespace(num_spawn=torch.tensor([6, 300]),
                                 num_wp=torch.tensor([40, 900]))
    table = torch.tensor(params.weather_ids)
    g = torch.Generator().manual_seed(7)
    d = tworld.block_reset_draws(g, K, 16, params, routes, table, town)
    g0 = torch.Generator().manual_seed(7)
    d0 = tworld.block_reset_draws(g0, K, 16, bare, routes, table)
    assert d0.npc is None
    for f in ("town_id", "weather_id", "route_id", "sim_time"):
        assert torch.equal(getattr(d, f), getattr(d0, f)), f
    g0_next = ttraffic.npc_reset_draws(g0, town, d.town_id.reshape(-1), 3, 4)
    assert torch.equal(g.get_state(), g0.get_state()), "not one further call"
    assert _equal(d.npc, tworld.map_tensors(lambda t: t.reshape((K, 16) + t.shape[1:]),
                                            g0_next))
    assert d.npc.spawn.shape == (K, 16, 3) and d.npc.ped_wp.shape == (K, 16, 4)
    assert bool((d.npc.spawn < town.num_spawn[d.town_id][..., None]).all())
    assert bool((d.npc.goal.wp < town.num_wp[d.town_id][..., None]).all())
    assert int(d.npc.spawn[d.town_id == 1].max()) >= 6 and bool((d.town_id == 0).any())
    with pytest.raises(ValueError, match="town tables"):
        tworld.block_reset_draws(g, K, 16, params, routes, table)


# block_reset_draws(Generator().manual_seed(7), 2, 3, ...) of WorldParams(
# town_names=("Town02",), weather_ids=(1, 5, 9)) with 128 routes, and a
# block rollout of 4 Town02 worlds (stages.build_env(town="Town02",
# num_routes=8, max_timesteps=6, image_shape=(45, 60, 3)), 8 steps of
# actions 0.7), computed on the tree before the NPC block path
ZERO_NPC_BLOCK = dict(weather_id=[[1, 5, 5], [9, 9, 5]], route_id=[[36, 26, 56], [45, 92, 9]],
                      sim_time=[[23.2780704498291, 2.58687686920166, 21.189062118530273],
                                [9.916145324707031, 18.172666549682617, 16.676340103149414]],
                      next=0.5209300518035889)
ZERO_NPC_ROLLOUT = dict(x=[104.99098205566406, 298.88214111328125, 136.7089080810547,
                           163.42039489746094], route_id=[1, 7, 6, 0], done=4,
                        next=0.9736230969429016)


def test_zero_npc_block_streams_are_unchanged():
    """Without NPCs the block's reset draws, a block rollout and the env's
    generator afterwards equal the parent tree's: stage s1 and the env
    bench draw what they drew."""
    params = tworld.WorldParams(town_names=("Town02",), weather_ids=(1, 5, 9))
    routes = types.SimpleNamespace(length=torch.zeros((1, 128), dtype=torch.int64))
    g = torch.Generator().manual_seed(7)
    d = tworld.block_reset_draws(g, 2, 3, params, routes, torch.tensor(params.weather_ids))
    assert d.npc is None
    assert d.weather_id.tolist() == ZERO_NPC_BLOCK["weather_id"]
    assert d.route_id.tolist() == ZERO_NPC_BLOCK["route_id"]
    np.testing.assert_array_equal(d.sim_time.numpy(), np.float32(ZERO_NPC_BLOCK["sim_time"]))
    assert float(torch.rand((), generator=g)) == np.float32(ZERO_NPC_BLOCK["next"])
    env = stages.build_env(town="Town02", max_timesteps=6, device="cpu", **SMALL_ENV)
    states, _ = env.reset_batch(4)

    def predict(net_in, n):
        return dict(action=torch.full((n, 4, 2), 0.7), log_prob=torch.zeros(n, 4, 2),
                    value=torch.zeros(4, 2))

    final, traj, _ = trollout.run_rollout_blocks(env, predict, states, 8)
    np.testing.assert_array_equal(final.world.x.numpy(), np.float32(ZERO_NPC_ROLLOUT["x"]))
    assert final.world.route_id.tolist() == ZERO_NPC_ROLLOUT["route_id"]
    assert int((traj.terminated + traj.truncated).sum()) == ZERO_NPC_ROLLOUT["done"]
    assert float(torch.rand((), generator=env.generator)) == np.float32(ZERO_NPC_ROLLOUT["next"])


# ---------------------------------------------------------------- the plain block

@pytest.mark.parametrize("vehicles,pedestrians", [(0, 50), (5, 10)])
def test_plain_block_with_npcs_equals_its_ticks(vehicles, pedestrians):
    """env.step_physics_block on NPC worlds draws the block's NPC tick
    draws, then its reset draws with their spawns, and equals K per-step
    ticks (env.step_physics) from those rows exactly.  The worlds start at
    different timesteps of 6-step episodes, so that they end at different
    ticks: a world that ends restarts its NPCs from its tick's spawn draws
    around its new ego, and the others keep ticking theirs."""
    env = stages.build_env(town="Town02", max_timesteps=6, device="cpu",
                           spawn=dict(vehicles=vehicles, pedestrians=pedestrians), **SMALL_ENV)
    assert env.n_actors == min(4, max(vehicles, 1)) + 4
    states, _ = env.reset_batch(B)
    states = states._replace(world=states.world._replace(
        timestep=torch.arange(B, dtype=torch.int64) % 6))
    gen = torch.Generator().manual_seed(1)
    p = env.params
    ended = torch.zeros(K, B, dtype=torch.bool)
    for blk in range(3):
        actions = torch.rand((K, B, 2), generator=gen) * 2.0 - 1.0
        twin = torch.Generator().manual_seed(0)
        twin.set_state(env.generator.get_state())
        out = env.step_physics_block(states, actions)
        nd = ttraffic.block_npc_step_draws(twin, env.town, states.world.town_id, K,
                                           p.v_max, p.p_max)
        rd = tworld.block_reset_draws(twin, K, B, p, env.routes, env.weather_table, env.town)
        assert torch.equal(twin.get_state(), env.generator.get_state())
        st, rows = states, []
        for k in range(K):
            st, *row = env.step_physics(st, actions[k], draws=_row(rd, k),
                                        npc_draws=_row(nd, k))
            rows.append((row[0], row[1], row[2], row[3]["speed"], row[3]["similarity"],
                         row[4]))
        assert _equal(out[0].world, st.world), f"block {blk}: the state after the block"
        want = [torch.stack(r) for r in zip(*rows)]
        got = [out[1], out[2], out[3], out[4]["speed"], out[4]["similarity"], out[5]]
        for name, x, y in zip(("reward", "term", "trunc", "speed", "similarity", "done"),
                              got, want):
            assert torch.equal(x, y), f"block {blk}: {name}"
        # the worlds that ended at the last tick restart their NPCs from its
        # spawn draws; the others carry on
        last = out[5][-1]
        fresh = tworld.reset_world(_row(rd, K - 1), env.routes, town=env.town, params=p).npc
        for f in ("veh_xy", "ped_xy", "veh_active", "ped_goal"):
            x, y = getattr(out[0].world.npc, f), getattr(fresh, f)
            assert torch.equal(x[last], y[last]), f
        running = out[0].world.npc.ped_xy[~last]
        assert not torch.equal(running, fresh.ped_xy[~last]), "the running worlds respawned"
        ended |= out[5]
        states = out[0]
    assert bool(ended[1:-1].any()) and bool(ended[-1].any()) and not bool(ended[-1].all())
    assert float(states.world.npc.ped_active.sum()) == B * pedestrians


# ---------------------------------------------------------------- the block rollout vs JAX

TRAFFIC = dict(town_names=("Town02",), num_routes=8, max_timesteps=7,
               weather_ids=tuple(int(i) for i in weather_ids(TEST_WEATHERS)),
               num_vehicles=5, num_pedestrians=10, v_max=5, p_max=10)


class _InjectedTrafficEnv(CARLAEnv):
    """The port's env with its reset and NPC tick draws taken from a list,
    one (reset, NPC tick) pair per physics tick, stacked (K, B) for each
    block call."""
    ticks = None
    calls = 0

    def step_physics_block(self, states, actions, draws=None, npc_draws=None):
        self.calls += 1
        ticks = [self.ticks.pop(0) for _ in range(actions.shape[0])]
        return super().step_physics_block(states, actions, *map(_stack, zip(*ticks)))


def _jax_draws(jenv, d, v_max=5, p_max=10):
    """The port's ResetDraws, NPC spawn included, of a vmapped
    jworld._reset_draws."""
    return _to_draws(d)._replace(npc=jax_reset_draws(d[6], jenv.town, d[0], v_max, p_max))


def _traffic_rollout(world: dict, render_mode: str):
    """JAX's run_rollout_blocks and the port's on B worlds of `world` for
    STEPS steps from the same reset, actions and draws: JAX's per-world
    draws of every tick replayed into the port's, each NPC tick's scaled by
    the town its world holds at that tick.  Returns (JAX final state, JAX
    trajectory, port final state, port trajectory, towns (STEPS + 1, B))."""
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**world), render_mode=render_mode))
    tenv = _InjectedTrafficEnv(CARLAEnvConfig(world=tworld.WorldParams(**world)),
                               device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((B,), jnp.int32))
    d0 = jax.vmap(lambda k: jworld._reset_draws(k, jenv.params, jenv.town, jenv.routes))(keys)
    key0 = jax.random.PRNGKey(5)
    key, actions = key0, []
    for _ in range(STEPS // K):
        key, k_act = jax.random.split(key)
        actions.append(np.asarray(jax.random.uniform(k_act, (K, B, 2), minval=0.05,
                                                     maxval=0.95)))

    def jpredict(net_in, k, n):
        a = jax.random.uniform(k, (n, B, 2), minval=0.05, maxval=0.95)
        return dict(action=a, log_prob=jnp.log(a), value=jnp.zeros((B, 2)))

    run = jax.jit(lambda s, k: jrollout.run_rollout_blocks(jenv, jpredict, s, k, STEPS))
    jfinal, jtraj, _ = run(js, key0)

    # JAX's draws of every tick from each world's key, replayed along the
    # rollout's done flags: step_world splits (key', k_npc) off the state's
    # key, the auto-reset draws from split(key')[0] and a world that ends
    # carries on with the reset's key (world.py:341, carla_env.py:502); its
    # next ticks are in the reset's town
    @jax.jit
    def tick(key, done):
        split = lambda ks, i: jax.vmap(lambda k: jax.random.split(k)[i])(ks)  # noqa: E731
        key1, k_npc = split(key, 0), split(key, 1)
        d = jax.vmap(lambda k: jworld._reset_draws(k, jenv.params, jenv.town, jenv.routes))(
            split(key1, 0))
        return jnp.where(done[:, None], d[7], key1), d, k_npc

    done = np.asarray(jtraj.terminated + jtraj.truncated) > 0
    key, per_tick = js.world.key, []
    towns = [np.asarray(js.world.town_id)]
    for i in range(STEPS):
        key, d, k_npc = tick(key, jnp.asarray(done[i]))
        per_tick.append((d, k_npc))
        towns.append(np.where(done[i], np.asarray(d[0]), towns[-1]))
    # every tick's draws converted at once, then split by tick
    cat = lambda xs: jnp.concatenate(xs)  # noqa: E731
    d, k_npc = (jax.tree_util.tree_map(lambda *x: cat(x), *col) for col in zip(*per_tick))
    split = lambda tree: [tworld.map_tensors(lambda t: t[i * B:(i + 1) * B], tree)  # noqa: E731
                          for i in range(STEPS)]
    town_id = jnp.asarray(np.concatenate(towns[:-1]))
    v, p = world["v_max"], world["p_max"]
    tenv.ticks = list(zip(split(_jax_draws(jenv, d, v, p)),
                          split(jax_step_draws(k_npc, jenv.town, town_id, v, p))))
    blocks = iter(actions)

    def tpredict(net_in, n):
        a = torch.from_numpy(next(blocks).copy())
        return dict(action=a, log_prob=torch.log(a), value=torch.zeros(B, 2))

    tstate, _ = tenv.reset(_jax_draws(jenv, d0, v, p))
    tfinal, ttraj, _ = trollout.run_rollout_blocks(tenv, tpredict, tstate, STEPS)
    assert tenv.calls == STEPS // K and not tenv.ticks, "one physics call per block"
    return jfinal, jtraj, tfinal, ttraj, np.stack(towns)


@pytest.fixture(scope="module")
def traffic_rollouts():
    return _traffic_rollout(TRAFFIC, "pallas")[:4]


def test_block_rollout_with_traffic_matches_jax(traffic_rollouts):
    jfinal, jtraj, tfinal, ttraj = traffic_rollouts
    assert float(np.sum(np.asarray(jtraj.terminated) + np.asarray(jtraj.truncated))) >= B
    assert float(np.sum(np.asarray(jtraj.post_reset))) > 0, "no mid-block reset"
    for k in ("terminated", "truncated", "post_reset", "stack_ids"):
        np.testing.assert_array_equal(getattr(ttraj, k).numpy(),
                                      np.asarray(getattr(jtraj, k)), k)
    for k in ("reward", "speed", "similarity", "road", "vehicle", "navigation",
              "action", "log_prob", "value"):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(), np.asarray(getattr(jtraj, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    for k in ("frames", "init_stack"):
        assert _within2(getattr(ttraj, k).numpy(), np.asarray(getattr(jtraj, k))) > 0.99, k
    np.testing.assert_array_equal(tfinal.stack_ids.numpy(), np.asarray(jfinal.stack_ids))
    np.testing.assert_array_equal(tfinal.stack_slot.numpy(), np.asarray(jfinal.stack_slot))
    want = _to_state(jfinal).world
    for f in ("route_id", "wp_idx", "timestep", "episode", "weather_id"):
        np.testing.assert_array_equal(getattr(tfinal.world, f).numpy(),
                                      getattr(want, f).numpy(), f)
    for f in ("x", "y", "yaw", "v", "total_reward"):
        np.testing.assert_allclose(getattr(tfinal.world, f).numpy(), getattr(want, f).numpy(),
                                   rtol=0, atol=1e-4, err_msg=f)
    assert_npc(tfinal.world.npc, jfinal.world.npc, 1e-4, "final NPCs")
    assert float(tfinal.world.npc.veh_active.sum()) > 0


# ---------------------------------------------------------------- random towns (stage s4)

TWO_TOWNS = dict(TRAFFIC, town_names=("Town01", "Town02"), random_towns=True)


def test_block_restarting_into_another_town_equals_its_ticks():
    """env.step_physics_block with NPCs on a Town01 + Town02 bank, worlds
    restarting mid-block: it draws the block's NPC uniforms, then its reset
    draws, and equals K per-step ticks (env.step_physics) whose NPC draws
    are tick k's uniforms scaled by the towns the worlds hold at tick k.
    Some world restarts mid-block into the other town, and there those
    draws differ from the same uniforms scaled by the block's starting
    towns (what the block used to draw)."""
    share_towns("Town01", "Town02")
    env = stages.build_env(town="Town02", random_towns=["Town01", "Town02"], max_timesteps=6,
                           device="cpu", spawn=dict(vehicles=5, pedestrians=10), **SMALL_ENV)
    states, _ = env.reset_batch(B)
    states = states._replace(world=states.world._replace(
        timestep=torch.arange(B, dtype=torch.int64) % 6))
    gen = torch.Generator().manual_seed(2)
    p = env.params
    moved = differ = 0
    for blk in range(3):
        actions = torch.rand((K, B, 2), generator=gen) * 2.0 - 1.0
        twin = torch.Generator().manual_seed(0)
        twin.set_state(env.generator.get_state())
        out = env.step_physics_block(states, actions)
        u = ttraffic.block_npc_step_uniforms(twin, K, B, p.v_max, p.p_max, "cpu")
        rd = tworld.block_reset_draws(twin, K, B, p, env.routes, env.weather_table, env.town)
        assert torch.equal(twin.get_state(), env.generator.get_state())
        st, rows = states, []
        for k in range(K):
            nd = ttraffic.step_draws_from_uniforms(u[k], env.town, st.world.town_id,
                                                   p.v_max, p.p_max)
            stale = ttraffic.step_draws_from_uniforms(u[k], env.town, states.world.town_id,
                                                      p.v_max, p.p_max)
            switched = st.world.town_id != states.world.town_id
            moved += int(switched.sum())
            differ += int((nd.goal.wp != stale.goal.wp).any(dim=1)[switched].sum())
            st, *row = env.step_physics(st, actions[k], draws=_row(rd, k), npc_draws=nd)
            rows.append((row[0], row[1], row[2], row[4]))
        assert _equal(out[0].world, st.world), f"block {blk}: the state after the block"
        for name, x, y in zip(("reward", "term", "trunc", "done"), (out[1], out[2], out[3], out[5]),
                              [torch.stack(r) for r in zip(*rows)]):
            assert torch.equal(x, y), f"block {blk}: {name}"
        states = out[0]
    assert moved > 0, "no world restarted mid-block into another town"
    assert differ > 0, "the new town's draws equal the old town's"


def test_two_town_block_rollout_with_traffic_matches_jax():
    """run_rollout_blocks on the Town01 + Town02 bank with 5 vehicles and
    10 walkers (stage s4's random towns) against JAX's, as
    test_block_rollout_with_traffic_matches_jax, the JAX renderer off
    (render_mode "zeros"; the frames are held by that test): worlds
    restart into either town, mid-block too."""
    share_towns("Town01", "Town02")
    jfinal, jtraj, tfinal, ttraj, towns = _traffic_rollout(TWO_TOWNS, "zeros")
    assert float(np.sum(np.asarray(jtraj.post_reset))) > 0, "no mid-block reset"
    assert len(np.unique(towns)) == 2 and np.any(towns[1:] != towns[:-1]), "no town change"
    for k in ("terminated", "truncated", "post_reset", "stack_ids"):
        np.testing.assert_array_equal(getattr(ttraj, k).numpy(),
                                      np.asarray(getattr(jtraj, k)), k)
    for k in ("reward", "speed", "similarity", "road", "vehicle", "navigation"):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(), np.asarray(getattr(jtraj, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    want = _to_state(jfinal).world
    for f in ("town_id", "route_id", "wp_idx", "timestep", "episode", "weather_id"):
        np.testing.assert_array_equal(getattr(tfinal.world, f).numpy(),
                                      getattr(want, f).numpy(), f)
    for f in ("x", "y", "yaw", "v", "total_reward"):
        np.testing.assert_allclose(getattr(tfinal.world, f).numpy(), getattr(want, f).numpy(),
                                   rtol=0, atol=1e-4, err_msg=f)
    assert_npc(tfinal.world.npc, jfinal.world.npc, 1e-4, "final NPCs")


# ---------------------------------------------------------------- stages and the CLI

@pytest.mark.parametrize("which", ["s2", "s3"])
def test_stage_factories_match_jax(which):
    """The env, agent and learning kwargs of stage_s2 / stage_s3 equal the
    JAX factories' on Town02, with every option the CLI passes."""
    kw = dict(episodes=5, timesteps=512, batch_size=64, num_envs=32, save_every="end",
              town="Town02", rollout_block=True, weights_dir="w",
              env_overrides=dict(cli.SAFE_ENV))
    got = getattr(stages, f"stage_{which}")(**kw)
    want = getattr(jstages, f"stage_{which}")(**kw)
    assert got.name == want.name == f"stage-{which}"
    assert got.env_args == want.env_args
    assert got.learn_args == want.learn_args
    assert got.agent_args == want.agent_args
    assert got.agent_args["load"] and got.agent_args["load_full"]
    assert got.agent_args["aug_intensity"] == 0.0
    if which == "s2":
        assert len(got.env_args["origins"]) == 50
        assert got.env_args["spawn"] == dict(vehicles=0, pedestrians=50)
    else:
        assert "origins" not in got.env_args
        assert got.env_args["random_weathers"] == list(TRAIN_WEATHERS)


@pytest.mark.parametrize("which,extra", [
    ("s4", {}), ("s4", dict(towns=["Town01", "Town02"], aug_intensity=0.5)),
    ("s5", dict(town="Town02")),
    ("s5", dict(town="Town02", traffic="regular", weather=["WetNoon"], load=False)),
    ("s5", dict(town="Town02", traffic="no", stage_name="stage-standard"))])
def test_stage_s4_s5_factories_match_jax(which, extra):
    """The env, agent and learning kwargs of stage_s4 / stage_s5 equal the
    JAX factories': s4 with stage s3's traffic and weathers, random towns
    when given and aug_intensity 1.0 by default; s5 with a traffic level of
    TRAFFIC_SPECS, its weathers and its `load`."""
    kw = dict(episodes=5, timesteps=512, batch_size=64, num_envs=32, save_every="end",
              rollout_block=True, weights_dir="w", env_overrides=dict(cli.SAFE_ENV))
    if which == "s4":
        kw["town"] = "Town02"
    got = getattr(stages, f"stage_{which}")(**kw, **copy.deepcopy(extra))
    want = getattr(jstages, f"stage_{which}")(**kw, **copy.deepcopy(extra))
    assert got.name == want.name == extra.get("stage_name", f"stage-{which}")
    assert got.env_args == want.env_args
    assert got.learn_args == want.learn_args
    assert got.agent_args == want.agent_args
    assert got.agent_args["load"] == extra.get("load", True) and got.agent_args["load_full"]
    assert got.agent_args["aug_intensity"] == extra.get("aug_intensity", 1.0)
    traffic = stages.TRAFFIC_SPECS[extra.get("traffic", "dense")] if which == "s5" \
        else dict(vehicles=50, pedestrians=50)
    assert got.env_args["spawn"] == traffic
    assert got.env_args["random_weathers"] == extra.get("weather", list(TRAIN_WEATHERS))
    with pytest.raises(ValueError, match="traffic"):
        stages.stage_s5(**dict(kw, town="Town02"), traffic="heavy")


def test_make_stage_s4_s5_augmentation(monkeypatch):
    """make_stage hands s4 and s5 their factories' augmentation (1.0), 0
    with --sharp, the --aug-intensity given otherwise; s5 on Town03 with
    dense traffic."""
    for which in ("s4", "s5"):
        monkeypatch.setattr(cli.stages, f"stage_{which}", lambda **kw: kw)
    assert "aug_intensity" not in cli.make_stage("s4", weights_dir="w")
    kw = cli.make_stage("s5", weights_dir="w")
    assert (kw["town"], kw["traffic"]) == ("Town03", "dense") and "aug_intensity" not in kw
    for which in ("s4", "s5"):
        assert cli.make_stage(which, sharp=True, weights_dir="w")["aug_intensity"] == 0.0
        assert cli.make_stage(which, sharp=True, aug_intensity=0.3,
                              weights_dir="w")["aug_intensity"] == 0.3


def test_sharp_recipe_matches_jax(monkeypatch):
    got, want = cli.sharp_recipe(), jmain.sharp_recipe()
    assert set(got) == set(want)
    for k in ("gamma", "lambda_", "network"):
        assert got[k] == want[k], k
    te, je = got["entropy_regularization"], want["entropy_regularization"]
    for step in (0, 30, 300):
        te.step = je.step = step
        assert te() == je(), step
    # what make_stage hands the stage factory with --sharp and --safe
    for which in ("s2", "s3"):
        monkeypatch.setattr(cli.stages, f"stage_{which}", lambda **kw: kw)
    kw = cli.make_stage("s2", sharp=True, weights_dir="w")
    assert kw["gamma"] == 0.999 and kw["lambda_"] == 0.95 and kw["aug_intensity"] == 0.0
    assert kw["network"] == {"control_policy": {"preact_floor": -3.0}}
    assert kw["entropy_regularization"].get_config() == je.get_config()
    kw = cli.make_stage("s3", safe=True, weights_dir="w")
    assert kw["env_overrides"]["off_road_penalty_divisor"] == 5.0
    assert kw["env_overrides"]["reward_speed_cap"] == 15.0
    assert "gamma" not in kw and "aug_intensity" not in kw


def test_hand_off_copies_and_refuses_the_tracked_weights(tmp_path):
    src = tmp_path / "stage-s1"
    (src / "evaluation").mkdir(parents=True)
    (src / "network.pt").write_bytes(b"n")
    (src / "evaluation" / "r.json").write_text("{}")
    dst = tmp_path / "stage-s2"
    dst.mkdir()
    (dst / "stale").write_text("old")
    cli.hand_off("s1", "s2", str(tmp_path))
    assert (dst / "network.pt").read_bytes() == b"n" and (dst / "evaluation" / "r.json").exists()
    assert not (dst / "stale").exists()
    assert cli.main(["--hand-off", "s2", "s3", "--weights-dir", str(tmp_path)]) == 0
    assert (tmp_path / "stage-s3" / "network.pt").exists()
    with pytest.warns(UserWarning, match="no "):
        cli.hand_off("s7", "s8", str(tmp_path))
    assert not (tmp_path / "stage-s8").exists()
    tracked = os.path.join(REPO_ROOT, "weights")
    before = {d: sorted(os.listdir(os.path.join(tracked, d))) for d in os.listdir(tracked)}
    for src_stage, dst_stage in (("s1", "s2"), ("s1", "s9")):
        with pytest.raises(ValueError, match="tracked"):
            cli.hand_off(src_stage, dst_stage, tracked)
    assert {d: sorted(os.listdir(os.path.join(tracked, d))) for d in os.listdir(tracked)} \
        == before


def _load_tracked_hand_off(tmp_path, src: str, dst: str, update_step: int, **stage_kw):
    """Stage `dst` at full width loads the JAX package's tracked
    stage-`src` checkpoint (params.msgpack, no optimizer states) through a
    hand-off in a temporary weights root: every tensor equals
    params_from_jax of the checkpoint, old_policy equals policy, and the
    update step is `update_step`."""
    ckpt = os.path.join(REPO_ROOT, "weights", f"stage-{src}")
    shutil.copytree(ckpt, tmp_path / f"stage-{src}")
    cli.hand_off(src, dst, str(tmp_path))
    stage = getattr(stages, f"stage_{dst}")(
        episodes=1, timesteps=8, batch_size=16, num_envs=4, town="Town02",
        weights_dir=str(tmp_path), env_overrides=dict(device="cpu", num_routes=8), **stage_kw)
    stage.init()
    ref = params_from_jax(read_flax_msgpack(os.path.join(ckpt, "params.msgpack")),
                          read_flax_msgpack(os.path.join(ckpt, "batch_stats.msgpack")))
    sd = stage.agent.network.state_dict()
    for name, v in sd.items():
        if name.startswith("old_policy."):
            assert torch.equal(v, sd[name.replace("old_policy.", "policy.", 1)]), name
        else:
            assert torch.equal(v, ref[name]), name
    assert stage.agent.update_step == update_step
    assert stage.agent.base_path == str(tmp_path / f"stage-{dst}")
    return stage


def test_hand_off_of_the_tracked_stage_s1_loads_exactly(tmp_path):
    _load_tracked_hand_off(tmp_path, "s1", "s2", 150)


@pytest.mark.parametrize("src,dst,update_step", [("s3", "s4", 290), ("s4", "s5", 340)])
def test_hand_off_of_the_tracked_stages_s3_s4_loads_exactly(tmp_path, src, dst, update_step):
    """The tracked weights/stage-s3 into a full-width s4 (with augmentation)
    and weights/stage-s4 into s5 (dense traffic), as the curriculum hands
    them off."""
    stage = _load_tracked_hand_off(tmp_path, src, dst, update_step)
    assert stage.agent.config.aug_intensity == 1.0


def test_curriculum_raises_before_any_stage_trains(tmp_path, monkeypatch):
    """`--fused-step` with stages s4 and s5 (NPC worlds, which the physics
    kernel does not compute), with the curriculum and with `--standard`,
    and a per-stage epoch list of the wrong length, raise before any
    stage trains."""
    root = ["--weights-dir", str(tmp_path), "--device", "cpu"]
    for which in ("s4", "s5"):
        stage = cli.make_stage(which, fused_step=True, device="cpu", weights_dir=str(tmp_path))
        with pytest.raises(NotImplementedError, match="NPC"):
            stage.init()
        with pytest.raises(NotImplementedError, match="NPC"):
            cli.main(["--stage", which, "--fused-step", "--epochs", "1"] + root)
    made = []
    monkeypatch.setattr(cli, "make_stage", lambda *a, **k: made.append(a))
    monkeypatch.setattr(cli.stages, "stage_s5", lambda **k: made.append(k))
    with pytest.raises(NotImplementedError, match="NPC"):
        cli.run_curriculum("1", weights_dir=str(tmp_path), fused_step=True)
    for what in ("--curriculum", "--standard"):
        with pytest.raises(NotImplementedError, match="NPC"):
            cli.main([what, "--fused-step", "--epochs", "1"] + root)
    for epochs in ("1,2,3", "30,16,12,10,10,5"):
        with pytest.raises(ValueError, match="one count per stage"):
            cli.run_curriculum(epochs, weights_dir=str(tmp_path))
    with pytest.raises(ValueError, match="one count per stage"):
        cli.main(["--curriculum", "--epochs", "1,2"] + root)
    assert not made and not (tmp_path / ".train.lock").exists()
    assert not any(p.name.startswith("stage-") for p in tmp_path.iterdir())


@pytest.fixture
def small_cli(monkeypatch):
    """The CLI's stages cut to one update of 4 worlds x 8 steps of a tiny
    network on Town02; returns {stage name: [(stage, network and Adam
    states right after Stage.init)]}."""
    made = {}
    monkeypatch.setattr(cli, "EPISODES", 1)
    monkeypatch.setattr(cli, "TIMESTEPS", 8)
    monkeypatch.setattr(cli, "BATCH", 16)
    for which in cli.STAGE_ORDER:
        factory = getattr(stages, f"stage_{which}")

        def small(factory=factory, **kw):
            kw.update(network=TINY_NET, town="Town02",
                      env_overrides=dict(kw["env_overrides"], **SMALL_ENV))
            stage = factory(**kw)
            init = stage.init

            def recorded_init():
                init()
                agent = stage.agent
                made.setdefault(stage.name, []).append((stage, dict(
                    network={k: v.clone() for k, v in agent.network.state_dict().items()},
                    optimizers={g: copy.deepcopy(o.state_dict())
                                for g, o in agent.optimizers.items()},
                    update_step=agent.update_step)))

            stage.init = recorded_init
            return stage

        monkeypatch.setattr(cli.stages, f"stage_{which}", small)
    return made


ARGS = ["--epochs", "1", "--num-envs", "4", "--block", "--device", "cpu"]


def test_cli_stage_s2_loads_a_hand_off_checkpoint(tmp_path, small_cli):
    """`--stage s1`, `--hand-off s1 s2`, then `--stage s2`: s2 starts from
    s1's checkpoint exactly and trains with 50 walkers; `--fused-step` with
    s2 raises before any training."""
    root = ["--weights-dir", str(tmp_path)]
    assert cli.main(["--stage", "s1"] + ARGS + root) == 0
    s1 = torch.load(tmp_path / "stage-s1" / "network.pt")
    assert cli.main(["--hand-off", "s1", "s2"] + root) == 0
    assert cli.main(["--stage", "s2"] + ARGS + root) == 0
    stage, at_init = small_cli["stage-s2"][0]
    for name, v in at_init["network"].items():
        ref = s1[name.replace("old_policy.", "policy.", 1)] if "running" not in name else s1[name]
        assert torch.equal(v, ref), name
    assert at_init["update_step"] == 1 and stage.agent.update_step == 2
    p = stage.env.params
    assert (p.num_vehicles, p.num_pedestrians, len(p.origin_spawns)) == (0, 50, 50)
    assert stage.env.n_actors == 5 and stage.agent.config.rollout_block
    assert (tmp_path / "stage-s2" / "network.pt").exists()
    with pytest.raises(NotImplementedError, match="NPC"):
        cli.main(["--stage", "s2", "--fused-step"] + ARGS + root)
    assert len(small_cli["stage-s2"]) == 1, "a stage trained with --fused-step"
    assert not (tmp_path / ".train.lock").exists()


def _held(at_init: dict, path) -> None:
    """The network and Adam states a stage started from equal the
    checkpoint under `path`, old_policy its policy."""
    net = torch.load(path / "network.pt")
    for name, v in at_init["network"].items():
        ref = net[name.replace("old_policy.", "policy.", 1)] if "running" not in name \
            else net[name]
        assert torch.equal(v, ref), name
    opt = torch.load(path / "optimizers.pt")
    for g, state in at_init["optimizers"].items():
        for i, st in opt[g]["state"].items():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(state["state"][i][key], st[key]), (g, i, key)


def test_curriculum_hands_off_between_stages(tmp_path, small_cli):
    """run_curriculum's loop over s1 -> s5: each of s2-s5 starts from the
    previous stage's checkpoint, the port's own network.pt and
    optimizers.pt, with its network and Adam states equal to the saved
    ones; s4 trains with augmentation, s5 with dense traffic."""
    logs = []
    cli.run_curriculum("1", num_envs=4, block=True, weights_dir=str(tmp_path),
                       log=logs.append, device="cpu")
    assert [m.split()[1] for m in logs[::2]] == [f"stage-s{i}" for i in range(1, 6)]
    for i in range(2, 6):
        stage, at_init = small_cli[f"stage-s{i}"][0]
        _held(at_init, tmp_path / f"stage-s{i - 1}")
        assert at_init["update_step"] == i - 1 and stage.agent.update_step == i
    s3, s4, s5 = (small_cli[f"stage-s{i}"][0][0] for i in (3, 4, 5))
    p = s3.env.params
    assert (p.num_vehicles, p.num_pedestrians) == (50, 50) and p.origin_spawns is None
    assert p.weather_ids == tuple(int(i) for i in weather_ids(TRAIN_WEATHERS))
    assert s3.agent.config.aug_intensity == 0.0 and s4.agent.config.aug_intensity == 1.0
    assert (s4.env.params.num_vehicles, s4.env.params.num_pedestrians) == (50, 50)
    assert (s5.env.params.num_vehicles, s5.env.params.num_pedestrians) == (100, 200)
    assert s5.agent.config.aug_intensity == 1.0 and s5.env.n_actors == 8


def test_cli_standard_trains_from_scratch(tmp_path, small_cli):
    """`--standard`: stage s5's setting (dense traffic, augmentation) from
    a fresh network into stage-standard; what that directory held is not
    read."""
    (tmp_path / "stage-standard").mkdir()
    (tmp_path / "stage-standard" / "network.pt").write_bytes(b"not a checkpoint")
    assert cli.main(["--standard"] + ARGS + ["--weights-dir", str(tmp_path)]) == 0
    stage, at_init = small_cli["stage-standard"][0]
    fresh = CARLAgent(stage.env, stage.agent.config, name="fresh", weights_dir="unused")
    for name, v in fresh.network.state_dict().items():
        assert torch.equal(at_init["network"][name], v), name
    assert at_init["update_step"] == 0 and stage.agent.update_step == 1
    assert not at_init["optimizers"]["policy"]["state"]
    assert stage.agent.config.aug_intensity == 1.0 and not stage.agent_args["load"]
    assert (stage.env.params.num_vehicles, stage.env.params.num_pedestrians) == (100, 200)
    assert torch.load(tmp_path / "stage-standard" / "network.pt").keys() == \
        fresh.network.state_dict().keys()
    assert not (tmp_path / "stage-s5").exists() and not (tmp_path / ".train.lock").exists()


@pytest.mark.parametrize("block", [True, False])
def test_learn_two_updates_with_traffic(block):
    """Two updates of a tiny network on 4 Town02 worlds with 5 vehicles and
    10 walkers, with block rollouts (the plain NPC block) and per step."""
    env = stages.build_env(town="Town02", max_timesteps=12, device="cpu",
                           spawn=dict(vehicles=5, pedestrians=10), **SMALL_ENV)
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, num_envs=4, rollout_steps=8,
                                           batch_size=16, rollout_block=block),
                      name="t", weights_dir="unused")
    before = {k: v.clone() for k, v in agent.network.state_dict().items()}
    states, history = agent.learn(2)
    assert len(history) == 2 and agent.update_step == 2
    for m in history:
        for k in ("loss_policy", "loss_value", "entropy", "ratio", "kl", "reward_mean"):
            assert np.isfinite(m[k]), k
    after = agent.network.state_dict()
    for grp in ("policy.", "value.", "dynamics."):
        assert max(float((after[k] - before[k]).abs().max()) for k in after
                   if k.startswith(grp)) > 0.0, grp
    assert int(states.world.npc.ped_active.sum()) == 4 * 10
