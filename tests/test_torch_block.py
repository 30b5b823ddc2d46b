"""The port's block path against the JAX package on the CPU, on 8 Town02
worlds without traffic, with the JAX renderer in Pallas interpret mode:

  * `push_block_frame_batch` with every world on one slot (the uniform
    write) and with a slot per world (the general write);
  * `run_rollout_blocks` driven on both sides by the same injected
    predict_fn (fixed actions, drawn once from JAX keys and handed to the
    port as arrays) and the same reset draws (JAX's `_reset_draws`,
    replayed step by step), then `gather_image_stacks` of every sample.

Tolerances: ids, slots, flags and post_reset exact; rewards and vector
stacks 1e-4 (the free-running bar of tests/test_physics_fused.py; the world
floats agree to ~1e-6); rendered uint8 |diff| <= 2 on > 99 % of pixels
(tests/test_rasterizer.py's bar: a pixel on a class threshold may flip under
a one-ulp difference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.agents import rollout as jrollout
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig
from carla_driving_rl_agent_tpu.envs.carla_env import convert_action as jconvert
from carla_driving_rl_agent_tpu.envs.weather import TEST_WEATHERS, weather_ids

from carla_driving_rl_agent_torch.agents import rollout as trollout
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig, EnvState
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

B, STEPS, BLOCK = 8, 16, 4
COMMON = dict(town_names=("Town02",), num_routes=8, max_timesteps=7,
              weather_ids=tuple(int(i) for i in weather_ids(TEST_WEATHERS)))


class _InjectedEnv(CARLAEnv):
    """The port's env with its reset draws taken from a list, one entry per
    physics tick, stacked (K, B) for each block call."""
    draws = None
    calls = 0

    def step_physics_block(self, states, actions, draws=None):
        self.calls += 1
        ticks = [self.draws.pop(0) for _ in range(actions.shape[0])]
        return super().step_physics_block(
            states, actions,
            tworld.ResetDraws(*(torch.stack(f) for f in zip(*map(tworld.tensors, ticks)))))


@pytest.fixture(scope="module")
def envs():
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**COMMON), render_mode="pallas"))
    tenv = _InjectedEnv(CARLAEnvConfig(world=tworld.WorldParams(**COMMON), fused_step=True),
                        device="cpu")
    jenv.push_jit = jax.jit(jenv.push_block_frame_batch)
    return jenv, tenv


def _to_draws(d):
    tid, wid, rid, _, _, st, _, _ = d
    return tworld.ResetDraws(*(torch.as_tensor(np.array(a)).to(t) for a, t in (
        (tid, torch.int64), (wid, torch.int64), (rid, torch.int64), (st, torch.float32))))


def _to_state(js) -> EnvState:
    world = {}
    for name in tworld.WorldState._fields:
        if name == "npc":        # the JAX state's constant zero fleet; the port's is None
            continue
        a = np.array(getattr(js.world, name))
        world[name] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)
    arr = lambda x, dt=None: torch.from_numpy(np.array(x).astype(dt) if dt else np.array(x))
    return EnvState(world=tworld.WorldState(**world), image_stack=arr(js.image_stack),
                    road_stack=arr(js.road_stack), vehicle_stack=arr(js.vehicle_stack),
                    nav_stack=arr(js.nav_stack), stack_ids=arr(js.stack_ids, np.int64),
                    stack_slot=arr(js.stack_slot, np.int64),
                    last_action=arr(js.last_action))


def _reset(jenv, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((B,), jnp.int32))
    d = jax.vmap(lambda k: jworld._reset_draws(k, jenv.params, jenv.town, jenv.routes))(keys)
    return js, _to_draws(d)


def _within2(a, b):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return (d <= 2).mean()


@pytest.mark.parametrize("uniform", [True, False])
def test_push_block_frame_batch(envs, uniform):
    jenv, tenv = envs
    js, _ = _reset(jenv, 1)
    rng = np.random.default_rng(int(uniform))
    T = jenv.config.time_horizon
    slots = np.full(B, 2, np.int32) if uniform else (np.arange(B) % T).astype(np.int32)
    js = js._replace(
        image_stack=jnp.asarray(rng.integers(0, 256, js.image_stack.shape, dtype=np.uint8)),
        road_stack=jnp.asarray(rng.uniform(0, 1, js.road_stack.shape).astype(np.float32)),
        stack_ids=jnp.asarray(rng.integers(-5, 9, js.stack_ids.shape).astype(np.int32)),
        stack_slot=jnp.asarray(slots))
    was_reset = rng.uniform(size=B) < 0.4
    frame_ids = rng.integers(0, 20, B).astype(np.int32)
    jout = jenv.push_jit(js, jnp.asarray(was_reset), jnp.asarray(frame_ids))
    tout = tenv.push_block_frame_batch(
        _to_state(js), torch.from_numpy(was_reset), torch.from_numpy(frame_ids).long(),
        slot=2 if uniform else None)
    np.testing.assert_array_equal(tout.stack_slot.numpy(), np.asarray(jout.stack_slot))
    np.testing.assert_array_equal(tout.stack_ids.numpy(), np.asarray(jout.stack_ids))
    for k in ("road_stack", "vehicle_stack", "nav_stack"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert _within2(tout.image_stack.numpy(), np.asarray(jout.image_stack)) > 0.99
    if uniform:
        # the general write gives the same stack on uniform slots
        gen = tenv.push_block_frame_batch(
            _to_state(js), torch.from_numpy(was_reset), torch.from_numpy(frame_ids).long())
        assert torch.equal(gen.image_stack, tout.image_stack)
        assert torch.equal(gen.stack_slot, tout.stack_slot)


@pytest.fixture(scope="module")
def rollouts(envs):
    jenv, tenv = envs
    js, tdraws = _reset(jenv, 3)
    key0 = jax.random.PRNGKey(5)

    # the actions each block's predict_fn draws, computed outside the scan
    # exactly as run_rollout_blocks splits its key
    key, actions = key0, []
    for _ in range(STEPS // BLOCK):
        key, k_act = jax.random.split(key)
        actions.append(np.asarray(jax.random.uniform(k_act, (BLOCK, B, 2), minval=0.05,
                                                     maxval=0.95)))

    def jpredict(net_in, k, n):
        a = jax.random.uniform(k, (n, B, 2), minval=0.05, maxval=0.95)
        return dict(action=a, log_prob=jnp.log(a), value=jnp.zeros((B, 2)))

    run = jax.jit(lambda s, k: jrollout.run_rollout_blocks(jenv, jpredict, s, k, STEPS))
    jfinal, jtraj, _ = run(js, key0)

    # JAX's reset draws of every tick, replayed through its physics
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

    blocks = iter(actions)

    def tpredict(net_in, n):
        a = torch.from_numpy(next(blocks).copy())
        return dict(action=a, log_prob=torch.log(a), value=torch.zeros(B, 2))

    tstate, _ = tenv.reset(tdraws)
    tfinal, ttraj, _ = trollout.run_rollout_blocks(tenv, tpredict, tstate, STEPS)
    assert tenv.calls == STEPS // BLOCK and not tenv.draws, "one physics call per block"
    return jfinal, jtraj, tfinal, ttraj


def test_block_rollout_records(rollouts):
    jfinal, jtraj, tfinal, ttraj = rollouts
    n_done = float(np.sum(np.asarray(jtraj.terminated) + np.asarray(jtraj.truncated)))
    assert n_done >= B, "the rollout exercised too few auto-resets"
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
    np.testing.assert_allclose(tfinal.world.x.numpy(), np.asarray(jfinal.world.x),
                               rtol=0, atol=1e-4)


def test_gather_image_stacks(rollouts):
    _, jtraj, _, ttraj = rollouts
    step = np.repeat(np.arange(STEPS), B)
    env = np.tile(np.arange(B), STEPS)
    jimg = np.asarray(jrollout.gather_image_stacks(jtraj, jnp.asarray(step), jnp.asarray(env)))
    timg = trollout.gather_image_stacks(ttraj, torch.from_numpy(step), torch.from_numpy(env))
    assert timg.shape == jimg.shape
    assert _within2(timg.numpy(), jimg) > 0.99
    # the port gathers what it stored, exactly
    timeline = trollout.frame_timeline(ttraj)
    assert torch.equal(trollout.gather_image_stacks(
        ttraj, torch.from_numpy(step), torch.from_numpy(env), timeline), timg)
