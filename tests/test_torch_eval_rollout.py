"""The evaluation slice of the PyTorch port as a whole, against the JAX
package on the CPU: 8 Town02 worlds driven by the converted safe-s5 network
for 12 steps through CARLAEnv.step (renderer included, the Pallas kernel in
interpret mode), with the JAX loop's own action samples and reset draws fed
to the port.

Tolerances: rewards and the world's floats 1e-4 (the free-running bar of
tests/test_physics_fused.py, after auto-resets); flags exact; image stacks
|diff| <= 2 u8 on > 99 % of pixels (tests/test_rasterizer.py); the network's
Beta mean and std, the log-prob of the JAX action and the value to 1e-3
(BatchNorm amplifies float32 rounding ~30x per layer through the backbone,
CLAUDE.md:292-300).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import (
    CARLAEnv as JEnv, CARLAEnvConfig as JEnvConfig, convert_action as jconvert)
from carla_driving_rl_agent_tpu.envs.weather import TEST_WEATHERS, weather_ids
from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet

from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import (
    CARLAEnv, CARLAEnvConfig, convert_action)
from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.ops.render import pack_geometry_banked
from carla_driving_rl_agent_torch.utils.checkpoint import load_network_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "safe-s5")
SPEC = {"control_policy": {"preact_floor": -3.0}}
B, STEPS = 8, 12
COMMON = dict(town_names=("Town02",), num_routes=8, max_timesteps=7,
              weather_ids=tuple(int(i) for i in weather_ids(TEST_WEATHERS)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for the module, its rollout fixture included:
    beside the suite's other workers, intra-op threads spend most of their
    time waiting for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_DRAW_FNS = {}


def _draws(jenv, jstate, batch):
    """The reset draws that JAX's CARLAEnv.step uses for each world's
    auto-reset from `jstate` (key -> step key -> reset key), compiled once
    per env (eagerly, each call runs one program per operation)."""
    if id(jenv) not in _DRAW_FNS:
        def one(k):
            step_key = jax.random.split(k)[0]
            reset_key = jax.random.split(step_key)[0]
            tid, wid, rid, _, _, st, _, _ = jworld._reset_draws(
                reset_key, jenv.params, jenv.town, jenv.routes)
            return tid, wid, rid, st
        _DRAW_FNS[id(jenv)] = (jenv, jax.jit(jax.vmap(one)))
    tid, wid, rid, st = _DRAW_FNS[id(jenv)][1](jstate.world.key)
    return tworld.ResetDraws(*(torch.as_tensor(np.array(a)).to(d) for a, d in (
        (tid, torch.int64), (wid, torch.int64), (rid, torch.int64), (st, torch.float32))))


@pytest.fixture(scope="module")
def rollout():
    return run_rollout(COMMON)


def run_rollout(common: dict) -> list:
    """STEPS steps of B worlds of the world configuration `common` on both
    sides, the JAX loop's samples and reset draws fed to the port: per step
    the JAX and the port's network outputs, rewards, flags, world floats
    and image stacks, and the port's render pack of the step's frame."""
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**common), render_mode="pallas"))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**common)), device="cpu")
    P = serialization.msgpack_restore(open(os.path.join(WEIGHTS, "params.msgpack"), "rb").read())
    S = serialization.msgpack_restore(open(os.path.join(WEIGHTS, "batch_stats.msgpack"), "rb").read())
    jnet = JNet(**SPEC)
    tnet = CARLANetwork(**SPEC)
    load_network_weights(tnet, WEIGHTS)

    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((B,), jnp.int32))
    k = jax.vmap(lambda kk: jworld._reset_draws(kk, jenv.params, jenv.town, jenv.routes))(keys)
    tstate, tobs = tenv.reset(tworld.ResetDraws(
        torch.as_tensor(np.array(k[0]), dtype=torch.int64),
        torch.as_tensor(np.array(k[1]), dtype=torch.int64),
        torch.as_tensor(np.array(k[2]), dtype=torch.int64),
        torch.as_tensor(np.array(k[5]), dtype=torch.float32)))

    jstep = jax.jit(jenv.step_batch)
    jpredict = jax.jit(lambda obs, key: jnet.predict(P, S, obs, key))
    key = jax.random.PRNGKey(11)
    log = []
    for _ in range(STEPS):
        key, kp = jax.random.split(key)
        jin = {f"state_{n}": v for n, v in jobs.items()}
        jin["action"] = jstate.last_action
        jpred = jpredict(jin, kp)
        tin = {f"state_{n}": v for n, v in tobs.items()}
        with torch.no_grad():
            feat = tnet.dynamics(tin)
            pol, val = tnet.old_policy(feat), tnet.value(feat)
        act = np.asarray(jpred["action"])
        draws = _draws(jenv, jstate, B)
        jstate, jobs, jr, jterm, jtrunc, _ = jstep(jstate, jconvert(jpred["action"]))
        tstate, tobs, tr, tterm, ttrunc, _ = tenv.step(
            tstate, convert_action(torch.from_numpy(act.copy())), draws=draws)
        log.append(dict(
            j=dict(mean=np.asarray(jpred["mean"]), std=np.asarray(jpred["std"]),
                   log_prob=np.asarray(jpred["log_prob"]), value=np.asarray(jpred["value"]),
                   reward=np.asarray(jr), term=np.asarray(jterm), trunc=np.asarray(jtrunc),
                   image=np.asarray(jstate.image_stack), x=np.asarray(jstate.world.x),
                   v=np.asarray(jstate.world.v), route=np.asarray(jstate.world.route_id),
                   ids=np.asarray(jstate.stack_ids), obs_image=np.asarray(jobs["image"])),
            t=dict(mean=pol["dist"].mean().numpy(), std=pol["dist"].stddev().numpy(),
                   log_prob=pol["dist"].log_prob(torch.from_numpy(act.copy())).numpy(),
                   value=val["value"].numpy(), reward=tr.numpy(), term=tterm.numpy(),
                   trunc=ttrunc.numpy(), image=tstate.image_stack.numpy(),
                   x=tstate.world.x.numpy(), v=tstate.world.v.numpy(),
                   route=tstate.world.route_id.numpy(), ids=tstate.stack_ids.numpy(),
                   obs_image=tobs["image"].numpy(),
                   geom=pack_geometry_banked(tenv.town, tstate.world,
                                             tenv.weather_params[tstate.world.weather_id],
                                             n_actors=tenv.n_actors))))
    return log


def test_rollout_exercised_auto_resets(rollout):
    check_rollout_exercised_auto_resets(rollout)


def check_rollout_exercised_auto_resets(rollout):
    n_done = sum(int(np.sum(s["j"]["term"] | s["j"]["trunc"])) for s in rollout)
    assert n_done >= B, f"only {n_done} episode ends in {STEPS} steps"


def test_rewards_and_flags(rollout):
    check_rewards_and_flags(rollout)


def check_rewards_and_flags(rollout):
    for i, s in enumerate(rollout):
        for k in ("term", "trunc", "route", "ids"):
            np.testing.assert_array_equal(s["t"][k], s["j"][k], f"step {i} {k}")
        for k in ("reward", "x", "v"):
            np.testing.assert_allclose(s["t"][k], s["j"][k], rtol=0, atol=1e-4,
                                       err_msg=f"step {i} {k}")


def test_image_stacks(rollout):
    for i, s in enumerate(rollout):
        d = np.abs(s["t"]["image"].astype(np.int32) - s["j"]["image"].astype(np.int32))
        assert (d <= 2).mean() > 0.99, f"step {i}: {(d > 2).mean():.4f} of pixels off"
        np.testing.assert_allclose(s["t"]["obs_image"], s["j"]["obs_image"],
                                   rtol=0, atol=2.0 / 255.0 + 1e-6)


def test_network_outputs(rollout):
    check_network_outputs(rollout)


def check_network_outputs(rollout):
    for i, s in enumerate(rollout):
        for k in ("mean", "std", "log_prob", "value"):
            np.testing.assert_allclose(s["t"][k], s["j"][k], rtol=0, atol=1e-3,
                                       err_msg=f"step {i} {k}")
