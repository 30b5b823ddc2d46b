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
import subprocess
import sys

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
from carla_driving_rl_agent_torch.utils.checkpoint import load_network_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "safe-s5")
SPEC = {"control_policy": {"preact_floor": -3.0}}
B, STEPS = 8, 12
COMMON = dict(town_names=("Town02",), num_routes=8, max_timesteps=7,
              weather_ids=tuple(int(i) for i in weather_ids(TEST_WEATHERS)))


def _draws(jenv, jstate, batch):
    """The reset draws that JAX's CARLAEnv.step uses for each world's
    auto-reset from `jstate` (key -> step key -> reset key)."""
    def one(k):
        step_key = jax.random.split(k)[0]
        reset_key = jax.random.split(step_key)[0]
        tid, wid, rid, _, _, st, _, _ = jworld._reset_draws(
            reset_key, jenv.params, jenv.town, jenv.routes)
        return tid, wid, rid, st
    tid, wid, rid, st = jax.vmap(one)(jstate.world.key)
    return tworld.ResetDraws(*(torch.as_tensor(np.array(a)).to(d) for a, d in (
        (tid, torch.int64), (wid, torch.int64), (rid, torch.int64), (st, torch.float32))))


@pytest.fixture(scope="module")
def rollout():
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**COMMON), render_mode="pallas"))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**COMMON)), device="cpu")
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
                   obs_image=tobs["image"].numpy())))
    return log


def test_rollout_exercised_auto_resets(rollout):
    n_done = sum(int(np.sum(s["j"]["term"] | s["j"]["trunc"])) for s in rollout)
    assert n_done >= B, f"only {n_done} episode ends in {STEPS} steps"


def test_rewards_and_flags(rollout):
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
    for i, s in enumerate(rollout):
        for k in ("mean", "std", "log_prob", "value"):
            np.testing.assert_allclose(s["t"][k], s["j"][k], rtol=0, atol=1e-3,
                                       err_msg=f"step {i} {k}")


# The evaluation's own records and draws (curriculum/stages.evaluate,
# CARLAgent.evaluate) on a tiny network saved under a temporary weights root.
TINY = dict(
    control_policy=dict(units=16, num_layers=1), control_value=dict(units=16, num_layers=1),
    dynamics=dict(shufflenet=dict(g=0.5, last_channels=32),
                  rnn=dict(image=16, road=8, vehicle=8, navigation=8), dynamics=dict(units=32),
                  road=dict(units=8, num_layers=1, activation="relu6"),
                  vehicle=dict(units=8, num_layers=1, activation="relu6"),
                  navigation=dict(units=8, num_layers=1, activation="relu6")))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A temporary checkout root whose weights/tiny holds a tiny network's
    checkpoint (saved by the port, read back as the evaluation reads)."""
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
    root = tmp_path_factory.mktemp("root")
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(town_names=("Town02",))),
                   device="cpu")
    CARLAgent(env, CARLAgentConfig(network=TINY), name="tiny",
              weights_dir=str(root / "weights")).save()
    return root


def _tree(path):
    return sorted((str(p.relative_to(path)), p.read_bytes() if p.is_file() else None)
                  for p in path.rglob("*"))


def test_evaluation_writes_nothing_under_the_weights_root(tiny_root, monkeypatch):
    """An evaluation with no evaluation_dir reads the weights from the
    weights root and writes its record under weights-torch/, never under
    weights/; a record directory under the checkout's tracked weights/ is
    refused."""
    from carla_driving_rl_agent_torch.agents import carla_agent as CA
    from carla_driving_rl_agent_torch.curriculum import stages
    monkeypatch.setattr(CA, "DEFAULT_WEIGHTS_DIR", str(tiny_root / "weights-torch"))
    before = _tree(tiny_root / "weights")
    rec = stages.evaluate("test", "Town02", [5], "no", steps=2, trials=2, weights="tiny",
                          weights_dir=str(tiny_root / "weights"), device="cpu")
    assert _tree(tiny_root / "weights") == before
    out = tiny_root / "weights-torch" / "tiny" / "evaluation" / "tiny-test-2-2-Town02-no-5.json"
    assert out.exists() and len(rec) == 1 and len(rec[0]["timesteps"]) == 2
    agent = stages.build_eval_agent("test", "Town02", 2, "tiny",
                                    weights_dir=str(tiny_root / "weights"), device="cpu")
    with pytest.raises(ValueError, match="tracked weights"):
        agent.evaluate("x", timesteps=1, trials=1, initial_seed=5,
                       evaluation_dir=os.path.join(REPO, "weights", "tiny", "evaluation"))


def test_traffic_evaluation_writes_its_record(tiny_root, monkeypatch):
    """The evaluation with regular traffic (50 vehicles, 50 walkers) runs
    through stages.evaluate and writes its record, under the scenario's
    name, under weights-torch/; its env draws the 8 actor rows."""
    from carla_driving_rl_agent_torch.agents import carla_agent as CA
    from carla_driving_rl_agent_torch.curriculum import stages
    monkeypatch.setattr(CA, "DEFAULT_WEIGHTS_DIR", str(tiny_root / "weights-torch"))
    rec = stages.evaluate("test", "Town02", [5], "regular", steps=2, trials=2, weights="tiny",
                          weights_dir=str(tiny_root / "weights"), device="cpu")
    out = (tiny_root / "weights-torch" / "tiny" / "evaluation"
           / "tiny-test-2-2-Town02-regular-5.json")
    assert out.exists() and len(rec) == 1 and len(rec[0]["timesteps"]) == 2
    assert sorted(k for k in rec[0] if not k.endswith(("_mean", "_std"))) == sorted(
        ("collision_rate", "similarity", "waypoint_distance", "speed", "total_reward",
         "timesteps"))
    agent = stages.build_eval_agent("test", "Town02", 2, "tiny", traffic="regular",
                                    weights_dir=str(tiny_root / "weights"), device="cpu")
    p = agent.env.params
    assert (p.num_vehicles, p.num_pedestrians, p.v_max, p.p_max) == (50, 50, 50, 50)
    assert agent.env.n_actors == 8 and not agent.env.config.fused_step
    agent.evaluate("x", timesteps=2, trials=2, initial_seed=5, evaluation_dir=str(out.parent))
    trials = agent.last_trials
    assert (trials["walkers"] == 50).all() and (trials["vehicles"] > 0).all()
    typed = trials["hit_vehicle"] + trials["hit_pedestrian"] + trials["hit_other"]
    assert (typed >= trials["collision"]).all()


def test_evaluation_trials_draw_from_their_own_streams(tiny_root, tmp_path):
    """Trial i's initial reset (town, weather, route, light offset) is the
    same whatever the number of trials, and so of worlds: the first 8
    trials of an 8-trial and a 20-trial evaluation start alike."""
    from carla_driving_rl_agent_torch.curriculum import stages
    agent = stages.build_eval_agent("test", "Town02", 1, "tiny",
                                    weights_dir=str(tiny_root / "weights"), device="cpu")
    seen, reset = [], agent.env.reset

    def spy(draws, *args, **kwargs):
        seen.append(draws)
        return reset(draws, *args, **kwargs)

    agent.env.reset = spy
    for trials in (8, 20):
        agent.evaluate("x", timesteps=1, trials=trials, initial_seed=42,
                       evaluation_dir=str(tmp_path))
    assert len(seen) == 2 and len(seen[0].route_id) == 16 and len(seen[1].route_id) == 28
    for a, b in zip(tworld.tensors(seen[0]), tworld.tensors(seen[1])):
        torch.testing.assert_close(a[:8], b[:8], rtol=0, atol=0)
    assert len(set(seen[1].route_id.tolist())) > 1


BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "carla_driving_rl_agent_tpu")

_NO_JAX = f"""
import importlib, pkgutil, sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import carla_driving_rl_agent_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
need = ["carla_driving_rl_agent_torch." + m for m in (
    "main", "ops.physics", "ops.render", "ops.shuffle_unit", "envs.carla_env", "agents.rollout",
    "agents.carla_agent", "utils.math", "utils.optimizers", "utils.schedules",
    "utils.checkpoint", "curriculum.stages", "models.layers", "models.recurrent",
    "ops.rasterizer", "envs.spaces", "envs.sensors")]
missing = [m for m in need if m not in sys.modules]
assert not missing, missing
print("ok")
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
