"""The port's evaluation on the CPU: its records and draws
(curriculum/stages.evaluate, CARLAgent.evaluate) on a tiny network saved
under a temporary weights root, and the jax-free import of the port and
chip_smoke.py.  The evaluation slice against the JAX package step by step
is tests/test_torch_eval_rollout.py."""

import os
import subprocess
import sys

import pytest
import torch

from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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



def test_evaluation_sweep_holds_each_scenario(tiny_root, monkeypatch, tmp_path, capsys):
    """main.run_evaluation over one town: 2 weather modes x 3 traffic
    levels, one record each under weights-torch/ and one line each printed
    with its timings and means; held against its own records every z-score
    is 0, and against records whose similarity lies 5 standard errors off,
    it raises after the sweep, naming each such scenario."""
    import json
    from carla_driving_rl_agent_torch import main as cli
    from carla_driving_rl_agent_torch.agents import carla_agent as CA
    monkeypatch.setattr(CA, "DEFAULT_WEIGHTS_DIR", str(tiny_root / "weights-torch"))
    kw = dict(steps=2, trials=2, device="cpu", towns=("Town02",),
              weights_dir=str(tiny_root / "weights"))
    rows = cli.run_evaluation("tiny", **kw)
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [(r["mode"], r["traffic"]) for r in rows] == [
        (m, t) for m in ("train", "test") for t in ("no", "regular", "dense")]
    for r in rows:
        assert r["town_seconds"] >= 0 and r["build_seconds"] > 0 and "z" not in r
        assert r["env_steps_per_s"][0] == 10 * 2 / r["seconds"][0]
        assert r["similarity_mean"] > 0
    records = tiny_root / "weights-torch" / "tiny" / "evaluation"
    assert len(list(records.glob("tiny-*-2-2-Town02-*-42.json"))) == 6
    held = cli.run_evaluation("tiny", references=str(records), **kw)
    assert all(v == 0.0 for r in held for v in r["z"].values())
    off = tmp_path / "off"
    off.mkdir()
    for path in records.glob("*.json"):
        rec = json.loads(path.read_text())
        se = rec["similarity_std"] / len(rec["similarity"]) ** 0.5
        rec["similarity_mean"] -= 5.0 * se if se > 0 else 0.0
        (off / path.name).write_text(json.dumps(rec))
    with pytest.raises(RuntimeError, match="standard errors") as err:
        cli.run_evaluation("tiny", references=str(off), **kw)
    assert "test Town02 dense similarity +5.000" in str(err.value)

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
    "ops.rasterizer", "envs.spaces", "envs.sensors", "agents.base", "agents.ppo",
    "models.networks", "models.distributions", "envs.toy", "envs.fake", "envs.route",
    "parallel.mesh", "utils.summary", "utils.profiling", "utils.flops")]
missing = [m for m in need if m not in sys.modules]
assert not missing, missing
print("ok")
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
