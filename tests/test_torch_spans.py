"""The port's spans (utils/profiling.py) on the CPU: off, they record
nothing and CARLAgent.last_timings still times the update's phases; on,
they nest under their parents through one CARLAgent.learn(1) of a tiny
Town02 agent and through an evaluation with NPCs, per step and in blocks;
and their clock is the profiler's."""

import statistics

import pytest
import torch

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.utils import profiling
from torch_learner_common import TINY_NET, one_thread  # noqa: F401  (one PyTorch thread)

WORLD = dict(town_names=("Town02",), num_routes=8, max_timesteps=12)
NPCS = dict(num_vehicles=4, num_pedestrians=4, v_max=4, p_max=4)


@pytest.fixture(autouse=True)
def recording_off():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.stop()
    profiling.drain()
    yield
    profiling.stop()
    profiling.drain()


def _env(**world):
    return CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**WORLD, **world), image_height=45,
                                   image_width=60, fused_step=not world), device="cpu")


@pytest.fixture(scope="module")
def env():
    return _env()


@pytest.fixture(scope="module")
def npc_env():
    return _env(**NPCS)


def _agent(env, **cfg):
    return CARLAgent(env, CARLAgentConfig(network=TINY_NET, **cfg), name="spans",
                     weights_dir="unused", log_mode=None)


def _recorded(fn):
    profiling.start()
    try:
        fn()
    finally:
        profiling.stop()
    return profiling.drain()


def _paths(spans):
    """Each span's path of names from the top, by its id."""
    by_id = {s.id: s for s in spans}

    def path(s):
        return (path(by_id[s.parent]) + "/" if s.parent in by_id else "") + s.name
    return {s.id: path(s) for s in spans}


def _ancestors(spans, s):
    by_id = {x.id: x for x in spans}
    out = []
    while s.parent in by_id:
        s = by_id[s.parent]
        out.append(s.id)
    return out


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing_and_costs_a_shared_context():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        with profiling.timed("b") as t:
            pass
    assert t.seconds >= 0.0
    assert profiling.drain() == []


def test_spans_nest_under_their_parents():
    def work():
        with profiling.span("outer"):
            with profiling.span("inner"):
                with profiling.timed("leaf"):
                    pass
            with profiling.span("inner"):
                pass
        with profiling.span("top"):
            pass
    spans = _recorded(work)
    assert [s.name for s in spans] == ["leaf", "inner", "inner", "outer", "top"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    outer, top = by_name["outer"][0], by_name["top"][0]
    assert outer.parent == top.parent == -1
    assert all(s.parent == outer.id for s in by_name["inner"])
    assert by_name["leaf"][0].parent == by_name["inner"][0].id
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = next(x for x in spans if x.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert outer.end_ns <= top.start_ns
    assert profiling.drain() == []


def test_learn_off_keeps_last_timings(env):
    agent = _agent(env, num_envs=4, rollout_steps=8, batch_size=16, rollout_block=True)
    agent.learn(1)
    assert set(agent.last_timings) == {"rollout", "targets", "policy", "value"}
    assert all(v > 0.0 for v in agent.last_timings.values())
    assert profiling.drain() == []


TRAINING = {
    "update": None,
    "update.rollout": "update", "update.targets": "update",
    "rollout.predict": "update.rollout", "env.physics_block": "update.rollout",
    "env.push_block": "update.rollout", "render": "env.push_block",
    "minibatch.gather": None,
    "step.forward": None, "step.backward": None, "step.apply": None,
    "step.old_policy": None,
}


@pytest.mark.parametrize("scheme", ["sequential", "fused_augmented"])
def test_learn_records_every_training_span(env, scheme):
    """learn(1): every span of the update under its parent, each
    minibatch step's four children, and last_timings equal to the phases'
    spans.  The fused scheme's steps augment their minibatches."""
    fused = scheme == "fused_augmented"
    agent = _agent(env, num_envs=4, rollout_steps=8, batch_size=16, rollout_block=True,
                   fused_update=fused, aug_intensity=1.0 if fused else 0.0)
    spans = _recorded(lambda: agent.learn(1))
    paths = _paths(spans)
    names = {s.name for s in spans}
    phases = ["update.fused"] if fused else ["update.policy", "update.value"]
    steps = ["minibatch.fused_step"] if fused else ["minibatch.policy_step",
                                                     "minibatch.value_step"]
    assert set(TRAINING) | set(phases) | set(steps) | ({"augment"} if fused else set()) \
        <= names, names
    (update,) = [s for s in spans if s.name == "update"]
    assert update.parent == -1
    assert {s.name for s in _children(spans, update)} == {
        "update.rollout", "update.targets", *phases}
    for s in spans:
        parent = TRAINING.get(s.name)
        # learn's first reset renders outside the update
        if parent is not None and paths[s.id].startswith("update/"):
            assert paths[s.id].split("/")[-2] == parent, paths[s.id]
    n_mb = 4 * 8 // 16
    for phase, step in zip(phases, steps):
        (p,) = [s for s in spans if s.name == phase]
        kids = _children(spans, p)
        assert [k.name for k in kids].count(step) == n_mb
        assert [k.name for k in kids].count("minibatch.gather") == n_mb
        for k in kids:
            if k.name == step:
                inner = [c.name for c in _children(spans, k)]
                assert {"step.forward", "step.backward", "step.apply"} <= set(inner), inner
                assert inner.count("step.old_policy") == (0 if step.endswith("value_step")
                                                          else 1)
    if fused:
        assert all(paths[s.id].endswith("minibatch.gather/augment")
                   for s in spans if s.name == "augment")
    timed = {s.name: (s.end_ns - s.start_ns) / 1e9 for s in spans if s.name.startswith("update.")}
    keys = {"update.rollout": "rollout", "update.targets": "targets", "update.policy": "policy",
            "update.value": "value", "update.fused": "update"}
    assert agent.last_timings == {keys[k]: v for k, v in timed.items()}


def test_evaluation_with_npcs_records_one_tick_and_spawn_a_step(npc_env):
    """The per-step evaluation: one eval.step a step, each with one predict
    and one env.step, whose world.step holds one npc.tick and world.reset
    one npc.spawn."""
    agent = _agent(npc_env)
    steps = 3
    spans = _recorded(lambda: agent.rollout(2, steps))
    evals = [s for s in spans if s.name == "eval.step"]
    assert len(evals) == steps
    paths = _paths(spans)
    for e in evals:
        kids = [k.name for k in _children(spans, e)]
        assert kids.count("predict") == 1 and kids.count("env.step") == 1, kids
        (step,) = [k for k in _children(spans, e) if k.name == "env.step"]
        assert {k.name for k in _children(spans, step)} == {
            "env.draws", "world.step", "world.reset", "render", "env.observe"}
        below = [paths[s.id][len(paths[e.id]):] for s in spans if e.id in _ancestors(spans, s)]
        assert below.count("/env.step/world.step/npc.tick") == 1, below
        assert below.count("/env.step/world.reset/npc.spawn") == 1, below
    assert sum(s.name == "npc.tick" for s in spans) == steps


def test_block_evaluation_records_its_blocks(env):
    agent = _agent(env, rollout_block=True)
    spans = _recorded(lambda: agent.rollout(2, 8))
    blocks = [s for s in spans if s.name == "eval.block"]
    assert len(blocks) == 2
    for b in blocks:
        kids = [k.name for k in _children(spans, b)]
        assert {"predict", "env.physics_block", "env.push_block"} <= set(kids), kids


def test_span_clock_is_the_profilers():
    """Under torch.profiler on the CPU, a record_function range opened just
    inside each of 100 spans (after one warm-up) starts no more than 10 µs
    before its span's converted start, and 20 µs after it at the median."""
    from torch.profiler import ProfilerActivity, profile, record_function
    profiling.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(101):
            with profiling.span(f"s{i}"):
                with record_function(f"r{i}"):
                    pass
    profiling.stop()
    spans = {s.name[1:]: s.start_ns for s in profiling.drain()}
    ranges = {e.name()[1:]: e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("r") and e.name()[1:].isdigit()}
    offsets = [(ranges[k] - spans[k]) / 1e3 for k in spans if k != "0"]
    assert len(offsets) == 100
    assert min(offsets) >= -10.0, min(offsets)
    assert statistics.median(offsets) < 20.0, statistics.median(offsets)
