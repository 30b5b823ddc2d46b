"""The port's imitation and tooling path against the JAX package on the CPU,
on Town02 with tiny networks:

  * `expert.expert_action` for each behaviour, a mixed profile, and the
    traffic lights heeded and ignored, with 50/50 NPCs (some just ahead of
    an ego, some egos before a junction), held per step from JAX's state
    along a JAX drive; `behaviour_profiles` exactly;
  * `rollout.run_rollout` with `expert_fn` against JAX's, both driven by
    the same injected predict_fn (a Beta from the vector observations):
    actions, log-probs and values;
  * the policy objective with `ratio_clamp`;
  * `CARLAgent.imitate` for one epoch on one trace directory holding
    expert traces (no log_prob) and a network trace, against JAX's imitate
    from the same parameters, in float64 on both sides: the losses and
    every tensor afterwards;
  * `load_traces`' order and `explore_traces` exactly;
  * `nocrash_success`, `CARLABenchmark.TASKS_SPEC` and its weathers, and
    the route length per world from the same states;
  * `Stage.run`'s count of collections for collect=True, False and 2;
  * by structure: the traces of `CARLACollectWrapper` and of
    `CARLAgent.collect` (keys, dtypes, the cut after the first done, the
    threshold), `CARLABenchmark.run`, `record_episodes` and the CLI's
    `--record`, which writes nothing under weights/.

JAX's draws are not needed: the expert is held per step from JAX's state
(the world tests' rule, tolerance 3.5 of ROADMAP.md: the frameworks'
float32 atan2, sin and cos differ by an ulp), and the rollout's episodes do
not end.  Tolerances: the expert 1e-5 + 2.5e-7 relative per step; the
rollout's actions, log-probs and values 1e-4 over its 8 free-running steps
(tests/test_torch_block.py's bar); the objective 1e-5 (float32);
imitate's losses 1e-4 relative + 1e-5 and its tensors test_torch_learner's
float64 bars (1e-4 relative + 1e-7, running statistics 1e-5, tensors whose
true gradient is zero two learning rates per step): the targets are
float32 on both sides (JAX casts them), and JAX's discounted sum is an
associative scan, so they differ by float32 rounding, and the JAX network
rounds its dynamics feature to float32 (tests/test_torch_learner.py).  The
JAX parameters are the port's fresh network's, laid out by jax_trees.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.agents import rollout as jrollout
from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgent as JAgent
from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgentConfig as JConfig
from carla_driving_rl_agent_tpu.curriculum import imitation as jimitation
from carla_driving_rl_agent_tpu.curriculum import stages as jstages
from carla_driving_rl_agent_tpu.envs import expert as jexpert
from carla_driving_rl_agent_tpu.envs import town as jtown
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs import wrappers as jwrappers
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig
from carla_driving_rl_agent_tpu.envs.dynamics import tgather as jtgather
from carla_driving_rl_agent_tpu.models.distributions import Beta as JBeta
from carla_driving_rl_agent_tpu.utils import math as jum
from carla_driving_rl_agent_tpu.utils import traces as jtraces
from carla_driving_rl_agent_tpu.utils.optimizers import get_optimizer_by_name as jopt
from carla_driving_rl_agent_tpu.utils.schedules import DynamicParameter as JDynamic

import carla_driving_rl_agent_torch as port
from carla_driving_rl_agent_torch import REPO_ROOT
from carla_driving_rl_agent_torch import main as cli
from carla_driving_rl_agent_torch.agents import rollout as trollout
from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.curriculum import imitation as timitation
from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import expert as texpert
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs import wrappers as twrappers
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.models.distributions import Beta as TBeta
from carla_driving_rl_agent_torch.utils import traces as ttraces
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax

from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet

from test_torch_block import _to_state
from test_torch_learner import HYPER, LR, MB, TINY_NET, _batch, _f64, _jself
from test_torch_traffic import _t, to_torch_npc

B = 8
ULP2 = 2.5e-7
FLEET = dict(num_vehicles=50, num_pedestrians=50, v_max=50, p_max=50)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small PyTorch operations: one intra-op thread beside the
    suite's other workers (tests/test_torch_curriculum.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def share_towns(*names):
    """The JAX package's town cache filled with the port's towns of
    `names` (equal, tests/test_torch_world.py), so that a JAX env does not
    build them again."""
    for name in names:
        jtown._TOWN_CACHE.setdefault(name, ttown.get_town(name))


@pytest.fixture(scope="module")
def world_data():
    """(JAX params, town, routes), (port params, town, routes) of a 50/50
    Town02 world, the JAX banks made of the port's arrays."""
    share_towns("Town02")
    kw = dict(town_names=("Town02",), num_routes=8, max_timesteps=48, weather_ids=(1, 5, 9),
              **FLEET)
    tp = tworld.WorldParams(**kw)
    tt, tr = tworld.build_world_data(tp, "cpu")
    bank = ttown.build_town_bank(["Town02"])
    jt = jworld.TownDev(**{f: jnp.asarray(getattr(bank, f)) for f in jworld.TownDev._fields})
    xyy = tr.xyy.numpy()
    jr = jworld.RoutesDev(xy=jnp.asarray(xyy[..., :2]), yaw=jnp.asarray(xyy[..., 2]),
                          option=jnp.zeros(xyy.shape[:3], jnp.int32),
                          length=jnp.asarray(tr.length.numpy().astype(np.int32)),
                          xyy=jnp.asarray(xyy), start=jnp.asarray(tr.start.numpy()),
                          end_xy=jnp.asarray(tr.end_xy.numpy()))
    return (jworld.WorldParams(**kw), jt, jr), (tp, tt, tr)


_LAYOUT = []


def jax_trees(net, dtype=jnp.float32):
    """The JAX package's (params, batch_stats) trees of the port's network
    `net` (the inverse of utils/checkpoint.params_from_jax), laid out by
    jax.eval_shape of the JAX network's init, which compiles nothing.  The
    layout (the trees and their shapes) does not depend on the compute
    dtype, so it is traced once per module; the leaves take `dtype`."""
    jnet = JNet(**TINY_NET, compute_dtype=dtype)
    if not _LAYOUT:
        sample = dict(state_image=jnp.zeros((1, 4, 45, 180, 3)),
                      state_road=jnp.zeros((1, 4, 9)), state_vehicle=jnp.zeros((1, 4, 4)),
                      state_navigation=jnp.zeros((1, 4, 5)), action=jnp.zeros((1, 2)))
        _LAYOUT.append(jax.eval_shape(JNet(**TINY_NET).init, jax.random.PRNGKey(0), sample))
    shapes = _LAYOUT[0]
    sd = {k: v.detach().numpy() for k, v in net.state_dict().items()}

    def fill(tree, prefix, stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, prefix + (k,), stats)
                continue
            mod = ".".join(prefix)
            if stats:
                a = sd[f"{mod}.running_{k}"]
            elif k == "kernel":
                w = sd[f"{mod}.weight"]
                a = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
            else:
                a = sd[f"{mod}.{'weight' if k == 'scale' else 'bias'}"]
            assert a.shape == v.shape, (mod, k)
            out[k] = jnp.asarray(np.ascontiguousarray(a), dtype)
        return out

    params, stats = shapes
    return (jnet, {c: fill(params[c], (c,), False) for c in params},
            {c: fill(stats[c], (c,), True) for c in stats})


def _torch_world(js):
    return tworld.WorldState(**{f: _t(getattr(js, f)) for f in tworld.WorldState._fields
                                if f != "npc"}, npc=to_torch_npc(js.npc))


# ---------------------------------------------------------------- the expert

MIX = np.array([0, 1, 2, 0, 1, 2, 2, 1])
EXPERT_CASES = {   # name: (behaviour, profile ids or None, ignore_traffic_light)
    "cautious": ("cautious", None, True),
    "normal": ("normal", None, True),
    "aggressive": ("aggressive", None, True),
    "mixed-lights": ("normal", MIX, False),
    "normal-lights": ("normal", None, False),
}


def _jax_expert(js, jp, jt, jr, case):
    behaviour, ids, ignore = EXPERT_CASES[case]
    if ids is None:
        return jax.vmap(lambda w: jexpert.expert_action(
            w, jp, jt, jr, behaviour=behaviour, ignore_traffic_light=ignore))(js)
    prof = jexpert.behaviour_profiles(jnp.asarray(ids))
    return jax.vmap(lambda w, sf, hd, bg, sd: jexpert.expert_action(
        w, jp, jt, jr, ignore_traffic_light=ignore,
        profile=dict(speed_factor=sf, hazard_distance=hd, brake_gain=bg, speed_decrease=sd)))(
        js, prof["speed_factor"], prof["hazard_distance"], prof["brake_gain"],
        prof["speed_decrease"])


@pytest.fixture(scope="module")
def expert_drive(world_data):
    """Eight 50/50 worlds driven by JAX's expert (the mixed profile, lights
    heeded) for 8 steps; world 0 has an NPC vehicle 9 m ahead, world 1 a
    walker 14 m ahead, worlds 2-5 stand 8 m before a junction facing it at
    light clocks that give green and red.  Returns [(JAX state, {case: JAX
    actions})] per step."""
    (jp, jt, jr), _ = world_data
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    # compiled once (eagerly, the reset compiles one program per operation)
    js = jax.jit(jax.vmap(lambda k: jworld.reset_world(k, jp, jt, jr)))(keys)
    w = jax.tree_util.tree_map(np.array, js)
    fwd = np.stack([np.cos(w.yaw), np.sin(w.yaw)], -1)
    w.npc.veh_xy[0, 0], w.npc.veh_yaw[0, 0], w.npc.veh_active[0, 0] = (
        np.array([w.x[0], w.y[0]]) + 9.0 * fwd[0], w.yaw[0], 1.0)
    w.npc.veh_v[0, 0] = 2.0
    w.npc.ped_xy[1, 0], w.npc.ped_active[1, 0] = np.array([w.x[1], w.y[1]]) + 14.0 * fwd[1], 1.0
    jxy = np.asarray(jt.junction_xy)[0]
    for i, wid in enumerate(range(2, 6)):
        theta = 0.5 * np.pi * i
        w.x[wid], w.y[wid] = jxy[i] + 8.0 * np.array([np.cos(theta), np.sin(theta)])
        w.yaw[wid] = np.float32(theta + np.pi)
        w.sim_time[wid] = np.float32(3.0 + 6.5 * i)
    js = jax.tree_util.tree_map(jnp.asarray, w)

    @jax.jit
    def step(js):
        acts = {c: _jax_expert(js, jp, jt, jr, c) for c in EXPERT_CASES}
        nxt, *_ = jax.vmap(lambda s, a: jworld.step_world(s, a, jp, jt, jr))(
            js, acts["mixed-lights"])
        return nxt, acts

    out = []
    for _ in range(8):
        nxt, acts = step(js)
        out.append((js, acts))
        js = nxt
    return out


@pytest.mark.parametrize("case", list(EXPERT_CASES))
def test_expert_action_matches_jax(world_data, expert_drive, case):
    _, (tp, tt, tr) = world_data
    behaviour, ids, ignore = EXPERT_CASES[case]
    profile = None if ids is None else texpert.behaviour_profiles(torch.from_numpy(ids))
    for i, (js, acts) in enumerate(expert_drive):
        got = texpert.expert_action(_torch_world(js), tp, tt, tr, behaviour=behaviour,
                                    ignore_traffic_light=ignore, profile=profile)
        np.testing.assert_allclose(got.numpy(), np.asarray(acts[case]), rtol=ULP2, atol=1e-5,
                                   err_msg=f"{case} step {i}")


def test_expert_drive_exercises_hazards_and_lights(expert_drive):
    """The drive reaches what the cases tell apart: the lights stop some
    ego (heeding them lowers a0), the NPCs ahead slow theirs, and the
    behaviours differ."""
    a = {c: np.stack([np.asarray(acts[c]) for _, acts in expert_drive]) for c in EXPERT_CASES}
    assert np.any(a["normal-lights"][..., 0] < a["normal"][..., 0] - 1e-3), "no red light"
    assert np.any(a["cautious"][..., 0] < a["aggressive"][..., 0] - 1e-3)
    assert np.all(a["cautious"][..., 0] <= a["aggressive"][..., 0] + 1e-6)
    assert np.any(np.abs(a["normal"][..., 1]) > 0.05), "the steering never moved"


def test_behaviour_profiles_match_jax():
    ids = np.array([0, 1, 2, 2, 1, 0])
    want = jexpert.behaviour_profiles(jnp.asarray(ids))
    got = texpert.behaviour_profiles(torch.from_numpy(ids))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    assert texpert.BEHAVIORS == jexpert.BEHAVIORS
    ids_mix = texpert.mixed_behaviour_ids(("normal", "aggressive"), 5, "cpu")
    assert ids_mix.tolist() == [1, 2, 1, 2, 1]


# ---------------------------------------------------------------- the expert rollout

ROLL = dict(town_names=("Town02",), num_routes=8, max_timesteps=48, weather_ids=(1, 5, 9))


def _beta_params(lib, net_in):
    mean = lambda x: x.mean(axis=(1, 2)) if lib is jnp else x.mean(dim=(1, 2))  # noqa: E731
    road, veh, nav = (net_in[f"state_{k}"] for k in ("road", "vehicle", "navigation"))
    alpha = 1.5 + mean(road)
    beta = 2.0 + mean(veh)
    value = lib.stack([mean(nav), veh.sum(axis=(1, 2)) if lib is jnp else veh.sum(dim=(1, 2))],
                      -1)
    return alpha, beta, value


def test_expert_rollout_matches_jax():
    """run_rollout with expert_fn, 8 steps of 8 Town02 worlds without
    traffic (the mixed behaviours, as CARLAgent's expert rollout mixes
    them), both sides predicting with a Beta from the vector observations;
    no episode ends, so no reset draw is used."""
    share_towns("Town02")
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**ROLL), render_mode="zeros",
                           image_height=45, image_width=60))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**ROLL), image_height=45,
                                   image_width=60), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((B,), jnp.int32))
    ids = texpert.mixed_behaviour_ids(("cautious", "normal", "aggressive"), B, "cpu")
    jprof = jexpert.behaviour_profiles(jnp.asarray(ids.numpy()))

    def jexpert_fn(states):
        return jax.vmap(lambda w, sf, hd, bg, sd: jexpert.expert_action(
            w, jenv.params, jenv.town, jenv.routes, ignore_traffic_light=True,
            profile=dict(speed_factor=sf, hazard_distance=hd, brake_gain=bg,
                         speed_decrease=sd)))(
            states.world, jprof["speed_factor"], jprof["hazard_distance"],
            jprof["brake_gain"], jprof["speed_decrease"])

    def jpredict(net_in, action01):
        alpha, beta, value = _beta_params(jnp, net_in)
        return dict(log_prob=JBeta(alpha[:, None], beta[:, None]).log_prob(action01),
                    value=value)

    run = jax.jit(lambda s, k: jrollout.run_rollout(jenv, jpredict, s, k, 8,
                                                    expert_fn=jexpert_fn))
    _, jtraj, _ = run(js, jax.random.PRNGKey(0))
    assert not np.any(np.asarray(jtraj.terminated + jtraj.truncated)), "an episode ended"

    tprof = texpert.behaviour_profiles(ids)

    def texpert_fn(states):
        return texpert.expert_action(states.world, tenv.params, tenv.town, tenv.routes,
                                     ignore_traffic_light=True, profile=tprof)

    def tpredict(net_in, action01):
        alpha, beta, value = _beta_params(torch, net_in)
        return dict(log_prob=TBeta(alpha[:, None], beta[:, None]).log_prob(action01),
                    value=value)

    _, ttraj, _ = trollout.run_rollout(tenv, tpredict, _to_state(js), 8, expert_fn=texpert_fn)
    for k in ("action", "log_prob", "value", "reward", "speed", "similarity"):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(), np.asarray(getattr(jtraj, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert float(np.asarray(jtraj.speed).max()) > 1.0, "the expert never moved"


def test_learn_with_expert_rollout(tmp_path):
    """expert_rollout with ratio_clamp trains on the CPU, one update (JAX
    tests/test_curriculum.py::test_learn_with_expert_rollout_trains_and_drives_well):
    finite losses, and the rollout's similarity that of the expert."""
    env = stages.build_env(town="Town02", max_timesteps=48, num_routes=8, image_shape=(45, 60, 3),
                           device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, num_envs=4, rollout_steps=8,
                                           batch_size=8, rollout_block=True,
                                           expert_rollout=True, ratio_clamp=4.0),
                      weights_dir=str(tmp_path))
    _, history = agent.learn(1)
    last = history[-1]
    assert all(np.isfinite(v) for v in last.values())
    assert last["similarity_mean"] > 0.7, last


# ---------------------------------------------------------------- ratio_clamp

def test_policy_objective_with_ratio_clamp_matches_jax():
    """The objective with ratio_clamp on a batch whose stored log-probs sit
    far below the policy's (the clamp active), the heads fed the same
    dynamics feature."""
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**ROLL), image_height=45,
                                  image_width=60), device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, ratio_clamp=3.0))
    jnet, params, stats = jax_trees(agent.network)
    jb, tb = _batch(5)
    jb["log_prob"] = jb["log_prob"] - 8.0
    tb["log_prob"] = tb["log_prob"] - 8.0
    js = _jself(jnet)
    js.config = JConfig(network=TINY_NET, ratio_clamp=3.0)
    feat = np.random.default_rng(0).normal(0, 1, (MB, 64)).astype(np.float32)
    # one compiled program instead of an eager compile per operation
    jtot, jaux = jax.jit(lambda p, s, f, b: js._policy_objective(
        p, s, f, b, HYPER, jax.random.PRNGKey(0)))(params, stats, jnp.asarray(feat), jb)
    pol = agent.network.policy_apply(torch.from_numpy(feat), training=True)
    ttot, taux = agent._policy_objective(pol, tb, HYPER)
    assert float(jaux["ratio"]) == pytest.approx(3.0, rel=1e-6), "the clamp is not active"
    for t, j in ((ttot, jtot), (taux["ratio"], jaux["ratio"]),
                 (taux["loss_policy"], jaux["loss_policy"]), (taux["kl"], jaux["kl"])):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5, atol=1e-5)
    # without the clamp the same batch's ratio is far above it
    agent.config.ratio_clamp = 0.0
    _, free = agent._policy_objective(pol, tb, HYPER)
    assert float(free["ratio"]) > 100.0


# ---------------------------------------------------------------- traces

def _write_traces(root, lengths, with_net=(), seed=0, log_prob=np.float32):
    """Synthetic traces trace-{i}-x.npz of the given lengths, in the
    collectors' layout at 24 x 48 frames; those in `with_net` hold
    log_prob and value (the network's), the others env actions in [-1, 1]
    with exact -1 and 1 among them (the expert's full brake and lock)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        action = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
        action[0] = (-1.0, 1.0)
        tr = dict(state_image=rng.integers(0, 256, (n, 4, 24, 48, 3), dtype=np.uint8),
                  state_road=rng.uniform(0, 1, (n, 4, 9)).astype(np.float32),
                  state_vehicle=rng.uniform(0, 1, (n, 4, 4)).astype(np.float32),
                  state_navigation=rng.uniform(0, 3, (n, 4, 5)).astype(np.float32),
                  action=action, reward=rng.uniform(-1, 3, n).astype(np.float32),
                  done=np.zeros(n, np.float32), speed=rng.uniform(0, 40, n).astype(np.float32),
                  similarity=rng.uniform(0.5, 1, n).astype(np.float32))
        tr["done"][-1] = 1.0
        if i in with_net:
            a01 = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
            tr.update(action=a01, log_prob=(np.log(a01) - 0.2).astype(log_prob),
                      value=np.stack([rng.uniform(-1, 1, n), rng.integers(0, 3, n)],
                                     -1).astype(np.float32))
        np.savez_compressed(os.path.join(root, f"trace-{i}-x.npz"), **tr)


def test_load_traces_order_and_explore_traces_match_jax(tmp_path):
    """Twelve traces: sorted as strings (trace-10 before trace-2), shuffled
    by random.Random(seed), and explore_traces' balanced samples, equal."""
    _write_traces(str(tmp_path), [5 + i % 4 for i in range(12)], with_net=(3, 7))
    for kw in (dict(), dict(shuffle=True, seed=4), dict(shuffle=True, seed=4, max_amount=5)):
        want = [t["reward"] for t in jtraces.load_traces(str(tmp_path), **kw)]
        got = [t["reward"] for t in ttraces.load_traces(str(tmp_path), **kw)]
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    first = [t["reward"][0] for t in ttraces.load_traces(str(tmp_path))]
    names = sorted(f for f in os.listdir(tmp_path))
    assert names[2].startswith("trace-10-"), names
    assert len(first) == ttraces.count_traces(str(tmp_path)) == jtraces.count_traces(str(tmp_path))
    want = jimitation.explore_traces(str(tmp_path), amount=6, seed=3)
    got = timitation.explore_traces(str(tmp_path), amount=6, seed=3)
    assert set(got["state"]) == set(want["state"])
    for k in want["state"]:
        np.testing.assert_array_equal(got["state"][k], want["state"][k], k)
    np.testing.assert_array_equal(got["action"], want["action"])
    np.testing.assert_array_equal(got["reward"], want["reward"])
    assert len(got["action"]) > 6
    trace = next(ttraces.load_traces(str(tmp_path)))
    assert ttraces.unpack_trace(trace)[1] is trace["action"]
    assert set(ttraces.unpack_trace(trace)[0]) == {k for k in trace if k.startswith("state_")}


def _jax_agent(jnet, params, stats):
    """A JAX CARLAgent with what imitate reads (network, config, params,
    statistics, the three Adam optimizers and their states, the schedules
    and a key); no env."""
    js = object.__new__(JAgent)
    js.network, js.config = jnet, JConfig(network=TINY_NET)
    js.params, js.stats = dict(params), dict(stats)
    for g in ("policy", "value", "dynamics"):
        setattr(js, f"{g}_opt", jopt("adam", LR))
    js.opt_state = {g: getattr(js, f"{g}_opt").init(js.params[g])
                    for g in ("policy", "value", "dynamics")}
    js.clip_ratio, js.entropy_strength, js.adv_scale = (JDynamic.create(v)
                                                        for v in (0.2, 0.1, 2.0))
    js._key = jax.random.PRNGKey(0)
    return js


def test_imitate_matches_jax(tmp_path, monkeypatch):
    """One epoch of imitate at batch 8 on two expert traces (16 and 12
    steps: their log-probs from the current old policy, their actions
    reaching -1 and 1), a network trace (10 steps) and one of 3 steps
    (skipped), from the same parameters, in float64.  The network trace's
    log-probs are stored in float64, the dtype of the expert's, so that
    JAX traces its update once.  JAX's imitate computes each trace's
    targets eagerly, one compile per operation and trace length; here its
    target helpers run compiled, one program each (the same operations)."""
    for name, static in (("compose_number", ()), ("batched_gae", (4, 5)), ("sp_norm", ()),
                         ("discount_cumsum", (1,)), ("decompose_number", ())):
        monkeypatch.setattr(jum, name, jax.jit(getattr(jum, name), static_argnums=static))
    _write_traces(str(tmp_path), [16, 12, 10, 3], with_net=(2,), seed=1, log_prob=np.float64)
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**ROLL), image_height=45,
                                  image_width=60), device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET), weights_dir=str(tmp_path))
    with jax.enable_x64(True):
        jnet, params, stats = jax_trees(agent.network, jnp.float64)
        js = _jax_agent(jnet, params, stats)
        jlosses = JAgent.imitate(js, epochs=1, batch_size=8, traces_dir=str(tmp_path), seed=6)
        ref = params_from_jax(_f64(js.params), _f64(js.stats))
    agent.network.double()
    # the steps' gradients, to tell the tensors whose true gradient is zero
    names = {id(p): n for n, p in agent.network.named_parameters()}
    tops, inner = {}, agent._grads

    def grab(loss, groups):
        out = inner(loss, groups)
        pairs = [(names[id(p)], g) for grp in groups for p, g in zip(agent.params[grp], out[grp])]
        top = max(float(g.abs().max()) for _, g in pairs)
        for n, g in pairs:
            tops[n] = max(tops.get(n, 0.0), float(g.abs().max()) / top)
        return out

    agent._grads = grab
    tlosses = agent.imitate(epochs=1, batch_size=8, traces_dir=str(tmp_path), seed=6)
    del agent._grads
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(np.array(tlosses), np.array(jlosses), rtol=1e-4, atol=1e-5)
    assert all(np.isfinite(tlosses).ravel())
    sd = agent.network.state_dict()
    assert set(sd) == set(ref)
    noise = {n for n, v in tops.items() if v < 1e-6}
    for name, v in sd.items():
        base = name.replace("old_policy.", "policy.", 1)
        atol = (2 * LR * len(tlosses) if base in noise
                else 1e-5 if "running" in name else 1e-7)
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)


# ---------------------------------------------------------------- the benchmark

def test_benchmark_constants_and_success_match_jax():
    T, J = twrappers.CARLABenchmark, jwrappers.CARLABenchmark
    assert T.TASKS_SPEC == J.TASKS_SPEC
    assert (T.TRAIN_TOWN, T.TEST_TOWN) == (J.TRAIN_TOWN, J.TEST_TOWN)
    assert T.TRAIN_WEATHERS == J.TRAIN_WEATHERS and T.TEST_WEATHERS == J.TEST_WEATHERS
    rng = np.random.default_rng(0)
    steps = rng.integers(1, 400, 64).astype(np.float32)
    collided, arrived = rng.random(64) < 0.3, rng.random(64) < 0.6
    route = rng.uniform(5, 120, 64).astype(np.float32)
    for speed in (10.0, 25.0):
        for g, w in zip(twrappers.nocrash_success(steps, collided, arrived, route, speed),
                        jwrappers.nocrash_success(steps, collided, arrived, route, speed)):
            np.testing.assert_array_equal(g, w)


def test_route_length_per_world_matches_jax(world_data):
    """The route length from each world's waypoint (JAX's route_len_m,
    wrappers.py:297-303) from the same states, some worlds advanced along
    their routes."""
    (jp, jt, jr), (tp, tt, tr) = world_data
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = jax.jit(jax.vmap(lambda k: jworld.reset_world(k, jp, jt, jr)))(keys)
    js = js._replace(wp_idx=jnp.asarray(np.arange(B) * 7, jnp.int32))

    def route_len_m(w):
        r_len = jtgather(jr.length, w.town_id, w.route_id)
        xy = jtgather(jr.xy, w.town_id, w.route_id)
        seg = jnp.linalg.norm(xy[1:] - xy[:-1], axis=-1)
        i = jnp.arange(seg.shape[0])
        m = (i >= w.wp_idx) & (i < r_len - 1)
        return jnp.sum(seg * m)

    want = np.asarray(jax.jit(jax.vmap(route_len_m))(js))
    got = twrappers.route_length_m(_torch_world(js), tr).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert want.min() > 0.0


def test_benchmark_runs(tmp_path):
    """CARLABenchmark.run at a tiny size: a new Town02 env with the task's
    traffic and the test weathers, the rates in [0, 1], the budgets
    nocrash_success's of its route lengths."""
    env = stages.build_env(town="Town02", max_timesteps=48, num_routes=8, device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET), weights_dir=str(tmp_path))
    bench = twrappers.CARLABenchmark(agent, task="regular", preset="test")
    out = bench.run(timesteps=12, trials=4, initial_seed=5)
    benv = bench.last_env
    assert benv.params.town_names == ("Town02",)
    assert (benv.params.num_vehicles, benv.params.num_pedestrians) == (15, 50)
    assert out["trials"] == 4 and out["avg_timesteps"] <= 12
    for k in ("success_rate", "collision_rate", "timeout_rate"):
        assert 0.0 <= out[k] <= 1.0
    _, _, budget = twrappers.nocrash_success(0, False, False, np.array(out["route_length_m"]))
    np.testing.assert_allclose(out["budget_steps"], budget, rtol=1e-6)
    assert bench.run(timesteps=12, trials=4, initial_seed=5)["route_length_m"] == \
        out["route_length_m"], "the same seed drew other worlds"


# ---------------------------------------------------------------- Stage.run

@pytest.mark.parametrize("collect", [True, False, 2])
def test_stage_run_collect_count_matches_jax(collect):
    """Stage.run(3, collect): the collections and RL phases made, port and
    JAX, with the same collect kwargs; and none without them."""
    def counts(module, collect_args):
        stage = module.Stage(agent={}, environment={}, collect=collect_args,
                             learning=dict(agent=dict(episodes=1)))
        made = []
        stage.init = lambda: None
        stage.collect = lambda **kw: made.append("collect")
        stage.reinforcement_learning = lambda: made.append("rl")
        stage.run(3, collect=collect)
        return made

    for collect_args in (dict(num_envs=2), None):
        assert counts(stages, collect_args) == counts(jstages, collect_args)
    assert counts(stages, dict())[:2] == (["collect", "rl"] if collect else ["rl", "rl"])
    with pytest.raises(NotImplementedError):
        stages.Stage(agent={}, environment={}, learning=dict(agent={})).representation_learning()


# ---------------------------------------------------------------- structure

def test_collect_wrapper_traces(tmp_path):
    """CARLACollectWrapper: one trace per world's first episode, cut after
    its first done, in the JAX package's layout; the threshold drops
    episodes below timesteps * threshold."""
    env = stages.build_env(town="Town02", max_timesteps=10, num_routes=8, image_shape=(45, 60, 3),
                           spawn=dict(vehicles=5, pedestrians=5), device="cpu")
    before = env.generator.get_state()
    wrapper = twrappers.CARLACollectWrapper(env, traces_dir=str(tmp_path), name="t",
                                            behaviour="cautious", num_envs=3)
    assert wrapper.collect(episodes=3, timesteps=14) == 3
    assert torch.equal(env.generator.get_state(), before), "the env's stream moved"
    traces = list(ttraces.load_traces(str(tmp_path / "t")))
    assert len(traces) == 3
    keys = {"state_image", "state_road", "state_vehicle", "state_navigation", "action",
            "reward", "done", "speed", "similarity"}
    for tr in traces:
        assert set(tr) == keys
        n = len(tr["reward"])
        assert n <= 10 and tr["done"][-1] == 1.0 and tr["done"][:-1].sum() == 0.0
        assert tr["state_image"].dtype == np.uint8 and tr["state_image"].shape == (n, 4, 45, 180, 3)
        assert tr["state_road"].shape == (n, 4, 9) and tr["state_navigation"].shape == (n, 4, 5)
        assert tr["action"].shape == (n, 2) and np.abs(tr["action"]).max() <= 1.0
        for k in keys - {"state_image"}:
            assert tr[k].dtype == np.float32, k
    # the image is the observation truncated to u8
    obs = env.reset_batch(1)[1]["image"]
    assert torch.equal((obs * 255.0).to(torch.uint8), (obs * 255.0).floor().to(torch.uint8))
    # nothing reaches an impossible threshold; max(4, episodes) rounds
    strict = twrappers.CARLACollectWrapper(env, traces_dir=str(tmp_path), name="none",
                                           num_envs=2)
    assert strict.collect(episodes=1, timesteps=6, episode_reward_threshold=1e3) == 0
    with pytest.raises(ValueError):
        twrappers.CARLACollectWrapper(env, behaviour="reckless")


def test_agent_collect_traces_and_lazy_exports(tmp_path):
    env = stages.build_env(town="Town02", max_timesteps=48, num_routes=8, image_shape=(45, 60, 3),
                           device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, num_envs=4),
                      weights_dir=str(tmp_path))
    gens = env.generator.get_state(), agent.generator.get_state()
    assert agent.collect(episodes=3, timesteps=6, traces_dir=str(tmp_path / "n")) == 3
    assert torch.equal(env.generator.get_state(), gens[0])
    assert torch.equal(agent.generator.get_state(), gens[1])
    names = sorted(os.listdir(tmp_path / "n"))
    assert [n.split("-")[1] for n in names] == ["0", "1", "2"]
    for tr in ttraces.load_traces(str(tmp_path / "n")):
        assert {"log_prob", "value"} <= set(tr) and tr["action"].shape == (6, 2)
        assert tr["action"].min() > 0.0 and tr["action"].max() < 1.0
        assert tr["value"].shape == (6, 2) and np.isfinite(tr["log_prob"]).all()
    # a threshold above any episode's reward would collect forever: one
    # below every reward keeps all
    assert agent.collect(episodes=1, timesteps=4, record_threshold=-1e9,
                         traces_dir=str(tmp_path / "m")) == 1
    for name in ("CARLACollectWrapper", "CARLAPlayWrapper", "CARLABenchmark"):
        assert getattr(port, name) is getattr(twrappers, name)
    assert port.Stage is stages.Stage
    out = twrappers.CARLAPlayWrapper(env).play(timesteps=5, seed=2)
    assert out["timesteps"] == 5 and np.isfinite(out["total_reward"])


def test_record_episodes_and_cli_record(tmp_path, monkeypatch):
    """record_episodes writes frames (t, H, 3W, C) u8 and info.json with
    reward and timestep; `main --record` at a tiny size (stage s5's
    Town03 cut to Town02 and a tiny network, the agent a port checkpoint)
    writes its records under --record-dir and nothing under weights/."""
    env = stages.build_env(town="Town02", max_timesteps=40, num_routes=8, image_shape=(45, 60, 3),
                           device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET), name="tiny",
                      weights_dir=str(tmp_path / "w"))
    paths = twrappers.record_episodes(agent, "demo", timesteps=36, trials=2,
                                      record_dir=str(tmp_path / "rec"))
    assert paths == [str(tmp_path / "rec" / "Town02" / "demo" / str(i)) for i in (1, 2)]
    for p in paths:
        frames = np.load(os.path.join(p, "frames.npz"))["frames"]
        info = json.load(open(os.path.join(p, "info.json")))
        assert set(info) == {"reward", "timestep"} and frames.shape[0] == info["timestep"]
        assert frames.dtype == np.uint8 and frames.shape[1:] == (45, 180, 3)
        assert info["timestep"] > 32 or info["timestep"] == 36
    with pytest.raises(ValueError):
        twrappers.record_episodes(agent, "demo", 4, 1,
                                  record_dir=os.path.join(REPO_ROOT, "weights", "x"))
    agent.save()
    with open(tmp_path / "w" / "tiny" / "config.json") as f:
        assert json.load(f)["network"] == TINY_NET

    stage_s5 = stages.stage_s5

    def small_stage_s5(**kw):
        assert (kw["town"], kw["traffic"], kw["stage_name"]) == ("Town03", "regular", "tiny")
        kw.update(town="Town02", weights_dir=str(tmp_path / "w"),
                  env_overrides=dict(kw["env_overrides"], num_routes=8, image_shape=(45, 60, 3)))
        return stage_s5(**kw)

    monkeypatch.setattr(cli.stages, "stage_s5", small_stage_s5)
    monkeypatch.setattr(cli.stages, "network_spec", lambda w, d: TINY_NET)
    tracked = os.path.join(REPO_ROOT, "weights")
    listing = {d: os.listdir(os.path.join(tracked, d)) for d in os.listdir(tracked)}
    rc = cli.main(["--record", "--weights", "tiny", "--steps", "34", "--trials", "1",
                   "--device", "cpu", "--record-dir", str(tmp_path / "cli")])
    assert rc == 0
    frames = np.load(tmp_path / "cli" / "Town02" / "demo" / "1" / "frames.npz")["frames"]
    assert frames.shape[1:] == (45, 180, 3) and frames.shape[0] <= 34
    assert {d: os.listdir(os.path.join(tracked, d)) for d in os.listdir(tracked)} == listing
