"""Data parallelism over worlds (parallel/mesh.py) on the CPU: two gloo
ranks, spawned with torch.multiprocessing, train stage s1's block rollout
(the physics kernel's plain version) on 4 Town02 worlds with a TINY
network for one update, against the same update in one process from the
same seed, the network in float64 on both sides (the world stays float32):

  * each rank's worlds equal its rows of the one-process rollout: the
    world's fields, frames included, exactly; the network's outputs
    (samples, log-probs, values) within 1e-9 relative, since a rank's
    forward pass over its 2 worlds rounds otherwise than one over all 4;
  * the parameters and buffers after the update equal the one-process
    run's within 1e-6 relative per tensor (the update runs on every rank
    over the same gathered minibatches), but for the tensors whose
    gradient is rounding noise, held as tests/torch_learner_common.py
    holds them, to 2 learning rates per step, and the BatchNorms' running
    statistics downstream of them, to 1e-5 as there.  In float32 that rounding of the
    rollout's values (~1e-8) moves the backbone's noise-level gradients,
    which Adam's first, normalised step turns into moves of up to the
    learning rate (the conv biases that a training-mode BatchNorm
    follows: their true gradient is 0), so the comparison runs in
    float64, from biases drawn away from 0 (see _agent);
  * the ranks held equal tensors after the update (replica drift 0);
  * the 2-D layout (2 nodes x 1 local rank, the JAX package's (slice,
    world) mesh) gives the 1-D layout's shards and the same parameters,
    bit for bit;
  * the evaluation rollout's accumulators over the mesh equal the
    one-process rollout's.
"""

import numpy as np
import pytest
import torch

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.parallel import mesh as mesh_mod
from torch_learner_common import TINY_NET, WORLD, one_thread  # noqa: F401

B = 4
LR = 3e-4       # CARLAgentConfig's learning rates
# the rollout's network outputs, which a rank computes over its own worlds
NET_FIELDS = ("action", "log_prob", "value")
CFG = dict(network=TINY_NET, num_envs=B, rollout_steps=8, batch_size=16, rollout_block=True,
           seed=3)


def _agent(device, mesh=None):
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**WORLD), image_height=45,
                                  image_width=60, fused_step=True), device=device)
    agent = CARLAgent(env, CARLAgentConfig(**CFG), weights_dir="unused", mesh=mesh,
                      log_mode=None)
    agent.network.double()
    with torch.no_grad():
        # biases away from 0: at flax's zero init, a relu6 unit fed the
        # zero-padded stacks of a fresh episode sits exactly on its kink,
        # and a rounding-level gradient (0 in one process, 1e-16 over two)
        # decides whether Adam's first step wakes it
        gen = torch.Generator().manual_seed(11)
        for name, p in agent.network.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=gen, dtype=p.dtype) * 1e-2)
    agent.network.update_old_policy()
    seen = []
    rollout = agent._rollout

    def recording(states):
        out = rollout(states)
        seen.append(out[1])
        return out
    agent._rollout = recording
    return agent, seen


def _train(mesh, town, nodes):
    """One update (and an evaluation rollout) on this rank's worlds; with
    `nodes`, the same again under the 2-D layout of the same ranks."""
    torch.set_num_threads(1)
    ttown._TOWN_CACHE.setdefault("Town02", town)
    out = {}
    for name, m in (("1d", mesh), ("2d", None if nodes is None else mesh_mod.init_mesh(
            mesh.rank, mesh.world_size, "gloo", "", device="cpu", nodes=nodes))):
        if m is None:
            continue
        agent, seen = _agent("cpu", m)
        _, hist = agent.learn(1)
        acc = agent.rollout(6, 8)
        out[name] = dict(state=agent.network.state_dict(), traj=seen[0]._asdict(),
                         drift=hist[0]["replica_drift"], shard=m.shard(B), axes=m.axes,
                         acc=acc)
    return out


def _noise_steps(agent) -> dict:
    """{name: the steps in which the tensor's gradient was rounding noise
    (max |g| below 1e-9 of the step's largest entry)}, filled as the
    agent learns: the conv biases that a training-mode BatchNorm follows,
    whose true gradient is 0 (tests/torch_learner_common.py)."""
    names = {id(p): n for n, p in agent.network.named_parameters()}
    steps = {}
    apply = agent._apply

    def recording(group, grads, clip_norm, opt=None):
        top = max(float(g.abs().max()) for g in grads)
        for p, g in zip(agent.params[group], grads):
            if float(g.abs().max()) < 1e-9 * top:
                steps[names[id(p)]] = steps.get(names[id(p)], 0) + 1
        return apply(group, grads, clip_norm, opt)
    agent._apply = recording
    return steps


@pytest.fixture(scope="module")
def runs():
    single, seen = _agent("cpu")
    noise = _noise_steps(single)
    single.learn(1)
    acc = single.rollout(6, 8)
    ranks = mesh_mod.spawn_ranks(_train, 2, "gloo", args=(ttown.get_town("Town02"), 2),
                                 device="cpu")
    return (single.network.state_dict(), seen[0]._asdict(), acc, noise), ranks


def test_each_rank_steps_its_rows_of_the_rollout(runs):
    (_, traj, _, _), ranks = runs
    for r, out in enumerate(ranks):
        lo, hi = out["1d"]["shard"]
        assert (lo, hi) == (r * B // 2, (r + 1) * B // 2)
        for k, v in out["1d"]["traj"].items():
            want = traj[k][:, lo:hi]
            if k in NET_FIELDS:
                np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=1e-9, atol=1e-12,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(v.numpy(), want.numpy(), err_msg=k)


def test_parameters_equal_the_one_process_run(runs):
    (state, _, _, noise), ranks = runs
    assert noise, "no noise-level gradient seen: the exception below is stale"
    for out in ranks:
        assert out["1d"]["drift"] == 0.0
        for k, v in state.items():
            # a noise-level gradient is Adam's normalised step of up to
            # the learning rate in any direction: 2 learning rates per step
            # (the running statistics see those biases: 1e-5, as there)
            atol = (2 * LR * noise[k] if k in noise else
                    1e-5 if "running" in k else 1e-6 * float(v.abs().max()))
            np.testing.assert_allclose(out["1d"]["state"][k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=atol, err_msg=k)


def test_two_d_layout_equals_one_d(runs):
    _, ranks = runs
    for out in ranks:
        assert out["2d"]["axes"] == (2, 1) and out["1d"]["axes"] == (2,)
        assert out["2d"]["shard"] == out["1d"]["shard"]
        for k, v in out["1d"]["state"].items():
            assert torch.equal(out["2d"]["state"][k], v), k
    m1 = mesh_mod.WorldMesh(1, 4, "gloo", torch.device("cpu"), axes=(4,))
    m2 = mesh_mod.WorldMesh(1, 4, "gloo", torch.device("cpu"), axes=(2, 2),
                            axis_names=(mesh_mod.SLICE_AXIS, mesh_mod.WORLD_AXIS))
    for n in (4, 6, 32, 33):
        assert m1.shard(n) == m2.shard(n)


def test_evaluation_rollout_over_the_mesh(runs):
    (_, _, acc, _), ranks = runs
    for out in ranks:
        for k, v in acc.items():
            np.testing.assert_allclose(out["1d"]["acc"][k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_backend_is_explicit():
    with pytest.raises(ValueError):
        mesh_mod.init_mesh(0, 1, "auto", "tcp://localhost:1")
