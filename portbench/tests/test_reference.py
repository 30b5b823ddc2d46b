"""At a small size on the CPU, the plain reference (portbench/reference)
agrees with the port's unfused network and its update: the parameter
names and shapes, the inference forward of the shipped safe-s5 weights,
the weights made from a seed, and one policy step and one value step of
CARLAgent in float64, where only the order of sums separates them."""

import os

import pytest
import torch

from portbench.reference import checkpoint, network, ppo

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SAFE_S5 = os.path.join(ROOT, "weights", "safe-s5")


def _obs(b: int, gen: torch.Generator, dtype=torch.float32) -> dict:
    return dict(state_image=torch.rand(b, 4, 90, 360, 3, generator=gen, dtype=dtype),
                state_road=torch.randn(b, 4, 9, generator=gen, dtype=dtype),
                state_vehicle=torch.randn(b, 4, 4, generator=gen, dtype=dtype),
                state_navigation=torch.randn(b, 4, 5, generator=gen, dtype=dtype))


def _port_net(**kw):
    from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
    return CARLANetwork(num_actions=2, nav_dim=5, **kw)


def test_spec_is_the_port_state_dict():
    want = {k: tuple(v.shape) for k, v in _port_net().state_dict().items()}
    got = {name: shape for name, shape, _ in network.spec()}
    assert got == want


def test_safe_s5_read_as_the_port_reads_it():
    from carla_driving_rl_agent_torch.utils import checkpoint as port_ckpt
    want = port_ckpt.params_from_jax(
        port_ckpt.read_flax_msgpack(os.path.join(SAFE_S5, "params.msgpack")),
        port_ckpt.read_flax_msgpack(os.path.join(SAFE_S5, "batch_stats.msgpack")))
    got = checkpoint.load(SAFE_S5, "cpu")
    assert set(got) == set(want)
    for k in want:
        # a full restore makes the old policy a copy of the policy
        src = "policy." + k[len("old_policy."):] if k.startswith("old_policy.") else k
        assert torch.equal(got[k], want[src].to(torch.float32)), k


@pytest.mark.parametrize("fused", [False, True])
def test_predict_matches_port(fused):
    """The safe-s5 network's inference forward; 2e-5 relative is float32's
    rounding over the backbone (the two orders of summation)."""
    p = checkpoint.load(SAFE_S5, "cpu")
    net = _port_net(control_policy={"preact_floor": -3.0}, fused_units=fused)
    net.load_state_dict(p)
    net.update_old_policy()
    obs = _obs(3, torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net.predict(obs, torch.Generator().manual_seed(1))
        ref = network.predict(p, obs, preact_floor=-3.0)
    for k in ("mean", "std", "value"):
        gap = float((out[k] - ref[k]).abs().max() / ref[k].abs().max())
        assert gap < 1e-4, (k, gap)


def test_seeded_weights_load_into_the_port():
    gen = torch.Generator().manual_seed(7)
    p0 = network.init_weights(network.spec(), gen, "cpu")
    net = _port_net()
    net.load_state_dict(p0, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, p0[k]), k
    again = network.init_weights(network.spec(), torch.Generator().manual_seed(7), "cpu")
    assert all(torch.equal(again[k], p0[k]) for k in p0)


@pytest.fixture(scope="module")
def agent64():
    """A CARLAgent on two Town02 worlds whose network is held in float64."""
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
    from carla_driving_rl_agent_torch.curriculum import stages
    env = stages.build_env(town="Town02", seed=42, device="cpu")
    agent = CARLAgent(env, CARLAgentConfig(num_envs=2, batch_size=4), log_mode=None,
                      weights_dir=os.path.join(ROOT, "build", "portbench", "test"))
    p0 = network.init_weights(network.spec(), torch.Generator().manual_seed(3), "cpu")
    agent.network.load_state_dict(p0)
    agent.network.double()
    return agent, {k: v.double() for k, v in p0.items()}


def _batch(gen: torch.Generator, n: int = 4) -> dict:
    d = torch.float64
    obs = _obs(n, gen, d)
    obs["state_image"][:, :2] = 0.0          # the stacks' zero frames of a fresh episode
    obs["action"] = torch.rand(n, 2, generator=gen, dtype=d)
    return dict(obs=obs, advantages=torch.randn(n, generator=gen, dtype=d),
                returns=torch.rand(n, 2, generator=gen, dtype=d),
                log_prob=-torch.rand(n, 2, generator=gen, dtype=d),
                speed=torch.rand(n, generator=gen, dtype=d),
                similarity=torch.rand(n, generator=gen, dtype=d))


def test_update_matches_port(agent64):
    """A policy step then a value step, in float64: each loss, the first
    step's clipped gradients as Adam got them (per leaf, by the benchmark's
    worst-leaf measure), and every leaf's change after both steps, over the
    leaves whose reference gradient reaches a thousandth of the median
    leaf's (a conv bias under a BatchNorm has a gradient of rounding noise,
    1e-14 here, which Adam's first step turns into a full step of either
    sign).  1e-8: the orders of summation in float64."""
    from portbench import common
    agent, p0 = agent64
    hyper = dict(clip_ratio=0.2, entropy=0.1, adv_scale=2.0)
    gen = torch.Generator().manual_seed(5)
    b1, b2 = _batch(gen), _batch(gen)
    names = {id(p): k for k, p in agent.network.named_parameters()}
    learner = ppo.Learner(p0)
    l1 = float(agent.policy_step(b1, hyper)["loss_total"])
    assert l1 == pytest.approx(learner.step("policy", b1, hyper), rel=1e-8)
    norm = lambda t: float(torch.linalg.vector_norm(t))  # noqa: E731
    got = {names[id(p)]: norm(agent.optimizers[g].state[p]["exp_avg"] / 0.1)
           for g in ("policy", "dynamics") for p in agent.params[g]}
    assert common.worst_leaf(got, {k: norm(v) for k, v in learner.grads[0].items()})[0] < 1e-8
    l2 = float(agent.value_step(b2)["loss_value"])
    assert l2 == pytest.approx(learner.step("value", b2, hyper), rel=1e-8)
    moved = {}
    for grads in learner.grads:
        for k, v in grads.items():
            moved[k] = max(moved.get(k, 0.0), norm(v))
    median = sorted(moved.values())[len(moved) // 2]
    keep = [k for k, v in moved.items() if v >= 1e-3 * median]
    params = dict(agent.network.named_parameters())
    d_got = {k: norm(params[k].detach() - p0[k]) for k in keep}
    d_ref = {k: norm(learner.p[k] - p0[k]) for k in keep}
    assert common.worst_leaf(d_got, d_ref)[0] < 1e-8
