"""The port's learner variants against the JAX package on the CPU, at
tests/test_torch_learner.py's TINY_NET widths and with its harness:

  * one minibatch step of fused_update, two_step_update and
    two_step_split_adam (and two_step_update with fused_units, the units'
    plain versions on the CPU) from the same parameters and Adam states,
    against the JAX learner's step (carla_agent.py:510-682) composed from
    its own functions, in float64: every parameter, running statistic and
    Adam moment afterwards, at test_torch_learner.py's bars (1e-4 relative;
    the tensors whose gradient is rounding noise held to 2 learning rates
    per step they took, their moments to 1e-6 of the group's largest).
The JAX references are compiled once for the module: one float64 program
of the shared forward pulled back for each objective, which gives the
fused, two-step and split steps' gradients alike (its compile is most of
the file's time).  The learner's other options: test_torch_learner_options.py
and test_torch_learner_loop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_driving_rl_agent_tpu.utils import math as jm
from carla_driving_rl_agent_tpu.utils.optimizers import get_optimizer_by_name as jopt

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnvConfig
from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.models.layers import init_flax_
from test_torch_imitation import jax_trees
from test_torch_learner import (HYPER, LR, TINY_NET, WORLD, _as_torch, _batch64, _jself,
                                _noise_tensors)


class NoTownEnv:
    """What CARLAgent reads of an env to build itself (the config, the
    world parameters, the device, the seed): the steps under test run no
    rollout, so no town is built."""

    def __init__(self):
        self.config = CARLAEnvConfig(world=tworld.WorldParams(**WORLD), image_height=45,
                                     image_width=60)
        self.params = self.config.world
        self.device = torch.device("cpu")

    def seed(self, seed: int) -> None:
        pass


@pytest.fixture(scope="module")
def env():
    return NoTownEnv()


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    """One PyTorch thread for the module, its module fixtures included
    (test_torch_curriculum.py's one_thread, at module scope): beside the
    suite's other workers, intra-op threads of small operations spend most
    of their time waiting for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net64():
    """A seeded port network in float64 (flax's initialisers, no JAX init
    compile) and its JAX trees: (net, JAX network in float64, params,
    stats)."""
    net = CARLANetwork(**TINY_NET)
    init_flax_(net, torch.Generator().manual_seed(7))
    net.update_old_policy()
    net.double()
    with jax.enable_x64(True):
        return (net,) + jax_trees(net, jnp.float64)


def _agent64(env, net64, **cfg):
    """A port agent holding net64's parameters, in float64."""
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, **cfg), weights_dir="unused")
    agent.network.double()
    agent.network.load_state_dict(net64[0].state_dict(), strict=True)
    return agent


@pytest.fixture(scope="module")
def jax_joint(net64):
    """The JAX learner's shared forward of one minibatch (its fused and
    two-step minibatch functions, carla_agent.py:517-530, 608-628) in
    float64, pulled back once per objective: (params, stats,
    policy-objective gradients, value-objective gradients, new stats)."""
    with jax.enable_x64(True):
        _, jnet, params, stats = net64
        jb, _ = _batch64(5)
        js = _jself(jnet)

        @jax.jit
        def joint(params, stats, batch):
            def fwd(pvd):
                feat, d_stats = jnet.dynamics_apply(pvd, stats, batch["obs"], training=True)
                p_total, p_aux = js._policy_objective(pvd, stats, feat, batch, HYPER,
                                                      jax.random.PRNGKey(0))
                v_total, v_aux = js._value_objective(pvd, stats, feat, batch)
                return (p_total, v_total), (d_stats, p_aux["p_stats"], v_aux["v_stats"])

            pvd = {g: params[g] for g in ("policy", "value", "dynamics")}
            _, pullback, (d_stats, p_stats, v_stats) = jax.vjp(fwd, pvd, has_aux=True)
            one, zero = jnp.ones(()), jnp.zeros(())
            return (pullback((one, zero))[0], pullback((zero, one))[0],
                    dict(stats, dynamics=d_stats, policy=p_stats, value=v_stats))

        g_p, g_v, new_stats = joint(params, stats, jb)
        return params, stats, g_p, g_v, new_stats


@pytest.fixture(scope="module")
def jax_variants(jax_joint):
    """The JAX steps of the three schemes from the joint gradients
    (carla_agent.py:537-564, 630-677): {scheme: (the parameters afterwards,
    {group: [(mu, nu) trees of each Adam state]})}.  Each group's gradient
    is clipped per tensor as the learner clips it, then optax's Adam runs on
    the group raveled into one vector (Adam is elementwise, so the numbers
    are the per-leaf ones; one small program per group instead of one per
    leaf)."""
    params, _, g_p, g_v, _ = jax_joint
    from jax.flatten_util import ravel_pytree
    with jax.enable_x64(True):
        opt = jopt("adam", LR)
        clip = jax.jit(lambda g: jm.clip_gradients(g, 1.0))     # every group at once

        @jax.jit
        def adam(g, st, p):
            up, st = opt.update(g, st, p)
            return optax.apply_updates(p, up), st

        def step(group, g, st, p):
            flat_p, unravel = ravel_pytree(p)
            new, st = adam(ravel_pytree(g)[0], st, flat_p)
            return unravel(new), st, unravel

        def moments(st, unravel):
            inner = st.inner_state[0]
            return unravel(inner.mu), unravel(inner.nu)

        fresh = {g: opt.init(ravel_pytree(params[g])[0]) for g in ("policy", "value", "dynamics")}
        summed = jax.tree_util.tree_map(lambda a, b: a + b, g_p, g_v)
        c_p, c_v, c_sum = clip(g_p), clip(g_v), clip(summed)
        out = {}
        for scheme in ("fused_update", "two_step_update", "two_step_split_adam"):
            gp, gv = c_p, c_v
            if scheme == "fused_update":       # one step on the summed gradients
                gp = gv = c_sum
            new = dict(params, old_policy=params["policy"])
            new["policy"], st_p, un_p = step("policy", gp["policy"], fresh["policy"],
                                             params["policy"])
            new["value"], st_v, un_v = step("value", gv["value"], fresh["value"],
                                            params["value"])
            dyn, st_d = params["dynamics"], fresh["dynamics"]
            if scheme == "fused_update":
                new["dynamics"], st, un_d = step("dynamics", gp["dynamics"], st_d, dyn)
                dstates = [st]
            elif scheme == "two_step_update":
                d1, st, un_d = step("dynamics", gp["dynamics"], st_d, dyn)
                new["dynamics"], st, _ = step("dynamics", gv["dynamics"], st, d1)
                dstates = [st]
            else:
                d1, st1, un_d = step("dynamics", gp["dynamics"], st_d, dyn)
                new["dynamics"], st2, _ = step("dynamics", gv["dynamics"], st_d, d1)
                dstates = [st1, st2]
            out[scheme] = (new, dict(policy=[moments(st_p, un_p)], value=[moments(st_v, un_v)],
                                     dynamics=[moments(st, un_d) for st in dstates]))
        return out


def _moments(params, stats, states, group):
    """[(mu, nu) as the port's {name: tensor}] of each Adam state of a
    group."""
    return [tuple({k: v for k, v in _as_torch(params, stats, {group: m}).items()
                   if k.startswith(group + ".")} for m in st) for st in states[group]]


@pytest.mark.parametrize("scheme,fused_units", [("fused_update", False),
                                                ("two_step_update", False),
                                                ("two_step_split_adam", False),
                                                ("two_step_update", True)])
def test_update_variant_step_matches_jax(env, net64, jax_joint, jax_variants, scheme,
                                        fused_units):
    params, stats, g_p, g_v, new_stats = jax_joint
    new, states = jax_variants[scheme]
    with jax.enable_x64(True):
        ref = _as_torch(new, new_stats, {})
        # the tensors whose gradient is rounding noise, per pull-back
        noise = _noise_tensors(params, stats, {k: g_p[k] for k in ("policy", "dynamics")})
        for name, n in _noise_tensors(params, stats,
                                      {k: g_v[k] for k in ("value", "dynamics")}).items():
            noise[name] = noise.get(name, 0) + n
        _, tb = _batch64(5)
    agent = _agent64(env, net64, fused_units=fused_units, **{scheme: True})
    pol0 = {k: v.clone() for k, v in agent.network.state_dict().items()
            if k.startswith("policy.") and "running" not in k}
    step = agent.fused_step if scheme == "fused_update" else agent.two_step
    step(tb, HYPER)
    sd = agent.network.state_dict()
    assert set(sd) == set(ref)
    for name, v in sd.items():
        steps = noise.get(name, 0) if scheme != "fused_update" else min(noise.get(name, 0), 1)
        atol = 2 * LR * steps if steps else (1e-5 if "running" in name else 1e-7)
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)
    for name, v in pol0.items():
        assert torch.equal(sd["old_" + name], v), name
    names = {id(p): n for n, p in agent.network.named_parameters()}
    for group in ("policy", "value", "dynamics"):
        opts = agent.optimizers[group]
        opts = opts if isinstance(opts, tuple) else (opts,)
        refs = _moments(new, new_stats, states, group)
        assert len(opts) == len(refs), group
        for opt, (mu, nu) in zip(opts, refs):
            tops = [max(float(t.abs().max()) for t in m.values()) for m in (mu, nu)]
            for p in agent.params[group]:
                st, n = opt.state[p], names[id(p)]
                for got, want, top in ((st["exp_avg"], mu[n], tops[0]),
                                       (st["exp_avg_sq"], nu[n], tops[1])):
                    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                               atol=1e-6 * top, err_msg=f"{group} {n}")
