"""Shared parts of the learner tests (tests/test_torch_learner.py,
test_torch_learner_steps.py and test_torch_learner_train.py), which hold
the port's learner against the JAX package on the CPU.  pytest does not
collect this module (its name does not start with test_); a test module
imports the fixtures it uses, `one_thread` included.

The port's learner against the JAX package on the CPU, at
tests/test_agent.py's TINY_NET widths on 45x180 frames, both sides starting
from the same parameters (the JAX network's own init, converted by
utils/checkpoint.params_from_jax):

  * training-mode BatchNorm outputs and folded running statistics against
    flax's nn.BatchNorm;
  * the policy and value objectives' terms on a fixed batch;
  * each phase's gradients against jax.grad;
  * one policy-phase and one value-phase step on injected minibatches
    (the samples an injected permutation picks): every parameter and
    running statistic afterwards, against the JAX learner's step
    (carla_agent.py:711-785) composed from the JAX package's functions;
  * a CPU learn() of 2 updates on Town02, save/load, and stage_s1.run2;
  * the same two steps with fused_units=True (the backbone's stride-1
    units through the fused op, whose plain version runs on the CPU), and
    the CLI's --fused-units.

Tolerances: BatchNorm and the objective terms (float32, the heads fed the
same dynamics feature) 1e-5: float32 in another summation order.  The
gradient and update comparisons run both sides in float64 (JAX under
jax.enable_x64 with compute_dtype float64, the port's network in double):
in float32 the JAX reference's own BatchNorm statistics carry ~1e-4
relative error at the stem (XLA's CPU sums over 62,656 values, measured
against float64), which the backbone's 16 training-mode BatchNorms amplify
to ~5 % in some of its gradients, more than any bar that would still catch
a fault.  In float64 the gradients must agree to 1e-4 relative per tensor,
with an absolute floor of 1e-6 of the phase's largest entry: the JAX
network casts the dynamics feature to float32 (carla_network.py:77), so its
backbone gradients carry float32 rounding.  Every parameter and running
statistic after the two steps must agree to 1e-4 relative + 1e-7 absolute,
except the tensors whose true gradient is zero (biases that a
training-mode BatchNorm follows, through linear layers only): their
gradients are rounding noise (below 1e-6 of the phase's largest entry),
which Adam's normalised step turns into a move of up to the learning rate,
so they are held to 2 learning rates per step they took; the running
statistics of the value phase, whose forward pass sees those biases after
the policy step, take a hundredth of their shift and are held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgent as JAgent
from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgentConfig as JConfig
from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
from carla_driving_rl_agent_tpu.utils import math as jm
from carla_driving_rl_agent_tpu.utils.optimizers import get_optimizer_by_name as jopt

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread for a module, its module fixtures included:
    beside the suite's other workers, intra-op threads of small operations
    spend most of their time waiting for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY_NET = dict(
    control_policy=dict(units=32, num_layers=1),
    control_value=dict(units=32, num_layers=1),
    dynamics=dict(
        shufflenet=dict(g=0.5, last_channels=64),
        rnn=dict(image=32, road=8, vehicle=8, navigation=8),
        dynamics=dict(units=64),
        road=dict(units=8, num_layers=1, activation="relu6"),
        vehicle=dict(units=8, num_layers=1, activation="relu6"),
        navigation=dict(units=8, num_layers=1, activation="relu6"),
    ),
)
MB, T, H, W = 8, 4, 45, 180
LR = 3e-4
HYPER = dict(clip_ratio=0.2, entropy=0.1, adv_scale=2.0)
WORLD = dict(town_names=("Town02",), num_routes=8, max_timesteps=12)


@pytest.fixture(scope="module")
def jnet_init():
    jnet = JNet(**TINY_NET)
    sample = dict(state_image=jnp.zeros((1, T, H, W, 3)), state_road=jnp.zeros((1, T, 9)),
                  state_vehicle=jnp.zeros((1, T, 4)), state_navigation=jnp.zeros((1, T, 5)),
                  action=jnp.zeros((1, 2)))
    params, stats = jax.jit(jnet.init)(jax.random.PRNGKey(0), sample)
    return jnet, params, stats


@pytest.fixture(scope="module")
def env():
    return CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**WORLD), image_height=45,
                                   image_width=60, fused_step=True), device="cpu")


def _agent(env, jnet_init, tmp=None, **cfg):
    _, params, stats = jnet_init
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, **cfg), name="t",
                      weights_dir=str(tmp) if tmp else "unused", log_mode=None)
    agent.network.load_state_dict(params_from_jax(params, stats), strict=True)
    return agent


def _batch(seed):
    rng = np.random.default_rng(seed)
    action = rng.uniform(0.05, 0.95, (MB, 2)).astype(np.float32)
    obs = dict(state_image=rng.uniform(0, 1, (MB, T, H, W, 3)).astype(np.float32),
               state_road=rng.uniform(0, 1, (MB, T, 9)).astype(np.float32),
               state_vehicle=rng.uniform(0, 1, (MB, T, 4)).astype(np.float32),
               state_navigation=rng.uniform(0, 3, (MB, T, 5)).astype(np.float32),
               action=action)
    returns = np.stack([rng.uniform(-1, 1, MB), rng.integers(0, 4, MB)], -1)
    b = dict(obs=obs, advantages=rng.normal(0, 1, MB).astype(np.float32),
             returns=returns.astype(np.float32),
             log_prob=(np.log(action) - 0.3 + rng.normal(0, 0.1, (MB, 2))).astype(np.float32),
             speed=rng.uniform(0, 0.5, MB).astype(np.float32),
             similarity=rng.uniform(0.5, 1, MB).astype(np.float32))
    to_j = lambda t: {k: to_j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    return to_j(b), to_t(b)


def _jself(jnet):
    """A JAX CARLAgent with only the network and config its objectives read
    (no env, no jitted programs)."""
    js = object.__new__(JAgent)
    js.network, js.config = jnet, JConfig(network=TINY_NET)
    return js


def _as_torch(params, stats, group_trees):
    """The port's tensors for JAX trees: `group_trees` replaces components
    of `params` (e.g. with gradients) before the conversion."""
    p = dict(params, **group_trees)
    if "policy" in group_trees:
        p["old_policy"] = group_trees["policy"]
    return params_from_jax(p, stats)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


_JNET64 = []


def _x64(env, jnet_init, **cfg):
    """The JAX network computing in float64 with float64 parameters, and a
    port agent holding the same parameters in double.  Call inside
    jax.enable_x64(True).  The JAX network is one object for the module,
    so that its compiled gradients (_jax_grads) serve every test."""
    _, params, stats = jnet_init
    if not _JNET64:
        _JNET64.append(JNet(**TINY_NET, compute_dtype=jnp.float64))
    jnet = _JNET64[0]
    agent = _agent(env, jnet_init, **cfg)
    agent.network.double()
    return jnet, _f64(params), _f64(stats), agent


def _noise_tensors(params, stats, grads):
    """{name: 1} for the port's tensors of a phase whose JAX gradient is
    rounding noise (max |g| below 1e-6 of the phase's largest entry)."""
    sd = _as_torch(params, stats, grads)
    names = [n for n in sd if n.split(".")[0] in grads and "running" not in n]
    top = max(float(sd[n].abs().max()) for n in names)
    return {n: 1 for n in names if float(sd[n].abs().max()) < 1e-6 * top}


def _batch64(seed):
    jb, tb = _batch(seed)
    return (_f64(jb), jax.tree_util.tree_map(lambda t: t.double(), tb))


_GRAD_FNS = {}


def _jax_grads(jnet, params, stats, jb, phase):
    """(loss, aux, grads) of the JAX learner's phase loss (carla_agent.py
    _policy_loss / _value_loss) w.r.t. the phase's head and the dynamics;
    compiled once per phase and network for the module."""
    key = (phase, id(jnet))
    if key not in _GRAD_FNS:
        js = _jself(jnet)

        def loss(pd, stats, jb):
            if phase == "policy":
                return js._policy_loss(pd["policy"], pd["dynamics"], stats, jb, HYPER,
                                       jax.random.PRNGKey(0))
            return js._value_loss(pd["value"], pd["dynamics"], stats, jb)

        _GRAD_FNS[key] = (jnet, jax.jit(jax.value_and_grad(loss, has_aux=True)))
    (value, aux), g = _GRAD_FNS[key][1](
        {phase: params[phase], "dynamics": params["dynamics"]}, stats, jb)
    return value, aux, g


@pytest.fixture(scope="module")
def jax_steps(env, jnet_init):
    """The JAX learner's policy_minibatch then value_minibatch
    (carla_agent.py:711-785), composed from its own functions, once for
    the module: the tensors after the two steps, the tensors whose
    gradient is rounding noise in each phase, and the policy before."""
    with jax.enable_x64(True):
        jnet, params, stats, _ = _x64(env, jnet_init)
        jb_p, _ = _batch64(3)
        jb_v, _ = _batch64(4)
        opts = {g: jopt("adam", LR) for g in ("policy", "value", "dynamics")}
        opt_state = {g: opts[g].init(params[g]) for g in opts}
        # each group's clipped Adam step, compiled (eagerly it compiles one
        # program per operation)
        adam = {grp: jax.jit(lambda g, st, p, grp=grp: (
            lambda up: (optax.apply_updates(p, up[0]), up[1]))(
                opts[grp].update(jm.clip_gradients(g, 1.0), st, p))) for grp in opts}
        _, paux, g = _jax_grads(jnet, params, stats, jb_p, "policy")
        noise = _noise_tensors(params, stats, g)
        new = dict(params, old_policy=params["policy"])
        for grp in ("policy", "dynamics"):
            new[grp], opt_state[grp] = adam[grp](g[grp], opt_state[grp], params[grp])
        stats1 = dict(stats, dynamics=paux["d_stats"], policy=paux["p_stats"])
        _, vaux, g = _jax_grads(jnet, new, stats1, jb_v, "value")
        noise_v = _noise_tensors(params, stats, g)
        new2 = dict(new)
        for grp in ("value", "dynamics"):
            new2[grp], opt_state[grp] = adam[grp](g[grp], opt_state[grp], new[grp])
        stats2 = dict(stats1, dynamics=vaux["d_stats"], value=vaux["v_stats"])
        return params_from_jax(new2, stats2), noise, noise_v, _as_torch(params, stats, {})


def _steps_match_jax(env, jnet_init, jax_steps, **cfg):
    ref, noise, noise_v, pol0 = jax_steps
    with jax.enable_x64(True):
        _, _, _, agent = _x64(env, jnet_init, **cfg)
        _, tb_p = _batch64(3)
        _, tb_v = _batch64(4)
    agent.policy_step(tb_p, HYPER)
    agent.value_step(tb_v)
    sd = agent.network.state_dict()
    assert set(sd) == set(ref)
    for name, v in sd.items():
        steps = noise.get(name, 0) + noise_v.get(name, 0)
        atol = 2 * LR * steps if steps else (1e-5 if "running" in name else 1e-7)
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=1e-4, atol=atol,
                                   err_msg=name)
    # old_policy holds the policy from before the step
    for name in sd:
        if name.startswith("old_policy.") and "running" not in name:
            assert torch.equal(sd[name], pol0[name.replace("old_policy.", "policy.", 1)])
