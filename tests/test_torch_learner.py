"""The port's learner against the JAX package on the CPU, at
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
import pytest
import torch
import flax.linen as fnn

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.models.layers import BatchNorm
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax

from torch_learner_common import (  # noqa: F401  (re-exported to other test modules)
    H, HYPER, LR, MB, T, TINY_NET, W, WORLD, _agent, _as_torch, _batch, _batch64, _f64,
    _jax_grads, _jself, _noise_tensors, _x64, env, jnet_init, one_thread)


@pytest.mark.parametrize("shape,axis", [((6, 4, 16), -1), ((6, 5, 7, 12), 1)])
def test_batchnorm_train_mode_matches_flax(rng, shape, axis):
    c = shape[axis]
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    scale, bias = rng.normal(1, 0.2, c).astype(np.float32), rng.normal(0, 0.2, c).astype(np.float32)
    mean0, var0 = rng.normal(0, 1, c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    jx = np.moveaxis(x, 1, -1) if axis == 1 else x          # flax: channels last
    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-3, momentum=0.99)
    y, upd = bn.apply({"params": dict(scale=scale, bias=bias),
                       "batch_stats": dict(mean=mean0, var=var0)},
                      jnp.asarray(jx), mutable=["batch_stats"])
    m = BatchNorm(c, channel_axis=axis).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    out = m(torch.from_numpy(x)).detach().numpy()
    out = np.moveaxis(out, 1, -1) if axis == 1 else out
    np.testing.assert_allclose(out, np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-5)


def test_params_from_jax_init_round_trip(env, jnet_init):
    """JAX init trees -> the port's state_dict -> the same eval forward."""
    jnet, params, stats = jnet_init
    agent = _agent(env, jnet_init)
    sd = agent.network.state_dict()
    conv = params_from_jax(params, stats)
    assert set(conv) == set(sd)
    for k, v in conv.items():
        assert torch.equal(sd[k], v), k
    jb, tb = _batch(0)

    @jax.jit        # one compiled program instead of an eager compile per operation
    def forward(params, stats, obs):
        feat, _ = jnet.dynamics_apply(params, stats, obs)
        jpol, _ = jnet.policy_apply(params, stats, feat, old=True)
        jval, _ = jnet.value_apply(params, stats, feat)
        return feat, jpol["dist"].alpha, jval["value"]

    feat, alpha, value = forward(params, stats, jb["obs"])
    with torch.no_grad():
        tfeat = agent.network.dynamics_apply(tb["obs"])
        tpol = agent.network.policy_apply(tfeat, old=True)
        tval = agent.network.value_apply(tfeat)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(feat), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpol["dist"].alpha.numpy(), np.asarray(alpha), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tval["value"].numpy(), np.asarray(value), rtol=0, atol=1e-5)


def test_objectives_match_jax(env, jnet_init):
    """The objectives on a fixed batch, the heads in training mode fed the
    same dynamics feature (the JAX one)."""
    jnet, params, stats = jnet_init
    agent = _agent(env, jnet_init)
    jb, tb = _batch(1)
    js = _jself(jnet)

    @jax.jit        # one compiled program instead of an eager compile per operation
    def objectives(params, stats, jb):
        feat, _ = jnet.dynamics_apply(params, stats, jb["obs"], training=True)
        return (feat, js._policy_objective(params, stats, feat, jb, HYPER,
                                           jax.random.PRNGKey(0)),
                js._value_objective(params, stats, feat, jb))

    feat, (jtot, jaux), (jvtot, jvaux) = objectives(params, stats, jb)
    net = agent.network
    tfeat = torch.from_numpy(np.array(feat))
    ttot, taux = agent._policy_objective(net.policy_apply(tfeat, training=True), tb, HYPER)
    tvtot, tvaux = agent._value_objective(net.value_apply(tfeat, training=True), tb)
    for t, j in ((ttot, jtot), (tvtot, jvtot), (taux["loss_policy"], jaux["loss_policy"]),
                 (taux["entropy"], jaux["entropy"]), (taux["ratio"], jaux["ratio"]),
                 (taux["kl"], jaux["kl"]), (tvaux["loss_value"], jvaux["loss_value"])):
        np.testing.assert_allclose(float(t.detach()), float(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("phase", ["policy", "value"])
def test_phase_gradients_match_jax(env, jnet_init, phase):
    with jax.enable_x64(True):
        jnet, params, stats, agent = _x64(env, jnet_init)
        jb, tb = _batch64(2)
        _, _, jg = _jax_grads(jnet, params, stats, jb, phase)
        ref = _as_torch(params, stats, jg)
    net = agent.network
    feat = net.dynamics_apply(tb["obs"], training=True)
    if phase == "policy":
        loss, _ = agent._policy_objective(net.policy_apply(feat, training=True), tb, HYPER)
    else:
        loss, _ = agent._value_objective(net.value_apply(feat, training=True), tb)
    grads = agent._grads(loss, (phase, "dynamics"))
    names = {id(p): n for n, p in net.named_parameters()}
    pairs = [(names[id(p)], g) for grp in (phase, "dynamics")
             for p, g in zip(agent.params[grp], grads[grp])]
    floor = 1e-6 * max(float(g.abs().max()) for _, g in pairs)
    for name, g in pairs:
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-4, atol=floor,
                                   err_msg=name)


@pytest.mark.parametrize("kw", [dict(fused_update=True, two_step_update=True),
                                dict(fused_update=True, two_step_split_adam=True),
                                dict(optimizer="lbfgs"),
                                dict(repeat_action=2, rollout_block=True)])
def test_refused_options_raise(env, kw):
    """What the JAX package refuses, the port refuses: fused_update with a
    two-step scheme, an unknown optimizer, repeat_action with the block
    rollout."""
    with pytest.raises(ValueError):
        CARLAgent(env, CARLAgentConfig(network=TINY_NET, **kw))
