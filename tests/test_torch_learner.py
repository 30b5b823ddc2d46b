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
import optax
import pytest
import torch
import flax.linen as fnn

from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgent as JAgent
from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgentConfig as JConfig
from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
from carla_driving_rl_agent_tpu.utils import math as jm
from carla_driving_rl_agent_tpu.utils.optimizers import get_optimizer_by_name as jopt

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.models.layers import BatchNorm
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax

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
                      weights_dir=str(tmp) if tmp else "unused")
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


# ------------------------------------------------------------------

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


def test_policy_and_value_steps_match_jax(env, jnet_init, jax_steps):
    """One policy-phase step then one value-phase step, from the same
    parameters, Adam states and minibatches."""
    _steps_match_jax(env, jnet_init, jax_steps)


def test_fused_units_steps_match_jax(env, jnet_init, jax_steps):
    """The same two steps with fused_units=True (the backbone's stride-1
    units through the fused op, its plain version on the CPU: forward,
    batch statistics, fold and backward) against the JAX learner's unfused
    steps, at the same bars."""
    _steps_match_jax(env, jnet_init, jax_steps, fused_units=True)


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


@pytest.mark.parametrize("block", [True, False])
def test_learn_two_updates(env, jnet_init, block):
    """Two updates with block rollouts (the kernel path) and with the
    per-step rollout (the JAX package's default)."""
    agent = _agent(env, jnet_init, num_envs=4, rollout_steps=8, batch_size=16,
                   rollout_block=block)
    before = {k: v.clone() for k, v in agent.network.state_dict().items()}
    _, history = agent.learn(2)
    assert len(history) == 2 and agent.update_step == 2
    for m in history:
        for k in ("loss_policy", "loss_value", "entropy", "ratio", "kl"):
            assert np.isfinite(m[k]), k
        assert set(agent.last_timings) == {"rollout", "targets", "policy", "value"}
    after = agent.network.state_dict()
    for grp in ("policy.", "value.", "dynamics."):
        moved = max(float((after[k] - before[k]).abs().max()) for k in after
                    if k.startswith(grp))
        assert moved > 0.0, grp


def test_save_load_round_trip(env, jnet_init, tmp_path):
    agent = _agent(env, jnet_init, tmp_path, num_envs=4, rollout_steps=8, batch_size=16,
                   rollout_block=True)
    agent.learn(1)
    agent.save()
    fresh = _agent(env, jnet_init, tmp_path, num_envs=4, rollout_steps=8, batch_size=16)
    fresh.load()
    sd, sd2 = agent.network.state_dict(), fresh.network.state_dict()
    for k in sd:
        if not k.startswith("old_policy."):
            assert torch.equal(sd[k], sd2[k]), k
    # a full restore copies policy -> old_policy, as the JAX package's does
    for n, p in fresh.network.old_policy.named_parameters():
        assert torch.equal(p, sd2[f"policy.{n}"])
    for g in ("policy", "value", "dynamics"):
        s1, s2 = agent.optimizers[g].state_dict(), fresh.optimizers[g].state_dict()
        for i in s1["state"]:
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s1["state"][i][key], s2["state"][i][key])
    assert fresh.update_step == agent.update_step == 1
    # backbone-only restore
    other = _agent(env, jnet_init, tmp_path)
    with torch.no_grad():
        for p in other.network.value.parameters():
            p.add_(1.0)
    other.load(full=False)
    sd3 = other.network.state_dict()
    for k in sd:
        if k.startswith("dynamics."):
            assert torch.equal(sd3[k], sd[k]), k
    assert not torch.equal(sd3["value.v_base.weight"], sd["value.v_base.weight"])


def test_stage_s1_run2(tmp_path):
    stage = stages.stage_s1(
        episodes=1, timesteps=8, batch_size=16, num_envs=4, town="Town02",
        network=TINY_NET, rollout_block=True, weights_dir=str(tmp_path),
        env_overrides=dict(fused_step=True, device="cpu", num_routes=8,
                           image_shape=(45, 60, 3)))
    stage.run2(1)
    assert stage.agent.update_step == 1
    assert stage.env.params.origin_spawns is not None
    assert len(stage.env.params.origin_spawns) == 10
    for d in ("stage-s1", "stage-s1-0"):
        assert (tmp_path / d / "network.pt").exists()
        assert (tmp_path / d / "config.json").exists()


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


def test_cli_fused_units_smoke(tmp_path, monkeypatch):
    """`python -m carla_driving_rl_agent_torch.main --fused-units` on the CPU,
    cut to one update of 4 worlds x 8 steps of a tiny network on Town02: the
    flag reaches the agent, every stride-1 unit runs fused, and the
    checkpoint is written."""
    from carla_driving_rl_agent_torch import main as cli
    made, stage_s1 = [], stages.stage_s1

    def small_stage_s1(**kw):
        kw.update(network=TINY_NET, town="Town02",
                  env_overrides=dict(kw["env_overrides"], num_routes=8, image_shape=(45, 60, 3)))
        made.append(stage_s1(**kw))
        return made[-1]

    monkeypatch.setattr(cli, "EPISODES", 1)
    monkeypatch.setattr(cli, "TIMESTEPS", 8)
    monkeypatch.setattr(cli, "BATCH", 16)
    monkeypatch.setattr(cli.stages, "stage_s1", small_stage_s1)
    rc = cli.main(["--stage", "s1", "--epochs", "1", "--num-envs", "4", "--block",
                   "--fused-step", "--fused-units", "--device", "cpu",
                   "--weights-dir", str(tmp_path)])
    assert rc == 0
    agent = made[0].agent
    assert agent.config.fused_units and agent.update_step == 1
    backbone = agent.network.dynamics.ShuffleNetV2_0
    units = [getattr(backbone, f"ShuffleUnit_{i}") for i in range(backbone.num_units)]
    assert [u.fused for u in units] == [u.stride == 1 for u in units]
    assert (tmp_path / "stage-s1" / "network.pt").exists()
