"""The generic agents of the port against the JAX package on the CPU: the
Gaussian and Categorical distributions, PPONetwork with converted JAX
parameters, PointNavEnv with JAX's draws, one PPOAgent train iteration
against JAX's `train_iteration` (the Beta and the Categorical adapters),
RandomAgent.evaluate, and FakeCARLAEnvironment.

Tolerances: the distributions' functions 1e-6 (float32, the same formulas);
the networks' distribution parameters and values 1e-5 (float32 MLPs with
LayerNorms in another summation order); the env exactly for flags, to
1e-6 for positions and distances (float32 norms, one ulp apart) and to
1e-5 for rewards (ten times a difference of two such distances).  The
train iteration runs both sides in float64 (JAX under jax.enable_x64, the
port's network in double) with JAX's rollout samples,
reset draws and permutation injected: the losses to 1e-6 relative, every
parameter to 1e-6 relative + 1e-8 absolute, 1e-5 of an Adam step (JAX's
GAE, sp_norm and decompose_number cast to float32, so JAX's advantages
carry float32 rounding into its update; measured <= 2.6e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.agents.base import RandomAgent as JRandom
from carla_driving_rl_agent_tpu.agents.ppo import PPOAgent as JPPO, PPOConfig as JConfig
from carla_driving_rl_agent_tpu.envs import spaces as jspaces
from carla_driving_rl_agent_tpu.envs.fake import FakeCARLAEnvironment as JFake
from carla_driving_rl_agent_tpu.envs.toy import PointNavEnv as JPointNav
from carla_driving_rl_agent_tpu.models import distributions as jd
from carla_driving_rl_agent_tpu.models.networks import PPONetwork as JNet

from carla_driving_rl_agent_torch.agents.base import RandomAgent
from carla_driving_rl_agent_torch.agents.ppo import PPOAgent, PPOConfig
from carla_driving_rl_agent_torch.envs import spaces
from carla_driving_rl_agent_torch.envs.fake import FakeCARLAEnvironment
from carla_driving_rl_agent_torch.envs.toy import PointNavDraws, PointNavEnv
from carla_driving_rl_agent_torch.models import distributions as td
from carla_driving_rl_agent_torch.models.networks import PPONetwork
from carla_driving_rl_agent_torch.utils.checkpoint import ppo_params_from_jax
from torch_learner_common import one_thread  # noqa: F401


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_gaussian_and_categorical_match_jax(rng):
    mu = rng.normal(0, 1, (5, 3)).astype(np.float32)
    log_std = rng.normal(-0.5, 0.3, (5, 3)).astype(np.float32)
    x = rng.normal(0, 1.5, (5, 3)).astype(np.float32)
    jg, tg = jd.Gaussian(jnp.asarray(mu), jnp.asarray(log_std)), td.Gaussian(_t(mu), _t(log_std))
    logits = rng.normal(0, 2, (5, 2, 4)).astype(np.float32)
    k = rng.integers(0, 4, (5, 2)).astype(np.float32)
    jc, tc = jd.Categorical(jnp.asarray(logits)), td.Categorical(_t(logits))
    for jdist, tdist, xx in ((jg, tg, x), (jc, tc, k)):
        pairs = [(jdist.log_prob(jnp.asarray(xx)), tdist.log_prob(_t(xx))),
                 (jdist.entropy(), tdist.entropy()), (jdist.mean(), tdist.mean()),
                 (jdist.stddev(), tdist.stddev()),
                 (jdist.clip(jnp.asarray(xx)), tdist.clip(_t(xx)))]
        for j, t in pairs:
            assert tuple(t.shape) == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)


def test_samples_come_from_the_generator():
    g = td.Gaussian(torch.zeros(20000), torch.full((20000,), np.log(2.0)))
    a = g.sample(torch.Generator().manual_seed(1))
    assert torch.equal(a, g.sample(torch.Generator().manual_seed(1)))
    assert abs(float(a.std()) - 2.0) < 0.05
    c = td.Categorical(torch.log(torch.tensor([[0.2, 0.3, 0.5]])).expand(30000, 3))
    s = c.sample(torch.Generator().manual_seed(2))
    freq = torch.bincount(s.long(), minlength=3).double() / len(s)
    np.testing.assert_allclose(freq.numpy(), [0.2, 0.3, 0.5], atol=0.01)


@pytest.mark.parametrize("dist,spec", [
    ("beta", dict(policy=dict(units=16, num_layers=2), value=dict(units=16, num_layers=4))),
    ("gaussian", dict(policy=dict(units=16, num_layers=2, linear_units=8),
                      value=dict(units=16, num_layers=2), components=3)),
    ("categorical", dict(policy=dict(units=16, num_layers=2, activation="tanh"),
                         value=dict(units=16, num_layers=2)))])
def test_ppo_network_matches_jax(rng, dist, spec):
    jnet = JNet(num_actions=2, distribution=dist, num_classes=3, policy=spec["policy"],
                value=spec["value"], components=spec.get("components", 1))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 6)))
    # the heads' biases and the Gaussian's log_std start at 0: move them
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(rng.normal(0, 1, a.shape), a.dtype), params)
    tnet = PPONetwork(6, 2, dist, 3, spec["policy"], spec["value"],
                      components=spec.get("components", 1))
    tnet.load_state_dict(ppo_params_from_jax(params), strict=True)
    x = rng.normal(0, 2, (7, 6)).astype(np.float32)

    @jax.jit
    def fwd(params, x):
        d = jnet.policy_dist(params, x, old=True)
        return jax.tree_util.tree_leaves(d), jnet.value(params, x)

    jleaves, jv = fwd(params, jnp.asarray(x))
    td_ = tnet.policy_dist(_t(x), old=True)
    tleaves = [getattr(td_, f) for f in td_.__dataclass_fields__]
    with torch.no_grad():
        for j, t in zip(jleaves, tleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tnet.value(_t(x)).numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)


def _jax_pointnav(n, seed, max_steps=100):
    env = JPointNav(max_steps=max_steps)
    states, _ = jax.jit(jax.vmap(env.reset))(jax.random.split(jax.random.PRNGKey(seed), n))
    return env, states


def _fresh_draws(env, keys):
    """The fresh episode each JAX state's auto-reset draws (toy.py:62-64)."""
    def one(k):
        _, k_reset = jax.random.split(k)
        k1, k2, _ = jax.random.split(k_reset, 3)
        u = lambda kk: jax.random.uniform(kk, (2,), minval=-env.arena, maxval=env.arena)
        return u(k1), u(k2)
    pos, goal = jax.vmap(one)(keys)
    return pos, goal


def test_pointnav_matches_jax(rng):
    jenv, js = _jax_pointnav(16, 3, max_steps=6)
    tenv = PointNavEnv(max_steps=6)
    ts, tobs = tenv.reset(PointNavDraws(_t(js.pos), _t(js.goal)))
    jstep = jax.jit(jax.vmap(jenv.step))
    draws = jax.jit(lambda k: _fresh_draws(jenv, k))
    for i in range(8):
        a = rng.uniform(-1.5, 1.5, (16, 2)).astype(np.float32)
        if i == 2:
            a[:4] = np.asarray(js.goal - js.pos)[:4] * 2.0      # some arrive
        pos, goal = draws(js.key)
        js, jobs, jr, jterm, jtrunc, jinfo = jstep(js, jnp.asarray(a))
        ts, tobs, tr, tterm, ttrunc, tinfo = tenv.step(ts, _t(a), PointNavDraws(_t(pos),
                                                                                _t(goal)))
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        for t, j in ((tobs, jobs), (tinfo["distance"], jinfo["distance"]), (ts.t, js.t)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
        # ten times a difference of two distances of a few metres
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5)


class DiscretePointNav(PointNavEnv):
    """tests/test_generic_ppo.py::test_discrete_action_space's env."""

    def __init__(self, bins=4, **kw):
        super().__init__(**kw)
        self.bins = bins
        self.action_space = spaces.MultiDiscrete(nvec=[bins, bins])

    def step(self, state, action, draws=None, gen=None):
        return super().step(state, action.to(torch.float32) / (self.bins - 1) * 2.0 - 1.0,
                            draws, gen)


class JDiscretePointNav(JPointNav):
    def __init__(self, bins=4, **kw):
        super().__init__(**kw)
        self.bins = bins
        self.action_space = jspaces.MultiDiscrete(nvec=[bins, bins])

    def step(self, state, action):
        return super().step(state, action.astype(jnp.float32) / (self.bins - 1) * 2.0 - 1.0)


def _jax_draws(jagent, params, states, key):
    """The samples, reset draws and permutation of JAX's train_iteration
    (ppo.py:145-194) from `key`, replayed."""
    cfg, env, net = jagent.config, jagent.env, jagent.network

    def run(params, states, key):
        key, k_roll, k_perm = jax.random.split(key, 3)

        def step(carry, _):
            states, key = carry
            key, k = jax.random.split(key)
            pred = net.predict(params, jax.vmap(env._obs)(states), k)
            pos, goal = _fresh_draws(env, states.key)
            states = jax.vmap(env.step)(states, jagent.convert_action(pred["action"]))[0]
            return (states, key), (pred["action"], pos, goal)

        _, out = jax.lax.scan(step, (states, k_roll), None, length=cfg.rollout_steps)
        return out + (jax.random.permutation(k_perm, cfg.rollout_steps * cfg.num_envs),)
    return jax.jit(run)(params, states, key)


@pytest.mark.parametrize("discrete", [False, True])
def test_train_iteration_matches_jax(tmp_path, discrete):
    cfg = dict(num_envs=4, rollout_steps=8, batch_size=8, polyak=0.9,
               entropy_regularization=0.01,
               network=dict(policy=dict(units=16, num_layers=2),
                            value=dict(units=16, num_layers=2)))
    hyper = dict(clip_ratio=0.2, entropy=0.01, adv_scale=2.0)
    with jax.enable_x64(True):
        jenv = JDiscretePointNav(max_steps=5) if discrete else JPointNav(max_steps=5)
        jagent = JPPO(jenv, JConfig(**cfg), weights_dir=str(tmp_path), log_mode=None)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jagent.params)
        opt_state = dict(policy=jagent.policy_opt.init(params["policy"]),
                         value=jagent.value_opt.init(params["value"]))
        states, _ = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(4), 4))
        key = jax.random.PRNGKey(9)
        acts, pos, goal, perm = _jax_draws(jagent, params, states, key)
        start = PointNavDraws(_t(states.pos), _t(states.goal))   # JAX donates `states`
        jparams, _, _, jm = jagent._build_train_fn()(
            params, opt_state, states, key, {k: jnp.float64(v) for k, v in hyper.items()})
        ref = ppo_params_from_jax(jparams)
    tenv = DiscretePointNav(max_steps=5) if discrete else PointNavEnv(max_steps=5)
    agent = PPOAgent(tenv, PPOConfig(**cfg), log_mode=None, device="cpu",
                     weights_dir=str(tmp_path))
    assert agent.distribution == ("categorical" if discrete else "beta")
    agent.network.double()
    agent.network.load_state_dict(ppo_params_from_jax(params), strict=True)
    ts, _ = tenv.reset(start)
    _, m = agent.train_iteration(ts, hyper, draws=dict(
        samples=_t(acts), resets=[PointNavDraws(_t(p), _t(g)) for p, g in zip(pos, goal)],
        perm=_t(perm, torch.int64)))
    for k, v in m.items():
        np.testing.assert_allclose(v, float(jm[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    for k, v in agent.network.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=k)


def test_learn_save_load_and_gaussian(tmp_path):
    """learn() with the schedules and the Summary, save and load, and the
    Gaussian adapter on an unbounded Box."""
    env = PointNavEnv(max_steps=20)
    agent = PPOAgent(env, PPOConfig(num_envs=4, rollout_steps=8, batch_size=16, seed=3),
                     device="cpu", weights_dir=str(tmp_path), log_dir=str(tmp_path / "logs"))
    _, hist = agent.learn(2)
    assert agent.update_step == 2 and all(np.isfinite(h["loss_policy"]) for h in hist)
    assert (tmp_path / "logs" / "ppo-agent").exists()
    agent.save()
    other = PPOAgent(env, PPOConfig(num_envs=4, rollout_steps=8, batch_size=16, seed=4),
                     device="cpu", weights_dir=str(tmp_path), log_mode=None)
    other.load()
    for k, v in agent.network.state_dict().items():
        assert torch.equal(other.network.state_dict()[k], v), k
    assert other.update_step == 2

    class Unbounded(PointNavEnv):
        def __init__(self):
            super().__init__()
            self.action_space = spaces.Box(low=-np.inf, high=np.inf, shape=(2,))
    g = PPOAgent(Unbounded(), PPOConfig(num_envs=4, rollout_steps=8, batch_size=16),
                 device="cpu", weights_dir=str(tmp_path), log_mode=None)
    assert g.distribution == "gaussian"
    _, hist = g.learn(1)
    assert np.isfinite(hist[0]["loss_value"])


def test_random_agent_statistics(tmp_path):
    env = PointNavEnv(max_steps=50)
    res = RandomAgent(env, device="cpu", weights_dir=str(tmp_path),
                      log_mode=None).evaluate(episodes=256, timesteps=50)
    assert len(res["episode_rewards"]) == 256
    jres = JRandom(JPointNav(max_steps=50), weights_dir=str(tmp_path),
                   log_mode=None).evaluate(episodes=256, timesteps=50)
    # other streams: the means within 4 standard errors of the pair
    se = np.hypot(res["std"], jres["std"]) / np.sqrt(256)
    assert abs(res["mean"] - jres["mean"]) < 4 * se
    assert np.isclose(res["mean"], np.mean(res["episode_rewards"]))
    again = RandomAgent(env, device="cpu", weights_dir=str(tmp_path),
                        log_mode=None).evaluate(episodes=256, timesteps=50)
    assert again == res


def test_fake_env_matches_jax():
    t, j = FakeCARLAEnvironment(), JFake()
    assert spaces.space_to_flat_spec(t.observation_space) == \
        jspaces.space_to_flat_spec(j.observation_space)
    assert t.action_space.shape == j.action_space.shape
    to, jo = t.sample_stacked_obs(3), j.sample_stacked_obs(3)
    assert set(to) == set(jo)
    for k in jo:
        assert tuple(to[k].shape) == jo[k].shape and not to[k].any()
