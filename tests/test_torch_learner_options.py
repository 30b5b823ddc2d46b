"""The port's learner options against the JAX package on the CPU, at
tests/test_torch_learner.py's TINY_NET widths:

  * the eight optimizers against optax (the JAX registry), 5 steps on
    random trees in float64, 1e-9 relative; the flat optimizer bit-equal to
    the per-tensor one;
  * resample_actions: JAX's Gamma variates fed to Beta.rsample, the policy
    objective's gradients against jax.grad's in float64, 1e-4 relative L2
    per tensor (measured <= 4.8e-5); the two implicit Gamma gradients
    themselves (torch._standard_gamma_grad, and lax.random_gamma_grad under
    jax.random's loggamma) are two approximations that differ elementwise
    by up to 3.6e-4 relative for concentrations in [1.01, 6] (median
    2.6e-5), held to 5e-4 (a recorded tolerance, ROADMAP.md section 3);
  * Beta.rsample drawing as sample does, its gradient reaching alpha and
    beta.

The options that run the learner's loop: test_torch_learner_loop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_driving_rl_agent_tpu.agents.carla_agent import CARLAgentConfig as JConfig
from carla_driving_rl_agent_tpu.utils.optimizers import get_optimizer_by_name as jopt

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.models.distributions import Beta as TBeta
from carla_driving_rl_agent_torch.utils.optimizers import OPTIMIZERS, get_optimizer_by_name
from test_torch_learner import HYPER, MB, TINY_NET, _batch64, _jself
from test_torch_learner_variants import env, one_thread_module  # noqa: F401  (no town)


def _tiny_agent(env, tmp, **cfg):
    return CARLAgent(env, CARLAgentConfig(network=TINY_NET, **cfg), name="t",
                     weights_dir=str(tmp), log_mode=None)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """5 steps on a random tree in float64 against the JAX registry's optax
    optimizer; the flat optimizer bit-equal to the per-tensor one."""
    rng = np.random.default_rng(len(name))
    shapes = [(4, 3), (7,), (2, 3, 5)]
    p0 = [rng.normal(0, 1, s) for s in shapes]
    grads = [[rng.normal(0, 1, s) for s in shapes] for _ in range(5)]
    with jax.enable_x64(True):
        opt = jopt(name, 3e-3)
        jp = [jnp.asarray(a) for a in p0]
        st = opt.init(jp)
        for g in grads:
            up, st = opt.update([jnp.asarray(a) for a in g], st, jp)
            jp = optax.apply_updates(jp, up)
        jp = [np.asarray(a) for a in jp]
    runs = []
    for flat in (False, True):
        ps = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
        o = get_optimizer_by_name(name, ps, 3e-3, flat=flat)
        for g in grads:
            for p, a in zip(ps, g):
                p.grad = torch.tensor(a)
            o.step()
            o.zero_grad()
        runs.append([p.detach() for p in ps])
    for got, want in zip(runs[0], jp):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=0)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_resample_actions_gradients_match_jax(env):
    """The policy objective with resample_actions, the policy head in
    training mode on a random dynamics feature, JAX's Gamma variates (its
    beta's loggamma draws, random.py _beta) fed to Beta.rsample: the
    gradients of the policy parameters against jax.grad's, float64."""
    from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
    agent = _tiny_agent(env, "unused", resample_actions=True)
    agent.network.double()
    head = agent.network.policy
    sd = {k: v.numpy() for k, v in head.state_dict().items()}
    feat = np.random.default_rng(8).normal(0, 1, (MB, 64))
    with jax.enable_x64(True):
        jnet = JNet(**TINY_NET, compute_dtype=jnp.float64)
        shapes = jax.eval_shape(lambda k, f: jnet.policy_model.init(k, f, training=False),
                                jax.random.PRNGKey(0), jnp.zeros((1, 64)))

        def fill(tree, prefix, stats):
            out = {}
            for k, v in tree.items():
                mod = ".".join(prefix + (k,)) if isinstance(v, dict) else ".".join(prefix)
                if isinstance(v, dict):
                    out[k] = fill(v, prefix + (k,), stats)
                elif stats:
                    out[k] = jnp.asarray(sd[f"{mod}.running_{k}"])
                elif k == "kernel":
                    out[k] = jnp.asarray(sd[f"{mod}.weight"].T)
                else:
                    out[k] = jnp.asarray(sd[f"{mod}.{'weight' if k == 'scale' else 'bias'}"])
            return out

        params = dict(policy=fill(shapes["params"], (), False))
        stats = dict(policy=fill(shapes["batch_stats"], (), True))
        jb, tb = _batch64(6)
        js = _jself(jnet)
        js.config = JConfig(network=TINY_NET, resample_actions=True)
        key = jax.random.PRNGKey(9)

        @jax.jit
        def ref(params, stats, feat, batch):
            pol, _ = jnet.policy_apply(params, stats, feat, training=True)
            a, b = pol["dist"].alpha, pol["dist"].beta
            k_a, k_b = jax.random.split(key)
            gammas = (jnp.exp(jax.random.loggamma(k_a, a, a.shape, a.dtype)),
                      jnp.exp(jax.random.loggamma(k_b, b, b.shape, b.dtype)))

            def loss(p):
                return js._policy_objective(dict(params, policy=p), stats, feat, batch, HYPER,
                                            key)[0]
            return (a, b), gammas, jax.grad(loss)(params["policy"])

        (a, b), gammas, g = ref(params, stats, jnp.asarray(feat), jb)
        # the two implicit Gamma gradients themselves
        for conc, x in zip((a, b), gammas):
            want = np.asarray(jax.lax.random_gamma_grad(conc, x))
            got = torch._standard_gamma_grad(torch.from_numpy(np.array(conc)),
                                             torch.from_numpy(np.array(x))).numpy()
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=0)
    tb["gammas"] = tuple(torch.from_numpy(np.array(x)) for x in gammas)
    loss, _ = agent._policy_objective(head.train()(torch.from_numpy(feat)), tb, HYPER)
    grads = agent._grads(loss, ("policy",))["policy"]
    names = {id(p): n for n, p in head.named_parameters()}
    top = max(float(t.abs().max()) for t in grads)
    want = {}
    for path, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        keys = [k.key for k in path]
        mod, leaf = ".".join(keys[:-1]), keys[-1]
        arr = np.asarray(v)
        want[f"{mod}.{'weight' if leaf in ('kernel', 'scale') else 'bias'}"] = \
            arr.T if leaf == "kernel" else arr
    assert set(want) == set(names.values())
    for p, t in zip(agent.params["policy"], grads):
        w = want[names[id(p)]]
        err = np.linalg.norm(t.numpy() - w) / max(np.linalg.norm(w), 1e-9 * top)
        assert err <= 1e-4, (names[id(p)], err)


def test_beta_rsample_draws_and_differentiates():
    """rsample draws as sample does (the same generator state gives the
    same values), and its gradient reaches alpha and beta."""
    alpha = torch.tensor([1.5, 3.0], dtype=torch.float64, requires_grad=True)
    beta = torch.tensor([2.0, 1.2], dtype=torch.float64, requires_grad=True)
    d = TBeta(alpha, beta)
    s = d.rsample(torch.Generator().manual_seed(4))
    assert torch.equal(s.detach(), d.sample(torch.Generator().manual_seed(4)).detach())
    s.sum().backward()
    assert alpha.grad is not None and beta.grad is not None
    assert bool((alpha.grad > 0).all()) and bool((beta.grad < 0).all())
