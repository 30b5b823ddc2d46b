"""The port's RL math and optimizer against the JAX package on seeded numpy
inputs: masked GAE, the learner's discounted returns, sp_norm,
decompose/compose_number, the KL surrogate, per-tensor gradient clipping
with non-finite entries, polyak averaging, and Adam against optax.

Tolerances: GAE and returns 1e-6 relative + 1e-5 absolute (37 steps of
accumulation over O(10) terms: a few float32 ulps, and XLA may contract a
multiply-add that PyTorch rounds twice); 1e-6 absolute elsewhere: the same
float32 formulas in the same order, differing only in reduction order and
the CPU's log10/pow; decompose's exponents exact; Adam after one
and after ten steps 1e-6 (a float32 ulp of the update's formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from carla_driving_rl_agent_tpu.utils import math as jm

from carla_driving_rl_agent_torch.utils import math as tm
from carla_driving_rl_agent_torch.utils.optimizers import (
    get_optimizer_by_name, set_learning_rate)

S, B = 37, 6


def _rollout(rng):
    rewards = rng.normal(0.0, 3.0, (S, B)).astype(np.float32)
    values = rng.normal(0.0, 5.0, (S, B)).astype(np.float32)
    dones = (rng.uniform(size=(S, B)) < 0.1).astype(np.float32)
    boot = rng.normal(0.0, 5.0, B).astype(np.float32)
    return rewards, values, dones, boot


@pytest.mark.parametrize("gamma,lam", [(0.9999, 0.999), (0.99, 0.95)])
def test_batched_gae(rng, gamma, lam):
    r, v, d, b = _rollout(rng)
    ja, jr = jm.batched_gae(*(jnp.asarray(x) for x in (r, v, d, b)), gamma, lam)
    ta, tr = tm.batched_gae(*(torch.from_numpy(x) for x in (r, v, d, b)), gamma, lam)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-5)


def test_discounted_returns(rng):
    """The learner's returns scan (JAX carla_agent.py:466-471)."""
    r, _, d, b = _rollout(rng)
    gamma = 0.9999

    def step(carry, xs):
        rr, dd = xs
        ret = rr + gamma * (1.0 - dd) * carry
        return ret, ret

    _, jret = jax.lax.scan(step, jnp.asarray(b), (jnp.asarray(r), jnp.asarray(d)),
                           reverse=True)
    tret = tm.discounted_returns(torch.from_numpy(r), torch.from_numpy(d),
                                 torch.from_numpy(b), gamma)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), rtol=1e-6, atol=1e-5)


def test_sp_norm_and_kl(rng):
    x = rng.normal(0.0, 4.0, (S, B)).astype(np.float32)
    np.testing.assert_allclose(tm.sp_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.sp_norm(jnp.asarray(x))), rtol=0, atol=1e-6)
    a, b = (rng.normal(size=(64, 2)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tm.kl_divergence(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.kl_divergence(jnp.asarray(a), jnp.asarray(b))), rtol=0, atol=1e-6)


def test_decompose_compose(rng):
    x = np.concatenate([
        rng.normal(0.0, 1.0, 200) * 10.0 ** rng.integers(-3, 6, 200),
        np.array([0.0, 1.0, -1.0, 10.0, 100.0, 1000.0, -1000.0, 0.5, 9.99, 10.01])
    ]).astype(np.float32)
    jb, je = jm.decompose_number(jnp.asarray(x))
    tb, te = tm.decompose_number(torch.from_numpy(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    assert float(tb.abs().max()) <= 1.0
    np.testing.assert_allclose(tm.compose_number(tb, te).numpy(),
                               np.asarray(jm.compose_number(jb, je)), rtol=1e-6, atol=1e-6)


def test_clip_gradients_per_tensor_with_non_finite(rng):
    grads = [rng.normal(0.0, s, shape).astype(np.float32)
             for s, shape in ((0.01, (5, 3)), (3.0, (7,)), (50.0, (2, 2, 3)), (1.0, (4,)))]
    grads[1][2] = np.inf
    grads[2][0, 1, 1] = np.nan
    grads[3][:] = -np.inf
    jout = jm.clip_gradients([jnp.asarray(g) for g in grads], 1.0)
    tout = tm.clip_gradients([torch.from_numpy(g) for g in grads], 1.0)
    for j, t in zip(jout, tout):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)
    # per tensor: each clipped tensor's norm is at most 1, the small one unchanged
    norms = [float(torch.linalg.vector_norm(t)) for t in tout]
    assert max(norms) <= 1.0 + 1e-6
    np.testing.assert_allclose(tout[0].numpy(), grads[0], rtol=0, atol=1e-7)


def test_polyak_average(rng):
    new, old = (rng.normal(size=(3, 4)).astype(np.float32) for _ in range(2))
    j = jm.polyak_average([jnp.asarray(new)], [jnp.asarray(old)], 0.95)[0]
    t = [torch.from_numpy(new.copy())]
    tm.polyak_average_(t, [torch.from_numpy(old)], 0.95)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 10])
def test_adam_matches_optax(rng, steps):
    p0 = [rng.normal(size=(7, 5)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    grads = [[(rng.normal(size=p.shape) * s).astype(np.float32) for p in p0]
             for s in np.geomspace(1e-3, 10.0, steps)]
    lrs = np.linspace(3e-4, 1e-4, steps)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = get_optimizer_by_name("adam", tp, 3e-4)
    jopt = optax.inject_hyperparams(optax.adam)(learning_rate=3e-4)
    jp = [jnp.asarray(p) for p in p0]
    state = jopt.init(jp)
    for g, lr in zip(grads, lrs):
        set_learning_rate(opt, lr)
        for p, gg in zip(tp, g):
            p.grad = torch.from_numpy(gg)
        opt.step()
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        up, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, up)
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_other_optimizers_raise():
    """A name outside the JAX registry's eight raises ValueError, as the
    JAX registry does; the seven besides Adam are ported (each held
    against optax in test_torch_learner_options.py)."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        get_optimizer_by_name("lbfgs", p)
    for name in ("adadelta", "adagrad", "adamax", "ftrl", "nadam", "rmsprop", "sgd"):
        assert isinstance(get_optimizer_by_name(name, p), torch.optim.Optimizer), name
