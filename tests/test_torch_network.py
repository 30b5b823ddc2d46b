"""The PyTorch port's network against the JAX package on the CPU, with the
shipped safe-s5 checkpoint converted by the port's own reader.

Tolerances: the checkpoint reader is exact; each ShuffleNet unit 1e-5 (one
unit's float32 convolutions in another summation order); the whole
backbone (also with fused_units=True, whose stride-1 units run their fused
op's plain version on the CPU, in inference and in training mode) and
predict's outputs 1e-4 absolute, the folded BatchNorm buffers 1e-5 (BatchNorm amplifies float32
rounding ~30x per layer through the 16 units, CLAUDE.md:292-300; measured
differences are ~1e-6); Beta log_prob/entropy 1e-5; Beta sampling moments
within 5 standard errors of the analytic mean and variance.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from carla_driving_rl_agent_tpu.models import shufflenet as jsn
from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
from carla_driving_rl_agent_tpu.models.distributions import Beta as JBeta

from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.models.distributions import Beta, sample_gamma
from carla_driving_rl_agent_torch.models.shufflenet import ShuffleNetV2
from carla_driving_rl_agent_torch.utils import checkpoint as ckpt
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "safe-s5")
SPEC = {"control_policy": {"preact_floor": -3.0}}

# (input H, W, C, num_channels, stride) of each unit for 90x360 frames
UNITS = ([(22, 90, 24, 116, 2)] + [(11, 45, 116, 116, 1)] * 3
         + [(11, 45, 116, 232, 2)] + [(6, 23, 232, 232, 1)] * 7
         + [(6, 23, 232, 464, 2)] + [(3, 12, 464, 464, 1)] * 3)


def _restore(name):
    with open(os.path.join(WEIGHTS, name), "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def trees():
    return _restore("params.msgpack"), _restore("batch_stats.msgpack")


@pytest.fixture(scope="module")
def tnet():
    net = CARLANetwork(**SPEC)
    ckpt.load_network_weights(net, WEIGHTS)
    return net


def _equal_trees(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(b[k], dict):
            _equal_trees(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], f"{path}/{k}")


@pytest.mark.parametrize("name", ["params.msgpack", "batch_stats.msgpack"])
def test_read_flax_msgpack_equals_flax(name):
    _equal_trees(ckpt.read_flax_msgpack(os.path.join(WEIGHTS, name)), _restore(name))


def test_state_dict_covers_the_network(trees, tnet):
    sd = ckpt.params_from_jax(*trees)
    assert set(sd) == set(tnet.state_dict())
    for k, v in tnet.state_dict().items():
        assert sd[k].shape == v.shape, k


@pytest.mark.parametrize("i", range(len(UNITS)))
def test_shufflenet_unit(i, trees, tnet):
    h, w, c, nc, stride = UNITS[i]
    name = f"ShuffleUnit_{i}"
    x = np.random.default_rng(i).normal(0.0, 1.0, (2, h, w, c)).astype(np.float32)
    P, S = trees
    unit = jsn.ShuffleUnit(num_channels=nc, stride=stride)
    ref = unit.apply({"params": P["dynamics"]["ShuffleNetV2_0"][name],
                      "batch_stats": S["dynamics"]["ShuffleNetV2_0"][name]},
                     jnp.asarray(x), training=False)
    mod = getattr(tnet.dynamics.ShuffleNetV2_0, name)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _obs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return dict(state_image=rng.uniform(0, 1, (batch, 4, 90, 360, 3)).astype(np.float32),
                state_road=rng.uniform(0, 1, (batch, 4, 9)).astype(np.float32),
                state_vehicle=rng.uniform(0, 1, (batch, 4, 4)).astype(np.float32),
                state_navigation=rng.uniform(0, 3, (batch, 4, 5)).astype(np.float32))


def test_backbone(trees, tnet):
    P, S = trees
    obs = _obs(2, seed=3)
    ref = jax.jit(lambda v, x: jsn.ShuffleNetV2(g=1.0, last_channels=768).apply(
        v, x, training=False))(
        {"params": P["dynamics"]["ShuffleNetV2_0"],
         "batch_stats": S["dynamics"]["ShuffleNetV2_0"]}, jnp.asarray(obs["state_image"]))
    with torch.no_grad():
        out = tnet.dynamics.ShuffleNetV2_0(torch.from_numpy(obs["state_image"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_predict_matches_jax(trees, tnet):
    P, S = trees
    obs = _obs(3, seed=1)
    jin = {k: jnp.asarray(v) for k, v in obs.items()}
    jin["action"] = jnp.zeros((3, 2))
    jnet = JNet(**SPEC)
    action = np.asarray([[0.2, 0.7], [0.5, 0.5], [0.9, 0.1]], np.float32)

    @jax.jit        # one compiled program instead of an eager compile per operation
    def reference(P, S, jin, action):
        out = jnet.predict(P, S, jin, jax.random.PRNGKey(0))
        feat_ref, _ = jnet.dynamics_apply(P, S, jin)
        pol_ref, _ = jnet.policy_apply(P, S, feat_ref, old=True)
        return out, feat_ref, pol_ref["dist"].log_prob(action)

    out, feat_ref, log_prob_ref = reference(P, S, jin, jnp.asarray(action))
    with torch.no_grad():
        feat = tnet.dynamics({k: torch.from_numpy(v) for k, v in obs.items()})
        pol, val = tnet.old_policy(feat), tnet.value(feat)
    d = pol["dist"]
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_ref), rtol=0, atol=1e-4)
    checks = dict(mean=(d.mean(), out["mean"]), std=(d.stddev(), out["std"]),
                  value=(val["value"], out["value"]),
                  log_prob=(d.log_prob(torch.from_numpy(action)), log_prob_ref),
                  speed=(pol["speed"], out["speed"]),
                  similarity=(pol["similarity"], out["similarity"]))
    for k, (a, b) in checks.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4, err_msg=k)


def test_predict_samples_from_the_generator(tnet):
    obs = {k: torch.from_numpy(v) for k, v in _obs(2, seed=2).items()}
    a = tnet.predict(obs, torch.Generator().manual_seed(1))
    b = tnet.predict(obs, torch.Generator().manual_seed(1))
    assert torch.equal(a["action"], b["action"])
    assert a["action"].shape == (2, 2)
    assert bool(((a["action"] > 0) & (a["action"] < 1)).all())


def test_beta_log_prob_entropy_match_jax(rng):
    alpha = rng.uniform(1.01, 8.0, 64).astype(np.float32)
    beta = rng.uniform(1.01, 8.0, 64).astype(np.float32)
    x = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    j, t = JBeta(jnp.asarray(alpha), jnp.asarray(beta)), Beta(torch.from_numpy(alpha),
                                                              torch.from_numpy(beta))
    for name, a, b in (("log_prob", t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x))),
                       ("entropy", t.entropy(), j.entropy()),
                       ("mean", t.mean(), j.mean()), ("stddev", t.stddev(), j.stddev()),
                       ("clip", t.clip(torch.from_numpy(x * 1.2 - 0.1)),
                        j.clip(jnp.asarray(x * 1.2 - 0.1)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("a,b", [(1.01, 1.01), (2.5, 1.2), (0.6, 3.0), (9.0, 9.0)])
def test_beta_sampling_moments(a, b):
    n = 20000
    g = torch.Generator().manual_seed(0)
    s = Beta(torch.full((n,), a), torch.full((n,), b)).sample(g).double()
    assert bool(((s >= 0) & (s <= 1)).all())
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(float(s.mean()) - mean) < 5 * (var / n) ** 0.5
    # the sample variance's standard error, from the Beta's fourth moment
    # bounded above by var (values in [0, 1])
    assert abs(float(s.var()) - var) < 5 * (var / n) ** 0.5


def test_gamma_sampling_mean():
    g = torch.Generator().manual_seed(3)
    for k in (0.5, 1.0, 4.0):
        s = sample_gamma(torch.full((40000,), k), g).double()
        assert abs(float(s.mean()) - k) < 5 * (k / 40000) ** 0.5


# ------------------------------------------------------------------
# fused_units: the backbone's stride-1 units as fused ops (their plain
# versions on the CPU) against the JAX package's unfused flax backbone
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_backbone():
    """JAX ShuffleNetV2(g=0.5, last_channels=64) with random running
    statistics, and the port's fused_units=True backbone holding the same
    trees; tests/test_networks.py's 48x64 input."""
    x = np.array(jax.random.normal(jax.random.PRNGKey(7), (2, 2, 48, 64, 3), jnp.float32))
    jnet = jsn.ShuffleNetV2(g=0.5, last_channels=64, fused_units=False)
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), training=False)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(-0.2, 0.2, np.shape(a)).astype(np.float32),
        v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    wrap = lambda t, comps: dict({"dynamics": {"ShuffleNetV2_0": t}}, **{c: {} for c in comps})
    sd = ckpt.params_from_jax(wrap(params, ("policy", "old_policy", "value")),
                              wrap(stats, ("policy", "value")))
    prefix = "dynamics.ShuffleNetV2_0."
    net = ShuffleNetV2(g=0.5, last_channels=64, fused_units=True)
    net.load_state_dict({k[len(prefix):]: t for k, t in sd.items()}, strict=True)
    return jnet, params, stats, net, x


def test_fused_backbone_units():
    net = ShuffleNetV2(g=0.5, last_channels=64, fused_units=True)
    units = [getattr(net, f"ShuffleUnit_{i}") for i in range(net.num_units)]
    assert [u.fused for u in units] == [u.stride == 1 for u in units]
    assert sum(u.fused for u in units) == 13
    assert set(net.state_dict()) == set(ShuffleNetV2(g=0.5, last_channels=64).state_dict())


def test_fused_backbone_infer_matches_jax(small_backbone):
    jnet, params, stats, net, x = small_backbone
    ref = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), training=False)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_fused_backbone_train_and_fold_match_jax(small_backbone):
    """Training mode: the output and every folded BatchNorm buffer (the
    fused units fold their three BatchNorms' batch statistics once)."""
    jnet, params, stats, net, x = small_backbone
    net = copy.deepcopy(net).train()
    ref, mut = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                          training=True, mutable=["batch_stats"])
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    wrap = lambda t, comps: dict({"dynamics": {"ShuffleNetV2_0": t}}, **{c: {} for c in comps})
    folded = ckpt.params_from_jax(wrap(params, ("policy", "old_policy", "value")),
                                  wrap(mut["batch_stats"], ("policy", "value")))
    prefix = "dynamics.ShuffleNetV2_0."
    sd = net.state_dict()
    n = 0
    for k, v in folded.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k[len(prefix):]].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
            n += 1
    assert n == 2 * (2 + 13 * 3 + 3 * 5)
