"""compute_dtype "bfloat16" in the port against the JAX package on the CPU,
all in bfloat16:

  * the split of a float32 value into three bf16 terms that the bf16
    kernels' tensor cores take (shuffle_unit.cuh `split3`: exact, each term
    a bf16 value) and the products summed over those terms
    (`add_product`), against float64;
  * the unit kernels' bf16 arithmetic (csrc/shuffle_unit.cuh built with
    g++, its products over the split terms) against the port's bf16 plain
    unit: the inference, the training
    forward, its batch statistics and the backward (relative L2 per tensor
    <= 1e-3; measured 0 for the outputs and gx, <= 3e-6 elsewhere; the four
    tensors whose true gradient is 0 held to 1e-3 of the unit's largest
    gradient); the inference also in bands of 1, 2 and 3 rows (halo rows
    recomputed, a last band shorter than the rest) and in one band taller
    than the image, against the plain unit (<= 1e-3) and JAX's (<= 1e-2);
  * the bf16 plain unit against JAX's shuffle_unit_infer and
    shuffle_unit_train on bf16 inputs (the Pallas kernels in interpret mode,
    cd = bfloat16 and f32 MXU passes): outputs, statistics and gradients,
    relative L2 <= 1e-2;
  * a bf16 port network that loads the JAX parameter tree (float32
    parameters either way) against JAX's compute_dtype=bfloat16 network in
    inference mode (the rollout's predict): alpha, beta, value, speed and
    similarity, relative L2 <= 2e-2 or a share of the distance between
    JAX's own bf16 and float32 networks where that is larger (a recorded
    tolerance, ROADMAP.md section 3), unfused and with fused units;
  * one bf16 learner step: the policy and value heads' gradients on the
    same float32 feature in training mode against JAX's, relative L2
    <= 5e-2 per tensor; the port's whole bf16 policy and value steps keep
    float32 parameters, Adam states and running statistics, all finite.

What is not held: the backbone's gradients of a whole bf16 training step.
Through training-mode BatchNorms at these tiny widths they are bf16
rounding noise: JAX's own bf16 gradients differ from its float32 ones by a
median relative L2 of ~1.0 per tensor, and the port's from JAX's by ~0.8
(tests/bf16_noise_floor.py measures both; ROADMAP.md section 3).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.models.carla_network import CARLANetwork as JNet
from carla_driving_rl_agent_tpu.models.shufflenet import ShuffleUnit as JUnit
from carla_driving_rl_agent_tpu.ops import shuffle_unit_pallas as sup

from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.models.layers import BatchNorm, init_flax_
from carla_driving_rl_agent_torch.models.shufflenet import ShuffleUnit
from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax
from test_torch_imitation import jax_trees
from test_torch_learner import HYPER, T, H, W, TINY_NET, _jself
from test_torch_learner_variants import env, one_thread_module  # noqa: F401  (no town)
from test_torch_shuffle_unit import (BAND_MAPS, NAMES, NOISE, SHAPES, Case, _bf16_launch,
                                     _host_lib, _infer_host, _nchw, _train_host)

BF = torch.bfloat16


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _bf16(a) -> np.ndarray:
    """a rounded to bfloat16 and back, float32."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _hold(got, ref, bar, what):
    """Per-tensor relative L2 in NAMES order; the noise tensors against the
    largest gradient."""
    top = max(float(np.abs(np.asarray(r, np.float64)).max()) for r in ref)
    for name, a, b in zip(NAMES, got, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, (what, name)
        if name in NOISE:
            assert np.abs(a - b).max() <= bar * top, (what, name)
        else:
            assert _rel(a, b) <= bar, (what, name, _rel(a, b))


def _bf16_unit(c, seed):
    g = torch.Generator().manual_seed(seed)
    unit = ShuffleUnit(c, c, 1, fused=True)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.4)
        for i in range(3):
            bn = getattr(unit, f"BatchNorm_{i}")
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.running_mean.normal_(0.0, 0.3, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
    return unit


def _plain_train(x, unit, gout):
    """The bf16 plain unit through autograd: (out, stats, gradients in
    NAMES order, each parameter's in its operand layout)."""
    xr = x.detach().requires_grad_(True)
    unit.train()
    out, stats = SU.shuffle_unit_train_plain(xr, unit)
    out.backward(gout)
    mods = [unit.Conv_0.weight, unit.Conv_0.bias, unit.BatchNorm_0.weight,
            unit.BatchNorm_0.bias, unit.Conv_1.weight, unit.Conv_1.bias,
            unit.BatchNorm_1.weight, unit.BatchNorm_1.bias, unit.Conv_2.weight,
            unit.Conv_2.bias, unit.BatchNorm_2.weight, unit.BatchNorm_2.bias]
    ops = SU.unit_operands(unit)
    grads = [xr.grad] + [m.grad.reshape(o.shape) for m, o in zip(mods, ops)]
    for m in mods:
        m.grad = None
    return out.detach(), stats, grads


def _bits(v) -> np.ndarray:
    return np.asarray(v, np.float32).view(np.uint32)


def _split_host(v: np.ndarray):
    v = np.ascontiguousarray(v, np.float32)
    hi, mid, lo = (np.empty_like(v) for _ in range(3))
    _host_lib().cdrl_unit_split_host(v.ctypes.data, v.size, hi.ctypes.data, mid.ctypes.data,
                                     lo.ctypes.data)
    return hi, mid, lo


# bit patterns: +-0, the smallest normal, bf16 rounding ties (the low 16
# bits 0x8000, even and odd bit 16), the values beside them, values whose
# rounding carries into the exponent, and the largest finite value, whose
# bf16 rounding to nearest would be infinite
SPLIT_EDGES = np.array([0x00000000, 0x80000000, 0x00800000, 0x3F808000, 0x3F818000, 0x3F807FFF,
                        0x3F808001, 0xBF818000, 0x3FFFFFFF, 0x3FFF8000, 0x7F7F8000, 0x7F7F7FFF,
                        0x7F7FFFFF, 0xFF7FFFFF, 0x0D000001, 0x4B7FFFFF], np.uint32)


@pytest.mark.parametrize("values", ["edges", "powers_of_two", "random"])
def test_split_into_three_bf16_terms_is_exact(values):
    """split3(v) = hi + mid + lo exactly in float64, each term a bf16 value
    (its low 16 bits 0), |mid| <= 2^-7 |v| and |lo| <= 2^-15 |v|: over the
    edge cases, every power of two from 2^-110 to 2^127 of both signs, and
    random values across the exponent range above 2^-110 (where lo keeps
    all its bits: below, bf16's subnormal spacing cuts it)."""
    if values == "edges":
        v = SPLIT_EDGES.view(np.float32)
    elif values == "powers_of_two":
        p = np.ldexp(1.0, np.arange(-110, 128)).astype(np.float32)
        v = np.concatenate([p, -p])
    else:
        rng = np.random.default_rng(16)
        bits = (rng.integers(0, 2, 20000, dtype=np.uint32) << 31
                | rng.integers(17, 255, 20000, dtype=np.uint32) << 23
                | rng.integers(0, 1 << 23, 20000, dtype=np.uint32))
        v = bits.astype(np.uint32).view(np.float32)
    hi, mid, lo = _split_host(v)
    for t in (hi, mid, lo):
        assert np.isfinite(t).all() and not (_bits(t) & 0xFFFF).any()
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    np.testing.assert_array_equal(total, v.astype(np.float64))
    mag = np.abs(v.astype(np.float64))
    assert (np.abs(mid) <= 2.0 ** -7 * mag).all() and (np.abs(lo) <= 2.0 ** -15 * mag).all()


@pytest.mark.parametrize("both", [False, True], ids=["bf16_by_float32", "float32_by_float32"])
def test_products_over_split_terms(both):
    """add_product (the bf16 kernels' products, g++ build) against float64
    s + a * b: a bf16 a against a float32 b's three terms, each product
    exact, three float32 additions (<= 2^-22 of |s| + |a b|); two float32
    operands' six largest cross terms, the three dropped and six additions
    (<= 2^-20 of |s| + |a b|)."""
    rng = np.random.default_rng(17)
    k = 10000
    s = rng.normal(0.0, 1.0, k).astype(np.float32)
    a = (rng.normal(0.0, 1.0, k) * np.exp2(rng.integers(-20, 20, k))).astype(np.float32)
    if not both:
        a = _bf16(a)
    b = (rng.normal(0.0, 1.0, k) * np.exp2(rng.integers(-20, 20, k))).astype(np.float32)
    out = np.empty(k, np.float32)
    _host_lib().cdrl_unit_product_host(s.ctypes.data, a.ctypes.data, b.ctypes.data, k, int(both),
                                       out.ctypes.data)
    s64, ab = s.astype(np.float64), a.astype(np.float64) * b.astype(np.float64)
    err = np.abs(out - (s64 + ab)) / (np.abs(s64) + np.abs(ab))
    assert err.max() <= 2.0 ** (-20 if both else -22), err.max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_host_build_bf16_matches_plain(shape):
    """The kernels' bf16 instantiation (g++) against the bf16 plain unit:
    inference, forward, statistics and backward, from the same bf16 x and
    output gradient; bf16 outputs and gx, float32 statistics and parameter
    gradients, dW1 and dW3 rounded to bf16."""
    n, h, w, c = SHAPES[shape]
    unit = _bf16_unit(c, seed=c)
    g = torch.Generator().manual_seed(c + 1)
    x = (3.0 * torch.rand((n, c, h, w), generator=g)).to(BF)
    gout = torch.randn((n, c, h, w), generator=g).to(BF)
    with torch.no_grad():
        unit.eval()
        got, want = _infer_host(x, unit), SU.shuffle_unit_infer_plain(x, unit)
    assert got.dtype == want.dtype == BF
    assert _rel(got.float(), want.float()) <= 1e-3
    out, stats, _, grads = _train_host(x, unit, gout)
    p_out, p_stats, p_grads = _plain_train(x, unit, gout)
    assert out.dtype == BF and stats.dtype == torch.float32
    assert grads[0].dtype == BF and grads[1].dtype == torch.float32
    for dw in (grads[1], grads[9], p_grads[1], p_grads[9]):
        assert torch.equal(dw, dw.to(BF).float())          # rounded to bf16
    assert _rel(out.float(), p_out.float()) <= 1e-3
    assert _rel(stats, p_stats) <= 1e-3
    _hold([t.float() for t in grads], [t.float() for t in p_grads], 1e-3, "host vs plain")


def _infer_bands_host(x: torch.Tensor, unit, rows) -> torch.Tensor:
    """bf16 inference as k_infer_bf16 computes it (g++ build), in bands of
    `rows` rows, or of the kernel's plan's ("plan")."""
    if rows == "plan":
        n, c, h, w = x.shape
        err, launch = _bf16_launch(n, c, h, w)
        assert err == 0
        rows = launch[1]
    args, out, _keep = SU._infer_args(x, unit)
    _host_lib().cdrl_unit_infer_bands_host(ctypes.byref(args), rows)
    return out


@pytest.mark.parametrize("rows", ["plan", 1, 2, 3, "taller"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_host_bf16_inference_bands_match_plain(shape, rows):
    """bf16 inference in bands of rows (g++ build of k_infer_bf16's
    arithmetic: each band's a1 from its rows and the halo rows inside the
    image, b2n on its rows) against the bf16 plain unit, relative L2 <=
    1e-3: the plan's band (the whole image at these sizes), bands of 1, 2
    and 3 rows (H = 5 and 4: the last band shorter at 2 and 3 rows), and
    one image in a band taller than it."""
    n, h, w, c = SHAPES[shape]
    rb = rows
    if rows == "taller":
        n, rb = 1, h + 3
    unit = _bf16_unit(c, seed=c + 7).eval()
    g = torch.Generator().manual_seed(c + 8)
    x = (3.0 * torch.rand((n, c, h, w), generator=g)).to(BF)
    with torch.no_grad():
        got, want = _infer_bands_host(x, unit, rb), SU.shuffle_unit_infer_plain(x, unit)
    assert got.dtype == BF
    assert _rel(got.float(), want.float()) <= 1e-3


@pytest.mark.parametrize("h, w, c", BAND_MAPS)
def test_host_bf16_inference_in_the_plans_bands_matches_plain(h, w, c):
    """At a map whose whole image no block holds, the host build's bf16
    inference (cdrl_unit_infer_host) walks the plan's bands, the last one
    shorter (10 rows then 3 with both panels; 2 rows then 1 with one), and
    matches the bf16 plain unit, relative L2 <= 1e-3."""
    n = 2
    err, (_, rb, nb, _, _) = _bf16_launch(n, c, h, w)
    assert err == 0 and 1 < nb and rb * nb > h
    unit = _bf16_unit(c, seed=c + 9).eval()
    g = torch.Generator().manual_seed(c + 10)
    x = (3.0 * torch.rand((n, c, h, w), generator=g)).to(BF)
    with torch.no_grad():
        got, want = _infer_host(x, unit), SU.shuffle_unit_infer_plain(x, unit)
    assert got.dtype == BF
    assert _rel(got.float(), want.float()) <= 1e-3


@pytest.fixture(scope="module")
def bf16_case():
    """One unit (Case's random parameters, N, H, W, C = 4, 5, 6, 16) and
    JAX's Pallas unit in interpret mode on its input rounded to bf16:
    inference, training forward and statistics, and jax.grad of sum(out *
    g) for g rounded to bf16."""
    shape = SHAPES["even"]
    n, h, w, c = shape
    rng = np.random.default_rng(c)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    g = rng.normal(0.0, 1.0, shape).astype(np.float32)
    junit = JUnit(num_channels=c, stride=1)
    v = junit.init(jax.random.PRNGKey(c), jnp.asarray(x), training=False)
    P = jax.tree_util.tree_map(np.asarray, v["params"])
    S = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    for i in range(3):
        bn, k = f"BatchNorm_{i}", P[f"BatchNorm_{i}"]["scale"].shape[0]
        P[bn] = dict(scale=rng.uniform(0.5, 1.5, k).astype(np.float32),
                     bias=rng.normal(0.0, 0.2, k).astype(np.float32))
        S[bn] = dict(mean=rng.normal(0.0, 0.3, k).astype(np.float32),
                     var=rng.uniform(0.5, 2.0, k).astype(np.float32))
    for conv in ("Conv_0", "Conv_1", "Conv_2"):
        P[conv]["bias"] = rng.normal(0.0, 0.1, P[conv]["bias"].shape).astype(np.float32)
    case = Case.__new__(Case)            # Case's layout helpers without its float32 runs
    case.c, case.P, case.S = c, P, S
    xb, gb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(_bf16(g))
    case.x, case.g = _bf16(x), np.asarray(gb)

    @jax.jit            # one compiled program for the three runs of the Pallas unit
    def ref(P, S, xb, gb):
        infer = sup.shuffle_unit_infer(xb, P, S, interpret=True)
        out, bst = sup.shuffle_unit_train(xb, P, interpret=True)

        def loss(p, xx):
            return jnp.sum(sup.shuffle_unit_train(xx, p, interpret=True)[0]
                           .astype(jnp.float32) * gb)

        gp, gx = jax.grad(loss, argnums=(0, 1))(P, xb)
        stats = jnp.stack([bst[f"BatchNorm_{i}"][m] for i in range(3) for m in ("mean", "var")])
        return infer, out, stats, gp, gx

    infer, out, stats, gp, gx = ref(P, S, xb, gb)
    assert out.dtype == jnp.bfloat16 and infer.dtype == jnp.bfloat16
    case.infer = np.asarray(infer.astype(jnp.float32))
    case.train = np.asarray(out.astype(jnp.float32))
    case.stats = np.asarray(stats)
    case.grads = case._grads((jax.tree_util.tree_map(np.asarray, gp),
                              gx.astype(jnp.float32)))
    return case


def test_plain_bf16_unit_matches_jax(bf16_case):
    """The bf16 plain unit against JAX's Pallas unit with cd = bfloat16:
    inference, training output, batch statistics and every gradient,
    relative L2 <= 1e-2."""
    case = bf16_case
    unit = case.port_unit(fused=True)
    x, g = _nchw(case.x).to(BF), _nchw(case.g).to(BF)
    with torch.no_grad():
        infer = SU.shuffle_unit_infer_plain(x, unit.eval())
    assert _rel(infer.float(), _nchw(case.infer)) <= 1e-2
    out, stats, grads = _plain_train(x, unit, g)
    assert _rel(out.float(), _nchw(case.train)) <= 1e-2
    assert _rel(stats, case.stats) <= 1e-2
    _hold([t.float() for t in grads], case.grads, 1e-2, "plain bf16 vs JAX")


@pytest.mark.parametrize("rows", ["plan", 2])
def test_host_bf16_inference_bands_match_jax(bf16_case, rows):
    """bf16 inference in the plan's band and in bands of 2 rows (g++ build
    of k_infer_bf16's arithmetic) against JAX's Pallas unit with cd =
    bfloat16 in interpret mode, relative L2 <= 1e-2."""
    case = bf16_case
    unit = case.port_unit(fused=True).eval()
    with torch.no_grad():
        got = _infer_bands_host(_nchw(case.x).to(BF), unit, rows)
    assert _rel(got.float(), _nchw(case.infer)) <= 1e-2


@pytest.fixture(scope="module")
def nets():
    """A seeded port network, its running statistics of real activations,
    and JAX's bf16 network with its trees (float32 parameters): JAX's bf16
    inference-mode heads on a batch, the port's float32 ones (JAX's own, to
    1e-5), and JAX's policy and value heads' bf16 gradients in training mode
    on a random float32 feature."""
    net = CARLANetwork(**TINY_NET)
    init_flax_(net, torch.Generator().manual_seed(11))
    net.update_old_policy()
    rng = np.random.default_rng(4)
    mb = 8
    a = rng.uniform(0.05, 0.95, (mb, 2)).astype(np.float32)
    batch = dict(obs=dict(state_image=rng.uniform(0, 1, (mb, T, H, W, 3)).astype(np.float32),
                          state_road=rng.uniform(0, 1, (mb, T, 9)).astype(np.float32),
                          state_vehicle=rng.uniform(0, 1, (mb, T, 4)).astype(np.float32),
                          state_navigation=rng.uniform(0, 3, (mb, T, 5)).astype(np.float32),
                          action=a),
                 advantages=rng.normal(0, 1, mb).astype(np.float32),
                 returns=np.stack([rng.uniform(-1, 1, mb), rng.integers(0, 4, mb)],
                                  -1).astype(np.float32),
                 log_prob=(np.log(a) - 0.3).astype(np.float32),
                 speed=rng.uniform(0, 0.5, mb).astype(np.float32),
                 similarity=rng.uniform(0.5, 1, mb).astype(np.float32))
    # running statistics of real activations (a float32 training-mode pass
    # of the batch folded at momentum 0): at init (mean 0, variance 1) the
    # backbone's exit BatchNorm and activation zero its output, which would
    # leave the image path out of the comparison
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.momentum = 0.0
    with torch.no_grad():
        obs = {k: torch.from_numpy(v) for k, v in batch["obs"].items()}
        feat = net.dynamics_apply(obs, training=True)
        net.policy_apply(feat, training=True), net.value_apply(feat, training=True)
    for m in bns:
        del m.momentum
    _, params, stats = jax_trees(net, jnp.float32)
    jnet = JNet(**TINY_NET, compute_dtype=jnp.bfloat16)
    js = _jself(jnet)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    # the heads' training-mode input: a feature of the dynamics' scale
    tfeat = jnp.asarray(np.random.default_rng(5).normal(0, 1, (mb, 64)).astype(np.float32))

    @jax.jit
    def ref(params, stats, batch):
        feat, _ = jnet.dynamics_apply(params, stats, batch["obs"])
        pol, _ = jnet.policy_apply(params, stats, feat, old=True)
        val, _ = jnet.value_apply(params, stats, feat)
        heads = dict(alpha=pol["dist"].alpha, beta=pol["dist"].beta, value=val["value"],
                     speed=pol["speed"], similarity=pol["similarity"])

        def p_loss(p):
            return js._policy_objective(dict(params, policy=p), stats, tfeat, batch, HYPER,
                                        jax.random.PRNGKey(0))[0]

        def v_loss(p):
            return js._value_objective(dict(params, value=p), stats, tfeat, batch)[0]

        grads = dict(policy=jax.grad(p_loss)(params["policy"]),
                     value=jax.grad(v_loss)(params["value"]))
        return heads, grads

    heads, grads = ref(params, stats, jb)
    # float32 heads: the port's float32 network, which computes JAX's to
    # 1e-5 (test_torch_learner.py::test_params_from_jax_init_round_trip)
    with torch.no_grad():
        obs = {k: torch.from_numpy(v) for k, v in batch["obs"].items()}
        feat32 = net.dynamics_apply(obs)
        pol, val = net.policy_apply(feat32, old=True), net.value_apply(feat32)
    heads32 = dict(alpha=pol["dist"].alpha, beta=pol["dist"].beta, value=val["value"],
                   speed=pol["speed"], similarity=pol["similarity"])
    heads32 = {k: v.numpy() for k, v in heads32.items()}
    return params, stats, batch, (heads, heads32), np.array(tfeat), grads


@pytest.mark.parametrize("fused_units", [False, True])
def test_bf16_network_heads_match_jax(nets, fused_units):
    """A bf16 port network loads the JAX trees (params_from_jax needs no new
    mapping: float32 parameters) and computes JAX's bf16 network's heads in
    inference mode, on running statistics of real activations.  Each head
    is held to relative L2 2e-2, or where JAX's own bf16 network lies
    further from its float32 one, to a share of that distance: a quarter
    unfused (measured <= 0.11 of it); with fused units, whose stride-1
    units round at the JAX unit kernel's points and not at the unfused flax
    path's that the JAX network here takes, within that distance (measured
    <= 0.86 of it; the unit itself is held to JAX's bf16 Pallas unit in
    test_plain_bf16_unit_matches_jax).  The distance is 0.08-0.5 on this
    tiny random network, whose near-constant channels amplify bf16
    rounding through its BatchNorms."""
    params, stats, batch, (heads, heads32), _, _ = nets
    share = 1.0 if fused_units else 0.25
    net = CARLANetwork(**TINY_NET, compute_dtype=BF, fused_units=fused_units)
    net.load_state_dict(params_from_jax(params, stats), strict=True)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    obs = {k: torch.from_numpy(v) for k, v in batch["obs"].items()}
    with torch.no_grad():
        feat = net.dynamics_apply(obs)
        pol, val = net.policy_apply(feat, old=True), net.value_apply(feat)
    assert feat.dtype == torch.float32
    got = dict(alpha=pol["dist"].alpha, beta=pol["dist"].beta, value=val["value"],
               speed=pol["speed"], similarity=pol["similarity"])
    for k, v in got.items():
        assert v.dtype == torch.float32, k
        bar = max(2e-2, share * _rel(heads[k], heads32[k]))
        assert _rel(v.numpy(), heads[k]) <= bar, (k, _rel(v.numpy(), heads[k]), bar)


def test_bf16_learner_step(env, nets):
    """The policy and value heads' bf16 gradients on a float32 feature in
    training mode against JAX's (relative L2 <= 5e-2 per tensor); then the
    port's whole bf16 policy and value steps: float32 parameters, Adam
    states and running statistics, every value finite, every group moved."""
    params, stats, batch, _, tfeat, grads = nets
    agent = CARLAgent(env, CARLAgentConfig(network=TINY_NET, compute_dtype="bfloat16"),
                      weights_dir="unused")
    agent.network.load_state_dict(params_from_jax(params, stats), strict=True)
    net = agent.network
    tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.from_numpy(v)) for k, v in batch.items()}
    feat = torch.from_numpy(np.array(tfeat))
    names = {id(p): n for n, p in net.named_parameters()}
    p_loss, _ = agent._policy_objective(net.policy_apply(feat, training=True), tb, HYPER)
    v_loss, _ = agent._value_objective(net.value_apply(feat, training=True), tb)
    for group, loss in (("policy", p_loss), ("value", v_loss)):
        want = params_from_jax(dict(params, **{group: grads[group]},
                                    **({"old_policy": grads[group]} if group == "policy"
                                       else {})), stats)
        for p, g in zip(agent.params[group], agent._grads(loss, (group,))[group]):
            assert _rel(g.numpy(), want[names[id(p)]].numpy()) <= 5e-2, names[id(p)]
    before = {k: v.clone() for k, v in net.state_dict().items()}
    agent.policy_step(tb, HYPER)
    agent.value_step(tb)
    after = net.state_dict()
    for k, v in after.items():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), k
    for group in ("policy.", "value.", "dynamics."):
        assert any(not torch.equal(after[k], before[k]) for k in after if k.startswith(group))
    for opt in agent.optimizers.values():
        for st in opt.state.values():
            assert st["exp_avg"].dtype == torch.float32
