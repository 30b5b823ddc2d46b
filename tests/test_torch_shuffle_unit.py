"""The port's fused stride-1 ShuffleNet unit (ops/shuffle_unit.py) against
the JAX package on the CPU: its plain versions and the CUDA kernels' own
arithmetic (csrc/shuffle_unit.cuh built with g++, the `_*_host` helpers),
against JAX `shuffle_unit_infer` / `shuffle_unit_train` with interpret=True
(the Pallas kernels, as tests/test_shuffle_halo.py runs them) and against
the flax `ShuffleUnit`, at N, H, W, C = 4, 5, 6, 16 and at a shape whose
half width C/2 = 9 is odd.  Parameters (random BatchNorm scales, biases and
running statistics, random conv biases) go across through
utils/checkpoint.params_from_jax.

Tolerances (float32): outputs and batch statistics 1e-5 absolute (values
of order 1-6; one unit's sums in another order); gradients 1e-4 relative
per tensor (its max |diff| over its max |value|; the backward's plain
version and the host build take the same steps of the activation's
gradient as each other, from the same saved tensors), except the four tensors
whose true gradient is zero (the conv biases Conv_0, Conv_1, Conv_2 and
BatchNorm_1's bias, each followed by a training-mode BatchNorm, BN2
through the linear W3): their gradients are rounding noise of ~1e-6
against ~10-60 for the others, and are held absolutely, to 1e-5 of the
unit's largest gradient.  The float64 instantiation of the host build is
held to the plain version in float64 at 1e-10.  The `cuda`-marked test
holds the kernels against the plain versions on the card and skips here;
so does the one that holds bf16 inference's kernel (k_infer_bf16) at whole
images and at bands of rows (BAND_MAPS), whose band plan (`_bf16_launch`)
and arithmetic in bands (tests/test_torch_bf16.py) the CPU tests hold
through the g++ build.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.models.shufflenet import ShuffleUnit as JUnit
from carla_driving_rl_agent_tpu.models.shufflenet import channel_shuffle as jshuffle
from carla_driving_rl_agent_tpu.ops import shuffle_unit_pallas as sup

from carla_driving_rl_agent_torch.models.shufflenet import ShuffleUnit, channel_shuffle
from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
from carla_driving_rl_agent_torch.utils.build import csrc, load_library
from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

SHAPES = {"even": (4, 5, 6, 16), "odd": (3, 4, 7, 18)}
NAMES = ("x",) + SU.UnitOperands._fields
NOISE = ("b1", "dwb", "be2", "b3")
ATOL = 1e-5


def _host_lib() -> ctypes.CDLL:
    """The kernels' arithmetic built with g++ (csrc/shuffle_unit_host.cpp)."""
    sig = (None, [ctypes.POINTER(SU._Args), ctypes.c_int])
    sigs = {f"{f}_host": sig for f in ("cdrl_unit_infer", "cdrl_unit_train_fwd",
                                       "cdrl_unit_train_bwd")}
    sigs["cdrl_unit_merge_host"] = (None, [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    sigs["cdrl_unit_plan_host"] = (ctypes.c_int, [ctypes.c_int] * 5 + [ctypes.POINTER(SU._Plan)])
    sigs["cdrl_unit_infer_launch_host"] = (ctypes.c_int, [ctypes.c_int] * 6 + [ctypes.c_void_p])
    sigs["cdrl_unit_train_launch_host"] = (ctypes.c_int, [ctypes.c_int] * 6 + [ctypes.c_void_p])
    sigs["cdrl_unit_infer_bf16_launch_host"] = (ctypes.c_int,
                                                [ctypes.c_int] * 5 + [ctypes.c_void_p])
    sigs["cdrl_unit_infer_bands_host"] = (None, [ctypes.POINTER(SU._Args), ctypes.c_int])
    sigs["cdrl_unit_split_host"] = (None, [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3)
    sigs["cdrl_unit_product_host"] = (None, [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                                                      ctypes.c_void_p])
    return load_library(
        "shuffle_unit_host", [csrc("shuffle_unit_host.cpp")], "g++", sigs,
        extra_deps=[csrc("shuffle_unit.cuh")], extra_flags=["-ffp-contract=off"])


SMS = 132       # the H100's streaming multiprocessors


def _plan_host(n: int, c: int, h: int, w: int):
    """(PlanError, the kernels' plan) of a unit of c channels at n x h x w
    on the H100, through the g++ build of shuffle_unit.cuh `make_plan`."""
    pl = SU._Plan()
    return _host_lib().cdrl_unit_plan_host(n, c, h, w, SMS, ctypes.byref(pl)), pl


def _host_scratch(x: torch.Tensor):
    """SU._scratch's (partials, counters) at x's shape on the H100."""
    err, pl = _plan_host(*x.shape)
    SU._refuse(err, x.shape)
    return pl.partial, pl.n_counters


def _infer_host(x: torch.Tensor, unit) -> torch.Tensor:
    """The inference kernel's arithmetic on CPU tensors, through the
    wrappers' operand checks."""
    args, out, _keep = SU._infer_args(x, unit)
    _host_lib().cdrl_unit_infer_host(ctypes.byref(args), SU._DTYPES[x.dtype])
    return out


def _train_host(x: torch.Tensor, unit, gout: torch.Tensor):
    """The forward and backward kernels' arithmetic on CPU tensors: (out,
    stats, saved (z1, z2, u), gradients in shuffle_unit_train_bwd's order)."""
    ops = SU.UnitOperands(*(t.detach() for t in SU.unit_operands(unit)))
    args, out, stats, saved, _keep = SU._fwd_args(x, ops, unit.leak, _host_scratch(x))
    _host_lib().cdrl_unit_train_fwd_host(ctypes.byref(args), SU._DTYPES[x.dtype])
    args, grads, _keep = SU._bwd_args(x, gout, ops, unit.leak, stats, saved, _host_scratch(x))
    _host_lib().cdrl_unit_train_bwd_host(ctypes.byref(args), SU._DTYPES[x.dtype])
    return out, stats, saved, grads


def _autograd_grads(x: torch.Tensor, unit, gout: torch.Tensor) -> tuple:
    """The gradients of x and of the 12 operands through autograd of the
    plain training forward."""
    xr = x.detach().requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in SU.unit_operands(unit)]
    out = SU._plain(xr, SU.UnitOperands(*leaves), unit.leak)[0]
    return torch.autograd.grad(out, [xr] + leaves, gout)


def _to_torch_unit(params, stats, c, **kw) -> ShuffleUnit:
    """A port ShuffleUnit holding a flax unit's trees (through
    params_from_jax, under a dummy network path)."""
    wrap = lambda t: {"dynamics": {"U": t}, "policy": {}, "old_policy": {}, "value": {}}
    sd = params_from_jax(wrap(params), {"dynamics": {"U": stats}, "policy": {}, "value": {}})
    unit = ShuffleUnit(c, c, 1, **kw)
    unit.load_state_dict({k[len("dynamics.U."):]: v for k, v in sd.items()}, strict=True)
    return unit


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


class Case:
    """One unit and its JAX references (computed once per shape)."""

    def __init__(self, shape):
        n, h, w, c = shape
        rng = np.random.default_rng(c)
        self.c = c
        self.x = rng.normal(0.0, 1.0, shape).astype(np.float32)
        self.g = rng.normal(0.0, 1.0, shape).astype(np.float32)
        unit = JUnit(num_channels=c, stride=1)
        v = unit.init(jax.random.PRNGKey(c), jnp.asarray(self.x), training=False)
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
        self.P, self.S, self.unit = P, S, unit
        x, g = jnp.asarray(self.x), jnp.asarray(self.g)
        # JAX references: the Pallas kernels in interpret mode, and flax
        self.infer_kernel = np.asarray(sup.shuffle_unit_infer(x, P, S, interpret=True))
        self.infer_flax = np.asarray(unit.apply({"params": P, "batch_stats": S}, x,
                                                training=False))
        out, bst = sup.shuffle_unit_train(x, P, interpret=True)
        self.train_kernel = np.asarray(out)
        self.stats_kernel = np.stack([np.asarray(bst[f"BatchNorm_{i}"][m])
                                      for i in range(3) for m in ("mean", "var")])
        out, mut = unit.apply({"params": P, "batch_stats": S}, x, training=True,
                              mutable=["batch_stats"])
        self.train_flax = np.asarray(out)
        self.folded_flax = jax.tree_util.tree_map(np.asarray, mut["batch_stats"])

        def loss_kernel(p, xx):
            return jnp.sum(sup.shuffle_unit_train(xx, p, interpret=True)[0] * g)

        def loss_flax(p, xx):
            y, _ = unit.apply({"params": p, "batch_stats": S}, xx, training=True,
                              mutable=["batch_stats"])
            return jnp.sum(y * g)

        self.grads_kernel = self._grads(jax.grad(loss_kernel, argnums=(0, 1))(P, x))
        self.grads_flax = self._grads(jax.grad(loss_flax, argnums=(0, 1))(P, x))

    def _grads(self, gp_gx):
        """JAX (param grads, x grad) -> a tuple in NAMES order, the port's
        layouts."""
        gp, gx = gp_gx
        holder = _to_torch_unit(jax.tree_util.tree_map(np.asarray, gp), self.S, self.c)
        return (_nchw(gx),) + tuple(t.detach().clone() for t in SU.unit_operands(holder))

    def port_unit(self, **kw) -> ShuffleUnit:
        return _to_torch_unit(self.P, self.S, self.c, **kw)


@pytest.fixture(scope="module", params=sorted(SHAPES))
def case(request):
    return Case(SHAPES[request.param])


def _hold_grads(got, ref, what):
    top = max(float(r.abs().max()) for r in ref)
    for name, a, b in zip(NAMES, got, ref):
        a, b = a.detach().double(), b.double()
        assert a.shape == b.shape, (what, name)
        err = float((a - b).abs().max())
        if name in NOISE:
            assert float(b.abs().max()) < 1e-6 * top, (what, name, "is not noise")
            assert err <= 1e-5 * top, (what, name, err, top)
        else:
            assert err <= 1e-4 * float(b.abs().max()), (what, name, err, float(b.abs().max()))


@pytest.mark.parametrize("c", [16, 18, 116, 232, 464, 14])
def test_shuffle_destination_map(c):
    """Concat channel i lands at (i % 2) * c/2 + i // 2, for even and odd
    c/2, in the port's channel_shuffle, the plain unit's shuffle and JAX's
    map and channel_shuffle."""
    hc = c // 2
    x = torch.arange(c, dtype=torch.float32).view(1, c, 1, 1)
    for out in (channel_shuffle(x), SU._shuffle(x[:, :hc], x[:, hc:])):
        for i in range(c):
            assert int(out[0, (i % 2) * hc + i // 2, 0, 0]) == i
    j = np.asarray(jshuffle(jnp.arange(c, dtype=jnp.float32).reshape(1, 1, 1, c)))[0, 0, 0]
    np.testing.assert_array_equal(j, channel_shuffle(x)[0, :, 0, 0].numpy())
    dest = np.asarray(sup._shuffle_dest(c, jnp.arange(c)))
    np.testing.assert_array_equal(dest, [(i % 2) * hc + i // 2 for i in range(c)])


def test_infer_matches_jax(case):
    unit = case.port_unit(fused=True).eval()
    x = _nchw(case.x)
    with torch.no_grad():
        plain = SU.shuffle_unit_infer_plain(x, unit)
        module = unit(x)
        host = _infer_host(x, unit)
    for name, got in (("plain", plain), ("module", module), ("host", host)):
        for ref in (case.infer_kernel, case.infer_flax):
            np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), rtol=0, atol=ATOL,
                                       err_msg=name)


def test_train_forward_stats_and_fold_match_jax(case):
    unit = case.port_unit(fused=True).train()
    x = _nchw(case.x)
    with torch.no_grad():
        out, stats = SU.shuffle_unit_train_plain(x, unit)
        module = unit(x)            # folds the batch statistics once
    for got in (out, module):
        for ref in (case.train_kernel, case.train_flax):
            np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), rtol=0, atol=ATOL)
    assert stats.shape == (6, case.c // 2)
    np.testing.assert_allclose(stats.numpy(), case.stats_kernel, rtol=0, atol=ATOL)
    for i in range(3):
        bn = getattr(unit, f"BatchNorm_{i}")
        for buf, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), case.folded_flax[f"BatchNorm_{i}"][key],
                                       rtol=0, atol=1e-6, err_msg=f"BatchNorm_{i} {key}")


def test_gradients_match_jax(case):
    """The plain unit's autograd gradients of x and all 12 parameter
    tensors, through the module in training mode, against jax.grad of the
    Pallas training kernel's custom_vjp and of the flax unit."""
    unit = case.port_unit(fused=True).train()
    x = _nchw(case.x).requires_grad_(True)
    out = unit(x)
    ops = SU.unit_operands(unit)
    torch.sum(out * _nchw(case.g)).backward()
    got = (x.grad,) + tuple(SU.unit_operands(_GradView(unit)))
    assert len(ops) == 12
    for ref, what in ((case.grads_kernel, "kernel"), (case.grads_flax, "flax")):
        _hold_grads(got, ref, what)
    # the backward kernel's plain version, from the plain forward's saved
    # tensors
    ops = SU.UnitOperands(*(t.detach() for t in ops))
    _, stats, saved = SU._plain(_nchw(case.x), ops, 0.0)
    plain = SU.shuffle_unit_train_bwd_plain(_nchw(case.x), _nchw(case.g), ops, 0.0, stats, saved)
    _hold_grads(plain, case.grads_kernel, "shuffle_unit_train_bwd_plain")


class _GradView:
    """A stand-in unit whose tensors are another unit's .grad, so that
    unit_operands() lays the gradients out as the operands."""

    def __init__(self, unit):
        for name in ("Conv_0", "Conv_1", "Conv_2", "BatchNorm_0", "BatchNorm_1",
                     "BatchNorm_2"):
            mod = getattr(unit, name)
            setattr(self, name, type("G", (), dict(weight=mod.weight.grad, bias=mod.bias.grad)))


def test_host_build_matches_jax(case):
    """The kernels' arithmetic (g++ build of csrc/shuffle_unit.cuh): the
    training forward, its batch statistics and the backward."""
    unit = case.port_unit()
    x, g = _nchw(case.x), _nchw(case.g)
    out, stats, saved, grads = _train_host(x, unit, g)
    np.testing.assert_allclose(out.numpy(), _nchw(case.train_kernel).numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(stats.numpy(), case.stats_kernel, rtol=0, atol=ATOL)
    _hold_grads(grads, case.grads_kernel, "host")
    _hold_grads(grads, case.grads_flax, "host vs flax")
    ops = SU.UnitOperands(*(t.detach() for t in SU.unit_operands(unit)))
    _hold_grads(grads, SU.shuffle_unit_train_bwd_plain(x, g, ops, 0.0, stats, saved),
                "host vs plain")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_host_build_float64_matches_plain(shape):
    """The kernels' float64 instantiation against the plain version in
    float64 (the precision train_agree holds the fused update to)."""
    n, h, w, c = SHAPES[shape]
    g = torch.Generator().manual_seed(c)
    unit = ShuffleUnit(c, c, 1).double()
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64) * 0.3)
        for i in range(3):
            bn = getattr(unit, f"BatchNorm_{i}")
            bn.weight.add_(1.0)
            bn.running_mean.normal_(0.0, 0.3, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
    x = torch.randn((n, c, h, w), generator=g, dtype=torch.float64)
    gout = torch.randn((n, c, h, w), generator=g, dtype=torch.float64)
    with torch.no_grad():
        infer = _infer_host(x, unit)
        infer_ref = SU.shuffle_unit_infer_plain(x, unit)
        ref_out, ref_stats = SU.shuffle_unit_train_plain(x, unit)
    torch.testing.assert_close(infer, infer_ref, rtol=0, atol=1e-10)
    out, stats, _, grads = _train_host(x, unit, gout)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=1e-10)
    torch.testing.assert_close(stats, ref_stats, rtol=0, atol=1e-10)
    ref = _autograd_grads(x, unit, gout)
    top = max(float(r.abs().max()) for r in ref)
    for name, a, b in zip(NAMES, grads, ref):
        assert float((a - b).abs().max()) <= 1e-10 * top, name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("p, per_block", [(1000, 64), (1001, 37), (4096, 100), (333, 333)])
def test_block_order_merge_matches_two_pass(p, per_block, dtype):
    """The batch statistics' reduction of the kernels (shuffle_unit.cuh:
    Welford within a block, the blocks' moments merged in block order by
    merge_blocks) through the g++ build, against a two-pass float64 mean and
    biased variance: 16, 28, 41 and 1 blocks, the last ragged in the first
    three.  The values sit at 100 + N(3, 0.5), where a one-pass E[z^2] - m^2
    in float32 is off by 3e-3 to 6e-2 of the variance; the bars are
    float32's rounding (mean 1e-6, variance 1e-5 relative) and 1e-12 in
    float64."""
    rng = np.random.default_rng(p)
    v = (100.0 + rng.normal(3.0, 0.5, p)).astype(dtype)
    mean, var = np.zeros(1, dtype), np.zeros(1, dtype)
    _host_lib().cdrl_unit_merge_host(v.ctypes.data, p, per_block, int(dtype == "float64"),
                                     mean.ctypes.data, var.ctypes.data)
    ref = v.astype(np.float64)
    ref_mean = ref.mean()
    ref_var = ((ref - ref_mean) ** 2).mean()
    tol = (1e-6, 1e-5) if dtype == "float32" else (1e-12, 1e-12)
    assert abs(float(mean[0]) - ref_mean) <= tol[0] * abs(ref_mean)
    assert abs(float(var[0]) - ref_var) <= tol[1] * ref_var


def test_wrappers_check_their_operands():
    unit = ShuffleUnit(16, 16, 1)
    x = torch.randn(2, 16, 5, 6)
    with pytest.raises(ValueError, match="contiguous"):
        _infer_host(x.transpose(2, 3).contiguous().transpose(2, 3), unit)
    with pytest.raises(TypeError):
        _infer_host(x.half(), unit)
    with pytest.raises(TypeError):
        _infer_host(x.double(), unit)          # unit is float32
    with pytest.raises(ValueError):
        _infer_host(torch.randn(2, 15, 5, 6), unit)
    with pytest.raises(ValueError, match="CUDA"):
        SU.shuffle_unit_train_bwd(x, x, SU.unit_operands(unit), 0.0, torch.zeros(6, 8),
                                  (x, x, x))
    with pytest.raises(ValueError):
        SU.shuffle_unit_infer(x.to("meta"), unit)


# the batch sizes the backbone's units see: a rollout predict or an
# evaluation (4 frames of each of 1-128 worlds), a training minibatch
# (4 frames of each of 32-128 samples), chip_smoke.py's three, and a tiny one
PLAN_N = sorted({4 * k for k in range(1, 129)} | {248, 256, 3})
# the kernels' constants (shuffle_unit.cuh): pixels per product tile, per
# weight-gradient chunk, the side of a weight-gradient tile, the most blocks
# one merge reads, a depthwise stage's pixels per pass and thread
PTILE, WCHUNK, WTILE, PGROUP, CH_OWN, CH_FILL = 64, 32, 64, 16, 8, 12


MAPS = [(11, 45, 116), (6, 23, 232), (3, 12, 464), (4, 7, 18)]


def _assert_plan_covers(n: int, h: int, w: int, c: int) -> None:
    """The plan takes the shape; the blocks cover every pixel tile, image
    and chunk once; the merges and tickets stay within the kernels' limits
    (16 blocks per merge, so at most 16 x 16 product blocks; 256 channels;
    2048 weight-gradient counters); the scratch holds every stage's
    partials; and one depthwise pass holds at least one image."""
    hc, p = c // 2, n * h * w
    err, pl = _plan_host(n, c, h, w)
    assert err == 0
    tiles, chunks = -(-p // PTILE), -(-p // WCHUNK)
    assert (pl.n_pb - 1) * pl.tpb < tiles <= pl.n_pb * pl.tpb
    assert (pl.n_s - 1) * pl.ipb < n <= pl.n_s * pl.ipb and pl.n_s <= PGROUP
    assert (pl.nseg - 1) * pl.cps < chunks <= pl.nseg * pl.cps
    groups = -(-pl.nseg // pl.gsz)
    wtiles = -(-hc // WTILE) ** 2
    assert pl.n_pb <= PGROUP ** 2 and 2 * wtiles * (groups + 1) <= 2048
    assert pl.n_counters == 4096
    assert pl.partial >= max(3 * hc * (pl.n_pb + -(-pl.n_pb // PGROUP)),
                             12 * hc * pl.n_s,
                             2 * wtiles * (pl.nseg + groups) * WTILE ** 2)
    per_pass = min(CH_OWN * 256 // (h * w), CH_FILL * 256 // ((h + 2) * (w + 2)))
    assert per_pass >= 1


@pytest.mark.parametrize("n", [256, 248, 128, 3])
@pytest.mark.parametrize("h, w, c", MAPS)
def test_plan_covers_the_unit(n, h, w, c):
    """The kernels' split of a call (shuffle_unit.cuh `make_plan`, g++
    build) at the backbone's stride-1 maps and a small one, at chip_smoke.py's
    three batch sizes and a tiny one."""
    _assert_plan_covers(n, h, w, c)


@pytest.mark.parametrize("h, w, c", MAPS)
def test_plan_takes_every_batch_of_the_backbone(h, w, c):
    """The same at every batch size in PLAN_N."""
    for n in PLAN_N:
        _assert_plan_covers(n, h, w, c)


SMEM_LIMIT = 232448    # the H100's dynamic shared memory per block, opted into


@pytest.mark.parametrize("h, w, c", MAPS)
def test_plan_covers_the_inference_stages(h, w, c):
    """The inference kernel's three launches (shuffle_unit.cu `infer`, the
    g++ build of their sizes) at every batch in PLAN_N, in float32 and
    float64: the two 1x1 products' blocks cover every 64-pixel tile of every
    64-channel tile once, the depthwise stage (its own split: it merges no
    statistic) has a block per channel and run of images covering every
    image, each fits the card's shared
    memory, and one depthwise pass holds at least one image."""
    hc = c // 2
    for n in PLAN_N:
        err, pl = _plan_host(n, c, h, w)
        assert err == 0
        tiles = -(-n * h * w // PTILE)
        for tsize in (4, 8):
            out = np.zeros(4, np.int64)
            assert _host_lib().cdrl_unit_infer_launch_host(n, c, h, w, SMS, tsize,
                                                           out.ctypes.data) == 0
            pw_blocks, dw_blocks, pw_smem, dw_smem = (int(v) for v in out)
            assert pw_blocks == -(-hc // 64) * pl.n_pb
            assert (pl.n_pb - 1) * pl.tpb < tiles <= pl.n_pb * pl.tpb
            assert dw_blocks == pl.n_si * hc and (pl.n_si - 1) * pl.ipi < n <= pl.n_si * pl.ipi
            assert 0 < pw_smem <= SMEM_LIMIT and 0 < dw_smem <= SMEM_LIMIT, (n, tsize)
        assert min(CH_OWN * 256 // (h * w), CH_FILL * 256 // ((h + 2) * (w + 2))) >= 1


SM_SHARED = 233472     # the H100's shared memory per SM
BLOCK_RESERVED = 1024  # the shared memory the card keeps for each resident block


@pytest.mark.parametrize("dtype", [0, 1, 2], ids=["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("h, w, c", MAPS)
def test_plan_covers_the_training_stages(h, w, c, dtype):
    """The training forward's and backward's launches (shuffle_unit.cu
    `train_fwd`, `train_bwd`, the g++ build of their sizes) at every batch
    in PLAN_N: the 1x1 products and the weight gradients cover their tiles,
    every block's shared memory fits the card's opt-in limit, and in float32
    and in bfloat16 (the tensor-core layout: bf16 panel and pixel operand,
    three tiles of g_u's split terms in PW3_BACK; the weight gradients'
    float32 ring and two buffers of split tiles) two product blocks and two weight-gradient
    blocks fit one SM, as the plan assumes."""
    hc = c // 2
    kpad = -(-hc // 32) * 32
    rest = 4 * (64 * 68 + 7 * hc + 5 * 64) + 4 * 64 * 4
    for n in PLAN_N:
        err, pl = _plan_host(n, c, h, w)
        assert err == 0
        out = np.zeros(10, np.int64)
        assert _host_lib().cdrl_unit_train_launch_host(n, c, h, w, SMS, dtype,
                                                       out.ctypes.data) == 0
        pw_blocks, ch_blocks, *pw_smem = (int(v) for v in out[:6])
        dw_fwd, dw_bwd, wg_blocks, wg_smem = (int(v) for v in out[6:])
        assert pw_blocks == -(-hc // 64) * pl.n_pb and ch_blocks == pl.n_s * hc
        assert wg_blocks == 2 * (-(-hc // WTILE)) ** 2 * pl.nseg
        for smem in pw_smem + [dw_fwd, dw_bwd, wg_smem]:
            assert 0 < smem <= SMEM_LIMIT, (n, dtype, smem)
        if dtype == 2:
            assert pw_smem == [2 * (kpad * 72 + 2 * t * 32 * 72) + rest for t in (1, 1, 3, 1)]
            assert wg_smem == 4 * 2 * 3 * 64 * 32 + 2 * 2 * 6 * 64 * 40
        if dtype != 1:
            for smem in pw_smem + [wg_smem]:
                assert 2 * (smem + BLOCK_RESERVED) <= SM_SHARED, (n, dtype, smem)


def _parent_inference_plan(n: int, c: int, h: int, w: int) -> tuple:
    """(tpb, n_pb, ipi, n_si) of the float32 and float64 inference stages as
    make_plan computed them before bf16 inference had a kernel of its own."""
    hc, tiles = c // 2, -(-n * h * w // PTILE)
    tpb = max(-(-tiles * -(-hc // 64) // (2 * SMS)), -(-tiles // PGROUP ** 2), 1)
    per_pass = min(CH_OWN * 256 // (h * w), CH_FILL * 256 // ((h + 2) * (w + 2)), n)
    ipi = min(2 * per_pass, n)
    return tpb, -(-tiles // tpb), ipi, -(-n // ipi)


def _ldsm_pitch(v: int) -> int:
    e = -(-v // 8)
    return 8 * (e if e % 2 else e + 1)


def _infer_bf16_bytes(hc: int, h: int, w: int, rb: int, panels: int) -> int:
    """k_infer_bf16's dynamic shared memory (shuffle_unit.cuh `infer_layout`):
    the bf16 panels, the pixel operand of the halo-extended band (pixel
    columns a multiple of 8), a1's zero-padded float32 planes (or, where
    larger, the staging of x's and the shortcut's rows: the aligned 16-byte
    pieces that hold them), 24 constants per channel and the two pixel
    tables (int16), the first three regions on 16 bytes."""
    a16 = lambda v: -(-v // 16) * 16
    kpad = -(-hc // 16) * 16
    xcols = -(-min(rb + 2, h) * w // 8) * 8
    x_off = a16(panels * kpad * _ldsm_pitch(kpad) * 2)
    a_off = a16(x_off + kpad * _ldsm_pitch(xcols) * 2)
    staged = hc * (a16(2 * min(rb + 2, h) * w + 31) + a16(2 * rb * w + 31))
    c_off = a16(a_off + max(hc * (rb + 2) * (w + 2) * 4, staged))
    return c_off + 4 * 24 * hc + 2 * (xcols + rb * w)


def _bf16_launch(n: int, c: int, h: int, w: int):
    """(PlanError, [blocks, rows per band, bands per image, panels, shared
    memory]) of k_infer_bf16 (512 threads a block) through the g++ build."""
    out = np.zeros(5, np.int64)
    err = _host_lib().cdrl_unit_infer_bf16_launch_host(n, c, h, w, SMS, out.ctypes.data)
    return err, [int(v) for v in out]


# maps whose whole image no block's shared memory holds: bands of 10 rows,
# the last of 3, both panels; bands of 2 rows, the last of 1, one panel
BAND_MAPS = [(13, 45, 116), (7, 12, 464)]


@pytest.mark.parametrize("h, w, c", MAPS + BAND_MAPS)
def test_plan_covers_the_bf16_inference_bands(h, w, c):
    """bf16 inference's one launch (shuffle_unit.cu `infer_bf16`, g++ build
    of its plan) at every batch in PLAN_N: a block per band of every image,
    the bands covering every row of the image once and each band's halo
    rows within its shared memory (at most rb + 2 rows of a1, the output
    tile inside a1's planes); the band and the panels are the first that
    fit, both panels before one: the whole image, else the tallest band
    (the shared memory recomputed here); and the float32 and float64
    inference stages keep the plan they had before bf16 inference had a
    kernel of its own."""
    hc = c // 2
    fits = [(panels, rb) for bands in ([h], range(h, 0, -1)) for panels in (2, 1)
            for rb in bands if _infer_bf16_bytes(hc, h, w, rb, panels) <= SMEM_LIMIT]
    for n in PLAN_N:
        err, (blocks, rb, nb, panels, smem) = _bf16_launch(n, c, h, w)
        assert err == 0
        assert (panels, rb) == fits[0], n
        assert (rb == h) == ((h, w, c) in MAPS)
        assert nb == -(-h // rb) and blocks == n * nb
        assert smem == _infer_bf16_bytes(hc, h, w, rb, panels) <= SMEM_LIMIT
        covered = [y for b in range(nb) for y in range(b * rb, min(h, b * rb + rb))]
        assert covered == list(range(h))
        assert hc * rb * w * 2 <= hc * (rb + 2) * (w + 2) * 4
        err, pl = _plan_host(n, c, h, w)
        assert err == 0 and (pl.tpb, pl.n_pb, pl.ipi, pl.n_si) == _parent_inference_plan(n, c, h, w)
        for tsize in (4, 8):
            out = np.zeros(4, np.int64)
            assert _host_lib().cdrl_unit_infer_launch_host(n, c, h, w, SMS, tsize,
                                                           out.ctypes.data) == 0
            assert int(out[0]) == -(-hc // 64) * pl.n_pb and int(out[1]) == pl.n_si * hc


def test_bf16_inference_refuses_a_map_no_band_fits():
    """A map the float32 kernels take but no bf16 band fits (hc = 256, one
    row of 1022 pixels: the pixel operand alone is over 500 KB) raises."""
    shape = (1, 512, 1, 1022)
    assert _plan_host(*shape)[0] == 0
    err, _ = _bf16_launch(*shape)
    assert err == 5
    with pytest.raises(ValueError, match="bfloat16 inference"):
        SU._refuse(err, shape)


def test_plan_refuses_what_the_kernels_do_not_take():
    for shape, why in (((2, 16, 60, 60), "depthwise"), ((4, 1024, 3, 3), "counters"),
                       ((0, 16, 5, 6), "empty")):
        err, _ = _plan_host(*shape)
        with pytest.raises(ValueError, match=why):
            SU._refuse(err, shape)


def test_stride2_units_stay_unfused():
    assert ShuffleUnit(16, 32, 2, fused=True).fused is False
    assert ShuffleUnit(16, 16, 1, fused=True).fused is True


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: the three kernels against the plain versions at a small
    unit, in float32 and float64 (chip_smoke.py's phase `unit` runs the
    full-width maps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        g = torch.Generator().manual_seed(0)
        unit = ShuffleUnit(18, 18, 1, fused=True).to(dtype)
        with torch.no_grad():
            for p in unit.parameters():
                p.copy_(torch.randn(p.shape, generator=g, dtype=dtype) * 0.3)
        unit = unit.cuda()
        x = torch.randn((3, 18, 4, 7), generator=g, dtype=dtype).cuda()
        gout = torch.randn((3, 18, 4, 7), generator=g, dtype=dtype).cuda()
        with torch.no_grad():
            torch.testing.assert_close(SU.shuffle_unit_infer(x, unit.eval()),
                                       SU.shuffle_unit_infer_plain(x, unit), rtol=tol, atol=tol)
        ops = SU.unit_operands(unit)
        out, stats = SU._UnitTrain.apply(x.requires_grad_(True), 0.0, *ops)
        ref_out, ref_stats = SU.shuffle_unit_train_plain(x.detach(), unit)
        torch.testing.assert_close(out.detach(), ref_out, rtol=tol, atol=tol)
        torch.testing.assert_close(stats, ref_stats, rtol=tol, atol=tol)
        grads = torch.autograd.grad(out, [x] + list(ops), gout)
        ref = _autograd_grads(x.detach(), unit, gout)
        top = max(float(r.abs().max()) for r in ref)
        for name, a, b in zip(NAMES, grads, ref):
            assert float((a - b).abs().max()) <= 10 * tol * top, name


@pytest.mark.cuda
def test_cuda_bf16_inference_kernel_matches_plain():
    """On the card: bf16 inference, one launch of k_infer_bf16 per call,
    against the bf16 plain version (relative L2 <= 1e-4, chip_smoke.py's
    UNIT_BF16_INFER_BAR) at small units (C / 2 odd and even), at the first
    backbone map (a whole image per block, both panels) and at the two
    BAND_MAPS (bands of 10 rows with a last band of 3, both panels; bands
    of 2 rows with a last band of 1, one panel shared by both products);
    two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cases = [(3, 18, 4, 7), (4, 16, 5, 6), (2, 116, 11, 45)] + [(3, c, h, w)
                                                               for h, w, c in BAND_MAPS]
    for n, c, h, w in cases:
        err, (_, rb, nb, _, _) = _bf16_launch(n, c, h, w)
        assert err == 0 and (nb > 1) == ((h, w, c) in BAND_MAPS) and (rb * nb > h) == (nb > 1)
        g = torch.Generator().manual_seed(c)
        unit = ShuffleUnit(c, c, 1, fused=True)
        with torch.no_grad():
            for p in unit.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        unit = unit.cuda().eval()
        x = (3.0 * torch.rand((n, c, h, w), generator=g)).to(torch.bfloat16).cuda()
        before = SU.shuffle_unit_infer.launches_bf16
        with torch.no_grad():
            got, again = SU.shuffle_unit_infer(x, unit), SU.shuffle_unit_infer(x, unit)
            want = SU.shuffle_unit_infer_plain(x, unit)
        assert SU.shuffle_unit_infer.launches_bf16 == before + 2
        assert got.dtype == torch.bfloat16 and torch.equal(got, again)
        rel = float((got.double() - want.double()).norm() / want.double().norm())
        assert rel <= 1e-4, (n, c, h, w, rel)


@pytest.mark.cuda
def test_cuda_calls_on_two_streams_share_no_state():
    """On the card: forward and backward calls on two streams at once give
    the bits each input gives on one stream (every call has its own ticket
    counters)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(1)
    unit = ShuffleUnit(116, 116, 1, fused=True)
    with torch.no_grad():
        for p in unit.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    unit = unit.cuda()
    ops = SU.unit_operands(unit)
    inputs = [(3.0 * torch.rand((64, 116, 11, 45), generator=g)).cuda() for _ in range(2)]
    gout = torch.randn((64, 116, 11, 45), generator=g).cuda()

    def call(x):
        out, stats, saved = SU._train_fwd_kernel(x, ops, 0.0)
        return (out, stats) + tuple(SU.shuffle_unit_train_bwd(x, gout, ops, 0.0, stats, saved))

    alone = [call(x) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()
    together = []
    for stream, x in zip(streams, inputs):
        with torch.cuda.stream(stream):
            together.append(call(x))
    torch.cuda.synchronize()
    for a, b in zip(alone, together):
        assert all(torch.equal(s, t) for s, t in zip(a, b))
