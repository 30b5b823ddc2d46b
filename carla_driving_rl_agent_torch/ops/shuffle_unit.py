"""The fused stride-1 ShuffleNet-V2 unit: the CUDA kernels' wrappers and
their plain PyTorch versions.

Counterpart of carla_driving_rl_agent_tpu/ops/shuffle_unit_pallas.py.  One
unit on x (N, C, H, W), hc = C / 2 (the port's backbone is NCHW):
split, 1x1 conv + BN + leaky ReLU6, 3x3 depthwise SAME + BN, 1x1 conv + BN +
act, concat, channel shuffle (models/shufflenet.ShuffleUnit with stride 1).

  * `shuffle_unit_infer(x, unit)`: BatchNorm on the running statistics
    (csrc/shuffle_unit.cu, 3 launches per call in float32 and float64: W1,
    the depthwise, W3; in bfloat16 one, a block per band of rows with a1
    and b2n in shared memory).
  * `shuffle_unit_train(x, unit)`: training mode; returns (out, stats), the
    three BatchNorms' batch mean and BIASED variance in branch order as a
    (6, hc) tensor (rows m1 v1 m2 v2 m3 v3), which feed the running
    averages only and carry no gradient.  On the card a
    torch.autograd.Function: the forward kernel (4 launches) saves z1, z2
    and u; the backward kernel (`shuffle_unit_train_bwd`, 5 launches)
    returns the gradients of x and of the unit's 12 parameter tensors.

The kernels split a call's work by a plan that the CUDA source computes
from the shape and the card's SM count (csrc/shuffle_unit.cuh `make_plan`);
the wrapper reads from it the size of the call's scratch and of its ticket
counters, which every call allocates afresh and the kernel's entry point
zeroes, so that calls on different streams share no state.

Each kernel has its plain version beside it (`*_plain`); the backward's
starts, as the kernel does, from the forward's statistics and saved
tensors.  Each wrapper launches its kernel for CUDA tensors (counting the
call in its `launches`, or for a bfloat16 x in its `launches_bf16`), runs
the plain version for CPU tensors, and raises for
anything else: a wrong device, dtype, shape or a non-contiguous tensor.
The kernels compute in float32 or float64, the dtype of the unit, or take
x in bfloat16 with float32 parameters (CARLAgentConfig.compute_dtype
"bfloat16"): then x, out, the output gradient and gx are bfloat16, the
statistics and the saved z1, z2 and u float32, and the kernels round to
bfloat16 where the JAX kernels with cd = bfloat16 round: W1 and W3 as
they load them (JAX's operands are their bfloat16 copies; rounding on load
saves two conversion launches per call), b2n before the W3 product, the
output, the gradient of z1 before the gx product, gx, and dW1 and dW3
(csrc/shuffle_unit.cuh).  The plain versions round at the same
points; in bfloat16 the plain training unit is an autograd.Function of the
plain forward and the plain backward, as the kernels' is.  The
1x1 products are computed in the kernels' own bodies, never by cuBLAS or
cuDNN: in float32 and float64 by CUDA-core FMAs, in the bfloat16 kernels on
the tensor cores (mma.sync, bf16 operands, float32 sums), where an operand
that the JAX function keeps in float32 (the gradient of u in W3^T g_u, the
gradient of z1 in dW1, both operands of dW3) enters as its exact split
into three bfloat16 terms, so the products equal float32 ones up to the
order of the sums.  What bounds the bfloat16 kernels is then
their memory traffic and the latency of their stages, not the products
(PERF.md).  The kernels' arithmetic lives in csrc/shuffle_unit.cuh, which
csrc/shuffle_unit_host.cpp also builds with g++, so that the CPU tests
(tests/test_torch_shuffle_unit.py) hold the kernels' math against the plain
version and the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from carla_driving_rl_agent_torch.utils.activations import leaky_relu6

BN_EPS = 1e-3          # keras BatchNormalization epsilon, as the flax nets
# rows of the backward kernel's vector gradients (csrc/shuffle_unit.cuh DVec)
DVEC = ("b1", "g1", "be1", "dwb", "g2", "be2", "b3", "g3", "be3")


class UnitOperands(NamedTuple):
    """A stride-1 unit's parameters as the kernels read them: views of the
    module's tensors, no copies (so gradients flow back to the module)."""
    w1: torch.Tensor    # Conv_0 (hc, hc) [out][in]
    b1: torch.Tensor    # Conv_0 bias (hc,)
    g1: torch.Tensor    # BatchNorm_0 scale
    be1: torch.Tensor   # BatchNorm_0 bias
    dw: torch.Tensor    # Conv_1 depthwise (hc, 9) [channel][tap], taps row-major
    dwb: torch.Tensor   # Conv_1 bias
    g2: torch.Tensor    # BatchNorm_1 scale
    be2: torch.Tensor   # BatchNorm_1 bias
    w3: torch.Tensor    # Conv_2 (hc, hc)
    b3: torch.Tensor    # Conv_2 bias
    g3: torch.Tensor    # BatchNorm_2 scale
    be3: torch.Tensor   # BatchNorm_2 bias


def unit_operands(unit) -> UnitOperands:
    """The kernels' operands of a stride-1 models.shufflenet.ShuffleUnit."""
    hc = unit.Conv_0.weight.shape[0]
    return UnitOperands(
        unit.Conv_0.weight.view(hc, hc), unit.Conv_0.bias,
        unit.BatchNorm_0.weight, unit.BatchNorm_0.bias,
        unit.Conv_1.weight.view(hc, 9), unit.Conv_1.bias,
        unit.BatchNorm_1.weight, unit.BatchNorm_1.bias,
        unit.Conv_2.weight.view(hc, hc), unit.Conv_2.bias,
        unit.BatchNorm_2.weight, unit.BatchNorm_2.bias)


def running_stats(unit) -> Tuple[torch.Tensor, ...]:
    """(m1, v1, m2, v2, m3, v3): the unit's three BatchNorms' running mean
    and variance."""
    return tuple(t for i in range(3) for t in (getattr(unit, f"BatchNorm_{i}").running_mean,
                                                getattr(unit, f"BatchNorm_{i}").running_var))


# ------------------------------------------------------------------
# the plain PyTorch versions
# ------------------------------------------------------------------

def _shuffle(shortcut: torch.Tensor, branch: torch.Tensor) -> torch.Tensor:
    """channel_shuffle(concat(shortcut, branch), groups=2), as
    models/shufflenet.channel_shuffle."""
    x = torch.cat([shortcut, branch], dim=1)
    n, c, h, w = x.shape
    return x.reshape(n, c // 2, 2, h, w).transpose(1, 2).reshape(n, c, h, w)


def _rstd(var: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(var + BN_EPS)


def _rounding(x: torch.Tensor):
    """(x in its compute dtype, the rounding of a bfloat16 unit's rounding
    points): float32 and a round trip through bfloat16 for a bfloat16 x,
    else x and the identity."""
    if x.dtype != torch.bfloat16:
        return x, lambda t: t
    return x.to(torch.float32), lambda t: t.to(torch.bfloat16).to(torch.float32)


def _plain(x: torch.Tensor, ops: UnitOperands, leak: float, running=None):
    """The unit with BatchNorm on `running` (m1, v1, ...), or in training
    mode on the batch statistics when `running` is None; returns (out,
    batch stats (6, hc) or None, (z1, z2, u)).  A bfloat16 x computes in
    float32 from W1, W3 and b2n rounded to bfloat16 and returns a bfloat16
    out."""
    hc = x.shape[1] // 2
    xs, rnd = _rounding(x)
    stats = []

    def bn(z, i, gamma, beta):
        if running is not None:
            return F.batch_norm(z, running[2 * i], running[2 * i + 1], gamma, beta,
                                False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(z, dim=(0, 2, 3), correction=0)
        stats.extend((mean, var))
        return F.batch_norm(z, None, None, gamma, beta, True, 0.0, BN_EPS)

    shortcut, branch = xs[:, :hc], xs[:, hc:]
    z1 = F.conv2d(branch, rnd(ops.w1)[:, :, None, None], ops.b1)
    z2 = F.conv2d(F.pad(leaky_relu6(bn(z1, 0, ops.g1, ops.be1), leak), (1, 1, 1, 1)),
                  ops.dw.view(hc, 1, 3, 3), ops.dwb, groups=hc)
    u = F.conv2d(rnd(bn(z2, 1, ops.g2, ops.be2)), rnd(ops.w3)[:, :, None, None], ops.b3)
    y = leaky_relu6(bn(u, 2, ops.g3, ops.be3), leak)
    out = _shuffle(shortcut, y).to(x.dtype)
    return out, (torch.stack(stats) if stats else None), (z1, z2, u)


def shuffle_unit_infer_plain(x: torch.Tensor, unit) -> torch.Tensor:
    """The plain version of `shuffle_unit_infer`."""
    return _plain(x, unit_operands(unit), unit.leak, running_stats(unit))[0]


def shuffle_unit_train_plain(x: torch.Tensor, unit):
    """The plain version of `shuffle_unit_train`: (out, stats (6, hc)),
    differentiable through autograd; in bfloat16 through _UnitTrainPlain,
    whose backward rounds as the backward kernel does."""
    if x.dtype == torch.bfloat16:
        return _UnitTrainPlain.apply(x, float(unit.leak), *unit_operands(unit))
    return _plain(x, unit_operands(unit), unit.leak)[:2]


def _act_grad(pre: torch.Tensor, leak: float) -> torch.Tensor:
    return torch.where(pre < 0.0, leak, torch.where(pre <= 6.0, 1.0, 0.0)).to(pre.dtype)


def shuffle_unit_train_bwd_plain(x: torch.Tensor, gout: torch.Tensor, ops: UnitOperands,
                                 leak: float, stats: torch.Tensor, saved):
    """The plain version of the backward kernel (`shuffle_unit_train_bwd`):
    the gradients of x and of the 12 operands for the output gradient
    `gout`, from the forward's batch statistics and saved (z1, z2, u).  Its
    pre-activations round as the kernel's (one operation at a time), so
    both take the same step of the activation's gradient.  A bfloat16 x and
    gout compute in float32 with W1 and W3 rounded to bfloat16, round the
    gradient of z1 before the gx product, and return gx in bfloat16 and dW1
    and dW3 rounded to bfloat16 (in float32, the parameters' dtype)."""
    n, c, h, w = x.shape
    hc = c // 2
    x_in = x
    x, rnd = _rounding(x)
    gout = gout.to(x.dtype)
    w1, w3 = rnd(ops.w1), rnd(ops.w3)
    inv_m = 1.0 / (n * h * w)
    col = lambda v: v.view(1, hc, 1, 1)
    z1, z2, u = saved
    m1, v1, m2, v2, m3, v3 = (col(t) for t in stats.unbind(0))
    r1, r2, r3 = _rstd(v1), _rstd(v2), _rstd(v3)
    sums = lambda t: t.sum(dim=(0, 2, 3))
    # the shuffled gradient back in concat order: shortcut, then branch
    gcat = gout.reshape(n, 2, hc, h, w).transpose(1, 2).reshape(n, c, h, w)
    xh3 = (u - m3) * r3
    ga3 = gcat[:, hc:] * _act_grad(col(ops.g3) * xh3 + col(ops.be3), leak)
    s1, s2 = sums(ga3), sums(ga3 * xh3)
    gu = col(ops.g3) * r3 * (ga3 - (col(s1) + xh3 * col(s2)) * inv_m)
    b2n = col(ops.g2) * ((z2 - m2) * r2) + col(ops.be2)
    dw3 = rnd(torch.einsum("nohw,nkhw->ok", gu, b2n))
    gb2n = torch.einsum("ok,nohw->nkhw", w3, gu)
    xh2 = (z2 - m2) * r2
    t1, t2 = sums(gb2n), sums(gb2n * xh2)
    gz2 = col(ops.g2) * r2 * (gb2n - (col(t1) + xh2 * col(t2)) * inv_m)
    xh1 = (z1 - m1) * r1
    a1p = F.pad(leaky_relu6(col(ops.g1) * xh1 + col(ops.be1), leak), (1, 1, 1, 1))
    gz2p = F.pad(gz2, (1, 1, 1, 1))
    ddw = torch.stack([sums(gz2 * a1p[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=1)
    ga1 = sum(col(ops.dw[:, (dy + 1) * 3 + dx + 1]) * gz2p[:, :, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
              for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    gpre1 = ga1 * _act_grad(col(ops.g1) * xh1 + col(ops.be1), leak)
    u1, u2 = sums(gpre1), sums(gpre1 * xh1)
    gz1 = col(ops.g1) * r1 * (gpre1 - (col(u1) + xh1 * col(u2)) * inv_m)
    dw1 = rnd(torch.einsum("nohw,nihw->oi", gz1, x[:, hc:]))
    gx = torch.cat([gcat[:, :hc], torch.einsum("oi,nohw->nihw", w1, rnd(gz1))], dim=1)
    return (gx.to(x_in.dtype), dw1, sums(gz1), u2, u1, ddw, sums(gz2), t2, t1, dw3, sums(gu),
            s2, s1)


class _UnitTrainPlain(torch.autograd.Function):
    """The plain bfloat16 training unit: the plain forward, the plain
    backward (shuffle_unit_train_bwd_plain), as _UnitTrain runs the
    kernels."""

    @staticmethod
    def forward(ctx, x, leak, *ops):
        out, stats, saved = _plain(x, UnitOperands(*ops), leak)
        ctx.leak = leak
        ctx.save_for_backward(x, stats, *saved, *ops)
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, gout, _gstats):
        x, stats, z1, z2, u, *ops = ctx.saved_tensors
        grads = shuffle_unit_train_bwd_plain(x, gout.contiguous(), UnitOperands(*ops),
                                             ctx.leak, stats, (z1, z2, u))
        return (grads[0], None) + grads[1:]


# ------------------------------------------------------------------
# the CUDA kernels and their host build
# ------------------------------------------------------------------

_POINTERS = ("x", "w1", "b1", "g1", "be1", "dw", "dwb", "g2", "be2", "w3", "b3", "g3",
             "be3", "m1", "v1", "m2", "v2", "m3", "v3", "gout", "out", "stats", "z1",
             "z2", "u", "gb2n", "gpre1", "gu", "b2n", "gz1", "xb", "dw1", "ddw", "dw3",
             "dvec", "partial", "counters")


class _Args(ctypes.Structure):
    """ctypes mirror of cdrl::unit::UnitArgs (csrc/shuffle_unit.cuh)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [("eps", ctypes.c_double), ("leak", ctypes.c_double)]
                + [(n, ctypes.c_int) for n in ("n", "c", "h", "w")])


class _Plan(ctypes.Structure):
    """ctypes mirror of cdrl::unit::Plan (csrc/shuffle_unit.cuh): the
    kernels' split of a call into blocks."""
    _fields_ = ([(n, ctypes.c_int) for n in ("tpb", "n_pb", "ipb", "n_s", "ipi", "n_si", "cps",
                                               "nseg", "gsz", "n_counters")]
                + [("partial", ctypes.c_int64)]
                + [(n, ctypes.c_int) for n in ("rb", "nb", "panels", "ismem")])


# the kernels' storage dtypes; bfloat16 computes in float32
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# cdrl::unit::PlanError, why the kernels' plan refuses a shape
_REFUSED = {1: "x is empty", 2: "x has 2^31 elements or more; the kernels index with 32-bit ints",
            3: "the map does not fit the depthwise stages' shared planes",
            4: "the unit needs more ticket counters than the kernels have",
            5: "no band of the map's rows fits the bfloat16 inference kernel's shared memory"}


def _refuse(code: int, shape) -> None:
    """Raise for a plan's nonzero `code` at x's `shape`."""
    if code:
        raise ValueError(f"the unit kernels do not take x of shape {tuple(shape)}: "
                         f"{_REFUSED.get(code, f'the card has no SM count ({code})')}")


@functools.lru_cache(maxsize=None)
def _scratch(device: int, n: int, c: int, h: int, w: int) -> Tuple[int, int]:
    """(elements of a call's partials scratch, its ticket counters) at x's
    shape on CUDA device `device`, from the kernels' plan."""
    pl = _Plan()
    _refuse(_kernel_lib().cdrl_unit_plan(device, n, c, h, w, ctypes.byref(pl)), (n, c, h, w))
    return pl.partial, pl.n_counters


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the kernels compute in and keep everything but x, out,
    the output gradient, gx, W1 and W3 in."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def _check(t: torch.Tensor, name: str, x: torch.Tensor, shape, dtype=None) -> int:
    """t's address, after checking it against x (its device, and `dtype`,
    default x's) and `shape`."""
    dtype = dtype or x.dtype
    if (t.device == x.device and t.dtype == dtype and t.shape == shape
            and t.is_contiguous()):
        return t.data_ptr()
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous")


_STATS = ("m1", "v1", "m2", "v2", "m3", "v3")


def _pack(x: torch.Tensor, ops: UnitOperands, leak: float, bn_stats=None, inputs=None,
          **ptrs) -> _Args:
    """Check x, the operands (in the compute dtype: float32 for a bfloat16
    x), the BatchNorm statistics and the `inputs` {name: tensor} of x's
    shape, and lay out the kernels' arguments.  `bn_stats` is a (6, hc)
    tensor of rows m1 v1 m2 v2 m3 v3 or a tuple of the six; `ptrs` are the
    buffers the wrapper allocated, {name: address}."""
    if x.dim() != 4 or x.shape[1] % 2:
        raise ValueError(f"x must be (N, C, H, W) with C even, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the unit kernels take float32, float64 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    hc = c // 2
    cd = _compute_dtype(x)
    a = _Args()
    a.x = _check(x, "x", x, x.shape)
    vec, mat = (hc,), (hc, hc)
    a.w1, a.b1, a.g1, a.be1 = (_check(ops.w1, "w1", x, mat, cd), _check(ops.b1, "b1", x, vec, cd),
                               _check(ops.g1, "g1", x, vec, cd), _check(ops.be1, "be1", x, vec, cd))
    a.dw, a.dwb, a.g2, a.be2 = (_check(ops.dw, "dw", x, (hc, 9), cd),
                                _check(ops.dwb, "dwb", x, vec, cd),
                                _check(ops.g2, "g2", x, vec, cd),
                                _check(ops.be2, "be2", x, vec, cd))
    a.w3, a.b3, a.g3, a.be3 = (_check(ops.w3, "w3", x, mat, cd), _check(ops.b3, "b3", x, vec, cd),
                               _check(ops.g3, "g3", x, vec, cd), _check(ops.be3, "be3", x, vec, cd))
    if isinstance(bn_stats, torch.Tensor):
        base = _check(bn_stats, "stats", x, (6, hc), cd)
        step = hc * bn_stats.element_size()
        a.m1, a.v1, a.m2, a.v2, a.m3, a.v3 = (base + i * step for i in range(6))
    elif bn_stats is not None:
        for name, t in zip(_STATS, bn_stats):
            setattr(a, name, _check(t, name, x, vec, cd))
    act = (n, hc, h, w)
    for name, t in (inputs or {}).items():
        if name == "gout":
            setattr(a, name, _check(t, name, x, x.shape))
        else:
            setattr(a, name, _check(t, name, x, act, cd))
    for name, ptr in ptrs.items():
        setattr(a, name, ptr)
    a.eps, a.leak = BN_EPS, float(leak)
    a.n, a.c, a.h, a.w = n, c, h, w
    return a


def _infer_args(x: torch.Tensor, unit) -> Tuple[_Args, torch.Tensor, tuple]:
    """The inference kernel's arguments, its output and the tensors to keep
    alive until it has run.  bfloat16 needs no scratch (k_infer_bf16 keeps a1
    and b2n in shared memory)."""
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        return _pack(x, unit_operands(unit), unit.leak, running_stats(unit),
                     out=out.data_ptr()), out, ()
    # a1, then b2n over it (csrc/shuffle_unit.cu k_dw_infer)
    a1 = torch.empty((n, c // 2, h, w), dtype=_compute_dtype(x), device=x.device)
    args = _pack(x, unit_operands(unit), unit.leak, running_stats(unit),
                 out=out.data_ptr(), z1=a1.data_ptr(), b2n=a1.data_ptr())
    return args, out, (a1,)


def _fwd_args(x: torch.Tensor, ops: UnitOperands, leak: float, scratch: Tuple[int, int]):
    """The forward kernel's arguments, its outputs out and stats (6, hc),
    its saved (z1, z2, u) and the tensors to keep alive until it has run;
    `scratch` is `_scratch`'s (partials, counters) at x's shape."""
    n, c, h, w = x.shape
    hc = c // 2
    new = lambda *shape: torch.empty(shape, dtype=_compute_dtype(x), device=x.device)
    out, stats, partial = torch.empty_like(x), new(6, hc), new(scratch[0])
    counters = torch.empty(scratch[1], dtype=torch.int32, device=x.device)
    z1, z2, u = new(n, hc, h, w), new(n, hc, h, w), new(n, hc, h, w)
    args = _pack(x, ops, leak, stats, out=out.data_ptr(), stats=stats.data_ptr(),
                 z1=z1.data_ptr(), z2=z2.data_ptr(), u=u.data_ptr(), partial=partial.data_ptr(),
                 counters=counters.data_ptr())
    return args, out, stats, (z1, z2, u), (partial, counters)


def _bwd_args(x: torch.Tensor, gout: torch.Tensor, ops: UnitOperands, leak: float,
              stats: torch.Tensor, saved, scratch_size: Tuple[int, int]):
    """The backward kernel's arguments, its gradients in (x, UnitOperands)
    order and the tensors to keep alive until it has run; `scratch_size` is
    `_scratch`'s (partials, counters) at x's shape.  In bfloat16 the
    scratch's g_u, b2n and g_z1 are channel-major, (hc, pitch) with the
    pixels' pitch a multiple of 8 (csrc/shuffle_unit.cuh `pixel_pitch`), and
    a sixth slot holds the branch input so (xb, bfloat16)."""
    n, c, h, w = x.shape
    hc = c // 2
    bf16 = x.dtype == torch.bfloat16
    act = hc * -(-n * h * w // 8) * 8 if bf16 else n * hc * h * w
    slots = 6 if bf16 else 5
    new = lambda size: torch.empty(size, dtype=_compute_dtype(x), device=x.device)
    gx = torch.empty_like(x)
    flat = new(2 * hc * hc + 9 * hc + len(DVEC) * hc)
    scratch = new(slots * act + scratch_size[0])
    counters = torch.empty(scratch_size[1], dtype=torch.int32, device=x.device)
    z1, z2, u = saved
    base, size = scratch.data_ptr(), scratch.element_size()
    at = lambda i: base + i * act * size
    args = _pack(x, ops, leak, stats, inputs=dict(gout=gout, z1=z1, z2=z2, u=u),
                 out=gx.data_ptr(), gb2n=at(0), gpre1=at(1), gu=at(2), b2n=at(3), gz1=at(4),
                 xb=at(5) if bf16 else None,
                 partial=at(slots), counters=counters.data_ptr(), dw1=flat.data_ptr(),
                 ddw=flat.data_ptr() + hc * hc * size,
                 dw3=flat.data_ptr() + (hc * hc + 9 * hc) * size,
                 dvec=flat.data_ptr() + (2 * hc * hc + 9 * hc) * size)
    dw1, ddw, dw3, *d = flat.split([hc * hc, 9 * hc, hc * hc] + [hc] * len(DVEC))
    d = dict(zip(DVEC, d))
    grads = (gx, dw1.view(hc, hc), d["b1"], d["g1"], d["be1"], ddw.view(hc, 9), d["dwb"],
             d["g2"], d["be2"], dw3.view(hc, hc), d["b3"], d["g3"], d["be3"])
    return args, grads, (scratch, counters)


def _kernel_lib() -> ctypes.CDLL:
    from carla_driving_rl_agent_torch.utils.build import csrc, load_library
    sig = (ctypes.c_int, [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p])
    sigs = {f: sig for f in ("cdrl_unit_infer", "cdrl_unit_train_fwd", "cdrl_unit_train_bwd")}
    sigs["cdrl_unit_plan"] = (ctypes.c_int, [ctypes.c_int] * 5 + [ctypes.POINTER(_Plan)])
    return load_library("shuffle_unit", [csrc("shuffle_unit.cu")], "nvcc", sigs,
                        extra_deps=[csrc("shuffle_unit.cuh")])


def build_kernel() -> None:
    """Compile (if needed) and load the CUDA unit kernels."""
    _kernel_lib()


def _launch(fn: str, args: _Args, x: torch.Tensor) -> None:
    """Launch `fn` on x's device and current stream; raises on a CUDA error."""
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(fn, args, x)
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_kernel_lib(), fn)(ctypes.byref(args), _DTYPES[x.dtype], stream)
    _refuse(max(0, -err), x.shape)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


def _count(fn, x: torch.Tensor) -> None:
    """One launch of `fn`'s kernel: its bfloat16 instantiation for a
    bfloat16 x, else the float32 / float64 one."""
    if x.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the unit runs on cuda or cpu, not {x.device}")
    return x.device.type


def shuffle_unit_infer(x: torch.Tensor, unit) -> torch.Tensor:
    """Inference-mode fused stride-1 unit (BatchNorm on the running
    statistics) of the module `unit`: the kernel on CUDA, the plain version
    on the CPU."""
    if _device(x) == "cpu":
        return shuffle_unit_infer_plain(x, unit)
    args, out, _keep = _infer_args(x, unit)
    if x.numel():
        _launch("cdrl_unit_infer", args, x)
        _count(shuffle_unit_infer, x)
    return out


shuffle_unit_infer.launches = shuffle_unit_infer.launches_bf16 = 0


def _train_fwd_kernel(x: torch.Tensor, ops: UnitOperands, leak: float):
    """The forward kernel: (out, stats, (z1, z2, u))."""
    args, out, stats, saved, _keep = _fwd_args(x, ops, leak, _scratch(x.device.index, *x.shape))
    _launch("cdrl_unit_train_fwd", args, x)
    _count(shuffle_unit_train, x)
    return out, stats, saved


def shuffle_unit_train_bwd(x: torch.Tensor, gout: torch.Tensor, ops: UnitOperands,
                           leak: float, stats: torch.Tensor, saved):
    """The backward kernel: the gradients of x and of the 12 operands
    (UnitOperands order) for the output gradient `gout`, from the forward
    kernel's stats and saved (z1, z2, u).  CUDA tensors only."""
    if _device(x) != "cuda":
        raise ValueError("shuffle_unit_train_bwd launches the CUDA kernel: CUDA tensors only")
    args, grads, _keep = _bwd_args(x, gout, ops, leak, stats, saved,
                                   _scratch(x.device.index, *x.shape))
    _launch("cdrl_unit_train_bwd", args, x)
    _count(shuffle_unit_train_bwd, x)
    return grads


shuffle_unit_train_bwd.launches = shuffle_unit_train_bwd.launches_bf16 = 0


class _UnitTrain(torch.autograd.Function):
    """The training unit on the card: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, x, leak, *ops):
        out, stats, saved = _train_fwd_kernel(x, UnitOperands(*ops), leak)
        ctx.leak = leak
        ctx.save_for_backward(x, stats, *saved, *ops)
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, gout, _gstats):
        x, stats, z1, z2, u, *ops = ctx.saved_tensors
        grads = shuffle_unit_train_bwd(x, gout.contiguous(), UnitOperands(*ops), ctx.leak,
                                       stats, (z1, z2, u))
        return (grads[0], None) + grads[1:]


def shuffle_unit_train(x: torch.Tensor, unit):
    """Training-mode fused stride-1 unit of the module `unit`: (out, stats
    (6, hc)), the batch statistics for the caller to fold into the running
    ones.  On CUDA the forward and backward kernels behind
    torch.autograd.Function; on the CPU the plain version."""
    if _device(x) == "cpu":
        return shuffle_unit_train_plain(x, unit)
    return _UnitTrain.apply(x, float(unit.leak), *unit_operands(unit))


shuffle_unit_train.launches = shuffle_unit_train.launches_bf16 = 0
