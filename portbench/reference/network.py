"""The CARLA agent's network as plain float32 PyTorch functions of a
parameter dict: the reference that the benchmark holds the port's network
against.  It imports nothing of the port.

The architecture is the reference agent's (Luca96/carla-driving-rl-agent,
core/networks.py and core/architectures.py, spec core/carla_agent.py:61-68):

  image      -> ShuffleNetV2(g=1.0, last 768), shared over T -> GRU(256)
  road       -> 2 x [Dense(16) -> relu6 -> BatchNorm]        -> GRU(32)
  vehicle    -> the same                                     -> GRU(32)
  navigation -> the same                                     -> GRU(32)
  concat -> BatchNorm -> Dense(512)                          (the feature)
  policy: 2 x [BatchNorm -> Dense(320) -> swish6] -> Beta(softplus + 1.01),
          speed (2 sigmoid) and similarity (tanh) heads
  value:  the same branch -> (tanh, 6 sigmoid), speed and similarity heads

The parameters are named as the flax tree that the shipped checkpoints hold
(ShuffleUnit_3.Conv_1, GRUCell_0.ir, ...), laid out as torch layers take
them: Dense weights (out, in), conv weights (out, in / groups, kh, kw).
BatchNorm is flax's: epsilon 1e-3, the biased batch variance in training.
flax's "SAME" padding puts the odd pixel of a stride-2 window at the end.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

CHANNELS = (116, 232, 464)          # ShuffleNetV2 g = 1.0
STAGE_UNITS = (4, 8, 4)
BN_EPS = 1e-3
ROAD, VEHICLE, NAV = 9, 4, 5


def spec(last_channels: int = 768, rnn=(256, 32, 32, 32), feature_units: int = 16,
         dynamics_units: int = 512, control_units: int = 320,
         image_channels: int = 3) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of the network: (name, shape, kind), kind one of
    kernel, bias, scale, mean, var (BatchNorm statistics)."""
    out = []

    def dense(name, n_in, n_out, bias=True):
        out.append((f"{name}.weight", (n_out, n_in), "kernel"))
        if bias:
            out.append((f"{name}.bias", (n_out,), "bias"))

    def conv(name, c_in, c_out, k, groups=1):
        out.append((f"{name}.weight", (c_out, c_in // groups, k, k), "kernel"))
        out.append((f"{name}.bias", (c_out,), "bias"))

    def bn(name, c):
        out.extend([(f"{name}.weight", (c,), "scale"), (f"{name}.bias", (c,), "bias"),
                    (f"{name}.running_mean", (c,), "mean"),
                    (f"{name}.running_var", (c,), "var")])

    sn = "dynamics.ShuffleNetV2_0"
    conv(f"{sn}.Conv_0", image_channels, 24, 3)
    bn(f"{sn}._BNAct_0.BatchNorm_0", 24)
    c_in, i = 24, 0
    for c, units in zip(CHANNELS, STAGE_UNITS):
        for j in range(units):
            u = f"{sn}.ShuffleUnit_{i}"
            if j == 0:
                conv(f"{u}.Conv_0", c_in, c // 2, 1)
                bn(f"{u}.BatchNorm_0", c // 2)
                conv(f"{u}.Conv_1", c // 2, c // 2, 3, groups=c // 2)
                bn(f"{u}.BatchNorm_1", c // 2)
                conv(f"{u}.Conv_2", c // 2, c - c_in, 1)
                bn(f"{u}.BatchNorm_2", c - c_in)
                conv(f"{u}.Conv_3", c_in, c_in, 3, groups=c_in)
                bn(f"{u}.BatchNorm_3", c_in)
                conv(f"{u}.Conv_4", c_in, c_in, 1)
                bn(f"{u}.BatchNorm_4", c_in)
            else:
                h = c // 2
                conv(f"{u}.Conv_0", h, h, 1)
                bn(f"{u}.BatchNorm_0", h)
                conv(f"{u}.Conv_1", h, h, 3, groups=h)
                bn(f"{u}.BatchNorm_1", h)
                conv(f"{u}.Conv_2", h, h, 1)
                bn(f"{u}.BatchNorm_2", h)
            c_in, i = c, i + 1
    conv(f"{sn}.Conv_1", c_in, last_channels, 1)
    bn(f"{sn}._BNAct_1.BatchNorm_0", last_channels)
    for k, d in enumerate((ROAD, VEHICLE, NAV)):
        f = f"dynamics.FeatureNet_{k}"
        dense(f"{f}.Dense_0", d, feature_units)
        bn(f"{f}.BatchNorm_0", feature_units)
        dense(f"{f}.Dense_1", feature_units, feature_units)
        bn(f"{f}.BatchNorm_1", feature_units)
    for k, (n_in, units) in enumerate(zip((last_channels,) + (feature_units,) * 3, rnn)):
        cell = f"dynamics.GRU_{k}.GRUCell_0"
        for g in ("ir", "iz", "in"):
            dense(f"{cell}.{g}", n_in, units)
        for g in ("hr", "hz"):
            dense(f"{cell}.{g}", units, units, bias=False)
        dense(f"{cell}.hn", units, units)
    bn("dynamics.LinearCombination_0.BatchNorm_0", sum(rnn))
    dense("dynamics.LinearCombination_0.Dense_0", sum(rnn), dynamics_units)
    for head, outs in (("policy", ("alpha", "beta", "pi_similarity", "pi_speed")),
                       ("old_policy", ("alpha", "beta", "pi_similarity", "pi_speed")),
                       ("value", ("v_base", "v_exp", "v_speed", "v_similarity"))):
        dims = (dynamics_units, control_units, control_units)
        for layer in range(2):
            bn(f"{head}.ControlBranch_0.BatchNorm_{layer}", dims[layer])
            dense(f"{head}.ControlBranch_0.Dense_{layer}", dims[layer], dims[layer + 1])
        for o in outs:
            dense(f"{head}.{o}", control_units, 2 if o in ("alpha", "beta") else 1)
    return out


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def swish6(x):
    return torch.clamp(x * torch.sigmoid(x), max=6.0)


def batch_norm(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor, axis: int,
               training: bool) -> torch.Tensor:
    """flax BatchNorm over channel axis `axis`: the running statistics, or in
    training the batch mean and biased variance over every other axis."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    if training:
        dims = [d for d in range(x.dim()) if d != axis % x.dim()]
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].reshape(shape)
        var = p[f"{name}.running_var"].reshape(shape)
    scale = p[f"{name}.weight"].reshape(shape)
    bias = p[f"{name}.bias"].reshape(shape)
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + bias


def dense(p, name, x):
    b = p.get(f"{name}.bias")
    y = x @ p[f"{name}.weight"].t()
    return y if b is None else y + b


def same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def conv(p, name, x, stride=1, groups=1, pad=False):
    w = p[f"{name}.weight"]
    if pad:
        x = same_pad(x, w.shape[-1], stride)
    return F.conv2d(x, w, p[f"{name}.bias"], stride=stride, groups=groups)


def shufflenet(p, x: torch.Tensor, training: bool) -> torch.Tensor:
    """(B, T, H, W, C) frames -> (B, T, last_channels)."""
    b, t = x.shape[:2]
    sn = "dynamics.ShuffleNetV2_0"
    x = x.reshape((b * t,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)

    def bn(name, y):
        return batch_norm(p, name, y, 1, training)

    x = relu6(bn(f"{sn}._BNAct_0.BatchNorm_0", conv(p, f"{sn}.Conv_0", x, stride=2)))
    x = F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, stride=2)
    i = 0
    for c, units in zip(CHANNELS, STAGE_UNITS):
        for j in range(units):
            u = f"{sn}.ShuffleUnit_{i}"
            s = 2 if j == 0 else 1
            if s == 1:
                shortcut, branch = x[:, :x.shape[1] // 2], x[:, x.shape[1] // 2:]
            else:
                shortcut, branch = x, x
            mid = p[f"{u}.Conv_1.weight"].shape[0]
            branch = relu6(bn(f"{u}.BatchNorm_0", conv(p, f"{u}.Conv_0", branch)))
            branch = bn(f"{u}.BatchNorm_1", conv(p, f"{u}.Conv_1", branch, s, mid, pad=True))
            branch = relu6(bn(f"{u}.BatchNorm_2", conv(p, f"{u}.Conv_2", branch)))
            if s == 2:
                sc = shortcut.shape[1]
                shortcut = bn(f"{u}.BatchNorm_3",
                              conv(p, f"{u}.Conv_3", shortcut, 2, sc, pad=True))
                shortcut = relu6(bn(f"{u}.BatchNorm_4", conv(p, f"{u}.Conv_4", shortcut)))
            y = torch.cat([shortcut, branch], dim=1)
            n, cc, h, w = y.shape
            x = y.reshape(n, cc // 2, 2, h, w).transpose(1, 2).reshape(n, cc, h, w)
            i += 1
    x = relu6(bn(f"{sn}._BNAct_1.BatchNorm_0", conv(p, f"{sn}.Conv_1", x)))
    return x.mean(dim=(2, 3)).reshape(b, t, -1)


def gru(p, name: str, x: torch.Tensor) -> torch.Tensor:
    """flax GRUCell over (B, T, D) from a zero state; the last state."""
    c = f"{name}.GRUCell_0"
    h = torch.zeros(x.shape[0], p[f"{c}.hr.weight"].shape[0], dtype=x.dtype,
                    device=x.device)
    for t in range(x.shape[1]):
        xt = x[:, t]
        r = torch.sigmoid(dense(p, f"{c}.ir", xt) + dense(p, f"{c}.hr", h))
        z = torch.sigmoid(dense(p, f"{c}.iz", xt) + dense(p, f"{c}.hz", h))
        n = torch.tanh(dense(p, f"{c}.in", xt) + r * dense(p, f"{c}.hn", h))
        h = (1.0 - z) * n + z * h
    return h


def feature_net(p, name, x, training):
    for i in range(2):
        x = relu6(dense(p, f"{name}.Dense_{i}", x))
        x = batch_norm(p, f"{name}.BatchNorm_{i}", x, -1, training)
    return x


def dynamics(p, obs: Dict[str, torch.Tensor], training: bool = False) -> torch.Tensor:
    parts = [gru(p, "dynamics.GRU_0", shufflenet(p, obs["state_image"], training))]
    for k, key in enumerate(("state_road", "state_vehicle", "state_navigation")):
        parts.append(gru(p, f"dynamics.GRU_{k + 1}",
                         feature_net(p, f"dynamics.FeatureNet_{k}", obs[key], training)))
    x = batch_norm(p, "dynamics.LinearCombination_0.BatchNorm_0", torch.cat(parts, -1), -1,
                   training)
    return dense(p, "dynamics.LinearCombination_0.Dense_0", x)


def _branch(p, head, x, training):
    for i in range(2):
        x = batch_norm(p, f"{head}.ControlBranch_0.BatchNorm_{i}", x, -1, training)
        x = swish6(dense(p, f"{head}.ControlBranch_0.Dense_{i}", x))
    return x


def policy(p, feat, training: bool = False, head: str = "policy",
           preact_floor=None) -> dict:
    """Beta(alpha, beta) and the auxiliary heads.  `head` "old_policy"
    reads the policy's BatchNorm statistics, as the agent shares them."""
    if head == "old_policy":
        p = dict(p)
        for k in list(p):
            if k.startswith("policy.") and k.endswith(("running_mean", "running_var")):
                p["old_policy." + k[len("policy."):]] = p[k]
    x = _branch(p, head, feat, training)
    za, zb = dense(p, f"{head}.alpha", x), dense(p, f"{head}.beta", x)
    if preact_floor is not None:
        f = float(preact_floor)
        za = torch.where(za > f, za, f + 0.05 * (za - f))
        zb = torch.where(zb > f, zb, f + 0.05 * (zb - f))
    return dict(alpha=F.softplus(za) + 1.01, beta=F.softplus(zb) + 1.01,
                speed=2.0 * torch.sigmoid(dense(p, f"{head}.pi_speed", x)),
                similarity=torch.tanh(dense(p, f"{head}.pi_similarity", x)))


def value(p, feat, training: bool = False) -> dict:
    x = _branch(p, "value", feat, training)
    return dict(value=torch.cat([torch.tanh(dense(p, "value.v_base", x)),
                                 6.0 * torch.sigmoid(dense(p, "value.v_exp", x))], -1),
                speed=2.0 * torch.sigmoid(dense(p, "value.v_speed", x)),
                similarity=torch.tanh(dense(p, "value.v_similarity", x)))


# ---- the Beta distribution of the policy (reference core/networks.py:128-144)

EPSILON = 1e-7


def beta_log_prob(alpha, beta, x):
    x = torch.clamp(x, EPSILON, 1.0 - EPSILON)
    log_b = torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)
    return (alpha - 1.0) * torch.log(x) + (beta - 1.0) * torch.log1p(-x) - log_b


def beta_entropy(a, b):
    log_b = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return (log_b - (a - 1.0) * torch.digamma(a) - (b - 1.0) * torch.digamma(b)
            + (a + b - 2.0) * torch.digamma(a + b))


def beta_mean_std(a, b):
    s = a + b
    return a / s, torch.sqrt(a * b / (s * s * (s + 1.0)))


def predict(p, obs, preact_floor=None) -> dict:
    """The rollout's and the evaluation's forward in inference mode: the old
    policy's Beta and the value."""
    feat = dynamics(p, obs)
    pol = policy(p, feat, head="old_policy", preact_floor=preact_floor)
    mean, std = beta_mean_std(pol["alpha"], pol["beta"])
    return dict(alpha=pol["alpha"], beta=pol["beta"], mean=mean, std=std,
                value=value(p, feat)["value"])


def init_weights(shapes, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Weights made from `gen` in one draw: glorot-uniform kernels (flax's
    initialiser of every Dense and Conv), zero biases, BatchNorm scale 1,
    running mean 0 and variance 1; old_policy a copy of policy."""
    kernels = [(n, s) for n, s, k in shapes if k == "kernel" and not n.startswith("old_")]
    flat = torch.rand(sum(math.prod(s) for _, s in kernels), generator=gen,
                      device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in kernels:
        n = math.prod(shape)
        rf = math.prod(shape[2:]) if len(shape) > 2 else 1
        limit = math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))
        out[name] = (flat[at:at + n] * limit).reshape(shape)
        at += n
    fill = dict(bias=0.0, scale=1.0, mean=0.0, var=1.0)
    for name, shape, kind in shapes:
        if kind != "kernel":
            out[name] = torch.full(shape, fill[kind], device=device)
    for name, shape, kind in shapes:
        if name.startswith("old_policy."):
            out[name] = out["policy." + name[len("old_policy."):]].clone()
    return out
