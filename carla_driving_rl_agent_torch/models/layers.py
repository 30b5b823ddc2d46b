"""Shared building blocks: time-distributed feature nets, control branches,
the linear combination, and the BatchNorm of the flax checkpoints.

Counterpart of carla_driving_rl_agent_tpu/models/layers.py (reference
core/architectures.py:9-27, core/networks.py:24-30,59-66).  Module and
parameter names follow the flax tree (Dense_0, BatchNorm_1, ...) so that the
checkpoint converter maps names one to one.

`dtype` (None, or torch.bfloat16 for CARLAgentConfig.compute_dtype
"bfloat16") follows flax's dtype rules, not torch.autocast's: the
parameters stay float32; a Dense or Conv casts its input and its kernel to
the dtype and returns the dtype, its product and its bias add each rounded
as flax's are; a BatchNorm computes its statistics and its normalisation
in float32 from its input, keeps float32 running averages, and returns its
input's dtype; the feature nets cast their input at entry.  None computes
in the parameters' dtype, as before.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from carla_driving_rl_agent_torch.utils.activations import get_activation

BN_EPS = 1e-3  # keras BatchNormalization default, as in the flax nets


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (flax's nn.Dense(dtype=...)): the
    product of the input and the kernel in the dtype, then the bias added
    in it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv(nn.Conv2d):
    """nn.Conv2d without padding computing in `dtype` (flax's
    nn.Conv(dtype=...)), as Dense; the callers pad."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, groups=groups)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return y + self.bias.to(dt).view(1, -1, 1, 1)


class BatchNorm(nn.Module):
    """flax's nn.BatchNorm (epsilon 1e-3, momentum 0.99) over the channel
    axis `channel_axis` of any input: -1 for (..., C), 1 for (N, C, H, W).

    In eval mode it normalises with the running statistics.  In train mode
    it normalises with the batch mean and the BIASED batch variance over
    every other axis (F.batch_norm without running buffers), and folds the
    batch statistics it computes itself into the running ones as
    0.99 * running + 0.01 * batch, with the biased variance, as flax does.
    PyTorch's own BatchNorm folds the unbiased variance with its momentum
    the other way round, so it never updates these buffers."""

    momentum = 0.99

    def __init__(self, features: int, channel_axis: int = -1):
        super().__init__()
        self.features = features
        self.channel_axis = channel_axis
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            # flax with dtype bfloat16: statistics and normalisation in
            # float32, one rounding of the output
            return self.forward(x.to(torch.float32)).to(x.dtype)
        # (N, C, ...) for F.batch_norm
        xx = x if self.channel_axis == 1 else x.reshape(-1, self.features)
        if not self.training:
            y = F.batch_norm(xx, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, BN_EPS)
            return y.reshape(x.shape)
        y = F.batch_norm(xx, None, None, self.weight, self.bias, True, 0.0, BN_EPS)
        with torch.no_grad():
            dims = [0] + list(range(2, xx.dim()))
            var, mean = torch.var_mean(xx, dim=dims, correction=0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y.reshape(x.shape)


class FeatureNet(nn.Module):
    """num_layers x [Dense -> act -> BatchNorm] over (B, T, D), shared over
    the time axis."""

    def __init__(self, in_features: int, units: int = 32, num_layers: int = 2,
                 activation="relu", dtype=None):
        super().__init__()
        self.act = get_activation(activation)
        self.dtype = dtype
        dims = [in_features] + [units] * num_layers
        for i in range(num_layers):
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))
            self.add_module(f"BatchNorm_{i}", BatchNorm(units))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"BatchNorm_{i}")(self.act(getattr(self, f"Dense_{i}")(x)))
        return x


class ControlBranch(nn.Module):
    """num_layers x [BatchNorm -> Dense(units) -> act] over the dynamics
    feature (reference core/networks.py:59-66)."""

    def __init__(self, in_features: int, units: int = 320, num_layers: int = 2,
                 activation="swish6", dtype=None):
        super().__init__()
        self.act = get_activation(activation)
        self.dtype = dtype
        dims = [in_features] + [units] * num_layers
        for i in range(num_layers):
            self.add_module(f"BatchNorm_{i}", BatchNorm(dims[i]))
            self.add_module(f"Dense_{i}", Dense(dims[i], dims[i + 1], dtype=dtype))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        for i in range(self.num_layers):
            x = self.act(getattr(self, f"Dense_{i}")(getattr(self, f"BatchNorm_{i}")(x)))
        return x


class LinearCombination(nn.Module):
    """BatchNorm -> Dense(units, linear) (reference core/networks.py:24-30)."""

    def __init__(self, in_features: int, units: int = 32, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Dense_0 = Dense(in_features, units, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        return self.Dense_0(self.BatchNorm_0(x))


# ------------------------------------------------------------------
# flax's initialisers, for training from scratch
# ------------------------------------------------------------------

def _fans(weight: torch.Tensor):
    """flax's fans of a Dense kernel (in, out) or a Conv kernel
    (kh, kw, in / groups, out), from the torch weight (out, in) or
    (out, in / groups, kh, kw)."""
    rf = weight[0, 0].numel() if weight.dim() > 2 else 1
    return weight.shape[1] * rf, weight.shape[0] * rf


@torch.no_grad()
def glorot_uniform_(weight: torch.Tensor, gen: torch.Generator) -> None:
    fan_in, fan_out = _fans(weight)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    weight.uniform_(-limit, limit, generator=gen)


@torch.no_grad()
def orthogonal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's orthogonal initialiser of a square recurrent kernel: Q of the
    QR factorisation of a normal matrix, its columns signed by R's
    diagonal."""
    q, r = torch.linalg.qr(torch.randn(weight.shape, generator=gen,
                                       device=weight.device, dtype=weight.dtype))
    weight.copy_(q * torch.sign(torch.diagonal(r))[None])


@torch.no_grad()
def init_flax_(module: nn.Module, gen: torch.Generator) -> None:
    """Initialise `module` as the JAX package's flax modules initialise:
    glorot-uniform Dense and Conv kernels (every Dense and Conv of the
    network names it), orthogonal recurrent kernels in the GRU cells, zero
    biases, BatchNorm scale 1 and bias 0 (running mean 0, variance 1)."""
    from carla_driving_rl_agent_torch.models.recurrent import FlaxGRUCell
    recurrent = set()
    for m in module.modules():          # a cell comes before its children
        if isinstance(m, FlaxGRUCell):
            recurrent.update(id(getattr(m, n)) for n in ("hr", "hz", "hn"))
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            if id(m) in recurrent:
                orthogonal_(m.weight, gen)
            else:
                glorot_uniform_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
