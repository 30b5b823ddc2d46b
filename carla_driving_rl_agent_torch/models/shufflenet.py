"""ShuffleNet-V2 backbone, weight-shared over the time axis.

Counterpart of carla_driving_rl_agent_tpu/models/shufflenet.py (reference
core/architectures.py:30-173): frames are folded into the batch, (B, T, H,
W, C) -> (B*T, C, H, W), so one set of weights processes all frames.  The
public input keeps the JAX package's channel-last layout; inside, the
convolutions run channel-first.

flax's "SAME" padding puts the odd pixel of a stride-2 window at the end
(lo = total // 2, hi = total - lo); `_same_pad` reproduces it with an
explicit F.pad (with -inf for the max pool), since torch's symmetric
`padding=1` would shift every stride-2 output on even sizes.

With `fused_units=True` every stride-1 unit runs as one fused op
(ops/shuffle_unit.py: the CUDA kernels on the card, their plain versions on
the CPU), as the JAX package's `fused_units` dispatches to its Pallas
kernels; stride-2 units stay unfused there and here.  The parameter and
statistics tree is the same either way.

`dtype` (bfloat16 for CARLAgentConfig.compute_dtype "bfloat16") is
flax's: the frames are cast at entry, every convolution computes in it
(models/layers.Conv) and every BatchNorm returns it, so the activations
between units are bfloat16; the fused units then run their bfloat16
kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from carla_driving_rl_agent_torch.models.layers import BatchNorm, Conv
from carla_driving_rl_agent_torch.ops import shuffle_unit as fused_unit
from carla_driving_rl_agent_torch.utils.activations import leaky_relu6

CHANNELS = {
    0.5: [48, 96, 192],
    1.0: [116, 232, 464],
    1.5: [176, 352, 704],
    2.0: [244, 488, 976],
    0.75: [82, 164, 328],
    1.25: [146, 292, 584],
    1.75: [210, 420, 840],
}


def _bn2d(c: int) -> BatchNorm:
    return BatchNorm(c, channel_axis=1)


def _same_pad(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad (N, C, H, W) as flax/XLA "SAME" does for a k x k window at
    stride s."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad wants W first
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """(N, C, H, W) channel shuffle (reference core/architectures.py:109-118)."""
    n, c, h, w = x.shape
    return x.reshape(n, c // groups, groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class _BNAct(nn.Module):
    def __init__(self, c: int, leak: float = 0.0):
        super().__init__()
        self.BatchNorm_0 = _bn2d(c)
        self.leak = leak

    def forward(self, x):
        return leaky_relu6(self.BatchNorm_0(x), self.leak)


class ShuffleUnit(nn.Module):
    """One ShuffleNet-V2 unit (reference core/architectures.py:120-145):
    1x1 conv -> BN/act -> 3x3 depthwise (stride) -> BN -> 1x1 conv -> BN/act
    on one half (stride 1) or all (stride 2) of the channels, a strided
    depthwise + 1x1 shortcut at stride 2, concat, channel shuffle.

    A stride-1 unit with `fused=True` runs as one fused op on its own
    parameters (JAX ShuffleUnit._fused_call): in training mode it folds the
    op's batch statistics into its BatchNorm buffers itself, once, as
    0.99 * running + 0.01 * batch with the biased variance."""

    def __init__(self, in_channels: int, num_channels: int, stride: int,
                 leak: float = 0.0, fused: bool = False, dtype=None):
        super().__init__()
        self.stride = stride
        self.leak = leak
        self.fused = fused and stride == 1
        sc = in_channels // 2 if stride == 1 else in_channels   # shortcut channels
        bi = in_channels - sc if stride == 1 else in_channels   # branch input
        mid = num_channels // 2
        self.Conv_0 = Conv(bi, mid, 1, dtype=dtype)
        self.BatchNorm_0 = _bn2d(mid)
        self.Conv_1 = Conv(mid, mid, 3, stride=stride, groups=mid, dtype=dtype)
        self.BatchNorm_1 = _bn2d(mid)
        self.Conv_2 = Conv(mid, num_channels - sc, 1, dtype=dtype)
        self.BatchNorm_2 = _bn2d(num_channels - sc)
        if stride == 2:
            self.Conv_3 = Conv(sc, sc, 3, stride=2, groups=sc, dtype=dtype)
            self.BatchNorm_3 = _bn2d(sc)
            self.Conv_4 = Conv(sc, sc, 1, dtype=dtype)
            self.BatchNorm_4 = _bn2d(sc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self._fused_forward(x)
        if self.stride == 1:
            shortcut, branch = x.chunk(2, dim=1)
        else:
            shortcut, branch = x, x
        branch = leaky_relu6(self.BatchNorm_0(self.Conv_0(branch)), self.leak)
        branch = self.BatchNorm_1(self.Conv_1(_same_pad(branch, 3, self.stride)))
        branch = leaky_relu6(self.BatchNorm_2(self.Conv_2(branch)), self.leak)
        if self.stride == 2:
            shortcut = self.BatchNorm_3(self.Conv_3(_same_pad(shortcut, 3, 2)))
            shortcut = leaky_relu6(self.BatchNorm_4(self.Conv_4(shortcut)), self.leak)
        return channel_shuffle(torch.cat([shortcut, branch], dim=1))

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return fused_unit.shuffle_unit_infer(x, self)
        out, stats = fused_unit.shuffle_unit_train(x, self)
        with torch.no_grad():
            buffers = fused_unit.running_stats(self)
            torch._foreach_lerp_(list(buffers), list(stats.unbind(0)),
                                 1.0 - BatchNorm.momentum)
        return out


class ShuffleNetV2(nn.Module):
    """Backbone over (B, T, H, W, C) -> (B, T, last_channels)."""

    def __init__(self, in_channels: int = 3, g: float = 1.0, leak: float = 0.0,
                 last_channels: int = 1024, fused_units: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        if g not in CHANNELS:
            raise ValueError(f"g={g} not in {sorted(CHANNELS)}")
        self.last_channels = last_channels
        # stem: conv 24f 3x3 s2 VALID + BN/ReLU6 + maxpool 3 s2 SAME
        self.Conv_0 = Conv(in_channels, 24, 3, stride=2, dtype=dtype)
        self._BNAct_0 = _BNAct(24, leak)
        c_in, i = 24, 0
        for c, blocks in zip(CHANNELS[g], (4, 8, 4)):
            for j in range(blocks):
                self.add_module(f"ShuffleUnit_{i}", ShuffleUnit(
                    c_in, c, stride=2 if j == 0 else 1, leak=leak, fused=fused_units,
                    dtype=dtype))
                c_in, i = c, i + 1
        self.num_units = i
        self.Conv_1 = Conv(c_in, last_channels, 1, dtype=dtype)
        self._BNAct_1 = _BNAct(last_channels, leak)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[0], x.shape[1]
        x = x.reshape((b * t,) + tuple(x.shape[2:])).permute(0, 3, 1, 2)
        x = x if self.dtype is None else x.to(self.dtype)
        x = self._BNAct_0(self.Conv_0(x))
        x = F.max_pool2d(_same_pad(x, 3, 2, value=float("-inf")), 3, stride=2)
        for i in range(self.num_units):
            x = getattr(self, f"ShuffleUnit_{i}")(x)
        x = self._BNAct_1(self.Conv_1(x))
        return x.mean(dim=(2, 3)).reshape(b, t, self.last_channels)
