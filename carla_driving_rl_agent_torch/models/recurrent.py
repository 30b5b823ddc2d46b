"""GRU aggregation over the time-horizon axis (reference
core/networks.py:45-50, keras GRU with unroll=True); counterpart of
carla_driving_rl_agent_tpu/models/recurrent.py.

The cell keeps flax's GRUCell parameters one to one: input kernels ir, iz,
in with biases, recurrent kernels hr, hz without and hn with a bias.  The
learner clips each gradient tensor on its own (utils/math.clip_gradients),
so the tensors must be the flax ones: torch's GRUCell stacks the three
gates into one tensor and has hidden-side r and z biases that flax lacks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FlaxGRUCell(nn.Module):
    """flax.linen.GRUCell:
        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
        n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h."""

    def __init__(self, in_features: int, units: int):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(in_features, units))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, nn.Linear(units, units, bias=bias))


class GRU(nn.Module):
    """Final hidden state of a GRU run over (B, T, D), from a zero state.
    With `dtype` (bfloat16) the cell and its carry compute in it as flax's
    GRUCell(dtype=...) does: each product rounded, then its bias added
    (models/layers.py)."""

    def __init__(self, in_features: int, units: int, dtype=None):
        super().__init__()
        self.units = units
        self.dtype = dtype
        self.GRUCell_0 = FlaxGRUCell(in_features, units)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.GRUCell_0
        u = self.units
        g_in = getattr(c, "in")
        dt = self.dtype
        cast = (lambda t: t) if dt is None else (lambda t: t.to(dt))
        x = cast(x)
        # the three input projections of every step in one product
        w_i = cast(torch.cat([c.ir.weight, c.iz.weight, g_in.weight]))
        b_i = cast(torch.cat([c.ir.bias, c.iz.bias, g_in.bias]))
        xi = F.linear(x, w_i, b_i) if dt is None else F.linear(x, w_i) + b_i
        w_h, b_hn = cast(torch.cat([c.hr.weight, c.hz.weight, c.hn.weight])), cast(c.hn.bias)
        h = torch.zeros(x.shape[0], u, dtype=x.dtype, device=x.device)
        for t in range(x.shape[1]):
            hh = F.linear(h, w_h)
            r = torch.sigmoid(xi[:, t, :u] + hh[:, :u])
            z = torch.sigmoid(xi[:, t, u:2 * u] + hh[:, u:2 * u])
            n = torch.tanh(xi[:, t, 2 * u:] + r * (hh[:, 2 * u:] + b_hn))
            h = (1.0 - z) * n + z * h
        return h
