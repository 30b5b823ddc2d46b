"""Optimizers (reference rl/utils.py:29-46); counterpart of
carla_driving_rl_agent_tpu/utils/optimizers.py.

The shipped trainer uses Adam with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8), one optimizer per parameter group, its learning rate set from
the host before every update (the JAX package injects it into the optax
state).  The registry's other seven optimizers are not ported yet.
"""

from __future__ import annotations

from typing import Iterable

import torch


def get_optimizer_by_name(name: str, params: Iterable[torch.nn.Parameter],
                          learning_rate: float = 1e-3) -> torch.optim.Optimizer:
    """Adam over `params`; on the card, PyTorch's fused implementation (one
    launch per step instead of a dozen per group)."""
    if name.lower() != "adam":
        raise NotImplementedError(f"optimizer {name!r}: only 'adam' is ported")
    params = list(params)
    fused = bool(params) and all(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            fused=fused or None)


def set_learning_rate(opt: torch.optim.Optimizer, learning_rate: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(learning_rate)
