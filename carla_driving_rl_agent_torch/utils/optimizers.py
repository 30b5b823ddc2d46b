"""Optimizers (reference rl/utils.py:29-46); counterpart of
carla_driving_rl_agent_tpu/utils/optimizers.py.

The registry's eight optimizers, each with optax's update rule and defaults
(the JAX package builds them with optax): adadelta, adagrad, adam, adamax,
ftrl (the JAX package's own FTRL-Proximal), nadam, rmsprop and sgd.  One
optimizer per parameter group, its learning rate set from the host before
every update (`set_learning_rate`; the JAX package injects it into the
optax state).  Adam is PyTorch's fused Adam, on the card (one launch per
step instead of a dozen per group) and on the CPU alike, so that both
devices take the same arithmetic; its update is optax's.  The other seven are
small `torch.optim.Optimizer`s here: PyTorch's built-ins differ from optax
(RMSprop's decay 0.99 against optax's 0.9, Adagrad's initial accumulator
and the place of its eps, NAdam's momentum-decay schedule).

`flat=True` (CARLAgentConfig.flat_optimizer, the JAX package's
optax.flatten) runs a group's update math on one flat buffer that holds
every tensor of the group.  Each rule is elementwise, so the numbers are
those of the per-tensor optimizer, bit for bit.  As with optax.flatten, the
checkpoint layout differs: the optimizer's state_dict holds one parameter,
the flat buffer, whose state tensors are the concatenation of the
per-tensor ones in the group's order, where the per-tensor optimizer holds
one entry per tensor.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


class _Elementwise(torch.optim.Optimizer):
    """An optax rule applied tensor by tensor: `_init(p)` gives a tensor's
    state, `_direction(p, g, state, hp)` the update before the learning rate
    (optax's scale_by_* transformation), which is then scaled by -lr
    (scale_by_learning_rate) and added to the parameter (apply_updates).
    A tensor without a gradient is not stepped."""

    def __init__(self, params, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))

    def _init(self, p: torch.Tensor, hp: dict) -> dict:
        return {}

    def _direction(self, p, g, state: dict, hp: dict) -> torch.Tensor:
        raise NotImplementedError

    def _update(self, p, g, state: dict, hp: dict) -> torch.Tensor:
        return self._direction(p, g, state, hp) * -hp["lr"]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state.update(self._init(p, group))
                p.add_(self._update(p, p.grad, state, group))


class Adadelta(_Elementwise):
    """optax.adadelta(rho=0.9, eps=1e-6): e_g <- (1 - rho) g^2 + rho e_g;
    u = sqrt(e_x + eps) / sqrt(e_g + eps) * g; e_x <- (1 - rho) u^2 + rho e_x."""

    def __init__(self, params, lr: float, rho: float = 0.9, eps: float = 1e-6):
        super().__init__(params, lr, rho=rho, eps=eps)

    def _init(self, p, hp):
        return dict(e_g=torch.zeros_like(p), e_x=torch.zeros_like(p))

    def _direction(self, p, g, st, hp):
        rho, eps = hp["rho"], hp["eps"]
        st["e_g"] = (1 - rho) * (g * g) + rho * st["e_g"]
        u = torch.sqrt(st["e_x"] + eps) / torch.sqrt(st["e_g"] + eps) * g
        st["e_x"] = (1 - rho) * (u * u) + rho * st["e_x"]
        return u


class Adagrad(_Elementwise):
    """optax.adagrad(initial_accumulator_value=0.1, eps=1e-7): s <- g^2 + s;
    u = g / sqrt(s + eps) where s > 0, else 0 (optax's rsqrt)."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, lr, initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def _init(self, p, hp):
        return dict(sum_of_squares=torch.full_like(p, hp["initial_accumulator_value"]))

    def _direction(self, p, g, st, hp):
        s = st["sum_of_squares"] = g * g + st["sum_of_squares"]
        # 1 / sqrt for optax's rsqrt: sqrt and the division round correctly
        # on the card and the CPU alike, the card's rsqrt does not
        inv = torch.where(s > 0, 1.0 / torch.sqrt(s + hp["eps"]), torch.zeros_like(s))
        return inv * g


class Adamax(_Elementwise):
    """optax.adamax(b1=0.9, b2=0.999, eps=1e-8): mu <- (1 - b1) g + b1 mu;
    nu <- max(|g| + eps, b2 nu); u = mu / (1 - b1^t) / nu."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _init(self, p, hp):
        return dict(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _direction(self, p, g, st, hp):
        b1, b2 = hp["b1"], hp["b2"]
        st["count"] += 1
        st["mu"] = (1 - b1) * g + b1 * st["mu"]
        st["nu"] = torch.maximum(g.abs() + hp["eps"], b2 * st["nu"])
        return st["mu"] / (1 - b1 ** st["count"]) / st["nu"]


class NAdam(_Elementwise):
    """optax.nadam (adam with nesterov=True, b1=0.9, b2=0.999, eps=1e-8):
    mu, nu as Adam's; u = (b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t))
    / (sqrt(nu / (1 - b2^t)) + eps)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps)

    def _init(self, p, hp):
        return dict(count=0, mu=torch.zeros_like(p), nu=torch.zeros_like(p))

    def _direction(self, p, g, st, hp):
        b1, b2 = hp["b1"], hp["b2"]
        st["mu"] = (1 - b1) * g + b1 * st["mu"]
        st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
        t = st["count"] = st["count"] + 1
        mu_hat = b1 * (st["mu"] / (1 - b1 ** (t + 1))) + (1 - b1) * (g / (1 - b1 ** t))
        nu_hat = st["nu"] / (1 - b2 ** t)
        return mu_hat / (torch.sqrt(nu_hat) + hp["eps"])


class RMSprop(_Elementwise):
    """optax.rmsprop(decay=0.9, eps=1e-8, initial_scale=0): nu <- (1 -
    decay) g^2 + decay nu; u = g / sqrt(nu + eps) (optax's rsqrt, as
    Adagrad's)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, lr, decay=decay, eps=eps)

    def _init(self, p, hp):
        return dict(nu=torch.zeros_like(p))

    def _direction(self, p, g, st, hp):
        d = hp["decay"]
        st["nu"] = (1 - d) * (g * g) + d * st["nu"]
        return (1.0 / torch.sqrt(st["nu"] + hp["eps"])) * g


class SGD(_Elementwise):
    """optax.sgd without momentum: u = g."""

    def _direction(self, p, g, st, hp):
        return g


class Ftrl(_Elementwise):
    """The JAX package's FTRL-Proximal (utils/optimizers.py:16-55, the
    tf.keras Ftrl at its defaults): a <- a + g^2, sigma = (a'^-power -
    a^-power) / lr, z <- z + g - sigma p, p' = (clip(z, -l1, l1) - z) /
    (a'^-power / lr + 2 l2) (-z / ... with l1 = 0); the update is p' - p."""

    def __init__(self, params, lr: float, learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1, l1: float = 0.0, l2: float = 0.0):
        super().__init__(params, lr, learning_rate_power=learning_rate_power,
                         initial_accumulator_value=initial_accumulator_value, l1=l1, l2=l2)

    def _init(self, p, hp):
        return dict(accum=torch.full_like(p, hp["initial_accumulator_value"]),
                    linear=torch.zeros_like(p))

    def _update(self, p, g, st, hp):
        lr, power, l1, l2 = hp["lr"], hp["learning_rate_power"], hp["l1"], hp["l2"]
        a = st["accum"]
        new_a = a + g * g
        sigma = (new_a ** -power - a ** -power) / lr
        new_lin = st["linear"] + g - sigma * p
        quad = new_a ** -power / lr + 2.0 * l2
        pre = torch.clamp(new_lin, -l1, l1) - new_lin if l1 > 0 else -new_lin
        st["accum"], st["linear"] = new_a, new_lin
        return pre / quad - p


def _adam(params, lr: float) -> torch.optim.Optimizer:
    params = list(params)
    fused = bool(params) and all(p.device.type in ("cuda", "cpu") for p in params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=fused or None)


OPTIMIZERS = dict(adadelta=Adadelta, adagrad=Adagrad, adam=_adam, adamax=Adamax, ftrl=Ftrl,
                  nadam=NAdam, rmsprop=RMSprop, sgd=SGD)


class FlatOptimizer:
    """An optimizer over one flat buffer that holds the group's tensors
    (the JAX package's optax.flatten): `step` gathers the tensors and their
    gradients into the buffer, steps the inner optimizer on it and writes
    the result back.  The group's tensors stay the parameters the model
    holds; the buffer is the optimizer's own."""

    def __init__(self, make: Callable, params: Iterable[torch.Tensor], lr: float):
        self.params: List[torch.Tensor] = list(params)
        self._sizes = [p.numel() for p in self.params]
        flat = torch.cat([p.detach().reshape(-1) for p in self.params]) if self.params else \
            torch.zeros(0)
        self.flat = torch.nn.Parameter(flat)
        self.inner = make([self.flat], lr)

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @torch.no_grad()
    def step(self) -> None:
        if not self.params:
            return
        self.flat.copy_(torch.cat([p.reshape(-1) for p in self.params]))
        self.flat.grad = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                                    .reshape(-1) for p in self.params])
        self.inner.step()
        for p, v in zip(self.params, self.flat.split(self._sizes)):
            p.copy_(v.view_as(p))

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.flat.grad = None
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


def get_optimizer_by_name(name: str, params: Iterable[torch.nn.Parameter],
                          learning_rate: float = 1e-3, flat: bool = False):
    """The registry's optimizer `name` over `params`, with optax's defaults;
    `flat` runs its math on one flat buffer (FlatOptimizer).  An unknown
    name raises ValueError, as the JAX registry does."""
    make = OPTIMIZERS.get(name.lower())
    if make is None:
        raise ValueError(f"Cannot find optimizer {name}. Select one of {sorted(OPTIMIZERS)}.")
    if flat:
        return FlatOptimizer(make, params, learning_rate)
    return make(list(params), learning_rate)


def set_learning_rate(opt, learning_rate: float) -> None:
    """Set the learning rate of an optimizer, or of each of a tuple of them
    (the split backbone states, CARLAgentConfig.two_step_split_adam)."""
    for o in (opt if isinstance(opt, tuple) else (opt,)):
        for group in o.param_groups:
            group["lr"] = float(learning_rate)
