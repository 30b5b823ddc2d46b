"""Generic policy and value networks for simple (non-CARLA) environments.

Counterpart of carla_driving_rl_agent_tpu/models/networks.py (reference
rl/networks/networks.py: the distribution factory :72-109, the MLP with
LayerNorm blocks :179-209, the (base, exp) value head :228-247).  Module
names follow the flax tree (MLPTorso_0, Dense_0, LayerNorm_0, alpha, ...)
so that `utils/checkpoint.ppo_params_from_jax` maps it one to one; a torch
Linear holds flax's (in, out) kernel transposed, and LayerNorm takes flax's
epsilon, 1e-6 (torch's default is 1e-5).

The torch modules need the input width at construction, where flax infers
it at init: PPONetwork takes `obs_dim`.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from carla_driving_rl_agent_torch.models.distributions import Beta, Categorical, Gaussian
from carla_driving_rl_agent_torch.models.layers import glorot_uniform_
from carla_driving_rl_agent_torch.utils.activations import get_activation

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from `gen` (flax nn.Dropout)."""
    keep = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MLPTorso(nn.Module):
    """Dense -> LayerNorm -> [Dense, Dense, LayerNorm] x (num_layers / 2)
    (reference `policy_layers`, rl/networks/networks.py:179-209); dropout
    after each block Dense, only when called with training=True."""

    def __init__(self, in_features: int, units: int = 32, num_layers: int = 2,
                 activation: Any = "swish", dropout: float = 0.0, linear_units: int = 0):
        super().__init__()
        self.act = get_activation(activation)
        self.dropout = dropout
        self.blocks = len(range(0, num_layers, 2))
        self.Dense_0 = nn.Linear(in_features, units)
        self.LayerNorm_0 = nn.LayerNorm(units, eps=LN_EPS)
        for i in range(self.blocks):
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(units, units))
            setattr(self, f"Dense_{2 * i + 2}", nn.Linear(units, units))
            setattr(self, f"LayerNorm_{i + 1}", nn.LayerNorm(units, eps=LN_EPS))
        self.linear_units = linear_units
        if linear_units > 0:
            setattr(self, f"Dense_{2 * self.blocks + 1}", nn.Linear(units, linear_units))
        self.out_features = linear_units or units

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.LayerNorm_0(self.act(self.Dense_0(x)))
        drop = training and self.dropout > 0
        for i in range(self.blocks):
            x = self.act(getattr(self, f"Dense_{2 * i + 1}")(x))
            if drop:
                x = _dropout(x, self.dropout, gen)
            x = self.act(getattr(self, f"Dense_{2 * i + 2}")(x))
            if drop:
                x = _dropout(x, self.dropout, gen)
            x = getattr(self, f"LayerNorm_{i + 1}")(x)
        if self.linear_units > 0:
            x = getattr(self, f"Dense_{2 * self.blocks + 1}")(x)
        return x


class PolicyMLP(nn.Module):
    """MLP torso + a Beta, Gaussian or Categorical head (reference
    rl/networks/networks.py:72-109)."""

    def __init__(self, in_features: int, num_actions: int, distribution: str = "beta",
                 num_classes: int = 2, spec: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.MLPTorso_0 = MLPTorso(in_features, **(spec or {}))
        self.num_actions, self.distribution, self.num_classes = (
            num_actions, distribution, num_classes)
        u = self.MLPTorso_0.out_features
        if distribution == "beta":
            self.alpha = nn.Linear(u, num_actions)
            self.beta = nn.Linear(u, num_actions)
        elif distribution == "gaussian":
            self.mu = nn.Linear(u, num_actions)
            self.log_std = nn.Parameter(torch.zeros(num_actions))
        else:
            self.logits = nn.Linear(u, num_actions * num_classes)

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None):
        torso = self.MLPTorso_0(x, training, gen)
        if self.distribution == "beta":
            return Beta(alpha=F.softplus(self.alpha(torso)) + 1.01,
                        beta=F.softplus(self.beta(torso)) + 1.01)
        if self.distribution == "gaussian":
            mu = self.mu(torso)
            return Gaussian(mu=mu, log_std=self.log_std.expand(mu.shape))
        logits = self.logits(torso)
        return Categorical(logits=logits.reshape(
            logits.shape[:-1] + (self.num_actions, self.num_classes)))


class ValueMLP(nn.Module):
    """MLP torso + the (base, exp) value head (reference
    rl/networks/networks.py:228-247); `components > 1` mixes that many
    heads with softmax weights (:232-244)."""

    def __init__(self, in_features: int, spec: Optional[Dict[str, Any]] = None,
                 exponent_scale: float = 6.0, components: int = 1):
        super().__init__()
        self.MLPTorso_0 = MLPTorso(in_features, **(spec or {}))
        self.exponent_scale, self.components = exponent_scale, components
        u = self.MLPTorso_0.out_features
        self.v_base = nn.Linear(u, components)
        self.v_exp = nn.Linear(u, components)
        if components > 1:
            self.w_base = nn.Linear(u, components)
            self.w_exp = nn.Linear(u, components)

    def forward(self, x: torch.Tensor, training: bool = False,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        torso = self.MLPTorso_0(x, training, gen)
        base = torch.tanh(self.v_base(torso))
        exp = self.exponent_scale * torch.sigmoid(self.v_exp(torso))
        if self.components > 1:
            base = torch.sum(base * torch.softmax(self.w_base(torso), dim=-1), dim=-1,
                             keepdim=True)
            exp = torch.sum(exp * torch.softmax(self.w_exp(torso), dim=-1), dim=-1,
                            keepdim=True)
        return torch.cat([base, exp], dim=-1)


@torch.no_grad()
def init_glorot_(module: nn.Module, gen: torch.Generator) -> None:
    """flax's initialisers: glorot-uniform Dense kernels, zero biases and
    log_std, LayerNorm scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            glorot_uniform_(m.weight, gen)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, PolicyMLP) and m.distribution == "gaussian":
            m.log_std.zero_()


class PPONetwork(nn.Module):
    """policy, old_policy and value with the (base, exp) head, as the
    reference's PPONetwork."""

    def __init__(self, obs_dim: int, num_actions: int, distribution: str = "beta",
                 num_classes: int = 2, policy: Optional[dict] = None,
                 value: Optional[dict] = None, exponent_scale: float = 6.0,
                 components: int = 1):
        super().__init__()
        self.exp_scale = exponent_scale
        self.policy = PolicyMLP(obs_dim, num_actions, distribution, num_classes, policy or {})
        self.old_policy = copy.deepcopy(self.policy)
        self.value = ValueMLP(obs_dim, value or {}, exponent_scale, components)

    def init(self, gen: torch.Generator) -> "PPONetwork":
        """Fresh flax-style parameters from `gen` (policy, then value), and
        old_policy = policy."""
        init_glorot_(self.policy, gen)
        init_glorot_(self.value, gen)
        self.update_old_policy()
        return self

    def policy_dist(self, state: torch.Tensor, old: bool = False):
        return (self.old_policy if old else self.policy)(state)

    @torch.no_grad()
    def predict(self, state: torch.Tensor, gen: torch.Generator,
                sample: Optional[torch.Tensor] = None) -> dict:
        """(action, mean, std, log_prob, value) with the action sampled from
        the OLD policy (reference rl/networks/networks.py:130-144), or the
        given raw `sample` (a test injects JAX's)."""
        dist = self.policy_dist(state, old=True)
        action = dist.clip(dist.sample(gen) if sample is None else sample)
        return dict(action=action, mean=dist.mean(), std=dist.stddev(),
                    log_prob=dist.log_prob(action), value=self.value(state))

    @torch.no_grad()
    def update_old_policy(self) -> None:
        self.old_policy.load_state_dict(self.policy.state_dict())
