"""The CARLA agent network: shared dynamics backbone, the trainable Beta
policy, its `old_policy` copy that drives rollouts, and the value head.

Counterpart of carla_driving_rl_agent_tpu/models/carla_network.py
(reference core/networks.py, architecture spec core/carla_agent.py:61-68):

  image      -> ShuffleNetV2(g, last_channels) shared over T -> GRU(256)
  road       -> FeatureNet(16x2, relu6)                      -> GRU(32)
  vehicle    -> FeatureNet(16x2, relu6)                      -> GRU(32)
  navigation -> FeatureNet(16x2, relu6)                      -> GRU(32)
  concat -> BatchNorm -> Dense(512, linear)    ("dynamics" feature)

  policy: ControlBranch(320x2, swish6) -> Beta(softplus(z) + 1.01) + aux
          speed (2*sigmoid) and similarity (tanh) heads
  value:  ControlBranch -> (base = tanh, exp = 6*sigmoid) + the same aux heads

Submodule names follow the flax parameter tree, so utils/checkpoint.py maps
a JAX checkpoint onto `state_dict()` name by name.

`compute_dtype=torch.bfloat16` computes the backbone, the GRUs, the
dynamics' linear combination and the heads' control branches in bfloat16
with flax's dtype rules (models/layers.py): the parameters stay float32,
the dynamics feature and the branches' outputs are cast back to float32,
so the Beta head, the value head and every loss stay float32 (JAX
carla_network.py:77,98,123).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from carla_driving_rl_agent_torch.models.distributions import Beta
from carla_driving_rl_agent_torch.models.layers import (
    BatchNorm, ControlBranch, FeatureNet, LinearCombination)
from carla_driving_rl_agent_torch.models.recurrent import GRU
from carla_driving_rl_agent_torch.models.shufflenet import ShuffleNetV2

DEFAULT_CONTROL = dict(units=320, num_layers=2, activation="swish6")
DEFAULT_DYNAMICS = dict(
    road=dict(units=16, num_layers=2, activation="relu6"),
    vehicle=dict(units=16, num_layers=2, activation="relu6"),
    navigation=dict(units=16, num_layers=2, activation="relu6"),
    shufflenet=dict(g=1.0, last_channels=768),
    rnn=dict(image=256, road=32, vehicle=32, navigation=32),
    dynamics=dict(units=512),
)


class DynamicsModel(nn.Module):
    def __init__(self, spec: Optional[Dict[str, Any]] = None, image_channels: int = 3,
                 road_dim: int = 9, vehicle_dim: int = 4, nav_dim: int = 5, dtype=None):
        super().__init__()
        s = dict(DEFAULT_DYNAMICS)
        s.update(spec or {})
        rnn = s["rnn"]
        self.dtype = dtype
        self.ShuffleNetV2_0 = ShuffleNetV2(in_channels=image_channels, dtype=dtype,
                                           **s["shufflenet"])
        self.FeatureNet_0 = FeatureNet(road_dim, dtype=dtype, **s["road"])
        self.FeatureNet_1 = FeatureNet(vehicle_dim, dtype=dtype, **s["vehicle"])
        self.FeatureNet_2 = FeatureNet(nav_dim, dtype=dtype, **s["navigation"])
        self.GRU_0 = GRU(s["shufflenet"]["last_channels"], rnn["image"], dtype)
        self.GRU_1 = GRU(s["road"]["units"], rnn["road"], dtype)
        self.GRU_2 = GRU(s["vehicle"]["units"], rnn["vehicle"], dtype)
        self.GRU_3 = GRU(s["navigation"]["units"], rnn["navigation"], dtype)
        n_in = rnn["image"] + rnn["road"] + rnn["vehicle"] + rnn["navigation"]
        self.LinearCombination_0 = LinearCombination(n_in, dtype=dtype, **s["dynamics"])

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        image = self.GRU_0(self.ShuffleNetV2_0(obs["state_image"]))
        road = self.GRU_1(self.FeatureNet_0(obs["state_road"]))
        vehicle = self.GRU_2(self.FeatureNet_1(obs["state_vehicle"]))
        nav = self.GRU_3(self.FeatureNet_2(obs["state_navigation"]))
        out = self.LinearCombination_0(torch.cat([image, road, vehicle, nav], dim=-1))
        return out if self.dtype is None else out.to(torch.float32)


class PolicyHead(nn.Module):
    def __init__(self, in_features: int = 512, num_actions: int = 2,
                 spec: Optional[Dict[str, Any]] = None, dtype=None):
        super().__init__()
        s = dict(DEFAULT_CONTROL)
        s.update(spec or {})
        # leaky floor on the concentration pre-activations (the JAX package's
        # saturation guard; safe-s5 trains with preact_floor = -3)
        self.preact_floor = s.pop("preact_floor", None)
        self.dtype = dtype
        self.ControlBranch_0 = ControlBranch(in_features, dtype=dtype, **s)
        self.alpha = nn.Linear(s["units"], num_actions)
        self.beta = nn.Linear(s["units"], num_actions)
        self.pi_similarity = nn.Linear(s["units"], 1)
        self.pi_speed = nn.Linear(s["units"], 1)

    def forward(self, feat: torch.Tensor) -> dict:
        x = self.ControlBranch_0(feat)
        x = x if self.dtype is None else x.to(torch.float32)
        za, zb = self.alpha(x), self.beta(x)
        if self.preact_floor is not None:
            f = float(self.preact_floor)
            za = torch.where(za > f, za, f + 0.05 * (za - f))
            zb = torch.where(zb > f, zb, f + 0.05 * (zb - f))
        return dict(dist=Beta(alpha=F.softplus(za) + 1.01, beta=F.softplus(zb) + 1.01),
                    speed=2.0 * torch.sigmoid(self.pi_speed(x)),
                    similarity=torch.tanh(self.pi_similarity(x)))


class ValueHead(nn.Module):
    def __init__(self, in_features: int = 512, spec: Optional[Dict[str, Any]] = None,
                 exp_scale: float = 6.0, dtype=None):
        super().__init__()
        s = dict(DEFAULT_CONTROL)
        s.update(spec or {})
        self.exp_scale = exp_scale
        self.dtype = dtype
        self.ControlBranch_0 = ControlBranch(in_features, dtype=dtype, **s)
        self.v_base = nn.Linear(s["units"], 1)
        self.v_exp = nn.Linear(s["units"], 1)
        self.v_speed = nn.Linear(s["units"], 1)
        self.v_similarity = nn.Linear(s["units"], 1)

    def forward(self, feat: torch.Tensor) -> dict:
        x = self.ControlBranch_0(feat)
        x = x if self.dtype is None else x.to(torch.float32)
        value = torch.cat([torch.tanh(self.v_base(x)),
                           self.exp_scale * torch.sigmoid(self.v_exp(x))], dim=-1)
        return dict(value=value, speed=2.0 * torch.sigmoid(self.v_speed(x)),
                    similarity=torch.tanh(self.v_similarity(x)))


class CARLANetwork(nn.Module):
    """dynamics + policy + old_policy + value, each a module whose
    parameters one optimizer owns (reference core/carla_agent.py:108-124).

    With `fused_units=True` the backbone's stride-1 units run as fused ops
    (models/shufflenet.ShuffleUnit); the parameter tree does not change, nor
    does it with `compute_dtype` (None: the parameters' dtype; or
    torch.bfloat16).

    `old_policy` has its own parameters but reads the policy's BatchNorm
    running statistics: the JAX package keeps one `policy` statistics tree
    for both (carla_network.policy_apply), so the policy phase's updates of
    those statistics reach the rollout's old policy at once.  The buffers
    are shared tensors, tied again after every device or dtype move."""

    def __init__(self, num_actions: int = 2, control_policy: Optional[dict] = None,
                 control_value: Optional[dict] = None, dynamics: Optional[dict] = None,
                 exp_scale: float = 6.0, image_channels: int = 3, nav_dim: int = 5,
                 fused_units: bool = False, compute_dtype=None):
        super().__init__()
        self.exp_scale = exp_scale
        dyn_spec = dict(dynamics or {})
        if fused_units:
            # merge the flag into the shufflenet sub-spec, keeping its g and
            # last_channels (JAX CARLANetwork.__init__)
            sn = dict(DEFAULT_DYNAMICS["shufflenet"])
            sn.update(dyn_spec.get("shufflenet", {}))
            sn["fused_units"] = True
            dyn_spec["shufflenet"] = sn
        self.dynamics = DynamicsModel(dyn_spec, image_channels=image_channels,
                                      nav_dim=nav_dim, dtype=compute_dtype)
        units = self.dynamics.LinearCombination_0.Dense_0.out_features
        self.policy = PolicyHead(units, num_actions, control_policy, compute_dtype)
        self.old_policy = PolicyHead(units, num_actions, control_policy, compute_dtype)
        self.value = ValueHead(units, control_value, exp_scale, compute_dtype)
        self._tie_old_policy_stats()
        self.update_old_policy()
        self.eval()

    def _tie_old_policy_stats(self) -> None:
        for bn_old, bn in zip(self.old_policy.modules(), self.policy.modules()):
            if isinstance(bn, BatchNorm):
                bn_old.running_mean = bn.running_mean
                bn_old.running_var = bn.running_var

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._tie_old_policy_stats()
        return self

    @torch.no_grad()
    def update_old_policy(self) -> None:
        """Copy policy -> old_policy (reference core/networks.py:281-285)."""
        for o, p in zip(self.old_policy.parameters(), self.policy.parameters()):
            o.copy_(p)

    # ---- forward passes (JAX carla_network.py:180-203) ----
    def dynamics_apply(self, obs: Dict[str, torch.Tensor], training: bool = False):
        """The dynamics feature; in training mode the BatchNorms use and fold
        the batch statistics.  A network held in float64 (.double(), for
        comparisons free of float32 rounding) takes its float inputs in
        float64."""
        self.dynamics.train(training)
        if next(self.parameters()).dtype == torch.float64:
            obs = {k: v.double() if v.is_floating_point() else v for k, v in obs.items()}
        return self.dynamics(obs)

    def policy_apply(self, feat: torch.Tensor, training: bool = False,
                     old: bool = False) -> dict:
        head = self.old_policy if old else self.policy
        head.train(training)
        return head(feat)

    def value_apply(self, feat: torch.Tensor, training: bool = False) -> dict:
        self.value.train(training)
        return self.value(feat)

    @torch.no_grad()
    def predict(self, obs: Dict[str, torch.Tensor], gen: torch.Generator,
                num_samples: Optional[int] = None, sampler=None) -> dict:
        """Rollout-time prediction (reference core/networks.py:181-193):
        dynamics -> old_policy sample + value, in inference mode.  `obs`
        holds state_image (B, T, H, W, C), state_road, state_vehicle and
        state_navigation (B, T, D); the `action` input of the reference is
        never wired into its graph and is not read here either.  With
        `num_samples=n`, action and log_prob have a leading (n,) axis: n iid
        draws from one forward pass, for the block rollout (the stacked
        observation is constant between frame pushes).  `sampler(dist, gen,
        num_samples)`, when given, draws the samples instead (the sharded
        rollout's, which draws for every rank's worlds: parallel/mesh.py)."""
        feat = self.dynamics_apply(obs)
        pol = self.policy_apply(feat, old=True)
        val = self.value_apply(feat)
        dist: Beta = pol["dist"]
        if sampler is not None:
            sample = sampler(dist, gen, num_samples)
        else:
            sample = dist.sample(gen) if num_samples is None else dist.sample_n(gen, num_samples)
        action = dist.clip(sample)
        return dict(action=action, mean=dist.mean(), std=dist.stddev(),
                    log_prob=dist.log_prob(action), value=val["value"],
                    speed=pol["speed"], similarity=pol["similarity"])
