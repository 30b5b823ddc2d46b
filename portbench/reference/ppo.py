"""The agent's PPO minibatch steps in plain float32 PyTorch, on the
parameter dict of reference/network.py: the reference that the benchmark
follows the port's first update steps with.  It imports nothing of the port.

The objectives are the reference agent's (core/carla_agent.py:394-486 over
rl/agents/ppo.py, as the shipped trainer runs them):
  * policy: PPO-clip on the ratio averaged over the action dimensions,
    minus entropy_regularization x the mean entropy, plus
    aux x 0.5 x (speed MSE + similarity MSE);
  * value: 0.25 MSE(base) + MSE(exp) / 6^2, plus aux x (speed MSE +
    similarity MSE), the whole x 0.25.
A policy step clips each gradient tensor of the policy head and of the
backbone to norm 1 (non-finite entries zeroed first) and takes one Adam
step of each; a value step the same for the value head and the backbone,
through the backbone's one Adam state.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import network as ref

GROUPS = dict(policy=("policy",), value=("value",))


def trainable(p: Dict[str, torch.Tensor], head: str) -> List[str]:
    """The trainable tensors of `head` (dynamics, policy, value): its
    parameters, not its BatchNorm statistics."""
    return [k for k in p if k.startswith(head + ".")
            and not k.endswith(("running_mean", "running_var"))]


def policy_loss(p, batch: dict, hyper: dict, preact_floor=None):
    feat = ref.dynamics(p, batch["obs"], training=True)
    pol = ref.policy(p, feat, training=True, preact_floor=preact_floor)
    a, b = pol["alpha"], pol["beta"]
    log_prob = ref.beta_log_prob(a, b, batch["obs"]["action"])
    entropy = ref.beta_entropy(a, b).mean()
    adv = batch["advantages"]
    ratio = torch.exp(log_prob - batch["log_prob"]).mean(dim=1)
    clip = hyper["clip_ratio"]
    clipped = torch.where(adv > 0.0, (1.0 + clip) * adv, (1.0 - clip) * adv)
    loss = -torch.minimum(ratio * adv, clipped).mean()
    aux = 0.5 * ((batch["speed"] - pol["speed"][:, 0]) ** 2).mean() \
        + 0.5 * ((batch["similarity"] - pol["similarity"][:, 0]) ** 2).mean()
    return loss - hyper["entropy"] * entropy + hyper.get("aux", 1.0) * aux


def value_loss(p, batch: dict, hyper: dict):
    feat = ref.dynamics(p, batch["obs"], training=True)
    val = ref.value(p, feat, training=True)
    v, ret = val["value"], batch["returns"]
    loss = 0.25 * ((ret[:, 0] - v[:, 0]) ** 2).mean() + ((ret[:, 1] - v[:, 1]) ** 2).mean() / 36.0
    aux = ((batch["speed"] - val["speed"][:, 0]) ** 2).mean() \
        + ((batch["similarity"] - val["similarity"][:, 0]) ** 2).mean()
    return (loss + hyper.get("aux", 1.0) * aux) * 0.25


def clip_each(grads: Dict[str, torch.Tensor], norm: float) -> Dict[str, torch.Tensor]:
    out = {}
    for k, g in grads.items():
        g = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
        n = torch.linalg.vector_norm(g)
        out[k] = g * torch.clamp(norm / torch.clamp(n, min=1e-12), max=1.0)
    return out


class Adam:
    """Adam with bias correction (b1 0.9, b2 0.999, eps 1e-8), one state per
    tensor name; `state` maps a name to the (first moment, second moment,
    step count) to start from."""

    def __init__(self, lr: float, state: Optional[dict] = None):
        self.lr, self.m, self.v, self.t = lr, {}, {}, {}
        for k, (m, v, t) in (state or {}).items():
            self.m[k], self.v[k], self.t[k] = m, v, int(t)

    def step(self, p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * 0.9 + 0.1 * g
            v = self.v.get(k, torch.zeros_like(g)) * 0.999 + 0.001 * g * g
            t = self.t.get(k, 0) + 1
            self.m[k], self.v[k], self.t[k] = m, v, t
            m_hat = m / (1.0 - 0.9 ** t)
            v_hat = v / (1.0 - 0.999 ** t)
            p[k] = p[k] - self.lr * m_hat / (torch.sqrt(v_hat) + 1e-8)


class Learner:
    """The three Adam states (policy, value, backbone) over a parameter
    dict, stepped as the shipped sequential update steps them; `adam` gives
    each group's state to start from (fresh where it is left out)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float = 3e-4,
                 clip_norm: float = 1.0, preact_floor=None, adam: Optional[dict] = None):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        adam = adam or {}
        self.opt = {g: Adam(lr, adam.get(g)) for g in ("policy", "value", "dynamics")}
        self.clip_norm = clip_norm
        self.preact_floor = preact_floor
        # the clipped gradients of each step, as the optimizers got them
        self.grads: List[Dict[str, torch.Tensor]] = []

    def step(self, phase: str, batch: dict, hyper: dict) -> float:
        head = "policy" if phase == "policy" else "value"
        names = trainable(self.p, head) + trainable(self.p, "dynamics")
        leaves = {k: self.p[k].detach().requires_grad_(True) for k in names}
        p = dict(self.p, **leaves)
        loss = (policy_loss(p, batch, hyper, self.preact_floor) if phase == "policy"
                else value_loss(p, batch, hyper))
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names],
                                                    allow_unused=True)))
        grads = clip_each({k: torch.zeros_like(leaves[k]) if g is None else g
                           for k, g in grads.items()}, self.clip_norm)
        self.grads.append(grads)
        with torch.no_grad():
            self.opt[head].step(self.p, {k: g for k, g in grads.items()
                                         if k.startswith(head + ".")})
            self.opt["dynamics"].step(self.p, {k: g for k, g in grads.items()
                                               if k.startswith("dynamics.")})
        return float(loss.detach())
