"""Generic PPO agent for simple batched envs (flat Box, MultiDiscrete or
Discrete action spaces).

Counterpart of carla_driving_rl_agent_tpu/agents/ppo.py (reference
rl/agents/ppo.py, the algorithm the CARLA agent specialises).  Unlike
CARLAgent: one policy and one value optimizer, no shared backbone or
auxiliary losses, and the PPO objective takes the new log-prob of the
STORED rollout actions (reference rl/agents/ppo.py:309-358).

One update (`train_iteration`) is, as in the JAX package's jitted program:
a rollout of `rollout_steps` steps over `num_envs` environments with the
old policy; GAE on the composed (base, exp) values, sign-preserving
max-norm advantages and reverse-scan returns decomposed into (base, exp);
one permutation of the samples, `optimization_steps[0]` epochs of policy
minibatches over it, then as many epochs of value minibatches over the same
permutation.  Python loops take the place of `lax.scan`; every tensor stays
on the agent's device until the update's metrics move to the host in one
transfer.  The rollout's samples, its reset draws and the permutation come
from the agent's generator unless given (a test feeds JAX's).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

from carla_driving_rl_agent_torch.agents.base import Agent
from carla_driving_rl_agent_torch.envs import spaces
from carla_driving_rl_agent_torch.models.networks import PPONetwork
from carla_driving_rl_agent_torch.utils import checkpoint as ckpt
from carla_driving_rl_agent_torch.utils import math as um
from carla_driving_rl_agent_torch.utils.optimizers import (
    get_optimizer_by_name, set_learning_rate)
from carla_driving_rl_agent_torch.utils.schedules import DynamicParameter


@dataclass
class PPOConfig:
    num_envs: int = 16
    rollout_steps: int = 128
    batch_size: int = 64
    gamma: float = 0.99
    lambda_: float = 0.95
    policy_lr: Any = 1e-3
    value_lr: Any = 3e-4
    clip_ratio: Any = 0.2
    entropy_regularization: Any = 0.0
    advantage_scale: Any = 2.0
    optimization_steps: Tuple[int, int] = (1, 1)
    clip_norm: Tuple[Optional[float], Optional[float]] = (1.0, 1.0)
    polyak: float = 1.0
    optimizer: str = "adam"
    repeat_action: int = 1
    seed: int = 42
    network: dict = field(default_factory=dict)


class PPOAgent(Agent):
    def __init__(self, env, config: Optional[PPOConfig] = None, name: str = "ppo-agent",
                 **kwargs):
        cfg = config or PPOConfig()
        super().__init__(env, name=name, batch_size=cfg.batch_size, seed=cfg.seed, **kwargs)
        self.config = cfg

        # the action-space adapter (reference rl/agents/ppo.py:148-181)
        a_space = env.action_space
        if isinstance(a_space, spaces.Box):
            self.num_actions = int(np.prod(a_space.shape))
            if a_space.is_bounded():
                self.distribution = "beta"
                self._low = torch.tensor(a_space.low, device=self.device)
                self._range = torch.tensor(a_space.high - a_space.low, device=self.device)
            else:
                self.distribution = "gaussian"
            num_classes = 2
        elif isinstance(a_space, spaces.MultiDiscrete):
            self.distribution = "categorical"
            if not np.all(a_space.nvec == a_space.nvec[0]):
                raise ValueError("a MultiDiscrete space needs equal class counts")
            self.num_actions = int(a_space.nvec.shape[0])
            num_classes = int(a_space.nvec[0]) + 1
        else:
            self.distribution = "categorical"
            self.num_actions = 1
            num_classes = int(a_space.n)

        spec = dict(cfg.network or {})
        obs_dim = int(np.prod(env.observation_space.shape))
        net = PPONetwork(obs_dim, self.num_actions, self.distribution, num_classes,
                         policy=spec.get("policy"), value=spec.get("value"),
                         exponent_scale=spec.get("exponent_scale", 6.0),
                         components=spec.get("components", 1))
        # flax's initialisers from a CPU generator: one seed, one network on
        # every device
        net.init(torch.Generator().manual_seed(self.seed))
        self.network = net.to(self.device)

        self.policy_lr = DynamicParameter.create(cfg.policy_lr)
        self.value_lr = DynamicParameter.create(cfg.value_lr)
        self.clip_ratio = DynamicParameter.create(cfg.clip_ratio)
        self.entropy_strength = DynamicParameter.create(cfg.entropy_regularization)
        self.adv_scale = DynamicParameter.create(cfg.advantage_scale)
        self.params = dict(policy=list(net.policy.parameters()),
                           value=list(net.value.parameters()))
        self.optimizers = dict(
            policy=get_optimizer_by_name(cfg.optimizer, self.params["policy"], self.policy_lr()),
            value=get_optimizer_by_name(cfg.optimizer, self.params["value"], self.value_lr()))
        self.update_step = 0

    def convert_action(self, action01: torch.Tensor) -> torch.Tensor:
        """Distribution samples in the env's range (reference
        rl/agents/ppo.py:158-181): a Beta sample in [0, 1] is scaled onto
        the Box, the others pass as they are."""
        if self.distribution == "beta":
            return action01 * self._range + self._low
        return action01

    # ------------------------------------------------------------------
    def _policy_objective(self, batch: dict, hyper: dict):
        """PPO-clip on the stored actions (reference rl/agents/ppo.py:309-358)."""
        dist = self.network.policy(batch["obs"])
        new_log_prob = dist.log_prob(dist.clip(batch["action"]))
        if new_log_prob.dim() == 1:
            new_log_prob = new_log_prob[:, None]
        entropy = torch.mean(dist.entropy())
        kl = torch.mean(um.kl_divergence(batch["log_prob"], new_log_prob))
        ratio = torch.mean(torch.exp(new_log_prob - batch["log_prob"]), dim=1)
        adv = batch["advantages"]
        clip_v = hyper["clip_ratio"]
        min_adv = torch.where(adv > 0, (1 + clip_v) * adv, (1 - clip_v) * adv)
        loss = -torch.mean(torch.minimum(ratio * adv, min_adv))
        total = loss - hyper["entropy"] * entropy
        # loss_policy is the whole objective, entropy term included, as JAX logs it
        return total, dict(loss_policy=total.detach(), entropy=entropy.detach(),
                           kl=kl.detach(), ratio=torch.mean(ratio).detach())

    def _value_objective(self, batch: dict) -> torch.Tensor:
        """0.5 * (0.25 * base MSE + exp MSE / exp_scale^2) (reference
        rl/agents/ppo.py:298-307)."""
        values = self.network.value(batch["obs"])
        base_loss = torch.mean(torch.square(batch["returns"][:, 0] - values[:, 0]))
        exp_loss = torch.mean(torch.square(batch["returns"][:, 1] - values[:, 1]))
        return 0.5 * (0.25 * base_loss + exp_loss / (self.network.exp_scale ** 2))

    def _step(self, group: str, loss: torch.Tensor, clip_norm: Optional[float]) -> None:
        """One clipped optimizer step of `group`, then polyak averaging with
        the pre-step values (the reference averages both nets,
        rl/agents/ppo.py:264-275)."""
        params = self.params[group]
        grads = torch.autograd.grad(loss, params)
        if clip_norm:
            grads = um.clip_gradients(grads, clip_norm)
        old = [p.detach().clone() for p in params] if self.config.polyak < 1.0 else None
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizers[group].step()
        for p in params:
            p.grad = None
        if old is not None:
            um.polyak_average_(params, old, self.config.polyak)

    @torch.no_grad()
    def rollout(self, env_states, samples=None, resets=None):
        """`rollout_steps` steps of every environment with the old policy.
        `samples` (S, B, ...) are the raw distribution samples and `resets`
        the S steps' auto-reset draws, each drawn from the agent's
        generator when not given.  Returns (env_states', trajectory)."""
        cfg, env, net, gen = self.config, self.env, self.network, self.generator
        recs = []
        for s in range(cfg.rollout_steps):
            obs = env._obs(env_states)
            pred = net.predict(obs, gen, None if samples is None else samples[s])
            env_states, _, reward, term, trunc, _ = env.step(
                env_states, self.convert_action(pred["action"]),
                draws=None if resets is None else resets[s], gen=gen)
            recs.append(dict(obs=obs, action=pred["action"], log_prob=pred["log_prob"],
                             value=pred["value"], reward=reward,
                             done=(term | trunc).to(torch.float32),
                             trunc=trunc.to(torch.float32)))
        return env_states, {k: torch.stack([r[k] for r in recs]) for k in recs[0]}

    def train_iteration(self, env_states, hyper: dict, draws: Optional[dict] = None):
        """One update (the JAX package's train_iteration, ppo.py:145-243).
        `draws` may hold the rollout's `samples` and `resets` (see rollout)
        and the permutation `perm` of the S * B samples.  Returns
        (env_states', metrics as floats)."""
        cfg, net = self.config, self.network
        draws = draws or {}
        env_states, traj = self.rollout(env_states, draws.get("samples"), draws.get("resets"))
        with torch.no_grad():
            values = um.compose_number(traj["value"][..., 0], traj["value"][..., 1])
            vlast = net.value(self.env._obs(env_states))
            bootstrap = um.compose_number(vlast[:, 0], vlast[:, 1])
            rewards = traj["reward"] + cfg.gamma * traj["trunc"] * values
            adv, _ = um.batched_gae(rewards, values, traj["done"], bootstrap,
                                    cfg.gamma, cfg.lambda_)
            advantages = um.sp_norm(adv) * hyper["adv_scale"]
            returns_raw = um.discounted_returns(rewards, traj["done"], bootstrap, cfg.gamma)
            rb, re = um.decompose_number(returns_raw)
        S, B = cfg.rollout_steps, cfg.num_envs
        flat = lambda x: x.reshape((S * B,) + tuple(x.shape[2:]))  # noqa: E731
        data = dict(obs=flat(traj["obs"]), action=flat(traj["action"]),
                    log_prob=flat(traj["log_prob"]), advantages=flat(advantages),
                    returns=flat(torch.stack([rb, re], dim=-1)))
        perm = draws.get("perm")
        if perm is None:
            perm = torch.randperm(S * B, generator=self.generator, device=self.device)
        n_mb = max(1, (S * B) // cfg.batch_size)
        batches = [{k: v[perm[m * cfg.batch_size:(m + 1) * cfg.batch_size]]
                    for k, v in data.items()}
                   for _ in range(cfg.optimization_steps[0]) for m in range(n_mb)]

        p_metrics = []
        for batch in batches:
            # old_policy takes the policy from before each step
            net.update_old_policy()
            total, aux = self._policy_objective(batch, hyper)
            self._step("policy", total, cfg.clip_norm[0])
            p_metrics.append(aux)
        v_losses = []
        for batch in batches:
            loss = self._value_objective(batch)
            self._step("value", loss, cfg.clip_norm[1])
            v_losses.append(loss.detach())

        mean = lambda key: torch.stack([m[key] for m in p_metrics]).mean()  # noqa: E731
        metrics = dict(reward_mean=traj["reward"].mean(), episode_done=traj["done"].sum(),
                       loss_policy=mean("loss_policy"),
                       loss_value=torch.stack(v_losses).mean(),
                       entropy=mean("entropy"), kl=mean("kl"), ratio=mean("ratio"))
        row = torch.stack(list(metrics.values())).tolist()
        return env_states, dict(zip(metrics, row))

    def learn(self, num_updates: int = 10, env_states=None, callback=None):
        """`num_updates` updates, each logged to the Summary; the schedules
        are read for the update, then stepped (on_episode).  Returns
        (env_states, history)."""
        if env_states is None:
            env_states, _ = self.env.reset_batch(self.generator, self.config.num_envs)
        history = []
        for _ in range(num_updates):
            set_learning_rate(self.optimizers["policy"], self.policy_lr())
            set_learning_rate(self.optimizers["value"], self.value_lr())
            hyper = dict(clip_ratio=float(self.clip_ratio()),
                         entropy=float(self.entropy_strength()),
                         adv_scale=float(self.adv_scale()))
            env_states, m = self.train_iteration(env_states, hyper)
            self.update_step += 1
            for p in (self.policy_lr, self.value_lr, self.clip_ratio,
                      self.entropy_strength, self.adv_scale):
                p.on_episode()
            self.log(**m)
            self.write_summaries()
            history.append(m)
            if callback:
                callback(self.update_step, m)
        return env_states, history

    # ------------------------------------------------------------------
    def _schedules(self) -> dict:
        return dict(policy_lr=self.policy_lr, value_lr=self.value_lr,
                    clip_ratio=self.clip_ratio, entropy_strength=self.entropy_strength,
                    adv_scale=self.adv_scale)

    def save(self, path: Optional[str] = None) -> None:
        """network.pt, optimizers.pt and config.json (the schedules' steps
        and the update step) under `path` (default base_path)."""
        config = {k: p.serialize() for k, p in self._schedules().items()}
        config["update_step"] = self.update_step
        ckpt.save_agent(path or self.base_path, self.network.state_dict(),
                        ckpt.optimizer_states(self.optimizers), config)

    def load(self, path: Optional[str] = None) -> None:
        """Restore a checkpoint of the port, or the JAX package's
        params.msgpack (converted in memory; no optimizer states then)."""
        path = path or self.base_path
        if os.path.exists(os.path.join(path, "network.pt")):
            loaded = ckpt.load_agent(path, self.device)
            self.network.load_state_dict(loaded["network"], strict=True)
            ckpt.load_optimizer_states(self.optimizers, loaded.get("optimizers"))
            config = loaded.get("config", {})
        else:
            sd = ckpt.ppo_params_from_jax(
                ckpt.read_flax_msgpack(os.path.join(path, "params.msgpack")))
            self.network.load_state_dict(sd, strict=True)
            config = {}
        for k, p in self._schedules().items():
            p.load(config.get(k, {}))
        self.update_step = int(config.get("update_step", self.update_step))
