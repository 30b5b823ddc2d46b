"""CARLAgent: PPO with a shared dynamics backbone and auxiliary losses,
in the shipped sequential float32 configuration, and the evaluation of the
reference's six metrics.

Counterpart of carla_driving_rl_agent_tpu/agents/carla_agent.py (reference
core/carla_agent.py over rl/agents/ppo.py).  One update (`train_iteration`):
  * rollout of `rollout_steps` steps over `num_envs` worlds with the old
    policy (per step, or in blocks of past_obs_freq with `rollout_block`);
  * targets: the bootstrap value, GAE, sign-preserving max-norm advantages
    scaled by advantage_scale, discounted returns decomposed into
    (base, exp);
  * the policy phase: minibatches of a permutation, each one clipped Adam
    step of the policy and one of the dynamics backbone;
  * the value phase: another permutation, each minibatch one clipped Adam
    step of the value head and one of the backbone, through the SAME
    dynamics Adam state.
The two phases stay apart: fusing them into one summed-gradient step was
measured to starve the policy head (main.py:97-134).  With aug_intensity
> 0 each phase augments the images of its own minibatches
(augment/simclr.py); the rollout and the targets see clean frames.  With
`expert_rollout` the rollout's actions come from the privileged expert
(envs/expert.py), behaviours mixed over the worlds, and the same update
learns from them (the device-resident imitation, JAX carla_agent.py:378-411).

Trace collection and imitation (JAX carla_agent.py:1110-1280, reference
rl/agents/ppo.py:360-462): `collect` writes episodes of the current policy
as npz traces (utils/traces.py), `imitate` learns from traces, the
expert's (envs/wrappers.CARLACollectWrapper) or the network's, with one
combined step per minibatch (see `imitation_step`).

Objectives (JAX carla_agent.py:283-359, reference core/carla_agent.py:394-486):
  * policy: PPO-clip on the per-action ratio averaged over the action
    dimensions, minus entropy * entropy_regularization, plus
    aux * 0.5 * (speed MSE + similarity MSE);
  * value: 0.25 * MSE(base) + MSE(exp) / exp_scale^2, plus aux * (speed MSE
    + similarity MSE) without the 0.5, the whole times 0.25.

Only Adam and float32 are ported, with the unfused network or with
`fused_units` (the ShuffleNet-unit kernels), with the augmentation, the
expert rollout and `ratio_clamp`; the JAX package's other learner options
raise (CARLAgentConfig.check).
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from carla_driving_rl_agent_torch import REPO_ROOT
from carla_driving_rl_agent_torch.agents import rollout as rollout_mod
from carla_driving_rl_agent_torch.augment import simclr
from carla_driving_rl_agent_torch.envs import expert as expert_mod
from carla_driving_rl_agent_torch.envs import world as world_mod
from carla_driving_rl_agent_torch.envs.carla_env import (
    CARLAEnv, EnvState, convert_action, planes_to_image)
from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
from carla_driving_rl_agent_torch.models.distributions import Beta
from carla_driving_rl_agent_torch.models.layers import init_flax_
from carla_driving_rl_agent_torch.utils import checkpoint as ckpt
from carla_driving_rl_agent_torch.utils import math as um
from carla_driving_rl_agent_torch.utils import traces as trace_io
from carla_driving_rl_agent_torch.utils.optimizers import (
    get_optimizer_by_name, set_learning_rate)
from carla_driving_rl_agent_torch.utils.schedules import DynamicParameter


# the port's checkpoints; the tracked weights/ holds the JAX package's
DEFAULT_WEIGHTS_DIR = os.path.join(REPO_ROOT, "weights-torch")


def full_float32() -> None:
    """Full float32 on the card: no TF32 in cuDNN convolutions (PyTorch's
    default) or in matmuls.  The shipped recipe trains in float32; bf16 was
    rejected for quantising away the Beta logits' small shifts
    (main.py:94-96)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@dataclass
class CARLAgentConfig:
    # parallel rollout geometry
    num_envs: int = 64
    rollout_steps: int = 128
    # PPO hyper-parameters (reference rl/agents/ppo.py:26-61)
    batch_size: int = 64
    gamma: float = 0.9999
    lambda_: float = 0.999
    policy_lr: Any = 3e-4
    value_lr: Any = 3e-4
    dynamics_lr: Any = 3e-4
    clip_ratio: Any = 0.2
    entropy_regularization: Any = 0.1
    advantage_scale: Any = 2.0
    optimization_steps: Tuple[int, int] = (1, 1)
    clip_norm: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    polyak: float = 1.0
    update_dynamics: bool = True
    optimizer: str = "adam"
    # one forward pass and one rendered frame per past_obs_freq steps
    rollout_block: bool = False
    # zero the advantage of block sub-steps after a mid-block auto-reset
    mask_post_reset: bool = True
    aux: float = 1.0
    seed: int = 42
    # network spec (reference core/carla_agent.py:61-68)
    network: Dict[str, Any] = field(default_factory=dict)
    # stride-1 ShuffleNet units as fused ops (the unit kernels on the card)
    fused_units: bool = False
    # the training augmentation of every minibatch's images (augment/simclr)
    aug_intensity: float = 0.0
    # the device-resident imitation: the rollout's actions from the
    # privileged expert, behaviours cycled over the worlds, log-probs from
    # the old policy and values from the value head; nothing is sampled.
    # Takes precedence over rollout_block, as in the JAX package.
    expert_rollout: bool = False
    expert_behaviour_mix: Tuple[str, ...] = ("cautious", "normal", "aggressive")
    # per-action importance-ratio ceiling of the policy objective, applied
    # in log space (0 = off): expert actions can sit in the policy's far
    # tail, where exp(log-ratio) overflows (JAX carla_agent.py:303-315)
    ratio_clamp: float = 0.0
    # learner options of the JAX package that the port does not have yet;
    # anything but these defaults raises
    fused_update: bool = False
    two_step_update: bool = False
    two_step_split_adam: bool = False
    resample_actions: bool = False
    compute_dtype: str = "float32"

    def check(self) -> None:
        unported = dict(fused_update=False, two_step_update=False,
                        two_step_split_adam=False, resample_actions=False,
                        compute_dtype="float32")
        for name, default in unported.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"CARLAgentConfig.{name}={getattr(self, name)!r} is not ported; "
                    f"the port trains the sequential float32 update only")


class CARLAgent:
    """Owns the network, the three Adam optimizers (policy, value,
    dynamics), the schedules and the agent's generator (action samples and
    minibatch permutations; the env's generator draws the resets)."""

    def __init__(self, env: CARLAEnv, config: Optional[CARLAgentConfig] = None,
                 name: str = "carla", weights_dir: Optional[str] = None):
        self.env = env
        self.config = cfg = config or CARLAgentConfig()
        cfg.check()
        self.name = name
        # checkpoints and evaluation records, default weights-torch/<name>
        self.base_path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR, name)
        spec = dict(cfg.network or {})
        net = CARLANetwork(
            num_actions=env.config.num_actions,
            control_policy=spec.get("control_policy"),
            control_value=spec.get("control_value"),
            dynamics=spec.get("dynamics"),
            image_channels=env.config.image_shape[2],
            nav_dim=env.params.num_waypoints_for_feature,
            fused_units=cfg.fused_units,
        )
        # flax's initialisers from a CPU generator, so that one seed gives
        # the same network on every device
        init_flax_(net, torch.Generator().manual_seed(cfg.seed))
        net.update_old_policy()
        self.network = net.to(env.device)
        self.env.seed(cfg.seed)
        self.generator = torch.Generator(device=env.device)
        self.generator.manual_seed(cfg.seed)

        # dynamic hyper-parameters (reference rl/agents/ppo.py:42-61,100-106)
        self.policy_lr = DynamicParameter.create(cfg.policy_lr)
        self.value_lr = DynamicParameter.create(cfg.value_lr)
        self.dynamics_lr = DynamicParameter.create(cfg.dynamics_lr)
        self.clip_ratio = DynamicParameter.create(cfg.clip_ratio)
        self.entropy_strength = DynamicParameter.create(cfg.entropy_regularization)
        self.adv_scale = DynamicParameter.create(cfg.advantage_scale)

        self.params = dict(policy=list(self.network.policy.parameters()),
                           value=list(self.network.value.parameters()),
                           dynamics=list(self.network.dynamics.parameters()))
        self.optimizers = dict(
            policy=get_optimizer_by_name(cfg.optimizer, self.params["policy"], self.policy_lr()),
            value=get_optimizer_by_name(cfg.optimizer, self.params["value"], self.value_lr()),
            dynamics=get_optimizer_by_name(cfg.optimizer, self.params["dynamics"],
                                           self.dynamics_lr()))
        self.update_step = 0
        # seconds of the last update's parts, each ended by a synchronise
        self.last_timings: Dict[str, float] = {}
        self.last_trials: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    # objectives
    # ------------------------------------------------------------------
    def _policy_objective(self, pol: dict, batch: dict, hyper: dict):
        """PPO-clip + entropy + aux on the policy head's output `pol` (JAX
        carla_agent.py:283-330); the log-prob is of the STORED rollout
        action (the reference's base objective, rl/agents/ppo.py:322-325)."""
        dist: Beta = pol["dist"]
        log_prob = dist.log_prob(dist.clip(batch["obs"]["action"]))
        entropy = torch.mean(dist.entropy())
        adv = batch["advantages"]
        log_ratio = log_prob - batch["log_prob"]
        if self.config.ratio_clamp:
            # in log space: min(exp(x), c) would overflow exp first and
            # backpropagate 0 * inf = NaN through the clamped branch
            log_ratio = torch.clamp(log_ratio, max=math.log(self.config.ratio_clamp))
        ratio = torch.exp(log_ratio)
        ratio = torch.mean(ratio, dim=1)                   # per-action-ratio mean (quirk)
        clip_v = hyper["clip_ratio"]
        min_adv = torch.where(adv > 0.0, (1.0 + clip_v) * adv, (1.0 - clip_v) * adv)
        policy_loss = -torch.mean(torch.minimum(ratio * adv, min_adv))
        entropy_penalty = hyper["entropy"] * entropy
        # the policy's aux losses carry 0.5, the value's do not (quirk)
        speed_loss = 0.5 * torch.mean(torch.square(batch["speed"] - pol["speed"][:, 0]))
        sim_loss = 0.5 * torch.mean(torch.square(batch["similarity"]
                                                 - pol["similarity"][:, 0]))
        total = policy_loss - entropy_penalty + self.config.aux * (speed_loss + sim_loss)
        aux = dict(loss_policy=policy_loss.detach(), entropy=entropy.detach(),
                   ratio=torch.mean(ratio).detach(),
                   kl=torch.mean(um.kl_divergence(batch["log_prob"], log_prob)).detach())
        return total, aux

    def _value_objective(self, val: dict, batch: dict):
        """(base, exp) value loss + aux, all times 0.25 (JAX
        carla_agent.py:340-359)."""
        values, returns = val["value"], batch["returns"]
        base_loss = torch.mean(torch.square(returns[:, 0] - values[:, 0]))
        exp_loss = torch.mean(torch.square(returns[:, 1] - values[:, 1]))
        value_loss = 0.25 * base_loss + exp_loss / (self.network.exp_scale ** 2)
        speed_loss = torch.mean(torch.square(batch["speed"] - val["speed"][:, 0]))
        sim_loss = torch.mean(torch.square(batch["similarity"] - val["similarity"][:, 0]))
        total = (value_loss + self.config.aux * (speed_loss + sim_loss)) * 0.25
        return total, dict(loss_value=value_loss.detach())

    # ------------------------------------------------------------------
    # one update: rollout, targets, policy phase, value phase
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.env.device.type == "cuda":
            torch.cuda.synchronize(self.env.device)

    def _rollout(self, env_states: EnvState):
        """The training rollout (reference core/networks.py:181-193): the
        expert's actions with the old policy's log-probs with
        `expert_rollout`, else the old policy's samples, per step or in
        blocks.  Returns (env_states', Trajectory, final_obs)."""
        cfg, net, gen = self.config, self.network, self.generator
        if cfg.expert_rollout:
            return rollout_mod.run_rollout(self.env, self._expert_log_prob_fn(), env_states,
                                           cfg.rollout_steps, expert_fn=self._expert_fn())
        if cfg.rollout_block:
            return rollout_mod.run_rollout_blocks(
                self.env, lambda net_in, n: net.predict(net_in, gen, num_samples=n),
                env_states, cfg.rollout_steps)
        return rollout_mod.run_rollout(
            self.env, lambda net_in: net.predict(net_in, gen), env_states,
            cfg.rollout_steps)

    def _expert_fn(self):
        """expert_fn(env_states) of the expert rollout: the expert's actions
        with the behaviours of expert_behaviour_mix cycled over the worlds,
        traffic lights ignored (JAX carla_agent.py:382-397)."""
        env = self.env
        profiles = expert_mod.behaviour_profiles(expert_mod.mixed_behaviour_ids(
            self.config.expert_behaviour_mix, self.config.num_envs, env.device))
        return lambda states: expert_mod.expert_action(
            states.world, env.params, env.town, env.routes, ignore_traffic_light=True,
            profile=profiles)

    def _expert_log_prob_fn(self):
        """predict_fn(net_in, action01) of the expert rollout: the old
        policy's log-prob of the action and the value, in inference mode
        (JAX carla_agent.py:399-407); imitate takes an expert trace's
        log-probs from it too (:1218-1227)."""
        net = self.network

        @torch.no_grad()
        def predict(net_in, action01):
            feat = net.dynamics_apply(net_in)
            pol = net.policy_apply(feat, old=True)
            return dict(log_prob=pol["dist"].log_prob(action01),
                        value=net.value_apply(feat)["value"])
        return predict

    @torch.no_grad()
    def targets(self, traj: rollout_mod.Trajectory, final_obs: dict,
                last_action: torch.Tensor, adv_scale: float) -> dict:
        """Advantages and (base, exp) returns of a trajectory, flattened to
        (S * B, ...) samples (JAX carla_agent.py:438-504)."""
        cfg, net = self.config, self.network
        values = um.compose_number(traj.value[..., 0], traj.value[..., 1])   # (S, B)
        final_in = {f"state_{k}": v for k, v in final_obs.items()}
        final_in["action"] = last_action
        vlast = net.value_apply(net.dynamics_apply(final_in))
        bootstrap = um.compose_number(vlast["value"][:, 0], vlast["value"][:, 1])

        done = torch.clamp(traj.terminated + traj.truncated, 0.0, 1.0)
        # truncation bootstraps from the current value estimate
        # (reference ppo.py:540-542)
        rewards = traj.reward + cfg.gamma * traj.truncated * values
        adv_raw, _ = um.batched_gae(rewards, values, done, bootstrap, cfg.gamma, cfg.lambda_)
        advantages = um.sp_norm(adv_raw) * adv_scale
        if cfg.mask_post_reset:
            # after sp_norm, so the normalisation statistics do not depend
            # on the mask
            advantages = advantages * (1.0 - traj.post_reset)
        returns_raw = um.discounted_returns(rewards, done, bootstrap, cfg.gamma)
        ret_base, ret_exp = um.decompose_number(returns_raw)

        S, B = traj.reward.shape
        dev = traj.reward.device

        def flat(x):
            return x.reshape((S * B,) + tuple(x.shape[2:]))

        return dict(
            advantages=flat(advantages),
            returns=flat(torch.stack([ret_base, ret_exp], dim=-1)),
            log_prob=flat(traj.log_prob), action=flat(traj.action),
            speed=flat(traj.speed) / 100.0,               # carla_agent.py:328
            similarity=flat(traj.similarity),
            road=flat(traj.road), vehicle=flat(traj.vehicle),
            navigation=flat(traj.navigation),
            step=torch.arange(S, device=dev).repeat_interleave(B),
            env=torch.arange(B, device=dev).repeat(S),
            # not flattened: for the metrics and the image gathers
            stats=dict(values=values, done=done, advantages=advantages,
                       returns_raw=returns_raw),
            timeline=rollout_mod.frame_timeline(traj), traj=traj)

    def gather_batch(self, data: dict, idx: torch.Tensor) -> dict:
        """One minibatch of samples `idx` (JAX carla_agent.py:480-504): the
        flat fields, and the image stacks gathered from the frame timeline
        and turned into the network's (mb, T, H, 3W, C) [0, 1] input, then
        augmented when aug_intensity > 0: one set of draws per sample from
        the agent's generator, shared by its T frames (JAX vmaps the
        pipeline with in_axes=(None, 0, None)), statistics per frame.  With
        aug_intensity 0 nothing is drawn."""
        keys = ("advantages", "returns", "log_prob", "action", "speed", "similarity",
                "road", "vehicle", "navigation")
        mb = {k: data[k][idx] for k in keys}
        img = rollout_mod.gather_image_stacks(data["traj"], data["step"][idx],
                                              data["env"][idx], data["timeline"])
        ry, rx = self.env.config.upsample
        img = planes_to_image(img, ry, rx).to(torch.float32) / 255.0
        img = simclr.augment(self.generator, img, self.config.aug_intensity)
        mb["obs"] = dict(state_image=img, state_road=mb["road"],
                         state_vehicle=mb["vehicle"], state_navigation=mb["navigation"],
                         action=mb["action"])
        return mb

    def _apply(self, group: str, grads, clip_norm: float) -> None:
        """One Adam step of a parameter group on its per-tensor clipped
        gradients, then polyak averaging with the pre-step values."""
        params = self.params[group]
        old = ([p.detach().clone() for p in params]
               if self.config.polyak < 1.0 and group != "dynamics" else None)
        for p, g in zip(params, um.clip_gradients(grads, clip_norm)):
            p.grad = g
        self.optimizers[group].step()
        self.optimizers[group].zero_grad(set_to_none=True)
        if old is not None:
            # the reference averages both heads (rl/agents/ppo.py:264-275)
            um.polyak_average_(params, old, self.config.polyak)

    def _grads(self, loss: torch.Tensor, groups):
        params = [p for g in groups for p in self.params[g]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        out, i = {}, 0
        for g in groups:
            out[g] = grads[i:i + len(self.params[g])]
            i += len(self.params[g])
        return out

    def policy_step(self, batch: dict, hyper: dict) -> dict:
        """One policy-phase step on a gathered minibatch (JAX
        carla_agent.py:711-749): the policy's and the backbone's gradients
        of the policy objective, each tensor clipped, then one Adam step of
        each."""
        cfg, net = self.config, self.network
        feat = net.dynamics_apply(batch["obs"], training=True)
        pol = net.policy_apply(feat, training=True)
        total, aux = self._policy_objective(pol, batch, hyper)
        grads = self._grads(total, ("policy", "dynamics"))
        # old_policy <- policy BEFORE the step (rl/agents/ppo.py:238-252):
        # the next rollout samples from the policy of one minibatch ago
        net.update_old_policy()
        self._apply("policy", grads["policy"], cfg.clip_norm[0])
        if cfg.update_dynamics:
            self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2])
        aux["loss_total"] = total.detach()
        return aux

    def value_step(self, batch: dict) -> dict:
        """One value-phase step (JAX carla_agent.py:755-785): the backbone's
        second clipped Adam step of the minibatch pair, through the same
        dynamics Adam state as the policy phase."""
        cfg, net = self.config, self.network
        feat = net.dynamics_apply(batch["obs"], training=True)
        val = net.value_apply(feat, training=True)
        total, aux = self._value_objective(val, batch)
        grads = self._grads(total, ("value", "dynamics"))
        self._apply("value", grads["value"], cfg.clip_norm[1])
        if cfg.update_dynamics:
            self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2])
        # the JAX learner reports the phase's total as loss_value
        return dict(loss_value=total.detach())

    def train_iteration(self, env_states: EnvState, hyper: dict):
        """Rollout + targets + policy phase + value phase.  Returns
        (env_states', metrics); self.last_timings holds the parts'
        seconds."""
        cfg = self.config
        t0 = time.perf_counter()
        env_states, traj, final_obs = self._rollout(env_states)
        self._sync()
        t1 = time.perf_counter()
        data = self.targets(traj, final_obs, env_states.last_action, hyper["adv_scale"])
        n = cfg.rollout_steps * cfg.num_envs
        n_mb = max(1, n // cfg.batch_size)
        self._sync()
        t2 = time.perf_counter()

        perm = torch.randperm(n, generator=self.generator, device=self.env.device)
        p_metrics = [self.policy_step(self.gather_batch(data, perm[m * cfg.batch_size:
                                                                   (m + 1) * cfg.batch_size]), hyper)
                     for _ in range(cfg.optimization_steps[0]) for m in range(n_mb)]
        self._sync()
        t3 = time.perf_counter()
        perm = torch.randperm(n, generator=self.generator, device=self.env.device)
        v_metrics = [self.value_step(self.gather_batch(data, perm[m * cfg.batch_size:
                                                                  (m + 1) * cfg.batch_size]))
                     for _ in range(cfg.optimization_steps[1]) for m in range(n_mb)]
        self._sync()
        t4 = time.perf_counter()
        self.last_timings = dict(rollout=t1 - t0, targets=t2 - t1, policy=t3 - t2,
                                 value=t4 - t3)

        st = data["stats"]

        def mean_of(records, key):
            return torch.stack([r[key] for r in records]).mean() if records else \
                torch.zeros((), device=self.env.device)

        metrics = dict(
            reward_mean=traj.reward.mean(),
            episode_done=st["done"].sum(),
            collision_rate=traj.terminated.sum() / torch.clamp(st["done"].sum(), min=1.0),
            speed_mean=traj.speed.mean(),
            similarity_mean=traj.similarity.mean(),
            advantage_abs=st["advantages"].abs().mean(),
            returns_mean=st["returns_raw"].mean(),
            value_mean=st["values"].mean(),
            loss_policy=mean_of(p_metrics, "loss_policy"),
            loss_value=mean_of(v_metrics, "loss_value"),
            entropy=mean_of(p_metrics, "entropy"),
            ratio=mean_of(p_metrics, "ratio"),
            kl=mean_of(p_metrics, "kl"))
        values = torch.stack(list(metrics.values())).tolist()
        return env_states, dict(zip(metrics, values))

    def learn(self, num_updates: int, env_states: Optional[EnvState] = None,
              callback=None):
        """Main training loop (reference rl/agents/ppo.py:464-568).  One
        update = rollout_steps x num_envs env steps and the PPO update.
        Returns (env_states, list of metrics dicts)."""
        full_float32()
        if env_states is None:
            env_states, _ = self.env.reset_batch(self.config.num_envs)
        history = []
        for _ in range(num_updates):
            # read this update's learning rates and scalars, THEN step the
            # schedules (JAX carla_agent.py:898-912)
            for group, param in (("policy", self.policy_lr), ("value", self.value_lr),
                                 ("dynamics", self.dynamics_lr)):
                set_learning_rate(self.optimizers[group], param())
            hyper = dict(clip_ratio=float(self.clip_ratio()),
                         entropy=float(self.entropy_strength()),
                         adv_scale=float(self.adv_scale()))
            self.update_step += 1
            for p in (self.policy_lr, self.value_lr, self.dynamics_lr,
                      self.clip_ratio, self.entropy_strength, self.adv_scale):
                p.on_episode()
            env_states, metrics = self.train_iteration(env_states, hyper)
            metrics.update({f"seconds_{k}": v for k, v in self.last_timings.items()})
            history.append(metrics)
            if callback is not None:
                callback(self.update_step, metrics)
        return env_states, history

    # ------------------------------------------------------------------
    # trace collection and imitation (JAX carla_agent.py:1110-1280,
    # reference rl/agents/ppo.py:360-462)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def collect(self, episodes: int, timesteps: int, record_threshold: float = 0.0,
                traces_dir: str = "traces", seed: int = 42) -> int:
        """Write `episodes` traces of the current policy into `traces_dir`
        (reference PPOAgent.collect, rl/agents/ppo.py:360-413): rounds of
        min(num_envs, episodes) fresh worlds for `timesteps` steps, each
        world's first episode kept when its total reward is at least
        `record_threshold`, with the observations, the sampled actions in
        [0, 1], their log-probs, the values, rewards, dones, speed and
        similarity (utils/traces.py).  The worlds come from the env's
        generator seeded with `seed` and restored afterwards, the samples
        from a generator of that seed, so that training draws as it would
        have.  Returns the number written."""
        from carla_driving_rl_agent_torch.envs.wrappers import seeded
        env, net = self.env, self.network
        num_envs = min(self.config.num_envs, max(episodes, 1))
        os.makedirs(traces_dir, exist_ok=True)
        gen = torch.Generator(device=env.device).manual_seed(seed)

        def act(states, net_in):
            pred = net.predict(net_in, gen)
            return dict(env_action=convert_action(pred["action"]), action=pred["action"],
                        log_prob=pred["log_prob"], value=pred["value"])

        written = 0
        with seeded(env, seed):
            while written < episodes:
                states, _ = env.reset_batch(num_envs)
                recs = trace_io.record_steps(env, states, act, timesteps)
                written = trace_io.save_episodes(recs, traces_dir, written, episodes,
                                                 lambda total: total >= record_threshold)
        return written

    def _trace_targets(self, trace: dict, adv_scale: float) -> dict:
        """Advantages and (base, exp) returns of one trace, in float32 as
        the JAX package computes them (carla_agent.py:1238-1250): GAE over
        the trace with its values (zero without) and dones, bootstrapped
        with 0, then sign-preserving max-norm times adv_scale; the
        discounted sum of the rewards, without episode masks, decomposed."""
        dev, cfg = self.env.device, self.config
        n = len(trace["reward"])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        rewards = f32(trace["reward"])
        values = (um.compose_number(f32(trace["value"][:, 0]), f32(trace["value"][:, 1]))
                  if "value" in trace else torch.zeros(n, device=dev))
        dones = f32(trace["done"]) if "done" in trace else torch.zeros(n, device=dev)
        zero = torch.zeros(1, device=dev)
        adv, _ = um.batched_gae(rewards[:, None], values[:, None], dones[:, None], zero,
                                cfg.gamma, cfg.lambda_)
        adv = um.sp_norm(adv[:, 0]) * adv_scale
        rets = um.discounted_returns(rewards[:, None], torch.zeros_like(rewards[:, None]),
                                     zero, cfg.gamma)[:, 0]
        base, exp = um.decompose_number(rets)
        return dict(advantages=adv, returns=torch.stack([base, exp], dim=-1))

    def imitation_step(self, batch: dict, hyper: dict) -> Tuple[float, float]:
        """One imitation update on a minibatch (JAX imitation_update,
        carla_agent.py:1185-1215): the policy and value objectives from one
        training-mode pass of the backbone (JAX runs it twice from the same
        parameters and statistics: the same values); the policy and the
        value head one clipped Adam step each, the backbone ONE clipped Adam
        step on the sum of both objectives' gradients; old_policy becomes
        the policy from before the step; the batch statistics of the three
        parts are folded once.  Returns (policy loss, value loss)."""
        cfg, net = self.config, self.network
        feat = net.dynamics_apply(batch["obs"], training=True)
        p_total, _ = self._policy_objective(net.policy_apply(feat, training=True), batch, hyper)
        v_total, _ = self._value_objective(net.value_apply(feat, training=True), batch)
        grads = self._grads(p_total + v_total, ("policy", "value", "dynamics"))
        net.update_old_policy()
        self._apply("policy", grads["policy"], cfg.clip_norm[0])
        self._apply("value", grads["value"], cfg.clip_norm[1])
        self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2])
        return float(p_total.detach()), float(v_total.detach())

    def imitate(self, epochs: int = 1, batch_size: Optional[int] = None,
                traces_dir: str = "traces", shuffle_data: bool = True,
                seed: Optional[int] = None) -> list:
        """Learn from the traces of `traces_dir` (reference PPOAgent.imitate,
        rl/agents/ppo.py:415-462): per epoch, every trace of 4 steps or more
        in load_traces' order (shuffled with `seed`), its targets
        (_trace_targets), then its samples in a permutation of
        numpy.random.default_rng(seed) cut into full minibatches of
        `batch_size`, each one imitation_step.  A trace without log_prob
        (the expert's) takes it from the current old policy.  The inputs
        are computed in float32 (the images as the stored u8 / 255), then
        cast to the network's dtype.  Returns the (policy loss, value loss)
        of every step."""
        full_float32()
        cfg, dev = self.config, self.env.device
        batch_size = batch_size or cfg.batch_size
        dtype = next(self.network.parameters()).dtype
        hyper = dict(clip_ratio=float(self.clip_ratio()), entropy=float(self.entropy_strength()),
                     adv_scale=float(self.adv_scale()))
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        old_log_prob = self._expert_log_prob_fn()
        rng = np.random.default_rng(seed)
        losses = []
        for _ in range(epochs):
            for trace in trace_io.load_traces(traces_dir, shuffle=True, seed=seed):
                n = len(trace["reward"])
                if n < 4:
                    continue
                targets = self._trace_targets(trace, hyper["adv_scale"])
                order = rng.permutation(n) if shuffle_data else np.arange(n)
                zeros = np.zeros(n, np.float32)
                for i0 in range(0, n - batch_size + 1, batch_size):
                    idx = order[i0:i0 + batch_size]
                    image = torch.as_tensor(trace["state_image"][idx], device=dev)
                    # float32 as stored, cast to the network's dtype after the
                    # arithmetic; the action stays float32, so that its log is
                    # taken in float32 as the JAX package takes it
                    obs = dict(state_image=(image.to(torch.float32) / 255.0).to(dtype),
                               state_road=f32(trace["state_road"][idx]).to(dtype),
                               state_vehicle=f32(trace["state_vehicle"][idx]).to(dtype),
                               state_navigation=f32(trace["state_navigation"][idx]).to(dtype),
                               action=f32(trace["action"][idx]))
                    tidx = torch.as_tensor(idx, device=dev)
                    log_prob = (torch.as_tensor(trace["log_prob"][idx], device=dev).to(dtype)
                                if "log_prob" in trace else
                                old_log_prob(obs, (obs["action"] + 1.0) / 2.0)["log_prob"])
                    batch = dict(obs=obs, advantages=targets["advantages"][tidx].to(dtype),
                                 returns=targets["returns"][tidx].to(dtype), log_prob=log_prob,
                                 speed=(f32(trace.get("speed", zeros)[idx]) / 100.0).to(dtype),
                                 similarity=f32(trace.get("similarity", zeros)[idx]).to(dtype))
                    losses.append(self.imitation_step(batch, hyper))
        return losses

    # the Stage orchestrator's name (reference core/learning.py:180-181)
    imitation_learning = imitate

    # ------------------------------------------------------------------
    # checkpointing (reference core/networks.py:297-310, rl/agents/ppo.py:601-616)
    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> None:
        """network.pt (the state dict), optimizers.pt (the three Adam
        states) and config.json (schedule steps, update step, network
        spec) under `path` (default base_path)."""
        ckpt.save_agent(path or self.base_path, self.network.state_dict(),
                        {g: o.state_dict() for g, o in self.optimizers.items()},
                        self.serialize_config())

    def load(self, path: Optional[str] = None, full: bool = True) -> None:
        """Restore a checkpoint of the port (network.pt) or of the JAX
        package (params.msgpack, converted in memory).  full=False restores
        only the dynamics backbone, the curriculum's stage transfer
        (reference core/networks.py:302-310).  As in the JAX package, a
        full restore copies policy -> old_policy."""
        path = path or self.base_path
        loaded = ckpt.load_agent(path, self.env.device)
        if full:
            self.network.load_state_dict(loaded["network"], strict=True)
            self.network.update_old_policy()
            for g, state in (loaded.get("optimizers") or {}).items():
                self.optimizers[g].load_state_dict(state)
        else:
            prefix = "dynamics."
            self.network.dynamics.load_state_dict(
                {k[len(prefix):]: v for k, v in loaded["network"].items()
                 if k.startswith(prefix)}, strict=True)
        self.load_config(loaded.get("config", {}))

    def serialize_config(self) -> dict:
        return dict(policy_lr=self.policy_lr.serialize(),
                    value_lr=self.value_lr.serialize(),
                    dynamics_lr=self.dynamics_lr.serialize(),
                    adv_scale=self.adv_scale.serialize(),
                    entropy_strength=self.entropy_strength.serialize(),
                    clip_ratio=self.clip_ratio.serialize(),
                    update_step=self.update_step,
                    network=self.config.network or {})

    def load_config(self, config: dict) -> None:
        self.policy_lr.load(config.get("policy_lr", {}))
        self.value_lr.load(config.get("value_lr", {}))
        self.dynamics_lr.load(config.get("dynamics_lr", {}))
        self.adv_scale.load(config.get("adv_scale", {}))
        self.entropy_strength.load(config.get("entropy_strength", {}))
        self.clip_ratio.load(config.get("clip_ratio", {}))
        self.update_step = int(config.get("update_step", self.update_step))

    # ------------------------------------------------------------------
    # evaluation (reference core/carla_agent.py:205-321)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout(self, num_worlds: int, timesteps: int,
                draws: Optional[world_mod.ResetDraws] = None) -> Dict[str, torch.Tensor]:
        """Per-step evaluation rollout: `num_worlds` worlds, one network
        prediction and one env step (one rendered frame) per timestep.  The
        worlds start from `draws` (default: drawn from the env's generator);
        every other random draw comes from the env's generator.  Returns the
        per-world accumulators of each world's FIRST episode; with NPCs also
        how it ended (hit_vehicle, hit_pedestrian, hit_other) and the active
        vehicles and walkers it started with."""
        env, net = self.env, self.network
        gen = env.generator
        states, obs = env.reset(draws) if draws is not None else env.reset_batch(num_worlds)
        zeros = torch.zeros(num_worlds, device=env.device)
        acc = dict(active=zeros + 1.0, total_reward=zeros, similarity=zeros,
                   speed=zeros, waypoint_distance=zeros, timesteps=zeros,
                   collision=zeros)
        npc = states.world.npc
        typed = {}
        if npc is not None:
            typed = dict(hit_vehicle=zeros, hit_pedestrian=zeros, hit_other=zeros)
            counts = dict(vehicles=npc.veh_active.sum(1), walkers=npc.ped_active.sum(1))
        for _ in range(timesteps):
            net_in = {f"state_{k}": v for k, v in obs.items()}
            pred = net.predict(net_in, gen)
            states, obs, reward, term, trunc, info = env.step(
                states, convert_action(pred["action"]))
            a = acc["active"]
            done = (term | trunc).to(torch.float32)
            acc = dict(
                active=a * (1.0 - done),
                total_reward=acc["total_reward"] + reward * a,
                similarity=acc["similarity"] + info["similarity"] * a,
                speed=acc["speed"] + info["speed"] * a,
                waypoint_distance=acc["waypoint_distance"]
                + info["distance_to_next_waypoint"] * a,
                timesteps=acc["timesteps"] + a,
                collision=torch.maximum(
                    acc["collision"],
                    info["collision"].to(torch.float32) * a * done),
            )
            if typed:
                ended = a * done
                typed = {k: torch.maximum(v, info[k].to(torch.float32) * ended)
                         for k, v in typed.items()}
        if typed:
            acc.update(typed, **counts)
        return acc

    def evaluate(self, name: str, timesteps: int, trials: int,
                 initial_seed: Optional[int] = None,
                 evaluation_dir: Optional[str] = None) -> dict:
        """Run `trials` evaluation episodes as parallel worlds and write the
        per-scenario JSON with the six metrics: collision_rate, similarity,
        waypoint_distance, speed, total_reward, timesteps.  Episodes of 32
        steps or fewer are discarded (accidental first-step collisions,
        reference :284); total_reward clips at -1000 (:286).  The kept
        trials' per-world accumulators of the rollout (with NPCs, their
        collisions by type and NPC counts too) stay in `last_trials`."""
        full_float32()
        eval_dir = evaluation_dir or os.path.join(self.base_path, "evaluation")
        ckpt.refuse_tracked(eval_dir)
        if isinstance(initial_seed, int):
            self.env.seed(initial_seed)
            seed = initial_seed
        else:
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.env.generator,
                                     device=self.env.device))

        # oversample worlds so >= trials valid episodes survive the filter
        num_worlds = max(trials + 8, int(trials * 1.25))
        # trial i starts from its own stream, keyed by (seed, i) as the JAX
        # package folds i into its reset key: its town, weather, route and
        # light offset do not depend on `trials`
        draws = world_mod.trial_draws(seed, num_worlds, self.env.params, self.env.routes,
                                      self.env.town)
        acc = {k: v.cpu().numpy() for k, v in
               self.rollout(num_worlds, timesteps, draws).items()}

        steps = np.maximum(acc["timesteps"], 1.0)
        valid = acc["timesteps"] > 32
        if valid.sum() < trials:
            valid = acc["timesteps"] > 0  # degenerate config: keep everything
        idx = np.nonzero(valid)[0][:trials]
        self.last_trials = {k: v[idx] for k, v in acc.items()}

        results = dict(
            collision_rate=acc["collision"][idx].tolist(),
            similarity=(acc["similarity"][idx] / steps[idx]).tolist(),
            waypoint_distance=(acc["waypoint_distance"][idx] / steps[idx]).tolist(),
            speed=(acc["speed"][idx] / steps[idx]).tolist(),
            total_reward=np.maximum(acc["total_reward"][idx], -1000.0).tolist(),
            timesteps=acc["timesteps"][idx].tolist(),
        )
        record = {}
        for k, v in results.items():
            record[k] = v
            record[f"{k}_mean"] = float(np.mean(v)) if len(v) else 0.0
            record[f"{k}_std"] = float(np.std(v)) if len(v) else 0.0

        os.makedirs(eval_dir, exist_ok=True)
        with open(os.path.join(eval_dir, f"{name}.json"), "w") as f:
            json.dump(record, f, indent=2)
        return record
