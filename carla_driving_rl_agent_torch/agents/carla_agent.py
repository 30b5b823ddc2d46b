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
The two phases stay apart by default: fusing them into one summed-gradient
step was measured to starve the policy head (main.py:97-134).  The JAX
package's three other update schemes are here too, each one backbone
forward per minibatch of one permutation (reused by every epoch): with
`fused_update` one step on the summed objectives (`fused_step`); with
`two_step_update` the forward pulled back twice, and the backbone stepped
twice through one Adam state, the policy's gradient first (`two_step`);
with `two_step_split_adam` the same through two Adam states, one per phase.
They time the minibatches as one part, `update`, where the sequential
update has `policy` and `value`.  With aug_intensity
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

Every option of the JAX package's CARLAgentConfig is here: the eight
optimizers (utils/optimizers.py, `flat_optimizer` too), `compute_dtype`
"bfloat16" (flax's dtype rules, models/layers.py; with `fused_units` the
bfloat16 unit kernels), `resample_actions` (the policy's log-prob of a
fresh reparameterised sample, models/distributions.Beta.rsample),
`repeat_action` on the per-step rollout, `seed_regularization` and
`updates_per_dispatch` (learn).  CARLAgentConfig.check raises only where
the JAX package refuses.

With a `mesh` (parallel/mesh.WorldMesh, the JAX package's world mesh,
carla_agent.py:815-822, 859-866) each process steps its shard of the
worlds: the env draws for every world and keeps this rank's rows
(CARLAEnv.sharded), the policy's samples likewise; the trajectories and the
bootstrap inputs are all-gathered, and every rank runs the same update over
the global minibatches, so that R ranks compute what one process does.
The evaluation shards its worlds the same way.  `learn` logs every
update's host metrics to the Summary (`log_mode`, JAX :913-918).
"""

from __future__ import annotations

import json
import math
import os
import secrets
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
from carla_driving_rl_agent_torch.parallel import mesh as mesh_mod
from carla_driving_rl_agent_torch.utils import checkpoint as ckpt
from carla_driving_rl_agent_torch.utils import math as um
from carla_driving_rl_agent_torch.utils import traces as trace_io
from carla_driving_rl_agent_torch.utils.optimizers import (
    OPTIMIZERS, get_optimizer_by_name, set_learning_rate)
from carla_driving_rl_agent_torch.utils.profiling import span, timed
from carla_driving_rl_agent_torch.utils.schedules import DynamicParameter
from carla_driving_rl_agent_torch.utils.summary import Summary


# the port's checkpoints; the tracked weights/ holds the JAX package's
DEFAULT_WEIGHTS_DIR = os.path.join(REPO_ROOT, "weights-torch")


def full_float32() -> None:
    """Full float32 on the card: no TF32 in cuDNN convolutions (PyTorch's
    default) or in matmuls.  The shipped recipe trains in float32; bf16
    (compute_dtype "bfloat16", whose float32 parts keep TF32 off as well)
    was rejected for quantising away the Beta logits' small shifts
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
    # one of utils/optimizers.OPTIMIZERS, each with optax's defaults
    optimizer: str = "adam"
    # each optimizer's update math on one flat buffer per group (the JAX
    # package's optax.flatten): the same numbers, another checkpoint layout
    flat_optimizer: bool = False
    # the per-step rollout applies each action this many times, summing the
    # rewards (a world that ends stops repeating); 1 with rollout_block
    repeat_action: int = 1
    # one forward pass and one rendered frame per past_obs_freq steps
    rollout_block: bool = False
    # zero the advantage of block sub-steps after a mid-block auto-reset
    mask_post_reset: bool = True
    aux: float = 1.0
    seed: int = 42
    # re-seed the agent's generator from the OS before every update
    # (reference rl/agents/ppo.py:44-52)
    seed_regularization: bool = False
    # learn() runs up to this many updates, then moves their metrics to the
    # host at once; the numbers are those of one update at a time
    updates_per_dispatch: int = 8
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
    # the update schemes (see the module docstring; JAX CARLAgentConfig
    # :78-116): one summed-gradient step per minibatch, or one forward
    # pulled back twice with two backbone steps through one Adam state, or
    # through one per phase
    fused_update: bool = False
    two_step_update: bool = False
    two_step_split_adam: bool = False
    # the policy's log-prob of a fresh sample of the current policy instead
    # of the stored action (the CARLA reference's quirk, JAX :130-137)
    resample_actions: bool = False
    # "bfloat16": the network computes in bfloat16 with float32 parameters
    # (models/layers.py); anything else float32
    compute_dtype: str = "float32"

    def check(self) -> None:
        """Raise where the JAX package refuses the config: fused_update with
        a two-step scheme (carla_agent.py:191-193), an unknown optimizer
        (utils/optimizers.py:84-85), repeat_action above 1 with the block
        rollout (:413-414, the expert rollout takes precedence over both)."""
        if self.fused_update and (self.two_step_update or self.two_step_split_adam):
            raise ValueError("fused_update and two_step_update/_split_adam are mutually "
                             "exclusive")
        if self.optimizer.lower() not in OPTIMIZERS:
            raise ValueError(f"Cannot find optimizer {self.optimizer}. Select one of "
                             f"{sorted(OPTIMIZERS)}.")
        if self.repeat_action > 1 and self.rollout_block and not self.expert_rollout:
            raise ValueError("block rollout composes with repeat_action=1 only")


def eval_worlds(trials: int) -> int:
    """The worlds an evaluation of `trials` trials steps: oversampled, so
    that at least `trials` valid episodes survive the filter."""
    return max(trials + 8, int(trials * 1.25))


class CARLAgent:
    """Owns the network, the three optimizers (policy, value, dynamics; with
    two_step_split_adam the dynamics entry is a pair, one per phase), the
    schedules and the agent's generator (action samples, minibatch
    permutations and augmentation draws; the env's generator draws the
    resets)."""

    def __init__(self, env: CARLAEnv, config: Optional[CARLAgentConfig] = None,
                 name: str = "carla", weights_dir: Optional[str] = None,
                 mesh: Optional[mesh_mod.WorldMesh] = None,
                 log_mode: Optional[str] = "summary", log_dir: Optional[str] = None):
        self.env = env
        self.config = cfg = config or CARLAgentConfig()
        cfg.check()
        self.name = name
        # checkpoints and evaluation records, default weights-torch/<name>
        self.base_path = os.path.join(weights_dir or DEFAULT_WEIGHTS_DIR, name)
        # worlds sharded over the mesh's ranks; None: one process
        self.mesh = mesh
        if mesh is not None and env.device != mesh.device:
            raise ValueError(f"the env runs on {env.device}, this rank on {mesh.device}")
        # rank 0 writes the run's summaries, by default into logs/ beside the
        # weights root (the checkout's logs/, the JAX package's, for the
        # default root)
        if log_dir is None:
            root = os.path.dirname(os.path.abspath(self.base_path))
            log_dir = os.path.join(os.path.dirname(root), "logs")
        self.summary = Summary(mode=log_mode if mesh is None or mesh.rank == 0 else None,
                               name=name, log_dir=log_dir)
        spec = dict(cfg.network or {})
        net = CARLANetwork(
            num_actions=env.config.num_actions,
            control_policy=spec.get("control_policy"),
            control_value=spec.get("control_value"),
            dynamics=spec.get("dynamics"),
            image_channels=env.config.image_shape[2],
            nav_dim=world_mod.nav_feature_dim(env.params),
            fused_units=cfg.fused_units,
            compute_dtype=torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None,
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
        make = lambda group, lr: get_optimizer_by_name(  # noqa: E731
            cfg.optimizer, self.params[group], lr, flat=cfg.flat_optimizer)
        dyn_lr = self.dynamics_lr()
        self.optimizers = dict(
            policy=make("policy", self.policy_lr()), value=make("value", self.value_lr()),
            dynamics=((make("dynamics", dyn_lr), make("dynamics", dyn_lr))
                      if cfg.two_step_split_adam else make("dynamics", dyn_lr)))
        self.update_step = 0
        if mesh is not None:
            # every rank starts from rank 0's network
            mesh.broadcast_(self._replicated())
        # seconds of the last update's parts, each ended by a synchronise
        self.last_timings: Dict[str, float] = {}
        self.last_trials: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------------
    # objectives
    # ------------------------------------------------------------------
    def _policy_objective(self, pol: dict, batch: dict, hyper: dict):
        """PPO-clip + entropy + aux on the policy head's output `pol` (JAX
        carla_agent.py:283-330); the log-prob is of the STORED rollout
        action (the reference's base objective, rl/agents/ppo.py:322-325),
        or with resample_actions of a fresh sample of the current policy
        through which the gradient flows (JAX :290-296), drawn from the
        agent's generator, or from the Gamma variates batch["gammas"] when
        the batch holds them."""
        dist: Beta = pol["dist"]
        if self.config.resample_actions:
            sample = dist.rsample(self.generator, batch.get("gammas"))
        else:
            sample = batch["obs"]["action"]
        log_prob = dist.log_prob(dist.clip(sample))
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
        kw = self._sampler(cfg.num_envs)
        with self.env.sharded(self.mesh, cfg.num_envs):
            if cfg.expert_rollout:
                return rollout_mod.run_rollout(self.env, self._expert_log_prob_fn(),
                                               env_states, cfg.rollout_steps,
                                               expert_fn=self._expert_fn())
            if cfg.rollout_block:
                return rollout_mod.run_rollout_blocks(
                    self.env,
                    lambda net_in, n: net.predict(net_in, gen, num_samples=n, **kw),
                    env_states, cfg.rollout_steps)
            return rollout_mod.run_rollout(
                self.env, lambda net_in: net.predict(net_in, gen, **kw), env_states,
                cfg.rollout_steps, repeat_action=cfg.repeat_action)

    def _sampler(self, total: int) -> dict:
        """The predicts' keyword arguments in a sharded run of `total`
        worlds: a sampler that gathers the Beta parameters of every rank's
        worlds, draws the samples for all of them (the draws one process
        takes) and cuts them to this rank's rows; none in one process."""
        mesh = self.mesh
        if mesh is None:
            return {}

        def sample(dist: Beta, gen, n):
            full = Beta(alpha=mesh.gather_rows(dist.alpha, total),
                        beta=mesh.gather_rows(dist.beta, total))
            x = full.sample(gen) if n is None else full.sample_n(gen, n)
            return mesh.rows(x, total, dim=x.dim() - 2)
        return dict(sampler=sample)

    def _local(self, n: int) -> int:
        """How many of n worlds this process steps."""
        if self.mesh is None:
            return n
        lo, hi = self.mesh.shard(n)
        return hi - lo

    def _replicated(self) -> list:
        """The tensors every rank of a mesh holds alike: the network's
        parameters and buffers and the optimizers' states."""
        return mesh_mod.replicated_tensors(self.network, self.optimizers.values())

    def _expert_fn(self):
        """expert_fn(env_states) of the expert rollout: the expert's actions
        with the behaviours of expert_behaviour_mix cycled over the worlds,
        traffic lights ignored (JAX carla_agent.py:382-397)."""
        env = self.env
        profiles = expert_mod.behaviour_profiles(expert_mod.mixed_behaviour_ids(
            self.config.expert_behaviour_mix, self.config.num_envs, env.device))
        if self.mesh is not None:
            profiles = self.mesh.rows(profiles, self.config.num_envs)
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
        with span("minibatch.gather"):
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

    def _apply(self, group: str, grads, clip_norm: float, opt=None) -> None:
        """One optimizer step (the group's, or `opt`) of a parameter group
        on its per-tensor clipped gradients, then polyak averaging with the
        pre-step values."""
        with span("step.apply"):
            params = self.params[group]
            opt = opt or self.optimizers[group]
            old = ([p.detach().clone() for p in params]
                   if self.config.polyak < 1.0 and group != "dynamics" else None)
            for p, g in zip(params, um.clip_gradients(grads, clip_norm)):
                p.grad = g
            opt.step()
            opt.zero_grad(set_to_none=True)
            if old is not None:
                # the reference averages both heads (rl/agents/ppo.py:264-275)
                um.polyak_average_(params, old, self.config.polyak)

    def _dynamics_optimizers(self) -> tuple:
        """(the policy phase's, the value phase's) backbone optimizer: one
        optimizer twice, or the two of two_step_split_adam."""
        opt = self.optimizers["dynamics"]
        return opt if isinstance(opt, tuple) else (opt, opt)

    def _grads(self, loss: torch.Tensor, groups, retain_graph: bool = False):
        params = [p for g in groups for p in self.params[g]]
        with span("step.backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        retain_graph=retain_graph)
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
        with span("minibatch.policy_step"):
            with span("step.forward"):
                feat = net.dynamics_apply(batch["obs"], training=True)
                pol = net.policy_apply(feat, training=True)
                total, aux = self._policy_objective(pol, batch, hyper)
            grads = self._grads(total, ("policy", "dynamics"))
            # old_policy <- policy BEFORE the step (rl/agents/ppo.py:238-252):
            # the next rollout samples from the policy of one minibatch ago
            with span("step.old_policy"):
                net.update_old_policy()
            self._apply("policy", grads["policy"], cfg.clip_norm[0])
            if cfg.update_dynamics:
                self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2],
                            self._dynamics_optimizers()[0])
            aux["loss_total"] = total.detach()
            return aux

    def value_step(self, batch: dict) -> dict:
        """One value-phase step (JAX carla_agent.py:755-785): the backbone's
        second clipped Adam step of the minibatch pair, through the same
        dynamics Adam state as the policy phase."""
        cfg, net = self.config, self.network
        with span("minibatch.value_step"):
            with span("step.forward"):
                feat = net.dynamics_apply(batch["obs"], training=True)
                val = net.value_apply(feat, training=True)
                total, aux = self._value_objective(val, batch)
            grads = self._grads(total, ("value", "dynamics"))
            self._apply("value", grads["value"], cfg.clip_norm[1])
            if cfg.update_dynamics:
                self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2],
                            self._dynamics_optimizers()[1])
            # the JAX learner reports the phase's total as loss_value
            return dict(loss_value=total.detach())

    def _joint_forward(self, batch: dict, hyper: dict):
        """One training-mode pass of the backbone on a minibatch, both heads
        on its feature: (policy objective, value objective, the policy's
        metrics).  The BatchNorms fold the batch statistics once."""
        net = self.network
        with span("step.forward"):
            feat = net.dynamics_apply(batch["obs"], training=True)
            p_total, aux = self._policy_objective(net.policy_apply(feat, training=True),
                                                  batch, hyper)
            v_total, _ = self._value_objective(net.value_apply(feat, training=True), batch)
            return p_total, v_total, aux

    def fused_step(self, batch: dict, hyper: dict) -> dict:
        """One fused_update step (JAX carla_agent.py:510-569): the gradients
        of the summed objectives of one backbone pass, each group's clipped
        once, one step of each; old_policy becomes the policy from before
        the step.  Reports the value objective's total as loss_value."""
        cfg = self.config
        with span("minibatch.fused_step"):
            p_total, v_total, aux = self._joint_forward(batch, hyper)
            grads = self._grads(p_total + v_total, ("policy", "value", "dynamics"))
            with span("step.old_policy"):
                self.network.update_old_policy()
            self._apply("policy", grads["policy"], cfg.clip_norm[0])
            self._apply("value", grads["value"], cfg.clip_norm[1])
            if cfg.update_dynamics:
                self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2])
            aux.update(loss_value=v_total.detach(), loss_total=(p_total + v_total).detach())
            return aux

    def two_step(self, batch: dict, hyper: dict) -> dict:
        """One two_step_update or two_step_split_adam step (JAX
        carla_agent.py:601-682): one backbone pass, pulled back twice, so
        both gradients are taken at the same parameters; four clipped
        gradients; the heads one step each; the backbone two steps, the
        policy objective's gradient first, through one optimizer or (split)
        one per phase."""
        cfg = self.config
        with span("minibatch.fused_step"):
            p_total, v_total, aux = self._joint_forward(batch, hyper)
            gp = self._grads(p_total, ("policy", "dynamics"), retain_graph=True)
            gv = self._grads(v_total, ("value", "dynamics"))
            with span("step.old_policy"):
                self.network.update_old_policy()
            self._apply("policy", gp["policy"], cfg.clip_norm[0])
            self._apply("value", gv["value"], cfg.clip_norm[1])
            if cfg.update_dynamics:
                opt_p, opt_v = self._dynamics_optimizers()
                self._apply("dynamics", gp["dynamics"], cfg.clip_norm[2], opt_p)
                self._apply("dynamics", gv["dynamics"], cfg.clip_norm[2], opt_v)
            aux.update(loss_value=v_total.detach(), loss_total=(p_total + v_total).detach())
            return aux

    def train_iteration(self, env_states: EnvState, hyper: dict, host: bool = True):
        """Rollout + targets + the minibatch steps (the policy phase and the
        value phase, or the fused or two-step scheme).  Returns
        (env_states', metrics), the metrics as floats, or with host=False as
        one tensor on the device and their names; self.last_timings holds the
        seconds of the phases' spans (`update.rollout`, `update.targets`,
        `update.policy` and `update.value`, or `update.fused`), each ended by
        a synchronise."""
        cfg = self.config
        with timed("update.rollout") as t_rollout:
            env_states, traj, final_obs = self._rollout(env_states)
            last_action = env_states.last_action
            if self.mesh is not None:
                # every rank's worlds, for the same update on every rank
                traj = self.mesh.gather_rows(traj, cfg.num_envs, dim=1)
                final_obs, last_action = self.mesh.gather_rows((final_obs, last_action),
                                                               cfg.num_envs)
            self._sync()
        with timed("update.targets") as t_targets:
            data = self.targets(traj, final_obs, last_action, hyper["adv_scale"])
            self._sync()
        n = cfg.rollout_steps * cfg.num_envs
        n_mb = max(1, n // cfg.batch_size)

        def minibatches(epochs):
            perm = torch.randperm(n, generator=self.generator, device=self.env.device)
            return (self.gather_batch(data, perm[m * cfg.batch_size:(m + 1) * cfg.batch_size])
                    for _ in range(epochs) for m in range(n_mb))

        timings = dict(rollout=t_rollout.seconds, targets=t_targets.seconds)
        if cfg.fused_update or cfg.two_step_update or cfg.two_step_split_adam:
            # one permutation, optimization_steps[0] epochs over it (JAX
            # :571-572, :684-685)
            step = self.fused_step if cfg.fused_update else self.two_step
            with timed("update.fused") as t_update:
                p_metrics = v_metrics = [step(b, hyper)
                                         for b in minibatches(cfg.optimization_steps[0])]
                self._sync()
            timings["update"] = t_update.seconds
        else:
            with timed("update.policy") as t_policy:
                p_metrics = [self.policy_step(b, hyper)
                             for b in minibatches(cfg.optimization_steps[0])]
                self._sync()
            with timed("update.value") as t_value:
                v_metrics = [self.value_step(b) for b in minibatches(cfg.optimization_steps[1])]
                self._sync()
            timings.update(policy=t_policy.seconds, value=t_value.seconds)
        self.last_timings = timings

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
        values = torch.stack(list(metrics.values()))
        if not host:
            return env_states, (list(metrics), values)
        return env_states, dict(zip(metrics, values.tolist()))

    def learn(self, num_updates: int, env_states: Optional[EnvState] = None,
              callback=None):
        """Main training loop (reference rl/agents/ppo.py:464-568).  One
        update = rollout_steps x num_envs env steps and the PPO update.
        Runs the updates in chunks of updates_per_dispatch and moves a
        chunk's metrics to the host in one transfer after its last update
        (JAX carla_agent.py:920-960); the history and the callback get one
        entry per update with its own step, and its parts' seconds, timed
        when it ran.  With seed_regularization the agent's generator is
        re-seeded from the OS before each update (JAX :904-905).  Returns
        (env_states, list of metrics dicts)."""
        full_float32()
        cfg = self.config
        if env_states is None:
            with self.env.sharded(self.mesh, cfg.num_envs):
                env_states, _ = self.env.reset_batch(self._local(cfg.num_envs))
        history = []
        chunk = max(1, int(cfg.updates_per_dispatch))
        for first in range(0, num_updates, chunk):
            pending = []
            for _ in range(min(chunk, num_updates - first)):
                # read this update's learning rates and scalars, THEN step the
                # schedules (JAX carla_agent.py:898-912)
                for group, param in (("policy", self.policy_lr), ("value", self.value_lr),
                                     ("dynamics", self.dynamics_lr)):
                    set_learning_rate(self.optimizers[group], param())
                hyper = dict(clip_ratio=float(self.clip_ratio()),
                             entropy=float(self.entropy_strength()),
                             adv_scale=float(self.adv_scale()))
                if cfg.seed_regularization:
                    self.generator.manual_seed(secrets.randbits(63))
                self.update_step += 1
                for p in (self.policy_lr, self.value_lr, self.dynamics_lr,
                          self.clip_ratio, self.entropy_strength, self.adv_scale):
                    p.on_episode()
                with span("update"):
                    env_states, (names, values) = self.train_iteration(env_states, hyper,
                                                                       host=False)
                extra = dict(self.last_timings)
                if self.mesh is not None:
                    # the replicas' largest difference from rank 0 after the
                    # update, which leaves every rank with rank 0's tensors
                    extra["replica_drift"] = self.mesh.replica_drift_(self._replicated())
                pending.append((self.update_step, names, values, extra))
            rows = torch.stack([v for _, _, v, _ in pending]).tolist()
            for (step, names, _, extra), row in zip(pending, rows):
                metrics = dict(zip(names, row))
                metrics.update({k if k == "replica_drift" else f"seconds_{k}": v
                                for k, v in extra.items()})
                history.append(metrics)
                self.summary.log(**metrics)
                self.summary.write_summaries()
                if callback is not None:
                    callback(step, metrics)
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
        cfg = self.config
        p_total, v_total, _ = self._joint_forward(batch, hyper)
        grads = self._grads(p_total + v_total, ("policy", "value", "dynamics"))
        self.network.update_old_policy()
        self._apply("policy", grads["policy"], cfg.clip_norm[0])
        self._apply("value", grads["value"], cfg.clip_norm[1])
        self._apply("dynamics", grads["dynamics"], cfg.clip_norm[2],
                    self._dynamics_optimizers()[0])
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
        """network.pt (the state dict), optimizers.pt (the three optimizer
        states; with two_step_split_adam the dynamics entry is a list of
        the two phases') and config.json (schedule steps, update step,
        network spec) under `path` (default base_path)."""
        ckpt.save_agent(path or self.base_path, self.network.state_dict(),
                        ckpt.optimizer_states(self.optimizers), self.serialize_config())

    def load(self, path: Optional[str] = None, full: bool = True) -> None:
        """Restore a checkpoint of the port (network.pt) or of the JAX
        package (params.msgpack, converted in memory).  full=False restores
        only the dynamics backbone, the curriculum's stage transfer
        (reference core/networks.py:302-310).  As in the JAX package, a
        full restore copies policy -> old_policy."""
        path = path or self.base_path
        loaded = ckpt.load_agent(path, self.env.device)
        if full:
            ckpt.check_shapes(loaded["network"], self.network.state_dict(), path)
            self.network.load_state_dict(loaded["network"], strict=True)
            self.network.update_old_policy()
            ckpt.load_optimizer_states(self.optimizers, loaded.get("optimizers"))
        else:
            prefix = "dynamics."
            sd = {k[len(prefix):]: v for k, v in loaded["network"].items()
                  if k.startswith(prefix)}
            ckpt.check_shapes(sd, self.network.dynamics.state_dict(), path)
            self.network.dynamics.load_state_dict(sd, strict=True)
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
        """Evaluation rollout of `num_worlds` worlds for `timesteps` steps,
        from `draws` (default: drawn from the env's generator); every other
        random draw comes from the env's generator.  Per step, one network
        prediction and one env step (one rendered frame); with
        `rollout_block` and `timesteps` a multiple of past_obs_freq, in
        blocks as the JAX package evaluates (carla_agent.py:1016-1042): one
        prediction of past_obs_freq samples, the block's ticks in one
        env.step_physics_block call (one physics-kernel launch with
        fused_step) and one frame push (env.push_block_frame_batch).
        Returns the per-world accumulators of each world's FIRST episode;
        with NPCs also how it ended (hit_vehicle, hit_pedestrian,
        hit_other) and the active vehicles and walkers it started with.
        With a mesh, this process steps its shard of the worlds (its rows
        of `draws`, and of every draw), and the accumulators of all worlds
        are gathered."""
        mesh = self.mesh
        if draws is not None and mesh is not None:
            draws = mesh.rows(draws, num_worlds)
        with self.env.sharded(mesh, num_worlds):
            acc = self._eval_rollout(self._local(num_worlds), timesteps, draws,
                                     **self._sampler(num_worlds))
        return acc if mesh is None else mesh.gather_rows(acc, num_worlds)

    def _eval_rollout(self, num_worlds: int, timesteps: int, draws, **kw) -> dict:
        """CARLAgent.rollout of `num_worlds` worlds of this process; `kw`
        reach the predicts."""
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

        def accumulate(acc, typed, reward, term, trunc, info):
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
            ended = a * done
            typed = {k: torch.maximum(v, info[k].to(torch.float32) * ended)
                     for k, v in typed.items()}
            return acc, typed

        block = env.config.past_obs_freq
        if self.config.rollout_block and timesteps % block == 0:
            T = env.config.time_horizon
            slot = T - 1                # every world's newest frame after the reset
            for _ in range(timesteps // block):
                with span("eval.block"):
                    net_in = {f"state_{k}": v for k, v in env.observe(states).items()}
                    with span("predict"):
                        action01 = net.predict(net_in, gen, num_samples=block, **kw)["action"]
                    states, reward, term, trunc, info, did_reset = env.step_physics_block(
                        states, convert_action(action01))
                    states = states._replace(last_action=action01[-1])
                    for i in range(block):
                        acc, typed = accumulate(acc, typed, reward[i], term[i], trunc[i],
                                                {k: v[i] for k, v in info.items()})
                    states = env.push_block_frame_batch(states, did_reset.any(dim=0),
                                                        slot=slot)
                    slot = (slot + 1) % T
        else:
            for _ in range(timesteps):
                with span("eval.step"):
                    net_in = {f"state_{k}": v for k, v in obs.items()}
                    with span("predict"):
                        pred = net.predict(net_in, gen, **kw)
                    states, obs, reward, term, trunc, info = env.step(
                        states, convert_action(pred["action"]))
                    acc, typed = accumulate(acc, typed, reward, term, trunc, info)
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

        num_worlds = eval_worlds(trials)
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

        if self.mesh is None or self.mesh.rank == 0:
            os.makedirs(eval_dir, exist_ok=True)
            with open(os.path.join(eval_dir, f"{name}.json"), "w") as f:
                json.dump(record, f, indent=2)
        return record
