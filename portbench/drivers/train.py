"""Driver `train`: the curriculum's training loop, CARLAgent.learn, one
update per call (rollout, targets, the policy phase and the value phase),
with no checkpoint writes and no summaries, on the stage's env
(curriculum/stages.stage_<n>).

Set-up makes the network's weights on the device from --seed, seeds the
agent's and the env's generators from it, and drives the one agent through
one update of `warmup_rollout_steps` steps (one block: its predict, the
physics block, the push and render, the bootstrap pass and two minibatches
in each phase), which touches every shape of the window.  The window then
runs whole updates of `rollout_steps` while less than --seconds has
passed; the rate is all their env steps over all their time.  A traced run
profiles its second update and takes rollout_s, update_s and mfu.train
from the others.

For `correct` the reference follows three minibatch steps twice, each
time from the state they started from and on the same minibatches: the
set-up's first three steps (two policy steps and a value step) from the
weights the benchmark made, with fresh Adam states; and in the window's
first update its last policy step and first two value steps, from the
program's weights and Adam states at that point.  Each time it compares
the first step's loss, the first step's clipped gradient per leaf as the
optimizer got it (from Adam's first moment before and after that step)
and each leaf's change after the three.  In the window's first update the
rollout's predict and the render of block `capture_block` (drawn from
--seed) are kept with the network's state at that time and compared with
the reference's.  The learning rate and the objectives' constants are the
configuration's, handed to the program and to the reference alike.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import common
from portbench.trace import Tracer, annotate

FOLLOWED = 3        # the minibatch steps the reference follows from each start
B1 = 0.9            # Adam's first-moment decay


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 root: str):
        self.config, self.mix, self.device, self.root = config, mix, device, root
        self.seed = seed
        self.frame_i = self.block_i = self.step_i = 0
        self.iteration = -1

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from carla_driving_rl_agent_torch.curriculum import stages
        cfg, mix, ppo = self.config, self.mix, self.config["ppo"]
        self.out = common.out_dir(self.root, "train")
        factory = getattr(stages, f"stage_{mix['stage']}")
        self.stage = factory(
            episodes=1, timesteps=mix["timesteps"], batch_size=mix["batch"],
            num_envs=mix["worlds"], seed=mix["env_seed"], town=mix["town"],
            rollout_block=mix["rollout_block"], fused_units=cfg["fused_units"],
            weights_dir=self.out, log_mode=None,
            policy_lr=ppo["learning_rate"], value_lr=ppo["learning_rate"],
            dynamics_lr=ppo["learning_rate"], clip_ratio=ppo["clip_ratio"],
            entropy_regularization=ppo["entropy_regularization"],
            env_overrides=dict(fused_step=mix["fused_step"], device=self.device))
        self.stage.init()
        self.env = self.stage.env
        self.tracer = Tracer(self.device)
        self._install_env()
        self.fresh_agent(self.seed, self.stage.agent)

    def fresh_agent(self, seed: int, agent=None) -> None:
        """The agent of --seed (`agent`, or a new one with fresh optimizer
        states): its weights, its and the env's generators, the worlds'
        first episodes; then the set-up update."""
        from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent
        from portbench.reference import network as ref_net
        mix, dev = self.mix, self.device
        self.seed = seed
        s_weights, s_agent, s_env = common.seeds(seed, 3)
        if agent is None:
            agent = CARLAgent(self.env, self.stage.agent.config, name="portbench",
                              weights_dir=self.out, log_mode=None)
        self.agent = agent
        shapes = ref_net.spec(**self.config["network"])
        gen = torch.Generator(device=dev).manual_seed(s_weights)
        self.p0 = ref_net.init_weights(shapes, gen, dev)
        agent.network.load_state_dict(self.p0, strict=True)
        agent.generator.manual_seed(s_agent)
        self.env.seed(s_env)
        self.env_states, _ = self.env.reset_batch(mix["worlds"])
        blocks = mix["rollout_steps"] // self.env.config.past_obs_freq
        self.capture_block = int(common.rng(seed, 0).integers(0, blocks))
        self.net = agent.network
        self.units = common.UnitCalls(self.net, self.tracer)
        self.spans: List[dict] = []
        self.captured: dict = {}
        self.ref64: Dict[int, dict] = {}
        self._install_agent()
        # where the reference starts: the set-up's first step (update -1),
        # and the window's first update's last policy step (update 0)
        policy_steps = (mix["rollout_steps"] * mix["worlds"] // mix["batch"]
                        * agent.config.optimization_steps[0])
        self.follows = {-1: dict(first=0), 0: dict(first=policy_steps - 1)}
        agent.config.rollout_steps = mix["warmup_rollout_steps"]
        self.iteration = -2
        self._learn()
        agent.config.rollout_steps = mix["rollout_steps"]
        self.spans.clear()
        common.sync(dev)

    def _learn(self) -> None:
        """One update, as the curriculum's training loop runs it."""
        self.iteration += 1
        self.block_i = self.frame_i = self.step_i = 0
        self.env_states, _ = self.agent.learn(1, self.env_states)
        self.spans.append(dict(self.agent.last_timings))

    def _install_env(self) -> None:
        """Wrap the env's calls that an update makes: the render keeps
        block `capture_block` of the window's first update; all are named
        in a traced sub-window."""
        from carla_driving_rl_agent_torch.ops import render as render_ops
        env, tr = self.env, self.tracer
        for name, layer in (("step_physics_block", "physics"),
                            ("push_block_frame_batch", "push")):
            setattr(env, name, annotate(getattr(env, name), layer, tr))
        render_frame = annotate(env.render_frame, "render", tr)
        pack = render_ops.pack_geometry_banked

        def w_pack(*args, **kwargs):
            self.last_geom = pack(*args, **kwargs)
            return self.last_geom

        def w_render(world):
            frame = render_frame(world)
            if self.iteration == 0 and self.frame_i == self.capture_block:
                self.captured.update(geom=common.copy(self.last_geom),
                                     frame=common.copy(frame))
            self.frame_i += 1
            return frame

        env.render_frame = w_render
        render_ops.pack_geometry_banked = w_pack
        self.restore = lambda: setattr(render_ops, "pack_geometry_banked", pack)

    def _install_agent(self) -> None:
        """Wrap the agent's calls that an update makes: the minibatch gather
        and steps keep the steps that the reference follows, with the state
        they started from; the rollout's predict keeps block `capture_block`
        of the window's first update with the network's state; all are named
        in a traced sub-window."""
        agent, net, tr = self.agent, self.net, self.tracer
        names = {id(p): k for k, p in net.named_parameters()}
        self.group_names = {g: [names[id(p)] for p in ps] for g, ps in agent.params.items()}
        agent.targets = annotate(agent.targets, "targets", tr)
        gather = annotate(agent.gather_batch, "gather", tr)
        policy_step = annotate(agent.policy_step, "policy_step", tr)
        value_step = annotate(agent.value_step, "value_step", tr)
        predict = annotate(net.predict, "predict", tr)

        def w_gather(data, idx):
            batch = gather(data, idx)
            rec = self._followed()
            if rec is not None:
                if "start" not in rec:
                    rec.update(start=self._state(names), batches=[], phases=[], losses=[])
                rec["batches"].append(common.copy(batch))
            return batch

        def after_step(phase: str, loss) -> None:
            rec = self._followed()
            if rec is not None:
                rec["phases"].append(phase)
                rec["losses"].append(float(loss))
                if len(rec["losses"]) == 1:
                    rec["m1"] = self._state(names)["adam"]
                if len(rec["losses"]) == FOLLOWED:
                    rec["params"] = {k: v.detach().clone() for k, v in net.named_parameters()}
            self.step_i += 1

        def w_policy_step(batch, hyper):
            out = policy_step(batch, hyper)
            after_step("policy", out["loss_total"])
            return out

        def w_value_step(batch):
            out = value_step(batch)
            after_step("value", out["loss_value"])
            return out

        def w_predict(net_in, gen, *args, **kwargs):
            out = predict(net_in, gen, *args, **kwargs)
            if self.iteration == 0 and self.block_i == self.capture_block:
                self.captured.update(obs=common.copy(net_in), out=common.copy(out),
                                     state={k: v.detach().clone()
                                            for k, v in net.state_dict().items()})
            self.block_i += 1
            return out

        agent.gather_batch, agent.policy_step, agent.value_step = (
            w_gather, w_policy_step, w_value_step)
        net.predict = w_predict

    def _followed(self) -> Optional[dict]:
        """The record of the steps the reference follows, while the step
        about to be taken or just taken is one of them."""
        rec = self.follows.get(self.iteration)
        if rec is not None and rec["first"] <= self.step_i < rec["first"] + FOLLOWED:
            return rec
        return None

    def _state(self, names: dict) -> dict:
        """The network's tensors, and each optimizer's Adam state by tensor
        name: (first moment, second moment, step count)."""
        adam = {}
        for g, opt in self.agent.optimizers.items():
            adam[g] = {names[id(p)]: (st["exp_avg"].detach().clone(),
                                      st["exp_avg_sq"].detach().clone(), int(st["step"]))
                       for p, st in opt.state.items() if "exp_avg" in st}
        return dict(params={k: v.detach().clone() for k, v in self.net.state_dict().items()},
                    adam=adam)

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        from portbench import yardstick
        mix = self.mix
        per_iter = mix["rollout_steps"] * mix["worlds"]
        times = []
        t0 = time.perf_counter()
        while True:
            profiled = trace and len(times) == 1
            if profiled:
                self.tracer.start()
            t = time.perf_counter()
            self._learn()
            times.append(time.perf_counter() - t)
            if profiled:
                self.tracer.stop()
            # a traced run profiles its second update and reads two more
            if time.perf_counter() - t0 >= seconds and len(times) >= (3 if trace else 1):
                break
        total = time.perf_counter() - t0
        res = dict(attempted=len(times), failed=0,
                   e2e=dict(train_env_steps_per_s=len(times) * per_iter / total))
        if trace:
            keep = [i for i in range(len(times)) if i != 1]
            spans = [self.spans[i] for i in keep]
            flops = yardstick.train_iteration_flops(
                mix["rollout_steps"], mix["worlds"], self.env.config.past_obs_freq,
                image_hw=self.env.config.image_shape[:2])
            red = self.tracer.reduced
            res["ctx"] = dict(
                reduced=red, iterations=1, unit_bound_s=self.units.bound_s(),
                rollout_s=float(np.mean([s["rollout"] for s in spans])) if spans else None,
                update_s=(float(np.mean([s["policy"] + s["value"] for s in spans]))
                          if spans else None),
                train_flops_per_s=(len(keep) * flops / sum(times[i] for i in keep))
                if keep else None)
            res["device"] = dict(busy_s=red["busy_s"], window_s=red["window_s"])
            res["breakdown"] = dict(device_ops=red["device_ops"], idle_gaps=red["idle_gaps"])
        return res

    # ------------------------------------------------------------------
    def release(self) -> None:
        """Free what the program holds that the reference does not read, and
        give the port's render module its own function back."""
        self.env_states = None
        self.restore()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, candidate: str = "program") -> Dict[str, float]:
        """The numbers `correct` compares, each against the plain reference
        in float64.  Of the set-up's three followed steps, and with the
        prefix `window_` of the window's: loss_gap, the first step's loss's
        relative gap; grad_gap, the worst leaf's gap of the first step's
        clipped-gradient norm; change_gap, the median leaf's gap of the
        change after the three steps (each over the leaves whose reference
        gradient reaches a thousandth of the median leaf's; the later steps'
        losses and the worst leaf's change swing with Adam's steps on
        gradients near rounding, in the reference's own float32 too:
        PERF.md).  predict_gap: the widest relative gap of the window's
        rollout predict (the Beta's mean and std, the value);
        render_share_off: the share of its frames' bytes that differ from
        the reference renderer's.  `candidate` "program" judges the
        program; "tf32" (the control), "float32", "half_batch" (a fault:
        half of each minibatch left out) and "lr_off" (a fault: the learning
        rate 10 % high) put the reference, so computed, in its place;
        "one_frame" plants a fault in the frames (world 0 shown world
        1's)."""
        from portbench.reference import network as ref_net
        from portbench.reference import precision
        from portbench.reference import render as ref_render
        out, self.diag = {}, {}
        for prefix, it in (("", -1), ("window_", 0)):
            numbers, diag = self._check_steps(it, candidate)
            out.update({prefix + k: v for k, v in numbers.items()})
            self.diag.update({prefix + k: v for k, v in diag.items()})
        cap = self.captured
        with torch.no_grad():
            r = ref_net.predict(common.as64(cap["state"]), common.as64(cap["obs"]))
        if candidate in ("program", "one_frame"):
            g = cap["out"]
        else:
            with torch.no_grad(), precision.mode("tf32" if candidate == "tf32"
                                                  else "float32"):
                g = ref_net.predict(cap["state"], cap["obs"])
        out["predict_gap"] = max(common.rel_gap(g[k], r[k]) for k in ("mean", "std", "value"))
        # on the CPU, whose divisions are IEEE's as the kernel's are
        frame = ref_render.render_planes_plain(cap["geom"].cpu(), with_depth=False,
                                               n_actors=self.env.n_actors)
        shown = cap["frame"].cpu()
        if candidate == "one_frame":            # a fault: world 0 shows world 1's frame
            shown = torch.cat([shown[1:2], shown[1:]])
        diff = (frame.to(torch.int32) - shown.to(torch.int32)).abs()
        out["render_share_off"] = int((diff > 0).sum()) / diff.numel()
        self.diag.update(render_bytes_off=int((diff > 0).sum()),
                         render_levels_off=int(diff.max()))
        return out

    def _check_steps(self, iteration: int, candidate: str) -> tuple:
        """loss_gap, grad_gap and change_gap of the steps followed in update
        `iteration`, with what the look at them needs."""
        from portbench.reference import precision
        rec = self.follows[iteration]
        if len(rec.get("losses", ())) != FOLLOWED:
            raise RuntimeError(f"update {iteration}: followed {rec.get('phases')}")
        if iteration not in self.ref64:
            self.ref64[iteration] = self._follow(iteration, torch.float64)
        ref = self.ref64[iteration]
        if candidate in ("program", "one_frame"):
            got = dict(loss=rec["losses"], grads=self._program_grads(rec), params=rec["params"])
        else:
            with precision.mode("tf32" if candidate == "tf32" else "float32"):
                got = self._follow(iteration, torch.float32, half=candidate == "half_batch",
                                   lr_scale=1.1 if candidate == "lr_off" else 1.0)
        norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
        loss_gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["loss"], ref["loss"])]
        # the leaves whose reference gradient is nought to rounding (a bias
        # under a BatchNorm) are left out, by their largest gradient over the
        # three steps against the median leaf's
        moved = {}
        for grads in ref["all_grads"]:
            for k, v in grads.items():
                moved[k] = max(moved.get(k, 0.0), norm(v))
        median = float(np.median(list(moved.values())))
        keep = [k for k, v in moved.items() if v >= 1e-3 * median]
        g_ref = {k: norm(v) for k, v in ref["grads"].items() if k in keep}
        g_got = {k: norm(got["grads"][k]) for k in g_ref}
        p_start = common.as64(self._start(rec, iteration))
        d_ref = {k: norm(ref["params"][k] - p_start[k]) for k in keep}
        d_got = {k: norm(got["params"][k].double() - p_start[k]) for k in keep}
        leaf_gaps = sorted(abs(d_got[k] - d_ref[k]) / max(d_ref[k], 1e-30) for k in keep)
        grad_gap, grad_leaf = common.worst_leaf(g_got, g_ref)
        worst_change, change_leaf = common.worst_leaf(d_got, d_ref)
        numbers = dict(loss_gap=loss_gaps[0], grad_gap=grad_gap,
                       change_gap=leaf_gaps[len(leaf_gaps) // 2])
        diag = dict(phases=rec["phases"], loss_gaps=loss_gaps, grad_leaf=grad_leaf,
                    change_gap_worst_leaf=worst_change, change_leaf=change_leaf,
                    leaves_kept=len(keep), leaves=len(moved))
        return numbers, diag

    def _start(self, rec: dict, iteration: int) -> Dict[str, torch.Tensor]:
        """The weights the followed steps started from: the set-up's are the
        ones the benchmark made; the window's, the program's at that step."""
        return self.p0 if iteration < 0 else rec["start"]["params"]

    def _program_grads(self, rec: dict) -> Dict[str, torch.Tensor]:
        """The clipped gradient of each leaf of the first followed step's
        groups as the optimizer got it: (m1 - b1 m0) / (1 - b1) from Adam's
        first moments before and after that step."""
        first = "policy" if rec["phases"][0] == "policy" else "value"
        m0 = {k: m for g in rec["start"]["adam"].values() for k, (m, _, _) in g.items()}
        m1 = {k: m for g in rec["m1"].values() for k, (m, _, _) in g.items()}
        out = {}
        for k in self.group_names[first] + self.group_names["dynamics"]:
            if k not in m1:
                out[k] = torch.zeros_like(rec["params"][k], dtype=torch.float64)
                continue
            before = m0[k].double() if k in m0 else 0.0
            out[k] = (m1[k].double() - B1 * before) / (1.0 - B1)
        return out

    def _follow(self, iteration: int, dtype, half: bool = False,
                lr_scale: float = 1.0) -> dict:
        """The reference's steps followed in update `iteration` from their
        start, on the same
        minibatches, in `dtype` (with `half`, each minibatch's first half
        only; the learning rate times `lr_scale`)."""
        from portbench.reference import ppo as ref_ppo
        ppo = self.config["ppo"]
        cast = lambda t: t.to(dtype) if t.is_floating_point() else t  # noqa: E731
        rec = self.follows[iteration]
        start = self._start(rec, iteration)
        adam = {g: {k: (cast(m), cast(v), t) for k, (m, v, t) in state.items()}
                for g, state in rec["start"]["adam"].items()}
        learner = ref_ppo.Learner({k: cast(v) for k, v in start.items()},
                                  lr=ppo["learning_rate"] * lr_scale,
                                  clip_norm=ppo["clip_norm"], adam=adam)
        hyper = dict(clip_ratio=ppo["clip_ratio"], entropy=ppo["entropy_regularization"])
        losses = []
        for phase, batch in zip(rec["phases"], rec["batches"]):
            batch = _half(batch) if half else batch
            batch = common.as64(batch) if dtype == torch.float64 else batch
            losses.append(learner.step(phase, batch, hyper))
        return dict(loss=losses, grads=learner.grads[0], all_grads=learner.grads,
                    params=learner.p)


def _half(batch: dict) -> dict:
    n = batch["advantages"].shape[0] // 2
    cut = lambda v: v[:n] if isinstance(v, torch.Tensor) else v  # noqa: E731
    return {k: ({kk: cut(vv) for kk, vv in v.items()} if isinstance(v, dict) else cut(v))
            for k, v in batch.items()}
