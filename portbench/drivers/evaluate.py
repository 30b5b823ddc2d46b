"""Driver `evaluate`: the protocol's evaluation of a shipped checkpoint, as
`main --evaluate` runs each scenario (curriculum/stages.build_eval_agent,
then CARLAgent.evaluate): `trials` episodes as lock-step worlds for `steps`
steps, one predict and one env step (NPC tick, auto-reset with the NPC
spawn, render) per step.

The window runs whole evaluations, each seeded from --seed, while less
than --seconds has passed; the rate is all their env steps over all their
time.  A traced run profiles `trace_steps` steps of its first evaluation
and takes mfu.eval from the others.

For `correct`, the steps of `capture_steps` indices drawn from --seed are
kept from every evaluation (the last evaluation's stay): the predict's
inputs and outputs, the render kernel's geometry packs and frames, and the
NPC tick's and the NPC spawn's inputs and outputs.  After the window the
plain reference (portbench/reference) recomputes each from the same
inputs.  The town tables that the NPC tick and spawn read, and the
geometry packs, are the program's (PERF.md).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from portbench import common
from portbench.trace import Tracer, annotate


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device,
                 root: str):
        self.config, self.mix, self.device, self.root = config, mix, device, root
        self.reseed(seed)

    def reseed(self, seed: int) -> None:
        self.seed = seed
        self.eval_seeds = common.seeds(seed, 4096)
        r = common.rng(seed, 0)
        self.capture_set = set(int(i) for i in r.choice(self.mix["steps"],
                                                          self.mix["capture_steps"],
                                                          replace=False))
        self.captured: Dict[int, dict] = {}

    # ------------------------------------------------------------------
    def setup(self) -> None:
        from carla_driving_rl_agent_torch.agents.carla_agent import full_float32
        from carla_driving_rl_agent_torch.curriculum import stages
        from carla_driving_rl_agent_torch.envs import traffic
        from carla_driving_rl_agent_torch.ops import render as render_ops
        cfg, mix = self.config, self.mix
        full_float32()
        self.agent = stages.build_eval_agent(
            mode=mix["mode"], town=mix["town"], steps=mix["steps"], weights=cfg["weights"],
            weights_dir=os.path.join(self.root, cfg["weights_dir"]), device=self.device,
            fused_units=cfg["fused_units"], traffic=mix["traffic"])
        self.env, self.net = self.agent.env, self.agent.network
        self.traffic, self.render_ops = traffic, render_ops
        self.out = common.out_dir(self.root, "evaluate")
        self.tracer = Tracer(self.device)
        self.units = common.UnitCalls(self.net, self.tracer)
        self._install()
        # every shape of the window: the reset, the predict at the
        # evaluation's worlds and the env step, NPCs and render included
        self._evaluate(self.eval_seeds[-1], mix["warmup_steps"])
        common.sync(self.device)

    def _install(self) -> None:
        """Wrap the calls into the port that the window makes: the predict,
        the env step, the render and the NPC tick and spawn; each keeps what
        `correct` needs at the capture steps and is named in a traced
        sub-window."""
        net, env, tr = self.net, self.env, self.tracer
        predict, step = net.predict, env.step
        render_frame, pack = env.render_frame, self.render_ops.pack_geometry_banked
        tick, spawn = self.traffic.step_npcs, self.traffic.init_npcs
        self.orig = dict(tick=tick, spawn=spawn, pack=pack)
        a_predict = annotate(predict, "predict", tr)
        a_step = annotate(step, "env.step", tr)
        a_render = annotate(render_frame, "render", tr)
        a_tick = annotate(tick, "npc.tick", tr)
        a_spawn = annotate(spawn, "npc.spawn", tr)

        def w_predict(net_in, gen, *args, **kwargs):
            i = self.step_i
            if self.profile_from is not None:
                if i == self.profile_from:
                    tr.start()
                elif i == self.profile_from + self.mix["trace_steps"]:
                    tr.stop()
            out = a_predict(net_in, gen, *args, **kwargs)
            if i in self.capture_set:
                self.captured.setdefault(i, {}).update(obs=common.copy(net_in),
                                                       out=common.copy(out))
            self.step_i += 1
            return out

        def w_step(*args, **kwargs):
            out = a_step(*args, **kwargs)
            self.last_state = out[0]
            return out

        def w_pack(*args, **kwargs):
            self.last_geom = pack(*args, **kwargs)
            return self.last_geom

        def w_render(world):
            frame = a_render(world)
            i = self.frame_i - 1            # frame 0 is the reset's
            if i in self.capture_set:
                self.captured.setdefault(i, {}).update(
                    geom=common.copy(self.last_geom), frame=common.copy(frame))
            self.frame_i += 1
            return frame

        def w_tick(*args, **kwargs):
            out = a_tick(*args, **kwargs)
            i = self.tick_i
            if i in self.capture_set:
                self.captured.setdefault(i, {}).update(tick_in=common.copy(args),
                                                       tick_out=common.copy(out))
            self.tick_i += 1
            return out

        def w_spawn(*args, **kwargs):
            out = a_spawn(*args, **kwargs)
            i = self.spawn_i - 1            # spawn 0 is the reset's
            if i in self.capture_set:
                self.captured.setdefault(i, {}).update(
                    spawn_in=(common.copy(args), common.copy(kwargs)),
                    spawn_out=common.copy(out))
            self.spawn_i += 1
            return out

        net.predict, env.step, env.render_frame = w_predict, w_step, w_render
        self.render_ops.pack_geometry_banked = w_pack
        self.traffic.step_npcs, self.traffic.init_npcs = w_tick, w_spawn

    def _evaluate(self, seed: int, steps: int, profile_from: Optional[int] = None) -> None:
        self.step_i = self.frame_i = self.tick_i = self.spawn_i = 0
        self.profile_from = profile_from
        self.agent.evaluate(name=f"portbench-{self.mix['traffic']}", timesteps=steps,
                            trials=self.mix["trials"], initial_seed=seed,
                            evaluation_dir=self.out)

    # ------------------------------------------------------------------
    def window(self, seconds: float, trace: bool) -> dict:
        from carla_driving_rl_agent_torch.agents.carla_agent import eval_worlds
        from portbench import yardstick
        mix = self.mix
        per_eval = eval_worlds(mix["trials"]) * mix["steps"]
        times = []
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            self._evaluate(self.eval_seeds[len(times)], mix["steps"],
                           mix["trace_from"] if trace and not times else None)
            times.append(time.perf_counter() - t)
            # a traced run profiles its first evaluation and reads another
            if time.perf_counter() - t0 >= seconds and len(times) >= (2 if trace else 1):
                break
        total = time.perf_counter() - t0
        res = dict(attempted=len(times), failed=0,
                   e2e=dict(eval_env_steps_per_s=len(times) * per_eval / total))
        if trace:
            rest = times[1:]
            flops = yardstick.predict_flops(image_hw=self.env.config.image_shape[:2]) * per_eval
            red = self.tracer.reduced
            res["ctx"] = dict(
                reduced=red, trace_steps=mix["trace_steps"],
                unit_bound_s=self.units.bound_s(),
                eval_flops_per_s=(len(rest) * flops / sum(rest)) if rest else None,
                npc_host_ms=self.npc_host_ms() if self.env.params.has_npcs else None)
            res["device"] = dict(busy_s=red["busy_s"], window_s=red["window_s"])
            res["breakdown"] = dict(device_ops=red["device_ops"], idle_gaps=red["idle_gaps"])
        return res

    def npc_host_ms(self) -> float:
        """Host ms to enqueue one NPC tick and one NPC spawn at the window's
        last world state (20 of each in flight), as chip_smoke.npc_costs
        times them."""
        env, world = self.env, self.last_state.world
        p = env.params
        tick_draws, reset = env.npc_step_draws(world), env.reset_draws(world.x.shape[0])
        ego = torch.stack([world.x, world.y], dim=-1)
        fns = (lambda: self.orig["tick"](tick_draws, world.npc, env.town, world.town_id,
                                         world.sim_time, ego, world.v),
               lambda: self.orig["spawn"](reset.npc, env.town, reset.town_id, ego,
                                          p.num_vehicles, p.num_pedestrians,
                                          crossing=p.ped_crossing, running=p.ped_running))
        total = 0.0
        for fn in fns:
            fn()
            common.sync(self.device)
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            total += (time.perf_counter() - t0) / 20 * 1e3
            common.sync(self.device)
        return total

    # ------------------------------------------------------------------
    def release(self) -> None:
        """Free what the program holds that the reference does not read, and
        give the port's modules their own functions back."""
        self.last_state = None
        self.traffic.step_npcs, self.traffic.init_npcs = self.orig["tick"], self.orig["spawn"]
        self.render_ops.pack_geometry_banked = self.orig["pack"]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, candidate: str = "program") -> Dict[str, float]:
        """The numbers `correct` compares: the predict's widest relative gap
        (the Beta's mean and std, the value) from the plain reference in
        float64, the share of the render's bytes that differ from the
        reference renderer's, and with NPCs the NPC tick's and the NPC
        spawn's widest gaps.  `candidate` "program" judges the program's
        captured outputs; "tf32" (the control) and "float32" put the
        reference, computed so, in the predict's place; "one_frame",
        "unchanged_tick" and "moved_spawn" plant a fault: world 0 shown
        world 1's frame, the NPC tick returning the state it was given, every
        spawned vehicle half a metre off."""
        from portbench.reference import checkpoint as ref_ckpt
        from portbench.reference import network as ref_net
        from portbench.reference import precision
        from portbench.reference import render as ref_render
        from portbench.reference import traffic as ref_traffic
        cfg = self.config
        floor = cfg.get("preact_floor")
        p = ref_ckpt.load(os.path.join(self.root, cfg["weights_dir"], cfg["weights"]),
                          self.device)
        p64 = common.as64(p)
        out = dict(predict_gap=0.0, render_share_off=0.0)
        if self.env.params.has_npcs:
            out["npc_gap"] = out["spawn_gap"] = 0.0
        if len(self.captured) != len(self.capture_set):
            raise RuntimeError(f"captured {sorted(self.captured)} of {sorted(self.capture_set)}")
        off = total = level = 0
        for i, cap in sorted(self.captured.items()):
            with torch.no_grad():
                ref = ref_net.predict(p64, common.as64(cap["obs"]), preact_floor=floor)
            if candidate in ("program", "one_frame", "unchanged_tick", "moved_spawn"):
                got = cap["out"]
            else:
                with torch.no_grad(), precision.mode(candidate):
                    got = ref_net.predict(p, cap["obs"], preact_floor=floor)
            out["predict_gap"] = max(out["predict_gap"],
                                     *(common.rel_gap(got[k], ref[k])
                                       for k in ("mean", "std", "value")))
            # on the CPU, whose divisions are IEEE's as the kernel's are
            frame = ref_render.render_planes_plain(cap["geom"].cpu(), with_depth=False,
                                                   n_actors=self.env.n_actors)
            shown = cap["frame"].cpu()
            if candidate == "one_frame":        # a fault: world 0 shows world 1's frame
                shown = torch.cat([shown[1:2], shown[1:]])
            diff = (frame.to(torch.int32) - shown.to(torch.int32)).abs()
            off, total = off + int((diff > 0).sum()), total + diff.numel()
            level = max(level, int(diff.max()))
            if "npc_gap" in out:
                npc = ref_traffic.step_npcs(*cap["tick_in"])
                # a fault: the tick returns the state it was given
                ticked = cap["tick_in"][1] if candidate == "unchanged_tick" else cap["tick_out"]
                out["npc_gap"] = max(out["npc_gap"], npc_gap(ticked, npc))
                args, kwargs = cap["spawn_in"]
                spawned = cap["spawn_out"]
                if candidate == "moved_spawn":  # a fault: every vehicle half a metre off
                    spawned = spawned._replace(veh_xy=spawned.veh_xy + 0.5)
                out["spawn_gap"] = max(out["spawn_gap"],
                                       npc_gap(spawned, ref_traffic.init_npcs(*args, **kwargs)))
        out["render_share_off"] = off / total
        self.diag = dict(render_bytes_off=off, render_levels_off=level)
        return out


def npc_gap(got, ref) -> float:
    """The widest relative gap over the NPC state's fields (a flag or an
    index that differs counts 1)."""
    gap = 0.0
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if a.dtype.is_floating_point:
            gap = max(gap, common.rel_gap(a, b))
        elif not torch.equal(a, b):
            gap = max(gap, 1.0)
    return gap
