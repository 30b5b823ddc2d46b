"""Each cell's check catches the faults the cell can have: a run at a small
size on the CPU (the look for a chip skipped) with the timed path broken
underneath comes out not correct, the number that the fault reaches above
its limit and above three times what the same run reads unbroken.  The
faults: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; the learning rate 10 % high; an answer
altered where it is produced (the predict, a frame, the NPC tick, the NPC
spawn).  One chip holds every cell, so no exchange between chips can be
left out.

At this size the CPU's float32 reads the first step's loss and gradients
farther from the float64 reference than the card does at the cell's size
(its BatchNorms over the stacks' zero frames), so the unbroken training run
is held to the limits of the numbers that the CPU reads as the card does."""

import contextlib
import io
import json

import pytest
import torch

from portbench.run import main

SMALL = dict(town="Town02", trials=2, steps=8, warmup_steps=4, capture_steps=2, trace_from=2,
             trace_steps=4, worlds=4, rollout_steps=8, timesteps=64, batch=8,
             warmup_rollout_steps=4)
SEED = "4100000003"


def _run(workload: str) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", workload, "--seed", SEED, "--seconds", "0"], device="cpu",
                  overrides=SMALL)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sound():
    return {w: _run(w) for w in sorted(FAULTS)}


def _predict_altered(monkeypatch):
    from carla_driving_rl_agent_torch.models.carla_network import CARLANetwork
    predict = CARLANetwork.predict

    def altered(self, *args, **kwargs):
        out = predict(self, *args, **kwargs)
        out["mean"] = out["mean"] * 1.01
        return out
    monkeypatch.setattr(CARLANetwork, "predict", altered)


def _frame_altered(monkeypatch):
    from carla_driving_rl_agent_torch.ops import render
    planes = render.render_planes

    def altered(geom, *args, **kwargs):
        out = planes(geom, *args, **kwargs).clone()
        out[0] = out[-1]                        # world 0 shows another world's frame
        return out
    monkeypatch.setattr(render, "render_planes", altered)


def _tick_unchanged(monkeypatch):
    from carla_driving_rl_agent_torch.envs import traffic
    monkeypatch.setattr(traffic, "step_npcs", lambda draws, npc, *args, **kwargs: npc)


def _spawn_moved(monkeypatch):
    from carla_driving_rl_agent_torch.envs import traffic
    spawn = traffic.init_npcs

    def moved(*args, **kwargs):
        npc = spawn(*args, **kwargs)
        return npc._replace(veh_xy=npc.veh_xy + 0.5)     # every vehicle half a metre off
    monkeypatch.setattr(traffic, "init_npcs", moved)


def _lr_high(monkeypatch):
    from carla_driving_rl_agent_torch.agents import carla_agent
    set_lr = carla_agent.set_learning_rate
    monkeypatch.setattr(carla_agent, "set_learning_rate",
                        lambda opt, lr: set_lr(opt, lr * 1.1))


def _step_unchanged(monkeypatch):
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent

    def policy_no_step(self, batch, hyper):
        with torch.no_grad():
            feat = self.network.dynamics_apply(batch["obs"], training=True)
            total, aux = self._policy_objective(self.network.policy_apply(feat, training=True),
                                                batch, hyper)
        return dict(aux, loss_total=total)

    def value_no_step(self, batch):
        with torch.no_grad():
            feat = self.network.dynamics_apply(batch["obs"], training=True)
            total, _ = self._value_objective(self.network.value_apply(feat, training=True),
                                             batch)
        return dict(loss_value=total)
    monkeypatch.setattr(CARLAgent, "policy_step", policy_no_step)
    monkeypatch.setattr(CARLAgent, "value_step", value_no_step)


def _half_batch(monkeypatch):
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent
    policy_step, value_step = CARLAgent.policy_step, CARLAgent.value_step

    def half(batch):
        n = batch["advantages"].shape[0] // 2
        return {k: ({kk: vv[:n] for kk, vv in v.items()} if isinstance(v, dict) else v[:n])
                for k, v in batch.items()}
    monkeypatch.setattr(CARLAgent, "policy_step",
                        lambda self, batch, hyper: policy_step(self, half(batch), hyper))
    monkeypatch.setattr(CARLAgent, "value_step",
                        lambda self, batch: value_step(self, half(batch)))


FAULTS = {
    "s5-eval-dense": [(_predict_altered, "predict_gap"), (_frame_altered, "render_share_off"),
                      (_tick_unchanged, "npc_gap"), (_spawn_moved, "spawn_gap")],
    "s5-eval-none": [(_predict_altered, "predict_gap"), (_frame_altered, "render_share_off")],
    "s1-train": [(_step_unchanged, "change_gap"), (_step_unchanged, "window_change_gap"),
                 (_half_batch, "grad_gap"), (_half_batch, "window_grad_gap"),
                 (_lr_high, "change_gap"), (_lr_high, "window_change_gap"),
                 (_predict_altered, "predict_gap"), (_frame_altered, "render_share_off")],
}
HELD_ON_CPU = dict(s1_train=("change_gap", "predict_gap", "render_share_off"))


@pytest.mark.parametrize("workload", sorted(FAULTS))
def test_sound_run_within_limits(workload, sound):
    checks = sound[workload]["checks"]
    held = HELD_ON_CPU.get(workload.replace("-", "_"), tuple(checks))
    for name in held:
        assert checks[name]["value"] <= checks[name]["limit"], (name, checks[name])
    if workload.startswith("s5-"):
        assert sound[workload]["correct"]


def _id(x) -> str:
    return (x if isinstance(x, str) else x.__name__).strip("_")


@pytest.mark.parametrize("workload,fault,number",
                         [(w, f, n) for w, fs in sorted(FAULTS.items()) for f, n in fs], ids=_id)
def test_fault_is_caught(workload, fault, number, monkeypatch, sound):
    fault(monkeypatch)
    res = _run(workload)
    assert not res["correct"]
    got, limit = res["checks"][number]["value"], res["checks"][number]["limit"]
    assert got > limit and got > 3 * sound[workload]["checks"][number]["value"], (got, limit)
