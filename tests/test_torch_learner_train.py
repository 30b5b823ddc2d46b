"""The port's learner trains on Town02 on the CPU: learn() of 2 updates
with block and per-step rollouts, save and load, stage_s1.run2, and the
CLI's --fused-units, at torch_learner_common.py's TINY_NET widths."""

import numpy as np
import pytest
import torch

from carla_driving_rl_agent_torch.curriculum import stages
from torch_learner_common import (  # noqa: F401
    TINY_NET, _agent, env, jnet_init, one_thread)


@pytest.mark.parametrize("block", [True, False])
def test_learn_two_updates(env, jnet_init, block):
    """Two updates with block rollouts (the kernel path) and with the
    per-step rollout (the JAX package's default)."""
    agent = _agent(env, jnet_init, num_envs=4, rollout_steps=8, batch_size=16,
                   rollout_block=block)
    before = {k: v.clone() for k, v in agent.network.state_dict().items()}
    _, history = agent.learn(2)
    assert len(history) == 2 and agent.update_step == 2
    for m in history:
        for k in ("loss_policy", "loss_value", "entropy", "ratio", "kl"):
            assert np.isfinite(m[k]), k
        assert set(agent.last_timings) == {"rollout", "targets", "policy", "value"}
    after = agent.network.state_dict()
    for grp in ("policy.", "value.", "dynamics."):
        moved = max(float((after[k] - before[k]).abs().max()) for k in after
                    if k.startswith(grp))
        assert moved > 0.0, grp


def test_save_load_round_trip(env, jnet_init, tmp_path):
    agent = _agent(env, jnet_init, tmp_path, num_envs=4, rollout_steps=8, batch_size=16,
                   rollout_block=True)
    agent.learn(1)
    agent.save()
    fresh = _agent(env, jnet_init, tmp_path, num_envs=4, rollout_steps=8, batch_size=16)
    fresh.load()
    sd, sd2 = agent.network.state_dict(), fresh.network.state_dict()
    for k in sd:
        if not k.startswith("old_policy."):
            assert torch.equal(sd[k], sd2[k]), k
    # a full restore copies policy -> old_policy, as the JAX package's does
    for n, p in fresh.network.old_policy.named_parameters():
        assert torch.equal(p, sd2[f"policy.{n}"])
    for g in ("policy", "value", "dynamics"):
        s1, s2 = agent.optimizers[g].state_dict(), fresh.optimizers[g].state_dict()
        for i in s1["state"]:
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(s1["state"][i][key], s2["state"][i][key])
    assert fresh.update_step == agent.update_step == 1
    # backbone-only restore
    other = _agent(env, jnet_init, tmp_path)
    with torch.no_grad():
        for p in other.network.value.parameters():
            p.add_(1.0)
    other.load(full=False)
    sd3 = other.network.state_dict()
    for k in sd:
        if k.startswith("dynamics."):
            assert torch.equal(sd3[k], sd[k]), k
    assert not torch.equal(sd3["value.v_base.weight"], sd["value.v_base.weight"])


def test_stage_s1_run2(tmp_path):
    stage = stages.stage_s1(
        episodes=1, timesteps=8, batch_size=16, num_envs=4, town="Town02",
        network=TINY_NET, rollout_block=True, weights_dir=str(tmp_path),
        env_overrides=dict(fused_step=True, device="cpu", num_routes=8,
                           image_shape=(45, 60, 3)))
    stage.run2(1)
    assert stage.agent.update_step == 1
    assert stage.env.params.origin_spawns is not None
    assert len(stage.env.params.origin_spawns) == 10
    for d in ("stage-s1", "stage-s1-0"):
        assert (tmp_path / d / "network.pt").exists()
        assert (tmp_path / d / "config.json").exists()


def test_cli_fused_units_smoke(tmp_path, monkeypatch):
    """`python -m carla_driving_rl_agent_torch.main --fused-units` on the CPU,
    cut to one update of 4 worlds x 8 steps of a tiny network on Town02: the
    flag reaches the agent, every stride-1 unit runs fused, and the
    checkpoint is written."""
    from carla_driving_rl_agent_torch import main as cli
    made, stage_s1 = [], stages.stage_s1

    def small_stage_s1(**kw):
        kw.update(network=TINY_NET, town="Town02",
                  env_overrides=dict(kw["env_overrides"], num_routes=8, image_shape=(45, 60, 3)))
        made.append(stage_s1(**kw))
        return made[-1]

    monkeypatch.setattr(cli, "EPISODES", 1)
    monkeypatch.setattr(cli, "TIMESTEPS", 8)
    monkeypatch.setattr(cli, "BATCH", 16)
    monkeypatch.setattr(cli.stages, "stage_s1", small_stage_s1)
    rc = cli.main(["--stage", "s1", "--epochs", "1", "--num-envs", "4", "--block",
                   "--fused-step", "--fused-units", "--device", "cpu",
                   "--weights-dir", str(tmp_path)])
    assert rc == 0
    agent = made[0].agent
    assert agent.config.fused_units and agent.update_step == 1
    backbone = agent.network.dynamics.ShuffleNetV2_0
    units = [getattr(backbone, f"ShuffleUnit_{i}") for i in range(backbone.num_units)]
    assert [u.fused for u in units] == [u.stride == 1 for u in units]
    assert (tmp_path / "stage-s1" / "network.pt").exists()
