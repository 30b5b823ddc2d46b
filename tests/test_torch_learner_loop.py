"""The port's learner options that run its loop, against the JAX package
on the CPU, at tests/test_torch_learner.py's TINY_NET widths on Town02:

  * repeat_action=2 on the per-step rollout against JAX's run_rollout, and
    a world that ends at its first application skipping the second;
  * updates_per_dispatch 1 and 3 bit-equal over 3 updates;
    seed_regularization runs differing, and equal without it;
  * two_step_split_adam's checkpoint with its two backbone states;
  * --probe-cfg and --slow through the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.agents import rollout as jrollout
from carla_driving_rl_agent_tpu.envs import expert as jexpert
from carla_driving_rl_agent_tpu.envs import world as jworld
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnv as JEnv
from carla_driving_rl_agent_tpu.envs.carla_env import CARLAEnvConfig as JEnvConfig
from carla_driving_rl_agent_tpu.models.distributions import Beta as JBeta

from carla_driving_rl_agent_torch.agents import rollout as trollout
from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
from carla_driving_rl_agent_torch.curriculum import stages
from carla_driving_rl_agent_torch.envs import expert as texpert
from carla_driving_rl_agent_torch.envs import world as tworld
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
from carla_driving_rl_agent_torch.models.distributions import Beta as TBeta
from test_torch_block import _to_state
from test_torch_imitation import ROLL, _beta_params, share_towns
from test_torch_learner import TINY_NET, env  # noqa: F401
from test_torch_learner_variants import one_thread_module  # noqa: F401

# a small geometry for the loops of learn: 2 worlds x 4 steps, one
# minibatch of 8 per phase
SMALL = dict(num_envs=2, rollout_steps=4, batch_size=8, rollout_block=True)


def _tiny_agent(env, tmp, **cfg):
    return CARLAgent(env, CARLAgentConfig(network=TINY_NET, **cfg), name="t",
                     weights_dir=str(tmp), log_mode=None)


def test_repeat_action_rollout_matches_jax():
    """run_rollout with repeat_action=2, 8 steps of 8 Town02 worlds (the
    expert's actions, so that both sides act alike), against JAX's: each
    action applied twice, the rewards summed; no episode ends, so no reset
    draw is used."""
    share_towns("Town02")
    B = 8
    jenv = JEnv(JEnvConfig(world=jworld.WorldParams(**ROLL), render_mode="zeros",
                           image_height=45, image_width=60))
    tenv = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(**ROLL), image_height=45,
                                   image_width=60), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js, _ = jax.jit(jax.vmap(jenv.reset))(keys, jnp.zeros((B,), jnp.int32))

    def jexpert_fn(states):
        return jax.vmap(lambda w: jexpert.expert_action(
            w, jenv.params, jenv.town, jenv.routes, ignore_traffic_light=True))(states.world)

    def jpredict(net_in, action01):
        alpha, beta, value = _beta_params(jnp, net_in)
        return dict(log_prob=JBeta(alpha[:, None], beta[:, None]).log_prob(action01),
                    value=value)

    run = jax.jit(lambda s, k: jrollout.run_rollout(jenv, jpredict, s, k, 8, repeat_action=2,
                                                    expert_fn=jexpert_fn))
    jfinal, jtraj, _ = run(js, jax.random.PRNGKey(0))
    assert not np.any(np.asarray(jtraj.terminated + jtraj.truncated)), "an episode ended"

    def texpert_fn(states):
        return texpert.expert_action(states.world, tenv.params, tenv.town, tenv.routes,
                                     ignore_traffic_light=True)

    def tpredict(net_in, action01):
        alpha, beta, value = _beta_params(torch, net_in)
        return dict(log_prob=TBeta(alpha[:, None], beta[:, None]).log_prob(action01),
                    value=value)

    tfinal, ttraj, _ = trollout.run_rollout(tenv, tpredict, _to_state(js), 8,
                                            expert_fn=texpert_fn, repeat_action=2)
    for k in ("action", "reward", "speed", "similarity"):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(), np.asarray(getattr(jtraj, k)),
                                   rtol=0, atol=1e-4, err_msg=k)
    # two physics ticks per step
    np.testing.assert_array_equal(tfinal.world.timestep.numpy(),
                                  np.asarray(jfinal.world.timestep))
    assert int(tfinal.world.timestep[0]) == 16


def test_repeat_action_skips_ended_worlds():
    """A world whose episode ends at the first application keeps that
    step's state, reward and flags: 4 Town02 worlds of 3-step episodes,
    2 rollout steps of 2 applications each."""
    env = CARLAEnv(CARLAEnvConfig(world=tworld.WorldParams(town_names=("Town02",),
                                                           num_routes=8, max_timesteps=3),
                                  image_height=45, image_width=60), device="cpu")
    states, _ = env.reset_batch(4)

    def predict(net_in):
        b = net_in["state_road"].shape[0]
        return dict(action=torch.full((b, 2), 0.6), log_prob=torch.zeros(b, 2),
                    value=torch.zeros(b, 2))

    final, traj, _ = trollout.run_rollout(env, predict, states, 2, repeat_action=2)
    # step 1 ticks to timestep 2; step 2's first application ends the
    # episode at 3 and resets, and the second application is skipped
    assert traj.truncated[0].sum() == 0 and bool((traj.truncated[1] == 1).all())
    assert bool((final.world.timestep == 0).all()), final.world.timestep
    assert bool((final.world.episode == states.world.episode + 1).all())


def _learn(env, updates=3, **cfg):
    agent = _tiny_agent(env, "unused", **SMALL, **cfg)
    steps = []
    _, history = agent.learn(updates, callback=lambda s, m: steps.append(s))
    return agent, history, steps


def test_updates_per_dispatch_bit_equal(env):
    """3 updates dispatched one at a time and as one chunk of 3: the same
    parameters and metrics, bit for bit; the callback gets each update's
    own step either way."""
    a1, h1, s1 = _learn(env, updates_per_dispatch=1)
    a3, h3, s3 = _learn(env, updates_per_dispatch=3)
    assert s1 == s3 == [1, 2, 3]
    for k, v in a1.network.state_dict().items():
        assert torch.equal(v, a3.network.state_dict()[k]), k
    for m1, m3 in zip(h1, h3):
        for k in m1:
            if not k.startswith("seconds_"):
                assert m1[k] == m3[k], k


def test_seed_regularization(env):
    """Re-seeded from the OS before every update, two runs differ; without
    it two runs are equal."""
    runs = {flag: [_learn(env, updates=1, seed_regularization=flag)[0]
                   for _ in range(2)] for flag in (False, True)}
    key = "policy.alpha.weight"
    same = runs[False]
    assert torch.equal(same[0].network.state_dict()[key], same[1].network.state_dict()[key])
    diff = runs[True]
    assert not torch.equal(diff[0].network.state_dict()[key], diff[1].network.state_dict()[key])


def test_split_adam_checkpoint_round_trip(env, tmp_path):
    """two_step_split_adam saves its two backbone states and loads them; an
    agent without the split loads its own checkpoint as before, and a
    split checkpoint into it keeps its fresh dynamics state (a warning)."""
    agent = _tiny_agent(env, tmp_path, **SMALL, two_step_split_adam=True)
    agent.learn(1)
    agent.save()
    fresh = _tiny_agent(env, tmp_path, **SMALL, two_step_split_adam=True)
    fresh.load()
    for a, b in zip(agent.optimizers["dynamics"], fresh.optimizers["dynamics"]):
        sa, sb = a.state_dict(), b.state_dict()
        for i in sa["state"]:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa["state"][i][k], sb["state"][i][k])
    single = _tiny_agent(env, tmp_path)
    with pytest.warns(UserWarning, match="dynamics"):
        single.load()
    assert single.optimizers["dynamics"].state_dict()["state"] == {}
    assert single.optimizers["policy"].state_dict()["state"]


def test_cli_probe_cfg(tmp_path, monkeypatch):
    """--probe-cfg reaches the agent's config through the CLI, after
    FAST_TRAIN; --slow leaves FAST_TRAIN out."""
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
    monkeypatch.setattr(cli, "FAST_TRAIN", dict(fused_update=True, optimizer="sgd"))
    monkeypatch.setattr(cli.stages, "stage_s1", small_stage_s1)
    argv = ["--stage", "s1", "--epochs", "1", "--num-envs", "4", "--block", "--device", "cpu",
            "--weights-dir", str(tmp_path), "--probe-cfg",
            json.dumps(dict(fused_update=False, two_step_split_adam=True, flat_optimizer=True))]
    assert cli.main(argv) == 0
    cfg = made[0].agent.config
    assert cfg.two_step_split_adam and cfg.flat_optimizer and not cfg.fused_update
    assert cfg.optimizer == "sgd"                    # FAST_TRAIN's, under the probe
    assert made[0].agent.update_step == 1
    assert cli.main(argv[:-2] + ["--slow"]) == 0
    assert made[1].agent.config.optimizer == "adam" and not made[1].agent.config.fused_update
