"""The PyTorch port against the JAX package on the CPU on Town04, the
larger of the two multi-lane towns (two lanes per direction): the town and
route banks, the world, the physics step, NPC traffic with lane changes,
and the render of a multi-lane traffic state (tests/torch_towns_common.py
says what each check holds and to which bar), and the evaluation slice as
a whole, 8 Town04 worlds driven by the converted safe-s5 network for 12
steps (tests/test_torch_eval_rollout.py's checks and bars; its frames
with tolerance 3.11 of ROADMAP.md, test_rollout_image_stacks).  The town
is built once per side for the module."""

import numpy as np
import pytest

import test_torch_eval_rollout as ER
import torch_towns_common as C
from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnvConfig
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

TOWN = "Town04"
PUSH = CARLAEnvConfig.past_obs_freq     # the stacks take a frame every PUSH steps


@pytest.fixture(scope="module")
def sides():
    return C.build_sides(TOWN)


def test_town_matches_jax(sides):
    C.town_vs_jax(sides)


def test_route_banks_match_jax(sides):
    C.route_banks_vs_jax(sides)


def test_world_matches_jax(sides, rng):
    C.world_vs_jax(sides, rng)


def test_physics_step_matches_jax(sides):
    C.physics_vs_jax(sides)


@pytest.mark.parametrize("fleet", list(C.FLEETS))
def test_init_npcs_matches_jax(sides, fleet):
    C.init_npcs_vs_jax(sides, fleet)


@pytest.mark.parametrize("fleet", list(C.FLEETS))
def test_step_npcs_matches_jax(sides, fleet):
    C.step_npcs_vs_jax(sides, fleet)


def test_traffic_render_matches_jax(sides):
    C.render_vs_jax(sides)


@pytest.fixture(scope="module")
def rollout(sides):
    return ER.run_rollout(dict(ER.COMMON, town_names=(TOWN,)))


def test_rollout_exercised_auto_resets(rollout):
    ER.check_rollout_exercised_auto_resets(rollout)


def test_rollout_rewards_and_flags(rollout):
    ER.check_rewards_and_flags(rollout)


def test_rollout_image_stacks(rollout):
    """The image stacks within 2 u8 on > 99 % of values at every step
    (tests/test_torch_eval_rollout.py's bar); the newest frame of each
    stack within 2 u8 at every pixel but where the nearest road segment
    ties at a dashed marking (C.marking_ties; tolerance 3.11: on a
    multi-lane road the lane divider's band crosses such ties at every
    junction node) in one of the packs of the last PUSH steps (the stacks
    take a frame every PUSH steps)."""
    ties = []
    for i, s in enumerate(rollout):
        d = np.abs(s["t"]["image"].astype(np.int32) - s["j"]["image"].astype(np.int32))
        assert (d <= 2).mean() > 0.99, f"step {i}: {(d > 2).mean():.4f} of values off"
        ties = (ties + [C.marking_ties(s["t"]["geom"])])[-PUSH:]
        far = (d[:, -1] > 2).any(1) & ~np.any(ties, axis=0)
        assert not far.any(), f"step {i}: pixels off outside the ties {np.argwhere(far)[:8]}"


def test_rollout_network_outputs(rollout):
    ER.check_network_outputs(rollout)
