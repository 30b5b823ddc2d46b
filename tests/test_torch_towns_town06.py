"""The PyTorch port against the JAX package on the CPU on Town06, the
second multi-lane town (two lanes per direction): the town and route
banks, the world, the physics step, NPC traffic with lane changes, and the
render of a multi-lane traffic state (tests/torch_towns_common.py says what
each check holds and to which bar).  The town is built once per side for
the module; the evaluation slice as a whole runs on Town04
(tests/test_torch_towns_town04.py)."""

import pytest

import torch_towns_common as C
from torch_learner_common import one_thread  # noqa: F401  (one PyTorch thread)

TOWN = "Town06"


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
