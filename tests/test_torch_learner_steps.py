"""One policy-phase step then one value-phase step of the port's learner
against the JAX learner's (carla_agent.py:711-785), in float64, with the
backbone unfused and with fused_units=True; the parameters, the JAX
steps and the tolerances are torch_learner_common.py's (its docstring says
why each bar is what it is)."""

from torch_learner_common import (  # noqa: F401
    _steps_match_jax, env, jax_steps, jnet_init, one_thread)


def test_policy_and_value_steps_match_jax(env, jnet_init, jax_steps):
    """One policy-phase step then one value-phase step, from the same
    parameters, Adam states and minibatches."""
    _steps_match_jax(env, jnet_init, jax_steps)


def test_fused_units_steps_match_jax(env, jnet_init, jax_steps):
    """The same two steps with fused_units=True (the backbone's stride-1
    units through the fused op, its plain version on the CPU: forward,
    batch statistics, fold and backward) against the JAX learner's unfused
    steps, at the same bars."""
    _steps_match_jax(env, jnet_init, jax_steps, fused_units=True)
