"""Vehicle dynamics: kinematic bicycle model at fixed dt = 1/30 s.

Counterpart of carla_driving_rl_agent_tpu/envs/dynamics.py, on (B,) tensors
of worlds.  Control semantics (reference core/carla_env.py:141-180):
`throttle_as_desired_speed` maps action[0] to a 0..100 km/h target speed and
throttle/brake are proportional errors; steer scales the front-wheel angle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DT = 1.0 / 30.0              # fixed_delta_seconds (reference environment.py:42-45,74-77)
WHEELBASE = 2.9              # m
LR = 1.45                    # rear-axle to CoM
MAX_STEER_ANGLE = 0.6109     # 35 deg front wheel at steer=1
MAX_ACCEL = 3.8              # m/s^2 full throttle
MAX_BRAKE = 8.0              # m/s^2 full brake
ROLL_DRAG = 0.08             # 1/s rolling+aero drag coefficient (on v)
QUAD_DRAG = 0.0015           # 1/m aero drag (on v^2)
MS_TO_KMH = 3.6


class VehicleControl(NamedTuple):
    throttle: torch.Tensor   # [0, 1]
    brake: torch.Tensor      # [0, 1]
    steer: torch.Tensor      # [-1, 1]
    reverse: torch.Tensor    # bool as float


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one IEEE division on every device.  PyTorch's CUDA
    kernels turn a division by a Python number into a multiplication by its
    float32 reciprocal, which can differ from x / c in the last bit (and
    then move a truncated cell index); a 0-dim tensor on x's device keeps
    the division exact, as the CPU, the JAX package and csrc/physics.cuh
    compute it."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def speed_kmh(v_ms: torch.Tensor) -> torch.Tensor:
    return torch.abs(v_ms) * MS_TO_KMH


def actions_to_control(actions: torch.Tensor, current_speed_ms: torch.Tensor,
                       throttle_as_desired_speed: bool = True,
                       disable_reverse: bool = True,
                       range_throttle=(0.0, 1.0), range_brake=(0.0, 1.0),
                       range_steer=(-1.0, 1.0)) -> VehicleControl:
    """Map agent actions in [-1, 1]^2 (or ^3 with a reverse channel) to a
    control: actions[..., 0] > 0 throttles, < 0 brakes; actions[..., 1]
    steers."""
    a0 = actions[..., 0]
    a1 = actions[..., 1]
    zero = torch.zeros_like(a0)
    throttle = torch.where(a0 > 0, a0, zero)
    brake = torch.where(a0 < 0, -a0, zero)
    steer = a1
    if actions.shape[-1] >= 3 and not disable_reverse:
        reverse_flag = (actions[..., 2] > 0).to(a0.dtype)
    else:
        reverse_flag = zero

    if throttle_as_desired_speed:
        desired = (a0 + 1.0) / 2.0 * 100.0                       # km/h
        current = current_speed_ms * MS_TO_KMH
        throttle = torch.where(current < desired, true_div(desired - current, 100.0), zero)
        brake = torch.where(current > desired, true_div(current - desired, 100.0), zero)

    throttle = torch.clamp(throttle, range_throttle[0], range_throttle[1])
    brake = torch.clamp(brake, range_brake[0], range_brake[1])
    steer = torch.clamp(steer, range_steer[0], range_steer[1])
    return VehicleControl(throttle=throttle, brake=brake, steer=steer,
                          reverse=reverse_flag)


def step_bicycle(x, y, yaw, v, control: VehicleControl, dt: float = DT):
    """One kinematic-bicycle integration step; returns new (x, y, yaw, v)."""
    accel = control.throttle * MAX_ACCEL - control.brake * MAX_BRAKE
    drag = ROLL_DRAG * v + QUAD_DRAG * v * v
    v_new = torch.clamp(v + (accel - drag) * dt, min=0.0)

    delta = control.steer * MAX_STEER_ANGLE
    beta = torch.atan(torch.tan(delta) * (LR / WHEELBASE))
    v_mid = 0.5 * (v + v_new)
    direction = 1.0 - 2.0 * control.reverse          # reverse gear flips motion
    x_new = x + direction * v_mid * torch.cos(yaw + beta) * dt
    y_new = y + direction * v_mid * torch.sin(yaw + beta) * dt
    yaw_new = yaw + direction * true_div(v_mid, LR) * torch.sin(beta) * dt
    yaw_new = torch.atan2(torch.sin(yaw_new), torch.cos(yaw_new))
    return x_new, y_new, yaw_new, v_new


def tgather(arr: torch.Tensor, town_id: torch.Tensor, *idx: torch.Tensor):
    """`arr[town_id, *idx]` per world, from a (towns, ...) bank array."""
    return arr[(town_id,) + idx]
