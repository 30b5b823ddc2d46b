"""The benchmark's arithmetic: the H100's published peaks, the FLOPs of the
CARLA agent's network and of its work, and the least time of a fused
ShuffleNet-unit call.  Copies of the port's own arithmetic
(carla_driving_rl_agent_torch/utils/flops.py and chip_smoke.py's
unit_bound_ms), kept here so that a change to the port cannot move the
yardstick.

FLOPs = 2 x MACs of the matrix products and convolutions; elementwise,
BatchNorm and pooling work is under 1 % and is not counted.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM5 80GB, the data sheet's dense rates
PEAK_FP32_FLOPS = 67e12      # float32 on the CUDA cores
PEAK_BF16_FLOPS = 989e12     # bfloat16 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3

CHANNELS = (116, 232, 464)   # ShuffleNetV2 g = 1.0
STAGE_UNITS = (4, 8, 4)

# the fused unit's kernels, by the name of the kernel function
UNIT_KERNELS = ("k_pw", "k_dw_infer", "k_dw_train", "k_out_train", "k_bn3_back",
                "k_dw_back", "k_wgrad", "k_infer_bf16")


def shufflenet_v2_flops(h: int, w: int, cin: int = 3, last_channels: int = 768) -> float:
    """Conv FLOPs of one ShuffleNetV2 (g = 1.0) forward of one frame: stem
    3x3 s2 VALID, maxpool s2 SAME, stages of 4/8/4 units, 1x1 exit."""
    f = 0.0
    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    f += 2.0 * h * w * 24 * (3 * 3 * cin)
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    c_prev = 24
    for c, blocks in zip(CHANNELS, STAGE_UNITS):
        for i in range(blocks):
            if i == 0:
                ho, wo = math.ceil(h / 2), math.ceil(w / 2)
                f += 2.0 * h * w * (c // 2) * c_prev
                f += 2.0 * ho * wo * (c // 2) * 9
                f += 2.0 * ho * wo * (c - c_prev) * (c // 2)
                f += 2.0 * ho * wo * c_prev * 9
                f += 2.0 * ho * wo * c_prev * c_prev
                h, w, c_prev = ho, wo, c
            else:
                hc = c // 2
                f += 2.0 * h * w * hc * hc
                f += 2.0 * h * w * hc * 9
                f += 2.0 * h * w * hc * hc
    f += 2.0 * h * w * last_channels * c_prev
    return f


def unit_maps(h: int, w: int):
    """(h, w, c) of each stride-1 unit of one forward of an (h, w) frame, in
    the order the forward runs them."""
    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    out = []
    for c, blocks in zip(CHANNELS, STAGE_UNITS):
        h, w = math.ceil(h / 2), math.ceil(w / 2)
        out += [(h, w, c)] * (blocks - 1)
    return out


def _mlp(in_dim: int, units: int, layers: int) -> float:
    return 2.0 * in_dim * units + (layers - 1) * 2.0 * units * units


def _gru(in_dim: int, units: int, steps: int) -> float:
    return steps * 2.0 * 3.0 * (in_dim + units) * units


def predict_flops(image_hw=(90, 360), time_horizon: int = 4, last_channels: int = 768,
                  feature_units: int = 16, gru_image: int = 256, gru_feat: int = 32,
                  dynamics_units: int = 512, head_units: int = 320) -> float:
    """FLOPs of one network forward (backbone, policy and value heads) of
    one sample of `time_horizon` frames."""
    t = time_horizon
    f = t * shufflenet_v2_flops(*image_hw, last_channels=last_channels)
    for in_dim in (9, 4, 10):
        f += t * _mlp(in_dim, feature_units, 2)
    f += _gru(last_channels, gru_image, t)
    f += 3 * _gru(feature_units, gru_feat, t)
    f += 2.0 * (gru_image + 3 * gru_feat + 2) * dynamics_units
    for _ in range(2):
        f += _mlp(dynamics_units, head_units, 2)
        f += 2.0 * head_units * 8
    return f


def train_iteration_flops(rollout_steps: int, num_envs: int, past_obs_freq: int,
                          opt_steps=(1, 1), **predict_kw) -> float:
    """FLOPs of one sequential training iteration: the block rollout's one
    forward per block of `past_obs_freq` steps over `num_envs` worlds, then
    the policy and the value phase over every sample, a backward counted as
    two forwards."""
    per = predict_flops(**predict_kw)
    samples = rollout_steps * num_envs
    rollout = (rollout_steps // past_obs_freq) * num_envs * per
    return rollout + 3.0 * (opt_steps[0] + opt_steps[1]) * samples * per


def unit_bound_s(kind: str, n: int, h: int, w: int, c: int, itemsize: int = 4) -> float:
    """Least seconds of one fused-unit call of `n` frames at map (h, w, c):
    the bytes its function moves (each input read once, each output written
    once) over the memory rate, or its float operations over the FP32 peak,
    whichever is larger.  The forward reads x and the parameters and writes
    out (and, in training, the batch statistics); the backward reads x, the
    output gradient and the parameters and writes their gradients.
    Operations per pixel: the two 1x1 products 4 hc^2 and the depthwise
    18 hc forward; the backward's four products 8 hc^2 and two depthwise
    passes 36 hc."""
    hc = c // 2
    p = n * h * w
    act = p * c * itemsize
    params = 2 * hc * hc * itemsize + 19 * hc * itemsize
    stats = 6 * hc * itemsize
    if kind in ("infer", "fwd"):
        nbytes, ops = 2 * act + params + stats, 4 * hc * hc + 18 * hc
    elif kind == "bwd":
        nbytes, ops = 3 * act + 2 * params, 8 * hc * hc + 36 * hc
    else:
        raise ValueError(f"unknown unit call kind {kind!r}")
    return max(p * ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
