"""Analytic FLOP accounting for the CARLA agent's network and train step,
and the H100's peak rates that bounds and utilisation are taken against.

Counterpart of carla_driving_rl_agent_tpu/utils/flops.py: the same
closed-form MAC walk over the model geometry (models/shufflenet.ShuffleNetV2
and models/carla_network.CARLANetwork), over the port's own CHANNELS.
FLOPs = 2 * MACs; only matmul and convolution FLOPs are counted
(elementwise, BatchNorm and pooling work is bound by bandwidth, not
FLOPs, and is under 1 % here).

The peaks are the NVIDIA H100 SXM5 80GB's dense rates (the data sheet):
float32 on the CUDA cores, bfloat16 on the tensor cores without sparsity,
and HBM3's bandwidth.
"""

import math

from carla_driving_rl_agent_torch.models.shufflenet import CHANNELS

PEAK_FP32_FLOPS = 67e12      # FLOP/s, float32 (CUDA cores)
PEAK_BF16_FLOPS = 989e12     # FLOP/s, bfloat16 tensor cores, dense
PEAK_BYTES_PER_S = 3.35e12   # bytes/s, HBM3


def shufflenet_v2_flops(h: int, w: int, cin: int = 3, g: float = 1.0,
                        last_channels: int = 768) -> float:
    """Conv FLOPs of ONE ShuffleNetV2 forward on one (h, w, cin) frame
    (models/shufflenet.ShuffleNetV2: stem 3x3 s2 VALID + maxpool s2 SAME,
    stages of 4/8/4 units, 1x1 exit conv)."""
    f = 0.0
    # stem: 3x3 s2 VALID -> 24 channels
    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    f += 2.0 * h * w * 24 * (3 * 3 * cin)
    # maxpool 3x3 s2 SAME (no MACs)
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    c_prev = 24
    for c, blocks in zip(CHANNELS[g], (4, 8, 4)):
        for i in range(blocks):
            if i == 0:                       # stride-2 unit: no split
                ho, wo = math.ceil(h / 2), math.ceil(w / 2)
                f += 2.0 * h * w * (c // 2) * c_prev        # branch 1x1
                f += 2.0 * ho * wo * (c // 2) * 9           # branch dw s2
                f += 2.0 * ho * wo * (c - c_prev) * (c // 2)  # branch 1x1
                f += 2.0 * ho * wo * c_prev * 9             # shortcut dw s2
                f += 2.0 * ho * wo * c_prev * c_prev        # shortcut 1x1
                h, w, c_prev = ho, wo, c
            else:                            # stride-1 unit: channel split
                hc = c // 2
                f += 2.0 * h * w * hc * hc                  # 1x1
                f += 2.0 * h * w * hc * 9                   # dw
                f += 2.0 * h * w * hc * hc                  # 1x1
    f += 2.0 * h * w * last_channels * c_prev               # exit 1x1
    return f


def _mlp_flops(in_dim: int, units: int, num_layers: int) -> float:
    f = 2.0 * in_dim * units
    for _ in range(num_layers - 1):
        f += 2.0 * units * units
    return f


def _gru_flops(in_dim: int, units: int, steps: int) -> float:
    # 3 gates, each (in + units) x units MACs per step
    return steps * 2.0 * 3.0 * (in_dim + units) * units


def carla_predict_flops(image_hw=(90, 360), time_horizon: int = 4,
                        g: float = 1.0, last_channels: int = 768,
                        feature_units: int = 16, gru_image: int = 256,
                        gru_feat: int = 32, dynamics_units: int = 512,
                        head_units: int = 320) -> float:
    """FLOPs of ONE full CARLANetwork forward (dynamics backbone + policy
    + value heads) for ONE sample: T frames through the weight-shared
    ShuffleNet + feature MLPs, GRUs over T, dynamics Dense, and both
    2-layer heads (models/carla_network.py DEFAULT_* spec)."""
    t = time_horizon
    f = t * shufflenet_v2_flops(*image_hw, cin=3, g=g,
                                last_channels=last_channels)
    # feature nets (road 9, vehicle 4, navigation 5 + past_control/command
    # folded in — use the obs dims; exact dims are <0.1% of total)
    for in_dim in (9, 4, 10):
        f += t * _mlp_flops(in_dim, feature_units, 2)
    f += _gru_flops(last_channels, gru_image, t)
    f += 3 * _gru_flops(feature_units, gru_feat, t)
    concat = gru_image + 3 * gru_feat
    f += 2.0 * (concat + 2) * dynamics_units          # dynamics Dense (+action)
    # policy + value heads: 2-layer MLPs + small output heads
    for _ in range(2):
        f += _mlp_flops(dynamics_units, head_units, 2)
        f += 2.0 * head_units * 8                     # output heads
    return f


def train_chunk_flops(num_updates: int, rollout_steps: int, num_envs: int,
                      opt_steps=(1, 1), fused_update: bool = False,
                      two_step: bool = False,
                      predict_flops: float = None, **predict_kw) -> float:
    """Analytic FLOPs of one `num_updates`-update train chunk
    (agents/carla_agent.CARLAgent.train_iteration): per update, a rollout of
    rollout_steps x num_envs inference forwards plus the minibatch SGD
    phase over all samples — backward ~= 2x forward, so each optimized
    sample costs ~3x a forward; the sequential (shipped) trainer runs the
    policy and value phases as separate fwd+bwd passes; two_step shares
    one forward but still runs both backwards (~5x a forward)."""
    if predict_flops is None:
        predict_flops = carla_predict_flops(**predict_kw)
    samples = rollout_steps * num_envs
    rollout = samples * predict_flops
    if fused_update:
        per_sample = 3.0 * opt_steps[0]
    elif two_step:
        per_sample = 5.0 * opt_steps[0]
    else:
        per_sample = 3.0 * (opt_steps[0] + opt_steps[1])
    update = per_sample * samples * predict_flops
    return num_updates * (rollout + update)
