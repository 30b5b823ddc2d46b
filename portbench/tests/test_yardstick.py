"""The benchmark's copies of the port's arithmetic agree with the port's
own at the cells' shapes: the FLOP counts with utils/flops.py (the block
rollout's one forward per block, as chip_smoke.summary_flops_phase corrects
train_chunk_flops) and the unit bounds with chip_smoke.unit_bound_ms."""

import pytest

from portbench import yardstick

MAPS = [(11, 45, 116), (6, 23, 232), (3, 12, 464)]


def test_predict_flops():
    from carla_driving_rl_agent_torch.utils import flops
    assert yardstick.predict_flops(image_hw=(90, 360)) == flops.carla_predict_flops(
        image_hw=(90, 360))


def test_train_iteration_flops_block_corrected():
    from carla_driving_rl_agent_torch.utils import flops
    per_step = flops.carla_predict_flops(image_hw=(90, 360)) * 32
    skipped = 128 - 128 // 4
    want = flops.train_chunk_flops(1, 128, 32, image_hw=(90, 360)) - skipped * per_step
    assert yardstick.train_iteration_flops(128, 32, 4, image_hw=(90, 360)) == pytest.approx(
        want, rel=1e-12)


def test_unit_maps():
    assert yardstick.unit_maps(90, 360) == [MAPS[0]] * 3 + [MAPS[1]] * 7 + [MAPS[2]] * 3


@pytest.mark.parametrize("kind", ["infer", "fwd", "bwd"])
@pytest.mark.parametrize("n", [128, 248, 256])
@pytest.mark.parametrize("hwc", MAPS)
def test_unit_bound(kind, n, hwc):
    import chip_smoke
    h, w, c = hwc
    want_ms, _ = chip_smoke.unit_bound_ms(kind, n, h, w, c)
    assert 1e3 * yardstick.unit_bound_s(kind, n, h, w, c) == pytest.approx(want_ms, rel=1e-12)


def test_peaks():
    from carla_driving_rl_agent_torch.utils import flops
    assert (yardstick.PEAK_FP32_FLOPS, yardstick.PEAK_BF16_FLOPS, yardstick.PEAK_BYTES_PER_S) \
        == (flops.PEAK_FP32_FLOPS, flops.PEAK_BF16_FLOPS, flops.PEAK_BYTES_PER_S)
