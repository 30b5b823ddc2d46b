"""mfu.train: the training iterations' analytic FLOPs
(portbench/yardstick.train_iteration_flops) over their seconds, against the
H100's float32 peak (67 TFLOP/s, the configuration computes in float32
without the tensor cores), in percent; over the window's iterations that
were not profiled."""

from portbench.yardstick import PEAK_FP32_FLOPS


def read(ctx):
    rate = ctx.get("train_flops_per_s")
    return None if rate is None else 100.0 * rate / PEAK_FP32_FLOPS
