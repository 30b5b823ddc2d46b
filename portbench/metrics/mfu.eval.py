"""mfu.eval: the evaluations' analytic FLOPs (one network forward per world
and step, portbench/yardstick.predict_flops) over their seconds, against the
H100's float32 peak (67 TFLOP/s), in percent; over the window's evaluations
that were not profiled."""

from portbench.yardstick import PEAK_FP32_FLOPS


def read(ctx):
    rate = ctx.get("eval_flops_per_s")
    return None if rate is None else 100.0 * rate / PEAK_FP32_FLOPS
