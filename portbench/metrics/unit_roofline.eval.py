"""unit_roofline.eval: the fused ShuffleNet units' share of their
roofline in the profiled sub-window: the least time of every unit call it
made (portbench/yardstick.unit_bound_s, a training call counting its
forward and its backward) over the device time of the kernels that compute
the units (yardstick.UNIT_KERNELS), in percent."""

from portbench.trace import kernel_seconds
from portbench.yardstick import UNIT_KERNELS


def read(ctx):
    red, bound = ctx.get("reduced"), ctx.get("unit_bound_s")
    secs = kernel_seconds(red, UNIT_KERNELS) if red else 0.0
    if not secs or not bound:
        return None
    return 100.0 * bound / secs
