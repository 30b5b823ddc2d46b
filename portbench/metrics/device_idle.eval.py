"""device_idle.eval: the share of the profiled sub-window in which no
kernel, copy or fill ran on the device, in percent."""


def read(ctx):
    red = ctx.get("reduced")
    if not red or not red["launches"]:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
