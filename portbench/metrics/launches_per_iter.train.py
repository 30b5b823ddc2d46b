"""launches_per_iter.train: the kernels launched in the profiled
sub-window (one training iteration), per iteration."""


def read(ctx):
    red = ctx.get("reduced")
    return red["launches"] / ctx["iterations"] if red and red["launches"] else None
