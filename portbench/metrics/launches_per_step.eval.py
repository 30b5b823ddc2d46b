"""launches_per_step.eval: the kernels launched in the profiled sub-window
(trace_steps evaluation steps of every world), per step."""


def read(ctx):
    red = ctx.get("reduced")
    return red["launches"] / ctx["trace_steps"] if red and red["launches"] else None
