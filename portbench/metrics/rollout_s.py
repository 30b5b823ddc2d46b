"""rollout_s: the mean seconds of an iteration's rollout (the block
rollout's predicts, physics blocks, pushes and renders), as
CARLAgent.last_timings["rollout"] gives them, over the window's iterations
that were not profiled."""


def read(ctx):
    return ctx.get("rollout_s")
