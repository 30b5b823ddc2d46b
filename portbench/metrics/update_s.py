"""update_s: the mean seconds of an iteration's policy and value phases
(CARLAgent.last_timings "policy" + "value"), over the window's iterations
that were not profiled."""


def read(ctx):
    return ctx.get("update_s")
