"""npc_host_ms: the host's milliseconds to enqueue one NPC tick
(envs/traffic.step_npcs) and one NPC spawn (envs/traffic.init_npcs) at the
window's last world state, each timed over 20 calls in flight."""


def read(ctx):
    return ctx.get("npc_host_ms")
