#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (carla_driving_rl_agent_torch) on one
GPU: the quickest proof that the port builds, agrees with itself, drives
and trains.

    python3 chip_smoke.py [--out summary.json] [--profile]

Phases, each printed with its seconds:
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — the CUDA render, physics and ShuffleNet-unit kernels and the
               render helpers' card checks (nvcc, sm_90a) and the C++ route
               planner (g++), from the sources in the checkout, into
               build/torch_kernels/, all compilers at once;
  3. setup   — the one-town Town03 evaluation env and the safe-s5 checkpoint,
               read and converted in memory by the port's own reader;
  4. kernel  — the render kernel's exact helpers (parity, reciprocal,
               division) against the IEEE operations they replace, bit for
               bit on the card over every float or 2^32 random pairs
               (csrc/render_check.cu); then the render kernel against its
               plain PyTorch version on real reset states (|diff| <= 2 u8 on > 99 % of values and
               exact on >= 99.99 %): with depth and 0 or 2 actors at 64
               worlds, and at 32 (training), 62 (evaluation), 64 and 1024
               worlds (the env bench) with 0 and 8 actors (ahead, behind,
               beside, inactive); each size and actor count then timed with
               CUDA events, its device time per launch from a CUDA graph of
               repeated calls, the host's time per call, the bound (counted
               over what these inputs need: pixel_kinds) and its share;
               one device launch per call, counted in a CUDA graph; then
               the same on real traffic packs: 62 Town03 worlds with dense
               traffic (100 vehicles, 200 walkers) after 30 steps, their
               8 actor rows the nearest NPCs, and stage s2's pack: 32 worlds
               with 50 walkers and no vehicles after 8 steps, 5 actor rows
               (the vehicle row never active);
  5. agree   — the env stepped on the GPU and on the CPU from the same
               draws and actions, and the network's outputs on both, on a
               small input; then a dense-traffic Town03 batch the same way,
               its NPC state, collision flags and frames compared; then the
               block path (step_physics_block, push_block_frame_batch) of
               stage s3's env for 3 blocks of 8 worlds the same way, worlds
               restarting mid-block;
  6. slice   — the shipped evaluation of safe-s5 on Town03 without traffic
               (test weathers, seed 42, 512 steps, 50 trials), its six means
               beside the recorded ones, the render launch count and the
               env-steps/s;
  6b. slice_traffic — the same evaluation with regular (50 vehicles, 50
               walkers) and then dense (100, 200) traffic, beside the
               recorded Town03 regular and dense evaluations, with the
               collisions by type and the NPCs each world starts with;
  7. physics — the physics kernel against its plain PyTorch version on
               Town03 at 32 and 1024 worlds, 24-step episodes so that worlds
               reset: one tick per call (`step_physics_batch`) for 40 steps
               from identical states and reset draws, and a block of 4
               ticks per call (`step_physics_block`, the rollout's entry)
               for 10 blocks, bit for bit; then each timed with CUDA events
               beside its bound, its device time per launch from the
               profiler, and the cost per tick the rollout pays with each:
               the draws and one single-tick call, or a block's draws and
               block call over 4;
  8. env     — the env bench at bench.py's geometry (1024 worlds, Town03,
               64 routes, 512-step episodes, 32-step chunks of 8 blocks,
               fused_step, one block call per 4 ticks): env-steps/s and the
               launches per chunk;
  9. train   — stage s1 at the shipped geometry (32 worlds, 128-step block
               rollouts, batch 64, sequential float32 update, fused_step)
               for one epoch of 5 updates from a fresh seeded network: the
               metrics, the parameters moved, the kernel launches per
               update, env-steps/s and the four parts of an update, then
               the checkpoint saved and reloaded;
 10. train_agree — one policy-phase and one value-phase step of a small
               network on the card and on the CPU from the same parameters
               and minibatches, in float32 and in float64;
 11. unit    — the three ShuffleNet-unit kernels (inference, training
               forward, training backward) against their plain versions at
               the backbone's three stride-1 maps, at the paths' batches
               (256 frames in a minibatch, 248 in an evaluation predict,
               128 in a rollout predict) in float32, and in float64 at each
               map end to end against autograd of the plain forward; two
               training calls on the same inputs give the same bits; then
               each timed with CUDA events beside its bound, its device
               launches per call counted in a CUDA graph of one call (at
               most 3 per inference, 4 per forward, 5 per backward) and its
               device time per stage read from the profiler;
 12. slice_fused — the safe-s5 evaluation of phase 6 with fused_units=True:
               its six means beside the record and beside phase 6, and 13
               inference-kernel launches per predict;
 12b. slice_traffic_fused — the dense-traffic evaluation of phase 6b with
               fused_units=True, beside the record and phase 6b;
 13. train_fused — the stage-s1 epoch of phase 9 with fused_units=True: the
               same numbers, plus the unit kernels' launches per update and
               per minibatch;
 14. train_agree_fused — phase 10 with fused_units=True: the unit kernels on
               the card against the plain versions on the CPU;
 15. train_s2 — first, `--fused-step` with stages s2 and s4 must raise
               before any training; then stage s2 (50 walkers, 50
               origins) at the shipped geometry, unfused, for 2 updates
               (a depth cut), from the tracked weights/stage-s1 copied into
               a temporary weights root and handed off (main.hand_off): the
               loaded network equal to the checkpoint, the update step 150,
               no physics-kernel launch (the plain block steps NPC worlds),
               32 render launches per update and one at the reset;
 16. train_s3_fused — stage s3 (50 vehicles, 50 walkers, the training
               weathers) with fused_units=True for 2 updates (a depth cut),
               handed train_s2's checkpoint: network and Adam states equal
               to it before the first update, the unit kernels' launches,
               8 actor rows, training weathers drawn;
 17. train_s4 — stage s4 (s3's traffic and weathers, the training
               augmentation at aug_intensity 1.0), unfused, for 2 updates,
               from the tracked weights/stage-s3 handed off: the loaded
               network equal to the checkpoint, update step 290;
 18. augment_agree — the augmentation pipeline on the card against the
               CPU on a real s4 minibatch (64 samples x 4 frames of 90 x
               360 x 3, after train_s4) with the same draws at alpha 1.0:
               max |diff| <= 1e-5 before normalize on every frame, and
               after it on every frame that normalize does not amplify
               (its range there >= 1e-2; those below entered flat, the
               stacks' zero frames); then its launches, ms per minibatch
               (CUDA events, draws included) and device ms (a CUDA graph),
               and its share of an s4 update;
 19. train_s5_fused — stage s5 (Town03, dense traffic: 100 vehicles, 200
               walkers, the augmentation) with fused_units=True for 2
               updates, handed train_s4's checkpoint: network and Adam
               states equal to it, 8 actor rows;
 20. expert  — the privileged expert (envs/expert.py) drives 32 Town03
               worlds with stage s3's 50/50 NPCs for 128 steps on the
               card, its actions at every step equal to the plain CPU
               port's on the same state within the world bar (1e-5 +
               2.5e-7 relative); the mean similarity >= 0.7, the collision
               rate and env-steps/s;
 21. imitate — CARLACollectWrapper writes 4 expert episodes of 128 steps
               (Town03, 90 x 360 frames) into a temporary root; then
               CARLAgent.imitate at batch 64 with the shipped network from
               the same seeded weights, fused units against the unfused
               backbone, one step on a trace cut to 64 samples (the losses
               and the BatchNorm buffer changes within train_agree's
               float32 bars), then one epoch over the traces with fused
               units: ms per update and the unit kernels' launches;
 22. train_expert_fused — 2 updates of learn with expert_rollout=True and
               ratio_clamp at stage s1's geometry with fused units: the
               losses finite, the rollout's similarity >= 0.7, one render
               and one predict per step, no physics-kernel launch (the
               per-step env.step), env-steps/s beside train_fused's;
 23. benchmark — CARLABenchmark of safe-s5 with fused units, preset test
               (a new Town02 env per task), tasks empty and regular, 25
               trials of 1024 steps: the success, collision and timeout
               rates, env-steps/s, the Town02 env's build seconds; the
               route lengths within 1e-4 of a float64 recompute on the
               CPU from the same spawn states, the budgets nocrash_success's;
 24. record  — main.run_record of safe-s5 for 1 trial of 64 steps into a
               temporary root: frames (t, 90, 360, 3) u8 and info.json
               with reward and timestep;
 25. s4_towns — stage s4's NPC block path over random towns (Town01 +
               Town02, 50/50 NPCs, the training weathers) on the card
               against the CPU from the same draws, 3 blocks of 16 worlds
               restarting mid-block, some into the other town.
Each training phase prints the mean reward per step, the episodes that
ended, the NPCs per world, train env-steps/s and the four parts of an
update.  With --profile, a last phase breaks an evaluation window (without
and with dense traffic, where it also times the NPC tick and spawn) and one
training update down by kernel (torch.profiler), with and without fused
units, and one update of stage s3 with fused units, with the rollout's
launches per block and the NPC tick's and spawn's costs at 32 worlds.

Each path is driven with the kernels' launch counts set to 0 just before it
and read just after.  The line before the last lists every ported kernel
with its launches on the training path (the fused training path for the
unit kernels), and its error against the plain version, its time, the plain
version's time and its bound at the training path's size: 32 worlds for
render and physics (a block of 4 ticks), the (11, 45, 116) map of a 128-frame rollout predict
for the inference kernel and of a 256-frame minibatch for the training
kernels (--out also records the other sizes and paths).  The last line is
the JSON device record.
Any failed check raises, and the script exits non-zero; without a CUDA
device it exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Float operations of the render function, counted from csrc/render.cuh
# where each is done the fewest times the function allows (an add,
# multiply, compare, min/max, select, abs, floor, mod, divide, sqrt, exp or
# log1p counts 1), and only where these inputs need it (pixel_kinds):
# per pixel: ray rotation 6, building rays 8, the ray's quadrant (the signs
#   of its two reciprocals) 2, 8 buildings x 17 (4 slab products, 2
#   min/max of offsets sorted for the quadrant, height 2, hit test 7,
#   select and min 2), composition 10, light 5, fog 14, quantize 9;
# per pixel that shows a building: its shade 5 and colour 3;
# per pixel that shows the ground: ground point 4, 12 road segments x 19
#   and the nearest one's arc length 1, road distance 1, dashes 4, marking,
#   road and sidewalk tests 16, 4 junctions x 6 + distance, band, stripes
#   and crossing 11, base colours 12, wet road 3 + 12 (only these pixels'
#   colours depend on the road tests);
# per pixel of the front view with the depth plane: 4;
# per ray (the same in every world): ground distance 4;
# per world: 12 segment vectors, squared lengths and lengths x 7, 8
#   buildings' slab offsets 8 and their order 4, sky 25, light, sun,
#   wet-road, fog and road constants 16;
# per actor of a world: its activity test 1; per active actor: its
#   ego-frame position 9; per (view, active actor): view rotation 7 and
#   the test that it lies ahead 1; per (view, live actor: active and
#   ahead): projection (depth clamp, centre, half width, bottom and top
#   rows, four divisions) 14 and its integer row range 2;
# per (pixel of a row a live billboard spans, actor): the column test 3;
# per (pixel inside a live billboard, actor): the depth test 1 and the
#   four selects 4.
RENDER_OPS_PER_PIXEL = 6 + 8 + 2 + 8 * 17 + 10 + 5 + 14 + 9
RENDER_OPS_BUILDING_PIXEL = 5 + 3
RENDER_OPS_GROUND_PIXEL = 4 + 12 * 19 + 1 + 1 + 4 + 16 + 4 * 6 + 11 + 12 + 3 + 12
RENDER_OPS_DEPTH_PIXEL = 4
RENDER_OPS_PER_RAY = 4
RENDER_OPS_PER_WORLD = 12 * 7 + 8 * (8 + 4) + 25 + 16
RENDER_OPS_PER_ACTOR = 1
RENDER_OPS_PER_ACTIVE_ACTOR = 9
RENDER_OPS_PER_VIEW_ACTIVE_ACTOR = 7 + 1
RENDER_OPS_PER_VIEW_LIVE_ACTOR = 14 + 2
RENDER_OPS_PER_ROW_PIXEL_ACTOR = 3
RENDER_OPS_PER_COVERED_PIXEL_ACTOR = 1 + 4

# Float operations of the physics kernel per world, counted from
# csrc/physics.cuh as for the render kernel (a transcendental counts 1):
#   control 23, bicycle 40, route window and descent 78, similarity and
#   distances 14, collision 4, reward 12, bookkeeping 8 (= 179), plus the
#   off-road cell index 5 and 21 per cell segment.
def physics_ops_per_world(k_segs: int) -> int:
    return 179 + 5 + 21 * k_segs


TOWN = "Town03"
WEIGHTS = "safe-s5"
SEED = 42
STEPS = 512
TRIALS = 50
TRAFFIC_LEVELS = ("regular", "dense")


def scenario(traffic: str = "no") -> str:
    """The evaluation's record name of the Town03 scenario with `traffic`."""
    return f"{WEIGHTS}-test-{STEPS}-{TRIALS}-{TOWN}-{traffic}-{SEED}"


def reference(traffic: str = "no") -> str:
    return os.path.join("weights", WEIGHTS, "evaluation", f"{scenario(traffic)}.json")
METRICS = ("collision_rate", "similarity", "waypoint_distance", "speed",
           "total_reward", "timesteps")
ENV_WORLDS, ENV_CHUNK, ENV_CHUNKS = 1024, 32, 5
TRAIN_UPDATES, TRAIN_WORLDS, TRAIN_STEPS, TRAIN_BATCH = 5, 32, 128, 64


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        state = "ok" if exc_type is None else "FAILED"
        print(f"phase {self.name}: {self.seconds:.3f} s {state}", flush=True)
        return False


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream, between
    CUDA events around `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# profiler windows taken before a reading that needs a kernel's records
# gives up: CUPTI may lose all of a window's kernel records (on the H100,
# once, in the first window of the process)
PROFILE_WINDOWS = 4


def profile_calls(fn, calls: int = 5, want: str = "") -> dict:
    """The device kernels of `calls` calls of `fn` under torch.profiler
    (after one warm-up call): {kernel name: device ms per launch}; copies
    and fills are not kernels and are left out.  A window with no record of
    a kernel named `want` is taken again, up to PROFILE_WINDOWS windows.
    (Per launch: in a long process the profiler may miss some of a window's
    kernel records, so its counts are not read; graph_launches counts.)"""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for window in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / 1e3 / e.count
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))}
        if any(want in k for k in out):
            break
        print(f"  profiler window {window + 1} of {PROFILE_WINDOWS}: no record of a kernel "
              f"named {want!r} ({len(out)} kernels recorded)", flush=True)
    return out


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of `fn`: a CUDA graph of `reps`
    back-to-back calls (after a warm-up call), replayed `replays` times
    between CUDA events, so that the host's time per call is out of the
    reading (the graph's own gaps between launches stay in)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    graph.reset()
    return ms


def graph_launches(fn) -> int:
    """Kernel launches of one call of `fn`: the kernel nodes of a CUDA graph
    that captures the call (after a warm-up call), counted with the driver
    API; copies and fills are not kernels and are left out."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(kind.value)
    graph.reset()
    return sum(k == 0 for k in kinds)     # CU_GRAPH_NODE_TYPE_KERNEL


def _short(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def kernel_sass(lib_path: str, kernel: str) -> dict:
    """Static SASS facts of the kernel whose mangled name holds `kernel` in
    the built library `lib_path`, read with the toolkit's cuobjdump: its
    instructions, its calls into the compiler's IEEE slow-path subroutines
    (division, reciprocal, square root outside their fast range), its
    special-function (MUFU) instructions and its registers.  Empty when
    cuobjdump is missing."""
    import re
    from carla_driving_rl_agent_torch.utils.build import _nvcc
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    body = next(f for f in re.split(r"\n\s+Function : ", sass)[1:]
                if kernel in f.split("\n")[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", body)
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True, text=True,
                         check=True).stdout
    regs = re.search(rf"Function [^\n]*{kernel}[^\n]*\n\s*REG:(\d+)", res)
    return dict(instructions=len(ops), slow_path_calls=sum(o.startswith("CALL") for o in ops),
                mufu=sum(o.startswith("MUFU") for o in ops),
                registers=int(regs.group(1)) if regs else None)


def pixel_kinds(geom: torch.Tensor, n_actors: int = 0) -> dict:
    """What one render call of the packs `geom` with their first `n_actors`
    billboards has to compute, from the plain version's own helpers: how
    many pixels show an actor, a building, the ground (the ray meets it
    nearer than MAX_DEPTH and nothing hides that point) or the sky; how
    many actors are active, and how many (world, view, actor) billboards
    show at all (`live`); how many pixels lie in the rows a live billboard
    spans (`row_pixels`) and inside it (`covered`), summed over actors.
    Only ground pixels need the road, marking and crossing tests, only
    building pixels the shade, and only those pixels the actor tests."""
    from carla_driving_rl_agent_torch.ops import render as R
    lut = R.lut_tensors(geom.device)
    t_g = lut["kernel_lut"][3][None]
    t_b = R.building_depth(geom, *R.world_rays(geom))
    ground_ok = t_g < R.MAX_DEPTH
    t_gm = torch.where(ground_ok, t_g, 1e6)
    building = t_b < t_gm
    depth = torch.minimum(t_gm, t_b)
    uu, vv, vid = lut["u"][None], lut["v"][None], lut["vid"][None]
    actor = torch.zeros_like(building)
    live = row_pixels = covered = 0
    for k in range(n_actors):
        for view, (cx, u_c, half_u, v_top, v_bot, shows) in enumerate(R.billboards(geom, k)):
            rows = (vid == view) & (vv >= v_top) & (vv <= v_bot) & shows
            inside = rows & (torch.abs(uu - u_c) < half_u)
            # a pixel shows an actor iff a billboard covers it nearer than
            # the scene behind: the first such one (in order) is drawn
            actor |= inside & (cx < depth)
            live += int(shows.sum())
            row_pixels += int(rows.sum())
            covered += int(inside.sum())
    active = int((geom[:, R._O_ACT + 2:R._O_ACT + 8 * n_actors:8] > 0.5).sum())
    building &= ~actor
    ground = ground_ok & ~(t_b < t_gm) & ~actor
    return dict(actor=int(actor.sum()), building=int(building.sum()),
                ground=int(ground.sum()), sky=int((~actor & ~building & ~ground).sum()),
                active=active, live=live, row_pixels=row_pixels, covered=covered)


def render_ops(geom: torch.Tensor, n_actors: int = 0, channels: int = 3) -> int:
    """The float operations one render call of the packs `geom` needs
    (RENDER_OPS_*, counted over pixel_kinds)."""
    from carla_driving_rl_agent_torch.ops import render as R
    n_worlds = geom.shape[0]
    pixels = n_worlds * R.N_PIX
    kinds = pixel_kinds(geom, n_actors)
    ops = (pixels * RENDER_OPS_PER_PIXEL
           + kinds["building"] * RENDER_OPS_BUILDING_PIXEL
           + kinds["ground"] * RENDER_OPS_GROUND_PIXEL
           + R.N_PIX * RENDER_OPS_PER_RAY
           + n_worlds * (RENDER_OPS_PER_WORLD + n_actors * RENDER_OPS_PER_ACTOR)
           + kinds["active"] * (RENDER_OPS_PER_ACTIVE_ACTOR + 3 * RENDER_OPS_PER_VIEW_ACTIVE_ACTOR)
           + kinds["live"] * RENDER_OPS_PER_VIEW_LIVE_ACTOR
           + kinds["row_pixels"] * RENDER_OPS_PER_ROW_PIXEL_ACTOR
           + kinds["covered"] * RENDER_OPS_PER_COVERED_PIXEL_ACTOR)
    if channels == 4:
        ops += pixels // 3 * RENDER_OPS_DEPTH_PIXEL
    return ops


def render_bound_ms(geom: torch.Tensor, channels: int = 3, n_actors: int = 0) -> tuple:
    """Least time for one render call of the packs `geom`: its float
    operations (render_ops) over the FP32 peak, or its bytes (packs and LUT
    read once, frames written once) over the memory rate, whichever is
    larger."""
    from carla_driving_rl_agent_torch.ops import render as R
    n_worlds = geom.shape[0]
    ops_s = render_ops(geom, n_actors, channels) / PEAK_FP32_FLOPS
    nbytes = n_worlds * R.GEOM_PAD * 4 + 3 * R.N_PIX * 4 + n_worlds * R.N_PIX * channels
    bytes_s = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes")


# (forward m, left m, active) of each billboard relative to its ego: ahead,
# behind, beside on the left, inactive ahead, ahead and right, beside on
# the right, far ahead, inactive beside (tests/test_torch_render.py's set)
ACTOR_PLACES = ((8.0, 0.0, 1.0), (-10.0, 0.0, 1.0), (1.0, 6.0, 1.0), (10.0, 1.0, 0.0),
                (14.0, -1.5, 1.0), (0.5, -5.0, 1.0), (30.0, 2.0, 1.0), (2.0, 4.0, 0.0))


def with_actors(geom: torch.Tensor, n: int) -> torch.Tensor:
    """Copy of the packs with the first `n` billboards of ACTOR_PLACES
    around each ego, to exercise the kernel's actor path."""
    from carla_driving_rl_agent_torch.ops import render as R
    g = geom.clone()
    ex, ey = g[:, R._O_EGO], g[:, R._O_EGO + 1]
    c, s = g[:, R._O_EGO + 2], g[:, R._O_EGO + 3]
    for k, (fwd, left, active) in enumerate(ACTOR_PLACES[:n]):
        row = R._O_ACT + 8 * k
        g[:, row] = ex + fwd * c - left * s
        g[:, row + 1] = ey + fwd * s + left * c
        g[:, row + 2:row + 8] = torch.tensor(
            [active, 1.0 + 0.1 * k, 1.6, 180.0 - 20 * k, 30.0 + 20 * k, 30.0], device=g.device)
    return g


def _render_check_lib():
    import ctypes
    from carla_driving_rl_agent_torch.ops import render as R
    from carla_driving_rl_agent_torch.utils.build import csrc, load_library
    return load_library(
        "render_check", [csrc("render_check.cu")], "nvcc",
        {"cdrl_render_check_helpers": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int])},
        extra_deps=[csrc("render.cuh")], extra_flags=R._NVCC_FLAGS)


RENDER_HELPER_ROUNDS = 4     # x 2^30 random pairs of each distribution for div_rn


def render_helper_mismatches(pair_rounds: int = RENDER_HELPER_ROUNDS) -> list:
    """The render kernel's exact helpers against the IEEE operations they
    replace, on the card (csrc/render_check.cu): mismatches of even_floor
    over every finite float, of rcp_rn over every float of exponent
    1..252, and of div_rn over `pair_rounds` x 2^30 raw pairs and as many
    pairs of the kernel's operands."""
    import ctypes
    out = (ctypes.c_ulonglong * 4)()
    err = _render_check_lib().cdrl_render_check_helpers(out, pair_rounds)
    check(err == 0, f"render helper checks: CUDA error {err}")
    return list(out)


RENDER_WORLDS = (32, 62, 64, 1024)   # training, evaluation, a full tile, env bench
RENDER_ACTORS = (0, 8)                # the no-traffic paths, and K_ACTORS (traffic)
RENDER_EXACT = 0.9999                 # share of values equal to the plain version's


def kernel_phase(env, kernels: dict) -> dict:
    """The render kernel against its plain version on real Town03 reset
    states: with depth and 0 or 2 actors at 64 worlds, and at 32 worlds
    (training), 62 (evaluation), 64 and 1024 (the env bench) with 0 and 8
    actors (ahead, behind, beside, inactive: ACTOR_PLACES); each within 2
    u8 on > 99 % of values and exact on RENDER_EXACT of them.  Then each
    size and actor count timed: ms per call (CUDA events), device ms per
    launch (a CUDA graph of repeated calls), the host's ms per call, the
    plain version, the bound and its share; and one device launch per
    call, counted in a CUDA graph."""
    from carla_driving_rl_agent_torch.ops import render as R
    helpers = render_helper_mismatches()
    print(f"  render helpers on the card, mismatches against the IEEE operations they "
          f"replace: even_floor {helpers[0]} (every finite float), rcp_rn {helpers[1]} "
          f"(every float of exponent 1..252), div_rn {helpers[2]} / {helpers[3]} "
          f"({RENDER_HELPER_ROUNDS} x 2^30 raw pairs / kernel-operand pairs)", flush=True)
    check(sum(helpers) == 0, f"render helpers disagree with IEEE on the card: {helpers}")
    env.seed(7)
    states, _ = env.reset_batch(max(RENDER_WORLDS))
    w = states.world
    geom = R.pack_geometry_banked(env.town, w, env.weather_params[w.weather_id]).contiguous()
    worst, least_exact = 0, 1.0
    cases = [(64, True, 0), (64, True, 2)] + [(n, False, a) for n in RENDER_WORLDS
                                              for a in RENDER_ACTORS]
    for n, depth, actors in cases:
        g = geom[:n].contiguous()
        g = with_actors(g, actors) if actors else g
        out_k = R.render_planes(g, with_depth=depth, n_actors=actors)
        out_p = R.render_planes_plain(g, with_depth=depth, n_actors=actors)
        torch.cuda.synchronize()
        diff = (out_k.to(torch.int32) - out_p.to(torch.int32)).abs()
        within = float((diff <= 2).float().mean())
        exact = float((diff == 0).float().mean())
        print(f"  render {n} worlds depth={depth} actors={actors}: "
              f"exact {exact:.7f}, |diff|<=2 {within:.7f}, "
              f"max |diff| {int(diff.max())}", flush=True)
        check(within > 0.99, f"render kernel vs plain at {n} worlds: {within:.6f} "
                             f"of pixels within 2")
        check(exact >= RENDER_EXACT, f"render kernel vs plain at {n} worlds, {actors} actors: "
                                     f"{exact:.7f} of values exact")
        worst, least_exact = max(worst, int(diff.max())), min(least_exact, exact)
        del out_k, out_p, diff
    times = {}
    for actors in RENDER_ACTORS:
        for n in RENDER_WORLDS:
            g = geom[:n].contiguous()
            g = with_actors(g, actors) if actors else g
            call = lambda: R.render_planes(g, n_actors=actors)  # noqa: E731
            ms = cuda_ms(call, iters=200, warmup=10)
            device_ms = graph_ms(call)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):     # the host's time to enqueue a call (20 in flight)
                call()
            host_ms = (time.perf_counter() - t0) / 20 * 1e3
            plain_ms = cuda_ms(lambda: R.render_planes_plain(g, n_actors=actors), iters=20)
            bound, by = render_bound_ms(g, n_actors=actors)
            kinds = pixel_kinds(g, actors)
            times[f"{n}/{actors}"] = dict(ms=ms, device_ms=device_ms, host_ms=host_ms,
                                          plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                                          bound_share=bound / device_ms, pixel_kinds=kinds)
            print(f"  render {n} worlds, {actors} actors: kernel {ms:.6f} ms per call, device "
                  f"{device_ms:.6f} ms per launch, host {host_ms:.6f} ms per call; plain "
                  f"{plain_ms:.6f} ms; bound {bound:.6f} ms ({by}), {bound / device_ms:.3f} of "
                  f"the device time ({kinds['ground'] / (n * R.N_PIX):.4f} of pixels show the "
                  f"ground, {kinds['building'] / (n * R.N_PIX):.4f} a building, "
                  f"{kinds['actor'] / (n * R.N_PIX):.4f} an actor); library "
                  f"call: none computes this function", flush=True)
    per_call = {}
    for a in RENDER_ACTORS:
        g = geom[:TRAIN_WORLDS].contiguous()
        g = with_actors(g, a) if a else g
        per_call[a] = graph_launches(lambda: R.render_planes(g, n_actors=a))
    print("  render_planes: device launches per call " + ", ".join(
        f"{per_call[a]} with {a} actors" for a in RENDER_ACTORS), flush=True)
    check(all(v == 1 for v in per_call.values()), f"render launches per call {per_call}")
    sass = kernel_sass(R._kernel_lib()._name, "render_kernel")
    print("  render kernel SASS (cuobjdump): " + (
        f"{sass['instructions']} instructions in the binary, {sass['slow_path_calls']} calls "
        f"to IEEE slow paths, {sass['mufu']} MUFU, {sass['registers']} registers"
        if sass else "not measured (no cuobjdump)"), flush=True)
    # the kernels line reports the training path's size, as its launches
    t = times[f"{TRAIN_WORLDS}/0"]
    kernels["render_planes"] = dict(
        name="render_planes", route="cuda",
        source="carla_driving_rl_agent_torch/csrc/render.cu",
        replaces="carla_driving_rl_agent_tpu/ops/rasterizer_pallas.py:99",
        launches=None, max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        by_worlds_actors=times, launches_per_call=per_call[0])
    return dict(times=times, max_abs_err=worst, least_exact_share=least_exact,
                helper_mismatches=helpers, sass=sass)


TRAFFIC_RENDER_WORLDS, TRAFFIC_RENDER_STEPS = 62, 30
S2_RENDER_STEPS = 8          # stage s2's pack: 32 worlds (the training batch) after 8 steps


def traffic_render_check(env, n: int = TRAFFIC_RENDER_WORLDS,
                         steps: int = TRAFFIC_RENDER_STEPS, label: str = "dense traffic") -> dict:
    """The render kernel against its plain version on real traffic packs:
    `n` worlds of `env` (Town03 with traffic: dense for the evaluation,
    stage s2's walkers for training) after `steps` steps of random driving,
    their actor rows the nearest NPCs; exact on RENDER_EXACT of the values
    and within 2 u8 on > 99 %, then timed as in kernel_phase beside its
    bound."""
    from carla_driving_rl_agent_torch.ops import render as R
    actors = env.n_actors
    env.seed(11)
    states, _ = env.reset_batch(n)
    gen = torch.Generator(device=env.device).manual_seed(12)
    lo = torch.tensor([0.0, -0.3], device=env.device)
    span = torch.tensor([1.0, 0.6], device=env.device)
    for _ in range(steps):
        states, *_ = env.step(states, lo + span * torch.rand((n, 2), generator=gen,
                                                             device=env.device))
    w = states.world
    g = R.pack_geometry_banked(env.town, w, env.weather_params[w.weather_id],
                               n_actors=actors).contiguous()
    out_k = R.render_planes(g, n_actors=actors)
    out_p = R.render_planes_plain(g, n_actors=actors)
    diff = (out_k.to(torch.int32) - out_p.to(torch.int32)).abs()
    within, exact = float((diff <= 2).float().mean()), float((diff == 0).float().mean())
    ok = g[:, R._O_ACT + 2:R._O_ACT + 8 * actors:8]
    print(f"  render {n} worlds, {label} after {steps} steps, {actors} "
          f"actor rows ({float(ok.sum()) / n:.2f} active per world): exact {exact:.7f}, "
          f"|diff|<=2 {within:.7f}, max |diff| {int(diff.max())}", flush=True)
    check(within > 0.99, f"render kernel vs plain on {label} packs: {within:.6f} within 2")
    check(exact >= RENDER_EXACT, f"render kernel vs plain on {label} packs: {exact:.7f} exact")
    call = lambda: R.render_planes(g, n_actors=actors)  # noqa: E731
    ms = cuda_ms(call, iters=200, warmup=10)
    device_ms = graph_ms(call)
    plain_ms = cuda_ms(lambda: R.render_planes_plain(g, n_actors=actors), iters=20)
    bound, by = render_bound_ms(g, n_actors=actors)
    kinds = pixel_kinds(g, actors)
    print(f"  render {n} worlds, {label}: kernel {ms:.6f} ms per call, device {device_ms:.6f} "
          f"ms per launch; plain {plain_ms:.6f} ms; bound {bound:.6f} ms ({by}), "
          f"{bound / device_ms:.3f} of the device time ({kinds['actor'] / (n * R.N_PIX):.4f} "
          f"of pixels show an actor, {kinds['live']} live billboards)", flush=True)
    return dict(worlds=n, n_actors=actors, exact_share=exact, within2_share=within,
                max_abs_err=int(diff.max()), active_per_world=float(ok.sum()) / n, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                bound_share=bound / device_ms, pixel_kinds=kinds)


NPC_EXACT = ("veh_wp", "veh_active", "ped_active", "ped_cross")


def _hold_npcs(gpu_npc, cpu_npc, where: str) -> float:
    """NPC indices and masks of the card's state equal the CPU's, floats
    within 1e-3; returns the floats' largest difference."""
    worst = 0.0
    for f, x, y in zip(gpu_npc._fields, gpu_npc, cpu_npc):
        if f in NPC_EXACT:
            check(torch.equal(x.cpu(), y), f"NPC {f} GPU vs CPU at {where}")
        else:
            err = float((x.cpu() - y).abs().max())
            worst = max(worst, err)
            check(err <= 1e-3, f"NPC {f} GPU vs CPU at {where}: max |diff| {err}")
    return worst


def agree_block_traffic(gpu, blocks: int = 3, n: int = 8,
                        what: str = "stage s3's traffic") -> dict:
    """GPU vs CPU on the block path with traffic (stage s3's env: Town03,
    50 vehicles, 50 walkers, the training weathers; or stage s4's over
    random towns): `blocks` calls of env.step_physics_block and
    push_block_frame_batch on the card and on a CPU twin from the same
    reset, NPC-tick and auto-reset draws (drawn on the card, a block's at
    once: the NPC ticks' uniforms, which each side scales per tick by the
    towns its worlds hold then) and actions; the worlds start 4-7 ticks
    before their episode's end, so that they restart mid-block and spawn
    new NPCs.  agree_traffic's bars: NPC indices and masks, flags and ints
    equal, NPC floats within 1e-3, rewards within 1e-4 + 1e-5 relative,
    frames within 2 u8 on > 99 %.  Returns the restarts, the worlds that
    changed town, the worst NPC float difference and image share."""
    from carla_driving_rl_agent_torch.envs import traffic, world as world_mod
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv
    cpu_env = CARLAEnv(gpu.config, device="cpu")
    to_cpu = lambda d: world_mod.map_tensors(lambda t: t.cpu(), d)  # noqa: E731
    rng = np.random.default_rng(2)
    gpu.seed(4)
    dg = gpu.reset_draws(n)
    sg, _ = gpu.reset(dg)
    sc, _ = cpu_env.reset(to_cpu(dg))
    end = gpu.params.max_timesteps - 7 + torch.arange(n) % 4
    sg = sg._replace(world=sg.world._replace(timestep=end.to(gpu.device)))
    sc = sc._replace(world=sc.world._replace(timestep=end))
    p, k, T = gpu.params, gpu.config.past_obs_freq, gpu.config.time_horizon
    worst_img, worst_npc, resets, switched, slot = 1.0, 0.0, 0, 0, T - 1
    for b in range(blocks):
        a = torch.as_tensor(rng.uniform(-1.0, 1.0, (k, n, 2)).astype(np.float32))
        nd = traffic.block_npc_step_uniforms(gpu.generator, k, n, p.v_max, p.p_max, gpu.device)
        rd = world_mod.block_reset_draws(gpu.generator, k, n, p, gpu.routes, gpu.weather_table,
                                         gpu.town)
        towns = sc.world.town_id.clone()
        out_g = gpu.step_physics_block(sg, a.to(gpu.device), draws=rd, npc_draws=nd)
        out_c = cpu_env.step_physics_block(sc, a, draws=to_cpu(rd), npc_draws=nd.cpu())
        for name, x, y in (("terminated", out_g[2], out_c[2]), ("truncated", out_g[3], out_c[3]),
                           ("was_reset", out_g[5], out_c[5])):
            check(torch.equal(x.cpu(), y), f"block {b}: {name} GPU vs CPU with {what}")
        check(torch.allclose(out_g[1].cpu(), out_c[1], rtol=1e-5, atol=1e-4),
              f"block {b}: rewards GPU vs CPU with {what}: "
              f"{(out_g[1].cpu() - out_c[1]).abs().max()}")
        for f in ("route_id", "wp_idx", "timestep", "episode", "weather_id", "town_id",
                  "should_terminate"):
            check(torch.equal(getattr(out_g[0].world, f).cpu(), getattr(out_c[0].world, f)),
                  f"block {b}: world {f} GPU vs CPU with {what}")
        worst_npc = max(worst_npc, _hold_npcs(out_g[0].world.npc, out_c[0].world.npc,
                                              f"block {b}"))
        resets += int(out_c[5].sum())
        switched += int((out_c[0].world.town_id != towns).sum())
        sg = gpu.push_block_frame_batch(out_g[0], out_g[5].any(0), frame_ids=b, slot=slot)
        sc = cpu_env.push_block_frame_batch(out_c[0], out_c[5].any(0), frame_ids=b, slot=slot)
        slot = (slot + 1) % T
        diff = (sg.image_stack.cpu().to(torch.int32) - sc.image_stack.to(torch.int32)).abs()
        worst_img = min(worst_img, float((diff <= 2).float().mean()))
    check(worst_img > 0.99, f"block image stacks GPU vs CPU with {what}: {worst_img:.6f} "
                            f"within 2")
    check(resets > 0, "no world restarted in the block path's agreement run")
    npc = sg.world.npc
    print(f"  block path, {what}, {blocks} blocks of {k} ticks x {n} worlds "
          f"({resets} restarts, {switched} into another town; "
          f"{float(npc.veh_active.sum()) / n:.1f} vehicles, "
          f"{float(npc.ped_active.sum()) / n:.1f} walkers per world): NPC floats max |diff| "
          f"{worst_npc:.3e}, images within 2 u8 {worst_img:.6f}", flush=True)
    return dict(restarts=resets, switched=switched, npc_max_abs_diff=worst_npc,
                image_within_2=worst_img)


def agree_traffic(gpu, steps: int = 6, n: int = 8) -> None:
    """GPU vs CPU with NPC traffic: the env `gpu` (Town03, dense) and its
    CPU twin stepped from the same reset, NPC-tick and auto-reset draws and
    actions; NPC indices and masks, the collision flags and the terminated
    flags equal, NPC floats within 1e-3 (float32 trig of the two devices
    differs in the last bits), rewards as in agree_phase, frames within 2
    u8 on > 99 %."""
    from carla_driving_rl_agent_torch.envs import world as world_mod
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv
    cpu_env = CARLAEnv(gpu.config, device="cpu")
    to_cpu = lambda d: world_mod.map_tensors(lambda t: t.cpu(), d)  # noqa: E731
    rng = np.random.default_rng(1)
    gpu.seed(3)
    dg = gpu.reset_draws(n)
    sg, _ = gpu.reset(dg)
    sc, _ = cpu_env.reset(to_cpu(dg))
    worst_img, worst_npc = 1.0, 0.0
    for i in range(steps + 1):
        worst_npc = max(worst_npc, _hold_npcs(sg.world.npc, sc.world.npc, f"step {i}"))
        if i == steps:
            break
        a = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32))
        nd, dg = gpu.npc_step_draws(sg.world), gpu.reset_draws(n)
        sg, _, rg, tg, _, ig = gpu.step(sg, a.to(gpu.device), draws=dg, npc_draws=nd)
        sc, _, rc, tc, _, ic = cpu_env.step(sc, a, draws=to_cpu(dg), npc_draws=to_cpu(nd))
        check(torch.equal(tg.cpu(), tc), "terminated flags GPU vs CPU with traffic")
        for k in ("hit_vehicle", "hit_pedestrian", "hit_other"):
            check(torch.equal(ig[k].cpu(), ic[k]), f"{k} GPU vs CPU")
        check(torch.allclose(rg.cpu(), rc, rtol=1e-5, atol=1e-4),
              f"rewards GPU vs CPU with traffic: {(rg.cpu() - rc).abs().max()}")
        diff = (sg.image_stack.cpu().to(torch.int32) - sc.image_stack.to(torch.int32)).abs()
        worst_img = min(worst_img, float((diff <= 2).float().mean()))
    check(worst_img > 0.99, f"image stacks GPU vs CPU with traffic: {worst_img:.6f} within 2")
    npc = sg.world.npc
    print(f"  dense traffic {steps} steps x {n} worlds ({float(npc.veh_active.sum()) / n:.1f} "
          f"vehicles, {float(npc.ped_active.sum()) / n:.1f} walkers per world): NPC floats "
          f"max |diff| {worst_npc:.3e}, images within 2 u8 {worst_img:.6f}", flush=True)


def agree_phase(agent, steps: int = 6, n: int = 8) -> None:
    """GPU vs CPU on a small input: the same reset draws, actions and
    auto-reset draws through both envs, then the network on both."""
    from carla_driving_rl_agent_torch.envs import world as world_mod
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv

    gpu = agent.env
    cpu = CARLAEnv(gpu.config, device="cpu")
    rng = np.random.default_rng(0)

    def draws():
        d = world_mod.reset_draws(gpu.generator, n, gpu.params, gpu.routes)
        return d, world_mod.map_tensors(lambda t: t.cpu(), d)

    dg, dc = draws()
    sg, og = gpu.reset(dg)
    sc, oc = cpu.reset(dc)
    worst_img = 1.0
    for _ in range(steps):
        a = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32))
        dg, dc = draws()
        sg, og, rg, tg, _, _ = gpu.step(sg, a.cuda(), draws=dg)
        sc, oc, rc, tc, _, _ = cpu.step(sc, a, draws=dc)
        check(torch.equal(tg.cpu(), tc), "terminated flags GPU vs CPU")
        check(torch.allclose(rg.cpu(), rc, rtol=1e-5, atol=1e-4),
              f"rewards GPU vs CPU: {(rg.cpu() - rc).abs().max()}")
        diff = (sg.image_stack.cpu().to(torch.int32) - sc.image_stack.to(torch.int32)).abs()
        worst_img = min(worst_img, float((diff <= 2).float().mean()))
    check(worst_img > 0.99, f"image stacks GPU vs CPU: {worst_img:.6f} within 2")

    net_cpu = copy.deepcopy(agent.network).cpu()
    obs_c = {f"state_{k}": v[:2] for k, v in oc.items()}
    obs_g = {k: v.cuda() for k, v in obs_c.items()}
    with torch.no_grad():
        outs = []
        for net, obs in ((agent.network, obs_g), (net_cpu, obs_c)):
            feat = net.dynamics(obs)
            pol, val = net.old_policy(feat), net.value(feat)
            outs.append(torch.cat([pol["dist"].mean(), pol["dist"].stddev(),
                                   val["value"]], dim=-1).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    print(f"  env {steps} steps x {n} worlds: images within 2 u8 {worst_img:.6f}; "
          f"network GPU vs CPU max |diff| {err:.3e}", flush=True)
    check(err < 1e-3, f"network GPU vs CPU max |diff| {err}")


# the evaluation metrics held within 4 standard errors of the record
HELD_METRICS = ("similarity", "speed", "timesteps")


def slice_phase(agent, out_dir: str, unfused: dict = None, traffic: str = "no") -> dict:
    """The shipped evaluation of safe-s5 on Town03 with `agent`, whose env
    has the `traffic` level (its fused_units decides the backbone's path),
    beside the recorded evaluation of that scenario; with `unfused`, the
    means of an unfused run are printed beside.  With traffic, also the
    kept trials' collisions by type and the NPCs their worlds started
    with."""
    from carla_driving_rl_agent_torch.evaluate_seeds import z_score
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    num_worlds = max(TRIALS + 8, int(TRIALS * 1.25))
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    check(agent.env.params.has_npcs == (traffic != "no"), f"the env's traffic is not {traffic}")
    record = agent.evaluate(name=scenario(traffic), timesteps=STEPS, trials=TRIALS,
                            initial_seed=SEED, evaluation_dir=out_dir)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    launches = counts["render_planes"]
    frames = STEPS + 1          # the reset frame, then one per step
    print(f"  render launches {launches}, frames rendered {frames} "
          f"(x {num_worlds} worlds); {num_worlds * STEPS / seconds:.1f} env-steps/s "
          f"({num_worlds} worlds x {STEPS} steps in {seconds:.3f} s)", flush=True)
    check(launches == frames, f"render launches {launches} != frames {frames}")
    units = counts["shuffle_unit_infer"]
    if agent.config.fused_units:
        print(f"  unit inference kernel launches {units}: {units / STEPS:.1f} per predict "
              f"({STEPS} predicts)", flush=True)
        check(units == UNITS_PER_PASS * STEPS,
              f"unit inference launches {units} != {UNITS_PER_PASS} x {STEPS} predicts")
    else:
        check(units == 0, f"unfused evaluation launched the unit kernel {units} times")
    with open(reference(traffic)) as f:
        ref = json.load(f)
    for m in METRICS:
        v = np.asarray(record[m], np.float64)
        check(len(v) == TRIALS and bool(np.all(np.isfinite(v))), f"{m}: {len(v)} finite values")
        z = z_score(record, ref, m)
        beside = (f"   unfused {unfused['means'][m]:.6f}" if unfused else "")
        print(f"  {m:18s} port {record[f'{m}_mean']:.6f} +- {record[f'{m}_std']:.6f}   "
              f"recorded {ref[f'{m}_mean']:.6f} +- {ref[f'{m}_std']:.6f}   "
              f"(port - recorded) / SE {z:+.3f}{beside}", flush=True)
        if m in HELD_METRICS:
            check(abs(z) <= 4.0, f"{m} lies {z:+.3f} standard errors from the record")
    npcs = {}
    if traffic != "no":
        kept = agent.last_trials
        npcs = dict(collisions={k: int(kept[f"hit_{k}"].sum())
                                for k in ("vehicle", "pedestrian", "other")},
                    vehicles_per_world=float(kept["vehicles"].mean()),
                    walkers_per_world=float(kept["walkers"].mean()))
        print(f"  {traffic} traffic: collisions of the {TRIALS} kept trials by type: "
              + ", ".join(f"{k} {v}" for k, v in npcs["collisions"].items())
              + f" (collision_rate x trials {sum(record['collision_rate']):.0f}); active NPCs "
              f"per world at the start: {npcs['vehicles_per_world']:.2f} vehicles, "
              f"{npcs['walkers_per_world']:.2f} walkers", flush=True)
    return dict(seconds=seconds, env_steps_per_s=num_worlds * STEPS / seconds, launches=counts,
                num_worlds=num_worlds, traffic=traffic, npcs=npcs,
                means={m: record[f"{m}_mean"] for m in METRICS},
                stds={m: record[f"{m}_std"] for m in METRICS},
                recorded_means={m: ref[f"{m}_mean"] for m in METRICS},
                recorded_stds={m: ref[f"{m}_std"] for m in METRICS})


def npc_costs(env, world) -> dict:
    """What the NPC tick (traffic.step_npcs) and the NPC spawn of every
    step's fresh-reset state (traffic.init_npcs) cost per step at `world`:
    the host's ms to enqueue one call (20 in flight), the device's ms per
    call (a CUDA graph of repeated calls) and the kernel launches per call
    (a CUDA graph of one call)."""
    from carla_driving_rl_agent_torch.envs import traffic
    p = env.params
    tick_draws, reset = env.npc_step_draws(world), env.reset_draws(world.x.shape[0])
    ego = torch.stack([world.x, world.y], dim=-1)
    fns = dict(
        tick=lambda: traffic.step_npcs(tick_draws, world.npc, env.town, world.town_id,
                                       world.sim_time, ego, world.v),
        spawn=lambda: traffic.init_npcs(reset.npc, env.town, reset.town_id, ego,
                                        p.num_vehicles, p.num_pedestrians,
                                        crossing=p.ped_crossing, running=p.ped_running))
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        out[name] = dict(host_ms=host_ms, device_ms=graph_ms(fn), launches=graph_launches(fn))
    return out


def profile_phase(agent, steps: int = 16) -> dict:
    """Where the evaluation's time goes: the per-step wall time of the
    network's predict and of the env step (each synchronised), the
    rollout's wall time, and under torch.profiler its device busy time and
    kernels by device time; with NPCs, also what their tick and spawn
    cost per step (npc_costs)."""
    from torch.profiler import ProfilerActivity, profile
    from carla_driving_rl_agent_torch.envs.carla_env import convert_action
    env, net = agent.env, agent.network
    num_worlds = max(TRIALS + 8, int(TRIALS * 1.25))
    states, obs = env.reset_batch(num_worlds)
    t_pred = t_env = 0.0
    with torch.no_grad():
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred = net.predict({f"state_{k}": v for k, v in obs.items()}, env.generator)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            states, obs, *_ = env.step(states, convert_action(pred["action"]))
            torch.cuda.synchronize()
            t_pred, t_env = t_pred + t1 - t0, t_env + time.perf_counter() - t1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.rollout(num_worlds, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for window in range(PROFILE_WINDOWS):   # a window whose records are lost is taken again
        _zero_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            agent.rollout(num_worlds, steps)
            torch.cuda.synchronize()
        counts = _counts()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        render = [e for e in kern if "render_kernel" in e.key]
        if len(render) == 1 and render[0].count == steps + 1:
            break
        print(f"  profiler window {window + 1} of {PROFILE_WINDOWS}: "
              f"{sum(e.count for e in render)} render kernel records of {steps + 1} frames "
              f"({counts.get('render_planes')} launches counted by the wrapper)", flush=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    check(len(render) == 1 and render[0].count == steps + 1,
          "the profiled rollout launched the render kernel once per frame")
    out = dict(steps=steps, num_worlds=num_worlds,
               predict_ms_per_step=1e3 * t_pred / steps,
               env_step_ms_per_step=1e3 * t_env / steps,
               rollout_ms_per_step=1e3 * wall / steps,
               device_busy_ms_per_step=1e3 * busy / steps,
               device_idle_share=1.0 - busy / wall,
               kernel_launches_per_step=sum(e.count for e in kern) / steps,
               render_kernel_device_ms=render[0].self_device_time_total / 1e3 / render[0].count,
               unit_device_ms=_unit_device_ms(kern, counts),
               top_kernels=[dict(name=e.key[:90], count=e.count,
                                 ms_per_step=e.self_device_time_total / 1e3 / steps)
                            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]])
    print(f"  [{'fused_units' if agent.config.fused_units else 'unfused'}"
          f"{', traffic' if env.params.has_npcs else ''}] per step: predict "
          f"{out['predict_ms_per_step']:.3f} ms, env step "
          f"{out['env_step_ms_per_step']:.3f} ms (each synchronised); rollout "
          f"{out['rollout_ms_per_step']:.3f} ms, device busy "
          f"{out['device_busy_ms_per_step']:.3f} ms, idle share "
          f"{out['device_idle_share']:.4f}, {out['kernel_launches_per_step']:.1f} "
          f"kernel launches; render kernel {out['render_kernel_device_ms']:.6f} ms "
          f"device time per launch; unit kernels' device ms per call: " + (", ".join(
              f"{k} {v:.6f}" for k, v in out["unit_device_ms"].items()) or "none"), flush=True)
    for k in out["top_kernels"]:
        print(f"    {k['ms_per_step']:9.4f} ms/step {k['count']:6d}x  {k['name']}", flush=True)
    if env.params.has_npcs:
        out["npc"] = npc_costs(env, states.world)
        print("  NPCs per step: " + "; ".join(
            f"{k} host {v['host_ms']:.4f} ms, device {v['device_ms']:.4f} ms, "
            f"{v['launches']} launches" for k, v in out["npc"].items()), flush=True)
    return out


def physics_bound_ms(n_worlds: int, n_done: int, k_segs: int, ticks: int = 1,
                     tick_rows: tuple = (7, 4)) -> tuple:
    """Least time for one physics call of `ticks` ticks: the bytes it must
    move (the state read once and written once; per tick the action and
    reset draws, the gathered route window of 10 rows, route length,
    destination and road half-width, the cell's segments, and the tick's
    `tick_rows` (float, flag) rows written; the start row of each world
    that resets) over the memory rate, or its float operations over the
    FP32 peak.  `n_done` counts the resets over all the ticks."""
    per_tick = (2 * 4 + 3 * 8 + 4                          # action, draws
                + 8 + 10 * 16 + 8 + 4 + k_segs * 16        # gathered banks
                + 4 * tick_rows[0] + tick_rows[1])         # the tick's rows
    state = 6 * 4 + 6 * 8 + 11 * 4 + 6 * 8 + 1            # read, then written
    nbytes = n_worlds * (state + ticks * per_tick) + n_done * 16
    bytes_s = nbytes / PEAK_BYTES_PER_S
    ops_s = ticks * n_worlds * physics_ops_per_world(k_segs) / PEAK_FP32_FLOPS
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes")


def _close(x: torch.Tensor, y: torch.Tensor) -> float:
    """Max |x - y| if every entry is within 1e-5 + 2.5e-7 |y| (floats) or
    equal (ints, bools); raises otherwise."""
    if x.dtype.is_floating_point:
        err = (x - y).abs()
        check(bool((err <= 1e-5 + 2.5e-7 * y.abs()).all()),
              f"physics kernel vs plain: max |diff| {float(err.max())}")
        return float(err.max())
    check(torch.equal(x, y), "physics kernel vs plain: ints or flags differ")
    return 0.0


def _device_ms(fn, name: str) -> float:
    """Device ms per launch of the kernel `name` in calls of `fn`."""
    times = [ms for k, ms in profile_calls(fn, want=name).items() if name in k]
    check(len(times) == 1, f"the profiler saw {len(times)} kernels named {name}")
    return times[0]


PHYSICS_BLOCK = 4           # ticks per block call: the rollout's past_obs_freq


def _time_physics(fn, plain, n: int, k_segs: int, ticks: int, tick_rows: tuple) -> dict:
    """A physics call `fn` of `ticks` ticks at n worlds and its plain
    version: ms per call of each, the bound, the kernel's device time per
    launch and its launches per call."""
    n_done = int(fn()[5].sum())
    ms = cuda_ms(fn, iters=200, warmup=10)
    plain_ms = cuda_ms(plain, iters=20)
    bound, by = physics_bound_ms(n, n_done, k_segs, ticks, tick_rows)
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               device_ms=_device_ms(fn, "physics_kernel"), launches_per_call=graph_launches(fn))
    print(f"  physics at {n} worlds, {ticks} tick(s) per call: kernel {ms:.6f} ms per call, "
          f"device {out['device_ms']:.6f} ms per launch, {out['launches_per_call']} device "
          f"launch per call; plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by}); library "
          f"call: none computes this function", flush=True)
    return out


def physics_phase(env, kernels: dict) -> dict:
    """The kernel against the plain version on Town03 states, both fed the
    same state and reset draws; 24-step episodes so that worlds reset.  The
    single-tick entry for 40 steps (ints and flags exact, floats within the
    world bar); the block entry for 10 blocks of 4 ticks, bit for bit.  Then
    each timed, its device time per launch read, and the cost per tick of
    the rollout's path old and new: the tick's draws and one single-tick
    call, against the block's draws and one block call over 4."""
    from carla_driving_rl_agent_torch.envs import world as W
    from carla_driving_rl_agent_torch.ops import physics as P
    params = dataclasses.replace(env.params, max_timesteps=24)
    consts = P.PhysicsConsts(params, env.town, env.routes)
    table = torch.tensor(params.weather_ids, dtype=torch.int64, device="cuda")
    k_segs = env.town.cell_segs.shape[3] // 4
    K = PHYSICS_BLOCK
    lo = torch.tensor([0.1, -0.6], device="cuda")
    hi = torch.tensor([0.9, 0.6], device="cuda")
    worst, single, block, per_tick = 0.0, {}, {}, {}
    for n in (TRAIN_WORLDS, ENV_WORLDS):
        g = torch.Generator(device="cuda").manual_seed(n)
        world = W.reset_world(W.reset_draws(g, n, params, env.routes), env.routes)
        start, resets = world, 0
        for _ in range(40):
            a = lo + (hi - lo) * torch.rand((n, 2), generator=g, device="cuda")
            d = W.reset_draws(g, n, params, env.routes)
            out = P.step_physics_batch(world, a, params, env.town, env.routes, d)
            ref = P.step_physics_batch_plain(world, a, params, env.town, env.routes, d)
            for x, y in zip(W.tensors(out[0]), W.tensors(ref[0])):
                worst = max(worst, _close(x, y))
            for x, y in zip(out[1:4] + out[5:], ref[1:4] + ref[5:]):
                worst = max(worst, _close(x, y))
            for key in ref[4]:
                worst = max(worst, _close(out[4][key], ref[4][key]))
            resets += int(out[5].sum())
            world = out[0]
        check(resets > 0, f"no world reset in 40 steps at {n} worlds")
        world, block_resets = start, 0
        for _ in range(10):
            a4 = lo + (hi - lo) * torch.rand((K, n, 2), generator=g, device="cuda")
            d4 = W.block_reset_draws(g, K, n, params, env.routes, table)
            out = P.step_physics_block(world, a4, params, env.town, env.routes, d4, consts)
            ref = P.step_physics_block_plain(world, a4, params, env.town, env.routes, d4)
            got = tuple(W.tensors(out[0])) + out[1:4] + out[5:] + tuple(out[4].values())
            want = tuple(W.tensors(ref[0])) + ref[1:4] + ref[5:] + tuple(ref[4].values())
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"physics block kernel vs {K} plain ticks at {n} worlds: not the same bits")
            block_resets += int(out[5].sum())
            world = out[0]
        check(block_resets > 0, f"no world reset in 10 blocks at {n} worlds")
        # timing: one tick's inputs, one block's
        a = lo + (hi - lo) * torch.rand((n, 2), generator=g, device="cuda")
        d = W.reset_draws(g, n, params, env.routes)
        a4 = lo + (hi - lo) * torch.rand((K, n, 2), generator=g, device="cuda")
        d4 = W.block_reset_draws(g, K, n, params, env.routes, table)
        single[n] = _time_physics(
            lambda: P.step_physics_batch(world, a, params, env.town, env.routes, d),
            lambda: P.step_physics_batch_plain(world, a, params, env.town, env.routes, d),
            n, k_segs, 1, (len(P.TICK_F), len(P.TICK_B)))
        block[n] = _time_physics(
            lambda: P.step_physics_block(world, a4, params, env.town, env.routes, d4, consts),
            lambda: P.step_physics_block_plain(world, a4, params, env.town, env.routes, d4),
            n, k_segs, K, (P.BLOCK_TICK_F, P.BLOCK_TICK_B))
        # what the rollout's path pays per tick: old, the tick's draws and a
        # single-tick call (the banks packed on every call); new, the
        # block's draws in one generator call and one block call, over K
        old = cuda_ms(lambda: P.step_physics_batch(
            world, a, params, env.town, env.routes, W.reset_draws(g, n, params, env.routes)),
            iters=400, warmup=10)
        new = cuda_ms(lambda: P.step_physics_block(
            world, a4, params, env.town, env.routes,
            W.block_reset_draws(g, K, n, params, env.routes, table), consts),
            iters=200, warmup=10) / K
        per_tick[n] = dict(old_ms=old, new_ms=new, ratio=old / new)
        print(f"  physics at {n} worlds: 40 single ticks with {resets} resets agree (ints and "
              f"flags exact, floats within 1e-5 + 2.5e-7 rel); 10 blocks of {K} ticks with "
              f"{block_resets} resets equal {K} plain ticks bit for bit; cost per tick on the "
              f"rollout's path: old {old:.6f} ms (draws + single-tick call), new {new:.6f} ms "
              f"(block draws + block call, / {K}): {old / new:.2f}x lower", flush=True)
    t = block[TRAIN_WORLDS]
    kernels["step_physics_block"] = dict(
        name="step_physics_block", route="cuda",
        source="carla_driving_rl_agent_torch/csrc/physics.cu",
        replaces="carla_driving_rl_agent_tpu/ops/physics_pallas.py:67",
        launches=None, max_abs_err=0.0, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        by_worlds=block, launches_per_call=t["launches_per_call"])
    return dict(single=single, block=block, per_tick=per_tick, single_max_abs_err=worst)


# The g=1.0 backbone's stride-1 maps on 90x360 frames: (H, W, C, units).
UNIT_MAPS = ((11, 45, 116, 3), (6, 23, 232, 7), (3, 12, 464, 3))
UNITS_PER_PASS = sum(m[3] for m in UNIT_MAPS)
# frames per backbone pass on the paths: a minibatch, an evaluation predict,
# a rollout predict (4 frames per sample)
UNIT_N = dict(train=4 * TRAIN_BATCH, evaluate=4 * max(TRIALS + 8, int(TRIALS * 1.25)),
              rollout=4 * TRAIN_WORLDS)
# the conv biases and BatchNorm_1's bias: followed by a training-mode
# BatchNorm, their true gradient is 0 and what both sides compute is noise
UNIT_NOISE = ("b1", "dwb", "be2", "b3")
# phase unit's bars: relative L2 of outputs and batch statistics, relative
# L2 per gradient tensor, the noise tensors' max |diff| over the unit's
# largest gradient, and every reading of the float64 cases
UNIT_BARS = dict(out=1e-5, grad=1e-4, noise=5e-5, float64=1e-10)
# the most device launches one call of each unit kernel may make, and the
# kernels of the first port's design that no path may launch any more (the
# finalising reductions, the inference tail)
UNIT_MAX_LAUNCHES = dict(infer=3, fwd=4, bwd=5)
UNIT_GONE = ("k_sum_final", "k_stats_final", "k_tail_infer")


def _unit_stages(kind: str, fn, shape: str) -> dict:
    """Launches per call of one unit kernel (graph_launches), the device ms
    per launch of each of its stages (the profiler) and the host's ms per
    call; checks the launch targets and that no finalising launch of the
    first port is left."""
    per_call = graph_launches(fn)
    stages = {_short(k): ms for k, ms in profile_calls(fn).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):     # the host's time to enqueue a call (20 in flight)
        fn()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    gone = [k for k in stages if any(g in k for g in UNIT_GONE)]
    check(not gone, f"unit {kind} at {shape} still launches {gone}")
    if kind in UNIT_MAX_LAUNCHES:
        check(per_call <= UNIT_MAX_LAUNCHES[kind],
              f"unit {kind} at {shape}: {per_call} launches per call > "
              f"{UNIT_MAX_LAUNCHES[kind]}")
    print(f"  unit {kind} at {shape}: {per_call} device launches per call, host "
          f"{host_ms:.6f} ms per call; device ms per launch by stage: "
          + ", ".join(f"{k} {ms:.6f}" for k, ms in stages.items()), flush=True)
    return dict(launches_per_call=per_call, stage_device_ms=stages, host_ms=host_ms)


def unit_bound_ms(kind: str, n: int, h: int, w: int, c: int, itemsize: int = 4) -> tuple:
    """Least time for one unit-kernel call: the bytes its function must move
    (each input read once, each output written once) over the memory rate,
    or its float operations over the FP32 peak (the tensor cores are off for
    parity with the plain version), whichever is larger.  The function is
    the JAX kernel's: the forward takes x and writes out and the batch
    statistics, the backward takes x and the output gradient and writes the
    gradients.  The tensors the port's forward saves for its backward (z1,
    z2, u) are the kernels' own cost, not the function's.  Operations per
    pixel: the two 1x1 products 2 * 2 hc^2 and the depthwise 2 * 9 hc
    (inference and forward); the backward's four products (W3^T g_u, dW3,
    W1^T g_z1, dW1) 8 hc^2 and its two depthwise passes 36 hc."""
    hc = c // 2
    p = n * h * w
    act = p * c * itemsize
    params = (2 * hc * hc + 19 * hc) * itemsize
    stats = 6 * hc * itemsize
    if kind == "infer":       # x, the parameters and running statistics in; out
        nbytes, ops = 2 * act + params + stats, p * (4 * hc * hc + 18 * hc)
    elif kind == "fwd":       # x and the parameters in; out and the batch statistics
        nbytes, ops = 2 * act + params + stats, p * (4 * hc * hc + 18 * hc)
    else:                     # x, gout and the parameters in; gx and their gradients
        nbytes, ops = 3 * act + 2 * params, p * (8 * hc * hc + 36 * hc)
    bytes_s, ops_s = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes")


def _random_unit(c: int, dtype: torch.dtype, seed: int):
    """A stride-1 unit on the card: flax's initialisers, then random
    BatchNorm scales, biases and running statistics and random conv biases."""
    from carla_driving_rl_agent_torch.models.layers import init_flax_
    from carla_driving_rl_agent_torch.models.shufflenet import ShuffleUnit
    g = torch.Generator().manual_seed(seed)
    unit = ShuffleUnit(c, c, 1, fused=True)
    init_flax_(unit, g)
    with torch.no_grad():
        for i in range(3):
            bn = getattr(unit, f"BatchNorm_{i}")
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(0.0, 0.2, generator=g)
            bn.running_mean.normal_(0.0, 0.3, generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)
            getattr(unit, f"Conv_{i}").bias.normal_(0.0, 0.1, generator=g)
    return unit.to("cuda", dtype)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||"""
    return float((a.double() - b.double()).norm() / b.double().norm())


def _unit_inputs(n: int, h: int, w: int, c: int, dtype: torch.dtype, seed: int):
    """x as a unit sees it (activations in [0, 6)) and an output gradient."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 3.0 * torch.rand((n, c, h, w), generator=g, device="cuda", dtype=dtype)
    gout = torch.randn((n, c, h, w), generator=g, device="cuda", dtype=dtype)
    return x, gout


def _hold_unit_grads(got, ref, what: str, grad_bar: float, noise_bar: float) -> tuple:
    """Per-tensor relative L2 (the noise tensors: max |diff| over the
    largest gradient); returns (worst relative, worst noise, max |diff|)."""
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    names = ("x",) + SU.UnitOperands._fields
    top = max(float(r.abs().max()) for r in ref)
    worst = noise = diff = 0.0
    for name, a, b in zip(names, got, ref):
        d = float((a.double() - b.double()).abs().max())
        diff = max(diff, d)
        if name in UNIT_NOISE:
            noise = max(noise, d / top)
            check(d / top <= noise_bar, f"{what} {name}: max |diff| {d:.3e} over the "
                                        f"largest gradient {top:.3e} > {noise_bar:.0e}")
        else:
            r = _rel(a, b)
            worst = max(worst, r)
            check(r <= grad_bar, f"{what} {name}: relative L2 {r:.3e} > {grad_bar:.0e}")
    return worst, noise, diff


def _plain_grads(x: torch.Tensor, unit, gout: torch.Tensor) -> tuple:
    """The gradients of x and of the unit's 12 operands through autograd of
    the plain training forward."""
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    xr = x.detach().requires_grad_(True)
    leaves = [t.detach().requires_grad_(True) for t in SU.unit_operands(unit)]
    out = SU._plain(xr, SU.UnitOperands(*leaves), unit.leak)[0]
    return torch.autograd.grad(out, [xr] + leaves, gout)


def _unit_two_streams(SU, unit, h: int, w: int, c: int, n: int) -> None:
    """Forward and backward calls on two streams at once, three times, give
    the bits each input gives on one stream: no call sees another's
    reduction state (every call has its own ticket counters)."""
    ops = SU.unit_operands(unit)
    inputs = [_unit_inputs(n, h, w, c, torch.float32, seed=s) for s in (101, 102)]

    def call(x, gout):
        out, stats, saved = SU._train_fwd_kernel(x, ops, unit.leak)
        return (out, stats) + tuple(SU.shuffle_unit_train_bwd(x, gout, ops, unit.leak, stats,
                                                                saved))

    alone = [call(*xi) for xi in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    for r in range(3):
        torch.cuda.synchronize()
        together = []
        for stream, xi in zip(streams, inputs):
            with torch.cuda.stream(stream):
                together.append(call(*xi))
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(alone, together)):
            check(all(torch.equal(s, t) for s, t in zip(a, b)),
                  f"unit at ({n}, {h}x{w}x{c}): input {k} on two streams, round {r}, "
                  f"differs from one stream")
    print(f"  unit forward and backward on two streams at once, ({n}, {c}, {h}, {w}), "
          f"3 rounds: the same bits as on one stream", flush=True)


def unit_phase(kernels: dict) -> dict:
    """The unit kernels against their plain versions at the backbone's
    three stride-1 maps, at the paths' batches, in float32; the backward
    kernel against its plain version on the same saved tensors and batch
    statistics of the forward kernel (so that both take the same steps of
    the activation's gradient, which is a step at 0 and 6).  Then float64
    at each map, end to end through torch.autograd (forward and backward
    kernels) against autograd of the plain forward.  Each size timed."""
    from carla_driving_rl_agent_torch.agents.carla_agent import full_float32
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    full_float32()
    full = dict(infer={}, fwd={}, bwd={})
    err = dict(infer=0.0, fwd=0.0, bwd=0.0)
    for i, (h, w, c, units) in enumerate(UNIT_MAPS):
        unit = _random_unit(c, torch.float32, seed=i)
        ops = SU.unit_operands(unit)
        shape = f"{h}x{w}x{c}"
        with torch.no_grad():
            for path in ("evaluate", "rollout"):
                n = UNIT_N[path]
                x, _ = _unit_inputs(n, h, w, c, torch.float32, seed=10 * i + n)
                unit.eval()
                k, p = SU.shuffle_unit_infer(x, unit), SU.shuffle_unit_infer_plain(x, unit)
                r = _rel(k, p)
                check(r <= UNIT_BARS["out"], f"inference kernel at ({n}, {shape}): {r:.3e}")
                check(torch.equal(SU.shuffle_unit_infer(x, unit), k),
                      f"inference kernel at ({n}, {shape}): two calls differ")
                err["infer"] = max(err["infer"], float((k - p).abs().max()))
                ms = cuda_ms(lambda: SU.shuffle_unit_infer(x, unit), iters=20)
                plain_ms = cuda_ms(lambda: SU.shuffle_unit_infer_plain(x, unit), iters=10)
                bound, by = unit_bound_ms("infer", n, h, w, c)
                full["infer"][f"{n}x{shape}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                                     bound_by=by, rel_l2=r, units=units)
                full["infer"][f"{n}x{shape}"].update(_unit_stages(
                    "infer", lambda: SU.shuffle_unit_infer(x, unit), f"({n}, {shape})"))
                print(f"  unit infer ({n}, {c}, {h}, {w}) [{path}]: relative L2 {r:.3e}, two "
                      f"calls equal bits; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms "
                      f"(kernel / plain {ms / plain_ms:.3f}), bound {bound:.6f} ms ({by}), "
                      f"{ms / bound:.2f}x the bound", flush=True)
            n = UNIT_N["train"]
            x, gout = _unit_inputs(n, h, w, c, torch.float32, seed=10 * i + n)
            out, stats, saved = SU._train_fwd_kernel(x, ops, unit.leak)
            p_out, p_stats = SU.shuffle_unit_train_plain(x, unit)
            r_out, r_stats = _rel(out, p_out), _rel(stats, p_stats)
            check(r_out <= UNIT_BARS["out"] and r_stats <= UNIT_BARS["out"],
                  f"forward kernel at ({n}, {shape}): out {r_out:.3e}, stats {r_stats:.3e}")
            err["fwd"] = max(err["fwd"], float((out - p_out).abs().max()),
                             float((stats - p_stats).abs().max()))
            again = SU._train_fwd_kernel(x, ops, unit.leak)
            check(torch.equal(again[0], out) and torch.equal(again[1], stats)
                  and all(torch.equal(s, t) for s, t in zip(again[2], saved)),
                  f"forward kernel at ({n}, {shape}): two calls differ")
            del again
            ms = cuda_ms(lambda: SU._train_fwd_kernel(x, ops, unit.leak), iters=20)
            plain_ms = cuda_ms(lambda: SU.shuffle_unit_train_plain(x, unit), iters=10)
            bound, by = unit_bound_ms("fwd", n, h, w, c)
            full["fwd"][f"{n}x{shape}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                               bound_by=by, rel_l2=max(r_out, r_stats),
                                               units=units)
            full["fwd"][f"{n}x{shape}"].update(_unit_stages(
                "fwd", lambda: SU._train_fwd_kernel(x, ops, unit.leak), f"({n}, {shape})"))
            print(f"  unit train forward ({n}, {c}, {h}, {w}): relative L2 out {r_out:.3e}, "
                  f"stats {r_stats:.3e}; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
                  f"{bound:.6f} ms ({by})", flush=True)
            bwd = lambda: SU.shuffle_unit_train_bwd(x, gout, ops, unit.leak, stats, saved)
            bwd_plain = lambda: SU.shuffle_unit_train_bwd_plain(x, gout, ops, unit.leak,
                                                                stats, saved)
            first = bwd()
            worst, noise, diff = _hold_unit_grads(first, bwd_plain(), f"backward kernel at "
                                                  f"({n}, {shape})", UNIT_BARS["grad"],
                                                  UNIT_BARS["noise"])
            err["bwd"] = max(err["bwd"], diff)
            check(all(torch.equal(s, t) for s, t in zip(bwd(), first)),
                  f"backward kernel at ({n}, {shape}): two calls differ")
            del first
            ms, plain_ms = cuda_ms(bwd, iters=20), cuda_ms(bwd_plain, iters=10)
            bound, by = unit_bound_ms("bwd", n, h, w, c)
            full["bwd"][f"{n}x{shape}"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                               bound_by=by, rel_l2=worst, noise=noise,
                                               units=units)
            full["bwd"][f"{n}x{shape}"].update(_unit_stages("bwd", bwd, f"({n}, {shape})"))
            print(f"  unit train backward ({n}, {c}, {h}, {w}): gradients' relative L2 <= "
                  f"{worst:.3e}, noise tensors {noise:.3e} of the largest; kernel {ms:.6f} "
                  f"ms, plain {plain_ms:.6f} ms, bound {bound:.6f} ms ({by})", flush=True)
            del x, gout, out, stats, saved
    # float64, end to end at each map: inference, and the autograd.Function
    # (forward and backward kernels) against autograd of the plain forward
    n = UNIT_N["train"]
    bar = UNIT_BARS["float64"]
    f64 = dict(infer=0.0, out=0.0, stats=0.0, grad=0.0, noise=0.0)
    for i, (h, w, c, _) in enumerate(UNIT_MAPS):
        unit = _random_unit(c, torch.float64, seed=7 + i)
        x, gout = _unit_inputs(n, h, w, c, torch.float64, seed=7 + i)
        with torch.no_grad():
            r_inf = _rel(SU.shuffle_unit_infer(x, unit.eval()),
                         SU.shuffle_unit_infer_plain(x, unit))
        ops = SU.unit_operands(unit)
        with torch.no_grad():
            out, stats = SU._UnitTrain.apply(x, unit.leak, *ops)
            p_out, p_stats = SU.shuffle_unit_train_plain(x, unit)
        r_out, r_stats = _rel(out, p_out), _rel(stats, p_stats)
        check(max(r_inf, r_out, r_stats) <= bar, f"float64 unit at ({n}, {h}x{w}x{c}): infer "
                                                 f"{r_inf:.3e}, out {r_out:.3e}, stats "
                                                 f"{r_stats:.3e}")
        xr = x.clone().requires_grad_(True)
        out, _ = SU._UnitTrain.apply(xr, unit.leak, *ops)
        grads = torch.autograd.grad(out, [xr] + list(ops), gout)
        worst, noise, _ = _hold_unit_grads(grads, _plain_grads(x, unit, gout),
                                           f"float64 unit ({n}, {c}, {h}, {w})", bar, bar)
        for k, v in dict(infer=r_inf, out=r_out, stats=r_stats, grad=worst, noise=noise).items():
            f64[k] = max(f64[k], v)
        print(f"  unit float64 ({n}, {c}, {h}, {w}), forward and backward kernels through "
              f"autograd against autograd of the plain forward: relative L2 infer "
              f"{r_inf:.3e}, out {r_out:.3e}, stats {r_stats:.3e}, gradients <= {worst:.3e}, "
              f"noise tensors {noise:.3e}", flush=True)
        del unit, x, gout, xr, out, grads
    h, w, c, _ = UNIT_MAPS[0]
    _unit_two_streams(SU, _random_unit(c, torch.float32, seed=0), h, w, c, UNIT_N["train"])
    src = "carla_driving_rl_agent_torch/csrc/shuffle_unit.cu"
    pallas = "carla_driving_rl_agent_tpu/ops/shuffle_unit_pallas.py"
    # the kernels line: the training path's largest map, a rollout predict
    # for inference and a minibatch for the training kernels
    for name, kind, n, line in (("shuffle_unit_infer", "infer", UNIT_N["rollout"], 383),
                                ("shuffle_unit_train", "fwd", UNIT_N["train"], 286),
                                ("shuffle_unit_train_bwd", "bwd", UNIT_N["train"], 405)):
        t = full[kind][f"{n}x{h}x{w}x{c}"]
        kernels[name] = dict(name=name, route="cuda", source=src,
                             replaces=f"{pallas}:{line}", launches=None,
                             max_abs_err=err[kind], ms=t["ms"], plain_ms=t["plain_ms"],
                             bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
                             by_shape=full[kind], launches_per_call=t["launches_per_call"])
    print("  unit kernels: library call: none computes a ShuffleNet unit", flush=True)
    return dict(float64=f64, **full)


def _zero_counts() -> None:
    from carla_driving_rl_agent_torch.ops import physics as P, render as R
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    R.render_planes.launches = 0
    P.step_physics_batch.launches = 0
    P.step_physics_block.launches = 0
    SU.shuffle_unit_infer.launches = 0
    SU.shuffle_unit_train.launches = 0
    SU.shuffle_unit_train_bwd.launches = 0


def _counts() -> dict:
    from carla_driving_rl_agent_torch.ops import physics as P, render as R
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    return dict(render_planes=R.render_planes.launches,
                step_physics_batch=P.step_physics_batch.launches,
                step_physics_block=P.step_physics_block.launches,
                shuffle_unit_infer=SU.shuffle_unit_infer.launches,
                shuffle_unit_train=SU.shuffle_unit_train.launches,
                shuffle_unit_train_bwd=SU.shuffle_unit_train_bwd.launches)



def env_phase() -> dict:
    """The env bench of bench.py:83-91 in the port: 1024 Town03 worlds,
    64 routes, 512-step episodes, blocks of 4 physics ticks (one block
    call) and one push, 32-step chunks with one generator call each for the
    random actions."""
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv, CARLAEnvConfig
    from carla_driving_rl_agent_torch.envs.world import WorldParams
    env = CARLAEnv(CARLAEnvConfig(
        world=WorldParams(town_names=(TOWN,), num_routes=64, max_route_len=512,
                          max_timesteps=512), fused_step=True), device="cuda", seed=0)
    T, block = env.config.time_horizon, env.config.past_obs_freq
    states, _ = env.reset_batch(ENV_WORLDS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lo = torch.tensor([-0.2, -0.5], device="cuda")
    hi = torch.tensor([0.8, 0.5], device="cuda")
    slot = T - 1

    def chunk(states, slot):
        a_all = lo + (hi - lo) * torch.rand((ENV_CHUNK // block, block, ENV_WORLDS, 2),
                                            generator=gen, device="cuda")
        for b in range(ENV_CHUNK // block):
            states, _, _, _, _, did = env.step_physics_block(states, a_all[b])
            states = env.push_block_frame_batch(states, did.any(0), slot=slot)
            slot = (slot + 1) % T
        return states, slot

    states, slot = chunk(states, slot)              # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(ENV_CHUNKS):
        states, slot = chunk(states, slot)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    per_chunk = {k: v / ENV_CHUNKS for k, v in counts.items()}
    sps = ENV_WORLDS * ENV_CHUNK * ENV_CHUNKS / seconds
    print(f"  env {ENV_WORLDS} worlds x {ENV_CHUNK * ENV_CHUNKS} steps in {seconds:.3f} s: "
          f"{sps:.1f} env-steps/s; launches per {ENV_CHUNK}-step chunk: physics "
          f"{per_chunk['step_physics_block']:.0f}, render {per_chunk['render_planes']:.0f}",
          flush=True)
    check(per_chunk["step_physics_block"] == ENV_CHUNK // block, "physics launches per chunk")
    check(per_chunk["step_physics_batch"] == 0, "single-tick physics launches in the bench")
    check(per_chunk["render_planes"] == ENV_CHUNK // block, "render launches per chunk")
    return dict(env_steps_per_s=sps, seconds=seconds, launches=counts,
                launches_per_chunk=per_chunk)



def _train_epoch(stage, updates: int, label: str, physics_per_update: int,
                 frames_per_update: int = TRAIN_STEPS // 4) -> dict:
    """Run2 of `stage` for one epoch of `updates` updates after stage.init,
    with the launch counts set to 0 just before: the metrics finite, every
    parameter group moved, `physics_per_update` physics-kernel block
    launches per update and no single-tick ones, `frames_per_update`
    render launches and predicts per update (one per 4-step block, or one
    per step on the per-step path) and one render at the reset, and with
    fused units a pass of the 13 stride-1 units per predict (inference) and
    per minibatch (forward and backward).  Prints and returns what it
    measured."""
    agent = stage.agent
    fused_units = agent.config.fused_units
    check(agent.config.rollout_steps == TRAIN_STEPS, "128-step rollouts")
    before = {k: v.detach().clone() for k, v in agent.network.state_dict().items()}
    history = []
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    stage.run2(1, callback=lambda step, m: history.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    check(len(history) == updates, f"{len(history)} updates")
    for m in history:
        for k in ("loss_policy", "loss_value", "entropy", "ratio", "kl"):
            check(math.isfinite(m[k]), f"{label} metric {k} = {m[k]}")
    after = agent.network.state_dict()
    moved = {g: max(float((after[k] - before[k]).abs().max()) for k in after
                    if k.startswith(g + ".") and "running" not in k)
             for g in ("policy", "value", "dynamics")}
    for g, v in moved.items():
        check(v > 0.0, f"{label}: {g} parameters did not move")
    check(counts["step_physics_block"] == updates * physics_per_update
          and counts["step_physics_batch"] == 0,
          f"{label}: physics launches {counts['step_physics_block']} block, "
          f"{counts['step_physics_batch']} single-tick")
    check(counts["render_planes"] == updates * frames_per_update + 1,
          f"{label}: render launches {counts['render_planes']}")
    # per update: a predict per frame and the bootstrap value's pass
    # (inference), and a training pass of each minibatch of the two phases
    minibatches = 2 * TRAIN_WORLDS * TRAIN_STEPS // TRAIN_BATCH
    passes = dict(shuffle_unit_infer=frames_per_update + 1, shuffle_unit_train=minibatches,
                  shuffle_unit_train_bwd=minibatches)
    for name, per_update in passes.items():
        want = updates * per_update * UNITS_PER_PASS if fused_units else 0
        check(counts[name] == want, f"{label}: {name} launches {counts[name]} != {want}")
    parts = {k: [m[f"seconds_{k}"] for m in history]
             for k in ("rollout", "targets", "policy", "value")}
    update_s = sum(sum(v) for v in parts.values())
    sps = updates * TRAIN_WORLDS * TRAIN_STEPS / update_s
    print(f"  {label}: {updates} updates of {TRAIN_WORLDS} worlds x {TRAIN_STEPS} steps, "
          f"batch {TRAIN_BATCH}, in {seconds:.3f} s (save and snapshot included); "
          f"{sps:.1f} train env-steps/s over the updates", flush=True)
    print("  seconds per update: " + ", ".join(
        f"{k} {np.mean(v):.4f}" for k, v in parts.items())
        + f"; launches per update: physics {counts['step_physics_block'] / updates:.0f}, "
          f"render {(counts['render_planes'] - 1) / updates:.0f} (+1 at the reset)",
        flush=True)
    if fused_units:
        print("  unit kernel launches per update: " + ", ".join(
            f"{k} {counts[k] / updates:.0f}" for k in passes)
            + f"; per minibatch: forward {counts['shuffle_unit_train'] / (updates * minibatches):.0f}"
              f", backward {counts['shuffle_unit_train_bwd'] / (updates * minibatches):.0f}",
            flush=True)
    for i, m in enumerate(history):
        print(f"  update {i + 1}: " + ", ".join(
            f"{k} {m[k]:.6g}" for k in ("reward_mean", "loss_policy", "loss_value",
                                         "entropy", "ratio", "kl", "episode_done")),
            flush=True)
    print("  parameters moved (max |delta|): " + ", ".join(
        f"{g} {v:.3e}" for g, v in moved.items()), flush=True)
    return dict(seconds=seconds, env_steps_per_s=sps, launches=counts,
                parts_mean_s={k: float(np.mean(v)) for k, v in parts.items()},
                parts_s=parts, moved=moved, history=history)


def train_phase(out_dir: str, fused_units: bool = False) -> tuple:
    """Stage s1 at the shipped geometry for one epoch (5 updates), from a
    fresh seeded network, with the backbone's stride-1 units unfused or on
    the unit kernels; returns (stage, summary)."""
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent
    from carla_driving_rl_agent_torch.curriculum import stages
    stage = stages.stage_s1(episodes=TRAIN_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            num_envs=TRAIN_WORLDS, rollout_block=True,
                            fused_units=fused_units,
                            weights_dir=os.path.join(out_dir, "weights-torch"),
                            env_overrides=dict(fused_step=True, device="cuda"))
    stage.init()
    agent = stage.agent
    summary = _train_epoch(stage, TRAIN_UPDATES, "train", TRAIN_STEPS // 4)
    after = agent.network.state_dict()

    # the checkpoint reloads equal
    fresh = CARLAgent(stage.env, agent.config, name=agent.name,
                      weights_dir=os.path.dirname(agent.base_path))
    fresh.load()
    sd = fresh.network.state_dict()
    for k, v in after.items():
        if not k.startswith("old_policy."):
            check(torch.equal(sd[k], v), f"reloaded {k}")
    for g in ("policy", "value", "dynamics"):
        s1, s2 = agent.optimizers[g].state_dict(), fresh.optimizers[g].state_dict()
        for i in s1["state"]:
            check(all(torch.equal(s1["state"][i][x], s2["state"][i][x])
                      for x in ("exp_avg", "exp_avg_sq")), f"reloaded {g} Adam state")
    check(fresh.update_step == agent.update_step, "reloaded update step")
    print(f"  checkpoint {os.path.basename(agent.base_path)}: reloads equal (network, "
          f"Adam states, update step {fresh.update_step})", flush=True)
    return stage, summary


# the depth of train_s2, train_s3_fused, train_s4, train_s5_fused and
# train_expert_fused (a cut for time)
CUT_UPDATES = 2


def _traffic_numbers(stage, summary: dict, label: str) -> dict:
    """What a stage with traffic ran with and earned: the mean reward per
    step, the episodes that ended, and the NPCs per world at the end."""
    npc = stage._env_states.world.npc
    out = dict(reward_per_step=float(np.mean([m["reward_mean"] for m in summary["history"]])),
               episodes_ended=float(sum(m["episode_done"] for m in summary["history"])),
               vehicles_per_world=float(npc.veh_active.sum()) / TRAIN_WORLDS,
               walkers_per_world=float(npc.ped_active.sum()) / TRAIN_WORLDS,
               n_actors=stage.env.n_actors)
    print(f"  {label}: mean reward per step {out['reward_per_step']:.6g}, "
          f"{out['episodes_ended']:.0f} episodes ended, {out['vehicles_per_world']:.2f} vehicles "
          f"and {out['walkers_per_world']:.2f} walkers per world, {out['n_actors']} actor rows; "
          f"{summary['env_steps_per_s']:.1f} train env-steps/s; seconds per update: "
          + ", ".join(f"{k} {v:.4f}" for k, v in summary["parts_mean_s"].items()), flush=True)
    return out


def _hold_loaded(agent, network: dict, optimizers=None, update_step: int = None,
                 what: str = "") -> None:
    """The agent right after its stage loaded a checkpoint: every tensor but
    old_policy's equals `network`, old_policy's parameters equal the
    policy's (a full load copies them), its Adam states equal
    `optimizers` (when given) and its update step `update_step`."""
    sd = agent.network.state_dict()
    check(set(sd) == set(network), f"{what}: the loaded network's tensors")
    params = {n for n, _ in agent.network.named_parameters()}
    for name, v in sd.items():
        if name.startswith("old_policy.") and name in params:
            want = sd[name.replace("old_policy.", "policy.", 1)]
        else:
            want = network[name]
        check(torch.equal(v.cpu(), want.cpu()), f"{what}: loaded {name}")
    for g, state in (optimizers or {}).items():
        got = agent.optimizers[g].state_dict()["state"]
        check(set(got) == set(state["state"]), f"{what}: {g} Adam state entries")
        for i, st in state["state"].items():
            check(all(torch.equal(got[i][x].cpu(), st[x].cpu())
                      for x in ("exp_avg", "exp_avg_sq", "step")), f"{what}: {g} Adam state {i}")
    check(agent.update_step == update_step, f"{what}: update step {agent.update_step}")


def stage_refusals(root: str) -> None:
    """What must fail before any training: `--fused-step` with stages s2
    and s4 (the physics kernel computes worlds without NPCs)."""
    from carla_driving_rl_agent_torch import main as cli
    for which in ("s2", "s4"):
        try:
            cli.make_stage(which, fused_step=True, device="cuda", weights_dir=root).init()
        except NotImplementedError as e:
            print(f"  --fused-step with {which} raises before training: {e}", flush=True)
        else:
            check(False, f"--fused-step with {which} did not raise")


def _hand_off_tracked(root: str, src: str, dst: str) -> dict:
    """The JAX package's tracked weights/stage-`src` copied into `root` and
    handed off to stage-`dst` there; returns it as the port's tensors."""
    from carla_driving_rl_agent_torch import main as cli
    from carla_driving_rl_agent_torch.utils.checkpoint import params_from_jax, read_flax_msgpack
    ckpt = os.path.join("weights", f"stage-{src}")
    shutil.copytree(ckpt, os.path.join(root, f"stage-{src}"))
    cli.hand_off(src, dst, root)
    return params_from_jax(read_flax_msgpack(os.path.join(ckpt, "params.msgpack")),
                           read_flax_msgpack(os.path.join(ckpt, "batch_stats.msgpack")))


def _hand_off_port(root: str, src: str, dst: str) -> tuple:
    """The port's stage-`src` checkpoint in `root` handed off to
    stage-`dst`; returns its (network, Adam states, update step)."""
    from carla_driving_rl_agent_torch import main as cli
    cli.hand_off(src, dst, root)
    ckpt = os.path.join(root, f"stage-{dst}")
    with open(os.path.join(ckpt, "config.json")) as f:
        update_step = json.load(f)["update_step"]
    return (torch.load(os.path.join(ckpt, "network.pt"), map_location="cpu"),
            torch.load(os.path.join(ckpt, "optimizers.pt"), map_location="cpu"), update_step)


def train_s2_phase(root: str) -> tuple:
    """Stage s2 (50 walkers, 50 origins) at the shipped geometry, unfused,
    for CUT_UPDATES updates, from the JAX package's tracked stage-s1
    checkpoint copied into `root` and handed off to stage-s2 there: before
    the first update the network equals params_from_jax of that checkpoint
    (old_policy its policy) and the update step is 150; the physics kernel
    makes no launch (the plain block steps the NPC worlds).  Returns
    (stage, summary)."""
    from carla_driving_rl_agent_torch.curriculum import stages
    ref = _hand_off_tracked(root, "s1", "s2")
    stage = stages.stage_s2(episodes=CUT_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            num_envs=TRAIN_WORLDS, rollout_block=True, weights_dir=root,
                            env_overrides=dict(device="cuda"))
    stage.init()
    _hold_loaded(stage.agent, ref, update_step=150, what="s2 from the tracked stage-s1")
    print("  stage-s2 loaded weights/stage-s1 through hand_off: every tensor equal, "
          "old_policy = policy, update step 150", flush=True)
    summary = _train_epoch(stage, CUT_UPDATES, "train_s2", 0)
    summary.update(_traffic_numbers(stage, summary, "train_s2"))
    return stage, summary


def train_s3_fused_phase(root: str) -> tuple:
    """Stage s3 (50 vehicles, 50 walkers, the training weathers) at the
    shipped geometry with fused_units=True, for CUT_UPDATES updates (a cut
    for time), from train_s2's checkpoint handed off in `root`: before the
    first update the network and the Adam states equal that checkpoint's
    exactly; the unit kernels run in every predict and minibatch, the
    physics kernel not at all; the weathers drawn are training weathers.
    Returns (stage, summary)."""
    from carla_driving_rl_agent_torch.curriculum import stages
    from carla_driving_rl_agent_torch.envs.weather import TRAIN_WEATHERS, weather_ids
    network, optimizers, update_step = _hand_off_port(root, "s2", "s3")
    stage = stages.stage_s3(episodes=CUT_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            num_envs=TRAIN_WORLDS, rollout_block=True, fused_units=True,
                            weights_dir=root, env_overrides=dict(device="cuda"))
    stage.init()
    _hold_loaded(stage.agent, network, optimizers, update_step, "s3 from the s2 checkpoint")
    print(f"  stage-s3 loaded train_s2's checkpoint through hand_off: network and Adam states "
          f"equal, update step {update_step}", flush=True)
    check(stage.env.n_actors == 8, f"s3 renders {stage.env.n_actors} actor rows")
    summary = _train_epoch(stage, CUT_UPDATES, "train_s3_fused", 0)
    summary.update(_traffic_numbers(stage, summary, "train_s3_fused"))
    drawn = set(stage._env_states.world.weather_id.tolist())
    check(drawn <= {int(i) for i in weather_ids(TRAIN_WEATHERS)},
          f"s3 weathers {sorted(drawn)} outside the training weathers")
    print(f"  weather ids at the end: {sorted(drawn)}, all training weathers", flush=True)
    return stage, summary


def train_s4_phase(root: str) -> tuple:
    """Stage s4 (stage s3's 50 vehicles, 50 walkers and training weathers,
    the training augmentation at aug_intensity 1.0) at the shipped
    geometry, unfused, for CUT_UPDATES updates, from the JAX package's
    tracked stage-s3 checkpoint handed off in `root`: before the first
    update the network equals params_from_jax of it (old_policy its
    policy) and the update step is 290.  Returns (stage, summary)."""
    from carla_driving_rl_agent_torch.curriculum import stages
    ref = _hand_off_tracked(root, "s3", "s4")
    stage = stages.stage_s4(episodes=CUT_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            num_envs=TRAIN_WORLDS, rollout_block=True, weights_dir=root,
                            env_overrides=dict(device="cuda"))
    stage.init()
    _hold_loaded(stage.agent, ref, update_step=290, what="s4 from the tracked stage-s3")
    check(stage.agent.config.aug_intensity == 1.0, "s4 trains with augmentation")
    check(stage.env.n_actors == 8, f"s4 renders {stage.env.n_actors} actor rows")
    print("  stage-s4 loaded weights/stage-s3 through hand_off: every tensor equal, "
          "old_policy = policy, update step 290; aug_intensity 1.0", flush=True)
    summary = _train_epoch(stage, CUT_UPDATES, "train_s4", 0)
    summary.update(_traffic_numbers(stage, summary, "train_s4"))
    return stage, summary


AUG_BAR = 1e-5       # max |diff| of the pipeline, card against CPU, on [0, 1] images
AUG_ILL_RANGE = 1e-2  # a range before normalize below which it amplifies rounding past AUG_BAR


def _profiled_launches(fn) -> int:
    """Device kernel launches of one call of `fn` under torch.profiler
    (after a warm-up call); a window with no kernel record is taken again,
    up to PROFILE_WINDOWS windows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset")))
        if n:
            return n
    return 0


def augment_agree_phase(stage, update_s: float) -> dict:
    """The training augmentation (augment/simclr.py) on a real s4
    minibatch: 64 samples of 4 frames of 90 x 360 x 3 from a 128-step
    rollout of `stage` (stage s4 after train_s4), one set of draws per
    sample from a CUDA generator, at aug_intensity 1.0.  The card's
    pipeline against the CPU's on the same images and draws: max |diff|
    <= AUG_BAR on every frame before normalize, and after it on every
    frame whose range there is at least AUG_ILL_RANGE (those below must
    have entered flat: the stacks' zero frames); every output in [0, 1].
    Then the launches and device ms per minibatch, and its share of an s4
    update (128 minibatches against `update_s`)."""
    from carla_driving_rl_agent_torch.agents import rollout as rollout_mod
    from carla_driving_rl_agent_torch.augment import simclr as S
    from carla_driving_rl_agent_torch.envs.carla_env import planes_to_image
    agent = stage.agent
    _, traj, final_obs = agent._rollout(stage._env_states)
    data = agent.targets(traj, final_obs, stage._env_states.last_action, 2.0)
    idx = torch.randperm(TRAIN_WORLDS * TRAIN_STEPS, device="cuda")[:TRAIN_BATCH]
    planes = rollout_mod.gather_image_stacks(data["traj"], data["step"][idx],
                                             data["env"][idx], data["timeline"])
    ry, rx = agent.env.config.upsample
    img = planes_to_image(planes, ry, rx).to(torch.float32) / 255.0
    n, t, h, w, c = img.shape
    check((n, t, h, w, c) == (TRAIN_BATCH, 4, 90, 360, 3), f"minibatch {tuple(img.shape)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    draws = S.pipeline_draws(gen, n, h, w, c)
    draws_cpu = S.PipelineDraws(*(x.cpu() for x in draws))
    img_cpu = img.cpu()
    pre = S.distort(img, draws, 1.0)
    pre_err = float((pre.cpu() - S.distort(img_cpu, draws_cpu, 1.0)).abs().max())
    check(pre_err <= AUG_BAR, f"augmentation before normalize, card vs CPU: {pre_err:.3e}")
    span = pre.amax((-3, -2, -1)) - pre.amin((-3, -2, -1))
    ill = (span < AUG_ILL_RANGE).cpu()
    flat_in = (img.amax((-3, -2, -1)) == img.amin((-3, -2, -1))).cpu()
    check(not bool((ill & ~flat_in).any()), "a frame that entered with a range is ill-conditioned")
    out = S.carla_augment_pipeline(img, draws, 1.0)
    t0 = time.perf_counter()
    out_cpu = S.carla_augment_pipeline(img_cpu, draws_cpu, 1.0)
    cpu_s = time.perf_counter() - t0
    err = float((out.cpu() - out_cpu)[~ill].abs().max())
    check(err <= AUG_BAR, f"augmentation, card vs CPU: {err:.3e} > {AUG_BAR}")
    check(bool(((out >= 0) & (out <= 1)).all()), "augmented values outside [0, 1]")
    print(f"  minibatch {n} x {t} x {h} x {w} x {c} of an s4 rollout: card vs CPU max |diff| "
          f"{err:.3e} (before normalize {pre_err:.3e}); {int(flat_in.sum())} frames entered "
          f"flat, {int(ill.sum())} of them met no blur, salt or noise (normalize divides "
          f"their rounding by its eps: held before normalize and to [0, 1])", flush=True)
    launches = graph_launches(lambda: S.carla_augment_pipeline(img, draws, 1.0))
    draw_launches = _profiled_launches(lambda: S.pipeline_draws(gen, n, h, w, c))
    ms = cuda_ms(lambda: S.augment(gen, img, 1.0), iters=10)
    device_ms = graph_ms(lambda: S.carla_augment_pipeline(img, draws, 1.0), reps=5, replays=3)
    share = 2 * TRAIN_WORLDS * TRAIN_STEPS // TRAIN_BATCH * ms / 1e3 / update_s
    print(f"  per minibatch: {launches} launches in the pipeline (CUDA graph) + {draw_launches} "
          f"for the draws (profiler); {ms:.4f} ms with its draws (CUDA events), {device_ms:.4f} "
          f"ms of device time without them (CUDA graph); the CPU's pipeline {cpu_s:.3f} s; "
          f"128 minibatches are {share:.4f} of an s4 update ({update_s:.3f} s)", flush=True)
    return dict(max_abs_err=err, before_normalize_err=pre_err, flat_frames=int(flat_in.sum()),
                ill_conditioned_frames=int(ill.sum()), launches=launches,
                draw_launches=draw_launches, ms=ms, device_ms=device_ms, cpu_s=cpu_s,
                share_of_update=share)


def train_s5_fused_phase(root: str) -> tuple:
    """Stage s5 (Town03, dense traffic: 100 vehicles, 200 walkers, the
    augmentation) at the shipped geometry with fused_units=True, for
    CUT_UPDATES updates, from train_s4's checkpoint handed off in `root`:
    before the first update the network and the Adam states equal that
    checkpoint's exactly; 8 actor rows.  Returns (stage, summary)."""
    from carla_driving_rl_agent_torch.curriculum import stages
    network, optimizers, update_step = _hand_off_port(root, "s4", "s5")
    stage = stages.stage_s5(episodes=CUT_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            town=TOWN, traffic="dense", num_envs=TRAIN_WORLDS,
                            rollout_block=True, fused_units=True, weights_dir=root,
                            env_overrides=dict(device="cuda"))
    stage.init()
    _hold_loaded(stage.agent, network, optimizers, update_step, "s5 from the s4 checkpoint")
    p = stage.env.params
    check((p.num_vehicles, p.num_pedestrians) == (100, 200), "s5's dense traffic")
    check(stage.env.n_actors == 8, f"s5 renders {stage.env.n_actors} actor rows")
    check(stage.agent.config.aug_intensity == 1.0, "s5 trains with augmentation")
    print(f"  stage-s5 loaded train_s4's checkpoint through hand_off: network and Adam states "
          f"equal, update step {update_step}", flush=True)
    summary = _train_epoch(stage, CUT_UPDATES, "train_s5_fused", 0)
    summary.update(_traffic_numbers(stage, summary, "train_s5_fused"))
    return stage, summary


TINY_NET = dict(
    control_policy=dict(units=32, num_layers=1),
    control_value=dict(units=32, num_layers=1),
    dynamics=dict(shufflenet=dict(g=0.5, last_channels=64),
                  rnn=dict(image=32, road=8, vehicle=8, navigation=8),
                  dynamics=dict(units=64),
                  road=dict(units=8, num_layers=1, activation="relu6"),
                  vehicle=dict(units=8, num_layers=1, activation="relu6"),
                  navigation=dict(units=8, num_layers=1, activation="relu6")))


# train_agree's bars, per dtype, on relative differences over a phase: the
# loss; the gradients of the parameter tensors whose true gradient is not
# rounding noise, the step's changes of those tensors, and the changes of
# the BatchNorm buffers, each as ||card - cpu|| / ||cpu|| over all those
# tensors together.  A tensor's gradient is rounding noise when its float64
# gradient on the CPU stays below 1e-6 of the phase's largest entry (biases
# that a training-mode BatchNorm follows: their true gradient is 0); Adam
# turns that noise into a step of up to the learning rate, either way on
# either side, so those tensors' changes are printed and not held.  In
# float32 no parameter change is held either: Adam's first step moves an
# entry by lr * g / (|g| + eps), about lr * sign(g) whatever |g|, so an
# entry whose gradient is near its own rounding noise may step either way.
TRAIN_AGREE_BARS = dict(float64=dict(loss=1e-9, grad=1e-9, param=1e-9, buffer=1e-9),
                        float32=dict(loss=1e-4, grad=5e-2, param=None, buffer=1e-4))


def _phase_step(agent, phase: str, batch: dict, hyper: dict) -> tuple:
    """One policy-phase or value-phase step; returns (loss, {parameter
    name: its gradient before clipping})."""
    names = {id(p): n for n, p in agent.network.named_parameters()}
    grads, inner = {}, agent._grads

    def grab(loss, groups):
        out = inner(loss, groups)
        for g in groups:
            grads.update({names[id(p)]: t.detach().cpu().clone()
                          for p, t in zip(agent.params[g], out[g])})
        return out

    agent._grads = grab
    if phase == "policy":
        loss = agent.policy_step(batch, hyper)["loss_total"]
    else:
        loss = agent.value_step(batch)["loss_value"]
    del agent._grads
    return float(loss), grads


def _rel_l2(xs: dict, refs: dict, names) -> float:
    """||xs - refs|| / ||refs|| over the tensors `names` together."""
    num = sum(float(((xs[k].double() - refs[k].double()) ** 2).sum()) for k in names)
    den = sum(float((refs[k].double() ** 2).sum()) for k in names)
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else math.inf)


def train_agree_phase(env, fused_units: bool = False) -> dict:
    """One policy-phase step and one value-phase step of a small network,
    each from the same fresh parameters and minibatch, on the card and on
    the CPU, in float64 and then in float32, held to TRAIN_AGREE_BARS.  The
    card computes in full float32, as the trainer does (no TF32).  With
    `fused_units` the card runs the unit kernels (float32 and float64
    instantiations) and the CPU their plain versions."""
    from carla_driving_rl_agent_torch.agents.carla_agent import (
        CARLAgent, CARLAgentConfig, full_float32)
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv
    full_float32()
    cpu_env = CARLAEnv(env.config, device="cpu")
    rng = np.random.default_rng(0)
    mb, T = 16, env.config.time_horizon
    h, w, c = env.config.image_shape

    def batch():
        a = rng.uniform(0.05, 0.95, (mb, 2)).astype(np.float32)
        return dict(obs=dict(state_image=rng.uniform(0, 1, (mb, T, h, w, c)).astype(np.float32),
                             state_road=rng.uniform(0, 1, (mb, T, 9)).astype(np.float32),
                             state_vehicle=rng.uniform(0, 1, (mb, T, 4)).astype(np.float32),
                             state_navigation=rng.uniform(0, 3, (mb, T, 5)).astype(np.float32),
                             action=a),
                    advantages=rng.normal(0, 1, mb).astype(np.float32),
                    returns=np.stack([rng.uniform(-1, 1, mb), rng.integers(0, 4, mb)],
                                     -1).astype(np.float32),
                    log_prob=(np.log(a) - 0.3).astype(np.float32),
                    speed=rng.uniform(0, 0.5, mb).astype(np.float32),
                    similarity=rng.uniform(0.5, 1, mb).astype(np.float32))

    batches = dict(policy=batch(), value=batch())
    hyper = dict(clip_ratio=0.2, entropy=0.1, adv_scale=2.0)
    out, noise = {}, {}
    for dtype in (torch.float64, torch.float32):    # float64 names the noise tensors
        name = str(dtype).split(".")[1]
        bars = TRAIN_AGREE_BARS[name]
        for phase in ("policy", "value"):
            runs = []
            for e in (env, cpu_env):
                agent = CARLAgent(e, CARLAgentConfig(network=TINY_NET, seed=3,
                                                     fused_units=fused_units))
                agent.network.to(dtype)
                conv = lambda t: {k: conv(v) if isinstance(v, dict) else
                                  torch.from_numpy(v).to(e.device, dtype) for k, v in t.items()}
                before = {k: v.detach().cpu().clone()
                          for k, v in agent.network.state_dict().items()}
                _zero_counts()
                loss, grads = _phase_step(agent, phase, conv(batches[phase]), hyper)
                if e is env and fused_units:
                    c = _counts()
                    check(c["shuffle_unit_train"] > 0 and c["shuffle_unit_train_bwd"] > 0,
                          f"train_agree's card step launched the unit kernels: {c}")
                after = {k: v.detach().cpu() for k, v in agent.network.state_dict().items()}
                runs.append((loss, grads, {k: after[k] - before[k] for k in after}))
            (lg, gg, dg), (lc, gc, dc) = runs
            if dtype == torch.float64:
                top = max(float(g.abs().max()) for g in gc.values())
                noise[phase] = sorted(k for k, g in gc.items() if float(g.abs().max()) < 1e-6 * top)
            held = [k for k in gc if k not in noise[phase]]
            buffers = [k for k in dc if "running" in k]
            r = dict(loss_card=lg, loss_cpu=lc, loss=abs(lg - lc) / abs(lc),
                     grad=_rel_l2(gg, gc, held), param=_rel_l2(dg, dc, held),
                     buffer=_rel_l2(dg, dc, buffers),
                     noise_delta=max((float((dg[k] - dc[k]).abs().max()) for k in noise[phase]),
                                     default=0.0),
                     max_delta_diff=max(float((dg[k] - dc[k]).abs().max()) for k in dg),
                     held=len(held), noise=len(noise[phase]), buffers=len(buffers))
            print(f"  train_agree{' fused_units' if fused_units else ''} {name} {phase} step: "
                  f"loss card {lg:.12g} cpu {lc:.12g}; "
                  f"relative differences: loss {r['loss']:.3e}, gradients {r['grad']:.3e} "
                  f"({r['held']} tensors), parameter changes {r['param']:.3e}, BatchNorm "
                  f"buffer changes {r['buffer']:.3e} ({r['buffers']}); the {r['noise']} "
                  f"noise-gradient tensors' changes differ by {r['noise_delta']:.3e}; "
                  f"largest parameter-delta difference {r['max_delta_diff']:.3e}", flush=True)
            for k, bar in bars.items():
                if bar is not None:
                    check(r[k] <= bar, f"train_agree {name} {phase}: {k} differs by "
                                       f"{r[k]:.3e} > {bar:.0e}")
            out[f"{name}_{phase}"] = r
    out["noise_tensors"] = noise
    return out


PROFILE_ROLLOUT_STEPS = 32


# the launches of one call of each unit-kernel wrapper, by kernel name
# (k_pw's second template argument is its stage: csrc/shuffle_unit.cu PwMode)
UNIT_KERNEL_NAMES = dict(
    shuffle_unit_infer=("k_pw<float, 0>", "k_dw_infer<float>", "k_pw<float, 5>"),
    shuffle_unit_train=("k_pw<float, 1>", "k_dw_train<float>", "k_pw<float, 2>",
                        "k_out_train<float>"),
    shuffle_unit_train_bwd=("k_bn3_back<float>", "k_pw<float, 3>", "k_dw_back<float>",
                            "k_pw<float, 4>", "k_wgrad<float>"))


def _unit_device_ms(kern, counts: dict) -> dict:
    """Device milliseconds per wrapper call of each unit kernel that ran,
    from the profiler's kernels and the wrappers' launch counts."""
    out = {}
    for name, keys in UNIT_KERNEL_NAMES.items():
        if counts.get(name):
            us = sum(e.self_device_time_total for e in kern if any(k in e.key for k in keys))
            out[name] = us / 1e3 / counts[name]
    return out


def profile_train_phase(agent, per_call: dict) -> dict:
    """A quarter-length training update under torch.profiler (rollouts of 32
    steps: 8 blocks, 16 minibatches per phase, the parts in the shipped
    proportions): device busy time, idle share, launches and the largest
    kernels; then the kernel launches of one rollout block alone, and one
    policy-phase and one value-phase minibatch of that rollout alone:
    launches, device time and wall time per minibatch; with NPCs, what
    their tick and spawn cost per tick (npc_costs)."""
    from torch.profiler import ProfilerActivity, profile
    steps = agent.config.rollout_steps
    agent.config.rollout_steps = PROFILE_ROLLOUT_STEPS
    states, _ = agent.env.reset_batch(agent.config.num_envs)
    hyper = dict(clip_ratio=0.2, entropy=0.1, adv_scale=2.0)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        agent.train_iteration(states, hyper)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    states, traj, final_obs = agent._rollout(states)
    data = agent.targets(traj, final_obs, states.last_action, hyper["adv_scale"])
    batch = agent.gather_batch(data, torch.arange(agent.config.batch_size,
                                                  device=agent.env.device))
    # a rollout of one block of past_obs_freq steps: its kernel launches (a
    # predict, the physics block, the push, and the rollout's start and end)
    agent.config.rollout_steps = agent.env.config.past_obs_freq
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as r_prof:
        agent._rollout(states)
        torch.cuda.synchronize()
    rollout_launches = sum(e.count for e in r_prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
    agent.config.rollout_steps = steps
    agent.policy_step(batch, hyper)
    agent.value_step(batch)
    torch.cuda.synchronize()
    _zero_counts()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as mb_prof:
        agent.policy_step(batch, hyper)
        agent.value_step(batch)
        torch.cuda.synchronize()
    mb_wall = (time.perf_counter() - t1) / 2
    mb_counts = _counts()
    mb_kern = [e for e in mb_prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    mb_busy = sum(e.self_device_time_total for e in mb_kern) / 1e6 / 2
    # the profiler's count of unit-kernel launches beside the one the
    # wrappers' calls imply (`per_call`: phase unit's launches per call,
    # counted in a CUDA graph), which says whether its records of the window
    # are complete
    unit_seen = sum(e.count for e in mb_kern if any(
        k in e.key for keys in UNIT_KERNEL_NAMES.values() for k in keys)) / 2
    unit_calls = sum(mb_counts[k] * per_call[k]
                     for k in ("shuffle_unit_train", "shuffle_unit_train_bwd")) / 2
    minibatch = dict(launches=sum(e.count for e in mb_kern) / 2, device_busy_s=mb_busy,
                     wall_s=mb_wall, device_idle_share=1.0 - mb_busy / mb_wall,
                     unit_device_ms=_unit_device_ms(mb_kern, mb_counts),
                     unit_launches_profiled=unit_seen, unit_launches_called=unit_calls)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    out = dict(rollout_steps=PROFILE_ROLLOUT_STEPS, wall_s=wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / wall,
               kernel_launches=sum(e.count for e in kern),
               parts_s=dict(agent.last_timings),
               top_kernels=[dict(name=e.key[:90], count=e.count,
                                 ms=e.self_device_time_total / 1e3)
                            for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:15]])
    for name in ("physics_kernel", "render_kernel"):
        ev = [e for e in kern if name in e.key]
        if ev:
            out[f"{name}_device_ms"] = ev[0].self_device_time_total / 1e3 / ev[0].count
    out.update(unit_device_ms=_unit_device_ms(kern, counts), minibatch=minibatch,
               rollout_launches_per_block=rollout_launches)
    label = "fused_units" if agent.config.fused_units else "unfused"
    if agent.env.params.has_npcs:
        label += ", traffic"
    print(f"  [{label}] a {PROFILE_ROLLOUT_STEPS}-step update under the profiler: wall "
          f"{wall:.3f} s, device busy {busy:.3f} s, idle share "
          f"{out['device_idle_share']:.4f}, {out['kernel_launches']} kernel launches; physics "
          f"kernel {out.get('physics_kernel_device_ms', float('nan')):.6f} ms and render kernel "
          f"{out.get('render_kernel_device_ms', float('nan')):.6f} ms device time per launch",
          flush=True)
    print(f"  [{label}] one minibatch (policy and value steps averaged): "
          f"{minibatch['launches']:.0f} kernel launches, wall {mb_wall:.4f} s, device busy "
          f"{mb_busy:.4f} s, idle share {minibatch['device_idle_share']:.4f}; unit kernels' "
          f"device ms per call: " + (", ".join(
              f"{k} {v:.6f}" for k, v in out["unit_device_ms"].items()) or "none")
          + f"; unit-kernel launches per minibatch: {unit_seen:g} profiled, {unit_calls:g} "
            f"called", flush=True)
    print(f"  [{label}] a rollout of one {agent.env.config.past_obs_freq}-step block (its start "
          f"and final observation included): {rollout_launches} kernel launches", flush=True)
    for k in out["top_kernels"]:
        print(f"    {k['ms']:10.3f} ms {k['count']:7d}x  {k['name']}", flush=True)
    if agent.env.params.has_npcs:
        out["npc"] = npc_costs(agent.env, states.world)
        print(f"  [{label}] NPCs per tick at {states.world.x.shape[0]} worlds: " + "; ".join(
            f"{k} host {v['host_ms']:.4f} ms, device {v['device_ms']:.4f} ms, "
            f"{v['launches']} launches" for k, v in out["npc"].items()), flush=True)
    return out


# ---------------------------------------------------------------- the imitation path

EXPERT_WORLDS, EXPERT_STEPS = 32, 128
EXPERT_SIMILARITY = 0.7      # JAX tests/test_curriculum.py's bar for the expert's driving
WORLD_BAR = (1e-5, 2.5e-7)   # the world tests' bar: absolute, relative


def expert_phase(env) -> dict:
    """The privileged expert drives EXPERT_WORLDS worlds of `env` (stage
    s3's: Town03 with 50 vehicles and 50 walkers) for EXPERT_STEPS steps on
    the card, auto-resets included; at every step its actions on the card
    equal the plain CPU port's on the same state (copied to the CPU)
    within the world bar.  Holds the mean similarity >= EXPERT_SIMILARITY
    and prints it with the collision rate (worlds whose first episode
    ended in a collision) and env-steps/s (the CPU comparisons excluded)."""
    from carla_driving_rl_agent_torch.envs import expert, world as world_mod
    from carla_driving_rl_agent_torch.envs.carla_env import CARLAEnv
    cpu_env = CARLAEnv(env.config, device="cpu")
    env.seed(7)
    states, _ = env.reset_batch(EXPERT_WORLDS)
    sims, worst, drive_s = [], 0.0, 0.0
    first = torch.zeros(EXPERT_WORLDS, dtype=torch.bool, device="cuda")
    hit = torch.zeros_like(first)
    _zero_counts()
    for _ in range(EXPERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = expert.expert_action(states.world, env.params, env.town, env.routes)
        world = states.world
        states, _, _, term, trunc, info = env.step(states, a)
        torch.cuda.synchronize()
        drive_s += time.perf_counter() - t0
        want = expert.expert_action(world_mod.map_tensors(lambda t: t.cpu(), world),
                                    cpu_env.params, cpu_env.town, cpu_env.routes)
        err = (a.cpu() - want).abs() - WORLD_BAR[1] * want.abs()
        worst = max(worst, float(err.max()))
        sims.append(info["similarity"])
        done = term | trunc
        hit |= info["collision"] & done & ~first
        first |= done
    counts = _counts()
    check(worst <= WORLD_BAR[0], f"the expert's actions, card vs CPU: {worst:.3e} over the bar")
    similarity = float(torch.stack(sims).mean())
    n_first = int(first.sum())
    rate = float(hit.sum()) / EXPERT_WORLDS
    sps = EXPERT_WORLDS * EXPERT_STEPS / drive_s
    print(f"  expert: {EXPERT_WORLDS} Town03 worlds with 50/50 NPCs x {EXPERT_STEPS} steps: "
          f"mean similarity {similarity:.4f}, collision rate {rate:.4f} ({int(hit.sum())} "
          f"worlds; {n_first} first episodes ended), {sps:.1f} env-steps/s; actions card vs CPU within "
          f"the world bar (worst excess {worst:.3e}); launches: render "
          f"{counts['render_planes']}", flush=True)
    check(similarity >= EXPERT_SIMILARITY, f"the expert's mean similarity {similarity:.4f}")
    check(counts["render_planes"] == EXPERT_STEPS, "one render launch per expert step")
    return dict(similarity=similarity, collision_rate=rate, episodes_ended=n_first,
                env_steps_per_s=sps, worst_excess=worst, launches=counts)


IMITATE_EPISODES, IMITATE_STEPS = 4, 128
# fused against unfused imitation, one step from the same weights: the
# float32 bars of TRAIN_AGREE_BARS (loss, BatchNorm buffer changes)
IMITATE_BARS = dict(loss=TRAIN_AGREE_BARS["float32"]["loss"],
                    buffer=TRAIN_AGREE_BARS["float32"]["buffer"])


def imitate_phase(root: str) -> dict:
    """CARLACollectWrapper writes IMITATE_EPISODES expert episodes of
    IMITATE_STEPS steps (Town03, no traffic, the shipped 90 x 360 frames)
    into `root`; then CARLAgent.imitate at batch 64 with the shipped
    network, from the same seeded weights, with fused units and unfused:
    first one step on a trace cut to 64 samples, held to IMITATE_BARS
    (the losses, and the BatchNorm buffers' changes as ||fused - unfused||
    / ||unfused||), the parameter changes printed; then one epoch over all
    traces with fused units, timed per update, its unit-kernel launches
    counted."""
    from carla_driving_rl_agent_torch.agents.carla_agent import CARLAgent, CARLAgentConfig
    from carla_driving_rl_agent_torch.curriculum import stages
    from carla_driving_rl_agent_torch.envs.wrappers import CARLACollectWrapper
    from carla_driving_rl_agent_torch.utils import traces as trace_io
    env = stages.build_env(town=TOWN, max_timesteps=IMITATE_STEPS, device="cuda")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    n = CARLACollectWrapper(env, traces_dir=root, name="expert",
                            num_envs=IMITATE_EPISODES).collect(IMITATE_EPISODES, IMITATE_STEPS)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    collect_counts = _counts()
    check(n == IMITATE_EPISODES, f"{n} expert traces written")
    tdir = os.path.join(root, "expert")
    traces = list(trace_io.load_traces(tdir))
    check(all(t["state_image"].shape[1:] == (4, 90, 360, 3) for t in traces), "trace frames")
    one = os.path.join(root, "one")
    os.makedirs(one)
    np.savez(os.path.join(one, "trace-0-cut.npz"),
             **{k: v[:TRAIN_BATCH] for k, v in max(traces, key=lambda t: len(t["reward"])).items()})
    print(f"  collection: {n} expert traces of {[len(t['reward']) for t in traces]} steps in "
          f"{collect_s:.3f} s; launches: render {collect_counts['render_planes']}", flush=True)

    def agent(fused: bool):
        return CARLAgent(env, CARLAgentConfig(fused_units=fused, seed=3), name="imitate",
                         weights_dir=root)

    runs = {}
    for fused in (True, False):
        a = agent(fused)
        before = {k: v.detach().clone() for k, v in a.network.state_dict().items()}
        losses = a.imitate(epochs=1, batch_size=TRAIN_BATCH, traces_dir=one, seed=1)
        after = a.network.state_dict()
        runs[fused] = (losses, {k: after[k] - before[k] for k in after})
    (lf, df), (lu, du) = runs[True], runs[False]
    check(len(lf) == len(lu) == 1, "one imitation step on the cut trace")
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(lf[0], lu[0]))
    buffers = [k for k in du if "running" in k]
    params = [k for k in du if "running" not in k and not k.startswith("old_policy.")]
    r = dict(loss=loss_rel, buffer=_rel_l2(df, du, buffers), param=_rel_l2(df, du, params),
             losses_fused=lf[0], losses_unfused=lu[0])
    print(f"  imitate, one step fused vs unfused: losses (policy, value) {lf[0]} / {lu[0]}; "
          f"relative differences: loss {r['loss']:.3e}, BatchNorm buffer changes "
          f"{r['buffer']:.3e}, parameter changes {r['param']:.3e} (not held: float32 Adam)",
          flush=True)
    for k, bar in IMITATE_BARS.items():
        check(r[k] <= bar, f"imitate fused vs unfused: {k} differs by {r[k]:.3e} > {bar:.0e}")

    a = agent(True)
    a.imitate(epochs=1, batch_size=TRAIN_BATCH, traces_dir=one, seed=1)     # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    losses = a.imitate(epochs=1, batch_size=TRAIN_BATCH, traces_dir=tdir, seed=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _counts()
    check(all(math.isfinite(x) for pair in losses for x in pair), "imitation losses finite")
    steps = len(losses)
    check(counts["shuffle_unit_train"] == steps * UNITS_PER_PASS
          and counts["shuffle_unit_train_bwd"] == steps * UNITS_PER_PASS,
          f"unit kernel launches in imitation: {counts}")
    # the expert traces take their log-probs from a predict-like pass
    check(counts["shuffle_unit_infer"] == steps * UNITS_PER_PASS, f"inference launches {counts}")
    ms = seconds / steps * 1e3
    print(f"  imitate, fused units: {steps} updates at batch {TRAIN_BATCH} in {seconds:.3f} s, "
          f"{ms:.2f} ms per update (trace loading included); launches per update: forward "
          f"{counts['shuffle_unit_train'] / steps:.0f}, backward "
          f"{counts['shuffle_unit_train_bwd'] / steps:.0f}, inference "
          f"{counts['shuffle_unit_infer'] / steps:.0f}", flush=True)
    r.update(collect_s=collect_s, updates=steps, ms_per_update=ms, launches=counts,
             collect_launches=collect_counts)
    return r


def train_expert_fused_phase(root: str) -> tuple:
    """learn with expert_rollout=True and ratio_clamp on stage s1's geometry
    (32 worlds x 128 steps, batch 64, fused units) for CUT_UPDATES updates
    from a fresh seeded network: the losses finite, the rollout's
    similarity >= EXPERT_SIMILARITY; the expert rollout steps per step
    (env.step, whose physics is the plain version: no physics-kernel
    launch), one render and one predict per step.  Returns (stage,
    summary)."""
    from carla_driving_rl_agent_torch.curriculum import stages
    stage = stages.stage_s1(episodes=CUT_UPDATES, timesteps=512, batch_size=TRAIN_BATCH,
                            num_envs=TRAIN_WORLDS, rollout_block=True, fused_units=True,
                            expert_rollout=True, ratio_clamp=4.0, weights_dir=root,
                            env_overrides=dict(fused_step=True, device="cuda"))
    stage.init()
    summary = _train_epoch(stage, CUT_UPDATES, "train_expert_fused", 0,
                           frames_per_update=TRAIN_STEPS)
    sims = [m["similarity_mean"] for m in summary["history"]]
    print(f"  expert rollout similarity per update: {sims}", flush=True)
    for sim in sims:
        check(sim >= EXPERT_SIMILARITY, f"the expert rollout's similarity {sim:.4f}")
    summary["similarity"] = sims
    return stage, summary


BENCH_TASKS, BENCH_TRIALS, BENCH_STEPS = ("empty", "regular"), 25, 1024


def _route_lengths_numpy(world, routes) -> np.ndarray:
    """Each world's route length from its waypoint, from the polyline on the
    CPU in float64, world by world: the recompute that CARLABenchmark's
    route_length_m is held against."""
    xyy, length = routes.xyy.cpu().numpy().astype(np.float64), routes.length.cpu().numpy()
    out = []
    for t, r, w in zip(*(x.cpu().numpy() for x in (world.town_id, world.route_id,
                                                   world.wp_idx))):
        xy = xyy[t, r, :length[t, r], :2]
        seg = np.sqrt(((xy[1:] - xy[:-1]) ** 2).sum(-1))
        out.append(seg[w:].sum())
    return np.array(out)


def benchmark_phase(agent) -> dict:
    """CARLABenchmark of `agent` (safe-s5 with fused units), preset test
    (Town02, the test weathers), tasks BENCH_TASKS, BENCH_TRIALS trials of
    BENCH_STEPS steps: the success, collision and timeout rates, env-steps/s
    and the Town02 env's first build; the route lengths within 1e-4 of a
    float64 recompute on the CPU from the same spawn states, the budgets
    nocrash_success's of those."""
    from carla_driving_rl_agent_torch.envs.wrappers import CARLABenchmark, nocrash_success
    out = {}
    for task in BENCH_TASKS:
        bench = CARLABenchmark(agent, task=task, preset="test")
        t0 = time.perf_counter()
        bench._build_env(BENCH_STEPS)
        build_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        r = bench.run(timesteps=BENCH_STEPS, trials=BENCH_TRIALS, initial_seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        env = bench.last_env
        env.seed(SEED)
        states, _ = env.reset_batch(BENCH_TRIALS)
        want = _route_lengths_numpy(states.world, env.routes)
        got = np.array(r["route_length_m"])
        err = float(np.max(np.abs(got - want) / np.maximum(want, 1.0)))
        check(err <= 1e-4, f"benchmark {task}: route lengths vs the CPU recompute {err:.3e}")
        budget = nocrash_success(0, False, False, want)[2]
        check(np.allclose(r["budget_steps"], budget, rtol=1e-4), f"benchmark {task}: budgets")
        check(counts["render_planes"] == BENCH_STEPS + 1, f"benchmark render launches {counts}")
        check(counts["shuffle_unit_infer"] == BENCH_STEPS * UNITS_PER_PASS,
              f"benchmark inference launches {counts}")
        sps = BENCH_TRIALS * BENCH_STEPS / seconds
        print(f"  benchmark {task} (Town02, {env.params.num_vehicles} vehicles, "
              f"{env.params.num_pedestrians} walkers): success {r['success_rate']:.4f}, "
              f"collision {r['collision_rate']:.4f}, timeout {r['timeout_rate']:.4f}, mean steps "
              f"{r['avg_timesteps']:.1f}, route {r['avg_route_length_m']:.1f} m, budget "
              f"{r['avg_budget_steps']:.1f} steps; {sps:.1f} env-steps/s ({seconds:.3f} s, the "
              f"env's build included); Town02 env build {build_s:.3f} s; route lengths vs the "
              f"CPU recompute {err:.3e}", flush=True)
        out[task] = dict(r, seconds=seconds, env_steps_per_s=sps, build_s=build_s,
                         route_err=err, launches=counts)
    return out


RECORD_STEPS = 64


def record_phase(root: str) -> dict:
    """main.run_record of safe-s5 for 1 trial of RECORD_STEPS steps into
    `root`: stage s5's Town03 with regular traffic; frames.npz (t, 90, 360,
    3) u8, the JAX package's shape, and info.json with reward and
    timestep."""
    from carla_driving_rl_agent_torch import main as cli
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    paths = cli.run_record(WEIGHTS, timesteps=RECORD_STEPS, trials=1, record_dir=root,
                           device="cuda")
    seconds = time.perf_counter() - t0
    counts = _counts()
    check(len(paths) == 1 and paths[0].endswith(os.path.join("Town03", "demo", "1")),
          f"record paths {paths}")
    frames = np.load(os.path.join(paths[0], "frames.npz"))["frames"]
    with open(os.path.join(paths[0], "info.json")) as f:
        info = json.load(f)
    check(set(info) == {"reward", "timestep"}, f"info.json {info}")
    check(frames.dtype == np.uint8 and frames.shape == (info["timestep"], 90, 360, 3),
          f"frames {frames.dtype} {frames.shape}")
    print(f"  record: {paths[0][len(root):]}: frames {frames.shape} {frames.dtype}, info "
          f"{info}, {seconds:.3f} s (stage build and load included); launches: render "
          f"{counts['render_planes']}", flush=True)
    return dict(frames=list(frames.shape), info=info, seconds=seconds, launches=counts)


def s4_towns_phase() -> dict:
    """The NPC block path of stage s4 over random towns (Town01 + Town02,
    50 vehicles, 50 walkers, the training weathers) on the card against the
    plain CPU port on the same draws for 3 blocks (agree_block_traffic), 16
    worlds restarting mid-block, some into the other town."""
    from carla_driving_rl_agent_torch.curriculum import stages
    from carla_driving_rl_agent_torch.envs.weather import TRAIN_WEATHERS
    t0 = time.perf_counter()
    env = stages.build_env(town="Town01", random_towns=["Town01", "Town02"],
                           random_weathers=list(TRAIN_WEATHERS),
                           spawn=dict(vehicles=50, pedestrians=50), device="cuda")
    build_s = time.perf_counter() - t0
    _zero_counts()
    r = agree_block_traffic(env, n=16, what="stage s4's random towns (Town01 + Town02)")
    check(r["switched"] > 0, "no world restarted into another town")
    r.update(build_s=build_s, launches=_counts())
    print(f"  Town01 + Town02 env build {build_s:.3f} s", flush=True)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the run's numbers to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="at the end, break an evaluation window and one training "
                         "update down by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from carla_driving_rl_agent_torch import native
    from carla_driving_rl_agent_torch.curriculum import stages
    from carla_driving_rl_agent_torch.envs.weather import TRAIN_WEATHERS
    from carla_driving_rl_agent_torch.ops import physics as P
    from carla_driving_rl_agent_torch.ops import render as R
    from carla_driving_rl_agent_torch.ops import shuffle_unit as SU
    from carla_driving_rl_agent_torch.utils.build import build_parallel

    summary = dict(phases={})
    kernels: dict = {}
    with Phase("device") as p:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        print(f"  {kind} x {count}; {smi}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)
    summary["phases"]["device"] = p.seconds
    with Phase("build") as p:
        build_parallel([R.build_kernel, P.build_kernel, SU.build_kernel, native._lib,
                        _render_check_lib])
    summary["phases"]["build"] = p.seconds
    with Phase("setup") as p:
        agent = stages.build_eval_agent("test", TOWN, STEPS, WEIGHTS, device="cuda")
        traffic_agents = {lvl: stages.build_eval_agent("test", TOWN, STEPS, WEIGHTS,
                                                       device="cuda", traffic=lvl)
                          for lvl in TRAFFIC_LEVELS}
        # the envs of stages s2 (50 walkers) and s3 (50 vehicles, 50 walkers,
        # the training weathers), as their factories build them
        s2_env = stages.build_env(town=TOWN, spawn=dict(vehicles=0, pedestrians=50),
                                  device="cuda")
        s3_env = stages.build_env(town=TOWN, random_weathers=list(TRAIN_WEATHERS),
                                  spawn=dict(vehicles=50, pedestrians=50), device="cuda")
    summary["phases"]["setup"] = p.seconds
    with Phase("kernel") as p:
        summary["kernel"] = kernel_phase(agent.env, kernels)
        summary["kernel"]["traffic"] = traffic_render_check(traffic_agents["dense"].env)
        kernels["render_planes"]["traffic_62_worlds"] = summary["kernel"]["traffic"]
        summary["kernel"]["s2"] = traffic_render_check(s2_env, n=TRAIN_WORLDS,
                                                       steps=S2_RENDER_STEPS,
                                                       label="stage s2's walkers")
        check(summary["kernel"]["s2"]["n_actors"] == 5, "stage s2's pack has 5 actor rows")
        kernels["render_planes"]["s2_32_worlds"] = summary["kernel"]["s2"]
    summary["phases"]["kernel"] = p.seconds
    with Phase("agree") as p:
        agree_phase(agent)
        agree_traffic(traffic_agents["dense"].env)
        agree_block_traffic(s3_env)
    summary["phases"]["agree"] = p.seconds
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir, Phase("slice") as p:
        summary["slice"] = slice_phase(agent, out_dir)
        launches["evaluate"] = summary["slice"].pop("launches")
    summary["phases"]["slice"] = p.seconds
    with tempfile.TemporaryDirectory() as out_dir, Phase("slice_traffic") as p:
        for lvl in TRAFFIC_LEVELS:
            summary[f"slice_{lvl}"] = slice_phase(traffic_agents[lvl], out_dir, traffic=lvl)
            launches[f"evaluate_{lvl}"] = summary[f"slice_{lvl}"].pop("launches")
        print("  evaluation env-steps/s, traffic no / regular / dense: " + " / ".join(
            f"{summary[k]['env_steps_per_s']:.1f}"
            for k in ("slice", "slice_regular", "slice_dense")), flush=True)
    summary["phases"]["slice_traffic"] = p.seconds
    with Phase("physics") as p:
        summary["physics"] = physics_phase(agent.env, kernels)
    summary["phases"]["physics"] = p.seconds
    with Phase("env") as p:
        summary["env"] = env_phase()
        launches["env"] = summary["env"].pop("launches")
    summary["phases"]["env"] = p.seconds
    with tempfile.TemporaryDirectory() as out_dir, Phase("train") as p:
        stage, summary["train"] = train_phase(out_dir)
        launches["train"] = summary["train"].pop("launches")
    summary["phases"]["train"] = p.seconds
    with Phase("train_agree") as p:
        summary["train_agree"] = train_agree_phase(stage.env)
    summary["phases"]["train_agree"] = p.seconds
    with Phase("unit") as p:
        summary["unit"] = unit_phase(kernels)
    summary["phases"]["unit"] = p.seconds
    with tempfile.TemporaryDirectory() as out_dir, Phase("slice_fused") as p:
        fused_agent = stages.build_eval_agent("test", TOWN, STEPS, WEIGHTS, device="cuda",
                                              fused_units=True)
        summary["slice_fused"] = slice_phase(fused_agent, out_dir, unfused=summary["slice"])
        launches["evaluate_fused"] = summary["slice_fused"].pop("launches")
        on, off = (summary[k]["env_steps_per_s"] for k in ("slice_fused", "slice"))
        print(f"  evaluation env-steps/s, fused_units on / off: {on:.1f} / {off:.1f} "
              f"({on / off:.3f})", flush=True)
    summary["phases"]["slice_fused"] = p.seconds
    with tempfile.TemporaryDirectory() as out_dir, Phase("slice_traffic_fused") as p:
        fused_dense = stages.build_eval_agent("test", TOWN, STEPS, WEIGHTS, device="cuda",
                                              fused_units=True, traffic="dense")
        summary["slice_dense_fused"] = slice_phase(fused_dense, out_dir,
                                                   unfused=summary["slice_dense"],
                                                   traffic="dense")
        launches["evaluate_dense_fused"] = summary["slice_dense_fused"].pop("launches")
        on, off = (summary[k]["env_steps_per_s"] for k in ("slice_dense_fused", "slice_dense"))
        print(f"  dense-traffic evaluation env-steps/s, fused_units on / off: {on:.1f} / "
              f"{off:.1f} ({on / off:.3f})", flush=True)
    summary["phases"]["slice_traffic_fused"] = p.seconds
    with tempfile.TemporaryDirectory() as out_dir, Phase("train_fused") as p:
        stage_fused, summary["train_fused"] = train_phase(out_dir, fused_units=True)
        launches["train_fused"] = summary["train_fused"].pop("launches")
        print("  seconds per update, fused_units on / off: " + ", ".join(
            f"{k} {summary['train_fused']['parts_mean_s'][k]:.4f} / "
            f"{summary['train']['parts_mean_s'][k]:.4f}" for k in summary["train"]["parts_mean_s"])
            + f"; train env-steps/s {summary['train_fused']['env_steps_per_s']:.1f} / "
              f"{summary['train']['env_steps_per_s']:.1f} ("
              f"{summary['train_fused']['env_steps_per_s'] / summary['train']['env_steps_per_s']:.3f})",
            flush=True)
    summary["phases"]["train_fused"] = p.seconds
    with Phase("train_agree_fused") as p:
        summary["train_agree_fused"] = train_agree_phase(stage.env, fused_units=True)
    summary["phases"]["train_agree_fused"] = p.seconds
    # stages s2 and s3 in one temporary weights root, s3 handed s2's checkpoint
    stages_root = tempfile.TemporaryDirectory()
    with Phase("train_s2") as p:
        stage_refusals(stages_root.name)
        stage_s2, summary["train_s2"] = train_s2_phase(stages_root.name)
        launches["train_s2"] = summary["train_s2"].pop("launches")
    summary["phases"]["train_s2"] = p.seconds
    with Phase("train_s3_fused") as p:
        stage_s3, summary["train_s3_fused"] = train_s3_fused_phase(stages_root.name)
        launches["train_s3_fused"] = summary["train_s3_fused"].pop("launches")
    summary["phases"]["train_s3_fused"] = p.seconds
    # stages s4 and s5 in a root of their own, s4 handed the tracked
    # stage-s3 (the first root holds train_s3_fused's), s5 handed s4's
    late_root = tempfile.TemporaryDirectory()
    with Phase("train_s4") as p:
        stage_s4, summary["train_s4"] = train_s4_phase(late_root.name)
        launches["train_s4"] = summary["train_s4"].pop("launches")
    summary["phases"]["train_s4"] = p.seconds
    with Phase("augment_agree") as p:
        summary["augment_agree"] = augment_agree_phase(
            stage_s4, sum(summary["train_s4"]["parts_mean_s"].values()))
    summary["phases"]["augment_agree"] = p.seconds
    with Phase("train_s5_fused") as p:
        _, summary["train_s5_fused"] = train_s5_fused_phase(late_root.name)
        launches["train_s5_fused"] = summary["train_s5_fused"].pop("launches")
        trained = ("train", "train_fused", "train_s2", "train_s3_fused", "train_s4",
                   "train_s5_fused")
        print("  train env-steps/s, s1 unfused / s1 fused / s2 unfused / s3 fused / s4 unfused "
              "/ s5 fused: " + " / ".join(f"{summary[k]['env_steps_per_s']:.1f}"
                                          for k in trained), flush=True)
        for k in trained:
            print(f"  seconds per update, {k}: " + ", ".join(
                f"{part} {v:.4f}" for part, v in summary[k]["parts_mean_s"].items()),
                flush=True)
    summary["phases"]["train_s5_fused"] = p.seconds
    # the imitation and tooling path
    with Phase("expert") as p:
        summary["expert"] = expert_phase(s3_env)
        launches["expert"] = summary["expert"].pop("launches")
    summary["phases"]["expert"] = p.seconds
    with tempfile.TemporaryDirectory() as root, Phase("imitate") as p:
        summary["imitate"] = imitate_phase(root)
        launches["imitate_fused"] = summary["imitate"].pop("launches")
        launches["collect"] = summary["imitate"].pop("collect_launches")
    summary["phases"]["imitate"] = p.seconds
    with tempfile.TemporaryDirectory() as root, Phase("train_expert_fused") as p:
        _, summary["train_expert_fused"] = train_expert_fused_phase(root)
        launches["train_expert_fused"] = summary["train_expert_fused"].pop("launches")
        on, off = (summary[k]["env_steps_per_s"] for k in ("train_expert_fused", "train_fused"))
        print(f"  train env-steps/s, expert rollout (per step) / policy rollout (blocks), "
              f"fused units: {on:.1f} / {off:.1f}", flush=True)
    summary["phases"]["train_expert_fused"] = p.seconds
    with Phase("benchmark") as p:
        summary["benchmark"] = benchmark_phase(fused_agent)
        for task in BENCH_TASKS:
            launches[f"benchmark_{task}"] = summary["benchmark"][task].pop("launches")
    summary["phases"]["benchmark"] = p.seconds
    with tempfile.TemporaryDirectory() as root, Phase("record") as p:
        summary["record"] = record_phase(root)
        launches["record"] = summary["record"].pop("launches")
    summary["phases"]["record"] = p.seconds
    with Phase("s4_towns") as p:
        summary["s4_towns"] = s4_towns_phase()
        launches["s4_towns"] = summary["s4_towns"].pop("launches")
    summary["phases"]["s4_towns"] = p.seconds
    print(f"  phases: {sum(summary['phases'].values()):.1f} s", flush=True)
    if args.profile:
        with Phase("profile") as p:
            summary["profile"] = profile_phase(agent)
            summary["profile_fused"] = profile_phase(fused_agent)
            summary["profile_dense"] = profile_phase(traffic_agents["dense"])
            per_call = {k: kr["launches_per_call"] for k, kr in kernels.items()}
            summary["profile_train"] = profile_train_phase(stage.agent, per_call)
            summary["profile_train_fused"] = profile_train_phase(stage_fused.agent, per_call)
            summary["profile_train_s3_fused"] = profile_train_phase(stage_s3.agent, per_call)
        summary["phases"]["profile"] = p.seconds
    stages_root.cleanup()
    late_root.cleanup()

    for name, kr in kernels.items():
        # the unit kernels run on the training path with fused_units=True
        path = "train_fused" if name.startswith("shuffle_unit") else "train"
        kr["launches"] = launches[path][name]
        check(kr["launches"] > 0, f"{name} was not launched on the {path} path")
        kr["launches_by_path"] = {path: c[name] for path, c in launches.items()}
    # what each kernel costs a training update beyond its bound: launches per
    # update x (ms - bound_ms), the unit kernels summed over their maps
    excess = {}
    for name, kr in kernels.items():
        per_update = kr["launches"] / TRAIN_UPDATES
        if name.startswith("shuffle_unit"):
            n = UNIT_N["rollout" if name == "shuffle_unit_infer" else "train"]
            rows = [kr["by_shape"][f"{n}x{h}x{w}x{c}"] for h, w, c, _ in UNIT_MAPS]
            per_pass = sum(u * (t["ms"] - t["bound_ms"]) for (*_, u), t in zip(UNIT_MAPS, rows))
            excess[name] = per_update / UNITS_PER_PASS * per_pass / 1e3
        else:
            excess[name] = per_update * (kr["ms"] - kr["bound_ms"]) / 1e3
    print("  launches x (time - bound) per training update: " + ", ".join(
        f"{k} {v:.6f} s" for k, v in sorted(excess.items(), key=lambda kv: -kv[1])), flush=True)
    print("  device launches per wrapper call: " + ", ".join(
        f"{k} {kr['launches_per_call']}" for k, kr in kernels.items()), flush=True)
    summary.update(card=smi, kernels=kernels, excess_s_per_update=excess)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2, default=float)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: kr[k] for k in keys} for kr in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
