"""The port's utilities against the JAX package on the CPU: Summary's JSONL
records (scalars and their _std, histogram quantiles, image routing, the
disabled and in-memory modes, the key filter), the FLOP counts at the s1
and TINY geometries, the five single-trajectory math helpers, the
device trace with a span, and the Python route planner's Town02 bank.

Tolerances: the records, FLOP counts and route banks exactly (the same
numpy host code); the math helpers 1e-6 relative + 1e-6 absolute (float32;
the JAX discount_cumsum is an associative scan, the port's a loop: the same
sums in another order).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from carla_driving_rl_agent_tpu.envs import route as jroute
from carla_driving_rl_agent_tpu.utils import flops as jflops
from carla_driving_rl_agent_tpu.utils import math as jm
from carla_driving_rl_agent_tpu.utils import summary as jsummary

from carla_driving_rl_agent_torch.envs import route as troute
from carla_driving_rl_agent_torch.envs import town as ttown
from carla_driving_rl_agent_torch.utils import flops as tflops
from carla_driving_rl_agent_torch.utils import math as tm
from carla_driving_rl_agent_torch.utils import profiling
from carla_driving_rl_agent_torch.utils import summary as tsummary
from torch_learner_common import one_thread  # noqa: F401


def _feed(summary, rng):
    """Two flushes of every kind of value the learner logs."""
    for step in range(2):
        summary.log(loss=float(rng.normal()), reward=rng.normal(0, 1, 5).astype(np.float32))
        summary.log(loss=float(rng.normal()), skipped=1.0)
        summary.log(**{"weight-dense": rng.normal(0, 1, (4, 3)), "bias-dense": rng.normal(0, 1, 3)})
        summary.log(image_obs=rng.uniform(0, 1, (2, 6, 5, 3)).astype(np.float32))
        summary.log(image_u8=rng.integers(0, 255, (4, 5, 1), dtype=np.uint8))
        summary.write_summaries()


def _records(d):
    with open(os.path.join(d, "events.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.mark.parametrize("keys", [None, ("loss", "image_obs", "weight-dense")])
def test_summary_records_match_jax(tmp_path, keys):
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    j = jsummary.Summary(name="run", log_dir=str(tmp_path / "j"), summary_keys=keys)
    t = tsummary.Summary(name="run", log_dir=str(tmp_path / "t"), summary_keys=keys)
    _feed(j, rngs[0])
    _feed(t, rngs[1])
    jr, tr = _records(j.dir), _records(t.dir)
    assert tr == jr and len(tr) == 2
    assert ("loss_std" in tr[0]) and ("weight-dense_hist" in tr[0]) and \
        (("reward" in tr[0]) == (keys is None))
    for rec in tr:
        for k, paths in rec.items():
            if k.endswith("_images"):
                for p in paths:
                    with open(os.path.join(t.dir, p), "rb") as a, \
                            open(os.path.join(j.dir, p), "rb") as b:
                        assert a.read() == b.read()


def test_summary_modes(tmp_path):
    for mode in (None, "log"):
        rngs = [np.random.default_rng(6), np.random.default_rng(6)]
        j = jsummary.Summary(mode=mode, log_dir=str(tmp_path))
        t = tsummary.Summary(mode=mode, log_dir=str(tmp_path))
        _feed(j, rngs[0])
        _feed(t, rngs[1])
        assert dict(t.history) == dict(j.history)
    assert not list(tmp_path.iterdir())          # neither mode writes
    stats, jstats = tsummary.IncrementalStatistics(), jsummary.IncrementalStatistics()
    for v in ([1.0, 2.0], 3.5, np.arange(4.0)):
        stats.update(v)
        jstats.update(v)
    assert stats.as_dict() == jstats.as_dict()


@pytest.mark.parametrize("geom", [
    dict(),                                                       # stage s1, full width
    dict(image_hw=(45, 180), g=0.5, last_channels=64, gru_image=32, gru_feat=8,
         dynamics_units=64, head_units=32, feature_units=8)])    # TINY_NET
def test_flops_match_jax(geom):
    assert tflops.carla_predict_flops(**geom) == jflops.carla_predict_flops(**geom)
    hw = geom.get("image_hw", (90, 360))
    kw = dict(g=geom.get("g", 1.0), last_channels=geom.get("last_channels", 768))
    assert tflops.shufflenet_v2_flops(*hw, **kw) == jflops.shufflenet_v2_flops(*hw, **kw)
    for opts in (dict(), dict(fused_update=True), dict(two_step=True)):
        assert tflops.train_chunk_flops(3, 128, 32, **opts, **geom) == \
            jflops.train_chunk_flops(3, 128, 32, **opts, **geom)
    assert tflops._mlp_flops(9, 16, 2) == jflops._mlp_flops(9, 16, 2)
    assert tflops._gru_flops(768, 256, 4) == jflops._gru_flops(768, 256, 4)


def test_math_helpers_match_jax(rng):
    r = rng.normal(0, 1, 33).astype(np.float32)
    v = rng.normal(0, 2, 33).astype(np.float32)
    a, b = rng.normal(0, 1, (6, 5)).astype(np.float32), rng.normal(0, 1, (6, 5)).astype(np.float32)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    pairs = [(tm.discount_cumsum(t(r), 0.97), jm.discount_cumsum(jnp.asarray(r), 0.97)),
             (tm.rewards_to_go(t(r), 0.9), jm.rewards_to_go(jnp.asarray(r), 0.9)),
             (tm.normalize_tensor(t(v)), jm.normalize_tensor(jnp.asarray(v))),
             (tm.cosine_similarity(t(a), t(b)), jm.cosine_similarity(jnp.asarray(a),
                                                                    jnp.asarray(b))),
             (tm.cosine_similarity(t(a), t(b), dim=0), jm.cosine_similarity(
                 jnp.asarray(a), jnp.asarray(b), axis=0))]
    for lam, norm in ((0.95, False), (0.0, False), (0.9, True)):
        pairs.append((tm.gae(t(r), t(v), 0.99, lam, norm),
                      jm.gae(jnp.asarray(r), jnp.asarray(v), 0.99, lam, norm)))
    for x, y in pairs:
        assert tuple(x.shape) == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)


def test_profiling_helpers(tmp_path):
    """A span inside device_trace lands in the Chrome trace file on the
    program spans' track, on the trace's time axis around the operators it
    held, and is no longer kept."""
    with profiling.device_trace(str(tmp_path), name="t") as prof:
        with profiling.span("region"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert profiling.span("off") is profiling.span("again") and profiling.drain() == []
    assert os.path.exists(prof.trace_path)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    (region,) = [e for e in events if e.get("name") == "region"]
    assert region["pid"] == profiling.TRACK and region["ph"] == "X"
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert region["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= region["ts"] + region["dur"]


def test_python_route_bank_matches_jax():
    """The Python planner on Town02 (both planners fed the port's town, so
    that only the planner differs) against the JAX package's Python
    planner: every array of the bank, and the road-option one-hot."""
    town = ttown.get_town("Town02")
    kw = dict(num_routes=24, max_len=256, seed=7)
    tb = troute.build_route_bank(town, use_native=False, **kw)
    jb = jroute.build_route_bank(town, use_native=False, **kw)
    for f in ("xy", "yaw", "option", "length", "origin_spawn"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    assert tb.num_routes == jb.num_routes == 24 and tb.max_len == jb.max_len
    assert (tb.length >= 40).all()
    np.testing.assert_array_equal(troute.road_option_one_hot(tb.option[:2]),
                                  jroute.road_option_one_hot(jb.option[:2]))
    origins = [1, 3, 5]
    tb2 = troute.build_route_bank(town, use_native=False, origin_spawns=origins, **kw)
    jb2 = jroute.build_route_bank(town, use_native=False, origin_spawns=origins, **kw)
    np.testing.assert_array_equal(tb2.xy, jb2.xy)
    assert set(tb2.origin_spawn.tolist()) <= set(origins)


def test_utils_package_names_match_jax():
    """The port's `utils` package exposes the five names of the JAX
    package's: the math and activations modules, DynamicParameter and the
    optimizer registry with the same keys; one optimizer built by name
    takes a step."""
    import carla_driving_rl_agent_tpu.utils as jutils
    from carla_driving_rl_agent_torch.utils import (OPTIMIZERS, DynamicParameter,
                                                    activations, get_optimizer_by_name, math)
    assert math is tm and callable(activations.leaky_relu6)
    assert sorted(OPTIMIZERS) == sorted(jutils.OPTIMIZERS)
    assert DynamicParameter.create(0.5)() == 0.5
    p = torch.nn.Parameter(torch.ones(3))
    opt = get_optimizer_by_name("adam", [p], 1e-2)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.all(p < 1.0)
