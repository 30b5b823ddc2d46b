"""portbench/spans.py: the attribution of a profiled sub-window's launches
and idle time to the program's spans, on synthetic kineto-like events; the
span metrics; and a traced window of each cell at a small size on the CPU
with the program's spans recorded."""

from collections import namedtuple

import pytest
import torch

from portbench import spans as S
from portbench import trace

Span = namedtuple("Span", "id name parent start_ns end_ns")
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    """What the readers call of a kineto event."""

    def __init__(self, name, device, start, dur, corr=0):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


# a window 0..1000 ns; span A 100..600 holds B 200..400; C 700..900
SPANS = [Span(1, "B", 0, 200, 400), Span(0, "A", -1, 100, 600), Span(2, "C", -1, 700, 900)]


def _events():
    def launch(corr, t):
        return Event("cudaLaunchKernel", CPU, t, 5, corr)

    def kernel(corr, t0, t1, name="k"):
        return Event(name, CUDA, t0, t1 - t0, corr)
    return [
        Event(trace.WINDOW, CPU, 0, 1000, 90),
        launch(1, 250), kernel(1, 300, 320),           # from B
        launch(2, 150), kernel(2, 500, 510),           # from A, outside B
        launch(3, 650), kernel(3, 660, 700),           # from no span
        launch(4, 750), kernel(4, 800, 850),           # from C
        kernel(6, 860, 870),                           # its runtime call not kept
        Event("Memcpy HtoD", CUDA, 100, 30, 5),         # busy, not a launch
        Event(trace.PREFIX + "x", CUDA, 0, 1000, 0),    # a range's projection
        # an operator whose own id equals a kernel's correlation id, at a
        # time no span holds: it must not stand in for the runtime call
        Event("aten::mm", CPU, 950, 10, 4),
    ]


def test_kernels_are_attributed_by_correlation_id_and_host_time():
    att = S.attribute(_events(), SPANS)
    assert att["launches"] == {"A/B": 1, "A": 1, "C": 1, S.NONE: 2}


def test_launches_add_up_to_reduce():
    events = _events()
    att = S.attribute(events, SPANS)
    assert sum(att["launches"].values()) == trace.reduce(events)["launches"] == 5


def test_idle_adds_up_to_the_window_less_busy():
    events = _events()
    att = S.attribute(events, SPANS)
    red = trace.reduce(events)
    assert sum(att["idle_s"].values()) == pytest.approx(red["window_s"] - red["busy_s"],
                                                        rel=1e-12)
    # busy 100..130, 300..320, 500..510, 660..700, 800..850, 860..870
    assert att["idle_s"]["A/B"] == pytest.approx(180e-9)      # 200..300, 320..400
    assert att["idle_s"]["A"] == pytest.approx(260e-9)        # 130..200, 400..500, 510..600
    assert att["idle_s"]["C"] == pytest.approx(140e-9)        # 700..800, 850..860, 870..900
    assert att["idle_s"][S.NONE] == pytest.approx(260e-9)     # 0..100, 600..660, 900..1000
    breakdown = S.idle_by_span(att)
    assert [k for k, _ in breakdown["spans"]] == ["A", "A/B", "C"]
    assert breakdown["unattributed_s"] == pytest.approx(260e-9)


def test_a_span_inside_a_span_wins():
    segs = S.segments(SPANS)
    assert [(s, e, p) for s, e, p in segs] == [
        (100, 200, "A"), (200, 400, "A/B"), (400, 600, "A"), (700, 900, "C")]


def test_span_metrics():
    att = dict(launches={"update/update.policy/minibatch.policy_step/step.backward": 30,
                         "update/update.policy/minibatch.policy_step": 10,
                         "update/update.value/minibatch.value_step/step.apply": 20,
                         "update/update.policy/minibatch.gather": 7,
                         "eval.step/env.step/world.step/npc.tick": 12,
                         "eval.step/env.step/world.reset/npc.spawn": 4, S.NONE: 3})
    steps = [Span(i, n, -1, 0, 1) for i, n in enumerate(
        ("minibatch.policy_step", "minibatch.value_step", "minibatch.gather"))]
    assert S.launches_per_minibatch(att, steps) == 30.0
    assert S.npc_launches_per_step(att, 4) == 4.0
    unit = []
    for k in range(512):           # eval.step k lasts k + 1 ms, its NPC spans 1 ms each
        t = k * 10 ** 9
        unit += [Span(3 * k, "eval.step", -1, t, t + (k + 1) * 10 ** 6),
                 Span(3 * k + 1, "npc.tick", 3 * k, t, t + 10 ** 6),
                 Span(3 * k + 2, "npc.spawn", 3 * k, t, t + 10 ** 6)]
    assert S.npc_ms([unit]) == pytest.approx(2.0)
    # nearest rank: the 487th of 512, 25 beyond it
    assert S.eval_step_p95_ms([unit]) == pytest.approx(487.0)
    assert S.eval_step_p95_ms([]) is None and S.npc_ms([[]]) is None
    cost = S.span_ns(1000)
    assert set(cost) == {"loop", "off", "on"} and all(v > 0 for v in cost.values())


SMALL = dict(town="Town02", trials=2, steps=8, warmup_steps=4, capture_steps=2, trace_from=2,
             trace_steps=4, worlds=4, rollout_steps=8, timesteps=64, batch=8,
             warmup_rollout_steps=4)


@pytest.mark.parametrize("workload", ["s5-eval-dense", "s1-train"])
def test_a_traced_window_with_spans_on_the_cpu(workload):
    """The cell's window at a small size on the CPU, traced with the
    program's spans on: every span sits in a unit, the idle time (all of the
    window: no kernel runs) is held by spans or counted apart, and the span
    metrics of the cell are read."""
    import os
    rec = S.Recorded(workload, 4100000007, torch.device("cpu"),
                     os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
                     overrides=SMALL)
    line = S.traced_line(rec, workload, 0.0)
    sums = line["sums"]
    assert sums["launches"] == sums["launches_attributed"] + sums["launches_unattributed"] == 0
    assert sums["idle_held_s"] + sums["idle_unheld_s"] == pytest.approx(sums["idle_s"])
    assert sums["idle_held_s"] > 0.95 * sums["idle_s"]
    if workload == "s1-train":
        assert line["span_counts"]["minibatch.policy_step"] == 4 * 8 // 8
        assert "launches_per_minibatch.train" in line["metrics"]
    else:
        assert line["span_counts"]["eval.step"] >= SMALL["trace_steps"]
        assert line["metrics"]["npc_ms.eval"] > 0.0
        assert line["metrics"]["eval_step_p95_ms"] > 0.0
        assert line["eval_steps_timed"] == SMALL["steps"]
