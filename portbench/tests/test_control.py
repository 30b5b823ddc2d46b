"""The control on the card, at each cell's own size, on three seeds: the
reference computed with TF32, put in the program's place, comes out as not
correct by the cell's own limits (run.judge), where the program comes out
correct.  Each cell takes one set-up and three short windows, one
evaluation or one update each (`python -m portbench.control` makes the
same readings on a dozen seeds: PERF.md)."""

import json
import os

import pytest

from portbench import control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEEDS = (4200000001, 4200000002, 4200000003)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s1-train", "s5-eval-dense", "s5-eval-none"])
def test_control_fails(workload, cuda_device, monkeypatch):
    monkeypatch.chdir(ROOT)
    lines = list(control.readings(workload, SEEDS, ("program", "tf32"), cuda_device, ROOT))
    print("\n".join(json.dumps(line) for line in lines))
    verdicts = {(r["seed"], r["candidate"]): r["correct"] for r in lines[1:]}
    assert len(verdicts) == 2 * len(SEEDS)
    for (seed, cand), correct in verdicts.items():
        assert correct == (cand == "program"), (seed, cand)
