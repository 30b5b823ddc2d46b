"""What the benchmark loads: nothing whose top-level name (the part before
the first dot, compared whole) is jax, jaxlib, flax or
carla_driving_rl_agent_tpu, in its sources or in a run's process; and the
reference (portbench/reference) loads nothing of the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "carla_driving_rl_agent_tpu"}
PORT = "carla_driving_rl_agent_torch"


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in _sources():
        assert not (_imported(path) & FORBIDDEN), path


def test_reference_sources_import_no_port():
    for path in _sources("reference"):
        assert PORT not in _imported(path), path


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_port():
    loaded = _modules_after("import portbench.reference.checkpoint, portbench.reference.network, "
                            "portbench.reference.ppo, portbench.reference.precision, "
                            "portbench.reference.render, portbench.reference.traffic")
    assert PORT not in loaded and not (loaded & FORBIDDEN)


@pytest.mark.parametrize("workload", ["s5-eval-dense", "s1-train"])
def test_a_run_loads_no_jax(workload):
    """A whole run of the cell at a small size on the CPU (the look for a
    chip skipped), traced, then the modules its process holds."""
    small = dict(town="Town02", trials=2, steps=8, warmup_steps=4, capture_steps=2,
                 trace_from=2, trace_steps=4, worlds=2, rollout_steps=8, timesteps=64,
                 batch=4, warmup_rollout_steps=4)
    loaded = _modules_after(
        "from portbench.run import main\n"
        f"rc = main(['--workload', '{workload}', '--seed', '4000000001', '--seconds', '0', "
        f"'--trace', '1'], device='cpu', overrides={small!r})\n"
        "assert rc == 0, rc")
    assert PORT in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN
