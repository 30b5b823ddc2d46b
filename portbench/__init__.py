"""The benchmark of the PyTorch and CUDA port (carla_driving_rl_agent_torch)
on one NVIDIA H100.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root of the checkout names the cells.  A cell is a
configuration (portbench/configs/<config>.json) under a traffic mix
(portbench/workloads/<traffic>.json, whose `driver` names
portbench/drivers/<driver>.py); each per-layer metric is read by
portbench/metrics/<metric>.py.  The harness finds every one of them by the
name in BENCHMARK.json, so a cell, a configuration or a metric is added as
new files.  portbench/reference/ holds the plain PyTorch reference that
decides `correct`; it imports nothing of the port.
"""
