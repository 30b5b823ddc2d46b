"""What the drivers share: the seeds drawn from --seed, copies of tensors
that the timed path handed on, the relative gaps that `correct` compares,
and the unit calls of a traced sub-window."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch


def seeds(seed: int, n: int) -> List[int]:
    """`n` 31-bit seeds drawn from --seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)), spawn_key=(1 if seed < 0 else 0,))
    return [int(x) for x in np.random.default_rng(ss).integers(0, 2 ** 31 - 1, size=n)]


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(abs(int(seed)),
                                                        spawn_key=(2 + stream,)))


def out_dir(root: str, name: str) -> str:
    """A directory of the checkout's git-ignored build/ tree for what a run
    writes."""
    path = os.path.join(root, "build", "portbench", name)
    os.makedirs(path, exist_ok=True)
    return path


def copy(x):
    """A copy of a tensor, or of the tensors of a dict, list, tuple or
    NamedTuple, made when the timed path hands them on."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: copy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[copy(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(copy(v) for v in x)
    return x


def as64(x):
    """`x` with every floating tensor (of a dict, list or tuple too) cast to
    float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: as64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as64(v) for v in x)
    return x


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|."""
    got, ref = got.double(), ref.double()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / max(scale, 1e-30)


def worst_leaf(got: Dict[str, float], ref: Dict[str, float],
               keep: Optional[List[str]] = None) -> tuple:
    """The largest gap between the port's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; with the leaf it was found in."""
    names = keep if keep is not None else sorted(ref)
    median = float(np.median([ref[k] for k in names]))
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


class UnitCalls:
    """The fused ShuffleNet units' calls while a sub-window is traced: a
    forward hook on each stride-1 unit records (kind, frames, h, w, c); a
    training-mode call is a forward and, later, its backward."""

    def __init__(self, network: torch.nn.Module, tracer):
        self.calls: List[tuple] = []
        self.tracer = tracer
        for m in network.modules():
            if type(m).__name__ == "ShuffleUnit" and getattr(m, "fused", False):
                m.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        if self.tracer.recording:
            n, c, h, w = args[0].shape
            self.calls.append(("fwd" if module.training else "infer", n, h, w, c))

    def bound_s(self) -> float:
        from portbench.yardstick import unit_bound_s
        total = 0.0
        for kind, n, h, w, c in self.calls:
            total += unit_bound_s(kind, n, h, w, c)
            if kind == "fwd":
                total += unit_bound_s("bwd", n, h, w, c)
        return total


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
