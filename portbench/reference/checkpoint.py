"""The shipped flax checkpoints (params.msgpack, batch_stats.msgpack), read
without flax or msgpack into the parameter dict of reference/network.py.

A flax checkpoint is a msgpack map of maps whose leaves are numpy arrays
encoded as msgpack extension type 1, whose payload is itself msgpack of
(shape, dtype name, raw C-order bytes).  The tree maps onto the network's
names: Dense kernels (in, out) become weights (out, in), conv kernels HWIO
become OIHW, BatchNorm scale/bias/mean/var become
weight/bias/running_mean/running_var; old_policy reads the policy's
statistics.  A frozen copy of the decoder the port carries, so that the
reference reads the raw files itself.
"""

from __future__ import annotations

import os
import struct
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xDC: ">H", 0xDD: ">I",                  # array
                 0xDE: ">H", 0xDF: ">I",                  # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode()
            if b in (0xDC, 0xDD):
                return [self.obj() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(self.unpack(">b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self.unpack(">b"), fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def _ext(self, code: int, n: int):
        payload = self.take(n)
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, buf = _Reader(payload).obj()
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a flax msgpack checkpoint file."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"{path}: {len(data) - r.pos} trailing bytes")
    return out


def _leaves(tree, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """The CARLANetwork state_dict of a JAX parameter tree (components
    dynamics, policy, old_policy, value) and batch-statistics tree
    (dynamics, policy, value; old_policy reads the policy statistics).
    Takes a checkpoint read by read_flax_msgpack or the trees that the JAX
    package's CARLANetwork.init returns (any mapping of array-likes)."""
    sd: Dict[str, torch.Tensor] = {}
    for comp in ("dynamics", "policy", "old_policy", "value"):
        for path, arr in _leaves(params[comp]):
            mod, leaf = ".".join((comp,) + path[:-1]), path[-1]
            arr = np.asarray(arr)
            if leaf == "kernel" and arr.ndim == 4:
                sd[f"{mod}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
            elif leaf == "kernel":
                sd[f"{mod}.weight"] = _tensor(arr.T)
            elif leaf == "scale":
                sd[f"{mod}.weight"] = _tensor(arr)
            elif leaf == "bias":
                sd[f"{mod}.bias"] = _tensor(arr)
            else:
                raise KeyError(f"unexpected parameter {comp}/{'/'.join(path)}")
        stats_comp = "policy" if comp == "old_policy" else comp
        for path, arr in _leaves(batch_stats[stats_comp]):
            mod = ".".join((comp,) + path[:-1])
            name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
            sd[f"{mod}.{name}"] = _tensor(arr)
    return sd


def load(path: str, device) -> Dict[str, torch.Tensor]:
    """The parameter dict of the checkpoint directory `path`, on `device`,
    restored as the agent restores a checkpoint in full: the old policy, which
    the predict samples from, becomes a copy of the policy (the checkpoint
    keeps the old policy of one minibatch before)."""
    sd = params_from_jax(read_flax_msgpack(os.path.join(path, "params.msgpack")),
                         read_flax_msgpack(os.path.join(path, "batch_stats.msgpack")))
    for k in list(sd):
        if k.startswith("old_policy."):
            sd[k] = sd["policy." + k[len("old_policy."):]].clone()
    return {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
