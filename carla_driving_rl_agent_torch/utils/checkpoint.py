"""Checkpoints: the port's own (torch.save), and the JAX package's flax
msgpack read without flax or msgpack.

The port saves a directory with network.pt (the network's state_dict),
optimizers.pt (the three optimizer states, {group: state_dict}; with
CARLAgentConfig.two_step_split_adam the dynamics entry is the list of the
two phases' states, as the JAX package's opt_state["dynamics"] becomes a
pair) and config.json (schedule steps, update step, network spec);
`load_agent` reads that or, where only the JAX package's params.msgpack
and batch_stats.msgpack are there, converts those.

The JAX package writes each component with flax.serialization.to_bytes:
a msgpack map of maps whose leaves are numpy arrays encoded as msgpack
extension type 1, whose payload is itself msgpack of (shape, dtype name,
raw C-order bytes).  `read_flax_msgpack` decodes that subset of msgpack;
`params_from_jax` maps the parameter and batch-statistics trees onto the
`state_dict` of models.carla_network.CARLANetwork:
  * Dense kernels (in, out) -> Linear weights (out, in);
  * Conv kernels HWIO -> OIHW;
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * GRUCell ir/iz/in/hr/hz/hn -> the port's FlaxGRUCell Linears of the
    same names.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from collections.abc import Mapping
from typing import Any, Dict, Optional, Tuple

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


def ppo_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The models.networks.PPONetwork state_dict of the JAX package's
    PPONetwork parameter tree (components policy, old_policy, value):
    Dense kernels (in, out) -> Linear weights (out, in), LayerNorm
    scale/bias -> weight/bias, the Gaussian head's log_std as it is."""
    sd: Dict[str, torch.Tensor] = {}
    for comp in ("policy", "old_policy", "value"):
        for path, arr in _leaves(params[comp]):
            mod, leaf = ".".join((comp,) + path[:-1]), path[-1]
            arr = np.asarray(arr)
            if leaf == "kernel":
                sd[f"{mod}.weight"] = _tensor(arr.T)
            elif leaf == "scale":
                sd[f"{mod}.weight"] = _tensor(arr)
            elif leaf in ("bias", "log_std"):
                sd[f"{mod}.{leaf}"] = _tensor(arr)
            else:
                raise KeyError(f"unexpected parameter {comp}/{'/'.join(path)}")
    return sd


def refuse_tracked(path: str) -> None:
    """Raise if `path` lies under the checkout's tracked weights/ directory
    (the reference's checkpoints and records): the port writes under
    weights-torch/."""
    from carla_driving_rl_agent_torch import REPO_ROOT
    tracked = os.path.join(os.path.realpath(REPO_ROOT), "weights")
    if os.path.realpath(path).startswith(tracked + os.sep):
        raise ValueError(f"{path} is under the tracked weights/ directory; "
                         f"the port writes under weights-torch/")


def save_agent(base_path: str, network: Dict[str, torch.Tensor],
               optimizers: Optional[Dict[str, Any]] = None,
               config: Optional[dict] = None) -> None:
    refuse_tracked(base_path)
    os.makedirs(base_path, exist_ok=True)
    torch.save(network, os.path.join(base_path, "network.pt"))
    if optimizers is not None:
        torch.save(optimizers, os.path.join(base_path, "optimizers.pt"))
    if config is not None:
        with open(os.path.join(base_path, "config.json"), "w") as f:
            json.dump(config, f, indent=2)


def load_agent(base_path: str, device=None) -> Dict[str, Any]:
    """{network: state_dict, optimizers: {group: state} or None, config:
    dict} of the checkpoint at `base_path`: the port's network.pt, else the
    JAX package's msgpack files (no optimizer states then)."""
    out: Dict[str, Any] = dict(optimizers=None, config={})
    net_path = os.path.join(base_path, "network.pt")
    if os.path.exists(net_path):
        out["network"] = torch.load(net_path, map_location=device)
        opt_path = os.path.join(base_path, "optimizers.pt")
        if os.path.exists(opt_path):
            out["optimizers"] = torch.load(opt_path, map_location=device)
    elif os.path.exists(os.path.join(base_path, "params.msgpack")):
        out["network"] = params_from_jax(
            read_flax_msgpack(os.path.join(base_path, "params.msgpack")),
            read_flax_msgpack(os.path.join(base_path, "batch_stats.msgpack")))
    else:
        raise FileNotFoundError(f"no checkpoint under {base_path}")
    cfg_path = os.path.join(base_path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            out["config"] = json.load(f)
    return out


def optimizer_states(optimizers: Dict[str, Any]) -> Dict[str, Any]:
    """The optimizers.pt content of an agent's {group: optimizer}, where an
    optimizer may be a tuple (the split backbone states): a list of their
    state_dicts then."""
    return {g: ([o.state_dict() for o in opt] if isinstance(opt, tuple) else opt.state_dict())
            for g, opt in optimizers.items()}


def load_optimizer_states(optimizers: Dict[str, Any], states: Optional[Dict[str, Any]]) -> None:
    """Restore `optimizer_states`' content into an agent's optimizers.  A
    group whose saved layout does not fit (a split state into a single one
    or the reverse) keeps its fresh state, with a warning, as the JAX
    package's load_agent re-initialises a mismatched opt_state."""
    import warnings
    for g, state in (states or {}).items():
        opt = optimizers[g]
        if isinstance(opt, tuple) != isinstance(state, (list, tuple)) or (
                isinstance(opt, tuple) and len(opt) != len(state)):
            warnings.warn(f"the checkpoint's {g} optimizer state does not fit this agent's "
                          f"(split backbone states or not); it starts fresh")
            continue
        for o, st in (zip(opt, state) if isinstance(opt, tuple) else ((opt, state),)):
            o.load_state_dict(st)


def check_shapes(loaded: Dict[str, torch.Tensor], current: Dict[str, torch.Tensor],
                 path: str) -> None:
    """Raise, before anything is copied, where a checkpoint's tensor and the
    network's differ in shape (load_state_dict would copy the tensors that
    fit before it raised): e.g. a navigation layer trained with another
    navigation width (WorldParams.lateral_obs)."""
    bad = [f"{k}: {tuple(v.shape)} in the checkpoint, {tuple(current[k].shape)} here"
           for k, v in loaded.items() if k in current and v.shape != current[k].shape]
    if bad:
        raise ValueError(f"{path} does not fit this network (e.g. it was trained with "
                         f"another navigation width, lateral_obs): " + "; ".join(bad))


def copy_folder(src: str, dst: str) -> None:
    """Per-epoch weight snapshots (reference rl/utils.py:568-570)."""
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst)


def load_network_weights(net: torch.nn.Module, weights_dir: str) -> None:
    """Load `<weights_dir>/params.msgpack` and `batch_stats.msgpack` into
    `net` (a CARLANetwork); every parameter and buffer must match."""
    params = read_flax_msgpack(os.path.join(weights_dir, "params.msgpack"))
    stats = read_flax_msgpack(os.path.join(weights_dir, "batch_stats.msgpack"))
    net.load_state_dict(params_from_jax(params, stats), strict=True)
