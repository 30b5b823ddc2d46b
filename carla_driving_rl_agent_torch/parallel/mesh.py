"""Data parallelism over worlds with torch.distributed.

Counterpart of carla_driving_rl_agent_tpu/parallel/mesh.py, whose 1-D
`world` mesh (:24-29) and 2-D (slice, world) mesh (:32-53) shard the world
axis over chips and replicate the parameters, the optimizer states and the
RNG, so that GSPMD computes what one device would.  Here every rank is one
process; the same holds by construction:

  * rank r of R steps worlds [r B / R, (r + 1) B / R) of the B worlds
    (`WorldMesh.shard`; a 2-D layout of nodes x local ranks orders its
    ranks node-major, so its shards are the 1-D layout's);
  * every draw is drawn for all B worlds from a generator that every rank
    holds in the same state, and cut to the rank's rows
    (envs/carla_env.CARLAEnv.sharded, and the policy's samples in
    agents/carla_agent), so that each world draws what it draws in one
    process;
  * the rollout's trajectories and bootstrap inputs are all-gathered, and
    every rank runs the same update over the global minibatches: the
    parameters, the optimizer states and the update's generator stay
    replicated.  Rank 0 broadcasts the initial parameters.

The backend is the caller's choice, never a silent one: "nccl" across
cards, "gloo" for CPU ranks and for several ranks on one card (NCCL
refuses two ranks on one device).  gloo's collectives on CUDA tensors are
only broadcast and all_reduce, so the gathers go through host copies there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

WORLD_AXIS = "world"
SLICE_AXIS = "slice"


def map_tree(fn: Callable, tree):
    """`fn` applied to every tensor of nested NamedTuples, tuples, lists and
    dicts; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, t) for t in tree)
    return fn(tree)


@dataclass
class WorldMesh:
    """This process's place in a data-parallel run over worlds: its rank,
    the number of ranks, the axes' sizes (R,) or (nodes, local ranks), the
    backend, and the device it runs on."""
    rank: int
    world_size: int
    backend: str
    device: torch.device
    axes: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = (WORLD_AXIS,)

    def shard(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """The rows [lo, hi) of n worlds that `rank` (default this one)
        steps."""
        r = self.rank if rank is None else rank
        return n * r // self.world_size, n * (r + 1) // self.world_size

    def rows(self, tree, n: int, dim: int = 0):
        """This rank's rows of every tensor of `tree`, whose `dim` holds n
        worlds."""
        lo, hi = self.shard(n)
        return map_tree(lambda t: t.narrow(dim, lo, hi - lo).contiguous(), tree)

    def _host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def gather_rows(self, tree, n: int, dim: int = 0):
        """Every tensor of `tree`, holding this rank's rows of n worlds
        along `dim`, all-gathered into the tensor of all n worlds (in rank
        order), on this rank's device."""
        return map_tree(lambda t: self._gather(t, n, dim), tree)

    def _gather(self, t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
        m = -(-n // self.world_size)                 # the largest shard
        x = t.movedim(dim, 0)
        if x.shape[0] < m:
            x = torch.cat([x, x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))])
        as_u8 = x.dtype == torch.bool
        buf = x.to(torch.uint8) if as_u8 else x
        buf = (buf.cpu() if self._host(t) else buf).contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.world_size)]
        dist.all_gather(parts, buf)
        out = torch.cat([p[:hi - lo] for p, (lo, hi) in
                         zip(parts, (self.shard(n, r) for r in range(self.world_size)))])
        out = (out.bool() if as_u8 else out).to(t.device)
        # contiguous, so that reductions over it sum in one process's order
        return out.movedim(0, dim).contiguous()

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite `tensors` with rank `src`'s, in place."""
        for t in tensors:
            dist.broadcast(t.data, src)

    def replica_drift_(self, tensors: Sequence[torch.Tensor]) -> float:
        """The largest |difference| of any entry of `tensors` from rank 0's
        over all ranks, after which every rank holds rank 0's values: the
        replicas' check and their repair in one pass (one broadcast per
        dtype, of the tensors packed flat)."""
        drift = torch.zeros((), dtype=torch.float64, device=self.device)
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault((t.dtype, t.device), []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            if flat.numel() == 0:
                continue
            ref = flat.clone()
            dist.broadcast(ref, 0)
            if flat.is_floating_point():
                d = (flat.double() - ref.double()).abs().max()
            else:
                d = (flat != ref).any().double()
            drift = torch.maximum(drift, d.to(drift.device))
            for t, v in zip(group, ref.split([t.numel() for t in group])):
                t.data.copy_(v.view_as(t))
        dist.all_reduce(drift, op=dist.ReduceOp.MAX)
        return float(drift)


def _device(device, local_rank: int) -> torch.device:
    """cuda:<local_rank> (modulo the cards present: several ranks may share
    one) unless `device` names another."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for CPU ranks")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_mesh(rank: int, world_size: int, backend: str, init_method: str,
              device=None, nodes: Optional[int] = None) -> WorldMesh:
    """Join the process group (init_method e.g. "tcp://localhost:29500",
    the caller's address: nothing here reads a cluster's environment) and
    return this rank's WorldMesh.  `nodes` lays the ranks out as (nodes,
    world_size / nodes), node-major: the JAX package's (slice, world) mesh.
    Each rank runs on cuda:<local_rank> unless `device` names another."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: pass 'nccl' (across cards) or 'gloo' "
                         f"(CPU ranks, or several ranks on one card)")
    if nodes is not None and world_size % nodes:
        raise ValueError(f"{world_size} ranks do not split into {nodes} nodes")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    local = world_size // nodes if nodes else world_size
    dev = _device(device, rank % local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if nodes:
        return WorldMesh(rank, world_size, backend, dev, axes=(nodes, local),
                         axis_names=(SLICE_AXIS, WORLD_AXIS))
    return WorldMesh(rank, world_size, backend, dev, axes=(world_size,))


def close_mesh() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def replicated_tensors(module: torch.nn.Module, optimizers) -> List[torch.Tensor]:
    """The tensors every rank holds alike: the module's parameters and
    buffers, and every tensor of the optimizers' states (an optimizer may
    be a tuple of them)."""
    out = list(module.parameters()) + list(module.buffers())
    for opt in optimizers:
        for o in (opt if isinstance(opt, tuple) else (opt,)):
            for state in o.state.values():
                out.extend(v for v in state.values() if isinstance(v, torch.Tensor))
    return out


def free_port() -> int:
    """A free TCP port on localhost, for init_method."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, init_method: str,
               device, nodes, args: tuple, out_dir: str) -> None:
    import os
    mesh = init_mesh(rank, world_size, backend, init_method, device=device, nodes=nodes)
    try:
        torch.save(fn(mesh, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        close_mesh()


def spawn_ranks(fn: Callable, world_size: int, backend: str, args: tuple = (),
                device=None, nodes: Optional[int] = None) -> list:
    """Run fn(mesh, *args) in `world_size` spawned processes joined on a
    free localhost port (init_mesh's rules for the backend and the
    devices), wait for all of them, and return their results in rank
    order (each passed back through torch.save).  `fn` must be importable
    by the children: a module-level function."""
    import os
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, backend, f"tcp://localhost:{free_port()}", device,
                       nodes, args, out_dir))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
