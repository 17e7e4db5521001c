"""Ray-sharded data parallelism — port of cednerf_tpu/parallel/mesh.py.

The JAX package runs one program over a 1-D device mesh (axis "data"):
ray batches sharded along axis 0; parameters, optimizer state and the
occupancy grid replicated; GSPMD inserts one gradient all-reduce per step;
occupancy updates run replicated on identical draws, so the grids stay
bit-equal; the budget compaction runs one block per device
(cfg.compact_blocks == mesh.size). An N-device run trains the same model
as the one-device run with compact_blocks = N.

Here each rank of a torch.distributed group is one device of the mesh and
the collectives are explicit:

  * every rank draws the global batch and its random draws (jitter, probe
    times) from the same generator and keeps its own rows (`shard_batch`,
    `Mesh.rows`), so it holds exactly the rows JAX's sharded program gives
    that device;
  * `replicate` broadcasts parameters and grids from rank 0; identical
    updates on identical inputs keep them bit-equal after that;
  * `all_reduce_grads` sums the gradients once a step (one flat buffer per
    dtype); `global_sum` gives loss denominators and metrics over all
    rays; `all_gather_rows` joins rendered rows.

Backends: NCCL for CUDA devices, gloo on the CPU. A gloo group handed CUDA
tensors (several ranks on one card, which NCCL refuses) runs each
collective on a host copy.

`make_mesh` joins the group a launcher made (`python -m
torch.distributed.run`, which sets RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT) or one the caller initialised; alone it makes a one-rank
group on an in-process store.
"""

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: `size` ranks of `group`, this process being `rank`, on
    `device`."""

    size: int
    rank: int
    device: torch.device
    group: object
    backend: str
    axis: str = "data"

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of an axis of n (n % size == 0)."""
        if n % self.size:
            raise ValueError(f"mesh: {n} rows do not split over "
                             f"{self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def _device_for(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' for a gloo mesh on the CPU")
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device="cuda") -> Mesh:
    """The mesh of this process's torch.distributed group (made here if
    none is: from the launcher's environment, else a one-rank group).
    device: this rank's device (CUDA, index LOCAL_RANK, unless given;
    "cpu" for a CPU mesh). A group made here takes NCCL on CUDA and gloo on
    the CPU. n_devices, if given, must be the group's size."""
    dev = _device_for(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the group "
                         f"has {size} ranks")
    return Mesh(size=size, rank=rank, device=dev,
                group=dist.group.WORLD, backend=dist.get_backend(), axis=axis)


def _on_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM):
    if _on_host(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=mesh.group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def global_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t summed over the mesh's ranks (a new tensor; every rank gets the
    same bits)."""
    return _all_reduce_(t.detach().clone(), mesh)


def all_reduce_grads(params, mesh: Mesh):
    """Sum every parameter's .grad over the ranks, in place: one all-reduce
    of one flat buffer per dtype."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        _all_reduce_(flat, mesh)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's t joined along axis 0 in rank order."""
    src = t.contiguous()
    if _on_host(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def barrier(mesh: Mesh):
    """Wait for every rank (an all-reduce of one element, which every
    backend and device takes)."""
    _all_reduce_(torch.zeros(1, device=mesh.device), mesh)


def shard_batch(batch, mesh: Mesh, n_rows: Optional[int] = None):
    """This rank's rows of every leaf of `batch` (a dict of tensors or
    numpy arrays): JAX's rule, a leaf of ndim >= 1 whose axis 0 divides by
    the mesh size is split, any other stays whole. n_rows, if given, splits
    only leaves with that many rows (a [3] background colour on a 3-rank
    mesh stays whole)."""
    def take(x):
        shape = getattr(x, "shape", ())
        if len(shape) >= 1 and shape[0] % mesh.size == 0 and (
                n_rows is None or shape[0] == n_rows):
            return x[mesh.rows(shape[0])]
        return x

    return {k: take(v) for k, v in batch.items()}


def _broadcast_(t: torch.Tensor, mesh: Mesh):
    buf = t.data.view(torch.uint8) if t.dtype == torch.bool else t.data
    if _on_host(mesh, buf):
        h = buf.cpu()
        dist.broadcast(h, src=0, group=mesh.group)
        buf.copy_(h)
    else:
        dist.broadcast(buf, src=0, group=mesh.group)


def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of `tree` from rank 0, in place: a module's
    parameters and buffers, the leaves of dicts, lists, tuples and
    NamedTuples (the occupancy grid). Returns `tree`."""
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                _broadcast_(t, mesh)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            _broadcast_(tree, mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif not isinstance(tree, (int, float, str, bool, np.ndarray,
                               type(None))):
        raise TypeError(f"replicate: cannot broadcast {type(tree).__name__}")
    return tree
