"""The device mesh (PyTorch counterpart of `nngp_tpu/parallel/mesh.py`).

The JAX tier is single-controller: one process drives a
`jax.sharding.Mesh` over every device. Here the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with one dimension named
"data", and the tier is SPMD: every rank runs the same program on its own
rows and calls the collectives itself.

`make_mesh` starts the process group when none exists: under `torchrun`
(WORLD_SIZE in the environment) from the launcher's variables, and
otherwise as a world-size-1 group on an in-process `HashStore`. NCCL
serves CUDA ranks, gloo CPU ranks. Each CUDA rank uses `cuda:<LOCAL_RANK>`.

The collectives the tier's modules share (`parallel/cholesky.py`,
`parallel/sharded.py`, the mesh paths of `gp/hyperopt.py` and
`gp/nystrom.py`) live here too: an owner's broadcast, a row gather onto
every rank or onto rank 0's host, and sums over ranks.
"""

import contextlib
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from nngp_tpu_torch.utils.device import resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# a rank that dies leaves the others blocked in a collective: fail instead
_TIMEOUT = datetime.timedelta(seconds=600)


def _start_group(backend: str):
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=_TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: str = "cuda") -> DeviceMesh:
    """The 1-D mesh over every rank of the process group, on `device`
    ('cuda' or 'cpu'; 'cuda' without a GPU raises).

    n_devices must equal the world size: an SPMD program cannot take a
    subset of its own ranks, where the JAX package slices `jax.devices()`.
    Without a launcher the world size is 1."""
    dev_type = resolve_device(device).type
    backend = _BACKENDS[dev_type]
    if not dist.is_initialized():
        if dev_type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())
        _start_group(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, but "
                         f"a {dev_type} mesh needs {backend}")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"requested {n_devices} devices, but the world size is {world}: "
            f"launch with torchrun --nproc_per_node {n_devices} (without a "
            "launcher only 1 is possible)")
    return init_device_mesh(dev_type, (world,), mesh_dim_names=(axis_name,))


@contextlib.contextmanager
def owned_group():
    """For a command line's run: a process group started inside the block
    (by `make_mesh`) is destroyed when the block ends without an
    exception. A gloo group left to the interpreter's exit can abort the
    process after its work is done (SIGABRT, "terminate called without an
    active exception"), which fails the launcher's run."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def control_group(mesh, timeout: Optional[datetime.timedelta] = None):
    """A gloo group over the mesh's ranks on which rank 0 and the others
    exchange pickled host objects (`serve/follower.py`), with `timeout`
    (default the process group's) on each of its operations; None when the
    mesh has one rank. Collective: every rank calls it at the same point.

    Not the mesh's NCCL group: a rank waiting in an NCCL collective for an
    idle server's next request holds a pending collective that the
    watchdog kills after its timeout, and query strings have no reason to
    go through the card."""
    if mesh is None or int(mesh.size()) == 1:
        return None
    return dist.new_group(dist.get_process_group_ranks(mesh.get_group()),
                          timeout=timeout or _TIMEOUT, backend="gloo")


def check_mesh_device(mesh, device):
    """Raise unless `device` (a name or torch.device) is of the mesh's
    device type: a cuda mesh serves cuda tensors, a cpu mesh cpu ones."""
    if mesh is not None and torch.device(device).type != mesh.device_type:
        raise ValueError(f"mesh is a {mesh.device_type} mesh but device is "
                         f"{torch.device(device)}")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_rank(mesh: DeviceMesh) -> int:
    """This rank's coordinate on the mesh's one dimension."""
    return int(mesh.get_local_rank())


def is_lead(mesh) -> bool:
    """True on the rank that writes files and prints: coordinate 0, or any
    process when there is no mesh."""
    return mesh is None or mesh_rank(mesh) == 0


# ------------------------------------------------------------ collectives
def topology(mesh, axis_name: str = "data"):
    """(group, p, this rank's coordinate) of the mesh's axis."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def owner_broadcast(make, owner: int, shape, like: torch.Tensor, group):
    """The owner's tensor `make()` on every rank: one broadcast from the
    owner into a buffer of `shape` that the other ranks allocate."""
    if dist.get_rank(group) == owner:
        buf = make().contiguous()
    else:
        buf = like.new_empty(shape)
    dist.broadcast(buf, src=dist.get_global_rank(group, owner), group=group)
    return buf


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (r, ...) tensors stacked in rank order, (p r, ...)."""
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def gather_rows_to_host(t: torch.Tensor, group) -> Optional[np.ndarray]:
    """The ranks' (r, ...) tensors stacked in rank order as one host numpy
    array on coordinate 0, None on the others. Each other rank sends its
    tensor to coordinate 0, which copies it into host memory, so no device
    holds the whole array (coordinate 0 holds one received shard at a
    time)."""
    d = dist.get_rank(group)
    lead = dist.get_global_rank(group, 0)
    if d != 0:
        dist.send(t.contiguous(), dst=lead, group=group)
        return None
    p, r = dist.get_world_size(group), t.shape[0]
    out = torch.empty((p * r,) + tuple(t.shape[1:]), dtype=t.dtype)
    out[:r].copy_(t)
    buf = None
    for src in range(1, p):
        if buf is None:
            buf = torch.empty_like(t, memory_format=torch.contiguous_format)
        dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
        out[src * r:(src + 1) * r].copy_(buf)
    return out.numpy()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of t (a new tensor; t is not modified)."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum_many(tensors, group):
    """The sum over ranks of each tensor of a list of one dtype (None
    entries stay None), in one all-reduce of their concatenation."""
    live = [t for t in tensors if t is not None]
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in live]), group)
    out, i = [], 0
    for t in tensors:
        if t is not None:
            t, i = flat[i:i + t.numel()].reshape(t.shape), i + t.numel()
        out.append(t)
    return out
