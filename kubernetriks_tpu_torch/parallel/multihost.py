"""Multi-process support for the batched simulation: one process a card.

Port of the JAX package's `parallel/multihost.py` onto `torch.distributed`.
The cluster batch shards over a 1-D device mesh with the step per cluster,
so scaling past one card is mostly a placement problem: every process
builds from the same compiled traces (the compile is deterministic, so all
build identical host arrays) and keeps its contiguous row range of
clusters on its own card (`put_global`); `to_host` gathers the rows back
at readout. Unlike the reference's SPMD program, where XLA inserts the
collectives, the port's engine makes the few quantities reduced over the
cluster axis global itself (batched/engine.py, module note): an
all-reduce or all-gather a window where fast-forward, the razor or a slide
reads one, none elsewhere.

The backend is NCCL for CUDA tensors on the card (its collectives are
captured into the window's CUDA graphs) and gloo on the CPU (the tests
spawn several processes on one host; gloo's collectives cannot be
captured, so an engine on a gloo group runs with graphs=False).

The reference's `shard_map` shim has no counterpart: torch runs each
process's program as written, and the RL policy's sharded forward
(rl/attention_policy.make_sharded_apply) calls its collectives by hand.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from kubernetriks_tpu_torch.sanitize import assert_sync_allowed


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> bool:
    """torch.distributed.init_process_group from explicit arguments, else
    from MASTER_ADDR (and MASTER_PORT), WORLD_SIZE and RANK as torchrun
    sets them; call once a process before any collective. Returns True
    where a process group is up after the call. Safe to call
    unconditionally: with no coordinator given or in the environment (a
    plain single-process run) it does nothing and returns False, and a
    repeated call returns whether the group spans more than one process.

    `coordinator_address`: "host:port", or an init method URL
    ("tcp://...", "file://..."). `backend`: None picks NCCL where a card is
    visible, else gloo. With NCCL the process's card is LOCAL_RANK (else
    the rank) modulo the visible cards. `timeout_s`: how long a collective
    waits for its peers before it raises (None: torch's default)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    address = coordinator_address
    if address is None and os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if address is None:
        return False
    world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    rank = process_id if process_id is not None else os.environ.get("RANK")
    if world is None or rank is None:
        raise ValueError(
            f"initialize_from_env: coordinator {address!r} given but the world size ({world}) or the rank "
            f"({rank}) is not: pass num_processes= and process_id= or set WORLD_SIZE and RANK"
        )
    world, rank = int(world), int(rank)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init_method = address if "://" in address else f"tcp://{address}"
    kwargs = {}
    if timeout_s is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kwargs)
    return True


def global_mesh(axis_name: str = "clusters"):
    """1-D DeviceMesh over every rank of the default group (data
    parallelism over the cluster batch; pass to BatchedSimulation(mesh=)).
    Its device type follows the group's backend: "cuda" on NCCL, "cpu" on
    gloo."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group; call initialize_from_env (or init_process_group) first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(dist.get_world_size()), mesh_dim_names=(axis_name,))


def is_cross_process(mesh) -> bool:
    """Whether the mesh spans more than this process (with one process a
    card, any mesh of more than one rank)."""
    return mesh is not None and mesh.size() > 1


def mesh_group(mesh, axis_name: Optional[str] = None):
    """The process group of the mesh's axis `axis_name` (a 1-D mesh's one
    axis where None)."""
    if axis_name is None or mesh.mesh_dim_names is None or len(mesh.mesh_dim_names) == 1:
        return mesh.get_group()
    return mesh.get_group(axis_name)


def row_range(n_rows: int, group) -> tuple:
    """[lo, hi): this rank's contiguous rows of an n_rows axis sharded
    evenly over `group` (n_rows must divide by its size)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_rows % world:
        raise ValueError(
            f"the cluster axis ({n_rows}) must divide evenly over the mesh's {world} ranks for the shard layout"
        )
    per = n_rows // world
    return rank * per, (rank + 1) * per


# Collectives issued through all_reduce_ and all_gather_rows, by kind: the
# graph executor compares them around each capture to record which
# captured pieces hold one (graphs.WindowExecutor.collective_captures).
CALLS = {"all_reduce": 0, "all_gather": 0}


def _on_group_device(x: torch.Tensor, group) -> torch.Tensor:
    """x where the group's backend takes it: as it is on NCCL, on the CPU
    on gloo."""
    if dist.get_backend(group) == "nccl" or x.device.type == "cpu":
        return x
    return x.cpu()


def all_reduce_(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all-reduce of x over `group` ("min", "max" or "sum"); on
    gloo a CUDA tensor goes through a host copy (a blocking read: the gloo
    path is the CPU's and the tests', never captured). Returns x."""
    red = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
    buf = _on_group_device(x, group)
    dist.all_reduce(buf, op=red, group=group)
    CALLS["all_reduce"] += 1
    if buf is not x:
        x.copy_(buf)
    return x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The (world * n, ...) concatenation of every rank's (n, ...) x along
    its first axis, in rank order, on x's device."""
    world = dist.get_world_size(group)
    buf = _on_group_device(x.contiguous(), group)
    out = torch.empty((world * buf.shape[0],) + tuple(buf.shape[1:]), dtype=buf.dtype, device=buf.device)
    if buf.dtype == torch.bool:
        dist.all_gather_into_tensor(out.view(torch.uint8), buf.view(torch.uint8), group=group)
    else:
        dist.all_gather_into_tensor(out, buf, group=group)
    CALLS["all_gather"] += 1
    return out.to(x.device)


def put_global(tree, group, n_rows: int, device=None):
    """This rank's slice of a host-built tree: every tensor leaf whose
    first axis is the n_rows cluster axis keeps rows [lo, hi) (a copy, so
    the full leaf can be freed), moved to `device` where given; other
    leaves stay as they are. NamedTuple trees, dicts, lists and tuples are
    walked; None stays None."""
    lo, hi = row_range(n_rows, group)

    def put(x):
        if x is None:
            return None
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[put(getattr(x, f)) for f in x._fields])
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            if x.dim() >= 1 and x.shape[0] == n_rows:
                x = x[lo:hi].clone()
            return x if device is None else x.to(device)
        return x

    return put(tree)


def to_host(x: torch.Tensor, group=None) -> np.ndarray:
    """Global host copy of x: this rank's rows, or with `group` every
    rank's rows gathered along the first axis in rank order (a collective:
    every rank of the group calls it).

    The device-to-host choke point of the sharded readouts: under
    KTPU_SANITIZE a call inside the guarded stepping loop without an allow
    scope raises (sanitize.assert_sync_allowed)."""
    assert_sync_allowed("to_host")
    if group is not None and dist.get_world_size(group) > 1:
        x = all_gather_rows(x, group)
    return x.detach().to("cpu", copy=True).numpy()


__all__: List[str] = [
    "all_gather_rows", "all_reduce_", "global_mesh", "initialize_from_env", "is_cross_process",
    "mesh_group", "put_global", "row_range", "to_host",
]
