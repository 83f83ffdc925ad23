"""Process layout of data-parallel and node-sharded runs (port of
gaot3d_tpu/parallel/mesh.py `make_mesh` and gaot3d_tpu/train/trainer.py
`initialize_distributed`).

The JAX package builds a (data, node) device mesh and lets GSPMD insert the
collectives. The port runs one process a rank over `torch.distributed` and
makes them explicit (`parallel/sharding.py`). Ranks are laid out
rank = data_rank * node + node_rank: the `node` ranks of one data index hold
the node shards of the same samples, the `data` ranks of one node index hold
different samples. `make_mesh` builds one process group along each axis.

`initialize_distributed` starts the default process group from
`setup.world_size`, `setup.rank` and `setup.coordinator_address`
("host:port"), or, without them, from torchrun's RANK, WORLD_SIZE and
MASTER_ADDR / MASTER_PORT variables, or as a group of one process. The
backend is `setup.backend` when it names one ('nccl', 'gloo'), else 'nccl'
when the ranks run on cards and 'gloo' on the CPU. Ranks that share one card
need 'gloo': NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
NODE_AXIS = "node"
BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, node) layout of `data * node` ranks,
    and the groups along each axis (None where the axis has one rank)."""

    data: int
    node: int
    rank: int
    data_group: Any = None  # the `data` ranks of this rank's node index
    node_group: Any = None  # the `node` ranks of this rank's data index
    world_group: Any = None  # every rank (None with one)

    @property
    def world(self) -> int:
        return self.data * self.node

    @property
    def data_rank(self) -> int:
        return self.rank // self.node

    @property
    def node_rank(self) -> int:
        return self.rank % self.node

    def replicated_data(self) -> "Mesh":
        """The layout of a batch every data rank holds whole (the test
        loader's): node sharding alone, within this rank's node group."""
        return Mesh(1, self.node, self.node_rank, None, self.node_group, self.node_group)


def backend_for(device: torch.device, requested: Optional[str] = None) -> str:
    """'nccl' or 'gloo': the requested one when it names one, else by device."""
    if requested in BACKENDS:
        return requested
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(setup, device, timeout_s: float = 600.0) -> None:
    """Start the default process group for `setup` (`distributed: true`)
    unless one is running. `device` is this rank's device; under NCCL the
    process's current card is set to it."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = backend_for(device, getattr(setup, "backend", None))
    timeout = datetime.timedelta(seconds=timeout_s)
    kwargs = dict(backend=backend, timeout=timeout)
    if backend == "nccl":
        torch.cuda.set_device(device)
    world = int(getattr(setup, "world_size", 1) or 1)
    if world > 1:
        if not setup.coordinator_address:
            raise ValueError("setup.world_size > 1 needs setup.coordinator_address "
                             "('host:port' of rank 0)")
        dist.init_process_group(init_method=f"tcp://{setup.coordinator_address}",
                                world_size=world, rank=int(setup.rank), **kwargs)
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:  # torchrun
        dist.init_process_group(init_method="env://", **kwargs)
    else:  # one process
        dist.init_process_group(store=dist.HashStore(), world_size=1, rank=0, **kwargs)


def local_rank(setup) -> int:
    """This process's card index: torchrun's LOCAL_RANK, else setup.local_rank."""
    return int(os.environ.get("LOCAL_RANK", getattr(setup, "local_rank", 0) or 0))


def _groups(members: List[List[int]], rank: int):
    """Every rank creates every group, in one order; this rank's, or None for
    groups of one."""
    mine = None
    for ranks in members:
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if rank in ranks:
            mine = group
    return mine


def make_mesh(data: Optional[int] = None, node: int = 1) -> Mesh:
    """The (data, node) layout over the running default group: `data=None`
    takes world // node. data * node must be the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    node = max(1, int(node))
    if data is None:
        data = max(1, world // node)
    if data * node != world:
        raise ValueError(f"mesh ({data}x{node}) needs {data * node} ranks, have {world}")
    node_group = _groups([[d * node + s for s in range(node)] for d in range(data)], rank)
    data_group = _groups([[d * node + s for d in range(data)] for s in range(node)], rank)
    world_group = dist.group.WORLD if world > 1 else None
    return Mesh(data, node, rank, data_group, node_group, world_group)
