"""Sharded steps over torch.distributed (port of
gaot3d_tpu/parallel/sharding.py `shard_point_batch`,
`make_sharded_train_step` and `make_sharded_eval_step`).

The JAX package replicates the parameters, shards the batch axis over
'data' and, optionally, the point axis over 'node', and GSPMD inserts the
collectives. Here each rank runs the port's own `train_step` / `eval_step`
on its rows of the global batch, inside a `Placement` that the model and
the step read, and the collectives are explicit:

  - the fused encoder all-reduces (sums) its raw accumulator over the node
    group before `_finalize`, so the geoembed's eigenvalues and z-norm see the
    whole cloud; its backward all-reduces the cotangent, so K5b gets the full
    one (`all_reduce_sum`); the modular encoder sums its per-cell sums and
    counts (the GNO's mean, the statistical geoembed's two passes, PointNet's
    mean pooling), takes the max of PointNet's max pooling
    (`all_reduce_max`), and joins the ranks' online-softmax states (the
    edge attention) the same way before it divides;
  - the batch-global z-norms take their sums over the data group (the
    encoder's, whose grid is replicated over a node group) or over every rank
    (the decoder's, on sharded queries);
  - the processor runs replicated on the node ranks; attention dropout is
    drawn from the step's global seeds at each row's global batch index
    (`Placement.batch_offset`), so a row keeps its keep bits whichever rank
    holds it;
  - the decoder runs on the rank's own query rows;
  - a neural-field step draws over the whole global batch (the node masks
    gathered over the node group) and each rank keeps the drawn nodes of its
    own rows;
  - the loss is the global masked mean: each rank divides its squared-error
    sum by the valid count of the whole global batch, and the gradients are
    summed over every rank before the optimizer steps. A mean of per-rank
    means (DDP's default average) would weight ranks with fewer valid nodes
    wrongly.

A global batch is split by `shard_point_batch`: its batch rows by data rank,
its node rows by node rank. Uniform slots split with their rows, flat edge
chunks by chunks (their node indices are chunk-local), shard-aligned sections
(`SectionedEdgeSlots.shards` equal to the node count) by each section's
shard-major rows, and a batch without edges leaves the model to build each
rank's slots from its own points.

Every all-reduce of a sharded step goes through this module, and
`all_reduce_.bytes` counts the bytes this process has all-reduced: the
forward's sums and maxima, their backward's and the gradients'. The
forward's (`all_reduce_sum`, `all_reduce_max` and the in-place
`all_reduce_`: the encoder's accumulator, the z-norm sums, the loss's valid
count and the global loss) run in the span `gaot.node_allreduce`; the
gradients' in `gaot.train.allreduce` (train/step.py), the backward's in the
backward.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.grid_graph import EdgeSlots, FlatEdgeChunks, SectionedEdgeSlots
from ..tracing import span
from .mesh import Mesh

NODE_ALLREDUCE = "gaot.node_allreduce"


@dataclass(frozen=True)
class Placement:
    """Where this rank's rows lie in the global batch of a sharded step."""

    mesh: Mesh
    batch_offset: int = 0  # the global batch index of the rank's row 0


_ACTIVE = threading.local()  # the placement of the step this thread runs


def active_placement() -> Optional[Placement]:
    """The placement of the sharded step this thread is running, or None."""
    return getattr(_ACTIVE, "placement", None)


@contextlib.contextmanager
def placed(placement: Optional[Placement]):
    """Run the body, on this thread, as this rank's part of a sharded step
    (None: an unsharded one)."""
    before = active_placement()
    _ACTIVE.placement = placement
    try:
        yield placement
    finally:
        _ACTIVE.placement = before


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over `group` in place, its bytes counted; no span."""
    dist.all_reduce(x, op=op, group=group)
    all_reduce_.bytes += x.numel() * x.element_size()
    return x


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over `group` in place (x itself when group is None), not
    differentiated: the forward's sums that take no gradient."""
    if group is None:
        return x
    with span(NODE_ALLREDUCE):
        return _reduce(x, group, op)


all_reduce_.bytes = 0  # bytes this process has all-reduced, every path


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangents the same
    way, which is the cotangent of the sum seen from every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over `group` (x itself when group is None)."""
    if group is None:
        return x
    all_reduce_sum.calls += 1
    with span(NODE_ALLREDUCE):
        return _AllReduceSum.apply(x, group)


all_reduce_sum.calls = 0


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of x over `group` (x itself when group is None),
    differentiable: the gradient goes to the lowest rank that holds the
    max, as a max over one concatenated tensor sends it to one element."""
    if group is None:
        return x
    all_reduce_sum.calls += 1  # the sum that hands out the max
    with span(NODE_ALLREDUCE):
        with torch.no_grad():
            top = _reduce(x.detach().clone(), group, dist.ReduceOp.MAX)
            me = float(dist.get_rank(group))
            first = torch.where(x.detach() == top, me, float(dist.get_world_size(group)))
            own = _reduce(first, group, dist.ReduceOp.MIN) == me
        return _AllReduceSum.apply(
            torch.where(own, x, torch.zeros((), dtype=x.dtype, device=x.device)), group)


def node_group() -> Any:
    place = active_placement()
    return None if place is None else place.mesh.node_group


def data_group() -> Any:
    place = active_placement()
    return None if place is None else place.mesh.data_group


def world_group() -> Any:
    place = active_placement()
    return None if place is None else place.mesh.world_group


def _rows(x, lo: int, hi: int, axis: int):
    if x is None:
        return None
    index = (slice(None),) * axis + (slice(lo, hi),)
    return x[index]


def _split_edges(edges, mesh: Mesh, b0: int, b1: int, shard_nodes: bool):
    """One scale's edge structure, cut to batch rows [b0, b1) and, with
    `shard_nodes`, to this rank's node shard."""
    S, s = mesh.node, mesh.node_rank
    if isinstance(edges, SectionedEdgeSlots):
        out = SectionedEdgeSlots(tuple(EdgeSlots(_rows(t.lat_idx, b0, b1, 0),
                                                 _rows(t.mask, b0, b1, 0))
                                       for t in edges.sections), edges.shards)
        if not shard_nodes:
            return out
        if edges.shards != S:
            raise ValueError(f"sections laid out for {edges.shards} shards, the mesh has "
                             f"{S} node ranks (set the loader's section_shards to node_shards)")
        return out.shard(s)
    if isinstance(edges, FlatEdgeChunks):
        parts = [_rows(t, b0, b1, 0) for t in (edges.src, edges.dst, edges.mask)]
        if shard_nodes:
            nc = edges.num_chunks
            if nc % S:
                raise ValueError(f"{nc} flat chunks do not split over {S} node ranks")
            parts = [_rows(t, s * nc // S, (s + 1) * nc // S, 1) for t in parts]
        return FlatEdgeChunks(*parts)
    if isinstance(edges, EdgeSlots):
        parts = [_rows(t, b0, b1, 0) for t in (edges.lat_idx, edges.mask)]
        if shard_nodes:
            n = parts[0].shape[1]
            parts = [_rows(t, s * n // S, (s + 1) * n // S, 1) for t in parts]
        return EdgeSlots(*parts)
    raise NotImplementedError(f"edge layout {type(edges).__name__} cannot be sharded")


def shard_point_batch(batch, mesh: Mesh, shard_nodes: bool = False,
                      process_local: bool = False) -> Tuple[Any, int]:
    """This rank's part of a global batch, and its batch offset.

    `batch` is a host PointBatch or a TrainBatch (any object with pos,
    feats, target, node_mask, enc_slots and dec_slots; num_nodes is kept as
    it is when present). Without `process_local`, the batch is the global one
    on every rank and data rank d takes rows [d * B/data, (d + 1) * B/data);
    with it, the batch is already this data rank's rows (a loader sharded by
    data rank) and is kept whole. With `shard_nodes`, node rank s takes point
    rows [s * N/node, (s + 1) * N/node) and the matching part of each edge
    structure. The offset is the global index of the rank's first row: the
    data ranks' rows concatenate in rank order into the global batch."""
    B, N = batch.pos.shape[:2]
    if process_local:
        b0, b1 = 0, B
        offset = mesh.data_rank * B
    else:
        if B % mesh.data:
            raise ValueError(f"batch {B} does not split over {mesh.data} data ranks")
        bl = B // mesh.data
        b0, b1 = mesh.data_rank * bl, (mesh.data_rank + 1) * bl
        offset = b0
    n0, n1 = 0, N
    if shard_nodes:
        if N % mesh.node:
            raise ValueError(f"{N} points do not split over {mesh.node} node ranks "
                             "(pad_multiple must be a multiple of node_shards)")
        nl = N // mesh.node
        n0, n1 = mesh.node_rank * nl, (mesh.node_rank + 1) * nl

    def points(x):
        return _rows(_rows(x, b0, b1, 0), n0, n1, 1)

    def side(edges):
        if edges is None:
            return None
        many = isinstance(edges, (list, tuple)) and not isinstance(
            edges, (EdgeSlots, FlatEdgeChunks))
        memo = {}

        def one(e):
            if id(e) not in memo:  # aliased encoder and decoder edges stay one
                memo[id(e)] = _split_edges(e, mesh, b0, b1, shard_nodes)
            return memo[id(e)]
        return type(edges)(one(e) for e in edges) if many else one(edges)

    fields = dict(pos=points(batch.pos), feats=points(batch.feats),
                  target=points(batch.target), node_mask=points(batch.node_mask))
    enc = side(batch.enc_slots)
    dec = enc if batch.dec_slots is batch.enc_slots else side(batch.dec_slots)
    fields.update(enc_slots=enc, dec_slots=dec)
    if hasattr(batch, "num_nodes"):
        fields["num_nodes"] = _rows(batch.num_nodes, b0, b1, 0)
    if getattr(batch, "condition", None) is not None:
        fields["condition"] = _rows(batch.condition, b0, b1, 0)
    local = batch._replace(**fields) if hasattr(batch, "_replace") else replace(batch, **fields)
    return local, offset


def all_reduce_gradients(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's gradient over all ranks (flattened into one
    buffer a dtype and device, one all-reduce each)."""
    if mesh.world_group is None:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    by_kind = {}
    for g in grads:
        by_kind.setdefault((g.dtype, g.device), []).append(g)
    for group in by_kind.values():
        flat = _reduce(torch.cat([g.reshape(-1) for g in group]), mesh.world_group)
        all_reduce_gradients.calls += 1
        off = 0
        for g in group:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


all_reduce_gradients.calls = 0


def make_sharded_train_step(train_step: Callable, mesh: Mesh, shard_nodes: bool = False,
                            process_local: bool = False) -> Callable:
    """`train_step(model, optimizer, batch, generator, neural_field)` on this
    rank's part of the global batch: the same arguments, every rank passing
    the global batch (or, with `process_local`, its data rank's rows) and a
    generator in the same state. Returns the global (loss, gradient norm) on
    every rank."""
    def step(model, optimizer, batch, generator=None, neural_field=None):
        local, offset = shard_point_batch(batch, mesh, shard_nodes, process_local)
        with placed(Placement(mesh, offset)):
            return train_step(model, optimizer, local, generator, neural_field)
    return step


def gather_rows(x: torch.Tensor, mesh: Mesh, shard_nodes: bool) -> torch.Tensor:
    """This rank's [b, n, ...] rows of a sharded output gathered into the
    global [B, N, ...] on every rank: node shards along axis 1, then data
    ranks along axis 0."""
    def gather(t, group, size, axis):
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=axis)
    if shard_nodes:
        x = gather(x, mesh.node_group, mesh.node, 1)
    return gather(x, mesh.data_group, mesh.data, 0)


def make_sharded_eval_step(eval_step: Callable, mesh: Mesh, shard_nodes: bool = False,
                           process_local: bool = False,
                           replicate_outputs: bool = False) -> Callable:
    """`eval_step(model, batch)` on this rank's part of the global batch:
    (prediction, global masked MSE). The prediction is the rank's rows, or
    with `replicate_outputs` the global [B, N, out] on every rank."""
    def step(model, batch):
        local, offset = shard_point_batch(batch, mesh, shard_nodes, process_local)
        with placed(Placement(mesh, offset)):
            pred, loss = eval_step(model, local)
        if replicate_outputs:
            pred = gather_rows(pred, mesh, shard_nodes)
        return pred, loss
    return step
