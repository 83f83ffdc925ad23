"""Edge sampling over edge slots (port of gaot3d_tpu/ops/sampling.py).

'ratio' is a Bernoulli edge dropout, 'max_neighbors' a random cap of the
edges of each query; without draws a cap keeps the first edges in slot order
(PyG radius's `max_num_neighbors` truncation).

Each random function takes `rng`: a `torch.Generator`, from which it draws on
the generator's device, or the draws themselves as a tensor (the keep mask
of `dropout_edges`, the priority keys of the caps), so that draws made
elsewhere give the same edges. Slots are [B, N, K]; a cap of the encoder
side ranks the edges of each sample on their own, as the JAX model's vmap
over the batch does.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..edges import EdgeSlots

Rng = Union[torch.Generator, torch.Tensor]


def uniform_draws(rng: Rng, shape, device) -> torch.Tensor:
    """U[0, 1) draws of `shape` on `device`: from the generator, or the
    given tensor (which must have that shape)."""
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(rng.shape)}, expected {tuple(shape)}")
        return rng.to(device)
    return torch.rand(tuple(shape), generator=rng, device=rng.device).to(device)


def dropout_edges(slots: EdgeSlots, rate: float, rng: Rng) -> EdgeSlots:
    """Keep each edge with probability 1 - rate: `rng` is a generator (keep
    = u < 1 - rate, as jax.random.bernoulli draws it) or the keep mask
    itself, of the slots' shape."""
    if isinstance(rng, torch.Tensor) and rng.dtype == torch.bool:
        if rng.shape != slots.mask.shape:
            raise ValueError(f"keep mask of shape {tuple(rng.shape)}, "
                             f"expected {tuple(slots.mask.shape)}")
        keep = rng.to(slots.mask.device)
    else:
        keep = uniform_draws(rng, slots.mask.shape, slots.mask.device) < (1.0 - rate)
    return EdgeSlots(lat_idx=slots.lat_idx, mask=slots.mask & keep)


def _rank_within_segment(seg_ids: torch.Tensor, mask: torch.Tensor,
                         order_key: Optional[torch.Tensor] = None,
                         num_segments: Optional[int] = None) -> torch.Tensor:
    """Rank of each edge within its segment, in the order of `order_key`
    (edge order without one), ties in edge order (`jnp.lexsort` is stable);
    [B, E] arrays, each row ranked on its own. Invalid edges get rank E. The
    sentinel segment of invalid edges is `num_segments` (max(seg) + 1
    without it), not E, which a real segment id may equal."""
    B, E = seg_ids.shape
    seg = seg_ids.long()
    big = num_segments if num_segments is not None else seg.amax(dim=1, keepdim=True) + 1
    keyed = torch.where(mask, seg, torch.as_tensor(big, device=seg.device).expand_as(seg))
    # every row's segments in a range of its own, so one sort ranks them all
    span = (num_segments if num_segments is not None else int(keyed.max()) + 1) + 1
    keyed = keyed + torch.arange(B, device=seg.device)[:, None] * span
    keyed = keyed.reshape(-1)
    if order_key is None:
        perm = torch.argsort(keyed, stable=True)
    else:
        by_key = torch.argsort(order_key.reshape(-1), stable=True)
        perm = by_key[torch.argsort(keyed[by_key], stable=True)]
    sorted_seg = keyed[perm]
    idx = torch.arange(B * E, device=seg.device)
    is_start = torch.ones_like(sorted_seg, dtype=torch.bool)
    is_start[1:] = sorted_seg[1:] != sorted_seg[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), dim=0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - seg_start
    return torch.where(mask, rank.reshape(B, E), torch.full_like(seg, E)).to(torch.int32)


def cap_per_query_scatter(slots: EdgeSlots, cap: int, rng: Optional[Rng] = None,
                          num_segments: Optional[int] = None) -> EdgeSlots:
    """Keep at most `cap` edges per latent cell (the encoder side) of each
    sample: the first `cap` in slot order without `rng`, else those with the
    smallest keys, drawn U[0, 1) per edge or given ([B, N, K] or [B, N*K]).
    num_segments: the latent token count (see `_rank_within_segment`)."""
    B = slots.mask.shape[0]
    seg = slots.lat_idx.reshape(B, -1)
    mask = slots.mask.reshape(B, -1)
    E = seg.shape[1]
    key = None
    if rng is not None:
        key = uniform_draws(rng.reshape(B, E) if isinstance(rng, torch.Tensor) else rng,
                            (B, E), seg.device)
    rank = _rank_within_segment(seg, mask, key, num_segments=num_segments)
    keep = mask & (rank < cap)
    return EdgeSlots(lat_idx=slots.lat_idx, mask=keep.reshape(slots.mask.shape))


def cap_per_query_gather(slots: EdgeSlots, cap: int, rng: Optional[Rng] = None) -> EdgeSlots:
    """Keep at most `cap` edges per point (the decoder side; a slot row is a
    query's edge list): the first `cap` valid slots of each row without
    `rng`, else those with the smallest keys (drawn, or given [B, N, K])."""
    mask = slots.mask
    if rng is None:  # a valid slot's rank is the number of valid slots before it
        return EdgeSlots(lat_idx=slots.lat_idx,
                         mask=mask & (torch.cumsum(mask.to(torch.int32), dim=-1) <= cap))
    order = uniform_draws(rng, mask.shape, mask.device).to(torch.float32)
    keyed = torch.where(mask, order, torch.full_like(order, float("inf")))
    rank = torch.argsort(torch.argsort(keyed, dim=-1, stable=True), dim=-1, stable=True)
    return EdgeSlots(lat_idx=slots.lat_idx, mask=mask & (rank < cap))
