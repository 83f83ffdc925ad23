"""The budgeted slot build, K10 (`gaot3d_tpu_torch/kernels/slot_build.py`),
on the CPU: the predicate that picks it, the wrapper's checks and its
refusal of CPU tensors, and the plain build whose bits K10 repeats, held to
JAX's build then `compact_slots` at any budget.

K10 itself runs only on the card (tests/test_torch_port_cuda.py); here the
predicate must pick it for float32 points on a card at a budget below the
window's K, within the widths and kNN picks it is built for, and for nothing
else; and the plain version must drop the same valid slots as JAX where a
row has more than the budget and fill the same masked cells where it has
fewer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu_torch.kernels import slot_build as k10
from gaot3d_tpu_torch.ops import grid_graph as tgg
from test_torch_port_device_edges import GRIDS
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

RECIPE = tgg.LatentGrid(dims=(64, 64, 32))  # spacings 2/63 and 2/31: a 6x6x4 window at 0.033
CUDA, F32 = torch.device("cuda"), torch.float32


@pytest.mark.parametrize("device,dtype,radius,k,strategy,budget,want", [
    (CUDA, F32, 0.033, 1, "bidirectional", 8, True),    # drivaerml: K 144
    ("cuda:1", F32, 0.033, 1, "reverse", 8, True),
    ("cpu", F32, 0.033, 1, "bidirectional", 8, False),  # the plain version
    (CUDA, torch.float64, 0.033, 1, "bidirectional", 8, False),
    (CUDA, F32, 0.033, 1, "bidirectional", None, False),  # edge sampling or caps
    (CUDA, F32, 0.033, 1, "bidirectional", 144, False),   # budget = K: nothing to compact
    (CUDA, F32, 0.033, 1, "bidirectional", 200, False),
    (CUDA, F32, 0.033, 1, "bidirectional", 0, False),
    (CUDA, F32, 0.033, 1, "bidirectional", 143, True),
    (CUDA, F32, 0.033, 1, "bidirectional", 1, True),
    (CUDA, F32, 0.033, 1, "knn", 7, True),                # a 2x2x2 window
    (CUDA, F32, 0.033, 1, "knn", 8, False),
    (CUDA, F32, 0.033, 8, "knn", 8, True),                # 8 picks: 8 passes
    (CUDA, F32, 0.033, 9, "knn", 8, False),
    (CUDA, F32, 0.033, 9, "bidirectional", 8, False),
    (CUDA, F32, 0.033, 9, "radius", 8, True),             # k unused by the radius test
    (CUDA, F32, 0.21, 1, "radius", 8, True),              # widths 16, 16, 10
    (CUDA, F32, 0.21, 1, "radius", 256, True),            # a warp's rows fill 40 of 48 KB
    (CUDA, F32, 0.21, 1, "radius", 257, False),
    (CUDA, F32, 0.23, 1, "radius", 8, False),             # widths 18, 18, 10
])
def test_engages_only_where_k10_is_built(device, dtype, radius, k, strategy, budget, want):
    assert k10.engages(device, dtype, RECIPE, radius, k, strategy, budget) == want


def _cloud(grid_name, B, N, seed):
    """Points in the box of one of `GRIDS` (the recipe's grid, an
    anisotropic box, an axis with h = 0, a grid whose centres and midpoints
    are exact in f32) and beyond it; on the 'exact' grid the first rows lie
    on cell centres and midpoints, so kNN picks meet ties; the last sample's
    last rows are padded (point mask false)."""
    dims, lo, hi, radius, low, high = GRIDS[grid_name]
    rng = np.random.default_rng(seed)
    pts = rng.uniform(low, high, (B, N, 3)).astype(np.float32)
    if grid_name == "exact":
        c = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
        pts[0, :5] = c[:, None]
        pts[0, 5:9] = (c[:4] + 0.25)[:, None]
    mask = np.ones((B, N), bool)
    mask[-1, -N // 5:] = False
    return tgg.LatentGrid(dims, lo, hi), jgg.LatentGrid(dims, lo, hi), radius, pts, mask


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("strategy", ["knn", "radius", "bidirectional", "reverse"])
@pytest.mark.parametrize("k", [1, 4])
def test_plain_build_equals_jax_compact_slots_at_any_budget(grid, strategy, k):
    """At budgets below the largest degree (rows over it drop their later
    valid slots; every kNN row at k = 1 has degree 1) and above it (rows
    under it fill with their first masked slots, cells included), whole and
    in node chunks: JAX's build, then its `compact_slots`, bit for bit."""
    tgrid, jgrid, radius, pts, mask = _cloud(grid, 2, 320, len(grid) + 10 * k)
    js = jgg.build_edge_slots_batched(jnp.asarray(pts), jgrid, radius, k_neighbors=k,
                                      strategy=strategy, point_mask=jnp.asarray(mask))
    K = js.lat_idx.shape[-1]
    top = jgg.max_slot_degree(js)
    budgets = {1, top - 1, top + 1, K - 1} & set(range(1, K))
    assert any(b > top for b in budgets) and (top == 1 or any(b < top for b in budgets))
    for budget in sorted(budgets):
        want = jgg.compact_slots(js, budget)
        for chunk in (None, 96):
            got = tgg.build_budgeted_slots(torch.from_numpy(pts), tgrid, radius, k, strategy,
                                           torch.from_numpy(mask), budget, chunk)
            np.testing.assert_array_equal(got.lat_idx.numpy(), np.asarray(want.lat_idx))
            np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert tgg.max_slot_degree(got) == min(budget, top)


def test_build_on_the_cpu_launches_nothing_and_the_wrapper_refuses_it():
    """`build_budgeted_slots` on CPU tensors gives the plain build's bits (the
    window, then `compact_slots`) and launches nothing; `slot_build`, K10
    alone, refuses CPU tensors after its checks pass."""
    tgrid, _, radius, pts, mask = _cloud("recipe", 3, 999, 3)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    before = k10.slot_build.launches
    got = tgg.build_budgeted_slots(pts, tgrid, radius, 1, "bidirectional", mask, 8, 200)
    want = tgg.compact_slots(
        tgg.build_edge_slots_batched(pts, tgrid, radius, 1, "bidirectional", mask), 8)
    assert torch.equal(got.lat_idx, want.lat_idx) and torch.equal(got.mask, want.mask)
    assert got.lat_idx.shape == (3, 999, 8) and got.mask.any()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        k10.slot_build(pts, tgrid, radius, 1, "bidirectional", mask, 8)
    assert k10.slot_build.launches == before


def _bad(case):
    pts = torch.zeros(2, 50, 3)
    mask = torch.ones(2, 50, dtype=torch.bool)
    budget, k = 8, 1
    if case == "float64":
        pts = pts.double()
    elif case == "shape":
        pts = torch.zeros(2, 50, 2)
    elif case == "strided":
        pts = torch.zeros(2, 3, 50).transpose(1, 2)
    elif case == "mask dtype":
        mask = mask.to(torch.uint8)
    elif case == "mask shape":
        mask = torch.ones(2, 49, dtype=torch.bool)
    elif case == "mask strided":
        mask = torch.ones(50, 2, dtype=torch.bool).t()
    elif case == "budget K":
        budget = 144
    elif case == "budget 0":
        budget = 0
    elif case == "budget 257":
        budget = 257
    elif case == "picks":
        k = 9
    return pts, mask, budget, k


@pytest.mark.parametrize("case", ["float64", "shape", "strided", "mask dtype", "mask shape",
                                  "mask strided", "budget K", "budget 0", "budget 257", "picks"])
def test_wrapper_rejects_what_k10_does_not_take(case):
    pts, mask, budget, k = _bad(case)
    radius = 0.21 if case == "budget 257" else 0.033  # a window of 2,560 slots
    with pytest.raises(ValueError):
        k10.slot_build(pts, RECIPE, radius, k, "bidirectional", mask, budget)
