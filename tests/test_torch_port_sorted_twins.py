"""The ordered twins of K7 (prefix sum) and K8 (tile segment sum) on the CPU.

Each twin repeats its kernel's float32 additions in the kernel's order with
plain torch ops, so on the card the kernel gives the twin's bits
(tests/test_torch_port_cuda.py, chip_smoke.py). Here each twin is held
against the JAX function it replaces, run in interpret mode as
tests/test_torch_port_segment.py runs it, and against the port's plain
version. Inputs are made with numpy from a seed.

Tolerances:
- K7 against the float64 plain version: 2e-6 of the column's largest prefix
  (chip_smoke.py K7_BOUND), which is what float32 rounding of a running sum
  follows. Against the JAX kernel, whose float32 Hillis-Steele scans of 128
  rows carry a block's total from one block to the next: 1e-5 of the same.
- K8 against the plain version: 1e-6 of each column's max-abs (K8_BOUND);
  on the CPU `index_add_` adds in row order from 0 too, so the two agree bit
  for bit, which is also asserted. Against the JAX kernel, which splits rows
  into two bf16 halves for the matrix unit: 1e-4 of the result's max-abs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops import pallas_kernels as jk
from gaot3d_tpu.ops import segment as jseg
from gaot3d_tpu_torch.kernels import prefix_sum as k7
from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

t = torch.from_numpy


def _largest_prefix(x):
    return np.maximum(np.abs(np.cumsum(x.astype(np.float64), axis=0)).max(axis=0), 1e-30)


# --- K7 -----------------------------------------------------------------------


@pytest.mark.parametrize("E", [1, 31, 1003])
@pytest.mark.parametrize("C", [1, 43, 300])
def test_prefix_sum_twin_matches_pallas_interpret_and_plain(E, C):
    rng = np.random.default_rng(E * 1000 + C)
    x = rng.normal(size=(E, C)).astype(np.float32)
    got = k7.prefix_sum_ordered_reference(t(x)).numpy()
    top = _largest_prefix(x)
    want = np.asarray(jk.prefix_sum(jnp.asarray(x), block_rows=128, interpret=True))
    assert got.shape == (E, C) and np.isfinite(got).all()
    assert (np.abs(got - want) / top).max() <= 1e-5
    plain = k7.prefix_sum_reference(t(x)).numpy()
    assert (np.abs(got - plain) / top).max() <= 2e-6


@pytest.mark.parametrize("E,C,levels", [(9000, 43, 2), (100_003, 1, 2), (4097, 7, 2),
                                         (40_000, 64, 3), (200_000, 43, 3)])
def test_prefix_sum_twin_over_several_tree_levels(E, C, levels):
    """Shapes whose tile totals take two or three levels of the tree, and
    ragged last tiles and groups: within 2e-6 of the float64 plain version,
    and the first tile is a plain running sum."""
    rng = np.random.default_rng(E + C)
    x = rng.normal(size=(E, C)).astype(np.float32)
    got = k7.prefix_sum_ordered_reference(t(x)).numpy()
    plain = k7.prefix_sum_reference(t(x)).numpy()
    assert (np.abs(got - plain) / _largest_prefix(x)).max() <= 2e-6
    R = k7.tile_rows(C)
    run = x[0].copy()
    for i in range(1, min(R, E)):
        run = run + x[i]
        np.testing.assert_array_equal(got[i], run)
    n, depth = -(-E // R), 0
    while n > 1 or depth == 0:
        n, depth = -(-n // k7.SCAN_RADIX), depth + 1
    assert depth == levels


def test_prefix_sum_twin_counts_exactly():
    """A column of ones reaches 163,840, exact in float32 in any order: the
    count column of the encoder's payload must come out exact."""
    x = torch.ones((163_840, 3))
    x[:, 1] = 0.0
    got = k7.prefix_sum_ordered_reference(x)
    want = torch.arange(1, 163_841, dtype=torch.float32)
    assert torch.equal(got[:, 0], want) and torch.equal(got[:, 2], want)
    assert not got[:, 1].any()


@pytest.mark.parametrize("C", [1, 32, 43, 300, 1000])
def test_prefix_sum_tile_rows(C):
    """Tiles are a multiple of 4 rows (a group of 43-float rows starts on a
    16-byte boundary) and a group of SCAN_RADIX tiles holds about
    BLOCK_FLOATS floats, or 4-row tiles when C is wider."""
    R = k7.tile_rows(C)
    assert R % 4 == 0 and R >= 4
    assert k7.SCAN_RADIX * R * C <= max(k7.BLOCK_FLOATS, k7.SCAN_RADIX * 4 * C)
    assert R == 4 or k7.SCAN_RADIX * (R + 4) * C > k7.BLOCK_FLOATS


def test_prefix_sum_twin_checks_its_input():
    with pytest.raises(ValueError, match=r"\[E, C\]"):
        k7.prefix_sum_ordered_reference(torch.zeros(5))
    assert k7.prefix_sum_ordered_reference(torch.zeros((0, 3))).shape == (0, 3)


# --- K8 -----------------------------------------------------------------------


def _sorted_rows(rng, E, S, P, n_valid, hot=None):
    """Rows sorted by id with the invalid ones (id S) at the tail; `hot`
    sends nine rows in ten to that one segment."""
    ids = rng.integers(0, S, E)
    if hot is not None:
        ids[rng.random(E) < 0.9] = hot
    ids[n_valid:] = S
    return rng.normal(size=(E, P)).astype(np.float32), np.sort(ids).astype(np.int32)


_TWIN_CASES = [
    # E, S, P, n_valid, hot, seg_tile
    (1000, 64, 43, 900, None, 8),      # ragged, a few rows a segment
    (1003, 517, 43, 1003, None, 100),  # S no multiple of the tile, empty segments
    (300, 2000, 5, 250, None, 16),     # most tiles empty
    (3001, 300, 43, 2900, 123, 32),    # one hot segment holds most rows
    (512, 40, 3, 0, None, 8),          # every row invalid
    (1, 9, 1, 1, None, 4),
]


@pytest.mark.parametrize("E,S,P,n_valid,hot,seg_tile", _TWIN_CASES)
def test_tile_segment_sum_twin_matches_plain_and_k6(E, S, P, n_valid, hot, seg_tile):
    """Sorted rows and the same rows read through perm: the twin against the
    plain version (1e-6 of each column's max-abs, and bit for bit on the
    CPU) and against K6's plain version on the same sorted rows."""
    rng = np.random.default_rng(E + S + seg_tile)
    data, ids = _sorted_rows(rng, E, S, P, n_valid, hot)
    ts = k8.tile_boundaries(t(ids), S, seg_tile)
    got = k8.tile_segment_sum_ordered_reference(t(data), t(ids), ts, S, seg_tile=seg_tile)
    plain = k8.tile_segment_sum_reference(t(data), t(ids), ts, S)
    assert got.shape == (S, P) and torch.isfinite(got).all()
    top = plain.abs().amax(dim=0).clamp_min(1e-30)
    assert ((got - plain).abs() / top).max().item() <= 1e-6
    assert torch.equal(got, plain)
    assert torch.equal(got, k6.segment_sum_sorted_reference(t(data), t(ids), S))
    shuffle = rng.permutation(E)
    perm = t(np.argsort(shuffle).astype(np.int32))  # data[shuffle][perm] == data
    assert torch.equal(got, k8.tile_segment_sum_ordered_reference(
        t(data[shuffle]), t(ids), ts, S, perm=perm, seg_tile=seg_tile))


@pytest.mark.parametrize("seg_tile,edge_block,max_blocks", [(8, 16, 8), (16, 32, 4), (4, 8, 2)])
@pytest.mark.parametrize("hot", [None, 3])
def test_tile_segment_sum_twin_matches_pallas_interpret(seg_tile, edge_block, max_blocks, hot):
    """Unsorted edges with a mask, sorted by the JAX fold; the twin reads
    them through perm. A hot segment overflows the TPU kernel's max_blocks
    and takes its cumsum fallback there."""
    rng = np.random.default_rng(seg_tile + (hot or 0))
    E, S, C = 257, 19, 4
    data = rng.normal(size=(E, C)).astype(np.float32)
    seg = rng.integers(0, S, size=E).astype(np.int32)
    if hot is not None:
        seg[rng.random(E) < 0.9] = hot
    mask = rng.random(E) < 0.8
    ctx = jseg.make_segment_fold(jnp.asarray(seg), S, jnp.asarray(mask))
    sd = np.asarray(jnp.asarray(data)[ctx.perm])
    want = np.asarray(jk.tile_segment_sum(jnp.asarray(sd), ctx.sorted_seg, ctx.starts,
                                          seg_tile=seg_tile, edge_block=edge_block,
                                          max_blocks=max_blocks, interpret=True))
    sorted_seg = t(np.array(ctx.sorted_seg))
    ts = k8.tile_boundaries(sorted_seg, S, seg_tile)
    got = k8.tile_segment_sum_ordered_reference(t(data), sorted_seg, ts, S,
                                                perm=t(np.array(ctx.perm)), seg_tile=seg_tile)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


def test_tile_segment_sum_twin_keeps_only_its_tiles_rows():
    """A row counts only among its own tile's rows [ts[t], ts[t+1]), as the
    kernel reads them; rows past ts[-1], negative ids and ids of S or more
    are dropped."""
    data = torch.arange(1.0, 9.0)[:, None]
    ids = torch.tensor([-1, 0, 0, 1, 2, 3, 4, 4], dtype=torch.int32)
    ts = torch.tensor([1, 4, 6], dtype=torch.int32)  # tiles {0, 1} and {2, 3}, rows 1..5
    got = k8.tile_segment_sum_ordered_reference(data, ids, ts, 4, seg_tile=2)
    assert got[:, 0].tolist() == [5.0, 4.0, 5.0, 6.0]
    short = torch.tensor([1, 3, 6], dtype=torch.int32)  # row 3 (segment 1) left out
    got = k8.tile_segment_sum_ordered_reference(data, ids, short, 4, seg_tile=2)
    assert got[:, 0].tolist() == [5.0, 0.0, 5.0, 6.0]
