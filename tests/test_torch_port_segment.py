"""The port's sorted segment reductions against the JAX package on the CPU.

Each kernel module's plain version (what its wrapper runs for a CPU tensor)
is held against the JAX function it replaces, driven as the JAX package's own
tests drive it: the Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and go through both. The folds are compared in value and in
gradient with `fold_sum`, `fold_sum_sorted`, `fold_sum_tile_lite` and
`pallas_segment_sum_presorted`.

Tolerances: the TPU kernels split float32 rows into two bf16 halves for the
matrix unit, which leaves about 2^-16 relative error even in interpret mode,
so the segment sums are compared to 1e-5 of the result's largest magnitude
(stated per test where it differs). A prefix sum is compared relative to the
column's largest prefix, which is what its rounding follows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops import pallas_kernels as jk
from gaot3d_tpu.ops import segment as jseg
from gaot3d_tpu.ops.pallas_segment import segment_sum_sorted_pallas
from gaot3d_tpu_torch.kernels import prefix_sum as k7
from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
from gaot3d_tpu_torch.ops import segment as pseg

t = torch.from_numpy


def _close(got, want, rel=1e-5):
    """max |got - want| <= rel * max |want| (at least rel)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


def _edges(seed=0, E=257, S=19, C=4, keep=0.8):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(E, C)).astype(np.float32)
    seg = rng.integers(0, S, size=E).astype(np.int32)
    mask = rng.random(E) < keep
    return data, seg, mask, S


# --- K7 -----------------------------------------------------------------------


@pytest.mark.parametrize("E,C,block_rows", [(10_000, 38, 1024), (1003, 43, 128), (77, 1, 32),
                                            (4096, 32, 4096)])
def test_prefix_sum_matches_pallas_interpret(E, C, block_rows):
    rng = np.random.default_rng(E)
    x = rng.normal(size=(E, C)).astype(np.float32)
    want = np.asarray(jk.prefix_sum(jnp.asarray(x), block_rows=block_rows, interpret=True))
    got = k7.prefix_sum(t(x)).numpy()
    top = np.abs(np.cumsum(x.astype(np.float64), axis=0)).max(axis=0)
    assert (np.abs(got - want) / top).max() <= 1e-5
    assert k7.prefix_sum.launches == 0  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(k7.cumsum_fast(t(x)).numpy(), got)


def test_prefix_sum_checks_its_input():
    with pytest.raises(ValueError, match=r"\[E, C\]"):
        k7.prefix_sum(torch.zeros(5))
    assert k7.prefix_sum(torch.zeros((0, 3))).shape == (0, 3)
    assert k7.cumsum_fast(torch.ones((4, 2), dtype=torch.float64)).dtype == torch.float32


# --- K6 -----------------------------------------------------------------------


@pytest.mark.parametrize("E,P,M,mt,slab", [(1000, 16, 256, 64, 128), (300, 8, 128, 128, 128),
                                           (2048, 43, 512, 256, 256)])
def test_segment_sum_sorted_matches_pallas_interpret(E, P, M, mt, slab):
    rng = np.random.default_rng(E)
    payload = rng.normal(size=(E, P)).astype(np.float32)
    seg = np.sort(rng.integers(0, M, size=E)).astype(np.int32)
    seg[E - E // 10:] = M  # invalid rows at the tail
    want = segment_sum_sorted_pallas(jnp.asarray(payload), jnp.asarray(seg), M, mt=mt,
                                     slab=slab, interpret=True, passes=2)
    got = k6.segment_sum_sorted(t(payload), t(seg), M, passes=2)
    _close(got.numpy(), want)
    assert k6.segment_sum_sorted.launches == 0


def test_segment_sum_sorted_hot_and_empty_segments():
    """One hot cell and empty tiles (tests/test_pallas_segment.py); the hot
    cell's 3,000-row sum is compared at 1e-4 of it, float32 order."""
    rng = np.random.default_rng(1)
    E, P, M = 4096, 12, 512
    seg = np.sort(np.concatenate([np.full(3000, 77),
                                  rng.integers(400, 512, 1096)])).astype(np.int32)
    payload = rng.normal(size=(E, P)).astype(np.float32)
    want = segment_sum_sorted_pallas(jnp.asarray(payload), jnp.asarray(seg), M, mt=128,
                                     slab=256, interpret=True, passes=2)
    got = k6.segment_sum_sorted(t(payload), t(seg), M).numpy()
    _close(got, want, rel=1e-4)
    assert not got[:77].any() and not got[78:400].any()


def test_segment_sum_sorted_checks_its_input():
    with pytest.raises(ValueError, match="leading shape"):
        k6.segment_sum_sorted(torch.zeros((4, 3)), torch.zeros(5, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="positive"):
        k6.segment_sum_sorted(torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int32), 0)
    out = k6.segment_sum_sorted(torch.ones((2, 4, 3)),
                                torch.tensor([[0, 0, 1, 2], [-1, 1, 2, 2]], dtype=torch.int32), 2)
    # ids of num_segments or more, and negative ids, are dropped
    assert out[:, :, 0].tolist() == [[2.0, 1.0], [0.0, 1.0]]


def _presorted_batch(seed, B=3, E=40, P=5, M=16):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, M, (B, E)), axis=1).astype(np.int32)
    nvalid = np.array([E, E - 7, 3])[:B]
    mask = np.arange(E)[None, :] < nvalid[:, None]
    seg = np.where(mask, seg, 0).astype(np.int32)  # padding carries cell 0, as flat lists do
    data = rng.normal(size=(B, E, P)).astype(np.float32)
    return data, seg, mask, M


def test_pallas_segment_sum_presorted_matches_jax_values_and_gradients():
    data, seg, mask, M = _presorted_batch(7)
    want = jseg.pallas_segment_sum_presorted(jnp.asarray(data), jnp.asarray(seg),
                                             jnp.asarray(mask), M)
    d = t(data).requires_grad_()
    got = pseg.pallas_segment_sum_presorted(d, t(seg), t(mask), M)
    _close(got.detach().numpy(), want, rel=5e-5)  # the JAX default passes=2: hi/lo bf16 error
    ct = np.random.default_rng(8).normal(size=(data.shape[0], M, data.shape[2])).astype(np.float32)
    g_want = jax.grad(lambda x: jnp.sum(jseg.pallas_segment_sum_presorted(
        x, jnp.asarray(seg), jnp.asarray(mask), M) * ct))(jnp.asarray(data))
    (g_got,) = torch.autograd.grad(got, d, t(ct))
    np.testing.assert_array_equal(g_got.numpy(), np.asarray(g_want))  # a gather: exact
    assert not g_got.numpy()[~mask].any()


# --- K8 -----------------------------------------------------------------------


def _sorted_for_tile(data, seg, mask, S):
    ctx = jseg.make_segment_fold(jnp.asarray(seg), S, jnp.asarray(mask))
    return ctx, np.asarray(jnp.asarray(data)[ctx.perm])


@pytest.mark.parametrize("seg_tile,edge_block,max_blocks", [(8, 16, 8), (16, 32, 4)])
def test_tile_segment_sum_matches_pallas_interpret(seg_tile, edge_block, max_blocks):
    data, seg, mask, S = _edges()
    ctx, sd = _sorted_for_tile(data, seg, mask, S)
    want = jk.tile_segment_sum(jnp.asarray(sd), ctx.sorted_seg, ctx.starts, seg_tile=seg_tile,
                               edge_block=edge_block, max_blocks=max_blocks, interpret=True)
    sorted_seg, starts = t(np.asarray(ctx.sorted_seg)), t(np.asarray(ctx.starts))
    got = k8.tile_segment_sum(t(sd), sorted_seg, starts, seg_tile=seg_tile,
                              edge_block=edge_block, max_blocks=max_blocks)
    _close(got.numpy(), want, rel=1e-4)  # tests/test_segment.py: the hi/lo bf16 split
    # from tile boundaries, and reading the unsorted rows through perm: same sums
    ts = k8.tile_boundaries(sorted_seg, S, seg_tile)
    np.testing.assert_array_equal(
        ts.numpy(), np.asarray(jk.tile_boundaries(ctx.sorted_seg, S, seg_tile)))
    lite = k8.tile_segment_sum(t(data), sorted_seg, ts=ts, num_segments=S, seg_tile=seg_tile,
                               perm=t(np.asarray(ctx.perm)))
    np.testing.assert_array_equal(lite.numpy(), got.numpy())
    assert k8.tile_segment_sum.launches == 0


def test_tile_segment_sum_inputs_that_overflow_the_tpu_grid():
    """Everything in segment 0 overflows max_blocks on the TPU and takes its
    cumsum fallback; the port has no such limit and gives the same sums."""
    rng = np.random.default_rng(1)
    E, S, C = 300, 10, 3
    data = rng.normal(size=(E, C)).astype(np.float32)
    seg = np.zeros(E, dtype=np.int32)
    seg[200:] = rng.integers(0, S, size=100)
    mask = np.ones(E, dtype=bool)
    ctx, sd = _sorted_for_tile(data, seg, mask, S)
    want = jk.tile_segment_sum(jnp.asarray(sd), ctx.sorted_seg, ctx.starts, seg_tile=4,
                               edge_block=8, max_blocks=2, interpret=True)
    got = k8.tile_segment_sum(t(sd), t(np.asarray(ctx.sorted_seg)), t(np.asarray(ctx.starts)),
                              seg_tile=4, edge_block=8, max_blocks=2)
    _close(got.numpy(), want)


def test_sorted_fold_matches_jax():
    data, seg, mask, S = _edges(seed=3)
    ctx, sd = _sorted_for_tile(data, seg, mask, S)
    n_valid = int(mask.sum())
    want = jk._sorted_fold(jnp.asarray(sd), ctx.starts, n_valid)
    got = k8._sorted_fold(t(sd), t(np.asarray(ctx.starts)), n_valid)
    _close(got.numpy(), want)


def test_tile_segment_sum_checks_its_input():
    rows, ids = torch.zeros((6, 2)), torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="starts"):
        k8.tile_segment_sum(rows, ids)
    with pytest.raises(ValueError, match="num_segments"):
        k8.tile_segment_sum(rows, ids, ts=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="boundaries"):
        k8.tile_segment_sum(rows, ids, ts=torch.zeros(5, dtype=torch.int32), num_segments=4,
                            seg_tile=4)


# --- the folds ------------------------------------------------------------------


def _fold_pair(name, data, seg, mask, S):
    """(JAX fold function of data, port fold function of data) for one fold."""
    sj, mj = jnp.asarray(seg), jnp.asarray(mask)
    sp, mp = t(seg), t(mask)
    if name == "fold_sum":
        cj, cp = jseg.make_segment_fold(sj, S, mj), pseg.make_segment_fold(sp, S, mp)
        return (lambda d: jseg.fold_sum(cj, d)), (lambda d: pseg.fold_sum(cp, d))
    if name == "fold_mean":
        cj, cp = jseg.make_segment_fold(sj, S, mj), pseg.make_segment_fold(sp, S, mp)
        return (lambda d: jseg.fold_mean(cj, d)), (lambda d: pseg.fold_mean(cp, d))
    if name == "fold_sum_tile":
        cj, cp = jseg.make_segment_fold(sj, S, mj), pseg.make_segment_fold(sp, S, mp)
        return (lambda d: jseg.fold_sum_tile(cj, d)), (lambda d: pseg.fold_sum_tile(cp, d, 8))
    if name == "fold_sum_tile_lite":
        cj = jseg.make_tile_fold(sj, S, mj, seg_tile=8)
        cp = pseg.make_tile_fold(sp, S, mp, seg_tile=8)
        return ((lambda d: jseg.fold_sum_tile_lite(cj, d, S, seg_tile=8)),
                (lambda d: pseg.fold_sum_tile_lite(cp, d, S, seg_tile=8)))
    raise ValueError(name)


@pytest.mark.parametrize("ndim", [2, 1])
@pytest.mark.parametrize("name", ["fold_sum", "fold_mean", "fold_sum_tile",
                                  "fold_sum_tile_lite"])
def test_folds_match_jax_values_and_gradients(name, ndim):
    data, seg, mask, S = _edges(seed=5)
    if ndim == 1:
        data = data[:, 0].copy()
    fj, fp = _fold_pair(name, data, seg, mask, S)
    want = fj(jnp.asarray(data))
    d = t(data).requires_grad_()
    got = fp(d)
    _close(got.detach().numpy(), want)
    ct = np.random.default_rng(6).normal(size=np.shape(want)).astype(np.float32)
    g_want = jax.grad(lambda x: jnp.sum(fj(x) * ct))(jnp.asarray(data))
    (g_got,) = torch.autograd.grad(got, d, t(ct))
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-6, atol=1e-7)
    assert not g_got.numpy()[~mask].any()  # masked rows take no gradient


def test_fold_contexts_match_jax():
    data, seg, mask, S = _edges(seed=9)
    cj = jseg.make_segment_fold(jnp.asarray(seg), S, jnp.asarray(mask))
    cp = pseg.make_segment_fold(t(seg), S, t(mask))
    for field in ("perm", "sorted_seg", "starts", "valid", "key"):  # the sort is stable in both
        np.testing.assert_array_equal(getattr(cp, field).numpy(), np.asarray(getattr(cj, field)))
    np.testing.assert_array_equal(pseg.fold_count(cp).numpy(), np.asarray(jseg.fold_count(cj)))
    tj = jseg.make_tile_fold(jnp.asarray(seg), S, jnp.asarray(mask), seg_tile=8)
    tp = pseg.make_tile_fold(t(seg), S, t(mask), seg_tile=8)
    for field in ("perm", "sorted_seg", "ts", "key"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(tj, field)))


def test_fold_sum_sorted_matches_jax_values_and_gradients():
    """tests/test_flat_edges.py: presorted edges with tail padding."""
    rng = np.random.default_rng(11)
    E, S, C = 300, 40, 7
    seg = np.sort(rng.integers(0, S, E)).astype(np.int32)
    mask = np.ones(E, bool)
    mask[270:] = False
    seg[270:] = 0  # padding carries cell 0
    data = rng.normal(size=(E, C)).astype(np.float32)
    cj = jseg.make_segment_fold_presorted(jnp.asarray(seg), S, jnp.asarray(mask))
    cp = pseg.make_segment_fold_presorted(t(seg), S, t(mask))
    np.testing.assert_array_equal(cp.starts.numpy(), np.asarray(cj.starts))
    want = jseg.fold_sum_sorted(cj, jnp.asarray(data))
    d = t(data).requires_grad_()
    got = pseg.fold_sum_sorted(cp, d)
    _close(got.detach().numpy(), want)
    ct = rng.normal(size=(S, C)).astype(np.float32)
    g_want = jax.grad(lambda x: jnp.sum(jseg.fold_sum_sorted(cj, x) * ct))(jnp.asarray(data))
    (g_got,) = torch.autograd.grad(got, d, t(ct))
    np.testing.assert_array_equal(g_got.numpy(), np.asarray(g_want))
    np.testing.assert_array_equal(pseg.fold_count(cp).numpy(),
                                  np.bincount(seg[mask], minlength=S).astype(np.float32))
