"""The port's edge build on the device against the JAX build, on the CPU.

`gaot3d_tpu_torch.ops.grid_graph.build_edge_slots_batched` repeats the f32
operations of `gaot3d_tpu.ops.grid_graph.build_edge_slots` one by one, so on
the same points both give the same bits: every case below compares lat_idx
and mask exactly. The JAX build runs op by op here; under `jax.jit` XLA on
the CPU contracts `lo + i * h` into a fused multiply-add, whose one rounding
gives the native host build's bits instead (the second test group bounds
that difference). Then the whole model without precomputed slots against
JAX `model.apply` without slots, on the same weights.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.data.host_graph import build_edge_slots_host
from gaot3d_tpu_torch.models import init_model
from gaot3d_tpu_torch.ops import grid_graph as tgg
from gaot3d_tpu_torch.weights import load_numpy_state_dict
from test_degree_sections import _flagship_model
from test_torch_port_model import _port_configs, _with_attention_dtype
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# (dims, lo, hi, radius, low, high): the recipe's grid; an anisotropic box;
# one axis of one cell with lo == hi there (h = 0); a grid of spacing 0.5,
# whose cell centres and midpoints are exact in f32. Points are drawn in
# [low, high]^3, partly outside every grid.
GRIDS = {
    "recipe": ((64, 64, 32), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 0.033, -1.05, 1.05),
    "anisotropic": ((8, 5, 12), (-1.0, -0.5, 0.0), (1.0, 0.5, 3.0), 0.3, -1.3, 3.3),
    "flat-axis": ((6, 1, 7), (-1.0, 0.25, -1.0), (1.0, 0.25, 1.0), 0.4, -1.2, 1.2),
    "exact": ((5, 5, 5), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 0.5, -1.0, 1.0),
}


def _grids(name):
    dims, lo, hi, radius, low, high = GRIDS[name]
    return jgg.LatentGrid(dims, lo, hi), tgg.LatentGrid(dims, lo, hi), radius, low, high


def _points(seed, B, N, low, high):
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, (B, N, 3)).astype(np.float32)


def _tie_points(B=2):
    """Points on cell centres (a zero distance, then six cells at one
    spacing) and on midpoints between two, four and eight centres, of the
    'exact' grid: every kNN choice beyond the first meets exact ties."""
    c = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
    m = (c[:-1] + 0.25).astype(np.float32)
    axes = [np.concatenate([c, m])] * 3
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(5)
    return np.stack([pts[rng.permutation(len(pts))] for _ in range(B)])


def _jax_build(pts, jgrid, radius, k, strategy, mask=None):
    out = jgg.build_edge_slots_batched(jnp.asarray(pts), jgrid, radius, k_neighbors=k,
                                       strategy=strategy,
                                       point_mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(out.lat_idx), np.asarray(out.mask)


def _port_build(pts, tgrid, radius, k, strategy, mask=None):
    out = tgg.build_edge_slots_batched(torch.from_numpy(pts), tgrid, radius, k, strategy,
                                       None if mask is None else torch.from_numpy(mask))
    assert out.lat_idx.dtype == torch.int32 and out.mask.dtype == torch.bool
    return out.lat_idx.numpy(), out.mask.numpy()


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["knn", "radius", "bidirectional", "reverse"])
def test_build_equals_jax_bit_for_bit(grid, k, strategy):
    """B = 2 clouds, partly outside the grid, the second with 40 padded rows
    (point_mask false): lat_idx and mask exactly as JAX's."""
    jgrid, tgrid, radius, low, high = _grids(grid)
    pts = _points(10 * sorted(GRIDS).index(grid) + k, 2, 300, low, high)
    mask = np.ones((2, 300), bool)
    mask[1, -40:] = False
    want = _jax_build(pts, jgrid, radius, k, strategy, mask)
    got = _port_build(pts, tgrid, radius, k, strategy, mask)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1][1, -40:].any() and got[1].any()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["knn", "bidirectional"])
def test_knn_ties_keep_the_lower_slot(k, strategy):
    """Exact distance ties: the port keeps the slots jax.lax.top_k keeps."""
    jgrid, tgrid, radius, _, _ = _grids("exact")
    pts = _tie_points()
    want = _jax_build(pts, jgrid, radius, k, strategy)
    got = _port_build(pts, tgrid, radius, k, strategy)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_single_cloud_build_and_default_mask():
    """`build_edge_slots` on one [N, 3] cloud is JAX's, and the batched
    build's default point_mask is all true."""
    jgrid, tgrid, radius, low, high = _grids("anisotropic")
    pts = _points(3, 1, 200, low, high)
    want = jgg.build_edge_slots(jnp.asarray(pts[0]), jgrid, radius, 2, "bidirectional")
    got = tgg.build_edge_slots(torch.from_numpy(pts[0]), tgrid, radius, 2, "bidirectional")
    np.testing.assert_array_equal(got.lat_idx.numpy(), np.asarray(want.lat_idx))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    full = _port_build(pts, tgrid, radius, 2, "bidirectional", np.ones((1, 200), bool))
    np.testing.assert_array_equal(_port_build(pts, tgrid, radius, 2, "bidirectional")[1],
                                  full[1])
    with pytest.raises(ValueError, match="unknown neighbor strategy"):
        tgg.build_edge_slots(torch.from_numpy(pts[0]), tgrid, radius, 1, "nearest")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_stencil_base_cell_and_widths_equal_jax(grid):
    jgrid, tgrid, radius, low, high = _grids(grid)
    pts = _points(11, 2, 257, low, high)
    for k, strategy in ((1, "radius"), (4, "knn"), (2, "bidirectional")):
        assert tgg.stencil_widths(tgrid, radius, k, strategy) == \
            jgg.stencil_widths(jgrid, radius, k, strategy)
        want = np.stack([np.asarray(jgg.stencil_base_cell(jnp.asarray(p), jgrid, radius, k,
                                                          strategy)) for p in pts])
        got = tgg.stencil_base_cell(torch.from_numpy(pts), tgrid, radius, k, strategy)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", ["recipe", "anisotropic"])
def test_compacted_build_equals_jax_compact_slots(grid):
    """The build compacted to a budget, whole or in node chunks
    (`build_budgeted_slots`), equals JAX's build then `compact_slots`, masked
    slots' cells included; `max_slot_degree` reads the same degree."""
    jgrid, tgrid, radius, low, high = _grids(grid)
    pts = _points(17, 2, 384, low, high)
    mask = np.ones((2, 384), bool)
    mask[0, :10] = False
    js = jgg.build_edge_slots_batched(jnp.asarray(pts), jgrid, radius, 1, "bidirectional",
                                      jnp.asarray(mask))
    budget = jgg.max_slot_degree(js)
    assert budget < js.lat_idx.shape[-1]
    want = jgg.compact_slots(js, budget)
    for chunk in (None, 128, 100):
        got = tgg.build_budgeted_slots(torch.from_numpy(pts), tgrid, radius, 1,
                                       "bidirectional", torch.from_numpy(mask), budget, chunk)
        np.testing.assert_array_equal(got.lat_idx.numpy(), np.asarray(want.lat_idx))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        assert tgg.max_slot_degree(got) == budget
    wide = tgg.build_budgeted_slots(torch.from_numpy(pts), tgrid, radius, 1, "bidirectional",
                                    torch.from_numpy(mask), None, 128)
    np.testing.assert_array_equal(wide.mask.numpy(), np.asarray(js.mask))


# --- the build against the native host build

BAND = 3e-5  # of r^2: one rounding of each cell coordinate moves d^2 by about 6e-6 r^2 here


def test_build_against_the_native_host_build_within_the_band():
    """A seeded 200,000-point cloud on the recipe's grid, bidirectional,
    r 0.033. The native host build (native/gaot_graph.cpp) computes lo + i * h
    with one rounding where the compiler contracts it; so a slot may differ,
    and each slot that differs must lie within BAND * r^2 of the radius (its
    d^2 taken in float64). The count is printed; none is fine too."""
    _, tgrid, radius, _, _ = _grids("recipe")
    pts = np.random.default_rng(2024).uniform(-1, 1, (200_000, 3)).astype(np.float32)
    port = tgg.build_edge_slots(torch.from_numpy(pts), tgrid, radius, 1, "bidirectional")
    lat, msk = port.lat_idx.numpy(), port.mask.numpy()
    h_lat, h_msk = build_edge_slots_host(pts, tgrid, radius, 1, "bidirectional")
    np.testing.assert_array_equal(h_lat, lat)  # the same windows
    rows, cols = np.nonzero(h_msk != msk)
    print(f"slots that differ from the host build: {rows.size} of {msk.size}")
    cells = tgrid.positions_from_idx(torch.from_numpy(lat[rows, cols].astype(np.int64)))
    d2 = ((cells.double().numpy() - pts[rows].astype(np.float64)) ** 2).sum(axis=1)
    r2 = float(np.float32(radius)) ** 2
    assert np.all(np.abs(d2 - r2) <= BAND * r2), (rows, cols, d2)


# --- the whole model without precomputed slots


def _jax_and_port(seed, slot_budget=None):
    jmodel = _with_attention_dtype(_flagship_model(slot_budget=slot_budget), "float32")
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 64, 2)).astype(np.float32)
    mask = np.ones((2, 64), bool)
    mask[1, -9:] = False
    params = jmodel.init({"params": jax.random.key(seed)}, jnp.asarray(pos),
                         jnp.asarray(feats), jnp.asarray(mask))
    magno, attn = _port_configs(jmodel)
    pmodel = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=jmodel.latent_tokens,
                        device="cpu")
    load_numpy_state_dict(pmodel, state_dict_from_params(params, jmodel.magno_config,
                                                         jmodel.attn_config))
    return jmodel, params, pmodel.eval(), (pos, feats, mask)


@pytest.mark.parametrize("slot_budget", [None, 12])
def test_model_without_slots_matches_jax(slot_budget):
    """Both models build their slots inside the forward (the 4x4x4 window
    has K 64; budget 12 compacts it), f32 attention: rtol 1e-4, atol 1e-5."""
    jmodel, params, pmodel, (pos, feats, mask) = _jax_and_port(3, slot_budget)
    want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
    t = torch.from_numpy
    with torch.inference_mode():
        got = pmodel(t(pos), t(feats), t(mask))
    assert got.shape == (2, 64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("slot_budget", [None, 12])
def test_model_with_query_points_matches_jax(slot_budget):
    """Queries distinct from the input points, a third of them masked out."""
    jmodel, params, pmodel, (pos, feats, mask) = _jax_and_port(4, slot_budget)
    rng = np.random.default_rng(40)
    qpos = rng.uniform(-1, 1, (2, 48, 3)).astype(np.float32)
    qmask = rng.random((2, 48)) < 0.67
    want = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask),
                        query_pos=jnp.asarray(qpos), query_mask=jnp.asarray(qmask))
    t = torch.from_numpy
    with torch.inference_mode():
        got = pmodel(t(pos), t(feats), t(mask), query_pos=t(qpos), query_mask=t(qmask))
        every = pmodel(t(pos), t(feats), t(mask), query_pos=t(qpos))
        all_true = pmodel(t(pos), t(feats), t(mask), query_pos=t(qpos),
                          query_mask=torch.ones(2, 48, dtype=torch.bool))
    assert got.shape == (2, 48, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert torch.equal(every, all_true)  # query_mask defaults to all true
    assert not torch.equal(every, got)


def test_built_slots_equal_slots_passed_in():
    """The forward that builds its slots is the forward on the same slots
    passed in, bit for bit, with and without query points."""
    _, _, pmodel, (pos, feats, mask) = _jax_and_port(5, 12)
    cfg = pmodel.magno_config
    t = torch.from_numpy
    slots = tgg.build_budgeted_slots(t(pos), pmodel.grid, cfg.gno_radius, cfg.k_neighbors,
                                     "bidirectional", t(mask), cfg.slot_budget,
                                     cfg.edge_chunk_size)
    qpos = t(np.random.default_rng(50).uniform(-1, 1, (2, 32, 3)).astype(np.float32))
    qslots = tgg.build_budgeted_slots(qpos, pmodel.grid, cfg.gno_radius, cfg.k_neighbors,
                                      "bidirectional", None, cfg.slot_budget,
                                      cfg.edge_chunk_size)
    with torch.inference_mode():
        built = pmodel(t(pos), t(feats), t(mask))
        given = pmodel(t(pos), t(feats), t(mask), encoder_slots=[slots], decoder_slots=[slots])
        q_built = pmodel(t(pos), t(feats), t(mask), query_pos=qpos)
        q_given = pmodel(t(pos), t(feats), t(mask), query_pos=qpos, encoder_slots=[slots],
                         decoder_slots=[qslots])
        enc_only = pmodel(t(pos), t(feats), t(mask), query_pos=qpos, encoder_slots=[slots])
    assert torch.equal(built, given)
    assert torch.equal(q_built, q_given) and torch.equal(q_built, enc_only)


def test_build_is_shared_only_where_the_sides_agree():
    """One build serves both sides when they build the same slots from the
    same points; queries, or a decoder of another strategy, build their own."""
    from gaot3d_tpu_torch.models import magno

    _, _, pmodel, (pos, feats, mask) = _jax_and_port(6, 12)
    calls = []
    build = magno.build_budgeted_slots

    def counted(points, grid, radius, k, strategy, *args):
        calls.append(strategy)
        return build(points, grid, radius, k, strategy, *args)

    t = torch.from_numpy
    with mock.patch.object(magno, "build_budgeted_slots", counted), torch.inference_mode():
        pmodel(t(pos), t(feats), t(mask))
        assert calls == ["bidirectional"]
        pmodel(t(pos), t(feats), t(mask), query_pos=t(pos).clone(), query_mask=t(mask))
        assert calls == ["bidirectional"] * 3
        cfg = dataclasses.replace(pmodel.magno_config, neighbor_strategy=["bidirectional", "knn"])
        pmodel.decoder.build_slots = magno.SlotBuild(cfg, pmodel.grid, "knn")
        pmodel(t(pos), t(feats), t(mask))
        assert calls == ["bidirectional"] * 4 + ["knn"]
