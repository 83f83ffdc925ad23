"""The port's MAGNO variant modules against their JAX twins on the CPU.

IntegralTransform (the three transform types, no attention or cosine or
dot-product attention, both directions, the 'sort' and 'scatter'
reductions), GeometricEmbedding (statistical and PointNet, max and mean
pooling, both directions), FusedDecoderScale, the fused encoder without a
GNO and with a nonlinear one, the four segment folds and the edge sampling
run in both packages on the same numpy inputs from a seed, on the slots of
tests/test_degree_sections.py `_problem` (64 points a sample, a 4x4x4 grid,
node chunks of 16). Weights go from the JAX module to the port through
gaot3d_tpu/torch_export.py's own per-module writers.

Limits, relative to the size of the reference (L2 over the whole tensor):
forward 1e-5, gradients 1e-4 (f32 sums in another order; the online
softmax's running maxima); sampling masks exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.models import fused_decoder as jfd
from gaot3d_tpu.models import fused_encoder as jfe
from gaot3d_tpu.models import geoembed as jgeo
from gaot3d_tpu.models import integral_transform as jit_
from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.ops import sampling as jsmp
from gaot3d_tpu.ops import segment as jseg
from gaot3d_tpu.torch_export import _put_geo, _put_it
from gaot3d_tpu_torch.models.fused_decoder import FusedDecoderScale
from gaot3d_tpu_torch.models.fused_encoder import FusedEncoderScale, StatisticalGeoEmbedding
from gaot3d_tpu_torch.models.geoembed import GeometricEmbedding
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform
from gaot3d_tpu_torch.ops import sampling as psmp
from gaot3d_tpu_torch.ops import segment as pseg
from gaot3d_tpu_torch.ops.grid_graph import EdgeSlots, LatentGrid
from test_degree_sections import _problem
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False

FWD, GRAD = 1e-5, 1e-4
DIMS, M, CHUNK = (4, 4, 4), 64, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def assert_rel(got, want, tol, what=""):
    assert np.shape(got) == np.shape(want), what
    assert np.isfinite(got).all(), what
    r = rel(got, want)
    assert r <= tol, f"{what}: relative L2 {r:.3e} > {tol}"


def _load(module, put, params, *args):
    """The JAX module's params through torch_export's writer into `module`."""
    out = {}
    put(out, "m", params["params"], *args)
    module.load_state_dict({k[2:]: _t(v) for k, v in out.items()}, strict=True)
    return module


def _slots(seed=23):
    pos, feats, _, mask, lat, msk = _problem(seed=seed)
    return pos, mask, lat, msk


def _jax_vjp(fn, rng, *primals):
    """fn(*primals), a cotangent of its shape drawn from `rng` and the
    gradient of <fn, cot> for each primal, from one forward and one backward
    of the jitted fn."""
    out, pull = jax.vjp(jax.jit(fn), *primals)
    cot = rng.normal(size=out.shape).astype(np.float32)
    return out, cot, pull(jnp.asarray(cot))


def _port_grads(out, params, cot):
    return torch.autograd.grad(out, params, _t(cot), allow_unused=False)


# -- IntegralTransform ------------------------------------------------------------

TRANSFORMS = ("linear", "nonlinear", "nonlinear_kernelonly")
ATTENTION = (None, "cosine", "dot_product")


@pytest.mark.parametrize("segment_impl", ["sort", "scatter"])
@pytest.mark.parametrize("direction", ["encoder", "decoder"])
@pytest.mark.parametrize("attention", ATTENTION, ids=["no_attn", "cosine", "dot_product"])
@pytest.mark.parametrize("transform", TRANSFORMS)
def test_integral_transform_matches_jax(transform, attention, direction, segment_impl):
    """Output, the kernel MLP's and the projections' gradients, and the
    source features' gradient."""
    pos, _, lat, msk = _slots(seed=23 + TRANSFORMS.index(transform))
    B, N, _ = pos.shape
    C = 8
    rng = np.random.default_rng(5)
    src = rng.normal(size=(B, N if direction == "encoder" else M, C)).astype(np.float32)
    layers = (6 + (C if transform != "linear" else 0), 16, 16, C)
    jgrid = jgg.LatentGrid(dims=DIMS)
    jmod = jit_.IntegralTransform(
        channel_mlp_layers=layers, transform_type=transform, use_attn=attention is not None,
        attention_type=attention or "cosine", edge_chunk_size=CHUNK, grid=jgrid,
        segment_impl=segment_impl)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    args = (slots, jnp.asarray(pos), jgrid.positions())
    params = jmod.init(jax.random.key(3), *args, jnp.asarray(src), direction=direction)

    def run(p, s=jnp.asarray(src)):
        return jmod.apply(p, *args, s, direction=direction)

    want, cot, (jg, jsrc) = _jax_vjp(run, rng, params, jnp.asarray(src))
    jg = jg["params"]

    pmod = IntegralTransform(list(layers), LatentGrid(dims=DIMS), transform,
                             use_attn=attention is not None, attention_type=attention or "cosine",
                             edge_chunk_size=CHUNK, segment_impl=segment_impl)
    _load(pmod, _put_it, params, len(layers) - 1, attention == "dot_product")
    src_t = _t(src).requires_grad_()
    got = pmod(EdgeSlots.from_numpy(lat, msk), _t(pos), src_t, direction=direction)
    assert_rel(got.detach().numpy(), want, FWD, "output")
    names = [n for n, _ in pmod.named_parameters()]
    grads = _port_grads(got, [src_t] + list(pmod.parameters()), cot)
    assert_rel(grads[0].numpy(), jsrc, GRAD, "source features")
    want_g = {}
    _put_it(want_g, "m", jg, len(layers) - 1, attention == "dot_product")
    by_name = dict(zip(names, grads[1:]))
    for name, g in by_name.items():
        if name == "key_proj.bias":
            # q . k_b is the same for every edge of a query, which the softmax
            # cancels: the gradient is 0 up to rounding in both packages, held
            # against the key weights' gradient instead
            scale = np.linalg.norm(want_g["m.key_proj.weight"])
            assert np.linalg.norm(g.numpy()) <= GRAD * scale
            assert np.linalg.norm(want_g["m." + name]) <= GRAD * scale
            continue
        assert_rel(g.numpy(), want_g["m." + name], GRAD, name)


def test_integral_transform_encoder_without_features_and_empty_cells():
    """A kernel of coordinates alone (src_feats None) and cells no edge
    reaches: both give JAX's zeros for the empty cells."""
    pos, _, lat, msk = _slots(seed=29)
    msk = msk & (lat != 5)  # cell 5 loses every edge
    jgrid = jgg.LatentGrid(dims=DIMS)
    jmod = jit_.IntegralTransform(channel_mlp_layers=(6, 16, 8), use_attn=True,
                                  edge_chunk_size=CHUNK, grid=jgrid)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    args = (slots, jnp.asarray(pos), jgrid.positions(), None)
    params = jmod.init(jax.random.key(1), *args, direction="encoder")
    want = np.asarray(jmod.apply(params, *args, direction="encoder"))
    pmod = _load(IntegralTransform([6, 16, 8], LatentGrid(dims=DIMS), use_attn=True,
                                   edge_chunk_size=CHUNK), _put_it, params, 2)
    got = pmod(EdgeSlots.from_numpy(lat, msk), _t(pos), None, direction="encoder")
    assert_rel(got.detach().numpy(), want, FWD)
    assert (got[:, 5] == 0).all() and (want[:, 5] == 0).all()


# -- GeometricEmbedding -----------------------------------------------------------


@pytest.mark.parametrize("segment_impl", ["sort", "scatter"])
@pytest.mark.parametrize("direction", ["encoder", "decoder"])
@pytest.mark.parametrize("pooling", ["max", "mean"])
@pytest.mark.parametrize("method", ["statistical", "pointnet"])
def test_geoembed_matches_jax(method, pooling, direction, segment_impl):
    """Output and the MLPs' gradients; the decoder's z-normalisation over
    the valid queries of a query mask with padding rows."""
    pos, mask, lat, msk = _slots(seed=31)
    mask = mask.copy()
    mask[1, -5:] = False  # padding rows: no edge, left out of the statistics
    msk = msk & mask[..., None]
    C = 8
    jgrid = jgg.LatentGrid(dims=DIMS)
    jmod = jgeo.GeometricEmbedding(input_dim=3, output_dim=C, method=method, pooling=pooling,
                                   edge_chunk_size=CHUNK, segment_impl=segment_impl, grid=jgrid)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    qm = jnp.asarray(mask) if direction == "decoder" else None
    args = (slots, jnp.asarray(pos), jgrid.positions())
    params = jmod.init(jax.random.key(4), *args, direction=direction, query_mask=qm)

    def run(p):
        return jmod.apply(p, *args, direction=direction, query_mask=qm)

    want, cot, (jg,) = _jax_vjp(run, np.random.default_rng(6), params)
    jg = jg["params"]
    pmod = _load(GeometricEmbedding(3, C, method, pooling, CHUNK, segment_impl,
                                    LatentGrid(dims=DIMS)), _put_geo, params, method)
    got = pmod(EdgeSlots.from_numpy(lat, msk), _t(pos), direction,
               query_mask=_t(mask) if direction == "decoder" else None)
    assert_rel(got.detach().numpy(), want, FWD, "output")
    want_g = {}
    _put_geo(want_g, "m", jg, method)
    names = [n for n, _ in pmod.named_parameters()]
    for name, g in zip(names, _port_grads(got, list(pmod.parameters()), cot)):
        assert_rel(g.numpy(), want_g["m." + name], GRAD, name)


# -- FusedDecoderScale and the fused encoder's variants ----------------------------


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_fused_decoder_matches_jax(transform):
    pos, mask, lat, msk = _slots(seed=37)
    mask = mask.copy()
    mask[0, :3] = False
    msk = msk & mask[..., None]
    B, N, _ = pos.shape
    C = 8
    rng = np.random.default_rng(8)
    latent = rng.normal(size=(B, M, C)).astype(np.float32)
    layers = (6 + (C if transform != "linear" else 0), 16, C)
    jgrid = jgg.LatentGrid(dims=DIMS)
    jmod = jfd.FusedDecoderScale(channels=C, kernel_layers=layers, transform_type=transform,
                                 grid=jgrid, edge_chunk_size=CHUNK)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))

    def run(p, feats=jnp.asarray(latent)):
        gno, geo = jmod.apply(p, slots, jnp.asarray(pos), feats, jgrid.positions(),
                              query_mask=jnp.asarray(mask))
        return jnp.concatenate([gno, geo], axis=-1)

    params = jmod.init(jax.random.key(2), slots, jnp.asarray(pos), jnp.asarray(latent),
                       jgrid.positions(), query_mask=jnp.asarray(mask))
    want, cot, (jg, jlat) = _jax_vjp(run, rng, params, jnp.asarray(latent))
    jg = jg["params"]

    grid = LatentGrid(dims=DIMS)
    gno = IntegralTransform(list(layers), grid, transform)
    geo = StatisticalGeoEmbedding(3, C, grid)
    p = params["params"]
    _load(gno, _put_it, {"params": p}, len(layers) - 1)
    _load(geo, _put_geo, {"params": {f"mlp_{k[4:]}": v for k, v in p.items()
                                     if k.startswith("geo_")}}, "statistical")
    fused = FusedDecoderScale(gno, geo, CHUNK)
    lat_t = _t(latent).requires_grad_()
    out = torch.cat(fused(EdgeSlots.from_numpy(lat, msk), _t(pos), lat_t, _t(mask)), dim=-1)
    assert_rel(out.detach().numpy(), want, FWD, "output")
    params_t = [lat_t] + list(gno.parameters()) + list(geo.parameters())
    grads = _port_grads(out, params_t, cot)
    assert_rel(grads[0].numpy(), jlat, GRAD, "latent features")
    for i, fc in enumerate(gno.channel_mlp.fcs):
        assert_rel(grads[1 + 2 * i].numpy(), np.asarray(jg[f"kernel_w{i}"]).T, GRAD, f"w{i}")
    assert_rel(grads[-4].numpy(), np.asarray(jg["geo_w0"]).T, GRAD, "geo_w0")


@pytest.mark.parametrize("segment_impl", ["scatter", "sort"])
@pytest.mark.parametrize("variant", ["use_gno false", "nonlinear", "nonlinear_kernelonly"])
def test_fused_encoder_variants_match_jax(variant, segment_impl):
    """`use_gno: false` (the 11 geometry columns alone) and the nonlinear
    transforms run the plain payload, reduced by `segment_impl`."""
    pos, _, lat, msk = _slots(seed=41)
    B, N, _ = pos.shape
    C = 8
    use_gno = variant != "use_gno false"
    transform = variant if use_gno else "linear"
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(B, N, C)).astype(np.float32) if use_gno else None
    layers = (6 + (C if transform != "linear" else 0), 16, C)
    jgrid = jgg.LatentGrid(dims=DIMS)
    jmod = jfe.FusedEncoderScale(lifting_channels=C, kernel_layers=layers if use_gno else (),
                                 transform_type=transform, grid=jgrid, edge_chunk_size=CHUNK,
                                 segment_impl=segment_impl, use_gno=use_gno)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    jf = None if feats is None else jnp.asarray(feats)

    def run(p):
        gno, geo = jmod.apply(p, slots, jnp.asarray(pos), jf, jgrid.positions())
        return geo if gno is None else jnp.concatenate([gno, geo], axis=-1)

    params = jmod.init(jax.random.key(5), slots, jnp.asarray(pos), jf, jgrid.positions())
    want = jax.jit(run)(params)
    grid = LatentGrid(dims=DIMS)
    p = params["params"]
    gno = _load(IntegralTransform(list(layers), grid, transform), _put_it, params,
                len(layers) - 1) if use_gno else None
    geo = _load(StatisticalGeoEmbedding(3, C), _put_geo,
                {"params": {f"mlp_{k[4:]}": v for k, v in p.items() if k.startswith("geo_")}},
                "statistical")
    fused = FusedEncoderScale(gno, geo, grid, C, CHUNK, segment_impl=segment_impl)
    g_out, geo_out = fused(EdgeSlots.from_numpy(lat, msk), _t(pos),
                           None if feats is None else _t(feats))
    assert (g_out is None) == (not use_gno)
    got = geo_out if g_out is None else torch.cat([g_out, geo_out], dim=-1)
    assert_rel(got.detach().numpy(), want, FWD)


# -- the folds --------------------------------------------------------------------


def _seg_problem(seed, E=300, S=40, C=5):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(E, C)).astype(np.float32)
    ids = rng.integers(0, S, E).astype(np.int32)
    ids[ids == 7] = 8  # segment 7 stays empty
    mask = rng.random(E) < 0.8
    return data, ids, mask, S


@pytest.mark.parametrize("empty", [0.0, -np.inf])
def test_segment_max_and_fold_max_match_jax(empty):
    data, ids, mask, S = _seg_problem(1)
    want = np.asarray(jseg.segment_max(jnp.asarray(data), jnp.asarray(ids), S,
                                       jnp.asarray(mask), empty_value=empty))
    got = pseg.segment_max(_t(data), _t(ids), S, _t(mask), empty_value=empty).numpy()
    np.testing.assert_array_equal(got, want)
    ctx = jseg.make_segment_fold(jnp.asarray(ids), S, jnp.asarray(mask))
    jfold = np.asarray(jseg.fold_max(ctx, jnp.asarray(data), empty_value=empty))
    pfold = pseg.fold_max(pseg.make_segment_fold(_t(ids), S, _t(mask)), _t(data),
                          empty_value=empty).numpy()
    np.testing.assert_array_equal(pfold, jfold)
    np.testing.assert_array_equal(pfold, got)
    one = pseg.fold_max(pseg.make_segment_fold(_t(ids), S, _t(mask)), _t(data[:, 0]),
                        empty_value=empty).numpy()
    np.testing.assert_array_equal(one, got[:, 0])


def test_segment_max_gradient_matches_jax():
    data, ids, mask, S = _seg_problem(2)
    cot = np.random.default_rng(3).normal(size=(S, data.shape[1])).astype(np.float32)
    want = jax.grad(lambda d: jnp.vdot(jseg.segment_max(d, jnp.asarray(ids), S,
                                                        jnp.asarray(mask)),
                                       jnp.asarray(cot)))(jnp.asarray(data))
    d = _t(data).requires_grad_()
    (got,) = torch.autograd.grad(pseg.segment_max(d, _t(ids), S, _t(mask)), d, _t(cot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f = _t(data).requires_grad_()
    (gf,) = torch.autograd.grad(pseg.fold_max(pseg.make_segment_fold(_t(ids), S, _t(mask)), f),
                                f, _t(cot))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(want))


def test_gather_table_and_its_backward_match_jax():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(20, 6)).astype(np.float32)
    idx = rng.integers(-3, 24, 90).astype(np.int32)  # some out of range: clipped
    mask = rng.random(90) < 0.7
    cot = rng.normal(size=(90, 6)).astype(np.float32)
    want = jseg.gather_table(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(mask))
    wgrad = jax.grad(lambda t: jnp.vdot(jseg.gather_table(t, jnp.asarray(idx),
                                                          jnp.asarray(mask)),
                                        jnp.asarray(cot)))(jnp.asarray(table))
    t = _t(table).requires_grad_()
    got = pseg.gather_table(t, _t(idx), _t(mask))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g,) = torch.autograd.grad(got, t, _t(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(wgrad), rtol=1e-6, atol=1e-6)


def test_segment_softmax_matches_jax():
    data, ids, mask, S = _seg_problem(5, C=1)
    scores = data[:, 0] * 30.0  # wide logits: the max shift matters
    want = jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), S, jnp.asarray(mask))
    got = pseg.segment_softmax(_t(scores), _t(ids), S, _t(mask))
    assert_rel(got.numpy(), np.asarray(want), FWD)
    sums = pseg.segment_sum(got, _t(ids), S, _t(mask))
    filled = np.isin(np.arange(S), ids[mask])
    np.testing.assert_allclose(sums.numpy()[filled], 1.0, rtol=1e-6)
    assert (got.numpy()[~mask] == 0).all()


# -- sampling ---------------------------------------------------------------------


def _keys(seed, shape):
    return np.asarray(jax.random.uniform(jax.random.key(seed), shape))


def test_dropout_edges_takes_jax_keep_masks_and_draws_its_own():
    _, _, lat, msk = _slots(seed=43)
    rng = jax.random.key(11)
    want = jsmp.dropout_edges(jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk)), 0.5, rng)
    keep = np.asarray(jax.random.bernoulli(rng, 0.5, msk.shape))
    got = psmp.dropout_edges(EdgeSlots.from_numpy(lat, msk), 0.5, _t(keep))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    # JAX's uniform draws as U[0, 1) keys give the same mask (u < 1 - rate)
    u = _keys(11, msk.shape)
    np.testing.assert_array_equal(
        psmp.dropout_edges(EdgeSlots.from_numpy(lat, msk), 0.3, _t(u)).mask.numpy(),
        msk & (u < 0.7))
    # the port's own generator: keep rate within 5 binomial sigmas, seeded
    big = EdgeSlots(torch.zeros((4, 5000, 8), dtype=torch.int32),
                    torch.ones((4, 5000, 8), dtype=torch.bool))
    a = psmp.dropout_edges(big, 0.3, torch.Generator().manual_seed(0)).mask
    b = psmp.dropout_edges(big, 0.3, torch.Generator().manual_seed(0)).mask
    n = a.numel()
    assert torch.equal(a, b)
    assert abs(a.sum().item() - 0.7 * n) <= 5 * (n * 0.7 * 0.3) ** 0.5


@pytest.mark.parametrize("draws", ["slot order", "jax keys"])
def test_cap_per_query_scatter_matches_jax(draws):
    """The encoder's cap per latent cell, each sample ranked on its own,
    with a sentinel of num_segments (a sample's E is below M here: a real
    cell id equals E)."""
    pos, _, lat, msk = _slots(seed=47)
    lat, msk = lat[:, :8], msk[:, :8]  # E = 8 * K < M = 64
    B = lat.shape[0]
    cap = 2
    keys = None
    want = []
    for b in range(B):
        r = jax.random.key(100 + b) if draws == "jax keys" else None
        s = jsmp.cap_per_query_scatter(jgg.EdgeSlots(jnp.asarray(lat[b]), jnp.asarray(msk[b])),
                                       cap, rng=r, num_segments=M)
        want.append(np.asarray(s.mask))
    if draws == "jax keys":
        keys = _t(np.stack([_keys(100 + b, (lat[b].size,)) for b in range(B)]))
    got = psmp.cap_per_query_scatter(EdgeSlots.from_numpy(lat, msk), cap, rng=keys,
                                     num_segments=M)
    np.testing.assert_array_equal(got.mask.numpy(), np.stack(want))
    jrank = jsmp._rank_within_segment(jnp.asarray(lat[0].reshape(-1)),
                                      jnp.asarray(msk[0].reshape(-1)),
                                      jnp.arange(lat[0].size), num_segments=M)
    for key in (torch.arange(lat[0].size)[None], None):  # a key in edge order, or none
        prank = psmp._rank_within_segment(_t(lat[:1].reshape(1, -1)),
                                          _t(msk[:1].reshape(1, -1)), key, num_segments=M)
        np.testing.assert_array_equal(prank.numpy()[0], np.asarray(jrank))


@pytest.mark.parametrize("draws", ["slot order", "jax keys"])
def test_cap_per_query_gather_matches_jax(draws):
    _, _, lat, msk = _slots(seed=53)
    r = jax.random.key(7) if draws == "jax keys" else None
    want = jsmp.cap_per_query_gather(jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk)), 2, rng=r)
    keys = _t(_keys(7, msk.shape)) if r is not None else None
    got = psmp.cap_per_query_gather(EdgeSlots.from_numpy(lat, msk), 2, rng=keys)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_caps_from_the_ports_generator_keep_at_most_cap():
    _, _, lat, msk = _slots(seed=59)
    slots = EdgeSlots.from_numpy(lat, msk)
    for cap in (1, 3):
        g = psmp.cap_per_query_gather(slots, cap, torch.Generator().manual_seed(cap)).mask
        assert (g.sum(-1) <= cap).all() and (g.sum(-1) == msk.sum(-1).clip(max=cap)).all()
        assert (g <= slots.mask).all()
        s = psmp.cap_per_query_scatter(slots, cap, torch.Generator().manual_seed(cap),
                                       num_segments=M).mask
        for b in range(lat.shape[0]):
            kept = np.bincount(lat[b][s[b].numpy()], minlength=M)
            avail = np.bincount(lat[b][msk[b]], minlength=M)
            np.testing.assert_array_equal(kept, np.minimum(avail, cap))


def test_centred_fold_keeps_the_digits_the_kernel_prefix_loses(monkeypatch):
    """K7's prefix rounds to its running size, so a segment sum Z[end] -
    Z[start] of raw distances, or of coordinates ordered with the cells,
    loses digits a cell. `fold_sum_centred` folds the deviations from a
    baseline, whose prefix is a random walk of their size: within 1e-5 of
    the largest sum (the raw folds' error is 30x and more). K7's own bits
    come from its ordered twin here."""
    from gaot3d_tpu_torch.kernels import prefix_sum as k7
    from gaot3d_tpu_torch.kernels import tile_segment_sum as k8

    monkeypatch.setattr(k8, "cumsum_fast",
                        lambda x: k7.prefix_sum_ordered_reference(x.to(torch.float32)))
    rng = np.random.default_rng(12)
    E, S = 300_000, 60_000
    seg = np.sort(rng.integers(0, S, E)).astype(np.int32)
    centre = np.linspace(-1, 1, S).astype(np.float32)
    dist = rng.uniform(0.01, 0.03, E).astype(np.float32)
    x = (centre[seg] + rng.uniform(-0.01, 0.01, E)).astype(np.float32)
    data = np.stack([dist, x], axis=1)
    exact = np.zeros((S, 2))
    np.add.at(exact, seg, data.astype(np.float64))
    ctx = pseg.make_segment_fold(_t(seg), S, None)
    base = torch.stack([torch.full((S,), float(dist.mean())), _t(centre)], dim=1)
    raw = pseg.fold_sum(ctx, _t(data)).numpy()
    centred = pseg.fold_sum_centred(ctx, _t(data), base).numpy()
    default = pseg.fold_sum_centred(ctx, _t(data[:, :1])).numpy()
    scale = np.abs(exact).max(0)
    err_raw = np.abs(raw - exact).max(0) / scale
    err_centred = np.abs(centred - exact).max(0) / scale
    assert (err_centred <= 1e-5).all(), err_centred
    assert (err_raw >= 30 * err_centred).all(), (err_raw, err_centred)
    assert np.abs(default[:, 0] - exact[:, 0]).max() / scale[0] <= 1e-5
