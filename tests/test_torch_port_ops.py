"""The PyTorch port's ops and modules against their JAX counterparts on CPU.

Inputs come from numpy seeds and go through both packages. Tolerances are
f32-grade unless a test says otherwise; TF32 is off on the port's side.
"""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu import models as jmodels
from gaot3d_tpu.models import fused_encoder as jfe
from gaot3d_tpu.models import integral_transform as jit_
from gaot3d_tpu.models import transformer as jtr
from gaot3d_tpu.ops import eigh3 as jeigh
from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.ops import rope as jrope
from gaot3d_tpu.ops import segment as jseg
from gaot3d_tpu.torch_export import _put_block, _put_processor
from gaot3d_tpu_torch import models as pmodels
from gaot3d_tpu_torch.data import host_graph
from gaot3d_tpu_torch.models import transformer as ptr
from gaot3d_tpu_torch.models.fused_encoder import FusedEncoderScale, StatisticalGeoEmbedding
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform
from gaot3d_tpu_torch.ops import eigh3 as peigh
from gaot3d_tpu_torch.ops import rope as prope
from gaot3d_tpu_torch.ops import segment as pseg
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, flat, prefix=""):
    """{prefix + key: np.ndarray} -> module (strict)."""
    sd = {k[len(prefix):]: _t(v) for k, v in flat.items() if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module


def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|gaot3d_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gaot3d_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    offenders = [f for f in files if pat.search(open(f).read())]
    assert offenders == []


@pytest.mark.parametrize("jcls,pcls", [
    (jmodels.MAGNOConfig, pmodels.MAGNOConfig),
    (jtr.AttentionConfig, ptr.AttentionConfig),
    (jtr.FFNConfig, ptr.FFNConfig),
    (jtr.TransformerConfig, ptr.TransformerConfig),
])
def test_config_dataclasses_match(jcls, pcls):
    jf, pf = dataclasses.fields(jcls), dataclasses.fields(pcls)
    assert [f.name for f in jf] == [f.name for f in pf]
    assert dataclasses.asdict(jcls()) == dataclasses.asdict(pcls())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches(dtype):
    x = np.random.default_rng(0).normal(size=(2, 4, 10, 8)).astype(np.float32)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = prope.apply_rope(_t(x).to(getattr(torch, dtype))).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    """Normalised in f32, cast back to the input type, then times the weight."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    want = jtr.RMSNorm(1e-6).apply({"params": {"weight": jnp.asarray(w)}},
                                   jnp.asarray(x).astype(dtype))
    norm = ptr.RMSNorm(16, 1e-6)
    norm.weight.data = _t(w)
    got = norm(_t(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=1e-6)


def _attn_cfg(rope):
    return jtr.AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2, atten_dropout=0.0,
                               attention_dtype="float32",
                               positional_embedding="rope" if rope else "absolute")


@pytest.mark.parametrize("skip,rope", [(False, False), (True, True)])
def test_transformer_block_matches(skip, rope):
    """Covers kv-repeat, sequence-order RoPE and the FFN residual taken from
    the normed h."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    s = rng.normal(size=(2, 16, 32)).astype(np.float32) if skip else None
    rel = jnp.zeros((16, 3)) if rope else None
    acfg, fcfg = _attn_cfg(rope), jtr.FFNConfig(hidden_size=64)
    jblk = jtr.TransformerBlock(32, 32, attn_config=acfg, ffn_config=fcfg, skip_connection=skip)
    args = (jnp.asarray(x), None, rel, None if s is None else jnp.asarray(s))
    params = jblk.init(jax.random.key(0), *args)
    want = jblk.apply(params, *args)
    flat = {}
    _put_block(flat, "b", params["params"], skip=skip)
    pblk = ptr.TransformerBlock(32, True, True, 1e-6, ptr.AttentionConfig(**acfg.__dict__),
                                ptr.FFNConfig(**fcfg.__dict__), skip_connection=skip)
    _load(pblk, flat, "b.")
    got = pblk(_t(x), relative_positions=_t(np.zeros((16, 3))) if rope else None,
               skip=None if s is None else _t(s))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("num_layers", [2, 3])
def test_uvit_processor_matches(num_layers):
    """U-skips, the optional middle block and the in/out projections."""
    x = np.random.default_rng(3).normal(size=(1, 12, 16)).astype(np.float32)
    cfg = jtr.TransformerConfig(patch_size=2, hidden_size=32, num_layers=num_layers,
                                positional_embedding="rope", attn_config=_attn_cfg(True),
                                ffn_config=jtr.FFNConfig(hidden_size=64))
    jproc = jtr.UViTProcessor(16, 16, cfg)
    rel = jnp.zeros((12, 3))
    params = jproc.init(jax.random.key(1), jnp.asarray(x), None, rel)
    want = jproc.apply(params, jnp.asarray(x), None, rel)
    flat = {}
    _put_processor(flat, params["params"], num_layers)
    pcfg = ptr.TransformerConfig(**{**cfg.__dict__,
                                    "attn_config": ptr.AttentionConfig(**cfg.attn_config.__dict__),
                                    "ffn_config": ptr.FFNConfig(**cfg.ffn_config.__dict__)})
    pproc = _load(ptr.UViTProcessor(16, 16, pcfg), flat, "processor.")
    got = pproc(_t(x), relative_positions=_t(np.zeros((12, 3))))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_eigh3_matches():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(200, 3, 3)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1)
    m[0] = np.eye(3) * 0.7  # isotropic: p == 0 branch
    m[1] = np.outer([1, 2, 3], [1, 2, 3])  # rank one
    want = np.asarray(jeigh.eigvalsh3x3_desc(jnp.asarray(m)))
    got = peigh.eigvalsh3x3_desc(_t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.all(np.diff(got, axis=1) <= 1e-6)  # descending


def test_segment_sum_matches_with_masked_garbage_ids():
    rng = np.random.default_rng(5)
    data = rng.normal(size=(50, 4)).astype(np.float32)
    ids = rng.integers(0, 7, 50).astype(np.int32)
    mask = rng.random(50) < 0.6
    ids[~mask] = 99999  # masked rows may carry any id
    want = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 7,
                                       jnp.asarray(mask)))
    got = pseg.segment_sum(_t(data), _t(ids), 7, _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("strategy,budget", [("bidirectional", 0), ("bidirectional", 8),
                                             ("radius", 6), ("knn", 0)])
def test_host_slots_match_jax_bitwise(strategy, budget):
    pts = np.random.default_rng(6).uniform(-1, 1, (3000, 3)).astype(np.float32)
    jgrid, pgrid = jgg.LatentGrid(dims=(8, 8, 4)), LatentGrid(dims=(8, 8, 4))
    want = jgg.build_edge_slots_host(pts, jgrid, 0.3, k_neighbors=2, strategy=strategy,
                                     budget=budget)
    got = host_graph.build_edge_slots_host(pts, pgrid, 0.3, k_neighbors=2, strategy=strategy,
                                           budget=budget)
    assert host_graph.stencil_widths(pgrid, 0.3, 2, strategy) == jgg.stencil_widths(
        jgrid, 0.3, 2, strategy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sectioning_matches_jax_bitwise():
    pts = np.random.default_rng(7).uniform(-1, 1, (4096, 3)).astype(np.float32)
    grid = LatentGrid(dims=(16, 16, 8))
    lat, msk = host_graph.build_edge_slots_host(pts, grid, 0.1, strategy="bidirectional")
    budget = int(msk.sum(1).max())
    lat_c, msk_c = host_graph.compact_slots_np(lat, msk, budget)
    jl, jm = jgg.compact_slots_np(lat, msk, budget)
    np.testing.assert_array_equal(lat_c, jl)
    np.testing.assert_array_equal(msk_c, jm)
    perm, secs = host_graph.section_slots_by_degree_np(lat_c, msk_c, 512)
    jperm, jsecs = jgg.section_slots_by_degree_np(lat_c, msk_c, 512)
    np.testing.assert_array_equal(perm, jperm)
    assert len(secs) == len(jsecs) > 1
    for (a, b), (c, d) in zip(secs, jsecs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="valid-first"):
        host_graph.section_slots_by_degree_np(lat_c, np.roll(msk_c, 1, axis=1), 512)


def _finalize_pair(seed, C=4, dims=(3, 3, 3)):
    """A JAX FusedEncoderScale and the port's, sharing geoembed weights."""
    jgrid = jgg.LatentGrid(dims=dims)
    jmod = jfe.FusedEncoderScale(lifting_channels=C, kernel_layers=(6, 8, C),
                                 transform_type="linear", grid=jgrid)
    M = jgrid.num_tokens
    acc0 = jnp.zeros((2, M, C + 11))
    params = jmod.init(jax.random.key(seed), acc0, 2, M, C, 3,
                       method=jfe.FusedEncoderScale._finalize)
    p = params["params"]
    geo = StatisticalGeoEmbedding(3, C)
    _load(geo, {"mlp.0.weight": np.asarray(p["geo_w0"]).T, "mlp.0.bias": p["geo_b0"],
                "mlp.2.weight": np.asarray(p["geo_w1"]).T, "mlp.2.bias": p["geo_b1"]})
    gno = IntegralTransform([6, 8, C], LatentGrid(dims=dims))
    return jmod, params, FusedEncoderScale(gno, geo, LatentGrid(dims=dims), C)


def _moments(rng, B, M, C, empty):
    """Accumulator of real point clouds per cell: counts, sums of d, y, yy^T."""
    acc = np.zeros((B, M, C + 11), np.float32)
    for b in range(B):
        for m in range(M):
            n = 0 if m in empty else int(rng.integers(1, 6))
            y = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
            acc[b, m, :C] = rng.normal(size=C) * n
            acc[b, m, C] = n
            acc[b, m, C + 1] = np.sqrt((y * y).sum(1)).sum()
            acc[b, m, C + 2:C + 5] = y.sum(0)
            acc[b, m, C + 5:] = [(y[:, i] * y[:, j]).sum() for i, j in
                                 ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    return acc


@pytest.mark.parametrize("case", ["moments", "constant_count"])
def test_finalize_matches(case):
    """Eigenvalue guard (pca > 1e-3 pca0), the batch-global z-norm with
    ddof=1 over B*M rows, the std < 1e-6 -> 1 guard and has_nb zeroing, on one
    shared accumulator (both guards are discontinuous, so the inputs are the
    same bits)."""
    rng = np.random.default_rng(8)
    jmod, params, pmod = _finalize_pair(0)
    M, C = 27, 4
    acc = _moments(rng, 2, M, C, empty={0, 5})
    if case == "constant_count":
        acc[..., C] = 3.0  # every cell non-empty, count column has std 0
    want_g, want_geo = jmod.apply(params, jnp.asarray(acc), 2, M, C, 3,
                                  method=jfe.FusedEncoderScale._finalize)
    got_g, got_geo = pmod._finalize(_t(acc))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_geo.detach().numpy(), np.asarray(want_geo),
                               atol=1e-5, rtol=1e-5)


def test_decoder_transform_matches():
    """Decoder GNO: kernel on [cell | point] (the encoder uses [point | cell]),
    values times the gathered latent features, masked mean over K; masked
    slots carry indices that must not matter."""
    rng = np.random.default_rng(9)
    B, n, K, C, dims = 2, 20, 4, 8, (3, 4, 5)
    M = 60
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    lat = rng.integers(0, M, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < 0.6
    latent = rng.normal(size=(B, M, C)).astype(np.float32)
    jgrid = jgg.LatentGrid(dims=dims)
    jmod = jit_.IntegralTransform(channel_mlp_layers=(6, 16, C), grid=jgrid)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    args = (slots, jnp.asarray(pos), jgrid.positions(), jnp.asarray(latent))
    params = jmod.init(jax.random.key(2), *args, direction="decoder")
    want = jmod.apply(params, *args, direction="decoder")
    p = params["params"]
    pmod = IntegralTransform([6, 16, C], LatentGrid(dims=dims))
    _load(pmod, {f"channel_mlp.fcs.{i}.{w}": (np.asarray(p[f"kernel_{w[0]}{i}"]).T
                                              if w == "weight" else p[f"kernel_b{i}"])
                 for i in range(2) for w in ("weight", "bias")})
    got = pmod.decoder_chunk(_t(latent), _t(pos), _t(lat), _t(msk))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
