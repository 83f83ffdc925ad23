"""The port's CUDA kernels against their plain versions on the card.

These tests need an NVIDIA GPU with nvcc (the kernels are built from
gaot3d_tpu_torch/csrc at first use) and skip without one. The file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from gaot3d_tpu_torch.kernels import decoder_payload as k9
from gaot3d_tpu_torch.kernels import dropout_bits as k4
from gaot3d_tpu_torch.kernels import elementwise_chain as t1
from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.kernels import flash_attention as k1
from gaot3d_tpu_torch.kernels import prefix_sum as k7
from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
from gaot3d_tpu_torch.kernels import slot_build as k10
from gaot3d_tpu_torch.kernels import tile_segment_sum as k8
from gaot3d_tpu_torch.models import (AttentionConfig, FFNConfig, MAGNOConfig,
                                     TransformerConfig, init_model)
from gaot3d_tpu_torch.models.integral_transform import IntegralTransform, effective_chunk
from gaot3d_tpu_torch.ops.grid_graph import (EdgeSlots, LatentGrid, build_budgeted_slots,
                                             build_edge_slots_batched, window_spec)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU: CUDA kernels have no CPU mode"),
]


@pytest.fixture(autouse=True)
def _exact_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _assert_out_close(out, ref):
    """f32: 1e-5 absolute. bf16: 2e-2 of the plain output's max-abs, which is
    two bf16 rounding steps at the top of the range (an absolute bound would
    exceed a typical value at long sequences, where |out| ~ 1/sqrt(Skv))."""
    err = (out.float() - ref.float()).abs().max().item()
    limit = 1e-5 if out.dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()
    assert err <= limit, f"max abs error {err} over the limit {limit}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,Skv,D", [(1000, 1000, 32), (4096, 4096, 32), (77, 130, 8),
                                       (200, 333, 64), (129, 64, 16)])
def test_flash_kernel_matches_twin(dtype, S, Skv, D):
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, s, D)).astype(np.float32))
               .to("cuda", dtype) for s in (S, Skv, Skv))
    before = k1.flash_attention.launches
    out, lse = k1.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert k1.flash_attention.launches == before + 1
    ref, ref_lse = k1.flash_attention_reference(q, k, v)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    _assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


def _encoder_problem(hid, C, K):
    rng = np.random.default_rng(hid + K)
    B, n, grid = 1, 20000, LatentGrid(dims=(16, 16, 8))
    M = grid.num_tokens
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    feats = rng.normal(size=(B, n, C)).astype(np.float32)
    lat = rng.integers(0, M, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < 0.6
    lat[~msk] = -7  # masked slots may hold any index
    lat[0, :3, 0], msk[0, :3, 0] = (M, -1, 2 ** 30), True  # valid but off the grid: dropped
    sizes = [6, hid, hid, hid, C]
    ws = [torch.from_numpy((rng.normal(size=(sizes[i + 1], sizes[i])) / sizes[i] ** 0.5)
                           .astype(np.float32)).cuda() for i in range(4)]
    bs = [torch.from_numpy(rng.normal(size=sizes[i + 1]).astype(np.float32) * 0.1).cuda()
          for i in range(4)]
    args = [torch.from_numpy(x).cuda() for x in (pos, feats, lat, msk)]
    return rng, args, ws, bs, grid


@pytest.mark.parametrize("hid,C,K", [(64, 32, 5), (64, 32, 1), (16, 8, 3)])
def test_encoder_kernel_matches_twin(hid, C, K):
    """Float atomics sum in a different order on every run: the bound is
    relative 1e-5 on the accumulator."""
    _, args, ws, bs, grid = _encoder_problem(hid, C, K)
    acc = torch.zeros((1, grid.num_tokens, C + 11), device="cuda")
    before = k5.encoder_accumulate.launches
    k5.encoder_accumulate(*args, ws, bs, grid, acc)
    torch.cuda.synchronize()
    assert k5.encoder_accumulate.launches == before + 1
    ref = k5.encoder_accumulate_reference(*args, ws, bs, grid,
                                          torch.zeros_like(acc), chunk=8192)
    rel = ((acc - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5


@pytest.mark.parametrize("hid,C,K", [(64, 32, 5), (64, 32, 1), (16, 8, 3), (32, 16, 2)])
def test_encoder_backward_kernel_matches_plain(hid, C, K):
    """K5b against autograd through the payload reference. dW and db sum
    20000*K rows in a run-dependent order (per-CTA partial sums, then float
    atomics): relative 1e-4 of each tensor's max-abs."""
    rng, args, ws, bs, grid = _encoder_problem(hid, C, K)
    g = torch.from_numpy(rng.normal(size=(1, grid.num_tokens, C + 11)).astype(np.float32)).cuda()
    before = k5.encoder_accumulate_backward.launches
    got = k5.encoder_accumulate_backward(g, *args, ws, bs, grid)
    torch.cuda.synchronize()
    assert k5.encoder_accumulate_backward.launches == before + 1
    want = k5.encoder_accumulate_backward_reference(g, *args, ws, bs, grid, chunk=4096)
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1])) + list(zip(got[2], want[2]))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


def test_encoder_autograd_threads_one_accumulator():
    """`accumulate` twice into one accumulator under autograd equals the
    plain versions' gradients; the accumulator's own gradient is the identity."""
    rng, args, ws, bs, grid = _encoder_problem(16, 8, 3)
    ws = [w.requires_grad_() for w in ws]
    feats = args[1].requires_grad_()
    acc0 = torch.zeros((1, grid.num_tokens, 19), device="cuda", requires_grad=True)
    acc = k5.accumulate(args[0], feats, args[2], args[3], ws, bs, grid, acc0 * 1.0)
    acc = k5.accumulate(args[0], feats, args[2], args[3], ws, bs, grid, acc)
    g = torch.from_numpy(rng.normal(size=tuple(acc.shape)).astype(np.float32)).cuda()
    got = torch.autograd.grad(acc, [acc0, feats, *ws], g)
    want = k5.encoder_accumulate_backward_reference(g, *[a.detach() for a in args], ws, bs, grid)
    torch.testing.assert_close(got[0], g)
    torch.testing.assert_close(got[1], 2 * want[0], atol=1e-4, rtol=1e-4)
    for a, b in zip(got[2:], want[1]):
        assert ((a - 2 * b).abs().max() / b.abs().max()).item() <= 1e-4


def _edge_problem(hid, C, K, B, n, n_mid, seed, valid=0.7):
    """Slots that reach every edge of K5's and K5b's node-major tiles: n not
    a multiple of the nodes a tile holds, masked slots (a share 1 - valid,
    anywhere among a node's slots) holding any index, and valid slots off the
    grid (dropped), in every batch."""
    rng = np.random.default_rng(seed)
    grid = LatentGrid(dims=(8, 8, 4))
    M = grid.num_tokens
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    feats = rng.normal(size=(B, n, C)).astype(np.float32)
    lat = rng.integers(0, M, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < valid
    lat[~msk] = rng.integers(-2 ** 31, 2 ** 31 - 1, int((~msk).sum()))
    off = rng.random((B, n, K)) < 0.02
    lat[off & msk] = rng.choice([-1, M, M + 5, 2 ** 30], int((off & msk).sum()))
    sizes = [6] + [hid] * (n_mid + 1) + [C]
    ws = [torch.from_numpy((rng.normal(size=(sizes[i + 1], sizes[i])) / sizes[i] ** 0.5)
                           .astype(np.float32)).cuda() for i in range(len(sizes) - 1)]
    bs = [torch.from_numpy(rng.normal(size=sizes[i + 1]).astype(np.float32) * 0.1).cuda()
          for i in range(len(sizes) - 1)]
    args = [torch.from_numpy(x).cuda() for x in (pos, feats, lat, msk)]
    g = torch.from_numpy(rng.normal(size=(B, M, C + 11)).astype(np.float32)).cuda()
    return args, ws, bs, grid, g


def _relative(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("hid,C,K,B,n,n_mid", [
    *[(64, 32, K, 1, 1001, 2) for K in (1, 2, 3, 4, 5, 7)],  # every section's K, and 7
    (64, 16, 3, 1, 1001, 2), (32, 32, 5, 1, 777, 0), (32, 16, 4, 1, 777, 3),
    (16, 16, 2, 1, 555, 1), (16, 8, 5, 1, 555, 3), (16, 16, 1, 1, 300, 0),
    (64, 32, 3, 2, 1001, 2), (64, 32, 5, 2, 131, 2), (16, 8, 4, 2, 97, 1),  # B = 2
    (64, 32, 130, 1, 37, 2), (16, 8, 300, 2, 11, 1),  # a node's slots span tiles
])
def test_encoder_kernels_at_tile_edges(hid, C, K, B, n, n_mid):
    """K5 (relative 1e-5 of the accumulator) and K5b (relative 1e-4 of each
    of dfeats, dW, db) against their plain versions at the edges of the
    node-major tiles, every supported width and depths 0 to 3."""
    args, ws, bs, grid, g = _edge_problem(hid, C, K, B, n, n_mid, seed=hid + C + K + n)
    acc = torch.zeros((B, grid.num_tokens, C + 11), device="cuda")
    k5.encoder_accumulate(*args, ws, bs, grid, acc)
    ref = k5.encoder_accumulate_reference(*args, ws, bs, grid, torch.zeros_like(acc))
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and _relative(acc, ref) <= 1e-5
    got = k5.encoder_accumulate_backward(g, *args, ws, bs, grid)
    want = k5.encoder_accumulate_backward_reference(g, *args, ws, bs, grid)
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1])) + list(zip(got[2], want[2]))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _relative(a, b) <= 1e-4


@pytest.mark.parametrize("K", [3, 130])
def test_encoder_backward_dfeats_repeat_bit_for_bit(K):
    """dfeats is summed over a node's slots inside its tile and stored once,
    without atomics: two launches give the same bits."""
    args, ws, bs, grid, g = _edge_problem(64, 32, K, 2, 2001 if K < 128 else 40, 2, seed=K)
    first = k5.encoder_accumulate_backward(g, *args, ws, bs, grid)[0]
    second = k5.encoder_accumulate_backward(g, *args, ws, bs, grid)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# the bf16 bodies against their bf16 plain versions: relative L2, as chip_smoke.py holds them
# (K5_BF16_BOUND, K5B_BF16_BOUND; their reasons in tests/test_torch_port_payload_bf16.py)
K5_BF16, K5B_BF16 = 1e-4, 2e-3


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("hid,C,K,B,n,n_mid,chunk", [
    *[(64, 32, K, 1, 1001, 2, None) for K in (1, 3, 5)],
    (64, 32, 5, 1, 3000, 2, 1000),  # three chunks: one launch, dW rounded in each chunk's slice
    (64, 32, 3, 2, 1001, 2, 500),   # B = 2: the same chunks in both samples
    (64, 16, 3, 1, 1001, 2, None), (32, 32, 5, 1, 777, 0, None), (32, 16, 4, 1, 777, 3, 300),
    (16, 8, 5, 1, 555, 3, None), (64, 32, 130, 1, 37, 2, None),
])
def test_encoder_bf16_bodies_match_plain(hid, C, K, B, n, n_mid, chunk):
    """K5's bf16 body (the accumulator's value columns) and K5b's (dfeats,
    dW, db), one K5b launch a call whatever the chunks, against the bf16
    plain versions."""
    args, ws, bs, grid, g = _edge_problem(hid, C, K, B, n, n_mid, seed=hid + C + K + n + 1)
    acc = torch.zeros((B, grid.num_tokens, C + 11), device="cuda")
    n5, n5b = k5.encoder_accumulate.launches_bf16, k5.encoder_accumulate_backward.launches_bf16
    k5.encoder_accumulate(*args, ws, bs, grid, acc, chunk, kernel_dtype="bfloat16")
    ref = k5.encoder_accumulate_reference(*args, ws, bs, grid, torch.zeros_like(acc), chunk,
                                          "bfloat16")
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and _rel_l2(acc[..., :C], ref[..., :C]) <= K5_BF16
    got = k5.encoder_accumulate_backward(g, *args, ws, bs, grid, chunk, kernel_dtype="bfloat16")
    want = k5.encoder_accumulate_backward_reference(g, *args, ws, bs, grid, chunk, "bfloat16")
    chunks = 1 if chunk is None else -(-n // chunk)
    assert k5.encoder_accumulate.launches_bf16 == n5 + 1
    assert k5.encoder_accumulate_backward.launches_bf16 == n5b + 1
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1])) + list(zip(got[2], want[2]))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_l2(a, b) <= K5B_BF16
    if chunks == 1:  # one launch: dW is its bf16 rounding, db is not rounded
        assert all(torch.equal(k5.round_bf16(w), w) for w in got[1])
        assert not all(torch.equal(k5.round_bf16(b), b) for b in got[2])


@pytest.mark.parametrize("K,B,n,chunk,valid", [
    (5, 1, 3001, 1000, 0.1),   # uniform slots, mostly masked
    (5, 2, 2000, 77, 0.5),     # chunks of 77 nodes: no multiple of a tile, B = 2
    (8, 2, 999, None, 0.02),   # nearly every slot masked, nodes without any valid slot
    (130, 1, 37, None, 0.9),   # nodes with more than 128 valid slots
    (300, 2, 11, 4, 0.7),      # a node's rows over three passes, chunks of 4 nodes, B = 2
])
def test_encoder_bf16_valid_row_tiles(K, B, n, chunk, valid):
    """The bf16 bodies over the tile map's valid rows: K5 and K5b against
    their bf16 plain versions where most slots are masked, where a node has
    more than 128 valid slots, at chunk sizes that are no multiple of a
    tile, at B = 2; one K5b launch a backward call, dfeats the same bits
    twice, zero for nodes without a valid slot."""
    args, ws, bs, grid, g = _edge_problem(64, 32, K, B, n, 2, seed=K + n, valid=valid)
    C = 32
    acc = torch.zeros((B, grid.num_tokens, C + 11), device="cuda")
    k5.encoder_accumulate(*args, ws, bs, grid, acc, chunk, kernel_dtype="bfloat16")
    ref = k5.encoder_accumulate_reference(*args, ws, bs, grid, torch.zeros_like(acc), chunk,
                                          "bfloat16")
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all() and _rel_l2(acc[..., :C], ref[..., :C]) <= K5_BF16
    before = k5.encoder_accumulate_backward.launches_bf16
    got = k5.encoder_accumulate_backward(g, *args, ws, bs, grid, chunk, kernel_dtype="bfloat16")
    again = k5.encoder_accumulate_backward(g, *args, ws, bs, grid, chunk,
                                           kernel_dtype="bfloat16")
    want = k5.encoder_accumulate_backward_reference(g, *args, ws, bs, grid, chunk, "bfloat16")
    torch.cuda.synchronize()
    assert k5.encoder_accumulate_backward.launches_bf16 == before + 2
    assert torch.equal(got[0], again[0])
    assert torch.all(got[0][~args[3].any(-1)] == 0)
    pairs = [(got[0], want[0])] + list(zip(got[1], want[1])) + list(zip(got[2], want[2]))
    for a, b in pairs:
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_l2(a, b) <= K5B_BF16


def test_encoder_bf16_backward_dfeats_repeat_bit_for_bit():
    args, ws, bs, grid, g = _edge_problem(64, 32, 3, 2, 2001, 2, seed=5)
    first = k5.encoder_accumulate_backward(g, *args, ws, bs, grid, 700, kernel_dtype="bfloat16")
    second = k5.encoder_accumulate_backward(g, *args, ws, bs, grid, 700, kernel_dtype="bfloat16")
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])


def test_encoder_bf16_autograd_on_card_matches_cpu():
    """`accumulate` at bf16 under autograd on the card (K5, then K5b once,
    with a dW slice a chunk) against the same on the CPU (the plain
    versions)."""
    args, ws, bs, grid, g = _edge_problem(64, 32, 4, 1, 3000, 2, seed=9)

    def run(device):
        a = [t.to(device) for t in args]
        feats = a[1].clone().requires_grad_()
        w = [x.to(device).requires_grad_() for x in ws]
        b = [x.to(device).requires_grad_() for x in bs]
        acc = k5.accumulate(a[0], feats, a[2], a[3], w, b, grid,
                            torch.zeros((1, grid.num_tokens, 43), device=device), 1000,
                            "bfloat16")
        grads = torch.autograd.grad(acc, [feats, *w, *b], g.to(device))
        return [acc.detach().cpu()] + [x.cpu() for x in grads]

    for a, b in zip(run("cuda"), run("cpu")):
        assert _rel_l2(a, b) <= K5B_BF16


@pytest.mark.parametrize("S,Skv", [(4096, 4096), (77, 130), (1000, 1001)])
def test_dropout_bits_kernel_matches_plain_bit_for_bit(S, Skv):
    seed = 0x1234_5678_9ABC_DEF0 + S
    before = k4.export_dropout_bits.launches
    got = k4.export_dropout_bits(seed, 3, S, Skv)
    torch.cuda.synchronize()
    assert k4.export_dropout_bits.launches == before + 1
    want = k4.dropout_bits_reference(seed, 3, S, Skv, device="cuda")
    assert got.dtype == torch.uint32 and torch.equal(got.view(torch.int32),
                                                     want.view(torch.int32))
    assert not torch.equal(got.view(torch.int32),
                           k4.export_dropout_bits(seed + 1, 3, S, Skv).view(torch.int32))


_SHAPES = [(1000, 1000, 32), (4096, 4096, 32), (77, 130, 8), (200, 333, 64), (129, 64, 16)]


def _qkv(dtype, S, Skv, D, H=4):
    rng = np.random.default_rng(S + D)
    return rng, [torch.from_numpy(rng.normal(size=(1, H, s, D)).astype(np.float32))
                 .to("cuda", dtype) for s in (S, Skv, Skv)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,Skv,D", _SHAPES)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flash_dropout_kernel_matches_plain(dtype, S, Skv, D, rate):
    """K1 drawing from a seed against the plain version fed the bits K4
    exports for that seed; the explicit-bits input gives the same result bit
    for bit, and so does a second run."""
    _, (q, k, v) = _qkv(dtype, S, Skv, D)
    seed = 99 + S
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    bits = k4.export_dropout_bits(seed, 4, S, Skv)
    ref, ref_lse = k1.flash_attention_reference(q, k, v, rate, bits)
    _assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    again, _ = k1.flash_attention(q, k, v, rate, seed=seed)
    from_bits, _ = k1.flash_attention(q, k, v, rate, dropout_bits=bits)
    assert torch.equal(out, again) and torch.equal(out, from_bits)
    other, _ = k1.flash_attention(q, k, v, rate, seed=seed + 1)
    assert not torch.equal(out, other)


def test_flash_dropout_rate_one_drops_everything_and_needs_a_mask():
    _, (q, k, v) = _qkv(torch.bfloat16, 130, 130, 32)
    out, _ = k1.flash_attention(q, k, v, 1.0, seed=1)
    assert not out.float().any()
    with pytest.raises(ValueError, match="seed or explicit bits"):
        k1.flash_attention(q, k, v, 0.1)


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("S,Skv,D", _SHAPES + [(1000, 130, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_backward_kernel_matches_plain(dtype, rel, S, Skv, D, rate):
    """K2 against the plain backward with the same bits. Bounds are relative
    to each gradient's max-abs: bf16 rounds pm, ds and the results (2e-2);
    f32 differs by summation order and by exp2 against exp (1e-4)."""
    rng, (q, k, v) = _qkv(dtype, S, Skv, D)
    dout = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to("cuda", dtype)
    seed = 7 + Skv
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    before = k1.flash_attention_backward.launches
    got = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
    torch.cuda.synchronize()
    assert k1.flash_attention_backward.launches == before + 1
    bits = k4.export_dropout_bits(seed, 4, S, Skv) if rate > 0 else None
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == b.shape
        err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert err <= rel, f"{name}: {err}"
    if rate > 0:
        from_bits = k1.flash_attention_backward(q, k, v, out, lse, dout, rate,
                                                dropout_bits=bits)
        assert torch.equal(got[1], from_bits[1]) and torch.equal(got[2], from_bits[2])


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("S,Skv,D", _SHAPES + [(1000, 130, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_backward_split_kernels_match_plain(dtype, rel, S, Skv, D, rate):
    """K3 (the dk/dv kernel, then the dq kernel) against the plain backward
    with the same bits, at K2's bounds; each kernel counts its own launch; dq
    within one bf16 step of K2's, dk and dv equal to K2's bit for bit; a second
    launch and the explicit-bits input give the same bits in all three
    gradients; the keep mask the dk/dv kernel hands over equals the plain
    packing of K4's bits, from the seed and from the bits, and is None at
    rate 0."""
    rng, (q, k, v) = _qkv(dtype, S, Skv, D)
    dout = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to("cuda", dtype)
    seed = 11 + Skv
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    before = (k1.flash_attention_backward_dq.launches, k1.flash_attention_backward_dkv.launches,
              k1.flash_attention_backward.launches)
    got = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
    torch.cuda.synchronize()
    assert (k1.flash_attention_backward_dq.launches, k1.flash_attention_backward_dkv.launches,
            k1.flash_attention_backward.launches) == (before[0] + 1, before[1] + 1, before[2])
    bits = k4.export_dropout_bits(seed, 4, S, Skv) if rate > 0 else None
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
    fused = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
    for a, b, f, name in zip(got, want, fused, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.shape == b.shape
        top = b.float().abs().max()
        err = ((a.float() - b.float()).abs().max() / top).item()
        assert err <= rel, f"{name}: {err}"
        assert ((a.float() - f.float()).abs().max() / top).item() <= 2.0 ** -7, name
    assert torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])
    again = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if rate > 0:
        from_bits = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate,
                                                      dropout_bits=bits)
        assert all(torch.equal(a, b) for a, b in zip(got, from_bits))
    _assert_keep_mask(q, k, v, out, lse, dout, rate, seed, bits)


def _assert_keep_mask(q, k, v, out, lse, dout, rate, seed, bits):
    """The dk/dv kernel's keep mask, drawn from the seed and read from K4's
    bits for it, equals the plain packing of those bits word for word; at
    rate 0 there is none."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    _, _, mask = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate, seed)
    if rate == 0:
        assert mask is None
        return
    _, _, mask_b = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate,
                                                   dropout_bits=bits)
    torch.cuda.synchronize()
    want = k1.pack_keep_mask_reference(bits, rate).view(torch.int32)
    assert mask.shape == want.shape and mask.dtype == torch.uint32
    assert torch.equal(mask.view(torch.int32), want)
    assert torch.equal(mask_b.view(torch.int32), want)


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S,Skv", [(77, 130), (130, 1000), (1000, 77)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_split_wgmma_bodies_match_plain_k2_and_the_exported_bits(D, S, Skv, rate):
    """K3's bf16 TMA/wgmma bodies at every head dim they take, sq != skv and
    neither a multiple of 64 or 128: against the plain backward with the bits
    K4 exports for the seed, 2e-2 of each gradient's max-abs (bf16 roundings
    of pm, ds and the results); dq within 2^-7 of K2's (one bf16 step: K2
    sums dq's tile partials in another order); dk and dv equal to K2's bit
    for bit (one body); two launches, and the seed against its exported bits,
    identical; the keep mask equal to the plain packing of those bits."""
    rng, (q, k, v) = _qkv(torch.bfloat16, S, Skv, D, H=3)
    dout = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    seed = 0x5EED + 3 * S + D if rate > 0 else None
    bits = k4.export_dropout_bits(seed, 3, S, Skv) if rate > 0 else None
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    got = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
    again = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate, seed=seed)
    fused = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
    torch.cuda.synchronize()
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all(), name
        err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert err <= 2e-2, f"{name}: {err}"
    top = want[0].float().abs().max()
    assert (got[0].float() - fused[0].float()).abs().max() <= 2.0 ** -7 * top
    assert torch.equal(got[1], fused[1]) and torch.equal(got[2], fused[2])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if rate > 0:
        from_bits = k1.flash_attention_backward_split(q, k, v, out, lse, dout, rate,
                                                      dropout_bits=bits)
        assert all(torch.equal(a, b) for a, b in zip(got, from_bits))
    _assert_keep_mask(q, k, v, out, lse, dout, rate, seed, bits)


@pytest.mark.parametrize("D", [16, 32, 64])
@pytest.mark.parametrize("S,Skv", [(77, 130), (130, 1000), (1000, 77)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_wgmma_bodies_match_plain_and_the_exported_bits(D, S, Skv, rate):
    """The bf16 TMA/wgmma bodies of K1 and K2 at every head dim they take,
    with sq != skv and neither a multiple of 128: against the plain versions
    with the bits K4 exports for the seed (K1 out 2e-2 of its max-abs, lse
    1e-4; K2 2e-2 of each gradient's max-abs); K1 twice, and K1 and K2 fed
    those bits, repeat the seeded run bit for bit (K2's dq to one bf16 step:
    its tile partials are added in a run-dependent order)."""
    rng, (q, k, v) = _qkv(torch.bfloat16, S, Skv, D, H=3)
    dout = torch.from_numpy(rng.normal(size=tuple(q.shape)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    seed = 0x5EED + S * D if rate > 0 else None
    bits = k4.export_dropout_bits(seed, 3, S, Skv) if rate > 0 else None
    out, lse = k1.flash_attention(q, k, v, rate, seed=seed)
    again, lse_again = k1.flash_attention(q, k, v, rate, seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    ref, ref_lse = k1.flash_attention_reference(q, k, v, rate, bits)
    _assert_out_close(out, ref)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    got = k1.flash_attention_backward(q, k, v, out, lse, dout, rate, seed=seed)
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(a.float()).all(), name
        err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        assert err <= 2e-2, f"{name}: {err}"
    if rate > 0:
        out_b, lse_b = k1.flash_attention(q, k, v, rate, dropout_bits=bits)
        assert torch.equal(out, out_b) and torch.equal(lse, lse_b)
        got_b = k1.flash_attention_backward(q, k, v, out_b, lse_b, dout, rate, dropout_bits=bits)
        assert torch.equal(got[1], got_b[1]) and torch.equal(got[2], got_b[2])
        top = got[0].float().abs().max()
        assert (got[0].float() - got_b[0].float()).abs().max() <= 2.0 ** -7 * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["exp", "select"])
def test_elementwise_chain_kernel_matches_plain(chain, dtype):
    """T1's kernel against its plain version on a [512, 1024] block from a
    seed, copies 3, per element relative to the value: select one rounding
    step of the type (both sides take the same correctly rounded operations);
    exp in f32 2e-6 at reps 1 and 2e-6 (1 + 0.9 |a1|) at reps 2, a1 the value
    after one step (the exponent carries the first step's error); exp in bf16
    (reps 1) 2^-5 + 2^-8 |x|: the exponential's bf16 output and the plain
    one's rounding, times up to 1.7 where exp(0.9 x) - x cancels, the two
    results' roundings, and the rounding of the exponential's bf16 argument.
    Non-finite positions agree as sets."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (512, 1024)).astype(np.float32)).to("cuda", dtype)
    for reps in ((1, 2) if dtype == torch.float32 else (1,)):
        before = t1.elementwise_chain.launches
        got = t1.elementwise_chain(x, chain, reps, copies=3).float()
        torch.cuda.synchronize()
        assert t1.elementwise_chain.launches == before + 1
        want = t1.chain_plain(x, chain, reps).float()
        assert torch.equal(torch.isfinite(got), torch.isfinite(want))
        fin = torch.isfinite(want)
        err = (got - want).abs()[fin]
        mag = want.abs()[fin]
        if chain == "select":
            limit = (2.0 ** -23 if dtype == torch.float32 else 2.0 ** -8) * mag
        elif dtype == torch.float32:
            grow = 1.0 + 0.9 * t1.chain_plain(x, chain, 1).float().abs()[fin] if reps == 2 else 1.0
            limit = 2e-6 * grow * mag
        else:
            limit = (2.0 ** -5 + 2.0 ** -8 * x.float().abs()[fin]) * mag
        assert (err <= limit).all(), f"reps {reps}: worst {(err / mag).max().item()}"


def test_attention_backward_on_card_follows_the_switch(monkeypatch):
    """GAOT_ATTN_BWD_FUSED=0 sends `attention`'s backward to K3's two kernels,
    and the gradients agree with K2's."""
    _, (q, k, v) = _qkv(torch.bfloat16, 300, 200, 32)
    dout = torch.ones_like(q)

    def grads(switch):
        monkeypatch.setenv("GAOT_ATTN_BWD_FUSED", switch)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(k1.attention(*leaves, 0.1, 9), leaves, dout)

    counts = lambda: (k1.flash_attention_backward.launches,  # noqa: E731
                      k1.flash_attention_backward_dq.launches,
                      k1.flash_attention_backward_dkv.launches)
    c0 = counts()
    fused = grads("1")
    c1 = counts()
    split = grads("0")
    c2 = counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2]) == (1, 0, 0)
    assert (c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]) == (0, 1, 1)
    for a, b in zip(split, fused):
        assert (a.float() - b.float()).abs().max() <= 2.0 ** -7 * b.float().abs().max()


def test_attention_autograd_on_card_matches_cpu():
    """`attention` under autograd: kernels on the card against the plain
    versions on the CPU, f32, one seed."""
    _, (q, k, v) = _qkv(torch.float32, 200, 130, 16)
    cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
    gpu = [t.requires_grad_() for t in (q, k, v)]
    dout = torch.ones(1, 4, 200, 16)
    want = torch.autograd.grad(k1.attention(*cpu, 0.2, 5), cpu, dout)
    got = torch.autograd.grad(k1.attention(*gpu, 0.2, 5), gpu, dout.cuda())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def test_model_on_card_matches_cpu():
    """The small flagship model (head dim 8, kernel MLP 6-16-16-8): CUDA
    kernels on the card vs the twins on the CPU, f32 attention."""
    magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                        in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                        edge_chunk_size=16)
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=2, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.0, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    model = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                       generator=torch.Generator().manual_seed(0), device="cpu").eval()
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(1, 256, 2)).astype(np.float32))
    lat = torch.from_numpy(rng.integers(0, 64, (1, 256, 4)).astype(np.int32))
    msk = torch.from_numpy(rng.random((1, 256, 4)) < 0.7)
    mask = torch.ones(1, 256, dtype=torch.bool)
    with torch.inference_mode():
        want = model(pos, feats, mask, encoder_slots=[EdgeSlots(lat, msk)],
                     decoder_slots=[EdgeSlots(lat, msk)])
        slots = EdgeSlots(lat.cuda(), msk.cuda())
        got = model.cuda()(pos.cuda(), feats.cuda(), mask.cuda(), encoder_slots=[slots],
                           decoder_slots=[slots])
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_train_step_on_card_matches_cpu():
    """One forward-and-backward in train mode with dropout: all four kernels
    on the card against the plain versions on the CPU, same seeds, f32. The
    training forward keeps the plain decoder: no K9 launch."""
    from gaot3d_tpu_torch.train import TrainBatch, masked_mse

    magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                        in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                        edge_chunk_size=16)
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=3, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.2, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    rng = np.random.default_rng(1)
    t = torch.from_numpy
    pos = t(rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32))
    feats = t(rng.normal(size=(1, 256, 2)).astype(np.float32))
    target = t(rng.normal(size=(1, 256, 1)).astype(np.float32))
    lat = t(rng.integers(0, 40, (1, 256, 4)).astype(np.int32))  # cells 40..63 stay empty
    msk = t(rng.random((1, 256, 4)) < 0.7)
    mask = torch.ones(1, 256, dtype=torch.bool)
    grads = []
    k9_before = k9.decoder_payload.launches
    for device in ("cpu", "cuda"):
        model = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                           generator=torch.Generator().manual_seed(0), device=device).train()
        slots = EdgeSlots(lat.to(device), msk.to(device))
        batch = TrainBatch(pos.to(device), feats.to(device), target.to(device),
                           mask.to(device), slots, slots)
        pred = model(batch.pos, batch.feats, batch.node_mask, encoder_slots=[slots],
                     decoder_slots=[slots], generator=torch.Generator().manual_seed(3))
        masked_mse(pred, batch.target, batch.node_mask).backward()
        grads.append(torch.cat([p.grad.flatten().cpu() for p in model.parameters()]))
    assert k9.decoder_payload.launches == k9_before
    assert torch.isfinite(grads[1]).all()
    rel = ((grads[1] - grads[0]).norm() / grads[0].norm()).item()
    assert rel <= 1e-4


def test_train_step_bf16_on_card_matches_cpu():
    """kernel_dtype bfloat16: one forward-and-backward through K5's and
    K5b's bf16 bodies (K5b once, its dW in 64-node chunks) on the card against the
    plain versions on the CPU, same seeds, f32 attention, no dropout:
    relative L2 of the gradient within K5B_BF16 (bf16 roundings that the
    sums' other order flips)."""
    from gaot3d_tpu_torch.train import masked_mse

    magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                        in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                        edge_chunk_size=64, kernel_dtype="bfloat16")
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=2, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.0, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    rng = np.random.default_rng(2)
    t = torch.from_numpy
    pos = t(rng.uniform(-1, 1, (1, 256, 3)).astype(np.float32))
    feats = t(rng.normal(size=(1, 256, 2)).astype(np.float32))
    target = t(rng.normal(size=(1, 256, 1)).astype(np.float32))
    lat = t(rng.integers(0, 64, (1, 256, 4)).astype(np.int32))
    msk = t(rng.random((1, 256, 4)) < 0.7)
    mask = torch.ones(1, 256, dtype=torch.bool)
    grads = []
    n5b = k5.encoder_accumulate_backward.launches_bf16
    for device in ("cpu", "cuda"):
        model = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                           generator=torch.Generator().manual_seed(0), device=device).train()
        slots = EdgeSlots(lat.to(device), msk.to(device))
        pred = model(pos.to(device), feats.to(device), mask.to(device), encoder_slots=[slots],
                     decoder_slots=[slots])
        masked_mse(pred, target.to(device), mask.to(device)).backward()
        grads.append(torch.cat([p.grad.flatten().cpu() for p in model.parameters()]))
    assert k5.encoder_accumulate_backward.launches_bf16 == n5b + 1
    assert torch.isfinite(grads[1]).all()
    assert _rel_l2(grads[1], grads[0]) <= K5B_BF16


# --- K7 prefix sum, K6 sorted segment sum, K8 tile segment sum ---------------


@pytest.mark.parametrize("E,C", [(1, 1), (31, 43), (160, 43), (161, 43), (5000, 32), (100_003, 43),
                                 (777, 1), (4097, 7), (300, 300), (40_000, 64)])
def test_prefix_sum_kernel_matches_plain(E, C):
    """Against its ordered twin bit for bit: each column of a tile of
    `tile_rows(C)` rows in row order, then the tree over tile totals in
    groups of 32. Against the float64 cumsum: 2e-6 of the largest prefix of
    each column (that association's rounding follows the running sum).
    Against the plain float32 cumsum, whose own rounding reads 1e-5 at
    163,840 rows: 3e-5. Two launches bit for bit, one launch a call."""
    rng = np.random.default_rng(E + C)
    x = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32)).cuda()
    before = k7.prefix_sum.launches
    got = k7.prefix_sum(x)
    again = k7.prefix_sum(x)
    torch.cuda.synchronize()
    assert k7.prefix_sum.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, k7.prefix_sum_ordered_reference(x))
    want = torch.cumsum(x.double(), dim=0)
    top = want.abs().amax(dim=0).clamp_min(1.0)
    assert ((got.double() - want).abs() / top).max().item() <= 2e-6
    plain = k7.prefix_sum_reference(x)
    assert ((got - plain).abs().double() / top).max().item() <= 3e-5


def test_prefix_sum_kernel_counts_exactly():
    """A column of ones reaches 163,840, exact in float32: the count column
    of the encoder's payload must come out exact."""
    x = torch.ones((163_840, 3), device="cuda")
    x[:, 1] = 0.0
    got = k7.prefix_sum(x)
    want = torch.arange(1, 163_841, device="cuda", dtype=torch.float32)
    assert torch.equal(got[:, 0], want) and torch.equal(got[:, 2], want)
    assert not got[:, 1].any()


def test_prefix_sum_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="float32"):
        k7.prefix_sum(torch.zeros((4, 4), device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\[E, C\]"):
        k7.prefix_sum(torch.zeros(4, device="cuda"))
    assert k7.prefix_sum(torch.zeros((0, 5), device="cuda")).shape == (0, 5)


def _sorted_rows(rng, E, S, P, n_valid, hot=None):
    """Rows sorted by id with the invalid ones (id S) at the tail; `hot`
    sends nine rows in ten to that one segment."""
    ids = rng.integers(0, S, E)
    if hot is not None:
        ids[rng.random(E) < 0.9] = hot
    ids[n_valid:] = S
    ids = np.sort(ids).astype(np.int32)
    data = rng.normal(size=(E, P)).astype(np.float32)
    return torch.from_numpy(data).cuda(), torch.from_numpy(ids).cuda()


def _assert_segment_sums(got, data, ids, S):
    """Against the float64 sums: 1e-6 of the segment's sum of magnitudes
    (float32 additions in row order; a dropped or doubled row of a segment of
    n rows would read about 1/n of it)."""
    keep = ids < S
    idx = ids[keep].long()
    want = torch.zeros((S, data.shape[1]), dtype=torch.float64, device=data.device)
    want.index_add_(0, idx, data[keep].double())
    size = torch.zeros_like(want).index_add_(0, idx, data[keep].double().abs())
    assert torch.isfinite(got).all()
    assert ((got.double() - want).abs() <= 1e-6 * size).all()


def _assert_close_to_plain(got, plain, data, ids, S):
    """Kernel against plain version, entry by entry within 2e-6 of the
    segment's sum of magnitudes: each is a float32 sum of the same rows in
    its own order (the plain `index_add_` adds with atomics on the card), so
    the limit follows the segment's size; one limit for the whole result
    would sit at the rounding noise of a segment of 60,000 rows and far above
    a dropped row of a short one."""
    keep = ids < S
    size = torch.zeros((S, data.shape[1]), dtype=torch.float64, device=data.device)
    size.index_add_(0, ids[keep].long(), data[keep].double().abs())
    assert ((got.double() - plain.double()).abs() <= 2e-6 * size).all()


_SEGMENT_CASES = [
    # E, S, P, n_valid, hot
    (1000, 64, 43, 900, None),       # ragged, a few rows a segment
    (1003, 517, 43, 1003, None),     # S no multiple of any tile, no padding, empty segments
    (50_000, 100_000, 43, 41_000, None),  # most segments empty
    (70_001, 3000, 43, 65_000, 1234),  # one hot segment holds most rows
    (4096, 700, 5, 0, None),         # every row invalid
    (777, 1, 130, 700, None),        # one segment, more columns than one pass holds
    (1, 9, 1, 1, None),
]


@pytest.mark.parametrize("E,S,P,n_valid,hot", _SEGMENT_CASES)
def test_segment_sum_sorted_kernel_matches_plain(E, S, P, n_valid, hot):
    rng = np.random.default_rng(E + S)
    data, ids = _sorted_rows(rng, E, S, P, n_valid, hot)
    before = k6.segment_sum_sorted.launches
    got = k6.segment_sum_sorted(data, ids, S)
    again = k6.segment_sum_sorted(data, ids, S, passes=2)
    torch.cuda.synchronize()
    assert k6.segment_sum_sorted.launches == before + 2
    assert got.shape == (S, P) and torch.equal(got, again)
    _assert_segment_sums(got, data, ids, S)
    plain = k6.segment_sum_sorted_reference(data, ids, S)
    _assert_close_to_plain(got, plain, data, ids, S)


def test_segment_sum_sorted_kernel_batches_on_the_grid():
    """Three batches with different valid counts in one launch, each equal to
    its own unbatched launch bit for bit."""
    rng = np.random.default_rng(5)
    E, S, P = 3000, 257, 43
    pairs = [_sorted_rows(rng, E, S, P, n) for n in (3000, 2100, 3)]
    data = torch.stack([p[0] for p in pairs])
    ids = torch.stack([p[1] for p in pairs])
    before = k6.segment_sum_sorted.launches
    got = k6.segment_sum_sorted(data, ids, S)
    assert k6.segment_sum_sorted.launches == before + 1
    for b, (d, i) in enumerate(pairs):
        assert torch.equal(got[b], k6.segment_sum_sorted(d, i, S))
        _assert_segment_sums(got[b], d, i, S)


def _k6_at_share(data, ids, S, share):
    """K6 through its C entry point with shares of `share` items (None: the
    wrapper, whose share is `share_items(P)`)."""
    if share is None:
        return k6.segment_sum_sorted(data, ids, S)
    B, E, P = data.shape
    out = torch.empty((B, S, P), device="cuda")
    err = k6._library().gaot_segment_sum_sorted(
        data.data_ptr(), ids.data_ptr(), out.data_ptr(), B, E, P, S, share,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out


@pytest.mark.parametrize("share", [None, 1, 7, 142])
@pytest.mark.parametrize("E,S,P,n_valid,hot", _SEGMENT_CASES)
def test_segment_sum_sorted_kernel_equals_its_ordered_twin(E, S, P, n_valid, hot, share):
    """The kernel gives the bits of its ordered twin along its own
    merge-path split, with a few negative ids at the head, twice over."""
    rng = np.random.default_rng(E + S + P)
    data, ids = _sorted_rows(rng, E, S, P, n_valid, hot)
    ids[: min(3, n_valid)] = -1 - torch.arange(min(3, n_valid), device="cuda").flip(0).int()
    got = _k6_at_share(data[None], ids[None], S, share)
    again = _k6_at_share(data[None], ids[None], S, share)
    torch.cuda.synchronize()
    twin = k6.segment_sum_sorted_ordered_reference(data, ids, S, share or k6.share_items(P))
    assert torch.equal(got[0], twin) and torch.equal(got, again)


@pytest.mark.parametrize("share", [None, 5])
def test_segment_sum_sorted_kernel_equals_its_twin_over_batches(share):
    """Three batches with different valid counts (one all padding) in one
    launch: the twin's bits batch by batch."""
    rng = np.random.default_rng(6)
    E, S, P = 3000, 257, 43
    pairs = [_sorted_rows(rng, E, S, P, n) for n in (3000, 2100, 0)]
    data = torch.stack([p[0] for p in pairs])
    ids = torch.stack([p[1] for p in pairs])
    got = _k6_at_share(data, ids, S, share)
    torch.cuda.synchronize()
    assert torch.equal(got, k6.segment_sum_sorted_ordered_reference(
        data, ids, S, share or k6.share_items(P)))
    assert not got[2].any()


@pytest.mark.parametrize("seg_tile", [512, 8, 100])
@pytest.mark.parametrize("E,S,P,n_valid,hot", _SEGMENT_CASES)
def test_tile_segment_sum_kernel_matches_plain(E, S, P, n_valid, hot, seg_tile):
    """From tile boundaries and from full starts, over sorted rows and over
    unsorted rows read through perm: all four the same bits, those of the
    ordered twin (each segment in row order from 0) and of K6 on the same
    sorted rows."""
    rng = np.random.default_rng(E + S + seg_tile)
    data, ids = _sorted_rows(rng, E, S, P, n_valid, hot)
    ts = k8.tile_boundaries(ids, S, seg_tile)
    before = k8.tile_segment_sum.launches
    got = k8.tile_segment_sum(data, ids, ts=ts, num_segments=S, seg_tile=seg_tile)
    torch.cuda.synchronize()
    assert k8.tile_segment_sum.launches == before + 1
    assert got.shape == (S, P)
    _assert_segment_sums(got, data, ids, S)
    starts = torch.searchsorted(ids, torch.arange(S + 1, dtype=torch.int32, device="cuda"),
                                out_int32=True)
    assert torch.equal(got, k8.tile_segment_sum(data, ids, starts, seg_tile=seg_tile,
                                                max_blocks=1))
    shuffle = torch.from_numpy(rng.permutation(E)).cuda()
    perm = torch.argsort(shuffle).to(torch.int32)  # data[shuffle][perm] == data
    assert torch.equal(got, k8.tile_segment_sum(data[shuffle], ids, ts=ts, num_segments=S,
                                                seg_tile=seg_tile, perm=perm))
    assert torch.equal(got, k8.tile_segment_sum_ordered_reference(data, ids, ts, S,
                                                                  seg_tile=seg_tile))
    assert torch.equal(got, k6.segment_sum_sorted(data, ids, S))
    plain = k8.tile_segment_sum_reference(data, ids, ts, S)
    _assert_close_to_plain(got, plain, data, ids, S)


def test_sorted_reductions_agree_with_k5_on_the_model():
    """The small model on the card: flat 'dst' edges through K6 and through
    the K7 fold, and slots through K8 and the K7 sort fold, against slots
    through K5, forward and gradients, f32 attention."""
    from gaot3d_tpu_torch.data.host_graph import (build_edge_slots_host,
                                                  flatten_slots_host_batched)

    grid = LatentGrid(dims=(4, 4, 4))
    rng = np.random.default_rng(2)
    B, N, chunk = 2, 256, 64
    pos = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, 2)).astype(np.float32)
    built = [build_edge_slots_host(pos[b], grid, 0.45, strategy="bidirectional", budget=12)
             for b in range(B)]
    lat, msk = np.stack([x[0] for x in built]), np.stack([x[1] for x in built])
    slots = EdgeSlots.from_numpy(lat, msk, device="cuda")
    by_src = flatten_slots_host_batched(lat, msk, chunk, pad_multiple=8, device="cuda")
    by_dst = flatten_slots_host_batched(lat, msk, chunk, pad_multiple=8, order="dst",
                                        device="cuda")
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=2, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.0, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    pos_t, feats_t = torch.from_numpy(pos).cuda(), torch.from_numpy(feats).cuda()
    mask = torch.ones(B, N, dtype=torch.bool, device="cuda")

    def run(enc, dec, **kw):
        magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                            in_gno_channel_mlp_hidden_layers=[16, 16],
                            out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                            edge_chunk_size=chunk, **kw)
        model = init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                           generator=torch.Generator().manual_seed(0))
        out = model(pos_t, feats_t, mask, encoder_slots=[enc], decoder_slots=[dec])
        (out ** 2).sum().backward()
        return out.detach(), torch.cat([p.grad.flatten() for p in model.parameters()])

    want, want_g = run(slots, slots)
    counters = {"k6": k6.segment_sum_sorted, "k7": k7.prefix_sum, "k8": k8.tile_segment_sum}
    nc = N // chunk
    for kw, enc, dec, expect in [
            (dict(flat_order="dst", flat_reduce_impl="pallas"), by_dst, by_src,
             {"k6": nc, "k7": B * nc, "k8": 0}),
            (dict(flat_order="dst"), by_dst, by_src, {"k6": 0, "k7": 2 * B * nc, "k8": 0}),
            (dict(segment_impl="tile"), slots, slots, {"k6": 0, "k7": 0, "k8": B * nc}),
            (dict(segment_impl="sort"), slots, slots, {"k6": 0, "k7": B * nc, "k8": 0}),
            (dict(segment_impl="tile"), by_src, slots, {"k6": 0, "k7": 0, "k8": B * nc})]:
        for fn in counters.values():
            fn.launches = 0
        got, got_g = run(enc, dec, **kw)
        assert {n: fn.launches for n, fn in counters.items()} == expect, kw
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
        assert ((got_g - want_g).norm() / want_g.norm()).item() <= 1e-4, kw


@pytest.mark.parametrize("B,N,k,strategy,budget", [
    (1, 524_288, 1, "bidirectional", 5), (1, 524_288, 1, "bidirectional", None),
    (3, 1_001, 2, "bidirectional", 8), (3, 777, 4, "knn", None), (3, 999, 1, "radius", 6)])
def test_edge_build_on_card_equals_cpu_bit_for_bit(B, N, k, strategy, budget):
    """The slots built on the card from the recipe's grid and radius are the
    CPU build's bits: the recipe's cloud (compacted to its budget and the
    whole window) and ragged batches of three, padded rows and points
    outside the grid included."""
    grid = LatentGrid(dims=(64, 64, 32))
    rng = np.random.default_rng(N + k)
    pts = torch.from_numpy(rng.uniform(-1.05, 1.05, (B, N, 3)).astype(np.float32))
    mask = torch.ones(B, N, dtype=torch.bool)
    mask[-1, N // 3:] = False
    if budget is None:
        cpu = build_edge_slots_batched(pts, grid, 0.033, k, strategy, mask)
        card = build_edge_slots_batched(pts.cuda(), grid, 0.033, k, strategy, mask.cuda())
    else:
        cpu = build_budgeted_slots(pts, grid, 0.033, k, strategy, mask, budget, 65_536)
        card = build_budgeted_slots(pts.cuda(), grid, 0.033, k, strategy, mask.cuda(), budget,
                                    65_536)
    assert card.lat_idx.is_cuda and card.mask.is_cuda
    assert torch.equal(card.lat_idx.cpu(), cpu.lat_idx)
    assert torch.equal(card.mask.cpu(), cpu.mask)


# ---- K10: the budgeted slot build (kernels/slot_build.py) ----------------------------------

# (dims, lo, hi, radius, low, high): the recipe's grid; an anisotropic box; one axis of one
# cell with lo == hi (h = 0); a grid of spacing 0.5 whose cell centres and midpoints are exact
# in f32, so kNN picks meet ties (tests/test_torch_port_device_edges.py `GRIDS`)
SLOT_GRIDS = {
    "recipe": ((64, 64, 32), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 0.033, -1.05, 1.05),
    "anisotropic": ((8, 5, 12), (-1.0, -0.5, 0.0), (1.0, 0.5, 3.0), 0.3, -1.3, 3.3),
    "flat-axis": ((6, 1, 7), (-1.0, 0.25, -1.0), (1.0, 0.25, 1.0), 0.4, -1.2, 1.2),
    "exact": ((5, 5, 5), (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), 0.5, -1.0, 1.0),
}


def _slot_cloud(name, B, N, seed):
    """(grid, radius, points, point mask) on the CPU: points in the grid's
    box and beyond it, on the 'exact' grid the first rows on cell centres and
    midpoints; the last sample's last fifth padded (point mask false)."""
    dims, lo, hi, radius, low, high = SLOT_GRIDS[name]
    rng = np.random.default_rng(seed)
    pts = rng.uniform(low, high, (B, N, 3)).astype(np.float32)
    if name == "exact":
        c = np.linspace(-1.0, 1.0, 5, dtype=np.float32)
        pts[0, :5] = c[:, None]
        pts[0, 5:9] = (c[:4] + 0.25)[:, None]
    mask = np.ones((B, N), bool)
    mask[-1, -N // 5:] = False
    return LatentGrid(dims, lo, hi), radius, torch.from_numpy(pts), torch.from_numpy(mask)


def _k10_against_cpu(pts, grid, radius, k, strategy, mask, budget):
    """K10's slots (one launch, counted) against the CPU build, bit for bit;
    the card's slots."""
    before = k10.slot_build.launches
    card = build_budgeted_slots(pts.cuda(), grid, radius, k, strategy,
                                None if mask is None else mask.cuda(), budget, 65_536)
    torch.cuda.synchronize()
    assert k10.slot_build.launches == before + 1
    cpu = build_budgeted_slots(pts, grid, radius, k, strategy, mask, budget, 65_536)
    assert card.lat_idx.shape == cpu.lat_idx.shape == (*pts.shape[:2], budget)
    assert torch.equal(card.lat_idx.cpu(), cpu.lat_idx)
    assert torch.equal(card.mask.cpu(), cpu.mask)
    return card


@pytest.mark.parametrize("grid", sorted(SLOT_GRIDS))
@pytest.mark.parametrize("strategy", ["knn", "radius", "bidirectional", "reverse"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_slot_build_kernel_equals_cpu_bit_for_bit(grid, strategy, k):
    """Ragged batches of three with padded rows and points outside the grid,
    at budgets 1, 4, 8 and K - 1: rows with more valid slots than the budget
    drop the same ones, rows with fewer fill the same masked cells."""
    tgrid, radius, pts, mask = _slot_cloud(grid, 3, 1_001, len(grid) + k)
    K = math.prod(window_spec(tgrid, radius, k, strategy)[0])
    for budget in sorted({1, 4, 8, K - 1} & set(range(1, K))):
        card = _k10_against_cpu(pts, tgrid, radius, k, strategy, mask, budget)
        assert not card.mask[-1, -200:].any()


@pytest.mark.parametrize("N,budget,cloud", [(524_288, 5, "box"), (524_288, 8, "box"),
                                            (8_388_608, 8, "surface")])
def test_slot_build_kernel_at_the_recipes_sizes(N, budget, cloud):
    """The recipe's grid, radius 0.033, bidirectional, k 1: its 524,288-point
    cloud and drivaerml's 8,388,608 points of a closed surface; two launches
    give the same bits."""
    grid = LatentGrid(dims=(64, 64, 32))
    if cloud == "box":
        rng = np.random.default_rng(N + budget)
        pts = torch.from_numpy(rng.uniform(-1.05, 1.05, (1, N, 3)).astype(np.float32))
    else:
        g = torch.Generator().manual_seed(22)
        d = torch.randn(1, N, 3, generator=g)
        d = d / d.norm(dim=-1, keepdim=True)
        pts = 0.8 * d * (1 + 0.15 * torch.sin(3 * d[..., :1]) * torch.cos(2 * d[..., 1:2]))
    mask = torch.ones(1, N, dtype=torch.bool)
    card = _k10_against_cpu(pts, grid, 0.033, 1, "bidirectional", mask, budget)
    again = build_budgeted_slots(pts.cuda(), grid, 0.033, 1, "bidirectional", mask.cuda(),
                                 budget)
    assert torch.equal(card.lat_idx, again.lat_idx) and torch.equal(card.mask, again.mask)
    assert card.mask.any(dim=-1).all()  # bidirectional: every point has its nearest cell


@pytest.mark.parametrize("radius,k,strategy,budget", [
    (0.033, 1, "bidirectional", None),  # no budget: the whole window
    (0.033, 9, "knn", 8),               # more picks than K10 takes
    (0.3, 1, "radius", 8),              # widths 22, 22, 12
])
def test_slot_build_off_k10_keeps_the_plain_bits(radius, k, strategy, budget):
    """Builds on the card that K10 does not take: no launch, the CPU build's
    bits."""
    grid = LatentGrid(dims=(64, 64, 32))
    rng = np.random.default_rng(k)
    pts = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 777, 3)).astype(np.float32))
    mask = torch.ones(2, 777, dtype=torch.bool)
    mask[1, 500:] = False
    assert not k10.engages(torch.device("cuda"), torch.float32, grid, radius, k, strategy,
                           budget)
    before = k10.slot_build.launches
    card = build_budgeted_slots(pts.cuda(), grid, radius, k, strategy, mask.cuda(), budget, 300)
    torch.cuda.synchronize()
    assert k10.slot_build.launches == before
    cpu = build_budgeted_slots(pts, grid, radius, k, strategy, mask, budget, 300)
    assert torch.equal(card.lat_idx.cpu(), cpu.lat_idx) and torch.equal(card.mask.cpu(), cpu.mask)


def test_slot_build_kernel_without_a_point_mask_and_as_the_model_calls_it():
    """No point mask (every row live), points sliced from a larger batch (not
    contiguous: `build_budgeted_slots` hands K10 a copy), and the model's own
    build (`SlotBuild`, one for both sides) launch K10 once each."""
    grid = LatentGrid(dims=(64, 64, 32))
    rng = np.random.default_rng(7)
    big = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 4_000, 3)).astype(np.float32))
    pts = big[:, 1_000:3_000]
    assert not pts.is_contiguous()
    _k10_against_cpu(pts, grid, 0.033, 1, "bidirectional", None, 8)
    model = _k9_model([1.0], slot_budget=8)  # radius slots in a 4x4x4 window, both sides
    feats = torch.from_numpy(rng.normal(size=(1, 512, 2)).astype(np.float32)).cuda()
    before = k10.slot_build.launches
    with torch.no_grad():
        model(big[:1, :512].cuda(), feats, torch.ones(1, 512, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    assert k10.slot_build.launches == before + 1


@pytest.mark.parametrize("case", ["float64", "shape", "strided", "mask dtype", "mask shape",
                                  "mask strided", "mask device", "budget K", "picks"])
def test_slot_build_kernel_rejects_what_it_does_not_take(case):
    grid = LatentGrid(dims=(64, 64, 32))
    pts = torch.zeros(2, 50, 3, device="cuda")
    mask = torch.ones(2, 50, dtype=torch.bool, device="cuda")
    budget, k = 8, 1
    if case == "float64":
        pts = pts.double()
    elif case == "shape":
        pts = torch.zeros(2, 50, 2, device="cuda")
    elif case == "strided":
        pts = torch.zeros(2, 3, 50, device="cuda").transpose(1, 2)
    elif case == "mask dtype":
        mask = mask.to(torch.uint8)
    elif case == "mask shape":
        mask = mask[:, :49].contiguous()
    elif case == "mask strided":
        mask = torch.ones(50, 2, dtype=torch.bool, device="cuda").t()
    elif case == "mask device":
        mask = mask.cpu()
    elif case == "budget K":
        budget = 144
    elif case == "picks":
        k = 9
    before = k10.slot_build.launches
    with pytest.raises(ValueError):
        k10.slot_build(pts, grid, 0.033, k, "bidirectional", mask, budget)
    assert k10.slot_build.launches == before


# ---- K9: the decoder's GNO mean (kernels/decoder_payload.py) -------------------------------

def _decoder_mlp(rng, sizes):
    """torch.nn.Linear's default draws, on the card."""
    ws = [torch.from_numpy(rng.uniform(-1, 1, (b, a)).astype(np.float32) / a ** 0.5).cuda()
          for a, b in zip(sizes, sizes[1:])]
    bs = [torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32) / a ** 0.5).cuda()
          for a, b in zip(sizes, sizes[1:])]
    return ws, bs


def _decoder_gaps(latent, pos, lat, msk, ws, bs, grid):
    """K9's output, the plain path's (`IntegralTransform`'s node chunks of
    65,536 through `decoder_chunk`) and the relative L2 gaps of each to a
    float64 version of the same function (the plain version in float64,
    131,072 nodes at a time)."""
    before = k9.decoder_payload.launches
    with torch.no_grad():
        got = k9.decoder_payload(latent, pos, lat, msk, ws, bs, grid)
        gno = IntegralTransform([6] + [w.shape[0] for w in ws], grid, edge_chunk_size=65_536)
        for fc, w, b in zip(gno.channel_mlp.fcs, ws, bs):
            fc.weight.copy_(w)
            fc.bias.copy_(b)
        plain = gno.cuda()(EdgeSlots(lat, msk), pos, latent)
        wd, bd = [w.double() for w in ws], [b.double() for b in bs]
        step = 131_072
        exact = torch.cat([k9.decoder_payload_reference(
            latent.double(), pos[:, c:c + step].double(), lat[:, c:c + step],
            msk[:, c:c + step], wd, bd, grid) for c in range(0, pos.shape[1], step)], dim=1)
    torch.cuda.synchronize()
    assert k9.decoder_payload.launches == before + 1
    assert got.shape == plain.shape and torch.isfinite(got).all()
    return got, plain, _rel_l2(got.double(), exact), _rel_l2(plain.double(), exact)


@pytest.mark.parametrize("hid,C,n_mid,K,B,n,valid", [
    (64, 32, 1, 8, 1, 65_536, 0.3),  # the recipe's widths over one of its node chunks
    (64, 32, 1, 5, 2, 3001, 0.5), (64, 16, 2, 8, 1, 2000, 0.7), (32, 32, 0, 3, 1, 777, 0.6),
    (32, 16, 3, 128, 1, 50, 0.9),    # a node's slots fill a tile
    (16, 16, 1, 1, 1, 555, 0.8), (16, 8, 0, 8, 2, 999, 0.02),  # nearly every slot masked
])
def test_decoder_payload_matches_plain_and_float64(hid, C, n_mid, K, B, n, valid):
    """K9 against the plain path on the card (relative L2 1e-6) and both
    against float64: K9 at most 1e-6 and within 10% of the plain path's gap.
    Both take f32 products and exact GELUs, the library's GEMMs summing them
    in another order than K9, so either gap may come out the smaller by a
    rounding: on an H100 the first two cases (the recipe's widths) read
    1.2241e-7 against 1.2240e-7 and 1.2259e-7 against 1.2254e-7, and hidden
    width 16 read 6.37e-8 against 6.08e-8. Rows with no valid slot (the
    first 5 of each sample) give 0; masked slots hold any index; a few valid
    slots lie off the grid (the latent row clipped, the centre from the
    index, as the plain path takes them)."""
    rng = np.random.default_rng(hid + C + K + n)
    grid = LatentGrid(dims=(16, 16, 8))
    M = grid.num_tokens
    lat = rng.integers(0, M, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < valid
    msk[:, :5] = False
    lat[~msk] = rng.integers(-2 ** 31, 2 ** 31 - 1, int((~msk).sum()))
    off = msk & (rng.random((B, n, K)) < 0.001)
    lat[off] = rng.choice([-1, M, M + 5], int(off.sum()))
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    latent = rng.normal(size=(B, M, C)).astype(np.float32)
    ws, bs = _decoder_mlp(rng, [6] + [hid] * (n_mid + 1) + [C])
    pos, latent, lat, msk = (torch.from_numpy(x).cuda() for x in (pos, latent, lat, msk))
    got, plain, k9_gap, plain_gap = _decoder_gaps(latent, pos, lat, msk, ws, bs, grid)
    print(f"K9 vs float64 {k9_gap:.3e}, plain vs float64 {plain_gap:.3e}, "
          f"K9 vs plain {_rel_l2(got, plain):.3e}")
    assert torch.all(got[:, :5] == 0)
    assert _rel_l2(got, plain) <= 1e-6
    assert k9_gap <= 1e-6 and k9_gap <= 1.1 * plain_gap


def test_decoder_payload_at_drivaerml_size():
    """8,388,608 points of a closed surface, slots built on the card at the
    recipe's grid, radius and budget 8, the recipe's MLP: K9 against the
    plain path and both against float64, K9 no worse than the plain path
    (1.039e-7 against 1.040e-7 on an H100; the inputs are the same every
    run); two launches give the same bits."""
    grid = LatentGrid(dims=(64, 64, 32))
    N = 8_388_608
    g = torch.Generator(device="cuda").manual_seed(20)
    d = torch.randn(1, N, 3, device="cuda", generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    pos = 0.8 * d * (1 + 0.15 * torch.sin(3 * d[..., :1]) * torch.cos(2 * d[..., 1:2]))
    mask = torch.ones(1, N, dtype=torch.bool, device="cuda")
    slots = build_budgeted_slots(pos, grid, 0.033, 1, "bidirectional", mask, 8, 65_536)
    latent = torch.randn(1, grid.num_tokens, 32, device="cuda", generator=g)
    ws, bs = _decoder_mlp(np.random.default_rng(20), [6, 64, 64, 32])
    got, plain, k9_gap, plain_gap = _decoder_gaps(latent, pos, slots.lat_idx, slots.mask, ws,
                                                  bs, grid)
    valid = slots.mask.sum().item()
    print(f"{valid} valid slots ({valid / N:.3f} a node); K9 vs float64 {k9_gap:.3e}, plain vs "
          f"float64 {plain_gap:.3e}, K9 vs plain {_rel_l2(got, plain):.3e}")
    assert _rel_l2(got, plain) <= 1e-6
    assert k9_gap <= 1e-6 and k9_gap <= plain_gap
    with torch.no_grad():
        again = k9.decoder_payload(latent, pos, slots.lat_idx, slots.mask, ws, bs, grid)
    assert torch.equal(got, again)


def _k9_model(scales, slot_budget=None):
    magno = MAGNOConfig(lifting_channels=8, use_geoembed=[True, False], gno_radius=0.45,
                        in_gno_channel_mlp_hidden_layers=[16, 16],
                        out_gno_channel_mlp_hidden_layers=[16], projection_channels=16,
                        edge_chunk_size=128, scales=scales, slot_budget=slot_budget)
    attn = TransformerConfig(
        patch_size=2, hidden_size=32, num_layers=2, positional_embedding="rope",
        attn_config=AttentionConfig(hidden_size=32, num_heads=4, num_kv_heads=2,
                                    atten_dropout=0.0, attention_dtype="float32"),
        ffn_config=FFNConfig(hidden_size=64))
    return init_model(2, 1, "gaot_3d", magno, attn, latent_tokens=(4, 4, 4),
                      generator=torch.Generator().manual_seed(0), device="cuda").eval()


@pytest.mark.parametrize("scales", [[1.0], [1.0, 1.5]])
def test_decoder_payload_in_the_eval_forward(scales):
    """An eval forward on the card launches K9 once a scale; query rows
    without an edge decode to the head's output on zeros, bit for bit; with
    the gradient on, the same forward takes the plain path (no K9) and agrees
    within f32 rounding."""
    model = _k9_model(scales)
    rng = np.random.default_rng(len(scales))
    n = 512
    pos = torch.from_numpy(rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)).cuda()
    feats = torch.from_numpy(rng.normal(size=(1, n, 2)).astype(np.float32)).cuda()
    mask = torch.ones(1, n, dtype=torch.bool, device="cuda")
    mask[0, -9:] = False  # no edges: the decoder's GNO mean is 0 there
    before = k9.decoder_payload.launches
    with torch.inference_mode():
        got = model(pos, feats, mask)
        chunk = effective_chunk(n, model.magno_config.edge_chunk_size)
        head = model.decoder.projection(torch.zeros(1, chunk, 8, device="cuda"))
    torch.cuda.synchronize()
    assert k9.decoder_payload.launches == before + len(scales)
    assert torch.equal(got[0, -9:], head[0, -9:])
    with torch.enable_grad():
        want = model(pos, feats, mask)
    torch.cuda.synchronize()
    assert want.requires_grad and k9.decoder_payload.launches == before + len(scales)
    torch.testing.assert_close(got, want.detach(), atol=1e-5, rtol=1e-4)
