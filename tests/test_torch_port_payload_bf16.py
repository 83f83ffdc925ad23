"""The numerics of the bf16 bodies of the encoder-payload kernels K5 and K5b
(`kernel_dtype: bfloat16`), checked on the CPU before any card runs them.

The bf16 bodies round each layer's input (the positions [point | cell]
included) and weight to bf16, to nearest even (`cvt.rn.bf16x2.f32`), and
take the product in one m16n8k16 bf16 `mma.sync` pass with f32
accumulation; bias and GELU stay f32. The backward never rounds the f32
cotangent: its products with a bf16 operand are 2xTF32 (hi_d*b + lo_d*b,
`cvt.rna`-style hi and the rest cut to TF32), the chain's d(in) is rounded
to bf16 before gelu', and dW, summed in f32 over a launch (one node chunk),
is rounded to bf16 by the wrapper before the chunks are summed. This file
emulates that arithmetic in numpy, with every sum in float64 and one
rounding to f32 (another order than the plain versions' f32 sums, as the
card's), and holds it to the limits `chip_smoke.py` holds the bf16 kernels
to against their bf16 plain versions: relative L2 over the accumulator's C
value columns for K5, and relative L2 of each of dfeats, dW and db for K5b.
Another order of f32 sums flips a bf16 rounding here and there (of a hidden
activation, of a chunk's dW), one bf16 step of that value, so the limits are
bf16-grade and taken in L2, where such flips average out: about 1e-5 for
K5 and 5e-4 for K5b here, the worst being the first layer's dW, whose
entries are near-cancelling sums (on an H100, 9e-4 over one chunk of
200,000 rows; K5b's limit is 2e-3). Two ways to be wrong must not meet them:
a forward that leaves the positions in f32 (8e-4 over the value columns),
and a backward that rounds the cotangent to bf16 before its products (6e-3).
"""
import numpy as np
import pytest
import torch

from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid
from test_torch_port_payload_tf32 import cut, gelu_parts, tf32
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

K5_BF16_LIMIT = 1e-4   # chip_smoke.py K5_BF16_BOUND
K5B_BF16_LIMIT = 2e-3  # chip_smoke.py K5B_BF16_BOUND
WIDTHS = [6, 64, 64, 64, 32]
CHUNK = 400  # nodes: three chunks, each its own K5b launch and dW rounding


def bf16(x):
    """f32 rounded to bf16 to nearest even, held in f32 (torch's rounding,
    which `cvt.rn.bf16x2.f32` and JAX's astype share)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def product(a, b):
    """a @ b summed in float64, rounded once to f32 (exact products: the
    bf16 pass, or both TF32 passes of a bf16 operand)."""
    return (np.asarray(a, np.float64) @ np.asarray(b, np.float64)).astype(np.float32)


def product_2xtf32(d, b, d_left=True):
    """d @ b (d_left) or b @ d of an f32 cotangent d and a bf16 operand b:
    hi_d*b + lo_d*b, d split as the kernel splits it."""
    hi = tf32(d).astype(np.float64)
    lo = cut(np.asarray(d, np.float32) - tf32(d)).astype(np.float64)
    b = np.asarray(b, np.float64)
    out = hi @ b + lo @ b if d_left else b @ hi + b @ lo
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """1,200 nodes with 3 slots each (3,600 rows, about 70% valid) on an
    8x8x4 grid, weights like torch's Linear default, all from one seed."""
    rng = np.random.default_rng(2025)
    grid = LatentGrid(dims=(8, 8, 4))
    n, K, C = 1200, 3, WIDTHS[-1]
    M = grid.num_tokens
    pos = rng.uniform(-1, 1, (1, n, 3)).astype(np.float32)
    feats = rng.normal(size=(1, n, C)).astype(np.float32)
    lat = rng.integers(0, M, (1, n, K)).astype(np.int32)
    mask = rng.random((1, n, K)) < 0.7
    ws, bs = [], []
    for fan_in, fan_out in zip(WIDTHS[:-1], WIDTHS[1:]):
        bound = fan_in ** -0.5
        ws.append(rng.uniform(-bound, bound, (fan_out, fan_in)).astype(np.float32))
        bs.append(rng.uniform(-bound, bound, fan_out).astype(np.float32))
    g = rng.normal(size=(1, M, C + 11)).astype(np.float32)
    return grid, pos, feats, lat, mask, ws, bs, g


def emulate(problem, round_positions=True, round_cotangent=False):
    """The bf16 bodies' arithmetic: the accumulator of the forward, and
    (dfeats, [dW], [db]) of the backward, dW rounded once a CHUNK-node
    launch. `round_positions` False leaves [point | cell] in f32;
    `round_cotangent` True rounds every cotangent to bf16 before a product."""
    grid, pos, feats, lat, mask, ws, bs, g = problem
    _, n, K = lat.shape
    C, M = feats.shape[-1], grid.num_tokens
    t = torch.from_numpy
    ref_rows = k5.encoder_payload_reference(t(pos), t(feats), t(lat), [t(w) for w in ws],
                                            [t(b) for b in bs], grid)[0].numpy()
    cells = grid.positions_from_idx(t(lat), dtype=torch.float32)[0].reshape(n * K, 3).numpy()
    x0 = np.concatenate([np.repeat(pos[0], K, axis=0), cells], axis=1)
    feat_rows = np.repeat(feats[0], K, axis=0)
    valid = mask[0].reshape(-1)
    cell = lat[0].reshape(-1)

    wk = [bf16(w.T) for w in ws]  # the kernels' [in][out], rounded when staged
    zs, ins = [], [bf16(x0) if round_positions else x0]  # each layer's input, as multiplied
    for w, b in zip(wk[:-1], bs[:-1]):
        zs.append(product(ins[-1], w) + b)
        ins.append(bf16(gelu_parts(zs[-1])[0]))
    out = product(ins[-1], wk[-1]) + bs[-1]

    acc = torch.zeros(M, C + 11)
    payload = np.concatenate([out * feat_rows, ref_rows[:, C:]], axis=1)
    acc.index_add_(0, t(cell[valid]).long(), t(payload[valid]))

    gv = np.where(valid[:, None], g[0, np.where(valid, cell, 0), :C], 0).astype(np.float32)
    dfeats = (gv * out).reshape(n, K, C).sum(axis=1)
    cot = bf16 if round_cotangent else (lambda x: x)
    d = gv * feat_rows
    dws, dbs = [None] * len(wk), [None] * len(wk)
    launches = [slice(r, min(r + CHUNK * K, n * K)) for r in range(0, n * K, CHUNK * K)]
    for layer in range(len(wk) - 1, -1, -1):
        dws[layer] = sum(bf16(product_2xtf32(cot(d[rows]), ins[layer][rows].T, d_left=False))
                         for rows in launches)
        dbs[layer] = d.astype(np.float64).sum(axis=0).astype(np.float32)
        if layer > 0:
            d = bf16(product_2xtf32(cot(d), wk[layer].T)) * gelu_parts(zs[layer - 1])[1]
    return acc[None], (dfeats[None], [w.T for w in dws], dbs)


def plain(problem):
    grid, pos, feats, lat, mask, ws, bs, g = problem
    t = torch.from_numpy
    args = (t(pos), t(feats), t(lat), t(mask), [t(w) for w in ws], [t(b) for b in bs], grid)
    acc = k5.encoder_accumulate_reference(
        *args, torch.zeros(1, grid.num_tokens, feats.shape[-1] + 11), CHUNK, "bfloat16")
    dfeats, dws, dbs = k5.encoder_accumulate_backward_reference(t(g), *args, CHUNK, "bfloat16")
    return acc, (dfeats, dws, dbs)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def errors(problem, **variant):
    """(K5's relative L2 over the value columns, K5b's worst relative L2 over
    dfeats, dW, db)."""
    acc, (dfeats, dws, dbs) = emulate(problem, **variant)
    ref_acc, (ref_dfeats, ref_dws, ref_dbs) = plain(problem)
    C = problem[2].shape[-1]
    forward = rel_l2(acc.numpy()[..., :C], ref_acc.numpy()[..., :C])
    pairs = [(dfeats, ref_dfeats)] + list(zip(dws, ref_dws)) + list(zip(dbs, ref_dbs))
    backward = max(rel_l2(a, b.detach().numpy()) for a, b in pairs)
    return forward, backward


def test_bf16_rounds_to_nearest_even():
    """Eight mantissa bits kept, ties to even: 1 + 2^-8 is a tie and stays
    at 1, 1 + 3 * 2^-8 is a tie and goes up to 1 + 2^-6."""
    cases = np.array([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -8 + 2.0 ** -20,
                      -(1 + 3 * 2.0 ** -8)], np.float32)
    want = np.array([1.0, 1 + 2.0 ** -6, 1 + 2.0 ** -7, -(1 + 2.0 ** -6)], np.float32)
    np.testing.assert_array_equal(bf16(cases), want)


def test_bf16_bodies_meet_the_kernel_limits(problem):
    forward, backward = errors(problem)
    assert forward <= K5_BF16_LIMIT, forward
    assert backward <= K5B_BF16_LIMIT, backward


def test_positions_left_in_f32_do_not(problem):
    forward, _ = errors(problem, round_positions=False)
    assert forward > K5_BF16_LIMIT, forward


def test_a_rounded_cotangent_does_not(problem):
    _, backward = errors(problem, round_cotangent=True)
    assert backward > K5B_BF16_LIMIT, backward
