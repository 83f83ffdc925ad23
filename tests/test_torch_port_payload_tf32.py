"""The numerics that the encoder-payload kernels K5 and K5b rely on, checked
on the CPU before any card runs them.

The kernels take every layer product of the kernel MLP on the tensor cores
as 3xTF32: each f32 operand x is split into hi = tf32(x), rounded as
`cvt.rna.tf32.f32` rounds, and lo = x - hi cut to TF32, and a*b is
hi_a*hi_b + hi_a*lo_b + lo_a*hi_b (`mma.sync` m16n8k8 with f32
accumulation). This file emulates that rounding in numpy (10 mantissa bits,
to nearest, ties away from zero; the rest toward zero), runs the
forward payload and the backward (dfeats, dW, db) through it at the
recipe's widths 6-64-64-64-32 with C 32, and holds them to the limits
`chip_smoke.py` holds the kernels to against the f32 plain versions
(`encoder_accumulate_reference`, `encoder_accumulate_backward_reference`):
1e-5 relative for K5, 1e-4 of each gradient's max-abs for K5b. K5's is
taken over the accumulator's C value columns, the only ones a product
touches (the 11 moment columns are exact, and the count column would set
the scale of the whole accumulator). A single TF32 pass (hi_a*hi_b only)
must not meet them: that is why the kernels pay for three.
"""
import numpy as np
import pytest
import torch

from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

K5_LIMIT = 1e-5
K5B_LIMIT = 1e-4
WIDTHS = [6, 64, 64, 64, 32]


def tf32(x):
    """`cvt.rna.tf32.f32`: f32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (adding half a step to the magnitude bits, then cutting)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def cut(x):
    """A TF32 operand as the tensor core reads an f32: its low 13 bits dropped."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def product(a, b, passes):
    """a @ b for f32 a [r, k], b [k, n] as the kernels take it on the tensor
    cores: hi = tf32(x), lo = the rest x - hi cut to TF32, exact products
    summed in (more than) f32, one rounding to f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = tf32(a), tf32(b)
    out = ah.astype(np.float64) @ bh.astype(np.float64)
    if passes == 3:
        al = cut(a - ah).astype(np.float64)
        bl = cut(b - bh).astype(np.float64)
        out += ah.astype(np.float64) @ bl + al @ bh.astype(np.float64)
    return out.astype(np.float32)


def gelu_parts(z):
    """gelu(z) and gelu'(z) in f32 as the kernels take them (exact erf)."""
    zt = torch.from_numpy(z)
    phi = 0.5 * (1.0 + torch.erf(zt * 0.70710678118654752))
    gp = phi + zt * torch.exp(-0.5 * zt * zt) * 0.3989422804014327
    return (zt * phi).numpy(), gp.numpy()


@pytest.fixture(scope="module")
def problem():
    """1,200 nodes with 3 slots each (3,600 rows, about 70% valid) on an
    8x8x4 grid, weights like torch's Linear default, all from one seed."""
    rng = np.random.default_rng(2024)
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


def emulate(problem, passes):
    """The kernels' arithmetic with `passes` TF32 passes a product: the
    accumulator of the forward, and (dfeats, [dW], [db]) of the backward."""
    grid, pos, feats, lat, mask, ws, bs, g = problem
    _, n, K = lat.shape
    C, M = feats.shape[-1], grid.num_tokens
    t = torch.from_numpy
    # payload reference rows give [point | cell] and the 11 moment columns,
    # which the kernels round like the reference
    ref_rows = k5.encoder_payload_reference(t(pos), t(feats), t(lat), [t(w) for w in ws],
                                            [t(b) for b in bs], grid)[0].numpy()
    cells = grid.positions_from_idx(t(lat), dtype=torch.float32)[0].reshape(n * K, 3).numpy()
    points = np.repeat(pos[0], K, axis=0)
    x0 = np.concatenate([points, cells], axis=1)
    feat_rows = np.repeat(feats[0], K, axis=0)
    valid = mask[0].reshape(-1)
    cell = lat[0].reshape(-1)

    wk = [w.T.copy() for w in ws]  # the kernels' [in][out]
    h, zs, hs = x0, [], [x0]
    for w, b in zip(wk[:-1], bs[:-1]):
        z = product(h, w, passes) + b
        h = gelu_parts(z)[0]
        zs.append(z)
        hs.append(h)
    out = product(h, wk[-1], passes) + bs[-1]

    acc = torch.zeros(M, C + 11)
    payload = np.concatenate([out * feat_rows, ref_rows[:, C:]], axis=1)
    acc.index_add_(0, t(cell[valid]).long(), t(payload[valid]))

    gv = np.where(valid[:, None], g[0, np.where(valid, cell, 0), :C], 0).astype(np.float32)
    dfeats = (gv * out).reshape(n, K, C).sum(axis=1)
    d = gv * feat_rows
    dws, dbs = [None] * len(wk), [None] * len(wk)
    for layer in range(len(wk) - 1, -1, -1):
        dws[layer] = product(hs[layer].T, d, passes)
        dbs[layer] = d.astype(np.float64).sum(axis=0).astype(np.float32)
        if layer > 0:
            d = product(d, wk[layer].T, passes) * gelu_parts(zs[layer - 1])[1]
    return acc[None], (dfeats[None], [w.T for w in dws], dbs)


def plain(problem):
    grid, pos, feats, lat, mask, ws, bs, g = problem
    t = torch.from_numpy
    args = (t(pos), t(feats), t(lat), t(mask), [t(w) for w in ws], [t(b) for b in bs], grid)
    acc = k5.encoder_accumulate_reference(*args, torch.zeros(1, grid.num_tokens,
                                                             feats.shape[-1] + 11))
    dfeats, dws, dbs = k5.encoder_accumulate_backward_reference(t(g), *args)
    return acc, (dfeats, dws, dbs)


def relative(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def errors(problem, passes):
    """(K5's relative error, K5b's worst relative error over dfeats, dW, db)."""
    acc, (dfeats, dws, dbs) = emulate(problem, passes)
    ref_acc, (ref_dfeats, ref_dws, ref_dbs) = plain(problem)
    C = problem[2].shape[-1]  # the value columns
    forward = relative(acc.numpy()[..., :C], ref_acc.numpy()[..., :C])
    pairs = [(dfeats, ref_dfeats)] + list(zip(dws, ref_dws)) + list(zip(dbs, ref_dbs))
    backward = max(relative(a, b.detach().numpy()) for a, b in pairs)
    return forward, backward


def test_tf32_rounds_to_nearest_ties_away():
    """Ten mantissa bits kept: 1 + 2^-11 is a tie and goes up (away from
    zero), just under it goes down; negative values mirror."""
    one = np.float32(1.0)
    step = np.float32(2.0 ** -10)
    cases = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23, 1 + 3 * 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.0], np.float32)
    want = np.array([one + step, one, one + 2 * step, -(one + step), 3.0], np.float32)
    np.testing.assert_array_equal(tf32(cases), want)
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    hi = tf32(x)
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all((hi.view(np.uint32) & np.uint32(0x1FFF)) == 0)


def test_three_tf32_passes_meet_the_kernel_limits(problem):
    forward, backward = errors(problem, passes=3)
    assert forward <= K5_LIMIT, forward
    assert backward <= K5B_LIMIT, backward


def test_one_tf32_pass_does_not(problem):
    forward, backward = errors(problem, passes=1)
    assert forward > K5_LIMIT, forward
    assert backward > K5B_LIMIT, backward
