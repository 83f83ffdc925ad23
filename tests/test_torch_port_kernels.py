"""The plain versions of the port's CUDA kernels against the JAX Pallas
kernels they replace, run in interpret mode on CPU, and the wrappers' CPU
dispatch and argument checks. The kernels themselves run only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.models.fused_encoder import FusedEncoderScale as JaxFusedEncoderScale
from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu.ops.pallas_attention import _flash_fwd_impl, flash_attention_dropout
from gaot3d_tpu.ops.pallas_encoder import encoder_payload
from gaot3d_tpu_torch.kernels import dropout_bits as k4
from gaot3d_tpu_torch.kernels import encoder_payload as k5
from gaot3d_tpu_torch.kernels import flash_attention as k1
from gaot3d_tpu_torch.ops.grid_graph import LatentGrid

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _qkv(S, Skv, seed=0, B=1, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, s, D)).astype(np.float32) for s in (S, Skv, Skv)]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S,Skv", [(128, 128), (192, 160)])
def test_flash_twin_matches_pallas(dtype, atol, S, Skv):
    """bf16: P is rounded to bf16 per 64-key block in the Pallas kernel and per
    full row in the twin, so the bound is bf16-grade."""
    q, k, v = _qkv(S, Skv)
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    want = flash_attention_dropout(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    _, want_lse = _flash_fwd_impl(jq, jk, jv, jnp.zeros((2,), jnp.int32), None, 0.0, 64, 64,
                                  True)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
    out, lse = k1.flash_attention_reference(tq, tk, tv)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5, rtol=1e-6)


def test_flash_wrapper_cpu_uses_twin_without_counting():
    q, k, v = (torch.from_numpy(x) for x in _qkv(70, 70, seed=1))
    before = k1.flash_attention.launches
    out, lse = k1.flash_attention(q, k, v)
    ref_out, ref_lse = k1.flash_attention_reference(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert k1.flash_attention.launches == before


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q, k[:, :, :5], v), "shape mismatch"),
    (lambda q, k, v: (q.to(torch.float16), k.to(torch.float16), v.to(torch.float16)), "dtype"),
    (lambda q, k, v: (q, k.to(torch.bfloat16), v), "dtype"),
    (lambda q, k, v: (q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3)), "contiguous"),
    (lambda q, k, v: (q[..., :24].contiguous(), k[..., :24].contiguous(),
                      v[..., :24].contiguous()), "head dim"),
])
def test_flash_wrapper_checks(bad, match):
    q, k, v = (torch.from_numpy(x) for x in _qkv(32, 32, seed=2))
    with pytest.raises(ValueError, match=match):
        k1._check(*bad(q, k, v))


def _payload_problem(n=64, K=5, C=16, seed=0):
    rng = np.random.default_rng(seed)
    dims, lo, sp = (6, 5, 4), (-1.0, -0.5, 0.0), (0.4, 0.25, 0.3)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, C)).astype(np.float32)
    lat = rng.integers(0, 6 * 5 * 4, size=(n, K)).astype(np.int32)
    sizes = [6, 32, 32, C]
    ws = [(rng.normal(size=(sizes[i], sizes[i + 1])) * 0.4).astype(np.float32)
          for i in range(3)]
    bs = [(rng.normal(size=(sizes[i + 1],)) * 0.1).astype(np.float32) for i in range(3)]
    grid = LatentGrid(dims=dims, lo=lo, hi=tuple(lo[a] + sp[a] * (dims[a] - 1)
                                                 for a in range(3)))
    return pos, feats, lat, ws, bs, grid


def test_payload_twin_matches_pallas():
    pos, feats, lat, ws, bs, grid = _payload_problem()
    want = encoder_payload(jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(lat),
                           [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
                           grid.dims, grid.lo, grid.spacing, block=32, interpret=True)
    got = k5.encoder_payload_reference(
        torch.from_numpy(pos), torch.from_numpy(feats), torch.from_numpy(lat),
        [torch.from_numpy(w.T.copy()) for w in ws], [torch.from_numpy(b) for b in bs], grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [None, 16])
def test_accumulate_twin_matches_fused_encoder_accumulator(chunk):
    """The masked index_add_ twin against the JAX FusedEncoderScale moment
    accumulator (`_run_slotted`), masked slots holding garbage indices."""
    B, n, K, C = 2, 48, 4, 8
    dims = (4, 4, 4)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    feats = rng.normal(size=(B, n, C)).astype(np.float32)
    lat = rng.integers(0, 64, (B, n, K)).astype(np.int32)
    msk = rng.random((B, n, K)) < 0.5
    jmod = JaxFusedEncoderScale(lifting_channels=C, kernel_layers=(6, 16, 16, C),
                                transform_type="linear", grid=jgg.LatentGrid(dims=dims),
                                edge_chunk_size=chunk)
    slots = jgg.EdgeSlots(jnp.asarray(lat), jnp.asarray(msk))
    args = (slots, jnp.asarray(pos), jnp.asarray(feats), 64)
    params = jmod.init(jax.random.key(0), *args, method=JaxFusedEncoderScale._run_slotted)
    want = jmod.apply(params, *args, method=JaxFusedEncoderScale._run_slotted)
    p = params["params"]
    ws = [torch.from_numpy(np.array(p[f"kernel_w{i}"]).T.copy()) for i in range(3)]
    bs = [torch.from_numpy(np.array(p[f"kernel_b{i}"])) for i in range(3)]
    lat[~msk] = 10 ** 6  # must be skipped, not clamped
    acc = torch.zeros((B, 64, C + 11))
    assert not msk[0, 0, 0]
    bad, msk_bad = lat.copy(), msk.copy()
    bad[0, 0, 0], msk_bad[0, 0, 0] = 64, True  # a valid slot outside the grid is dropped
    dropped = k5.encoder_accumulate_reference(
        torch.from_numpy(pos), torch.from_numpy(feats), torch.from_numpy(bad),
        torch.from_numpy(msk_bad), ws, bs, LatentGrid(dims=dims), torch.zeros_like(acc),
        chunk=chunk)
    got = k5.encoder_accumulate(torch.from_numpy(pos), torch.from_numpy(feats),
                                torch.from_numpy(lat), torch.from_numpy(msk), ws, bs,
                                LatentGrid(dims=dims), acc, chunk=chunk)
    assert got is acc
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(dropped.numpy(), acc.numpy())


def _k5_args(hid=64, C=32, n_hidden=3):
    B, n, K = 1, 8, 3
    grid = LatentGrid(dims=(4, 4, 4))
    sizes = [6] + [hid] * n_hidden + [C]
    ws = [torch.zeros(sizes[i + 1], sizes[i]) for i in range(len(sizes) - 1)]
    bs = [torch.zeros(sizes[i + 1]) for i in range(len(sizes) - 1)]
    return [torch.zeros(B, n, 3), torch.zeros(B, n, C), torch.zeros(B, n, K, dtype=torch.int32),
            torch.zeros(B, n, K, dtype=torch.bool), ws, bs, grid,
            torch.zeros(B, 64, C + 11)]


def _set(i, v):
    def f(a):
        a[i] = v(a[i])
        return a
    return f


@pytest.mark.parametrize("mutate,match", [
    (lambda a: a, None),
    (_set(0, lambda t: t.double()), "pos must be"),
    (_set(2, lambda t: t.long()), "lat_idx must be"),
    (_set(3, lambda t: t[:, :4]), "lat_idx and mask"),
    (_set(7, lambda t: t[:, :10]), "acc"),
    (_set(1, lambda t: torch.zeros(*t.shape[:2], 2 * t.shape[2])[..., ::2]), "contiguous"),
    (lambda a: (a[4].pop(1), a[5].pop(1), a)[2], None),  # one hidden layer fewer
    (_set(4, lambda ws: [torch.zeros(48, 6)] + ws[1:]), "kernel MLP"),
])
def test_payload_wrapper_checks(mutate, match):
    args = mutate(_k5_args())
    if match is None:
        k5._check(*args)
    else:
        with pytest.raises(ValueError, match=match):
            k5._check(*args)


def test_payload_wrapper_rejects_unbuilt_widths():
    with pytest.raises(ValueError, match="not built"):
        k5._check(*_k5_args(hid=48, C=32))


# --- attention dropout: the bits (K4), the forward with dropout (K1), the backward (K2)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(counter, key, want):
    """The Philox4x32-10 test vectors of the Random123 library."""
    words = k4.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert " ".join(f"{int(w):08x}" for w in words) == want


def test_dropout_bits_stream():
    """The stream is a function of (seed, head, row, column) alone: the same
    seed gives the same bits, a crop of a larger export equals the smaller
    export, another seed (another layer) or head gives other bits, and the
    keep rule keeps 1 - rate of them."""
    seed = 0x0123_4567_89AB_CDEF
    bits = k4.export_dropout_bits(seed, 3, 250, 333, device="cpu")
    assert bits.dtype == torch.uint32 and tuple(bits.shape) == (3, 250, 333)
    as_int = k4.bits_as_int64
    assert torch.equal(as_int(bits), as_int(k4.dropout_bits_reference(seed, 3, 250, 333)))
    small = k4.dropout_bits_reference(seed, 2, 77, 130)
    assert torch.equal(as_int(small), as_int(bits)[:2, :77, :130])
    assert not torch.equal(as_int(bits), as_int(k4.dropout_bits_reference(seed + 1, 3, 250, 333)))
    assert not torch.equal(as_int(bits)[0], as_int(bits)[1])
    # element (1, 3, 6) reads word (3 & 1) * 2 + (6 & 1) of counter (3, 1, head 1, 0)
    lo, hi = k4.seed_words(seed)
    ctr = tuple(torch.tensor([c], dtype=torch.int64) for c in (3, 1, 1, 0))
    assert int(as_int(bits)[1, 3, 6]) == int(k4.philox4x32_10(ctr, (lo, hi))[2])
    for rate in (0.1, 0.5):
        kept = (k4.keep_multiplier(bits, rate) > 0).double().mean().item()
        assert abs(kept - (1 - rate)) < 5e-3
        assert k4.keep_multiplier(bits, rate).max().item() == pytest.approx(1 / (1 - rate))
    assert not k4.keep_multiplier(bits, 1.0).any()
    assert k4.keep_threshold(0.3) == int(np.uint32(0.3 * 4294967295.0))


def test_blocked_and_rowmajor_bits_round_trip():
    rng = np.random.default_rng(0)
    blocked = torch.from_numpy(rng.integers(0, 2 ** 32, size=(2, 3, 3, 64, 64), dtype=np.uint32))
    dense = k4.blocked_to_rowmajor(blocked, 192, 130)
    assert tuple(dense.shape) == (2, 192, 130)
    # the JAX oracle's own flattening (tests/test_pallas_attention.py `_dense_oracle`)
    want = blocked.numpy().transpose(0, 1, 3, 2, 4).reshape(2, 192, 192)[:, :, :130]
    np.testing.assert_array_equal(dense.numpy(), want)
    back = k4.rowmajor_to_blocked(dense, 64, 64)
    assert tuple(back.shape) == (2, 3, 3, 64, 64)
    np.testing.assert_array_equal(k4.blocked_to_rowmajor(back, 192, 130).numpy(), dense.numpy())
    assert not back.numpy()[:, :, 2, :, 2:].any()  # the padding of the last key block is zero


def _dropout_problem(dtype, S=192, Skv=130, seed=11):
    """q, k, v and one set of random bits in both layouts."""
    q, k, v = _qkv(S, Skv, seed=seed)
    rng = np.random.default_rng(seed + 1)
    nq, nk = -(-S // 64), -(-Skv // 64)
    blocked = rng.integers(0, 2 ** 32, size=(2, nq, nk, 64, 64), dtype=np.uint32)
    dense = k4.blocked_to_rowmajor(torch.from_numpy(blocked), S, Skv)
    jqkv = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    tqkv = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    return jqkv, tqkv, jnp.asarray(blocked), dense


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_flash_dropout_plain_matches_pallas(dtype, atol, rate):
    """One set of bits through the Pallas kernel (interpret mode) and the
    plain forward, S=192, Skv=130. bf16: P is rounded per 64-key tile there
    and per row here."""
    jqkv, tqkv, jbits, bits = _dropout_problem(dtype)
    want = flash_attention_dropout(*jqkv, dropout_rate=rate, dropout_bits=jbits, block_q=64,
                                   block_k=64, interpret=True)
    out, lse = k1.flash_attention_reference(*tqkv, rate, bits)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    # dropout leaves the denominator, and so lse, as it was
    _, lse0 = k1.flash_attention_reference(*tqkv)
    assert torch.equal(lse, lse0)
    wrapped, _ = k1.flash_attention(*tqkv, rate, dropout_bits=bits)
    assert torch.equal(wrapped, out)


@pytest.mark.parametrize("dtype,rel", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("fused", ["1", "0"])
def test_flash_backward_plain_matches_pallas_grad(dtype, rel, rate, fused, monkeypatch):
    """The plain backward against jax.grad through the Pallas kernels, fused
    and split (GAOT_ATTN_BWD_FUSED=0), with the same bits. Bounds relative to
    each gradient's max-abs: summation order in f32, roundings of pm, ds and
    the results in bf16."""
    monkeypatch.setenv("GAOT_ATTN_BWD_FUSED", fused)
    jqkv, tqkv, jbits, bits = _dropout_problem(dtype, seed=13)
    if rate == 0.0:
        jbits = bits = None
    do = np.random.default_rng(5).normal(size=(1, 2, 192, 32)).astype(np.float32)

    def f(q, k, v):
        out = flash_attention_dropout(q, k, v, dropout_rate=rate, dropout_bits=jbits,
                                      block_q=64, block_k=64, interpret=True)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(do).astype(dtype))

    want = jax.grad(f, argnums=(0, 1, 2))(*jqkv)
    tdo = torch.from_numpy(do).to(tqkv[0].dtype)
    out, lse = k1.flash_attention_reference(*tqkv, rate, bits)
    got = k1.flash_attention_backward_reference(*tqkv, out, lse, tdo, rate, bits)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tqkv[0].dtype
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)
    # the autograd function reaches the same plain versions on CPU tensors
    leaves = [t.clone().requires_grad_() for t in tqkv]
    auto = torch.autograd.grad(k1.attention(*leaves, rate, None, bits), leaves, tdo)
    assert all(torch.equal(a, g) for a, g in zip(auto, got))


@pytest.mark.parametrize("dtype,rel", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,Skv", [(192, 130), (150, 64)])
def test_flash_backward_split_matches_pallas_split(dtype, rel, rate, S, Skv, monkeypatch):
    """K3 on the CPU: the same q, k, v, dO and bits through the JAX split
    kernels (interpret mode under GAOT_ATTN_BWD_FUSED=0) and through
    `flash_attention_backward_split` on CPU tensors, at K2's CPU tolerance:
    relative to each gradient's max-abs, 2e-5 in f32 (summation order) and
    2e-2 in bf16 (roundings of pm, ds and the results). S=150 and Skv=130 are
    no multiples of the 64-row tiles."""
    monkeypatch.setenv("GAOT_ATTN_BWD_FUSED", "0")
    jqkv, tqkv, jbits, bits = _dropout_problem(dtype, S=S, Skv=Skv, seed=17)
    if rate == 0.0:
        jbits = bits = None
    do = np.random.default_rng(6).normal(size=(1, 2, S, 32)).astype(np.float32)

    def f(q, k, v):
        out = flash_attention_dropout(q, k, v, dropout_rate=rate, dropout_bits=jbits,
                                      block_q=64, block_k=64, interpret=True)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(do).astype(dtype))

    want = jax.grad(f, argnums=(0, 1, 2))(*jqkv)
    tdo = torch.from_numpy(do).to(tqkv[0].dtype)
    out, lse = k1.flash_attention(*tqkv, rate, dropout_bits=bits)
    before = (k1.flash_attention_backward_dq.launches, k1.flash_attention_backward_dkv.launches)
    got = k1.flash_attention_backward_split(*tqkv, out, lse, tdo, rate, dropout_bits=bits)
    # CPU tensors go to the plain version: no kernel is counted
    assert before == (k1.flash_attention_backward_dq.launches,
                      k1.flash_attention_backward_dkv.launches)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tqkv[0].dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)
    again = k1.flash_attention_backward_split(*tqkv, out, lse, tdo, rate, dropout_bits=bits)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("switch,want", [(None, "fused"), ("1", "fused"), ("0", "split")])
def test_attention_backward_follows_the_switch(switch, want, monkeypatch):
    """`attention(...)`'s backward reads GAOT_ATTN_BWD_FUSED when it runs:
    "0" takes the split wrapper, unset or "1" the fused one."""
    calls = {"fused": 0, "split": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(k1, "flash_attention_backward",
                        counted("fused", k1.flash_attention_backward))
    monkeypatch.setattr(k1, "flash_attention_backward_split",
                        counted("split", k1.flash_attention_backward_split))
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(40, 30, seed=3))
    out = k1.attention(q, k, v, 0.2, seed=5)
    # the switch is read at the backward, not when the forward ran
    if switch is None:
        monkeypatch.delenv("GAOT_ATTN_BWD_FUSED", raising=False)
    else:
        monkeypatch.setenv("GAOT_ATTN_BWD_FUSED", switch)
    assert k1.backward_is_split() == (want == "split")
    out.sum().backward()
    assert calls == {"fused": int(want == "fused"), "split": int(want == "split")}
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_flash_backward_split_refuses_other_devices():
    q, k, v = (torch.from_numpy(x) for x in _qkv(16, 16))
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.flash_attention_backward_split(*meta, meta[0], torch.empty(1, 2, 16, device="meta"),
                                          meta[0])


def test_flash_dropout_rate_one_drops_all_and_a_mask_is_required():
    _, tqkv, _, bits = _dropout_problem("float32", S=70, Skv=50)
    out, _ = k1.flash_attention(*tqkv, 1.0, dropout_bits=bits)
    assert not out.any()
    grads = k1.flash_attention_backward(*tqkv, out, torch.zeros(1, 2, 70), torch.ones_like(out),
                                        1.5, seed=3)
    assert not grads[2].any()  # nothing was kept, so v got nothing
    with pytest.raises(ValueError, match="seed or explicit bits"):
        k1.flash_attention(*tqkv, 0.1)
    with pytest.raises(ValueError, match="seed or explicit bits"):
        k1.attention(*tqkv, 0.1)
    with pytest.raises(ValueError, match="explicit bits"):
        k1.flash_attention_reference(*tqkv, 0.1)
    with pytest.raises(ValueError, match="dropout_bits must be uint32"):
        k1.flash_attention(*tqkv, 0.1, dropout_bits=bits[:, :10])
    seeded, lse = k1.flash_attention(*tqkv, 0.3, seed=21)  # the CPU draws the plain Philox bits
    bits21 = k4.dropout_bits_reference(21, 2, 70, 50)
    from_bits, _ = k1.flash_attention(*tqkv, 0.3, dropout_bits=bits21)
    assert torch.equal(seeded, from_bits)
    other, _ = k1.flash_attention(*tqkv, 0.3, seed=22)
    assert not torch.equal(seeded, other)
    # the backward replays the same mask from the seed as from its bits
    dout = torch.ones_like(out)
    g_seed = k1.flash_attention_backward(*tqkv, seeded, lse, dout, 0.3, seed=21)
    g_bits = k1.flash_attention_backward(*tqkv, seeded, lse, dout, 0.3, dropout_bits=bits21)
    assert all(torch.equal(a, b) for a, b in zip(g_seed, g_bits))


# --- the encoder backward (K5b)


def test_payload_backward_plain_matches_pallas_vjp():
    """dfeats, dW, db from the plain backward against jax.vjp of the Pallas
    payload kernel (interpret mode) composed with the masked scatter, with
    garbage in the masked slots and one valid slot off the grid: relative
    1e-5 of each gradient's max-abs."""
    pos, feats, lat, ws, bs, grid = _payload_problem(n=64, K=5, C=16, seed=4)
    rng = np.random.default_rng(9)
    M, C = grid.num_tokens, 16
    msk = rng.random(lat.shape) < 0.6
    g = rng.normal(size=(1, M, C + 11)).astype(np.float32)
    keep = jnp.asarray(msk.reshape(-1))
    ids = jnp.asarray(lat.reshape(-1))

    def accumulate(feats_, ws_, bs_):
        payload = encoder_payload(jnp.asarray(pos), feats_, jnp.asarray(lat), ws_, bs_,
                                  grid.dims, grid.lo, grid.spacing, block=32, interpret=True)
        payload = jnp.where(keep[:, None], payload, 0.0)
        return jnp.zeros((M, C + 11)).at[ids].add(payload)

    _, vjp = jax.vjp(accumulate, jnp.asarray(feats), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    want_f, want_w, want_b = vjp(jnp.asarray(g[0]))
    lat_bad, msk_bad = lat.copy(), msk.copy()
    lat_bad[~msk] = 10 ** 6          # masked slots may hold anything
    assert not msk[0, 0]
    lat_bad[0, 0], msk_bad[0, 0] = M, True  # valid but off the grid: skipped like the forward
    t = torch.from_numpy
    got_f, got_w, got_b = k5.encoder_accumulate_backward(
        t(g), t(pos[None]), t(feats[None]), t(lat_bad[None]), t(msk_bad[None]),
        [t(w.T.copy()) for w in ws], [t(b) for b in bs], grid, chunk=16)

    def close(a, w, name):
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)

    close(got_f[0].numpy(), want_f, "dfeats")
    for i in range(3):
        close(got_w[i].numpy().T, want_w[i], f"dW{i}")
        close(got_b[i].numpy(), want_b[i], f"db{i}")


def test_accumulate_autograd_threads_one_accumulator():
    """`accumulate` twice into one accumulator (as the degree sections do)
    under autograd: the gradients are those of autograd through the plain
    payload, the accumulator's own gradient is the identity, and the forward
    is the in-place wrapper's."""
    pos, feats, lat, ws, bs, grid = _payload_problem(n=48, K=3, C=16, seed=6)
    rng = np.random.default_rng(2)
    msk = rng.random(lat.shape) < 0.7
    t = torch.from_numpy
    args = [t(pos[None]), t(feats[None]).requires_grad_(), t(lat[None]), t(msk[None])]
    tw = [t(w.T.copy()).requires_grad_() for w in ws]
    tb = [t(b).requires_grad_() for b in bs]
    acc0 = torch.zeros(1, grid.num_tokens, 27, requires_grad=True)
    acc = k5.accumulate(*args, tw, tb, grid, acc0 * 1.0)
    acc = k5.accumulate(*args, tw, tb, grid, acc, chunk=16)
    once = k5.encoder_accumulate(*[a.detach() for a in args], [w.detach() for w in tw],
                                 [b.detach() for b in tb], grid,
                                 torch.zeros(1, grid.num_tokens, 27))
    torch.testing.assert_close(acc.detach(), 2 * once)
    g = t(rng.normal(size=tuple(acc.shape)).astype(np.float32))
    got = torch.autograd.grad(acc, [acc0, args[1], *tw, *tb], g)
    want = k5.encoder_accumulate_backward_reference(g, *[a.detach() for a in args], tw, tb, grid)
    assert torch.equal(got[0], g)
    torch.testing.assert_close(got[1], 2 * want[0])
    for a, b in zip(got[2:], want[1] + want[2]):
        torch.testing.assert_close(a, 2 * b, atol=1e-5, rtol=1e-5)
