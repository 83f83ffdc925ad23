"""The keep mask that the split flash backward (K3) hands from its dk/dv
kernel to its dq kernel, on the CPU: the plain packing against the keep rule
on K4's plain bits, its layout, the two halves' contract through their plain
versions, and the halves in sequence against the JAX split kernels in
interpret mode. The kernels themselves run only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaot3d_tpu.ops.pallas_attention import flash_attention_dropout
from gaot3d_tpu_torch.kernels import dropout_bits as k4
from gaot3d_tpu_torch.kernels import flash_attention as k1
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)


def _keep(bits, rate):
    return k4.bits_as_int64(bits) >= k4.keep_threshold(rate)


@pytest.mark.parametrize("S,Skv,rate", [(77, 130, 0.1), (130, 1000, 0.5), (64, 64, 0.1),
                                        (1, 3, 0.9), (200, 63, 0.3)])
def test_keep_mask_packing_unpacks_to_the_keep_rule(S, Skv, rate):
    """On K4's plain bits with S and Skv no multiples of the 64-score tiles:
    the packing unpacks to exactly bits >= keep_threshold(rate), and every
    set bit of the mask is one of those (the padding is 0)."""
    bits = k4.dropout_bits_reference(0xC0FFEE + S, 3, S, Skv)
    mask = k1.pack_keep_mask_reference(bits, rate)
    assert mask.dtype == torch.uint32 and tuple(mask.shape) == k1.keep_mask_shape(3, S, Skv)
    keep = _keep(bits, rate)
    assert torch.equal(k1.unpack_keep_mask_reference(mask, S, Skv), keep)
    words = k4.bits_as_int64(mask)
    set_bits = sum(int(((words >> b) & 1).sum()) for b in range(32))
    assert set_bits == int(keep.sum())


@pytest.mark.parametrize("row,key", [(0, 0), (1, 0), (0, 1), (13, 6), (63, 63), (64, 0),
                                     (5, 64), (70, 129)])
def test_keep_mask_layout_places_one_score(row, key):
    """One kept score lands where the layout says: tile (key // 64, row //
    64), word 4 kp + (qp & 3), bit 4 (qp >> 2) + 2 (row & 1) + (key & 1), for
    the local pairs qp = (row % 64) // 2, kp = (key % 64) // 2."""
    bits = torch.zeros((1, 71, 130), dtype=torch.int64)
    bits[0, row, key] = 2 ** 32 - 1
    mask = k4.bits_as_int64(k1.pack_keep_mask_reference(
        bits.to(torch.int32).view(torch.uint32), 0.5))
    qp, kp = (row % 64) // 2, (key % 64) // 2
    want = torch.zeros_like(mask)
    want[0, key // 64, row // 64, 4 * kp + (qp & 3)] = 1 << (4 * (qp >> 2) + 2 * (row & 1)
                                                              + (key & 1))
    assert torch.equal(mask, want)


def _problem(dtype, S=150, Skv=130, seed=21):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(1, 2, s, 32)).astype(np.float32))
                     .to(dtype) for s in (S, Skv, Skv, S))
    return q, k, v, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_halves_hand_the_mask_over_on_cpu(dtype, rate):
    """The halves on CPU tensors run their plain versions: the dk/dv half
    returns no mask at rate 0 and, at a rate above 0, the plain packing of
    the seed's bits; the dq half on that mask, and the dk/dv half, give the
    full plain backward's gradients bit for bit; no kernel is counted."""
    q, k, v, dout = _problem(dtype)
    seed = 0x5EED_0007
    bits = k4.dropout_bits_reference(seed, 2, 150, 130) if rate > 0 else None
    out, lse = k1.flash_attention_reference(q, k, v, rate, bits)
    delta = (dout.float() * out.float()).sum(dim=-1)
    before = (k1.flash_attention_backward_dq.launches, k1.flash_attention_backward_dkv.launches)
    dk, dv, mask = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate, seed)
    dq = k1.flash_attention_backward_dq(q, k, v, lse, dout, delta, rate, mask)
    assert before == (k1.flash_attention_backward_dq.launches,
                      k1.flash_attention_backward_dkv.launches)
    if rate == 0:
        assert mask is None
    else:
        assert torch.equal(mask.view(torch.int32),
                           k1.pack_keep_mask_reference(bits, rate).view(torch.int32))
        _, _, from_bits = k1.flash_attention_backward_dkv(q, k, v, lse, dout, delta, rate,
                                                          dropout_bits=bits)
        assert torch.equal(from_bits.view(torch.int32), mask.view(torch.int32))
    want = k1.flash_attention_backward_reference(q, k, v, out, lse, dout, rate, bits)
    for got, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert torch.equal(got, w), name


def test_dq_half_refuses_a_missing_or_wrong_mask():
    """At a rate above 0 the dq half needs the dk/dv half's mask, of its
    shape and type, on any device; at rate 0 it needs none."""
    q, k, v, dout = _problem(torch.float32)
    lse = torch.zeros(1, 2, 150)
    args = (q, k, v, lse, dout, torch.zeros(1, 2, 150))
    with pytest.raises(ValueError, match="needs the keep mask"):
        k1.flash_attention_backward_dq(*args, 0.1)
    with pytest.raises(ValueError, match="needs the keep mask"):
        k1.flash_attention_backward_dq(*(t.to("meta") for t in args), 0.1)
    shape = k1.keep_mask_shape(2, 150, 130)
    with pytest.raises(ValueError, match="keep_mask must be uint32"):
        k1.flash_attention_backward_dq(*args, 0.1, torch.zeros(shape, dtype=torch.int32))
    with pytest.raises(ValueError, match="keep_mask must be uint32"):
        k1.flash_attention_backward_dq(
            *args, 0.1, torch.zeros((2, 2, 2, 128), dtype=torch.int32).view(torch.uint32))
    assert k1.flash_attention_backward_dq(*args, 0.0).shape == q.shape
    with pytest.raises(ValueError, match="no kernel for device"):
        k1.flash_attention_backward_dkv(*(t.to("meta") for t in args), 0.0)


@pytest.mark.parametrize("dtype,rel", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_halves_in_sequence_match_pallas_split(dtype, rel, rate, monkeypatch):
    """The dk/dv half, then the dq half on its mask, on CPU tensors, against
    the JAX split kernels (interpret mode under GAOT_ATTN_BWD_FUSED=0) fed the
    same bits, at K3's CPU tolerance relative to each gradient's max-abs:
    2e-5 in f32 (summation order), 2e-2 in bf16 (roundings of pm, ds and the
    results). S=150 and Skv=130 are no multiples of the 64-row tiles."""
    monkeypatch.setenv("GAOT_ATTN_BWD_FUSED", "0")
    S, Skv = 150, 130
    rng = np.random.default_rng(23)
    q, k, v, do = (rng.normal(size=(1, 2, s, 32)).astype(np.float32) for s in (S, Skv, Skv, S))
    nq, nk = -(-S // 64), -(-Skv // 64)
    blocked = rng.integers(0, 2 ** 32, size=(2, nq, nk, 64, 64), dtype=np.uint32)
    bits = k4.blocked_to_rowmajor(torch.from_numpy(blocked), S, Skv) if rate > 0 else None
    jbits = jnp.asarray(blocked) if rate > 0 else None
    jqkv = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]

    def f(q_, k_, v_):
        out = flash_attention_dropout(q_, k_, v_, dropout_rate=rate, dropout_bits=jbits,
                                      block_q=64, block_k=64, interpret=True)
        return jnp.vdot(out.astype(jnp.float32), jnp.asarray(do).astype(dtype))

    want = jax.grad(f, argnums=(0, 1, 2))(*jqkv)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v, do))
    out, lse = k1.flash_attention(tq, tk, tv, rate, dropout_bits=bits)
    delta = (tdo.float() * out.float()).sum(dim=-1)
    dk, dv, mask = k1.flash_attention_backward_dkv(tq, tk, tv, lse, tdo, delta, rate,
                                                   dropout_bits=bits)
    dq = k1.flash_attention_backward_dq(tq, tk, tv, lse, tdo, delta, rate, mask)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == tq.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)
