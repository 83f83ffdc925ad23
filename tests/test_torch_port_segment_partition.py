"""K6's merge-path split and its ordered twin on the CPU.

K6 (`csrc/segment_sum_sorted.cu`) splits each batch's merged sequence of
rows and segment boundaries into shares, one a CTA; a CTA owns the segments
whose boundaries fall in its share and reads their rows, past its share for
the last of them. `merge_path_split` computes that split with plain torch
ops, and `segment_sum_sorted_ordered_reference` sums along it, which gives the
kernel's bits on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
Here the split is checked to cover every valid row and every segment exactly
once, and the twin is held:
- against the plain version (`index_add_`, which on the CPU adds in row order
  from 0 too): bit for bit;
- against the JAX kernel, `segment_sum_sorted_pallas` run in interpret mode
  with one f32 pass (on the CPU its one-hot product is exact float32, summed
  in its own blocked order): each entry within 1e-6 of its segment's sum of
  magnitudes. Two float32 sums of the same rows in two orders differ by
  rounding that follows the magnitudes summed, not the result: where a
  segment of 256 rows cancels to a small sum, the two differ by 2.8e-5 of
  its column's max-abs and 3e-8 of the magnitudes (a hypothesis example).
Ids are drawn with numpy from a seed, or by hypothesis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gaot3d_tpu.ops.pallas_segment import segment_sum_sorted_pallas
from gaot3d_tpu_torch.kernels import segment_sum_sorted as k6
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

t = torch.from_numpy
MT = 32  # the JAX kernel's segment tile: its M is padded up to a multiple of it


def _check_split(ids, M, share):
    """Every share holds `share` items, and the owners' segments and rows
    cover [0, M) and the valid rows exactly once, in order."""
    E = ids.shape[0]
    split = {k: v.numpy() for k, v in k6.merge_path_split(t(ids), M, share).items()}
    sizes = split["r1"] - split["r0"] + split["s1"] - split["s0"]
    assert sizes.sum() == E + M and (sizes[:-1] == share).all()
    own = split["s0"] < split["s1"]
    segs = np.concatenate([np.arange(a, b) for a, b in zip(split["s0"][own], split["s1"][own])]
                          + [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(segs, np.arange(M))
    rows = np.concatenate([np.arange(a, z) for a, z in zip(split["a"][own], split["z"][own])]
                          + [np.zeros(0, np.int64)])
    np.testing.assert_array_equal(rows, np.flatnonzero((ids >= 0) & (ids < M)))
    # an owner's rows start inside its share and go past it only for its last segment
    a, z, r0, r1 = (split[k][own] for k in ("a", "z", "r0", "r1"))
    assert ((r0 <= a) & (a <= r1)).all()
    last = split["s1"][own] - 1
    for zz, rr, s in zip(z, r1, last):
        assert (ids[rr:zz] == s).all()


def _jax_sum(data, ids, M):
    """segment_sum_sorted_pallas in interpret mode, one f32 pass, M padded up
    to a multiple of MT (rows to drop carry the padded M)."""
    Mp = -(-M // MT) * MT
    seg = np.where(ids >= M, Mp, ids).astype(np.int32)
    out = segment_sum_sorted_pallas(jnp.asarray(data), jnp.asarray(seg), Mp, mt=MT, slab=64,
                                    interpret=True, passes=1)
    return np.asarray(out)[:M]


def _check_twin(data, ids, M, share, jax_too=True):
    got = k6.segment_sum_sorted_ordered_reference(t(data), t(ids), M, share)
    plain = k6.segment_sum_sorted_reference(t(data), t(ids), M)
    assert got.shape == plain.shape and torch.equal(got, plain)
    if jax_too:
        size = k6.segment_sum_sorted_reference(t(np.abs(data)), t(ids), M)
        for b in range(data.shape[0]):
            want = _jax_sum(data[b], ids[b], M)
            assert (np.abs(got[b].numpy() - want) <= 1e-6 * size[b].numpy()).all()


def _ids(rng, E, M, n_valid, n_negative=0, hot=None, hot_rows=0):
    """Sorted ids [E]: n_negative negative ids at the head, n_valid ids in
    [0, M) (hot_rows of them equal to `hot`), the rest M or more."""
    valid = rng.integers(0, M, n_valid - hot_rows)
    valid = np.sort(np.concatenate([valid, np.full(hot_rows, hot or 0)]))
    tail = M + rng.integers(0, 3, E - n_valid - n_negative)
    return np.concatenate([-1 - rng.integers(0, 4, n_negative)[::-1].cumsum()[::-1], valid,
                           np.sort(tail)]).astype(np.int32)


def _case(name, rng):
    """(data [B, E, P], ids [B, E], M, share) of each named case."""
    P = 5
    if name == "hot segment spanning many shares":
        ids = [_ids(rng, 400, 40, 390, hot=17, hot_rows=300)]
        M, share = 40, 8
    elif name == "empty run longer than a share":
        ids = [np.sort(np.concatenate([rng.integers(0, 10, 150), rng.integers(400, 500, 150),
                                       np.full(20, 500)])).astype(np.int32)]
        M, share = 500, 16
    elif name == "negative ids at the head":
        ids = [_ids(rng, 300, 60, 250, n_negative=30)]
        M, share = 60, 11
    elif name == "a batch all padding":
        ids = [_ids(rng, 200, 50, 180), np.full(200, 50, np.int32)]
        M, share = 50, 9
    elif name == "M no multiple of any tile":
        ids = [_ids(rng, 1003, 517, 950)]
        M, share = 517, k6.share_items(43)
        P = 43
    elif name == "three batches, different valid counts":
        ids = [_ids(rng, 300, 257, n) for n in (300, 211, 3)]
        M, share = 257, 13
    elif name == "share boundaries inside segments":
        ids = [np.repeat(np.arange(30), 10).astype(np.int32)]
        M, share = 30, 4
    else:
        raise KeyError(name)
    ids = np.stack(ids)
    data = rng.normal(size=ids.shape + (P,)).astype(np.float32)
    return data, ids, M, share


_CASES = ["hot segment spanning many shares", "empty run longer than a share",
          "negative ids at the head", "a batch all padding", "M no multiple of any tile",
          "three batches, different valid counts", "share boundaries inside segments"]


@pytest.mark.parametrize("name", _CASES)
def test_split_and_twin_on_named_cases(name):
    data, ids, M, share = _case(name, np.random.default_rng(len(name)))
    for b in range(ids.shape[0]):
        _check_split(ids[b], M, share)
    _check_twin(data, ids, M, share)


def test_share_boundaries_fall_inside_segments():
    """The named case does what it says: some share ends between two rows of
    one segment, so its owner reads past its share."""
    _, ids, M, share = _case("share boundaries inside segments", np.random.default_rng(0))
    split = k6.merge_path_split(t(ids[0]), M, share)
    own = split["s0"] < split["s1"]
    assert (split["z"][own] > split["r1"][own]).any()


def test_twin_of_an_unbatched_call_and_the_shipped_share():
    rng = np.random.default_rng(3)
    ids = _ids(rng, 2000, 700, 1900, n_negative=5)
    data = rng.normal(size=(2000, 43)).astype(np.float32)
    share = k6.share_items(43)
    assert share == 190
    got = k6.segment_sum_sorted_ordered_reference(t(data), t(ids), 700, share)
    assert got.shape == (700, 43)
    assert torch.equal(got, k6.segment_sum_sorted(t(data), t(ids), 700))
    _check_split(ids, 700, share)


def test_share_items():
    assert [k6.share_items(P) for P in (1, 43, 130, 8192, 20_000)] == [8192, 190, 63, 1, 1]


@st.composite
def _sorted_ids(draw, E=None, M=None):
    E = draw(st.integers(1, 300)) if E is None else E
    M = draw(st.integers(1, 120)) if M is None else M
    n_negative = draw(st.integers(0, E // 4))
    n_tail = draw(st.integers(0, E - n_negative))
    n_valid = E - n_negative - n_tail
    cuts = sorted(draw(st.lists(st.integers(0, M - 1), min_size=n_valid, max_size=n_valid)))
    hot = draw(st.one_of(st.none(), st.integers(0, M - 1)))
    if hot is not None and cuts:  # one segment takes about half the valid rows
        cuts = sorted(cuts[: len(cuts) // 2] + [hot] * (len(cuts) - len(cuts) // 2))
    ids = ([-draw(st.integers(1, 5))] * n_negative + cuts
           + [M + draw(st.integers(0, 3))] * n_tail)
    return np.sort(np.array(ids, np.int32)), M


@settings(max_examples=60, deadline=None)
@given(_sorted_ids(), st.integers(1, 40))
def test_split_covers_rows_and_segments_once(ids_m, share):
    ids, M = ids_m
    _check_split(ids, M, share)
    data = np.random.default_rng(ids.size).normal(size=(1, ids.size, 3)).astype(np.float32)
    _check_twin(data, ids[None], M, share, jax_too=False)


@settings(max_examples=25, deadline=None)
@given(_sorted_ids(E=256, M=64), st.sampled_from([1, 5, 16, 142]))
def test_twin_matches_pallas_interpret(ids_m, share):
    ids, M = ids_m
    data = np.random.default_rng(int(ids.sum()) % 1000).normal(size=(1, 256, 7))
    _check_twin(data.astype(np.float32), ids[None], M, share)
