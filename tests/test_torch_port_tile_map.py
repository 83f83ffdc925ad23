"""The valid-row tile map of the encoder-payload kernels and the bf16
backward's per-chunk gradient slices (`gaot3d_tpu_torch/kernels/
encoder_payload.py` `tile_map`, `sum_chunk_slices`), on the CPU.

Both bodies of K5 and K5b's bf16 body walk the items of `tile_map` and take
the valid slots of an item's nodes as its rows. Each item is expanded here by brute
force into those rows and held to what the kernels rely on: every valid slot
lands in exactly one item, no masked slot in any, an item holds whole nodes of
one node chunk and at most TILE_ROWS rows (or one node with rows, which the
kernel takes in passes of TILE_ROWS), and every node, with or without valid
slots, lies in exactly one item. The autograd function builds the map in
the forward for either dtype and hands it to the backward. K5b's one launch
adds each node chunk's f32
gradient into its own slice; `sum_chunk_slices` must give what one launch a
chunk, each rounded and summed in f32 by the wrapper, gave before.
"""
import numpy as np
import pytest
import torch

from gaot3d_tpu_torch.kernels import encoder_payload as k5
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

R = k5.TILE_ROWS


def _mask(rng, B, n, K, degrees):
    """[B, n, K] with each node's degree drawn from `degrees`, its valid
    slots at random places among its K (not packed first)."""
    deg = rng.choice(degrees, size=(B, n))
    mask = np.zeros((B, n, K), bool)
    for b in range(B):
        for i in range(n):
            mask[b, i, rng.choice(K, size=deg[b, i], replace=False)] = True
    return torch.from_numpy(mask)


def _items(tiles):
    """[(first node, end node)] of every item, from the map's arrays."""
    nf = tiles.node_first.numpy()
    return [(int(nf[t]), int(nf[t + 1])) for t in range(int(tiles.n_items[0]))]


CASES = [
    # B, n, K, chunk, degrees
    (1, 1001, 5, None, [0, 1, 2, 3, 4, 5]),
    (2, 700, 5, 64, [0, 1, 2, 3, 4, 5]),    # chunks of 64 nodes, B = 2
    (2, 333, 3, 37, [0, 0, 0, 1, 3]),       # mostly masked, chunks no multiple of anything
    (1, 500, 8, 100, [0]),                  # no valid slot at all
    (2, 29, 130, None, [0, 1, 5, 130]),     # nodes with more rows than a tile
    (2, 13, 300, 4, [0, 3, 130, 300]),      # a node's rows over three tiles, chunks of 4
    (1, 2000, 128, 500, [0, 64, 128]),      # K = R: windows of one position
]


def _check_map(mask, chunk):
    """Expand each item of the mask's tile map into its rows and hold the map
    to what the kernels rely on (the module's docstring)."""
    B, n, K = mask.shape
    tiles = k5.tile_map(mask, chunk)
    assert tiles.node_first.dtype == torch.int32 and tiles.n_items.dtype == torch.int32
    step = n if chunk is None else min(chunk, n)
    assert tiles.chunk == step and tiles.n_chunks == -(-n // step)
    items = _items(tiles)
    assert len(items) <= tiles.max_items
    flat = mask.reshape(B * n, K).numpy()
    node_item = np.full(B * n, -1)
    slot_seen = np.zeros_like(flat, dtype=np.int64)
    for t, (a, b) in enumerate(items):
        assert a <= b
        node_item[a:b] = t  # whole nodes: an item is a range of nodes
        segments = {(x // n, (x % n) // step) for x in range(a, b)}
        assert len(segments) <= 1, f"item {t} crosses a chunk boundary: {segments}"
        rows = [(x, s) for x in range(a, b) for s in range(K) if flat[x, s]]  # in order
        for x, s in rows:
            slot_seen[x, s] += 1
        with_rows = {x for x, _ in rows}
        if len(rows) > R:  # one node with rows, taken in passes of R rows
            assert len(with_rows) == 1, f"item {t}: {len(rows)} rows over {len(with_rows)} nodes"
            passes = [rows[p:p + R] for p in range(0, len(rows), R)]
            assert all(len(p) <= R for p in passes)
    assert (node_item >= 0).all(), "a node lies in no item"
    assert np.array_equal(slot_seen, flat.astype(np.int64)), \
        "a valid slot outside every item or in two, or a masked slot in one"
    return items


@pytest.mark.parametrize("B,n,K,chunk,degrees", CASES)
def test_tile_map_against_brute_force(B, n, K, chunk, degrees):
    rng = np.random.default_rng(B * 1000 + n + K)
    _check_map(_mask(rng, B, n, K, degrees), chunk)


def test_tile_map_on_budgeted_slots():
    """Slots as the card's budgeted build (K10) writes them for drivaerml's
    requests: K = 8, each node's valid slots packed first, about 30% of the
    slots valid (2.36 a node there), node chunks of 700 over 3,000 nodes. Every
    valid slot lies in exactly one item, and a chunk's rows take one item a
    window of R - K + 1 positions and one more: the items are nearly full
    tiles of valid rows."""
    rng = np.random.default_rng(8)
    deg = rng.choice(9, size=(1, 3000), p=[.02, .1, .45, .3, .08, .03, .01, .005, .005])
    mask = torch.from_numpy(np.arange(8) < deg[..., None])
    assert 0.25 < float(mask.float().mean()) < 0.35
    items = _check_map(mask, 700)
    per_chunk = mask[0].sum(-1).split(700)
    assert len(items) <= sum(int(c.sum()) // (R - 8 + 1) + 1 for c in per_chunk)
    assert int(mask.sum()) / (len(items) * R) > 0.85


def test_tile_map_fills_tiles_where_most_slots_are_masked():
    """About 30% valid slots at K = 5: the items are nearly full tiles of
    valid rows, where node-major tiles of every slot would be 70% masked."""
    rng = np.random.default_rng(7)
    mask = torch.from_numpy(rng.random((1, 40_000, 5)) < 0.3)
    tiles = k5.tile_map(mask, 65_536)
    items = _items(tiles)
    flat = mask.reshape(-1, 5)
    rows = [int(flat[a:b].sum()) for a, b in items]
    assert max(rows) <= R
    assert int(mask.sum()) / (len(items) * R) > 0.95


def test_sum_chunk_slices_is_the_loop_over_chunks():
    """The slices of K5b's one launch, rounded and summed, against the
    wrapper's sum over one launch a chunk that it replaces: each chunk's
    gradient with its weights (not its biases) rounded to bf16, added in
    chunk order to an f32 total that starts at zero. Bit for bit."""
    shapes = [(16, 6), (16, 16), (16, 16), (8, 16)]
    P = sum(o * i + o for o, i in shapes)
    rng = np.random.default_rng(3)
    slices = torch.from_numpy((rng.normal(size=(5, P)) * 10.0 ** rng.integers(-3, 3, (5, P)))
                              .astype(np.float32))
    total = torch.zeros(P)
    for part in slices:
        part = part.clone()
        for a, b in k5._weight_entries(shapes):
            part[a:b] = k5.round_bf16(part[a:b])
        total += part
    got = k5.sum_chunk_slices(slices, shapes)
    assert torch.equal(got, total)
    one = k5.sum_chunk_slices(slices[:1], shapes)
    ws, bs = k5._unpack_mlp(one, shapes)
    assert all(torch.equal(k5.round_bf16(w), w) for w in ws)
    assert all(torch.equal(b, s) for b, s in zip(bs, k5._unpack_mlp(slices[0], shapes)[1]))


@pytest.mark.parametrize("dtype", k5.KERNEL_DTYPES)
def test_bf16_launches_refuse_a_missing_tile_map(dtype):
    """Every K5 launch and K5b's bf16 one take the map; K5b's f32 body, on
    node-major tiles of every slot, takes none."""
    with pytest.raises(ValueError, match="tile map"):
        k5._map_args(dtype, None)
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="tile map"):
            k5._map_args(dtype, None, backward=True)
    else:
        assert k5._map_args(dtype, None, backward=True) == []


@pytest.mark.parametrize("dtype", k5.KERNEL_DTYPES)
def test_autograd_builds_and_keeps_the_tile_map(dtype, monkeypatch):
    """On the card, `accumulate`'s forward builds the mask's tile map once,
    for float32 as for bfloat16, hands it to K5 and keeps it for K5b (the
    launches replaced here by spies, the device test by a stub)."""
    B, n, K, C, hid, chunk = 1, 300, 8, 8, 16, 128
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(np.arange(K) < rng.integers(0, 4, (B, n, 1)))
    lat = torch.from_numpy(rng.integers(0, 64, (B, n, K)).astype(np.int32))
    pos = torch.from_numpy(rng.uniform(-1, 1, (B, n, 3)).astype(np.float32))
    feats = torch.randn(B, n, C, requires_grad=True)
    sizes = [6, hid, hid, C]
    ws = [torch.randn(o, i, requires_grad=True) for i, o in zip(sizes[:-1], sizes[1:])]
    bs = [torch.zeros(o, requires_grad=True) for o in sizes[1:]]
    grid = k5.LatentGrid(dims=(4, 4, 4))
    taken = {}

    def forward(pos_, feats_, lat_, mask_, ws_, bs_, grid_, acc, chunk_=None, **kw):
        taken["forward"] = kw["tiles"]
        return acc

    def backward(g, pos_, feats_, lat_, mask_, ws_, bs_, grid_, chunk_=None, **kw):
        taken["backward"] = kw["tiles"]
        return torch.zeros_like(feats_), [torch.zeros_like(w) for w in ws_], \
            [torch.zeros_like(b) for b in bs_]

    monkeypatch.setattr(k5, "_on_card", lambda t: True)
    monkeypatch.setattr(k5, "encoder_accumulate", forward)
    monkeypatch.setattr(k5, "encoder_accumulate_backward", backward)
    acc = k5.accumulate(pos, feats, lat, mask, ws, bs, grid,
                        torch.zeros(B, grid.num_tokens, C + 11), chunk, dtype)
    acc.sum().backward()
    want = k5.tile_map(mask, chunk)
    assert isinstance(taken["forward"], k5.TileMap) and taken["backward"] is taken["forward"]
    assert torch.equal(taken["forward"].node_first, want.node_first)
    assert torch.equal(taken["forward"].n_items, want.n_items)
    assert taken["forward"].chunk == chunk
