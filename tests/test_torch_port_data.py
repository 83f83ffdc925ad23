"""The port's data feed against the JAX package's, on the CPU: the seeded
synthetic generator writes one small dataset, and both packages' dataset,
stats, preprocessing, precompute sweep, batch loader and shared sectioning run
on it. Everything here is host code on the same numpy inputs, so every
comparison is exact (`np.array_equal`) unless it says otherwise."""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from gaot3d_tpu.data import dataset as jds
from gaot3d_tpu.data import graph_precompute as jpre
from gaot3d_tpu.data import native_io as jio
from gaot3d_tpu.data import pipeline as jpipe
from gaot3d_tpu.data import transforms as jtr
from gaot3d_tpu.metadata import DATASET_METADATA as JMETA
from gaot3d_tpu.models.magno import MAGNOConfig as JMAGNOConfig
from gaot3d_tpu.ops import grid_graph as jgg
from gaot3d_tpu_torch.data import dataset as tds
from gaot3d_tpu_torch.data import graph_precompute as tpre
from gaot3d_tpu_torch.data import host_graph as thg
from gaot3d_tpu_torch.data import native_io as tio
from gaot3d_tpu_torch.data import pipeline as tpipe
from gaot3d_tpu_torch.data import transforms as ttr
from gaot3d_tpu_torch.metadata import DATASET_METADATA as TMETA
from gaot3d_tpu_torch.models.magno import MAGNOConfig as TMAGNOConfig
from gaot3d_tpu_torch.ops import grid_graph as tgg

META = "synthetic/unit_cube"
DIMS = (8, 8, 8)
N_NODES = 300
CHUNK = 128


def _dataset_fields(base, **over):
    return dict(name="synthetic_small", metaname=META, base_path=str(base),
                processed_folder="processed", train_size=5, val_size=2, test_size=2,
                batch_size=2, num_workers=0, shuffle=True, metric_suite="general",
                pad_multiple=128, synthetic_num_samples=9, synthetic_num_nodes=N_NODES,
                synthetic_seed=3, **over)


def _generate(module, base, **over):
    cfg = module.DatasetConfig(**_dataset_fields(base, **over))
    module.generate_synthetic_dataset(cfg, cfg.base_path)
    return cfg


def _files(cfg):
    folder = os.path.join(cfg.base_path, cfg.processed_folder)
    return {name: dict(np.load(os.path.join(folder, name)))
            for name in sorted(os.listdir(folder))}


def _assert_same_files(a, b):
    assert list(a) == list(b)
    for name in a:
        assert list(a[name]) == list(b[name]), name
        for key in a[name]:
            x, y = a[name][key], b[name][key]
            assert x.dtype == y.dtype and x.shape == y.shape, (name, key)
            assert x.tobytes() == y.tobytes(), (name, key)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One synthetic dataset written by each package: (jax cfg, port cfg)."""
    root = tmp_path_factory.mktemp("data")
    return _generate(jds, root / "jax"), _generate(tds, root / "torch")


def _grids():
    lo, hi = JMETA[META].domain_x
    return (jgg.LatentGrid.from_domain(DIMS, lo, hi, rescale_to=(-1, 1)),
            tgg.LatentGrid.from_domain(DIMS, lo, hi, rescale_to=(-1, 1)))


def _magno(budget, **over):
    fields = dict(gno_radius=0.30, neighbor_strategy="bidirectional", lifting_channels=8,
                  use_geoembed=[True, False], edge_chunk_size=CHUNK, slot_budget=budget, **over)
    return JMAGNOConfig(**fields), TMAGNOConfig(**fields)


def _max_degree(cfg):
    """The largest degree over the dataset: the budget the sweeps use."""
    _, grid = _grids()
    deg = 0
    for sample in _files(cfg).values():
        pos = ttr.rescale(sample["pos"].astype(np.float32), (-1, 1)).astype(np.float32)
        _, mask = thg.build_edge_slots_host(pos, grid, 0.30, strategy="bidirectional")
        deg = max(deg, int(mask.sum(axis=1).max()))
    return deg


# --- (a) dataset, stats, splits, preprocessing


def test_metadata_and_grid_agree():
    assert set(JMETA) == set(TMETA)
    for name in JMETA:
        assert dataclasses.asdict(JMETA[name]) == dataclasses.asdict(TMETA[name])
    jgrid, tgrid = _grids()
    assert (jgrid.dims, jgrid.lo, jgrid.hi) == (tgrid.dims, tgrid.lo, tgrid.hi)


def test_synthetic_dataset_files_are_equal(roots):
    jcfg, tcfg = roots
    _assert_same_files(_files(jcfg), _files(tcfg))
    order = "order_processed.txt"
    with open(os.path.join(jcfg.base_path, order)) as a, \
            open(os.path.join(tcfg.base_path, order)) as b:
        assert a.read() == b.read()


def test_dataset_config_fields_agree():
    j = {f.name: f.default for f in dataclasses.fields(jds.DatasetConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tds.DatasetConfig)}
    assert j == t


@pytest.mark.parametrize("rand", [False, True])
def test_splits_agree(roots, rand):
    jcfg, tcfg = (dataclasses.replace(c, rand_dataset=rand) for c in roots)
    for split in ("train", "val", "test"):
        j, t = jds.MeshDataset(jcfg, split), tds.MeshDataset(tcfg, split)
        assert j.filenames == t.filenames and len(t) == len(j) > 0
    with pytest.raises(ValueError, match="Invalid split"):
        tds.MeshDataset(tcfg, "other")


@pytest.mark.parametrize("active", [None, [0]])
def test_stats_agree_and_are_cached_by_selection(roots, active):
    jcfg, tcfg = (dataclasses.replace(c, active_variables=active, force_recompute_stats=True)
                  for c in roots)
    j, t = jds.compute_or_load_stats(jcfg), tds.compute_or_load_stats(tcfg)
    assert set(j) == set(t) == {"mean", "std"}
    for key in j:
        assert j[key].dtype == t[key].dtype and np.array_equal(j[key], t[key])
    tag = "" if active is None else "_av0"
    path = os.path.join(tcfg.base_path, f"{tcfg.name}_norm_stats{tag}.json")
    assert os.path.exists(path)
    with open(path) as a, open(path.replace("/torch/", "/jax/")) as b:
        assert a.read() == b.read()
    # the second call reads the cache
    cached = tds.compute_or_load_stats(dataclasses.replace(tcfg, force_recompute_stats=False))
    assert all(np.array_equal(cached[k], t[k]) for k in t)
    # ddof = 1 over all train nodes
    xs = np.concatenate([tds.MeshDataset(tcfg, "train")[i]["x"] for i in range(tcfg.train_size)])
    np.testing.assert_allclose(t["std"], xs.astype(np.float64).std(axis=0, ddof=1), rtol=1e-6)


@pytest.mark.parametrize("new,attr", [(False, "x"), (True, ["pos", "x"])])
def test_preprocessor_agrees(roots, new, attr):
    jcfg, tcfg = roots
    stats = tds.compute_or_load_stats(tcfg)
    jp = jpipe.SamplePreprocessor(stats, JMETA[META], use_rescale_new=new,
                                  encoder_feature_attr=attr)
    tp = tpipe.SamplePreprocessor(stats, TMETA[META], use_rescale_new=new,
                                  encoder_feature_attr=attr)
    jsample, tsample = jp(jds.MeshDataset(jcfg, "test")[0]), tp(tds.MeshDataset(tcfg, "test")[0])
    assert set(jsample) == set(tsample)
    for key in jsample:
        assert jsample[key].dtype == tsample[key].dtype
        assert np.array_equal(jsample[key], tsample[key]), key
    with pytest.raises(AttributeError, match="feature attribute 'c'"):
        tpipe.SamplePreprocessor(stats, TMETA[META], encoder_feature_attr="c")(
            tds.MeshDataset(tcfg, "test")[0])


def test_transforms_agree_and_keep_the_scalar_min_max():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(50, 3)) * [1.0, 5.0, 0.2]).astype(np.float32)
    assert np.array_equal(jtr.rescale(x), ttr.rescale(x))
    assert np.array_equal(jtr.rescale_new(x, (-1, 1), ([-2, -1, 0], [3, 1, 1])),
                          ttr.rescale_new(x, (-1, 1), ([-2, -1, 0], [3, 1, 1])))
    assert np.array_equal(jtr.normalize(x, [1, 2, 3], [2, 2, 2]),
                          ttr.normalize(x, [1, 2, 3], [2, 2, 2]))
    # one scalar min and max over the whole array, not one per axis
    r = ttr.rescale(x)
    assert r.min() == -1.0 and r.max() == 1.0 and r[:, 2].max() < 0.5


def test_sample_formats_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    sample = {"pos": rng.normal(size=(40, 3)).astype(np.float32),
              "x": rng.normal(size=(40, 2)).astype(np.float32),
              "idx": rng.integers(0, 9, (40, 4)).astype(np.int32)}
    tds.save_sample(str(tmp_path / "a.npz"), sample)
    tio.write_gsb(str(tmp_path / "a.gsb"), sample)
    jio.write_gsb(str(tmp_path / "j.gsb"), sample)
    torch.save({"pos": torch.from_numpy(sample["pos"]), "x": torch.from_numpy(sample["x"])},
               str(tmp_path / "a.pt"))
    with open(tmp_path / "a.gsb", "rb") as a, open(tmp_path / "j.gsb", "rb") as b:
        assert a.read() == b.read()
    for name, keys in (("a.npz", sample), ("a.gsb", sample), ("j.gsb", sample),
                       ("a.pt", ("pos", "x"))):
        got = tds.load_sample(str(tmp_path / name))
        assert set(got) == set(keys)
        assert all(np.array_equal(got[k], sample[k]) and got[k].dtype == sample[k].dtype
                   for k in keys)
    plain = tio.read_gsb_numpy(str(tmp_path / "a.gsb"))
    assert all(np.array_equal(plain[k], sample[k]) for k in sample)
    with pytest.raises(ValueError, match="unsupported sample format"):
        tds.load_sample("a.vtk")


def test_pad_batch_native_agrees():
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 0, 9)]
    counts = np.asarray([5, 0, 9], np.int32)
    out, mask = tio.pad_batch_native(arrays, counts, 12)
    jout, jmask = jio.pad_batch_native(arrays, counts, 12)
    assert np.array_equal(out, jout) and np.array_equal(mask, jmask)
    assert mask.sum(axis=1).tolist() == [5, 0, 9] and not out[2, 9:].any()


# --- (b) the precompute sweep


@pytest.fixture(scope="module")
def swept(roots, tmp_path_factory):
    """The same dataset swept by each package: (jax cfg, port cfg, budget)."""
    jcfg, tcfg = roots
    root = tmp_path_factory.mktemp("swept")
    shutil.copytree(jcfg.base_path, root / "jax")
    shutil.copytree(tcfg.base_path, root / "torch")
    jcfg = dataclasses.replace(jcfg, base_path=str(root / "jax"))
    tcfg = dataclasses.replace(tcfg, base_path=str(root / "torch"))
    budget = _max_degree(tcfg)
    jmag, tmag = _magno(budget)
    jgrid, tgrid = _grids()
    jpre.update_sample_files_with_edges(jcfg, jmag, jgrid, JMETA[META])
    tpre.update_sample_files_with_edges(tcfg, tmag, tgrid, TMETA[META])
    return jcfg, tcfg, budget


def test_sweep_writes_the_same_keys_and_bytes(swept):
    jcfg, tcfg, budget = swept
    jfiles, tfiles = _files(jcfg), _files(tcfg)
    _assert_same_files(jfiles, tfiles)
    first = next(iter(tfiles.values()))
    assert {"encoder_slot_idx_s0", "encoder_slot_mask_s0", "encoder_slot_mask_s0_K",
            "decoder_slot_idx_s0", "decoder_slot_mask_s0", "decoder_slot_mask_s0_K"} \
        <= set(first)
    assert first["encoder_slot_idx_s0"].shape[1] <= budget


def test_each_package_reads_the_others_sweep(swept):
    jcfg, tcfg, _ = swept
    for name in ("sample_00000.npz", "sample_00007.npz"):
        jpath = os.path.join(jcfg.base_path, "processed", name)
        tpath = os.path.join(tcfg.base_path, "processed", name)
        from_jax = tpre.extract_precomputed_slots(tds.load_sample(jpath), 1)
        from_port = jpre.extract_precomputed_slots(jds.load_sample(tpath), 1)
        for side in ("encoder", "decoder"):
            (li, mi), (lj, mj) = from_jax[side][0], from_port[side][0]
            assert np.array_equal(li, lj) and np.array_equal(mi, mj) and mi.dtype == bool
    assert tpre.extract_precomputed_slots({"pos": np.zeros((3, 3))}, 1) is None


def test_sweep_leaves_a_swept_file_alone(swept):
    """A second sweep, by the other package, finds the slots and rewrites
    nothing."""
    jcfg, tcfg, budget = swept
    jmag, tmag = _magno(budget)
    jgrid, tgrid = _grids()
    path = os.path.join(jcfg.base_path, "processed", "sample_00001.npz")
    before = os.stat(path).st_mtime_ns
    tpre.update_sample_files_with_edges(
        dataclasses.replace(tcfg, base_path=jcfg.base_path), tmag, tgrid, TMETA[META])
    assert os.stat(path).st_mtime_ns == before


def test_sweep_refuses_a_budget_that_drops_edges(roots):
    _, tcfg = roots
    _, tmag = _magno(1)
    _, tgrid = _grids()
    sample = tds.MeshDataset(tcfg, "test")[0]
    with pytest.raises(ValueError, match="slot_budget=1 drops edges"):
        tpre.compute_sample_edge_slots(sample["pos"], tgrid, tmag, False, TMETA[META].domain_x)


# --- (c) the batch loader


def _loaders(swept, split, layout, **kw):
    jcfg, tcfg, _ = swept
    stats = tds.compute_or_load_stats(tcfg)
    common = dict(batch_size=2, pad_multiple=128, slot_mode="precomputed", num_scales=1,
                  edge_layout=layout, edge_chunk_size=CHUNK, seed=7, **kw)
    jl = jpipe.BatchLoader(jds.MeshDataset(jcfg, split),
                           jpipe.SamplePreprocessor(stats, JMETA[META]), host_arrays=True,
                           **common)
    tl = tpipe.BatchLoader(tds.MeshDataset(tcfg, split),
                           tpipe.SamplePreprocessor(stats, TMETA[META]), **common)
    return jl, tl


def _edge_arrays(edges):
    """An edge structure of either package as a list of numpy arrays."""
    if hasattr(edges, "sections"):
        return [np.asarray(a) for s in edges.sections for a in (s.lat_idx, s.mask)]
    if hasattr(edges, "src"):
        return [np.asarray(a) for a in (edges.src, edges.dst, edges.mask)]
    return [np.asarray(edges.lat_idx), np.asarray(edges.mask)]


def _assert_same_batches(jl, tl):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl)
    for a, b in zip(jb, tb):
        for field in ("pos", "feats", "target", "node_mask", "num_nodes"):
            x, y = np.asarray(getattr(a, field)), getattr(b, field)
            assert isinstance(y, np.ndarray) and x.dtype == y.dtype, field
            assert np.array_equal(x, y), field
        for side in ("enc_slots", "dec_slots"):
            ja, ta = _edge_arrays(getattr(a, side)[0]), _edge_arrays(getattr(b, side)[0])
            assert len(ja) == len(ta)
            for x, y in zip(ja, ta):
                assert x.dtype == y.dtype and np.array_equal(x, y), side
        # aliased directions stay one object in both packages
        assert (a.enc_slots[0] is a.dec_slots[0]) == (b.enc_slots[0] is b.dec_slots[0])
    return tb


@pytest.mark.parametrize("layout,kw", [
    ("slots", {}),
    ("flat", {"flat_order": "src"}),
    ("flat", {"flat_order": "dst"}),
    (["flat", "slots"], {"flat_order": "dst"}),
    ("sectioned", {}),
], ids=["slots", "flat-src", "flat-dst", "flat-slots", "sectioned"])
def test_loader_batches_agree(swept, layout, kw):
    """Shuffled train batches of two epochs, every layout: the same order,
    padding, permutation and edge structures in both packages."""
    jl, tl = _loaders(swept, "train", layout, shuffle=True, **kw)
    orders = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        assert np.array_equal(jl._indices(), tl._indices())
        orders.append(tl._indices().tolist())
        batches = _assert_same_batches(jl, tl)
    assert orders[0] != orders[1] and sorted(orders[0]) == list(range(5))
    last = batches[-1]  # 5 samples in batches of 2: the last is half empty
    assert last.num_nodes.tolist()[1] == 0 and not last.node_mask[1].any()
    assert last.pos.shape == (2, 384, 3)
    if layout == "slots":
        assert last.enc_slots[0] is last.dec_slots[0]  # bidirectional both ways: aliased


def test_loader_sectioned_permutes_the_sample_arrays(swept):
    _, tl = _loaders(swept, "test", "sectioned")
    _, plain = _loaders(swept, "test", "slots")
    (sect,), (flat,) = list(tl), list(plain)
    assert isinstance(sect.enc_slots[0], tgg.SectionedEdgeSlots)
    assert sect.enc_slots[0].num_nodes == sect.pos.shape[1]
    for b in range(2):
        n = int(flat.num_nodes[b])
        assert sect.node_mask[b, :n].all() and not sect.node_mask[b, n:].any()
        # the same rows in another order
        assert np.array_equal(np.sort(sect.pos[b, :n], axis=0), np.sort(flat.pos[b, :n], axis=0))
        assert not np.array_equal(sect.pos[b], flat.pos[b])
    degrees = np.concatenate([s.mask[0].sum(dim=1).numpy() for s in sect.enc_slots[0].sections])
    n = int(flat.num_nodes[0])
    assert (np.diff(degrees[:n]) >= 0).all()  # ascending degree over the valid nodes


def test_loader_workers_and_sharding_agree(swept):
    jl, tl = _loaders(swept, "train", "slots", shuffle=True, num_workers=2)
    _assert_same_batches(jl, tl)
    for shard in (0, 1):
        jl, tl = _loaders(swept, "train", "slots", shuffle=True, num_shards=2,
                          shard_index=shard)
        assert np.array_equal(jl._indices(), tl._indices()) and len(tl._indices()) == 3


def test_loader_device_cache_and_refusals(swept):
    puts = []

    def put(batch):
        puts.append(batch)
        return batch

    _, plain = _loaders(swept, "val", "slots")
    tl = tpipe.BatchLoader(plain.dataset, plain.preprocessor, 2, slot_mode="precomputed",
                           device_cache=True, cache_put=put)
    first, second = list(tl), list(tl)
    assert len(puts) == 1 and first[0] is second[0]
    with pytest.raises(ValueError, match="needs host-built slots"):
        tpipe.BatchLoader(tl.dataset, tl.preprocessor, 2, slot_mode="device",
                          edge_layout="flat")


def test_loader_warns_when_the_chunk_falls_far_below_edge_chunk_size(swept, caplog):
    """307 padded nodes (a prime) against edge_chunk_size 128: the model's
    chunk falls to 1 node, and the loader says so once."""
    _, tl = _loaders(swept, "test", "flat")
    tl.pad_multiple = 307
    with caplog.at_level("WARNING", logger="gaot3d_tpu_torch.data.pipeline"):
        list(tl)
        list(tl)
    said = [r for r in caplog.records if "does not divide the padded node count" in r.message]
    assert len(said) == 1


def test_prefetch_accounts_and_propagates_errors():
    stats = {}
    got = list(tpipe.prefetch_to_device(iter(range(5)), lambda x: x * 2, stats=stats))
    assert got == [0, 2, 4, 6, 8]
    assert stats["gets"] == 6 and {"wait_s", "first_wait_s", "host_load_s", "put_s"} <= set(stats)

    def broken():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tpipe.prefetch_to_device(broken(), lambda x: x))
    with pytest.raises(RuntimeError, match="bad put"):
        def bad_put(x):
            raise RuntimeError("bad put")
        list(tpipe.prefetch_to_device(iter([1]), bad_put))


def test_pinned_to_device_on_the_cpu_shares_and_memoizes():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    memo = {}
    t = tpipe.pinned_to_device(a, "cpu", memo)
    assert t.data_ptr() == a.ctypes.data and tpipe.pinned_to_device(a, "cpu", memo) is t
    c = torch.ones(3)
    assert tpipe.pinned_to_device(c, "cpu") is c


# --- (d) shared sectioning


def _slot_batch(seed, B=2, N=256, K=4):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, K + 1, (B, N))
    mask = np.arange(K)[None, None, :] < deg[..., None]  # valid-first packed
    lat = rng.integers(0, 512, (B, N, K)).astype(np.int32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, 200:] = False
    mask[1, 200:] = False
    return lat, mask, node_mask


def _assert_same_sections(jout, tout):
    assert len(jout.sections) == len(tout.sections)
    for js, ts in zip(jout.sections, tout.sections):
        assert np.array_equal(np.asarray(js.lat_idx), ts.lat_idx.numpy())
        assert np.array_equal(np.asarray(js.mask), ts.mask.numpy())
        assert ts.lat_idx.dtype == torch.int32 and ts.mask.dtype == torch.bool


@pytest.mark.parametrize("profile", [None, [2, 3, 4, 4]])
def test_section_slots_shared_agrees(profile):
    lat, mask, node_mask = _slot_batch(0)
    lat2, mask2, _ = _slot_batch(1, K=3)
    mask2 = mask2 & node_mask[..., None]
    if profile is not None:  # cap the degrees so that the pinned profile covers them
        mask = mask & (np.arange(4)[None, None, :] < 2)
        mask2 = mask2 & (np.arange(3)[None, None, :] < 1)
    pairs = [(lat, mask), (lat2, mask2), (lat, mask)]
    jperm, jouts = jgg.section_slots_shared(pairs, 64, node_mask=node_mask, profile=profile,
                                            host_arrays=True)
    tperm, touts = thg.section_slots_shared(pairs, 64, node_mask=node_mask, profile=profile)
    assert tperm.dtype == np.int64 and np.array_equal(jperm, tperm)
    for j, t in zip(jouts, touts):
        _assert_same_sections(j, t)
    assert touts[0] is touts[2] and touts[0] is not touts[1]  # identical pairs: one object
    # pads last, so the valid nodes stay a prefix
    assert node_mask[1][tperm[1]][:200].all()
    if profile is not None:
        widths = [s.lat_idx.shape[-1] for s in touts[1].sections]
        assert widths == [2, 3, 4]  # padded beyond the pair's own K = 3


def test_section_slots_shared_refusals():
    lat, mask, node_mask = _slot_batch(2)
    with pytest.raises(ValueError, match="below the observed"):
        thg.section_slots_shared([(lat, mask)], 64, node_mask=node_mask, profile=[1, 1, 1, 1])
    with pytest.raises(ValueError, match="one per 64-node chunk"):
        thg.section_slots_shared([(lat, mask)], 64, profile=[4, 4])
    with pytest.raises(ValueError, match="must divide N"):
        thg.section_slots_shared([(lat, mask)], 100)
    unpacked = mask[..., ::-1].copy()  # valid-last: not what sections can truncate
    with pytest.raises(ValueError, match="not valid-first packed"):
        thg.section_slots_shared([(lat, unpacked)], 64)
