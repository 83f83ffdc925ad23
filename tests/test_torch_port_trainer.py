"""The port's trainer, checkpoints, CLI and config against the JAX package's,
on the CPU (`setup.device: "cpu"`) at smoke.yaml's widths: both trainers run
on ONE dataset directory that the seeded synthetic generator fills, the JAX
trainer's initial parameters reach the port through a msgpack checkpoint, and
validate(), test() and two epochs of fit() are held against each other. Each
tolerance is stated where it is used."""
import copy
import csv
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gaot3d_tpu import config as jconfig
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu.train import checkpoint as jckpt
from gaot3d_tpu.train import metrics as jmetrics
from gaot3d_tpu.train.trainer import init_trainer as jax_init_trainer
from gaot3d_tpu.utils import dataclass_utils as jdu
from gaot3d_tpu_torch import cli
from gaot3d_tpu_torch import config as tconfig
from gaot3d_tpu_torch.train import checkpoint as tckpt
from gaot3d_tpu_torch.train import metrics as tmetrics
from gaot3d_tpu_torch.train.trainer import init_trainer
from gaot3d_tpu_torch.utils import dataclass_utils as tdu
from gaot3d_tpu_torch.weights import numpy_state_dict
from test_torch_port_cpu import child_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_config(base, name="run", **dataset):
    """smoke.yaml's model at two layers, 300-node samples padded to 384, the
    recipe's layout (degree sections over a precomputed sweep), dropout 0."""
    out = os.path.join(str(base), name)
    return {
        "setup": {"seed": 42, "device": "cpu", "train": True, "test": False},
        "model": {"name": "gaot_3d", "args": {
            "latent_tokens": [8, 8, 8],
            "magno": {"neighbor_strategy": "bidirectional", "projection_channels": 32,
                      "in_gno_channel_mlp_hidden_layers": [16, 16],
                      "out_gno_channel_mlp_hidden_layers": [16], "lifting_channels": 8,
                      "gno_radius": 0.30, "use_geoembed": [True, False], "mlp_type": "linear",
                      "edge_chunk_size": 128, "slot_budget": 12, "edge_layout": "sectioned"},
            "transformer": {"patch_size": 2, "hidden_size": 64, "num_layers": 2,
                            "positional_embedding": "rope",
                            "attn_config": {"hidden_size": 64, "num_heads": 4,
                                            "num_kv_heads": 4, "atten_dropout": 0.0},
                            "ffn_config": {"hidden_size": 128}}}},
        "dataset": {"name": "synthetic_small", "metaname": "synthetic/unit_cube",
                    "base_path": os.path.join(str(base), "data"),
                    "processed_folder": "processed", "train_size": 4, "val_size": 2,
                    "test_size": 2, "batch_size": 2, "num_workers": 0, "shuffle": True,
                    "metric_suite": "general", "pad_multiple": 128,
                    "synthetic_num_samples": 8, "synthetic_num_nodes": 300,
                    "update_pt_files_with_edges": True, **dataset},
        "optimizer": {"name": "adamw", "args": {
            "lr": 1e-3, "weight_decay": 1e-5, "epoch": 2, "eval_every_eps": 1,
            "scheduler": "mix", "max_lr": 2e-3, "min_lr": 1e-4, "final_lr": 5e-5}},
        "path": {"ckpt_path": f"{out}/c.pt", "loss_path": f"{out}/l.png",
                 "result_path": f"{out}/r.png", "database_path": f"{out}/db.csv"},
    }


def write_config(cfg, path):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def port_trainer(cfg, tmp, name="cfg.json"):
    return init_trainer(tconfig.load_run_config(write_config(cfg, os.path.join(str(tmp), name))))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both trainers on one directory, the port holding the JAX trainer's
    initial parameters; then validate(), test() and fit() of each."""
    tmp = tmp_path_factory.mktemp("pair")
    cfg = small_config(tmp)
    jcfg = copy.deepcopy(cfg)
    jcfg["path"]["ckpt_path"] = os.path.join(str(tmp), "jax", "c.msgpack")
    for key in ("loss_path", "result_path", "database_path"):
        jcfg["path"][key] = jcfg["path"][key].replace("/run/", "/jax/")
    jt = jax_init_trainer(jconfig.load_run_config(write_config(jcfg, tmp / "jax.json")))
    init_ckpt = os.path.join(str(tmp), "init.msgpack")
    jt.save_ckpt(init_ckpt)
    init_params = jax.tree.map(np.asarray, jt.state.params)
    pt = port_trainer(cfg, tmp)
    pt.load_ckpt(init_ckpt)
    init_state = numpy_state_dict(pt.model)
    out = {"jax": jt, "port": pt, "tmp": tmp, "cfg": cfg, "init_ckpt": init_ckpt,
           "init_params": init_params, "init_state": init_state,
           "val": (jt.validate(jt.val_loader), pt.validate(pt.val_loader)),
           "test": (jt.test(), pt.test())}
    out["fit"] = (jt.fit(), pt.fit())
    return out


# --- (e) the two trainers on one directory


def test_port_reads_the_jax_trainers_directory(pair):
    """The port found the dataset, the stats cache and the sweep that the JAX
    trainer had written, and counts the same parameters and edges."""
    jt, pt = pair["jax"], pair["port"]
    assert all(np.array_equal(jt.stats[k], pt.stats[k]) for k in jt.stats)
    for column in ("nparams", "nbytes", "p2r edges", "r2p edges", "r2r edges"):
        assert jt.datarow[column] == pt.datarow[column], column
    assert len(pt.train_loader) == len(jt.train_loader) == 2
    assert pt.optimizer.schedule(0) == pytest.approx(1e-3)


def test_validate_agrees_through_a_jax_checkpoint(pair):
    """validate() with the JAX trainer's initial parameters: 1e-5 relative
    (f32 sums in another order; bf16 attention on the same values)."""
    jval, pval = pair["val"]
    assert np.isfinite(pval) and pval > 0
    np.testing.assert_allclose(pval, jval, rtol=1e-5)


def test_test_metrics_agree_through_a_jax_checkpoint(pair):
    """test() with the same parameters: every metric of the suite to 1e-4
    relative; the timing report has the same keys."""
    jres, pres = pair["test"]
    assert set(jres) == set(pres)
    for key in ("MSE", "MAE", "Max AE", "Rel L2 Error (%)", "Rel L1 Error (%)"):
        np.testing.assert_allclose(pres[key], jres[key], rtol=1e-4, err_msg=key)
    assert pres["total_samples"] == jres["total_samples"] == 2
    jt, pt = pair["jax"], pair["port"]
    for column in ("MSE (x10^-2)", "MAE (x10^-1)"):
        np.testing.assert_allclose(pt.datarow[column], jt.datarow[column], rtol=1e-4)
    assert pt.datarow["inference time"] > 0


def test_two_epochs_of_fit_follow_the_jax_losses(pair):
    """Two epochs (4 AdamW steps on the `mix` warm-up, dropout 0, the same
    shuffle) from the same parameters: train and validation losses to 1e-3
    relative. Adam's first update lr * g / (|g| + eps) turns rounding noise in
    near-zero gradient entries into steps of up to lr, so the parameters part
    by a little after step 1; the losses stay within the bound."""
    jfit, pfit = pair["fit"]
    assert pfit["train"]["epoch"] == jfit["train"]["epoch"] == [0, 1]
    assert pfit["valid"]["epoch"] == jfit["valid"]["epoch"] == [0, 1]
    np.testing.assert_allclose(pfit["train"]["loss"], jfit["train"]["loss"], rtol=1e-3)
    np.testing.assert_allclose(pfit["valid"]["loss"], jfit["valid"]["loss"], rtol=1e-3)
    assert pfit["best"]["epoch"] == jfit["best"]["epoch"]
    np.testing.assert_allclose(pfit["best"]["loss"], jfit["best"]["loss"], rtol=1e-3)
    assert pfit["train"]["loss"][1] < pfit["train"]["loss"][0]
    assert pfit["time"] > 0 and set(pfit["loader"]) == set(jfit["loader"])


def test_fit_writes_its_artifacts_and_restores_the_best_state(pair):
    pt, cfg = pair["port"], pair["cfg"]
    base = os.path.dirname(cfg["path"]["ckpt_path"])
    assert {"c.pt", "l.npz", "r.npz"} <= set(os.listdir(base))
    losses = np.load(os.path.join(base, "l.npz"))
    assert losses["val_epoch"].tolist() == [0, 1] and np.isfinite(losses["val_loss"]).all()
    assert pt.datarow["training time"] == pair["fit"][1]["time"]
    # the model holds the best epoch's parameters, and so does the checkpoint
    saved = tckpt.load_checkpoint(cfg["path"]["ckpt_path"])
    assert saved["step"] == 4 and set(saved) == {"params", "opt_state", "step"}
    for key, value in pt.model.state_dict().items():
        assert torch.equal(saved["params"][key], value)
    best = pair["fit"][1]["best"]
    np.testing.assert_allclose(pt.validate(pt.val_loader), best["loss"], rtol=1e-6)
    assert pt.current_lr() == pytest.approx(pt.optimizer.schedule(3))


# --- (f) checkpoints


def test_msgpack_checkpoint_loads_as_the_exported_state_dict(pair):
    """JAX msgpack -> port: every entry equals the JAX package's own export of
    the same tree (exact)."""
    jt = pair["jax"]
    want = state_dict_from_params(pair["init_params"], jt.model_config.args.magno,
                                  jt.model_config.args.transformer)
    got = pair["init_state"]
    assert set(got) == set(want)
    for key in got:
        assert np.array_equal(got[key], np.asarray(want[key]).reshape(got[key].shape)), key


def test_port_msgpack_is_read_by_the_jax_package(pair, tmp_path):
    """port -> msgpack -> `load_params_only` of the JAX package: the tree the
    JAX trainer started from, exactly; and back into a port model."""
    fresh = port_trainer(pair["cfg"], tmp_path)
    fresh.load_ckpt(pair["init_ckpt"])
    path = str(tmp_path / "port.msgpack")
    tckpt.save_msgpack_params(path, fresh.model)
    restored = jckpt.load_params_only(path, pair["init_params"])
    flat_want = jax.tree_util.tree_leaves_with_path(pair["init_params"])
    flat_got = jax.tree_util.tree_leaves_with_path(restored)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, a), (_, b) in zip(flat_got, flat_want):
        assert np.array_equal(np.asarray(a), b), p
    other = port_trainer(pair["cfg"], tmp_path, "other.json")
    other.load_ckpt(path)
    assert all(np.array_equal(v, pair["init_state"][k])
               for k, v in numpy_state_dict(other.model).items())
    with pytest.raises(ValueError, match="no optimizer state"):
        other.load_ckpt(path, params_only=False)


def test_full_state_round_trip_and_artifacts(pair, tmp_path):
    """port -> port: parameters, optimizer moments and step count; then the
    'latest' and 'best' artifact aliases."""
    cfg = copy.deepcopy(pair["cfg"])
    cfg["path"] = {k: v.replace("/run/", "/art/") for k, v in cfg["path"].items()}
    cfg["optimizer"]["args"].update(epoch=2, save_every_epochs=1)
    a = port_trainer(cfg, tmp_path)
    a.fit()
    art = os.path.join(os.path.dirname(cfg["path"]["ckpt_path"]), "artifacts")
    assert sorted(os.listdir(art)) == ["c-aliases.json", "c-e1.pt", "c-e2.pt"]
    with open(os.path.join(art, "c-aliases.json")) as f:
        aliases = json.load(f)
    assert aliases["latest"]["epoch"] == 2 and aliases["best"]["epoch"] in (1, 2)
    assert tckpt.load_checkpoint(aliases["latest"]["path"])["epoch"] == 2

    b = port_trainer(cfg, tmp_path, "b.json")
    b.load_ckpt(params_only=False)
    assert b.optimizer.count == a.optimizer.count == 4
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sa, sb = a.optimizer.optimizer.state_dict(), b.optimizer.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and len(sa["state"]) > 0
    for idx in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][idx][name], sb["state"][idx][name])
    c = port_trainer(cfg, tmp_path, "c.json")
    c.load_from_artifact("best")
    want = tckpt.load_params_only(aliases["best"]["path"])
    assert all(torch.equal(v, want[k]) for k, v in c.model.state_dict().items())


def test_profile_dir_gets_a_chrome_trace(pair, tmp_path):
    """`setup.profile_dir` wraps the first `profile_steps` steps of
    `profile_epoch` in torch.profiler and writes a Chrome trace there, with
    the port's spans: both steps' stages, and the wait for the second batch."""
    cfg = copy.deepcopy(pair["cfg"])
    cfg["path"] = {k: v.replace("/run/", "/prof/") for k, v in cfg["path"].items()}
    cfg["setup"].update(profile_dir=str(tmp_path / "trace"), profile_epoch=0, profile_steps=2)
    cfg["optimizer"]["args"].update(epoch=1)
    port_trainer(cfg, tmp_path).fit()
    with open(tmp_path / "trace" / "train_steps.trace.json") as f:
        trace = json.load(f)
    assert any(e.get("cat") == "cpu_op" for e in trace["traceEvents"])
    names = [str(e.get("name", "")) for e in trace["traceEvents"]]
    for span in ("gaot.train.step", "gaot.train.forward", "gaot.train.backward",
                 "gaot.train.optimizer"):
        assert names.count(span) == 2, span
    assert "gaot.loader.wait" in names


# --- (g) the command line


def _run_cli(*args):
    return subprocess.run([sys.executable, "-m", "gaot3d_tpu_torch", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=560,
                          env=child_env(JAX_PLATFORMS="cpu"))


def _cli_config(tmp_path, name):
    cfg = small_config(tmp_path, name, synthetic_num_samples=6, train_size=4, val_size=1,
                       test_size=1)
    cfg["setup"]["test"] = True
    cfg["optimizer"]["args"].update(epoch=1)
    return cfg


def test_cli_config_mode_writes_the_datarow(tmp_path):
    cfg = _cli_config(tmp_path, "one")
    path = write_config(cfg, tmp_path / "one.json")
    r = _run_cli("--config", path)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(cfg["path"]["database_path"]) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["config"] == path
    for column in ("nparams", "p2r edges", "r2p edges", "training time", "inference time",
                   "MSE (x10^-2)", "MAE (x10^-1)"):
        assert float(rows[0][column]) > 0, column
    base = os.path.dirname(cfg["path"]["ckpt_path"])
    assert {"c.pt", "l.npz", "r.npz", "db.csv"} <= set(os.listdir(base))
    # a second run appends a row
    assert _run_cli("--config", path).returncode == 0
    with open(cfg["path"]["database_path"]) as f:
        assert len(list(csv.DictReader(f))) == 2


def test_cli_folder_mode_isolates_a_failing_job(tmp_path):
    cfg = _cli_config(tmp_path, "good")
    folder = tmp_path / "cfgs"
    folder.mkdir()
    write_config(cfg, folder / "good.json")
    (folder / "bad.toml").write_text("[setup]\nnot_a_real_key = 1\n")
    (folder / "notes.txt").write_text("not a config")
    r = _run_cli("--folder", str(folder))
    assert r.returncode == 0, r.stderr[-3000:]
    assert os.path.exists(cfg["path"]["database_path"])
    assert "failed" in (r.stderr + r.stdout).lower()


def test_cli_needs_a_config_or_a_folder():
    r = _run_cli()
    assert r.returncode == 2 and "--config or --folder" in r.stderr


def test_append_csv_row_takes_the_union_of_columns(tmp_path):
    path = str(tmp_path / "db.csv")
    cli.append_csv_row(path, {"a": 1, "b": 2.5})
    cli.append_csv_row(path, {"b": 3, "c": "x"})
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["a", "b", "c"]
    assert rows == [{"a": "1", "b": "2.5", "c": ""}, {"a": "", "b": "3", "c": "x"}]


def test_run_config_file_applies_the_load_priority(pair, tmp_path):
    """`resume_from_ckpt` outranks the `ckpt` flag: a test-only run reports the
    metrics of the checkpoint it was pointed at."""
    cfg = copy.deepcopy(pair["cfg"])
    cfg["path"] = {k: v.replace("/run/", "/resume/") for k, v in cfg["path"].items()}
    cfg["setup"].update(train=False, test=True, ckpt=True, resume_from_ckpt=pair["init_ckpt"])
    row, trainer = cli.run_config_file(write_config(cfg, tmp_path / "resume.json"),
                                       return_trainer=True)
    np.testing.assert_allclose(row["MSE (x10^-2)"], pair["test"][1]["MSE"] * 100, rtol=1e-6)
    assert "training time" not in row and os.path.exists(cfg["path"]["database_path"])
    assert trainer.train_loader is None


# --- (h) what the trainer refuses


@pytest.mark.parametrize("updates,error,match", [
    ({"dataset": {"training_strategy": "neural_field"}}, ValueError,
     "neural_field training strategy requires update_pt_files_with_edges=False"),
    ({"dataset": {"training_strategy": "neural_field", "update_pt_files_with_edges": False},
      "magno": {"asynchronous_graph_building": True}}, ValueError,
     r"neural_field training strategy requires asynchronous_graph_building=False \(edges "
     r"are built on device from the sampled coordinates\)"),
    ({"dataset": {"update_pt_files_with_edges": False}}, ValueError,
     "magno.edge_layout='sectioned' requires precomputed or async graph building"),
    ({"dataset": {"update_pt_files_with_edges": False}, "magno": {"edge_layout": "flat"}},
     ValueError, "magno.edge_layout='flat' requires precomputed or async graph building"),
    ({"magno": {"slot_budget": None}}, ValueError, "requires slot_budget"),
    ({"magno": {"slot_budget": 1}}, ValueError, "below the max per-point degree"),
    ({"setup": {"device": "tpu"}}, ValueError, "not a device of this package"),
    ({"setup": {"trainer_name": "sequential"}}, ValueError, "unknown trainer"),
], ids=["neural_field-precompute", "neural_field-async", "device-sectioned", "device-flat",
        "sectioned-no-budget",
        "budget-too-small", "tpu", "trainer-name"])
def test_trainer_refusals(tmp_path, updates, error, match):
    """What the trainer refuses; the neural-field and slot-mode refusals in
    the JAX trainer's words."""
    cfg = small_config(tmp_path)
    for section, update in updates.items():
        target = cfg["model"]["args"]["magno"] if section == "magno" else cfg[section]
        target.update(update)
    with pytest.raises(error, match=match):
        port_trainer(cfg, tmp_path)


@pytest.mark.parametrize("device", ["auto", "cuda", "cuda:0"])
def test_no_card_raises_instead_of_running_on_the_cpu(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    cfg = small_config(tmp_path)
    cfg["setup"]["device"] = device
    with pytest.raises(RuntimeError, match="no CUDA device is present"):
        port_trainer(cfg, tmp_path)
    assert not os.path.exists(cfg["dataset"]["base_path"])  # refused before any work


def test_async_graph_building_gives_the_sweeps_batches(pair, tmp_path):
    """`asynchronous_graph_building` builds in the loader what the sweep
    stores: the same first validation batch."""
    cfg = copy.deepcopy(pair["cfg"])
    cfg["dataset"]["update_pt_files_with_edges"] = False
    cfg["model"]["args"]["magno"]["asynchronous_graph_building"] = True
    cfg["setup"]["train"] = False
    t = port_trainer(cfg, tmp_path)
    a, b = next(iter(t.test_loader)), next(iter(pair["port"].test_loader))
    assert np.array_equal(a.pos, b.pos) and np.array_equal(a.node_mask, b.node_mask)
    for sa, sb in zip(a.enc_slots[0].sections, b.enc_slots[0].sections):
        assert torch.equal(sa.mask, sb.mask)
        assert torch.equal(sa.lat_idx[sa.mask], sb.lat_idx[sb.mask])


# --- (i) metrics and config


def _fields(rng, n=3, nodes=50, nvar=2):
    return ([rng.normal(size=(nodes, nvar)) for _ in range(n)],
            [rng.normal(size=(nodes, nvar)) for _ in range(n)])


def test_metric_suites_agree():
    """The three suites on the same arrays: the same numpy code, so exact."""
    rng = np.random.default_rng(0)
    gtr, prd = _fields(rng)
    mean, std = [0.5, -1.0], [2.0, 0.7]
    assert tmetrics.compute_drivaernet_metric(gtr, prd, mean, std) == \
        jmetrics.compute_drivaernet_metric(gtr, prd, mean, std)
    assert tmetrics.compute_general_metrics(np.concatenate(gtr), np.concatenate(prd)) == \
        jmetrics.compute_general_metrics(np.concatenate(gtr), np.concatenate(prd))
    for chunks in (None, [0, 1]):
        assert tmetrics.compute_poseidon_metric(gtr, prd, mean, std, chunks) == \
            jmetrics.compute_poseidon_metric(gtr, prd, mean, std, chunks)


def test_config_merge_agrees(tmp_path):
    """The same file through both loaders gives the same values for every
    field both schemas have; unknown keys raise in both."""
    cfg = small_config(tmp_path)
    path = write_config(cfg, tmp_path / "cfg.json")
    j, t = jconfig.load_run_config(path), tconfig.load_run_config(path)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert jd.keys() == td.keys()
    for section in jd:
        assert jd[section] == td[section], section
    assert t.model.args.latent_tokens == (8, 8, 8) and t.optimizer.args.lr == 1e-3
    assert tdu.merge_config(t, {"optimizer": {"args": {"lr": "3e-4"}}}).optimizer.args.lr == 3e-4
    for module in (jdu, tdu):
        with pytest.raises(KeyError, match="unknown config key 'setup.nope'"):
            module.merge_config(t if module is tdu else j, {"setup": {"nope": 1}})


def test_config_defaults_agree_but_for_the_checkpoint_suffix():
    jd, td = dataclasses.asdict(jconfig.RunConfig()), dataclasses.asdict(tconfig.RunConfig())
    assert td["path"].pop("ckpt_path") == ".ckpt/test/test.pt"
    assert jd["path"].pop("ckpt_path") == ".ckpt/test/test.msgpack"
    assert jd == td


def test_config_files_load_in_three_formats(tmp_path):
    (tmp_path / "a.toml").write_text('[setup]\nseed = 7\ndevice = "cpu"\n')
    (tmp_path / "a.json").write_text('{"setup": {"seed": 7, "device": "cpu"}}')
    (tmp_path / "a.yaml").write_text('setup:\n  seed: 7\n  device: "cpu"\n')
    loaded = [tconfig.load_run_config(str(tmp_path / f"a.{ext}"))
              for ext in ("toml", "json", "yaml")]
    assert all(c == loaded[0] and c.setup.seed == 7 for c in loaded)
    with pytest.raises(NotImplementedError, match="unsupported config file type"):
        tconfig.load_run_config(str(tmp_path / "a.ini"))
    assert tconfig.SetUpConfig(dtype="torch.float64").dtype == "float32"


def test_recipe_toml_is_the_yamls_twin():
    """h100_500k.toml against tpu_500k.yaml: the differences its header
    states, and no other."""
    t = dataclasses.asdict(tconfig.load_run_config(
        os.path.join(REPO, "configs/examples/synthetic/h100_500k.toml")))
    j = dataclasses.asdict(jconfig.load_run_config(
        os.path.join(REPO, "configs/examples/synthetic/tpu_500k.yaml")))
    differ = set()

    def walk(a, b, prefix=""):
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], prefix + key + ".")
            elif a[key] != b[key] and list(np.ravel(a[key])) != list(np.ravel(b[key])):
                differ.add(prefix + key)

    walk(t, j)
    assert differ == {"setup.device", "path.ckpt_path",
                      "path.loss_path", "path.result_path", "path.database_path"}
    assert t["model"]["args"]["transformer"]["attn_config"]["atten_dropout"] == 0.1
