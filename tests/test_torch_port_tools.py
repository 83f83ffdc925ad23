"""The port's serving and data tools against their JAX twins, on the CPU.

Each tool under gaot3d_tpu_torch/tools/ runs beside the JAX tool of the same
name under tools/ (imported by path, run in this process) on the same input:
- export_model: a bucket bundle (and a single artifact) from a JAX
  `.msgpack` and from the port's checkpoint serves the JAX tool's artifact's
  predictions within rtol 1e-4, atol 1e-5; like the JAX tool it builds the
  model from `model.args` as written, so `setup.dtype: bfloat16` does not
  turn a float32 `kernel_dtype` into bfloat16 (the trainer's rule);
- import_torch_ckpt: a reference-style checkpoint (a JAX init exported by
  `state_dict_from_params`, DDP-prefixed, wrapped in {"model": ...}; with
  skips off also the reference's dead `skip_proj` weights) becomes the same
  `.msgpack` tree, bit for bit, and a model that matches the JAX forward;
- export_torch_ckpt: the same `.pt` state dict, key for key and bit for bit;
- gen_synthetic, repack_gsb, convert_vtk: the same files (`.gsb` and order
  files byte for byte, `.npz` key for key and bit for bit, as a zip's
  timestamps may differ).
"""
import contextlib
import importlib.util
import io
import json
import os
import shutil
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from gaot3d_tpu.config import load_run_config as jax_load_run_config
from gaot3d_tpu.models import init_model as jax_init_model
from gaot3d_tpu.serve import load_inference as jax_load_inference
from gaot3d_tpu.serve import load_inference_buckets as jax_load_buckets
from gaot3d_tpu.torch_export import state_dict_from_params
from gaot3d_tpu_torch.config import load_run_config
from gaot3d_tpu_torch.models import init_model
from gaot3d_tpu_torch.serve import load_inference, load_inference_buckets
from gaot3d_tpu_torch.tools import (convert_vtk, export_model, export_torch_ckpt,
                                    gen_synthetic, import_torch_ckpt, repack_gsb)
from gaot3d_tpu_torch.train.checkpoint import (load_msgpack_params, load_trained_params,
                                               save_checkpoint)
from gaot3d_tpu_torch.weights import load_numpy_state_dict
from test_vtk_ingestion import write_vtk
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHANNELS = (2, 1)


def jax_tool(name):
    """tools/<name>.py of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_tool(name, *argv):
    """Run the JAX tool's main() with `argv` on its command line."""
    with mock.patch.object(sys, "argv", [f"{name}.py", *argv]), \
            contextlib.redirect_stdout(io.StringIO()):
        jax_tool(name).main()


# --- models and checkpoints


def run_config(tmp_path, name, skips=True, mlp_type="channel", dtype="float32"):
    """A run config (JSON) of the tiny model of tests/test_serve.py, f32
    attention, with `setup.dtype` `dtype`."""
    raw = {"setup": {"device": "cpu", "dtype": dtype},
           "model": {"name": "gaot_3d", "args": {
               "latent_tokens": [4, 4, 4],
               "magno": {"lifting_channels": 8, "use_geoembed": [True, False],
                         "gno_radius": 0.45, "neighbor_strategy": "bidirectional",
                         "in_gno_channel_mlp_hidden_layers": [16],
                         "out_gno_channel_mlp_hidden_layers": [16],
                         "projection_channels": 16, "mlp_type": mlp_type},
               "transformer": {"patch_size": 2, "hidden_size": 32, "num_layers": 3,
                               "positional_embedding": "absolute",
                               "use_long_range_skip": skips,
                               "attn_config": {"hidden_size": 32, "num_heads": 4,
                                               "num_kv_heads": 2, "atten_dropout": 0.0,
                                               "attention_dtype": "float32"},
                               "ffn_config": {"hidden_size": 64}}}}}
    path = os.path.join(tmp_path, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def jax_model(config_path, seed=0):
    """The JAX model of the config, built as the JAX tools build it, with
    weights from `seed`."""
    margs = jax_load_run_config(config_path).model.args
    model = jax_init_model(*CHANNELS, "gaot_3d", margs.magno, margs.transformer,
                           latent_tokens=tuple(margs.latent_tokens))
    zeros = jnp.zeros((1, 32, 3), jnp.float32)
    params = model.init({"params": jax.random.key(seed)}, zeros, zeros[..., :2],
                        jnp.ones((1, 32), bool))
    return model, params


def port_model(config_path, sd=None):
    margs = load_run_config(config_path).model.args
    model = init_model(*CHANNELS, "gaot_3d", margs.magno, margs.transformer,
                       latent_tokens=tuple(margs.latent_tokens), device="cpu")
    if sd is not None:
        load_numpy_state_dict(model, sd)
    return model.eval()


def write_msgpack(path, params):
    """The JAX trainer's params-only layout {"params": variables}."""
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize({"params": jax.tree.map(np.asarray, params)}))


def checkpoints(tmp_path, config_path, seed=0):
    """(jax model, params, {kind: path}) for one set of weights: a JAX
    `.msgpack` and the port trainer's checkpoint."""
    jmodel, params = jax_model(config_path, seed)
    paths = {"msgpack": os.path.join(tmp_path, "run.msgpack"),
             "port": os.path.join(tmp_path, "run.pt")}
    write_msgpack(paths["msgpack"], params)
    pmodel = port_model(config_path, state_dict_from_params(params, jmodel.magno_config,
                                                             jmodel.attn_config))
    save_checkpoint(paths["port"], {"params": pmodel.state_dict(), "step": 3})
    return jmodel, params, paths


def request(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (1, n, 3)).astype(np.float32),
            rng.normal(size=(1, n, 2)).astype(np.float32), np.ones((1, n), bool))


def flat_tree(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def assert_same_arrays(a, b):
    """Equal key sets and, for every key, the same dtype, shape and bits."""
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


# --- export_model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["msgpack", "port"])
def test_export_model_bundle_matches_the_jax_tool(tmp_path, capsys, kind, dtype):
    """A bucket bundle {64, 128} of the port's tool, from either checkpoint,
    against the JAX tool's bundle from the JAX `.msgpack`: rtol 1e-4, atol
    1e-5 at requests 50, 100 and 128. With `setup.dtype: bfloat16` both tools
    keep the kernel MLPs at float32 (the JAX tool's behaviour): the port's
    artifact says so, and the bf16 model would miss the bound."""
    cfg = run_config(tmp_path, "run", dtype=dtype)
    assert load_run_config(cfg).setup.dtype == dtype
    _, _, paths = checkpoints(tmp_path, cfg)
    jpath, ppath = os.path.join(tmp_path, "jax.gaotxb"), os.path.join(tmp_path, "port.pt")
    run_jax_tool("export_model", "--config", cfg, "--ckpt", paths["msgpack"], "--output", jpath,
                 "--nodes", "64,128", "--in-channels", "2")
    export_model.main(["--config", cfg, "--ckpt", paths[kind], "--output", ppath,
                       "--nodes", "128,64", "--in-channels", "2", "--platforms", "tpu",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "--platforms and --device name JAX's lowering and tracing backends and are " \
           "ignored" in out
    blob = torch.load(ppath, weights_only=True)
    assert blob["buckets"] == [64, 128] and blob["edges"] == "device"
    assert blob["config"]["magno_config"]["kernel_dtype"] == "float32"
    jinfer, pinfer = jax_load_buckets(jpath), load_inference_buckets(ppath, device="cpu")
    for n in (50, 100, 128):
        pos, feats, mask = request(n, seed=n)
        want = jinfer(jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
        got = pinfer(torch.from_numpy(pos), torch.from_numpy(feats), torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_export_model_single_artifact_matches_the_jax_tool(tmp_path):
    """One `--nodes` value: the port writes a single artifact that builds its
    slots (the JAX tool's 'baked'), served by `load_inference` in its stored
    mode; `--edges slots` stores the call-time-edges mode."""
    cfg = run_config(tmp_path, "run", skips=False, mlp_type="linear")
    _, _, paths = checkpoints(tmp_path, cfg, seed=1)
    jpath, ppath = os.path.join(tmp_path, "jax.gaotx"), os.path.join(tmp_path, "port.pt")
    run_jax_tool("export_model", "--config", cfg, "--ckpt", paths["msgpack"], "--output", jpath,
                 "--nodes", "96", "--in-channels", "2")
    export_model.main(["--config", cfg, "--ckpt", paths["port"], "--output", ppath,
                       "--nodes", "96", "--in-channels", "2"])
    pos, feats, mask = request(96, seed=5)
    want = jax_load_inference(jpath)(jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
    got = load_inference(ppath, device="cpu")(*map(torch.from_numpy, (pos, feats, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    export_model.main(["--config", cfg, "--ckpt", paths["port"], "--output", ppath,
                       "--nodes", "96", "--in-channels", "2", "--edges", "flat,slots"])
    assert torch.load(ppath, weights_only=True)["edges"] == "args"
    with pytest.raises(ValueError, match="edge_layout"):
        export_model.main(["--config", cfg, "--ckpt", paths["port"], "--output", ppath,
                           "--nodes", "96", "--in-channels", "2", "--edges", "sectioned,slots"])


# --- import_torch_ckpt and export_torch_ckpt

REFERENCE_CONFIGS = {"skips-channel": dict(skips=True, mlp_type="channel"),
                     "no-skips-linear": dict(skips=False, mlp_type="linear")}


def reference_checkpoint(tmp_path, config_path, extra=None):
    """A checkpoint as the reference saves it, of a JAX init: its state dict
    (with the latent_tokens buffer, and with skips off the dead `skip_proj`
    weights the reference builds), DDP-prefixed, under "model"."""
    jmodel, params = jax_model(config_path, seed=2)
    attn = jmodel.attn_config
    sd = state_dict_from_params(params, jmodel.magno_config, attn,
                                latent_tokens=jmodel.latent_tokens)
    if not attn.use_long_range_skip:
        rng = np.random.default_rng(3)
        h = attn.hidden_size
        for i in range(attn.num_layers // 2):
            sd[f"processor.decoder_layers.{i}.skip_proj.weight"] = \
                rng.normal(size=(h, 2 * h)).astype(np.float32)
            sd[f"processor.decoder_layers.{i}.skip_proj.bias"] = np.zeros(h, np.float32)
    sd.update(extra or {})
    path = os.path.join(tmp_path, "reference.pt")
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, "epoch": 7}, path)
    return jmodel, params, path


@pytest.mark.parametrize("name", sorted(REFERENCE_CONFIGS))
def test_import_torch_ckpt_matches_the_jax_tool(tmp_path, name):
    """The port's `.msgpack` output is the JAX tool's tree (params_from_torch_
    state_dict) bit for bit; its `.pt` output loads the same weights; the
    imported model's forward matches JAX's on the JAX init: rtol 1e-4, atol
    1e-5."""
    cfg = run_config(tmp_path, name, **REFERENCE_CONFIGS[name])
    jmodel, params, ref = reference_checkpoint(tmp_path, cfg)
    jout, pout, ptout = (os.path.join(tmp_path, f) for f in ("jax.msgpack", "port.msgpack",
                                                             "port.pt"))
    run_jax_tool("import_torch_ckpt", "--config", cfg, "--torch-ckpt", ref, "--output", jout)
    import_torch_ckpt.main(["--config", cfg, "--torch-ckpt", ref, "--output", pout])
    import_torch_ckpt.main(["--config", cfg, "--torch-ckpt", ref, "--output", ptout])
    with open(jout, "rb") as f:
        want = flat_tree(serialization.msgpack_restore(f.read()))
    with open(pout, "rb") as f:
        got = flat_tree(serialization.msgpack_restore(f.read()))
    assert_same_arrays(got, want)
    from_pt = load_trained_params(ptout, port_model(cfg))
    from_msgpack = load_msgpack_params(pout, port_model(cfg))
    for (k, a), b in zip(from_pt.state_dict().items(), from_msgpack.state_dict().values()):
        assert torch.equal(a, b), k
    pos, feats, mask = request(64, seed=9)
    expect = jmodel.apply(params, jnp.asarray(pos), jnp.asarray(feats), jnp.asarray(mask))
    with torch.inference_mode():
        out = from_pt(*map(torch.from_numpy, (pos, feats, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bad", ["unknown", "missing", "live-skip", "grid"])
def test_import_torch_ckpt_is_strict(tmp_path, bad):
    """A key the model lacks, a key the checkpoint lacks, a `skip_proj` the
    model has none of while its skips are on (a decoder block of a model
    whose skips are off is the only place it is dropped) and a latent_tokens
    buffer of another grid all raise."""
    cfg = run_config(tmp_path, "run", skips=bad != "live-skip")
    extra = {"unknown": {"encoder.bogus.weight": np.zeros((2, 2), np.float32)},
             "live-skip": {"processor.encoder_layers.0.skip_proj.bias":
                           np.zeros(32, np.float32)},
             "grid": {"latent_tokens": np.zeros((64, 3), np.float32)}}.get(bad)
    _, _, ref = reference_checkpoint(tmp_path, cfg, extra)
    if bad == "missing":
        blob = torch.load(ref, weights_only=True)
        del blob["model"]["module.decoder.gno.channel_mlp.fcs.0.bias"]
        torch.save(blob, ref)
    with pytest.raises(ValueError, match="latent_tokens" if bad == "grid" else "does not fit"):
        import_torch_ckpt.main(["--config", cfg, "--torch-ckpt", ref,
                                "--output", os.path.join(tmp_path, "out.pt")])


def test_extract_state_dict_layouts():
    """The reference's save layouts, as the JAX tool's `extract_state_dict`
    accepts them."""
    sd = {"a.weight": torch.zeros(2), "a.bias": torch.zeros(1)}
    jax_extract = jax_tool("import_torch_ckpt").extract_state_dict
    for ckpt in (sd, {"model": sd}, {"gaot_3d": sd, "epoch": torch.tensor(1)},
                 {"state_dict": sd}, {"anything": sd}):
        assert import_torch_ckpt.extract_state_dict(ckpt) is jax_extract(ckpt) is sd
    for bad in ({}, {"epoch": torch.tensor(1)}, {"x": sd, "y": sd}):
        with pytest.raises(ValueError):
            import_torch_ckpt.extract_state_dict(bad)


@pytest.mark.parametrize("kind", ["msgpack", "port"])
@pytest.mark.parametrize("name", sorted(REFERENCE_CONFIGS))
def test_export_torch_ckpt_matches_the_jax_tool(tmp_path, name, kind):
    """{"model": state_dict} with the reference's keys: the key set and every
    array's bits, latent_tokens included, as `state_dict_from_params` and the
    JAX tool give them."""
    cfg = run_config(tmp_path, name, **REFERENCE_CONFIGS[name])
    jmodel, params, paths = checkpoints(tmp_path, cfg, seed=4)
    jout, pout = os.path.join(tmp_path, "jax.pt"), os.path.join(tmp_path, "port.pt")
    run_jax_tool("export_torch_ckpt", "--config", cfg, "--ckpt", paths["msgpack"],
                 "--output", jout)
    export_torch_ckpt.main(["--config", cfg, "--ckpt", paths[kind], "--output", pout])
    got = {k: v.numpy() for k, v in torch.load(pout, weights_only=True)["model"].items()}
    tool = {k: v.numpy() for k, v in torch.load(jout, weights_only=True)["model"].items()}
    want = state_dict_from_params(params, jmodel.magno_config, jmodel.attn_config,
                                  latent_tokens=jmodel.latent_tokens)
    assert_same_arrays(got, want)
    assert_same_arrays(got, tool)
    assert "latent_tokens" in got


def test_checkpoint_round_trip_is_exact(tmp_path):
    """export_torch_ckpt then import_torch_ckpt gives back the same bits."""
    cfg = run_config(tmp_path, "run")
    _, _, paths = checkpoints(tmp_path, cfg, seed=6)
    ref, back = os.path.join(tmp_path, "ref.pt"), os.path.join(tmp_path, "back.pt")
    export_torch_ckpt.main(["--config", cfg, "--ckpt", paths["port"], "--output", ref])
    import_torch_ckpt.main(["--config", cfg, "--torch-ckpt", ref, "--output", back])
    a = torch.load(paths["port"], weights_only=True)["params"]
    b = torch.load(back, weights_only=True)["params"]
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


# --- data tools


def smoke_config(tmp_path, side):
    """configs/examples/synthetic/smoke.yaml cut to 3 samples of 2,000 nodes,
    its data under tmp_path/side."""
    with open(os.path.join(REPO, "configs/examples/synthetic/smoke.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["dataset"].update(base_path=os.path.join(tmp_path, side), synthetic_num_samples=3,
                          synthetic_num_nodes=2000, train_size=1, val_size=1, test_size=1)
    path = os.path.join(tmp_path, f"smoke_{side}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def assert_same_tree(a, b):
    """Two directories hold the same files: .npz key for key and bit for bit,
    every other file byte for byte."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    assert files
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert_same_arrays(dict(za), dict(zb))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("gsb", [False, True])
def test_gen_synthetic_writes_the_jax_tools_files(tmp_path, gsb):
    """The dataset, its precomputed slots and (with --gsb) the repack."""
    flag = ["--gsb"] if gsb else []
    run_jax_tool("gen_synthetic", "--config", smoke_config(tmp_path, "jax"), *flag)
    with contextlib.redirect_stdout(io.StringIO()):
        gen_synthetic.main(["--config", smoke_config(tmp_path, "port"), *flag])
    assert_same_tree(os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "port"))
    names = sorted(os.listdir(os.path.join(tmp_path, "port", "processed")))
    ext = ".gsb" if gsb else ".npz"
    assert names == [f"sample_{i:05d}{ext}" for i in range(3)]


def test_repack_gsb_writes_the_jax_tools_files(tmp_path):
    """.npz samples and one reference-style .pt sample repacked to .gsb."""
    with contextlib.redirect_stdout(io.StringIO()):
        gen_synthetic.main(["--config", smoke_config(tmp_path, "src")])
    src = os.path.join(tmp_path, "src")
    first = os.path.join(src, "processed", "sample_00000")
    with np.load(first + ".npz") as z:
        torch.save({k: torch.from_numpy(z[k]) for k in ("pos", "x")}, first + ".pt")
    os.remove(first + ".npz")
    for side in ("jax", "port"):
        shutil.copytree(src, os.path.join(tmp_path, side))
    run_jax_tool("repack_gsb", "--root", os.path.join(tmp_path, "jax"))
    repack_gsb.main(["--root", os.path.join(tmp_path, "port")])
    assert_same_tree(os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "port"))
    assert os.path.exists(os.path.join(tmp_path, "port", "processed", "sample_00000.gsb"))


def test_convert_vtk_writes_the_jax_tools_files(tmp_path):
    """Legacy ASCII .vtk meshes with SCALARS (with and without their
    component count), VECTORS and FIELD blocks, the fields stacked as
    columns; a mesh without a requested field is left out by both."""
    raw = os.path.join(tmp_path, "raw")
    os.makedirs(os.path.join(raw, "nested"))
    write_vtk(os.path.join(raw, "car_000.vtk"), 40, seed=0, scalars_inline_ncomp=True)
    write_vtk(os.path.join(raw, "nested", "car_001.vtk"), 55, seed=1)
    with open(os.path.join(raw, "car_002.vtk"), "w") as f:
        f.write("# vtk DataFile Version 3.0\nno fields\nASCII\nDATASET POLYDATA\n"
                "POINTS 2 float\n0 0 0\n1 1 1\n")
    fields = ["pressure", "wss", "Normals"]
    jax_tool("convert_vtk").convert(raw, os.path.join(tmp_path, "jax"), fields, "processed")
    convert_vtk.convert(raw, os.path.join(tmp_path, "port"), fields, "processed")
    assert_same_tree(os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "port"))
    with np.load(os.path.join(tmp_path, "port", "processed", "car_001.npz")) as z:
        assert z["pos"].shape == (55, 3) and z["x"].shape == (55, 7)
    with open(os.path.join(tmp_path, "port", "order_processed.txt")) as f:
        assert f.read().split() == ["car_000", "car_001"]
