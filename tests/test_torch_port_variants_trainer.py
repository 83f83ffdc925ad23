"""The port's trainer on a multiscale MAGNO variant config against the JAX
trainer on the CPU: tests/test_torch_port_trainer.py's `small_config` with
two scales and scale weights, the PointNet encoder geoembed and cosine
attention in the GNOs, over uniform slots. Both trainers read one dataset
directory; the port starts from the JAX trainer's initial parameters through
a msgpack checkpoint. validate() to 1e-5 relative, two epochs of fit() to
1e-3 (tests/test_torch_port_trainer.py's bound and reason).
"""
import copy
import dataclasses
import os

import numpy as np
import pytest

from gaot3d_tpu import config as jconfig
from gaot3d_tpu.train.trainer import init_trainer as jax_init_trainer
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)
from test_torch_port_trainer import port_trainer, small_config, write_config


def variant_config(base, name="run"):
    """`small_config` with two scales and scale weights, the PointNet encoder
    geoembed and cosine attention in the GNOs, over uniform slots (sections
    take one scale)."""
    cfg = small_config(base, name)
    cfg["model"]["args"]["magno"].update(
        scales=[1.0, 2.0], use_scale_weights=True, embedding_method="pointnet",
        use_attn=True, attention_type="cosine", edge_layout="slots", slot_budget=None)
    return cfg


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("variants")
    cfg = variant_config(tmp)
    jcfg = copy.deepcopy(cfg)
    jcfg["path"]["ckpt_path"] = os.path.join(str(tmp), "jax", "c.msgpack")
    for key in ("loss_path", "result_path", "database_path"):
        jcfg["path"][key] = jcfg["path"][key].replace("/run/", "/jax/")
    jt = jax_init_trainer(jconfig.load_run_config(write_config(jcfg, tmp / "jax.json")))
    init_ckpt = os.path.join(str(tmp), "init.msgpack")
    jt.save_ckpt(init_ckpt)
    pt = port_trainer(cfg, tmp)
    pt.load_ckpt(init_ckpt)  # the JAX tree's variant names through tree_path
    return {"jax": jt, "port": pt, "val": (jt.validate(jt.val_loader),
                                          pt.validate(pt.val_loader)),
            "fit": (jt.fit(), pt.fit())}


def test_trainer_reads_multiscale_batches(trainers):
    pt = trainers["port"]
    batch = pt.put_batch(next(iter(pt.train_loader)))
    assert isinstance(batch.enc_slots, list) and len(batch.enc_slots) == 2
    assert batch.enc_slots[1].lat_idx.shape[-1] > batch.enc_slots[0].lat_idx.shape[-1]
    assert dataclasses.asdict(pt.model.magno_config)["scales"] == [1.0, 2.0]


def test_trainer_follows_the_jax_trainers_losses(trainers):
    """validate() on the JAX trainer's initial parameters to 1e-5; two epochs
    of fit() to 1e-3 (Adam's first step, see tests/test_torch_port_trainer.py)."""
    jval, pval = trainers["val"]
    np.testing.assert_allclose(pval, jval, rtol=1e-5)
    jfit, pfit = trainers["fit"]
    np.testing.assert_allclose(pfit["train"]["loss"], jfit["train"]["loss"], rtol=1e-3)
    np.testing.assert_allclose(pfit["valid"]["loss"], jfit["valid"]["loss"], rtol=1e-3)
    assert pfit["train"]["loss"][1] < pfit["train"]["loss"][0]
