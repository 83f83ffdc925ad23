"""The elementwise-chain probe (T1): the plain version of the port's kernel
against the JAX probe tools/microbench_vpu_bf16.py run in interpret mode on
the CPU, the wrapper's CPU dispatch and checks, and the entry point's refusal
to run without a card. The kernel itself runs only on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""
import functools
import importlib.util
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gaot3d_tpu_torch.kernels import elementwise_chain as t1
from gaot3d_tpu_torch.tools import microbench_vpu_bf16 as probe
import test_torch_port_cpu  # noqa: F401  (torch on this worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Per-element limits on |port - jax| / |jax|, for the finite elements:
# - select: both sides take the same correctly rounded compare, multiply and
#   add, so they agree to one rounding step of the type (they agree exactly
#   here);
# - exp: the two libraries' exponentials may differ by a rounding step of
#   the type (f32: a few 1e-7; bf16: XLA and torch both round every operation
#   to bf16, one step is 2^-7 at most). At reps 2 the step before feeds the
#   exponent, which multiplies a relative error by 0.9 |acc|, so the limit
#   grows by that factor, with acc the plain value after one step.
STEP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
EXP_STEP = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture
def jax_probe(monkeypatch):
    """tools/microbench_vpu_bf16.py imported by path, its `pl` swapped for a
    shim whose pallas_call runs in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "microbench_vpu_bf16_jax", os.path.join(REPO, "tools", "microbench_vpu_bf16.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    shim = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                 BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(module, "pl", shim)
    return module


def _block(seed=0):
    return np.random.default_rng(seed).standard_normal(probe.BLOCK, dtype=np.float32)


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", ["exp", "select"])
def test_chain_plain_matches_jax_probe(jax_probe, chain, dtype, reps):
    x = _block()
    want = np.asarray(jax_probe.make(chain, JAX_DTYPES[dtype], reps, 1)(
        jnp.asarray(x).astype(JAX_DTYPES[dtype])).astype(jnp.float32))
    xt = torch.from_numpy(x).to(dtype)
    got = t1.chain_plain(xt, chain, reps).float().numpy()
    assert got.shape == want.shape == probe.BLOCK
    assert np.array_equal(~np.isfinite(got), ~np.isfinite(want)), "non-finite positions differ"
    fin = np.isfinite(want)
    rel = np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), np.finfo(np.float32).tiny)
    if chain == "select":
        limit = np.full_like(rel, STEP[dtype])
    else:
        limit = np.full_like(rel, EXP_STEP[dtype])
        if reps == 2:
            after_one = t1.chain_plain(xt, chain, 1).float().numpy()[fin]
            limit = limit * (1.0 + 0.9 * np.abs(after_one))
    worst = int(np.argmax(rel / limit))
    assert rel[worst] <= limit[worst], \
        f"{chain} {dtype} reps {reps}: relative error {rel[worst]} over its limit {limit[worst]}"


def test_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(_block(1)[:4]).to(torch.bfloat16)
    before = t1.elementwise_chain.launches
    for chain in t1.CHAINS:
        got = t1.elementwise_chain(x, chain, 2, copies=3)
        assert torch.equal(got, t1.chain_plain(x, chain, 2))
    assert t1.elementwise_chain.launches == before


def test_wrapper_checks_arguments():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="chain"):
        t1.elementwise_chain(x, "tanh", 1)
    with pytest.raises(ValueError, match="reps"):
        t1.elementwise_chain(x, "exp", 3)
    with pytest.raises(ValueError, match="chain"):
        t1.chain_plain(x, "tanh", 1)


def test_probe_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        probe.run(1, 1)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        probe.main(["1", "1"])


def test_probe_modules_import_without_cuda_triton_or_jax():
    code = ("import sys\n"
            "sys.modules['triton'] = None\n"
            "import gaot3d_tpu_torch.kernels.elementwise_chain\n"
            "import gaot3d_tpu_torch.tools.microbench_vpu_bf16\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'gaot3d_tpu', 'triton') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
