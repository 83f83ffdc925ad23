"""The CPU settings the port's tests run under, and the checks that hold them.

Threads. The suite runs its files in pytest-xdist workers, one process each,
and torch sizes its intra-op pool (and MKL's) to every core of the machine in
every one of them: six workers on eight cores ran 48 threads that spun
against each other, and a two-epoch fit of the port's trainer that takes
seconds alone took minutes beside five such processes. Every port test
module imports this one, which gives torch the worker's share of the cores
(all of them when the file runs alone). `child_env` passes the same share to
the processes that a test starts.

Precision. The port's parity tests compare f32 on the CPU, where the f32
products of both libraries are exact f32 products summed in f32, and their
exponentials are within a few ulp. The checks below hold that in a worker
under these settings with rigorous bounds (gamma_K of the dot's length), so
that a library that computed at TF32 or bf16x3 grade would be named here.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch


def cpu_threads() -> int:
    """This process's share of the cores: all of them alone, cores over
    workers under pytest-xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


def child_env(**extra) -> dict:
    """The environment for a process a test starts: the same share of cores."""
    return {**os.environ, "OMP_NUM_THREADS": str(cpu_threads()), **extra}


torch.set_num_threads(cpu_threads())

U32 = 2.0 ** -24  # f32 unit roundoff


def _operands(K, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(128, K)).astype(np.float32)
    b = rng.normal(size=(K, 128)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    # |fl(a . b) - a . b| <= gamma_K sum |a_i b_i|, gamma_K = K u / (1 - K u)
    bound = K * U32 / (1 - K * U32) * (np.abs(a).astype(np.float64) @ np.abs(b))
    return a, b, exact, bound


def test_torch_runs_on_the_workers_share_of_the_cores():
    assert torch.get_num_threads() == cpu_threads()
    assert child_env()["OMP_NUM_THREADS"] == str(cpu_threads())


def test_both_libraries_multiply_in_exact_f32():
    """The attention's dot lengths (head dim 32, 64-key blocks, 128 keys):
    each element within gamma_K of the float64 product, in torch, in a jitted
    and an eager JAX dot; neither library has a reduced precision set."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert jax.config.jax_default_matmul_precision is None
    for K in (32, 64, 128):
        a, b, exact, bound = _operands(K, seed=K)
        got = {"torch": torch.from_numpy(a) @ torch.from_numpy(b),
               "jax.jit": jax.jit(jnp.matmul)(a, b),
               "jax eager": jnp.matmul(jnp.asarray(a), jnp.asarray(b))}
        for lib, out in got.items():
            err = np.abs(np.asarray(out, np.float64) - exact)
            assert (err <= bound).all(), (lib, K, float((err / bound).max()))


def test_both_libraries_exponentiate_to_a_few_ulp():
    """exp over the softmax's range [-30, 0]: 4 ulp of f32, relative."""
    x = np.linspace(-30.0, 0.0, 4099, dtype=np.float32)
    exact = np.exp(x.astype(np.float64))
    for lib, out in (("torch", torch.exp(torch.from_numpy(x))),
                     ("jax", jax.jit(jnp.exp)(x))):
        rel = np.abs(np.asarray(out, np.float64) - exact) / exact
        assert rel.max() <= 4 * 2.0 ** -23, (lib, float(rel.max()))
