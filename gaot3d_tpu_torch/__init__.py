"""PyTorch + CUDA port of gaot3d_tpu for NVIDIA Hopper (H100).

The JAX package `gaot3d_tpu` is the reference; this package mirrors its layout
(`ops/`, `models/`, `data/`) so every module has an obvious counterpart, and
adds `kernels/` (Python wrappers) and `csrc/` (the hand-written CUDA kernels
that replace the Pallas TPU kernels).

This package imports `torch` and never `jax`, `flax` or `gaot3d_tpu`.

Covered: the serving path (`serve.py`), the train step (`train/step.py`) over
uniform slots, degree sections and flat edge lists, and the trainer with its
data feed, checkpoints and command line (`python -m gaot3d_tpu_torch --config
<file>`: `cli.py`, `config.py`, `train/trainer.py`, `data/`).
"""
