"""Top-level run configuration (port of gaot3d_tpu/config.py).

The same sections and fields as the JAX package's schema, so one YAML, TOML or
JSON file drives either: setup / model / dataset / optimizer / path. Unknown
keys raise. Fields that only the JAX package acts on are kept so that its
files load; the trainer refuses the values it cannot honour.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from .data.dataset import DatasetConfig
from .models import require_device
from .models.magno import MAGNOConfig
from .models.transformer import TransformerConfig
from .train.schedule import OptimizerargsConfig
from .utils.dataclass_utils import dataclass_from_dict, load_config_file


@dataclass
class SetUpConfig:
    """(reference: default_set.py:17-48)"""

    seed: int = 42
    # 'auto', 'cuda' and 'cuda:N' mean the card and raise without one; 'cpu'
    # means the CPU (the kernels' plain versions); 'tpu' raises. Nothing falls
    # back to the CPU because no GPU was found (`resolve_device`).
    device: str = "auto"
    # ['float32', 'bfloat16']; 'bfloat16' turns a float32 magno.kernel_dtype
    # into bfloat16 (the trainer's init_model, as in the JAX trainer).
    # Attention q/k/v are bf16 either way (`attention_dtype`).
    dtype: str = "float32"
    trainer_name: str = "static3d"
    train: bool = True
    test: bool = False
    ckpt: bool = False
    # accepted for reference-YAML drop-in compat and deliberately inert — the
    # reference never consumes it either: default_set.py:26 is a TODO and
    # base.py:413 variance_test() is an abstract stub nothing calls, yet the
    # shipped config/examples/drivaernet/pressure.yaml sets the key
    use_variance_test: bool = False
    # distributed runs and node sharding are not ported: the trainer refuses
    # `distributed: true` and `node_shards > 1`; the other fields are kept so
    # that the JAX package's files load
    distributed: bool = False
    world_size: int = 1
    rank: int = 0
    local_rank: int = 0
    coordinator_address: Optional[str] = None
    backend: str = "jax"
    data_parallel: Optional[int] = None
    node_shards: int = 1
    # wandb
    wandb: bool = False
    wandb_project: Optional[str] = None
    wandb_entity: Optional[str] = None
    wandb_run_name: Optional[str] = None
    wandb_group: Optional[str] = None
    wandb_mode: str = "online"
    wandb_notes: Optional[str] = None
    wandb_tags: List[str] = field(default_factory=list)
    wandb_watch_model: bool = False
    # schema-parity field, inert here exactly as in the reference (declared at
    # default_set.py:44, never read anywhere; wandb rows go out per eval epoch)
    wandb_log_interval: int = 1
    resume_from_artifact: Optional[str] = None
    resume_from_ckpt: Optional[str] = None
    test_during_training: bool = False
    # observability: write a torch.profiler Chrome trace of the first
    # `profile_steps` training steps of epoch `profile_epoch` into this
    # directory
    profile_dir: Optional[str] = None
    profile_epoch: int = 1
    profile_steps: int = 3

    def __post_init__(self):
        # reference YAMLs write torch dtype strings ("torch.float32",
        # default_set.py:21 + the shipped pressure.yaml) — normalize to the
        # plain names the trainer consumes. float64 maps to float32, as in the
        # JAX package: the reference only ever runs float32 in practice.
        d = self.dtype.removeprefix("torch.")
        self.dtype = "float32" if d == "float64" else d


@dataclass
class ModelArgsConfig:
    """(reference: default_set.py:50-54)"""

    latent_tokens: Tuple[int, int, int] = (64, 64, 64)
    magno: MAGNOConfig = field(default_factory=MAGNOConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)


@dataclass
class ModelConfig:
    """(reference: default_set.py:56-60)"""

    name: str = "gaot_3d"
    use_conditional_norm: bool = False
    args: ModelArgsConfig = field(default_factory=ModelArgsConfig)


@dataclass
class OptimizerConfig:
    """(reference: default_set.py:88-91)"""

    name: str = "adamw"
    args: OptimizerargsConfig = field(default_factory=OptimizerargsConfig)


@dataclass
class PathConfig:
    """(reference: default_set.py:93-98)"""

    ckpt_path: str = ".ckpt/test/test.pt"
    loss_path: str = ".loss/test/test.png"
    result_path: str = ".result/test/test.png"
    database_path: str = ".database/test/test.csv"


@dataclass
class RunConfig:
    setup: SetUpConfig = field(default_factory=SetUpConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    path: PathConfig = field(default_factory=PathConfig)


def load_run_config(filename: str) -> RunConfig:
    raw = load_config_file(filename)
    return dataclass_from_dict(RunConfig, raw)


def resolve_device(name: str):
    """`setup.device` as a torch.device: 'auto', 'cuda' and 'cuda:N' are the
    card and raise RuntimeError when none is present, 'cpu' is the CPU, 'tpu'
    and anything else raise ValueError."""
    name = (name or "auto").lower()
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto" or name == "cuda" or name.startswith("cuda:"):
        return require_device("cuda" if name == "auto" else name)
    raise ValueError(f"setup.device {name!r} is not a device of this package: use 'auto', "
                     "'cuda', 'cuda:N' or 'cpu'")
