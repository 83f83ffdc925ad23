"""Config merging, seeding and host-side sampling helpers of the port."""
from .dataclass_utils import dataclass_from_dict, merge_config, shallow_asdict
from .rand import manual_seed, rng_for
from .sample import grid, subsample

__all__ = ["shallow_asdict", "dataclass_from_dict", "merge_config", "manual_seed", "rng_for",
           "grid", "subsample"]
