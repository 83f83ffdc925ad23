"""Config merging and seeding helpers of the port."""
from .dataclass_utils import dataclass_from_dict, merge_config, shallow_asdict
from .rand import manual_seed, rng_for

__all__ = ["shallow_asdict", "dataclass_from_dict", "merge_config", "manual_seed", "rng_for"]
