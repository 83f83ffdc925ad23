"""Dataset metadata registry (port of gaot3d_tpu/metadata.py, same constants).

Numerical constants (domain bounds, global mean/std) must match the reference
registry exactly — DrivAerNet metric parity depends on them
(reference: src/data/metadata.py:25-162; metrics z-normalize with global_mean/std,
src/trainer/utils/metric.py:149-175).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union


@dataclass
class Metadata:
    periodic: bool
    group_u: Optional[str]
    group_c: Optional[str]
    group_x: Optional[str]
    type: str
    fix_x: bool
    domain_x: Tuple[Sequence[float], Sequence[float]]
    domain_t: Optional[Tuple[float, float]]
    active_variables: Optional[Sequence[int]]
    chunked_variables: Optional[Sequence[int]]
    num_variable_chunks: int
    signed: Dict[str, Union[bool, Sequence[Optional[bool]]]]
    names: Dict[str, Sequence[Optional[str]]]
    global_mean: Sequence[float]
    global_std: Sequence[float]


def _meta(domain_x, names_u, global_mean, global_std, group_c=None, names_c=(None,)):
    nvar = len(global_mean)
    return Metadata(
        periodic=False,
        group_u="u",
        group_c=group_c,
        group_x="x",
        type="gaot",
        fix_x=False,
        domain_x=domain_x,
        domain_t=None,
        active_variables=None,
        chunked_variables=None,
        num_variable_chunks=1,
        signed={"u": [False] * nvar, "c": list(names_c and [None] * len(names_c))},
        names={"u": list(names_u), "c": list(names_c)},
        global_mean=list(global_mean),
        global_std=list(global_std),
    )


_DRIVAERNET_DOMAIN = ([-1.16, -1.20, 0.0], [4.21, 1.19, 1.77])
_NASA_CRM_DOMAIN = ([2.3495, -29.460142, 2.3101413], [66.744965, 29.460142, 8.833843])
_DRIVAERML_DOMAIN = ([-0.943, -1.14, -0.318], [4.14, 1.14, 1.25])

DATASET_METADATA: Dict[str, Metadata] = {
    "incompressible_fluids/drivaernet_pressure": _meta(
        _DRIVAERNET_DOMAIN, ["$p$"], [-93.4105], [120.7879]
    ),
    "incompressible_fluids/drivaernet_shearstress": _meta(
        _DRIVAERNET_DOMAIN,
        ["$p$"],
        [-0.6717, 0.0364, -0.0846],
        [0.8199, 0.4510, 0.7811],
    ),
    "incompressible_fluids/nasa_crm": _meta(
        _NASA_CRM_DOMAIN,
        ["$p$", "sfc_x", "sfc_y", "sfc_z"],
        [-3.3177e-02, 1.4710e-03, 6.4260e-06, -2.2570e-06],
        [0.3108, 0.0010, 0.0005, 0.0007],
        group_c="c",
        names_c=["Mach", "AOA"],
    ),
    "incompressible_fluids/nasa_crm_pressure": _meta(
        _NASA_CRM_DOMAIN,
        ["$p$"],
        [-3.3177e-02],
        [0.3108],
        group_c="c",
        names_c=["Mach", "AOA"],
    ),
    "incompressible_fluids/nasa_crm_sfc": _meta(
        _NASA_CRM_DOMAIN,
        ["sfc_x", "sfc_y", "sfc_z"],
        [1.4710e-03, 6.4260e-06, -2.2570e-06],
        [0.0010, 0.0005, 0.0007],
        group_c="c",
        names_c=["Mach", "AOA"],
    ),
    "incompressible_fluids/drivaerml_pressure": _meta(
        _DRIVAERML_DOMAIN, ["$p$"], [-0.3046], [0.3560]
    ),
    "incompressible_fluids/drivaerml_wss": _meta(
        _DRIVAERML_DOMAIN,
        ["wss_x", "wss_y", "wss_z"],
        [-1.2049, 0.0015, -0.0724],
        [2.0773, 1.3518, 1.1098],
    ),
    "incompressible_fluids/drivaerml": _meta(
        _DRIVAERML_DOMAIN,
        ["$p$", "wss_x", "wss_y", "wss_z"],
        [-0.3046, -1.2049, 0.0015, -0.0724],
        [0.3560, 2.0773, 1.3518, 1.1098],
    ),
}

# Synthetic dataset used by tests / benchmarks (not in the reference registry).
DATASET_METADATA["synthetic/unit_cube"] = _meta(
    ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]), ["$p$"], [0.0], [1.0]
)
