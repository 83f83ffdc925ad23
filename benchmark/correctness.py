"""The numbers that decide `correct`, each held to the limit of its cell
(`benchmark/limits/<cell>.json`, where the readings it was set from are kept
beside it). The drivers and `control.py` both take them from here.

A forward (`stage_gaps`), on each compared mesh, as relative L2 gaps:
  gno_gap   the encoder's GNO mean (what K5 accumulates, over each cell's
            edges) against the reference's, from the inputs;
  enc_gap   the encoder's output (the latent tokens the processor reads)
            against the reference's encoder run from the inputs;
  dec_gap   the prediction against the reference's decoder run on the
            program's own decoder input (the processor's output);
  pred_gap  the prediction against the reference's whole forward (served
            cells).
The cells that an undecided point may join or not, and the points that are
undecided or lean on such a cell, are left out (reference/model.py
`compared`: a squared distance within 3e-5 of radius^2, the band within
which the port's host and card builds may differ from the reference).
Training (`train_gaps`): the relative gap of each of the first steps' losses;
the gap between the program's and the reference's norm of each leaf of the
first gradient, and of each leaf's change over the first steps, over the
larger of the reference's norm of that leaf and of the median leaf (the
worst leaf); the change leaves out leaves whose reference gradient is under
a thousandth of the median leaf's, which Adam moves by round-off alone.
Every cell: points joined to more cells than the slot budget holds
(`over_budget`, limit 0, counted by the benchmark's own graph code), and
kernel launches that differ from what the configuration implies
(`launches_off`, limit 0).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Iterable, List, Mapping, Sequence

import torch

from .reference import graph as ref_graph
from .reference import model as ref

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> Dict[str, float]:
    path = os.path.join(HERE, "limits", f"{cell}.json")
    with open(path) as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def leaf_norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                  keep: Sequence[str]) -> float:
    """Worst leaf of |norm(got) - norm(want)| / max(norm(want), median norm)."""
    gn = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keep}
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    med = _median(list(wn.values()))
    return max(abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in keep)


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grad.items()}
    med = _median(list(norms.values()))
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def train_gaps(losses: Sequence[float], ref_losses: Sequence[float],
               first_grad: Dict[str, torch.Tensor], ref_grad: Dict[str, torch.Tensor],
               after: Dict[str, torch.Tensor], ref_after: Dict[str, torch.Tensor],
               w0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of the first steps against the
    reference's (`reference.optim.train_steps`)."""
    moving = moving_leaves(ref_grad)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": leaf_norm_gap(first_grad, ref_grad, list(ref_grad)),
        "change_gap": leaf_norm_gap({k: after[k] - w0[k] for k in moving},
                                    {k: ref_after[k] - w0[k] for k in moving}, moving),
    }


@torch.no_grad()
def stage_gaps(w0: Dict[str, torch.Tensor], spec: "ref.Spec", pos: torch.Tensor,
               feats: torch.Tensor, got: Mapping[str, torch.Tensor],
               end_to_end: bool = True) -> Dict[str, float]:
    """The gaps of one forward of the program on one mesh. `got` holds its
    encoder's GNO mean "gno" [M, C] and output "enc" [M, C], its decoder's
    input "dec_in" [M, C] and its prediction "pred" [N, C_out] in the order
    of `pos`; `end_to_end`
    adds pred_gap (an eval forward: a training forward's dropout is the
    loss's to compare)."""
    cells, valid = ref.graph(spec, pos)
    nodes_ok, cells_ok = ref.compared(spec, pos, cells, valid)
    want_gno, want_geo = ref.encode_parts(w0, spec, pos, feats, cells, valid)
    want_enc = ref.recover(w0, spec, want_gno, want_geo)
    pred = got["pred"].to(pos.device)[nodes_ok]
    gaps = {"gno_gap": rel_l2(got["gno"][cells_ok], want_gno[cells_ok]),
            "enc_gap": rel_l2(got["enc"][cells_ok], want_enc[cells_ok]),
            "dec_gap": rel_l2(pred, ref.decode(w0, spec, got["dec_in"], pos, cells,
                                               valid)[nodes_ok])}
    if end_to_end:
        want = ref.decode(w0, spec, ref.process(w0, spec, want_enc), pos, cells, valid)
        gaps["pred_gap"] = rel_l2(pred, want[nodes_ok])
    return gaps


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over several meshes."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


@torch.no_grad()
def over_budget(spec: "ref.Spec", positions: Iterable[torch.Tensor]) -> float:
    """Points, over all the meshes, joined to more cells than the slot
    budget holds."""
    return float(sum(ref_graph.over_budget(p, spec.grid, spec.radius, spec.budget, spec.chunk)
                     for p in positions))


def launch_mismatches(got: Dict[str, int], want: Dict[str, int]) -> int:
    return sum(got.get(k, 0) != v for k, v in want.items())


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at most its limit."""
    return all(math.isfinite(values.get(k, math.nan)) and values[k] <= limits[k]
               for k in limits)
