"""Evaluation metric suites (port of gaot3d_tpu/train/metrics.py, numpy only).

Parity with the reference (src/trainer/utils/metric.py):
  - 'drivaernet' (metric.py:147-190): per-batch z-normalize DE-NORMALIZED
    predictions/targets by the dataset metadata global mean/std, compute
    MSE/MAE/RMSE/MaxErr/RelL2/RelL1 per batch, aggregate mean +- std over
    batches. RelL2/RelL1 are per-variable column norms over the node axis,
    averaged across variables (metric.py:174-177).
  - 'general' (stat.py:734-765): whole-test-set MSE/MAE/MaxAE/RelL1/RelL2 on
    de-normalized values.
  - 'poseidon' (metric.py:10-68): per-sample relative L1 per variable chunk,
    median over samples, mean over chunks.

These run host-side on numpy (the test loop accumulates on the host like the
reference does, stat.py:632-633): they are not in the device's hot path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

EPSILON = 1e-10


def compute_drivaernet_metric(
    gtr_list: Sequence[np.ndarray],
    prd_list: Sequence[np.ndarray],
    global_mean: Sequence[float],
    global_std: Sequence[float],
) -> Dict[str, float]:
    mean = np.asarray(global_mean, dtype=np.float64)
    std = np.asarray(global_std, dtype=np.float64)
    per_batch: List[Dict[str, float]] = []
    for gtr, prd in zip(gtr_list, prd_list):
        g = (np.asarray(gtr, np.float64) - mean) / std
        p = (np.asarray(prd, np.float64) - mean) / std
        diff = g - p
        mse = float(np.mean(diff ** 2))
        per_batch.append(
            {
                "MSE": mse,
                "MAE": float(np.mean(np.abs(diff))),
                "RMSE": float(np.sqrt(mse)),
                "Max_Error": float(np.max(np.abs(diff))),
                "Rel_L2": float(
                    np.mean(np.linalg.norm(diff, axis=0) / np.linalg.norm(g, axis=0))
                ),
                "Rel_L1": float(
                    np.mean(np.sum(np.abs(diff), axis=0) / np.sum(np.abs(g), axis=0))
                ),
            }
        )
    agg: Dict[str, float] = {}
    for key in per_batch[0]:
        vals = np.asarray([m[key] for m in per_batch])
        agg[key] = float(vals.mean())
        agg[f"{key}_std"] = float(vals.std())
    return agg


def compute_general_metrics(gtr: np.ndarray, prd: np.ndarray) -> Dict[str, float]:
    gtr = np.asarray(gtr, np.float64)
    prd = np.asarray(prd, np.float64)
    diff = prd - gtr
    rel_l2 = float(np.linalg.norm(diff) / (np.linalg.norm(gtr) + EPSILON)) * 100.0
    rel_l1 = float(np.abs(diff).sum() / (np.abs(gtr).sum() + EPSILON)) * 100.0
    return {
        "MSE": float(np.mean(diff ** 2)),
        "MAE": float(np.mean(np.abs(diff))),
        "Max AE": float(np.max(np.abs(diff))),
        "Rel L2 Error (%)": rel_l2,
        "Rel L1 Error (%)": rel_l1,
    }


def compute_poseidon_metric(
    gtr_list: Sequence[np.ndarray],
    prd_list: Sequence[np.ndarray],
    global_mean: Sequence[float],
    global_std: Sequence[float],
    chunked_variables: Sequence[int] = None,
) -> float:
    """Per-sample relative L1 per variable chunk -> median over samples ->
    mean over chunks (metric.py:10-68). Samples here are list entries
    (one array [nodes, vars] each)."""
    mean = np.asarray(global_mean, np.float64)
    std = np.asarray(global_std, np.float64)
    nvar = mean.shape[0]
    chunks = np.asarray(chunked_variables if chunked_variables is not None else [0] * nvar)
    num_chunks = int(chunks.max()) + 1
    rel_errors = []
    for gtr, prd in zip(gtr_list, prd_list):
        g = (np.asarray(gtr, np.float64) - mean) / std
        p = (np.asarray(prd, np.float64) - mean) / std
        abs_err = np.abs(g - p).sum(axis=0)  # [vars]
        gtr_abs = np.abs(g).sum(axis=0)
        err_chunk = np.zeros(num_chunks)
        gtr_chunk = np.zeros(num_chunks)
        for v in range(nvar):
            err_chunk[chunks[v]] += abs_err[v]
            gtr_chunk[chunks[v]] += gtr_abs[v]
        rel_errors.append(err_chunk / (gtr_chunk + EPSILON))
    rel = np.stack(rel_errors)  # [samples, chunks]
    return float(np.median(rel, axis=0).mean())
