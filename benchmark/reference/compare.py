"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference computes from the same inputs."""

from __future__ import annotations

import math
import statistics

import numpy as np


__all__ = ["map_gaps", "over_frames", "leaf_gaps", "leaf_diffs", "train_gaps", "state_change"]


def map_gaps(program: np.ndarray, reference: np.ndarray, rounded: np.ndarray) -> dict:
    """Of a disparity map against the float32 reference's: the mean
    absolute gap (px), that gap over the one that rounding the reference's
    convolutions to bfloat16 gives on the same frame (``rounded``), and the
    share of pixels (%) off by more than three times that rounding's 99th
    percentile."""
    ref = np.asarray(reference, np.float64)
    gap = np.abs(np.asarray(program, np.float64) - ref)
    floor = np.abs(np.asarray(rounded, np.float64) - ref)
    if not np.isfinite(gap).all():
        gap = np.full_like(ref, np.inf)
    return {
        "disp_mean_gap_px": float(gap.mean()),
        "disp_gap_over_rounding": float(gap.mean() / max(floor.mean(), 1e-12)),
        "disp_beyond_3x_rounding_pct": float(100.0 * (gap > 3 * np.percentile(floor, 99)).mean()),
    }


def over_frames(readings: list[dict]) -> dict:
    """Each number's mean over the frames."""
    return {k: float(np.mean([r[k] for r in readings])) for k in readings[0]}


def leaf_gaps(program: dict, reference: dict, names) -> dict:
    """Each leaf's gap of norms: ``| |p| - |r| |`` over the larger of the
    reference leaf's norm and the median leaf's (some are all but zero)."""
    pn = {k: program[k].double().norm().item() for k in names}
    rn = {k: reference[k].double().norm().item() for k in names}
    floor = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in names}
    return {k: (math.inf if math.isnan(v) else v) for k, v in gaps.items()}


def leaf_diffs(program: dict, reference: dict) -> dict:
    """Each leaf's norm of the difference, over the larger of the reference
    leaf's norm and the median leaf's."""
    rn = {k: v.double().norm().item() for k, v in reference.items()}
    floor = statistics.median(rn.values())
    return {k: (program[k].double() - reference[k].double()).norm().item() / max(rn[k], floor, 1e-30) for k in reference}


def _worst(gaps: dict) -> tuple[float, str]:
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def train_gaps(prog: dict, ref: dict, rounded: dict | None = None) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the checked steps), ``grad``
    (the first gradient by parameter), ``disp1`` (the first step's
    train-mode maps), ``change`` (each parameter's change over the checked
    steps) and ``stats`` (each BN running statistic's change).
    ``loss1_gap`` is the first step's alone; ``change_median_gap`` and
    ``stats_median_gap`` the median leaf's gap of change of the parameters
    and of the running statistics. Given ``rounded`` (the reference with
    bfloat16 convolutions), the ``disp1_`` numbers are ``map_gaps`` of the
    first maps, and ``rounding_loss1_gap`` is the first loss's gap that
    rounding alone gives. Leaves whose reference gradient is under a
    thousandth of the median leaf's (a bias ahead of a BatchNorm) move
    under Adam by round-off alone and are left out of the change."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in zip(prog["losses"], ref["losses"])]
    gnorm = {k: v.double().norm().item() for k, v in ref["grad"].items()}
    floor = 1e-3 * statistics.median(gnorm.values())
    moved = [k for k, v in gnorm.items() if v >= floor]
    grads = leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    grad, grad_leaf = _worst(grads)
    changes = leaf_gaps(prog["change"], ref["change"], moved)
    change, change_leaf = _worst(changes)
    stats_gaps = leaf_gaps(prog["stats"], ref["stats"], list(ref["stats"]))
    stats, stats_leaf = _worst(stats_gaps)
    out = {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": grad,
        "grad_median_gap": statistics.median(grads.values()),
        "change_gap": change,
        "change_median_gap": statistics.median(changes.values()),
        "stats_gap": stats,
        "stats_median_gap": statistics.median(stats_gaps.values()),
        "leaves": {"grad": grad_leaf, "change": change_leaf, "stats": stats_leaf, "left_out": sorted(set(gnorm) - set(moved))},
    }
    if rounded is not None:
        maps = [map_gaps(p, r, b) for p, r, b in zip(prog["disp1"], ref["disp1"], rounded["disp1"])]
        out.update({f"disp1_{k[len('disp_'):]}": v for k, v in over_frames(maps).items()})
        out["rounding_loss1_gap"] = abs(rounded["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return out


def state_change(after: dict, before: dict) -> dict:
    """Each leaf of ``after`` less the same leaf of ``before``, in float64."""
    return {k: (after[k].double() - before[k].double()) for k in after}

