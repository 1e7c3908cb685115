"""Wrapper around the external ``midd_eval`` Middlebury evaluator binary.

Reference ``utils/estimate_classic.py:17-52`` shells out to a closed-source
``midd_eval``/``cmm`` binary per sample and averages its d_err / t_err /
mean_err columns. Gated: raises a clear error when the binary is absent.

A copy of ``leastereo_tpu/utils/classic_eval.py``.
"""

from __future__ import annotations

import os
import shutil
import subprocess

__all__ = ["midd_eval_sample", "midd_eval_average"]


def _binary(name: str = "midd_eval") -> str:
    path = shutil.which(name)
    if path is None:
        raise FileNotFoundError(
            f"external evaluator {name!r} not on PATH (closed-source binary; "
            "see reference utils/estimate_classic.py)"
        )
    return path


def midd_eval_sample(pred_path: str, gt_path: str, binary: str = "midd_eval") -> dict:
    """Run the evaluator on one (prediction, GT) pair -> parsed metrics."""
    out = subprocess.run(
        [_binary(binary), pred_path, gt_path], capture_output=True, text=True, check=True
    ).stdout
    fields = out.split()
    if len(fields) < 3:
        raise ValueError(f"unexpected {binary} output: {out!r}")
    d_err, t_err, mean_err = (float(x) for x in fields[:3])
    return {"d_err": d_err, "t_err": t_err, "mean_err": mean_err}


def midd_eval_average(pairs, binary: str = "midd_eval") -> dict:
    """Average metrics over (pred, gt) path pairs
    (reference estimate_classic.py:33-52)."""
    sums = {"d_err": 0.0, "t_err": 0.0, "mean_err": 0.0}
    n = 0
    for pred, gt in pairs:
        m = midd_eval_sample(pred, gt, binary)
        for k in sums:
            sums[k] += m[k]
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
