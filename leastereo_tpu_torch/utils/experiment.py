"""Experiment directory management + early stopping (a copy of
``leastereo_tpu/utils/experiment.py``, pure Python).

Replaces reference ``utils/saver.py`` (experiment dir layout, refuses to
reuse an experiment name, dumps the run parameters) and
``utils/early_stopping.py`` (patience/delta on the validation metric with
best + periodic checkpoints).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

__all__ = ["ExperimentSaver", "EarlyStopping"]


class ExperimentSaver:
    """run/{dataset}-{stage}/{experiment}/{logs,checkpoints} layout
    (reference utils/saver.py:16-41)."""

    def __init__(self, run_root: str, dataset: str, stage: str, experiment: str, resume: bool = False):
        self.experiment_dir = os.path.join(run_root, f"{dataset}-{stage}", experiment)
        self.logs_dir = os.path.join(self.experiment_dir, "logs")
        self.checkpoint_dir = os.path.join(self.experiment_dir, "checkpoints")
        if os.path.exists(self.experiment_dir) and not resume:
            raise FileExistsError(
                f"experiment {self.experiment_dir} already exists; "
                "pass a new --experiment name or resume"
            )
        os.makedirs(self.logs_dir, exist_ok=True)
        os.makedirs(self.checkpoint_dir, exist_ok=True)

    def save_parameters(self, args: Any) -> None:
        """Dump run configuration (reference utils/saver.py:35-41)."""
        if dataclasses.is_dataclass(args):
            payload = dataclasses.asdict(args)
        elif hasattr(args, "__dict__"):
            payload = vars(args)
        else:
            payload = dict(args)
        with open(os.path.join(self.experiment_dir, "parameters.json"), "w") as f:
            json.dump({k: repr(v) if not _jsonable(v) else v for k, v in payload.items()}, f, indent=2)


def _jsonable(v) -> bool:
    return isinstance(v, (str, int, float, bool, type(None), list, dict, tuple))


class EarlyStopping:
    """Stop when the validation metric hasn't improved by ``delta`` for
    ``patience`` evaluations; save best on improvement and a periodic
    checkpoint every ``period`` (reference utils/early_stopping.py:5-53)."""

    def __init__(
        self,
        patience: int = 1500,
        delta: float = 0.001,
        period: int = 20,
        save_fn: Callable[[str, int], None] | None = None,
    ):
        self.patience = patience
        self.delta = delta
        self.period = period
        self.save_fn = save_fn
        self.best: float | None = None
        self.counter = 0
        self.stopped = False
        self.best_epoch: int | None = None

    def __call__(self, metric: float, epoch: int) -> bool:
        """Returns True if training should stop."""
        improved = self.best is None or metric < self.best - self.delta
        if improved:
            self.best = metric
            self.best_epoch = epoch
            self.counter = 0
            if self.save_fn:
                self.save_fn("best", epoch)
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.stopped = True
        if self.period and epoch % self.period == 0 and self.save_fn:
            self.save_fn("periodic", epoch)
        return self.stopped
