"""Torch ``.pth`` checkpoints of the port's model: load one (``--checkpoint``,
``--resume``), and save and find the training driver's.

The port's module names are the reference's (``utils/weights.py``), so a
file the reference wrote loads without a conversion step: the JAX package
needs ``cli/convert.py`` and an orbax directory for the same file. Reference
files wrap the weights as ``{"state_dict": ...}`` with ``module.`` prefixes
from ``DataParallel`` (reference ``predict.py:55-65``) and carry the unused
``last_*`` heads, which the port's model does not build.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import torch
import torch.nn as nn

__all__ = ["load_state_dict_file", "save_checkpoint", "latest_checkpoint"]

_PREFIX = "module."


def load_state_dict_file(path: str, model: nn.Module, tolerant: bool = False) -> list[str]:
    """Copy every tensor ``model`` needs from the file at ``path``.

    Keys the model lacks are ignored. A missing tensor raises ``KeyError``
    and a shape mismatch ``ValueError``, naming the tensor; the model is left
    untouched then. BatchNorm ``num_batches_tracked`` counters, which some
    reference files lack, keep the model's value.

    ``tolerant=True`` (``--resume``; ``tolerant_merge`` of the JAX package,
    reference ``utils/copy_state_dict.py``) adopts every tensor whose name
    and shape match and keeps the model's value elsewhere, without raising.
    Returns the names that kept the model's value.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path}: not a state_dict (got {type(obj).__name__})")
    found = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v for k, v in obj.items()}
    state, kept = {}, []
    for name, want in model.state_dict().items():
        got = found.get(name)
        if got is None and name.endswith("num_batches_tracked"):
            got = want
        fits = torch.is_tensor(got) and got.shape == want.shape
        if tolerant and not fits:
            got = want
            kept.append(name)
        elif got is None:
            raise KeyError(f"{path}: checkpoint lacks tensor {name!r}")
        elif not fits:
            shape = tuple(got.shape) if torch.is_tensor(got) else type(got).__name__
            raise ValueError(f"{path}: {name!r} has shape {shape}, the model needs {tuple(want.shape)}")
        state[name] = got
    model.load_state_dict(state)
    return kept


def save_checkpoint(directory: str, epoch: int, model: nn.Module) -> str:
    """Write ``directory/<epoch>.pth`` as ``{"state_dict", "epoch"}``, the
    layout :func:`load_state_dict_file` reads (the JAX checkpoint likewise
    holds the weights and BN statistics, no optimizer state). Returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{epoch}.pth")
    torch.save({"state_dict": model.state_dict(), "epoch": epoch}, path)
    return path


def latest_checkpoint(directory: str) -> str | None:
    """The ``<epoch>.pth`` of the highest epoch in ``directory``, or ``None``."""
    if not os.path.isdir(directory):
        return None
    epochs = [int(f[:-4]) for f in os.listdir(directory) if f.endswith(".pth") and f[:-4].isdigit()]
    return os.path.join(directory, f"{max(epochs)}.pth") if epochs else None
