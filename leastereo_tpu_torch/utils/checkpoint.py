"""Load a torch ``.pth`` file into the port's model (``--checkpoint``).

The port's module names are the reference's (``utils/weights.py``), so a
file the reference wrote loads without a conversion step: the JAX package
needs ``cli/convert.py`` and an orbax directory for the same file. Reference
files wrap the weights as ``{"state_dict": ...}`` with ``module.`` prefixes
from ``DataParallel`` (reference ``predict.py:55-65``) and carry the unused
``last_*`` heads, which the port's model does not build.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn as nn

__all__ = ["load_state_dict_file"]

_PREFIX = "module."


def load_state_dict_file(path: str, model: nn.Module) -> None:
    """Copy every tensor ``model`` needs from the file at ``path``.

    Keys the model lacks are ignored. A missing tensor raises ``KeyError``
    and a shape mismatch ``ValueError``, naming the tensor; the model is left
    untouched then. BatchNorm ``num_batches_tracked`` counters, which some
    reference files lack, keep the model's value.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path}: not a state_dict (got {type(obj).__name__})")
    found = {k[len(_PREFIX):] if k.startswith(_PREFIX) else k: v for k, v in obj.items()}
    state = {}
    for name, want in model.state_dict().items():
        got = found.get(name)
        if got is None and name.endswith("num_batches_tracked"):
            got = want
        if got is None:
            raise KeyError(f"{path}: checkpoint lacks tensor {name!r}")
        if not torch.is_tensor(got) or got.shape != want.shape:
            shape = tuple(got.shape) if torch.is_tensor(got) else type(got).__name__
            raise ValueError(f"{path}: {name!r} has shape {shape}, the model needs {tuple(want.shape)}")
        state[name] = got
    model.load_state_dict(state)
