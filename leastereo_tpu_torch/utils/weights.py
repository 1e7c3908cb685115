"""Load the JAX package's weights into the port.

``state_dict_from_jax`` inverts ``leastereo_tpu/utils/torch_convert.py``: the
flax ``{"params", "batch_stats"}`` tree (numpy arrays) becomes the port's
``state_dict``. The port's module names are the reference's, so

* ``cell_N`` -> ``cells.N``, ``op_K`` -> ``_ops.K``,
  ``skip_conv_4`` / ``skip_conv_8`` -> ``conv1`` / ``conv2``;
* ``conv/kernel`` DHWIO -> ``conv.weight`` OIDHW (HWIO -> OIHW in 2-D);
* ``bn`` ``scale/bias/mean/var`` -> ``bn.weight/bias/running_mean/running_var``.

The JAX model's default ``PackedMatchingNet`` has the same tree as
``MatchingNet``, so one mapping serves both.

``supernet_state_dict_from_jax`` does the same for the search supernet
(``AutoStereoSupernet``): ``cell_{layer}_{level}`` -> ``cells.{flat index}``
in the reference's order, ``op_{e}_conv`` -> ``_ops.{e}._ops.1``, and the
``alphas`` / ``betas`` leaves -> ``feature.alphas`` etc.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "supernet_state_dict_from_jax"]

_SKIP_NAMES = {"skip_conv_4": "conv1", "skip_conv_8": "conv2"}
_BN_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _module_name(path: tuple[str, ...]) -> str:
    out = []
    for p in path:
        if p.startswith("cell_"):
            out.append(f"cells.{p[5:]}")
        elif p in _SKIP_NAMES:
            out.append(_SKIP_NAMES[p])
        elif p.startswith("op_"):
            out.append(f"_ops.{p[3:]}")
        else:
            out.append(p)
    return ".".join(out)


def _supernet_module_name(path: tuple[str, ...]) -> str:
    out = []
    for p in path:
        if p.startswith("cell_"):
            # Cells per layer, in increasing level: 2, 3, then 4 (levels
            # 0..min(layer + 1, 3)), whatever the number of layers.
            layer, level = map(int, p[5:].split("_"))
            out.append(f"cells.{sum(min(l + 2, 4) for l in range(layer)) + level}")
        elif p.startswith("op_") and p.endswith("_conv"):
            # PRIMITIVES index 1 is conv_3x3; index 0 (skip) has no weights.
            out.append(f"_ops.{p[3:-5]}._ops.1")
        else:
            out.append(p)
    return ".".join(out)


def _convert(variables: Mapping[str, Any], module_name) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for (collection, *mods, leaf), value in _flatten(variables):
        a = np.asarray(value, dtype=np.float32)
        if collection == "params" and leaf in ("alphas", "betas"):
            sd[f"{module_name(tuple(mods))}.{leaf}"] = torch.from_numpy(a.copy())
            continue
        prefix = module_name(tuple(mods[:-1]))
        prefix = prefix + "." if prefix else ""
        if mods[-1] == "conv" and leaf == "kernel":
            # DHWIO -> OIDHW / HWIO -> OIHW
            perm = (4, 3, 0, 1, 2) if a.ndim == 5 else (3, 2, 0, 1)
            sd[prefix + "conv.weight"] = torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))
        elif mods[-1] == "bn" and (collection, leaf) in _BN_LEAVES:
            sd[prefix + "bn." + _BN_LEAVES[(collection, leaf)]] = torch.from_numpy(a.copy())
            sd.setdefault(prefix + "bn.num_batches_tracked", torch.tensor(0, dtype=torch.long))
        else:
            raise KeyError(f"unknown variable {collection}/{'/'.join(mods)}/{leaf}")
    return sd


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from JAX ``variables`` (``model.init`` output,
    leaves as numpy or JAX arrays). BatchNorm ``num_batches_tracked`` counters,
    which the flax tree lacks, are set to 0 so the result loads strictly."""
    return _convert(variables, _module_name)


def supernet_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``AutoStereoSupernet`` ``state_dict`` from the JAX
    ``AutoStereoSupernet``'s ``variables``, loadable with ``strict=True``."""
    return _convert(variables, _supernet_module_name)
