"""Bilevel (DARTS first-order) search optimization (port of
``leastereo_tpu/search/bilevel.py``; reference ``search.py:75-100,155-211``).

SGD (cosine-per-iteration lr, momentum 0.9, coupled L2 3e-4) on the network
weights over the ``search_weights`` split, and Adam (1e-3, coupled L2 1e-3)
on the arch parameters (alphas, betas) over the ``search_arch`` split,
alternating one step each. The reference keeps four optimizers
(feature/matching x weight/arch) with identical hyperparameters; here each
side is one torch optimizer over its partition
(``AutoStereoSupernet.weight_parameters()`` / ``arch_parameters()``).

A run's state is the model's parameters and buffers, the two optimizers and
the count of weight steps taken: no ``SearchState``. The lr of weight step
``k`` (0-based) is ``schedule(k)``, as optax's count gives it; arch steps do
not advance the count. Both steps run the train-mode forward, so both update
the BN running statistics, as the JAX steps do.

Data-parallel (``mesh``): the reductions of ``train/step.py``. The batch is
this rank's rows; the supernet's BN syncs over the data group, the loss is
this rank's sum over the global count of ``target < maxdisp``, the stepped
side's gradients are summed over the group, and the metrics are global.
The ranks of the mesh's ``disp`` axis replicate the step: the supernet's
volume is not sharded, as in the JAX search over such a mesh.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

from ..ops.convbr import set_bn_group
from ..parallel.mesh import Mesh, all_reduce_grads
from ..train.losses import smooth_l1
from ..train.step import global_count, global_metrics

__all__ = [
    "cosine_iter_schedule",
    "make_weight_optimizer",
    "make_arch_optimizer",
    "search_loss",
    "weight_step",
    "arch_step",
]


def cosine_iter_schedule(base_lr: float, total_iters: int, min_lr: float = 1e-3) -> Callable[[int], float]:
    """Per-iteration cosine with a floor: lr = base/2 * (1 + cos(pi*T/N)),
    clamped at min_lr (reference utils/lr_scheduler.py:48-58)."""

    def schedule(t: int) -> float:
        return max(0.5 * base_lr * (1.0 + math.cos(math.pi * t / total_iters)), min_lr)

    return schedule


def make_weight_optimizer(
    params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9, weight_decay: float = 3e-4
) -> torch.optim.SGD:
    """SGD with momentum over the weights. Torch's ``weight_decay`` adds
    ``wd * p`` to the gradient before the momentum: the coupled L2 of
    ``optax.chain(add_decayed_weights(wd), sgd)``. The lr is set per step
    (:func:`weight_step`)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def make_arch_optimizer(
    params: Iterable[torch.nn.Parameter], lr: float = 1e-3, weight_decay: float = 1e-3
) -> torch.optim.Adam:
    """Adam(0.9, 0.999, eps 1e-8) with coupled L2 over alphas and betas:
    torch's ``Adam(weight_decay=...)``, not ``AdamW``, as
    ``optax.chain(add_decayed_weights(wd), adam)``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def search_loss(
    disp: torch.Tensor, target: torch.Tensor, maxdisp: int, count: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean smooth-L1 over ``target < maxdisp``, with no lower bound on the
    target, unlike the retrain loss (reference search.py:170-183). ``count``
    replaces this batch's count as the divisor (the global count)."""
    mask = target < maxdisp
    return (smooth_l1(disp - target) * mask).sum() / (mask.sum() if count is None else count).clamp(min=1)


def _step(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, batch: dict, maxdisp: int, mesh: Mesh | None
) -> dict[str, float]:
    """Train-mode forward, search loss, a backward into the optimizer's
    parameters only, and its update."""
    model.train()
    group = None if mesh is None else mesh.data_group
    set_bn_group(model, group)
    device = next(model.parameters()).device
    left, right, target = (torch.as_tensor(batch[k]).to(device) for k in ("left", "right", "disparity"))
    count = None if group is None else global_count(target < maxdisp, group)
    disp = model(left, right).float()
    loss = search_loss(disp, target, maxdisp, count)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # No gradient is left for the other side's optimizer to apply.
    model.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    all_reduce_grads(params, group)
    optimizer.step()
    return global_metrics(disp.detach(), target, maxdisp, group, loss)


def weight_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    maxdisp: int,
    lr: float,
    mesh: Mesh | None = None,
) -> dict[str, float]:
    """One weight update at learning rate ``lr`` on a batch of NHWC ``left``,
    ``right`` and ``(B, H, W)`` ``disparity``. Alphas and betas do not move.
    Returns the loss, EPE and 3-px error of the train-mode disparity; with
    ``mesh``, the data-parallel step on this rank's rows (module docstring)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return _step(model, optimizer, batch, maxdisp, mesh)


def arch_step(
    model: torch.nn.Module, optimizer: torch.optim.Optimizer, batch: dict, maxdisp: int, mesh: Mesh | None = None
) -> dict[str, float]:
    """One arch update (alphas, betas) on a batch; the weights do not move."""
    return _step(model, optimizer, batch, maxdisp, mesh)
