"""Training and evaluation steps (port of ``leastereo_tpu/train/step.py``;
reference ``train.py:130-178``).

The state of a run is the model's parameters and buffers, the optimizer and
the count of updates taken: no ``TrainState`` object. The learning rate of
update ``k`` (0-based) is ``schedule(k)``, as optax's count gives it, so with
warmup the first update has lr 0.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

from .losses import edge_aware_smoothness_loss, masked_smooth_l1
from .metrics import epe, three_px_error

__all__ = ["make_lr_schedule", "make_optimizer", "train_step", "eval_step"]


def make_lr_schedule(
    mode: str,
    base_lr: float,
    num_epochs: int,
    steps_per_epoch: int,
    *,
    milestones: tuple[int, ...] = (),
    gamma: float = 0.5,
    lr_step: int = 0,
    warmup_epochs: int = 0,
    min_lr: float | None = None,
) -> Callable[[int], float]:
    """Per-update LR ``t -> lr`` (reference ``utils/lr_scheduler.py:14-75``).

    Modes (T = update count, N = num_epochs * steps_per_epoch):

    * ``cos``       ``0.5 * lr * (1 + cos(pi * T / N))``
    * ``poly``      ``lr * (1 - T/N)^0.9``
    * ``step``      ``lr * 0.1^(epoch // lr_step)``
    * ``multistep`` torch MultiStepLR (reference train.py:80): ``gamma`` per
      epoch milestone passed, milestones scaled to updates

    The ``min_lr`` floor comes BEFORE the linear warmup ramp
    (``lr * T / warmup_iters`` for ``T < warmup_epochs * steps_per_epoch``),
    as in the reference, so warmup scales the floored lr.
    """
    n = max(num_epochs * steps_per_epoch, 1)
    warmup_iters = warmup_epochs * steps_per_epoch
    if mode == "step" and not lr_step:
        raise ValueError("mode 'step' requires lr_step > 0")
    if mode not in ("cos", "poly", "step", "multistep"):
        raise ValueError(f"unknown lr scheduler {mode!r}")
    boundaries = {int(m) * steps_per_epoch for m in milestones}

    def schedule(t: int) -> float:
        if mode == "cos":
            lr = 0.5 * base_lr * (1.0 + math.cos(math.pi * t / n))
        elif mode == "poly":
            lr = base_lr * max(1.0 - t / n, 0.0) ** 0.9
        elif mode == "step":
            epoch = t // max(steps_per_epoch, 1)
            lr = base_lr * 0.1 ** (epoch // lr_step)
        else:
            lr = base_lr * gamma ** sum(t >= b for b in boundaries)
        if min_lr is not None:
            lr = max(lr, min_lr)
        if t < warmup_iters:
            lr = lr * t / warmup_iters
        return lr

    return schedule


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    solver: str = "adam",
    lr: float = 1e-3,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """Adam(0.9, 0.999, eps 1e-8) or SGD(momentum) (reference train.py:75-78).

    ``weight_decay`` adds ``wd * p`` to the gradient before the moments
    (coupled L2), as ``optax.chain(add_decayed_weights(wd), adam)`` of the
    JAX package does: torch's ``Adam(weight_decay=wd)``, not ``AdamW``."""
    if solver == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if solver == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    raise ValueError(f"unknown solver {solver}")


def _to_model(batch: dict, model: torch.nn.Module) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    device = next(model.parameters()).device
    return tuple(torch.as_tensor(batch[k]).to(device) for k in ("left", "right", "disparity"))


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    maxdisp: int,
    lr: float,
    edge_loss_w: float = 0.0,
) -> dict[str, float]:
    """One update at learning rate ``lr`` on a batch of NHWC ``left``,
    ``right`` and ``(B, H, W)`` ``disparity``: the train-mode forward, the
    masked smooth-L1 (plus ``edge_loss_w`` times the edge-aware term), the
    backward and the optimizer step. Returns the loss, and the EPE and
    3-px error of the train-mode disparity, as floats."""
    model.train()
    left, right, target = _to_model(batch, model)
    for group in optimizer.param_groups:
        group["lr"] = lr
    disp = model(left, right).float()
    loss = masked_smooth_l1(disp, target, maxdisp)
    if edge_loss_w:
        loss = loss + edge_loss_w * edge_aware_smoothness_loss(disp, target, maxdisp)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    disp = disp.detach()
    return {
        "loss": loss.item(),
        "epe": epe(disp, target, maxdisp).item(),
        "err3": three_px_error(disp, target, maxdisp).item(),
    }


def eval_step(model: torch.nn.Module, batch: dict, maxdisp: int) -> tuple[torch.Tensor, dict[str, float]]:
    """Eval-mode disparity of a batch and its EPE and 3-px error."""
    model.eval()
    left, right, target = _to_model(batch, model)
    with torch.inference_mode():
        disp = model(left, right).float()
        metrics = {"epe": epe(disp, target, maxdisp).item(), "err3": three_px_error(disp, target, maxdisp).item()}
    return disp, metrics
