"""Training and evaluation steps (port of ``leastereo_tpu/train/step.py``;
reference ``train.py:130-178``).

The state of a run is the model's parameters and buffers, the optimizer and
the count of updates taken: no ``TrainState`` object. The learning rate of
update ``k`` (0-based) is ``schedule(k)``, as optax's count gives it, so with
warmup the first update has lr 0.

Data-parallel (``mesh``, as the JAX steps over a mesh's ``data`` axis): the
batch is this rank's rows of the global batch, BatchNorm normalises with the
global batch's statistics (sync-BN, ``ops/convbr.py``), the loss is the
global masked mean (this rank's sum over the all-reduced valid-pixel count,
so ranks with different numbers of valid pixels weigh as in one batch), the
gradients are summed over the data group in one all_reduce, and the metrics
are global. The replicas start equal (``parallel.broadcast_module``) and
stay so: every rank applies the same summed gradient.

Disparity-sharded (a mesh with ``disp > 1``, as the JAX step under
``cost_volume_pspec=("data", "disp")``): the model's cost volume is sharded
over the mesh's disp ranks (``model.mesh``), and every disp rank of a data
row holds that row's batch and, after the sharded head, the same whole map.
So the valid-pixel count and the metrics reduce over the data group only,
and the loss is counted once (the head's sums pass each rank its own
gradient, ``ops/softargmin.py``). The matching net's BatchNorm takes its
statistics over both axes (each rank holds only its planes); the feature
net, replicated over disp, keeps the data group, whose ranks hold distinct
rows. (Over both axes each row would count ``disp`` times, in the sums and
in the count alike, so its statistics and the summed gradients would come
out the same, at ``disp`` times the traffic.) Each rank's gradients are its
partial sums (its rows, its planes), summed over both axes in one
all_reduce.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Iterable

import torch

from ..ops.convbr import set_bn_group
from ..parallel.mesh import Mesh, all_reduce, all_reduce_grads
from ..utils.tracing import span
from .losses import edge_aware_smoothness_loss, masked_smooth_l1, validity_mask
from .metrics import epe, three_px_error

__all__ = ["make_lr_schedule", "make_optimizer", "train_step", "eval_step", "global_metrics"]


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


def _data_group(mesh: Mesh | None):
    return None if mesh is None else mesh.data_group


def _step_groups(model: torch.nn.Module, mesh: Mesh | None):
    """Set the BatchNorm groups of a train step of ``model`` over ``mesh``
    (module docstring) and return the group its gradients sum over."""
    if mesh is None or mesh.disp == 1:
        set_bn_group(model, _data_group(mesh))
        return _data_group(mesh)
    part = model.disp_partition()
    if (part.world, part.group) != (mesh.disp, mesh.disp_group):
        raise ValueError(
            f"a train step over a mesh with disp={mesh.disp} needs a model whose cost volume is sharded over "
            "its disp ranks: cost_volume_pspec=('data', 'disp') and model.mesh = mesh"
        )
    set_bn_group(model.feature, mesh.data_group)
    set_bn_group(model.matching, mesh.group)
    return mesh.group


def global_count(mask: torch.Tensor, group) -> torch.Tensor:
    """The number of ``True`` in ``mask`` summed over ``group`` (float)."""
    return all_reduce(mask.sum().float(), group)


def global_metrics(
    disp: torch.Tensor, target: torch.Tensor, maxdisp: int, group, loss: torch.Tensor | None = None
) -> dict[str, float]:
    """EPE and 3-px error over the rows of every rank of ``group`` (and the
    global ``loss``, already this rank's share of it), in one all_reduce:
    each rank's metric weighs by its share of the global valid pixels."""
    out = {} if loss is None else {"loss": loss.detach()}
    if group is None:
        out.update(epe=epe(disp, target, maxdisp), err3=three_px_error(disp, target, maxdisp))
        return {k: v.item() for k, v in out.items()}
    mask = validity_mask(target, maxdisp)
    share = mask.sum() / global_count(mask, group).clamp(min=1)
    out.update(epe=epe(disp, target, maxdisp) * share, err3=(1.0 - three_px_error(disp, target, maxdisp)) * share)
    v = dict(zip(out, all_reduce(torch.stack(list(out.values())).float(), group).tolist()))
    v["err3"] = 1.0 - v["err3"]
    return v


def train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: dict,
    maxdisp: int,
    lr: float,
    edge_loss_w: float = 0.0,
    mesh: Mesh | None = None,
) -> dict[str, float]:
    """One update at learning rate ``lr`` on a batch of NHWC ``left``,
    ``right`` and ``(B, H, W)`` ``disparity``: the train-mode forward, the
    masked smooth-L1 (plus ``edge_loss_w`` times the edge-aware term), the
    backward and the optimizer step. Returns the loss, and the EPE and
    3-px error of the train-mode disparity, as floats.

    With ``mesh``, ``batch`` is this rank's rows and the step is the data-
    parallel, and with ``mesh.disp > 1`` the disparity-sharded, step
    (module docstring): the returned numbers are those of the global batch."""
    with span("step"):
        model.train()
        grad_group = _step_groups(model, mesh)
        group = _data_group(mesh)
        with span("h2d"):
            left, right, target = _to_model(batch, model)
        for g in optimizer.param_groups:
            g["lr"] = lr
        count = None if group is None else global_count(validity_mask(target, maxdisp), group)
        disp = model(left, right).float()
        with span("loss"):
            loss = masked_smooth_l1(disp, target, maxdisp, count)
            if edge_loss_w:
                loss = loss + edge_loss_w * edge_aware_smoothness_loss(disp, target, maxdisp, count)
        with span("backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        all_reduce_grads([p for g in optimizer.param_groups for p in g["params"]], grad_group)
        with span("optimizer"):
            optimizer.step()
        with span("metrics"):
            return global_metrics(disp.detach(), target, maxdisp, group, loss)


def eval_step(
    model: torch.nn.Module, batch: dict, maxdisp: int, mesh: Mesh | None = None
) -> tuple[torch.Tensor, dict[str, float]]:
    """Eval-mode disparity of a batch and its EPE and 3-px error; with
    ``mesh``, of this rank's rows, and the metrics of the global batch. A
    disparity-sharded model (``mesh.disp > 1``) runs its sharded forward on
    every disp rank, each of which returns the whole map."""
    model.eval()
    left, right, target = _to_model(batch, model)
    with torch.inference_mode():
        disp = model(left, right).float()
        metrics = global_metrics(disp, target, maxdisp, _data_group(mesh))
    return disp, metrics
