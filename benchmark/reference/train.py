"""The reference's train steps: autograd through the plain model in train
mode, the masked smooth-L1 loss of the published fine-tune, and
``torch.optim.Adam``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .compare import state_change
from .model import build_reference, exact_float32

__all__ = ["masked_loss", "running_stats", "reference_steps"]


def masked_loss(disp: torch.Tensor, target: torch.Tensor, maxdisp: int) -> torch.Tensor:
    """Smooth L1 over the pixels whose target lies in (0.001, maxdisp)."""
    mask = (target > 0.001) & (target < maxdisp)
    return F.smooth_l1_loss(disp[mask], target[mask], reduction="mean")


def running_stats(module: torch.nn.Module) -> dict:
    """A copy of every BatchNorm running mean and variance."""
    return {k: v.detach().clone() for k, v in module.named_buffers() if k.endswith(("running_mean", "running_var"))}


def reference_steps(cfg: dict, state: dict, batches, lr: float, device, precision: str = "float32",
                    adam: dict | None = None) -> dict:
    """Train steps of the reference from ``state`` on ``batches`` (each
    ``(left, right, disparity)``, NHWC views): the loss of each, the first
    gradient, the first step's train-mode disparity, and each parameter's
    and running statistic's change. ``adam``, by parameter name, is
    Adam's state to start from (its step count and moments)."""
    ref = build_reference(cfg, state, device, precision, train=True)
    opt = torch.optim.Adam(ref.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if adam:
        for name, p in ref.named_parameters():
            opt.state[p] = {k: v.clone() for k, v in adam[name].items()}
    params0 = {k: v.detach().clone() for k, v in ref.named_parameters()}
    stats0 = running_stats(ref)
    losses, grad, disp1 = [], None, None
    with exact_float32():
        for left, right, target in batches:
            disp = ref(left, right)
            if disp1 is None:
                disp1 = disp.detach().cpu().numpy()
            loss = masked_loss(disp, target, cfg["maxdisp"])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if grad is None:
                grad = {k: p.grad.detach().clone() for k, p in ref.named_parameters()}
            opt.step()
            losses.append(loss.item())
    params = {k: v.detach() for k, v in ref.named_parameters()}
    return {"losses": losses, "grad": grad, "disp1": disp1, "change": state_change(params, params0),
            "stats": state_change(running_stats(ref), stats0)}
