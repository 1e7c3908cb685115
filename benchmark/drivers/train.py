"""Fine-tune steps through ``train.step.train_step`` with the optimizer of
``train.step.make_optimizer``: batches drawn in seeded order from a bank of
seeded pairs with ground-truth disparity, held in host memory."""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from ..common import Phases, make_pairs, make_state, standardize
from ..program import build_model
from ..reference.compare import state_change, train_gaps
from ..reference.flops import step_flops
from ..reference.train import reference_steps, running_stats
from ..trace import Spans

__all__ = ["Train", "Driver"]


class Train:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from leastereo_tpu_torch.train.step import make_optimizer, train_step

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.train_step = train_step
        self.phases = Phases(self.device)
        self.state = make_state(cfg, seed, self.device, self.phases)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.model = build_model(cfg, self.state, self.device, train=True)
        self.opt = make_optimizer(self.model.parameters(), "adam", traffic["lr"])
        self.phases.mark("model")
        h, w = traffic["crop"]
        left, right, disp = make_pairs(traffic["bank"], h, w, cfg["maxdisp"], seed, 2, self.device)
        self.left = standardize(left).cpu().numpy()
        self.right = standardize(right).cpu().numpy()
        self.disp = disp.cpu().numpy()
        del left, right, disp
        rng = np.random.default_rng([seed % 2**63, 5])
        self.order = np.concatenate([rng.permutation(traffic["bank"]) for _ in range(traffic["epochs_drawn"])])
        self.steps, self.losses, self.failed = 0, [], 0
        self.units_per_step = traffic["batch"]
        lo, hi = traffic["window_checked_step"]
        self.window_step = traffic["checked_steps"] + int(np.random.default_rng([seed % 2**63, 6]).integers(lo, hi))
        self.window = None
        self.phases.mark("bank")
        self._checked_steps()
        self.phases.mark("checked_steps")

    def batch(self, j: int) -> dict:
        n = self.units_per_step
        rows = np.take(self.order, range(j * n, (j + 1) * n), mode="wrap")
        return {"left": self.left[rows], "right": self.right[rows], "disparity": self.disp[rows]}

    def step(self) -> None:
        if self.steps == self.window_step:
            self.window = self._watched_step()
            return
        self._step()

    def _step(self) -> float:
        out = self.train_step(self.model, self.opt, self.batch(self.steps), self.cfg["maxdisp"], self.traffic["lr"])
        self.losses.append(out["loss"])
        self.failed += not math.isfinite(out["loss"])
        self.steps += 1
        return out["loss"]

    def _watched_step(self) -> dict:
        """A step of the window that the reference repeats from the
        program's own state before it: the parameters and running
        statistics (``start``), Adam's state (``adam``) and the batch's
        index; then the step's loss, train-mode disparity, gradient (from
        Adam's first moment before and after) and changes."""
        names = dict(self.model.named_parameters())
        start = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        adam = {k: {s: v.clone() for s, v in self.opt.state[p].items()} for k, p in names.items()}
        maps = []
        hook = self.model.register_forward_hook(lambda m, args, out: maps.append(out.detach().float().cpu().numpy()))
        batch = self.steps
        loss = self._step()
        hook.remove()
        beta1 = self.opt.param_groups[0]["betas"][0]
        grad = {k: (self.opt.state[p]["exp_avg"] - beta1 * adam[k]["exp_avg"]) / (1 - beta1) for k, p in names.items()}
        stats = running_stats(self.model)
        return {"batch": batch, "start": start, "adam": adam, "losses": [loss], "disp1": maps[0], "grad": grad,
                "change": state_change({k: p.detach() for k, p in names.items()}, {k: start[k] for k in names}),
                "stats": state_change(stats, {k: start[k] for k in stats})}

    def _checked_steps(self) -> None:
        """The first steps, which the reference follows: they go through the
        window's own call on rows that all differ, and warm its shapes. The
        first step's train-mode disparity is read at the model's output; the
        first gradient from Adam's first moment after step 1
        (``(1 - beta1) * g``); the change of every parameter and running
        statistic after the last. A step of the window is checked too
        (``_watched_step``), drawn from the seed among the traffic's
        ``window_checked_step`` range of the window's steps."""
        names = dict(self.model.named_parameters())
        stats0 = running_stats(self.model)
        first = []
        hook = self.model.register_forward_hook(lambda m, args, out: first.append(out.detach().float().cpu().numpy()))
        self.step()
        hook.remove()
        self.disp1 = first[0]
        beta1 = self.opt.param_groups[0]["betas"][0]
        self.grad = {k: self.opt.state[p]["exp_avg"].detach().clone() / (1 - beta1) for k, p in names.items()}
        for _ in range(self.traffic["checked_steps"] - 1):
            self.step()
        params = {k: p.detach() for k, p in names.items()}
        self.change = state_change(params, {k: self.state[k] for k in names})
        self.stats = state_change(running_stats(self.model), stats0)
        self.checked_losses = list(self.losses)

    def start_window(self) -> None:
        self.failed = 0

    def instrument(self, spans: Spans) -> list:
        """CUDA events: the train-mode forward (the model's pre- and
        post-hook), and from its end to the optimizer's step (the loss and
        the backward)."""
        return [
            self.model.register_forward_pre_hook(lambda *_: spans.start_event("train_forward")),
            self.model.register_forward_hook(lambda *_: _forward_done(spans)),
            self.opt.register_step_pre_hook(lambda *_: spans.end_event("train_backward", "backward")),
        ]

    def trace_facts(self) -> dict:
        h, w = self.traffic["crop"]
        return {"flops_per_unit": step_flops(self.cfg, self.units_per_step, h, w) / self.units_per_step}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.opt
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reach_window_step(self) -> None:
        """Steps on, after a window too short to reach its watched step."""
        while self.window is None:
            self.step()

    def reference(self, precision: str = "float32", steps: int | None = None) -> dict:
        """The reference's checked steps (or the first ``steps``) on the same rows."""
        batches = []
        for j in range(self.traffic["checked_steps"] if steps is None else steps):
            b = self.batch(j)
            batches.append(tuple(torch.from_numpy(b[k]).to(self.device) for k in ("left", "right", "disparity")))
        return reference_steps(self.cfg, self.state, batches, self.traffic["lr"], self.device, precision)

    def window_reference(self, precision: str = "float32") -> dict:
        """The reference's step from the program's state before the watched
        step, on the same rows."""
        w, b = self.window, self.batch(self.window["batch"])
        batch = tuple(torch.from_numpy(b[k]).to(self.device) for k in ("left", "right", "disparity"))
        return reference_steps(self.cfg, w["start"], [batch], self.traffic["lr"], self.device, precision, w["adam"])

    def program_readings(self) -> tuple[dict, dict]:
        """What the program's checked steps and its watched step gave."""
        checked = {"losses": self.checked_losses, "grad": self.grad, "disp1": self.disp1, "change": self.change,
                   "stats": self.stats}
        return checked, self.window

    def gaps(self, programs: dict) -> tuple[dict, dict]:
        """Each of ``programs`` (a name to its checked and watched readings)
        against the float32 reference (``train_gaps``; the watched step's
        numbers prefixed ``win_``), and the reference's checked steps."""
        ref, rounded = self.reference(), self.reference("bfloat16", 1)
        wref, wrounded = self.window_reference(), self.window_reference("bfloat16")
        out = {}
        for name, (checked, watched) in programs.items():
            out[name] = train_gaps(checked, ref, rounded)
            out[name].update({f"win_{k}": v for k, v in train_gaps(watched, wref, wrounded).items()})
        return out, ref

    def check(self) -> dict:
        """The checked steps and the watched step against the reference's."""
        self.reach_window_step()
        self.release()
        gaps = self.gaps({"program": self.program_readings()})[0]["program"]
        gaps.pop("leaves")
        gaps.pop("win_leaves")
        return gaps


def _forward_done(spans: Spans) -> None:
    """Close the forward's span and open the loss and backward's (a forward
    hook that returns nothing leaves the output as it is)."""
    spans.end_event("train_forward")
    spans.start_event("backward")


Driver = Train
