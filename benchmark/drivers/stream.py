"""Closed-loop frames through the predict driver's forward
(``cli.predict.make_forward``): one client, a bank of seeded pairs held in
host memory and cycled, each frame handed over as numpy and its disparity
returned as numpy."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..common import Phases, make_pairs, make_state, standardize
from ..program import build_model
from ..reference.compare import map_gaps, over_frames
from ..reference.flops import frame_flops, head_least_s
from ..reference.model import build_reference, exact_float32
from ..trace import Spans

__all__ = ["Stream", "Driver"]


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Stream:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from leastereo_tpu_torch.cli.predict import make_forward

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.phases = Phases(self.device)
        self.state = make_state(cfg, seed, self.device, self.phases)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.model = build_model(cfg, self.state, self.device)
        self.fwd = make_forward(self.model)
        self.phases.mark("model")
        h, w = traffic["frame"]
        left, right, _ = make_pairs(traffic["bank"], h, w, cfg["maxdisp"], seed, 2, self.device)
        self.left = standardize(left).cpu().numpy()
        self.right = standardize(right).cpu().numpy()
        del left, right
        self.phases.mark("bank")
        self.frames = 0
        self.start_window()
        for _ in range(traffic["warm_frames"]):
            self.step()
        self.phases.mark("warm")
        self.start_window()

    units_per_step = 1
    failed = 0  # a frame that raises ends the run

    def start_window(self) -> None:
        self.kept = Reservoir(self.traffic["checked_frames"], np.random.default_rng([self.seed % 2**63, 7]))

    def step(self) -> None:
        k = self.frames % len(self.left)
        out = self.fwd(self.left[k : k + 1], self.right[k : k + 1])
        self.kept.offer((k, out[0]))
        self.frames += 1

    def instrument(self, spans: Spans) -> list:
        """Host clock from the model's forward pre-hook to its post-hook (the
        kernels enqueued); CUDA events around the feature and matching nets."""
        clock = {}

        def enqueue_pre(*_):
            clock["t"] = time.perf_counter()

        def enqueue_post(*_):
            spans.add_host("host_enqueue", time.perf_counter() - clock["t"])

        handles = [self.model.register_forward_pre_hook(enqueue_pre),
                   self.model.register_forward_hook(enqueue_post)]
        for name in ("feature", "matching"):
            net = getattr(self.model, name)
            handles.append(net.register_forward_pre_hook(lambda *_, n=name: spans.start_event(n)))
            handles.append(net.register_forward_hook(lambda *_, n=name: spans.end_event(n)))
        return handles

    def trace_facts(self) -> dict:
        h, w = self.traffic["frame"]
        d = self.cfg["maxdisp"] // 3
        c = self.cfg["matching"]["filter_multiplier"] * self.cfg["matching"]["block_multiplier"]
        return {"flops_per_unit": frame_flops(self.cfg, 1, h, w),
                "head_least_s": head_least_s(1, c, d, h // 3, w // 3, 2, 2)}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.fwd
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_maps(self, keys, precision: str = "float32") -> dict:
        """The reference's map of each bank pair in ``keys``."""
        ref = build_reference(self.cfg, self.state, self.device, precision)
        out = {}
        with torch.no_grad(), exact_float32():
            for k in sorted(set(keys)):
                left = torch.from_numpy(self.left[k : k + 1]).to(self.device)
                right = torch.from_numpy(self.right[k : k + 1]).to(self.device)
                out[k] = ref(left, right)[0].cpu().numpy()
        return out

    def check(self) -> dict:
        """The window's sampled frames against the reference's maps of their
        pairs, float32 and with bfloat16 convolutions (``map_gaps``), each
        number's mean over the frames (``over_frames``)."""
        self.release()
        return self.readings([out for _, out in self.kept.items])

    def readings(self, outputs: list) -> dict:
        """``outputs`` (one map for each sampled frame, in order) against the
        reference."""
        keys = [k for k, _ in self.kept.items]
        ref, rounded = self.reference_maps(keys), self.reference_maps(keys, "bfloat16")
        return over_frames([map_gaps(out, ref[k], rounded[k]) for k, out in zip(keys, outputs)])


Driver = Stream
