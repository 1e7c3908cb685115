"""The predict driver's own per-frame path over files: set-up writes seeded
PNG pairs in the KITTI 2015 layout and a list file; each frame is
``StereoListDataset.load_stack``, ``cli.predict.run_frame`` and
``cli.predict.save_frame``, into one output directory overwritten each
cycle."""

from __future__ import annotations

import gc
import os
import tempfile
import time

import numpy as np
import torch

from ..common import Phases, make_pairs, make_state, to_uint8
from ..program import build_model
from ..reference.colormap import turbo_render
from ..reference.compare import map_gaps, over_frames
from ..reference.model import build_reference, exact_float32
from ..reference.png import read_png, write_png
from ..trace import Spans

__all__ = ["Files", "Driver"]


class Files:
    units_per_step = 1
    failed = 0  # a frame that raises ends the run

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from leastereo_tpu_torch.cli import predict
        from leastereo_tpu_torch.data import StereoListDataset

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.predict = predict
        self.phases = Phases(self.device)
        self.state = make_state(cfg, seed, self.device, self.phases)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.model = build_model(cfg, self.state, self.device)
        self.fwd = predict.make_forward(self.model)
        self.phases.mark("model")
        self.tmp = tempfile.TemporaryDirectory(prefix="leastereo_bench_")
        self.root = os.path.join(self.tmp.name, "data")
        self.out = os.path.join(self.tmp.name, "out")
        self.names = self._write_frames()
        list_file = os.path.join(self.tmp.name, "frames.list")
        with open(list_file, "w") as f:
            f.writelines(f"image_2/{n}\n" for n in self.names)
        os.makedirs(self.out)
        self.ds = StereoListDataset(dataset="kitti15", list_file=list_file, root=self.root,
                                    crop_size=tuple(traffic["crop"]), training=False)
        self.phases.mark("frames_written")
        self.spans = None
        self.frames = 0
        for _ in range(traffic["warm_frames"]):
            self.step()
        self.phases.mark("warm")

    def _write_frames(self) -> list[str]:
        """Seeded frames as 8-bit PNG pairs and 16-bit disparity (x256, 0
        invalid), written in chunks from the device."""
        h, w = self.traffic["frame"]
        names, n = [], self.traffic["bank"]
        for d in ("image_2", "image_3", "disp_occ_0"):
            os.makedirs(os.path.join(self.root, d))
        for lo in range(0, n, 8):
            left, right, disp = make_pairs(min(8, n - lo), h, w, self.cfg["maxdisp"], self.seed + lo, 2, self.device)
            left, right = to_uint8(left).cpu().numpy(), to_uint8(right).cpu().numpy()
            disp = (256.0 * disp).round().clamp(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
            for i in range(len(left)):
                name = f"{lo + i:06d}_10.png"
                write_png(os.path.join(self.root, "image_2", name), left[i])
                write_png(os.path.join(self.root, "image_3", name), right[i])
                write_png(os.path.join(self.root, "disp_occ_0", name), disp[i])
                names.append(name)
        return names

    def start_window(self) -> None:
        pass

    def step(self) -> None:
        k = self.frames % len(self.names)
        t0 = time.perf_counter()
        stack = self.ds.load_stack(k)
        t1 = time.perf_counter()
        disp = self.predict.run_frame(self.fwd, stack, *self.traffic["crop"])
        t2 = time.perf_counter()
        self.predict.save_frame(self.out, self.ds.entries[k].replace("/", "_"), disp)
        t3 = time.perf_counter()
        if self.spans is not None:
            for name, dt in (("load", t1 - t0), ("forward", t2 - t1), ("save", t3 - t2)):
                self.spans.add_host(name, dt)
        self.frames += 1

    def instrument(self, spans: Spans) -> list:
        """Host clocks around the predict script's load, forward and save."""
        self.spans = spans
        return []

    def trace_facts(self) -> dict:
        return {}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.fwd
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_map(self, name: str, precision: str = "float32") -> np.ndarray:
        """The reference's disparity of frame ``name``: its own PNG decode,
        per-channel standardisation, zero pad to the crop (bottom-right
        aligned), forward, and un-pad."""
        views = [read_png(os.path.join(self.root, d, name)).astype(np.float64) for d in ("image_2", "image_3")]
        h, w = views[0].shape[:2]
        ch, cw = self.traffic["crop"]
        padded = []
        for v in views:
            v = (v - v.mean(axis=(0, 1))) / v.std(axis=(0, 1))
            p = np.zeros((1, ch, cw, 3), np.float32)
            p[0, ch - h :, cw - w :] = v
            padded.append(torch.from_numpy(p).to(self.device))
        ref = build_reference(self.cfg, self.state, self.device, precision)
        with torch.no_grad(), exact_float32():
            out = ref(*padded)[0].cpu().numpy()
        return out[ch - h :, cw - w :]

    def sample(self) -> list[int]:
        """A seeded sample of the frames written."""
        rng = np.random.default_rng([self.seed % 2**63, 9])
        written = min(self.frames, len(self.names))
        return sorted(rng.choice(written, size=min(self.traffic["checked_frames"], written), replace=False))

    def frame_gaps(self, k: int) -> dict:
        """Frame ``k``'s last outputs on disk: the ``.npy`` against the
        reference's maps (``map_gaps``), and the ``.png`` against the frozen
        Turbo render of that ``.npy`` (exact)."""
        from PIL import Image

        stem = os.path.join(self.out, self.ds.entries[k].replace("/", "_"))
        disp = np.load(stem + ".npy")
        with Image.open(stem + ".png") as img:
            render = np.asarray(img)
        name = self.names[k]
        gaps = map_gaps(disp, self.reference_map(name), self.reference_map(name, "bfloat16"))
        gaps["render_gap"] = float(np.abs(render.astype(np.int32) - turbo_render(disp).astype(np.int32)).max())
        return gaps

    def check(self) -> dict:
        """The seeded sample's ``frame_gaps``, each number's mean over it."""
        self.release()
        readings = [self.frame_gaps(k) for k in self.sample()]
        self.tmp.cleanup()
        return over_frames(readings)

Driver = Files
