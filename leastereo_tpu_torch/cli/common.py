"""Shared driver plumbing: model construction, the drivers' ranks, metric
logging and a wall-clock timer (port of ``leastereo_tpu/cli/common.py``)."""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import time
from collections.abc import Callable

import torch
import torch.distributed as dist

from ..models.genotypes import BEST_SCENEFLOW, load_architecture
from ..models.leastereo import LEAStereo, LEAStereoConfig, require_cuda
from ..parallel import Mesh, initialize, make_mesh

__all__ = ["build_model", "run_on_mesh", "MetricLogger", "Timer"]

_PACKAGE_ROOT = str(pathlib.Path(__file__).resolve().parents[2])


def run_on_mesh(module: str, argv: list[str] | None, args, body: Callable[[Mesh], int]) -> int:
    """Run ``body(mesh)`` as this process's rank of the ``--mesh_data`` x
    ``--mesh_disp`` mesh and return its exit code.

    * Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) or with
      ``--multihost``: join the process group from the environment, run,
      leave the group.
    * Otherwise, a mesh larger than 1x1 spawns its ``data * disp`` ranks as
      local processes (``python -m module argv``, ranks in the environment
      as torchrun sets them) and returns the first failing rank's code, or
      0. So ``python -m leastereo_tpu_torch.cli.predict --mesh_disp 2``
      behaves as the JAX command does on a host with two devices.
    * A 1x1 mesh runs here, with no process group.

    On ``--device cuda`` the backend is NCCL and every rank needs a card of
    its own: fewer cards than ranks raises, it never moves to gloo or the
    CPU. ``--device cpu`` runs gloo."""
    env = os.environ
    if args.multihost or ("RANK" in env and "WORLD_SIZE" in env):
        initialize(device=args.device)
        try:
            return body(make_mesh(data=args.mesh_data, disp=args.mesh_disp))
        finally:
            dist.destroy_process_group()
    n = (args.mesh_data or 1) * args.mesh_disp
    if n == 1:
        return body(make_mesh())
    if args.device == "cuda":
        require_cuda()
        if torch.cuda.device_count() < n:
            raise RuntimeError(
                f"a {args.mesh_data or 1}x{args.mesh_disp} mesh needs {n} CUDA cards, "
                f"{torch.cuda.device_count()} visible (NCCL takes one rank per card)"
            )
    argv = sys.argv[1:] if argv is None else list(argv)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = os.pathsep.join(p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", module, *argv],
            env=dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(n),
                     RANK=str(rank), LOCAL_RANK=str(rank), PYTHONPATH=path),
        )
        for rank in range(n)
    ]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        # A rank that failed leaves the others waiting in a collective.
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def build_model(args, seed: int = 0, mesh: Mesh | None = None) -> LEAStereo:
    """Model from arch .npy flags, falling back to the shipped best
    architecture (reference retrain/LEAStereo.py:16-21), initialised from
    ``seed``, in eval mode, on ``--device``. ``--device cuda`` without a card
    raises.

    With ``--mesh_disp > 1`` the cost volume's disparity axis is sharded over
    ``mesh``'s ``disp`` ranks (``cost_volume_pspec=("data", "disp")``, as the
    JAX ``build_model``)."""
    device = torch.device(args.device)
    if device.type == "cuda":
        require_cuda()
    mesh_disp = getattr(args, "mesh_disp", 1)
    cfg = LEAStereoConfig(
        maxdisp=args.maxdisp,
        fea_filter_multiplier=args.fea_filter_multiplier,
        fea_block_multiplier=args.fea_block_multiplier,
        fea_steps=args.fea_step,
        mat_filter_multiplier=args.mat_filter_multiplier,
        mat_block_multiplier=args.mat_block_multiplier,
        mat_steps=args.mat_step,
        compute_dtype=args.dtype,
        fast_head=args.fast_head,
        return_entropy=getattr(args, "confidence", False),
        cost_volume_pspec=("data", "disp") if mesh_disp > 1 else None,
    )
    if args.net_arch_fea and args.cell_arch_fea:
        fea = load_architecture(args.net_arch_fea, args.cell_arch_fea)
    else:
        fea = BEST_SCENEFLOW["feature"]
    if args.net_arch_mat and args.cell_arch_mat:
        mat = load_architecture(args.net_arch_mat, args.cell_arch_mat)
    else:
        mat = BEST_SCENEFLOW["matching"]
    model = LEAStereo(fea, mat, cfg, torch.Generator().manual_seed(seed))
    model.mesh = mesh
    return model.to(device).eval()


class MetricLogger:
    """stdout + JSONL scalar logging (``logs/metrics.jsonl``; replaces the
    reference's TensorBoard writer, train.py:100-101).

    ``tensorboard=True`` additionally writes TensorBoard event files next to
    the JSONL through tensorboardX; without it installed the flag is
    ignored with a warning. ``echo=False`` prints nothing (the ranks other
    than 0 of a parallel run)."""

    def __init__(self, logs_dir: str | None, tensorboard: bool = False, echo: bool = True):
        self.echo = echo
        self.path = None
        self._tb = None
        if logs_dir:
            os.makedirs(logs_dir, exist_ok=True)
            self.path = os.path.join(logs_dir, "metrics.jsonl")
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(logs_dir)
                except ImportError:
                    print("tensorboardX not available; --tensorboard ignored")

    def log(self, step: int, **scalars) -> None:
        payload = {"step": int(step)}
        payload.update({k: float(v) for k, v in scalars.items()})
        line = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in payload.items())
        if self.echo:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(payload) + "\n")
        if self._tb is not None:
            for k, v in payload.items():
                if k != "step":
                    self._tb.add_scalar(k, v, payload["step"])

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
