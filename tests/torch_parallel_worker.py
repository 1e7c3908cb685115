"""Ranks of the port's parallel tests (``tests/test_torch_parallel*.py``).

The parent test calls :func:`run_ranks`, which writes the inputs to a file,
starts ``world`` processes of this script joined over gloo on the CPU, each
on one intra-op thread, and returns what each rank wrote. A rank imports
torch and ``leastereo_tpu_torch`` only, never JAX: the parent computes any
JAX reference and passes numpy arrays.

    python tests/torch_parallel_worker.py TASK RANK WORLD PORT DIR
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def run_ranks(tmp_path: pathlib.Path, world: int, task: str, timeout: float = 300, **inputs) -> list[dict]:
    """Run ``task`` on ``world`` gloo ranks with ``inputs``; each rank's
    outputs. A rank that fails stops the others (they would wait in a
    collective)."""
    import torch

    tmp_path.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp_path / "in.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    logs = [tmp_path / f"rank{rank}.log" for rank in range(world)]
    procs = []
    try:
        for rank in range(world):
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, task, str(rank), str(world), str(port), str(tmp_path)],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank} of {task} exited {p.returncode}:\n{logs[rank].read_text()[-4000:]}"
    return [torch.load(tmp_path / f"out{rank}.pt", weights_only=False) for rank in range(world)]


# --- tasks (run in the ranks) ---------------------------------------------------


def _slab(x, part, dim):
    return x.narrow(dim, part.lo, part.count)


def task_exchange(inp, mesh):
    """fetch_planes, soft_argmin_sharded, disparity_entropy_sharded and the
    sharded resize3d on seeded tensors, for each depth in ``inp``."""
    import torch

    from leastereo_tpu_torch.ops.resize import resize3d
    from leastereo_tpu_torch.ops.softargmin import disparity_entropy_sharded, soft_argmin_sharded
    from leastereo_tpu_torch.parallel import DispPartition, fetch_planes

    out = {}
    for depth in inp["depths"]:
        part = DispPartition(depth, mesh.disp, mesh.disp_index, mesh.disp_group)
        vol = torch.from_numpy(inp[f"vol{depth}"])
        slab = _slab(vol, part, 2)
        # Every rank's range: its own planes and two more on either side.
        lo = [a - 2 for a, _ in part.bounds]
        hi = [b + 2 for _, b in part.bounds]
        out[f"fetch{depth}"] = fetch_planes(slab, part, lo, hi)
        cost = torch.from_numpy(inp[f"cost{depth}"])
        out[f"softargmin{depth}"] = soft_argmin_sharded(_slab(cost, part, 1), part, 3 * depth)
        out[f"entropy{depth}"] = disparity_entropy_sharded(_slab(cost, part, 1), part, 3 * depth)
        for size in inp["sizes"][depth]:
            out[f"resize{depth}_{size[0]}"] = resize3d(slab, size, part=part)
    return out


def task_adjoint(inp, mesh):
    """The gradient that each sharded op gives this rank's slab (float64):
    of ``sum(out * g)`` with ``g`` this rank's slice of a cotangent over the
    op's global output (``fetch_planes``, ``halo``, the sharded resize3d),
    or ``g`` whole where every rank returns the whole map (the sharded
    soft-argmins)."""
    import torch

    from leastereo_tpu_torch.ops.resize import resize3d
    from leastereo_tpu_torch.ops.softargmin import soft_argmin_fast_sharded, soft_argmin_sharded
    from leastereo_tpu_torch.parallel import DispPartition, fetch_planes, halo

    out = {}
    for depth in inp["depths"]:
        part = DispPartition(depth, mesh.disp, mesh.disp_index, mesh.disp_group)
        lo, hi = part.lo, part.hi
        ops = {
            "fetch": (2, lambda x: fetch_planes(x, part, [a - 2 for a, _ in part.bounds], [b + 2 for _, b in part.bounds]),
                      lambda g: g[:, :, lo : hi + 4]),
            "halo": (2, lambda x: halo(x, part), lambda g: g[:, :, lo : hi + 2]),
            "softargmin": (1, lambda c: soft_argmin_sharded(c, part, 3 * depth), lambda g: g),
            "fast": (1, lambda c: soft_argmin_fast_sharded(c, part, 3 * depth), lambda g: g),
        }
        for size in inp["sizes"][depth]:
            out_part = part.of_depth(size[0])
            ops[f"resize{size[0]}"] = (2, lambda x, size=size: resize3d(x, size, part=part),
                                       lambda g, p=out_part: g[:, :, p.lo : p.hi])
        for name, (dim, fn, mine) in ops.items():
            src = inp[f"cost{depth}" if dim == 1 else f"vol{depth}"]
            slab = _slab(torch.from_numpy(src), part, dim).clone().requires_grad_()
            (fn(slab) * mine(torch.from_numpy(inp[f"g_{name}{depth}"]))).sum().backward()
            out[f"{name}{depth}"] = slab.grad
    return out


def task_forward(inp, mesh):
    """The disparity-sharded eval forward of the model in ``inp``, once for
    each config override in ``inp["variants"]`` (by default without and
    with ``return_entropy``)."""
    import torch

    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model

    out = {}
    left, right = (torch.from_numpy(inp[k]) for k in ("left", "right"))
    variants = inp.get("variants", {f"entropy={e}": {"return_entropy": e} for e in (False, True)})
    for name, override in variants.items():
        cfg = LEAStereoConfig(**inp["config"], cost_volume_pspec=("data", "disp"), **override)
        model = best_sceneflow_model(cfg, device="cpu")
        model.load_state_dict(inp["state_dict"])
        model.mesh = mesh
        with torch.no_grad():
            out[name] = model(left, right)
    return out


def _rows(batch, mesh):
    n = batch["left"].shape[0] // mesh.data
    return {k: v[mesh.data_index * n : (mesh.data_index + 1) * n] for k, v in batch.items()}


def _step_outputs(model, metrics):
    return {
        "metrics": metrics,
        "grads": {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
        "state": {k: v.clone() for k, v in model.state_dict().items()},
    }


def task_train_step(inp, mesh):
    """A data-parallel (and, with a config sharding the cost volume,
    disparity-sharded) eval step, then one such Adam train step, on this
    rank's rows of the global batch."""
    from leastereo_tpu_torch import LEAStereoConfig, best_sceneflow_model
    from leastereo_tpu_torch.train import eval_step, make_optimizer, train_step

    model = best_sceneflow_model(LEAStereoConfig(**inp["config"]), device="cpu")
    model.load_state_dict(inp["state_dict"])
    model.mesh = mesh
    opt = make_optimizer(model.parameters(), "adam", inp["lr"])
    rows = _rows(inp["batch"], mesh)
    eval_metrics = eval_step(model, rows, inp["config"]["maxdisp"], mesh=mesh)[1]
    metrics = train_step(model, opt, rows, inp["config"]["maxdisp"], inp["lr"], mesh=mesh)
    return {**_step_outputs(model, metrics), "eval_metrics": eval_metrics}


def task_search_step(inp, mesh):
    """One data-parallel supernet weight step on this rank's rows."""
    from leastereo_tpu_torch.search import AutoStereoSupernet, make_weight_optimizer, weight_step

    model = AutoStereoSupernet(**inp["supernet"])
    model.load_state_dict(inp["state_dict"])
    opt = make_weight_optimizer(model.weight_parameters(), inp["lr"])
    metrics = weight_step(model, opt, _rows(inp["batch"], mesh), inp["supernet"]["maxdisp"], inp["lr"], mesh)
    return _step_outputs(model, metrics)


def main() -> None:
    task, rank, world, port, out_dir = sys.argv[1:]
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from leastereo_tpu_torch.parallel import initialize, make_mesh

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{port}", int(world), int(rank), device="cpu")
    inp = torch.load(pathlib.Path(out_dir) / "in.pt", weights_only=False)
    mesh = make_mesh(data=inp.get("data", 1), disp=inp.get("disp", 1))
    out = globals()[f"task_{task}"](inp, mesh)
    torch.save(out, pathlib.Path(out_dir) / f"out{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
