"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload kitti15_stream --seeds 1 2 3 --steps 8 [--faults]

For each seed, in one process: the cell's set-up and ``--steps`` steps of
its timed path, then the numbers the check compares, read three ways:
``program`` (what the timed path produced against the float32 reference),
each of ``--precisions`` (the reference computed so, put in the program's
place: ``fp8``, the precision below the configuration's bfloat16, is the
control). With ``--faults`` a training cell also reads a program fed half
of each batch; with ``--leaves`` it writes each leaf's first-gradient
readings. One JSON line a seed; the device and its power limit first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _stream(drv, precisions, leaves=False) -> dict:
    items = drv.kept.items
    drv.release()
    keys = [k for k, _ in items]
    out = {"program": drv.readings([o for _, o in items])}
    for p in precisions:
        other = drv.reference_maps(keys, p)
        out[p] = drv.readings([other[k] for k in keys])
    return out


def _files(drv, precisions, leaves=False) -> dict:
    from benchmark.reference.compare import map_gaps, over_frames

    drv.release()
    out = {k: [] for k in ("program", *precisions)}
    for k in drv.sample():
        name = drv.names[k]
        out["program"].append(drv.frame_gaps(k))
        ref, rounded = drv.reference_map(name), drv.reference_map(name, "bfloat16")
        for p in precisions:
            out[p].append(map_gaps(drv.reference_map(name, p), ref, rounded))
    drv.tmp.cleanup()
    return {k: over_frames(v) for k, v in out.items()}


def _train(drv, precisions, leaves=False) -> dict:
    from benchmark.reference.compare import leaf_diffs, leaf_gaps

    drv.reach_window_step()
    drv.release()
    programs = {"program": drv.program_readings()}
    programs.update({p: (drv.reference(p), drv.window_reference(p)) for p in precisions})
    out, ref = drv.gaps(programs)
    if not leaves:
        return out
    grads = {"program": drv.grad, "bfloat16": drv.reference("bfloat16", 1)["grad"]}
    grads.update({p: programs[p][0]["grad"] for p in precisions})
    names = list(ref["grad"])
    drv.leaf_table = {"names": names, "norm": [ref["grad"][k].double().norm().item() for k in names],
                      "numel": [ref["grad"][k].numel() for k in names],
                      **{f"gap.{w}": list(leaf_gaps(g, ref["grad"], names).values()) for w, g in grads.items()},
                      **{f"diff.{w}": list(leaf_diffs(g, ref["grad"]).values()) for w, g in grads.items()}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--precisions", nargs="*", default=["fp8"])
    p.add_argument("--faults", action="store_true")
    p.add_argument("--leaves", help="a training cell: write each leaf's first-gradient norms and gaps to this JSON file")
    args = p.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark.harness import card, load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    print(json.dumps({"workload": args.workload, "device": card(1)}), flush=True)
    device = torch.device("cuda", 0)
    read = {"stream": _stream, "files": _files, "train": _train}[cell.traffic["driver"]]
    leaves = {}
    for seed in args.seeds:
        drv = cell.driver()(cell.cfg, cell.traffic, seed, device)
        for _ in range(args.steps):
            drv.step()
        line = {"seed": seed, **read(drv, args.precisions, bool(args.leaves))}
        if args.leaves:
            leaves[seed] = drv.leaf_table
            pathlib.Path(args.leaves).write_text(json.dumps(leaves))
        if args.faults and cell.traffic["driver"] == "train":
            line["half_batch"] = _half_batch(cell, seed, device)
        print(json.dumps(line, default=str), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


def _half_batch(cell, seed, device) -> dict:
    """The program fed the first half of each batch (the mean over those
    rows alone), against the reference on the whole batches."""
    base = cell.driver()

    class HalfBatch(base):
        def batch(self, j):
            b = super().batch(j)
            if getattr(self, "_reference_rows", False):
                return b
            return {k: v[: len(v) // 2] for k, v in b.items()}

        def reference(self, precision="float32", steps=None):
            self._reference_rows = True
            return super().reference(precision, steps)

        def window_reference(self, precision="float32"):
            self._reference_rows = True
            return super().window_reference(precision)

    drv = HalfBatch(cell.cfg, cell.traffic, seed, device)
    drv.reach_window_step()
    drv.release()
    return drv.gaps({"half_batch": drv.program_readings()})[0]["half_batch"]


if __name__ == "__main__":
    sys.exit(main())
