"""Readings that the limits of `correct` are set from (run on the card, one process a cell):

    python3 portbench/calibrate.py --workload <name> --seeds 101,102,... [--control-seeds ...]
        [--faults all|name,...] [--fault-seeds ...] [--seconds 2] [--out calibrate_<name>.json]

For each seed, a sound run: the cell's job with the program under test, as the
benchmark runs it, its window cut to --seconds (the numbers compared read set-up's steps or
the window's sampled outputs, not the window's length). For each control seed, the control:
the reference put in the program's place at the precision below the configuration's
(bf16 configuration: fp8; float32 with TF32 off: TF32; the EMD: the reference's in bf16).
With --faults, the planted faults of faults.py (all, or those named) on the fault seeds
(the control seeds where none are given). Every number
is printed beside the limit it is held to now; the run itself never fails."""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


# every number the jobs compute, compared or not
WATCHED = {"train": ("g_image_gap", "logit_gap", "loss_gap", "grad_gap", "grad_median_gap", "change_gap",
                     "change_median_gap", "draw_mismatch"),
           "eval": ("emd_gap", "emd_mean_gap", "score_gap", "missing")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.jobs import common
    from portbench.harness.cells import find_cell

    cell = find_cell(args.workload, ROOT)
    job = importlib.import_module(f"portbench.jobs.{cell.traffic['kind']}")
    limits = common.load_limits(cell.name)
    wide = {k: float("inf") for k in WATCHED.get(cell.traffic["kind"], limits)}
    device = "cuda" if torch.cuda.is_available() else "cpu"
    rows = []

    def one(label, seed, factory=None):
        t = time.perf_counter()
        o = job.run(cell, seed, args.seconds, False, t, device, program_factory=factory, limits=wide)
        row = {"kind": label, "seed": seed, "seconds": round(time.perf_counter() - t, 2),
               "numbers": {c.name: c.value for c in o.checks}, "e2e": o.e2e, "notes": o.notes}
        rows.append(row)
        held = {k: [v, limits.get(k), "not compared" if k not in limits else "ok" if v <= limits[k] else "OVER"]
                for k, v in row["numbers"].items()}
        print(json.dumps({"kind": label, "seed": seed, "checks": held}), flush=True)
        for note in o.notes:
            print("   ", note[:400], flush=True)

    for s in [int(x) for x in args.seeds.split(",") if x]:
        one("sound", s)
    control_seeds = [int(x) for x in args.control_seeds.split(",") if x]
    for s in control_seeds:
        one("control", s, faults.control(cell))
    planted = {k: v for k, v in faults.planted(cell).items()
               if args.faults == "all" or k in args.faults.split(",")}
    for s in [int(x) for x in args.fault_seeds.split(",") if x] or control_seeds:
        for name, factory in planted.items():
            one(f"fault:{name}", s, factory)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": cell.name, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
