"""Run one cell of the benchmark once and print its result as the last line of stdout.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names a configuration (its file) and a traffic mix
(traffic/<name>.json), whose "kind" picks the job (jobs/<kind>.py). With --trace 0 the
result holds the cell's end-to-end metrics; with --trace 1 its per-layer metrics
(metrics/<name>.py), read from probes that time the program's kernels and phases and from
a profiled stretch of the window. Every run checks the outputs of the timed path against
the plain reference (reference/) and prints each number compared beside its limit, on
stderr and under "checks" in the result. Exits non-zero, printing no result, without the
card(s) the cell asks for or when a module of JAX or of the JAX package is loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"  # fixed paths inside the checkout: a second run finds every build
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the program's host work is one Python thread, and idle
# intra-op pools only compete with it for the host's shared cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.runtime import process_start_perf  # noqa: E402

T_PROC = process_start_perf()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "dusty_gan_v2_tpu")


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def trace_context(cell, outcome, probes):
    from portbench import work
    from portbench.harness.cells import peaks

    ctx = dict(outcome.trace)
    pk = peaks(ROOT)
    ctx["peaks"] = pk
    ctx["launches"] = probes.resolve()
    prec = cell.config.get("precision", "fp32")
    ctx["peak_flops_per_s"] = pk[f"{prec}_flops_per_s"]
    cfg = {k: cell.config[k] for k in ("dataset", "training", "model")}
    if ctx["kind"] == "train":
        cfg["training"]["batch_size"] = int(cell.traffic["batch"])
        ctx["model_flops"] = work.train_window_flops(cfg, ctx["first_iteration"], ctx["iterations"])
    return ctx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from portbench.harness import checks as C
    from portbench.harness.cells import find_cell, kernels, reader

    cell = find_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell asks for {cell.chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    job = importlib.import_module(f"portbench.jobs.{cell.traffic['kind']}")
    probes = None
    if args.trace:
        from portbench.harness.probes import KernelProbes

        probes = KernelProbes(kernels(ROOT))
        probes.install()
    outcome = job.run(cell, args.seed, args.seconds, bool(args.trace), T_PROC, "cuda", probes=probes)

    metrics, device = {}, {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                           "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed}
    if args.trace:
        ctx = trace_context(cell, outcome, probes)
        probes.uninstall()
        from portbench.harness.readers import best_profile, busy_filled

        for m in cell.per_layer:
            value = reader(m["name"], ROOT)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        p = best_profile(ctx)
        if p is not None:
            device["busy_s"] = busy_filled(ctx, p)
            device["window_s"] = p["window_s"]
            result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
            for prof in ctx["profiles"]:
                print("profiler records against launch counters: " + json.dumps(
                    {k: [r["profiler"], r["counter"]] for k, r in prof["records"].items()}), file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in outcome.e2e.items() if k in units}
    print(f"peak memory {outcome.memory_peak_bytes / 2**30:.3f} GiB; e2e " + json.dumps(outcome.e2e), file=sys.stderr)
    bad = banned_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    for line in outcome.notes:
        print(line, file=sys.stderr)
    for line in C.lines(outcome.checks):
        print(line, file=sys.stderr)
    result.update(metrics=metrics, device=device, checks=C.report(outcome.checks))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
