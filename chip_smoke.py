#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

1. device: a CUDA card or fail; print its name and power limit (nvidia-smi).
2. build: compile every CUDA kernel of the port from csrc/ (nvcc, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the sampling path gives it, with its time, the plain version's time and
   the least time the card could take (bound).
4. slice: the full-width dusty_v2 generator (full_gen_cfg(), seeded random weights)
   samples B=8 at psi 0.7 with fixed logistic noise, and the clouds are
   FPS-downsampled to 2048 points, through the port's entry points; the launch
   counters show both kernels ran (the fused bias-act 9 times per forward), and the
   card's fp32 output matches the same model on the CPU within 1e-4.
5. rates: samples/s at B=8 and B=128, fp32 and the bfloat16 compute policy.

Any failed phase raises, so the exit code is non-zero and the last line is not
printed. A JSON record of every number goes to chiprun_out/chip_smoke.json. The
last lines are the kernels record and {"ok": true, "device": {...}}.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dusty_gan_v2_tpu_torch import kernels
from dusty_gan_v2_tpu_torch.metrics import fps_cuda, furthest_point_sampling
from dusty_gan_v2_tpu_torch.models import build_generator
from dusty_gan_v2_tpu_torch.ops import fused_bias_act, fused_bias_act_cuda, fused_leaky_relu, sample_logistic
from dusty_gan_v2_tpu_torch.sampling import full_gen_cfg, load_angle, make_coord_bridge, sample, sample_and_downsample

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and non-tensor-core f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# per-sample (C, H, W) of the fused bias-act sites of full_gen_cfg(): block 0 has one
# site (bias_act1), blocks 1-4 two (bias_act1, bias_act2)
K1_SITES = [((512, 4, 32), 1), ((256, 8, 64), 2), ((128, 16, 128), 2), ((64, 32, 256), 2), ((32, 64, 512), 2)]
B_SLICE, N_POINTS, K_POINTS = 8, 64 * 512, 2048
OUT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.json"


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps, repeats=5):
    """Median over `repeats` of the mean CUDA-event time of `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def profile_ms(fn, reps):
    """(device ms per call, wall ms per call, {kernel name: device ms per call}).

    Device time is the sum of every kernel, copy and fill the calls put on the card,
    read from torch.profiler's CUDA events; it is None when the profiler saw none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    device_ms = sum(by_name.values()) if by_name else None
    return device_ms, wall_ms, by_name


def kernel_ms(fn, reps):
    """Device ms per call from the profiler; CUDA-event ms where it saw no device time."""
    ms, _, _ = profile_ms(fn, reps)
    return ms if ms is not None else cuda_ms(fn, reps)


def bf16_ulp(ref):
    mag = ref.float().abs().clamp(min=2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    reports = kernels.build_all()
    for name in kernels.SOURCES:
        kernels.library(name)
    seconds = time.perf_counter() - t0
    log("build", f"{len(kernels.SOURCES)} kernels built in {seconds:.2f} s into {kernels.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")
    return seconds, reports


def check_fused_bias_act(dev, gen):
    rows, f32_err, k_ms, p_ms, bound_ms = [], 0.0, 0.0, 0.0, 0.0
    for (C, H, W), sites in K1_SITES:
        shape = (B_SLICE, C, H, W)
        x = torch.randn(shape, device=dev, generator=gen)
        b = torch.randn(C, device=dev, generator=gen)
        row = {"shape": list(shape), "sites": sites}
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            got, ref = fused_bias_act_cuda(xd, b), fused_leaky_relu(xd, b)
            err = (got.float() - ref.float()).abs()
            if dtype == torch.float32:
                assert float(err.max()) <= 1e-6, f"K1 f32 forward {shape}: {float(err.max())}"
                f32_err = max(f32_err, float(err.max()))
            else:
                assert bool((err <= bf16_ulp(ref)).all()), f"K1 bf16 forward {shape}: max {float(err.max())}"
            # backward: the kernel's autograd Function against plain autograd
            g = torch.randn(shape, device=dev, generator=gen).to(dtype)
            xk, bk = xd.clone().requires_grad_(), b.clone().requires_grad_()
            xp, bp = xd.clone().requires_grad_(), b.clone().requires_grad_()
            (fused_bias_act(xk, bk).float() * g.float()).sum().backward()
            (fused_leaky_relu(xp, bp).float() * g.float()).sum().backward()
            dx_err = (xk.grad.float() - xp.grad.float()).abs()
            db_err = float((bk.grad - bp.grad).abs().max() / bp.grad.abs().max())
            if dtype == torch.float32:
                assert float(dx_err.max()) <= 1e-6, f"K1 f32 dx {shape}: {float(dx_err.max())}"
            else:
                assert bool((dx_err <= bf16_ulp(xp.grad)).all()), f"K1 bf16 dx {shape}"
            # the plain bf16 graph rounds d(bias) to bfloat16 on its way back to the f32 bias
            assert db_err <= (1e-5 if dtype == torch.float32 else 2.0**-8), f"K1 db {shape} {dtype}: {db_err}"
            name = "f32" if dtype == torch.float32 else "bf16"
            row[f"{name}_max_abs_err"] = float(err.max())
            # device time from the profiler; the CUDA-event time of back-to-back calls
            # (call_ms) also holds the host's launch overhead where that is longer
            row[f"{name}_ms"] = kernel_ms(lambda: fused_bias_act_cuda(xd, b), reps=50)
            row[f"{name}_plain_ms"] = kernel_ms(lambda: fused_leaky_relu(xd, b), reps=50)
            row[f"{name}_call_ms"] = cuda_ms(lambda: fused_bias_act_cuda(xd, b), reps=50)
            row[f"{name}_plain_call_ms"] = cuda_ms(lambda: fused_leaky_relu(xd, b), reps=50)
            nbytes = 2 * xd.numel() * xd.element_size() + b.numel() * 4
            row[f"{name}_bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, 4 * xd.numel() / F32_FLOPS_PER_S)
        k_ms += sites * row["f32_ms"]
        p_ms += sites * row["f32_plain_ms"]
        bound_ms += sites * row["f32_bound_ms"]
        rows.append(row)
        log("kernels", f"fused_bias_act {shape} x{sites}: fwd+bwd match; device ms f32 {row['f32_ms']:.4f} "
            f"(plain {row['f32_plain_ms']:.4f}, bound {row['f32_bound_ms']:.4f}), bf16 {row['bf16_ms']:.4f} "
            f"(plain {row['bf16_plain_ms']:.4f}, bound {row['bf16_bound_ms']:.4f}); per call incl. host "
            f"f32 {row['f32_call_ms']:.4f} (plain {row['f32_plain_call_ms']:.4f})")
    entry = {
        "name": "fused_bias_act", "route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/fused_bias_act.cu",
        "replaces": "dusty_gan_v2_tpu/ops/act.py:67", "launches": None, "max_abs_err": f32_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }
    return entry, rows


def check_fps(dev, gen):
    xyz = torch.randn(B_SLICE, N_POINTS, 3, device=dev, generator=gen)
    dropped = torch.rand(B_SLICE, N_POINTS, device=dev, generator=gen) < 0.3
    xyz[dropped] = 0.0  # dropped rays sit on the origin: many exact distance ties
    got = fps_cuda(xyz, K_POINTS)
    ref = furthest_point_sampling(xyz, K_POINTS)
    mismatch = int((got != ref).sum())
    assert mismatch == 0, f"K2 indices differ from the plain scan at {mismatch} places"
    ms = kernel_ms(lambda: fps_cuda(xyz, K_POINTS), reps=5)
    plain_ms = kernel_ms(lambda: furthest_point_sampling(xyz, K_POINTS), reps=1)
    nbytes = xyz.numel() * 4 + B_SLICE * K_POINTS * 4
    flops = 9 * (K_POINTS - 1) * B_SLICE * N_POINTS  # 3 sub, 3 mul, 2 add, 1 min per point and step
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    log("kernels", f"fps {B_SLICE}x{N_POINTS}->{K_POINTS}: indices equal the plain scan; {ms:.3f} ms "
        f"(plain {plain_ms:.3f}, bound {bound_ms:.4f} by operations)")
    return {
        "name": "fps", "route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/fps.cu",
        "replaces": "dusty_gan_v2_tpu/metrics/pallas_fps.py:27", "launches": None, "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations", "library_ms": None,
    }


def phase_slice(dev):
    cpu_gen = torch.Generator().manual_seed(0)
    G_cpu = build_generator(full_gen_cfg(), device="cpu", seed=0)
    with torch.no_grad():  # a non-zero w_avg, as after training, so truncation acts
        G_cpu.w_avg.copy_(G_cpu.mapping_network(torch.randn(4096, 512, generator=cpu_gen)).mean(0, keepdim=True))
    G = copy.deepcopy(G_cpu).to(dev)
    angle = load_angle()
    coord = make_coord_bridge(angle)
    z = torch.randn(B_SLICE, 512, generator=cpu_gen)
    noise = sample_logistic(cpu_gen, (B_SLICE, 1, 64, 512))

    fused_bias_act_cuda.launches = 0
    fps_cuda.launches = 0
    t0 = time.perf_counter()
    o, inv, small = sample_and_downsample(
        G, z.to(dev), angle, coord, truncation_psi=0.7, gumbel_noise=noise.to(dev), k=K_POINTS
    )
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"fused_bias_act": fused_bias_act_cuda.launches, "fps": fps_cuda.launches}
    log("slice", f"sample B={B_SLICE} + FPS to {K_POINTS}: {first_s:.3f} s (first call); launches {launches}")
    assert launches["fused_bias_act"] == 9, launches
    assert launches["fps"] >= 1, launches

    assert tuple(o["image"].shape) == (B_SLICE, 1, 64, 512), o["image"].shape
    assert tuple(small.shape) == (B_SLICE, K_POINTS, 3), small.shape
    for key in ("image", "image_orig", "raydrop_logit", "raydrop_mask", "w"):
        assert bool(torch.isfinite(o[key]).all()), key
    assert bool(torch.isfinite(small).all()) and bool(((inv >= 0) & (inv <= 1)).all())
    drop_share = float(1.0 - o["raydrop_mask"].mean())

    pts = coord.convert(inv, "inv_depth_norm", "point_set") / coord.max_depth
    idx_plain = furthest_point_sampling(pts, K_POINTS)
    assert torch.equal(fps_cuda(pts, K_POINTS), idx_plain), "K2 differs from the plain scan on the sampled clouds"

    o_cpu = sample(G_cpu, z, angle.cpu(), truncation_psi=0.7, gumbel_noise=noise)
    errs = {k: float((o[k].cpu() - o_cpu[k]).abs().max()) for k in ("image_orig", "raydrop_logit")}
    log("slice", f"card vs CPU fp32 max abs err {errs}; ray-drop share {drop_share:.3f}")
    assert all(e <= 1e-4 for e in errs.values()), errs
    return G_cpu, launches, {"first_call_s": first_s, "cpu_max_abs_err": errs, "raydrop_share": drop_share}


def phase_rates(G_cpu, dev):
    angle = load_angle()
    coord = make_coord_bridge(angle)
    gen = torch.Generator(device=dev).manual_seed(1)
    rates = []
    for compute_dtype in ("float32", "bfloat16"):
        cfg = full_gen_cfg()
        cfg["compute_dtype"] = compute_dtype
        G = build_generator(cfg, device=dev)
        G.load_state_dict(G_cpu.state_dict())
        for B in (8, 128):
            z = torch.randn(B, 512, device=dev, generator=gen)
            noise = sample_logistic(gen, (B, 1, 64, 512), device=dev)
            torch.cuda.reset_peak_memory_stats()
            gen_ms = cuda_ms(lambda: sample(G, z, angle, 0.7, noise), reps=10, repeats=3)
            slice_ms = cuda_ms(
                lambda: sample_and_downsample(G, z, angle, coord, 0.7, noise, K_POINTS), reps=3, repeats=3
            )
            dev_ms, wall_ms, by_name = profile_ms(lambda: sample(G, z, angle, 0.7, noise), reps=5)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            rec = {
                "compute_dtype": compute_dtype, "batch": B,
                "sample_ms": gen_ms, "samples_per_s": 1e3 * B / gen_ms,
                "sample_fps_ms": slice_ms, "sample_fps_per_s": 1e3 * B / slice_ms,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                # the profiler slows the host, so the idle share is taken against the
                # unprofiled batch time
                "profiled_wall_ms": wall_ms, "device_ms": dev_ms,
                "device_idle_share": None if dev_ms is None else max(0.0, 1.0 - dev_ms / gen_ms),
                "device_kernels": len(by_name), "top_device_ms": top,
            }
            rates.append(rec)
            log("rates", f"{compute_dtype} B={B}: sample {gen_ms:.3f} ms/batch = {rec['samples_per_s']:.1f} "
                f"samples/s; sample+FPS {slice_ms:.3f} ms = {rec['sample_fps_per_s']:.1f} samples/s; "
                f"peak {rec['peak_mem_gib']:.2f} GiB; device {dev_ms} ms per sample call, idle share "
                f"{rec['device_idle_share']}")
            log("rates", f"  top device ms per sample call: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in top))
        del G
    return rates


def main():
    smi = phase_device()
    dev = torch.device("cuda:0")
    build_s, reports = phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    k1, k1_rows = check_fused_bias_act(dev, gen)
    k2 = check_fps(dev, gen)
    G_cpu, launches, slice_rec = phase_slice(dev)
    k1["launches"], k2["launches"] = launches["fused_bias_act"], launches["fps"]
    rates = phase_rates(G_cpu, dev)

    record = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "ptxas": reports,
        "kernels": [k1, k2], "fused_bias_act_sites": k1_rows, "slice": slice_rec, "rates": rates,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1))
    for k in (k1, k2):
        assert all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")), k
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
