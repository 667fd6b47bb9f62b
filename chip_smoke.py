#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

1. device: a CUDA card or fail; print its name and power limit (nvidia-smi).
2. build: compile every CUDA kernel of the port from csrc/ (nvcc, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with its time, the plain version's time and the
   least time the card could take (bound): the fused bias-act at its 9 sites, FPS at
   8 x 32768 -> 2048, the fused EMD at 256 pairs of 2048 x 2048 points (uniform clouds
   and clouds with 30% of their points on the origin).
4. slice: the full-width dusty_v2 generator (full_gen_cfg(), seeded random weights)
   samples B=8 at psi 0.7 with fixed logistic noise, and the clouds are
   FPS-downsampled to 2048 points, through the port's entry points; the launch
   counters show both kernels ran (the fused bias-act 9 times per forward), and the
   card's fp32 output matches the same model on the CPU within 1e-4.
5. evaluate: through evaluation.py only. The full-width generator produces the
   generated set, a second full-width generator with other weights the stand-in
   reference set (KITTI frames are not part of the repository), 64 clouds of 2048
   points each (the protocol's 2048 clouds per set would be 12.6 M EMD pairs); then
   SWD, JSD, COV-MMD-1-NNA over CD, EMD and DCD, FPD and KPD with a seeded random
   PointNet. The counters show 48 EMD kernel launches and no plain-route call; the
   EMD and CD scores of a 16-cloud subset match those from the plain versions' matrices.
6. rates: samples/s at B=8 and B=128, fp32 and the bfloat16 compute policy.

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

import numpy as np
import scipy
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from dusty_gan_v2_tpu_torch import kernels
from dusty_gan_v2_tpu_torch.evaluation import collect_generated, evaluate
from dusty_gan_v2_tpu_torch.metrics import (
    build_pointnet, earth_mover_distance, emd_cost, emd_cuda, fps_cuda, furthest_point_sampling,
)
from dusty_gan_v2_tpu_torch.metrics.cov_mmd_1nna import _compute_cov_mmd, _compute_nna, _pairwise_distance
from dusty_gan_v2_tpu_torch.models import build_generator
from dusty_gan_v2_tpu_torch.ops import fused_bias_act, fused_bias_act_cuda, fused_leaky_relu, sample_logistic
from dusty_gan_v2_tpu_torch.sampling import full_gen_cfg, load_angle, make_coord_bridge, sample, sample_and_downsample

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and non-tensor-core f32 rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# special-function results (exp2, sqrt, ...) per second: 16 per clock and SM against 128
# f32 FMA lanes (NVIDIA's CUDA C++ programming manual, arithmetic-instruction throughput table,
# compute capability 9.0); the data sheet's 67 TFLOP/s counts an FMA as two operations
SFU_OPS_PER_S = F32_FLOPS_PER_S / 2 / 128 * 16
# per-sample (C, H, W) of the fused bias-act sites of full_gen_cfg(): block 0 has one
# site (bias_act1), blocks 1-4 two (bias_act1, bias_act2)
K1_SITES = [((512, 4, 32), 1), ((256, 8, 64), 2), ((128, 16, 128), 2), ((64, 32, 256), 2), ((32, 64, 512), 2)]
B_SLICE, N_POINTS, K_POINTS = 8, 64 * 512, 2048
# evaluation: clouds per set (the protocol's depth, 2048, cut to 64), pairs per EMD
# launch (test_gan.py's --pairwise_batch), pairs per call of the plain EMD (its
# (pairs, 2048, 2048) f32 temporaries are 0.5 GB each at 32)
N_CLOUDS, PAIRWISE_BATCH, PLAIN_CHUNK, N_SUBSET = 64, 256, 32, 16
EVAL_METRICS = ("swd", "jsd", "1nna-cd", "1nna-emd", "1nna-dcd", "fpd", "kpd")
OUT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.json"
MEASURED, GAP_S = "measured_calls", 0.002  # the profiler range that holds the measured calls


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


def device_events(fn, reps):
    """([(kernel name, device ms), ...] of `reps` calls of fn, wall ms per call), from
    torch.profiler's CUDA events.

    The profiler loses a record at the edges of its window (one of N launches of a
    single kernel goes missing now and then), so one call that is not measured runs
    before and one after the measured calls. Those lie in a named range, with the card
    idle for GAP_S on either side of each end of it, so that the device events between
    the range's ends are the measured calls' whatever the skew of the two clocks."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(GAP_S)
        with record_function(MEASURED):
            time.sleep(GAP_S)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
            time.sleep(GAP_S)
        time.sleep(GAP_S)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events if e.name == MEASURED and e.device_type == DeviceType.CPU)
    return [
        (e.name, e.time_range.elapsed_us() / 1e3) for e in events
        if e.device_type == DeviceType.CUDA and e.name != MEASURED and span.start <= e.time_range.start <= span.end
    ], wall_ms


def profile_ms(fn, reps, windows=3):
    """(device ms per call, wall ms per call, {kernel name: device ms per call}).

    Device time is the sum of every kernel, copy and fill the calls put on the card; it
    is None when the profiler saw none. A kernel name whose record count is no multiple
    of `reps` means records were lost: such a window is measured again, up to `windows`
    times; if the last is still short its sum is a lower bound, and the log says so."""
    for _ in range(windows):
        events, wall_ms = device_events(fn, reps)
        by_name, records = {}, {}
        for name, ms in events:
            by_name[name] = by_name.get(name, 0.0) + ms / reps
            records[name] = records.get(name, 0) + 1
        odd = {name[:48]: n for name, n in records.items() if n % reps}
        if not odd:
            break
    else:
        log("profile", f"records incomplete in {windows} windows of {reps} calls, the device time is a lower "
            f"bound: {dict(list(odd.items())[:4])}")
    device_ms = sum(by_name.values()) if by_name else None
    return device_ms, wall_ms, by_name


def kernel_ms(fn, reps):
    """Device ms per call from the profiler; CUDA-event ms where it saw no device time."""
    ms, _, _ = profile_ms(fn, reps)
    return ms if ms is not None else cuda_ms(fn, reps)


def launch_ms(fn, reps):
    """CUDA-event ms of each of `reps` single calls of fn, for a wrapper that launches
    one long kernel: the events enclose nothing else, and the few microseconds they add
    do not show beside milliseconds. (Of five launches of the EMD kernel the profiler
    kept three or four records, even in the guarded window of device_events, so its sum
    over the call count read 20 to 40% too small.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def smi_clocks():
    """The card's SM clock, power draw and temperature right now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


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
        f"CUDA {torch.version.cuda}, scipy {scipy.__version__}")
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
    ms = statistics.median(launch_ms(lambda: fps_cuda(xyz, K_POINTS), 5))
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

def plain_emd(x, y):
    """The plain version over many pairs, PLAIN_CHUNK at a time."""
    return torch.cat([
        earth_mover_distance(x[i : i + PLAIN_CHUNK], y[i : i + PLAIN_CHUNK]) for i in range(0, x.shape[0], PLAIN_CHUNK)
    ])


def emd_bound_ms(pairs, n, m):
    """Least time for `pairs` approxmatch costs. Per element of the n x m plane: d once
    (3 mul + 2 add for x.y, 1 add, 1 mul, 1 sub, 1 max) and its sqrt once; per level one
    exp (counted once, whatever a kernel recomputes), the exponent's multiply, pass A's
    and pass B's multiply-add, pass C's three multiplies and two adds."""
    f32_ops = pairs * n * m * (9 + 9 * 10)
    sfu_ops = pairs * n * m * (1 + 9)
    nbytes = pairs * ((n + m) * 12 + 4)
    by_ops = f32_ops / F32_FLOPS_PER_S + sfu_ops / SFU_OPS_PER_S
    by_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"


def check_emd(dev, gen):
    n = K_POINTS
    worst, rows, ms_by_kind = 0.0, {}, {}
    for kind in ("origin30", "uniform"):
        x = torch.rand(PAIRWISE_BATCH, n, 3, device=dev, generator=gen)
        y = torch.rand(PAIRWISE_BATCH, n, 3, device=dev, generator=gen)
        if kind == "origin30":  # dropped rays sit on the origin: d = 0 and K = 1 at every level
            x[torch.rand(PAIRWISE_BATCH, n, device=dev, generator=gen) < 0.3] = 0.0
            y[torch.rand(PAIRWISE_BATCH, n, device=dev, generator=gen) < 0.3] = 0.0
        got, ref = emd_cuda(x, y), plain_emd(x, y)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and bool((ref > 0).all()), kind
        rel = float(((got - ref).abs() / ref).max())
        assert rel <= 1e-5, f"K3 differs from the plain version on {kind} clouds: max relative error {rel}"
        rows[kind] = rel
        worst = max(worst, rel)
        ms_by_kind[kind] = launch_ms(lambda: emd_cuda(x, y), 5)
        clocks = smi_clocks()
    # the plain version is timed on the same (uniform) clouds
    ms = statistics.median(ms_by_kind["uniform"])
    # 8 chunks of large back-to-back kernels: the CUDA-event time is the device's
    plain_ms = cuda_ms(lambda: plain_emd(x, y), reps=1, repeats=3)
    bound_ms, bound_by = emd_bound_ms(PAIRWISE_BATCH, n, n)
    log("kernels", f"emd {PAIRWISE_BATCH} pairs x {n} x {n}: max relative error per pair {rows} (bar 1e-5); "
        f"{ms:.3f} ms per launch (plain {plain_ms:.3f}, bound {bound_ms:.3f} by {bound_by}); "
        f"single launches min/median/max " + ", ".join(
            f"{k} {min(v):.3f}/{statistics.median(v):.3f}/{max(v):.3f}" for k, v in ms_by_kind.items())
        + f"; clocks.sm, clocks.max.sm, power.draw, temperature after them: {clocks}")
    return {
        "name": "emd", "route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/emd.cu",
        "replaces": "dusty_gan_v2_tpu/metrics/pallas_emd.py:41", "launches": None, "max_abs_err": worst,
        "err_kind": "max relative error per pair", "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }, {"max_rel_err": rows, "launch_ms": ms_by_kind, "clocks_after": clocks}


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

def plain_matrices(p1, p2):
    """(B1, B2) CD and EMD matrices from plain formulations on the card: CD from the
    difference form sum((a - b)^2), EMD from the plain approxmatch."""
    B1, B2 = p1.shape[0], p2.shape[0]
    i, j = torch.meshgrid(torch.arange(B1, device=p1.device), torch.arange(B2, device=p1.device), indexing="ij")
    a, b = p1[i.reshape(-1)], p2[j.reshape(-1)]
    emd = plain_emd(a, b) / a.shape[1]
    cd = []
    for k in range(0, a.shape[0], PLAIN_CHUNK):
        d = (a[k : k + PLAIN_CHUNK, :, None] - b[k : k + PLAIN_CHUNK, None]).square().sum(-1)
        cd.append(d.min(2).values.mean(1) + d.min(1).values.mean(1))
    return {"cd": torch.cat(cd).reshape(B1, B2).cpu().numpy(), "emd": emd.reshape(B1, B2).cpu().numpy()}


def phase_evaluate(G_cpu, dev):
    G = copy.deepcopy(G_cpu).to(dev)
    G_ref = build_generator(full_gen_cfg(), device=dev, seed=1)
    pointnet = build_pointnet(dev, seed=0)
    angle = load_angle()
    coord = make_coord_bridge(angle)
    log("evaluate", f"{N_CLOUDS} clouds per set of {K_POINTS} points from 64x512 images, pairwise batch "
        f"{PAIRWISE_BATCH}; the reference set is a stand-in (a second full-width generator, weight seed 1): "
        "KITTI frames are not part of the repository. The protocol's depth is 2048 clouds per set.")

    counters = {"fused_bias_act": fused_bias_act_cuda, "fps": fps_cuda, "emd": emd_cuda}
    for fn in counters.values():
        fn.launches = 0
    emd_cost.plain_route = 0
    times = {}
    t0 = time.perf_counter()
    gen, ref = (
        collect_generated(model, angle, coord, n=N_CLOUDS, batch_size=N_CLOUDS, pointnet=pointnet,
                          num_points=K_POINTS, truncation_psi=1.0, seed=seed)
        for model, seed in ((G, 2), (G_ref, 3))
    )
    torch.cuda.synchronize()
    times[f"generate+features+fps x{N_CLOUDS} x2"] = time.perf_counter() - t0
    print(f"[t] generate+features+fps x{N_CLOUDS} x2: {time.perf_counter() - t0:.1f}s", flush=True)
    scores = evaluate(gen, ref, metrics=EVAL_METRICS, pairwise_batch=PAIRWISE_BATCH, stage_times=times)
    launches = {name: fn.launches for name, fn in counters.items()}
    plain_route = emd_cost.plain_route

    n_launches = 3 * math.ceil(N_CLOUDS * N_CLOUDS / PAIRWISE_BATCH)
    log("evaluate", f"launches {launches}, plain-route EMD calls {plain_route}")
    assert launches["emd"] == n_launches == 48 and plain_route == 0, (launches, plain_route)
    assert launches["fps"] >= 2 and launches["fused_bias_act"] >= 18, launches
    assert tuple(gen.points.shape) == tuple(ref.points.shape) == (N_CLOUDS, K_POINTS, 3)
    assert tuple(gen.features.shape) == (N_CLOUDS, 1808) and gen.points.is_cuda
    assert bool(torch.isfinite(gen.features).all()) and bool(torch.isfinite(ref.features).all())
    bad = {k: v for k, v in scores.items() if not math.isfinite(v)}
    assert not bad, bad
    unit = {k: v for k, v in scores.items() if k.startswith("cov") or "accuracy" in k}
    assert len(unit) == 12 and all(0.0 <= v <= 1.0 + 1e-9 for v in unit.values()), unit
    for key in ("swd-mean", "jsd", "fpd", "kpd", "mmd-emd", "1-nn-accuracy-emd", "1-nn-accuracy-cd", "cov-emd"):
        log("evaluate", f"  {key}: {scores[key]:.6g}")

    # a cloud against itself. approxmatch is not exact: its first level, exp(-16384 d),
    # spreads a point's mass over the neighbours within about 1/128 = 0.0078 (units of
    # max_depth), and a LiDAR cloud has many that near. So the self-distance is bounded
    # by that length, and is below the distance to every other cloud.
    M_rr = _pairwise_distance(ref.points, ref.points, PAIRWISE_BATCH, ("emd",), dev)["emd"]
    diag = float(M_rr.diagonal().max())
    off = M_rr + np.diag(np.full(N_CLOUDS, np.inf, dtype=M_rr.dtype))
    assert diag <= 2.0 / 128, f"EMD of a cloud with itself: {diag}"
    assert bool((M_rr.diagonal() < off.min(axis=1)).all()), "a cloud is nearer to another than to itself"

    # the kernel route against plain formulations on the slice's own clouds
    g16, r16 = gen.points[:N_SUBSET], ref.points[:N_SUBSET]
    pairs = ((r16, r16), (r16, g16), (g16, g16))
    kernel_M = [_pairwise_distance(a, b, PAIRWISE_BATCH, ("cd", "emd"), dev) for a, b in pairs]
    plain_M = [plain_matrices(a, b) for a, b in pairs]
    emd_rel = max(
        float((abs(k["emd"] - p["emd"])[p["emd"] > 0] / p["emd"][p["emd"] > 0]).max()) for k, p in zip(kernel_M, plain_M)
    )
    assert emd_rel <= 1e-5, f"K3 differs from the plain version on the slice's clouds: {emd_rel}"

    def subset_scores(Ms, m):  # Ms: the (rr, rg, gg) matrices
        return {**_compute_cov_mmd(Ms[1][m]), **_compute_nna(Ms[0][m], Ms[1][m], Ms[2][m])}

    score_err = max(
        abs(value - subset_scores(plain_M, m)[key])
        for m in ("cd", "emd") for key, value in subset_scores(kernel_M, m).items()
    )
    assert score_err <= 1e-4, f"subset scores differ from the plain versions': {score_err}"
    # one chunk of the ref x gen matrix, as _pairwise_distance cuts it: the kernel's
    # device time on the slice's own clouds
    idx = torch.arange(PAIRWISE_BATCH, device=dev)
    a, b = ref.points[idx // N_CLOUDS], gen.points[idx % N_CLOUDS]
    own_ms = statistics.median(launch_ms(lambda: emd_cuda(a, b), 5))
    n_pairs = 3 * N_CLOUDS * N_CLOUDS
    rates = {m: n_pairs / times[f"1nna-{m}"] for m in ("cd", "emd", "dcd")}
    log("evaluate", f"self-EMD max {diag:.3g}; {N_SUBSET}-cloud subset: EMD max relative error per pair "
        f"{emd_rel:.3g}, score error vs plain {score_err:.3g}; K3 on the slice's clouds {own_ms:.3f} ms per "
        f"{PAIRWISE_BATCH}-pair launch; pairs/s " + ", ".join(f"{m} {r:.0f}" for m, r in rates.items()))
    return launches, {
        "clouds_per_set": N_CLOUDS, "points": K_POINTS, "pairwise_batch": PAIRWISE_BATCH, "reference_set": "stand-in",
        "stage_s": times, "scores": scores, "launches": launches, "plain_route": plain_route,
        "self_emd_max": diag, "subset_emd_max_rel_err": emd_rel, "subset_score_err": score_err, "pairs_per_s": rates,
        "emd_ms_on_own_clouds": own_ms,
    }


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
    k3, k3_rows = check_emd(dev, gen)
    G_cpu, launches, slice_rec = phase_slice(dev)
    k1["launches"], k2["launches"] = launches["fused_bias_act"], launches["fps"]
    eval_launches, eval_rec = phase_evaluate(G_cpu, dev)
    k3["launches"] = eval_launches["emd"]
    rates = phase_rates(G_cpu, dev)
    ks = [k1, k2, k3]

    record = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "ptxas": reports,
        "kernels": ks, "fused_bias_act_sites": k1_rows, "emd_by_clouds": k3_rows, "slice": slice_rec,
        "evaluate": eval_rec, "rates": rates,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1))
    for k in ks:
        assert all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")) and k["launches"] > 0, k
    print(json.dumps({"kernels": ks}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
