#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

1. device: a CUDA card or fail; print its name and power limit (nvidia-smi).
2. build: compile every CUDA kernel of the port from csrc/ (nvcc, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with its time, the plain version's time and the
   least time the card could take (bound): the fused bias-act at its 9 sites, FPS at
   8 x 32768 -> 2048, the fused EMD at 256 pairs of 2048 x 2048 points (uniform clouds
   and clouds with 30% of their points on the origin), the fused act -> resample chain
   forward (with and without activation) and backward at the discriminator's four
   trunk shapes at B=8 and the widest at B=128, in f32 and bf16, each beside its
   yardsticks (the unfused pair, the einsum of the bare resample, the backward's adjoint
   pair), plus up-2 and down-2 plans (at the generator's site and at ragged sizes),
   dense random operators, the transposed-operator use, and a NaN in one plane, which
   must reach only the outputs of its band.
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
7. critic: through build_discriminator and training/trainer.py only. The full-width
   dusty_v2 discriminator (full_disc_cfg(), seeded weights, non-zero biases) scores the
   slice's B=8 fakes and stand-in reals from a second generator, and takes the three
   D-side loss phases with their gradients (g_phase_loss, d_phase_loss, r1_penalty with
   its double backward). The launch counters show the chain kernels on the unfused
   route (8 forward launches per D forward; 4 backward + 4 forward per backward); the
   card's fp32 logits and losses match the same D on the CPU within 1e-4 and all three
   kinds of gradient within 1e-2 of their largest magnitude (a float32 evaluation of
   them moves by ~1e-3 when its weights move by one ulp, which the phase measures); the
   composite route agrees; the bf16 policy stays near fp32.
8. critic rates: ms and imgs/s of the D forward, d_phase_loss forward + backward and
   r1_penalty forward + double backward at B=32 fp32 and B=128 bf16, and the four-block
   trunk with the chain kernels against the same trunk from the unfused pair.
9. train: the training step through training/trainer.py's Trainer only, full width and
   depth (full_train_cfg(): configs/gans/dusty_v2_bf16.yaml and dusty_v2.yaml, seeded
   weights, synthetic depth batches as bench.py builds them). Each step variant the
   configs reach runs once at bf16 B=128 (iteration 0: warmup + R1 + ADA; 4, 1,
   1,000,000, 1,000,004 and 1,000,003, bench.py's steady step) and the launch counters
   show K1, K4 and K5 on it (39 / 36 / 12 a step, 46 / 60 / 20 with R1). One fp32 B=4
   step (R1 + ADA + warmup) from a state whose Adam moments are populated runs on the
   card and on the CPU on the same replayed draws, each on its own trajectory: the
   losses and D outputs within 1e-4 (PL's penalty and pl_ema 1e-3), or twice the shift
   one ulp in the weights causes on the CPU where that is larger; D's outputs on fakes
   over the samples with no raydrop decision taken the other way (the straight-through
   Gumbel mask is a hard threshold: a pixel whose logit plus noise sits within rounding
   of it can flip after G's update), at most 4 such pixels (or twice as many as one ulp
   flips) on at most half the fakes; a CPU run fed the card's gradients (each phase on
   the state the card's earlier phases made) within 1e-4, PL's values too; R1's penalty
   and each phase's gradients before the optimizer within 1e-2 of their largest
   magnitude, or within twice the one-ulp shift where that is larger; G's buffers and
   the ADA state 1e-4; on the card, G's update is
   Adam's on its moments and the EMA e d + p (1 - d). The bf16 B=128 steady
   step stays within bf16 precision of the fp32 one. Then the rates: ms per step and
   imgs/s at bf16 B=128 and fp32 B=32 (TF32 off, and allowed), the R1 step, device ms by
   kernel, idle share, peak GiB.
10. cli: the command lines in process, through main(argv), full width and depth. A KITTI
   Raw tree is fabricated from a seed in a temporary directory (32 train frames of
   odometry sequence 00's drive, 64 test frames of a city drive; 64 rings x 2048
   azimuths a scan). configs/gans/dusty_v2_bf16.yaml is read with the port's
   load_config (B=128, cache: ram, float16 upload, warmup and ADA on) and changed only in
   the dataset root, prune_missing, total_kimg and the cadences (stats every 4, a
   checkpoint every 8, validation past the run). train_gan runs iterations 1-8 and
   writes a checkpoint; the state loaded from it equals the saved one bit for bit;
   train_gan --resume runs 9-16 (ADA at 12 and 16, R1 at 16); the launch counters show
   K1 / K4 / K5 equal to the sum of the variants that ran; the final checkpoint loads
   through pretrained.autoload_ckpt. A second resumed run, under the profiler, gives the
   device's busy time over iterations 9-15, and the idle share over the unprofiled window. One fp32 B=4 PL iteration (pl 2) runs on the
   card and on the CPU on replayed draws, held to phase 9's bars (the PL penalty and
   pl_ema among the values, both of G's Adam steps checked); one
   bf16 B=128 PL step is timed beside the steady step. test_gan evaluates the final
   checkpoint over swd, jsd, 1nna-cd, 1nna-emd, fpd and kpd at 64 + 64 clouds with a
   seeded random PointNet: K1 9, K2 3 and K3 48 launches, every score finite and in --out.
   Recorded: the CLI's imgs/s over iterations 9-15 beside phase 9's bare step, the
   loader's host ms per batch (first pass and cached), the idle share, the PL step's ms
   and test_gan's seconds per stage.
11. semseg: the SqueezeSeg command lines in process, through main(argv). The release's
   frontal layout is fabricated from seed 0 in a temporary directory: 240 GTA frames
   (64 x 512 x 5) with DUSty v2 drop maps and 64 KITTI frontal val frames (64 x 512 x 6).
   configs/semseg/sim2real_w_gan_noise_dustyv2_bf16.yaml is read with the port's
   load_config (SqueezeSegV2 + CAM + CRF-as-RNN, bf16, B=120, focal loss) and changed only
   in the dataset root, the steps (16 of 50,000) and the cadences (stats every 4,
   validation and a checkpoint at the end). train_semseg runs, its checkpoint loads equal
   to the trained state, a second (profiled) run gives the idle share, and test_semseg
   evaluates the checkpoint without and with --knn, twice in turns: every score finite
   and in --out. This
   path launches none of K1-K5 (the counters read 0 after it). Then: one fp32 B=4 step at
   64 x 512 on the card and on the CPU on injected dropout masks (loss, logits and running
   statistics 1e-4, gradients 1e-2 of their largest magnitude, or twice the shift one ulp
   in the weights makes on the CPU where larger), two card updates against the SGD
   chain's formula on the card's gradients (1e-6), kNN labels equal on the card and the
   CPU, bf16 against fp32 logits at B=40, and the bare step's rates (fp32 B=40 with TF32
   off and allowed, bf16 B=40, bf16 B=120 with and without the CRF; device ms, idle share,
   peak GiB).
12. other archs: configs/gans/dusty_v1.yaml (DUSty v1 G + vanilla D) and vanilla.yaml
   (vanilla G + vanilla D) at full width (ch_base 64, ch_max 512, 64 x 512, z 512, f32,
   TF32 off), read with sampling.train_cfg. For each: the G (seeded, non-zero biases and
   w_avg) samples B=8 at psi 0.7 on the card and on the CPU on the same z and logistic
   noise (image_orig / image and raydrop_logit within 1e-4; DUSty v1's drop-mask flips at
   most 4, or twice the one-ulp run's), the D scores the CPU's images on both (logits
   1e-4); K1 launches 4 per G forward and 4 per D forward; samples/s at B=32 and 128; one
   fp32 B=4 step card against CPU on replayed draws with phase 9's bars; bare Trainer
   steps at the config's B=32 (iteration 0 with R1: K1 24, then 20 a step) and their rates.
   train_gan runs dusty_v1.yaml on a fabricated KITTI tree over 16 iterations (ADA every
   4, R1 at 16: K1 324), then test_gan evaluates its checkpoint over swd, jsd, 1nna-cd,
   1nna-emd, fpd and kpd at 64 + 64 clouds (K1 4, K2 3, K3 48, every score finite);
   test_gan evaluates a checkpoint of the vanilla bare steps over swd, jsd and 1nna-cd
   through the real sets (its config sets no measurement_kwargs.raydrop_const: the reals
   take the dataset's).

13. inversion and demos: configs/gans/dusty_v2.yaml's G at full width (64 x 512, ch_base 32,
   ch_max 512, fp32; seeded, non-zero biases and w_avg) saved through training/checkpoint.py,
   and phase 10's kind of fabricated KITTI tree. demo_inversion runs at its defaults (w,
   500 + 500 steps), then w+ with --optimize_phase --hypersphere_z at 50 + 50: K1 launches
   9 per G forward (1,001 and 101 forwards), the last loss finite and below the first, the
   drop map (64, 512) float32 in [0, 1], the summary PNG 512 x 256. One stage-1 step (loss,
   latent and phase gradients) and one stage-2 step (every parameter's gradient) from the
   w+ run's state on the card and on the CPU: the loss within 1e-4 (relative), gradients
   within 1e-2 of their largest, each or twice the one-ulp shift. A window of 20 stage-1
   steps under the profiler gives the device's busy time and idle share. quick_demo at
   B=8 (K1 9, a 1024 x 256 PNG); demo_interpolation 2d and 3d at 2 anchors x 4 frames on
   the card and on the CPU on the same anchors (K1 9 a frame; colour indices differ on at
   most 1e-3 of the pixels, points within 1e-4 of the depth range; the card's normals
   against the CPU's normal_map of the card's points past 1e-4 on at most 1e-3 of the
   pixels, or twice the share one ulp in the points moves on the CPU: closest-pair
   near-ties and nearly collinear neighbours), then 2 x 30 frames for the rate; the
   bird's-eye view of quick_demo's images on the card against the CPU (lit pixels past
   1e-4 held to the same kind of bar: the card's scatter adds in no fixed order); the
   image tick's panels timed. Phase 10's train_gan runs now write an image tick at iterations 8 and 16
   (one G forward more each, K1 9) with the panels under the JAX CLI's tags.

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
from dusty_gan_v2_tpu_torch.datasets import InfiniteSampler, KITTIRaw, Prefetcher
from dusty_gan_v2_tpu_torch.evaluation import collect_generated, evaluate
from dusty_gan_v2_tpu_torch.metrics import (
    build_pointnet, earth_mover_distance, emd_cost, emd_cuda, fps_cuda, furthest_point_sampling,
)
from dusty_gan_v2_tpu_torch.metrics.cov_mmd_1nna import _compute_cov_mmd, _compute_nna, _pairwise_distance
from dusty_gan_v2_tpu_torch.metrics.fps import _fit_cluster
from dusty_gan_v2_tpu_torch.models import build_discriminator, build_generator
from dusty_gan_v2_tpu_torch.ops import (
    fused_act_resample, fused_act_resample_bwd_plain, fused_act_resample_plain, fused_bias_act, fused_bias_act_cuda,
    fused_chain_bwd_cuda, fused_chain_fwd_cuda, fused_leaky_relu, fused_resample_plain, make_resample, resample,
    sample_logistic,
)
from dusty_gan_v2_tpu_torch.ops.fused_chain import chain_operators, operators_from_dense
from dusty_gan_v2_tpu_torch.sampling import (
    full_disc_cfg, full_gen_cfg, full_train_cfg, load_angle, make_coord_bridge, sample, sample_and_downsample,
    train_cfg,
)
from dusty_gan_v2_tpu_torch.parallel import PerSampleStream, ReplayStream
from dusty_gan_v2_tpu_torch.training import Trainer, d_phase_loss, g_phase_loss, r1_penalty

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
G_K1 = sum(n for _, n in K1_SITES)  # fused bias-act launches of a dusty_v2 G forward: 9
B_SLICE, N_POINTS, K_POINTS = 8, 64 * 512, 2048
FPS_BATCHES = (B_SLICE, 64, 128)  # the slice, the evaluation's batch, the rates phase's
EMD_SEEDS = (0, 1, 2)
B_WIDE = 128  # the batch bench.py times: the widest chain site is timed there too
# per-sample (C, H, W) of the act -> blur sites of full_disc_cfg(): the input of each
# residual block, where the main path runs the chain with the activation and the skip
# without
CHAIN_SITES = [(32, 64, 512), (64, 32, 256), (128, 16, 128), (256, 8, 64)]
BLUR_WINDOW = (1, 3, 3, 1)
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


def graph_ms(fn, reps=20, repeats=5):
    """Device ms per call of fn: the median over `repeats` replays of a CUDA graph that
    holds `reps` back-to-back calls, timed with CUDA events. The graph takes the host
    out of the time (a wrapper's checks last longer than a small kernel) and needs no
    profiler records, which the card's machine loses (up to 3 of 10 launches of one
    kernel in a window). Inputs that fit the 50 MB L2 cache stay there from call to call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


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


def check_fps(dev, gen, smi):
    """K2 at B = 8 (the slice), 64 (the evaluation's batch) and 128 (the rates phase), 32768
    -> 2048 points, 30% of them on the origin: indices equal to the plain scan's; ms per
    launch and per step and the cluster size the launcher chose (CS = 1 is the one-block
    kernel). At B=8 CS = 1 and the chosen CS in turns, and every CS once; at B=128 a forced
    CS = 2, which runs in two waves."""
    rows, entry = [], None
    for B in FPS_BATCHES:
        xyz = torch.randn(B, N_POINTS, 3, device=dev, generator=gen)
        dropped = torch.rand(B, N_POINTS, device=dev, generator=gen) < 0.3
        xyz[dropped] = 0.0  # dropped rays sit on the origin: many exact distance ties
        got = fps_cuda(xyz, K_POINTS)
        chosen = _fit_cluster(xyz.device.index, B, N_POINTS)
        ref = furthest_point_sampling(xyz, K_POINTS)
        mismatch = int((got != ref).sum())
        assert mismatch == 0, f"K2 indices differ from the plain scan at {mismatch} places, B={B}"
        ms = statistics.median(launch_ms(lambda: fps_cuda(xyz, K_POINTS), 5))
        row = {"batch": B, "cluster": chosen, "ms": ms, "us_per_step": 1e3 * ms / (K_POINTS - 1), "device": smi}
        if B == B_SLICE:
            turns = []
            for cs in (1, chosen, chosen, 1):
                assert torch.equal(fps_cuda(xyz, K_POINTS, cluster=cs), ref), f"K2 with CS={cs} differs"
                turns.append({"cluster": cs, "ms": statistics.median(launch_ms(lambda: fps_cuda(xyz, K_POINTS, cluster=cs), 3))})
            by_cs = {}
            for cs in (2, 4, 8, 16):
                assert torch.equal(fps_cuda(xyz, K_POINTS, cluster=cs), ref), f"K2 with CS={cs} differs"
                by_cs[cs] = statistics.median(launch_ms(lambda: fps_cuda(xyz, K_POINTS, cluster=cs), 3))
            one = statistics.mean(t["ms"] for t in turns if t["cluster"] == 1)
            best = statistics.mean(t["ms"] for t in turns if t["cluster"] == chosen)
            row.update(turns=turns, ms_by_cluster=by_cs, speedup_over_cs1=one / best)
            plain_ms = kernel_ms(lambda: furthest_point_sampling(xyz, K_POINTS), reps=1)
            nbytes = xyz.numel() * 4 + B * K_POINTS * 4
            flops = 9 * (K_POINTS - 1) * B * N_POINTS  # 3 sub, 3 mul, 2 add, 1 min per point and step
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
            entry = {
                "name": "fps", "route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/fps.cu",
                "replaces": "dusty_gan_v2_tpu/metrics/pallas_fps.py:27", "launches": None, "max_abs_err": 0.0,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations", "library_ms": None,
            }
            row.update(plain_ms=plain_ms, bound_ms=bound_ms)
        if B == FPS_BATCHES[-1]:
            assert torch.equal(fps_cuda(xyz, K_POINTS, cluster=2), ref), "K2 with CS=2 differs at B=128"
            row["forced_cluster2_ms"] = statistics.median(launch_ms(lambda: fps_cuda(xyz, K_POINTS, cluster=2), 3))
        rows.append(row)
        log("kernels", f"fps {B}x{N_POINTS}->{K_POINTS} on {smi}: indices equal the plain scan; CS {chosen}, "
            f"{ms:.3f} ms per launch, {row['us_per_step']:.3f} us per step"
            + (f"; in turns (CS, ms) {[(t['cluster'], round(t['ms'], 3)) for t in row['turns']]}, "
               f"{row['speedup_over_cs1']:.2f}x over CS = 1; ms by CS {by_cs}; plain {plain_ms:.3f}, bound {bound_ms:.4f} by operations"
               if B == B_SLICE else "")
            + (f"; forced CS = 2 (two waves) {row['forced_cluster2_ms']:.3f} ms" if "forced_cluster2_ms" in row else ""))
        del xyz, dropped
    # the cluster kernel against the one-block kernel in turns on this card; B=128 keeps
    # the one-block kernel (two waves of clusters are not chosen)
    assert rows[0]["speedup_over_cs1"] >= 2.0, rows[0]
    assert rows[-1]["cluster"] == 1, rows[-1]
    return entry, rows


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


def emd_sets(dev, seeds):
    """{kind + seed: (x, y)}: PAIRWISE_BATCH pairs of K_POINTS-point clouds a set, uniform in
    the unit cube and with 30% of the points on the origin, from a generator of their own
    per seed (scripts/torch_emd_kernel_variants.py draws the same sets)."""
    sets = {}
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        for kind in ("uniform", "origin30"):
            x = torch.rand(PAIRWISE_BATCH, K_POINTS, 3, device=dev, generator=gen)
            y = torch.rand(PAIRWISE_BATCH, K_POINTS, 3, device=dev, generator=gen)
            if kind == "origin30":  # dropped rays sit on the origin: d = 0 and K = 1 at every level
                x[torch.rand(PAIRWISE_BATCH, K_POINTS, device=dev, generator=gen) < 0.3] = 0.0
                y[torch.rand(PAIRWISE_BATCH, K_POINTS, device=dev, generator=gen) < 0.3] = 0.0
            sets[f"{kind}{seed}"] = (x, y)
    return sets


def check_emd(dev, smi):
    """K3 against the plain version on six sets of 256 pairs of 2048 x 2048 points (seeds
    0-2, both kinds), 1e-5 relative per pair; ms per launch on the seed-0 sets."""
    n = K_POINTS
    worst, rows, ms_by_kind = 0.0, {}, {}
    for tag, (x, y) in emd_sets(dev, EMD_SEEDS).items():
        got, ref = emd_cuda(x, y), plain_emd(x, y)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and bool((ref > 0).all()), tag
        rel = float(((got - ref).abs() / ref).max())
        assert rel <= 1e-5, f"K3 differs from the plain version on set {tag}: max relative error per pair {rel}"
        rows[tag] = rel
        worst = max(worst, rel)
        if tag.endswith("0"):
            kind = tag[:-1]
            ms_by_kind[kind] = launch_ms(lambda: emd_cuda(x, y), 5)
            if kind == "uniform":
                uniform = (x, y)
    clocks = smi_clocks()
    # the plain version is timed on the same (uniform) clouds
    x, y = uniform
    ms = statistics.median(ms_by_kind["uniform"])
    # 8 chunks of large back-to-back kernels: the CUDA-event time is the device's
    plain_ms = cuda_ms(lambda: plain_emd(x, y), reps=1, repeats=3)
    bound_ms, bound_by = emd_bound_ms(PAIRWISE_BATCH, n, n)
    log("kernels", f"emd {PAIRWISE_BATCH} pairs x {n} x {n} on {smi}: max relative error per pair {rows} (bar 1e-5); "
        f"{ms:.3f} ms per launch (plain {plain_ms:.3f}, bound {bound_ms:.3f} by {bound_by}); "
        f"single launches min/median/max " + ", ".join(
            f"{k} {min(v):.3f}/{statistics.median(v):.3f}/{max(v):.3f}" for k, v in ms_by_kind.items())
        + f"; clocks.sm, clocks.max.sm, power.draw, temperature after them: {clocks}")
    return {
        "name": "emd", "route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/emd.cu",
        "replaces": "dusty_gan_v2_tpu/metrics/pallas_emd.py:41", "launches": None, "max_abs_err": worst,
        "err_kind": "max relative error per pair", "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    }, {"max_rel_err": rows, "launch_ms": ms_by_kind, "clocks_after": clocks, "device": smi}


def chain_tol(ref, dtype, inter=None, second=None):
    """Elementwise bar of a chain kernel against its plain version. f32: 1e-5 absolute
    plus 1e-5 relative (two sum orders of at most 512 terms). bf16: both round at the same
    places but sum in another order, which can flip a rounding: 2 ulp of the output,
    plus what one ulp of the rounded intermediate `inter` gives after the second product
    (`second`, with the operator's magnitudes)."""
    if dtype == torch.float32:
        return 1e-5 + 1e-5 * ref.float().abs()
    return 2 * bf16_ulp(ref) + second(bf16_ulp(inter))


def chain_bound(n_planes, o, backward):
    """(bound ms, "bytes" or "operations", dense-product ms) of one chain launch with the
    operators `o`: out = hm (ho, h) @ plane (h, w) @ wmT (w, wo), or for the backward
    hmT @ g @ wm times the mask. Bytes: every plane read and written once (the backward
    also reads the saved input, of the output's shape) and the operators read once in the
    form the kernel reads them: the ELL indices (int32) and values of its two passes.
    Operations: the multiply-adds the two products need on these operators, which are
    sparse (a zero needs no operation); the dense count is what a kernel blind to the
    zeros does."""
    left, right = (o.hmT, o.wm) if backward else (o.hm, o.wmT)
    forms = (o.hmT_ell, o.wm_ell) if backward else (o.hm_ell, o.wmT_ell)
    (ho, h), (w, wo) = left.shape, right.shape
    esize = left.element_size()
    op_bytes = sum(e.idx.numel() * e.idx.element_size() + e.val.numel() * e.val.element_size() for e in forms)
    nbytes = esize * n_planes * (h * w + (2 if backward else 1) * ho * wo) + op_bytes
    nnz_l, nnz_r = int((left != 0).sum()), int((right != 0).sum())
    if backward:
        need, dense = nnz_l * w + ho * nnz_r, ho * h * w + ho * w * wo
    else:
        need, dense = h * nnz_r + nnz_l * wo, h * w * wo + ho * h * wo
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, 2 * n_planes * need / F32_FLOPS_PER_S
    return (1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            1e3 * 2 * n_planes * dense / F32_FLOPS_PER_S)


def check_chain_case(x, b, g, plan, dtype, tag, o=None):
    """One resampling on one input: the forward kernel with and without the activation,
    the backward kernel (dx, and d(bias) through the autograd Function) and the forward
    kernel with the transposed operators, each against its plain version. The operators
    are the plan's, or `o` (then without the Function, which takes a plan). Returns the
    largest absolute errors."""
    B, C, H, W = x.shape
    o = chain_operators(plan, H, W, x.device, dtype) if o is None else o
    up = lambda u: torch.matmul(o.hm.abs().float(), u)  # noqa: E731
    down = lambda u: torch.matmul(u, o.wm.abs().float())  # noqa: E731
    errs = {}

    def hold(name, got, ref, tol):
        err = (got.float() - ref.float()).abs()
        assert bool(torch.isfinite(got.float()).all()), f"{tag} {name}: non-finite"
        assert bool((err <= tol).all()), f"{tag} {name}: max abs err {float(err.max())}, over the bar at {int((err > tol).sum())} places"
        errs[name] = float(err.max())

    y = fused_leaky_relu(x, b)
    ref = fused_act_resample_plain(x, b, o.wmT, o.hm)
    hold("fwd_act", fused_chain_fwd_cuda(x, b, o), ref, chain_tol(ref, dtype, torch.matmul(y, o.wmT), up))
    ref = fused_resample_plain(x, o.wmT, o.hm)
    hold("fwd", fused_chain_fwd_cuda(x, None, o), ref, chain_tol(ref, dtype, torch.matmul(x, o.wmT), up))
    ref = fused_act_resample_bwd_plain(g, x, b, o.wm, o.hmT)
    t = torch.matmul(o.hmT, g)
    hold("bwd", fused_chain_bwd_cuda(g, x, b, o), ref, chain_tol(ref, dtype, t, lambda u: math.sqrt(2.0) * down(u)))
    # the resample's adjoint is the forward kernel with the transposed operators
    ref = fused_resample_plain(g, o.wm, o.hmT)
    hold("fwd_transposed", fused_chain_fwd_cuda(g, None, o.adjoint), ref,
         chain_tol(ref, dtype, torch.matmul(g, o.wm), lambda u: torch.matmul(o.hmT.abs().float(), u)))
    if plan is None:
        return errs
    # d(bias) through the Function: a float32 sum of the kernel's dx
    xk, bk = x.clone().requires_grad_(), b.clone().requires_grad_()
    (fused_act_resample(xk, bk, plan).float() * g.float()).sum().backward()
    db_ref = fused_act_resample_bwd_plain(g, x, b, o.wm, o.hmT).float().sum(dim=(0, 2, 3))
    db_err = float((bk.grad - db_ref).abs().max() / db_ref.abs().max())
    assert db_err <= (1e-4 if dtype == torch.float32 else 2.0**-7), f"{tag} db: {db_err}"
    return errs


def einsum_resample(x, o):
    """The bare resample as one PyTorch call: K4's library yardstick (the port never calls it)."""
    return torch.einsum("ih,bchw,wj->bcij", o.hm, x, o.wmT)


def adjoint_pair(g, mask, o):
    """K5's yardstick: the adjoint resample as one einsum with the transposed operators,
    then the multiply by the activation mask (computed beforehand, in g's dtype)."""
    return torch.einsum("hi,bcij,jw->bchw", o.hmT, g, o.wm) * mask


def time_chain_site(x, b, g, o, reps=20):
    """Device ms of K4 (with and without the activation) and K5 at one site beside their
    plain versions' (the bare one is the pair of matmuls), the unfused pair (the bias-act
    kernel, then two matmuls), the einsum of the bare resample and K5's adjoint pair, all
    timed alike (graph_ms: no host time); the bounds and the share of them reached."""
    n = x.shape[0] * x.shape[1]
    pre = x.float() + b.to(x.dtype).float().reshape(1, -1, 1, 1)
    mask = torch.where(pre >= 0, math.sqrt(2.0), 0.2 * math.sqrt(2.0)).to(x.dtype)
    del pre
    fb, fby, fdense = chain_bound(n, o, backward=False)
    bb, bby, bdense = chain_bound(n, o, backward=True)
    times = {
        "fwd_act_ms": graph_ms(lambda: fused_chain_fwd_cuda(x, b, o), reps),
        "fwd_ms": graph_ms(lambda: fused_chain_fwd_cuda(x, None, o), reps),
        "bwd_ms": graph_ms(lambda: fused_chain_bwd_cuda(g, x, b, o), reps),
        "fwd_act_plain_ms": graph_ms(lambda: fused_act_resample_plain(x, b, o.wmT, o.hm), reps),
        "fwd_plain_ms": graph_ms(lambda: fused_resample_plain(x, o.wmT, o.hm), reps),
        "bwd_plain_ms": graph_ms(lambda: fused_act_resample_bwd_plain(g, x, b, o.wm, o.hmT), reps),
        # what the card would run unfused: the bias-act kernel, then two matmuls
        "fwd_act_pair_ms": graph_ms(lambda: fused_resample_plain(fused_bias_act_cuda(x, b), o.wmT, o.hm), reps),
        "fwd_einsum_ms": graph_ms(lambda: einsum_resample(x, o), reps),
        "bwd_adjoint_pair_ms": graph_ms(lambda: adjoint_pair(g, mask, o), reps),
        "fwd_bound_ms": fb, "fwd_bound_by": fby, "fwd_dense_ops_ms": fdense,
        "bwd_bound_ms": bb, "bwd_bound_by": bby, "bwd_dense_ops_ms": bdense,
    }
    times.update(fwd_act_share=fb / times["fwd_act_ms"], fwd_share=fb / times["fwd_ms"], bwd_share=bb / times["bwd_ms"],
                 fwd_not_slower_than_einsum=times["fwd_ms"] <= times["fwd_einsum_ms"],
                 fwd_act_not_slower_than_pair=times["fwd_act_ms"] <= times["fwd_act_pair_ms"],
                 bwd_not_slower_than_adjoint_pair=times["bwd_ms"] <= times["bwd_adjoint_pair_ms"])
    return times


def log_chain_site(shape, name, times, errs):
    log("kernels", f"fused_chain {shape} {name}: fwd/bwd match; device ms fwd+act {times['fwd_act_ms']:.4f} "
        f"(plain {times['fwd_act_plain_ms']:.4f}, K1 + 2 matmuls {times['fwd_act_pair_ms']:.4f}), fwd "
        f"{times['fwd_ms']:.4f} (plain = 2 matmuls {times['fwd_plain_ms']:.4f}, einsum {times['fwd_einsum_ms']:.4f}), bound "
        f"{times['fwd_bound_ms']:.4f} by {times['fwd_bound_by']} (share act {times['fwd_act_share']:.3f}, bare "
        f"{times['fwd_share']:.3f}), dense products {times['fwd_dense_ops_ms']:.4f}; bwd {times['bwd_ms']:.4f} (plain "
        f"{times['bwd_plain_ms']:.4f}, adjoint pair {times['bwd_adjoint_pair_ms']:.4f}), bound {times['bwd_bound_ms']:.4f} "
        f"by {times['bwd_bound_by']} (share {times['bwd_share']:.3f}), dense products {times['bwd_dense_ops_ms']:.4f}; "
        f"max abs err {errs}")


def check_nan_band(dev, gen):
    """A NaN in one plane of the input (K4, with and without the activation) or of the
    gradient (K5): every other plane's output equals the NaN-free run bit for bit, and in
    that plane exactly the outputs whose band covers the NaN are non-finite; the rest of
    the plane equals the NaN-free run too. The NaN sits in column 0, where the ring wraps."""
    blur = make_resample(window=BLUR_WINDOW, ring=True)
    C, H, W = CHAIN_SITES[0]
    p, h, w = 5, 10, 0
    rec = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = torch.randn(2, C, H, W, device=dev, generator=gen).to(dtype)
        g = torch.randn(2, C, H, W, device=dev, generator=gen).to(dtype)
        b = torch.randn(C, device=dev, generator=gen)
        o = chain_operators(blur, H, W, dev, dtype)
        fwd_band = (o.hm[:, h] != 0)[:, None] & (o.wmT[w, :] != 0)[None, :]
        bwd_band = (o.hmT[:, h] != 0)[:, None] & (o.wm[w, :] != 0)[None, :]
        cases = {
            "fwd_act": (lambda v: fused_chain_fwd_cuda(v, b, o), x, fwd_band),
            "fwd": (lambda v: fused_chain_fwd_cuda(v, None, o), x, fwd_band),
            "bwd": (lambda v: fused_chain_bwd_cuda(v, x, b, o), g, bwd_band),
        }
        for case, (fn, clean_in, band) in cases.items():
            dirty_in = clean_in.clone()
            dirty_in.view(-1, H, W)[p, h, w] = math.nan
            clean, dirty = (fn(v).view(-1, *band.shape) for v in (clean_in, dirty_in))
            others = torch.arange(clean.shape[0], device=dev) != p
            assert torch.equal(clean[others], dirty[others]), f"{name} {case}: a NaN in plane {p} changed another plane"
            bad = ~torch.isfinite(dirty[p])
            assert torch.equal(bad, band), f"{name} {case}: {int(bad.sum())} non-finite outputs, band {int(band.sum())}"
            assert torch.equal(clean[p][~band], dirty[p][~band]), f"{name} {case}: outside the band"
            rec[f"{name}_{case}"] = int(bad.sum())
    log("kernels", f"fused_chain NaN in one plane: other planes equal, non-finite outputs only on the band {rec}")
    return rec


def check_fused_chain(dev, gen):
    """K4 / K5 against their plain versions at the discriminator's trunk shapes (B=8, and
    the widest at B=128), and their device times beside the plain versions', the unfused
    pair on the card (the bias-act kernel plus two matmuls), the einsum of the bare
    resample (K4's library call), K5's adjoint pair, and the bound."""
    blur = make_resample(window=BLUR_WINDOW, ring=True)
    rows, worst = [], {"fwd": 0.0, "bwd": 0.0}
    total = {k: 0.0 for k in ("fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "fwd_library_ms", "bwd_ms", "bwd_plain_ms",
                              "bwd_bound_ms", "bwd_library_ms")}
    for B, (C, H, W) in [(B_SLICE, site) for site in CHAIN_SITES] + [(B_WIDE, CHAIN_SITES[0])]:
        shape = (B, C, H, W)
        x32 = torch.randn(shape, device=dev, generator=gen)
        b = torch.randn(C, device=dev, generator=gen)
        g32 = torch.randn(shape, device=dev, generator=gen)
        row = {"shape": list(shape)}
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x, g = x32.to(dtype), g32.to(dtype)
            errs = check_chain_case(x, b, g, blur, dtype, f"chain {shape} {name}")
            times = time_chain_site(x, b, g, chain_operators(blur, H, W, dev, dtype))
            row[name] = {"max_abs_err": errs, **times}
            if dtype == torch.float32:
                worst["fwd"] = max(worst["fwd"], errs["fwd_act"], errs["fwd"], errs["fwd_transposed"])
                worst["bwd"] = max(worst["bwd"], errs["bwd"])
            if dtype == torch.float32 and B == B_SLICE:  # one D forward: the act chain and the bare one per site
                total["fwd_ms"] += times["fwd_act_ms"] + times["fwd_ms"]
                total["fwd_plain_ms"] += times["fwd_act_plain_ms"] + times["fwd_plain_ms"]
                total["fwd_bound_ms"] += 2 * times["fwd_bound_ms"]
                total["fwd_library_ms"] += 2 * times["fwd_einsum_ms"]
                total["bwd_ms"] += times["bwd_ms"]
                total["bwd_plain_ms"] += times["bwd_plain_ms"]
                total["bwd_bound_ms"] += times["bwd_bound_ms"]
                total["bwd_library_ms"] += times["bwd_adjoint_pair_ms"]
            log_chain_site(shape, name, times, errs)
        rows.append(row)
        del x32, g32
    # rectangular operators: the generator's 2x up site and a 2x down; then ragged sizes
    # (no multiple of a tile in any dimension, an odd plane count); f32 and bf16
    for plan_kw, shape in ((dict(up=2), (B_SLICE, 64, 32, 256)), (dict(down=2), (B_SLICE, 32, 64, 512)),
                           (dict(), (3, 5, 6, 12)), (dict(up=2), (2, 3, 23, 70)), (dict(down=2), (1, 7, 46, 140))):
        plan = make_resample(window=BLUR_WINDOW, ring=True, **plan_kw)
        x32 = torch.randn(shape, device=dev, generator=gen)
        b = torch.randn(shape[1], device=dev, generator=gen)
        oh, ow = plan.out_shape(*shape[2:])
        g32 = torch.randn((*shape[:2], oh, ow), device=dev, generator=gen)
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            errs = check_chain_case(x32.to(dtype), b, g32.to(dtype), plan, dtype, f"chain {plan_kw} {shape} {name}")
            if dtype == torch.float32:
                worst["fwd"] = max(worst["fwd"], errs["fwd_act"], errs["fwd"], errs["fwd_transposed"])
                worst["bwd"] = max(worst["bwd"], errs["bwd"])
            log("kernels", f"fused_chain {plan_kw} {shape} -> {(oh, ow)} {name}: fwd/bwd match, max abs err {errs}")
    # the operators are general dense arguments: random ones, (40, 100) planes -> (24, 72)
    hm = torch.randn(24, 40, device=dev, generator=gen) / math.sqrt(40)
    wmT = torch.randn(100, 72, device=dev, generator=gen) / math.sqrt(100)
    x32, b = torch.randn(2, 3, 40, 100, device=dev, generator=gen), torch.randn(3, device=dev, generator=gen)
    g32 = torch.randn(2, 3, 24, 72, device=dev, generator=gen)
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        o = operators_from_dense(hm.to(dtype), wmT.to(dtype))
        errs = check_chain_case(x32.to(dtype), b, g32.to(dtype), None, dtype, f"chain dense operators {name}", o)
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], errs["fwd_act"], errs["fwd"], errs["fwd_transposed"])
            worst["bwd"] = max(worst["bwd"], errs["bwd"])
        log("kernels", f"fused_chain dense random operators (2, 3, 40, 100) -> (24, 72) {name}: fwd/bwd match, max abs err {errs}")
    nan_rec = check_nan_band(dev, gen)
    torch.cuda.synchronize()
    common = {"route": "cuda", "source": "dusty_gan_v2_tpu_torch/csrc/fused_chain.cu", "launches": None, "bound_by": "bytes"}
    k4 = {"name": "fused_chain_fwd", "replaces": "dusty_gan_v2_tpu/ops/fused_chain.py:51", "max_abs_err": worst["fwd"],
          "ms": total["fwd_ms"], "plain_ms": total["fwd_plain_ms"], "bound_ms": total["fwd_bound_ms"],
          "library_ms": total["fwd_library_ms"], **common}
    k5 = {"name": "fused_chain_bwd", "replaces": "dusty_gan_v2_tpu/ops/fused_chain.py:104", "max_abs_err": worst["bwd"],
          "ms": total["bwd_ms"], "plain_ms": total["bwd_plain_ms"], "bound_ms": total["bwd_bound_ms"],
          "library_ms": total["bwd_library_ms"], **common}
    for row in rows:  # the totals' bound is by bytes only if every site's is
        assert row["f32"]["fwd_bound_by"] == row["f32"]["bwd_bound_by"] == "bytes", row
    log("kernels", f"fused_chain per D forward at B={B_SLICE} f32 (8 launches): {k4['ms']:.4f} ms (plain {k4['plain_ms']:.4f}, "
        f"einsum of the bare resample at each launch {k4['library_ms']:.4f}, bound {k4['bound_ms']:.4f}); per backward "
        f"(4 launches of the backward kernel): {k5['ms']:.4f} ms (plain {k5['plain_ms']:.4f}, adjoint pair "
        f"{k5['library_ms']:.4f}, bound {k5['bound_ms']:.4f})")
    return k4, k5, {"sites": rows, "nan_band": nan_rec}


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
    return G_cpu, launches, {"first_call_s": first_s, "cpu_max_abs_err": errs, "raydrop_share": drop_share}, o["image"]

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


def phase_evaluate(G_cpu, dev, smi):
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
        f"{PAIRWISE_BATCH}-pair launch; pairs/s " + ", ".join(f"{m} {r:.0f}" for m, r in rates.items()) + f"; on {smi}")
    return launches, {
        "clouds_per_set": N_CLOUDS, "points": K_POINTS, "pairwise_batch": PAIRWISE_BATCH, "reference_set": "stand-in",
        "stage_s": times, "scores": scores, "launches": launches, "plain_route": plain_route,
        "self_emd_max": diag, "subset_emd_max_rel_err": emd_rel, "subset_score_err": score_err, "pairs_per_s": rates,
        "emd_ms_on_own_clouds": own_ms,
    }


def phase_rates(G_cpu, dev, smi):
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
                f"{rec['device_idle_share']}; on {smi}")
            log("rates", f"  top device ms per sample call: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in top))
        del G
    return rates


CHAIN_COUNTERS = {"fused_bias_act": fused_bias_act_cuda, "fused_chain_fwd": fused_chain_fwd_cuda,
                  "fused_chain_bwd": fused_chain_bwd_cuda}


def read_and_reset(counters):
    out = {name: fn.launches for name, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    return out


def grads_of(D):
    """{name: gradient} of D's parameters (zeros where a phase leaves one untouched)."""
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()) for k, p in D.named_parameters()}


def critic_phases(D, x_real, x_fake):
    """The three loss phases on D with their gradients, as the training step takes them."""
    xf = x_fake.detach().clone().requires_grad_()
    g_loss = g_phase_loss(D, xf, "nsgan")
    (g_grad,) = torch.autograd.grad(g_loss, xf)
    D.zero_grad(set_to_none=True)
    d_loss = d_phase_loss(D, x_real, x_fake, "nsgan")
    d_loss.backward()
    d_grads = grads_of(D)
    D.zero_grad(set_to_none=True)
    r1 = r1_penalty(D, x_real)
    r1.backward()
    r1_grads = grads_of(D)
    D.zero_grad(set_to_none=True)
    return {"g_loss": float(g_loss.detach()), "d_loss": float(d_loss.detach()), "r1": float(r1.detach())}, g_grad.detach(), d_grads, r1_grads


def rel_max_err(got, ref):
    """max |got - ref| over the reference's largest magnitude, over a dict of tensors."""
    scale = max(float(r.abs().max()) for r in ref.values())
    return max(float((got[k].cpu() - ref[k].cpu()).abs().max()) for k in ref) / scale


def phase_critic(x_fake, dev):
    D_cpu = build_discriminator(full_disc_cfg(), device="cpu", seed=0)
    bias_gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-zero biases, as after training, so the activations' bias paths act
        for name, prm in D_cpu.named_parameters():
            if name.endswith("bias"):
                prm.normal_(0.0, 0.3, generator=bias_gen)
    D = copy.deepcopy(D_cpu).to(dev)
    # stand-in reals: a second full-width generator (KITTI frames are not part of the repository)
    G_ref = build_generator(full_gen_cfg(), device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(4)
    angle = load_angle()
    z = torch.randn(B_SLICE, 512, device=dev, generator=gen)
    x_real = sample(G_ref, z, angle, 1.0, sample_logistic(gen, (B_SLICE, 1, 64, 512), device=dev))["image"]
    del G_ref
    assert tuple(x_fake.shape) == tuple(x_real.shape) == (B_SLICE, 1, 64, 512)

    # launch counters of one forward on each route and of one backward
    read_and_reset(CHAIN_COUNTERS)
    xf = x_fake.detach().clone().requires_grad_()
    y_chain = D(xf, blur_fuse=False)
    n_fwd = read_and_reset(CHAIN_COUNTERS)
    y_chain.sum().backward()
    n_bwd = read_and_reset(CHAIN_COUNTERS)
    D.zero_grad(set_to_none=True)
    with torch.no_grad():
        y_comp = D(x_fake, blur_fuse=True)
    n_comp = read_and_reset(CHAIN_COUNTERS)
    log("critic", f"launches: forward blur_fuse=False {n_fwd}, its backward {n_bwd}, forward blur_fuse=True {n_comp}")
    assert n_fwd == {"fused_bias_act": 7, "fused_chain_fwd": 8, "fused_chain_bwd": 0}, n_fwd
    assert n_bwd == {"fused_bias_act": 0, "fused_chain_fwd": 4, "fused_chain_bwd": 4}, n_bwd
    assert n_comp == {"fused_bias_act": 11, "fused_chain_fwd": 0, "fused_chain_bwd": 0}, n_comp
    assert tuple(y_chain.shape) == tuple(y_comp.shape) == (B_SLICE, 1)
    assert bool(torch.isfinite(y_chain).all()) and bool(torch.isfinite(y_comp).all())
    routes_err = float((y_chain.detach() - y_comp).abs().max())

    # the main path of this slice: the three loss phases with their gradients
    read_and_reset(CHAIN_COUNTERS)
    t0 = time.perf_counter()
    values, g_grad, d_grads, r1_grads = critic_phases(D, x_real, x_fake)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_and_reset(CHAIN_COUNTERS)
    log("critic", f"g_phase + d_phase + r1 with gradients, B={B_SLICE}: {first_s:.3f} s (first call); launches {launches}; {values}")
    # g: 8 + 4 forward-kernel and 4 backward-kernel launches; d: two forwards and their
    # backwards; r1: forward, backward with a graph (12 + 4), and the double backward, which
    # runs the forward kernel for every chain of the first backward (8) and, through the
    # minibatch stddev's dependence on the trunk, the trunk's own backward (4 + 4)
    assert launches == {"fused_bias_act": 28, "fused_chain_fwd": 60, "fused_chain_bwd": 20}, launches
    assert all(math.isfinite(v) for v in values.values()) and values["r1"] > 0, values

    # the same D on the CPU, fp32
    t0 = time.perf_counter()
    with torch.no_grad():
        y_cpu = {fuse: D_cpu(x_fake.cpu(), blur_fuse=fuse) for fuse in (False, True)}
    values_cpu, g_grad_cpu, d_grads_cpu, r1_grads_cpu = critic_phases(D_cpu, x_real.cpu(), x_fake.cpu())
    # how far one ulp moves the same float32 computation: the CPU reference once more with
    # every weight stepped to the next float. A leaky-ReLU mask flips where a pre-activation
    # sits within rounding of zero, and one flipped element among the 8 x 64 x 512 a bias
    # gradient sums moves it by ~1e-3 of its size, so no two float32 evaluations of these
    # gradients agree to 1e-4; values (logits, losses) do.
    D_ulp = copy.deepcopy(D_cpu)
    with torch.no_grad():
        for prm in D_ulp.parameters():
            prm.copy_(torch.nextafter(prm, torch.full_like(prm, math.inf)))
    _, g_grad_ulp, d_grads_ulp, r1_grads_ulp = critic_phases(D_ulp, x_real.cpu(), x_fake.cpu())
    cpu_s = time.perf_counter() - t0
    one_ulp = {
        "g_phase_input_grad": rel_max_err({"x": g_grad_ulp}, {"x": g_grad_cpu}),
        "d_phase_param_grads": rel_max_err(d_grads_ulp, d_grads_cpu),
        "r1_param_grads": rel_max_err(r1_grads_ulp, r1_grads_cpu),
    }
    errs = {
        "logits_chain": float((y_chain.detach().cpu() - y_cpu[False]).abs().max()),
        "logits_composite": float((y_comp.cpu() - y_cpu[True]).abs().max()),
        "routes": routes_err,
        "losses": max(abs(values[k] - values_cpu[k]) / max(abs(values_cpu[k]), 1e-12) for k in values),
    }
    grad_errs = {
        "g_phase_input_grad": rel_max_err({"x": g_grad}, {"x": g_grad_cpu}),
        "d_phase_param_grads": rel_max_err(d_grads, d_grads_cpu),
        "r1_param_grads": rel_max_err(r1_grads, r1_grads_cpu),
    }
    log("critic", f"card vs CPU fp32 (CPU references {cpu_s:.1f} s): logits max abs err and losses relative {errs} "
        f"(bar 1e-4); gradients' max abs err over the reference's largest magnitude {grad_errs} (bar 1e-2); the CPU "
        f"against itself with every weight one ulp up: {one_ulp}")
    assert all(e <= 1e-4 for e in errs.values()), errs
    assert all(e <= 1e-2 for e in grad_errs.values()), grad_errs
    assert float(g_grad_cpu.abs().max()) > 0 and all(float(g.abs().max()) > 0 for g in (d_grads_cpu["res0.conv1.conv.weight"], r1_grads_cpu["res0.conv1.conv.weight"]))

    # the bfloat16 policy: trunk in bfloat16, epilogue float32
    cfg = full_disc_cfg()
    cfg["compute_dtype"] = "bfloat16"
    D16 = build_discriminator(cfg, device=dev)
    D16.load_state_dict(D.state_dict())
    with torch.no_grad():
        y16 = {fuse: D16(x_fake, blur_fuse=fuse) for fuse in (False, True)}
    values16, g16, d16, r16 = critic_phases(D16, x_real, x_fake)
    bf16_l2 = {f"logits_{'composite' if fuse else 'chain'}": float((y - y_chain.detach()).norm() / y_chain.detach().norm())
               for fuse, y in y16.items()}
    finite16 = all(bool(torch.isfinite(t).all()) for t in (g16, *d16.values(), *r16.values(), *y16.values()))
    log("critic", f"bf16 policy: relative L2 of the logits to fp32 {bf16_l2}; losses {values16}; gradients finite: {finite16}")
    assert finite16 and all(math.isfinite(v) for v in values16.values())
    # ~30 bfloat16 roundings along the trunk, then a readout that cancels: a few percent of
    # the logits' norm (the losses agree to 0.2%)
    assert all(e <= 0.15 for e in bf16_l2.values()), bf16_l2
    return D_cpu, launches, {
        "first_call_s": first_s, "cpu_reference_s": cpu_s, "launches_forward_chain": n_fwd, "launches_backward": n_bwd,
        "launches_forward_composite": n_comp, "launches_three_phases": launches, "losses": values,
        "cpu_err": errs, "cpu_grad_err": grad_errs, "cpu_one_ulp_grad_shift": one_ulp, "bf16_rel_l2": bf16_l2, "bf16_losses": values16,
    }


def trunk(D, h, kernels_route):
    """The four residual blocks on h (B, 32, 64, 512): with the chain kernels (the block's
    own unfused route), or composed from the unfused pair the kernels replace (the
    bias-act kernel, then the two matmuls of `resample`)."""
    for j in range(D.n_down):
        blk = getattr(D, f"res{j}")
        if kernels_route:
            h = blk(h, blur_fuse=False)
            continue
        m = blk.conv2(resample(blk.bias_act1(blk.conv1(h)), blk.blur))
        h = (blk.bias_act2(m) + blk.skip(resample(h, blk.blur))) / math.sqrt(2.0)
    return h


def phase_critic_rates(D_cpu, G_cpu, dev):
    angle = load_angle()
    gen = torch.Generator(device=dev).manual_seed(5)
    G = copy.deepcopy(G_cpu).to(dev)
    rates = []
    for compute_dtype, B in (("float32", 32), ("bfloat16", 128)):
        cfg = full_disc_cfg()
        cfg["compute_dtype"] = compute_dtype
        D = build_discriminator(cfg, device=dev)
        D.load_state_dict(D_cpu.state_dict())
        imgs = [
            sample(G, torch.randn(B, 512, device=dev, generator=gen), angle, 1.0,
                   sample_logistic(gen, (B, 1, 64, 512), device=dev))["image"] for _ in range(2)
        ]

        def forward():
            with torch.no_grad():
                return D(imgs[0], blur_fuse=False)

        def forward_composite():
            with torch.no_grad():
                return D(imgs[0], blur_fuse=True)

        def d_step():
            D.zero_grad(set_to_none=True)
            d_phase_loss(D, imgs[0], imgs[1], "nsgan").backward()

        def r1_step():
            D.zero_grad(set_to_none=True)
            r1_penalty(D, imgs[0]).backward()

        rec = {"compute_dtype": compute_dtype, "batch": B}
        for name, fn, reps in (("forward", forward, 5), ("forward_composite", forward_composite, 5),
                               ("d_phase", d_step, 2), ("r1", r1_step, 2)):
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(fn, reps=reps, repeats=3)
            rec[f"{name}_ms"], rec[f"{name}_imgs_per_s"] = ms, 1e3 * B / ms
            rec[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        dev_ms, _, by_name = profile_ms(d_step, reps=2)
        chain_ms = sum(t for n, t in by_name.items() if "chain_fwd" in n or "chain_bwd" in n)
        rec.update(d_phase_device_ms=dev_ms, d_phase_chain_kernels_ms=chain_ms,
                   d_phase_top_device_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        rates.append(rec)
        log("critic-rates", f"{compute_dtype} B={B}: D forward {rec['forward_ms']:.3f} ms = {rec['forward_imgs_per_s']:.0f} "
            f"imgs/s (composite route {rec['forward_composite_ms']:.3f} ms); d_phase fwd+bwd {rec['d_phase_ms']:.3f} ms = "
            f"{rec['d_phase_imgs_per_s']:.0f} imgs/s, peak {rec['d_phase_peak_gib']:.2f} GiB; r1 fwd+double bwd "
            f"{rec['r1_ms']:.3f} ms = {rec['r1_imgs_per_s']:.0f} imgs/s, peak {rec['r1_peak_gib']:.2f} GiB; d_phase device "
            f"{dev_ms} ms of which chain kernels {chain_ms:.3f}")
        log("critic-rates", "  top device ms per d_phase step: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in rec["d_phase_top_device_ms"]))
        if compute_dtype == "float32":  # the trunk with the kernels against the unfused pair, in turns
            h = torch.randn(B_SLICE, 32, 64, 512, device=dev, generator=gen).requires_grad_()

            def trunk_step(kernels_route):
                D.zero_grad(set_to_none=True)
                h.grad = None
                trunk(D, h, kernels_route).square().sum().backward()

            with torch.no_grad():
                trunk_err = float((trunk(D, h, True) - trunk(D, h, False)).abs().max())
            turns = []
            for route in (False, True, True, False):  # device ms from the profiler, and ms per call on the host's clock
                dev_ms, _, by_name = profile_ms(lambda: trunk_step(route), reps=3)
                chain = sum(t for n, t in by_name.items() if "chain_fwd" in n or "chain_bwd" in n)
                turns.append({"kernels_route": route, "device_ms": dev_ms, "chain_kernels_ms": chain,
                              "call_ms": cuda_ms(lambda: trunk_step(route), reps=3, repeats=3)})
            rec["trunk_fwd_bwd"] = {"batch": B_SLICE, "turns": turns, "max_abs_diff": trunk_err}
            log("critic-rates", f"four-block trunk fwd+bwd, fp32 B={B_SLICE}, in turns (device ms / ms per call): " + ", ".join(
                f"{'chain kernels' if t['kernels_route'] else 'unfused pair'} {t['device_ms']:.3f} / {t['call_ms']:.3f}"
                for t in turns) + f"; chain kernels' share of the kernel route {turns[1]['chain_kernels_ms']:.3f} ms; "
                f"outputs differ by {trunk_err:.3g}")
            # what the same float32 model costs when cuDNN may use TF32, PyTorch's default
            torch.backends.cudnn.allow_tf32 = True
            rec["tf32_conv_forward_ms"] = cuda_ms(forward, reps=5, repeats=3)
            rec["tf32_conv_d_phase_ms"] = cuda_ms(d_step, reps=2, repeats=3)
            torch.backends.cudnn.allow_tf32 = False
            log("critic-rates", f"float32 B={B} with TF32 convolutions allowed (timing only): D forward "
                f"{rec['tf32_conv_forward_ms']:.3f} ms, d_phase fwd+bwd {rec['tf32_conv_d_phase_ms']:.3f} ms")
        del D
    return rates


# the training step: iteration -> (do_r1, do_ada, skip_warmup) under full_train_cfg (lazy gp 16,
# ada 4; warmup fades over 200 kimg), the six variants the configs reach
TRAIN_VARIANTS = {0: (True, True, False), 4: (False, True, False), 1: (False, False, False),
                  1_000_000: (True, True, True), 1_000_004: (False, True, True), 1_000_003: (False, False, True)}
STEADY_IT = 1_000_003  # bench.py's step: past the warmup fade, off the lazy cadence; it adds 48 a step
# launches a step: a G forward has 9 bias-act sites; a D forward (chain route) 7 K1 + 8 K4
# and its backward 4 K4 + 4 K5. G phase: G + D forward, D's input backward; D phase: G
# forward, two D forwards and backwards; R1: 7 K1, 24 K4, 8 K5 (the critic phase's count)
STEP_LAUNCHES = {False: {"fused_bias_act": 39, "fused_chain_fwd": 36, "fused_chain_bwd": 12},
                 True: {"fused_bias_act": 46, "fused_chain_fwd": 60, "fused_chain_bwd": 20}}


class RecordingStream(PerSampleStream):
    """A PerSampleStream that keeps what it draws, in the form a ReplayStream hands out
    (Bernoulli draws as their uniforms, logistic noise as the noise)."""

    def __init__(self, n, generator, device, log=None):
        super().__init__(n, generator, device)
        self.log = [] if log is None else log

    def with_batch(self, n):
        return RecordingStream(n, self.generator, self.device, self.log)

    def _keep(self, t):
        self.log.append(t.detach().cpu().numpy())
        return t

    def normal(self, shape=(), dtype=torch.float32):
        return self._keep(super().normal(shape, dtype))

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
        return self._keep(super().uniform(shape, dtype, minval, maxval))

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32):
        return self._keep(super().randint(shape, minval, maxval, dtype))

    def logistic(self, shape=(), dtype=torch.float32, eps=1e-7):
        u = PerSampleStream.uniform(self, shape, dtype, eps, 1.0 - eps)
        return self._keep(torch.log(u) - torch.log1p(-u))


def train_batch(tr, seed):
    """Synthetic depth (m) + mask for tr's batch, as bench.py::_gan_train_rate feeds the step."""
    rng = np.random.RandomState(seed)
    shape = (tr.batch_size, 1, *tr.resolution)
    return {"depth": torch.from_numpy(rng.uniform(2.0, 79.0, shape).astype(np.float32)).to(tr.device),
            "mask": torch.from_numpy((rng.rand(*shape) > 0.1).astype(np.float32)).to(tr.device)}


def record_draws(tr, st, batch, it):
    """The draws of one step, taken on a copy of the state (the state is not touched)."""
    rec = RecordingStream(tr.batch_size, tr.generator, tr.device)
    tr.step(copy.deepcopy(st), batch, it, draws=rec)
    return rec.log


def state_to_cpu(st):
    """A CPU copy of a TrainState (modules, Adam moments, ADA state)."""
    st = copy.deepcopy(st)
    for net in (st.G, st.G_ema, st.D):
        net.to("cpu")  # in place: the optimizers keep their parameters
    for opt in (st.opt_G, st.opt_D):
        for pst in opt.state.values():
            for k, v in pst.items():
                if torch.is_tensor(v):
                    pst[k] = v.cpu()
    st.ada = type(st.ada)(p=st.ada.p.cpu(), sign_cum=st.ada.sign_cum.cpu(), n_pred_cum=st.ada.n_pred_cum.cpu())
    st.pl_ema = st.pl_ema.cpu()
    return st


def phase_recorder(out, edit=None):
    """on_phase hook: each phase's values and its network's gradients, on the host; then
    `edit(name, state, net)`, where given, before the optimizer steps."""
    def hook(name, st, values):
        net = st.G if name in ("g", "pl") else st.D
        out[name] = ({k: v.detach().float().cpu() for k, v in values.items()}, grads_of(net))
        if edit is not None:
            edit(name, st, net)
    return hook


def feed_grads(record):
    """phase_recorder edit: each phase's gradients replaced by another run's (`record`),
    so that the next phase starts from the state that run's update made."""
    def edit(name, st, net):
        with torch.no_grad():
            for k, prm in net.named_parameters():
                prm.grad.copy_(record[name][1][k])
    return edit


def flat_state(st):
    return {f"{n}.{k}": v.detach().float().cpu().clone() for n in ("G", "G_ema", "D")
            for k, v in getattr(st, n).state_dict().items()}


def ulp(t):
    return torch.nextafter(t.abs(), torch.full_like(t, math.inf)) - t.abs()


def adam_formula_err(opt, net, old, new):
    """G's update (one Adam step this iteration) against optax's formula on the same
    moments, in float64: max over tensors, relative to the largest update, each element
    allowed 2 ulps of its stored value."""
    g = opt.param_groups[0]
    (b1, b2), lr, eps = g["betas"], g["lr"], g["eps"]
    worst = 0.0
    for k, prm in net.named_parameters():
        pst = opt.state[prm]
        t = float(pst["step"])
        mu, nu = pst["exp_avg"].double().cpu(), pst["exp_avg_sq"].double().cpu()
        upd = -lr * (mu / (1 - b1**t)) / ((nu / (1 - b2**t)).sqrt() + eps)
        d = new[f"G.{k}"].double() - old[f"G.{k}"].double()
        excess = float(((d - upd).abs() - 2 * ulp(new[f"G.{k}"]).double()).clamp(min=0).max())
        worst = max(worst, excess / max(float(upd.abs().max()), 1e-30))  # PL's step leaves the mapping net
    return worst


def update_err(new, ref, old, keys):
    """max over keys of max |(new - old) - (ref - old)| / max |ref - old|, each element
    allowed 2 ulps of its stored float32 value first."""
    worst = 0.0
    for k in keys:
        d_ref, d_new = ref[k] - old[k], new[k] - old[k]
        excess = float((d_new - d_ref).abs().sub(2 * ulp(ref[k])).clamp(min=0).max())
        worst = max(worst, excess / max(float(d_ref.abs().max()), 1e-30))
    return worst


FLIP = 1e-2  # a pixel of D's input this far from the CPU's: a raydrop decision taken the other way
MAX_FLIPS = 4  # such pixels allowed in a B=4 step's fakes (131,072 pixels), or twice the one-ulp run's
# PL's penalty and baseline on each run's own trajectory: squared deviations of path lengths
# that G takes after an Adam step on a gradient the card matches to ~3.5e-3 of its largest
# (bar 1e-2) at iteration 36; with the CPU fed the card's gradients they are held at 1e-4
PL_VALUES, PL_BAR = ("loss/G/path_length", "loss/G/path_length/baseline"), 1e-3


def train_card_vs_cpu(dev, it=32, pl=0, label="train", config="dusty_v2"):
    """One fp32 B=4 step on the card and on the CPU from the same state (two steps old, so
    Adam's moments are populated) on the same draws: at iteration 32 R1 + ADA + warmup;
    with `pl` > 0 (lazy pl 4) iteration 36 takes PL + ADA + warmup.

    Each run keeps its own trajectory. Fakes carry a hard raydrop mask (the straight-through
    Gumbel-sigmoid's forward thresholds logit + noise), so after G's update a pixel whose
    logit plus noise sits within rounding of the threshold can be dropped on one side and
    kept on the other, and D's output on that fake moves by far more than rounding. So D's
    outputs on fakes are compared on the samples whose fake has no such pixel (at least
    half of them), and the pixels are counted (at most MAX_FLIPS, or twice as many as one
    ulp in the weights flips on the CPU). Values are held at 1e-4 (PL's at PL_BAR), or
    twice the shift one ulp in the weights makes on the CPU where that is larger. A CPU
    run that takes the card's gradients into its optimizer steps holds each phase on the
    state the card's earlier phases made, every value at 1e-4. `config` names the float32
    configs/gans/*.yaml (B=32, lazy gp 16, ada 4 in each)."""
    cfg = train_cfg(config)
    cfg["training"]["batch_size"] = 4
    cfg["training"]["loss"]["pl"] = pl
    # it 32: R1 (every 16), ADA (every 4), warmup (B=4: 50,000 iterations); 36: PL (every 4), no R1
    tr = Trainer(cfg, device=dev, seed=7)
    st = tr.init_state(seed=3)
    batch = train_batch(tr, 1)
    for pre in (it - 2, it - 1):
        tr.step(st, batch, pre)
    sched = tr.schedule(it)
    assert (sched.skip_warmup, sched.do_pl, sched.do_ada) == (False, pl > 0, True)
    draws = record_draws(tr, st, batch, it)
    tr_cpu = Trainer(cfg, device="cpu", angle=tr.angle.cpu(), seed=7)
    batch_cpu = {k: v.cpu() for k, v in batch.items()}
    starts = {n: state_to_cpu(st) for n in ("cpu", "cpu_ulp", "cpu_fed")}
    with torch.no_grad():
        for net in (starts["cpu_ulp"].G, starts["cpu_ulp"].D):
            for prm in net.parameters():
                prm.copy_(torch.nextafter(prm, torch.full_like(prm, math.inf)))
    old, old_ulp, old_card = flat_state(starts["cpu"]), flat_state(starts["cpu_ulp"]), flat_state(st)

    # on the card's own numbers, each of G's Adam steps (a second one after PL) is Adam's on
    # the moments it left: checked at the PL hook for the first, after the step for the last
    g_before, adam_errs = [old_card], []

    def check_g_step(name, s, net):
        if name == "pl":
            now = flat_state(s)
            adam_errs.append(adam_formula_err(s.opt_G, s.G, g_before[0], now))
            g_before[0] = now

    runs, fakes = {}, {}

    def run(name, t, s, b, d, edit=None):
        phases, seen, marks = {}, [], {}

        def mark(phase, st_, net):
            marks[phase] = len(seen)
            if edit is not None:
                edit(phase, st_, net)

        hook = s.D.register_forward_pre_hook(lambda mod, args: seen.append(args[0].detach().float().cpu()))
        rs = ReplayStream(draws, device=d)
        try:
            metrics = t.step(s, b, it, draws=rs, on_phase=phase_recorder(phases, mark))
        finally:
            hook.remove()
        assert rs.remaining == 0, name
        runs[name] = (phases, {k: float(v) for k, v in metrics.items()}, s)
        fakes[name] = seen[marks["d"] - 1]  # the d phase scores reals, then the fakes of the updated G

    t0 = time.perf_counter()
    run("card", tr, st, batch, dev, check_g_step)
    run("cpu", tr_cpu, starts["cpu"], batch_cpu, "cpu")
    run("cpu_ulp", tr_cpu, starts["cpu_ulp"], batch_cpu, "cpu")
    run("cpu_fed", tr_cpu, starts["cpu_fed"], batch_cpu, "cpu", feed_grads(runs["card"][0]))
    cpu_s = time.perf_counter() - t0
    (ph, m, _), (ph_cpu, m_cpu, st_cpu), (ph_ulp, _, st_ulp) = runs["card"], runs["cpu"], runs["cpu_ulp"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)  # noqa: E731
    loss_keys = ["loss/G/adversarial", "loss/D/adversarial"]
    if sched.do_pl:
        loss_keys += ["loss/G/path_length", "loss/G/path_length/baseline"]
    flips = {n: ((fakes[n] - fakes["cpu"]).abs() > FLIP).flatten(1).sum(1).tolist() for n in ("card", "cpu_ulp")}
    flips["cpu_fed"] = ((fakes["card"] - fakes["cpu_fed"]).abs() > FLIP).flatten(1).sum(1).tolist()

    def value_diff(a, b, n_flips):
        """losses (relative) and D's outputs (max abs; on fakes over the samples without a
        flipped raydrop decision) of run a against run b"""
        (pa, ma, _), (pb, mb, _) = runs[a], runs[b]
        d = {k: rel(ma[k], mb[k]) for k in loss_keys}
        d["y_real"] = float((pa["d"][0]["y_real"] - pb["d"][0]["y_real"]).abs().max())
        keep = torch.tensor(n_flips) == 0
        d["y_fake"] = float((pa["d"][0]["y_fake"] - pb["d"][0]["y_fake"])[keep].abs().max()) if keep.any() else 0.0
        return d

    value_err = value_diff("card", "cpu", flips["card"])
    one_ulp_value, fed_value_err = value_diff("cpu_ulp", "cpu", flips["cpu_ulp"]), value_diff("card", "cpu_fed", flips["cpu_fed"])
    value_bar = {k: max(PL_BAR if k in PL_VALUES else 1e-4, 2 * one_ulp_value[k]) for k in value_err}
    flip_bar = max(MAX_FLIPS, 2 * sum(flips["cpu_ulp"]))
    y_fake_err = (ph["d"][0]["y_fake"] - ph_cpu["d"][0]["y_fake"]).abs().flatten().tolist()
    # R1's penalty is a sum of squared input gradients: it is held to the gradients' bar
    penalty_err = rel(m["loss/D/gradient_penalty"], m_cpu["loss/D/gradient_penalty"]) if sched.do_r1 else 0.0
    phases = [n for n in ("g", "pl", "d", "r1") if n in ph]
    grad_err = {f"{n}_phase": rel_max_err(ph[n][1], ph_cpu[n][1]) for n in phases}
    fed_grad_err = {f"{n}_phase": rel_max_err(ph[n][1], runs["cpu_fed"][0][n][1]) for n in phases}
    one_ulp = {f"{n}_phase": rel_max_err(ph_ulp[n][1], ph_cpu[n][1]) for n in phases}
    # a phase's bar is 1e-2 of its gradients' largest magnitude (the D side's), or twice the
    # shift one ulp in every weight causes to the same phase on the CPU where that is
    # larger: R1's gradients at B=4 follow leaky-ReLU masks that flip within rounding, and
    # in some runs one ulp moves them by more than 1e-2
    grad_bar = {k: max(1e-2, 2 * one_ulp[k]) for k in grad_err}
    new, new_cpu, new_ulp = flat_state(st), flat_state(st_cpu), flat_state(st_ulp)
    bufs = [k for k in new_cpu if k.startswith("G") and k.endswith(("w_avg", "ema_var"))]
    buf_err = max(float((new[k] - new_cpu[k]).abs().max() / new_cpu[k].abs().max()) for k in bufs)
    ada_err = max(abs(float(a) - float(b)) for a, b in zip(
        (st.ada.p, st.ada.sign_cum, st.ada.n_pred_cum), (st_cpu.ada.p, st_cpu.ada.sign_cum, st_cpu.ada.n_pred_cum)))
    # on the card's own numbers: G's last update is Adam's on its moments, the EMA is
    # e * d + p * (1 - d) in float32 (both within 2 ulps of the stored values)
    adam_errs.append(adam_formula_err(st.opt_G, st.G, g_before[0], new))
    adam_err = max(adam_errs)
    d32 = np.float32(tr.schedule(it).ema_decay)
    ema_ok = all(
        bool(((new[f"G_ema.{k}"] - (old_card[f"G_ema.{k}"] * float(d32) + new[f"G.{k}"] * float(np.float32(1) - d32)))
              .abs() <= 2 * ulp(new[f"G_ema.{k}"])).all())
        for k, _ in st.G.named_parameters()
    )
    # updates against the CPU's, beside what one ulp in the weights does to them: Adam
    # divides each gradient by the root of a second moment that is small after two steps
    keys = {n: [f"{n}.{k}" for k, _ in getattr(st, "G" if n == "G_ema" else n).named_parameters()]
            for n in ("G", "D", "G_ema")}
    upd_err = {n: update_err(new, new_cpu, old, ks) for n, ks in keys.items()}
    upd_ulp = {n: update_err({k: new_ulp[k] - old_ulp[k] + old[k] for k in ks}, new_cpu, old, ks) for n, ks in keys.items()}
    log(label, f"card vs CPU, fp32 B=4 step at iteration {it} (CPU steps {cpu_s:.1f} s): losses (relative) and D "
        f"outputs (abs) {value_err}, bars {value_bar} (1e-4, PL's {PL_BAR}, or twice the shift of the CPU against "
        f"itself with every weight one ulp up, {one_ulp_value}); raydrop decisions taken the other way, per fake, card {flips['card']}, "
        f"one ulp {flips['cpu_ulp']}, fed {flips['cpu_fed']} (at most {flip_bar}, on at most half the fakes; y_fake "
        f"per sample {y_fake_err}); "
        f"CPU fed the card's gradients {fed_value_err} (bar 1e-4); R1 penalty {penalty_err:.3g} relative and phase "
        f"gradients' max abs err over the largest magnitude {grad_err}, fed {fed_grad_err} (bars {grad_bar}: 1e-2, or "
        f"twice the one-ulp shift, {one_ulp}); G buffers {buf_err:.3g} of their largest (bar 1e-4); ADA state "
        f"{ada_err:.3g} (bar 1e-4); on the card G's {len(adam_errs)} update(s) Adam's on their moments within "
        f"{adam_errs} of the largest (bar 1e-4), the EMA e d + p (1 - d) within 2 ulps: {ema_ok}; parameter and EMA "
        f"updates against the CPU's {upd_err}, one ulp's {upd_ulp} (measured); metrics {m}")
    assert all(value_err[k] <= value_bar[k] for k in value_err), (value_err, value_bar)
    assert all(e <= 1e-4 for e in fed_value_err.values()), fed_value_err
    assert all(sum(flips[n]) <= flip_bar and 2 * sum(f > 0 for f in flips[n]) <= len(flips[n])
               for n in ("card", "cpu_fed")), (flips, flip_bar)
    assert penalty_err <= 1e-2 and all(max(grad_err[k], fed_grad_err[k]) <= grad_bar[k] for k in grad_err), \
        (penalty_err, grad_err, fed_grad_err, grad_bar)
    assert buf_err <= 1e-4 and ada_err <= 1e-4 and adam_err <= 1e-4 and ema_ok, (buf_err, ada_err, adam_errs, ema_ok)
    return {"iteration": it, "value_err": value_err, "value_bar": value_bar, "one_ulp_value_shift": one_ulp_value,
            "raydrop_flips": flips, "y_fake_err_per_sample": y_fake_err, "fed_value_err": fed_value_err,
            "penalty_err": penalty_err, "grad_err": grad_err, "fed_grad_err": fed_grad_err,
            "one_ulp_grad_shift": one_ulp, "grad_bar": grad_bar, "buffer_err": buf_err, "ada_err": ada_err,
            "adam_formula_err": adam_errs, "update_err": upd_err, "one_ulp_update_shift": upd_ulp, "metrics": m,
            "cpu_steps_s": cpu_s}


def train_bf16_vs_fp32(dev):
    """bench.py's steady step at B=128, bf16 against fp32, same weights and draws."""
    out, draws = {}, None
    for dtype, bf16 in (("bfloat16", True), ("float32", False)):
        cfg = full_train_cfg(bf16)
        cfg["training"]["batch_size"] = 128
        tr = Trainer(cfg, device=dev, seed=7)
        st = tr.init_state(seed=3)
        batch = train_batch(tr, 2)
        if draws is None:
            draws = record_draws(tr, st, batch, STEADY_IT)
        phases = {}
        m = tr.step(st, batch, STEADY_IT, draws=ReplayStream(draws, device=dev), on_phase=phase_recorder(phases))
        out[dtype] = ({k: float(v) for k, v in m.items()}, phases)
        del tr, st
        torch.cuda.empty_cache()
    (m16, ph16), (m32, ph32) = out["bfloat16"], out["float32"]
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    errs = {
        "y_real": rel_l2(ph16["d"][0]["y_real"], ph32["d"][0]["y_real"]),
        "y_fake": rel_l2(ph16["d"][0]["y_fake"], ph32["d"][0]["y_fake"]),
        "loss_G": abs(m16["loss/G/adversarial"] - m32["loss/G/adversarial"]) / abs(m32["loss/G/adversarial"]),
        "loss_D": abs(m16["loss/D/adversarial"] - m32["loss/D/adversarial"]) / abs(m32["loss/D/adversarial"]),
    }
    grads = {n: rel_l2(torch.cat([g.flatten() for g in ph16[n][1].values()]),
                       torch.cat([g.flatten() for g in ph32[n][1].values()])) for n in ("g", "d")}
    finite = all(bool(torch.isfinite(g).all()) for n in ("g", "d") for g in ph16[n][1].values())
    log("train", f"bf16 B=128 against fp32 B=128, steady step, same weights and draws: relative L2 of D's outputs "
        f"and relative loss differences {errs} (bar 0.15, the critic phase's), of the phase gradients {grads}; "
        f"bf16 gradients finite {finite}; losses bf16 {m16} fp32 {m32}")
    assert finite and all(e <= 0.15 for e in errs.values()), errs
    return {"errs": errs, "grad_rel_l2": grads, "metrics_bf16": m16, "metrics_fp32": m32}


def train_rates(tr, st, batch, label):
    """ms per step and imgs/s of bench.py's steady step and of the R1 step, device ms by
    kernel, idle share, peak GiB."""
    B = tr.batch_size
    counter = iter(range(10**6))
    steady = lambda: tr.step(st, batch, STEADY_IT + 48 * next(counter))  # noqa: E731
    r1 = lambda: tr.step(st, batch, 1_000_000 + 16 * next(counter))  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    steady_ms = cuda_ms(steady, reps=4, repeats=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    r1_ms = cuda_ms(r1, reps=2, repeats=3)
    r1_peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms, wall_ms, by_name = profile_ms(steady, reps=3)
    chain = {n: sum(t for k, t in by_name.items() if n in k) for n in ("fused_bias_act", "chain_fwd", "chain_bwd")}
    rec = {
        "label": label, "batch": B, "step_ms": steady_ms, "imgs_per_s": 1e3 * B / steady_ms, "peak_gib": peak,
        "r1_step_ms": r1_ms, "r1_peak_gib": r1_peak,
        # R1 every 16th step; ADA's p update (every 4th) adds no kernel of note
        "amortized_ms": (15 * steady_ms + r1_ms) / 16, "device_ms": dev_ms, "profiled_wall_ms": wall_ms,
        "device_idle_share": None if dev_ms is None else max(0.0, 1.0 - dev_ms / steady_ms),
        "kernels_ms": chain, "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
    }
    rec["amortized_imgs_per_s"] = 1e3 * B / rec["amortized_ms"]
    log("train-rates", f"{label}: steady step {steady_ms:.3f} ms = {rec['imgs_per_s']:.1f} imgs/s, peak {peak:.2f} "
        f"GiB; R1 step {r1_ms:.3f} ms, peak {r1_peak:.2f} GiB; amortized {rec['amortized_ms']:.3f} ms = "
        f"{rec['amortized_imgs_per_s']:.1f} imgs/s; device {dev_ms} ms per steady step, idle share "
        f"{rec['device_idle_share']}; K1 / K4 / K5 device ms {chain}")
    log("train-rates", "  top device ms per steady step: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in rec["top_device_ms"]))
    return rec


def phase_train(dev, smi):
    """The training step through Trainer: variants and launch counts, card against CPU,
    bf16 against fp32, rates."""
    card_vs_cpu = train_card_vs_cpu(dev)
    bf16_vs_fp32 = train_bf16_vs_fp32(dev)

    # every variant once at bf16 B=128, the counters read around each step
    tr = Trainer(full_train_cfg(True), device=dev, seed=0)
    st = tr.init_state(seed=0)
    batch = train_batch(tr, 0)
    variants = {}
    for it, want in TRAIN_VARIANTS.items():
        sched = tr.schedule(it)
        assert (sched.do_r1, sched.do_ada, sched.skip_warmup) == want, (it, sched)
        read_and_reset(CHAIN_COUNTERS)
        t0 = time.perf_counter()
        m = tr.step(st, batch, it)
        metrics = {k: float(v) for k, v in m.items()}
        seconds = time.perf_counter() - t0
        launches = read_and_reset(CHAIN_COUNTERS)
        variants[it] = {"r1_ada_steady": want, "launches": launches, "metrics": metrics, "first_call_s": seconds}
        log("train", f"bf16 B=128 iteration {it} (R1, ADA, warmup faded = {want}): {seconds:.3f} s (first call of "
            f"the variant); launches {launches}; {metrics}")
        assert launches == STEP_LAUNCHES[want[0]], (it, launches)
        assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert st.step == len(TRAIN_VARIANTS)

    rates = [train_rates(tr, st, batch, "bf16 B=128")]
    del tr, st, batch
    torch.cuda.empty_cache()
    tr = Trainer(full_train_cfg(False), device=dev, seed=0)
    st = tr.init_state(seed=0)
    batch = train_batch(tr, 0)
    tr.step(st, batch, 0)
    rates.append(train_rates(tr, st, batch, "fp32 B=32, TF32 off"))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        rates.append(train_rates(tr, st, batch, "fp32 B=32, TF32 allowed"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    del tr, st
    torch.cuda.empty_cache()
    steady = variants[STEADY_IT]["launches"]
    return steady, {"card_vs_cpu": card_vs_cpu, "bf16_vs_fp32": bf16_vs_fp32, "variants": variants,
                    "rates": rates, "nvidia_smi": smi}


# the GAN command lines: a fabricated KITTI Raw tree (train frames of odometry sequence 00's
# drive, test frames of a city drive outside train/val), 64 rings x 2048 azimuths a frame
CLI_TRAIN_SEQ, CLI_TEST_SEQ = "2011_10_03_drive_0027_sync", "2011_09_26_drive_0001_sync"
CLI_TRAIN_FRAMES, CLI_TEST_FRAMES, CLI_RINGS, CLI_AZIMUTHS = 32, 64, 64, 2048
CLI_SPLIT, CLI_ITERS = 8, 16  # train 1-8 and checkpoint, then resume to 16 (R1 at 16, ADA at 4, 8, 12, 16)
CLI_WINDOW = (9, 15)  # the resumed run's iterations timed: no R1, no checkpoint
CLI_METRICS = "swd,jsd,1nna-cd,1nna-emd,fpd,kpd"
CLI_PL_IT = 1_000_004  # bf16 B=128 with pl 2 (lazy 4): PL + ADA, no R1, warmup faded; it adds 16 a step
PL_K1 = 18  # a PL phase's G forwards (eval, then train from w): 9 bias-act sites each


def fabricated_scan(rng):
    """One ring-ordered 64-beam scan (x, y, z, intensity): each ring starts just inside the
    first quadrant and wraps once, as scan unfolding reads a spinning LiDAR; ranges of
    2-100 m (some beyond the 80 m limit) and 8% of the returns missing (never a ring's
    first, which marks the ring)."""
    H, W = CLI_RINGS, CLI_AZIMUTHS
    elev = np.deg2rad(3.0 - 28.0 * np.arange(H) / (H - 1))[:, None]
    phis = np.linspace(0.003, 2 * np.pi - 0.003, W)[None, :]
    r = 2.0 + 98.0 * rng.rand(H, W) ** 2
    pts = np.stack([r * np.cos(elev) * np.cos(phis), r * np.cos(elev) * np.sin(phis),
                    r * np.sin(elev) * np.ones_like(phis), rng.rand(H, W)], axis=-1)
    keep = rng.rand(H, W) > 0.08
    keep[:, 0] = True
    return pts[keep].astype(np.float32)


def fabricate_kitti(root: Path, seed=0):
    rng = np.random.RandomState(seed)
    for seq, n in ((CLI_TRAIN_SEQ, CLI_TRAIN_FRAMES), (CLI_TEST_SEQ, CLI_TEST_FRAMES)):
        d = root / seq[:10] / seq / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            fabricated_scan(rng).tofile(d / f"{i:010d}.bin")


def payload_equal(a, b, where="state"):
    """Names of the tensors and values that differ between two checkpoint state payloads."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [where]
        return [w for k in a for w in payload_equal(a[k], b[k], f"{where}.{k}")]
    if torch.is_tensor(a):
        return [] if a.dtype == b.dtype and torch.equal(a, b) else [where]
    return [] if a == b else [where]


def device_busy_ms(prof):
    """The union of the card's kernel and copy intervals in a profile, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


class StepWindow:
    """Wraps `cls.step` (Trainer's, or SemsegTrainer's) while a CLI runs: synchronizes the
    card before iteration `first` and after iteration `last` and times that window on the
    host clock; with `profile`, torch.profiler records the window, and `busy_ms` is the
    union of the device's kernel and copy intervals in it. The iteration is the step's
    last positional argument."""

    def __init__(self, first, last, profile=False, cls=Trainer):
        self.first, self.last, self.profile, self.cls = first, last, profile, cls
        self.ms = self.busy_ms = None

    def __enter__(self):
        self._orig = self.cls.step
        window = self

        def step(tr, *args, **kwargs):
            iteration = args[-1]
            if iteration == window.first:
                torch.cuda.synchronize()
                if window.profile:
                    window._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    window._prof.start()
                window._t0 = time.perf_counter()
            m = window._orig(tr, *args, **kwargs)
            if iteration == window.last:
                torch.cuda.synchronize()
                window.ms = 1e3 * (time.perf_counter() - window._t0)
                if window.profile:
                    window._prof.stop()
                    window.busy_ms = device_busy_ms(window._prof)  # the copy stream overlaps the compute
            return m

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self._orig


def loader_ms(root: Path):
    """Host ms of the training loader (cache: ram, 4 threads) per batch of 128 at 64x512:
    the first batch (every frame projected once), and the mean of the next five (the
    cache serves them); and ms of one frame's projection + resize."""
    ds = KITTIRaw(str(root), "train", shape=(64, 512), min_depth=1.45, max_depth=80.0, prune_missing=True, cache="ram")
    one = KITTIRaw(str(root), "train", shape=(64, 512), min_depth=1.45, max_depth=80.0, prune_missing=True)
    t0 = time.perf_counter()
    for i in range(4):
        one[i]
    frame_ms = 1e3 * (time.perf_counter() - t0) / 4
    it = iter(Prefetcher(ds, B_WIDE, InfiniteSampler(len(ds), seed=0), num_workers=4))
    t0 = time.perf_counter()
    next(it)
    t1 = time.perf_counter()
    for _ in range(5):
        next(it)
    t2 = time.perf_counter()
    it.close()
    return {"first_batch_ms": 1e3 * (t1 - t0), "cached_batch_ms": 1e3 * (t2 - t1) / 5, "frame_ms": frame_ms}


def pl_rates(dev):
    """bf16 B=128 with pl 2: ms of the PL step (PL + ADA) beside the steady step, both
    warmup faded, CUDA events; the PL step's launches and peak GiB."""
    cfg = full_train_cfg(True)
    cfg["training"]["loss"]["pl"] = 2
    tr = Trainer(cfg, device=dev, seed=0)
    st = tr.init_state(seed=0)
    batch = train_batch(tr, 0)
    assert tr.schedule(CLI_PL_IT).do_pl and not tr.schedule(CLI_PL_IT).do_r1 and not tr.schedule(STEADY_IT).do_pl
    read_and_reset(CHAIN_COUNTERS)
    m = tr.step(st, batch, CLI_PL_IT)
    launches = read_and_reset(CHAIN_COUNTERS)
    want = dict(STEP_LAUNCHES[False], fused_bias_act=STEP_LAUNCHES[False]["fused_bias_act"] + PL_K1)
    assert launches == want, (launches, want)
    metrics = {k: float(v) for k, v in m.items()}
    assert all(math.isfinite(v) for v in metrics.values()) and metrics["loss/G/path_length"] > 0, metrics
    counter = iter(range(1, 10**6))
    torch.cuda.reset_peak_memory_stats()
    pl_ms = cuda_ms(lambda: tr.step(st, batch, CLI_PL_IT + 16 * next(counter)), reps=2, repeats=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady_ms = cuda_ms(lambda: tr.step(st, batch, STEADY_IT + 48 * next(counter)), reps=2, repeats=3)
    rec = {"pl_step_ms": pl_ms, "steady_step_ms": steady_ms, "pl_peak_gib": peak, "launches": launches,
           "metrics": metrics}
    log("cli", f"bf16 B=128, pl 2: PL step (PL + ADA) {pl_ms:.3f} ms, steady step {steady_ms:.3f} ms in the same "
        f"call, peak {peak:.2f} GiB; PL step launches {launches}; {metrics}")
    del tr, st
    torch.cuda.empty_cache()
    return rec


def phase_cli(dev, smi, bare_step_rate):
    """The port's command lines in process, through main(argv), at full width and depth."""
    import tempfile

    from dusty_gan_v2_tpu_torch.cli import test_gan, train_gan
    from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt
    from dusty_gan_v2_tpu_torch.training.checkpoint import load_checkpoint, state_payload
    from dusty_gan_v2_tpu_torch.utils.config import load_config, save_config

    rec = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        fabricate_kitti(tmp / "kitti_raw")
        rec["fabricate_s"] = time.perf_counter() - t0
        cfg = load_config(str(Path(__file__).resolve().parent / "configs" / "gans" / "dusty_v2_bf16.yaml"))
        cfg.dataset.root, cfg.dataset.prune_missing = str(tmp / "kitti_raw"), True
        ck = cfg.training.checkpoint
        ck.save_stats, ck.save_model, ck.validation, ck.save_image = 4, CLI_SPLIT, 10**9, CLI_SPLIT
        B = int(cfg.training.batch_size)
        paths = {}
        for name, iters in (("first", CLI_SPLIT), ("full", CLI_ITERS)):
            cfg.training.total_kimg = iters * B / 1e3
            paths[name] = tmp / f"gan_{name}.yaml"
            save_config(cfg, str(paths[name]))
        log_dir = tmp / "logs"
        args = ["--num_workers", "4", "--device", str(dev)]

        read_and_reset(CHAIN_COUNTERS)
        t0 = time.perf_counter()
        _, saved = train_gan.main(["--config", str(paths["first"]), "--log_dir", str(log_dir / "a")] + args)
        torch.cuda.synchronize()
        rec["first_run_s"] = time.perf_counter() - t0
        first = read_and_reset(CHAIN_COUNTERS)
        want_first = {k: CLI_SPLIT * v + (G_K1 if k == "fused_bias_act" else 0) for k, v in STEP_LAUNCHES[False].items()}
        log("cli", f"train_gan, bf16 B=128, iterations 1-{CLI_SPLIT}: {rec['first_run_s']:.2f} s (process start "
            f"to checkpoint, first calls included); launches {first} (want {want_first})")
        assert first == want_first, (first, want_first)
        mid = log_dir / "a" / "models" / f"checkpoint_{CLI_SPLIT * B:010d}.ckpt"
        # the image tick at iteration 8 (G_ema's fixed-z fakes: one more G forward) and the
        # real frames' panels at the start, under the JAX CLI's tags
        tick = np.load(log_dir / "a" / "images" / f"step_{CLI_SPLIT * B:010d}.npz")
        start = np.load(log_dir / "a" / "images" / f"step_{1:010d}.npz")
        panels = {"real/image/aug", "fake/image/orig", "fake/raydrop_prob", "fake/raydrop_mask", "fake/image",
                  "fake/image/spectrum", "fake/normal", "fake/pointcloud"}
        assert panels <= set(tick.files) and tick["fake/pointcloud"].shape == (8, 3, 512, 512), tick.files
        assert all(np.isfinite(tick[k]).all() for k in panels) and "real/pointcloud" in start.files, start.files
        rec["image_tick_panels"] = sorted(tick.files)

        # the state loaded on resume equals the state saved, bit for bit
        template = Trainer(load_config(str(paths["full"])), device=dev, seed=0).init_state(seed=5)
        _, loaded, _, num_imgs = load_checkpoint(str(mid), template)
        differ = payload_equal(state_payload(saved), state_payload(loaded))
        log("cli", f"checkpoint at {num_imgs} images: {mid.stat().st_size / 2**20:.1f} MiB; loaded state equals "
            f"the saved one bit for bit: {not differ} {differ[:5]}")
        assert num_imgs == CLI_SPLIT * B and loaded.step == CLI_SPLIT and not differ, differ
        del saved, loaded, template
        torch.cuda.empty_cache()

        with StepWindow(*CLI_WINDOW) as window:
            t0 = time.perf_counter()
            _, final_state = train_gan.main(["--config", str(paths["full"]), "--log_dir", str(log_dir / "b"),
                                             "--resume", str(mid)] + args)
            torch.cuda.synchronize()
            rec["resume_run_s"] = time.perf_counter() - t0
        second = read_and_reset(CHAIN_COUNTERS)
        want_second = {k: (CLI_ITERS - CLI_SPLIT - 1) * v + STEP_LAUNCHES[True][k] + (G_K1 if k == "fused_bias_act" else 0)
                       for k, v in STEP_LAUNCHES[False].items()}
        n_win = CLI_WINDOW[1] - CLI_WINDOW[0] + 1
        rec["cli_window_ms_per_iter"] = window.ms / n_win
        rec["cli_imgs_per_s"] = 1e3 * B * n_win / window.ms
        rec["bare_step_imgs_per_s"] = bare_step_rate
        rows = [json.loads(line) for line in (log_dir / "b" / "stats.jsonl").read_text().splitlines()]
        log("cli", f"train_gan --resume, iterations {CLI_SPLIT + 1}-{CLI_ITERS}: {rec['resume_run_s']:.2f} s; "
            f"iterations {CLI_WINDOW[0]}-{CLI_WINDOW[1]} {window.ms:.1f} ms = {rec['cli_window_ms_per_iter']:.3f} ms an "
            f"iteration, {rec['cli_imgs_per_s']:.1f} imgs/s (phase 9's bare steady step: {bare_step_rate:.1f}); "
            f"launches {second} (want {want_second}); stats rows {rows}")
        assert second == want_second, (second, want_second)
        assert final_state.step == CLI_ITERS and [r["iteration"] for r in rows] == [12, 16]
        assert all(math.isfinite(v) for r in rows for v in r.values()), rows
        assert "loss/D/gradient_penalty" in rows[-1] and "stats/ada_rt" in rows[-1], rows
        rec["stats"], rec["launches"] = rows, {k: first[k] + second[k] for k in first}
        del final_state
        torch.cuda.empty_cache()

        # the idle share: the device's busy time in the same window of a second resumed run,
        # under the profiler, over the unprofiled window (the profiler's host work stretches
        # its own window; the kernels' device intervals are the same work)
        with StepWindow(*CLI_WINDOW, profile=True) as pwin:
            train_gan.main(["--config", str(paths["full"]), "--log_dir", str(log_dir / "c"), "--resume", str(mid)]
                           + args)
        read_and_reset(CHAIN_COUNTERS)
        rec["profiled_window_ms"], rec["device_busy_ms"] = pwin.ms, pwin.busy_ms
        rec["profiler_stretch"] = pwin.ms / window.ms
        rec["device_idle_share"] = max(0.0, 1.0 - pwin.busy_ms / window.ms)
        rec["profiled_idle_share"] = max(0.0, 1.0 - pwin.busy_ms / pwin.ms)
        log("cli", f"profiled resumed run, iterations {CLI_WINDOW[0]}-{CLI_WINDOW[1]}: {pwin.ms:.1f} ms "
            f"({rec['profiler_stretch']:.3f} x the unprofiled {window.ms:.1f} ms), device busy {pwin.busy_ms:.1f} ms "
            f"(union of kernel and copy intervals): idle share {rec['device_idle_share']:.3f} of the unprofiled "
            f"window ({rec['profiled_idle_share']:.3f} of the profiled one)")
        torch.cuda.empty_cache()

        final = log_dir / "b" / "models" / f"checkpoint_{CLI_ITERS * B:010d}.ckpt"
        ckpt = autoload_ckpt(str(final), dev)
        assert ckpt["step"] == CLI_ITERS * B and ckpt["state"]["iteration"] == CLI_ITERS
        del ckpt

        rec["loader"] = loader_ms(tmp / "kitti_raw")
        log("cli", f"loader, B=128 at 64x512, 4 threads, host ms: {rec['loader']}")

        rec["pl_card_vs_cpu"] = train_card_vs_cpu(dev, it=36, pl=2, label="cli-pl")
        rec["pl_rates"] = pl_rates(dev)

        out = tmp / "scores.json"
        fps_cuda.launches = emd_cuda.launches = 0
        read_and_reset(CHAIN_COUNTERS)
        t0 = time.perf_counter()
        scores, stages = test_gan.main([
            "--ckpt_path", str(final), "--metrics", CLI_METRICS, "--num_samples", str(N_CLOUDS),
            "--num_subsample", str(N_CLOUDS), "--pointnet_ckpt", "random", "--out", str(out), "--device", str(dev),
        ])
        rec["test_gan_s"] = time.perf_counter() - t0
        eval_launches = {"fused_bias_act": read_and_reset(CHAIN_COUNTERS)["fused_bias_act"], "fps": fps_cuda.launches,
                         "emd": emd_cuda.launches}
        written = json.loads(out.read_text())
        log("cli", f"test_gan --metrics {CLI_METRICS}, {N_CLOUDS} + {N_CLOUDS} clouds: {rec['test_gan_s']:.2f} s; "
            f"seconds per stage {stages}; launches {eval_launches}; scores {scores}")
        assert written == scores and all(math.isfinite(v) for v in scores.values()), scores
        assert {"jsd", "fpd", "kpd"} <= set(scores) and any(k.endswith("-emd") for k in scores), scores
        assert eval_launches == {"fused_bias_act": 9, "fps": 3, "emd": 48}, eval_launches
        rec.update(test_gan_stage_s=stages, test_gan_scores=scores, test_gan_launches=eval_launches)
    return rec


# phase 11, semseg: configs/semseg/sim2real_w_gan_noise_dustyv2_bf16.yaml (SqueezeSegV2 + CAM +
# CRF, bf16, B=120, focal loss) on frames fabricated from seed 0 at the release's 64 x 512:
# 240 GTA frames with DUSty v2 drop maps (two batches), 64 KITTI frontal val frames
SEMSEG_CFG = Path(__file__).resolve().parent / "configs" / "semseg" / "sim2real_w_gan_noise_dustyv2_bf16.yaml"
SEMSEG_GTA, SEMSEG_VAL, SEMSEG_STEPS = 240, 64, 16
SEMSEG_WINDOW = (5, 16)  # the CLI's steps timed (stats drains at 8 and 12 inside)
SEMSEG_BENCH_B = 40  # the batch bench.py times
SEMSEG_BF16_CAL_BAR = 0.75  # relative L2 of bf16 logits against fp32 on calibrated BN statistics
SEMSEG_CONFIG = (120, "bfloat16", True, "focal_loss")  # batch, compute dtype, CRF, loss of SEMSEG_CFG


def semseg_frame(rng, gta):
    """One 64 x 512 frontal frame: (x, y, z, intensity, depth, label), GTA's without the
    intensity and with 3 classes; depths 2-60 m, 15% of the rays missing."""
    H, W = 64, 512
    depth = rng.uniform(2.0, 60.0, (H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.15] = 0.0
    azim = np.linspace(np.pi / 4, -np.pi / 4, W, dtype=np.float32)[None]
    elev = np.linspace(0.03, -0.4, H, dtype=np.float32)[:, None]
    label = rng.randint(0, 3 if gta else 4, (H, W)).astype(np.float32)
    label[depth == 0] = 0
    planes = [depth * np.cos(elev) * np.cos(azim), depth * np.cos(elev) * np.sin(azim), depth * np.sin(elev)]
    planes += [depth, label] if gta else [rng.rand(H, W).astype(np.float32), depth, label]
    return np.stack(planes, axis=-1).astype(np.float32)


def fabricate_semseg(root: Path, seed=0):
    """The release's layout: GTAV/<seq>/*.npy, GTAV_noise_v2/<seq>/*.npy, lidar_2d/*.npy and
    ImageSet/val.txt."""
    rng = np.random.RandomState(seed)
    for d in ("GTAV/seq0", "GTAV_noise_v2/seq0", "lidar_2d", "ImageSet"):
        (root / d).mkdir(parents=True)
    for i in range(SEMSEG_GTA):
        np.save(root / "GTAV" / "seq0" / f"{i:06d}.npy", semseg_frame(rng, True))
        np.save(root / "GTAV_noise_v2" / "seq0" / f"{i:06d}.npy", rng.uniform(0.6, 1.0, (64, 512)).astype(np.float32))
    names = [f"2011_09_26_drive_0001_{i:010d}" for i in range(SEMSEG_VAL)]
    for n in names:
        np.save(root / "lidar_2d" / f"{n}.npy", semseg_frame(rng, False))
    (root / "ImageSet" / "val.txt").write_text("\n".join(names) + "\n")


def semseg_cfg(root: Path, dtype="bfloat16", use_crf=True):
    from dusty_gan_v2_tpu_torch.utils.config import load_config

    cfg = load_config(str(SEMSEG_CFG))
    cfg.dataset.root = str(root)
    cfg.arch.compute_dtype, cfg.arch.use_crf = dtype, use_crf
    return cfg


def semseg_batch(root: Path, B, dev, offset=0):
    """B GTA items (flip and ray drop as the loader draws them) as the CLI ships them: float
    planes in float32, label and mask as uint8."""
    from dusty_gan_v2_tpu_torch.semseg import GTALiDAR_GAN

    ds = GTALiDAR_GAN(root=str(root), shape=(64, 512), flip=True, gan_dir="GTAV_noise_v2")
    items = [ds[(offset + i) % len(ds)] for i in range(B)]
    host = {k: np.stack([it[k] for it in items]) for k in ("xyz", "depth", "label", "mask")}
    host["label"], host["mask"] = host["label"].astype(np.uint8), host["mask"].astype(np.uint8)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def semseg_trainer(cfg, dev, model=None):
    from dusty_gan_v2_tpu_torch.cli.train_semseg import build_model
    from dusty_gan_v2_tpu_torch.semseg.train_step import SemsegTrainer

    return SemsegTrainer(build_model(cfg) if model is None else model, cfg, dev)


def grads_dict(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def semseg_card_vs_cpu(dev, root):
    """One fp32 B=4 step at 64 x 512, TF32 off, on injected dropout masks, on the card and on
    the CPU from the same weights; a third run on the CPU with every weight one ulp up gives
    each value's rounding sensitivity. Then two more card steps held to the SGD chain's
    formula on the card's own gradients."""
    cfg = semseg_cfg(root, "float32")
    tr_cpu = semseg_trainer(cfg, "cpu")
    tr_dev = semseg_trainer(cfg, dev, copy.deepcopy(tr_cpu.model))
    ulp_model = copy.deepcopy(tr_cpu.model)
    with torch.no_grad():
        for p in ulp_model.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    tr_ulp = semseg_trainer(cfg, "cpu", ulp_model)
    batch = semseg_batch(root, 4, "cpu", offset=7)
    keep = torch.rand((len(batch["xyz"]), 64, 1, 1), generator=torch.Generator().manual_seed(3)) < 0.5
    runs = {}
    for name, tr, dv in (("card", tr_dev, dev), ("cpu", tr_cpu, "cpu"), ("ulp", tr_ulp, "cpu")):
        loss, logit = tr.forward_backward({k: v.to(dv) for k, v in batch.items()}, 1, keep=keep.to(dv))
        stats = {k: b.detach().cpu().clone() for k, b in tr.model.named_buffers() if k.endswith(("_mean", "_var"))}
        runs[name] = {"loss": {"loss": loss.cpu().reshape(1)}, "logit": {"logit": logit.cpu()}, "stats": stats,
                      "grads": {k: g.cpu() for k, g in grads_dict(tr.model).items()}}
    errs = {k: rel_max_err(runs["card"][k], runs["cpu"][k]) for k in runs["card"]}
    one_ulp = {k: rel_max_err(runs["ulp"][k], runs["cpu"][k]) for k in runs["card"]}
    bars = {k: max(1e-2 if k == "grads" else 1e-4, 2 * one_ulp[k]) for k in errs}
    log("semseg", f"card vs CPU, fp32 B=4 64x512 step 1 (relative to the largest magnitude): {errs}; one ulp in "
        f"the weights on the CPU: {one_ulp}; bars {bars}")
    assert all(errs[k] <= bars[k] for k in errs), (errs, bars)

    # the card's update is the chain's formula on its own gradients: clip to the global
    # norm (optax's g / |g| * max), weight decay, momentum (the first step's buffer is d)
    t, model = cfg.training, tr_dev.model
    update_err, buf = [], None
    for step in (1, 2):
        if step == 2:
            tr_dev.forward_backward(semseg_batch(root, 4, dev, offset=11), 2, keep=keep.to(dev))
        g = {k: v.double() for k, v in grads_dict(model).items()}
        p_old = {k: p.detach().double() for k, p in model.named_parameters()}
        norm = math.sqrt(sum(float((v * v).sum()) for v in g.values()))
        scale = 1.0 if norm < t.max_grad_norm else t.max_grad_norm / norm
        d = {k: g[k] * scale + t.weight_decay * p_old[k] for k in g}
        buf = d if buf is None else {k: t.lr_momentum * buf[k] + d[k] for k in d}
        tr_dev.update(step)
        ref = {k: p_old[k] - tr_dev.lr(step) * buf[k] for k in d}
        update_err.append(rel_max_err({k: p.detach().double() for k, p in model.named_parameters()}, ref))
    log("semseg", f"card's SGD updates against the chain's formula on its gradients: {update_err} (bar 1e-6; "
        f"global norms clipped to {t.max_grad_norm})")
    assert all(e <= 1e-6 for e in update_err), update_err
    return {"errors": errs, "one_ulp": one_ulp, "bars": bars, "update_err": update_err}


def semseg_knn_equal(dev, root):
    """knn2d labels on 8 val frames' normalized depth (masked pixels < 0, whole windows tied
    at +inf) with random labels: the card's equal the CPU's, at k 3 / kernel 3 and k 5 /
    kernel 5; and the card's ms at B=32 (test_semseg's batch)."""
    from dusty_gan_v2_tpu_torch.semseg import KITTIRawFrontal, knn2d

    ds = KITTIRawFrontal(root=str(root), split="val", shape=(64, 512), omit_cyclist=True)
    depth = torch.from_numpy(np.stack([ds[i]["depth"] for i in range(32)]))
    label = torch.randint(0, 3, (32, 64, 512), generator=torch.Generator().manual_seed(4))
    rec = {}
    for k, ks in ((3, 3), (5, 5)):
        ref = knn2d(depth[:8], label[:8], 3, k=k, kernel_size=(ks, ks))
        got = knn2d(depth[:8].to(dev), label[:8].to(dev), 3, k=k, kernel_size=(ks, ks)).cpu()
        assert torch.equal(got, ref), f"knn2d k={k} kernel {ks}: card and CPU labels differ"
        d32, l32 = depth.to(dev), label.to(dev)
        rec[f"k{k}_kernel{ks}_B32_ms"] = cuda_ms(lambda: knn2d(d32, l32, 3, k=k, kernel_size=(ks, ks)), reps=5,
                                                 repeats=3)
    rec["changed_share"] = float((ref != label[:8]).float().mean())
    log("semseg", f"knn2d labels equal on the card and the CPU (8 frames, 64x512); {rec}")
    return rec


def semseg_bf16_vs_fp32(dev, root):
    """Eval-mode logits (CRF on) of the bf16 policy against fp32 on the same weights at B=40,
    in two states of the BN statistics. At their init: max |difference| <= 0.02 of the
    largest |logit| (the JAX package's own bar) and relative L2 <= 5e-2. Set to a
    calibration batch's (one fp32 train-mode pass with momentum 1): relative L2 <=
    SEMSEG_BF16_CAL_BAR (the JAX package's bf16 policy reads 0.448 in that state on the CPU,
    tests/test_torch_semseg.py::test_bf16_policy_against_fp32)."""
    from dusty_gan_v2_tpu_torch.cli.train_semseg import build_model
    from dusty_gan_v2_tpu_torch.semseg.common import BatchNorm2d

    m32 = build_model(semseg_cfg(root, "float32")).to(dev)
    m16 = build_model(semseg_cfg(root, "bfloat16")).to(dev)
    calib, batch = semseg_batch(root, SEMSEG_BENCH_B, dev, offset=SEMSEG_BENCH_B), semseg_batch(root, SEMSEG_BENCH_B, dev)
    rec = {}
    with torch.no_grad():
        for state in ("init", "calibrated"):
            if state == "calibrated":
                bns = [m for m in m32.modules() if isinstance(m, BatchNorm2d)]
                for bn in bns:
                    bn.momentum = 1.0
                xyz = calib["xyz"]
                m32(torch.cat([xyz, calib["depth"]], 1), xyz, calib["mask"].float(), train=True,
                    keep=torch.ones((len(xyz), 64, 1, 1), dtype=torch.bool, device=dev))
                for bn in bns:
                    bn.momentum = 0.001
            m16.load_state_dict(m32.state_dict())
            xyz, mask = batch["xyz"], batch["mask"].float()
            x = torch.cat([xyz, batch["depth"]], 1)
            y32, y16 = m32(x, xyz, mask), m16(x, xyz, mask)
            assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
            rec[state] = {"rel_l2": float(torch.linalg.vector_norm(y16 - y32) / torch.linalg.vector_norm(y32)),
                          "max_abs_over_scale": float((y16 - y32).abs().max() / y32.abs().max())}
    log("semseg", f"bf16 vs fp32 eval-mode logits at B={SEMSEG_BENCH_B}: {rec} (bars: init 0.02 max abs over scale "
        f"and 5e-2 relative L2; calibrated {SEMSEG_BF16_CAL_BAR} relative L2)")
    assert rec["init"]["max_abs_over_scale"] <= 0.02 and rec["init"]["rel_l2"] <= 5e-2, rec
    assert rec["calibrated"]["rel_l2"] <= SEMSEG_BF16_CAL_BAR, rec
    del m32, m16
    torch.cuda.empty_cache()
    return rec


def semseg_rates(dev, root):
    """ms per bare step and imgs/s (CUDA events), peak GiB; for the bf16 rows the device ms
    from the profiler, its top 8 and the idle share over the unprofiled step."""
    rows = []
    for label, dtype, B, use_crf, tf32, prof in (
        ("fp32 B=40, TF32 off", "float32", 40, True, False, False),
        ("fp32 B=40, TF32 allowed", "float32", 40, True, True, False),
        ("bf16 B=40", "bfloat16", 40, True, False, True),
        ("bf16 B=120", "bfloat16", 120, True, False, True),
        ("bf16 B=120, no CRF", "bfloat16", 120, False, False, True),
    ):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            tr = semseg_trainer(semseg_cfg(root, dtype, use_crf), dev)
            batch = semseg_batch(root, B, dev)
            counter = iter(range(1, 10**6))
            step = lambda: tr.step(batch, next(counter))  # noqa: E731
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, reps=3, repeats=3)
            rec = {"label": label, "batch": B, "step_ms": ms, "imgs_per_s": 1e3 * B / ms,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if prof:
                dev_ms, wall_ms, by_name = profile_ms(step, reps=3)
                rec.update(device_ms=dev_ms, profiled_wall_ms=wall_ms,
                           device_idle_share=None if dev_ms is None else max(0.0, 1.0 - dev_ms / ms),
                           top_device_ms=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        del tr, batch
        torch.cuda.empty_cache()
        log("semseg-rates", f"{label}: {ms:.3f} ms a step = {rec['imgs_per_s']:.1f} imgs/s, peak {rec['peak_gib']:.2f} "
            f"GiB; device {rec.get('device_ms')} ms, idle share {rec.get('device_idle_share')}")
        if prof:
            log("semseg-rates", "  top device ms per step: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in rec["top_device_ms"]))
        rows.append(rec)
    crf, no_crf = rows[3]["step_ms"], rows[4]["step_ms"]
    log("semseg-rates", f"the CRF's share of the bf16 B=120 step: {(crf - no_crf) / crf:.3f} ({crf - no_crf:.3f} ms)")
    return {"rows": rows, "crf_share_b120": (crf - no_crf) / crf}


def phase_semseg(dev, smi):
    """The semseg command lines in process, through main(argv), on the bf16 CRF config at
    B=120, then the checks and rates. The path launches none of K1-K5."""
    import tempfile

    from dusty_gan_v2_tpu_torch.cli import test_semseg, train_semseg
    from dusty_gan_v2_tpu_torch.semseg.train_step import SemsegTrainer, load_checkpoint
    from dusty_gan_v2_tpu_torch.utils.config import save_config

    rec = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_semseg_") as tmp:
        tmp = Path(tmp)
        root = tmp / "kitti_raw_frontal"
        t0 = time.perf_counter()
        fabricate_semseg(root)
        rec["fabricate_s"] = time.perf_counter() - t0
        cfg = semseg_cfg(root)
        cfg.training.max_steps = SEMSEG_STEPS
        ck = cfg.training.checkpoint
        ck.stats, ck.test = 4, SEMSEG_STEPS
        B = int(cfg.training.batch_size)
        assert (B, cfg.arch.compute_dtype, cfg.arch.use_crf, cfg.loss.name) == SEMSEG_CONFIG
        save_config(cfg, str(tmp / "semseg.yaml"))
        args = ["--config", str(tmp / "semseg.yaml"), "--num_workers", "4", "--device", str(dev)]

        read_and_reset(CHAIN_COUNTERS)
        fps_cuda.launches = emd_cuda.launches = 0
        with StepWindow(*SEMSEG_WINDOW, cls=SemsegTrainer) as window:
            t0 = time.perf_counter()
            trainer = train_semseg.main(args + ["--log_dir", str(tmp / "logs_a")])
            torch.cuda.synchronize()
            rec["train_s"] = time.perf_counter() - t0
        n_win = SEMSEG_WINDOW[1] - SEMSEG_WINDOW[0] + 1
        rec["cli_window_ms_per_step"] = window.ms / n_win
        rec["cli_imgs_per_s"] = 1e3 * B * n_win / window.ms
        rows = [json.loads(line) for line in (tmp / "logs_a" / "stats.jsonl").read_text().splitlines()]
        log("semseg", f"train_semseg, bf16 B={B} + CRF, steps 1-{SEMSEG_STEPS}: {rec['train_s']:.2f} s (process start "
            f"to checkpoint); steps {SEMSEG_WINDOW[0]}-{SEMSEG_WINDOW[1]} {window.ms:.1f} ms = "
            f"{rec['cli_window_ms_per_step']:.3f} ms a step, {rec['cli_imgs_per_s']:.1f} imgs/s; stats rows {rows}")
        assert [r["step"] for r in rows] == [4, 8, 12, 16, 16], rows
        assert all(math.isfinite(v) for r in rows for v in r.values() if not isinstance(v, list)), rows
        ckpt = tmp / "logs_a" / "models" / f"checkpoint_step-{SEMSEG_STEPS:010d}.ckpt"
        _, payload = load_checkpoint(str(ckpt))
        saved = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        differ = payload_equal({**payload["params"], **payload["batch_stats"]}, saved)
        log("semseg", f"checkpoint {ckpt.stat().st_size / 2**20:.1f} MiB at step {payload['step']}; loaded equals the "
            f"trained state bit for bit: {not differ} {differ[:5]}")
        assert payload["step"] == SEMSEG_STEPS and not differ, differ
        del trainer, payload, saved
        torch.cuda.empty_cache()

        # the idle share: the device's busy time in the same window of a second run, under the
        # profiler, over the unprofiled window
        with StepWindow(*SEMSEG_WINDOW, profile=True, cls=SemsegTrainer) as pwin:
            train_semseg.main(args + ["--log_dir", str(tmp / "logs_b")])
        rec["profiled_window_ms"], rec["device_busy_ms"] = pwin.ms, pwin.busy_ms
        rec["device_idle_share"] = max(0.0, 1.0 - pwin.busy_ms / window.ms)
        log("semseg", f"profiled second run, steps {SEMSEG_WINDOW[0]}-{SEMSEG_WINDOW[1]}: {pwin.ms:.1f} ms, device busy "
            f"{pwin.busy_ms:.1f} ms: idle share {rec['device_idle_share']:.3f} of the unprofiled window")
        torch.cuda.empty_cache()

        # each evaluation twice, in turns: the first call of the first one sets up cuDNN
        rec["test_semseg"] = {}
        for knn in (False, True, False, True):
            out = tmp / f"scores_{knn}.json"
            scores, info = test_semseg.main(["--ckpt_path", str(ckpt), "--dataset_root", str(root), "--out", str(out),
                                             "--device", str(dev)] + (["--knn"] if knn else []))
            assert json.loads(out.read_text()) == scores and info["frames"] == SEMSEG_VAL
            assert all(math.isfinite(v) and 0 <= v <= 1 for k in scores for v in scores[k]), scores
            rec["test_semseg"].setdefault("knn" if knn else "plain", []).append(
                {"scores": scores, "seconds": info["seconds"], "frames_per_s": info["frames"] / info["seconds"]})
            log("semseg", f"test_semseg{' --knn' if knn else ''}: {info['frames']} frames in {info['seconds']:.3f} s = "
                f"{info['frames'] / info['seconds']:.1f} frames/s; {scores}")
        launches = {**read_and_reset(CHAIN_COUNTERS), "fps": fps_cuda.launches, "emd": emd_cuda.launches}
        log("semseg", f"K1-K5 launches over train_semseg (two runs) and test_semseg (four): {launches}")
        assert not any(launches.values()), launches
        rec["k1_k5_launches"] = launches

        rec["card_vs_cpu"] = semseg_card_vs_cpu(dev, root)
        rec["knn"] = semseg_knn_equal(dev, root)
        rec["bf16_vs_fp32"] = semseg_bf16_vs_fp32(dev, root)
        rec["rates"] = semseg_rates(dev, root)
    return rec


# phase 12: the DUSty v1 and vanilla families at full width (configs/gans/dusty_v1.yaml: DUSty v1 G
# + vanilla D; vanilla.yaml: vanilla G + vanilla D; ch_base 64, ch_max 512, 64 x 512, z 512, float32)
OTHER_CONFIGS = ("dusty_v1", "vanilla")
# bias-act sites: the projection and up1-3 in either G (the head has none), down1-4 in the D
OTHER_K1_G = OTHER_K1_D = 4
# K1 a step: G phase G + D forward, D phase G + two D forwards; R1 one D forward more (the
# double backward runs the bias-act's plain backward): {R1: launches}
OTHER_STEP_K1 = {False: 20, True: 24}
OTHER_ITERS, OTHER_WINDOW = 16, (9, 15)  # train_gan on dusty_v1.yaml: ADA at 4, 8, 12, 16, R1 at 16
OTHER_BARE_ITS = (0, 1, 2)  # bare steps: 0 takes R1 + ADA + warmup, 1 and 2 warmup only
OTHER_VANILLA_METRICS = "swd,jsd,1nna-cd"


def other_forward_gates(name, dev):
    """The config's G (seed 0) and D (seed 1), with non-zero biases and w_avg, on the card
    against the same modules on the CPU, B=8 at psi 0.7 on the same z and logistic noise;
    the K1 launches of one forward of each. Returns the card's G and the record."""
    m = train_cfg(name)["model"]
    cpu_gen = torch.Generator().manual_seed(12)
    G_cpu = build_generator(m["generator"], device="cpu", seed=0)
    D_cpu = build_discriminator(m["discriminator"], device="cpu", seed=1)
    with torch.no_grad():  # as after training: biases and w_avg away from zero
        for mod in (G_cpu, D_cpu):
            for k, prm in mod.named_parameters():
                if k.endswith("bias"):
                    prm.normal_(0.0, 0.1, generator=cpu_gen)
        G_cpu.w_avg.normal_(0.0, 0.3, generator=cpu_gen)
    G, D = copy.deepcopy(G_cpu).to(dev), copy.deepcopy(D_cpu).to(dev)
    z = torch.randn(B_SLICE, 512, generator=cpu_gen)
    noise = sample_logistic(cpu_gen, (B_SLICE, 1, 64, 512))
    read_and_reset(CHAIN_COUNTERS)
    o = sample(G, z.to(dev), None, 0.7, noise.to(dev))
    torch.cuda.synchronize()
    g_k1 = read_and_reset(CHAIN_COUNTERS)
    o_cpu = sample(G_cpu, z, None, 0.7, noise)
    with torch.no_grad():
        read_and_reset(CHAIN_COUNTERS)
        y = D(o_cpu["image"].to(dev), blur_fuse=False)
        torch.cuda.synchronize()
        d_k1 = read_and_reset(CHAIN_COUNTERS)
        y_cpu = D_cpu(o_cpu["image"], blur_fuse=False)
    G_ulp = copy.deepcopy(G_cpu)
    with torch.no_grad():
        for prm in G_ulp.parameters():
            prm.copy_(torch.nextafter(prm, torch.full_like(prm, math.inf)))
    o_ulp = sample(G_ulp, z, None, 0.7, noise)
    raydrop = "raydrop_mask" in o_cpu
    keys = ("image_orig", "raydrop_logit") if raydrop else ("image",)
    errs = {k: float((o[k].cpu() - o_cpu[k]).abs().max()) for k in keys}
    errs["D_logits"] = float((y.cpu() - y_cpu).abs().max())
    flips = {"card": int((o["raydrop_mask"].cpu() != o_cpu["raydrop_mask"]).sum()),
             "one_ulp": int((o_ulp["raydrop_mask"] != o_cpu["raydrop_mask"]).sum())} if raydrop else {}
    flip_bar = max(MAX_FLIPS, 2 * flips.get("one_ulp", 0))
    rec = {"max_abs_err": errs, "raydrop_flips": flips, "flip_bar": flip_bar, "k1_G_forward": g_k1["fused_bias_act"],
           "k1_D_forward": d_k1["fused_bias_act"], "outputs": sorted(o), "logit_scale": float(y_cpu.abs().max())}
    log("other", f"{name}: card vs CPU fp32, B={B_SLICE} psi 0.7, max abs err {errs} (bar 1e-4; logits up to "
        f"{rec['logit_scale']:.3f}); drop-mask flips {flips} (bar {flip_bar}); K1 per forward G {g_k1}, D {d_k1}")
    assert all(e <= 1e-4 for e in errs.values()), errs
    assert not raydrop or flips["card"] <= flip_bar, (flips, flip_bar)
    assert g_k1 == {"fused_bias_act": OTHER_K1_G, "fused_chain_fwd": 0, "fused_chain_bwd": 0}, g_k1
    assert d_k1 == {"fused_bias_act": OTHER_K1_D, "fused_chain_fwd": 0, "fused_chain_bwd": 0}, d_k1
    assert tuple(o["image"].shape) == (B_SLICE, 1, 64, 512) and tuple(y.shape) == (B_SLICE, 1, 1, 1)
    return G, rec


def other_sample_rates(name, G, dev):
    """samples/s of the G at B=32 and B=128 (CUDA events), device ms and idle share."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for B in (32, B_WIDE):
        z = torch.randn(B, 512, device=dev, generator=gen)
        noise = sample_logistic(gen, (B, 1, 64, 512), device=dev)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: sample(G, z, None, 1.0, noise), reps=10, repeats=3)
        dev_ms, _, by_name = profile_ms(lambda: sample(G, z, None, 1.0, noise), reps=5)
        rec = {"batch": B, "sample_ms": ms, "samples_per_s": 1e3 * B / ms, "device_ms": dev_ms,
               "device_idle_share": None if dev_ms is None else max(0.0, 1.0 - dev_ms / ms),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "top_device_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:5]}
        out.append(rec)
        log("other", f"{name} G fp32 B={B}: {ms:.3f} ms = {rec['samples_per_s']:.1f} samples/s; device {dev_ms} ms, "
            f"idle share {rec['device_idle_share']}; peak {rec['peak_gib']:.2f} GiB; top "
            + "; ".join(f"{n[:50]} {t:.3f}" for n, t in rec["top_device_ms"]))
    return out


def other_bare_steps(name, dev):
    """The config's own Trainer (B=32): OTHER_BARE_ITS with the K1 counters read around each
    step, then train_rates. Returns (trainer, state, record)."""
    tr = Trainer(train_cfg(name), device=dev, seed=0)
    st = tr.init_state(seed=0)
    batch = train_batch(tr, 0)
    steps = {}
    for it in OTHER_BARE_ITS:
        sched = tr.schedule(it)
        read_and_reset(CHAIN_COUNTERS)
        metrics = {k: float(v) for k, v in tr.step(st, batch, it).items()}
        launches = read_and_reset(CHAIN_COUNTERS)
        steps[it] = {"r1": sched.do_r1, "launches": launches, "metrics": metrics}
        assert launches == {"fused_bias_act": OTHER_STEP_K1[sched.do_r1], "fused_chain_fwd": 0, "fused_chain_bwd": 0}, \
            (name, it, launches)
        assert all(math.isfinite(v) for v in metrics.values()), metrics
    assert steps[0]["r1"] and "loss/D/gradient_penalty" in steps[0]["metrics"]
    log("other", f"{name} bare Trainer steps, fp32 B={tr.batch_size}: " + "; ".join(
        f"iteration {it} (R1 {v['r1']}) K1 {v['launches']['fused_bias_act']}, {v['metrics']}" for it, v in steps.items()))
    rates = train_rates(tr, st, batch, f"{name} fp32 B={tr.batch_size}, TF32 off")
    return tr, st, {"steps": steps, "rates": rates}


def other_train_gan(dev, tmp):
    """train_gan on dusty_v1.yaml (B=32) over OTHER_ITERS iterations on the fabricated tree,
    then test_gan on its checkpoint over CLI_METRICS at 64 + 64 clouds."""
    from dusty_gan_v2_tpu_torch.cli import test_gan, train_gan
    from dusty_gan_v2_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(str(Path(__file__).resolve().parent / "configs" / "gans" / "dusty_v1.yaml"))
    cfg.dataset.root, cfg.dataset.prune_missing = str(tmp / "kitti_raw"), True
    ck = cfg.training.checkpoint
    ck.save_stats, ck.save_model, ck.validation = 4, OTHER_ITERS, 10**9
    B = int(cfg.training.batch_size)
    cfg.training.total_kimg = OTHER_ITERS * B / 1e3
    save_config(cfg, str(tmp / "dusty_v1.yaml"))
    rec = {}
    read_and_reset(CHAIN_COUNTERS)
    fps_cuda.launches = emd_cuda.launches = 0
    with StepWindow(*OTHER_WINDOW) as window:
        t0 = time.perf_counter()
        _, state = train_gan.main(["--config", str(tmp / "dusty_v1.yaml"), "--log_dir", str(tmp / "logs_v1"),
                                   "--num_workers", "4", "--device", str(dev)])
        torch.cuda.synchronize()
        rec["train_gan_s"] = time.perf_counter() - t0
    launches = {**read_and_reset(CHAIN_COUNTERS), "fps": fps_cuda.launches, "emd": emd_cuda.launches}
    want = {"fused_bias_act": (OTHER_ITERS - 1) * OTHER_STEP_K1[False] + OTHER_STEP_K1[True], "fused_chain_fwd": 0,
            "fused_chain_bwd": 0, "fps": 0, "emd": 0}
    n_win = OTHER_WINDOW[1] - OTHER_WINDOW[0] + 1
    rec["cli_imgs_per_s"] = 1e3 * B * n_win / window.ms
    rows = [json.loads(line) for line in (tmp / "logs_v1" / "stats.jsonl").read_text().splitlines()]
    log("other", f"train_gan dusty_v1.yaml, fp32 B={B}, iterations 1-{OTHER_ITERS}: {rec['train_gan_s']:.2f} s; "
        f"iterations {OTHER_WINDOW[0]}-{OTHER_WINDOW[1]} {window.ms / n_win:.3f} ms an iteration = "
        f"{rec['cli_imgs_per_s']:.1f} imgs/s (loader uncached, as the config sets); launches {launches} (want "
        f"{want}); stats rows {rows}")
    assert launches == want, (launches, want)
    assert state.step == OTHER_ITERS and [r["iteration"] for r in rows] == [4, 8, 12, 16], rows
    assert all(math.isfinite(v) for r in rows for v in r.values()), rows
    assert "loss/D/gradient_penalty" in rows[-1] and "stats/ada_rt" in rows[-1], rows
    rec["launches"], rec["stats"] = launches, rows
    del state
    torch.cuda.empty_cache()

    ckpt = tmp / "logs_v1" / "models" / f"checkpoint_{OTHER_ITERS * B:010d}.ckpt"
    out = tmp / "scores_v1.json"
    fps_cuda.launches = emd_cuda.launches = 0
    read_and_reset(CHAIN_COUNTERS)
    t0 = time.perf_counter()
    scores, stages = test_gan.main([
        "--ckpt_path", str(ckpt), "--metrics", CLI_METRICS, "--num_samples", str(N_CLOUDS), "--num_subsample",
        str(N_CLOUDS), "--pointnet_ckpt", "random", "--out", str(out), "--device", str(dev),
    ])
    rec["test_gan_s"] = time.perf_counter() - t0
    ev = {"fused_bias_act": read_and_reset(CHAIN_COUNTERS)["fused_bias_act"], "fps": fps_cuda.launches,
          "emd": emd_cuda.launches}
    log("other", f"test_gan on the dusty_v1 checkpoint, --metrics {CLI_METRICS}, {N_CLOUDS} + {N_CLOUDS} clouds: "
        f"{rec['test_gan_s']:.2f} s; seconds per stage {stages}; launches {ev}; scores {scores}")
    assert json.loads(out.read_text()) == scores and all(math.isfinite(v) for v in scores.values()), scores
    assert {"jsd", "fpd", "kpd"} <= set(scores) and any(k.endswith("-emd") for k in scores), scores
    assert ev == {"fused_bias_act": OTHER_K1_G, "fps": 3, "emd": 48}, ev
    rec.update(test_gan_stage_s=stages, test_gan_scores=scores, test_gan_launches=ev)
    return rec


def other_vanilla_test_gan(dev, tmp, tr, st):
    """test_gan on a checkpoint of the vanilla bare steps' state, through the real sets:
    its config sets no measurement_kwargs.raydrop_const, so the reals take the dataset's."""
    from dusty_gan_v2_tpu_torch.cli import test_gan
    from dusty_gan_v2_tpu_torch.training.checkpoint import save_checkpoint
    from dusty_gan_v2_tpu_torch.utils.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "configs" / "gans" / "vanilla.yaml"))
    cfg.dataset.root, cfg.dataset.prune_missing = str(tmp / "kitti_raw"), True
    assert cfg.to_dict()["model"] == tr.cfg["model"]
    assert "raydrop_const" not in cfg.model.generator.measurement_kwargs
    path = tmp / "vanilla.ckpt"
    save_checkpoint(str(path), cfg, st, tr.angle, st.step * tr.batch_size)
    out = tmp / "scores_vanilla.json"
    fps_cuda.launches = emd_cuda.launches = 0
    read_and_reset(CHAIN_COUNTERS)
    t0 = time.perf_counter()
    scores, stages = test_gan.main([
        "--ckpt_path", str(path), "--metrics", OTHER_VANILLA_METRICS, "--num_samples", str(N_CLOUDS),
        "--num_subsample", str(N_CLOUDS), "--out", str(out), "--device", str(dev),
    ])
    seconds = time.perf_counter() - t0
    ev = {"fused_bias_act": read_and_reset(CHAIN_COUNTERS)["fused_bias_act"], "fps": fps_cuda.launches,
          "emd": emd_cuda.launches}
    log("other", f"test_gan on a vanilla checkpoint, --metrics {OTHER_VANILLA_METRICS}, {N_CLOUDS} + {N_CLOUDS} "
        f"clouds: {seconds:.2f} s; seconds per stage {stages}; launches {ev}; scores {scores}")
    assert "real data collection" in stages and json.loads(out.read_text()) == scores, stages
    assert all(math.isfinite(v) for v in scores.values()) and "jsd" in scores, scores
    assert ev == {"fused_bias_act": OTHER_K1_G, "fps": 2, "emd": 0}, ev
    return {"test_gan_s": seconds, "test_gan_stage_s": stages, "test_gan_scores": scores, "test_gan_launches": ev}


def phase_other_archs(dev, smi):
    """DUSty v1 and vanilla: card-vs-CPU forwards and training steps, rates, the bare steps,
    train_gan + test_gan on dusty_v1.yaml, test_gan on a vanilla checkpoint."""
    import tempfile

    rec = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
        tmp = Path(tmp)
        fabricate_kitti(tmp / "kitti_raw")
        for name in OTHER_CONFIGS:
            G, fwd = other_forward_gates(name, dev)
            r = {"forward": fwd, "sample_rates": other_sample_rates(name, G, dev)}
            del G
            r["card_vs_cpu"] = train_card_vs_cpu(dev, label="other", config=name)
            tr, st, r["bare"] = other_bare_steps(name, dev)
            if name == "vanilla":
                r.update(other_vanilla_test_gan(dev, tmp, tr, st))
            del tr, st
            torch.cuda.empty_cache()
            rec[name] = r
        rec["dusty_v1"]["cli"] = other_train_gan(dev, tmp)
    return rec


# phase 13: GAN inversion and the demos at the full width of configs/gans/dusty_v2.yaml (64 x 512,
# ch_base 32, ch_max 512, float32, TF32 off); a seeded G with non-zero biases and w_avg stands in
# for a trained checkpoint, phase 10's kind of fabricated tree for KITTI Raw
INV_DEFAULT_STEPS = (500, 500)  # demo_inversion's defaults: the run a user pays for, not cut
INV_WPLUS_STEPS = (50, 50)  # w+ with --optimize_phase --hypersphere_z
INV_PROFILE_STEPS = 20  # stage-1 steps in the profiled window
INTERP_GATE, INTERP_RATE = (2, 4), (2, 30)  # anchors x frames per anchor: card vs CPU, then the rate
# shares of pixels allowed past 1e-4 card against CPU, or twice the share one ulp moves on the CPU
NORMAL_FLIP_BAR = 1e-3  # normals on equal points (closest-pair near-ties, nearly collinear neighbours)
BEV_BAR = 1e-3  # lit BEV pixels (normal colours, bilinear weights at their 1e-3 drop line)


def png_size(path):
    """(width, height) from a PNG's IHDR (no imaging library on the card's machine)."""
    data = Path(path).read_bytes()[:24]
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR", path
    return tuple(int.from_bytes(data[i : i + 4], "big") for i in (16, 20))


def inversion_checkpoint(dev, tmp):
    """configs/gans/dusty_v2.yaml's G (seed 0; biases N(0, 0.1^2) and w_avg the mean mapped
    w, as after training) saved through training/checkpoint.py, the fabricated tree its
    dataset root. Returns the path."""
    from dusty_gan_v2_tpu_torch.training.checkpoint import save_checkpoint
    from dusty_gan_v2_tpu_torch.utils.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parent / "configs" / "gans" / "dusty_v2.yaml"))
    cfg.dataset.root = str(tmp / "kitti_raw")
    tr = Trainer(cfg.to_dict(), device=dev, seed=0)
    st = tr.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        for k, prm in st.G_ema.named_parameters():
            if k.endswith("bias"):
                prm.normal_(0.0, 0.1, generator=gen)
        st.G_ema.w_avg.copy_(st.G_ema.mapping_network(torch.randn(4096, 512, device=dev, generator=gen)).mean(0, keepdim=True))
    path = tmp / "inversion.ckpt"
    save_checkpoint(str(path), cfg, st, tr.angle, 0)
    del tr, st
    torch.cuda.empty_cache()
    return str(path)


def inversion_run(dev, ckpt, root, out, extra=()):
    """demo_inversion.main on the card; the gates; seconds per stage and launches."""
    from dusty_gan_v2_tpu_torch.cli import demo_inversion

    args = demo_inversion.parse_args(["--ckpt_path", ckpt] + list(extra))
    steps = (args.num_steps_1st, args.num_steps_2nd)
    read_and_reset(CHAIN_COUNTERS)
    t0 = time.perf_counter()
    res = demo_inversion.main(["--ckpt_path", ckpt, "--dataset_root", root, "--out_dir", str(out), "--device", str(dev)]
                              + list(extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_and_reset(CHAIN_COUNTERS)
    forwards = steps[0] + steps[1] + 1  # every step's forward and the final one
    sid = res["sample_id"]
    prob = np.load(out / f"raydrop_prob_{sid:010d}.npy")
    losses = res["losses_1st"] + res["losses_2nd"]
    sec = res["seconds"]
    rec = {"args": list(extra), "steps": steps, "sample_id": sid, "wall_s": wall, "seconds": sec,
           "stage1_ms_per_step": 1e3 * sec["1"] / steps[0], "stage2_ms_per_step": 1e3 * sec["2"] / steps[1],
           "launches": launches, "forwards": forwards, "first_loss": losses[0], "last_loss": losses[-1],
           "losses_every_100": losses[::100], "summary_png": png_size(out / f"summary_{sid:010d}.png"),
           "raydrop_prob_mean": float(prob.mean()), "latent": res["latent"], "phase": res["phase"]}
    log("inversion", f"demo_inversion {' '.join(extra) or '(defaults: w, 500 + 500)'}: frame {sid}, {wall:.2f} s "
        f"(setup {sec['setup']:.2f}, stage 1 {sec['1']:.2f} = {rec['stage1_ms_per_step']:.3f} ms a step, stage 2 "
        f"{sec['2']:.2f} = {rec['stage2_ms_per_step']:.3f} ms a step, outputs {sec['outputs']:.2f}); loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches {launches} ({forwards} G forwards); drop map mean "
        f"{rec['raydrop_prob_mean']:.4f}; summary {rec['summary_png']}")
    assert launches == {"fused_bias_act": G_K1 * forwards, "fused_chain_fwd": 0, "fused_chain_bwd": 0}, launches
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], (losses[0], losses[-1])
    assert prob.shape == (64, 512) and prob.dtype == np.float32 and 0.0 <= prob.min() and prob.max() <= 1.0
    assert rec["summary_png"] == (512, 4 * 64), rec["summary_png"]
    return rec


def inversion_target(ckpt, root, sid, device, latent_type="w+"):
    """(Inversion of frame `sid` on `device`, G_ema) as demo_inversion builds them."""
    from dusty_gan_v2_tpu_torch.cli.demo_inversion import Inversion
    from dusty_gan_v2_tpu_torch.cli.test_gan import fixed_logistic_noise
    from dusty_gan_v2_tpu_torch.geometry import CoordBridge
    from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt

    ck = autoload_ckpt(ckpt, device)
    item = KITTIRaw(root, "test", shape=(64, 512), min_depth=1.45, max_depth=80.0)[sid]
    coord = CoordBridge(64, 512, 1.45, 80.0, angle=ck["angle"], device=device)
    np.random.seed(0)
    noise = torch.as_tensor(fixed_logistic_noise(64, 512), device=device)
    G = ck["G_ema"]
    inv = Inversion(coord, ck["angle"], torch.as_tensor(item["depth"][None], device=device),
                    torch.as_tensor(item["mask"][None], device=device), noise, latent_type, G.synthesis_network.num_styles)
    return inv, G


def inversion_grads(inv, G, latent, phase):
    """One stage-1 step's loss and gradients (latent, phase) and one stage-2 step's
    gradients (every parameter of a copy of G; none for the mapping network under w+)."""
    lat, ph = latent.clone().requires_grad_(True), phase.clone().requires_grad_(True)
    loss, _ = inv(G, lat, ph)
    g_lat, g_ph = torch.autograd.grad(loss, [lat, ph])
    G2 = copy.deepcopy(G).requires_grad_(True)
    names, params = zip(*G2.named_parameters())
    loss2, _ = inv(G2, latent, phase)
    g2 = torch.autograd.grad(loss2, params, allow_unused=True)
    stage2 = {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, params, g2)}
    return float(loss.detach()), {"latent": g_lat, "phase": g_ph}, stage2


def inversion_card_vs_cpu(dev, ckpt, root, sid, latent, phase):
    """One stage-1 and one stage-2 step from the w+ run's final latent and phase, on the
    card and on the CPU (same frame, same noise): the loss within 1e-4 (relative), the
    gradients within 1e-2 of their largest magnitude, each or twice the shift one ulp in
    G's weights causes on the CPU where that is larger."""
    inv_d, G_d = inversion_target(ckpt, root, sid, dev)
    inv_c, G_c = inversion_target(ckpt, root, sid, "cpu")
    lat, ph = latent.detach().cpu(), phase.detach().cpu()
    loss_d, s1_d, s2_d = inversion_grads(inv_d, G_d, lat.to(dev), ph.to(dev))
    loss_c, s1_c, s2_c = inversion_grads(inv_c, G_c, lat, ph)
    G_ulp = copy.deepcopy(G_c)
    with torch.no_grad():
        for prm in G_ulp.parameters():
            prm.copy_(torch.nextafter(prm, torch.full_like(prm, math.inf)))
    loss_u, s1_u, s2_u = inversion_grads(inv_c, G_ulp, lat, ph)
    errs = {"loss": abs(loss_d - loss_c) / abs(loss_c), "stage1": rel_max_err(s1_d, s1_c), "stage2": rel_max_err(s2_d, s2_c)}
    ulp = {"loss": abs(loss_u - loss_c) / abs(loss_c), "stage1": rel_max_err(s1_u, s1_c), "stage2": rel_max_err(s2_u, s2_c)}
    bars = {"loss": max(1e-4, 2 * ulp["loss"]), "stage1": max(1e-2, 2 * ulp["stage1"]),
            "stage2": max(1e-2, 2 * ulp["stage2"])}
    rec = {"loss_cpu": loss_c, "errors": errs, "one_ulp": ulp, "bars": bars,
           "phase_grad_cpu": s1_c["phase"].reshape(-1).tolist(), "phase_grad_card": s1_d["phase"].reshape(-1).tolist()}
    log("inversion", f"card vs CPU, w+ step from the w+ run's state (frame {sid}): loss {loss_d:.6f} / {loss_c:.6f}; "
        f"errors {errs}; one-ulp shift {ulp}; bars {bars}; phase gradient card {rec['phase_grad_card']} CPU "
        f"{rec['phase_grad_cpu']}")
    assert all(errs[k] <= bars[k] for k in errs), (errs, bars)
    return rec


def inversion_profile(dev, ckpt, root, sid):
    """Stage-1 steps (w, B=1) at the card: ms a step unprofiled and under torch.profiler,
    the device's busy time, and the idle share over the unprofiled window."""
    from dusty_gan_v2_tpu_torch.cli.demo_inversion import LatentStage

    inv, G = inversion_target(ckpt, root, sid, dev, "w")
    stage = LatentStage(inv, G, G.w_avg.clone(), torch.zeros((1, 2, 1, 1), device=dev), INV_DEFAULT_STEPS[0], 5e-2)
    n = INV_PROFILE_STEPS
    for i in range(5):
        stage.step(100 + i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        stage.step(200 + i)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            stage.step(300 + i)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0) / n
    busy = device_busy_ms(prof) / n
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA) / n
    rec = {"step_ms": wall_ms, "profiled_step_ms": prof_ms, "device_busy_ms": busy, "device_records_per_step": kernels,
           "device_idle_share": max(0.0, 1.0 - busy / wall_ms), "profiled_idle_share": max(0.0, 1.0 - busy / prof_ms)}
    log("inversion", f"stage-1 steps (w, B=1), {n} in a window: {wall_ms:.3f} ms a step ({prof_ms:.3f} profiled); device "
        f"busy {busy:.3f} ms a step over {kernels:.0f} device records; idle share {rec['device_idle_share']:.3f} "
        f"({rec['profiled_idle_share']:.3f} of the profiled window)")
    return rec


def bev_card_vs_cpu(dev, inv):
    """CoordBridge's bird's-eye view of `inv` (B, 1, 64, 512) on the card and the CPU: the
    share of lit pixels past 1e-4, held to BEV_BAR or twice the share one ulp in `inv`
    moves on the CPU (a pixel's colour is a normal, and nearly collinear neighbours' normals
    follow rounding; the card's scatter adds in no fixed order): not to the bit."""
    from dusty_gan_v2_tpu_torch.geometry import make_Rt

    angle = load_angle(device=dev)
    coord_d, coord_c = make_coord_bridge(angle), make_coord_bridge(angle.cpu())
    inv_c = inv.cpu()
    bev_d = coord_d.make_birds_eye_view(inv.to(dev), make_Rt(z=0.7, device=dev)).cpu()
    bev_c = coord_c.make_birds_eye_view(inv_c, make_Rt(z=0.7))
    bev_u = coord_c.make_birds_eye_view(torch.nextafter(inv_c, torch.full_like(inv_c, math.inf)), make_Rt(z=0.7))
    lit = bev_c.amax(dim=1) > 0
    off = (bev_d - bev_c).abs().amax(dim=1) > 1e-4
    off_u = (bev_u - bev_c).abs().amax(dim=1) > 1e-4
    share, share_u = float(off[lit].float().mean()), float(off_u[lit].float().mean())
    return {"max_abs_err": float((bev_d - bev_c).abs().max()), "lit_share": float(lit.float().mean()),
            "lit_share_past_1e-4": share, "lit_share_past_1e-4_one_ulp": share_u, "bar": max(BEV_BAR, 2 * share_u)}


def demo_runs(dev, ckpt, tmp):
    """quick_demo at B=8; demo_interpolation 2d and 3d on the card against the CPU on the
    same anchors; their rates; the BEV card against CPU; the image tick's panels."""
    from dusty_gan_v2_tpu_torch.cli import demo_interpolation, quick_demo
    from dusty_gan_v2_tpu_torch.cli.train_gan import image_panels

    rec = {}
    read_and_reset(CHAIN_COUNTERS)
    t0 = time.perf_counter()
    out = quick_demo.main(["--ckpt_path", ckpt, "--out", str(tmp / "quick.png"), "--device", str(dev)])
    torch.cuda.synchronize()
    rec["quick_demo_s"] = time.perf_counter() - t0
    rec["quick_demo_launches"] = read_and_reset(CHAIN_COUNTERS)
    rec["quick_demo_png"] = png_size(tmp / "quick.png")
    log("demos", f"quick_demo B=8: {rec['quick_demo_s']:.3f} s (process-level call: checkpoint load, sample, PNG); "
        f"launches {rec['quick_demo_launches']}; PNG {rec['quick_demo_png']}")
    assert rec["quick_demo_launches"]["fused_bias_act"] == G_K1 and rec["quick_demo_png"] == (1024, 4 * 64)

    anchors = torch.randn(INTERP_GATE[0], 512, generator=torch.Generator().manual_seed(14))
    normal = lambda shape: anchors.reshape(shape)  # noqa: E731  (the same anchors on the card and the CPU)
    runs = {}
    for mode in ("2d", "3d"):
        for device in (str(dev), "cpu"):
            argv = ["--ckpt_path", ckpt, "--mode", mode, "--num_anchors", str(INTERP_GATE[0]), "--frames_per_anchor",
                    str(INTERP_GATE[1]), "--out", str(tmp / f"interp_{mode}_{device[:4]}.{'gif' if mode == '2d' else 'npz'}"),
                    "--device", device]
            read_and_reset(CHAIN_COUNTERS)
            runs[mode, device] = demo_interpolation.main(argv, normal=normal)
            k1 = read_and_reset(CHAIN_COUNTERS)["fused_bias_act"]
            frames = INTERP_GATE[0] * INTERP_GATE[1]
            assert k1 == (G_K1 * frames if device != "cpu" else 0), (mode, device, k1)
            assert Path(runs[mode, device]["path"]).is_file()
    f_d, f_c = np.stack(runs["2d", str(dev)]["frames"]), np.stack(runs["2d", "cpu"]["frames"])
    rec["interp_2d_index_mismatch_share"] = float((f_d != f_c).mean())
    p_d, p_c = runs["3d", str(dev)]["points"], runs["3d", "cpu"]["points"]
    n_d, n_c = runs["3d", str(dev)]["normals"], runs["3d", "cpu"]["normals"]
    rec["interp_3d_points_max_abs_err_m"] = float(np.abs(p_d - p_c).max())
    # the generator's outputs differ by ~1e-5 m between the two runs (gated by the points);
    # a unit normal of nearly collinear neighbours moves by more than 1e-4 for that, so the
    # two runs' normals are recorded, and the card's normal_map is held to the CPU's on the
    # card's own points: the pixels past 1e-4 there are closest-pair near-ties
    rec["interp_3d_normals_share_past_1e-4_runs"] = float((np.abs(n_d - n_c).max(axis=-1) > 1e-4).mean())
    T = p_d.shape[0]
    pm = torch.from_numpy(p_d).permute(0, 2, 1).reshape(T, 3, 64, 512)
    n_ref = make_coord_bridge(load_angle(device="cpu")).convert(pm, "point_map", "normal_map")
    n_ref = n_ref.reshape(T, 3, -1).permute(0, 2, 1).numpy()
    off = np.abs(n_d - n_ref).max(axis=-1) > 1e-4
    rec["interp_3d_normals_share_past_1e-4"] = float(off.mean())
    rec["interp_3d_normals_max_abs_err_elsewhere"] = float(np.abs(n_d - n_ref)[~off].max())
    # how many pixels one ulp in the points moves past 1e-4 on the CPU (nearly collinear
    # neighbours; the card's fused multiply-adds round the cross products otherwise)
    pm_ulp = torch.nextafter(pm, torch.full_like(pm, math.inf))
    n_ulp = make_coord_bridge(load_angle(device="cpu")).convert(pm_ulp, "point_map", "normal_map")
    n_ulp = n_ulp.reshape(T, 3, -1).permute(0, 2, 1).numpy()
    rec["interp_3d_normals_share_past_1e-4_one_ulp"] = float((np.abs(n_ulp - n_ref).max(axis=-1) > 1e-4).mean())
    normal_bar = max(NORMAL_FLIP_BAR, 2 * rec["interp_3d_normals_share_past_1e-4_one_ulp"])
    log("demos", f"demo_interpolation {INTERP_GATE[0]} x {INTERP_GATE[1]} frames, card vs CPU on the same anchors: 2d "
        f"colour-index mismatch share {rec['interp_2d_index_mismatch_share']:.2e} (bar 1e-3); 3d points max abs err "
        f"{rec['interp_3d_points_max_abs_err_m']:.3g} m (bar 8e-3), normals of the two runs past 1e-4 on a share "
        f"{rec['interp_3d_normals_share_past_1e-4_runs']:.2e}; the card's normals against the CPU's on the card's points "
        f"past 1e-4 on a share {rec['interp_3d_normals_share_past_1e-4']:.2e} (one ulp in the points: "
        f"{rec['interp_3d_normals_share_past_1e-4_one_ulp']:.2e}; bar {normal_bar:.2e}), elsewhere max "
        f"{rec['interp_3d_normals_max_abs_err_elsewhere']:.3g}")
    gates = [("interp 2d colour indices", rec["interp_2d_index_mismatch_share"] <= 1e-3),
             ("interp 3d points", rec["interp_3d_points_max_abs_err_m"] <= 1e-4 * 80.0),
             ("interp 3d normals", rec["interp_3d_normals_share_past_1e-4"] <= normal_bar)]

    for mode in ("2d", "3d"):  # the rate: a longer path, B=1 a frame
        argv = ["--ckpt_path", ckpt, "--mode", mode, "--num_anchors", str(INTERP_RATE[0]), "--frames_per_anchor",
                str(INTERP_RATE[1]), "--out", str(tmp / f"rate_{mode}"), "--device", str(dev)]
        r = demo_interpolation.main(argv)
        rec[f"interp_{mode}_frames_per_s"] = r["frames_per_s"]
    read_and_reset(CHAIN_COUNTERS)
    log("demos", f"demo_interpolation frames/s at B=1 over {INTERP_RATE[0] * INTERP_RATE[1]} frames: 2d "
        f"{rec['interp_2d_frames_per_s']:.1f} (GIF strip indices to the host each frame), 3d "
        f"{rec['interp_3d_frames_per_s']:.1f} (points and normals to the host each frame)")

    inv = torch.clamp((out["image"] + 1) / 2, 0, 1)
    rec["bev"] = bev_card_vs_cpu(dev, inv)
    log("demos", f"BEV of quick_demo's B=8 card vs CPU: {rec['bev']}")
    gates.append(("BEV", rec["bev"]["lit_share_past_1e-4"] <= rec["bev"]["bar"] and rec["bev"]["lit_share"] > 0))

    # the image tick's panels (train_gan.py's log_images twins) on quick_demo's fakes
    coord = make_coord_bridge(load_angle(device=dev))
    fakes = {k: out[k] for k in ("image", "image_orig", "raydrop_logit", "raydrop_mask")}
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        panels = {**image_panels("real", image_aug=out["image"]), **image_panels("fake", coord, **fakes)}
        times.append(1e3 * (time.perf_counter() - t0))
    rec["image_tick_panels_ms"] = statistics.median(times)
    assert len(panels) == 8 and all(np.isfinite(v).all() for v in panels.values())
    log("demos", f"image tick panels (B=8 fakes + augmented reals, to the host): {rec['image_tick_panels_ms']:.3f} ms "
        f"(median of 5; {', '.join(f'{t:.1f}' for t in times)})")
    failed = [name for name, ok in gates if not ok]
    assert not failed, failed
    return rec


def phase_inversion(dev, smi):
    """demo_inversion at the defaults and w+ with the phase, card vs CPU steps, the profiled
    stage-1 window, then quick_demo, demo_interpolation and the panels."""
    import tempfile

    rec = {"nvidia_smi": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inversion_") as tmp:
        tmp = Path(tmp)
        fabricate_kitti(tmp / "kitti_raw")
        ckpt = inversion_checkpoint(dev, tmp)
        root = str(tmp / "kitti_raw")
        rec["default"] = inversion_run(dev, ckpt, root, tmp / "inv_w")
        rec["wplus"] = inversion_run(dev, ckpt, root, tmp / "inv_wplus", [
            "--latent_type", "w+", "--optimize_phase", "--hypersphere_z", "--num_steps_1st", str(INV_WPLUS_STEPS[0]),
            "--num_steps_2nd", str(INV_WPLUS_STEPS[1])])
        assert float(rec["wplus"]["phase"].abs().max()) > 0  # the phase moved
        sid = rec["wplus"]["sample_id"]
        rec["card_vs_cpu"] = inversion_card_vs_cpu(dev, ckpt, root, sid, rec["wplus"]["latent"], rec["wplus"]["phase"])
        for r in ("default", "wplus"):
            rec[r]["phase"] = rec[r]["phase"].reshape(-1).tolist()
            del rec[r]["latent"]
        rec["profile"] = inversion_profile(dev, ckpt, root, rec["default"]["sample_id"])
        read_and_reset(CHAIN_COUNTERS)
        rec["demos"] = demo_runs(dev, ckpt, tmp)
    torch.cuda.empty_cache()
    return rec


def main():
    smi = phase_device()
    dev = torch.device("cuda:0")
    build_s, reports = phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    k1, k1_rows = check_fused_bias_act(dev, gen)
    k2, k2_rows = check_fps(dev, gen, smi)
    k3, k3_rows = check_emd(dev, smi)
    k4, k5, chain_rows = check_fused_chain(dev, gen)
    G_cpu, launches, slice_rec, x_fake = phase_slice(dev)
    k1["launches"], k2["launches"] = launches["fused_bias_act"], launches["fps"]
    eval_launches, eval_rec = phase_evaluate(G_cpu, dev, smi)
    k3["launches"] = eval_launches["emd"]
    rates = phase_rates(G_cpu, dev, smi)
    D_cpu, critic_launches, critic_rec = phase_critic(x_fake, dev)
    k4["launches"], k5["launches"] = critic_launches["fused_chain_fwd"], critic_launches["fused_chain_bwd"]
    critic_rates = phase_critic_rates(D_cpu, G_cpu, dev)
    train_launches, train_rec = phase_train(dev, smi)
    cli_rec = phase_cli(dev, smi, train_rec["rates"][0]["imgs_per_s"])
    semseg_rec = phase_semseg(dev, smi)
    other_rec = phase_other_archs(dev, smi)
    inversion_rec = phase_inversion(dev, smi)
    # this slice's main path is demo_inversion at its defaults: K1 at each of its 1,001 G
    # forwards; K4 and K5 over train_gan's 16 iterations (8, a checkpoint, 8 resumed), K2 and
    # K3 in test_gan (phase 10), the paths that run them
    k1["launches"] = inversion_rec["default"]["launches"]["fused_bias_act"]
    k4["launches"], k5["launches"] = cli_rec["launches"]["fused_chain_fwd"], cli_rec["launches"]["fused_chain_bwd"]
    k2["launches"], k3["launches"] = cli_rec["test_gan_launches"]["fps"], cli_rec["test_gan_launches"]["emd"]
    ks = [k1, k2, k3, k4, k5]

    record = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": build_s, "ptxas": reports,
        "kernels": ks, "fused_bias_act_sites": k1_rows, "fps_by_batch": k2_rows, "emd_by_clouds": k3_rows, "slice": slice_rec,
        "evaluate": eval_rec, "rates": rates, "fused_chain": chain_rows, "critic": critic_rec,
        "critic_rates": critic_rates, "train": train_rec, "cli": cli_rec, "semseg": semseg_rec,
        "other_archs": other_rec, "inversion": inversion_rec,
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
