#!/usr/bin/env python3
"""The design study of the PyTorch port's fused EMD kernel (dusty_gan_v2_tpu_torch/csrc/emd.cu),
on a CUDA card:

    python3 scripts/torch_emd_kernel_variants.py

1. The approximate instructions, against float64: ex2.approx.ftz.f32 on t in [-130, 0) by
   range (mean and largest error in ulp of the result), sqrt.approx.f32 on [0, 3.25]
   (relative error).
2. Variants of csrc/emd.cu, each built from its text with one edit, against the plain
   version (metrics/distance.py::earth_mover_distance) on ten sets of 256 pairs of 2048 x
   2048 points (seeds 0-4; uniform clouds and clouds with 30% of their points on the
   origin, drawn as chip_smoke.py::emd_sets draws them): the largest and the mean relative
   error per pair in each set, and ms per launch on the seed-0 sets (median of 5 launches,
   CUDA events):
   - kernel: as committed (K = expf of the exact L d, the plain version's K);
   - ex2: ex2.approx of the rounded L log2(e) d, a third fewer instructions;
   - k4: K_l in the fused sweep as (K_{l+1}^2)^2, one exponential fewer an element;
   - 512x4, 512x2: blocks of 512 threads owning 4 or 2 rows (64 registers, half the warps);
   - unroll2: the column loops unrolled 2 times instead of 4.
The edits are made at the text in VARIANTS: the script stops, naming the text, where a
later edit of emd.cu has removed it. Prints the card's name and power limit first; writes
chiprun_out/emd_kernel_variants.json.
"""

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from dusty_gan_v2_tpu_torch import kernels  # noqa: E402
from dusty_gan_v2_tpu_torch.metrics import earth_mover_distance  # noqa: E402

PAIRS, POINTS, CHUNK, SEEDS = 256, 2048, 32, (0, 1, 2, 3, 4)
PROBE = r"""
#include <cuda_runtime.h>
__global__ void probe_kernel(const float* t, const float* d, float* e, float* s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(t[i]));
  e[i] = r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(d[i]));
  s[i] = r;
}
extern "C" int probe(const void* t, const void* d, void* e, void* s, int n) {
  probe_kernel<<<(n + 255) / 256, 256>>>((const float*)t, (const float*)d, (float*)e, (float*)s, n);
  return (int)cudaGetLastError();
}
"""
# (the text in csrc/emd.cu, its replacement) of each variant
KEXP = "{ return expf(__fmul_rn(d, level)); }"
KL_FUSED = """        if (kNext) run_ka[r] = fmaf(kexp(d, next_level), rw.x, run_ka[r]);
        const float kr = kexp(d, level) * rw.y;"""
SHAPE = "constexpr int kThreads = 1024;\nconstexpr int kRows = 2;"
VARIANTS = {
    "kernel": [],
    # level * log2 e is exact, the level being a power of two
    "ex2": [(KEXP, '{ float r; asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(d, level * 1.44269504f)));'
                   ' return r; }')],
    "k4": [(KL_FUSED, """        float kl;
        if (kNext) {
          const float k = kexp(d, next_level);
          run_ka[r] = fmaf(k, rw.x, run_ka[r]);
          const float k2 = k * k;
          kl = k2 * k2;
        } else {
          kl = kexp(d, level);
        }
        const float kr = kl * rw.y;""")],
    "512x4": [(SHAPE, "constexpr int kThreads = 512;\nconstexpr int kRows = 4;")],
    "512x2": [(SHAPE, "constexpr int kThreads = 512;\nconstexpr int kRows = 2;")],
    "unroll2": [("#pragma unroll 4", "#pragma unroll 2")],
}


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def build(out):
    """{variant: library path}, all nvcc processes at once."""
    src = (kernels.CSRC / "emd.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is no longer in emd.cu")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [kernels.nvcc(), *kernels.NVCC_FLAGS["emd"], "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    (out / "probe.cu").write_text(PROBE)
    procs["probe"] = subprocess.Popen(
        [kernels.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-o", str(out / "libprobe.so"), str(out / "probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        regs[name] = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
    return {name: out / f"lib{name}.so" for name in procs}, regs


def instruction_errors(lib, dev):
    lib.probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    gen = torch.Generator(device=dev).manual_seed(1)
    t = -130.0 * torch.rand(1 << 22, device=dev, generator=gen)
    d = 3.25 * torch.rand(1 << 22, device=dev, generator=gen)
    e, s = torch.empty_like(t), torch.empty_like(d)
    assert lib.probe(t.data_ptr(), d.data_ptr(), e.data_ptr(), s.data_ptr(), t.numel()) == 0
    torch.cuda.synchronize()
    ref = torch.exp2(t.double())
    ulp = torch.exp2(torch.floor(torch.log2(ref)) - 23)
    rows = []
    for lo in range(-130, 0, 10):
        m = (t >= lo) & (t < lo + 10) & (ref >= 2.0**-126)
        err = (e.double()[m] - ref[m]) / ulp[m]
        rows.append({"t_from": lo, "t_to": lo + 10, "mean_ulp": err.mean().item(), "max_abs_ulp": err.abs().max().item()})
    rel = (s.double() - torch.sqrt(d.double())) / torch.sqrt(d.double())
    return {"ex2": rows, "sqrt_mean_rel": rel.mean().item(), "sqrt_max_abs_rel": rel.abs().max().item()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_emd_kernel_variants: needs a CUDA card")
    card = smi()
    print(card, flush=True)
    dev = torch.device("cuda:0")
    with tempfile.TemporaryDirectory() as tmp:
        libs, regs = build(Path(tmp))
        record = {"device": card, "registers": regs, "instructions": instruction_errors(ctypes.CDLL(str(libs["probe"])), dev)}
        for row in record["instructions"]["ex2"]:
            print(f"ex2.approx t in [{row['t_from']}, {row['t_to']}): mean {row['mean_ulp']:+.3f} ulp, "
                  f"largest {row['max_abs_ulp']:.2f} ulp", flush=True)
        print(f"sqrt.approx on [0, 3.25]: mean {record['instructions']['sqrt_mean_rel']:+.3e}, largest "
              f"{record['instructions']['sqrt_max_abs_rel']:.3e} relative", flush=True)
        clouds = {}
        for seed in SEEDS:
            gen = torch.Generator(device=dev).manual_seed(seed)
            for kind in ("uniform", "origin30"):
                x = torch.rand(PAIRS, POINTS, 3, device=dev, generator=gen)
                y = torch.rand(PAIRS, POINTS, 3, device=dev, generator=gen)
                if kind == "origin30":
                    x[torch.rand(PAIRS, POINTS, device=dev, generator=gen) < 0.3] = 0.0
                    y[torch.rand(PAIRS, POINTS, device=dev, generator=gen) < 0.3] = 0.0
                ref = torch.cat([earth_mover_distance(x[i : i + CHUNK], y[i : i + CHUNK]) for i in range(0, PAIRS, CHUNK)])
                clouds[f"{kind}{seed}"] = (x, y, ref)
        record["variants"] = {}
        for name in VARIANTS:
            lib = ctypes.CDLL(str(libs[name]))
            lib.emd_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            rec = {}
            for tag, (x, y, ref) in clouds.items():
                cost = torch.empty(PAIRS, device=dev)

                def launch():
                    stream = torch.cuda.current_stream().cuda_stream
                    assert lib.emd_f32(x.data_ptr(), y.data_ptr(), cost.data_ptr(), PAIRS, POINTS, POINTS, stream) == 0

                launch()
                torch.cuda.synchronize()
                rel = (cost - ref) / ref
                rec[tag] = {"max_abs_rel": rel.abs().max().item(), "mean_rel": rel.mean().item()}
                if tag.endswith("0"):
                    times = []
                    for _ in range(5):
                        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        a.record()
                        launch()
                        b.record()
                        b.synchronize()
                        times.append(a.elapsed_time(b))
                    rec[tag]["ms"] = statistics.median(times)
            record["variants"][name] = rec
            print(f"{name}: ms uniform {rec['uniform0']['ms']:.3f}, origin30 {rec['origin300']['ms']:.3f}; largest "
                  f"relative error per pair " + ", ".join(f"{k} {v['max_abs_rel']:.2e}" for k, v in rec.items())
                  + f" ({card})", flush=True)
    out = ROOT / "chiprun_out" / "emd_kernel_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
