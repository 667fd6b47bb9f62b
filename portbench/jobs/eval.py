"""Evaluation cells: the program's 1-NNA stage, metrics/cov_mmd_1nna.py::compute_cov_mmd_1nna.

Set-up makes the two sets of clouds itself: a generated set from the seed's generator and
a stand-in reference set from a second generator (seed + 1), each the reference's G
(float32) with the ray drop drawn from the seed, mapped to points and reduced by
furthest-point sampling, as test_gan prepares its clouds. The window repeats whole rounds
of compute_cov_mmd_1nna(gen, ref, chunk, metrics) (three pair matrices on the device, their
download, the scores) until `--seconds` have passed. The matrices each round returns are
kept from the benchmark's side (the program's _pairwise_distance is wrapped), and after the
window one pair of every chunk of every round, its position drawn from the seed, is
recomputed by the reference; the scores are recomputed from the program's matrices (the
reference follows the program from its own matrices there: their entries are checked by
the sample)."""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..harness import checks as C
from ..harness.cells import Cell
from ..harness.runtime import Outcome, free_cuda, set_precision
from ..harness.weights import seeded_weights
from ..reference import emd as REF
from ..reference.fps import downsample
from ..reference.geometry import image_to_points
from ..reference.models import build_generator, build_pe_cache
from ..reference.stream import SeedStream
from . import common


class PortEval:
    """The program under test: compute_cov_mmd_1nna, its matrices kept as they return."""

    def __init__(self, device):
        from dusty_gan_v2_tpu_torch.metrics import cov_mmd_1nna as M

        self.M, self.device = M, device
        self.matrices: List[np.ndarray] = []
        self._orig = M._pairwise_distance
        self.keep = False

        def kept(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            if self.keep:
                self.matrices.append(out)
            return out

        M._pairwise_distance = kept

    def close(self) -> None:
        self.M._pairwise_distance = self._orig

    def round(self, gen, ref, chunk: int, metrics) -> Dict[str, float]:
        return self.M.compute_cov_mmd_1nna(gen, ref, chunk, metrics=tuple(metrics), device=self.device)


def clouds(cfg, seed: int, salt: int, n: int, traffic: Dict[str, Any], device) -> torch.Tensor:
    """n clouds of traffic["points"] points from the reference G of the seed's weights."""
    g_cfg, ds = cfg["model"]["generator"], cfg["dataset"]
    H, W = g_cfg["synthesis_kwargs"]["resolution"]
    weights = seeded_weights(cfg["model"], seed, device, salt=salt)
    G = build_generator(g_cfg, device)
    G.load_state_dict(weights["G"])
    ang = common.angle((H, W), device)
    pe = build_pe_cache(G, ang)
    st = SeedStream.seeded(n, device, seed, common.LATENTS, salt)
    z_dim = g_cfg["mapping_kwargs"]["in_ch"]
    with torch.no_grad():
        z, noise = st.normal((z_dim,)), st.logistic((1, H, W))
        out = []
        for i in range(0, n, 64):
            img = G(z[i:i + 64], None, pe_cache=pe, gumbel_noise=noise[i:i + 64])["image"]
            pts = image_to_points(img, ang, float(ds["min_depth"]), float(ds["max_depth"]))
            out.append(downsample(pts, int(traffic["points"])))
    return torch.cat(out)


def sampled_pairs(seed: int, rounds: int, n_mat: int, B: int, chunk: int):
    """One flat pair index a chunk, for each round and matrix: [(round, matrix, index)]."""
    rng = random.Random(f"{seed}:pairs")
    total = B * B
    out = []
    for r in range(rounds):
        for m in range(n_mat):
            for start in range(0, total, chunk):
                out.append((r, m, start + rng.randrange(min(chunk, total - start))))
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_proc: float, device="cuda",
        program_factory: Optional[Callable] = None, probes=None, limits: Optional[Dict[str, float]] = None) -> Outcome:
    cfg, traffic = common.model_cfg(cell.config), cell.traffic
    dev = torch.device(device)
    set_precision(cell.config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n, chunk, metric = int(cell.config["eval_clouds"]), int(traffic["chunk"]), traffic["metric"]
    gen = clouds(cfg, seed, 0, n, traffic, dev)
    ref = clouds(cfg, seed, 1, n, traffic, dev)
    free_cuda()
    program = (program_factory or PortEval)(dev)
    warm = max(1, int(np.ceil(np.sqrt(chunk))))  # three chunks of the window's size
    program.round(gen[:warm], ref[:warm], chunk, (metric,))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t_win = time.perf_counter()
    setup_s = t_win - t_proc
    program.keep = True
    if trace and probes is not None:
        probes.active = True
    results, profiles = [], []
    while True:
        if trace and probes is not None and not profiles:
            from ..harness.probes import profile_stretch

            before = {k: len(v) for k, v in probes.launches.items()}
            holder = {}
            profiles.append(profile_stretch(lambda: holder.setdefault("r", program.round(gen, ref, chunk, (metric,))),
                                            probes.specs, probes.counts, probes))
            profiles[-1]["launch_range"] = {k: (before[k], len(probes.launches[k])) for k in before}
            results.append(holder["r"])
        else:
            results.append(program.round(gen, ref, chunk, (metric,)))
        if time.perf_counter() - t_win >= seconds:
            break
    window_s = time.perf_counter() - t_win
    if probes is not None:
        probes.active = False
    program.keep = False
    rounds = len(results)
    pairs = rounds * 3 * n * n
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    mats = [(m[metric] if isinstance(m, dict) else m) for m in program.matrices]
    entries = getattr(program, "sampled_entries", None)
    close = getattr(program, "close", None)
    if close:
        close()
    del program
    free_cuda()
    ctx = {"kind": "eval", "rounds": rounds, "pairs": pairs, "window_s": window_s, "profiles": profiles} if trace else None

    witness = []
    nums = judge(mats, results, gen, ref, seed, rounds, chunk, metric, notes=witness, entries=entries)
    limits = limits if limits is not None else common.load_limits(cell.name)
    found = [C.Check(k, v, limits[k]) for k, v in nums.items() if k in limits]
    shown = [f"reading {k}: {v!r} (not compared)" for k, v in nums.items() if k not in limits]
    return Outcome(e2e={"eval_emd_pairs_per_s": pairs / window_s, "setup_s": setup_s}, attempted=rounds, failed=0,
                   checks=found, memory_peak_bytes=peak, trace=ctx, notes=shown + witness)


def judge(mats, results, gen, ref, seed, rounds, chunk, metric, emd_fn=None, notes=None,
          entries=None) -> Dict[str, float]:
    """emd_gap: the worst relative gap of a sampled entry to the reference's EMD of its pair;
    emd_mean_gap: the mean of those gaps; score_gap: the worst gap of a returned score to the
    reference's scores of the round's own matrices; missing: matrices that did not come back.
    `notes` takes the worst pair with a float64 witness of the reference. `entries(a, b)`,
    where given, is the program's value at each sampled pair in place of its matrices' (the
    control computes only the entries the comparison reads)."""
    emd_fn = emd_fn or REF.emd_per_point
    n = gen.shape[0]
    missing = float(max(0, 3 * rounds - len(mats)))
    if missing:
        return {"emd_gap": float("inf"), "emd_mean_gap": float("inf"), "score_gap": float("inf"), "missing": missing}
    sets = ((ref, ref), (ref, gen), (gen, gen))  # rr, rg, gg, in the program's order
    picks = sampled_pairs(seed, rounds, 3, n, chunk)
    a = torch.stack([sets[m][0][i // n] for _, m, i in picks])
    b = torch.stack([sets[m][1][i % n] for _, m, i in picks])
    if entries is None:
        got = torch.tensor([float(mats[3 * r + m].reshape(-1)[i]) for r, m, i in picks])
    else:
        got = entries(a, b).cpu()
    want = emd_fn(a, b).cpu()
    gaps = (got - want).abs() / want.abs().clamp(min=1e-30)
    j = int(gaps.argmax())
    if notes is not None:
        w64 = REF.emd_per_point(a[j:j + 1].double(), b[j:j + 1].double()).item()
        notes.append(f"worst sampled pair {picks[j]}: program {got[j].item()!r}, reference {want[j].item()!r}, "
                     f"reference in float64 {w64!r}")
    score_gap = 0.0
    for r in range(rounds):
        s = REF.scores(mats[3 * r], mats[3 * r + 1], mats[3 * r + 2], metric)
        for k, v in s.items():
            score_gap = max(score_gap, abs(results[r].get(k, float("nan")) - v))
    if not np.isfinite(score_gap):
        score_gap = float("inf")
    return {"emd_gap": float(gaps.max()), "emd_mean_gap": float(gaps.mean()), "score_gap": score_gap, "missing": 0.0}
