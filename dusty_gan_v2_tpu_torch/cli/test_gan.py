"""Evaluate a trained generator: SWD / JSD / COV-MMD-1-NNA (CD / EMD / DCD) / FPD / KPD
(counterpart of test_gan.py).

    python -m dusty_gan_v2_tpu_torch.cli.test_gan --ckpt_path <checkpoint> \
        [--metrics swd,jsd,1nna-cd,fpd,kpd] [--pointnet_ckpt cls_model_39.pth|random] [--device cuda|cpu]

G_ema of the checkpoint (any generator arch: dusty_v2, dusty_v1, vanilla) generates
`num_samples` images with one fixed logistic noise map (drawn with numpy from --seed, as
the JAX CLI draws it; a vanilla generator does not read it), and evaluation.py's stages
turn them into PointNet features and FPS-downsampled clouds. The real sets come from
KITTI Raw: the test split for SWD, JSD and 1-NNA, the train split for FPD and KPD.
A `[t] stage: seconds` line is printed per stage; --out receives the scores as JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets.kitti import KITTIRaw, Prefetcher, to_device
from ..evaluation import DEFAULT_METRICS, Outputs, collect_generated, evaluate, reals_to_outputs
from ..geometry import CoordBridge
from ..metrics import build_pointnet
from ..pretrained import autoload_ckpt
from ..utils import init_random_seed, resolve_device

__all__ = ["main", "fixed_logistic_noise"]


def fixed_logistic_noise(H: int, W: int) -> np.ndarray:
    """(1, 1, H, W) logistic noise from numpy's global generator, u clipped to
    [1e-6, 1 - 1e-6], as test_gan.py draws it after seeding."""
    u = np.clip(np.random.rand(1, 1, H, W).astype(np.float32), 1e-6, 1 - 1e-6)
    return np.log(u) - np.log1p(-u)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--metrics", default=",".join(DEFAULT_METRICS),
                        help="comma list: swd,jsd,fpd,kpd,1nna-cd,1nna-emd,1nna-dcd (default: the protocol's)")
    parser.add_argument("--num_samples", type=int, default=50_000)
    parser.add_argument("--num_subsample", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--pairwise_batch", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pointnet_ckpt", default=None, help="cls_model_39.pth, or 'random' (seeded weights)")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--prune_missing", action="store_true",
                        help="skip split-table frames absent on disk; defaults to the checkpoint config's value")
    parser.add_argument("--out", default=None, help="write the scores as JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Runs the evaluation; returns (scores, seconds per stage)."""
    args = parse_args(argv)
    metrics = args.metrics.split(",")
    device = resolve_device(args.device)
    init_random_seed(args.seed)
    ckpt = autoload_ckpt(args.ckpt_path, device)
    cfg = ckpt["cfg"]
    H, W = cfg.model.generator.synthesis_kwargs.resolution
    num_points = int(cfg.validation.num_points)
    coord = CoordBridge(H, W, cfg.dataset.min_depth, cfg.dataset.max_depth, angle=ckpt["angle"], device=device)
    # the reals' fill value: the measurement model's, else the dataset's (a vanilla
    # generator has none; the JAX CLI reads measurement_kwargs.raydrop_const and fails there)
    measurement = cfg.model.generator.get("measurement_kwargs", {})
    raydrop_const = float(measurement.get("raydrop_const", cfg.dataset.raydrop_const))

    need_feats = any(m in metrics for m in ("fpd", "kpd"))
    need_test = any(m in metrics for m in ("swd", "jsd")) or any(m.startswith("1nna") for m in metrics)
    pointnet = None
    if need_feats:
        if not args.pointnet_ckpt:
            raise ValueError("--pointnet_ckpt is required for fpd / kpd")
        random_weights = args.pointnet_ckpt == "random"
        pointnet = build_pointnet(device, state_dict_path=None if random_weights else args.pointnet_ckpt)
    noise = torch.from_numpy(fixed_logistic_noise(H, W)).to(device)

    stage_times: Dict[str, float] = {}
    stage_t = time.perf_counter()

    def stage(name):
        nonlocal stage_t
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stage_times[name] = now - stage_t
        print(f"[t] {name}: {now - stage_t:.1f}s", flush=True)
        stage_t = now

    def collect_real(split: str) -> Outputs:
        root = args.dataset_root or cfg.dataset.root
        ds = KITTIRaw(root=root, split=split, shape=(H, W), min_depth=cfg.dataset.min_depth,
                      max_depth=cfg.dataset.max_depth,
                      prune_missing=args.prune_missing or bool(cfg.dataset.get("prune_missing", False)))
        parts = [
            reals_to_outputs(to_device(b["depth"], device), to_device(b["mask"], device), coord, raydrop_const,
                             pointnet, num_points)
            for b in Prefetcher(ds, args.batch_size, num_workers=4)
        ]
        if not parts:
            raise ValueError(f"no KITTI Raw frames of the {split} split under {root}")
        return Outputs(*(torch.cat(x) for x in zip(*parts)))

    print("generating", args.num_samples, "samples...", flush=True)
    gen = collect_generated(
        ckpt["G_ema"], ckpt["angle"], coord, args.num_samples, batch_size=args.batch_size,
        num_subsample=args.num_subsample if need_test else 0, pointnet=pointnet, num_points=num_points,
        fixed_logistic=noise, seed=args.seed,
    )
    stage(f"generate+features+fps x{args.num_samples}")
    test_data = collect_real("test") if need_test else None
    train_data = collect_real("train") if need_feats else None
    if need_test or need_feats:
        stage("real data collection")

    scores = evaluate(
        gen, test_data if need_test else train_data, metrics, pairwise_batch=args.pairwise_batch,
        num_subsample=args.num_subsample, train_features=None if train_data is None else train_data.features,
        device=device, seed=args.seed, stage_times=stage_times,
    )
    for k, v in sorted(scores.items()):
        print(f"{k:>30}: {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f, indent=2)
    return scores, stage_times


if __name__ == "__main__":
    main()
