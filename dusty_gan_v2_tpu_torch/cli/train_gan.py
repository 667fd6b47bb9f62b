"""Train a LiDAR range-image GAN on KITTI Raw (counterpart of train_gan.py).

    python -m dusty_gan_v2_tpu_torch.cli.train_gan --config configs/gans/dusty_v2_bf16.yaml \
        [--resume <checkpoint>] [--log_dir DIR] [--dry_run] [--device cuda|cpu] \
        [--distributed [--coordinator HOST:PORT --num_processes N --process_id I]]

Data parallel: one process per card, each started with --distributed and either the
three rendezvous flags or torchrun's environment (torchrun --nproc_per_node N -m
dusty_gan_v2_tpu_torch.cli.train_gan --distributed ...); NCCL on cards, gloo with
--device cpu. The config's batch_size is the global batch: each rank loads its
batch_size / N rows (rank k the k-th slice of each global batch of the one-process
stream) and the step averages over the ranks, so N processes train as one does. Only
the chief (rank 0) writes the config, stats, images and checkpoints and runs the
validation; every rank loads a --resume checkpoint.

Every shipped config trains: dusty_v2.yaml and dusty_v2_bf16.yaml (DUSty v2 G and D),
dusty_v1.yaml (DUSty v1 G, vanilla D) and vanilla.yaml (vanilla G and D).

The loop: KITTI Raw frames through the threaded loader and the device prefetcher (only
the depth plane ships, in dataset.upload_dtype; the step rebuilds the mask as
depth > 0), one `Trainer.step` per iteration, the step's metrics kept on the device
until the training.checkpoint.save_stats tick and then brought to the host in one
transfer, FPD/KPD validation every `validation` iterations when a PointNet is given,
side samples every `save_image` iterations (written to <log_dir>/images/step_<imgs>.npz: the
raw arrays and the JAX CLI's image panels under its TensorBoard tags, `image_panels`; the
real frames' panels once at the start, in step_0000000001.npz),
and a checkpoint every `save_model` iterations and at the last. Scalars keep the JAX
CLI's names; they go to stdout and to <log_dir>/stats.jsonl.

Every draw is keyed by (seed, iteration): the step's by fold_seed(seed, iteration),
the side samples' by fold_seed(seed, SIDE, 2i + 1) and (seed, SIDE, 2i), and a resumed
run skips the sampler's indices of the iterations done, so that it trains on what the
uninterrupted run would have. imgs/s counts the global batch over the iterations of this
run only. Not ported yet: the TensorBoard writer and orbax checkpoints.
"""

from __future__ import annotations

import argparse
import datetime
import itertools
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets.kitti import DevicePrefetcher, InfiniteSampler, KITTIRaw, Prefetcher, to_device
from ..evaluation import features
from ..geometry import CoordBridge, render_point_clouds
from ..metrics import build_pointnet, compute_frechet_distance, compute_squared_mmd
from ..parallel import PerSampleStream, fold_seed, init_distributed, rank, shutdown, world_size
from ..training import Trainer, fetch_reals
from ..training.checkpoint import load_checkpoint, save_checkpoint
from ..utils import colorize, init_random_seed, points_to_normal_2d, power_spectrum_2d, resolve_device, tanh_to_sigmoid
from ..utils.config import load_config, save_config

__all__ = ["main", "validation_fpd_kpd", "image_panels", "SIDE", "VALIDATION"]

# fold_seed domains of the draws outside the step (the step's own are (seed, iteration))
SIDE, VALIDATION, FIXED_Z = 1 << 32, (1 << 32) + 1, (1 << 32) + 2


def validation_fpd_kpd(trainer: Trainer, state, loader_factory, pointnet, real_feats_cache: Dict,
                       num_samples: int = 10_000) -> Dict[str, float]:
    """FPD and KPD of PointNet features of G_ema's samples against the training split's
    (the real features are computed once and kept in real_feats_cache)."""
    coord = CoordBridge(*trainer.resolution, trainer.min_depth, trainer.max_depth, angle=trainer.angle,
                        device=trainer.device)
    if real_feats_cache.get("feats") is None:
        feats = []
        for batch in loader_factory():
            host = {k: batch[k] for k in ("depth", "mask")}
            reals = fetch_reals(host, trainer.min_depth, trainer.max_depth, trainer.raydrop_const, trainer.device)
            feats.append(features(reals["image"], coord, pointnet).cpu())
        real_feats_cache["feats"] = torch.cat(feats).numpy()
    B = int(trainer.cfg["validation"]["batch_size"])
    gen = torch.Generator(device=trainer.device).manual_seed(fold_seed(trainer.seed, VALIDATION))
    fake = []
    for done in range(0, num_samples, B):
        z = torch.randn((min(B, num_samples - done), trainer.z_dim), generator=gen, device=trainer.device)
        fake.append(features(trainer.sample(state, z, generator=gen)["image"], coord, pointnet))
    fake = torch.cat(fake).cpu().numpy()
    real = real_feats_cache["feats"]
    k = num_samples // 1000
    return {
        f"pointcloud/frechet_distance_{k}k": compute_frechet_distance(fake, real),
        f"pointcloud/squared_mmd_{k}k": compute_squared_mmd(fake, real),
    }


@torch.no_grad()
def image_panels(tag: str, coord: Optional[CoordBridge] = None, image=None, image_orig=None, image_aug=None,
                 raydrop_logit=None, raydrop_mask=None) -> Dict[str, np.ndarray]:
    """The JAX CLI's TensorBoard image panels (train_gan.py::log_images) as
    {tag/name: (B, C, H, W) float32 array}: colorized range images, the drop probability
    and mask, and, with `image` and `coord`, the power spectrum, the surface normals and
    a bird's-eye render from 0.7 above the sensor."""
    out = {}
    clip01 = lambda x: torch.clamp(tanh_to_sigmoid(x), 0, 1)  # noqa: E731
    if image_orig is not None:
        out[f"{tag}/image/orig"] = colorize(clip01(image_orig))
    if image_aug is not None:
        out[f"{tag}/image/aug"] = colorize(clip01(image_aug))
    if raydrop_logit is not None:
        out[f"{tag}/raydrop_prob"] = colorize(torch.sigmoid(raydrop_logit))
    if raydrop_mask is not None:
        out[f"{tag}/raydrop_mask"] = raydrop_mask
    if image is not None and coord is not None:
        inv_depth = clip01(image.float())
        pm = coord.convert(inv_depth, "inv_depth_norm", "point_map") / coord.max_depth
        nm = points_to_normal_2d(pm, mode="closest")
        B = pm.shape[0]
        t = torch.tensor([[0.0, 0.0, 0.7]], device=pm.device)
        bev = render_point_clouds(pm.reshape(B, 3, -1).transpose(1, 2), nm.reshape(B, 3, -1).transpose(1, 2),
                                  size=image.shape[-1], t=t)
        spec = power_spectrum_2d(inv_depth)
        spec = spec - spec.min()
        spec = (spec / spec.max()).astype(np.float32)
        out[f"{tag}/image"] = colorize(inv_depth)
        out[f"{tag}/image/spectrum"] = colorize(torch.from_numpy(spec))
        out[f"{tag}/normal"] = nm
        out[f"{tag}/pointcloud"] = torch.clamp(bev, 0, 1)
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--pointnet_ckpt", default=None,
                        help="cls_model_39.pth for FPD/KPD validation, or 'random' (seeded weights: timing only)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of steps 20-25 of this run into DIR")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallel: join a process group (the three flags below, or torchrun's environment)")
    parser.add_argument("--coordinator", default=None, help="HOST:PORT of the rendezvous")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Runs the training; returns (trainer, state) at the end."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    if args.dry_run:
        print(json.dumps(cfg.to_dict(), indent=2, default=str))
        return None
    if args.distributed:
        device = init_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
        try:
            return _train(args, cfg, device)
        finally:
            shutdown()
    return _train(args, cfg, resolve_device(args.device))


def _train(args: argparse.Namespace, cfg, device: torch.device):
    seed = int(cfg.training.random_seed)
    init_random_seed(seed)  # the same on every rank: the ranks start from one state
    trainer = Trainer(cfg, device=device, seed=seed)
    B, B_local, chief = trainer.batch_size, trainer.B_local, rank() == 0
    if chief:
        print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}) | "
              f"batch {B} ({world_size()} x {B_local})", flush=True)

    if args.log_dir is None:
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        arch = f"{cfg.model.generator.arch}+{cfg.model.discriminator.arch}"
        log_dir = Path("logs/gans") / cfg.dataset.name / arch / stamp
    else:
        log_dir = Path(args.log_dir)
    if chief:
        log_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, str(log_dir / "config.yaml"))

    state = trainer.init_state(seed)
    start_iter = 0
    if args.resume:
        _, state, _, num_imgs = load_checkpoint(args.resume, state)
        start_iter = num_imgs // B
        if chief:
            print(f"resumed from {args.resume} at iteration {start_iter:,}", flush=True)

    ds = cfg.dataset
    dataset = KITTIRaw(
        root=ds.root, split="train", shape=trainer.resolution, min_depth=ds.min_depth, max_depth=ds.max_depth,
        flip=bool(ds.get("flip", False)), prune_missing=bool(ds.get("prune_missing", False)), cache=ds.get("cache"),
    )
    # the one-process index stream, rank k taking the k-th slice of each global batch; a
    # resumed run skips what it consumed
    sampler = itertools.islice(
        iter(InfiniteSampler(len(dataset), rank=rank(), num_replicas=world_size(), seed=int(cfg.random_seed),
                             block=B_local)),
        start_iter * B_local, None)
    loader = iter(Prefetcher(dataset, B_local, sampler, num_workers=args.num_workers))
    up_dtype = np.dtype(ds.get("upload_dtype", "float32"))
    dev_loader = DevicePrefetcher(
        loader, lambda host: {"depth": to_device(host["depth"].astype(up_dtype, copy=False), device)}, device, depth=2
    )

    pointnet = None
    if args.pointnet_ckpt and chief:
        random_weights = args.pointnet_ckpt == "random"
        pointnet = build_pointnet(device, state_dict_path=None if random_weights else args.pointnet_ckpt)
    real_feats_cache: Dict = {}
    coord = CoordBridge(*trainer.resolution, trainer.min_depth, trainer.max_depth, angle=trainer.angle, device=device)
    if chief:
        # the real frames' panels once, from the first frames of the one-process stream
        # (read from the dataset again, so that the loader's stream is untouched)
        first = itertools.islice(iter(InfiniteSampler(len(dataset), seed=int(cfg.random_seed))), start_iter * B,
                                 start_iter * B + 8)
        frames = [dataset[int(j)] for j in first]
        reals0 = fetch_reals({k: np.stack([f[k] for f in frames]) for k in ("depth", "mask")}, trainer.min_depth,
                             trainer.max_depth, trainer.raydrop_const, device)
        (log_dir / "images").mkdir(exist_ok=True)
        np.savez_compressed(log_dir / "images" / f"step_{1:010d}.npz",
                            **image_panels("real", coord, image=reals0["image"], raydrop_mask=reals0["raydrop_mask"]))

    total_iters = int(cfg.training.total_kimg * 1e3 / B)
    ckpt_cfg = cfg.training.checkpoint
    moving = defaultdict(lambda: deque(maxlen=100))
    z_fixed = torch.randn(
        (8, trainer.z_dim), generator=torch.Generator(device=device).manual_seed(fold_seed(seed, FIXED_Z)),
        device=device,
    )
    side = lambda *fold: torch.Generator(device=device).manual_seed(fold_seed(seed, SIDE, *fold))  # noqa: E731
    stats_file = open(log_dir / "stats.jsonl", "a") if chief else None
    prof = None
    pending = []
    t_start = time.time()
    try:
        for i in range(start_iter + 1, total_iters + 1):
            if args.profile and chief and i - start_iter == 20:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=activities)
                prof.start()
            batch = next(dev_loader)
            pending.append(trainer.step(state, batch, i))
            if prof is not None and i - start_iter == 25:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.stop()
                Path(args.profile).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(args.profile) / "trace.json"))
                print(f"torch.profiler trace written to {args.profile}", flush=True)
                prof = None
            num_imgs = i * B

            if chief and (i % int(ckpt_cfg.save_stats) == 0 or i == total_iters):
                # one device -> host transfer for every metric since the last tick (the
                # metrics are the ranks' means: the chief alone writes them)
                keys = [k for m in pending for k in m]
                values = torch.stack([v.detach().float().reshape(()) for m in pending for v in m.values()]).tolist()
                for k, v in zip(keys, values):
                    moving[k].append(v)
                ips = B * (i - start_iter) / (time.time() - t_start)
                row = {"iteration": i, "num_imgs": num_imgs, "stats/imgs_per_sec": ips}
                row.update({k: float(np.mean(dq)) for k, dq in moving.items()})
                stats_file.write(json.dumps(row) + "\n")
                stats_file.flush()
                print(f"iter {i:>8}/{total_iters} imgs {num_imgs:>10,} {ips:8.1f} imgs/s "
                      + " ".join(f"{k.split('/')[-1]}={np.mean(v):.3f}" for k, v in list(moving.items())[:4]),
                      flush=True)
            if i % int(ckpt_cfg.save_stats) == 0 or i == total_iters:
                pending.clear()

            if chief and i % int(ckpt_cfg.save_image) == 0:
                # augmented reals at the current ADA p and G_ema's samples on the fixed z (eval
                # mode and ADA: no collective, so the chief runs them alone)
                reals_aug = trainer.augment_reals(
                    state, {"depth": batch["depth"][:8]}, i, stream=PerSampleStream(8, side(2 * i + 1), device)
                )
                fakes = trainer.sample(state, z_fixed, generator=side(2 * i))
                out = {"real_aug": reals_aug, **{k: v for k, v in fakes.items() if k != "w"}}
                panels = {**image_panels("real", image_aug=reals_aug),
                          **image_panels("fake", coord, **{k: fakes.get(k) for k in (
                              "image", "image_orig", "raydrop_logit", "raydrop_mask")})}
                np.savez_compressed(log_dir / "images" / f"step_{num_imgs:010d}.npz",
                                    **{k: v.float().cpu().numpy() for k, v in out.items()}, **panels)

            if pointnet is not None and i % int(ckpt_cfg.validation) == 0:
                def loader_factory():
                    return iter(Prefetcher(dataset, int(cfg.validation.batch_size), num_workers=args.num_workers))

                scores = validation_fpd_kpd(trainer, state, loader_factory, pointnet, real_feats_cache)
                stats_file.write(json.dumps({"iteration": i, "num_imgs": num_imgs,
                                             **{"score/" + k: v for k, v in scores.items()}}) + "\n")
                stats_file.flush()
                print(f"iter {i:>8} " + " ".join(f"{k}={v:.4f}" for k, v in scores.items()), flush=True)

            if i % int(ckpt_cfg.save_model) == 0 or i == total_iters:
                path = log_dir / "models" / f"checkpoint_{num_imgs:010d}.ckpt"
                save_checkpoint(str(path), cfg, state, trainer.angle, num_imgs)  # the chief writes; all wait
    finally:
        if stats_file is not None:
            stats_file.close()
        loader.close()  # stops the loader's thread
        if prof is not None:
            prof.stop()
    return trainer, state


if __name__ == "__main__":
    main()
