"""Train SqueezeSeg V1/V2 for sim2real LiDAR semantic segmentation (counterpart of
train_semseg.py).

    python -m dusty_gan_v2_tpu_torch.cli.train_semseg \
        --config configs/semseg/sim2real_w_gan_noise_dustyv2_bf16.yaml \
        [--log_dir DIR] [--dry_run] [--num_workers N] [--max_steps N] [--device cuda|cpu] \
        [--distributed [--coordinator HOST:PORT --num_processes N --process_id I]]

Data parallel, as train_gan: one process per card (the JAX CLI drives one mesh of all
its devices from one process), each with --distributed and the three rendezvous flags or
torchrun's environment; the config's batch_size is the global batch, each rank loads the
k-th slice of each global batch of the one-process stream, and the step averages over the
ranks (SyncBatchNorm moments), so N processes train as one does. The chief (rank 0)
alone validates and writes.

The dataset follows the config's name, as in the JAX CLI: KITTI frontal frames, or GTA
frames without ray drop, with the average KITTI drop map (spatial or its mean), or with
per-frame GAN drop maps (DUSty v1 / v2). Frames go through the threaded loader and the
device prefetcher in compact dtypes (label and mask as uint8, the other planes in
dataset.upload_dtype); one `SemsegTrainer.step` per step; the loss and the (3, C)
confusion counts stay on the device until the checkpoint.stats tick, which brings them
to the host in one transfer; validation on the KITTI frontal val split and a checkpoint
every checkpoint.test steps and at the last. Scalars go to stdout and
<log_dir>/stats.jsonl (no TensorBoard).

The encoder takes ImageNet SqueezeNet v1.1 Fire weights when arch.pretrained_weights is
on (the default) and the pickle is a local file (arch.pretrained_path, or
data/pretrained/squeezenet_v1.1.pkl); without it the CLI warns and trains from its own
init. The checkpoint has no optimizer state and there is no --resume, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import datetime
import json
import time
from collections import deque
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..datasets.kitti import DevicePrefetcher, InfiniteSampler, Prefetcher, nearest_resize_hw, to_device
from ..parallel import init_distributed, local_batch, rank, shutdown, world_size
from ..semseg import (
    GTALiDAR, GTALiDAR_GAN, KITTIRawFrontal, SqueezeSegV1, SqueezeSegV2, apply_squeezenet_fire_weights,
    load_squeezenet_v11,
)
from ..semseg.common import POOL_IMPLS
from ..semseg.train_step import SemsegTrainer, confusion_device, save_checkpoint
from ..utils import init_random_seed, resolve_device
from ..utils.config import load_config, save_config

__all__ = ["MODALITY_CH", "make_inputs", "build_dataset", "build_model", "evaluate_confusion", "validate", "main"]

MODALITY_CH = {"xyz": 3, "depth": 1, "reflectance": 1, "mask": 1}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AVG_RAYDROP = "data/avg_raydrop/kitti_raw_frontal.npy"


def make_inputs(item, modalities):
    """The modalities of a batch concatenated on the channel axis (numpy or torch)."""
    parts = [item[m] if item[m].ndim == 4 else item[m][:, None] for m in modalities]
    return np.concatenate(parts, axis=1) if isinstance(parts[0], np.ndarray) else torch.cat(parts, dim=1)


def _resize_drop_map(drop, shape):
    if drop.shape == tuple(shape):
        return drop.astype(np.float32)
    return nearest_resize_hw(drop[..., None].astype(np.float32), shape)[..., 0]


def build_dataset(cfg):
    """(train, val) datasets of the config's dataset.name."""
    name = cfg.dataset.name
    root = cfg.dataset.get("root", "data/kitti_raw_frontal")
    shape = tuple(cfg.dataset.shape)
    kw = dict(root=root, shape=shape, flip=bool(cfg.dataset.random_flip), cache=cfg.dataset.get("cache"))
    if name == "kitti_raw_frontal":
        train = KITTIRawFrontal(split="train", **kw)
    elif name == "gta_lidar":
        train = GTALiDAR(raydrop_p=_resize_drop_map(np.load(AVG_RAYDROP), shape), **kw)
    elif name == "gta_lidar_w_uniform_noise":
        train = GTALiDAR(raydrop_p=np.full(shape, np.load(AVG_RAYDROP).mean(), np.float32), **kw)
    elif name == "gta_lidar_w_gan_noise_dustyv1":
        train = GTALiDAR_GAN(gan_dir="GTAV_noise_v1", **kw)
    elif name == "gta_lidar_w_gan_noise_dustyv2":
        train = GTALiDAR_GAN(gan_dir="GTAV_noise_v2", **kw)
    elif name == "gta_lidar_wo_noise":
        train = GTALiDAR(raydrop_p=None, **kw)
    else:
        raise ValueError(name)
    return train, KITTIRawFrontal(split="val", root=root, shape=shape)


def build_model(cfg):
    """SqueezeSegV1 / V2 of cfg.arch, weights drawn from random_seed (on the CPU)."""
    arch = cfg.arch
    # the JAX package's implementation switches of the pool and the BN moments (module
    # globals there, set by its build_model), passed to the modules here
    pool_impl = str(arch.get("pool_impl") or "separable")
    if pool_impl not in POOL_IMPLS:
        raise ValueError(f"arch.pool_impl: {pool_impl!r} (one of {POOL_IMPLS})")
    crf = arch.get("crf")
    kwargs = dict(
        inputs=tuple(arch.inputs),
        num_classes=int(cfg.dataset.num_classes),
        dtype=DTYPES[arch.get("compute_dtype", "float32")],
        head_dropout_p=float(arch.decoder.dropout_p),
        use_crf=bool(arch.use_crf),
        crf_kwargs={
            "kernel_size": tuple(crf.kernel_size),
            "init_weight_smoothness": crf.init_weight_smoothness,
            "init_weight_appearance": crf.init_weight_appearance,
            "theta_gamma": tuple(np.atleast_1d(crf.theta_gamma)),
            "theta_alpha": tuple(np.atleast_1d(crf.theta_alpha)),
            "theta_beta": tuple(np.atleast_1d(crf.theta_beta)),
            "num_iters": int(crf.num_iters),
        } if arch.use_crf else None,
        seed=int(cfg.random_seed),
        pool_impl=pool_impl,
    )
    if arch.name == "squeezeseg_v1":
        return SqueezeSegV1(**kwargs)
    if arch.name == "squeezeseg_v2":
        bias = cfg.dataset.get("logit_bias")
        one_pass = arch.get("bn_one_pass")
        return SqueezeSegV2(**kwargs, bn_momentum=float(arch.bn_momentum),
                            logit_bias=tuple(bias) if bias is not None else None,
                            bn_one_pass=True if one_pass is None else bool(one_pass))
    raise ValueError(arch.name)


def evaluate_confusion(label, pred, num_classes):
    """Per-class tp / fp / fn of host arrays."""
    tps, fps, fns = np.zeros(num_classes), np.zeros(num_classes), np.zeros(num_classes)
    for c in range(num_classes):
        tps[c] = ((pred == c) & (label == c)).sum()
        fps[c] = ((pred == c) & (label != c)).sum()
        fns[c] = ((pred != c) & (label == c)).sum()
    return tps, fps, fns


def iou_of(conf: np.ndarray) -> np.ndarray:
    tp, fp, fn = conf
    return tp / (tp + fn + fp + 1e-12)


@torch.no_grad()
def validate(model, dataset, modalities, batch_size, num_classes, device, num_workers=4) -> np.ndarray:
    """(3, C) [tp, fp, fn] of the eval-mode model's argmax over `dataset`, on its masked pixels."""
    conf = torch.zeros((3, num_classes), dtype=torch.int64, device=device)
    for raw in Prefetcher(dataset, batch_size, num_workers=num_workers):
        x = to_device(make_inputs(raw, modalities), device)
        xyz, mask = to_device(raw["xyz"], device), to_device(raw["mask"], device)
        label = to_device(raw["label"], device).long()
        pred = model(x, xyz, mask).argmax(1)
        conf += confusion_device((label * mask).long(), (pred * mask).long(), num_classes)
    return conf.cpu().numpy().astype(np.float64)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--distributed", action="store_true",
                        help="data parallel: join a process group (the three flags below, or torchrun's environment)")
    parser.add_argument("--coordinator", default=None, help="HOST:PORT of the rendezvous")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Optional[SemsegTrainer]:
    """Runs the training; returns the trainer at the end."""
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


def _train(args: argparse.Namespace, cfg, device: torch.device) -> SemsegTrainer:
    chief = rank() == 0
    seed = int(cfg.random_seed)
    init_random_seed(seed)
    model = build_model(cfg)
    if cfg.arch.name == "squeezeseg_v2" and bool(cfg.arch.get("pretrained_weights", True)):
        try:
            weights = load_squeezenet_v11(cfg.arch.get("pretrained_path"))
        except FileNotFoundError as e:
            if chief:
                print(f"WARNING: pretrained encoder init unavailable ({e}); the encoder starts from its "
                      "truncated-normal init", flush=True)
        else:
            apply_squeezenet_fire_weights(model, weights)
            if chief:
                print("loaded ImageNet SqueezeNet-v1.1 Fire weights into the encoder", flush=True)
    trainer = SemsegTrainer(model, cfg, device)
    B = int(cfg.training.batch_size)
    B_local = local_batch(B)
    num_classes, modalities = trainer.num_classes, trainer.modalities
    steps_total = args.max_steps or int(cfg.training.max_steps)
    if chief:
        print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'host'}) | "
              f"batch {B} ({world_size()} x {B_local}) | {steps_total} steps", flush=True)

    if args.log_dir is None:
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        log_dir = Path("logs/semseg") / cfg.dataset.name / cfg.arch.name / stamp
    else:
        log_dir = Path(args.log_dir)
    if chief:
        log_dir.mkdir(parents=True, exist_ok=True)
        save_config(cfg, str(log_dir / "training_config.yaml"))

    train_ds, val_ds = build_dataset(cfg)
    sampler = InfiniteSampler(len(train_ds), rank=rank(), num_replicas=world_size(), seed=seed, block=B_local)
    loader = iter(Prefetcher(train_ds, B_local, sampler, num_workers=args.num_workers))
    up_dtype = np.dtype(cfg.dataset.get("upload_dtype", "float32"))

    def assembled():
        # each plane ships once: xyz and the other float planes in up_dtype, label and
        # mask as uint8 (exact); the step restores float32 / int64
        for raw in loader:
            out = {"xyz": raw["xyz"].astype(up_dtype, copy=False)}
            for m in modalities:
                if m not in ("xyz", "mask"):
                    t = raw[m]
                    out[m] = (t if t.ndim == 4 else t[:, None]).astype(up_dtype, copy=False)
            out["label"] = raw["label"].astype(np.uint8)
            out["mask"] = raw["mask"].astype(np.uint8)
            yield out

    dev_loader = DevicePrefetcher(assembled(), lambda host: {k: to_device(v, device) for k, v in host.items()},
                                  device, depth=2)
    ckpt_cfg = cfg.training.checkpoint
    moving = deque(maxlen=100)
    conf = np.zeros((3, num_classes))
    pending = []
    stats_file = open(log_dir / "stats.jsonl", "a") if chief else None
    t0 = time.time()
    try:
        for step in range(1, steps_total + 1):
            out = trainer.step(next(dev_loader), step)
            pending.append(out)

            if not chief:
                pending.clear()  # the step's loss and counts are the ranks': the chief writes them
            elif step % int(ckpt_cfg.stats) == 0 or step == steps_total:
                # one device -> host transfer for every step since the last tick
                losses = torch.stack([o["loss"].float() for o in pending]).cpu().numpy()
                conf += torch.stack([o["conf"] for o in pending]).sum(0).cpu().numpy()
                moving.extend(losses.tolist())
                pending.clear()
                iou = iou_of(conf)
                ips = step * B / (time.time() - t0)
                row = {"step": step, "train/loss": float(np.mean(moving)), "train/iou/mean": float(iou[1:].mean()),
                       "train/lr": trainer.lr(step), "stats/imgs_per_sec": ips}
                stats_file.write(json.dumps(row) + "\n")
                stats_file.flush()
                print(f"step {step:>7}/{steps_total} loss {np.mean(moving):.4f} miou {iou[1:].mean():.3f} "
                      f"({ips:.1f} imgs/s)", flush=True)
                conf = np.zeros((3, num_classes))

            if step % int(ckpt_cfg.test) == 0 or step == steps_total:
                if chief:
                    iou = iou_of(validate(trainer.model, val_ds, modalities, B, num_classes, device,
                                          args.num_workers))
                    stats_file.write(json.dumps({"step": step, "val/iou/mean": float(iou[1:].mean()),
                                                 "val/iou": iou.tolist()}) + "\n")
                    stats_file.flush()
                    print(f"[val] step {step}: miou={iou[1:].mean():.4f} per-class={iou}", flush=True)
                save_checkpoint(str(log_dir / "models" / f"checkpoint_step-{step:010d}.ckpt"), cfg, trainer.model,
                                step)  # the chief writes; all wait
    finally:
        if stats_file is not None:
            stats_file.close()
        loader.close()  # stops the loader's thread
    return trainer


if __name__ == "__main__":
    main()
