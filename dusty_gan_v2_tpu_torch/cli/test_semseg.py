"""Evaluate a semseg checkpoint on the KITTI frontal val split with the per-class IoU /
precision / recall table (counterpart of test_semseg.py).

    python -m dusty_gan_v2_tpu_torch.cli.test_semseg --ckpt_path <checkpoint> \
        [--dataset_root DIR] [--batch_size N] [--knn [--knn_k K --knn_kernel_size S]] [--out scores.json] \
        [--device cuda|cpu]

The checkpoint is one that cli/train_semseg.py wrote, the JAX CLI's msgpack file or a
reference `.pth` (semseg/train_step.py::load_checkpoint). The protocol omits the cyclist
class (its labels count as unknown, and so do its predictions); --knn refines the
predictions with the kNN post-filter on the device. The counts stay on the device until
the end. Not ported: the JAX CLI's release keywords (a download).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..datasets.kitti import Prefetcher, to_device
from ..semseg import KITTIRawFrontal, knn2d
from ..semseg.train_step import confusion_device, load_checkpoint, load_model_state
from ..utils import resolve_device
from .train_semseg import build_model, make_inputs

__all__ = ["main", "scores_of"]


def scores_of(conf: np.ndarray) -> Dict[str, List[float]]:
    """IoU, precision and recall per class of (3, C) [tp, fp, fn] counts."""
    tp, fp, fn = conf
    eps = 1e-12
    return {"iou": (tp / (tp + fn + fp + eps)).tolist(), "precision": (tp / (tp + fp + eps)).tolist(),
            "recall": (tp / (tp + fn + eps)).tolist()}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--dataset_root", default="data/kitti_raw_frontal")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--knn", action="store_true", dest="knn_enabled")
    parser.add_argument("--knn_k", type=int, default=3)
    parser.add_argument("--knn_kernel_size", type=int, default=3)
    parser.add_argument("--out", default=None, help="write the scores as JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> Tuple[Dict[str, List[float]], Dict[str, float]]:
    """Runs the evaluation; returns (scores, {"frames", "seconds"}: the evaluation loop's
    frames and host seconds, from the first batch to the counts on the host)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, payload = load_checkpoint(args.ckpt_path)
    model = load_model_state(build_model(cfg), payload).to(device)
    num_classes, modalities = int(cfg.dataset.num_classes), tuple(cfg.arch.inputs)
    ds = KITTIRawFrontal(root=args.dataset_root, split="val", shape=tuple(cfg.dataset.shape), omit_cyclist=True)

    conf = torch.zeros((3, num_classes), dtype=torch.int64, device=device)
    frames = 0
    t0 = time.perf_counter()
    for raw in Prefetcher(ds, args.batch_size, num_workers=4):
        b = {k: to_device(v, device) for k, v in raw.items()}
        pred = model(make_inputs(b, modalities), b["xyz"], b["mask"]).argmax(1)
        pred = torch.where(pred == 3, 0, pred)  # the cyclist class is omitted
        if args.knn_enabled:
            pred = knn2d(b["depth"], pred, num_classes, k=args.knn_k, kernel_size=(args.knn_kernel_size,) * 2)
        mask = b["mask"]
        conf += confusion_device((b["label"] * mask).long(), (pred * mask).long(), num_classes)
        frames += raw["mask"].shape[0]
    conf = conf.cpu().numpy().astype(np.float64)
    seconds = time.perf_counter() - t0

    scores = scores_of(conf)
    iou, precision, recall = (np.asarray(scores[k]) for k in ("iou", "precision", "recall"))
    print(f"{'class':>12} {'iou':>8} {'precision':>10} {'recall':>8}")
    for i, name in enumerate(ds.class_list):
        print(f"{name:>12} {iou[i]:8.1%} {precision[i]:10.1%} {recall[i]:8.1%}")
    print(f"{'mean':>12} {iou[1:3].mean():8.1%} {precision[1:3].mean():10.1%} {recall[1:3].mean():8.1%}")
    print(f"[t] {frames} frames in {seconds:.3f} s ({frames / seconds:.1f} frames/s)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(scores, f, indent=2)
    return scores, {"frames": frames, "seconds": seconds}


if __name__ == "__main__":
    main()
