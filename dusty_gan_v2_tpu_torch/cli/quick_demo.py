"""Sample a trained generator and save a colorized range-image grid (counterpart of
quick_demo.py).

    python -m dusty_gan_v2_tpu_torch.cli.quick_demo --ckpt_path <checkpoint> \
        [--batch_size 8] [--truncation_psi 0.7] [--seed 0] [--out quick_demo.png] [--device cuda|cpu]

G_ema of a port checkpoint samples `batch_size` images; z and the logistic noise come
from a torch.Generator on the device seeded with --seed. The grid holds two images a
row, turbo-coloured, and is written as a PNG without an imaging library. The release
keywords (dusty_v1, dusty_v2, vanilla) are a download, and raise.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..pretrained import autoload_ckpt
from ..sampling import sample
from ..utils import colorize, init_random_seed, resolve_device, tanh_to_sigmoid
from ..utils.image_io import to_uint8, write_png

__all__ = ["main", "grid_of"]


def grid_of(colored: np.ndarray) -> np.ndarray:
    """(B, 3, H, W) colours -> (ceil(B / 2) H, 2 W, 3), two images a row."""
    rows = [np.concatenate(list(colored[i : i + 2].transpose(0, 2, 3, 1)), axis=1) for i in range(0, len(colored), 2)]
    return np.concatenate(rows, axis=0)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", default=None, help="a checkpoint path (the release keywords are a download)")
    parser.add_argument("--ckpt_path", default=None, help="alias of --arch for paths")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--truncation_psi", type=float, default=0.7)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="quick_demo.png")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Samples and writes the grid; returns G's outputs (on the device)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    init_random_seed(args.seed)
    ckpt = autoload_ckpt(args.ckpt_path or args.arch, device)
    G = ckpt["G_ema"]
    gen = torch.Generator(device=device).manual_seed(args.seed)
    z = torch.randn((args.batch_size, G.style_dim), generator=gen, device=device)
    out = sample(G, z, ckpt["angle"], truncation_psi=args.truncation_psi, generator=gen)
    colored = colorize(torch.clamp(tanh_to_sigmoid(out["image"]), 0, 1)).cpu().numpy()
    write_png(args.out, to_uint8(grid_of(colored)))
    print(f"saved: {args.out}  images: {tuple(out['image'].shape)}", flush=True)
    return out


if __name__ == "__main__":
    main()
