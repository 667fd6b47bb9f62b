"""Latent-space interpolation: a smooth cubic path through mapped anchors (counterpart of
demo_interpolation.py).

    python -m dusty_gan_v2_tpu_torch.cli.demo_interpolation --ckpt_path <checkpoint> \
        [--mode 2d|3d] [--num_anchors 10] [--frames_per_anchor 30] [--truncation_psi 0.7] \
        [--seed 0] [--out interp.gif] [--device cuda|cpu]

The anchors are z on the hypersphere mapped to w by G_ema's mapping network (a DUSty v2
generator); scipy's cubic interp1d runs through them on the host, over five copies of
the anchors so that the path is periodic. Each frame is one G forward at B=1 on its w
(truncated by --truncation_psi toward w_avg) with one fixed logistic noise map.
--mode 2d writes a GIF of the turbo-coloured strip (image_orig over the drop probability
over the image) through utils/image_io.py::save_video, exact in its colours and written
without an imaging library; --mode 3d writes an .npz of the frames' points (T, H W, 3)
and their surface normals (CoordBridge's normal_map).

Randomness, as the JAX script: numpy's global generator, seeded by init_random_seed,
draws the logistic noise; the anchors' z come from a torch.Generator on the device
seeded with --seed, or from the `normal` callable given to main().
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import scipy.interpolate
import torch

from ..geometry import CoordBridge
from ..models import fixed_noise_maps
from ..pretrained import autoload_ckpt
from ..utils import colorize_indices, init_random_seed, resolve_device, tanh_to_sigmoid
from ..utils.image_io import save_video
from .test_gan import fixed_logistic_noise

__all__ = ["main", "interpolation_path"]


def interpolation_path(ws: np.ndarray, frames_per_anchor: int) -> np.ndarray:
    """(A, D) anchors -> (A * frames_per_anchor, D) float32 points of the periodic cubic
    path through them."""
    A = ws.shape[0]
    interp = scipy.interpolate.interp1d(x=np.arange(-A * 2, A * 3), y=np.tile(ws, [5] + [1] * (ws.ndim - 1)),
                                        kind="cubic", axis=0)
    return interp(np.linspace(0, A, A * frames_per_anchor, endpoint=False)).astype(np.float32)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--mode", choices=["2d", "3d"], default="2d")
    parser.add_argument("--num_anchors", type=int, default=10)
    parser.add_argument("--frames_per_anchor", type=int, default=30)
    parser.add_argument("--truncation_psi", type=float, default=0.7)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="interp.gif")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None, normal: Optional[Callable[[tuple], torch.Tensor]] = None) -> Dict:
    """Renders the path; returns {"path", "frames" (2d: (3H, W) uint8 colour indices) or
    "points" / "normals" (3d), "seconds", "frames_per_s"}. `normal(shape)` replaces the
    torch.Generator's standard normal draws."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    init_random_seed(args.seed)
    if normal is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        normal = lambda shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    ckpt = autoload_ckpt(args.ckpt_path, device)
    cfg, G, angle = ckpt["cfg"], ckpt["G_ema"], ckpt["angle"]
    if not hasattr(G, "mapping_network"):
        raise ValueError("demo_interpolation needs a generator with a mapping network (dusty_v2)")
    H, W = cfg.model.generator.synthesis_kwargs.resolution
    coord = CoordBridge(H, W, cfg.dataset.min_depth, cfg.dataset.max_depth, angle=angle, device=device)
    num_styles = G.synthesis_network.num_styles

    zs = normal((args.num_anchors, G.style_dim)).to(device)
    zs = zs / torch.sqrt((zs**2).mean(dim=-1, keepdim=True) + 1e-8)
    with torch.no_grad():
        ws = G.mapping_network(zs).cpu().numpy()
    path = interpolation_path(ws, args.frames_per_anchor)
    noise = torch.as_tensor(fixed_logistic_noise(H, W), device=device)
    maps = fixed_noise_maps(G, args.seed, device)
    noise_kw = {} if maps is None else {"noise": maps}

    frames, points, normals = [], [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        for w in path:
            w_all = torch.as_tensor(w, device=device)[None, None].expand(1, num_styles, -1)
            o = G(w_all, angle, truncation_psi=args.truncation_psi, gumbel_noise=noise, input_w=True, **noise_kw)
            image = torch.clamp(tanh_to_sigmoid(o["image"]), 0, 1)
            if args.mode == "2d":
                panels = [image]
                if "image_orig" in o:
                    panels = [torch.clamp(tanh_to_sigmoid(o["image_orig"]), 0, 1), torch.sigmoid(o["raydrop_logit"])] + panels
                frames.append(colorize_indices(torch.cat(panels, dim=2))[0].to(torch.uint8).cpu().numpy())
            else:
                pm = coord.convert(image, "inv_depth_norm", "point_map")
                nm = coord.convert(pm, "point_map", "normal_map")
                points.append(pm[0].reshape(3, -1).T.cpu().numpy())
                normals.append(nm[0].reshape(3, -1).T.cpu().numpy())
    seconds = time.perf_counter() - t0
    rec = {"seconds": seconds, "frames_per_s": len(path) / seconds}
    if args.mode == "2d":
        rec["path"] = save_video(frames, args.out[:-4] if args.out.endswith(".gif") else args.out,
                                 fps=30)
        rec["frames"] = frames
    else:
        rec["path"] = args.out if args.out.endswith(".npz") else args.out + ".npz"
        rec["points"], rec["normals"] = np.stack(points), np.stack(normals)
        np.savez_compressed(rec["path"], points=rec["points"], normals=rec["normals"])
    print(f"saved {len(path)} frames -> {rec['path']} ({rec['frames_per_s']:.1f} frames/s)", flush=True)
    return rec


if __name__ == "__main__":
    main()
