"""GAN inversion and pivotal tuning of a trained generator onto a KITTI Raw frame
(counterpart of demo_inversion.py): the frame's ray-drop probability map is the
per-frame drop map of the sim2real pipeline.

    python -m dusty_gan_v2_tpu_torch.cli.demo_inversion --ckpt_path <checkpoint> \
        [--dataset_root DIR] [--sample_id -1] [--latent_type z|w|w+] [--num_steps_1st 500] \
        [--num_steps_2nd 500] [--optimize_phase] [--hypersphere_z] [--out_dir inversion_out] \
        [--device cuda|cpu]

Stage 1 optimizes the latent (z, w or w+; the laser angles' phase too with
--optimize_phase) with Adam at lr_1st times the StyleGAN2 schedule, set on the parameter
group each step; --hypersphere_z projects the latent back onto the hypersphere after
each step (and the initial w). Stage 2 (pivotal tuning) freezes the latent and the phase
and tunes every parameter of a copy of G_ema with Adam at lr_2nd; its buffers (w_avg,
ema_var, the Fourier bases) stay as loaded. The loss is the multiscale masked L1 (two
levels) on depth_norm and on inv_depth_norm, plus 5e-3 of the geodesic cross term for
w+. Each step is one G forward at B=1 on the uncached angle grid (the phase's gradient
runs through the angle pyramid and the Fourier encodings).

Outputs in --out_dir: raydrop_prob_<id>.npy (H x W float32, sigmoid of the tuned G's
raydrop logit) and summary_<id>.png (the target's inverse depth, image_orig, the drop
probability and the image, stacked, turbo-coloured; written without an imaging library).

Randomness, as the JAX script: numpy's global generator, seeded by init_random_seed,
draws the sample id (when --sample_id is -1) and then the logistic noise. The normal
draws (10,000 z for the initial w, then the initial z) come from a torch.Generator on
the device seeded with --seed, or from the `normal` callable given to main().
"""

from __future__ import annotations

import argparse
import copy
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..datasets.kitti import KITTIRaw
from ..geometry import CoordBridge
from ..inversion import geocross_loss, multiscale_masked_loss, spherical_project, stylegan2_lr_schedule
from ..models import fixed_noise_maps
from ..pretrained import autoload_ckpt
from ..utils import colorize, init_random_seed, resolve_device, tanh_to_sigmoid
from ..utils.image_io import to_uint8, write_png
from .test_gan import fixed_logistic_noise

__all__ = ["main", "Inversion", "LatentStage", "TuningStage", "W_AVG_SAMPLES"]

W_AVG_SAMPLES = 10_000
LOG_EVERY = 100


class Inversion:
    """The loss of one target frame: G(styles, angle + phase) against the target's
    depth_norm and inv_depth_norm, through `__call__(G, latent, phase) -> (loss, outputs)`."""

    def __init__(self, coord: CoordBridge, angle: torch.Tensor, depth: torch.Tensor, mask: torch.Tensor,
                 gumbel_noise: torch.Tensor, latent_type: str, num_styles: int, noise_maps=None):
        """depth and mask (1, 1, H, W): the target in metres and its valid pixels;
        `noise_maps` the fixed maps of a generator with noise injection
        (models.fixed_noise_maps)."""
        if latent_type not in ("z", "w", "w+"):
            raise ValueError(f"unknown latent type {latent_type!r}")
        self.coord, self.angle, self.noise = coord, angle, gumbel_noise
        self.noise_kw = {} if noise_maps is None else {"noise": noise_maps}
        self.latent_type, self.num_styles = latent_type, num_styles
        self.mask = mask
        self.depth = coord.convert(depth, "depth", "depth_norm")
        self.inv = coord.convert(self.depth, "depth_norm", "inv_depth_norm") * mask

    def styles(self, G, latent: torch.Tensor) -> torch.Tensor:
        if self.latent_type == "z":
            return G.mapping_network(latent)[:, None].expand(-1, self.num_styles, -1)
        if self.latent_type == "w":
            return latent[:, None].expand(-1, self.num_styles, -1)
        return latent

    def __call__(self, G, latent: torch.Tensor, phase: torch.Tensor):
        w = self.styles(G, latent)
        o = G(w, self.angle + phase, gumbel_noise=self.noise, input_w=True, **self.noise_kw)
        inv = tanh_to_sigmoid(o["image_orig"])
        depth = self.coord.convert(inv, "inv_depth_norm", "depth_norm")
        loss = multiscale_masked_loss(depth, self.depth, self.mask, level=2)
        loss = loss + multiscale_masked_loss(inv, self.inv, self.mask, level=2)
        if self.latent_type == "w+":
            loss = loss + 5e-3 * geocross_loss(w)
        return loss.sum(), o


class LatentStage:
    """Stage 1: Adam on the latent (and the phase with `optimize_phase`) at lr times the
    StyleGAN2 schedule of `num_steps`; G's weights stay fixed."""

    def __init__(self, inv: Inversion, G, latent: torch.Tensor, phase: torch.Tensor, num_steps: int, lr: float,
                 optimize_phase: bool = False, hypersphere_z: bool = False):
        self.inv, self.G, self.lr, self.hypersphere_z = inv, G, lr, hypersphere_z
        self.latent = latent.detach().clone().requires_grad_(True)
        self.phase = phase.detach().clone().requires_grad_(optimize_phase)
        self.opt = torch.optim.Adam([self.latent] + ([self.phase] if optimize_phase else []), lr=lr)
        self.sched = stylegan2_lr_schedule(num_steps)

    def step(self, i: int) -> torch.Tensor:
        self.opt.param_groups[0]["lr"] = self.lr * self.sched(i)
        self.opt.zero_grad(set_to_none=True)
        loss, _ = self.inv(self.G, self.latent, self.phase)
        loss.backward()
        self.opt.step()
        if self.hypersphere_z:
            with torch.no_grad():
                self.latent.copy_(spherical_project(self.latent))
        return loss.detach()


class TuningStage:
    """Stage 2 (pivotal tuning): Adam at lr on every parameter of a copy of G, the latent
    and the phase frozen. Parameters that get no gradient (the mapping network unless
    the latent is z) are left as they are, as a zero gradient leaves them under Adam."""

    def __init__(self, inv: Inversion, G, latent: torch.Tensor, phase: torch.Tensor, lr: float):
        self.inv, self.latent, self.phase = inv, latent.detach(), phase.detach()
        self.G = copy.deepcopy(G).requires_grad_(True)
        self.opt = torch.optim.Adam(self.G.parameters(), lr=lr)

    def step(self) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss, _ = self.inv(self.G, self.latent, self.phase)
        loss.backward()
        self.opt.step()
        return loss.detach()


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--sample_id", type=int, default=-1)
    parser.add_argument("--latent_type", choices=["z", "w", "w+"], default="w")
    parser.add_argument("--num_steps_1st", type=int, default=500)
    parser.add_argument("--num_steps_2nd", type=int, default=500)
    parser.add_argument("--lr_1st", type=float, default=5e-2)
    parser.add_argument("--lr_2nd", type=float, default=5e-4)
    parser.add_argument("--hypersphere_z", action="store_true")
    parser.add_argument("--optimize_phase", action="store_true")
    parser.add_argument("--dataset_root", default=None)
    parser.add_argument("--out_dir", default="inversion_out")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None, normal: Optional[Callable[[tuple], torch.Tensor]] = None) -> Dict:
    """Runs the inversion; returns {"sample_id", "raydrop_prob" (H, W), "losses_1st",
    "losses_2nd" (one float a step), "latent", "phase", "seconds" (per stage)}.
    `normal(shape)` replaces the torch.Generator's standard normal draws."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    init_random_seed(args.seed)
    if normal is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        normal = lambda shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    seconds = {}
    t0 = time.perf_counter()
    ckpt = autoload_ckpt(args.ckpt_path, device)
    cfg, G, angle = ckpt["cfg"], ckpt["G_ema"], ckpt["angle"]
    H, W = cfg.model.generator.synthesis_kwargs.resolution
    coord = CoordBridge(H, W, cfg.dataset.min_depth, cfg.dataset.max_depth, angle=angle, device=device)
    num_styles = G.synthesis_network.num_styles

    ds = KITTIRaw(root=args.dataset_root or cfg.dataset.root, split="test", shape=(H, W),
                  min_depth=cfg.dataset.min_depth, max_depth=cfg.dataset.max_depth)
    if args.sample_id == -1:
        args.sample_id = int(np.random.randint(len(ds)))
    item = ds[args.sample_id]
    depth = torch.as_tensor(item["depth"][None], device=device)
    mask = torch.as_tensor(item["mask"][None], device=device)

    # the initial latent from the mean w of W_AVG_SAMPLES mapped z
    with torch.no_grad():
        w_avg = G.mapping_network(normal((W_AVG_SAMPLES, G.style_dim)).to(device)).mean(dim=0, keepdim=True)
    if args.hypersphere_z:
        w_avg = spherical_project(w_avg)
    if args.latent_type == "z":
        latent = normal((1, G.style_dim)).to(device)
    elif args.latent_type == "w":
        latent = w_avg
    else:
        latent = w_avg[:, None].repeat(1, num_styles, 1)
    phase = torch.zeros((1, 2, 1, 1), device=device)
    noise = torch.as_tensor(fixed_logistic_noise(H, W), device=device)
    inv = Inversion(coord, angle, depth, mask, noise, args.latent_type, num_styles,
                    fixed_noise_maps(G, args.seed, device))
    _sync(device)
    seconds["setup"] = time.perf_counter() - t0

    def run(tag, steps, step_fn):
        t0, losses = time.perf_counter(), []
        for i in range(steps):
            losses.append(step_fn(i))
            if i % LOG_EVERY == 0:
                print(f"[{tag}] step {i:4d} loss {float(losses[-1]):.5f}", flush=True)
        _sync(device)
        seconds[tag] = time.perf_counter() - t0
        return torch.stack(losses).tolist() if losses else []

    stage1 = LatentStage(inv, G, latent, phase, args.num_steps_1st, args.lr_1st, args.optimize_phase,
                         args.hypersphere_z)
    losses_1st = run("1", args.num_steps_1st, stage1.step)
    latent, phase = stage1.latent.detach(), stage1.phase.detach()
    stage2 = TuningStage(inv, G, latent, phase, args.lr_2nd)
    losses_2nd = run("2", args.num_steps_2nd, lambda i: stage2.step())

    t0 = time.perf_counter()
    with torch.no_grad():
        _, o = inv(stage2.G, latent, phase)
    raydrop_prob = torch.sigmoid(o["raydrop_logit"])
    os.makedirs(args.out_dir, exist_ok=True)
    prob = raydrop_prob[0, 0].float().cpu().numpy()
    np.save(os.path.join(args.out_dir, f"raydrop_prob_{args.sample_id:010d}.npy"), prob)
    panels = [inv.inv, torch.clamp(tanh_to_sigmoid(o["image_orig"]), 0, 1), raydrop_prob,
              torch.clamp(tanh_to_sigmoid(o["image"]), 0, 1)]
    grid = torch.cat([colorize(p)[0].permute(1, 2, 0) for p in panels], dim=0).cpu().numpy()
    write_png(os.path.join(args.out_dir, f"summary_{args.sample_id:010d}.png"), to_uint8(grid))
    seconds["outputs"] = time.perf_counter() - t0
    print("saved outputs to", args.out_dir, "| seconds", {k: round(v, 3) for k, v in seconds.items()}, flush=True)
    return {"sample_id": args.sample_id, "raydrop_prob": prob, "losses_1st": losses_1st, "losses_2nd": losses_2nd,
            "latent": latent, "phase": phase, "seconds": seconds}


if __name__ == "__main__":
    main()
