"""The port's evaluation entry points (counterpart of test_gan.py after checkpoint
loading): generate, map images to point clouds, PointNet features and FPS, then
SWD / JSD / COV-MMD-1-NNA over CD, EMD or DCD / FPD / KPD.

    G = build_generator(full_gen_cfg())                      # CUDA by default
    angle = load_angle(); coord = make_coord_bridge(angle)
    pointnet = build_pointnet()                              # seeded random weights
    gen = collect_generated(G, angle, coord, n=2048, pointnet=pointnet)
    ref = reals_to_outputs(depth, mask, coord, pointnet=pointnet)
    scores = evaluate(gen, ref)

Everything a stage produces stays on the device until a metric needs it on the host:
the pairwise matrices leave in one download each, the features once for FPD/KPD.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .geometry import CoordBridge
from .metrics import (
    compute_cov_mmd_1nna,
    compute_frechet_distance,
    compute_jsd,
    compute_squared_mmd,
    compute_swd,
    downsample_point_clouds,
)
from .models import build_pe_cache
from .ops import sample_logistic
from .sampling import sample
from .utils import resolve_device, sigmoid_to_tanh, tanh_to_sigmoid

__all__ = [
    "DEFAULT_METRICS", "Outputs", "features", "to_outputs", "collect_generated", "reals_to_outputs", "evaluate",
]

# the protocol's metric list (test_gan.py's default): 1nna-emd is the expensive stage
DEFAULT_METRICS = ("swd", "jsd", "1nna-emd", "fpd", "kpd")
# clouds per PointNet call: its (B, 1024, H*W) activations take 134 MB a cloud at 64x512
_POINTNET_BATCH = 8


class Outputs(NamedTuple):
    """What the metrics read of a set: inverse-depth images (B, 1, H, W) in [0, 1],
    FPS-downsampled clouds (B, k, 3) in units of max_depth, PointNet features (B, F)
    (F = 0 without a PointNet)."""

    images: torch.Tensor
    points: torch.Tensor
    features: torch.Tensor


def _images_to_points(img_tanh: torch.Tensor, coord: CoordBridge):
    inv = torch.clamp(tanh_to_sigmoid(img_tanh), 0, 1)
    return inv, coord.convert(inv, "inv_depth_norm", "point_set") / coord.max_depth


def _pointnet_features(pts: torch.Tensor, pointnet) -> torch.Tensor:
    if pointnet is None:
        return pts.new_zeros((pts.shape[0], 0))
    return torch.cat([
        pointnet(pts[i : i + _POINTNET_BATCH].transpose(1, 2)) for i in range(0, pts.shape[0], _POINTNET_BATCH)
    ])


@torch.no_grad()
def features(img_tanh: torch.Tensor, coord: CoordBridge, pointnet) -> torch.Tensor:
    """Generator images in [-1, 1] -> the full clouds' PointNet features (B, F)."""
    return _pointnet_features(_images_to_points(img_tanh, coord)[1], pointnet)


@torch.no_grad()
def to_outputs(
    img_tanh: torch.Tensor, coord: CoordBridge, pointnet=None, num_points: int = 2048
) -> Outputs:
    """Generator images in [-1, 1] -> Outputs: clipped inverse depth, the full cloud's
    PointNet features, and the cloud FPS-downsampled to `num_points`."""
    inv, pts = _images_to_points(img_tanh, coord)
    return Outputs(inv, downsample_point_clouds(pts, num_points), _pointnet_features(pts, pointnet))


@torch.no_grad()
def collect_generated(
    G,
    angle: torch.Tensor,
    coord: CoordBridge,
    n: int,
    batch_size: int = 64,
    num_subsample: int = 2048,
    pointnet=None,
    num_points: int = 2048,
    truncation_psi: float = 1.0,
    fixed_logistic: Optional[torch.Tensor] = None,
    z: Optional[torch.Tensor] = None,
    seed: int = 0,
) -> Outputs:
    """Generate n samples on angle's device. Features are kept for all of them (FPD and
    KPD read the full set), images and clouds only for the first `num_subsample`,
    which is all SWD, JSD and 1-NNA read. The ray-drop is deterministic: one logistic
    noise map (1, 1, H, W) shared by every sample (drawn from `seed` unless given).
    `z` (n, z_dim) may be handed in; else it is drawn from `seed` batch by batch."""
    device = angle.device
    generator = torch.Generator(device=device).manual_seed(seed)
    if fixed_logistic is None:
        fixed_logistic = sample_logistic(generator, (1, 1, *angle.shape[-2:]), device, eps=1e-6)
    fixed_logistic = fixed_logistic.to(device)
    z_dim = int(G.style_dim)
    pe_cache = build_pe_cache(G, angle)  # constants of the fixed sensor grid (None without Fourier PE)
    imgs, pts, feats = [], [], []
    for done in range(0, n, batch_size):
        b = min(batch_size, n - done)
        zb = (
            torch.randn((b, z_dim), generator=generator, device=device)
            if z is None else z[done : done + b].to(device)
        )
        o = sample(G, zb, None, truncation_psi, fixed_logistic, pe_cache=pe_cache)
        out = to_outputs(o["image"], coord, pointnet, num_points)
        if done < num_subsample:
            imgs.append(out.images)
            pts.append(out.points)
        feats.append(out.features)
    if not imgs:  # nothing kept: empty sets of the right rank
        imgs, pts = [feats[0].new_zeros((0, 1, *angle.shape[-2:]))], [feats[0].new_zeros((0, num_points, 3))]
    return Outputs(torch.cat(imgs)[:num_subsample], torch.cat(pts)[:num_subsample], torch.cat(feats))


@torch.no_grad()
def reals_to_outputs(
    depth: torch.Tensor,
    mask: torch.Tensor,
    coord: CoordBridge,
    raydrop_const: float = -1.0,
    pointnet=None,
    num_points: int = 2048,
) -> Outputs:
    """Real scans, as metric depth (B, 1, H, W) and validity mask, -> Outputs through
    the same stages as generated images (dropped pixels take `raydrop_const`)."""
    x = sigmoid_to_tanh(coord.convert(depth, "depth", "inv_depth_norm"))
    x = mask * x + (1 - mask) * float(raydrop_const)
    return to_outputs(x, coord, pointnet, num_points)


def evaluate(
    gen: Outputs,
    ref: Outputs,
    metrics: Sequence[str] = DEFAULT_METRICS,
    pairwise_batch: int = 256,
    num_subsample: int = 2048,
    train_features=None,
    device="cuda",
    seed: int = 0,
    stage_times: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Scores of a generated set against a reference set.

    metrics: any of swd, jsd, 1nna-cd, 1nna-emd, 1nna-dcd, fpd, kpd. SWD, JSD and 1-NNA
    read the first `num_subsample` images and clouds of both sets; FPD and KPD read
    the features of all generated samples against `train_features` (the training
    split's, as in the protocol; the reference set's own when none are given).
    `seed` fixes SWD's patches and directions and KPD's subsets. Seconds per stage are
    printed as `[t] stage: seconds` lines and go into `stage_times` when a dict is given."""
    device = resolve_device(device)
    unknown = set(metrics) - {"swd", "jsd", "1nna-cd", "1nna-emd", "1nna-dcd", "fpd", "kpd"}
    if unknown:
        raise ValueError(f"unknown metrics: {sorted(unknown)}")
    stage_t = time.perf_counter()

    def stage(name):
        nonlocal stage_t
        now = time.perf_counter()
        if stage_times is not None:
            stage_times[name] = now - stage_t
        print(f"[t] {name}: {now - stage_t:.1f}s", flush=True)
        stage_t = now

    def on_device(x):
        return torch.as_tensor(x)[:num_subsample].to(device)

    scores: Dict[str, float] = {}
    if "swd" in metrics:
        generator = torch.Generator(device=device).manual_seed(seed)
        scores.update(compute_swd(on_device(gen.images), on_device(ref.images), generator=generator))
        stage("swd")
    gen_pts, ref_pts = on_device(gen.points), on_device(ref.points)
    if "jsd" in metrics:
        scores["jsd"] = compute_jsd(gen_pts / 2.0, ref_pts / 2.0, device=device)
        stage("jsd")
    for m in metrics:
        if m.startswith("1nna"):
            scores.update(compute_cov_mmd_1nna(
                gen_pts, ref_pts, batch_size=pairwise_batch, metrics=(m.split("-")[1],), device=device
            ))
            stage(m)
    if "fpd" in metrics or "kpd" in metrics:
        to_host = lambda f: torch.as_tensor(f).cpu().numpy()  # noqa: E731
        gen_feats = to_host(gen.features)
        ref_feats = to_host(ref.features if train_features is None else train_features)
        if "fpd" in metrics:
            scores["fpd"] = compute_frechet_distance(gen_feats, ref_feats)
            stage("fpd")
        if "kpd" in metrics:
            rng = np.random.RandomState(seed)
            scores["kpd"] = compute_squared_mmd(gen_feats, ref_feats, rng=rng) * 1000.0
            stage("kpd")
    return scores
