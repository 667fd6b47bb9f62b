"""Sliced Wasserstein distance over Laplacian-pyramid patch descriptors (counterpart of
dusty_gan_v2_tpu/metrics/swd.py).

Gaussian pyramid with reflect padding, 7x7 patch descriptors (128 per image),
per-channel standardisation, random 1-D projections + sort; everything stays on the
images' device and only the per-level scalars leave it.

Randomness is explicit. The patch positions and the projection directions are drawn
from a torch.Generator (seed 0 on the images' device when none is given), or handed
in: `patch_inds[batch][level]` (flat indices into the level's (nH, nW) patch grid) and
`dirs[level][repeat]` ((C*pH*pW, dirs_per_repeat) normal draws before normalisation),
so that a test can inject the ones another implementation drew.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.pad import pad_axis
from ..utils import full_float32

__all__ = ["compute_swd", "laplacian_pyramid", "pyramid_down", "pyramid_up"]

_G5 = np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]).astype(np.float32)
_G5 /= _G5.sum()


def _reflect_pad(x, p):
    return pad_axis(pad_axis(x, -1, p, p, "reflect"), -2, p, p, "reflect")


def _dwconv(x, kern, stride=1):
    C = x.shape[1]
    k = torch.as_tensor(kern, dtype=x.dtype, device=x.device).expand(C, 1, *kern.shape)
    with full_float32():
        return F.conv2d(x, k, stride=stride, groups=C)


def pyramid_down(x):
    return _dwconv(_reflect_pad(x, 2), _G5, stride=2)


def pyramid_up(x):
    B, C, H, W = x.shape
    # zero-insertion upsample with the samples at the odd indices
    up = x.new_zeros((B, C, H * 2, W * 2))
    up[:, :, 1::2, 1::2] = x
    return _dwconv(_reflect_pad(up, 2), _G5 * 4.0)


def laplacian_pyramid(images, num_levels):
    pyramid = [images]
    for _ in range(1, num_levels):
        pyramid.append(pyramid_down(pyramid[-1]))
        pyramid[-2] = pyramid[-2] - pyramid_up(pyramid[-1])
    return pyramid


def _extract_patches(x, patch_size, inds):
    """(B, C, H, W) -> (B, P, C, pH, pW): the patches at the flat positions `inds` of
    the (H - pH + 1, W - pW + 1) grid of all overlapping patches, the same in every image."""
    pH, pW = patch_size
    windows = x.unfold(2, pH, 1).unfold(3, pW, 1)  # (B, C, nH, nW, pH, pW), a view
    nW = windows.shape[3]
    inds = torch.as_tensor(inds, device=x.device).long()
    return windows[:, :, inds // nW, inds % nW].permute(0, 2, 1, 3, 4)


def _finalize(desc):
    dims = (0, 1, 3, 4)
    mean = desc.mean(dims, keepdim=True)
    std = desc.std(dims, unbiased=False, keepdim=True)
    desc = (desc - mean) / (std + 1e-8)
    return desc.reshape(-1, desc.shape[2] * desc.shape[3] * desc.shape[4])


def _swd(desc1, desc2, dir_repeats, dirs_per_repeat, generator=None, dirs=None):
    D = desc1.shape[1]
    dists = []
    for r in range(dir_repeats):
        if dirs is None:
            d = torch.randn((D, dirs_per_repeat), generator=generator, device=desc1.device)
        else:
            d = torch.as_tensor(dirs[r], dtype=torch.float32, device=desc1.device)
        d = d / d.std(0, unbiased=False, keepdim=True)
        with full_float32():
            p1, p2 = desc1 @ d, desc2 @ d
        dists.append((p1.sort(0).values - p2.sort(0).values).abs().mean())
    return torch.stack(dists).mean()


@torch.no_grad()
def compute_swd(
    img1,
    img2,
    num_levels=None,
    patch_size=(7, 7),
    num_patches=128,
    dir_repeats=4,
    dirs_per_repeat=128,
    batch_size=128,
    generator: Optional[torch.Generator] = None,
    patch_inds: Optional[Sequence] = None,
    dirs: Optional[Sequence] = None,
) -> Dict[str, float]:
    """img1, img2: (B, C, H, W) tensors on one device -> {"swd-16": ..., "swd-mean": ...}."""
    assert img1.ndim == img2.ndim == 4 and img1.shape == img2.shape
    B, C, H, W = img1.shape
    if num_levels is None:
        num_levels = int(np.log2(min(H, W) // 16) + 1)
    if isinstance(patch_size, int):
        patch_size = (patch_size, patch_size)
    if generator is None:
        generator = torch.Generator(device=img1.device).manual_seed(0)

    desc1 = [[] for _ in range(num_levels)]
    desc2 = [[] for _ in range(num_levels)]
    for bi, i in enumerate(range(0, B, batch_size)):
        pyr1 = laplacian_pyramid(img1[i : i + batch_size].float(), num_levels)
        pyr2 = laplacian_pyramid(img2[i : i + batch_size].float(), num_levels)
        for lvl in range(num_levels):
            inds = None if patch_inds is None else patch_inds[bi][lvl]
            if inds is None:  # both sets are cut at the same positions
                nH, nW = pyr1[lvl].shape[2] - patch_size[0] + 1, pyr1[lvl].shape[3] - patch_size[1] + 1
                inds = torch.randperm(nH * nW, generator=generator, device=img1.device)[:num_patches]
            desc1[lvl].append(_extract_patches(pyr1[lvl], patch_size, inds))
            desc2[lvl].append(_extract_patches(pyr2[lvl], patch_size, inds))

    scores = [
        _swd(
            _finalize(torch.cat(desc1[lvl])), _finalize(torch.cat(desc2[lvl])),
            dir_repeats, dirs_per_repeat, generator, None if dirs is None else dirs[lvl],
        )
        for lvl in range(num_levels)
    ]
    result = {f"swd-{16 << lvl}": float(s) for lvl, s in enumerate(scores)}
    result["swd-mean"] = float(np.mean(list(result.values())))
    return result
