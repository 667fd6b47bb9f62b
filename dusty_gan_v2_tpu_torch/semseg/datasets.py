"""Semseg datasets: KITTI Raw frontal crops + GTA-LiDAR with ray-drop injection.

Counterpart of dusty_gan_v2_tpu/semseg/datasets.py, a numpy copy: the same files give
the same arrays, and the flip and the Bernoulli ray drop draw from numpy's global
generator with the same calls in the same order, so that after np.random.seed(s) an
item equals the JAX package's bit for bit.
  * KITTIRawFrontal: (64,512,6)=(x,y,z,intensity,depth,label) .npy frames, ImageSet
    splits, per-channel normalization, flip with y-negation.
  * GTALiDAR: simulated frames with Bernoulli ray-drop from a fixed probability map
    (uniform variant = map filled with its mean).
  * GTALiDAR_GAN: per-frame GAN-estimated drop maps from GTAV_noise_v{1,2} dirs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..datasets.kitti import nearest_resize_hw

__all__ = ["KITTIRawFrontal", "GTALiDAR", "GTALiDAR_GAN"]

# per-channel statistics from the reference (sqsg.py:59-67 / 148-156)
_KITTI_MEAN = np.array([10.88, 0.23, -1.04, 0.21, 12.12, 0.0], np.float32)
_KITTI_STD = np.array([11.47, 6.91, 0.86, 0.16, 12.32, 1.0], np.float32)
_GTA_MEAN = np.array([10.88, 0.23, -1.04, 12.12, 0.0], np.float32)
_GTA_STD = np.array([11.47, 6.91, 0.86, 12.32, 1.0], np.float32)


class KITTIRawFrontal:
    CLASS_LIST = ("unknown", "car", "pedestrian", "cyclist")

    def __init__(
        self,
        root="data/kitti_raw_frontal",
        split="train",
        shape: Tuple[int, int] = (64, 512),
        min_depth=1.45,
        max_depth=80.0,
        flip=False,
        omit_cyclist=False,
        cache: Optional[str] = None,
    ):
        assert split in ("all", "train", "val")
        self.root = Path(root)
        self.split = split
        self.shape = tuple(shape)
        self.flip = flip
        self.omit_cyclist = omit_cyclist
        self._cache = {} if cache == "ram" else None
        setlist = self.root / "ImageSet" / f"{split}.txt"
        assert setlist.exists(), setlist
        with open(setlist) as f:
            self.datalist = [p.strip() + ".npy" for p in f.readlines()]

    def __len__(self):
        return len(self.datalist)

    @property
    def class_list(self):
        return self.CLASS_LIST[:3] if self.omit_cyclist else self.CLASS_LIST

    def __getitem__(self, index):
        # cache="ram" memoizes the deterministic load+resize; everything
        # stochastic (flip) stays per-access
        if self._cache is not None and index in self._cache:
            pts = self._cache[index]
        else:
            pts = np.load(self.root / "lidar_2d" / self.datalist[index])  # (64,512,6)
            pts = nearest_resize_hw(pts.astype(np.float32), self.shape)
            if self._cache is not None:
                self._cache[index] = pts
        chw = pts.transpose(2, 0, 1).copy()
        mask = (chw[4] > 0).astype(np.float32)
        chw[:-1] *= mask[None]
        chw = (chw - _KITTI_MEAN[:, None, None]) / _KITTI_STD[:, None, None]
        if self.flip and np.random.rand() > 0.5:
            chw = chw[:, :, ::-1].copy()
            chw[1] *= -1
            mask = mask[:, ::-1].copy()
        if self.omit_cyclist:
            chw[5][chw[5] == 3] = 0
        return {
            "xyz": chw[:3],
            "reflectance": chw[3:4],
            "depth": chw[4:5],
            "label": chw[5].astype(np.int32),
            "mask": mask,
        }


class _GTABase:
    CLASS_LIST = ("unknown", "car", "pedestrian")

    def __init__(self, root, shape, flip, cache=None):
        self.root = Path(root)
        self.shape = tuple(shape)
        self.flip = flip
        self.datalist = sorted((self.root / "GTAV").glob("*/*.npy"))
        # cache="ram" memoizes the deterministic load+resize (and GAN drop maps);
        # the Bernoulli ray-drop / flip stay stochastic per access
        self._cache = {} if cache == "ram" else None

    def _load_resized(self, key, path):
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        pts = nearest_resize_hw(np.load(path).astype(np.float32), self.shape)
        if self._cache is not None:
            self._cache[key] = pts
        return pts

    def __len__(self):
        return len(self.datalist)

    @property
    def class_list(self):
        return self.CLASS_LIST

    def _finish(self, pts, dropout_map):
        chw = pts.transpose(2, 0, 1).copy()  # (5,H,W): x,y,z,depth,label
        mask = (chw[3] > 0).astype(np.float32)
        if dropout_map is not None:
            mask *= (np.random.rand(*dropout_map.shape) < dropout_map).astype(
                np.float32
            )
        chw[:-1] *= mask[None]
        chw = (chw - _GTA_MEAN[:, None, None]) / _GTA_STD[:, None, None]
        if self.flip and np.random.rand() > 0.5:
            chw = chw[:, :, ::-1].copy()
            chw[1] *= -1
            mask = mask[:, ::-1].copy()
        return {
            "xyz": chw[:3],
            "depth": chw[3:4],
            "label": chw[4].astype(np.int32),
            "mask": mask,
        }


class GTALiDAR(_GTABase):
    def __init__(self, root="data/kitti_raw_frontal", split="all",
                 shape=(64, 512), min_depth=1.45, max_depth=80.0, flip=False,
                 raydrop_p: Optional[np.ndarray] = None, cache=None):
        assert split == "all"
        super().__init__(root, shape, flip, cache)
        if raydrop_p is None:
            self.dropout_map = np.ones(shape, np.float32)
        else:
            assert raydrop_p.shape == tuple(shape)
            self.dropout_map = raydrop_p.astype(np.float32)

    def __getitem__(self, index):
        return self._finish(
            self._load_resized(index, self.datalist[index]), self.dropout_map
        )


class GTALiDAR_GAN(_GTABase):
    def __init__(self, root="data/kitti_raw_frontal", split="all",
                 shape=(64, 512), min_depth=1.45, max_depth=80.0, flip=False,
                 gan_dir="GTAV_noise", cache=None):
        assert split == "all"
        super().__init__(root, shape, flip, cache)
        self.gan_dir = gan_dir

    def __getitem__(self, index):
        path = self.datalist[index]
        if self._cache is not None and ("n", index) in self._cache:
            noise = self._cache[("n", index)]
        else:
            noise = np.load(str(path).replace("GTAV", self.gan_dir)).astype(np.float32)
            if self._cache is not None:
                self._cache[("n", index)] = noise
        return self._finish(self._load_resized(index, path), noise)
