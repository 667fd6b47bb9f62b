"""KITTI Raw LiDAR dataset: raw velodyne .bin -> (64, 2048) range images via scan
unfolding, nearest-resized to the model resolution; the infinite sampler, the threaded
batch loader and the device prefetcher of the training loop.

Counterpart of dusty_gan_v2_tpu/datasets/kitti.py, a numpy copy of its split tables,
`scan_unfolding` / z-buffer projection, resize, `KITTIRaw`, `InfiniteSampler` and
`Prefetcher`: the same frames give the same arrays. `KITTIRaw` projects each frame with
the C++ library of datasets/native.py (built with g++ at first use; a build failure
raises), as the JAX loader does where its library loads, then resizes with numpy as the
JAX loader does; the numpy projection here is the library's test oracle and plain
version, and no loader path falls back to it.
`DevicePrefetcher` keeps batches in flight to a CUDA device: pinned host tensors
copied with non_blocking=True on a side stream, the consumer's stream waiting on an
event of that stream.
"""

from __future__ import annotations

import collections
import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .native import project_points_to_image_native

__all__ = [
    "KITTIRaw", "InfiniteSampler", "Prefetcher", "DevicePrefetcher", "to_device", "project_points_to_image",
    "scan_unfold_rings", "nearest_resize_hw",
]

# odometry sequence -> (raw drive, start frame, end frame)
_KITTI_ODOMETRY_TO_RAW = {
    0: ("2011_10_03_drive_0027_sync", 0, 4540),
    1: ("2011_10_03_drive_0042_sync", 0, 1100),
    2: ("2011_10_03_drive_0034_sync", 0, 4660),
    3: ("2011_09_26_drive_0067_sync", 0, 800),  # raw data unavailable; skipped
    4: ("2011_09_30_drive_0016_sync", 0, 270),
    5: ("2011_09_30_drive_0018_sync", 0, 2760),
    6: ("2011_09_30_drive_0020_sync", 0, 1100),
    7: ("2011_09_30_drive_0027_sync", 0, 1100),
    8: ("2011_09_30_drive_0028_sync", 1100, 5170),
    9: ("2011_09_30_drive_0033_sync", 0, 1590),
    10: ("2011_09_30_drive_0034_sync", 0, 1200),
}

_SEQUENCE_SPLITS = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "val": [8],
}

# city/road/residential drives used for the test split (everything not in trainval)
_KITTI_RAW_RECORDS = {
    "city": [
        "2011_09_26_drive_0001_sync", "2011_09_26_drive_0002_sync",
        "2011_09_26_drive_0005_sync", "2011_09_26_drive_0009_sync",
        "2011_09_26_drive_0011_sync", "2011_09_26_drive_0013_sync",
        "2011_09_26_drive_0014_sync", "2011_09_26_drive_0017_sync",
        "2011_09_26_drive_0018_sync", "2011_09_26_drive_0048_sync",
        "2011_09_26_drive_0051_sync", "2011_09_26_drive_0056_sync",
        "2011_09_26_drive_0057_sync", "2011_09_26_drive_0059_sync",
        "2011_09_26_drive_0060_sync", "2011_09_26_drive_0084_sync",
        "2011_09_26_drive_0091_sync", "2011_09_26_drive_0093_sync",
        "2011_09_26_drive_0095_sync", "2011_09_26_drive_0096_sync",
        "2011_09_26_drive_0104_sync", "2011_09_26_drive_0106_sync",
        "2011_09_26_drive_0113_sync", "2011_09_26_drive_0117_sync",
        "2011_09_28_drive_0001_sync", "2011_09_28_drive_0002_sync",
        "2011_09_29_drive_0026_sync", "2011_09_29_drive_0071_sync",
    ],
    "road": [
        "2011_09_26_drive_0015_sync", "2011_09_26_drive_0027_sync",
        "2011_09_26_drive_0028_sync", "2011_09_26_drive_0029_sync",
        "2011_09_26_drive_0032_sync", "2011_09_26_drive_0052_sync",
        "2011_09_26_drive_0070_sync", "2011_09_26_drive_0101_sync",
        "2011_09_29_drive_0004_sync", "2011_09_30_drive_0016_sync",
        "2011_10_03_drive_0042_sync", "2011_10_03_drive_0047_sync",
    ],
    "residential": [
        "2011_09_26_drive_0019_sync", "2011_09_26_drive_0020_sync",
        "2011_09_26_drive_0022_sync", "2011_09_26_drive_0023_sync",
        "2011_09_26_drive_0035_sync", "2011_09_26_drive_0036_sync",
        "2011_09_26_drive_0039_sync", "2011_09_26_drive_0046_sync",
        "2011_09_26_drive_0061_sync", "2011_09_26_drive_0064_sync",
        "2011_09_26_drive_0079_sync", "2011_09_26_drive_0086_sync",
        "2011_09_26_drive_0087_sync", "2011_09_30_drive_0018_sync",
        "2011_09_30_drive_0020_sync", "2011_09_30_drive_0027_sync",
        "2011_09_30_drive_0028_sync", "2011_09_30_drive_0033_sync",
        "2011_09_30_drive_0034_sync", "2011_10_03_drive_0027_sync",
        "2011_10_03_drive_0034_sync",
    ],
}

_KITTI_RAW_TRAINVAL = {
    "2011_10_03_drive_0027_sync", "2011_10_03_drive_0042_sync",
    "2011_10_03_drive_0034_sync", "2011_09_26_drive_0067_sync",
    "2011_09_30_drive_0016_sync", "2011_09_30_drive_0018_sync",
    "2011_09_30_drive_0020_sync", "2011_09_30_drive_0027_sync",
    "2011_09_30_drive_0028_sync", "2011_09_30_drive_0033_sync",
    "2011_09_30_drive_0034_sync",
}


def scan_unfold_rings(x: np.ndarray, y: np.ndarray, H: int) -> np.ndarray:
    """Recover the laser ring index from the point ordering: detect azimuth wrap-arounds
    (3rd -> 1st quadrant transitions) and index segments from the bottom up."""
    quads = np.zeros(len(x), np.int32)
    quads[(x < 0) & (y >= 0)] = 1
    quads[(x < 0) & (y < 0)] = 2
    quads[(x >= 0) & (y < 0)] = 3
    diff = np.roll(quads, 1) - quads
    delim = np.where(diff == 3)[0]  # segment starts
    grid_h = np.zeros(len(x), np.int32)
    S = len(delim)
    if S == 0:
        return grid_h
    # segment i (0-based over delim) gets ring H - S + i; rings < 0 stay 0 (same as the
    # reference's early 'break' leaving the leading segments at 0)
    bounds = np.concatenate([delim, [len(x)]])
    seg_of_point = np.searchsorted(bounds, np.arange(len(x)), side="right") - 1
    ring = H - S + seg_of_point
    valid = seg_of_point >= 0
    grid_h[valid] = np.clip(ring[valid], 0, H - 1) * (ring[valid] >= 0)
    grid_h[ring < 0] = 0
    return grid_h


def project_points_to_image(
    points: np.ndarray,
    H: int = 64,
    W: int = 2048,
    min_depth: float = 0.9,
    max_depth: float = 120.0,
    scan_unfolding: bool = True,
) -> np.ndarray:
    """(N,4) xyzi -> (H,W,6) image of [x,y,z,intensity,depth,mask], nearest-point wins."""
    xyz = points[:, :3]
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    depth = np.linalg.norm(xyz, axis=1)
    mask = ((depth >= min_depth) & (depth <= max_depth)).astype(np.float32)
    feats = np.concatenate(
        [points, depth[:, None], mask[:, None]], axis=1
    )  # (N, 6)

    if scan_unfolding:
        grid_h = scan_unfold_rings(x, y, H)
    else:
        fup, fdown = np.deg2rad(3), np.deg2rad(-25)
        pitch = np.arcsin(np.clip(z / np.maximum(depth, 1e-12), -1, 1)) + abs(fdown)
        grid_h = np.floor((1 - pitch / (fup - fdown)) * H).clip(0, H - 1).astype(np.int32)

    yaw = -np.arctan2(y, x)
    grid_w = np.floor(((yaw / np.pi + 1) / 2 % 1) * W).clip(0, W - 1).astype(np.int32)

    # vectorized z-buffer: per cell keep the nearest point (the reference scatters
    # far-to-near so the last=nearest write wins)
    flat = grid_h.astype(np.int64) * W + grid_w
    order = np.lexsort((depth, flat))  # grouped by cell, ascending depth
    flat_sorted = flat[order]
    first = np.ones(len(flat_sorted), bool)
    first[1:] = flat_sorted[1:] != flat_sorted[:-1]
    winners = order[first]

    out = np.zeros((H * W, 6), np.float32)
    out[flat[winners]] = feats[winners]
    return out.reshape(H, W, 6)


def nearest_resize_hw(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbor resize of (H,W,C): src index = floor(dst * in/out)
    (torch interpolate(mode="nearest") convention used by the reference)."""
    H, W = img.shape[:2]
    OH, OW = shape
    ih = np.floor(np.arange(OH) * (H / OH)).astype(np.int64)
    iw = np.floor(np.arange(OW) * (W / OW)).astype(np.int64)
    return img[ih][:, iw]


class KITTIRaw:
    """Map-style dataset over raw velodyne scans (64x2048 native grid)."""

    def __init__(
        self,
        root: str = "data/kitti_raw",
        split: str = "train",
        shape: Tuple[int, int] = (64, 2048),
        min_depth: float = 0.9,
        max_depth: float = 120.0,
        flip: bool = False,
        scan_unfolding: bool = True,
        prune_missing: bool = False,
        cache: Optional[str] = None,
    ):
        """cache="ram" memoizes the projected+resized frames (deterministic work:
        scan unfold, z-buffer, resize, masking; the stochastic flip stays
        per-access). The reference re-projects on every access
        (gans/datasets/kitti.py:265-270) — fine with many loader processes, but on
        few-core hosts the projection starves the accelerator once frames repeat
        (~0.8 MB/frame at 64x512, ~15 GB for the full 19k-frame train split: size
        the host RAM accordingly, or leave off)."""
        if split not in ("train", "val", "test"):
            raise ValueError(f"unknown split {split!r}")
        self.root = Path(root)
        self.split = split
        self.shape = tuple(shape)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.flip = flip
        self.scan_unfolding = scan_unfolding
        self._cache: Optional[Dict[int, np.ndarray]] = {} if cache == "ram" else None
        self.datalist: List[str] = []

        if split in ("train", "val"):
            for seq in _SEQUENCE_SPLITS[split]:
                if seq == 3:
                    continue  # kitti raw does not ship odometry sequence 03
                name, start, end = _KITTI_ODOMETRY_TO_RAW[seq]
                day = name[:10]
                for i in range(start, end + 1):
                    self.datalist.append(
                        str(self.root / day / name / "velodyne_points" / "data" / f"{i:010d}.bin")
                    )
        else:
            for category in ("city", "road", "residential"):
                for name in _KITTI_RAW_RECORDS[category]:
                    if name in _KITTI_RAW_TRAINVAL:
                        continue
                    d = self.root / name[:10] / name / "velodyne_points" / "data"
                    self.datalist += [str(p) for p in sorted(d.glob("*.bin"))]

        if prune_missing:
            # partial-download trees (and tiny CI fixtures): keep only frames that
            # exist on disk instead of crashing at first read
            self.datalist = [p for p in self.datalist if os.path.exists(p)]

    def __len__(self):
        return len(self.datalist)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and index in self._cache:
            img = self._cache[index]
        else:
            pts = np.fromfile(self.datalist[index], dtype=np.float32).reshape(-1, 4)
            img = project_points_to_image_native(pts, 64, 2048, self.min_depth, self.max_depth, self.scan_unfolding)
            img = nearest_resize_hw(img, self.shape)
            img = img * img[..., 5:6]  # zero out invalid cells in every channel
            if self._cache is not None:
                self._cache[index] = img
        if self.flip and np.random.rand() > 0.5:
            img = img[:, ::-1]
        chw = np.ascontiguousarray(img.transpose(2, 0, 1))
        return {
            "xyz": chw[:3],
            "reflectance": chw[3:4],
            "depth": chw[4:5],
            "mask": chw[5:6],
        }


class InfiniteSampler:
    """StyleGAN3-style infinite shuffled-window sampler with rank sharding
    (reference gans/utils.py:238-271 semantics).

    Rank `rank` of `num_replicas` takes the positions of the one index stream whose
    block (position // block) is rank modulo num_replicas. block = 1 interleaves the
    ranks, as the reference does; block = the local batch gives rank k the k-th slice of
    each global batch of the one-process stream, so that the ranks' batches concatenated
    are the batch one process would load."""

    def __init__(self, dataset_size, rank=0, num_replicas=1, shuffle=True, seed=0, window_size=0.5, block=1):
        if dataset_size <= 0:
            raise ValueError("the dataset is empty")
        self.size = int(dataset_size)
        self.rank = rank
        self.num_replicas = num_replicas
        self.block = int(block)
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if (idx // self.block) % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


class Prefetcher:
    """Threaded batch loader: dataset[idx] in a worker pool, batches stacked to numpy.

    Equivalent role to torch DataLoader(num_workers=...) feeding the device; loading is
    I/O + numpy bound so threads suffice (no fork overhead). Closing the iterator (or
    dropping it) stops the producer thread: it waits on the full queue with a timeout
    and checks for the stop between tries, and the consumer joins it."""

    def __init__(self, dataset, batch_size, sampler=None, num_workers=4, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __iter__(self):
        idx_iter = iter(self.sampler) if self.sampler is not None else iter(range(len(self.dataset)))
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    while not stop.is_set():
                        idxs = list(itertools.islice(idx_iter, self.batch_size))
                        if not idxs:
                            put(None)
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
                        if not put(batch):
                            return
                        if len(idxs) < self.batch_size:
                            put(None)
                            return
                except Exception as e:  # surface worker errors to the consumer
                    put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`: for a CUDA device through pinned memory with a
    non-blocking copy (enqueued on the current stream), else a CPU tensor."""
    device = torch.device(device)
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class DevicePrefetcher:
    """Keep `depth` batches on their way to `device` ahead of the consumer.

    `put_fn(host_batch)` returns the batch's device tensors (to_device: pinned memory,
    non_blocking copies). On a CUDA device it runs on a side stream, so that the copies
    overlap the running step; `__next__` makes the current stream wait on an event
    recorded after the batch's copies, and marks its tensors as used by the current
    stream, so that the caching allocator keeps their memory until the step is done
    with them. On the CPU `put_fn` runs inline."""

    def __init__(self, host_iter, put_fn: Callable[[Any], Any], device, depth: int = 2):
        self._it = iter(host_iter)
        self._put = put_fn
        self._depth = max(1, int(depth))
        self._buf: collections.deque = collections.deque()
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __iter__(self):
        return self

    def _fill(self):
        while len(self._buf) < self._depth:
            try:
                host = next(self._it)
            except StopIteration:
                return
            if self._stream is None:
                self._buf.append((self._put(host), None))
                continue
            with torch.cuda.stream(self._stream):
                dev = self._put(host)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            self._buf.append((dev, ready))

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        dev, ready = self._buf.popleft()
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in _tensors(dev):
                t.record_stream(current)
        return dev
