"""The port's KITTI Raw loader (dusty_gan_v2_tpu_torch/datasets/kitti.py) against the JAX
package's (dusty_gan_v2_tpu/datasets/kitti.py) on a fabricated KITTI Raw tree.

Both loaders project through the C++ library of their own copy of csrc/projection.cpp
(the JAX package's committed build, the port's g++ build): the same source with the same
flags. Items are compared byte for byte (dtype, shape and every bit); the split lists,
the InfiniteSampler index streams and the Prefetcher batches must be equal."""

import itertools

import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.datasets import kitti as jkitti
from dusty_gan_v2_tpu_torch.datasets import kitti as pkitti

TRAIN, TEST, VAL = "2011_10_03_drive_0027_sync", "2011_09_26_drive_0001_sync", "2011_09_30_drive_0028_sync"


def fabricated_scan(rng, H=64, W=512, n_extra=300):
    """Ring-ordered points (x, y, z, intensity), each ring starting inside the first
    quadrant and wrapping once, plus stray points that land on occupied cells (the
    z-buffer's nearest point must win) and points out of the depth range."""
    elev = np.deg2rad(3 - 28 * np.arange(H) / (H - 1))[:, None]
    phis = np.sort(rng.uniform(0.005, 2 * np.pi - 0.005, (H, W)), axis=1)
    r = rng.uniform(0.5, 130, (H, W))
    pts = np.stack([r * np.cos(elev) * np.cos(phis), r * np.cos(elev) * np.sin(phis),
                    r * np.sin(elev) * np.ones_like(phis), rng.rand(H, W)], axis=-1).reshape(-1, 4)
    extra = pts[rng.randint(0, len(pts), n_extra)] * np.array([0.9, 0.9, 0.9, 1.0])
    return np.concatenate([pts, extra]).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.RandomState(0)
    for seq, frames in ((TRAIN, range(6)), (TEST, range(4)), (VAL, (1100, 1101))):
        d = root / seq[:10] / seq / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in frames:
            fabricated_scan(rng).tofile(d / f"{i:010d}.bin")
    return root


@pytest.fixture(autouse=True)
def native_route():
    from dusty_gan_v2_tpu.datasets import native

    assert native.available(), "the JAX package's native library does not load"


def assert_bytes_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("prune", [False, True])
def test_split_lists_equal(root, split, prune):
    got = pkitti.KITTIRaw(str(root), split, prune_missing=prune).datalist
    ref = jkitti.KITTIRaw(str(root), split, prune_missing=prune).datalist
    assert got == ref
    if prune:
        assert len(got) == {"train": 6, "val": 2, "test": 4}[split]


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("shape", [(64, 2048), (64, 512), (8, 64)])
@pytest.mark.parametrize("cache", [None, "ram"])
def test_items_byte_equal(root, split, shape, cache):
    kw = dict(shape=shape, min_depth=1.45, max_depth=80.0, prune_missing=True, cache=cache)
    got_ds, ref_ds = pkitti.KITTIRaw(str(root), split, **kw), jkitti.KITTIRaw(str(root), split, **kw)
    assert len(got_ds) == len(ref_ds) > 0
    for _ in range(2 if cache else 1):  # the second pass reads the cache
        for i in range(len(ref_ds)):
            assert_bytes_equal(got_ds[i], ref_ds[i])
    item = got_ds[0]
    assert item["depth"].shape == (1, *shape) and set(np.unique(item["mask"])) <= {0.0, 1.0}
    assert 0.05 < item["mask"].mean() < 1.0  # dropped rays and out-of-range points exist


def test_flip_draws_equal(root):
    kw = dict(shape=(64, 512), min_depth=1.45, max_depth=80.0, prune_missing=True, flip=True)
    got_ds, ref_ds = pkitti.KITTIRaw(str(root), "train", **kw), jkitti.KITTIRaw(str(root), "train", **kw)
    np.random.seed(3)
    got = [got_ds[0] for _ in range(12)]
    np.random.seed(3)
    ref = [ref_ds[0] for _ in range(12)]
    plain = pkitti.KITTIRaw(str(root), "train", **{**kw, "flip": False})[0]["depth"]
    for g, r in zip(got, ref):
        assert_bytes_equal(g, r)
    flipped = sum(not np.array_equal(g["depth"], plain) for g in got)
    assert 0 < flipped < 12


@pytest.mark.parametrize("unfold", [True, False])
def test_projection_equal(unfold):
    pts = fabricated_scan(np.random.RandomState(7), H=64, W=2048)
    got = pkitti.project_points_to_image(pts, 64, 2048, 0.9, 120.0, scan_unfolding=unfold)
    ref = jkitti.project_points_to_image(pts, 64, 2048, 0.9, 120.0, scan_unfolding=unfold)
    assert got.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(pkitti.scan_unfold_rings(pts[:, 0], pts[:, 1], 64),
                                  jkitti.scan_unfold_rings(pts[:, 0], pts[:, 1], 64))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("shuffle", [True, False])
def test_infinite_sampler_streams_equal(rank, shuffle):
    kw = dict(rank=rank, num_replicas=2, shuffle=shuffle, seed=5)
    got = list(itertools.islice(iter(pkitti.InfiniteSampler(37, **kw)), 300))
    ref = list(itertools.islice(iter(jkitti.InfiniteSampler(37, **kw)), 300))
    assert got == ref and len(set(got)) > 10


def test_prefetcher_batches_equal(root):
    kw = dict(shape=(64, 512), min_depth=1.45, max_depth=80.0, prune_missing=True, cache="ram")
    got_ds, ref_ds = pkitti.KITTIRaw(str(root), "train", **kw), jkitti.KITTIRaw(str(root), "train", **kw)
    got_it = iter(pkitti.Prefetcher(got_ds, 4, pkitti.InfiniteSampler(6, seed=1), num_workers=2))
    ref_it = iter(jkitti.Prefetcher(ref_ds, 4, jkitti.InfiniteSampler(6, seed=1), num_workers=2))
    for _ in range(5):
        assert_bytes_equal(next(got_it), next(ref_it))
    got_it.close()
    # without a sampler: one pass, the last batch short
    got = list(pkitti.Prefetcher(got_ds, 4, num_workers=2))
    ref = list(jkitti.Prefetcher(ref_ds, 4, num_workers=2))
    assert [b["depth"].shape[0] for b in got] == [4, 2]
    for g, r in zip(got, ref):
        assert_bytes_equal(g, r)


def test_prefetcher_close_stops_its_thread(root):
    ds = pkitti.KITTIRaw(str(root), "train", shape=(8, 64), min_depth=1.45, max_depth=80.0, prune_missing=True)
    import threading

    before = threading.active_count()
    it = iter(pkitti.Prefetcher(ds, 2, pkitti.InfiniteSampler(6), num_workers=2, prefetch=1))
    next(it)
    it.close()  # the producer waits on a full queue: close must still stop it
    assert threading.active_count() == before


def test_device_prefetcher_on_the_cpu():
    seen = []

    def put(x):
        seen.append(x)
        return {"v": pkitti.to_device(np.full((2,), x, np.float32), "cpu")}

    it = pkitti.DevicePrefetcher(iter(range(5)), put, "cpu", depth=2)
    first = next(it)
    assert seen == [0, 1] and torch.equal(first["v"], torch.zeros(2))  # two batches staged ahead
    assert [int(b["v"][0]) for b in it] == [1, 2, 3, 4]
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(ValueError):
        pkitti.KITTIRaw("x", "trainval")
