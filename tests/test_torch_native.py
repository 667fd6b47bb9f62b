"""The port's C++ loader library (dusty_gan_v2_tpu_torch/datasets/native.py over its copy
of csrc/projection.cpp, built with g++) against the JAX package's native library and the
port's numpy projection.

Bars: against the JAX package's project_points_to_image_native and nearest_resize_native
on the same scans, bit for bit (the same source with the same flags); against the numpy
route, the JAX package's own bar (tests/test_datasets.py::TestNativeLoader,
atol=1e-5): the library's depth sqrt(x*x + y*y + z*z) may contract to FMAs and land up
to two ulps from numpy's norm."""

import numpy as np
import pytest

from dusty_gan_v2_tpu.datasets import native as jnative
from dusty_gan_v2_tpu_torch.datasets import kitti as pkitti
from dusty_gan_v2_tpu_torch.datasets import native as pnative

from test_datasets import synthetic_scan
from test_torch_kitti import fabricated_scan


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    assert jnative.available(), "the JAX package's native library does not load"


@pytest.mark.parametrize("unfold", [True, False], ids=["scan-unfolding", "pitch-bins"])
def test_native_matches_numpy(unfold):
    """The JAX package's own test on the port's library: synthetic_scan at 8 x 64."""
    pts = synthetic_scan(H=8, W=32)
    ref = pkitti.project_points_to_image(pts, H=8, W=64, min_depth=1.45, max_depth=80.0, scan_unfolding=unfold)
    got = pnative.project_points_to_image_native(pts, 8, 64, 1.45, 80.0, unfold)
    assert got.dtype == np.float32 and got.shape == (8, 64, 6)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got[..., 5] > 0).sum() > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("unfold", [True, False], ids=["scan-unfolding", "pitch-bins"])
def test_native_matches_jax_native_bit_for_bit(seed, unfold):
    """Full 64 x 2048 frames with stray points on occupied cells and out-of-range depths;
    and the numpy route on a frame of one point a cell: every winning point equal,
    depths within two ulps."""
    pts = fabricated_scan(np.random.RandomState(seed), H=64, W=2048)
    got = pnative.project_points_to_image_native(pts, 64, 2048, 1.45, 80.0, unfold)
    ref = jnative.project_points_to_image_native(pts, 64, 2048, 1.45, 80.0, unfold)
    assert got.tobytes() == ref.tobytes()
    pts = synthetic_scan(H=64, W=2000)
    got = pnative.project_points_to_image_native(pts, 64, 2048, 0.9, 120.0, unfold)
    ref = jnative.project_points_to_image_native(pts, 64, 2048, 0.9, 120.0, unfold)
    assert got.tobytes() == ref.tobytes()
    plain = pkitti.project_points_to_image(pts, 64, 2048, 0.9, 120.0, scan_unfolding=unfold)
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 5]], plain[..., [0, 1, 2, 3, 5]])
    assert np.all(np.abs(got[..., 4] - plain[..., 4]) <= 2 * np.spacing(plain[..., 4]))


@pytest.mark.parametrize("shape", [(64, 512), (8, 16), (64, 640), (48, 300), (33, 1000), (64, 2048), (128, 4096)])
def test_nearest_resize_matches_numpy_and_jax(shape):
    img = np.random.RandomState(1).randn(64, 2048, 6).astype(np.float32)
    got = pnative.nearest_resize_native(img, shape)
    assert got.tobytes() == pkitti.nearest_resize_hw(img, shape).tobytes()
    assert got.tobytes() == jnative.nearest_resize_native(img, shape).tobytes()


def test_empty_scan_and_bad_points():
    out = pnative.project_points_to_image_native(np.zeros((0, 4), np.float32), 4, 8, 1.0, 2.0)
    assert out.shape == (4, 8, 6) and not out.any()
    with pytest.raises(ValueError, match=r"\(N, 4\)"):
        pnative.project_points_to_image_native(np.zeros((5, 3), np.float32), 4, 8, 1.0, 2.0)


def test_library_is_built_once_under_its_hash():
    """The library's name hashes the source, the compiler and the flags; it is reused."""
    path = pnative.build()
    assert path.exists() and path.parent == pnative.BUILD_DIR and path == pnative.library_path()
    assert path.stat().st_mtime == pnative.build().stat().st_mtime
    assert "-march=native" in pnative.CXX_FLAGS and "-O3" in pnative.CXX_FLAGS


def test_build_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises, naming g++'s complaint."""
    bad = tmp_path / "projection.cpp"
    bad.write_text("int project_points_to_image( {\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exit") as e:
        pnative.build()
    assert "error" in str(e.value)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pnative.build()


def test_loader_takes_the_native_route(monkeypatch, tmp_path):
    """KITTIRaw projects through the library; the numpy projection is not on its path."""
    d = tmp_path / "2011_09_26" / "2011_09_26_drive_0001_sync" / "velodyne_points" / "data"
    d.mkdir(parents=True)
    fabricated_scan(np.random.RandomState(4), H=64, W=2048).tofile(d / f"{0:010d}.bin")
    calls = []
    real = pkitti.project_points_to_image_native
    monkeypatch.setattr(pkitti, "project_points_to_image_native", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(pkitti, "project_points_to_image", lambda *a, **k: pytest.fail("numpy route taken"))
    item = pkitti.KITTIRaw(str(tmp_path), "test", shape=(64, 512), min_depth=1.45, max_depth=80.0)[0]
    assert calls == [1] and item["depth"].shape == (1, 64, 512) and item["mask"].any()
