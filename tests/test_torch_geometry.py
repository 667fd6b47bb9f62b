"""The port's image and geometry helpers against the JAX package on the CPU.

colorize (the port's own turbo table against matplotlib's, bit for bit), the normal
colours, the power spectrum and the masked loss of utils; surface normals, Euler
rotations, the extrinsics, the bilinear rasterizer and the point-cloud render of
geometry; CoordBridge's normal_map routes and bird's-eye view; and the PNG / GIF writers,
read back with PIL. Inputs are numpy arrays from a seed handed to both packages.
Tolerances: 1e-5 absolute where floating-point sums are reordered, exact elsewhere.
"""

from pathlib import Path

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from dusty_gan_v2_tpu import utils as jutils
from dusty_gan_v2_tpu.geometry import CoordBridge as JCoordBridge
from dusty_gan_v2_tpu.geometry import bilinear_rasterizer as j_rasterizer
from dusty_gan_v2_tpu.geometry import estimate_surface_normal as j_normals
from dusty_gan_v2_tpu.geometry import euler_rotation_matrix as j_euler
from dusty_gan_v2_tpu.geometry import make_Rt as j_make_Rt
from dusty_gan_v2_tpu.geometry import render_point_clouds as j_render
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut
from dusty_gan_v2_tpu_torch import utils
from dusty_gan_v2_tpu_torch.geometry import (
    CoordBridge, bilinear_rasterizer, estimate_surface_normal, euler_rotation_matrix, make_Rt, render_point_clouds,
)
from dusty_gan_v2_tpu_torch.utils.colormap import TURBO, TURBO_U8, get_lut
from dusty_gan_v2_tpu_torch.utils.image_io import gif_lzw_literal, save_video, to_uint8, write_png

LUT = Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy"
RES = (16, 64)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=tol)


def _range_image(rng, B=2, drop=0.1):
    """inv_depth_norm values in (0, 1] with dropped (zero) rays."""
    x = rng.uniform(0.02, 1.0, (B, 1, *RES)).astype(np.float32)
    return x * (rng.rand(B, 1, *RES) > drop)


@pytest.fixture(scope="module")
def bridges():
    angle = np.asarray(j_resize_angle_lut(np.load(LUT), RES))
    j = JCoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle)
    t = CoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle, device="cpu")
    return j, t


# ---------------------------------------------------------------------------- colour


def test_turbo_table_is_matplotlibs():
    ref = np.asarray(matplotlib.colormaps["turbo"](np.linspace(0, 1, 256)))[:, :3]
    assert TURBO.dtype == ref.dtype and np.array_equal(TURBO, ref)
    assert np.array_equal(TURBO_U8, (ref.astype(np.float32) * 255).astype(np.uint8))
    assert get_lut("turbo") is TURBO
    with pytest.raises(ValueError):
        get_lut("viridis")


@pytest.mark.parametrize("shape", [(2, 1, *RES), (3, *RES)])
def test_colorize_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    x.reshape(-1)[:6] = [0.0, 1.0, 1.0 / 256, 255.0 / 256, np.nan, np.inf]  # the table's edges; NaN and inf
    got, ref = utils.colorize(_t(x)), jutils.colorize(jnp.asarray(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    idx = utils.colorize_indices(_t(x))
    np.testing.assert_array_equal(TURBO.astype(np.float32)[idx.numpy()].transpose(0, 3, 1, 2), np.asarray(ref))


def test_colorize_takes_a_table():
    rng = np.random.RandomState(1)
    lut = rng.rand(7, 3)
    x = rng.rand(2, 1, *RES).astype(np.float32)
    np.testing.assert_array_equal(utils.colorize(_t(x), lut).numpy(), np.asarray(jutils.colorize(jnp.asarray(x), lut)))
    with pytest.raises(ValueError):
        utils.colorize(torch.zeros(2, 2, *RES))


@pytest.mark.parametrize("mode", ["closest", "mean"])
def test_points_to_normal_2d_matches_jax(mode):
    pm = np.random.RandomState(2).randn(2, 3, *RES).astype(np.float32)
    _close(utils.points_to_normal_2d(_t(pm), mode=mode), jutils.points_to_normal_2d(jnp.asarray(pm), mode=mode))


def test_power_spectrum_matches_jax():
    x = np.random.RandomState(3).rand(2, 1, *RES).astype(np.float32)
    got = utils.power_spectrum_2d(_t(x))
    ref = jutils.power_spectrum_2d(jnp.asarray(x))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("distance", ["l1", "l2"])
def test_utils_masked_loss_matches_jax(distance):
    rng = np.random.RandomState(4)
    a, b = rng.rand(2, 2, 1, *RES).astype(np.float32)
    m = (rng.rand(2, 1, *RES) > 0.3).astype(np.float32)
    _close(utils.masked_loss(_t(a), _t(b), _t(m), distance), jutils.masked_loss(a, b, m, distance), 1e-6)


# ---------------------------------------------------------------------------- normals


def _structured_points(rng, H=RES[0], W=RES[1]):
    """A range image's point map: rings and azimuths with ranges, a dropped block (points
    on the origin), a constant row and a ring seam."""
    elev = np.deg2rad(np.linspace(3, -25, H))[:, None]
    azim = np.linspace(np.pi, -np.pi, W, endpoint=False)[None]
    r = rng.uniform(2, 60, (H, W))
    r[3:6, 10:20] = 0.0  # dropped rays
    r[-1] = 7.0  # one ring at a constant range
    pm = np.stack([r * np.cos(elev) * np.cos(azim), r * np.cos(elev) * np.sin(azim), r * np.sin(elev) * np.ones_like(azim)])
    return pm[None].astype(np.float32)


@pytest.mark.parametrize("mode", ["closest", "mean"])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("kind", ["random", "structured"])
def test_surface_normals_match_jax(mode, d, kind):
    rng = np.random.RandomState(5)
    pm = rng.randn(2, 3, *RES).astype(np.float32) if kind == "random" else _structured_points(rng)
    got = estimate_surface_normal(_t(pm), d=d, mode=mode)
    ref = np.asarray(j_normals(jnp.asarray(pm), d=d, mode=mode))
    assert tuple(got.shape) == ref.shape
    _close(got, ref)
    # the edge rows (replicated) and the ring seam (circular) are covered by the shape
    _close(got[..., :d, :], ref[..., :d, :])
    _close(got[..., :, -d:], ref[..., :, -d:])


def test_surface_normals_small_and_bad_input():
    pm = np.random.RandomState(6).randn(1, 3, 3, 4).astype(np.float32)  # H smaller than the pad
    _close(estimate_surface_normal(_t(pm), d=2), j_normals(jnp.asarray(pm), d=2))
    with pytest.raises(ValueError):
        estimate_surface_normal(torch.zeros(1, 2, 4, 4))
    with pytest.raises(NotImplementedError):
        estimate_surface_normal(torch.zeros(1, 3, 4, 4), mode="median")


def test_surface_normals_argmin_takes_the_first_tie():
    """Equal sums (a flat, evenly spaced grid) pick the first pair, as jnp.argmin does."""
    h, w = np.meshgrid(np.arange(6.0), np.arange(8.0), indexing="ij")
    pm = np.stack([w, h, np.zeros_like(h)])[None].astype(np.float32)
    _close(estimate_surface_normal(_t(pm), d=1), j_normals(jnp.asarray(pm), d=1), 0.0)


@pytest.mark.parametrize("theta", [(0.0, 0.0, 0.0), (0.3, -1.2, 2.5), (np.pi, 0.5, -0.25)])
def test_euler_rotation_matrix_matches_jax(theta):
    th = np.asarray(theta, np.float32)
    R = euler_rotation_matrix(_t(th))
    _close(R, j_euler(jnp.asarray(th)), 1e-6)
    _close(R @ R.T, np.eye(3), 1e-6)


# ---------------------------------------------------------------------------- render


@pytest.mark.parametrize("args", [{}, {"roll": 0.2, "pitch": -0.4, "yaw": 1.3, "x": 0.1, "y": -0.2, "z": 0.7}])
def test_make_Rt_matches_jax(args):
    R, t = make_Rt(**args)
    jR, jt = j_make_Rt(**args)
    np.testing.assert_array_equal(R.numpy(), np.asarray(jR))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_bilinear_rasterizer_matches_jax():
    rng = np.random.RandomState(7)
    coords = rng.uniform(-2, 20, (2, 300, 2)).astype(np.float32)  # some corners outside
    coords[0, :5] = [[0.0, 0.0], [15.0, 15.0], [3.0005, 4.0], [7.5, 7.9995], [-0.5, 3.0]]  # edges, tiny weights
    values = rng.rand(2, 300, 3).astype(np.float32)
    got = bilinear_rasterizer(_t(coords), _t(values), (16, 16))
    ref = j_rasterizer(jnp.asarray(coords), jnp.asarray(values), (16, 16))
    assert tuple(got.shape) == ref.shape == (2, 3, 16, 16)
    _close(got, ref)


@pytest.mark.parametrize("extrinsics", ["none", "t", "Rt"])
def test_render_point_clouds_matches_jax(extrinsics):
    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    pts[:, :10] = 0.0  # dropped rays on the origin
    cols = rng.rand(2, 500, 3).astype(np.float32)
    R, t = make_Rt(pitch=0.3, yaw=0.5, z=0.2)
    kw = {"none": {}, "t": {"t": torch.tensor([[0.0, 0.0, 0.7]])}, "Rt": {"R": R, "t": t}}[extrinsics]
    got = render_point_clouds(_t(pts), _t(cols), size=32, **kw)
    ref = j_render(jnp.asarray(pts), jnp.asarray(cols), size=32, **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    assert tuple(got.shape) == ref.shape == (2, 3, 32, 32)
    _close(got, ref)


# ---------------------------------------------------------------------------- CoordBridge


@pytest.mark.parametrize("src", ["depth", "inv_depth_norm", "point_map"])
def test_normal_map_routes_match_jax(bridges, src):
    jb, tb = bridges
    inv = _range_image(np.random.RandomState(9))
    x = jb.convert(jnp.asarray(inv), "inv_depth_norm", src)
    x = np.asarray(x)
    got = tb.convert(_t(x), src, "normal_map")
    ref = jb.convert(jnp.asarray(x), src, "normal_map")
    assert tuple(got.shape) == (2, 3, *RES)
    _close(got, ref)
    assert torch.isfinite(got).all()


def test_normal_map_from_depth_norm_raises_as_in_jax(bridges):
    jb, tb = bridges
    with pytest.raises(NotImplementedError):
        jb.convert(jnp.zeros((1, 1, *RES)), "depth_norm", "normal_map")
    with pytest.raises(NotImplementedError):
        tb.convert(torch.zeros(1, 1, *RES), "depth_norm", "normal_map")


@pytest.mark.parametrize("Rt", [{"z": 0.7}, {"pitch": 0.6, "z": 0.4}])
def test_birds_eye_view_matches_jax(bridges, Rt):
    """The port's bird's-eye view against JAX's normals and render of the port's own point
    map, within 1e-5; the point maps themselves within 1e-5.

    Against JAX's make_birds_eye_view end to end a handful of pixels differ by ~2e-5:
    XLA's sin / cos / division round a few percent of the points one ulp away from
    torch's, and a bilinear corner weight near the 1e-3 drop line moves by ~1e-2 of
    itself for one ulp in its coordinate (the weights are differences of nearby
    coordinates), so that pixel's normalized colour moves. On the same point map the
    render agrees to ~1e-7 (test_render_point_clouds_matches_jax)."""
    jb, tb = bridges
    inv = _range_image(np.random.RandomState(10))
    got = tb.make_birds_eye_view(_t(inv), make_Rt(**Rt))
    pts = tb.convert(_t(inv), "inv_depth_norm", "point_map") / tb.max_depth
    _close(pts, np.asarray(jb.convert(jnp.asarray(inv), "inv_depth_norm", "point_map")) / jb.max_depth)
    jp = jnp.asarray(pts.numpy())
    cols = jutils.points_to_normal_2d(jp, mode="closest")
    flat = lambda a: a.reshape(2, 3, -1).transpose(0, 2, 1)  # noqa: E731
    jR, jt = j_make_Rt(**Rt)
    ref = j_render(flat(jp), flat(cols), size=RES[1], R=jR, t=jt)
    assert tuple(got.shape) == ref.shape == (2, 3, RES[1], RES[1])
    _close(got, ref)
    assert float(got.abs().max()) > 0


# ---------------------------------------------------------------------------- writers


@pytest.mark.parametrize("shape", [(13, 21, 3), (1, 1, 3)])
def test_write_png_reads_back(tmp_path, shape):
    img = np.random.RandomState(11).randint(0, 256, shape).astype(np.uint8)
    path = write_png(str(tmp_path / "sub" / "a.png"), img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    with pytest.raises(TypeError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "c.png"), img[..., 0])


def test_to_uint8_is_matplotlibs_conversion():
    x = np.random.RandomState(12).rand(5, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), (x * 255).astype(np.uint8))
    with pytest.raises(ValueError):
        to_uint8(x + 1)


@pytest.mark.parametrize("n_pixels", [1, 253, 254, 255, 508, 5000])
def test_gif_lzw_literal_lengths(n_pixels):
    """A clear code before every 254 literals, all codes 9 bits: the stream's length
    follows, and PIL decodes it (below)."""
    data = gif_lzw_literal(np.zeros(n_pixels, np.uint8))
    n_codes = n_pixels + -(-n_pixels // 254) + 1
    payload = -(-9 * n_codes // 8)
    assert data[0] == 8 and data[-1] == 0
    assert len(data) == 1 + payload + -(-payload // 255) + 1


def test_save_video_reads_back(tmp_path):
    rng = np.random.RandomState(13)
    x = rng.rand(4, 1, 3 * RES[0], RES[1]).astype(np.float32)
    frames = [f for f in utils.colorize_indices(_t(x)).to(torch.uint8).numpy()]
    path = save_video(frames, str(tmp_path / "clip"), fps=30)
    assert path.endswith("clip.gif")
    with Image.open(path) as im:
        assert im.n_frames == 4 and im.info.get("loop") == 0 and im.info.get("duration") == 30
        for i, f in enumerate(frames):
            im.seek(i)
            got = np.asarray(im.convert("RGB"))
            # exactly the colours colorize gives, as the JAX demo writes them ((rgb * 255) truncated)
            want = (np.asarray(jutils.colorize(jnp.asarray(x[i : i + 1])))[0].transpose(1, 2, 0) * 255).astype(np.uint8)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, TURBO_U8[f])
    with pytest.raises(ValueError):
        save_video([frames[0], frames[0][:-1]], str(tmp_path / "bad"))
