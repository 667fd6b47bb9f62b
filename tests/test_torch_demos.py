"""The port's demo command lines and the training CLI's image panels end to end on the CPU,
against the JAX scripts.

A tiny DUSty v2 generator (z 16, ch_base 4, ch_max 16, 8 x 64, layers (2, 2)) gets its
weights from a numpy seed in JAX; the port's checkpoint carries them (load_jax_variables
into a TrainState, training/checkpoint.py), and the JAX scripts read the same variables
through their autoload_ckpt, replaced here by one that returns them. Both read the same
fabricated KITTI Raw test frames (tests/test_torch_gan_e2e.py's tree; the JAX loader on
its numpy route). The JAX scripts' jax.random.normal draws are replaced by the draws the
port is given through main(..., normal=...); numpy's global generator draws the rest
in both, in the same order.

Bars: drop maps 1e-4, printed losses to their printed digits, points 1e-5 of their range,
normals 1e-4 off the pixels whose closest-pair choice follows an ulp of the points,
colour indices equal off the pixels whose value sits within 1e-5 of a table edge or whose
drop decision sits on its threshold.
"""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_gan_e2e import RES, fabricated_scan, tiny_cfg  # noqa: E402
from test_torch_generator import _seeded_variables  # noqa: E402

from dusty_gan_v2_tpu import utils as jutils  # noqa: E402
from dusty_gan_v2_tpu.geometry import CoordBridge as JCoordBridge  # noqa: E402
from dusty_gan_v2_tpu.geometry import estimate_surface_normal as j_normals  # noqa: E402
from dusty_gan_v2_tpu.geometry import resize_angle_lut as j_resize_angle_lut  # noqa: E402
from dusty_gan_v2_tpu.models import build_generator as j_build_generator  # noqa: E402
from dusty_gan_v2_tpu.utils.config import Config as JConfig  # noqa: E402
from dusty_gan_v2_tpu_torch.cli import demo_interpolation, demo_inversion, quick_demo  # noqa: E402
from dusty_gan_v2_tpu_torch.cli import train_gan as port_train_gan  # noqa: E402
from dusty_gan_v2_tpu_torch.convert import load_jax_variables  # noqa: E402
from dusty_gan_v2_tpu_torch.geometry import CoordBridge, estimate_surface_normal  # noqa: E402
from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt  # noqa: E402
from dusty_gan_v2_tpu_torch.training import Trainer  # noqa: E402
from dusty_gan_v2_tpu_torch.training.checkpoint import save_checkpoint  # noqa: E402
from dusty_gan_v2_tpu_torch.utils import colorize  # noqa: E402
from dusty_gan_v2_tpu_torch.utils.colormap import TURBO_U8  # noqa: E402
from dusty_gan_v2_tpu_torch.utils.image_io import to_uint8  # noqa: E402

_REPO = Path(__file__).resolve().parent.parent
LUT = _REPO / "data" / "coords" / "kitti_raw.npy"
Z = 16


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """KITTI Raw scans at the sensor's 64 x 2048 (tests/test_torch_gan_e2e.py's fabricator),
    so that the 8 x 64 frames are dense: 8 train frames (odometry 00's drive), 4 test
    frames (a city drive)."""
    root = tmp_path_factory.mktemp("kitti_dense")
    rng = np.random.RandomState(1)
    for seq, n in (("2011_10_03_drive_0027_sync", 8), ("2011_09_26_drive_0001_sync", 4)):
        d = root / seq[:10] / seq / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(n):
            fabricated_scan(rng, H=64, W=2048).tofile(d / f"{i:010d}.bin")
    return root


@pytest.fixture(scope="module")
def ckpts(kitti_root, tmp_path_factory):
    """(the port's checkpoint path, the JAX scripts' checkpoint dict, the config)."""
    tmp = tmp_path_factory.mktemp("demo_ckpt")
    cfg = tiny_cfg(kitti_root)
    jcfg = JConfig(cfg)
    angle = np.array(j_resize_angle_lut(np.load(LUT), RES))
    v = _seeded_variables(j_build_generator(jcfg.model.generator), jnp.asarray(angle), seed=11)
    tr = Trainer(cfg, device="cpu", angle=torch.from_numpy(angle), seed=0)
    st = tr.init_state(seed=0)
    load_jax_variables(st.G, v)
    load_jax_variables(st.G_ema, v)
    path = tmp / "port.ckpt"
    save_checkpoint(str(path), cfg, st, tr.angle, 128)
    return str(path), {"cfg": jcfg, "angle": angle, "G_ema": v, "G": v}, cfg


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}_demos", _REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(seed, shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _inject(monkeypatch, draws):
    """jax.random.normal returns `draws` in order (their shapes checked) when called on
    a concrete key; returns the port's `normal` over the same arrays."""
    queue, orig = list(draws), jax.random.normal

    def fake_normal(key, shape=(), dtype=jnp.float32):
        if isinstance(key, jax.core.Tracer):  # flax's abstract shape check of an existing param
            return orig(key, shape, dtype)
        d = queue.pop(0)
        assert d.shape == tuple(shape), (d.shape, shape)
        return jnp.asarray(d, dtype)

    monkeypatch.setattr(jax.random, "normal", fake_normal)
    port_queue = list(draws)
    return lambda shape: torch.from_numpy(port_queue.pop(0)).reshape(shape)


def _run_jax(monkeypatch, name, jckpt, argv):
    mod = _load_jax_script(name)
    monkeypatch.setattr(mod, "autoload_ckpt", lambda path: jckpt)
    monkeypatch.setitem(sys.modules, "dusty_gan_v2_tpu.datasets.native", None)  # the JAX loader's numpy route
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    mod.main()


def _printed_losses(text):
    return [(int(s), int(i), float(v)) for s, i, v in re.findall(r"\[(\d)\] step\s+(\d+) loss (\S+)", text)]


# ---------------------------------------------------------------------------- inversion


@pytest.mark.parametrize("extra", [[], ["--latent_type", "w+", "--optimize_phase", "--hypersphere_z"],
                                   ["--latent_type", "z"]])
def test_demo_inversion_matches_jax(ckpts, tmp_path, monkeypatch, capsys, extra):
    """3 + 3 steps: the sample id (numpy's, before the noise), the printed losses and the
    saved drop map against the JAX script's; the summary PNG holds the four panels."""
    path, jckpt, cfg = ckpts
    root = cfg["dataset"]["root"]
    argv = ["--ckpt_path", path, "--num_steps_1st", "3", "--num_steps_2nd", "3", "--dataset_root", root] + extra
    draws = _draws(5, [(demo_inversion.W_AVG_SAMPLES, Z)] + ([(1, Z)] if "z" in extra else []))
    normal = _inject(monkeypatch, draws)
    _run_jax(monkeypatch, "demo_inversion", jckpt, argv + ["--out_dir", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    res = demo_inversion.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"], normal=normal)
    port_out = capsys.readouterr().out
    sid = res["sample_id"]
    assert 0 <= sid < 4 and len(res["losses_1st"]) == len(res["losses_2nd"]) == 3
    assert min(res["losses_1st"]) > 0.01
    name = f"raydrop_prob_{sid:010d}.npy"
    ref = np.load(tmp_path / "jax" / name)
    got = np.load(tmp_path / "port" / name)
    assert got.dtype == np.float32 and got.shape == ref.shape == RES
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got, res["raydrop_prob"])
    jl, pl = _printed_losses(jax_out), _printed_losses(port_out)
    assert [x[:2] for x in jl] == [x[:2] for x in pl] == [(1, 0), (2, 0)]
    for (_, _, a), (_, _, b) in zip(jl, pl):
        assert abs(a - b) <= 1.5e-5, (jl, pl)  # printed with 5 decimals
    assert abs(res["losses_1st"][0] - jl[0][2]) <= 1e-5 and abs(res["losses_2nd"][0] - jl[1][2]) <= 1e-5
    with Image.open(tmp_path / "port" / f"summary_{sid:010d}.png") as im:
        png = np.asarray(im)
    with Image.open(tmp_path / "jax" / f"summary_{sid:010d}.png") as im:
        jpng = np.asarray(im.convert("RGB"))
    assert png.shape == jpng.shape == (4 * RES[0], RES[1], 3)
    # colours of the turbo table; the target panel (no model output in it) equal to JAX's
    assert set(map(tuple, png.reshape(-1, 3))) <= set(map(tuple, TURBO_U8))
    np.testing.assert_array_equal(png[: RES[0]], jpng[: RES[0]])


def test_inversion_outputs_are_the_tuned_generators(ckpts, tmp_path, capsys):
    """The drop map is sigmoid of the tuned G's raydrop logit, in [0, 1]; the loss falls
    over the 4 + 4 steps; the summary's panels are colorize of the outputs."""
    path, _, cfg = ckpts
    res = demo_inversion.main(["--ckpt_path", path, "--num_steps_1st", "4", "--num_steps_2nd", "4", "--dataset_root",
                               cfg["dataset"]["root"], "--sample_id", "2", "--out_dir", str(tmp_path), "--device", "cpu"])
    capsys.readouterr()
    prob = np.load(tmp_path / f"raydrop_prob_{2:010d}.npy")
    assert res["sample_id"] == 2 and prob.shape == RES and 0 <= prob.min() and prob.max() <= 1
    assert np.isfinite(res["losses_1st"] + res["losses_2nd"]).all() and res["losses_2nd"][-1] < res["losses_1st"][0]
    with Image.open(tmp_path / f"summary_{2:010d}.png") as im:
        png = np.asarray(im)
    want = to_uint8(colorize(torch.from_numpy(prob)[None, None])[0].permute(1, 2, 0).numpy())
    np.testing.assert_array_equal(png[2 * RES[0] : 3 * RES[0]], want)


# ---------------------------------------------------------------------------- interpolation


def _edge_or_flip(values, tol=1e-5):
    """Pixels whose value in [0, 1] sits within tol of a 256-entry table edge."""
    x = np.clip(values, 0, 1) * 256
    return np.abs(x - np.round(x)) < tol * 256


def test_demo_interpolation_2d_matches_jax(ckpts, tmp_path, monkeypatch, capsys):
    """2 anchors x 4 frames: each frame's colour indices against the JAX script's frames
    (caught at PIL.Image.fromarray), and the GIF read back equal to the table's colours."""
    path, jckpt, _ = ckpts
    normal = _inject(monkeypatch, _draws(6, [(2, Z)]))
    argv = ["--num_anchors", "2", "--frames_per_anchor", "4", "--mode", "2d"]
    caught = []
    orig = Image.fromarray
    monkeypatch.setattr(Image, "fromarray", lambda a, *k, **kw: caught.append(np.array(a)) or orig(a, *k, **kw))
    _run_jax(monkeypatch, "demo_interpolation", jckpt, ["--ckpt_path", path, "--out", str(tmp_path / "jax.gif")] + argv)
    monkeypatch.setattr(Image, "fromarray", orig)
    res = demo_interpolation.main(["--ckpt_path", path, "--out", str(tmp_path / "port.gif"), "--device", "cpu"] + argv,
                                  normal=normal)
    capsys.readouterr()
    assert len(caught) == len(res["frames"]) == 8 and res["path"].endswith("port.gif")
    mismatched = 0
    for f, ref in zip(res["frames"], caught):
        assert f.shape == (3 * RES[0], RES[1]) and ref.shape == (3 * RES[0], RES[1], 3)
        mismatched += int((TURBO_U8[f] != ref).any(axis=-1).sum())
    # a colour index may differ where the value sits on a table edge or a drop decision
    # on its threshold (an ulp of the generator's output apart); none did on this seed
    assert mismatched <= 2, mismatched
    with Image.open(res["path"]) as im:
        assert im.n_frames == 8
        for i, f in enumerate(res["frames"]):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), TURBO_U8[f])


def test_demo_interpolation_3d_matches_jax(ckpts, tmp_path, monkeypatch, capsys):
    """2 anchors x 4 frames: points within 1e-5 of the depth range, normals within 1e-4
    where the closest-pair choice does not follow an ulp of the points (checked: on the
    JAX points the port's normals equal JAX's there too)."""
    path, jckpt, cfg = ckpts
    normal = _inject(monkeypatch, _draws(7, [(2, Z)]))
    argv = ["--num_anchors", "2", "--frames_per_anchor", "4", "--mode", "3d"]
    _run_jax(monkeypatch, "demo_interpolation", jckpt, ["--ckpt_path", path, "--out", str(tmp_path / "jax.npz")] + argv)
    res = demo_interpolation.main(["--ckpt_path", path, "--out", str(tmp_path / "port"), "--device", "cpu"] + argv,
                                  normal=normal)
    capsys.readouterr()
    ref = np.load(tmp_path / "jax.npz")
    got = np.load(tmp_path / "port.npz")
    n = RES[0] * RES[1]
    assert got["points"].shape == ref["points"].shape == (8, n, 3) == got["normals"].shape
    np.testing.assert_allclose(got["points"], ref["points"], rtol=0, atol=1e-5 * cfg["dataset"]["max_depth"])
    np.testing.assert_array_equal(got["points"], res["points"])
    off = np.abs(got["normals"] - ref["normals"]).max(axis=-1) > 1e-4
    assert off.sum() <= 0.01 * off.size, off.sum()
    # on the JAX points, the port's normals equal JAX's everywhere (1e-5)
    pm = ref["points"].transpose(0, 2, 1).reshape(8, 3, *RES) / cfg["dataset"]["max_depth"]
    mine = -estimate_surface_normal(torch.from_numpy(np.ascontiguousarray(pm)))
    theirs = -np.asarray(j_normals(jnp.asarray(pm)))
    np.testing.assert_allclose(np.nan_to_num(mine.numpy()), np.nan_to_num(theirs), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------- quick_demo


def test_quick_demo_writes_colorize_of_its_sample(ckpts, tmp_path, capsys):
    path, _, _ = ckpts
    out = quick_demo.main(["--ckpt_path", path, "--out", str(tmp_path / "q.png"), "--batch_size", "6", "--device", "cpu"])
    assert "saved:" in capsys.readouterr().out
    colored = colorize(torch.clamp((out["image"] + 1) / 2, 0, 1)).numpy()
    rows = [np.concatenate(list(colored[i : i + 2].transpose(0, 2, 3, 1)), axis=1) for i in range(0, 6, 2)]
    with Image.open(tmp_path / "q.png") as im:
        png = np.asarray(im)
    assert png.shape == (3 * RES[0], 2 * RES[1], 3)
    np.testing.assert_array_equal(png, to_uint8(np.concatenate(rows, axis=0)))
    again = quick_demo.main(["--ckpt_path", path, "--out", str(tmp_path / "r.png"), "--batch_size", "6", "--device", "cpu"])
    assert torch.equal(again["image"], out["image"])  # seeded: the same sample
    with pytest.raises(ValueError, match="release"):
        quick_demo.main(["--arch", "dusty_v2", "--device", "cpu"])


# ---------------------------------------------------------------------------- image panels


class _StubWriter:
    def __init__(self):
        self.images = {}

    def add_images(self, tag, array, step):
        self.images[tag] = np.asarray(array)


def _panel_inputs(seed, B=4):
    rng = np.random.RandomState(seed)
    image_orig = np.tanh(rng.randn(B, 1, *RES)).astype(np.float32)
    logit = rng.randn(B, 1, *RES).astype(np.float32)
    mask = (rng.rand(B, 1, *RES) > 0.3).astype(np.float32)
    return {"image": (image_orig * mask - (1 - mask)).astype(np.float32), "image_orig": image_orig,
            "raydrop_logit": logit, "raydrop_mask": mask, "image_aug": np.tanh(rng.randn(B, 1, *RES)).astype(np.float32)}


def test_image_panels_match_jax_log_images(ckpts):
    """Every panel of the JAX CLI's log_images, caught by a stub writer, against the
    port's image_panels on the same inputs: colour panels equal off table edges, the
    normals 1e-4 off closest-pair near-ties, the bird's-eye render 1e-5 off the few
    pixels a bilinear weight at its 1e-3 drop line moves (one ulp in a point moves such a
    weight by ~1e-2 of itself; geometry tests hold the render on equal points)."""
    _, jckpt, cfg = ckpts
    jax_cli = _load_jax_script("train_gan")
    angle = jckpt["angle"]
    jcoord = JCoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle)
    tcoord = CoordBridge(RES[0], RES[1], 1.45, 80.0, angle=angle, device="cpu")
    x = _panel_inputs(12)
    writer = _StubWriter()
    jax_cli.log_images(writer, "fake", 1, coord=jcoord, **{k: jnp.asarray(v) for k, v in x.items()})
    got = port_train_gan.image_panels("fake", tcoord, **{k: torch.from_numpy(v) for k, v in x.items()})
    assert set(got) == set(writer.images) == {f"fake/{k}" for k in (
        "image/orig", "image/aug", "raydrop_prob", "raydrop_mask", "image", "image/spectrum", "normal", "pointcloud")}
    for k, ref in writer.images.items():
        assert got[k].shape == ref.shape and got[k].dtype == np.float32, k
    inv = np.clip((x["image"] + 1) / 2, 0, 1)
    for k, src in (("image/orig", np.clip((x["image_orig"] + 1) / 2, 0, 1)), ("image/aug", np.clip((x["image_aug"] + 1) / 2, 0, 1)),
                   ("raydrop_prob", 1 / (1 + np.exp(-x["raydrop_logit"]))), ("image", inv)):
        same = ~_edge_or_flip(src)[:, 0]
        np.testing.assert_array_equal(got[f"fake/{k}"].transpose(0, 2, 3, 1)[same],
                                      writer.images[f"fake/{k}"].transpose(0, 2, 3, 1)[same], err_msg=k)
    np.testing.assert_array_equal(got["fake/raydrop_mask"], writer.images["fake/raydrop_mask"])
    spec_diff = (got["fake/image/spectrum"] != writer.images["fake/image/spectrum"]).any(axis=1)
    assert spec_diff.mean() <= 1e-3, spec_diff.sum()
    off = np.abs(got["fake/normal"] - writer.images["fake/normal"]).max(axis=1) > 1e-4
    assert off.mean() <= 0.01, off.sum()
    bev_off = np.abs(got["fake/pointcloud"] - writer.images["fake/pointcloud"]).max(axis=1) > 1e-5
    assert bev_off.mean() <= 1e-3, bev_off.sum()
    assert got["fake/pointcloud"].max() > 0


def test_train_gan_writes_the_panels(kitti_root, tmp_path):
    """The CLI's image tick holds the panels beside the raw arrays, under the JAX tags;
    the real frames' panels are written once at the start."""
    cfg = tiny_cfg(kitti_root)
    cfg["training"]["total_kimg"] = 2 * 8 / 1e3
    cfg["training"]["checkpoint"].update(save_image=2, save_model=100, save_stats=2)
    import yaml

    (tmp_path / "gan.yaml").write_text(yaml.safe_dump(cfg))
    port_train_gan.main(["--config", str(tmp_path / "gan.yaml"), "--log_dir", str(tmp_path / "run"),
                         "--num_workers", "1", "--device", "cpu"])
    start = np.load(tmp_path / "run" / "images" / f"step_{1:010d}.npz")
    assert set(start.files) == {"real/image", "real/image/spectrum", "real/normal", "real/pointcloud",
                                "real/raydrop_mask"}
    tick = np.load(tmp_path / "run" / "images" / f"step_{16:010d}.npz")
    panels = {"real/image/aug", "fake/image/orig", "fake/raydrop_prob", "fake/raydrop_mask", "fake/image",
              "fake/image/spectrum", "fake/normal", "fake/pointcloud"}
    assert set(tick.files) == {"real_aug", "image", "image_orig", "raydrop_logit", "raydrop_mask"} | panels
    assert tick["fake/image"].shape == (8, 3, *RES) and tick["fake/pointcloud"].shape == (8, 3, RES[1], RES[1])
    assert all(np.isfinite(tick[k]).all() and 0 <= tick[k].min() and tick[k].max() <= 1 for k in panels)


# ---------------------------------------------------------------------------- entry points


def test_demos_need_a_card_unless_told(ckpts):
    path = ckpts[0]
    assert not torch.cuda.is_available()
    for mod, argv in ((demo_inversion, ["--ckpt_path", path]), (demo_interpolation, ["--ckpt_path", path]),
                      (quick_demo, ["--ckpt_path", path])):
        assert mod.parse_args(argv).device == "cuda"
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(argv)
    with pytest.raises(RuntimeError, match="cuda"):
        autoload_ckpt(path)


def test_demos_import_no_jax_and_no_imaging_library():
    code = (
        "import sys\n"
        "import dusty_gan_v2_tpu_torch.cli.demo_inversion, dusty_gan_v2_tpu_torch.cli.demo_interpolation\n"
        "import dusty_gan_v2_tpu_torch.cli.quick_demo, dusty_gan_v2_tpu_torch.cli.train_gan\n"
        "import dusty_gan_v2_tpu_torch.inversion, dusty_gan_v2_tpu_torch.geometry, dusty_gan_v2_tpu_torch.utils.image_io\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dusty_gan_v2_tpu',\n"
        "                                                     'matplotlib', 'PIL')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(_REPO)})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
