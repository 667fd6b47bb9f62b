"""The port's GAN command lines end to end on the CPU, on fabricated KITTI Raw frames
(the port's twin of tests/test_gan_e2e.py::test_train_then_eval).

train_gan runs a tiny dusty_v2 config with path-length regularization on (loss.pl 1,
lazy pl 2), R1, ADA and warmup, and writes checkpoints; a second run resumes from the
middle one and must end on the uninterrupted run's final state bit for bit (same draws
keyed by (seed, iteration), same data stream, same arithmetic on the CPU). test_gan then
evaluates the final checkpoint, and its scores must equal those of evaluation.py called
directly on the same outputs. --dry_run prints what the JAX CLI prints, and neither CLI
imports JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from dusty_gan_v2_tpu_torch.cli import test_gan as port_test_gan
from dusty_gan_v2_tpu_torch.cli import train_gan as port_train_gan
from dusty_gan_v2_tpu_torch.datasets import KITTIRaw, Prefetcher
from dusty_gan_v2_tpu_torch.evaluation import Outputs, collect_generated, evaluate, reals_to_outputs
from dusty_gan_v2_tpu_torch.geometry import CoordBridge
from dusty_gan_v2_tpu_torch.metrics import build_pointnet
from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt
from dusty_gan_v2_tpu_torch.training import Trainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (8, 64)  # the model's resolution; the fabricated scans are 16 rings x 64 azimuths
B = 8


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fabricated_scan(rng, H=16, W=64):
    """Ring-ordered spinning-LiDAR points (x, y, z, intensity): each ring starts inside
    the first quadrant and wraps once, as scan unfolding expects."""
    elev = np.deg2rad(3 - 28 * np.arange(H) / (H - 1))[:, None]
    phis = np.linspace(0.01, 2 * np.pi - 0.01, W)[None, :]
    r = rng.uniform(5, 50, (H, W))
    pts = np.stack([r * np.cos(elev) * np.cos(phis), r * np.cos(elev) * np.sin(phis),
                    r * np.sin(elev) * np.ones_like(phis), rng.rand(H, W)], axis=-1)
    return pts.reshape(-1, 4).astype(np.float32)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.RandomState(0)
    for seq in ("2011_10_03_drive_0027_sync", "2011_09_26_drive_0001_sync"):  # train (odometry 00), test (city)
        d = root / seq[:10] / seq / "velodyne_points" / "data"
        d.mkdir(parents=True)
        for i in range(16):
            fabricated_scan(rng).tofile(d / f"{i:010d}.bin")
    return root


def tiny_cfg(root):
    return {
        "dataset": {"name": "kitti_raw", "root": str(root), "min_depth": 1.45, "max_depth": 80, "flip": False,
                    "raydrop_const": -1, "prune_missing": True, "cache": "ram", "upload_dtype": "float16"},
        "training": {
            "random_seed": 0, "total_kimg": 4 * B / 1e3, "ema_kimg": 10, "ema_rampup": 0.05, "batch_size": B,
            "gan_objective": "nsgan", "loss": {"gan": 1, "gp": 1, "pl": 1}, "lazy": {"gp": 2, "pl": 2, "ada": 2},
            "lr": {"generator": {"alpha": 0.002, "beta1": 0, "beta2": 0.99},
                   "discriminator": {"alpha": 0.002, "beta1": 0, "beta2": 0.99}},
            "augment": {"p_init": 0.1, "p_target": 0.6, "kimg": 500,
                        "policy": {"lr_flip": 1, "int_trans": 1, "brightness": 1, "contrast": 1}},
            "warmup": {"fade_kimg": 1, "blur_init_sigma": 0, "dropout_init_ratio": 0.5},
            "checkpoint": {"save_stats": 1, "save_image": 2, "save_model": 2, "validation": 1000},
        },
        "validation": {"batch_size": 8, "num_points": 64},
        "random_seed": 0,
        "model": {
            "generator": {
                "arch": "dusty_v2", "mapping_kwargs": {"in_ch": 16, "out_ch": 16, "depth": 2},
                "synthesis_kwargs": {
                    "in_ch": 16, "out_ch": [{"name": "image", "ch": 1, "act": "tanh"},
                                            {"name": "raydrop_logit", "ch": 1, "act": None}],
                    "ch_base": 4, "ch_max": 16, "resolution": list(RES), "layers": [2, 2], "ring": True,
                    "use_noise": False, "aug_coords": True,
                },
                "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1},
            },
            "discriminator": {"arch": "dusty_v2", "layer_kwargs": {
                "in_ch": 1, "ring": True, "ch_base": 4, "ch_max": 16, "resolution": list(RES), "mbdis_group": 4,
                "mbdis_feat": 1, "pre_blur": True}},
        },
    }


@pytest.fixture(scope="module")
def trained(kitti_root, tmp_path_factory):
    """Run A: iterations 1-4 (checkpoints at 2 and 4). Run B: resumed from A's checkpoint
    at iteration 2, on to 4."""
    tmp = tmp_path_factory.mktemp("train")
    cfg_path = tmp / "gan.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_cfg(kitti_root)))  # PyYAML's block style, read by the port
    common = ["--config", str(cfg_path), "--num_workers", "2", "--device", "cpu"]
    _, state_a = port_train_gan.main(common + ["--log_dir", str(tmp / "a")])
    mid = tmp / "a" / "models" / f"checkpoint_{2 * B:010d}.ckpt"
    _, state_b = port_train_gan.main(common + ["--log_dir", str(tmp / "b"), "--resume", str(mid)])
    return tmp, state_a, state_b


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}.{k}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_train_writes_checkpoints_and_stats(trained):
    tmp, state_a, _ = trained
    names = sorted(p.name for p in (tmp / "a" / "models").glob("*.ckpt"))
    assert names == [f"checkpoint_{2 * B:010d}.ckpt", f"checkpoint_{4 * B:010d}.ckpt"]
    rows = [json.loads(line) for line in (tmp / "a" / "stats.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    # PL runs at the even iterations: its scalars appear from iteration 2 on, under the JAX names
    assert "loss/G/path_length" not in rows[0] and "loss/G/path_length/baseline" in rows[1]
    assert "loss/D/gradient_penalty" in rows[1] and "stats/ada_p" in rows[0]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert state_a.step == 4 and float(state_a.pl_ema) > 0
    # G's Adam stepped twice at each PL iteration (2 and 4): 6 steps
    assert float(state_a.opt_G.state[next(state_a.G.parameters())]["step"]) == 6.0
    side = np.load(tmp / "a" / "images" / f"step_{2 * B:010d}.npz")
    assert side["image"].shape == (8, 1, *RES) and side["real_aug"].shape == (8, 1, *RES)
    assert yaml.safe_load((tmp / "a" / "config.yaml").read_text())["training"]["loss"]["pl"] == 1


def test_resume_is_bit_exact(trained):
    tmp, state_a, state_b = trained
    last = f"checkpoint_{4 * B:010d}.ckpt"
    a, b = _payload(tmp / "a" / "models" / last), _payload(tmp / "b" / "models" / last)
    assert a["step"] == b["step"] == 4 * B
    _assert_equal_trees(a["state"], b["state"], "state")
    assert torch.equal(a["angle"], b["angle"]) and a["cfg"] == b["cfg"]
    rows_b = [json.loads(line) for line in (tmp / "b" / "stats.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows_b] == [3, 4]


def test_eval_scores_equal_evaluation_py(trained, kitti_root, tmp_path, capsys):
    tmp, _, _ = trained
    ckpt_path = tmp / "a" / "models" / f"checkpoint_{4 * B:010d}.ckpt"
    out_json = tmp_path / "scores.json"
    scores, stage_times = port_test_gan.main([
        "--ckpt_path", str(ckpt_path), "--metrics", "jsd,1nna-cd", "--num_samples", "16", "--num_subsample", "16",
        "--batch_size", "8", "--pairwise_batch", "8", "--dataset_root", str(kitti_root), "--out", str(out_json),
        "--device", "cpu",
    ])
    assert json.loads(out_json.read_text()) == scores
    assert "jsd" in scores and any("1-nn" in k and k.endswith("-cd") for k in scores)
    assert all(np.isfinite(v) for v in scores.values())
    assert {"generate+features+fps x16", "real data collection", "jsd", "1nna-cd"} <= set(stage_times)
    assert "[t] jsd:" in capsys.readouterr().out

    # the same through evaluation.py directly
    ckpt = autoload_ckpt(str(ckpt_path), device="cpu")
    cfg = ckpt["cfg"]
    coord = CoordBridge(*RES, cfg.dataset.min_depth, cfg.dataset.max_depth, angle=ckpt["angle"], device="cpu")
    np.random.seed(0)
    u = np.clip(np.random.rand(1, 1, *RES).astype(np.float32), 1e-6, 1 - 1e-6)
    noise = torch.from_numpy(np.log(u) - np.log1p(-u))
    gen = collect_generated(ckpt["G_ema"], ckpt["angle"], coord, 16, batch_size=8, num_subsample=16,
                            num_points=64, fixed_logistic=noise, seed=0)
    ds = KITTIRaw(str(kitti_root), "test", RES, cfg.dataset.min_depth, cfg.dataset.max_depth, prune_missing=True)
    parts = [reals_to_outputs(torch.from_numpy(b["depth"]), torch.from_numpy(b["mask"]), coord, -1.0, None, 64)
             for b in Prefetcher(ds, 8, num_workers=1)]
    ref = Outputs(*(torch.cat(x) for x in zip(*parts)))
    direct = evaluate(gen, ref, ("jsd", "1nna-cd"), pairwise_batch=8, num_subsample=16, device="cpu", seed=0)
    assert direct == scores


def test_validation_fpd_kpd(trained):
    """The FPD/KPD validation of the loop, at 16 samples with a seeded random PointNet."""
    tmp, state_a, _ = trained
    cfg = yaml.safe_load((tmp / "gan.yaml").read_text())
    tr = Trainer(cfg, device="cpu", seed=0)
    ds = KITTIRaw(cfg["dataset"]["root"], "train", RES, 1.45, 80, prune_missing=True)
    cache = {}
    scores = port_train_gan.validation_fpd_kpd(
        tr, state_a, lambda: iter(Prefetcher(ds, 8, num_workers=1)), build_pointnet("cpu"), cache, num_samples=16)
    assert set(scores) == {"pointcloud/frechet_distance_0k", "pointcloud/squared_mmd_0k"}
    assert all(np.isfinite(v) for v in scores.values()) and cache["feats"].shape[0] == 16


def _load_jax_cli(name):
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}_torch_e2e", os.path.join(_REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["dusty_v2.yaml", "dusty_v2_bf16.yaml", "dusty_v1.yaml", "vanilla.yaml"])
def test_dry_run_matches_jax_cli(config, monkeypatch, capsys):
    path = os.path.join(_REPO, "configs", "gans", config)
    assert port_train_gan.main(["--config", path, "--dry_run"]) is None
    ours = capsys.readouterr().out
    jax_cli = _load_jax_cli("train_gan")
    monkeypatch.setattr(sys, "argv", ["train_gan.py", "--config", path, "--dry_run"])
    jax_cli.main()
    assert capsys.readouterr().out == ours


def test_entry_points_need_a_card_unless_told(trained, tmp_path):
    """Without --device cpu / device="cpu" every entry point asks for the card and fails
    here, where there is none; none carries on on the CPU."""
    tmp, _, _ = trained
    ckpt = str(tmp / "a" / "models" / f"checkpoint_{4 * B:010d}.ckpt")
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        port_train_gan.main(["--config", str(tmp / "gan.yaml"), "--log_dir", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="cuda"):
        port_test_gan.main(["--ckpt_path", ckpt, "--metrics", "jsd"])
    with pytest.raises(RuntimeError, match="cuda"):
        autoload_ckpt(ckpt)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(yaml.safe_load((tmp / "gan.yaml").read_text()))


def test_clis_import_no_jax():
    code = (
        "import sys\n"
        "import dusty_gan_v2_tpu_torch.cli.train_gan, dusty_gan_v2_tpu_torch.cli.test_gan\n"
        "import dusty_gan_v2_tpu_torch.pretrained, dusty_gan_v2_tpu_torch.training.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dusty_gan_v2_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
