"""The port's GAN command lines on the DUSty v1 and vanilla configs, end to end on the CPU,
on fabricated KITTI Raw frames (tests/test_torch_gan_e2e.py's tree and harness).

train_gan runs a tiny dusty_v1 config (DUSty v1 G + vanilla D at 32 x 64) with R1, ADA
and warmup, and a second run resumed from its middle checkpoint must end on the
uninterrupted run's final state bit for bit. A tiny vanilla config (vanilla G + vanilla
D, `measurement_kwargs: {}` as in configs/gans/vanilla.yaml) trains two iterations, and
test_gan evaluates its checkpoint through the real sets: the reals take the dataset's
raydrop_const, where the JAX CLI reads measurement_kwargs.raydrop_const and fails. Each
test_gan run's scores must equal those of evaluation.py called on the same outputs.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dusty_gan_v2_tpu_torch.cli import test_gan as port_test_gan
from dusty_gan_v2_tpu_torch.cli import train_gan as port_train_gan
from dusty_gan_v2_tpu_torch.datasets import KITTIRaw, Prefetcher
from dusty_gan_v2_tpu_torch.evaluation import Outputs, collect_generated, evaluate, reals_to_outputs
from dusty_gan_v2_tpu_torch.geometry import CoordBridge
from dusty_gan_v2_tpu_torch.pretrained import autoload_ckpt

from test_torch_gan_e2e import _assert_equal_trees, _payload, kitti_root  # noqa: F401 (a fixture)
from test_torch_gan_e2e import tiny_cfg as dusty_v2_cfg

RES = (32, 64)  # the vanilla synthesis starts at (H/16, W/16) and pads that by reflection
B = 8
CONFIGS = Path(__file__).resolve().parent.parent / "configs" / "gans"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg(root, g_arch, iters):
    """test_torch_gan_e2e's config with the model swapped for g_arch + vanilla D (PL off,
    as in the shipped configs; R1 every second iteration)."""
    cfg = dusty_v2_cfg(root)
    cfg["training"]["total_kimg"] = iters * B / 1e3
    cfg["training"]["loss"]["pl"] = 0
    heads = [{"name": "image", "ch": 1, "act": None}]
    if g_arch == "dusty_v1":
        heads.append({"name": "raydrop_logit", "ch": 1, "act": None})
    cfg["model"] = {
        "generator": {
            "arch": g_arch, "mapping_kwargs": {"in_ch": 16, "out_ch": 16},
            "synthesis_kwargs": {"in_ch": 16, "out_ch": heads, "ch_base": 4, "ch_max": 16, "resolution": list(RES),
                                 "ring": True},
            "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1} if g_arch == "dusty_v1" else {},
        },
        "discriminator": {"arch": "vanilla", "layer_kwargs": {"in_ch": 1, "ring": True, "ch_base": 4, "ch_max": 16,
                                                              "resolution": list(RES)}},
    }
    return cfg


def _train(tmp, root, g_arch, iters, name, resume=None):
    cfg_path = tmp / f"{g_arch}.yaml"
    cfg_path.write_text(yaml.safe_dump(tiny_cfg(root, g_arch, iters)))
    argv = ["--config", str(cfg_path), "--num_workers", "2", "--device", "cpu", "--log_dir", str(tmp / name)]
    return port_train_gan.main(argv + (["--resume", str(resume)] if resume else []))[1]


@pytest.fixture(scope="module")
def trained(kitti_root, tmp_path_factory):  # noqa: F811
    """dusty_v1: run A, iterations 1-4 (checkpoints at 2 and 4); run B resumed from A's
    checkpoint at 2, on to 4. vanilla: iterations 1-2."""
    tmp = tmp_path_factory.mktemp("train")
    state_a = _train(tmp, kitti_root, "dusty_v1", 4, "a")
    state_b = _train(tmp, kitti_root, "dusty_v1", 4, "b", tmp / "a" / "models" / f"checkpoint_{2 * B:010d}.ckpt")
    state_v = _train(tmp, kitti_root, "vanilla", 2, "v")
    return tmp, state_a, state_b, state_v


def test_dusty_v1_train_writes_checkpoints_and_stats(trained):
    tmp, state_a, _, _ = trained
    names = sorted(p.name for p in (tmp / "a" / "models").glob("*.ckpt"))
    assert names == [f"checkpoint_{2 * B:010d}.ckpt", f"checkpoint_{4 * B:010d}.ckpt"]
    rows = [json.loads(line) for line in (tmp / "a" / "stats.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2, 3, 4]
    assert "loss/D/gradient_penalty" in rows[1] and not any("path_length" in k for r in rows for k in r)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert state_a.step == 4 and type(state_a.G).__module__.endswith("dusty_v1")
    side = np.load(tmp / "a" / "images" / f"step_{2 * B:010d}.npz")
    panels = {"real/image/aug", "fake/image", "fake/image/spectrum", "fake/normal", "fake/pointcloud"}
    assert set(side.files) == {"real_aug", "image", "image_orig", "raydrop_logit", "raydrop_mask"} | panels | {
        "fake/image/orig", "fake/raydrop_prob", "fake/raydrop_mask"}
    assert side["image"].shape == (8, 1, *RES)


def test_dusty_v1_resume_is_bit_exact(trained):
    tmp = trained[0]
    last = f"checkpoint_{4 * B:010d}.ckpt"
    a, b = _payload(tmp / "a" / "models" / last), _payload(tmp / "b" / "models" / last)
    assert a["step"] == b["step"] == 4 * B
    _assert_equal_trees(a["state"], b["state"], "state")
    assert torch.equal(a["angle"], b["angle"]) and a["cfg"] == b["cfg"]


def _direct_scores(ckpt_path, root, metrics, raydrop_const):
    """test_gan's pipeline through evaluation.py directly (seed 0, 16 + 16 clouds)."""
    ckpt = autoload_ckpt(str(ckpt_path), device="cpu")
    cfg = ckpt["cfg"]
    coord = CoordBridge(*RES, cfg.dataset.min_depth, cfg.dataset.max_depth, angle=ckpt["angle"], device="cpu")
    np.random.seed(0)
    u = np.clip(np.random.rand(1, 1, *RES).astype(np.float32), 1e-6, 1 - 1e-6)
    noise = torch.from_numpy(np.log(u) - np.log1p(-u))
    gen = collect_generated(ckpt["G_ema"], ckpt["angle"], coord, 16, batch_size=8, num_subsample=16,
                            num_points=64, fixed_logistic=noise, seed=0)
    ds = KITTIRaw(str(root), "test", RES, cfg.dataset.min_depth, cfg.dataset.max_depth, prune_missing=True)
    parts = [reals_to_outputs(torch.from_numpy(b["depth"]), torch.from_numpy(b["mask"]), coord, raydrop_const,
                              None, 64)
             for b in Prefetcher(ds, 8, num_workers=1)]
    ref = Outputs(*(torch.cat(x) for x in zip(*parts)))
    return evaluate(gen, ref, metrics, pairwise_batch=8, num_subsample=16, device="cpu", seed=0)


@pytest.mark.parametrize("g_arch,run", [("dusty_v1", "a"), ("vanilla", "v")])
def test_test_gan_scores_equal_evaluation_py(trained, kitti_root, tmp_path, g_arch, run):  # noqa: F811
    tmp = trained[0]
    iters = 4 if g_arch == "dusty_v1" else 2
    ckpt_path = tmp / run / "models" / f"checkpoint_{iters * B:010d}.ckpt"
    cfg = autoload_ckpt(str(ckpt_path), device="cpu")["cfg"]
    assert cfg.model.generator.arch == g_arch
    if g_arch == "vanilla":  # the configuration the JAX CLI cannot evaluate
        assert "raydrop_const" not in cfg.model.generator.measurement_kwargs
    out_json = tmp_path / "scores.json"
    metrics = ("swd", "jsd", "1nna-cd")
    scores, stage_times = port_test_gan.main([
        "--ckpt_path", str(ckpt_path), "--metrics", ",".join(metrics), "--num_samples", "16",
        "--num_subsample", "16", "--batch_size", "8", "--pairwise_batch", "8", "--dataset_root", str(kitti_root),
        "--out", str(out_json), "--device", "cpu",
    ])
    assert json.loads(out_json.read_text()) == scores
    assert "real data collection" in stage_times and "jsd" in scores
    assert all(np.isfinite(v) for v in scores.values())
    assert _direct_scores(ckpt_path, kitti_root, metrics, float(cfg.dataset.raydrop_const)) == scores


def test_vanilla_trains_and_checkpoints(trained):
    tmp, _, _, state_v = trained
    assert state_v.step == 2 and type(state_v.G).__module__.endswith("vanilla")
    rows = [json.loads(line) for line in (tmp / "v" / "stats.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2] and all(np.isfinite(v) for r in rows for v in r.values())
    ckpt = autoload_ckpt(str(tmp / "v" / "models" / f"checkpoint_{2 * B:010d}.ckpt"), device="cpu")
    for name in ("G", "G_ema", "D"):
        got, ref = ckpt[name].state_dict(), getattr(state_v, name).state_dict()
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref), name
    side = np.load(tmp / "v" / "images" / f"step_{2 * B:010d}.npz")
    assert set(side.files) == {"real_aug", "image", "real/image/aug", "fake/image", "fake/image/spectrum",
                               "fake/normal", "fake/pointcloud"}


def test_jax_cli_reads_a_key_vanilla_lacks():
    """The fault the port's test_gan steps round: the JAX CLI (test_gan.py) fills the reals
    with cfg.model.generator.measurement_kwargs.raydrop_const, which configs/gans/vanilla.yaml
    does not set; the port falls back to dataset.raydrop_const, which both configs set."""
    from dusty_gan_v2_tpu.utils.config import load_config as j_load_config

    from dusty_gan_v2_tpu_torch.utils.config import load_config

    cfg = j_load_config(str(CONFIGS / "vanilla.yaml"))
    with pytest.raises(AttributeError, match="raydrop_const"):
        cfg.model.generator.measurement_kwargs.raydrop_const
    for name in ("vanilla", "dusty_v1"):
        ours = load_config(str(CONFIGS / f"{name}.yaml"))
        assert float(ours.dataset.raydrop_const) == -1.0
