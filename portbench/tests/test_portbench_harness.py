"""The harness itself: no JAX anywhere, a reference independent of the program, cells,
configurations, traffic mixes and metrics found by name as new files, work counts against
hand counts, the readers on made-up traces."""

import ast
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import work
from portbench.harness import readers
from portbench.harness.cells import find_cell, kernels, load_benchmark, reader

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "dusty_gan_v2_tpu"}
PORT = "dusty_gan_v2_tpu_torch"


def imported(path: Path):
    """Top-level names of every module a file imports (relative imports excluded)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    found = set(imported(path)) & BANNED
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert PORT not in names and "portbench" not in names, names


def test_names_are_compared_whole():
    assert "dusty_gan_v2_tpu_torch".split(".")[0] not in BANNED


def test_benchmark_names_and_files():
    bench = load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = find_cell(w["name"], ROOT)
        assert cell.end_to_end and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(reader(m["name"], ROOT))
    assert set(kernels(ROOT)) == {"k1", "k3", "k4", "k5"}


def test_new_cell_config_and_metric_are_found_as_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a per-layer metric and a cell as
    new files (and entries in BENCHMARK.json): the harness finds each by its name."""
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = load_benchmark(ROOT)
    (root / "portbench" / "configs" / "dusty_v2_b64.json").write_text(
        json.dumps(dict(json.loads((PB / "configs" / "dusty_v2_bf16.json").read_text()), name="dusty_v2_b64")))
    (root / "portbench" / "traffic" / "train-b64.json").write_text(
        json.dumps(dict(json.loads((PB / "traffic" / "train-b128.json").read_text()), batch=64)))
    (root / "portbench" / "metrics" / "imgs_per_step.train64.py").write_text(
        "def read(ctx):\n    return ctx['imgs'] / ctx['iterations']\n")
    bench["configs"].append({"name": "dusty_v2_b64", "source": "x", "file": "portbench/configs/dusty_v2_b64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dusty_v2_b64.train-b64", "config": "dusty_v2_b64", "traffic": "train-b64",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "imgs_per_step.train64", "unit": "imgs", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "train64_imgs_per_s",
                               "workloads": ["dusty_v2_b64.train-b64"]})
    bench["end_to_end"].append({"name": "train64_imgs_per_s", "unit": "imgs/s", "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["dusty_v2_b64.train-b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("dusty_v2_b64.train-b64", root)
    assert cell.traffic["batch"] == 64 and cell.config["name"] == "dusty_v2_b64"
    assert sorted(m["name"] for m in cell.end_to_end) == ["setup_s", "train64_imgs_per_s"]
    assert "imgs_per_step.train64" in [m["name"] for m in cell.per_layer]
    assert reader("imgs_per_step.train64", root)({"imgs": 640, "iterations": 10}) == 64


def test_bias_act_counts():
    w = work.bias_act((2, 3, 4, 5), 2)
    assert w["bytes"] == (2 * 120 + 3) * 2 and w["f32_ops"] == 360


def test_chain_counts():
    # a blur at 2 x 3 planes of 4 x 8: W pass 4 x 8 outputs of 4 taps, H pass 4 x 8 of 4
    w = work.chain_fwd((2, 3, 4, 8), (2, 3, 4, 8), 4, act=True)
    assert w["f32_ops"] == 6 * 2 * (32 * 4 + 32 * 4) + 3 * 6 * 32
    assert w["bytes"] == (6 * (32 + 32) + 3) * 4
    b = work.chain_bwd((2, 3, 4, 8), (2, 3, 4, 8), 2)
    assert b["bytes"] == (6 * (64 + 32) + 3) * 2
    # 2x down: outputs of 4 taps along each axis
    d = work.chain_fwd((1, 1, 4, 8), (1, 1, 2, 4), 4, act=False)
    assert d["f32_ops"] == 2 * (4 * 4 * 4 + 2 * 4 * 4)


def test_emd_counts_and_bound():
    w = work.emd(256, 2048, 2048)
    assert w["bytes"] == 256 * (4096 * 12 + 4)
    peaks = json.loads((PB / "peaks.json").read_text())
    s, bound = work.least_seconds(w, peaks)
    assert bound == "operations" and 4.0e-3 < s < 4.3e-3  # chip_smoke.py's 4.151 ms


def test_model_flops_by_hand():
    """The vanilla D's convolutions and G's transposed convolutions at B=1, counted by the
    FLOP counter on the meta device, against the layer sums."""
    from portbench.tests import tiny
    from portbench.tests.tiny import tiny_config

    from portbench.reference.models import build_generator

    g_cfg = tiny_config("dusty_v1")["model"]["generator"]
    with torch.device("meta"):
        G = build_generator(g_cfg, "meta")
        with work._Counting() as c, torch.no_grad():
            G(torch.empty(1, 16), None, gumbel_noise=torch.empty(1, 1, *tiny.RES_V1))
    f = c.flops
    # projection 16 -> 16 channels (ch_max) over a (2, 4) kernel, then three 4x4 stride-2
    # transposed convolutions of the padded input, 16 -> 16 -> 8 -> 4, and two 4x4 heads 4 -> 1
    proj = 2 * 16 * 16 * 2 * 4
    ups = sum(2 * (h + 2) * (w + 2) * cin * cout * 16 for (h, w), cin, cout in
              (((2, 4), 16, 16), ((4, 8), 16, 8), ((8, 16), 8, 4)))
    heads = 2 * (2 * 18 * 34 * 4 * 1 * 16)
    assert f == proj + ups + heads


def test_readers_on_a_made_up_trace():
    peaks = json.loads((PB / "peaks.json").read_text())
    w = work.bias_act((1, 1, 1000, 1000), 4)
    least = work.least_seconds(w, peaks)[0]
    launches = {"k1": [{"s": 2 * least, "work": w, "dtype": "float32"}] * 4}
    prof = {"window_s": 1.0, "busy_s": 0.5, "device_ops": [], "idle_gaps": [],
            "records": {"k1": {"profiler": 3, "counter": 4, "seconds": [least] * 3}},
            "launch_range": {"k1": (0, 4)}}
    ctx = {"launches": launches, "profiles": [prof], "peaks": peaks, "window_s": 2.0,
           "model_flops": 1e12, "peak_flops_per_s": 1e14}
    assert readers.roofline(ctx, "k1") == pytest.approx(50.0)  # records incomplete: the events
    assert readers.roofline(ctx, "k4") is None
    assert readers.idle(ctx) == pytest.approx(100 * (1 - (0.5 + (4 - 3) * 2 * least)))  # one record filled
    prof["records"]["k1"]["profiler"] = 4
    prof["records"]["k1"]["seconds"] = [least] * 4
    assert readers.roofline(ctx, "k1") == pytest.approx(100.0)
    assert readers.mfu(ctx) == pytest.approx(0.5)
    # launches of a profiled stretch carry no events: without complete records, none to read
    launches["k1"] = [dict(l, s=None) for l in launches["k1"]]
    prof["records"]["k1"]["profiler"] = 3
    assert readers.roofline(ctx, "k1") is None
