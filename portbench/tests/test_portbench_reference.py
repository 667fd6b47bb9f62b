"""The program against the reference at a tiny size, for each entry the benchmark drives;
a lower precision failing the comparison; the planted faults caught."""

import time

import pytest
import torch

from portbench import faults
from portbench.jobs import common, eval as ev, train
from portbench.tests.tiny import EVAL, TRAIN, tiny_cell

# the comparison at the tiny size on the CPU: the program's float32 plain routes against the
# reference's float32 differ by summation order only (~1e-7 read); the cells' own limits
# (limits/*.json) are set from card runs at the cells' sizes
TIGHT = {"g_image_gap": 1e-5, "loss_gap": 1e-5, "grad_median_gap": 1e-5, "change_gap": 1e-5,
         "change_median_gap": 1e-5, "grad_gap": 1e-5, "logit_gap": 1e-5,
         "draw_mismatch": 0.0,
         "emd_gap": 1e-5, "emd_mean_gap": 1e-5, "score_gap": 1e-9, "missing": 0.0}
RUNS = {"train": (train, TRAIN), "eval": (ev, EVAL)}


def run(config, kind, factory=None, fp32=True, seed=20251018):
    job, traffic = RUNS[kind]
    cell = tiny_cell(config, traffic, fp32=fp32)
    limits = {k: v for k, v in TIGHT.items()}
    return job.run(cell, seed, 0.2, False, time.perf_counter(), "cpu", program_factory=factory, limits=limits), cell


@pytest.mark.parametrize("config,kind", [("dusty_v2_bf16", "train"), ("dusty_v1", "train"), ("dusty_v2_bf16", "eval")])
def test_program_matches_reference(config, kind):
    out, _ = run(config, kind)
    assert out.correct, [(c.name, c.value) for c in out.checks]
    assert out.attempted > 0 and all(v > 0 for v in out.e2e.values())


@pytest.mark.parametrize("config,kind,number", [("dusty_v2_bf16", "train", "g_image_gap"),
                                                ("dusty_v2_bf16", "eval", "emd_mean_gap")])
def test_lower_precision_fails(config, kind, number):
    """The control: the reference in the program's place with fp8 operands (training), the
    reference's approxmatch in bfloat16 at the sampled entries (evaluation)."""
    cell = tiny_cell(config, RUNS[kind][1])
    out, _ = run(config, kind, faults.control(cell))
    gaps = {c.name: c.value for c in out.checks}
    assert not out.correct and gaps[number] > TIGHT[number], gaps


def test_half_batch_reads_in_g_image_gap():
    """Half of the batch left out: G's image of the first step reads the other half's
    latents in the rows left out, whatever the rounding of the rest."""
    cell = tiny_cell("dusty_v2_bf16", TRAIN)
    out, _ = run("dusty_v2_bf16", "train", faults.planted(cell)["half_batch"])
    gaps = {c.name: c.value for c in out.checks}
    assert gaps["g_image_gap"] > 0.1, gaps


@pytest.mark.parametrize("config,kind,fault", [
    ("dusty_v2_bf16", "train", "unchanged"), ("dusty_v2_bf16", "train", "half_batch"),
    ("dusty_v1", "train", "half_batch"), ("dusty_v2_bf16", "eval", "altered"),
    ("dusty_v2_bf16", "eval", "half_batch")])
def test_planted_fault_is_caught(config, kind, fault):
    """The rest of a run (the look for a card skipped) with the timed path broken
    underneath comes out not correct."""
    cell = tiny_cell(config, RUNS[kind][1])
    out, _ = run(config, kind, faults.planted(cell)[fault])
    assert not out.correct, [(c.name, c.value) for c in out.checks]


def test_bf16_program_reads_a_gap():
    """The program at its configuration's bf16 policy is not the float32 reference: the
    numbers compared read it (the cells' limits leave room for it)."""
    out, _ = run("dusty_v2_bf16", "train", fp32=False)
    gaps = {c.name: c.value for c in out.checks}
    assert gaps["grad_median_gap"] > 1e-5 and gaps["draw_mismatch"] == 0.0, gaps


def test_draws_do_not_depend_on_the_window():
    """The same seed draws the same batch and step draws whatever ran before."""
    a = common.depth_batch(7, 1568, 2, 4, 8, TRAIN, "cpu")
    common.depth_batch(7, 1569, 2, 4, 8, TRAIN, "cpu")
    b = common.depth_batch(7, 1568, 2, 4, 8, TRAIN, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    s1, s2 = common.step_stream(2**31 + 5, 3, 2, "cpu"), common.step_stream(2**31 + 5, 3, 2, "cpu")
    assert torch.equal(s1.normal((4,)), s2.normal((4,)))


@pytest.mark.card
def test_cells_run_on_the_card(card):
    """Each cell of BENCHMARK.json through run.py's job on the card, a short window,
    correct under the cell's own limits."""
    from portbench.harness.cells import ROOT, find_cell, load_benchmark
    import importlib

    for w in load_benchmark(ROOT)["workloads"]:
        cell = find_cell(w["name"], ROOT)
        job = importlib.import_module(f"portbench.jobs.{cell.traffic['kind']}")
        out = job.run(cell, 4242, 1.0, False, time.perf_counter(), "cuda")
        assert out.correct, (w["name"], [(c.name, c.value, c.limit) for c in out.checks])


@pytest.mark.card
def test_controls_fail_on_the_card(card):
    """Each cell's control at the cell's own size comes out not correct."""
    from portbench.harness.cells import ROOT, find_cell, load_benchmark
    import importlib

    for w in load_benchmark(ROOT)["workloads"]:
        cell = find_cell(w["name"], ROOT)
        job = importlib.import_module(f"portbench.jobs.{cell.traffic['kind']}")
        out = job.run(cell, 4243, 1.0, False, time.perf_counter(), "cuda", program_factory=faults.control(cell))
        assert not out.correct, (w["name"], [(c.name, c.value, c.limit) for c in out.checks])
