"""Tiny configurations and cells for the harness's CPU tests (the cells' shapes cut to a
size a test run holds; the benchmark's own cells run only on the card)."""

from __future__ import annotations

import copy
import json

from portbench.harness.cells import ROOT, Cell

RES = (16, 64)
RES_V1 = (32, 64)  # the DUSty v1 G starts at H / 16, which a reflect pad of 1 needs at 2 or more


def tiny_config(name: str, fp32: bool = True) -> dict:
    """The benchmark's configuration `name` with its widths and resolution cut down (and,
    with fp32, its compute in float32, as the reference's)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    g, d = cfg["model"]["generator"], cfg["model"]["discriminator"]
    if "mapping_kwargs" in g:
        g["mapping_kwargs"].update(in_ch=16, out_ch=16)
    res = list(RES if g["arch"] == "dusty_v2" else RES_V1)
    g["synthesis_kwargs"].update(in_ch=16, ch_base=4, ch_max=16, resolution=res)
    if g["arch"] == "dusty_v2":
        g["synthesis_kwargs"]["layers"] = [2, 2]
    d["layer_kwargs"].update(ch_base=4, ch_max=16, resolution=res)
    if fp32:
        g.pop("compute_dtype", None)
        d["layer_kwargs"].pop("compute_dtype", None)
    cfg["training"]["lazy"].update(gp=4, ada=2)
    cfg["training"]["warmup"]["fade_kimg"] = 0.05
    cfg["eval_clouds"] = 4
    return cfg


def tiny_cell(config: str, traffic: dict, name: str = "tiny", fp32: bool = True) -> Cell:
    return Cell(name, config, tiny_config(config, fp32), traffic.get("kind", "?"), traffic, 1, [], [])


TRAIN = {"kind": "train", "batch": 8, "start_iteration": 8, "checked_steps": 3, "period": 4, "ada_p": 0.2,
         "depth_range_m": [2.0, 79.0], "mask_keep": 0.9}
EVAL = {"kind": "eval", "points": 64, "chunk": 4, "metric": "emd"}
