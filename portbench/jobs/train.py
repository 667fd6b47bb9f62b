"""Training cells: the program's `Trainer.step` over consecutive iterations.

Set-up builds one Trainer and one TrainState (weights from the seed), drives the state
through the first `checked_steps` iterations with the window's own call and feed
(recording each step's losses, the first step's gradients as each optimizer gets them,
through the step's `on_phase` hook, and the parameters' change over those steps), then
on through the rest of that lazy-regularization period so that every variant of the
step (R1, ADA's update, neither) has run once, and hands the same state to the window.
The window runs whole periods of `period` iterations until `--seconds` have passed, so
the share of R1 and ADA steps is the configuration's in every run.

After the window (and after the peak memory is read and the program's state freed) the
reference follows the same first steps from the same weights, batches and draws, and
the numbers of harness/checks.py decide `correct`. They read only set-up's steps, so
they do not depend on --seconds or --trace."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..harness import checks as C
from ..harness.cells import Cell
from ..harness.runtime import Outcome, free_cuda, set_precision
from ..harness.weights import seeded_weights
from ..reference import precision
from ..reference.step import RefTrainer
from . import common

NETS = ("G", "D", "G_ema")


class PortTrainer:
    """The program under test: dusty_gan_v2_tpu_torch's Trainer."""

    def __init__(self, cfg: Dict[str, Any], device, seed: int):
        from dusty_gan_v2_tpu_torch.training import Trainer

        self.tr = Trainer(cfg, device=device, seed=seed)

    def init_state(self, weights, ada_p: float):
        st = self.tr.init_state(seed=0)
        st.G.load_state_dict(weights["G"])
        st.G_ema.load_state_dict(weights["G"])
        st.D.load_state_dict(weights["D"])
        st.ada.p.fill_(ada_p)
        return st

    def step(self, st, depth, mask, it: int, stream, on_phase=None) -> Dict[str, torch.Tensor]:
        hook = None if on_phase is None else (lambda name, state, values: on_phase(name, self.nets(state), values))
        m = self.tr.step(st, {"depth": depth, "mask": mask}, it, draws=stream, on_phase=hook)
        out = {"g": m["loss/G/adversarial"], "d": m["loss/D/adversarial"]}
        if "loss/D/gradient_penalty" in m:
            out["r1"] = m["loss/D/gradient_penalty"]
        return out

    @staticmethod
    def nets(st) -> Dict[str, torch.nn.Module]:
        return {"G": st.G, "D": st.D, "G_ema": st.G_ema}


class RefProgram:
    """The reference put in the program's place (the control runs), at `prec`
    ("fp32", "bf16", "fp8", or "tf32": float32 with the TF32 switches on)."""

    def __init__(self, cfg: Dict[str, Any], device, seed: int, prec: str = "fp32"):
        H, W = cfg["model"]["generator"]["synthesis_kwargs"]["resolution"]
        self.ref = RefTrainer(cfg, common.angle((H, W), device), device)
        self.prec = prec

    def init_state(self, weights, ada_p: float):
        return self.ref.init_state(weights, ada_p)

    def step(self, st, depth, mask, it, stream, on_phase=None):
        hook = None if on_phase is None else (lambda name, state, values: on_phase(name, self.nets(state), values))
        tf32 = self.prec == "tf32"
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32 or old[0]
        try:
            with precision.use("fp32" if tf32 else self.prec):
                return self.ref.step(st, depth, mask, it, stream, hook)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    @staticmethod
    def nets(st) -> Dict[str, torch.nn.Module]:
        return {"G": st.G, "D": st.D, "G_ema": st.G_ema}


def _params(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in net.named_parameters()}


def follow(program, weights, traffic, seed: int, B: int, HW, device) -> Dict[str, Any]:
    """Drive `program` from `weights` through the checked steps; returns its readings:
    losses per step, G's image (before the ray drop) in the first step's G phase, D's
    outputs on the first step's reals, the first step's gradient norms per phase and leaf,
    the parameters' change norms per network and leaf, and the draws each step asked for."""
    it0, n = traffic["start_iteration"], traffic["checked_steps"]
    st = program.init_state(weights, traffic["ada_p"])
    grads: Dict[str, Dict[str, float]] = {}
    fakes = []

    def keep_fake(module, args, out):  # G's first forward of the step: the G phase's
        if not fakes:
            fakes.append(out["image_orig"].detach().float().cpu())

    logits: Dict[str, torch.Tensor] = {}

    def on_phase(name, nets, values):
        if name == "d":
            logits["real"] = values["y_real"].detach().float().reshape(-1).cpu()
        net = nets["G"] if name == "g" else nets["D"]
        grads[name] = C.leaf_norms({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                                    for k, p in net.named_parameters() if p.requires_grad})

    losses, draws = [], []
    for k in range(n):
        it = it0 + k
        depth, mask = common.depth_batch(seed, it, B, *HW, traffic, device)
        stream = common.step_stream(seed, it, B, device)
        hook = program.nets(st)["G"].register_forward_hook(keep_fake) if k == 0 else None
        out = program.step(st, depth, mask, it, stream, on_phase if k == 0 else None)
        if hook is not None:
            hook.remove()
        losses.append({name: float(v) for name, v in out.items()})
        draws.append(list(stream.log))
    nets = program.nets(st)
    init = {"G": weights["G"], "D": weights["D"], "G_ema": weights["G"]}
    change = {}
    for net_name in NETS:
        params = _params(nets[net_name])
        change[net_name] = C.leaf_norms({k: p.detach() - init[net_name][k] for k, p in params.items()})
    return {"losses": losses, "grads": grads, "logits": logits, "fake": fakes[0] if fakes else None, "change": change,
            "draws": draws, "state": st}


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers compared (harness/checks.py's measures; the cell's limits file says which
    it holds, PERF.md gives the readings): g_image_gap, G's image before the ray drop in the
    first step's G phase (before any update), the worst sample's relative L2 gap; logit_gap, D's outputs on the first step's
    augmented reals (D's forward alone, before any update or ray-drop decision), the worst
    sample's gap over the batch's root mean square; loss_gap, the worst relative gap of a
    loss (G, D, R1) over the checked steps; grad_gap and grad_median_gap, the first step's
    gradients as each optimizer gets them, by the worst leaf and by the median leaf, the
    worst phase; change_gap and change_median_gap, the parameters' change over the checked
    steps by the worst leaf and by the median leaf, the worst network (leaves whose reference
    gradient is under a thousandth of the median leaf's in every phase left out);
    draw_mismatch, draws asked for differently."""
    same = len(prog["losses"]) == len(ref["losses"]) and set(prog["grads"]) == set(ref["grads"])
    loss_gap = 0.0
    for lp, lr in zip(prog["losses"], ref["losses"]):
        for k in lr:
            loss_gap = max(loss_gap, C.rel_gap(lp.get(k, float("nan")), lr[k]))
    yp, yr = prog["logits"].get("real"), ref["logits"].get("real")
    if yp is None or yr is None or yp.shape != yr.shape:
        logit_gap = float("inf")
    else:
        logit_gap = float((yp - yr).abs().max() / yr.square().mean().sqrt().clamp(min=1e-30))
    fp, fr = prog["fake"], ref["fake"]
    if fp is None or fr is None or fp.shape != fr.shape:
        g_image_gap = float("inf")
    else:
        g_image_gap = float(((fp - fr).flatten(1).norm(dim=1) / fr.flatten(1).norm(dim=1).clamp(min=1e-30)).max())
    grad_gap = max((C.worst_leaf_gap(prog["grads"].get(ph, {}), g) for ph, g in ref["grads"].items()), default=0.0)
    grad_med = max((C.median_leaf_gap(prog["grads"].get(ph, {}), g) for ph, g in ref["grads"].items()), default=0.0)
    still = {}
    for ph, g in ref["grads"].items():
        med = sorted(g.values())[len(g) // 2] if g else 0.0
        still[ph] = {k for k, v in g.items() if v < 1e-3 * med}
    skip_G = still.get("g", set())
    skip_D = set.intersection(*(still[ph] for ph in ("d", "r1") if ph in still)) if ("d" in still) else set()
    skips = {"G": skip_G, "G_ema": skip_G, "D": skip_D}
    change_gap = max(C.worst_leaf_gap(prog["change"][n], ref["change"][n], skips[n]) for n in NETS)
    change_med = max(C.median_leaf_gap(prog["change"][n], ref["change"][n], skips[n]) for n in NETS)
    mismatch = sum(a != b for a, b in zip(prog["draws"], ref["draws"])) + abs(len(prog["draws"]) - len(ref["draws"]))
    out = {"g_image_gap": g_image_gap, "logit_gap": logit_gap, "loss_gap": loss_gap, "grad_gap": grad_gap, "grad_median_gap": grad_med,
           "change_gap": change_gap, "change_median_gap": change_med, "draw_mismatch": float(mismatch)}
    return out if same else {k: float("inf") for k in out}


def detail(prog: Dict[str, Any], ref: Dict[str, Any]) -> list:
    """Where each number comes from: the losses, each phase's and network's worst leaf."""
    out = [f"losses program {prog['losses']} reference {ref['losses']}"]
    for ph, g in ref["grads"].items():
        out.append(f"grad {ph}: worst leaf {C.worst_leaf(prog['grads'].get(ph, {}), g)}")
    for n in NETS:
        out.append(f"change {n}: worst leaf {C.worst_leaf(prog['change'][n], ref['change'][n])}")
    return out


def reference_readings(cfg, weights, traffic, seed, B, HW, device) -> Dict[str, Any]:
    ref = RefProgram(cfg, device, seed, "fp32")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = follow(ref, weights, traffic, seed, B, HW, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    out.pop("state")
    return out


def _profile_more(profiles) -> bool:
    """Another stretch to profile: none yet, or the last one's records fall short."""
    if len(profiles) >= 3:
        return False
    return not profiles or any(r["profiler"] != r["counter"] for r in profiles[-1]["records"].values())


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_proc: float, device="cuda",
        program_factory: Optional[Callable] = None, probes=None, limits: Optional[Dict[str, float]] = None) -> Outcome:
    cfg, traffic = common.model_cfg(cell.config), cell.traffic
    cfg["training"]["batch_size"] = B = int(traffic["batch"])
    H, W = cfg["model"]["generator"]["synthesis_kwargs"]["resolution"]
    dev = torch.device(device)
    set_precision(cell.config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    weights = seeded_weights(cfg["model"], seed, dev)
    program = (program_factory or PortTrainer)(cfg, dev, seed)
    readings = follow(program, weights, traffic, seed, B, (H, W), dev)
    st = readings.pop("state")
    period, it = int(traffic["period"]), traffic["start_iteration"] + traffic["checked_steps"]
    while it % period:  # the rest of the first period: every variant of the step runs in set-up
        depth, mask = common.depth_batch(seed, it, B, H, W, traffic, dev)
        program.step(st, depth, mask, it, common.step_stream(seed, it, B, dev))
        it += 1
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t_win = time.perf_counter()
    setup_s = t_win - t_proc

    phase_events = []
    profiles = []

    def one_step(i):
        depth, mask = common.depth_batch(seed, i, B, H, W, traffic, dev)
        stream = common.step_stream(seed, i, B, dev)
        if trace:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            program.step(st, depth, mask, i, stream,
                         lambda name, nets, values: ev[1].record() if name == "g" else None)
            ev[2].record()
            phase_events.append(ev)
        else:
            program.step(st, depth, mask, i, stream)

    def one_period():
        nonlocal it
        for _ in range(period):
            one_step(it)
            it += 1

    # a traced run profiles its second period (and the next, up to three, while the profiler's
    # records fall short of the launch counters); the per-layer rates read the periods that
    # ran without the profiler
    steps, n_periods, plain_s, plain_steps, period_s = 0, 0, 0.0, 0, []
    if trace and probes is not None:
        probes.active = True
    while True:
        t0 = time.perf_counter()
        profiled = trace and probes is not None and n_periods >= 1 and _profile_more(profiles)
        if profiled:
            from ..harness.probes import profile_stretch

            before = {k: len(v) for k, v in probes.launches.items()}
            p = profile_stretch(one_period, probes.specs, probes.counts, probes)
            p["launch_range"] = {k: (before[k], len(probes.launches[k])) for k in before}
            profiles.append(p)
        else:
            one_period()
        steps += period
        n_periods += 1
        sync()
        t1 = time.perf_counter()
        if not profiled:
            plain_s, plain_steps = plain_s + t1 - t0, plain_steps + period
            period_s.append(t1 - t0)
        if t1 - t_win >= seconds and (not trace or probes is None or profiles):
            break
    window_s = time.perf_counter() - t_win
    if probes is not None:
        probes.active = False
    peak = int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0
    imgs = steps * B
    ctx = None
    if trace:
        ctx = {"kind": "train", "iterations": plain_steps, "first_iteration": it - steps, "window_s": plain_s,
               "imgs": plain_steps * B,
               "phase_ms": {"g": [e[0].elapsed_time(e[1]) for e in phase_events],
                            "d": [e[1].elapsed_time(e[2]) for e in phase_events]},
               "profiles": profiles}
    del st, program
    free_cuda()

    ref = reference_readings(cfg, weights, traffic, seed, B, (H, W), dev)
    nums = compare(readings, ref)
    limits = limits if limits is not None else common.load_limits(cell.name)
    found = [C.Check(k, v, limits[k]) for k, v in nums.items() if k in limits]
    shown = [f"reading {k}: {v!r} (not compared)" for k, v in nums.items() if k not in limits]
    shown.append(f"window periods of {period} steps, seconds each: {[round(s, 4) for s in period_s]}")
    return Outcome(e2e={"train_imgs_per_s": imgs / window_s, "setup_s": setup_s}, attempted=steps, failed=0,
                   checks=found, memory_peak_bytes=peak, trace=ctx, notes=shown + detail(readings, ref))
