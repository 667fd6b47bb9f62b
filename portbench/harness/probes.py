"""What the traced run reads from the program without changing it: each port kernel timed
with CUDA events around its launches (its wrapper replaced, from the benchmark's side, by
one that records the events, the launch's shapes and dtypes and then calls it), its launch
counter, CUDA events at the training step's own boundaries, and torch.profiler over a
steady stretch for the device's busy time, its idle gaps and the top device operations."""

from __future__ import annotations

import importlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import work as W

Launch = Dict[str, Any]


def _shape(t) -> Optional[tuple]:
    return tuple(t.shape) if isinstance(t, torch.Tensor) else None


def launch_work(kind: str, args: tuple, out) -> Dict[str, float]:
    """The work of one launch from its tensors' shapes and dtypes (work.py)."""
    if kind == "bias_act":
        x = args[0]
        return W.bias_act(tuple(x.shape), x.element_size())
    if kind == "chain_fwd":
        x, bias = args[0], args[1]
        return W.chain_fwd(tuple(x.shape), tuple(out.shape), x.element_size(), bias is not None)
    if kind == "chain_bwd":
        g, x = args[0], args[1]
        return W.chain_bwd(tuple(x.shape), tuple(g.shape), x.element_size())
    if kind == "emd":
        a, b = args[0], args[1]
        return W.emd(a.shape[0], a.shape[1], b.shape[1])
    raise KeyError(kind)


class KernelProbes:
    """Replace each kernel's wrapper in its module by a timed one while active."""

    def __init__(self, specs: Dict[str, Dict[str, Any]]):
        self.specs = specs
        self.launches: Dict[str, List[Launch]] = {k: [] for k in specs}
        self._orig: Dict[str, Callable] = {}
        self.active = False
        self.timed = True  # CUDA events around each launch; off inside a profiled stretch

    def counts(self) -> Dict[str, int]:
        """Each kernel's launch counter as the program keeps it: the wrapper's function
        counts its launches on the attribute of the name it is called by, which is the
        timed wrapper while the probes are installed."""
        out = {}
        for k, s in self.specs.items():
            fn = getattr(importlib.import_module(s["module"]), s["function"])
            out[k] = int(getattr(fn, "launches", 0))
        return out

    def _wrap(self, key: str, fn: Callable) -> Callable:
        rec, kind = self.launches[key], self.specs[key]["work"]

        def timed(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            if not self.timed:  # the profiler times it: keep its work only
                out = fn(*args, **kwargs)
                rec.append({"start": None, "end": None, "work": launch_work(kind, args, out),
                            "dtype": str(args[0].dtype).replace("torch.", "")})
                return out
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            rec.append({"start": start, "end": end, "work": launch_work(kind, args, out),
                        "dtype": str(args[0].dtype).replace("torch.", "")})
            return out

        timed.launches = getattr(fn, "launches", 0)
        return timed

    def install(self) -> None:
        for k, s in self.specs.items():
            mod = importlib.import_module(s["module"])
            fn = getattr(mod, s["function"])
            self._orig[k] = fn
            setattr(mod, s["function"], self._wrap(k, fn))

    def uninstall(self) -> None:
        for k, s in self.specs.items():
            if k in self._orig:
                mod = importlib.import_module(s["module"])
                self._orig[k].launches = getattr(getattr(mod, s["function"]), "launches", 0)
                setattr(mod, s["function"], self._orig.pop(k))

    def resolve(self) -> Dict[str, List[Dict[str, Any]]]:
        """After a synchronize: each launch's event-timed seconds beside its work."""
        out = {}
        for k, recs in self.launches.items():
            out[k] = [{"s": None if r["start"] is None else r["start"].elapsed_time(r["end"]) / 1e3,
                       "work": r["work"], "dtype": r["dtype"]} for r in recs]
        return out


RANGE = "portbench_stretch"
GAP_S = 0.002


def profile_stretch(fn: Callable[[], None], kernel_specs: Dict[str, Dict[str, Any]],
                    counts: Callable[[], Dict[str, int]], probes: Optional["KernelProbes"] = None) -> Dict[str, Any]:
    """torch.profiler over one call of fn (a steady stretch of the window), between two
    synchronizations, inside a named range with the card idle for GAP_S at each end, so
    that the device records between the range's ends are the stretch's.

    Returns the stretch's seconds, the union of device activity in it (busy seconds), the
    kernels' device seconds by name, the idle gaps labelled by the host operation open at
    their start, and for each port kernel the profiler's record count beside its launch
    counter's increase (complete when equal)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    if probes is not None:
        probes.timed = False
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(GAP_S)
            with record_function(RANGE):
                time.sleep(GAP_S)
                before = counts()
                fn()
                torch.cuda.synchronize()
                after = counts()
                time.sleep(GAP_S)
            time.sleep(GAP_S)
    finally:
        if probes is not None:
            probes.timed = True
    events = prof.events()
    span = next(e.time_range for e in events if e.name == RANGE and e.device_type == DeviceType.CPU)
    dev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CUDA and e.name != RANGE
                  and span.start <= e.time_range.start <= span.end), key=lambda t: t[0])
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU and e.name != RANGE and span.start <= e.time_range.start <= span.end]
    by_name: Dict[str, float] = {}
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += (cur_e - cur_s) / 1e6
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += (cur_e - cur_s) / 1e6
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        open_ops = [c for c in cpu if c[0] <= g0 <= c[1]]
        label = min(open_ops, key=lambda c: c[1] - c[0])[2] if open_ops else "host"
        labelled.append([label, (g1 - g0) / 1e6])
    records = {}
    for key, spec in kernel_specs.items():
        n = sum(1 for _, _, name in dev if any(p in name for p in spec["profiler_names"]))
        records[key] = {"profiler": n, "counter": after[key] - before[key],
                        "seconds": [(e - s) / 1e6 for s, e, name in dev
                                    if any(p in name for p in spec["profiler_names"])]}
    return {"window_s": (span.end - span.start) / 1e6, "busy_s": busy,
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda t: -t[1])[:10],
            "idle_gaps": labelled, "records": records}
