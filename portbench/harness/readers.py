"""What the per-layer readers (metrics/<name>.py) share: a kernel's share of its
roofline, the device's idle share, a model's share of the card's peak.

A reader takes the traced run's context and returns a number, or None where it finds
nothing to read (a kernel that did not run): the harness then leaves the metric out."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..work import least_seconds


def _complete(profile: Dict[str, Any], key: str) -> bool:
    r = profile["records"].get(key)
    return bool(r) and r["counter"] > 0 and r["profiler"] == r["counter"]


def best_profile(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The profiled stretch with every port kernel's records complete, else the one that
    misses fewest."""
    profiles = ctx.get("profiles") or []
    if not profiles:
        return None

    def missing(p):
        return sum(abs(r["counter"] - r["profiler"]) for r in p["records"].values())

    return min(profiles, key=missing)


def kernel_seconds(ctx: Dict[str, Any], key: str) -> Optional[List[Dict[str, Any]]]:
    """Each launch of kernel `key` with its work and its device seconds: the profiler's
    records of a stretch where they are complete for this kernel, else every launch of the
    window timed by CUDA events around it."""
    launches = ctx.get("launches", {}).get(key) or []
    if not launches:
        return None
    for p in ctx.get("profiles") or []:
        if _complete(p, key):
            lo, hi = p["launch_range"][key]
            part = launches[lo:hi]
            if len(part) == len(p["records"][key]["seconds"]):
                return [dict(l, s=s) for l, s in zip(part, p["records"][key]["seconds"])]
    timed = [l for l in launches if l["s"] is not None]
    return timed or None


def roofline(ctx: Dict[str, Any], key: str) -> Optional[float]:
    """100 x the launches' least time (work.py, peaks.json) over their device time."""
    rows = kernel_seconds(ctx, key)
    if not rows:
        return None
    least = sum(least_seconds(r["work"], ctx["peaks"])[0] for r in rows)
    spent = sum(r["s"] for r in rows)
    return 100.0 * least / spent if spent > 0 else None


def busy_filled(ctx: Dict[str, Any], profile: Dict[str, Any]) -> float:
    """The stretch's busy seconds, with each port kernel's missing records filled in by its
    mean event-timed launch of the window (the port's kernels run on one stream, so a lost
    record is a hole in the union, not an overlap)."""
    busy = profile["busy_s"]
    for key, r in profile["records"].items():
        if r["profiler"] < r["counter"]:
            lo, hi = profile["launch_range"][key]
            # the stretch's launches carry no events: fill each missing record with the mean
            # event-timed launch of the window
            timed = [l["s"] for l in ctx.get("launches", {}).get(key, []) if l["s"] is not None]
            if timed:
                busy += (r["counter"] - r["profiler"]) * sum(timed) / len(timed)
    return min(busy, profile["window_s"])


def idle(ctx: Dict[str, Any]) -> Optional[float]:
    p = best_profile(ctx)
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_filled(ctx, p) / p["window_s"])


def mfu(ctx: Dict[str, Any]) -> Optional[float]:
    """100 x the model FLOPs of the window over its seconds, over the configuration's
    peak."""
    flops = ctx.get("model_flops")
    if not flops or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops / ctx["window_s"] / ctx["peak_flops_per_s"]
