"""What every kind of cell shares: the card, the profiler window, the spans
and the result line."""
import json
import math
import sys
import time
from typing import Dict, List, Tuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "wildgaussians_tpu")


def card() -> Dict[str, object]:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def union_us(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """(length of the union of (start, end) intervals, the union's pieces)."""
    pieces: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if pieces and s <= pieces[-1][1]:
            pieces[-1] = (pieces[-1][0], max(pieces[-1][1], e))
        else:
            pieces.append((s, e))
    return sum(e - s for s, e in pieces), pieces


def profile_units(device, unit, warm: int, n: int):
    """Run `warm` units with the profiler on (its start-up is not kept),
    then a marker kernel and `n` units under a `SpanTimer`, whose spans
    name the device's idle gaps. Only the device is traced (CUDA
    activity: no CPU ops, which would slow the host). Returns (what the
    window shows, each measured unit's return value)."""
    from wildgaussians_torch.spans import SpanTimer
    sched = torch.profiler.schedule(wait=0, warmup=warm, active=1, repeat=1)
    got = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=sched) as prof:
        for _ in range(warm):
            unit()
            prof.step()
        torch.cuda.synchronize()
        with SpanTimer() as timer:
            ref = torch.cuda.Event(enable_timing=True)
            ref.record()
            torch.ones(1, device=device).mul_(2.0)   # the marker: the window's first kernel
            t0 = time.perf_counter()
            for _ in range(n):
                got.append(unit())
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        prof.step()
    return read_window(prof, ref, list(timer.events), wall_s), got


def read_window(prof, ref, span_events, window_s: float) -> Dict[str, object]:
    """Kernel time by name, busy time and launches of the window that the
    marker kernel opens, and its idle gaps named by the innermost program
    span that encloses them."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    marker, dev = dev[0], dev[1:]
    t0 = marker.time_range.start
    t_end = t0 + window_s * 1e6
    by_name: Dict[str, Tuple[float, int]] = {}
    for e in dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy, pieces = union_us([(e.time_range.start, min(e.time_range.end, t_end)) for e in dev])
    spans = []
    for name, start, end in span_events:
        s, e = (t0 + ref.elapsed_time(x) * 1e3 for x in (start, end))
        spans.append((s, e, name))
    gaps: Dict[str, float] = {}
    edges = [(t0, t0)] + pieces + [(t_end, t_end)]
    for (_s0, e0), (s1, _e1) in zip(edges[:-1], edges[1:]):
        if s1 <= e0:
            continue
        mid = 0.5 * (e0 + s1)
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        name = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "(no span)"
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) * 1e-6
    return {"kernels": by_name, "busy_s": busy * 1e-6, "window_s": window_s,
            "launches": len(dev), "gaps": gaps}


def breakdown(profile: Dict[str, object]) -> Dict[str, list]:
    """The device operations that took most of the window, by name, and the
    idle gaps by the span the host was in, each in seconds."""
    ops: Dict[str, float] = {}
    for name, (us, _n) in profile["kernels"].items():
        ops[_short(name)] = ops.get(_short(name), 0.0) + us * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    head = name.split("(", 1)[0] if not name.startswith("void ") else name[5:].split("(", 1)[0]
    return head[:120]


def emit(result: Dict[str, object], checks: Dict[str, Dict[str, float]]):
    """The compared numbers beside their limits as the last lines on
    standard error, then the result line last on standard output."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    out = dict(result)
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
