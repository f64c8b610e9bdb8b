#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100;
the kernels are built for sm_90a). Every phase is fatal on failure:

  1. the card (name and power limit from nvidia-smi), torch, CUDA and nvcc;
  2. build every CUDA kernel of the serving path from wildgaussians_torch/csrc
     with nvcc, one process per source, printing nvcc's register and
     shared-memory report;
  3. hold each kernel against its plain PyTorch version on the card (a
     20k-Gaussian surfel scene at 512x384, 1-3 color passes), and the whole
     render path on the card against the same path on the CPU;
  4. the serving path at full width: a 1.5M-Gaussian, SH-degree-3,
     appearance-on checkpoint in the JAX package's format, loaded through
     WildGaussians and asked for 8 renders at 1280x720 from 4 poses (one with
     depth, one with an explicit embedding; the first is a warm-up). Each
     kernel's launch count is read over exactly those requests; then each
     kernel is checked against its plain version and timed at the shapes the
     path gave it, beside its bound;
  5. where a request's time goes, on the same model: the render's stage
     spans timed on the device (wildgaussians_torch/spans.py), then one
     torch.profiler window of requests for the device's busy time, idle
     share and launches per request, and the kernels that take most of it.

It prints one {"kernels": [...]} line, the nvidia-smi line of the card, and
as its last line {"ok": true, "device": {...}}. Without a CUDA card it exits
with 1 and prints no result.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
CHECK_N, CHECK_W, CHECK_H = 20_000, 512, 384
FULL_N, FULL_W, FULL_H = 1_500_000, 1280, 720
# K1 against its plain version: a pixel can differ only where an alpha sits
# on the 1/255 floor or T on the 1e-4 stop; a T-stop flip moves it < 1e-4
TOL_PIXEL, TOL_FRAC, TOL_MAX = 1e-4, 1e-4, 5e-3
# the whole path, card vs CPU: the same float ops, but exp/log/matmul round
# differently, which can flip a corner cull or a depth-key tie
TOL_PATH_PIXEL, TOL_PATH_FRAC = 1e-3, 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor cores,
# HBM3 bandwidth; the SFU issues 1/16 of the FP32 flop rate
PEAK_FP32, PEAK_BYTES, SFU_COST = 67e12, 3.35e12, 16
# K1's FP32 operations (an FMA is two) per (pixel, entry) pair, by the work
# the pair needs (blend.blend_pair_counts): the power and its test; exp (at
# the SFU's cost), alpha, its clamp and test; the T (1 - alpha) test; the
# weight, then 3 FMAs per color pass
OPS_EVALUATED, OPS_EXP, OPS_USED, OPS_CONTRIB, OPS_PER_PASS = 12, 3 + SFU_COST, 3, 1, 6
PROFILE_REQUESTS = 5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_line():
    from wildgaussians_torch.ops import _build
    out = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    return [ln for ln in out.splitlines() if "release" in ln][0].strip()


def kernels():
    """Every kernel of the serving path, with its wrapper and plain version."""
    from wildgaussians_torch.ops import blend
    return [dict(name="blend_fwd", route="cuda", source="wildgaussians_torch/csrc/blend_fwd.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:376",
                 wrapper=blend.blend_forward, plain=blend.blend_forward_plain)]


def camera(pose, width, height, f):
    from wildgaussians_torch.types import new_cameras
    return new_cameras(poses=np.asarray(pose, np.float32)[None],
                       intrinsics=np.array([[f, f, width / 2, height / 2]], np.float32),
                       camera_models=np.zeros((1,), np.int32),
                       distortion_parameters=np.zeros((1, 6), np.float32),
                       image_sizes=np.array([[width, height]], np.int32))


def poses():
    """Four camera-to-world poses around the surfel scene's identity camera."""
    out = []
    for yaw, t in ((0.0, (0.0, 0.0, 0.0)), (0.06, (0.4, -0.1, 0.5)),
                   (-0.08, (-0.5, 0.1, 1.0)), (0.03, (0.2, 0.15, -0.5))):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        out.append(np.concatenate([R, np.array(t)[:, None]], axis=1))
    return out


def make_checkpoint(root, name, n, width, height):
    from wildgaussians_torch.scenes import write_surfel_checkpoint
    return write_surfel_checkpoint(os.path.join(root, name), n, width, height, SEED)


def compare(kernel_out, plain_out):
    """(max abs error, pixels over TOL_PIXEL, pixels) over colors and final_T."""
    kc, kt, _kw = kernel_out
    pc, pt, _pw = plain_out
    err = torch.maximum((kc - pc).abs().amax(dim=(0, 3)), (kt - pt).abs())   # [T, 256]
    return float(err.max()), int((err > TOL_PIXEL).sum()), err.numel()


def check_kernel(k, inputs, label):
    out = k["wrapper"](*inputs)
    plain = k["plain"](*inputs)
    torch.cuda.synchronize()
    max_err, over, total = compare(out, plain)
    walked_diff = int((out[2] != plain[2]).sum())
    emit({"check": k["name"], "at": label, "max_abs_err": max_err, "pixels_over_1e-4": over,
          "pixels": total, "tiles_walked_differently": walked_diff})
    check(max_err <= TOL_MAX and over <= TOL_FRAC * total,
          f"{k['name']} disagrees with its plain version at {label}: max {max_err}, "
          f"{over} of {total} pixels over {TOL_PIXEL}")
    return max_err, over


def time_cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blend_bound_ms(table, tile_counts, walked, n_passes, pairs):
    """Least time for K1's work on these inputs: the walked entries' table
    columns read once plus the outputs written once over the memory rate,
    against the operations these inputs need (`pairs`, by kind, from
    blend.blend_pair_counts) over the FP32 rate."""
    T = int(tile_counts.shape[0])
    walked_entries = int(walked.sum())
    bytes_moved = (walked_entries * table.shape[0] * 4 + T * 8
                   + (3 * n_passes + 1) * 256 * T * 4 + T * 4)
    ops = (pairs["evaluated"] * OPS_EVALUATED + pairs["exp"] * OPS_EXP
           + pairs["used"] * OPS_USED
           + pairs["contributing"] * (OPS_CONTRIB + OPS_PER_PASS * n_passes))
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def blend_inputs(pkg, n_passes, grid):
    b = pkg.blend
    return (b["table"][:6 + 3 * n_passes], b["tile_starts"], b["tile_counts"], grid, n_passes)


def phase_check(tmp, errs):
    """Kernels against their plain versions at 512x384, and the whole path
    on the card against the CPU."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    ckpt = make_checkpoint(tmp, "check", CHECK_N, CHECK_W, CHECK_H)
    cam = camera(poses()[1], CHECK_W, CHECK_H, CHECK_W / 1.4)
    gpu = WildGaussians(checkpoint=ckpt)
    pkg = gpu.render_pkg(cam, options={"outputs": ["depth"]})
    grid = make_grid(CHECK_W, CHECK_H, 16)
    k = kernels()[0]
    for n_passes in (1, 2, 3):
        e, o = check_kernel(k, blend_inputs(pkg, n_passes, grid), f"{CHECK_W}x{CHECK_H}, "
                            f"{CHECK_N} Gaussians, {n_passes} passes")
        errs[k["name"]].append((e, o))
    opts = {"outputs": ["depth"], "embedding": gpu.get_train_embedding(2)}
    on_card = gpu.render(cam, options=opts)
    on_cpu = WildGaussians(checkpoint=ckpt, device="cpu").render(cam, options=opts)
    for key in ("color", "accumulation"):
        d = np.abs(on_card[key] - on_cpu[key])
        d = d.max(-1) if d.ndim == 3 else d
        emit({"check": "render path, card vs CPU", "output": key, "max_abs_diff": float(d.max()),
              "pixels_over_1e-3": int((d > TOL_PATH_PIXEL).sum()), "pixels": int(d.size)})
        check((d > TOL_PATH_PIXEL).mean() <= TOL_PATH_FRAC, f"{key} on the card differs from the CPU")
    rel = np.abs(on_card["depth"] - on_cpu["depth"]) / max(float(on_cpu["depth"].max()), 1e-6)
    check((rel > TOL_PATH_PIXEL).mean() <= TOL_PATH_FRAC, "depth on the card differs from the CPU")
    del gpu, pkg
    torch.cuda.empty_cache()


def phase_serve(tmp):
    """The serving path at full width; returns each kernel's launch count
    over the requests, and the blend inputs of pose 0 by number of passes."""
    from wildgaussians_torch import WildGaussians
    t0 = time.perf_counter()
    ckpt = make_checkpoint(tmp, "full", FULL_N, FULL_W, FULL_H)
    t1 = time.perf_counter()
    model = WildGaussians(checkpoint=ckpt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cams = [camera(p, FULL_W, FULL_H, FULL_W / 1.4) for p in poses()]
    emb = model.get_train_embedding(5)
    requests = [(0, None), (1, None), (2, None), (3, None), (0, {"outputs": ["depth"]}),
                (1, {"embedding": emb}), (2, None), (3, None)]
    ks = kernels()
    torch.cuda.reset_peak_memory_stats()
    for k in ks:
        k["wrapper"].launches = 0
    request_ms, acc_means = [], []
    for pose_i, opts in requests:
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        out = model.render(cams[pose_i], options=opts)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - r0) * 1e3)
        check(out["color"].shape == (FULL_H, FULL_W, 3), f"color shape {out['color'].shape}")
        check(all(np.isfinite(v).all() for v in out.values()), "non-finite render output")
        acc_means.append(float(out["accumulation"].mean()))
        check(acc_means[-1] > 0.5, f"mean accumulation {acc_means[-1]} <= 0.5")
        check((opts is not None and "outputs" in opts) == ("depth" in out), "depth output")
    launches = {k["name"]: k["wrapper"].launches for k in ks}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, n in launches.items():   # each kernel of the path runs once per request
        check(n == len(requests), f"{name} launched {n} times for {len(requests)} requests")

    # per pose: the counters of the render, and the blend kernel's inputs
    per_pose, captures = [], {}
    for i, cam in enumerate(cams):
        pkg = model.render_pkg(cam)
        per_pose.append({"pose": i, "overflow": int(pkg.overflow),
                         "num_rendered": int(pkg.num_rendered),
                         "binned_entries": int(pkg.blend["tile_starts"][-1]),
                         "walked_entries": int(pkg.blend["walked"].sum())})
        check(int(pkg.overflow) == 0, f"overflow {int(pkg.overflow)} at pose {i}")
        if i == 0:
            captures[2] = pkg
    captures[3] = model.render_pkg(cams[0], options={"outputs": ["depth"]})
    emit({"phase": "serve", "gaussians": FULL_N, "size": [FULL_W, FULL_H],
          "checkpoint_write_s": t1 - t0, "checkpoint_load_s": t2 - t1,
          "request_ms": request_ms, "warmup_ms": request_ms[0],
          "steady_mean_ms": float(np.mean(request_ms[1:])),
          "mean_accumulation": acc_means, "per_pose": per_pose, "peak_mem_gib": peak_gib})
    phase_profile(model, cams[0])
    return launches, captures


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def phase_profile(model, cam):
    """Where a request's time goes (pose 0, raw + toned passes): the stage
    spans over PROFILE_REQUESTS requests, then one torch.profiler window
    over as many, whose device busy time (the union of its kernel and copy
    intervals), idle share and launch count are all read from that window."""
    from wildgaussians_torch.spans import SpanTimer
    n = PROFILE_REQUESTS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SpanTimer() as timer:
        for _ in range(n):
            model.render(cam)
    stages = timer.ms()
    spans_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.render(cam)
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    by_name = {}
    for e in device_events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "requests": n, "request_ms_with_spans": spans_wall_ms,
          "stage_device_ms": {name: ms / n for name, (ms, _c) in stages.items()},
          "traced_request_ms": traced_us / 1e3 / n, "device_busy_ms": busy_us / 1e3 / n,
          "device_idle_share": 1.0 - busy_us / traced_us,
          # the traced window is lengthened by the profiler itself; beside it,
          # the traced busy time over the request time with spans only
          "busy_over_untraced_request": busy_us / 1e3 / n / spans_wall_ms,
          "device_launches_per_request": len(device_events) / n,
          "top_device_ops": [{"name": name[:90], "ms_per_request": us / 1e3 / n,
                              "per_request": count / n} for name, (us, count) in top]})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wildgaussians_torch.ops import _build, blend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    # f32 matmuls in full f32 (the plain version and the appearance MLP)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_line()})

    ks = kernels()
    t0 = time.perf_counter()
    logs = _build.build([k["name"] for k in ks])
    for name, log in logs.items():
        emit({"phase": "build", "kernel": name, "seconds": log.seconds,
              "ptxas": [ln.strip() for ln in log.log.splitlines()
                        if "registers" in ln or "bytes smem" in ln or "spill" in ln]})
    emit({"phase": "build", "wall_s": time.perf_counter() - t0})

    errs = {k["name"]: [] for k in ks}
    with tempfile.TemporaryDirectory(prefix="wg_chip_smoke_") as tmp:
        phase_check(tmp, errs)
        launches, captures = phase_serve(tmp)

    grid = make_grid(FULL_W, FULL_H, 16)
    k = ks[0]
    for n_passes, pkg in sorted(captures.items()):
        errs[k["name"]].append(check_kernel(k, blend_inputs(pkg, n_passes, grid),
                                            f"{FULL_W}x{FULL_H}, {FULL_N} Gaussians, pose 0, "
                                            f"{n_passes} passes"))
    # timed at the main path's common shape: raw + toned passes
    inputs = blend_inputs(captures[2], 2, grid)
    ms = time_cuda_ms(lambda: k["wrapper"](*inputs), iters=20)
    plain_ms = time_cuda_ms(lambda: k["plain"](*inputs), iters=3, warmup=1)
    walked = k["wrapper"](*inputs)[2]
    pairs = blend.blend_pair_counts(*inputs[:4])
    bound_ms, bound_by = blend_bound_ms(inputs[0], inputs[2], walked, 2, pairs)
    emit({"phase": "timing", "kernel": k["name"], "passes": 2, "pairs": pairs,
          "walked_pairs": int(walked.sum()) * 256, "binned_entries": int(inputs[1][-1]),
          "walked_entries": int(walked.sum()), "ms": ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by})
    entry = {"name": k["name"], "route": k["route"], "source": k["source"],
             "replaces": k["replaces"], "launches": launches[k["name"]],
             "max_abs_err": max(e for e, _ in errs[k["name"]]),
             "pixels_over_1e-4": max(o for _, o in errs[k["name"]]),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None}
    emit({"kernels": [entry]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
