#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100;
the kernels are built for sm_90a). Every phase is fatal on failure:

  1. the card (name and power limit from nvidia-smi), torch, CUDA and nvcc;
  2. build every CUDA kernel of the serving and training paths from
     wildgaussians_torch/csrc with nvcc, one process per source, all started
     together, printing nvcc's register and shared-memory report;
  3. check, on a 20k-Gaussian surfel scene at 512x384: each kernel against
     its plain PyTorch version on the card (K1 and K2 for 1-3 color passes,
     K3), the whole render path on the card against the same path on the
     CPU, and one training step on the card against the same step on the
     CPU from the same init (every parameter's gradient and the metrics);
  4. the serving path at full width: a 1.5M-Gaussian, SH-degree-3,
     appearance-on checkpoint in the JAX package's format, loaded through
     WildGaussians and asked for 8 renders at 1280x720 from 4 poses (one with
     depth, one with an explicit embedding; the first is a warm-up), then K1
     checked and timed at the shapes the path gave it, beside its bound;
  5. where a request's time goes, on the same model: the render's stage
     spans timed on the device (wildgaussians_torch/spans.py), then one
     torch.profiler window of requests for the device's busy time, idle
     share and launches per request, and the kernels that take most of it;
  6. the training path at full width: WildGaussians(train_dataset=...) from
     the surfel scene's 1.5M points plus the default's 50,000 sky candidates,
     with the serving renders of step 4 as ground truth at 1280x720 and
     configs/default.yml (uncertainty disabled), for 8 train_iteration steps
     (the first a warm-up): step time, loss, PSNR and counters per step,
     peak memory, device time per stage span, and one torch.profiler window
     of steps; every kernel of the step launches once per step;
  7. K1, K2 and K3 held against their plain versions on the arguments the
     first training step passed them (recorded by wrapping the wrappers for
     that step), and K2 and K3 timed there beside their plain versions,
     their bounds and (K3) the PyTorch call that computes the same function.

Each path's launch counts are read over exactly that path's run (the counts
are set to 0 just before it). It prints one {"kernels": [...]} line, the
nvidia-smi line of the card, and as its last line {"ok": true, "device":
{...}}. Without a CUDA card it exits with 1 and prints no result.
"""
import contextlib
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
# K2 walks the same pairs and repeats K1's work on them; a contributing pair
# then needs the gradient chain (the weight, dalpha with its divide, dpower,
# dmx/dmy, the three conic terms, dop, the abs channel and the T update: 40
# operations) and per pass cg, the prefix, the suffix and dcol (13), plus one
# add per gradient row (7 + 3 per pass) for the sum over the tile's pixels
K2_OPS_CONTRIB, K2_OPS_PER_PASS = 40 + 7, 13 + 3
# K2 against its plain version, per gradient row: max |error| over max |row|.
# The kernel sums each entry's values over 256 pixels in another order (warp
# shuffles, then 8 warp sums) and runs T as a product where the plain
# version uses exp of a log-space prefix
TOL_ROW = 2e-3
# one training step, card vs CPU, from the same state: per parameter, the
# share of elements outside atol 5e-3 max|g| + rtol 5e-2 (a corner cull or a
# T stop that flips between the devices moves single Gaussians); metrics
TOL_GRAD_ATOL, TOL_GRAD_RTOL, TOL_GRAD_FRAC, TOL_METRIC = 5e-3, 5e-2, 1e-3, 1e-3
PROFILE_REQUESTS = 5
CHECK_SKY = 2000            # sky candidates of the check phase's training set
TRAIN_STEPS, TRAIN_PROFILE_STEPS = 8, 2


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
    """Every kernel of the serving and training paths, with its wrapper, its
    plain version and the paths that launch it."""
    from wildgaussians_torch.ops import blend
    return [dict(name="blend_fwd", route="cuda", source="wildgaussians_torch/csrc/blend_fwd.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:376",
                 wrapper=blend.blend_forward, plain=blend.blend_forward_plain,
                 paths=("serve", "train")),
            dict(name="blend_bwd", route="cuda", source="wildgaussians_torch/csrc/blend_bwd.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:493",
                 also_replaces=["wildgaussians_tpu/ops/rasterize_pallas.py:482",
                                "wildgaussians_tpu/ops/rasterize_pallas.py:501"],
                 wrapper=blend.blend_backward, plain=blend.blend_backward_plain,
                 paths=("train",)),
            dict(name="tier2_merge", route="cuda",
                 source="wildgaussians_torch/csrc/tier2_merge.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:872",
                 wrapper=blend.tier2_merge, plain=blend.tier2_merge_plain,
                 paths=("train",))]


def kernel_by_name(name):
    return next(k for k in kernels() if k["name"] == name)


@contextlib.contextmanager
def calls_of(module, attr, record):
    """Within the block, a call of `module.attr` first hands its arguments
    to `record`."""
    orig = getattr(module, attr)

    def call(*args, **kwargs):
        record(*args, **kwargs)
        return orig(*args, **kwargs)
    # one attribute dict for both: a kernel wrapper counts its launches on
    # its module-level name, which is `call` within the block
    call.__dict__ = orig.__dict__
    setattr(module, attr, call)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def blend_calls(captured):
    """A context in which each blend kernel's wrapper keeps its arguments in
    `captured[kernel name]`, detached from the autograd graph (the backward
    gets the forward's output final_T, which is part of it), and K3's
    `sums`, which it updates in place, as a copy."""
    from wildgaussians_torch.ops import blend
    stack = contextlib.ExitStack()
    for name, attr in (("blend_fwd", "blend_forward"), ("blend_bwd", "blend_backward"),
                       ("tier2_merge", "tier2_merge")):
        def record(*args, name=name):
            args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
            captured[name] = (args[0].clone(),) + args[1:] if name == "tier2_merge" else args
        stack.enter_context(calls_of(blend, attr, record))
    return stack


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


def k2_inputs(pkg, n_passes, grid, gcol=None, seed=SEED):
    """K2's arguments on the blend inputs of `pkg`: K1's outputs on the card
    and the color cotangent `gcol` (random when None) with a random summed
    gt_eff."""
    from wildgaussians_torch.ops import blend
    b = pkg.blend
    table = b["table"][:6 + 3 * n_passes]
    colors, final_t, _ = blend.blend_forward(table, b["tile_starts"], b["tile_counts"], grid,
                                             n_passes)
    g = torch.Generator(device=table.device).manual_seed(seed)
    if gcol is None:
        gcol = torch.randn(colors.shape, generator=g, device=table.device) * 1e-3
    gte = torch.randn(final_t.shape, generator=g, device=table.device) * 1e-3
    return (table, b["tile_starts"], b["tile_counts"], grid, n_passes, gcol.contiguous(),
            gte, colors, final_t, (0.5 * grid.width, 0.5 * grid.height))


def check_k2(inputs, label):
    """K2 against its plain version, per gradient row (TOL_ROW)."""
    k = kernel_by_name("blend_bwd")
    out = k["wrapper"](*inputs)
    plain = k["plain"](*inputs)
    torch.cuda.synchronize()
    row_max = plain.abs().amax(dim=1)
    row_err = (out - plain).abs().amax(dim=1)
    rel = (row_err / torch.clamp_min(row_max, 1e-30)).tolist()
    emit({"check": "blend_bwd", "at": label, "rows": len(rel), "entries": int(out.shape[1]),
          "max_abs_err": float(row_err.max()), "row_rel_err": rel})
    check(torch.isfinite(out).all() and max(rel) <= TOL_ROW,
          f"blend_bwd disagrees with its plain version at {label}: row errors {rel}")
    return float(row_err.max()), max(rel)


def check_k3(sums, big_list, bigs, label):
    """K3 against its plain version: exactly."""
    k = kernel_by_name("tier2_merge")
    out = k["wrapper"](sums.clone(), big_list, bigs)
    plain = k["plain"](sums.clone(), big_list, bigs)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    valid = int((big_list < sums.shape[1]).sum())
    emit({"check": "tier2_merge", "at": label, "rows": int(sums.shape[0]), "n": int(sums.shape[1]),
          "m_cap": int(big_list.shape[0]), "valid": valid, "max_abs_err": err,
          "equal": bool(torch.equal(out, plain))})
    check(torch.equal(out, plain) and valid > 0, f"tier2_merge differs from its plain version at {label}")
    return err


def training_set(cams, images, xyz, colors):
    """A Dataset of the given cameras and float images, seeded by a point
    cloud with colors in [0, 1]."""
    from wildgaussians_torch.types import Cameras
    cameras = Cameras.cat(cams)
    return dict(cameras=cameras, images=list(images), masks=None,
                points3D_xyz=np.asarray(xyz, np.float32),
                points3D_rgb=np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8),
                image_paths=[f"{i:03d}.png" for i in range(len(cams))], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={}, images_points3D_indices=None)


def surfel_points(n, width, height):
    """The surfel scene's points and colors (the same draws as its checkpoint)."""
    from wildgaussians_torch.scenes import make_surfel_scene
    xyz, _s, _r, _o, colors = make_surfel_scene(np.random.default_rng(SEED), n, width, height,
                                                width / 1.4)
    return xyz, colors


def check_train_step(gpu_model, cams):
    """One training step on the card against the same step on the CPU from
    the same state (the CPU model's init copied to the card), at active SH
    degree 3 with anisotropic scales so that every parameter gets gradient:
    every parameter's gradient, read where the step hands it to Adam, and
    the metrics."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.models import gaussian_store as gs
    images = [gpu_model.render(cam)["color"] for cam in cams]
    xyz, colors = surfel_points(CHECK_N, CHECK_W, CHECK_H)
    ds = training_set(cams, images, xyz, colors)
    overrides = dict(uncertainty_mode="disabled", num_sky_gaussians=CHECK_SKY)
    cpu = WildGaussians(train_dataset=ds, config_overrides=overrides, device="cpu")
    card = WildGaussians(train_dataset=ds, config_overrides=overrides)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
            p = cpu.params[k]
            p.add_(torch.as_tensor(rng.normal(0, sigma, p.shape).astype(np.float32)))
        for k, p in card._trainable().items():
            p.copy_(cpu._trainable()[k].to(p.device))
    for m in (cpu, card):
        m.aux = m.aux._replace(
            active_sh_degree=torch.tensor(3, dtype=torch.int32, device=m.device),
            filter_3D=cpu.aux.filter_3D.to(m.device))
    grads, metrics, seconds = {}, {}, {}
    for name, m in (("cpu", cpu), ("card", card)):
        def record(_params, g, *_args, name=name, **_kwargs):
            grads[name] = {k: v.detach().to("cpu", copy=True) for k, v in g.items()}
        t0 = time.perf_counter()
        with calls_of(gs, "adam_update", record):
            metrics[name] = m.train_iteration(0, camera_id=0)
        seconds[name] = time.perf_counter() - t0
    m_cpu, m_card = metrics["cpu"], metrics["card"]
    per_param = {}
    alive = cpu.aux.alive
    for k, want in grads["cpu"].items():
        got = grads["card"][k]
        if want.shape[0] == alive.shape[0]:
            # a dead slot's gradient may be NaN, as in the JAX package (the
            # norm's derivative at 0 where a zero slot meets a camera centre)
            want, got = want[alive], got[alive]
        scale = float(want.abs().max())
        over = (got - want).abs() > TOL_GRAD_ATOL * scale + TOL_GRAD_RTOL * want.abs()
        per_param[k] = {"max_abs": scale, "max_err_rel": float((got - want).abs().max()) / max(scale, 1e-30),
                        "share_over_tol": float(over.float().mean())}
        check(scale > 0 and torch.isfinite(got).all(), f"train step: {k} has no finite gradient")
        check(per_param[k]["share_over_tol"] <= TOL_GRAD_FRAC,
              f"train step: the gradient of {k} differs between the card and the CPU: {per_param[k]}")
    metric_err = {k: abs(m_card[k] - v) / max(abs(v), 1e-12) for k, v in m_cpu.items()}
    emit({"check": "train step, card vs CPU", "size": [CHECK_W, CHECK_H],
          "gaussians": int(m_cpu["num_gaussians"]), "cpu_step_s": seconds["cpu"],
          "metrics_cpu": m_cpu, "metrics_card": m_card, "metric_rel_err": metric_err,
          "gradients": per_param})
    check(all(e <= TOL_METRIC for e in metric_err.values()),
          f"train step metrics differ between the card and the CPU: {metric_err}")


def phase_check(tmp, errs):
    """Kernels against their plain versions at 512x384, the whole render
    path and one training step on the card against the CPU."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.ops import blend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    ckpt = make_checkpoint(tmp, "check", CHECK_N, CHECK_W, CHECK_H)
    cam = camera(poses()[1], CHECK_W, CHECK_H, CHECK_W / 1.4)
    gpu = WildGaussians(checkpoint=ckpt)
    pkg = gpu.render_pkg(cam, options={"outputs": ["depth"]})
    grid = make_grid(CHECK_W, CHECK_H, 16)
    k = kernel_by_name("blend_fwd")
    for n_passes in (1, 2, 3):
        label = f"{CHECK_W}x{CHECK_H}, {CHECK_N} Gaussians, {n_passes} passes"
        errs["blend_fwd"].append(check_kernel(k, blend_inputs(pkg, n_passes, grid), label))
        errs["blend_bwd"].append(check_k2(k2_inputs(pkg, n_passes, grid), label))
    big_list = pkg.blend["big_list"]
    n = gpu.params["xyz"].shape[0]
    g = torch.Generator(device=gpu.device).manual_seed(SEED)
    rows = blend.grad_rows(2)
    errs["tier2_merge"].append(check_k3(
        torch.randn((rows, n), generator=g, device=gpu.device), big_list,
        torch.randn((rows, big_list.shape[0]), generator=g, device=gpu.device),
        f"{CHECK_N} Gaussians"))
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
    check_train_step(gpu, [camera(p, CHECK_W, CHECK_H, CHECK_W / 1.4) for p in poses()[:2]])
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
    ks = [k for k in kernels() if "serve" in k["paths"]]
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
    return launches, captures, model, cams


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


def phase_train(serve_model, cams):
    """The training path at full width (see the module docstring); returns
    each kernel's launch count over the 8 steps, the arguments each kernel
    was given in the first step (blend_calls) and a label of that step."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.models import gaussian_store as gs
    from wildgaussians_torch.spans import SpanTimer
    ks = [k for k in kernels() if "train" in k["paths"]]
    images = [serve_model.render(cam)["color"] for cam in cams]
    xyz, colors = surfel_points(FULL_N, FULL_W, FULL_H)
    ds = training_set(cams, images, xyz, colors)
    del images
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = WildGaussians(train_dataset=ds, config_overrides=dict(uncertainty_mode="disabled"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # per parameter over the steps before the profiled ones, taken where
    # each step hands its gradients to Adam and read after the step, outside
    # its timing: every gradient finite, and its largest |g|
    grad_max, pending = {}, []

    def observe(_params, grads, *_args, **_kwargs):
        pending.append(grads)

    def fold():
        alive = model.aux.alive
        for k, g in pending.pop().items():
            if g.shape[0] == alive.shape[0]:
                g = g[alive]   # a dead slot's gradient may be NaN (see check_train_step)
            m = torch.where(torch.isfinite(g), g.abs(), torch.inf).max()
            grad_max[k] = m if k not in grad_max else torch.maximum(grad_max[k], m)
    captured = {}
    for k in ks:
        k["wrapper"].launches = 0
    steps, per_step_launches = [], []
    timer = SpanTimer()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    n_plain = TRAIN_STEPS - TRAIN_PROFILE_STEPS
    traced_us = 0.0
    observing = calls_of(gs, "adam_update", observe)
    observing.__enter__()
    for step in range(TRAIN_STEPS):
        if step == 1:
            timer.__enter__()
        if step == n_plain:
            timer.__exit__(None, None, None)
            observing.__exit__(None, None, None)
            prof.__enter__()
        before = {k["name"]: k["wrapper"].launches for k in ks}
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        # the warm-up step records each kernel's arguments
        with blend_calls(captured) if step == 0 else contextlib.nullcontext():
            metrics = model.train_iteration(step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - r0) * 1e3
        if step >= n_plain:
            traced_us += ms * 1e3
        else:
            fold()
        per_step_launches.append({k["name"]: k["wrapper"].launches - before[k["name"]] for k in ks})
        steps.append({"step": step, "ms": ms, **{key: metrics[key] for key in (
            "loss", "psnr", "num_rendered", "overflow", "max_tiles", "num_gaussians")}})
        check(np.isfinite(metrics["loss"]), f"loss at step {step} is {metrics['loss']}")
    prof.__exit__(None, None, None)
    launches = {k["name"]: k["wrapper"].launches for k in ks}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = timer.ms()
    for i, per in enumerate(per_step_launches):
        check(all(v == 1 for v in per.values()), f"step {i} launched {per} (each kernel once)")
    grad_max = {k: float(v) for k, v in grad_max.items()}
    for k, v in grad_max.items():
        check(np.isfinite(v), f"a gradient of {k} is not finite")
        # at active SH degree 0 (the first 1000 iterations) nothing reads the
        # higher SH bands: their gradient is exactly zero, as in the JAX package
        if k == "features_rest" and int(model.aux.active_sh_degree) == 0:
            check(v == 0.0, f"features_rest has gradient {v} at SH degree 0")
        else:
            check(v > 0.0, f"{k} got no gradient in {n_plain} steps")
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    by_name = {}
    for e in device_events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    n_span = n_plain - 1
    np_ = TRAIN_PROFILE_STEPS
    emit({"phase": "train", "points": int(len(xyz)), "capacity": int(model.params["xyz"].shape[0]),
          "size": [FULL_W, FULL_H], "setup_s": setup_s, "steps": steps,
          "warmup_ms": steps[0]["ms"],
          "steady_mean_ms": float(np.mean([st["ms"] for st in steps[1:n_plain]])),
          "peak_mem_gib": peak_gib, "grad_max_abs": grad_max,
          "stage_device_ms": {name: ms / n_span for name, (ms, _c) in stages.items()},
          "stage_spans_per_step": {name: c / n_span for name, (_ms, c) in stages.items()},
          "traced_step_ms": traced_us / 1e3 / np_, "device_busy_ms": busy_us / 1e3 / np_,
          "device_idle_share": 1.0 - busy_us / traced_us,
          "device_launches_per_step": len(device_events) / np_,
          "top_device_ops": [{"name": name[:90], "ms_per_step": us / 1e3 / np_,
                              "per_step": count / np_} for name, (us, count) in top]})
    label = (f"training step 0 at {FULL_W}x{FULL_H}, {steps[0]['num_gaussians']} Gaussians, "
             f"{captured['blend_fwd'][4]} passes")
    return launches, captured, label


def k2_bound_ms(inputs, walked, pairs):
    """Least time for K2's work on these inputs: the walked entries' table
    columns, the cotangent and forward packs read once and the walked
    entries' gradient rows written once over the memory rate, against the
    operations the pairs need (K1's per kind, plus the gradient chain per
    contributing pair) over the FP32 rate."""
    table, _s, tile_counts, _g, n_passes = inputs[:5]
    T = int(tile_counts.shape[0])
    w = int(walked.sum())
    bytes_moved = (w * table.shape[0] * 4 + T * 8 + 2 * n_passes * T * 256 * 3 * 4
                   + 2 * T * 256 * 4 + w * (7 + 3 * n_passes) * 4)
    ops = (pairs["evaluated"] * OPS_EVALUATED + pairs["exp"] * OPS_EXP + pairs["used"] * OPS_USED
           + pairs["contributing"] * (K2_OPS_CONTRIB + K2_OPS_PER_PASS * n_passes))
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def k3_bound_ms(sums, big_list, bigs):
    """K3 moves bytes: the pool's indices and values read once, and each
    valid (row, slot)'s element of `sums` read and written once."""
    valid = int((big_list < sums.shape[1]).sum())
    bytes_moved = big_list.shape[0] * 4 + bigs.numel() * 4 + 2 * sums.shape[0] * valid * 4
    return bytes_moved / PEAK_BYTES * 1e3, "bytes"


def time_backward_kernels(captured, label, errs):
    """K1, K2 and K3 on the arguments a training step passed them
    (`captured`, from blend_calls): each checked against its plain version;
    K2 and K3 timed beside their plain versions, with their bounds, and K3
    also beside `index_add_` on its valid slots."""
    from wildgaussians_torch.ops import blend
    fwd, k2 = captured["blend_fwd"], captured["blend_bwd"]
    sums, big_list, bigs = captured["tier2_merge"]
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), fwd, label))
    errs["blend_bwd"].append(check_k2(k2, label))
    errs["tier2_merge"].append(check_k3(sums, big_list, bigs, label))
    walked = blend.blend_forward(*fwd)[2]
    pairs = blend.blend_pair_counts(*k2[:4])
    out = {}
    ms = time_cuda_ms(lambda: blend.blend_backward(*k2), iters=10)
    plain_ms = time_cuda_ms(lambda: blend.blend_backward_plain(*k2), iters=1, warmup=1)
    bound, by = k2_bound_ms(k2, walked, pairs)
    out["blend_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    emit({"phase": "timing", "kernel": "blend_bwd", "at": label, "passes": k2[4], "pairs": pairs,
          "binned_entries": int(k2[1][-1]), "walked_entries": int(walked.sum()), **out["blend_bwd"]})
    scratch = sums.clone()
    ms = time_cuda_ms(lambda: blend.tier2_merge(scratch, big_list, bigs), iters=20)
    plain_ms = time_cuda_ms(lambda: blend.tier2_merge_plain(scratch, big_list, bigs), iters=5)
    valid = big_list < sums.shape[1]
    idx, vals = big_list[valid].long(), bigs[:, valid].contiguous()
    library_ms = time_cuda_ms(lambda: scratch.index_add_(1, idx, vals), iters=20)
    bound, by = k3_bound_ms(sums, big_list, bigs)
    out["tier2_merge"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                              library_ms=library_ms)
    emit({"phase": "timing", "kernel": "tier2_merge", "at": label, "rows": int(sums.shape[0]),
          "n": int(sums.shape[1]), "m_cap": int(big_list.shape[0]), "valid": int(valid.sum()),
          **out["tier2_merge"]})
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wildgaussians_torch.ops import _build, blend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    # f32 matmuls and convolutions in full f32 (the plain versions, the
    # appearance MLP, SSIM)
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
        serve_launches, captures, serve_model, cams = phase_serve(tmp)

    grid = make_grid(FULL_W, FULL_H, 16)
    k = kernel_by_name("blend_fwd")
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
    timings = {k["name"]: dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=None)}
    del captures, inputs
    torch.cuda.empty_cache()

    train_launches, captured, label = phase_train(serve_model, cams)
    del serve_model
    torch.cuda.empty_cache()
    timings.update(time_backward_kernels(captured, label, errs))

    entries = []
    for k in ks:
        name = k["name"]
        by_path = {"serve": serve_launches.get(name, 0), "train": train_launches.get(name, 0)}
        for path in k["paths"]:
            check(by_path[path] > 0, f"{name} was not launched on the {path} path")
        entry = {"name": name, "route": k["route"], "source": k["source"],
                 "replaces": k["replaces"], "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(e[0] if isinstance(e, tuple) else e for e in errs[name]),
                 **timings[name]}
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        if name == "blend_fwd":
            entry["pixels_over_1e-4"] = max(o for _, o in errs[name])
        if name == "blend_bwd":
            entry["max_row_rel_err"] = max(r for _, r in errs[name])
        entries.append(entry)
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
