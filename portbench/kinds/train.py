"""Training cells: WildGaussians resumed from a checkpoint this benchmark
writes, trained in a closed loop over its cameras.

Set-up: the seed's scene, photos and trained state, written as a
checkpoint into TMPDIR and read back by `WildGaussians(checkpoint=...,
train_dataset=...)` (the program resumes from files only), then deleted.
The first `check_steps` steps, each on another camera, are the ones the
reference follows; the warm-up then completes the epoch (every camera's
DINO features cached) and goes on while the tile budget grows. The window
runs `train_iteration` for `--seconds` over the seed's camera order; each
call returns host numbers, so it ends synchronised. `step_ms` is the
window over the steps completed in it.

`correct`: the program's first steps against the reference's, from the
same inputs: each step's loss, the norm of the first gradient of each
trained tensor (read from Adam's first moment after step 1) and the norm
of each tensor's change after the last checked step, each by its worst
tensor (see `compare`). The program's parameters and moments are read
through its public checkpoint path, `state_dict()`, under the checkpoint's
keys; the window's checks read only what `train_iteration` returns and
that state."""
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from harness import common, state as ST
from reference import render as R
from reference.train import PER_GAUSSIAN, leaves, run_steps

B1 = 0.9


def camera_order(seed: int, n: int, epochs: int) -> List[int]:
    """Epochs of the seed's permutations of the n cameras."""
    g = torch.Generator().manual_seed(int(seed) % (1 << 63))
    return [int(i) for _ in range(epochs) for i in torch.randperm(n, generator=g)]


def dataset(made, cfg):
    from wildgaussians_torch.types import new_cameras
    cams = made.cams
    cameras = new_cameras(
        poses=np.stack([c.pose.cpu().numpy() for c in cams]),
        intrinsics=np.array([c.intr for c in cams], np.float32),
        camera_models=np.zeros((len(cams),), np.int32),
        distortion_parameters=np.zeros((len(cams), 6), np.float32),
        image_sizes=np.array([c.size for c in cams], np.int32))
    rgb = np.full((made.points.shape[0], 3), 128, np.uint8)
    return dict(cameras=cameras, images=[im.cpu().numpy() for im in made.images], masks=None,
                points3D_xyz=made.points, points3D_rgb=rgb,
                image_paths=[f"{i:03d}.png" for i in range(len(cams))], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={}, images_points3D_indices=None)


def trained(flat) -> List[str]:
    """The trained tensors of a checkpoint's arrays: those Adam keeps."""
    return sorted(k[len("adam/mu/"):] for k in flat if k.startswith("adam/mu/"))


def rows(name: str, x: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    return x[slots] if name in PER_GAUSSIAN else x


def live_norm(name: str, x, slots: torch.Tensor, minus=None, scale: float = 1.0) -> float:
    """The norm over the live Gaussians' rows of (x - minus) * scale, on
    the device; x and minus are checkpoint arrays."""
    t = rows(name, torch.from_numpy(np.asarray(x)).to(slots.device), slots).double()
    if minus is not None:
        t = t - rows(name, torch.from_numpy(np.asarray(minus)).to(slots.device), slots).double()
    return float(t.norm()) * scale


def budget_streak(streak: int, m: Dict[str, float]) -> int:
    """Steps in a row whose contributions overflowed the tile budget: the
    program grows its budget after 10 (`train_iteration`'s `overflow`
    less its `send_drops`)."""
    return streak + 1 if m["overflow"] - m.get("send_drops", 0.0) > 0 else 0


def norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """|program norm - reference norm| over the larger of the reference's
    norm of the tensor and of the median tensor, for each key."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def compare(losses_p, g1_p, d3_p, losses_r, g1_r, d3_r) -> Dict[str, float]:
    """The three numbers `correct` holds: the worst step's relative loss
    gap, and the worst tensor's first-gradient gap and change gap, so that
    a fault confined to one group (its update skipped, its learning rate
    wrong) shows. A tensor whose reference gradient is under a thousandth
    of the median tensor's is left out of the change (Adam moves it by
    rounding alone)."""
    keys = sorted(g1_r)
    med = statistics.median(g1_r[k] for k in keys)
    moved = [k for k in keys if g1_r[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_p, losses_r))
    return {"loss_gap": loss_gap, "grad_gap": max(gap(g1_p, g1_r, keys).values()),
            "change_gap": max(gap(d3_p, d3_r, moved).values())}


def run(ctx) -> tuple:
    cfg, conf, traffic = ctx["cfg"], ctx["conf"], ctx["traffic"]
    seed, device = ctx["seed"], ctx["device"]
    n_img, sizes, step0 = conf["train_images"], conf["image_sizes"], traffic["resume_iteration"]
    phases = {"imports": time.perf_counter() - ctx["t_start"]}
    made = ST.make(seed, cfg, conf["scene"], device, n_img, sizes, True, step0)
    phases["inputs"] = time.perf_counter() - ctx["t_start"]
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        if made.vit is not None:
            ST.write_vit(os.path.join(tmp, "dinov2.pth"), made.vit)
            os.environ["WG_DINOV2_WEIGHTS"] = os.path.join(tmp, "dinov2.pth")
        ckpt = os.path.join(tmp, "checkpoint")
        ST.write_checkpoint(ckpt, made, cfg, step0)
        phases["written"] = time.perf_counter() - ctx["t_start"]
        ds = dataset(made, cfg)
        made = made._replace(images=[im.cpu() for im in made.images],
                             vit={k: v.cpu() for k, v in made.vit.items()} if made.vit else None)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        from wildgaussians_torch import WildGaussians
        model = WildGaussians(checkpoint=ckpt, train_dataset=ds, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("WG_DINOV2_WEIGHTS", None)
    del ds
    phases["loaded"] = time.perf_counter() - ctx["t_start"]
    fault = ctx.get("fault")
    if fault is not None:
        fault(model)
    order = camera_order(seed, n_img, traffic["epochs"])
    slots = torch.from_numpy(np.nonzero(made.alive)[0]).to(device)
    checks_n = traffic["check_steps"]
    losses, g1, d3 = [], None, None
    k = 0
    while k < checks_n:
        m = model.train_iteration(step0 + k, camera_id=order[k])
        losses.append(m["loss"])
        if k == 0:
            sd = model.state_dict()
            with torch.no_grad():
                g1 = {name: live_norm(name, sd[f"adam/mu/{name}"], slots,
                                      B1 * np.asarray(made.flat[f"adam/mu/{name}"]), 1 / (1 - B1))
                      for name in trained(sd)}
            del sd
        k += 1
    sd = model.state_dict()
    with torch.no_grad():
        d3 = {name: live_norm(name, sd[f"params/{name}"], slots, made.flat[f"params/{name}"])
              for name in trained(sd)}
    capacity = int(sd["params/xyz"].shape[0])
    del sd
    phases["checked_steps"] = time.perf_counter() - ctx["t_start"]
    # the warm-up: the rest of the epoch, then on until `settle_steps` steps
    # in a row fit the tile budget (no overflow streak carries into the
    # window), in whole epochs
    overflow, streak, quiet = [], 0, 0
    while k < n_img or quiet < traffic["settle_steps"] or k % n_img:
        if k >= traffic["warmup_epochs_max"] * n_img:
            raise RuntimeError(f"the tile budget overflowed for {streak} steps in a row "
                               f"after {k} warm-up steps")
        m = model.train_iteration(step0 + k, camera_id=order[k])
        overflow.append(m["overflow"])
        streak = budget_streak(streak, m)
        quiet = quiet + 1 if streak == 0 else 0
        k += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]

    trace = ctx["trace"]
    timer = None
    if trace:
        from wildgaussians_torch.spans import SpanTimer
        timer = SpanTimer().__enter__()
    ok, steps, longest = 0, 0, 0
    # the set-up's objects out of the collector's way, so that no collection
    # of them lands in the window
    gc.collect()
    gc.freeze()
    step_s, seen = [], []
    t0 = time.perf_counter()
    try:
        # whole epochs, so that every camera counts alike whatever the seed
        while time.perf_counter() - t0 < ctx["seconds"] or k % n_img:
            m = model.train_iteration(step0 + k, camera_id=order[k])
            step_s.append(time.perf_counter())
            ok += common.finite(m["loss"])
            streak = budget_streak(streak, m)
            longest = max(longest, streak)
            seen.append((int(m["overflow"]), int(m["max_tiles"]), int(m["num_rendered"])))
            steps += 1
            k += 1
    finally:
        if timer is not None:
            timer.__exit__(None, None, None)
    window_s = time.perf_counter() - t0
    spans = timer.ms() if trace else None
    profile, cams_profiled = None, []
    if trace:
        # after the window: the profiler's own start-up, then its steps
        def unit():
            nonlocal k, streak, longest
            cam = order[k]
            streak = budget_streak(streak, model.train_iteration(step0 + k, camera_id=cam))
            longest = max(longest, streak)
            k += 1
            return cam
        profile, cams_profiled = common.profile_units(device, unit, traffic["profile_warmup"],
                                                      traffic["profile_steps"])
    iters = range(step0 + 1, step0 + k + 1)
    problems = []
    if any(i < cfg["densify_until_iter"] for i in iters):
        problems.append("a step densifies or resets the opacities")
    if longest >= 10:
        problems.append("the tile budget may have grown in the window "
                        f"({longest} steps in a row overflowed it)")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if int(model.state_dict()["params/xyz"].shape[0]) != capacity:
        problems.append("the store grew in the window")
    found = common.forbidden_modules()
    del model, m
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    canvas = ST.canvas(sizes)
    made = made._replace(images=[im.to(device) for im in made.images],
                         vit={k_: v.to(device) for k_, v in made.vit.items()} if made.vit else None)
    inp = ST.reference_inputs(made, cfg, device, canvas)
    losses_r, g1r_t, final_r = run_steps(inp, cfg, order[:checks_n], step0 + 1, canvas)
    g1_r = norms(g1r_t)
    d3_r = {name: float((final_r[name] - start).double().norm())
            for name, start in leaves(inp.state, inp.mlp, inp.head).items()}
    del g1r_t, final_r
    numbers = compare(losses, g1, d3, losses_r, g1_r, d3_r)
    print(json.dumps({"diag": "train", "losses": losses, "losses_ref": losses_r,
                      "grad_norms": g1, "grad_norms_ref": g1_r, "change_norms": d3,
                      "change_norms_ref": d3_r, "setup_phases_s": phases,
                      "overflow_last_warmup": overflow[-3:], "steps_in_setup": k - steps,
                      "capacity": capacity, "live": int(slots.shape[0]),
                      "window_overflow_max_tiles_rendered": seen,
                      "step_ms": [round((b - a) * 1e3, 3) for a, b in zip([t0] + step_s, step_s)]}),
          file=sys.stderr)
    limits = ctx["limits"]
    checks = {k_: {"value": v, "limit": limits[k_]} for k_, v in numbers.items()}
    correct = (not problems and not found and all(v <= limits[k_] for k_, v in numbers.items())
               and ok == steps and all(common.finite(x) for x in losses))
    work = None
    if trace:
        work = count_work(inp, cfg, cams_profiled, canvas)
    out = {
        "correct": bool(correct), "attempted": steps, "failed": steps - ok,
        "e2e": {"step_ms": window_s / steps * 1e3, "setup_s": setup_s},
        "peak": peak, "spans": spans, "profile": profile, "units": steps,
        "profile_units": traffic["profile_steps"], "work": work, "problems": problems,
    }
    return out, checks


@torch.no_grad()
def count_work(inp, cfg, cam_ids, canvas) -> Dict[str, float]:
    """The needed (pixel, entry) pairs and entries of the profiled steps'
    cameras, from the reference's walk of the cell's inputs, per step."""
    filt = R.filter_3d(inp.state["xyz"], inp.cams)
    pairs = entries = 0
    for c in cam_ids:
        f = R.render(inp.state, inp.mlp, filt, inp.slots, inp.cams[c], cfg,
                     inp.state["appearance_embeddings"][c] if cfg["appearance_enabled"] else None,
                     count_pairs=True)
        pairs += f.pairs
        entries += f.entries
    n = len(cam_ids)
    return {"pairs": pairs / n, "entries": entries / n, "pixels": canvas[0] * canvas[1],
            "gaussians": int(inp.state["xyz"].shape[0]),
            "passes": 2 if cfg["appearance_enabled"] else 1,
            "appearance": bool(cfg["appearance_enabled"]),
            "uncertainty": cfg["uncertainty_mode"] != "disabled"}
