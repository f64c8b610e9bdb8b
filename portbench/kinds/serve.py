"""Viewer cells: WildGaussians loaded from a checkpoint this benchmark
writes, serving renders at a fixed rate.

Set-up: the seed's scene and trained state written as a checkpoint into
TMPDIR, loaded by `WildGaussians(checkpoint=...)` and deleted; one warm-up
request per pose. The window offers a request every 1 / `rate` seconds
(an open loop, as a viewer's frame clock does) for `--seconds`; each asks
`render` for one of the seed's poses with the appearance embedding of one
of the seed's training photos and waits for the image on the host. A
request's latency runs from when it was due to when its image is back, so
a late request counts its wait.

`correct`: a sample of the window's requests, drawn from the seed, is
rendered again by the reference from the same inputs; the images are
compared (see `compare`)."""
import gc
import itertools
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from harness import common, scene as S, state as ST
from reference import render as R
from reference.train import serve_image


def compare(got, want):
    """The mean |difference| over the sampled images' pixels and channels."""
    return {"image_mean_gap": float(np.mean([np.abs(a - b).mean() for a, b in zip(got, want)]))}


def run(ctx) -> tuple:
    cfg, conf, traffic = ctx["cfg"], ctx["conf"], ctx["traffic"]
    seed, device = ctx["seed"], ctx["device"]
    n_img, sizes = conf["train_images"], conf["image_sizes"]
    made = ST.make(seed, cfg, conf["scene"], device, n_img, sizes, False, 0, training=False)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ckpt = os.path.join(tmp, "checkpoint")
        ST.write_checkpoint(ckpt, made, cfg, 0)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        from wildgaussians_torch import WildGaussians
        from wildgaussians_torch.types import new_cameras
        model = WildGaussians(checkpoint=ckpt, device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fault = ctx.get("fault")
    if fault is not None:
        fault(model)
    w, h = traffic["width"], traffic["height"]
    poses = S.view_poses(traffic["poses"], w, h, device)
    cams = [new_cameras(poses=p.pose.cpu().numpy()[None], intrinsics=np.array([p.intr], np.float32),
                        camera_models=np.zeros((1,), np.int32),
                        distortion_parameters=np.zeros((1, 6), np.float32),
                        image_sizes=np.array([[w, h]], np.int32)) for p in poses]
    embeddings = np.asarray(made.flat["params/appearance_embeddings"])
    rng = np.random.default_rng(int(seed) % (1 << 63))
    n_max = int(traffic["rate"] * ctx["seconds"]) + 1
    # the poses in the seed's permutations, so that every pose counts alike
    which_pose = np.concatenate([rng.permutation(len(cams))
                                 for _ in range(n_max // len(cams) + 1)])
    which_img = rng.integers(0, n_img, n_max)
    sample = set(rng.choice(min(n_max, traffic["sample_within"]), traffic["sample"], replace=False)
                 .tolist())
    for c in cams:   # warm-up: every pose once
        model.render(c, options={"embedding": embeddings[0]})
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx["t_start"]

    trace = ctx["trace"]
    timer = None
    if trace:
        from wildgaussians_torch.spans import SpanTimer
        timer = SpanTimer().__enter__()
    latencies, kept, ok = [], {}, 0
    period = 1.0 / traffic["rate"]
    # the set-up's objects out of the collector's way
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    try:
        for i in range(n_max):
            due = t0 + i * period
            if due - t0 >= ctx["seconds"]:
                break
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            out = model.render(cams[which_pose[i]], options={"embedding": embeddings[which_img[i]]})
            latencies.append(time.perf_counter() - due)
            ok += bool(np.isfinite(out["color"]).all())
            if i in sample:
                kept[i] = out["color"]
    finally:
        if timer is not None:
            timer.__exit__(None, None, None)
    n = len(latencies)
    spans = timer.ms() if trace else None
    profile, profiled_poses = None, []
    if trace:
        # after the window, back to back: the service alone, without the
        # open loop's waits between requests
        j = itertools.count(n)

        def unit():
            i = next(j) % n_max
            model.render(cams[which_pose[i]], options={"embedding": embeddings[which_img[i]]})
            return int(which_pose[i])
        profile, profiled_poses = common.profile_units(device, unit, traffic["profile_warmup"],
                                                       traffic["profile_requests"])
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    inp = ST.reference_inputs(made, cfg, device, (w, h))
    filt = torch.from_numpy(np.asarray(made.flat["aux/filter_3D"])).to(device)[inp.slots]
    got, want = [], []
    for i in sorted(kept):
        p = poses[which_pose[i]]
        cam = R.camera(p.pose, p.intr, ST.canvas([(w, h)]), (w, h))
        emb = torch.from_numpy(embeddings[which_img[i]]).to(device)
        want.append(serve_image(inp, cfg, cam, emb, filt).cpu().numpy())
        got.append(kept[i])
    numbers = compare(got, want)
    limits = ctx["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (len(kept) == traffic["sample"] and ok == n
               and all(v <= limits[k] for k, v in numbers.items()))
    work = None
    if trace:
        work = count_work(inp, cfg, filt, [poses[j] for j in profiled_poses], (w, h))
    lat_ms = sorted(x * 1e3 for x in latencies)
    out = {
        "correct": bool(correct), "attempted": n, "failed": n - ok,
        "e2e": {"render_ms_p95": float(np.percentile(lat_ms, 95)), "setup_s": setup_s},
        "peak": peak, "spans": spans, "profile": profile, "units": n,
        "profile_units": traffic["profile_requests"], "work": work, "problems": [],
    }
    print(json.dumps({"diag": "serve", "latency_ms": [round(x * 1e3, 3) for x in latencies]}),
          file=sys.stderr)
    return out, checks


@torch.no_grad()
def count_work(inp, cfg, filt, poses, size):
    """The needed pairs and entries of the profiled requests' toned image,
    from the reference's walk of the cell's inputs, per request."""
    w, h = size
    pairs = entries = 0
    for p in poses:
        cam = R.camera(p.pose, p.intr, ST.canvas([(w, h)]), (w, h))
        f = R.render(inp.state, inp.mlp, filt, inp.slots, cam, dict(cfg, appearance_enabled=False),
                     None, count_pairs=True)
        pairs += f.pairs
        entries += f.entries
    n = len(poses)
    return {"pairs": pairs / n, "entries": entries / n, "pixels": w * h,
            "gaussians": int(inp.state["xyz"].shape[0]), "passes": 1,
            "appearance": bool(cfg["appearance_enabled"]), "uncertainty": False}
