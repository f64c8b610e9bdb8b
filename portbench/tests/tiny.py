"""A cell shrunk to a size the CPU tests can hold: a few thousand
Gaussians, four small photos, the program and the reference on the CPU."""
import copy
import time

import torch

import run


# a cell whose files the harness keeps though BENCHMARK.json does not list
# it (PERF.md, open questions): its kind and reference stay tested
KEPT = [{"name": "pt-serve", "config": "phototourism", "traffic": "viewer_1280x720", "chips": 1}]


def bench() -> dict:
    b = run.load(run.ROOT, "BENCHMARK.json")
    names = {w["name"] for w in b["workloads"]}
    b["workloads"] += [w for w in KEPT if w["name"] not in names]
    return b


def context(cell: str, seed: int = 2 ** 33 + 5, seconds: float = 0.5) -> dict:
    ctx = copy.deepcopy(run.cell_context(cell, bench()))
    conf = ctx["conf"]
    conf["scene"]["surfel_gaussians"] = 3000
    conf["config"]["num_sky_gaussians"] = 2000
    conf["train_images"] = 4
    conf["image_sizes"] = [[128, 72], [96, 80]][:len(conf["image_sizes"])]
    t = ctx["traffic"]
    if t["kind"] == "train":
        t.update(epochs=4, settle_steps=0)
    else:
        t.update(width=128, height=72, rate=8.0, sample=3, sample_within=4, poses=4)
    ctx.update(seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
               t_start=time.perf_counter())
    return ctx
