"""Cells, configurations, traffic, limits and metrics are found by name
from their files, and BENCHMARK.json keeps to the shape the harness reads."""
import importlib
import json
import os

import run

ROOT = run.ROOT


def bench():
    return run.load(ROOT, "BENCHMARK.json")


def test_every_cell_resolves_by_name():
    b = bench()
    for cell in b["workloads"]:
        ctx = run.cell_context(cell["name"], b)
        assert ctx["cfg"]["sh_degree"] == 3
        assert importlib.import_module("kinds." + ctx["traffic"]["kind"]).run
        assert ctx["limits"], cell["name"]
        conf = ctx["conf"]
        entry = next(c for c in b["configs"] if c["name"] == cell["config"])
        assert conf["name"] == entry["name"] and conf["reduced"] == entry["reduced"]


def test_every_metric_has_a_reader_and_a_cell():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        spec = run.load(run.HERE, "metrics", m["name"] + ".json")
        reader = importlib.import_module("readers." + spec["reader"])
        assert reader.read(spec, {"units": 1, "profile_units": 1}) is None
        assert set(m["workloads"]) <= cells and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        assert run.metrics_of(b, cell, False) and run.metrics_of(b, cell, True)
        assert any(m["name"] == "setup_s" for m in run.metrics_of(b, cell, False))


def test_metric_values_come_from_their_readers():
    b = bench()
    out = {"e2e": {"step_ms": 100.0, "setup_s": 30.0, "render_ms_p95": 40.0},
           "spans": {"sort_engine": (200.0, 10), "preprocess": (100.0, 10),
                     "appearance": (50.0, 10),
                     "dino_pred": (20.0, 10), "uncertainty_head": (5.0, 10),
                     "uncertainty_loss": (25.0, 10), "backward": (400.0, 10), "adam": (110.0, 10)},
           "units": 10, "profile_units": 2,
           "profile": {"kernels": {"void blend_fwd_kernel<2>(float*)": (1000.0, 2),
                                   "void blend_bwd_kernel<2, false>(float*)": (6000.0, 2)},
                       "busy_s": 0.15, "window_s": 0.2, "launches": 5000, "gaps": {}},
           "work": {"pairs": 2e8, "entries": 3e6, "pixels": 1280 * 768, "gaussians": 1.6e6,
                    "passes": 2, "appearance": True, "uncertainty": True}}
    got = run.read_metrics(b, "pt-train", True, out)
    assert got["binning_ms.train"]["value"] == 20.0
    assert got["uncertainty_ms.train"]["value"] == 5.0
    assert abs(got["idle_share.train"]["value"] - 25.0) < 1e-9
    assert got["launches_per_step.train"]["value"] == 2500.0
    assert 0 < got["blend_roofline.train"]["value"] < 100
    assert 0 < got["mfu.train"]["value"] < 100
    e2e = run.read_metrics(b, "pt-train", False, out)
    assert set(e2e) == {"step_ms", "setup_s"}


def test_files_are_named_from_names():
    b = bench()
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(run.HERE, "metrics", m["name"] + ".json"))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(run.HERE, "workloads", w["name"] + ".json"))
        assert os.path.isfile(os.path.join(run.HERE, "traffic", w["traffic"] + ".json"))
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"]), encoding="utf8") as f:
            assert json.load(f)["name"] == c["name"]
